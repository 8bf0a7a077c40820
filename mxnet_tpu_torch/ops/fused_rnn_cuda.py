"""Wrappers of the Hopper fused-LSTM and fused-GRU kernels.

The kernels (``csrc/fused_rnn.cuh``, one translation unit each:
``csrc/fused_{lstm,gru}_{fwd,bwd}.cu``) replace the TPU kernels of
``mxnet_tpu/ops/pallas_lstm.py`` (``_fwd_kernel``, ``_bwd_kernel``) and
``mxnet_tpu/ops/pallas_gru.py`` (``_fwd_kernel``, ``_bwd_kernel``).  They
are built with ``nvcc`` at the first launch and called through
``ctypes``.  Each wrapper checks what its kernel takes and raises on
anything else; a failed build or launch raises its ``cudaError``, and
there is no fallback to the plain versions (those are
``ops.fused_lstm.fused_lstm_{fwd,bwd}_torch`` and
``ops.fused_gru.fused_gru_{fwd,bwd}_torch``, which the CPU path runs).
``launches`` counts each kernel's launches in this process.

gx (T, N, G H) is float32 or bfloat16; wh is cast to gx's dtype (the
product's operand type, as the TPU kernels cast it) and bh to float32;
h0/c0 are float32 (N, H).  Every tensor is made contiguous.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import load_library
from .fused_lstm import KERNEL_DTYPES

__all__ = ["lstm_fwd_cuda", "lstm_bwd_cuda", "gru_fwd_cuda", "gru_bwd_cuda",
           "barrier_floor_cuda", "launches"]

LIB_NAME = "mxtt_fused_rnn"
SOURCES = ("fused_rnn.cuh", "fused_lstm_fwd.cu", "fused_lstm_bwd.cu",
           "fused_gru_fwd.cu", "fused_gru_bwd.cu")

# kernel launches in this process, per kernel; reset by whoever counts a
# window
launches = {"lstm_fwd": 0, "lstm_bwd": 0, "gru_fwd": 0, "gru_bwd": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = load_library(LIB_NAME, SOURCES)
    if lib.mxtt_lstm_fwd.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        for mode in ("lstm", "gru"):
            fwd, bwd = (getattr(lib, f"mxtt_{mode}_{k}") for k in ("fwd",
                                                                  "bwd"))
            fwd.argtypes = [i] + [vp] * 10 + [i] * 4 + [vp]
            bwd.argtypes = [i] + [vp] * 15 + [i] * 3 + [vp]
            fwd.restype = bwd.restype = ctypes.c_int
        lib.mxtt_rnn_barrier_floor.argtypes = [i, i, vp]
        lib.mxtt_rnn_barrier_floor.restype = ctypes.c_int
    return lib


def _need(cond, msg):
    if not cond:
        raise ValueError(f"fused_rnn_cuda: {msg}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _check(rc, name):
    if rc != 0:
        # 1 (cudaErrorInvalidValue): a geometry outside the kernels' limits;
        # 82 (cudaErrorCooperativeLaunchTooLarge): a grid not co-resident
        raise RuntimeError(f"fused_rnn_cuda: {name} launch failed with "
                           f"cudaError {rc}")
    launches[name] += 1


def _fwd_checks(gx, h0, wh, G, c0=None):
    _need(gx.is_cuda, f"gx must be a CUDA tensor (got {gx.device})")
    _need(gx.dtype in KERNEL_DTYPES, f"dtype {gx.dtype} not float32/bfloat16")
    _need(gx.dim() == 3 and gx.shape[2] % G == 0,
          f"gx must be (T, N, {G} H), got {tuple(gx.shape)}")
    T, N, GH = gx.shape
    H = GH // G
    _need(T >= 1 and N >= 1 and H >= 1,
          f"gx must hold a non-empty sequence, got {tuple(gx.shape)}")
    for t, name in ((h0, "h0"), (c0, "c0")):
        if t is not None:
            _need(t.device == gx.device and tuple(t.shape) == (N, H),
                  f"{name} must be ({N}, {H}) on {gx.device}")
    _need(tuple(wh.shape) == (GH, H) and wh.device == gx.device,
          f"wh must be ({GH}, {H}) on {gx.device}, got {tuple(wh.shape)}")
    return T, N, H


def _fwd(G, name, gx, h0, c0, wh, bh, save):
    T, N, H = _fwd_checks(gx, h0, wh, G, c0)
    dt, dev = gx.dtype, gx.device
    _need(bh.numel() == G * H and bh.device == dev,
          f"bh must hold {G * H} values on {dev}")
    gx = gx.contiguous()
    h0 = h0.float().contiguous()
    c0 = None if c0 is None else c0.float().contiguous()
    wh = wh.to(dt).contiguous()
    bh = bh.reshape(-1).float().contiguous()
    ys = torch.empty(T, N, H, dtype=dt, device=dev)
    hT = torch.empty(N, H, dtype=dt, device=dev)
    cT = torch.empty(N, H, dtype=dt, device=dev) if G == 4 else None
    acts = cells = None
    if save:
        acts = torch.empty(T, N, 4 * H, device=dev)
        cells = torch.empty(T, N, H, device=dev) if G == 4 else None
    with torch.cuda.device(dev):
        rc = getattr(_lib(), f"mxtt_{name}")(
            _DTYPE_CODE[dt], _ptr(gx), _ptr(h0), _ptr(c0), _ptr(wh),
            _ptr(bh), _ptr(ys), _ptr(hT), _ptr(cT), _ptr(acts),
            _ptr(cells), T, N, H, int(save), _stream(dev))
    _check(rc, name)
    return ys, hT, cT, acts, cells


def lstm_fwd_cuda(gx, h0, c0, wh, bh, save=True):
    """Fused-LSTM forward kernel: ``(ys, hT, cT, acts, cells)``, the
    residuals (float32 acts (T, N, 4H), cells (T, N, H)) None without
    ``save``."""
    return _fwd(4, "lstm_fwd", gx, h0, c0, wh, bh, save)


def gru_fwd_cuda(gx, h0, wh, bh, save=True):
    """Fused-GRU forward kernel: ``(ys, hT, acts)``, acts the float32
    (T, N, 4H) (r, z, n, hp_n), None without ``save``."""
    ys, hT, _, acts, _ = _fwd(3, "gru_fwd", gx, h0, None, wh, bh, save)
    return ys, hT, acts


def _bwd(G, name, acts, cells, ys, h0, c0, wh, dys, dhT, dcT):
    _need(ys.is_cuda, f"ys must be a CUDA tensor (got {ys.device})")
    dt, dev = ys.dtype, ys.device
    _need(dt in KERNEL_DTYPES, f"dtype {dt} not float32/bfloat16")
    T, N, H = ys.shape
    _need(T >= 1 and N >= 1 and H >= 1,
          f"ys must hold a non-empty sequence, got {tuple(ys.shape)}")
    _need(tuple(acts.shape) == (T, N, 4 * H) and acts.dtype == torch.float32,
          f"acts must be float32 ({T}, {N}, {4 * H})")
    if G == 4:
        _need(tuple(cells.shape) == (T, N, H)
              and cells.dtype == torch.float32,
              f"cells must be float32 ({T}, {N}, {H})")
    _need(tuple(wh.shape) == (G * H, H), f"wh must be ({G * H}, {H})")
    for t, shape, nm in ((dys, (T, N, H), "dys"), (dhT, (N, H), "dhT"),
                         (dcT, (N, H), "dcT"), (h0, (N, H), "h0"),
                         (c0, (N, H), "c0")):
        if t is not None:
            _need(tuple(t.shape) == shape and t.device == dev,
                  f"{nm} must be {shape} on {dev}")
    for t, nm in ((dys, "dys"), (dhT, "dhT"), (dcT, "dcT")):
        if t is not None:
            _need(t.dtype == dt, f"{nm} must be in ys's dtype {dt}")
    c = [None if t is None else t.contiguous()
         for t in (acts, cells, ys, dys, dhT, dcT)]
    h0 = h0.float().contiguous()
    c0 = None if c0 is None else c0.float().contiguous()
    wh = wh.to(dt).contiguous()
    dgx = torch.empty(T, N, G * H, dtype=dt, device=dev)
    xbuf = (torch.empty(2, N, G * H, dtype=dt, device=dev) if G == 3
            else None)
    dwh = torch.empty(G * H, H, device=dev)
    dbh = torch.empty(G * H, device=dev)
    dh0 = torch.empty(N, H, device=dev)
    dc0 = torch.empty(N, H, device=dev) if G == 4 else None
    with torch.cuda.device(dev):
        rc = getattr(_lib(), f"mxtt_{name}")(
            _DTYPE_CODE[dt], _ptr(c[0]), _ptr(c[1]), _ptr(c[2]),
            _ptr(h0), _ptr(c0), _ptr(wh), _ptr(c[3]), _ptr(c[4]),
            _ptr(c[5]), _ptr(dgx), _ptr(xbuf), _ptr(dwh), _ptr(dbh),
            _ptr(dh0), _ptr(dc0), T, N, H, _stream(dev))
    _check(rc, name)
    return dgx, dwh, dbh, dh0, dc0


def lstm_bwd_cuda(acts, cells, ys, h0, c0, wh, dys, dhT, dcT):
    """Fused-LSTM backward kernel: ``(dgx, dwh, dbh, dh0, dc0)``; the
    cotangents in ys's dtype, dgx in ys's dtype, the rest float32."""
    return _bwd(4, "lstm_bwd", acts, cells, ys, h0, c0, wh, dys, dhT, dcT)


def gru_bwd_cuda(acts, ys, h0, wh, dys, dhT):
    """Fused-GRU backward kernel: ``(dgx, dwh, dbh, dh0)``."""
    dgx, dwh, dbh, dh0, _ = _bwd(3, "gru_bwd", acts, None, ys, h0, None, wh,
                                 dys, dhT, None)
    return dgx, dwh, dbh, dh0


def barrier_floor_cuda(T, H, device):
    """Launch the empty cooperative kernel of T grid barriers over the
    kernels' grid at width H (the serial floor the bounds do not
    cover).  Not counted in ``launches``."""
    with torch.cuda.device(device):
        rc = _lib().mxtt_rnn_barrier_floor(T, H,
                                           _stream(torch.device(device)))
    if rc != 0:
        raise RuntimeError(f"fused_rnn_cuda: barrier floor launch failed "
                           f"with cudaError {rc}")
