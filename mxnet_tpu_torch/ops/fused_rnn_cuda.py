"""Wrappers of the Hopper fused-LSTM and fused-GRU kernels.

The kernels (``csrc/fused_rnn.cuh``, one translation unit each:
``csrc/fused_{lstm,gru}_{fwd,bwd}.cu``) replace the TPU kernels of
``mxnet_tpu/ops/pallas_lstm.py`` (``_fwd_kernel``, ``_bwd_kernel``) and
``mxnet_tpu/ops/pallas_gru.py`` (``_fwd_kernel``, ``_bwd_kernel``).  The
forward and the backward each have three variants, picked by
:func:`_fwd_variant` and :func:`_bwd_variant` from the dtype and the
geometry: ``tc`` (bf16 tensor cores over thread-block clusters of 16
CTAs: ``csrc/fused_rnn_fwd_tc.cuh``, units ``csrc/fused_{lstm,gru}_fwd_tc.cu``,
h_{t-1} multicast to the cluster; ``csrc/fused_rnn_bwd_tc.cuh``, units
``csrc/fused_{lstm,gru}_bwd_tc.cu``, the recurrent product split by K
across the cluster), ``tc32`` (float32 on tensor cores through split-TF32
products over the same clusters: ``csrc/fused_rnn_fwd_f32tc.cuh``, units
``csrc/fused_{lstm,gru}_fwd_f32tc.cu``; ``csrc/fused_rnn_bwd_f32tc.cuh``,
units ``csrc/fused_{lstm,gru}_bwd_f32tc.cu``) and ``simt``
(``rnn_fwd_kernel`` and ``rnn_bwd_kernel`` in ``csrc/fused_rnn.cuh``:
float32 FMAs, for every geometry outside the tensor-core kernels'
limits).  They are built with ``nvcc`` at the first launch and called
through ``ctypes``.
Each wrapper checks what its kernel takes and raises on anything else; a
failed build or launch (a refused cluster or cooperative launch too)
raises its ``cudaError``, and there is no fallback to the plain versions
(those are ``ops.fused_lstm.fused_lstm_{fwd,bwd}_torch`` and
``ops.fused_gru.fused_gru_{fwd,bwd}_torch``, which the CPU path runs) nor
from one variant to the other.  ``launches`` counts each kernel's
launches in this process (``lstm_fwd``/``lstm_bwd``/``gru_fwd``/
``gru_bwd``: the bf16 tensor-core kernels; ``lstm_fwd_f32``/
``lstm_bwd_f32``/``gru_fwd_f32``/``gru_bwd_f32``: the float32 tensor-core
kernels; the ``_simt`` names: the others).

gx (T, N, G H) is float32 or bfloat16; wh is cast to gx's dtype (the
product's operand type, as the TPU kernels cast it) and bh to float32;
h0/c0 are float32 (N, H).  Every tensor is made contiguous.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from .._build import load_library
from .fused_lstm import KERNEL_DTYPES

__all__ = ["lstm_fwd_cuda", "lstm_bwd_cuda", "gru_fwd_cuda", "gru_bwd_cuda",
           "barrier_floor_cuda", "split_barrier_floor_cuda", "launches",
           "last_tc_plan", "last_fwd_tc_plan"]

LIB_NAME = "mxtt_fused_rnn"
SOURCES = ("fused_rnn.cuh", "fused_lstm_fwd.cu", "fused_lstm_bwd.cu",
           "fused_gru_fwd.cu", "fused_gru_bwd.cu", "rnn_tc_sync.cuh",
           "tc_tile.cuh", "fused_rnn_bwd_tc.cuh", "fused_lstm_bwd_tc.cu",
           "fused_gru_bwd_tc.cu", "fused_rnn_fwd_tc.cuh",
           "fused_lstm_fwd_tc.cu", "fused_gru_fwd_tc.cu", "tf32x3.cuh",
           "fused_rnn_bwd_f32tc.cuh", "fused_lstm_bwd_f32tc.cu",
           "fused_gru_bwd_f32tc.cu", "fused_rnn_fwd_f32tc.cuh",
           "fused_lstm_fwd_f32tc.cu", "fused_gru_fwd_f32tc.cu")

# kernel launches in this process, per kernel; reset by whoever counts a
# window
launches = {"lstm_fwd": 0, "lstm_fwd_f32": 0, "lstm_fwd_simt": 0,
            "lstm_bwd": 0, "lstm_bwd_f32": 0, "lstm_bwd_simt": 0,
            "gru_fwd": 0, "gru_fwd_f32": 0, "gru_fwd_simt": 0, "gru_bwd": 0,
            "gru_bwd_f32": 0, "gru_bwd_simt": 0}

# the last tensor-core backward's and forward's (each bf16 or float32)
# launch plans: cluster size C, grid CTAs, shared-memory bytes and units a CTA
last_tc_plan = {}
last_fwd_tc_plan = {}

# The tensor-core kernels' limits (csrc/fused_rnn_{fwd,bwd}_tc.cuh and
# csrc/fused_rnn_{fwd,bwd}_f32tc.cuh, Limits): registers sized for N <= 32
# (two m16 tiles of the batch) and H <= 512 (the bf16 backward: 4 pairs of
# dWh n-tiles and 8 k-steps of Wh fragments a warp; the float32 backward:
# 16 k-steps of Wh fragments and 64 dWh columns a warp; the bf16 forward:
# 8 k16-steps a warp; the float32 forward: 8 k8-steps a warp), H a
# multiple of 8 (16-byte rows), and their shared memory (tc_smem_bytes,
# tc32_smem_bytes, fwd_tc_smem_bytes, fwd_tc32_smem_bytes) within a
# block's 227 KB.  A CTA owns TC_HS hidden units, a cluster TC_CLUSTER
# CTAs.
TC_MAX_N, TC_MAX_H = 32, 512
TC_HS, TC_CLUSTER = 8, 16
_SMEM_MAX = 232448
_TC_FWD_SPLIT_K = 4            # the bf16 forward's product: K-quarters
_TC32_FWD_SPLIT_K = 8          # the float32 forward's: K parts, one a warp
_TC_PART_STRIDE = 40           # floats a row of a quarter's partial sums
# the float32 backward's dWh sums: 8 warps x 8 n-tiles x 2 m-tiles of
# 16-byte fragments a lane
_TC32_DWH_BYTES = 8 * 8 * 2 * 32 * 16

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
        for mode in ("lstm", "gru"):
            for suffix in ("tc", "f32tc"):
                tc = getattr(lib, f"mxtt_{mode}_bwd_{suffix}")
                tc.argtypes = [vp] * 16 + [i] * 3 + [vp, vp]
                tc.restype = ctypes.c_int
            for suffix in ("tc", "f32tc"):
                fwd_tc = getattr(lib, f"mxtt_{mode}_fwd_{suffix}")
                fwd_tc.argtypes = [vp] * 11 + [i] * 4 + [vp, vp]
                fwd_tc.restype = ctypes.c_int
        lib.mxtt_rnn_split_barrier_floor.argtypes = [i] * 3 + [vp] * 3
        lib.mxtt_rnn_split_barrier_floor.restype = ctypes.c_int
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
        # 82 (cudaErrorCooperativeLaunchTooLarge): a grid (or, for the
        # tensor-core kernels, its clusters) not co-resident
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


def _fwd(G, name, gx, h0, c0, wh, bh, save, variant=None):
    T, N, H = _fwd_checks(gx, h0, wh, G, c0)
    dt, dev = gx.dtype, gx.device
    _need(bh.numel() == G * H and bh.device == dev,
          f"bh must hold {G * H} values on {dev}")
    variant = variant or _fwd_variant(dt, N, H, G)
    _need(variant in ("tc", "tc32", "simt"), f"unknown variant {variant!r}")
    _need(variant != "tc" or dt == torch.bfloat16,
          f"the tc forward takes bfloat16, not {dt}")
    _need(variant != "tc32" or dt == torch.float32,
          f"the tc32 forward takes float32, not {dt}")
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
    ptrs = (_ptr(gx), _ptr(h0), _ptr(c0), _ptr(wh), _ptr(bh), _ptr(ys),
            _ptr(hT), _ptr(cT), _ptr(acts), _ptr(cells))
    with _launch_stream(dev) as stream:
        if variant != "simt":
            ctr = torch.zeros(1, dtype=torch.int32, device=dev)
            info = (ctypes.c_int * 3)()
            entry = "tc" if variant == "tc" else "f32tc"
            rc = getattr(_lib(), f"mxtt_{name}_{entry}")(
                *ptrs, _ptr(ctr), T, N, H, int(save), info, stream)
            if rc == 0:
                last_fwd_tc_plan.clear()
                last_fwd_tc_plan.update(C=info[0], grid=info[1],
                                        smem_bytes=info[2], hs=TC_HS)
        else:
            rc = getattr(_lib(), f"mxtt_{name}")(
                _DTYPE_CODE[dt], *ptrs, T, N, H, int(save), stream)
    _check(rc, {"tc": name, "tc32": f"{name}_f32",
                "simt": f"{name}_simt"}[variant])
    return ys, hT, cT, acts, cells


def lstm_fwd_cuda(gx, h0, c0, wh, bh, save=True, _variant=None):
    """Fused-LSTM forward kernel: ``(ys, hT, cT, acts, cells)``, the
    residuals (float32 acts (T, N, 4H), cells (T, N, H)) None without
    ``save``.  ``_variant`` ("tc", "tc32" or "simt") overrides
    :func:`_fwd_variant`: for tests and timings only."""
    return _fwd(4, "lstm_fwd", gx, h0, c0, wh, bh, save, _variant)


def gru_fwd_cuda(gx, h0, wh, bh, save=True, _variant=None):
    """Fused-GRU forward kernel: ``(ys, hT, acts)``, acts the float32
    (T, N, 4H) (r, z, n, hp_n), None without ``save``; ``_variant`` as
    :func:`lstm_fwd_cuda`'s."""
    ys, hT, _, acts, _ = _fwd(3, "gru_fwd", gx, h0, None, wh, bh, save,
                              _variant)
    return ys, hT, acts


def _cdiv(a, b):
    return -(-a // b)


def tc_smem_bytes(N, H, G):
    """Shared memory of the tensor-core backward, in bytes: the layout of
    ``tc_geo`` (csrc/fused_rnn_bwd_tc.cuh) in closed form."""
    up = lambda a, b: _cdiv(a, b) * b
    mt = _cdiv(N, 16)                          # m16 tiles of the batch
    r = G * TC_HS                              # the CTA's rows of dWh
    return (16 * mt * (up(_cdiv(G * H, TC_CLUSTER), 16) + 8) * 2  # slice
            + 2 * 16 * mt * (up(H, 16) + 8) * 2         # h_prev, two halves
            + 2 * up(r, 16) * (16 * mt + 8) * 2         # dg_lo^T, two halves
            + 2 * up(N * r * 4, 16)                     # dgates, two halves
            + N * r * 2                                 # staged X_t
            + TC_CLUSTER * 16 * mt * 8 * 4 + 16)        # partials, mbarriers


def tc32_smem_bytes(N, H, G):
    """Shared memory of the float32 tensor-core backward, in bytes: the
    layout of ``tc32_geo`` (csrc/fused_rnn_bwd_f32tc.cuh) in closed form.
    At most 195,600 (N 32, H 512, G 4) within its limits."""
    up = lambda a, b: _cdiv(a, b) * b
    mt, kb = _cdiv(N, 16), _cdiv(N, 8)         # m16 tiles, k8 steps
    return (2 * 16 * mt * (up(_cdiv(G * H, TC_CLUSTER), 8) + 4) * 4
            + 8 * kb * (up(H, 32) + 8) * 4              # slice; h_prev
            + _TC32_DWH_BYTES                           # dWh sums
            + 2 * 32 * (8 * kb + 4) * 4                 # dg^T, big/small
            + N * G * TC_HS * 4                         # staged X_t
            + TC_CLUSTER * 16 * mt * 8 * 4 + 16)        # partials, mbarrier


def fwd_tc_smem_bytes(N, H):
    """Shared memory of the tensor-core forward, in bytes: the layout of
    ``fwd_geo`` (csrc/fused_rnn_fwd_tc.cuh) in closed form, the same for
    both gate counts."""
    up = lambda a, b: _cdiv(a, b) * b
    mt = _cdiv(N, 16)                          # m16 tiles of the batch
    return (2 * 16 * mt * (up(H, 16) + 8) * 2           # h, two halves
            + _TC_FWD_SPLIT_K * 16 * mt * _TC_PART_STRIDE * 4  # partials
            + N * TC_HS * 2 + 16)                       # staged h, mbarriers


def fwd_tc32_smem_bytes(N, H):
    """Shared memory of the float32 tensor-core forward, in bytes: the
    layout of ``fwd32_geo`` (csrc/fused_rnn_fwd_f32tc.cuh) in closed form,
    the same for both gate counts.  At most 174,096 (N 32, H 512) within
    its limits."""
    up = lambda a, b: _cdiv(a, b) * b
    mt = _cdiv(N, 16)                          # m16 tiles of the batch
    return (2 * 16 * mt * (up(H, 32) + 4) * 4           # h, two halves
            + _TC32_FWD_SPLIT_K * 16 * mt * _TC_PART_STRIDE * 4  # partials
            + N * TC_HS * 4 + 16)                       # staged h, mbarriers


def _tc_limits(dtype, N, H, want=torch.bfloat16):
    return (dtype == want and 1 <= N <= TC_MAX_N and H % 8 == 0
            and 8 <= H <= TC_MAX_H)


def _fwd_variant(dtype, N, H, G):
    """Which forward kernel takes a layer of G gates: ``"tc"`` (bf16
    tensor cores) where its limits hold (bfloat16, N <= 32, H a multiple
    of 8 up to 512, its shared memory within 227 KB; the same for both
    gate counts), ``"tc32"`` (float32 tensor cores, split TF32) where the
    same limits hold in float32 (:func:`fwd_tc32_smem_bytes` within 227
    KB), else ``"simt"``.  A pure function of its arguments, decided on
    the host."""
    if _tc_limits(dtype, N, H) and fwd_tc_smem_bytes(N, H) <= _SMEM_MAX:
        return "tc"
    if (_tc_limits(dtype, N, H, torch.float32)
            and fwd_tc32_smem_bytes(N, H) <= _SMEM_MAX):
        return "tc32"
    return "simt"


def _bwd_variant(dtype, N, H, G):
    """Which backward kernel takes a layer: ``"tc"`` (bf16 tensor cores)
    where its limits hold (bfloat16, N <= 32, H a multiple of 8 up to
    512, its shared memory within 227 KB), ``"tc32"`` (float32 tensor
    cores, split TF32) where the same limits hold in float32
    (:func:`tc32_smem_bytes` within 227 KB), else ``"simt"``.
    A pure function of its arguments, decided on the host."""
    if _tc_limits(dtype, N, H) and tc_smem_bytes(N, H, G) <= _SMEM_MAX:
        return "tc"
    if (_tc_limits(dtype, N, H, torch.float32)
            and tc32_smem_bytes(N, H, G) <= _SMEM_MAX):
        return "tc32"
    return "simt"


def _bwd_checks(G, acts, cells, ys, h0, c0, wh, dys, dhT, dcT):
    """Checks the backward's operands and returns (T, N, H)."""
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
    return T, N, H


@contextlib.contextmanager
def _launch_stream(device):
    """Makes ``device`` current and yields its current stream (an int)."""
    with torch.cuda.device(device):
        yield _stream(device)


def _bwd(G, name, acts, cells, ys, h0, c0, wh, dys, dhT, dcT, variant=None):
    T, N, H = _bwd_checks(G, acts, cells, ys, h0, c0, wh, dys, dhT, dcT)
    dt, dev = ys.dtype, ys.device
    variant = variant or _bwd_variant(dt, N, H, G)
    _need(variant in ("tc", "tc32", "simt"), f"unknown variant {variant!r}")
    _need(variant != "tc" or dt == torch.bfloat16,
          f"the tc backward takes bfloat16, not {dt}")
    _need(variant != "tc32" or dt == torch.float32,
          f"the tc32 backward takes float32, not {dt}")
    c = [None if t is None else t.contiguous()
         for t in (acts, cells, ys, dys, dhT, dcT)]
    if variant != "simt" and c[2].data_ptr() % 16:
        c[2] = c[2].clone()      # the bulk copies of ys rows: 16-byte aligned
    h0 = h0.float().contiguous()
    if variant == "tc32" and h0.data_ptr() % 16:
        h0 = h0.clone()          # and of h0's
    c0 = None if c0 is None else c0.float().contiguous()
    wh = wh.to(dt).contiguous()
    dgx = torch.empty(T, N, G * H, dtype=dt, device=dev)
    xbuf = (torch.empty(2, N, G * H, dtype=dt, device=dev) if G == 3
            else None)
    dwh = torch.empty(G * H, H, device=dev)
    dbh = torch.empty(G * H, device=dev)
    dh0 = torch.empty(N, H, device=dev)
    dc0 = torch.empty(N, H, device=dev) if G == 4 else None
    ptrs = (_ptr(c[0]), _ptr(c[1]), _ptr(c[2]), _ptr(h0), _ptr(c0),
            _ptr(wh), _ptr(c[3]), _ptr(c[4]), _ptr(c[5]), _ptr(dgx),
            _ptr(xbuf), _ptr(dwh), _ptr(dbh), _ptr(dh0), _ptr(dc0))
    with _launch_stream(dev) as stream:
        if variant == "simt":
            rc = getattr(_lib(), f"mxtt_{name}")(
                _DTYPE_CODE[dt], *ptrs, T, N, H, stream)
        else:
            ctr = torch.zeros(1, dtype=torch.int32, device=dev)
            info = (ctypes.c_int * 3)()
            entry = "tc" if variant == "tc" else "f32tc"
            rc = getattr(_lib(), f"mxtt_{name}_{entry}")(
                *ptrs, _ptr(ctr), T, N, H, info, stream)
            if rc == 0:
                last_tc_plan.clear()
                last_tc_plan.update(C=info[0], grid=info[1],
                                    smem_bytes=info[2], hs=TC_HS)
    _check(rc, {"tc": name, "tc32": f"{name}_f32",
                "simt": f"{name}_simt"}[variant])
    return dgx, dwh, dbh, dh0, dc0


def lstm_bwd_cuda(acts, cells, ys, h0, c0, wh, dys, dhT, dcT, _variant=None):
    """Fused-LSTM backward kernel: ``(dgx, dwh, dbh, dh0, dc0)``; the
    cotangents in ys's dtype, dgx in ys's dtype, the rest float32.
    ``_variant`` ("tc", "tc32" or "simt") overrides :func:`_bwd_variant`:
    for tests and timings only."""
    return _bwd(4, "lstm_bwd", acts, cells, ys, h0, c0, wh, dys, dhT, dcT,
                _variant)


def gru_bwd_cuda(acts, ys, h0, wh, dys, dhT, _variant=None):
    """Fused-GRU backward kernel: ``(dgx, dwh, dbh, dh0)``; ``_variant``
    as :func:`lstm_bwd_cuda`'s."""
    dgx, dwh, dbh, dh0, _ = _bwd(3, "gru_bwd", acts, None, ys, h0, None, wh,
                                 dys, dhT, None, _variant)
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


def split_barrier_floor_cuda(T, N, H, device):
    """Launch T arrive/wait pairs of the tensor-core backward's split
    barrier over the launch the LSTM kernel takes at (N, H) (same grid,
    clusters and shared memory): its serial floor.  Returns the plan
    (C, grid, shared-memory bytes).  Not counted in ``launches``."""
    dev = torch.device(device)
    with torch.cuda.device(dev):
        ctr = torch.zeros(1, dtype=torch.int32, device=dev)
        info = (ctypes.c_int * 3)()
        rc = _lib().mxtt_rnn_split_barrier_floor(T, N, H, _ptr(ctr), info,
                                                 _stream(dev))
    if rc != 0:
        raise RuntimeError(f"fused_rnn_cuda: split barrier floor launch "
                           f"failed with cudaError {rc}")
    return {"C": info[0], "grid": info[1], "smem_bytes": info[2],
            "hs": TC_HS}
