"""Wrappers of the Hopper flash-attention kernels.

The kernels replace the TPU kernels of ``mxnet_tpu/ops/flash_attention.py``:
``_fwd_kernel`` (forward: ``o`` and the per-row log-sum-exp),
``_bwd_dq_kernel`` (dQ) and ``_bwd_dkv_kernel`` (dK/dV).  The forward has
two variants, picked by :func:`_fwd_variant` from the operands: ``tc``
(``csrc/flash_fwd_tc.cu``, bf16 tensor cores, within its limits) and
``simt`` (``csrc/flash_attention.cu``, float32 FMAs: float32 and every
other bf16 geometry).  dQ and dK/dV are in ``csrc/flash_attention.cu``.
They are built with ``nvcc`` at the first launch and called through
``ctypes``.  Each wrapper checks what its kernel takes and raises on
anything else; there is no fallback to the plain versions (those are
``ops.flash_attention.flash_attention_fwd_torch`` /
``flash_attention_bwd_torch``, which the CPU path runs), and no retreat
from one variant to the other.  ``launches`` counts each kernel's
launches in this process (``flash_fwd``: the tensor-core forward;
``flash_fwd_simt``: the other).

Tensors are 4-D in either layout (``bhsd``: (B, H, S, D); ``bshd``:
(B, S, H, D)), float32 or bfloat16, on one CUDA device, with a
contiguous last dimension; other strides are passed to the kernels.
K/V may carry fewer heads than q (grouped-query attention).  Row tensors
(``lse``, ``delta``, ``dlse``) are float32 (B, H, Sq), contiguous.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import load_library

__all__ = ["flash_fwd_cuda", "flash_dq_cuda", "flash_dkv_cuda", "launches"]

LIB_NAME = "mxtt_flash_attention"
SOURCES = ("flash_attention.cu", "flash_fwd_tc.cu", "tc_tile.cuh")

# kernel launches in this process, per kernel; reset by whoever counts a
# window
launches = {"flash_fwd": 0, "flash_fwd_simt": 0, "flash_dq": 0,
            "flash_dkv": 0}

# what each kernel takes; a launch outside it returns cudaErrorInvalidValue
LIMITS = {
    "flash_fwd": "bfloat16, head_dim 64 or 128, q/k/v/o 16-byte aligned, "
                 "batch/head/sequence strides multiples of 8 elements",
    "flash_fwd_simt": "float32 or bfloat16, head_dim <= 128",
    "flash_dq": "float32 or bfloat16, head_dim <= 128",
    "flash_dkv": "float32 or bfloat16, head_dim <= 128",
}
_TC_HEAD_DIMS = (64, 128)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = load_library(LIB_NAME, SOURCES)
    if lib.mxtt_flash_fwd.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        tail = [vp, vp, i, i, i, i, f, vp]    # dims, strides, mask, stream
        lib.mxtt_flash_fwd.argtypes = [i] + [vp] * 5 + tail
        lib.mxtt_flash_fwd_tc.argtypes = [i] + [vp] * 5 + tail
        lib.mxtt_flash_dq.argtypes = [i] + [vp] * 8 + tail
        lib.mxtt_flash_dkv.argtypes = [i] + [vp] * 9 + tail
        for fn in (lib.mxtt_flash_fwd, lib.mxtt_flash_fwd_tc,
                   lib.mxtt_flash_dq, lib.mxtt_flash_dkv):
            fn.restype = ctypes.c_int
    return lib


def _need(cond, msg):
    if not cond:
        raise ValueError(f"flash_attention_cuda: {msg}")


def _strides(t, layout):
    """(batch, head, sequence) element strides of a 4-D tensor."""
    sb, s1, s2, _ = t.stride()
    return (sb, s1, s2) if layout == "bhsd" else (sb, s2, s1)


def _geometry(q, k, v, layout, extra=()):
    """Checks the operands and returns (B, Hq, Hkv, Sq, Sk, D)."""
    _need(layout in ("bhsd", "bshd"), f"layout must be bhsd|bshd "
          f"(got {layout!r})")
    _need(q.is_cuda, f"q must be a CUDA tensor (got {q.device})")
    _need(q.dtype in _DTYPE_CODE,
          f"dtype {q.dtype} not float32/bfloat16")
    for t in (q, k, v) + tuple(extra):
        _need(t.dim() == 4, f"tensors must be 4-D, got {tuple(t.shape)}")
        _need(t.device == q.device, f"tensor on {t.device}, q on {q.device}")
        _need(t.dtype == q.dtype, f"dtype {t.dtype} != q's {q.dtype}")
        _need(t.stride(-1) == 1, "the last dimension must be contiguous")
    _need(k.shape == v.shape, "k and v shapes must match")
    if layout == "bhsd":
        B, Hq, Sq, D = q.shape
        Bk, Hkv, Sk, Dk = k.shape
    else:
        B, Sq, Hq, D = q.shape
        Bk, Sk, Hkv, Dk = k.shape
    _need(Bk == B and Dk == D, f"k {tuple(k.shape)} does not fit q "
          f"{tuple(q.shape)} ({layout})")
    _need(Hkv > 0 and Hq % Hkv == 0,
          f"q heads ({Hq}) must be a multiple of kv heads ({Hkv})")
    return B, Hq, Hkv, Sq, Sk, D


def _rows(t, B, H, Sq, name):
    _need(t.dtype == torch.float32 and tuple(t.shape) == (B, H, Sq)
          and t.is_contiguous(),
          f"{name} must be float32 ({B}, {H}, {Sq}) contiguous")


def _call(fn, dtype, ptrs, dims, strides, causal, window, q_offset,
          k_offset, scale, device, name):
    dims_c = (ctypes.c_int * 6)(*dims)
    strides_c = (ctypes.c_longlong * len(strides))(*strides)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(_DTYPE_CODE[dtype], *ptrs, dims_c, strides_c, int(causal),
                int(window), int(q_offset), int(k_offset), float(scale),
                stream)
    if rc != 0:
        # 1 (cudaErrorInvalidValue) is also the kernel refusing a geometry
        # outside its limits
        raise RuntimeError(
            f"flash_attention_cuda: {name} launch failed with cudaError "
            f"{rc}" + (f" (invalid value: the {name} kernel takes "
                       f"{LIMITS[name]})" if rc == 1 else ""))
    launches[name] += 1


def _fwd_variant(dtype, D, ptrs, strides):
    """The forward kernel that takes a call: ``"tc"`` (tensor cores) for
    bfloat16 at head_dim 64 or 128 with 16-byte-aligned ``ptrs`` (q, k,
    v, o) and every stride in ``strides`` (batch, head, sequence of each)
    a multiple of 8 elements; ``"simt"`` for everything else."""
    if dtype != torch.bfloat16 or D not in _TC_HEAD_DIMS:
        return "simt"
    if any(p % 16 for p in ptrs) or any(s % 8 for s in strides):
        return "simt"
    return "tc"


def flash_fwd_cuda(q, k, v, causal=False, scale=None, q_offset=0,
                   k_offset=0, layout="bhsd", window=0):
    """Forward kernel (the variant :func:`_fwd_variant` picks): ``(o,
    lse)``, ``o`` like q, ``lse`` float32 (B, Hq, Sq) (-1e30 on
    fully-masked rows, whose ``o`` is 0)."""
    B, Hq, Hkv, Sq, Sk, D = _geometry(q, k, v, layout)
    _need(window >= 0, f"window must be >= 0 (got {window})")
    o = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    scale = 1.0 / D ** 0.5 if scale is None else scale
    strides = sum((_strides(t, layout) for t in (q, k, v, o)), ())
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    lib = _lib()
    fn, name = ((lib.mxtt_flash_fwd_tc, "flash_fwd")
                if _fwd_variant(q.dtype, D, ptrs, strides) == "tc" else
                (lib.mxtt_flash_fwd, "flash_fwd_simt"))
    _call(fn, q.dtype, ptrs + (lse.data_ptr(),), (B, Hq, Hkv, Sq, Sk, D),
          strides, causal, window, q_offset, k_offset, scale, q.device, name)
    return o, lse


def _bwd_checks(q, k, v, do, lse, delta, dlse, layout, window):
    geo = _geometry(q, k, v, layout, extra=(do,))
    _need(do.shape == q.shape, "do must have q's shape")
    _need(window >= 0, f"window must be >= 0 (got {window})")
    B, Hq, _, Sq, _, _ = geo
    for t, name in ((lse, "lse"), (delta, "delta"), (dlse, "dlse")):
        _need(t.device == q.device, f"{name} on {t.device}")
        _rows(t, B, Hq, Sq, name)
    return geo


def flash_dq_cuda(q, k, v, do, lse, delta, dlse, causal=False, scale=None,
                  q_offset=0, k_offset=0, layout="bhsd", window=0):
    """dQ kernel: ``dq`` like q, from the forward's ``lse`` and the row
    terms ``delta = rowsum(dO * O)`` and ``dlse`` (float32 (B, Hq, Sq))."""
    B, Hq, Hkv, Sq, Sk, D = _bwd_checks(q, k, v, do, lse, delta, dlse,
                                        layout, window)
    dq = torch.empty_like(q)
    if dq.numel() == 0:
        return dq
    scale = 1.0 / D ** 0.5 if scale is None else scale
    strides = sum((_strides(t, layout) for t in (q, k, v, do, dq)), ())
    _call(_lib().mxtt_flash_dq, q.dtype,
          (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr(), dlse.data_ptr(),
           dq.data_ptr()), (B, Hq, Hkv, Sq, Sk, D), strides, causal,
          window, q_offset, k_offset, scale, q.device, "flash_dq")
    return dq


def flash_dkv_cuda(q, k, v, do, lse, delta, dlse, causal=False, scale=None,
                   q_offset=0, k_offset=0, layout="bhsd", window=0):
    """dK/dV kernel: ``(dk, dv)`` like k and v; each kv head sums the
    gradients of its q-head group in registers (no atomics)."""
    B, Hq, Hkv, Sq, Sk, D = _bwd_checks(q, k, v, do, lse, delta, dlse,
                                        layout, window)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    scale = 1.0 / D ** 0.5 if scale is None else scale
    strides = sum((_strides(t, layout) for t in (q, k, v, do, dk, dv)), ())
    _call(_lib().mxtt_flash_dkv, q.dtype,
          (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr(), dlse.data_ptr(),
           dk.data_ptr(), dv.data_ptr()), (B, Hq, Hkv, Sq, Sk, D), strides,
          causal, window, q_offset, k_offset, scale, q.device, "flash_dkv")
    return dk, dv
