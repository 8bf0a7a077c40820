"""Wrapper of the Hopper paged-attention decode kernel.

The kernel (``csrc/paged_attention.cu``) replaces the TPU kernel
``mxnet_tpu/ops/pallas_paged_attention.py`` ``paged_attention_kernel``.
It is built with ``nvcc`` at the first launch and called through
``ctypes``.  :func:`paged_attention_cuda` checks what the kernel takes
and raises on anything else; there is no fallback to the plain path
(that is ``ops.attention.paged_attention_torch``, the caller's explicit
choice).  ``launches`` counts the kernel launches of this process.

ctypes note: every pointer and the stream go through ``c_void_p``
argtypes; without them ctypes passes a Python int as a 32-bit C int and
cuts the address.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import load_library

__all__ = ["paged_attention_cuda", "launches"]

LIB_NAME = "mxtt_paged_attention"
SOURCES = ("paged_attention.cu",)

# kernel launches in this process; reset by whoever counts a window
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _fn():
    lib = load_library(LIB_NAME, SOURCES)
    fn = lib.mxtt_paged_attention_decode
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i, vp, vp, vp, vp, vp, vp, vp, vp,
                       i, i, i, i, i, i, i, ctypes.c_float, vp]
        fn.restype = ctypes.c_int
    return fn


def _need(cond, msg):
    if not cond:
        raise ValueError(f"paged_attention_cuda: {msg}")


def paged_attention_cuda(q, k_cache, v_cache, block_tables, context_lens,
                         window=0, scale=None, k_scale=None, v_scale=None):
    """Launch the kernel: same contract as
    ``ops.attention.paged_attention`` (q ``(B, Hq, Dh)`` float32 or
    bfloat16; caches ``(num_blocks, block_size, Hkv, Dh)`` in q's dtype,
    or int8 with float32 ``k_scale``/``v_scale`` ``(num_blocks,
    block_size, Hkv)``; ``block_tables (B, W)`` and ``context_lens
    (B,)`` int32).  Every tensor must be contiguous and on q's CUDA
    device.  Returns ``(B, Hq, Dh)`` in q's dtype."""
    global launches
    _need(q.is_cuda, f"q must be a CUDA tensor (got {q.device})")
    dev = q.device
    _need(q.dim() == 3, f"q must be (B, Hq, Dh), got {tuple(q.shape)}")
    _need(k_cache.dim() == 4 and k_cache.shape == v_cache.shape,
          "k_cache/v_cache must both be (num_blocks, block_size, Hkv, Dh)")
    B, Hq, Dh = q.shape
    nb, bs, Hkv, cDh = k_cache.shape
    _need(cDh == Dh, f"cache head_dim {cDh} != q head_dim {Dh}")
    _need(Hkv > 0 and Hq % Hkv == 0,
          f"q heads ({Hq}) must be a multiple of kv heads ({Hkv})")
    _need(q.dtype in (torch.float32, torch.bfloat16),
          f"q dtype {q.dtype} not float32/bfloat16")
    _need(window >= 0, f"window must be >= 0 (got {window})")
    _need((k_scale is None) == (v_scale is None),
          "k_scale and v_scale must be given together")
    quant = k_scale is not None
    if quant:
        _need(k_cache.dtype == torch.int8 and v_cache.dtype == torch.int8,
              "scaled caches must be int8")
        for sc in (k_scale, v_scale):
            _need(sc.dtype == torch.float32 and tuple(sc.shape)
                  == (nb, bs, Hkv),
                  f"scales must be float32 ({nb}, {bs}, {Hkv})")
    else:
        _need(k_cache.dtype == q.dtype and v_cache.dtype == q.dtype,
              f"cache dtype {k_cache.dtype} must equal q's {q.dtype} "
              "(or be int8 with scales)")
    _need(block_tables.dim() == 2 and block_tables.shape[0] == B,
          f"block_tables must be ({B}, W)")
    _need(tuple(context_lens.shape) == (B,), f"context_lens must be ({B},)")
    _need(block_tables.dtype == torch.int32
          and context_lens.dtype == torch.int32,
          "block_tables and context_lens must be int32")
    W = block_tables.shape[1]
    _need(W > 0, "block_tables needs at least one column")
    tensors = [q, k_cache, v_cache, block_tables, context_lens]
    if quant:
        tensors += [k_scale, v_scale]
    for t in tensors:
        _need(t.device == dev, f"tensor on {t.device}, q on {dev}")
        _need(t.is_contiguous(), "every tensor must be contiguous")
    # 16-byte cp.async copies read the caches
    _need(k_cache.data_ptr() % 16 == 0 and v_cache.data_ptr() % 16 == 0,
          "caches must be 16-byte aligned")
    out = torch.empty_like(q)
    if B == 0:
        return out
    scale = float(scale) if scale is not None else 1.0 / (Dh ** 0.5)
    fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(_DTYPE_CODE[q.dtype], _DTYPE_CODE[k_cache.dtype],
                q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                k_scale.data_ptr() if quant else None,
                v_scale.data_ptr() if quant else None,
                block_tables.data_ptr(), context_lens.data_ptr(),
                out.data_ptr(), B, Hq, Hkv, Dh, bs, W, int(window), scale,
                stream)
    if rc != 0:
        # 1 (cudaErrorInvalidValue) is also the kernel refusing a geometry
        # outside the limits stated in csrc/paged_attention.cu
        raise RuntimeError(
            f"paged_attention_cuda: launch failed with cudaError {rc}"
            + (" (invalid value: head_dim, block_size, group or shared "
               "memory outside the kernel's limits)" if rc == 1 else ""))
    launches += 1
    return out
