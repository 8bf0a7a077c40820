"""Wrapper of the Hopper paged-attention decode kernels.

The kernels (``csrc/paged_attention.cu``) replace the TPU kernel
``mxnet_tpu/ops/pallas_paged_attention.py`` ``paged_attention_kernel``:
a split kernel spreads each row's context over ``splits`` CTAs, each
writing float32 partial softmax state, and a combine kernel merges the
splits into the output (with one split the split kernel writes the
output itself).  The split count comes from :func:`_split_plan`, from
shapes and the SM count only: the wrapper never reads ``context_lens``
on the host.  Both are built with ``nvcc`` at the first launch and
called through ``ctypes``.  :func:`paged_attention_cuda` checks what the
kernels take and raises on anything else; there is no fallback to the
plain path (that is ``ops.attention.paged_attention_torch``, the
caller's explicit choice).  ``launches`` counts calls of the op that
launched the kernels (one per layer and decode step), and
``combine_launches`` the combine kernel's launches.

:func:`paged_partials_torch` and :func:`paged_combine_torch` are the two
kernels' plain versions; composed, they equal ``paged_attention_torch``.
The tests and ``chip_smoke.py`` use them, never the decode path.

ctypes note: every pointer and the stream go through ``c_void_p``
argtypes; without them ctypes passes a Python int as a 32-bit C int and
cuts the address.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import load_library

__all__ = ["paged_attention_cuda", "paged_partials_torch",
           "paged_combine_torch", "launches", "combine_launches"]

LIB_NAME = "mxtt_paged_attention"
SOURCES = ("paged_attention.cu",)

# calls of the op in this process (one split launch each, plus one
# combine launch where splits > 1); reset by whoever counts a window
launches = 0
combine_launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

# the split kernel's limits on the plan (csrc/paged_attention.cu)
MAX_TABLE = 512          # table entries a CTA stages: blocks per split
MAX_SPLITS = 65535       # grid z
# The plan's constants.  A split covers at least _MIN_SPLIT_ROWS
# positions (one ring slot of the kernel, whole blocks), and the grid
# aims at _CTAS_PER_SM CTAs an SM.  Chosen from chip_smoke.py's
# `paged_split_sweep` lines (bf16, forced splits at the decode shape and
# at ctx 2048) on an NVIDIA H100 80GB HBM3 at 700 W.
_MIN_SPLIT_ROWS = 64
_CTAS_PER_SM = 3


def _split_plan(B, Hkv, W, bs, sms):
    """``(splits, blocks_per_split)`` for a batch of ``B`` rows, ``Hkv``
    kv heads, a table ``W`` blocks wide of ``bs`` positions, on a card of
    ``sms`` SMs.  Shapes only, never ``context_lens``: one launch
    geometry per batch shape, as CUDA-graph capture needs.

    One split where ``W`` holds fewer than two splits' worth of blocks or
    where ``B * Hkv`` CTAs already reach the target; otherwise enough to
    bring the grid to about ``_CTAS_PER_SM * sms`` CTAs, each split
    covering at least ``_MIN_SPLIT_ROWS`` positions.  ``splits * bps >=
    W``, no split starts beyond ``W``, and ``bps <= MAX_TABLE``.  The
    grid stays within ``max(_CTAS_PER_SM * sms + B * Hkv, B * Hkv *
    ceil(W / MAX_TABLE))`` CTAs."""
    rows = max(1, B * Hkv)
    min_bps = max(1, -(-_MIN_SPLIT_ROWS // bs))
    want = -(-(_CTAS_PER_SM * sms) // rows)
    splits = max(1, min(want, W // min_bps))
    splits = max(splits, -(-W // MAX_TABLE))
    bps = -(-W // splits)
    return -(-W // bps), bps


def _fns():
    lib = load_library(LIB_NAME, SOURCES)
    split, combine = (lib.mxtt_paged_attention_split,
                      lib.mxtt_paged_attention_combine)
    if split.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        split.argtypes = [i, i, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,
                          i, i, i, i, i, i, i, ctypes.c_float, i, i, vp]
        split.restype = ctypes.c_int
        combine.argtypes = [i, vp, vp, vp, vp, i, i, i, vp]
        combine.restype = ctypes.c_int
    return split, combine


def _need(cond, msg):
    if not cond:
        raise ValueError(f"paged_attention_cuda: {msg}")


def _raise_launch(kernel, rc, limits):
    # 1 (cudaErrorInvalidValue) is also the kernel refusing a geometry
    # outside the limits stated in csrc/paged_attention.cu
    raise RuntimeError(
        f"paged_attention_cuda: {kernel} launch failed with cudaError {rc}"
        + (f" (invalid value: {limits})" if rc == 1 else ""))


def paged_attention_cuda(q, k_cache, v_cache, block_tables, context_lens,
                         window=0, scale=None, k_scale=None, v_scale=None,
                         _splits=None):
    """Launch the kernels: same contract as
    ``ops.attention.paged_attention`` (q ``(B, Hq, Dh)`` float32 or
    bfloat16; caches ``(num_blocks, block_size, Hkv, Dh)`` in q's dtype,
    or int8 with float32 ``k_scale``/``v_scale`` ``(num_blocks,
    block_size, Hkv)``; ``block_tables (B, W)`` and ``context_lens
    (B,)`` int32).  Every tensor must be contiguous and on q's CUDA
    device.  Returns ``(B, Hq, Dh)`` in q's dtype.  ``_splits`` forces
    the split count (tests and chip_smoke.py only; the engine never
    passes it)."""
    global launches, combine_launches
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
    if _splits is None:
        splits, bps = _split_plan(
            B, Hkv, W, bs,
            torch.cuda.get_device_properties(dev).multi_processor_count)
    else:
        splits = int(_splits)   # above W leaves splits with nothing live
        _need(1 <= splits <= MAX_SPLITS,
              f"_splits must be in [1, {MAX_SPLITS}] (got {splits})")
        bps = -(-W // splits)
        _need(bps <= MAX_TABLE, f"_splits={splits} gives {bps} blocks a "
              f"split, above the kernel's {MAX_TABLE}")
    out = torch.empty_like(q)
    if B == 0:
        return out
    scale = float(scale) if scale is not None else 1.0 / (Dh ** 0.5)
    if splits > 1:
        part_acc = torch.empty((B, Hq, splits, Dh), dtype=torch.float32,
                               device=dev)
        part_m = torch.empty((B, Hq, splits), dtype=torch.float32,
                             device=dev)
        part_l = torch.empty_like(part_m)
        parts = (part_acc.data_ptr(), part_m.data_ptr(), part_l.data_ptr())
    else:
        parts = (None, None, None)
    split_fn, combine_fn = _fns()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = split_fn(_DTYPE_CODE[q.dtype], _DTYPE_CODE[k_cache.dtype],
                      q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                      k_scale.data_ptr() if quant else None,
                      v_scale.data_ptr() if quant else None,
                      block_tables.data_ptr(), context_lens.data_ptr(),
                      out.data_ptr(), *parts, B, Hq, Hkv, Dh, bs, W,
                      int(window), scale, splits, bps, stream)
        if rc != 0:
            _raise_launch("paged_attention_split", rc,
                          "head_dim a multiple of 8 up to 256, block_size "
                          "up to 128, group up to 32, blocks a split up to "
                          f"{MAX_TABLE}, or shared memory outside the "
                          "kernel's limits")
        if splits > 1:
            rc = combine_fn(_DTYPE_CODE[q.dtype], *parts, out.data_ptr(),
                            B * Hq, splits, Dh, stream)
            if rc != 0:
                _raise_launch("paged_attention_combine", rc,
                              "head_dim up to 256, splits >= 1")
            combine_launches += 1
    launches += 1
    return out


# -- the plain versions of the two kernels ----------------------------------
def paged_partials_torch(q, k_cache, v_cache, block_tables, context_lens,
                         splits, blocks_per_split, window=0, scale=None,
                         k_scale=None, v_scale=None):
    """The split kernel's partial softmax state, in float32: split ``s``
    covers table columns ``[s * bps, (s + 1) * bps)`` and keeps position
    ``pos`` where ``pos < ctx`` (and ``pos > ctx - 1 - window`` with a
    window), as the kernel masks.  Returns ``acc (B, Hq, splits, Dh)``
    (unnormalised), ``m`` and ``l`` ``(B, Hq, splits)``: the max of the
    kept scaled scores (-1e30 where a split keeps none) and the sum of
    ``exp(score - m)``.  K/V are dequantized in float32 (no rounding to
    q's dtype).  Needs ``splits * blocks_per_split >= W``."""
    B, Hq, Dh = q.shape
    _, bs, Hkv, _ = k_cache.shape
    group = Hq // Hkv
    scale = scale if scale is not None else 1.0 / (Dh ** 0.5)
    tables = block_tables.long()
    W = tables.shape[1]
    if splits * blocks_per_split < W:
        raise ValueError(f"paged_partials_torch: {splits} splits of "
                         f"{blocks_per_split} blocks do not cover W={W}")
    S = W * bs
    k = k_cache[tables].reshape(B, S, Hkv, Dh).float()
    v = v_cache[tables].reshape(B, S, Hkv, Dh).float()
    if k_scale is not None:
        k = k * k_scale[tables].reshape(B, S, Hkv)[..., None]
        v = v * v_scale[tables].reshape(B, S, Hkv)[..., None]
    s = torch.einsum("bkgd,bskd->bkgs", q.float().reshape(B, Hkv, group, Dh),
                     k) * scale
    ctx = context_lens.to(device=q.device).long()[:, None]
    pos = torch.arange(S, device=q.device)[None, :]
    keep = pos < ctx
    if window:
        keep = keep & (pos > ctx - 1 - window)
    span = blocks_per_split * bs
    pad = splits * span - S
    s = torch.nn.functional.pad(s, (0, pad)).reshape(
        B, Hkv, group, splits, span)
    keep = torch.nn.functional.pad(keep, (0, pad)).reshape(
        B, 1, 1, splits, span)
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad)).reshape(
        B, splits, span, Hkv, Dh)
    s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(-1)
    m = torch.where(keep.any(-1), m, torch.full_like(m, -1e30))
    p = torch.exp(s - m[..., None])       # masked: exp(-inf) = 0
    acc = torch.einsum("bkgcs,bcskd->bkgcd", p, v)
    return (acc.reshape(B, Hq, splits, Dh), m.reshape(B, Hq, splits),
            p.sum(-1).reshape(B, Hq, splits))


def paged_combine_torch(acc, m, l, dtype):
    """The combine kernel: merge the splits' partial state in float32,
    ``M = max m_s``, ``L = sum l_s e^(m_s - M)``, ``out = sum acc_s
    e^(m_s - M) / L`` (zeros where ``L == 0``), rounded to ``dtype``
    once.  Returns ``(B, Hq, Dh)``."""
    w = torch.exp(m - m.amax(-1, keepdim=True))
    L = (l * w).sum(-1)[..., None]
    o = (acc * w[..., None]).sum(-2)
    live = L > 0
    out = torch.where(live, o / torch.where(live, L, torch.ones_like(L)),
                      torch.zeros_like(o))
    return out.to(dtype)
