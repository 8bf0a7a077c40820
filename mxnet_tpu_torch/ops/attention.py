"""Paged attention for serving: the dispatcher and its plain version.

The port of ``mxnet_tpu/ops/attention.py``'s serving half.  A CUDA
tensor goes to the hand-written Hopper kernel
(``ops/paged_attention_cuda.py``); a CPU tensor goes to the plain torch
path below, which repeats the reference's jnp path step for step (gather
through the block tables, masked float32 softmax, grouped-query heads)
and is the kernel's parity oracle.  ``impl="torch"`` (or
``MXTPU_TORCH_PAGED_ATTENTION=torch``) forces the plain path on any
device; it is a caller's explicit choice, never an automatic retreat.
"""

from __future__ import annotations

import os

import torch

__all__ = ["paged_eligible", "resolve_paged_impl", "paged_attention",
           "paged_attention_torch", "gqa_group"]

ENV_IMPL = "MXTPU_TORCH_PAGED_ATTENTION"


def gqa_group(Hq, Hkv):
    """Validated grouped-query factor: q heads per shared K/V head."""
    if Hkv <= 0 or Hq % Hkv:
        raise ValueError(
            f"grouped-query attention: q heads ({Hq}) must be a "
            f"multiple of kv heads ({Hkv})")
    return Hq // Hkv


def paged_eligible(block_size, head_dim):
    """The reference's cache-geometry gate for its kernel: head_dim a
    multiple of 8 and blocks of at least 4 tokens.  The CUDA kernel
    takes the same geometries (its wrapper states its own limits)."""
    return head_dim % 8 == 0 and block_size >= 4


def resolve_paged_impl(block_size, head_dim, impl=None, device=None):
    """The implementation :func:`paged_attention` runs for this cache
    geometry on ``device`` — ``"cuda"`` or ``"torch"``.

    ``impl`` is ``"auto"`` (default ``MXTPU_TORCH_PAGED_ATTENTION``, else
    auto), ``"cuda"`` or ``"torch"``.  Auto picks the kernel for a CUDA
    device and the plain path for the CPU.  A CUDA device with a
    geometry the kernel does not take raises rather than quietly
    running the plain path: pass ``impl="torch"`` to choose it."""
    if impl is None:
        impl = os.environ.get(ENV_IMPL) or "auto"
    if impl not in ("auto", "cuda", "torch"):
        raise ValueError(f"paged_attention: impl must be auto|cuda|torch "
                         f"(got {impl!r})")
    if impl != "auto":
        return impl
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "cuda":
        return "torch"
    if not paged_eligible(block_size, head_dim):
        raise ValueError(
            f"paged_attention: block_size={block_size}, head_dim="
            f"{head_dim} is outside the CUDA kernel's geometry; pass "
            "impl='torch' to run the plain path on the GPU")
    return "cuda"


def _check_args(q, k_cache, window, k_scale, v_scale):
    if window < 0:
        raise ValueError(f"paged_attention: window must be >= 0 "
                         f"(got {window})")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("paged_attention: k_scale and v_scale must be "
                         "given together")
    return gqa_group(q.shape[1], k_cache.shape[2])


def paged_attention(q, k_cache, v_cache, block_tables, context_lens,
                    window=0, scale=None, k_scale=None, v_scale=None,
                    impl=None):
    """Single-token decode attention over a paged KV-cache.

    Args:
      q: (B, Hq, Dh) — one query token per sequence.
      k_cache/v_cache: (num_blocks, block_size, Hkv, Dh) physical cache
        (one layer's); Hq a multiple of Hkv — kv head g serves q heads
        [g*group, (g+1)*group).
      block_tables: (B, W) int32 physical block ids per sequence in
        logical order, padded with the null block (id 0).
      context_lens: (B,) int32 valid cache entries per sequence (the
        current token's K/V already written).  A row with 0 returns
        zeros, never NaN.
      window: sliding-window radius (0 = full): the query at position
        L-1 sees positions > L-1-window only.
      scale: score scale; default 1/sqrt(Dh).
      k_scale/v_scale: (num_blocks, block_size, Hkv) float32
        dequantization scales of int8 caches; both or neither.
      impl: "auto" | "cuda" | "torch" (see :func:`resolve_paged_impl`).

    Returns (B, Hq, Dh) in q's dtype.
    """
    _check_args(q, k_cache, window, k_scale, v_scale)
    if resolve_paged_impl(k_cache.shape[1], q.shape[2], impl,
                          q.device) == "cuda":
        from .paged_attention_cuda import paged_attention_cuda
        return paged_attention_cuda(
            q, k_cache, v_cache, block_tables, context_lens,
            window=window, scale=scale, k_scale=k_scale, v_scale=v_scale)
    return paged_attention_torch(
        q, k_cache, v_cache, block_tables, context_lens, window=window,
        scale=scale, k_scale=k_scale, v_scale=v_scale)


def paged_attention_torch(q, k_cache, v_cache, block_tables, context_lens,
                          window=0, scale=None, k_scale=None, v_scale=None):
    """The plain torch path of :func:`paged_attention` (any device)."""
    B, Hq, Dh = q.shape
    nb, bs, Hkv, _ = k_cache.shape
    group = _check_args(q, k_cache, window, k_scale, v_scale)
    scale = scale if scale is not None else 1.0 / (Dh ** 0.5)
    tables = block_tables.long()
    S = tables.shape[1] * bs
    # (B, W, bs, Hkv, Dh) -> (B, S, Hkv, Dh): each row's logical view
    k = k_cache[tables].reshape(B, S, Hkv, Dh)
    v = v_cache[tables].reshape(B, S, Hkv, Dh)
    if k_scale is not None:
        k = (k.float() * k_scale[tables].reshape(B, S, Hkv)[..., None]
             ).to(q.dtype)
        v = (v.float() * v_scale[tables].reshape(B, S, Hkv)[..., None]
             ).to(q.dtype)
    qg = q.reshape(B, Hkv, group, Dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k) * scale
    ctx = context_lens.to(device=q.device).long()[:, None]
    pos = torch.arange(S, device=q.device)[None, :]
    keep = pos < ctx
    if window:
        keep = keep & (pos > ctx - 1 - window)
    s = s.masked_fill(~keep[:, None, None, :], float("-inf"))
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", p, v)
    # an all-masked row's softmax is 0/0 = NaN: a dead slot
    # (context_lens == 0) yields zeros instead
    out = torch.where((ctx > 0)[:, :, None, None], out,
                      torch.zeros((), dtype=out.dtype, device=out.device))
    return out.reshape(B, Hq, Dh)
