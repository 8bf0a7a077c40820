"""Attention-era operators: the training half and paged attention.

The port of ``mxnet_tpu/ops/attention.py``, as plain functions on
tensors.  Training half: :func:`LayerNorm`, :func:`RMSNorm`,
:func:`gelu`, :func:`silu` (statistics and activations in float32, cast
back to the input dtype), :func:`FlashAttention` (the op: the Hopper
kernels or the dense formulation, by ``impl``) and :func:`RoPE`.
``spmd_attention`` is not ported: the port's mesh (``parallel/mesh.py``)
serves tensor-parallel decoding only.  The registered ops of the
training frontend (``LayerNorm``, ``RMSNorm``, ``gelu``, ``silu``,
``FlashAttention``, ``RoPE``: the reference's parameters and shape
rules) call these functions.

Serving half: :func:`paged_attention` calls the custom op
``torch.ops.mxnet_tpu_torch.paged_attention``, registered when this
module is imported.  Inside the op, at run time, a CUDA tensor goes to
the hand-written Hopper paged-attention kernel
(``ops/paged_attention_cuda.py``) and a CPU tensor to the plain torch
path below, which repeats the reference's jnp path step for step
(gather through the block tables, masked float32 softmax, grouped-query
heads) and is the kernel's parity oracle.  Being one op, it is one node
of a ``torch.export`` graph: an exported program holds the call, never
the branch a device took.  ``impl="torch"`` (or
``MXTPU_TORCH_PAGED_ATTENTION=torch``) forces the plain path on any
device; it is a caller's explicit choice, never an automatic retreat.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch

from ..param import Params, field
from .op import OpDef, register_op, register_simple_op

__all__ = ["paged_eligible", "resolve_paged_impl", "paged_attention",
           "paged_attention_torch", "gqa_group", "LayerNorm", "RMSNorm",
           "gelu", "silu", "FlashAttention", "RoPE"]

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
    scale = float(scale) if scale is not None else 1.0 / (q.shape[2] ** 0.5)
    return torch.ops.mxnet_tpu_torch.paged_attention(
        q, k_cache, v_cache, block_tables, context_lens, k_scale, v_scale,
        int(window), scale, impl)


@torch.library.custom_op("mxnet_tpu_torch::paged_attention",
                         mutates_args=())
def _paged_attention_op(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, block_tables: torch.Tensor,
                        context_lens: torch.Tensor,
                        k_scale: Optional[torch.Tensor],
                        v_scale: Optional[torch.Tensor], window: int,
                        scale: float, impl: Optional[str]) -> torch.Tensor:
    """The op behind :func:`paged_attention`: the implementation is
    resolved here, on every call, from the tensors' device (and
    ``impl``/the env), so a graph that holds the op runs the kernel on
    CUDA tensors and the plain path on CPU tensors."""
    if resolve_paged_impl(k_cache.shape[1], q.shape[2], impl,
                          q.device) == "cuda":
        from . import paged_attention_cuda as pac
        return pac.paged_attention_cuda(
            q, k_cache, v_cache, block_tables, context_lens,
            window=window, scale=scale, k_scale=k_scale, v_scale=v_scale)
    return paged_attention_torch(
        q, k_cache, v_cache, block_tables, context_lens, window=window,
        scale=scale, k_scale=k_scale, v_scale=v_scale)


@_paged_attention_op.register_fake
def _paged_attention_fake(q, k_cache, v_cache, block_tables, context_lens,
                          k_scale, v_scale, window, scale, impl):
    return torch.empty_like(q)


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


# -- training half -----------------------------------------------------------
def _axis_shape(x, axis):
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    return shape


def LayerNorm(data, gamma, beta, axis=-1, eps=1e-5):
    """Normalize over ``axis`` with scale and shift; statistics in
    float32 whatever the input dtype, the result cast back to it."""
    axis = axis % data.dim()
    xf = data.float()
    mean = xf.mean(dim=axis, keepdim=True)
    var = (xf - mean).square().mean(dim=axis, keepdim=True)
    shape = _axis_shape(data, axis)
    y = ((xf - mean) * torch.rsqrt(var + eps)
         * gamma.float().reshape(shape) + beta.float().reshape(shape))
    return y.to(data.dtype)


def RMSNorm(data, gamma, axis=-1, eps=1e-5):
    """y = x / rms(x) * gamma (llama-style); statistics in float32."""
    axis = axis % data.dim()
    xf = data.float()
    ms = xf.square().mean(dim=axis, keepdim=True)
    y = xf * torch.rsqrt(ms + eps) * gamma.float().reshape(
        _axis_shape(data, axis))
    return y.to(data.dtype)


def gelu(x):
    """Exact (erf) GELU in float32, cast back to x's dtype."""
    xf = x.float()
    return (0.5 * xf * (1.0 + torch.erf(xf / math.sqrt(2.0)))).to(x.dtype)


def silu(x):
    """x * sigmoid(x) in float32, cast back to x's dtype."""
    xf = x.float()
    return (xf * torch.sigmoid(xf)).to(x.dtype)


def FlashAttention(query, key, value, causal=False, window=0, block_q=512,
                   block_k=512, impl="auto", layout="bhsd"):
    """The ``FlashAttention`` op: softmax(Q K^T / sqrt(D)) V over
    (B, H, S, D) [``layout="bhsd"``] or (B, S, H, D) [``"bshd"``]
    self-attention; K/V may carry fewer heads than Q (grouped-query).

    ``impl`` selects the implementation, as the reference op's does:
    ``"auto"`` launches the Hopper kernels (``ops.flash_attention``) on
    CUDA tensors and runs the dense formulation below on CPU tensors (the
    reference runs its dense path off the TPU); ``"flash"`` runs
    :func:`~mxnet_tpu_torch.ops.flash_attention.flash_attention` on any
    device (its plain version on the CPU); ``"xla"`` runs the dense
    formulation on any device.  The kernels take any sequence length and
    mask ragged tiles, so unlike the reference's ``flash_eligible`` gate
    ``"auto"`` needs no length check.  ``block_q``/``block_k`` are the
    reference's TPU tile bounds, passed through and not used."""
    if impl not in ("auto", "flash", "xla"):
        raise ValueError(f"FlashAttention: impl must be auto|flash|xla "
                         f"(got {impl!r})")
    if layout not in ("bhsd", "bshd"):
        raise ValueError(f"FlashAttention: layout must be bhsd|bshd "
                         f"(got {layout!r})")
    if window < 0:
        raise ValueError(f"FlashAttention: window must be >= 0 "
                         f"(got {window})")
    if impl == "flash" or (impl == "auto" and query.is_cuda):
        from .flash_attention import flash_attention
        return flash_attention(query, key, value, causal=causal,
                               block_q=block_q, block_k=block_k,
                               layout=layout, window=window)
    seq_axis = 1 if layout == "bshd" else 2
    h_ax = 2 if layout == "bshd" else 1
    S = query.shape[seq_axis]
    scale = 1.0 / math.sqrt(query.shape[-1])
    if key.shape[h_ax] != query.shape[h_ax]:
        rep = gqa_group(query.shape[h_ax], key.shape[h_ax])
        key = key.repeat_interleave(rep, dim=h_ax)
        value = value.repeat_interleave(rep, dim=h_ax)
    if layout == "bshd":
        s = torch.einsum("bqhd,bkhd->bhqk", query, key) * scale
    else:
        s = torch.einsum("bhqd,bhkd->bhqk", query, key) * scale
    pos_q = torch.arange(S, device=query.device)[:, None]
    pos_k = torch.arange(S, device=query.device)[None, :]
    keep = None
    if causal:
        keep = pos_q >= pos_k
    if window:
        band = pos_q - pos_k < window
        if not causal:
            band = band & (pos_k - pos_q < window)
        keep = band if keep is None else keep & band
    if keep is not None:
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s.float(), dim=-1).to(query.dtype)
    if layout == "bshd":
        return torch.einsum("bhqk,bkhd->bqhd", p, value)
    return torch.einsum("bhqk,bhkd->bhqd", p, value)


def RoPE(data, base=10000.0, layout="bshd", offset=0):
    """Rotary position embedding: rotates each head-dim pair
    (x_i, x_{i+D/2}) by pos * base^(-2i/D), pos = offset + sequence
    index; computed in float32, cast back to the input dtype."""
    if layout not in ("bshd", "bhsd"):
        raise ValueError(f"RoPE: layout must be bshd|bhsd (got {layout!r})")
    seq_axis = 1 if layout == "bshd" else 2
    S, D = data.shape[seq_axis], data.shape[-1]
    if D % 2:
        raise ValueError(f"RoPE: head_dim must be even, got {D}")
    half = D // 2
    dev = data.device
    inv_freq = torch.pow(
        torch.tensor(float(base), dtype=torch.float32, device=dev),
        -torch.arange(0, half, dtype=torch.float32, device=dev) / half)
    pos = torch.arange(S, dtype=torch.float32, device=dev) + offset
    ang = pos[:, None] * inv_freq[None, :]
    shape = [1] * data.dim()
    shape[seq_axis] = S
    shape[-1] = half
    cos, sin = torch.cos(ang).reshape(shape), torch.sin(ang).reshape(shape)
    xf = data.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(data.dtype)


# -- the registered ops of the training frontend -----------------------------
# Each OpDef's forward calls the function above; FlashAttention's reaches
# the Hopper kernels on CUDA tensors (ops/flash_attention.py's autograd
# Function) and the dense formulation on CPU tensors, by ``impl``.
class LayerNormParam(Params):
    axis = field(int, default=-1)
    eps = field(float, default=1e-5)


@register_op("LayerNorm", aliases=("layernorm",))
class LayerNormOp(OpDef):
    """Normalize over one axis with learnable scale/shift (statistics in
    float32)."""

    param_cls = LayerNormParam

    def list_arguments(self, params):
        return ["data", "gamma", "beta"]

    def infer_shape(self, params, in_shapes):
        d = in_shapes[0]
        if d is None:
            raise ValueError("LayerNorm: data shape unknown")
        c = (d[params.axis % len(d)],)
        return [tuple(d), c, c], [tuple(d)], []

    def forward(self, params, inputs, aux, train, key):
        x, gamma, beta = inputs
        return [LayerNorm(x, gamma, beta, axis=params.axis,
                          eps=params.eps)], []


class RMSNormParam(Params):
    axis = field(int, default=-1)
    eps = field(float, default=1e-5)


@register_op("RMSNorm", aliases=("rmsnorm",))
class RMSNormOp(OpDef):
    """y = x / rms(x) * gamma (statistics in float32)."""

    param_cls = RMSNormParam

    def list_arguments(self, params):
        return ["data", "gamma"]

    def infer_shape(self, params, in_shapes):
        d = in_shapes[0]
        if d is None:
            raise ValueError("RMSNorm: data shape unknown")
        c = (d[params.axis % len(d)],)
        return [tuple(d), c], [tuple(d)], []

    def forward(self, params, inputs, aux, train, key):
        x, gamma = inputs
        return [RMSNorm(x, gamma, axis=params.axis, eps=params.eps)], []


register_simple_op("gelu", gelu, nin=1)
register_simple_op("silu", silu, nin=1)


class FlashAttentionParam(Params):
    causal = field(bool, default=False)
    # sliding-window (local) attention radius; 0 = full attention
    window = field(int, default=0)
    block_q = field(int, default=512)
    block_k = field(int, default=512)
    impl = field(str, default="auto", enum=("auto", "flash", "xla"))
    layout = field(str, default="bhsd", enum=("bhsd", "bshd"))
    # the schedule of a sequence-sharded program (ROADMAP §A18); one
    # device runs no such program, so it is carried and not used
    sp_impl = field(str, default="ring", enum=("ring", "ulysses"))


@register_op("FlashAttention", aliases=("flashattention",))
class FlashAttentionOp(OpDef):
    """softmax(Q K^T / sqrt(D)) V over (B, H, S, D) [layout='bhsd'] or
    (B, S, H, D) [layout='bshd']; K/V may carry fewer heads than Q.
    ``impl="auto"`` launches the Hopper flash kernels on CUDA tensors
    and runs the dense formulation on CPU tensors; ``"flash"`` runs
    ``ops.flash_attention`` on any device (its plain versions on the
    CPU); ``"xla"`` the dense formulation."""

    param_cls = FlashAttentionParam

    def list_arguments(self, params):
        return ["query", "key", "value"]

    def infer_shape(self, params, in_shapes):
        q = in_shapes[0]
        kv = in_shapes[1] or in_shapes[2]
        if q is None and kv is None:
            raise ValueError("FlashAttention: input shapes unknown")
        if q is None:
            q = kv
        if kv is None:
            kv = q          # MHA default; GQA needs k/v shapes known
        return [tuple(q), tuple(kv), tuple(kv)], [tuple(q)], []

    def forward(self, params, inputs, aux, train, key):
        q, k, v = inputs
        return [FlashAttention(q, k, v, causal=params.causal,
                               window=params.window, block_q=params.block_q,
                               block_k=params.block_k, impl=params.impl,
                               layout=params.layout)], []


class RoPEParam(Params):
    base = field(float, default=10000.0)
    layout = field(str, default="bshd", enum=("bshd", "bhsd"))
    offset = field(int, default=0)


@register_op("RoPE", aliases=("rope",))
class RoPEOp(OpDef):
    """Rotary position embedding of each head-dim pair."""

    param_cls = RoPEParam

    def list_arguments(self, params):
        return ["data"]

    def infer_shape(self, params, in_shapes):
        d = in_shapes[0]
        if d is None:
            raise ValueError("RoPE: data shape unknown")
        if d[-1] % 2:
            raise ValueError(f"RoPE: head_dim must be even, got {d[-1]}")
        return [tuple(d)], [tuple(d)], []

    def forward(self, params, inputs, aux, train, key):
        return [RoPE(inputs[0], base=params.base, layout=params.layout,
                     offset=params.offset)], []
