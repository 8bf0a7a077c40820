"""Flash attention: the Hopper kernels' autograd wrapper and their plain
versions.

The port of ``mxnet_tpu/ops/flash_attention.py``.  :func:`flash_attention`
keeps the reference's signature and contract: ``bhsd``/``bshd`` layouts,
grouped-query K/V, causal and bidirectional sliding windows with the
reference's band rules, ``q_offset``/``k_offset`` position shifts with
``Sq != Sk``, fully-masked rows giving ``o = 0`` and ``lse = -1e30``
(never NaN), and a differentiable float32 ``lse`` (B, H, Sq).

:class:`_Flash` replaces the reference's ``custom_vjp``.  On CUDA tensors
its forward launches the forward kernel and its backward computes
``delta = rowsum(dO * O)`` in float32, as the reference's ``_bwd`` does,
then launches the dQ and the dK/dV kernels (``ops/flash_attention_cuda``).
On CPU tensors it runs :func:`flash_attention_fwd_torch` and
:func:`flash_attention_bwd_torch`, the plain versions, which keep the
reference kernels' rounding points: ``p`` in v's dtype before P.V, ``ds``
in the input dtype before the dQ/dK products, ``dO`` in q's dtype.
"""

from __future__ import annotations

import torch

from .attention import gqa_group

__all__ = ["flash_attention", "flash_attention_fwd_torch",
           "flash_attention_bwd_torch", "flash_attention_fwd_tf32",
           "flash_attention_dkv_tf32", "round_tf32", "gqa_group"]

NEG_INF = -1e30      # the reference kernels' fully-masked sentinel
_TINY = 1e-30


def _dims(q, k, layout):
    if layout == "bshd":
        B, Sq, H, D = q.shape
        return B, H, Sq, D, k.shape[1], k.shape[2]
    if layout != "bhsd":
        raise ValueError(f"flash_attention: layout must be bhsd|bshd "
                         f"(got {layout!r})")
    B, H, Sq, D = q.shape
    return B, H, Sq, D, k.shape[2], k.shape[1]


def _bhsd(x, layout):
    return x if layout == "bhsd" else x.transpose(1, 2)


def _keep(Sq, Sk, causal, q_offset, k_offset, window, device):
    """(Sq, Sk) bool mask of kept scores (the reference's ``_mask_for``
    over global positions), or None when nothing is masked."""
    if not causal and not window:
        return None
    qp = q_offset + torch.arange(Sq, device=device)[:, None]
    kp = k_offset + torch.arange(Sk, device=device)[None, :]
    if causal:
        keep = qp >= kp
        if window:
            keep = keep & (qp - kp < window)
        return keep
    return (qp - kp < window) & (kp - qp < window)


def _expand(x, group):
    return x if group == 1 else x.repeat_interleave(group, dim=1)


def flash_attention_fwd_torch(q, k, v, causal=False, scale=None,
                              q_offset=0, k_offset=0, layout="bhsd",
                              window=0):
    """Plain version of the forward kernel: ``(o, lse)`` with ``o`` in
    q's layout and dtype, ``lse`` float32 (B, H, Sq)."""
    B, H, Sq, D, Sk, Hkv = _dims(q, k, layout)
    group = gqa_group(H, Hkv)
    scale = 1.0 / D ** 0.5 if scale is None else scale
    qh = _bhsd(q, layout)
    kh = _expand(_bhsd(k, layout), group)
    vh = _expand(_bhsd(v, layout), group)
    # q.k products of the input values, summed in float32
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    keep = _keep(Sq, Sk, causal, q_offset, k_offset, window, q.device)
    if keep is not None:
        s = s.masked_fill(~keep, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if keep is not None:
        # a fully-masked row has m == NEG_INF and would get p == 1
        p = p.masked_fill(~keep, 0.0)
    l_row = p.sum(dim=-1)
    valid = l_row > 0.0
    l_fin = l_row.clamp_min(_TINY)
    # p rounded to v's dtype before P.V, as the kernel does
    o = torch.matmul(p.to(v.dtype).float(), vh.float()) / l_fin[..., None]
    o = torch.where(valid[..., None], o, torch.zeros((), device=o.device))
    lse = torch.where(valid, m[..., 0] + torch.log(l_fin),
                      torch.full((), NEG_INF, device=o.device))
    return _bhsd(o.to(q.dtype), layout), lse


def flash_attention_bwd_torch(q, k, v, o, lse, do, dlse=None, causal=False,
                              scale=None, q_offset=0, k_offset=0,
                              layout="bhsd", window=0):
    """Plain version of the two backward kernels: ``(dq, dk, dv)`` from
    the forward's ``o`` and ``lse`` and the output gradients ``do`` and
    ``dlse`` (None: zero).  P is recomputed from ``lse`` as the kernels
    do; each kv head sums its group's gradients in float32."""
    B, H, Sq, D, Sk, Hkv = _dims(q, k, layout)
    group = gqa_group(H, Hkv)
    scale = 1.0 / D ** 0.5 if scale is None else scale
    do = do.to(q.dtype)
    qh, doh = _bhsd(q, layout), _bhsd(do, layout)
    kh = _expand(_bhsd(k, layout), group)
    vh = _expand(_bhsd(v, layout), group)
    delta = (doh.float() * _bhsd(o, layout).float()).sum(-1)
    dlse = (torch.zeros_like(lse) if dlse is None
            else dlse.to(torch.float32))
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    keep = _keep(Sq, Sk, causal, q_offset, k_offset, window, q.device)
    if keep is not None:
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.exp(s - lse[..., None])
    if keep is not None:
        p = p.masked_fill(~keep, 0.0)   # fully-masked rows: lse = NEG_INF
    dp = torch.matmul(doh.float(), vh.float().transpose(-1, -2))
    # ds from the o path (p (dp - delta)) and the lse output (p dlse)
    ds = p * (dp - delta[..., None] + dlse[..., None]) * scale
    dq = torch.matmul(ds.to(k.dtype).float(), kh.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), qh.float())
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), doh.float())
    if group > 1:
        dk = dk.reshape(B, Hkv, group, Sk, D).sum(2)
        dv = dv.reshape(B, Hkv, group, Sk, D).sum(2)
    return (_bhsd(dq.to(q.dtype), layout), _bhsd(dk.to(k.dtype), layout),
            _bhsd(dv.to(v.dtype), layout))


def round_tf32(x):
    """float32 ``x`` rounded to the nearest TF32 value (10 mantissa bits,
    ties away from zero: ``cvt.rna.tf32.f32``), kept as float32."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_matmul(a, b, products):
    """``a @ b`` as the float32 tensor-core kernels take it: 3 is their
    split (``csrc/tf32x3.cuh``: a_small b_big + a_big b_small + a_big
    b_big, each half rounded to TF32), 1 one TF32 product of the operands
    rounded once."""
    a_big, b_big = round_tf32(a), round_tf32(b)
    if products == 1:
        return torch.matmul(a_big, b_big)
    if products != 3:
        raise ValueError(f"products must be 1 or 3 (got {products})")
    a_small, b_small = round_tf32(a - a_big), round_tf32(b - b_big)
    return (torch.matmul(a_small, b_big) + torch.matmul(a_big, b_small)
            + torch.matmul(a_big, b_big))


def flash_attention_fwd_tf32(q, k, v, products=3, causal=False, scale=None,
                             q_offset=0, k_offset=0, layout="bhsd",
                             window=0):
    """The float32 tensor-core forward's arithmetic in plain torch: ``(o,
    lse)`` of :func:`flash_attention_fwd_torch` with its two products
    (S = Q K^T, then P V on the unnormalised P) taken by
    :func:`_tf32_matmul` with ``products`` TF32 products.  Not on any
    path: it shows what the float32 bound tells apart (the kernel's
    three-product split meets it, one TF32 product does not)."""
    B, H, Sq, D, Sk, Hkv = _dims(q, k, layout)
    group = gqa_group(H, Hkv)
    scale = 1.0 / D ** 0.5 if scale is None else scale
    qh = _bhsd(q, layout).float()
    kh = _expand(_bhsd(k, layout).float(), group)
    vh = _expand(_bhsd(v, layout).float(), group)
    s = _tf32_matmul(qh, kh.transpose(-1, -2), products) * scale
    keep = _keep(Sq, Sk, causal, q_offset, k_offset, window, q.device)
    if keep is not None:
        s = s.masked_fill(~keep, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if keep is not None:
        p = p.masked_fill(~keep, 0.0)
    l_row = p.sum(dim=-1)
    valid = l_row > 0.0
    l_fin = l_row.clamp_min(_TINY)
    o = _tf32_matmul(p, vh, products) / l_fin[..., None]
    o = torch.where(valid[..., None], o, torch.zeros((), device=o.device))
    lse = torch.where(valid, m[..., 0] + torch.log(l_fin),
                      torch.full((), NEG_INF, device=o.device))
    return _bhsd(o, layout), lse


def flash_attention_dkv_tf32(q, k, v, o, lse, do, dlse=None, products=3,
                             causal=False, scale=None, q_offset=0,
                             k_offset=0, layout="bhsd", window=0):
    """The float32 tensor-core dK/dV's arithmetic in plain torch: ``(dk,
    dv)`` of :func:`flash_attention_bwd_torch` with each of its four
    products (S = Q K^T, dP = dO V^T, dV = P^T dO, dK = dS^T Q) taken by
    :func:`_tf32_matmul` with ``products`` TF32 products.  Not on any
    path: it shows what the float32 bound tells apart (the kernel's
    three-product split meets it, one TF32 product does not)."""
    B, H, Sq, D, Sk, Hkv = _dims(q, k, layout)
    group = gqa_group(H, Hkv)
    scale = 1.0 / D ** 0.5 if scale is None else scale
    qh, doh = (_bhsd(t, layout).float() for t in (q, do))
    kh = _expand(_bhsd(k, layout).float(), group)
    vh = _expand(_bhsd(v, layout).float(), group)
    delta = (doh * _bhsd(o, layout).float()).sum(-1)
    dlse = (torch.zeros_like(lse) if dlse is None
            else dlse.to(torch.float32))
    s = _tf32_matmul(qh, kh.transpose(-1, -2), products) * scale
    keep = _keep(Sq, Sk, causal, q_offset, k_offset, window, q.device)
    if keep is not None:
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.exp(s - lse[..., None])
    if keep is not None:
        p = p.masked_fill(~keep, 0.0)
    dp = _tf32_matmul(doh, vh.transpose(-1, -2), products)
    ds = p * (dp - delta[..., None] + dlse[..., None]) * scale
    dk = _tf32_matmul(ds.transpose(-1, -2), qh, products)
    dv = _tf32_matmul(p.transpose(-1, -2), doh, products)
    if group > 1:
        dk = dk.reshape(B, Hkv, group, Sk, D).sum(2)
        dv = dv.reshape(B, Hkv, group, Sk, D).sum(2)
    return _bhsd(dk, layout), _bhsd(dv, layout)


class _Flash(torch.autograd.Function):
    """The reference's ``custom_vjp`` ``_flash``: kernels on CUDA tensors,
    the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_offset, k_offset, layout,
                window):
        args = (causal, scale, q_offset, k_offset, layout, window)
        if q.is_cuda:
            from .flash_attention_cuda import flash_fwd_cuda
            o, lse = flash_fwd_cuda(q, k, v, *args)
        else:
            o, lse = flash_attention_fwd_torch(q, k, v, *args)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = args
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        causal, scale, q_offset, k_offset, layout, window = ctx.args
        if not q.is_cuda:
            dq, dk, dv = flash_attention_bwd_torch(
                q, k, v, o, lse, do, dlse, *ctx.args)
            return dq, dk, dv, None, None, None, None, None, None
        from .flash_attention_cuda import flash_dkv_cuda, flash_dq_cuda

        # dO stays in the input dtype for the kernels' products; only the
        # row reduction delta = rowsum(dO * O) is float32, outside them
        do = do.to(q.dtype)
        if do.stride(-1) != 1:        # e.g. the expanded gradient of a sum
            do = do.contiguous()
        delta = (do.float() * o.float()).sum(-1)
        if layout == "bshd":
            delta = delta.transpose(1, 2)       # (B, Sq, H) -> (B, H, Sq)
        delta = delta.contiguous()
        dlse = dlse.to(torch.float32).contiguous()
        dq = flash_dq_cuda(q, k, v, do, lse, delta, dlse, *ctx.args)
        dk, dv = flash_dkv_cuda(q, k, v, do, lse, delta, dlse, *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, causal=False, scale=None, block_q=512,
                    block_k=512, q_offset=0, k_offset=0, return_lse=False,
                    layout="bhsd", window=0):
    """Fused multi-head attention: softmax(Q K^T * scale) V.

    ``layout="bhsd"``: q (B, H, Sq, D), k/v (B, Hkv, Sk, D);
    ``layout="bshd"``: q (B, Sq, H, D), k/v (B, Sk, Hkv, D).  H must be a
    multiple of Hkv (grouped-query attention: q head h reads kv head
    h // (H // Hkv), natively in both layouts).  The output matches q's
    layout and dtype (float32 or bfloat16).  Differentiable.

    ``window`` > 0 is sliding-window attention (causal: keys in
    (q - window, q]; bidirectional: |q - k| < window).
    ``q_offset``/``k_offset`` shift the global positions the masks read.
    With ``return_lse`` the float32 (B, H, Sq) log-sum-exp is also
    returned, differentiably; fully-masked rows give o = 0 and
    lse = -1e30.

    On CUDA tensors this launches the Hopper kernels; on CPU tensors it
    runs their plain versions.  ``block_q``/``block_k`` are the
    reference's TPU VMEM tile bounds: the kernels choose their own tiles
    and mask ragged ones, so any sequence length runs, and these two
    arguments are accepted and not used.
    """
    del block_q, block_k
    if window < 0:
        raise ValueError(
            f"flash_attention: window must be >= 0 (got {window}); a "
            "negative band would mask every score")
    B, H, Sq, D, Sk, Hkv = _dims(q, k, layout)
    if Hkv != H:
        gqa_group(H, Hkv)
    if v.shape != k.shape:
        raise ValueError("flash_attention: k and v shapes must match")
    if not causal and not window:
        q_offset, k_offset = 0, 0     # no mask reads positions
    scale = float(1.0 / D ** 0.5) if scale is None else float(scale)
    o, lse = _Flash.apply(q, k, v, bool(causal), scale, int(q_offset),
                          int(k_offset), layout, int(window))
    if return_lse:
        return o, lse
    return o
