"""Fused GRU layer: the Hopper kernels' autograd wrapper and their plain
versions.

The port of ``mxnet_tpu/ops/pallas_gru.py``, the LSTM's companion (see
``ops/fused_lstm.py``): the same grid, residency, reverse stream and
cast points with another cell.  Gate math as ``ops/rnn.py``'s scan cell
(r, z, n; the reset gate applied to the hidden projection, the cuDNN
variant)::

    hp = h @ Wh^T + bh;   r = sig(rx + hp_r);  z = sig(zx + hp_z)
    n  = tanh(nx + r * hp_n);   h' = (1 - z) * n + z * h

The forward saves (r, z, n, hp_n) per step in float32; the backward
rebuilds every gradient from them.  Its recurrent product takes
``dhp = [dr_pre, dz_pre, dnh]`` in gx's dtype, not dgx (whose third
block is ``dn_pre``), and dWh/dbh sum dhp.
"""

from __future__ import annotations

import torch

from .fused_lstm import fused_rnn_eligible

__all__ = ["fused_gru", "fused_gru_eligible", "fused_gru_fwd_torch",
           "fused_gru_bwd_torch"]


def fused_gru_eligible(T, N, H, force=None, dtype=torch.float32):
    """The LSTM's rule (:func:`~.fused_lstm.fused_rnn_eligible`) with the
    GRU's three gates in the residency count."""
    return fused_rnn_eligible(T, N, H, 3, force, dtype)


def fused_gru_fwd_torch(gx, h0, wh, bh, save=True):
    """Plain version of the forward kernel: ``(ys, hT)`` in gx's dtype
    and, with ``save``, the float32 residual ``acts`` (T, N, 4H:
    r, z, n, hp_n), else None."""
    T, N, G = gx.shape
    H = G // 3
    dt = gx.dtype
    w = wh.to(dt).float().t()
    b = bh.reshape(-1).float()
    h = h0.float()
    ys = torch.empty(T, N, H, dtype=dt, device=gx.device)
    acts = torch.empty(T, N, 4 * H, device=gx.device) if save else None
    for t in range(T):
        hp = h.to(dt).float() @ w + b
        x = gx[t].float()
        r = torch.sigmoid(x[:, :H] + hp[:, :H])
        z = torch.sigmoid(x[:, H:2 * H] + hp[:, H:2 * H])
        nh = hp[:, 2 * H:]
        n = torch.tanh(x[:, 2 * H:] + r * nh)
        h = (1.0 - z) * n + z * h
        if save:
            acts[t] = torch.cat([r, z, n, nh], dim=-1)
        ys[t] = h.to(dt)
    return ys, h.to(dt), acts


def fused_gru_bwd_torch(acts, ys, h0, wh, dys, dhT):
    """Plain version of the backward kernel: ``(dgx, dwh, dbh, dh0)``,
    dgx in ys's dtype, the rest float32."""
    T, N, _ = acts.shape
    H = ys.shape[-1]
    dt = ys.dtype
    w = wh.to(dt).float()
    dh = dhT.float()
    dwh = torch.zeros(3 * H, H, device=acts.device)
    dbh = torch.zeros(3 * H, device=acts.device)
    dgx = torch.empty(T, N, 3 * H, dtype=dt, device=acts.device)
    for t in range(T - 1, -1, -1):
        r, z, n, nh = acts[t].split(H, dim=-1)
        h_prev = h0.float() if t == 0 else ys[t - 1].float()
        dh = dh + dys[t].float()
        dz = dh * (h_prev - n)
        dn = dh * (1.0 - z)
        dn_pre = dn * (1.0 - n * n)
        dr = dn_pre * nh
        dnh = dn_pre * r
        dr_pre = dr * r * (1.0 - r)
        dz_pre = dz * z * (1.0 - z)
        dgx[t] = torch.cat([dr_pre, dz_pre, dn_pre], dim=-1).to(dt)
        dhp = torch.cat([dr_pre, dz_pre, dnh], dim=-1)
        dhp_lo = dhp.to(dt).float()
        dwh += dhp_lo.t() @ h_prev.to(dt).float()
        dbh += dhp.sum(0)
        dh = dh * z + dhp_lo @ w
    return dgx, dwh, dbh, dh


class _FusedGRU(torch.autograd.Function):
    """The reference's ``custom_vjp`` ``_fused`` for the GRU."""

    @staticmethod
    def forward(ctx, gx, h0, wh, bh, save):
        if gx.is_cuda:
            from .fused_rnn_cuda import gru_fwd_cuda
            ys, hT, acts = gru_fwd_cuda(gx, h0, wh, bh, save)
        else:
            ys, hT, acts = fused_gru_fwd_torch(gx, h0, wh, bh, save)
        if save:
            ctx.save_for_backward(acts, ys, h0, wh, bh)
        return ys, hT

    @staticmethod
    def backward(ctx, dys, dhT):
        acts, ys, h0, wh, bh = ctx.saved_tensors
        dt = ys.dtype
        grads = (dys.to(dt).contiguous(), dhT.to(dt).contiguous())
        if ys.is_cuda:
            from .fused_rnn_cuda import gru_bwd_cuda
            dgx, dwh, dbh, dh0 = gru_bwd_cuda(acts, ys, h0, wh, *grads)
        else:
            dgx, dwh, dbh, dh0 = fused_gru_bwd_torch(acts, ys, h0, wh,
                                                     *grads)
        return (dgx, dh0.to(h0.dtype), dwh.to(wh.dtype), dbh.to(bh.dtype),
                None)


def fused_gru(gx, h0, wh, bh):
    """One GRU layer over precomputed gate inputs.

    gx: (T, N, 3H) input projection incl. the input bias; h0: (N, H)
    initial state (cast to float32 on entry); wh: (3H, H) recurrent
    weights; bh: (3H,) recurrent bias.  Returns ``(ys, hT)`` in gx's
    dtype; differentiable in all four arrays."""
    T, N, G = gx.shape
    H = G // 3
    if tuple(wh.shape) != (G, H):
        raise ValueError(f"wh must be {(G, H)}, got {tuple(wh.shape)}")
    save = torch.is_grad_enabled() and any(
        t.requires_grad for t in (gx, h0, wh, bh))
    return _FusedGRU.apply(gx, h0.float(), wh, bh.reshape(G), save)
