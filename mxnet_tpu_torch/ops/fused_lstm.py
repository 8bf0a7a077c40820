"""Fused LSTM layer: the Hopper kernels' autograd wrapper and their plain
versions.

The port of ``mxnet_tpu/ops/pallas_lstm.py``.  :func:`fused_lstm` keeps
the reference contract: one LSTM layer over precomputed gate inputs
``gx = x @ Wi^T + bi`` (T, N, 4H), gate order i, f, g, o (cuDNN's, as
``ops/rnn.py``'s scan cell), ``h0``/``c0`` cast to float32 on entry,
``wh`` (4H, H) checked, differentiable in all five arrays.

:class:`_FusedLSTM` replaces the reference's ``custom_vjp`` ``_fused``.
On CUDA tensors its forward launches a fused-LSTM forward kernel and its
backward a fused-LSTM backward kernel, each picked by
``ops/fused_rnn_cuda`` (``_fwd_variant``, ``_bwd_variant``: the
tensor-core kernels in bf16 within their limits and the float32
tensor-core ones in float32, else the float32-FMA ones); on CPU
tensors it runs :func:`fused_lstm_fwd_torch` and
:func:`fused_lstm_bwd_torch`, the plain versions.
:func:`fused_lstm_fwd_tf32` and :func:`fused_lstm_bwd_tf32` model the
float32 tensor-core kernels' split-TF32 products; nothing on the card's
path calls them.  Both keep the TPU
kernels' cast points: the recurrent product's operands (h, Wh; dgates,
Wh; dgates, h_prev) in gx's dtype and summed in float32; gx, bh, the
carried state, the saved activations and cells in float32; ys, hT, cT
and dgx in gx's dtype; dWh, dbh, dh0, dc0 in float32, cast to each
primal's dtype by the backward.  Without a gradient (eval,
``torch.no_grad``) the forward writes no residuals.
"""

from __future__ import annotations

import functools
import os

import torch

from .flash_attention import _tf32_matmul

__all__ = ["fused_lstm", "fused_lstm_eligible", "fused_lstm_fwd_torch",
           "fused_lstm_bwd_torch", "fused_lstm_fwd_tf32",
           "fused_lstm_bwd_tf32", "fused_rnn_eligible", "fused_rnn_fits",
           "KERNEL_DTYPES"]

KERNEL_DTYPES = (torch.float32, torch.bfloat16)

# The kernels' limit (csrc/fused_rnn.cuh): a persistent cooperative grid of
# 256-thread CTAs on one H100 SXM, CTA k owning hs = ceil(H / 132) hidden
# units.  A CTA keeps in shared memory, as float32, its units' Wh rows
# (forward) or Wh columns, dWh rows and dgates (backward), a 32-row operand
# tile, split-K partial sums and its units' state.
SMEM_WORDS = 232448 // 4   # float32 words a block may use (227 KB)


def _rows(x):
    """x rounded up to 4 times a power of two: the output rows a CTA's
    product pads to."""
    return 4 * (1 << (-(-x // 4) - 1).bit_length())


def fused_rnn_fits(N, H, G):
    """Whether one layer of batch N, hidden width H and G gates fits the
    kernels' residency: a closed-form upper bound on each kernel's
    shared memory, stated with the kernel (csrc/fused_rnn.cuh, Limits),
    within one block's 227 KB, and at most 128 padded Wh rows a CTA."""
    if N < 1 or H < 1:
        return False
    hs = -(-H // 132)
    R = G * hs
    K = H + 12                                  # a padded row of H
    rf, rb, r4 = _rows(R), _rows(hs), 4 * -(-R // 4)
    fwd = (rf + 32) * K + 32 * rf + 4096 + N * hs
    bwd = ((G * rb + 32 + r4) * K + 32 * rb + 4096 + (2 * N + 1) * r4
           + 2 * N * hs)
    return rf <= 128 and max(fwd, bwd) <= SMEM_WORDS


def fused_rnn_eligible(T, N, H, G, force=None, dtype=torch.float32):
    """Whether the fused kernels carry a layer of G gates (4 LSTM, 3 GRU)
    at this shape: a pure function of (T, N, H, G, dtype) and
    ``MXNET_TPU_FUSED_RNN``.

    ``MXNET_TPU_FUSED_RNN=0`` never takes them.  The shape must fit the
    kernels' residency on the card (:func:`fused_rnn_fits`: the resident
    weight slices, operand tile and state within a block's shared
    memory over a co-resident grid) and the dtype be float32 or
    bfloat16.  ``force`` or ``MXNET_TPU_FUSED_RNN=1`` pass the
    sequence-length gate; otherwise ``T >= 8`` (tiny sequences gain
    nothing over the scan), as in the reference."""
    env = os.environ.get("MXNET_TPU_FUSED_RNN", "")
    if env == "0":
        return False
    if dtype not in KERNEL_DTYPES or not fused_rnn_fits(N, H, G):
        return False
    if bool(force) or env == "1":
        return True
    return T >= 8


def fused_lstm_eligible(T, N, H, force=None, dtype=torch.float32):
    """:func:`fused_rnn_eligible` for the LSTM's four gates."""
    return fused_rnn_eligible(T, N, H, 4, force, dtype)


def fused_lstm_fwd_torch(gx, h0, c0, wh, bh, save=True):
    """Plain version of the forward kernel: ``(ys, hT, cT)`` in gx's
    dtype and, with ``save``, the float32 residuals ``acts`` (T, N, 4H:
    the activated i, f, g, o) and ``cells`` (T, N, H), None without
    ``save`` (sums in the wider of float32 and gx's dtype: a float64 gx
    gives a float64 reference)."""
    return _lstm_fwd(gx, h0, c0, wh, bh, save, torch.matmul)


def fused_lstm_fwd_tf32(gx, h0, c0, wh, bh, save=True, products=3):
    """The float32 tensor-core forward's arithmetic in plain torch
    (``csrc/fused_rnn_fwd_f32tc.cuh``): :func:`fused_lstm_fwd_torch` with
    its recurrent product h_{t-1} Wh^T taken as the kernel takes it
    (``products`` as :func:`fused_lstm_bwd_tf32`'s).  float32 only."""
    if gx.dtype != torch.float32:
        raise ValueError(f"the TF32 model takes float32, not {gx.dtype}")
    return _lstm_fwd(gx, h0, c0, wh, bh, save,
                     functools.partial(_tf32_matmul, products=products))


def _lstm_fwd(gx, h0, c0, wh, bh, save, mm):
    """The forward's recurrence with its recurrent product taken by
    ``mm``."""
    T, N, G = gx.shape
    H = G // 4
    dt = gx.dtype
    acc = torch.promote_types(dt, torch.float32)
    w = wh.to(dt).to(acc).t()                   # operands in gx's dtype
    b = bh.reshape(-1).to(acc)
    h, c = h0.to(acc), c0.to(acc)
    ys = torch.empty(T, N, H, dtype=dt, device=gx.device)
    acts = cells = None
    if save:
        acts = torch.empty(T, N, G, dtype=acc, device=gx.device)
        cells = torch.empty(T, N, H, dtype=acc, device=gx.device)
    for t in range(T):
        gates = gx[t].to(acc) + mm(h.to(dt).to(acc), w) + b
        i = torch.sigmoid(gates[:, :H])
        f = torch.sigmoid(gates[:, H:2 * H])
        g = torch.tanh(gates[:, 2 * H:3 * H])
        o = torch.sigmoid(gates[:, 3 * H:])
        c = f * c + i * g
        h = o * torch.tanh(c)
        if save:
            acts[t] = torch.cat([i, f, g, o], dim=-1)
            cells[t] = c
        ys[t] = h.to(dt)
    return ys, h.to(dt), c.to(dt), acts, cells


def fused_lstm_bwd_torch(acts, cells, ys, h0, c0, wh, dys, dhT, dcT):
    """Plain version of the backward kernel (``_bwd_kernel``): reverse
    time from the saved residuals, no recompute.  ``dys``/``dhT``/
    ``dcT`` in ys's dtype.  Returns ``(dgx, dwh, dbh, dh0, dc0)``: dgx in
    ys's dtype, the rest float32 (sums in the wider of float32 and ys's
    dtype: float64 residuals give a float64 reference)."""
    return _lstm_bwd(acts, cells, ys, h0, c0, wh, dys, dhT, dcT,
                     torch.matmul)


def fused_lstm_bwd_tf32(acts, cells, ys, h0, c0, wh, dys, dhT, dcT,
                        products=3):
    """The float32 tensor-core backward's arithmetic in plain torch
    (``csrc/fused_rnn_bwd_f32tc.cuh``): :func:`fused_lstm_bwd_torch` with
    its two recurrent products, dh = dgates Wh and dWh += dgates^T
    h_prev, taken as the kernel takes them: ``products=3`` its split
    TF32 (a_small b_big + a_big b_small + a_big b_big, each half rounded
    to TF32), 1 one TF32 product of operands rounded once (what the
    float32 bound must tell from the split).  float32 only."""
    if ys.dtype != torch.float32:
        raise ValueError(f"the TF32 model takes float32, not {ys.dtype}")
    return _lstm_bwd(acts, cells, ys, h0, c0, wh, dys, dhT, dcT,
                     functools.partial(_tf32_matmul, products=products))


def _lstm_bwd(acts, cells, ys, h0, c0, wh, dys, dhT, dcT, mm):
    """The backward's recurrence with its recurrent products taken by
    ``mm``."""
    T, N, G = acts.shape
    H = G // 4
    dt = ys.dtype
    acc = torch.promote_types(dt, torch.float32)
    w = wh.to(dt).to(acc)
    dh, dc = dhT.to(acc), dcT.to(acc)
    dwh = torch.zeros(G, H, dtype=acc, device=acts.device)
    dbh = torch.zeros(G, dtype=acc, device=acts.device)
    dgx = torch.empty(T, N, G, dtype=dt, device=acts.device)
    for t in range(T - 1, -1, -1):
        i, f, g, o = acts[t].to(acc).split(H, dim=-1)
        c = cells[t].to(acc)
        c_prev = (c0 if t == 0 else cells[t - 1]).to(acc)
        h_prev = h0.to(acc) if t == 0 else ys[t - 1].to(acc)
        dh = dh + dys[t].to(acc)
        tc = torch.tanh(c)
        do = dh * tc
        dc = dc + dh * o * (1.0 - tc * tc)
        di, df, dg = dc * g, dc * c_prev, dc * i
        dgates = torch.cat([di * i * (1.0 - i), df * f * (1.0 - f),
                            dg * (1.0 - g * g), do * o * (1.0 - o)], dim=-1)
        dgx[t] = dgates.to(dt)
        dg_lo = dgates.to(dt).to(acc)
        dwh += mm(dg_lo.t(), h_prev.to(dt).to(acc))
        dbh += dgates.sum(0)
        dh = mm(dg_lo, w)
        dc = dc * f
    return dgx, dwh, dbh, dh, dc


class _FusedLSTM(torch.autograd.Function):
    """The reference's ``custom_vjp`` ``_fused``: kernels on CUDA
    tensors, the plain versions on CPU tensors.  ``save`` is decided by
    the caller (inside ``forward`` grad mode is always off)."""

    @staticmethod
    def forward(ctx, gx, h0, c0, wh, bh, save):
        if gx.is_cuda:
            from .fused_rnn_cuda import lstm_fwd_cuda
            ys, hT, cT, acts, cells = lstm_fwd_cuda(gx, h0, c0, wh, bh, save)
        else:
            ys, hT, cT, acts, cells = fused_lstm_fwd_torch(gx, h0, c0, wh,
                                                           bh, save)
        if save:
            ctx.save_for_backward(acts, cells, ys, h0, c0, wh, bh)
        return ys, hT, cT

    @staticmethod
    def backward(ctx, dys, dhT, dcT):
        acts, cells, ys, h0, c0, wh, bh = ctx.saved_tensors
        dt = ys.dtype
        grads = (dys.to(dt).contiguous(), dhT.to(dt).contiguous(),
                 dcT.to(dt).contiguous())
        if ys.is_cuda:
            from .fused_rnn_cuda import lstm_bwd_cuda
            dgx, dwh, dbh, dh0, dc0 = lstm_bwd_cuda(acts, cells, ys, h0, c0,
                                                    wh, *grads)
        else:
            dgx, dwh, dbh, dh0, dc0 = fused_lstm_bwd_torch(
                acts, cells, ys, h0, c0, wh, *grads)
        return (dgx, dh0.to(h0.dtype), dc0.to(c0.dtype), dwh.to(wh.dtype),
                dbh.to(bh.dtype), None)


def fused_lstm(gx, h0, c0, wh, bh):
    """One LSTM layer over precomputed gate inputs.

    gx: (T, N, 4H) input projection incl. the input bias; h0, c0: (N, H)
    initial states (cast to float32 on entry); wh: (4H, H) recurrent
    weights; bh: (4H,) recurrent bias.  Returns ``(ys, hT, cT)`` with ys
    (T, N, H), all in gx's dtype; differentiable in all five arrays.
    CUDA tensors run the Hopper kernels, CPU tensors their plain
    versions."""
    T, N, G = gx.shape
    H = G // 4
    if tuple(wh.shape) != (G, H):
        raise ValueError(f"wh must be {(G, H)}, got {tuple(wh.shape)}")
    save = torch.is_grad_enabled() and any(
        t.requires_grad for t in (gx, h0, c0, wh, bh))
    return _FusedLSTM.apply(gx, h0.float(), c0.float(), wh, bh.reshape(G),
                            save)
