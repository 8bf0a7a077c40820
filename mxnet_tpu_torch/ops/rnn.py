"""Fused multi-layer RNN operator.

The port of ``mxnet_tpu/ops/rnn.py`` (the reference ``RNN`` op, cuDNN's
fused RNN in the original).  Parameters keep the reference's flat cuDNN
layout byte for byte (all layers' and directions' W_i2h then W_h2h
blocks, then all b_i2h then b_h2h blocks), so a ``*_parameters`` vector
moves between the packages unchanged.  Gate orders follow cuDNN: LSTM
(i, f, g, o), GRU (r, z, n).  Layout: data (T, N, input_size)
time-major, states (L*D, N, H).

Each layer and direction computes the input projection ``x @ Wi^T + bi``
for all T steps as one matmul, outside any kernel (as the reference
leaves it to XLA), then runs the recurrence: LSTM and GRU layers through
the fused kernels (``ops/fused_lstm``, ``ops/fused_gru``) where
:func:`_fused_dispatch` takes them, else the eager scan of
:func:`_cell_step`.  The reverse direction flips gx before the
recurrence and ys after it.

:func:`RNN` is the op's function over torch tensors; :class:`RNNOp`
registers it as the reference's ``RNN`` Symbol op (its arguments,
outputs and shape rule), so a bound graph's LSTM and GRU layers take the
same path.
"""

from __future__ import annotations

import os

import torch

from ..param import Params, field
from .op import OpDef, register_op

__all__ = ["RNN", "RNNParam", "RNNOp", "rnn_infer_shape"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


class RNNParam(Params):
    """The reference's ``RNNParam`` fields and checks; positional
    arguments fill the fields in order."""

    state_size = field(int, required=True)
    num_layers = field(int, required=True)
    mode = field(str, required=True)
    bidirectional = field(bool, default=False)
    p = field(float, default=0.0, doc="dropout between layers")
    state_outputs = field(bool, default=False)

    def __init__(self, *args, **kwargs):
        kwargs.update(zip(self.argument_names(), args))
        super().__init__(**kwargs)
        if self.state_size < 1:
            raise ValueError(f"RNN: state_size must be >= 1 "
                             f"(got {self.state_size})")
        if self.num_layers < 1:
            raise ValueError(f"RNN: num_layers must be >= 1 "
                             f"(got {self.num_layers})")
        if self.mode not in _GATES:
            raise ValueError(f"RNN: mode must be one of {tuple(_GATES)} "
                             f"(got {self.mode!r})")


def _dirs(params):
    return 2 if params.bidirectional else 1


def _layer_input_size(params, input_size, layer):
    return input_size if layer == 0 else params.state_size * _dirs(params)


def _weight_size(params, input_size):
    """Total flat parameter count (cuDNN's size calculation)."""
    G, H, D = _GATES[params.mode], params.state_size, _dirs(params)
    total = 0
    for layer in range(params.num_layers):
        isz = _layer_input_size(params, input_size, layer)
        total += D * (G * H * isz + G * H * H)  # W_i2h + W_h2h
    total += params.num_layers * D * 2 * G * H  # b_i2h + b_h2h
    return total


def _slice_params(params, input_size, flat):
    """Split the flat vector into per-(layer, direction) ``[wi, wh, bi,
    bh]`` blocks (views of ``flat``)."""
    G, H, D = _GATES[params.mode], params.state_size, _dirs(params)
    out = []
    pos = 0
    for layer in range(params.num_layers):
        isz = _layer_input_size(params, input_size, layer)
        per_layer = []
        for _ in range(D):
            wi = flat[pos:pos + G * H * isz].reshape(G * H, isz)
            pos += G * H * isz
            wh = flat[pos:pos + G * H * H].reshape(G * H, H)
            pos += G * H * H
            per_layer.append([wi, wh, None, None])
        out.append(per_layer)
    for layer in range(params.num_layers):
        for d in range(D):
            out[layer][d][2] = flat[pos:pos + G * H]
            pos += G * H
            out[layer][d][3] = flat[pos:pos + G * H]
            pos += G * H
    return out


def _cell_step(mode, H):
    """One step of the eager scan: ``step(carry, gx_t, wh, bh) -> (carry,
    y_t)``; the LSTM's carry is (h, c)."""
    if mode == "lstm":
        def step(carry, gx, wh, bh):
            h, c = carry
            gates = gx + h @ wh.t() + bh
            i, f, g, o = gates.split(H, dim=-1)
            c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h2 = torch.sigmoid(o) * torch.tanh(c2)
            return (h2, c2), h2
    elif mode == "gru":
        def step(h, gx, wh, bh):
            hp = h @ wh.t() + bh
            rx, zx, nx = gx.split(H, dim=-1)
            rh, zh, nh = hp.split(H, dim=-1)
            r = torch.sigmoid(rx + rh)
            z = torch.sigmoid(zx + zh)
            n = torch.tanh(nx + r * nh)
            h2 = (1 - z) * n + z * h
            return h2, h2
    else:
        def step(h, gx, wh, bh):
            pre = gx + h @ wh.t() + bh
            h2 = torch.relu(pre) if mode == "rnn_relu" else torch.tanh(pre)
            return h2, h2
    return step


def _fused_dispatch(mode, gx, h0, c0, wh, bh):
    """Route gated cells through the fused kernels when eligible; returns
    (ys, hT, cT-or-None), or None to use the scan.  On CUDA tensors the
    eligibility rule decides; on CPU tensors the kernel path (its plain
    versions) runs only when ``MXNET_TPU_FUSED_RNN=1`` forces it, as the
    reference runs its kernels off the TPU only when forced."""
    if mode not in ("lstm", "gru"):
        return None
    if not gx.is_cuda and os.environ.get("MXNET_TPU_FUSED_RNN", "") != "1":
        return None
    T, N, _ = gx.shape
    H = h0.shape[-1]
    if mode == "lstm":
        from .fused_lstm import fused_lstm, fused_lstm_eligible

        if not fused_lstm_eligible(T, N, H, dtype=gx.dtype):
            return None
        return fused_lstm(gx, h0, c0, wh, bh)
    from .fused_gru import fused_gru, fused_gru_eligible

    if not fused_gru_eligible(T, N, H, dtype=gx.dtype):
        return None
    ys, hT = fused_gru(gx, h0, wh, bh)
    return ys, hT, None


def _run_direction(mode, x, h0, c0, wi, wh, bi, bh, reverse):
    """One layer, one direction over the full sequence."""
    # time-batched input projection: (T, N, I) x (GH, I) -> (T, N, GH)
    gx = torch.matmul(x, wi.t()) + bi
    if reverse:
        gx = gx.flip(0)
    fused = _fused_dispatch(mode, gx, h0, c0, wh, bh)
    if fused is not None:
        ys, hT, cT = fused
    else:
        step = _cell_step(mode, h0.shape[-1])
        carry = (h0, c0) if mode == "lstm" else h0
        outs = []
        for t in range(gx.shape[0]):
            carry, y = step(carry, gx[t], wh, bh)
            outs.append(y)
        ys = torch.stack(outs)
        hT, cT = carry if mode == "lstm" else (carry, None)
    if reverse:
        ys = ys.flip(0)
    return ys, hT, cT


def _infer_shape(params, data_shape):
    """The reference op's ``infer_shape`` for data (T, N, input_size):
    ``(argument shapes, output shapes)``, arguments in the op's order
    (data, parameters, state[, state_cell])."""
    T, N, input_size = data_shape
    H, D, L = params.state_size, _dirs(params), params.num_layers
    state_shape = (L * D, N, H)
    args = [tuple(data_shape), (_weight_size(params, input_size),),
            state_shape]
    if params.mode == "lstm":
        args.append(state_shape)
    outs = [(T, N, H * D)]
    if params.state_outputs:
        outs.append(state_shape)
        if params.mode == "lstm":
            outs.append(state_shape)
    return args, outs


def rnn_infer_shape(data_shape, state_size, num_layers, mode,
                    bidirectional=False, state_outputs=False):
    """The reference op's ``infer_shape``: ``(argument shapes, output
    shapes)`` for data (T, N, input_size), arguments in the op's order
    (data, parameters, state[, state_cell])."""
    return _infer_shape(RNNParam(state_size, num_layers, mode, bidirectional,
                                 state_outputs=state_outputs), data_shape)


def _rnn(params, data, parameters, state, state_cell, train):
    """The op's forward: the outputs' list (output, then hN and cN with
    ``state_outputs``)."""
    mode = params.mode
    if params.p > 0 and train and params.num_layers > 1:
        raise NotImplementedError(
            "RNN(p>0): dropout between layers when training is not ported "
            "yet (ROADMAP §A16)")
    if mode == "lstm" and state_cell is None:
        raise ValueError("RNN(mode='lstm') needs state_cell")
    T, N, input_size = data.shape
    D, L = _dirs(params), params.num_layers
    if parameters.numel() != _weight_size(params, input_size):
        raise ValueError(f"RNN: parameters hold {parameters.numel()} values, "
                         f"the layout needs "
                         f"{_weight_size(params, input_size)}")
    dt = torch.promote_types(data.dtype, parameters.dtype)
    blocks = _slice_params(params, input_size, parameters.to(dt))
    x = data.to(dt)
    hTs, cTs = [], []
    for layer in range(L):
        outs_dir = []
        for d in range(D):
            wi, wh, bi, bh = blocks[layer][d]
            h0 = state[layer * D + d].to(dt)
            c0 = state_cell[layer * D + d].to(dt) if mode == "lstm" else None
            ys, hT, cT = _run_direction(mode, x, h0, c0, wi, wh, bi, bh,
                                        reverse=(d == 1))
            outs_dir.append(ys)
            hTs.append(hT)
            if cT is not None:
                cTs.append(cT)
        x = torch.cat(outs_dir, dim=-1) if D == 2 else outs_dir[0]
    outputs = [x]
    if params.state_outputs:
        outputs.append(torch.stack(hTs).to(x.dtype))
        if mode == "lstm":
            outputs.append(torch.stack(cTs).to(x.dtype))
    return outputs


def RNN(data, parameters, state, state_cell=None, *, state_size, num_layers,
        mode, bidirectional=False, p=0.0, state_outputs=False):
    """The reference ``RNN`` op's forward: a multi-layer, optionally
    bidirectional RNN over time-major ``data`` (T, N, input_size).

    ``parameters`` is the flat cuDNN-layout vector, ``state`` (and, for
    ``mode="lstm"``, ``state_cell``) the (L*D, N, H) initial states.
    Returns the output (T, N, H*D); with ``state_outputs`` the tuple
    ``(output, hN[, cN])``.  Differentiable.  Grad mode says whether this
    is a training pass: dropout between layers (``p > 0``) when training
    is not ported yet and raises; under ``torch.no_grad`` ``p`` has no
    effect, as in the reference outside training."""
    params = RNNParam(state_size, num_layers, mode, bidirectional, p,
                      state_outputs)
    outputs = _rnn(params, data, parameters, state, state_cell,
                   torch.is_grad_enabled())
    return tuple(outputs) if params.state_outputs else outputs[0]


@register_op("RNN")
class RNNOp(OpDef):
    """The reference's ``RNN`` Symbol op (``mxnet_tpu/ops/rnn.py``
    ``RNNOp``): its arguments, outputs and shape rule over :func:`_rnn`,
    so the LSTM and GRU layers of a bound graph take the fused kernels
    where :func:`_fused_dispatch` does."""

    param_cls = RNNParam
    need_rng = True

    def list_arguments(self, params):
        args = ["data", "parameters", "state"]
        if params.mode == "lstm":
            args.append("state_cell")
        return args

    def list_outputs(self, params):
        outs = ["output"]
        if params.state_outputs:
            outs.append("state")
            if params.mode == "lstm":
                outs.append("state_cell")
        return outs

    def infer_shape(self, params, in_shapes):
        if in_shapes[0] is None:
            raise ValueError("RNN: data shape unknown")
        args, outs = _infer_shape(params, in_shapes[0])
        return args, outs, []

    def forward(self, params, inputs, aux, train, key):
        cell = inputs[3] if params.mode == "lstm" else None
        return _rnn(params, inputs[0], inputs[1], inputs[2], cell,
                    train), []
