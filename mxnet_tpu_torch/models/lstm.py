"""Explicitly-unrolled LSTM language model.

The port of ``mxnet_tpu/models/lstm.py`` (``lstm_cell``, ``lstm_unroll``;
the reference example/rnn/lstm.py): the bucketing-LM network of
``examples/lstm_bucketing.py``, one FullyConnected pair per step and
layer.  It reaches no kernel; the fused ``RNN`` op (``ops/rnn.py``) is
the kernel path.

Its gate order is the reference cell's, **i, g, f, o** (in, transform,
forget, out: the four slices of ``i2h + h2h``), not the ``RNN`` op's
cuDNN order i, f, g, o.
"""

from __future__ import annotations

from collections import namedtuple

import torch
from torch import nn

from ..ops.loss import SoftmaxOutput
from ..ops.nn import Embedding, FullyConnected

__all__ = ["LSTMState", "LSTMParam", "lstm_cell", "lstm_unroll",
           "LSTMUnroll"]

LSTMState = namedtuple("LSTMState", ["c", "h"])
LSTMParam = namedtuple("LSTMParam", ["i2h_weight", "i2h_bias",
                                     "h2h_weight", "h2h_bias"])


def lstm_cell(num_hidden, indata, prev_state, param, seqidx=None,
              layeridx=None, dropout=0.0):
    """One LSTM step: gates ``i2h(x) + h2h(h)`` sliced in the reference
    cell's order in, transform, forget, out.  ``seqidx``/``layeridx``
    named the reference's Symbol nodes and are accepted unused."""
    if dropout > 0.0:
        raise NotImplementedError("lstm_cell(dropout>0) is not ported yet "
                                  "(ROADMAP §A16)")
    gates = (FullyConnected(indata, param.i2h_weight, param.i2h_bias,
                            num_hidden=num_hidden * 4)
             + FullyConnected(prev_state.h, param.h2h_weight,
                              param.h2h_bias, num_hidden=num_hidden * 4))
    in_gate, in_transform, forget_gate, out_gate = gates.split(num_hidden,
                                                               dim=-1)
    next_c = (torch.sigmoid(forget_gate) * prev_state.c
              + torch.sigmoid(in_gate) * torch.tanh(in_transform))
    next_h = torch.sigmoid(out_gate) * torch.tanh(next_c)
    return LSTMState(c=next_c, h=next_h)


class LSTMUnroll(nn.Module):
    """The network of :func:`lstm_unroll`.  ``forward(data,
    softmax_label, **init_states)`` takes (N, seq_len) token ids and
    labels, and optionally the initial states ``l{i}_init_c`` /
    ``l{i}_init_h`` (N, num_hidden; zeros when absent, as the bucketing
    example feeds them), and returns the SoftmaxOutput probabilities
    (seq_len * N, num_label), time-major rows.  Parameters carry the
    reference Symbol's argument names in its argument order; the
    initial states, which the Symbol also lists as arguments, are inputs
    here (:meth:`arguments` lists all of them)."""

    def __init__(self, num_lstm_layer, seq_len, input_size, num_hidden,
                 num_embed, num_label):
        super().__init__()
        self.num_lstm_layer, self.seq_len = num_lstm_layer, seq_len
        self.num_hidden, self.num_embed = num_hidden, num_embed
        self.input_size, self.num_label = input_size, num_label
        for name, shape in self.arguments(1):
            if name in ("data", "softmax_label") or name.endswith("_init_c") \
                    or name.endswith("_init_h"):
                continue
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, device="meta")))

    def arguments(self, batch_size):
        """``[(name, shape)]`` of the reference Symbol's arguments, in its
        order, at batch size ``batch_size``."""
        H, E = self.num_hidden, self.num_embed
        args = [("data", (batch_size, self.seq_len)),
                ("embed_weight", (self.input_size, E))]
        for i in range(self.num_lstm_layer):
            isz = E if i == 0 else H
            args += [(f"l{i}_i2h_weight", (4 * H, isz)),
                     (f"l{i}_i2h_bias", (4 * H,)),
                     (f"l{i}_init_h", (batch_size, H)),
                     (f"l{i}_h2h_weight", (4 * H, H)),
                     (f"l{i}_h2h_bias", (4 * H,)),
                     (f"l{i}_init_c", (batch_size, H))]
        args += [("cls_weight", (self.num_label, H)),
                 ("cls_bias", (self.num_label,)),
                 ("softmax_label", (batch_size, self.seq_len))]
        return args

    def forward(self, data, softmax_label, **init_states):
        p = self._parameters
        N = data.shape[0]
        embed = Embedding(data, p["embed_weight"],
                          input_dim=self.input_size,
                          output_dim=self.num_embed)      # (N, T, E)
        params, states = [], []
        for i in range(self.num_lstm_layer):
            params.append(LSTMParam(*(p[f"l{i}_{k}"] for k in (
                "i2h_weight", "i2h_bias", "h2h_weight", "h2h_bias"))))
            zeros = torch.zeros(N, self.num_hidden, dtype=embed.dtype,
                                device=embed.device)
            states.append(LSTMState(
                c=init_states.get(f"l{i}_init_c", zeros).to(embed.dtype),
                h=init_states.get(f"l{i}_init_h", zeros).to(embed.dtype)))
        hidden_all = []
        for seqidx in range(self.seq_len):
            hidden = embed[:, seqidx]
            for i in range(self.num_lstm_layer):
                states[i] = lstm_cell(self.num_hidden, hidden, states[i],
                                      params[i])
                hidden = states[i].h
            hidden_all.append(hidden)
        pred = FullyConnected(torch.cat(hidden_all, dim=0), p["cls_weight"],
                              p["cls_bias"], num_hidden=self.num_label)
        return SoftmaxOutput(pred, softmax_label.t().reshape(-1))


def lstm_unroll(num_lstm_layer, seq_len, input_size, num_hidden, num_embed,
                num_label, dropout=0.0):
    """The unrolled LSTM LM over a padded sequence, as an
    :class:`LSTMUnroll` module.  ``dropout > 0`` is not ported yet and
    raises."""
    if dropout > 0.0:
        raise NotImplementedError("lstm_unroll(dropout>0) is not ported yet "
                                  "(ROADMAP §A16)")
    return LSTMUnroll(num_lstm_layer, seq_len, input_size, num_hidden,
                      num_embed, num_label)
