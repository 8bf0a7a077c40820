"""Shared inputs for the PyTorch-port parity tests (tests/test_torch_*.py).

Seeded tiny gpt() checkpoints built from the reference's own
``infer_shape`` and handed as numpy arrays to both packages: the
GPT-2-style model of ``tests/test_serve.py`` and a llama-style variant
(rope + grouped-query + SwiGLU + RMSNorm + tied head).  Weight scale
0.35 gives greedy argmax varied, non-degenerate sequences with wide
logit margins.  For RNN training, the RNN-op language model of
``examples/rnn_time_major.py`` in both packages (``ref_rnn_lm``,
``port_rnn_lm``) and a trainer pair on it (``rnn_train_pair``).
"""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

VOCAB = 53
SEQ = 96
VARIANTS = {
    "gpt2": dict(num_layers=2, d_model=32, num_heads=4),
    "llama": dict(num_layers=2, d_model=32, num_heads=4, kv_heads=2,
                  norm="rmsnorm", mlp="swiglu", pos_embed="rope",
                  tie_embeddings=True),
}


def ref_net(variant, seq=SEQ, **extra):
    import mxnet_tpu as mx

    return mx.models.gpt(VOCAB, seq, **VARIANTS[variant], **extra)


def ref_params(net, seq=SEQ, seed=3, scale=0.35):
    """numpy params in argument order from the reference's shapes."""
    arg_shapes, _, _ = net.infer_shape(data=(1, seq), softmax_label=(1, seq))
    rng = np.random.RandomState(seed)
    params = {}
    for name, shp in zip(net.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        s = scale if name.endswith("weight") else 0.0
        params[name] = (rng.randn(*shp) * s
                        + (1.0 if name.endswith("gamma") else 0.0)
                        ).astype(np.float32)
    return params


def model(variant):
    """(reference net, numpy params, num_heads) for one variant."""
    net = ref_net(variant)
    return net, ref_params(net), VARIANTS[variant]["num_heads"]


def prompts(n, seed=7, lo=6, hi=22):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, (rng.randint(lo, hi),)).astype(np.int32)
            for _ in range(n)]


# -- training: the reference ShardedTrainer and the port's on one batch ----
TRAIN_SEQ, TRAIN_BATCH = 16, 4
TRAIN_BASE = dict(num_layers=2, d_model=32, num_heads=4)
TRAIN_VARIANTS = {
    "gpt2": {},
    "llama": dict(kv_heads=2, mlp="swiglu", norm="rmsnorm",
                  pos_embed="rope", tie_embeddings=True),
    "fused_qkv": dict(fused_qkv=True),
    "ce": dict(loss="ce"),
    "window_bshd": dict(attn_window=5, attn_layout="bshd"),
    "flash_interpret": dict(attn_impl="flash"),
}
TRAIN_OPTS = {"sgd": {"learning_rate": 0.1},
              "adam": {"learning_rate": 3e-3}}


def train_batch(seed=0):
    rng = np.random.RandomState(seed)
    shape = (TRAIN_BATCH, TRAIN_SEQ)
    return {"data": rng.randint(0, VOCAB, shape).astype(np.int32),
            "softmax_label": rng.randint(0, VOCAB, shape).astype(np.int32)}


def train_pair(variant, optimizer):
    """(reference trainer, port trainer) for one variant, both starting
    from the reference trainer's Xavier-initialised parameters."""
    import mxnet_tpu as mx
    import mxnet_tpu_torch as mt

    extra = {**TRAIN_BASE, **TRAIN_VARIANTS[variant]}
    shapes = {"data": (TRAIN_BATCH, TRAIN_SEQ),
              "softmax_label": (TRAIN_BATCH, TRAIN_SEQ)}
    dtypes = {"data": np.int32, "softmax_label": np.int32}
    ref = mx.parallel.ShardedTrainer(
        mx.models.gpt(VOCAB, TRAIN_SEQ, **extra), shapes,
        mesh=mx.parallel.make_mesh({"dp": 1}), optimizer=optimizer,
        optimizer_params=TRAIN_OPTS[optimizer],
        initializer=mx.initializer.Xavier(), input_dtypes=dtypes)
    port = mt.parallel.ShardedTrainer(
        mt.models.gpt(VOCAB, TRAIN_SEQ, **extra), shapes,
        optimizer=optimizer, optimizer_params=TRAIN_OPTS[optimizer],
        initializer=mt.initializer.Xavier(), input_dtypes=dtypes,
        device="cpu")
    port.set_params(ref.get_params())
    return ref, port


# -- RNN training: the RNN-op language model of examples/rnn_time_major.py --
# Embedding -> RNN (time-major (T, N)) -> Reshape(-1, H) -> FullyConnected
# -> SoftmaxOutput, at a tiny width: V 12, T 8, N 4, H 16 (the embedding
# as wide as the hidden state), 2 layers.
RNN_VOCAB, RNN_SEQ, RNN_BATCH, RNN_HIDDEN, RNN_LAYERS = 12, 8, 4, 16, 2
RNN_OPTS = {"sgd": {"learning_rate": 0.1},
            "adam": {"learning_rate": 0.01}}


def ref_rnn_lm(mode, vocab=RNN_VOCAB, hidden=RNN_HIDDEN,
               num_layers=RNN_LAYERS):
    """The reference's build_net (examples/rnn_time_major.py:27-40) with
    ``mode`` and ``num_layers``; its RNN arguments are named after the
    mode (``lstm_parameters``, ``gru_state``, ...)."""
    import mxnet_tpu as mx

    data = mx.sym.Variable("data")
    embed = mx.sym.Embedding(data, name="embed", input_dim=vocab,
                             output_dim=hidden)
    kw = dict(parameters=mx.sym.Variable(f"{mode}_parameters"),
              state=mx.sym.Variable(f"{mode}_state"))
    if mode == "lstm":
        kw["state_cell"] = mx.sym.Variable("lstm_state_cell")
    rnn = mx.sym.RNN(embed, name=mode, mode=mode, state_size=hidden,
                     num_layers=num_layers, **kw)
    flat = mx.sym.Reshape(rnn, shape=(-1, hidden))
    fc = mx.sym.FullyConnected(flat, name="cls", num_hidden=vocab)
    label = mx.sym.Reshape(mx.sym.Variable("softmax_label"), shape=(-1,))
    return mx.sym.SoftmaxOutput(fc, label, name="softmax")


def port_rnn_lm(mode, batch=RNN_BATCH, vocab=RNN_VOCAB, hidden=RNN_HIDDEN,
                num_layers=RNN_LAYERS):
    """The same network composed from the port's ops, as an nn.Module
    whose parameters carry the reference's argument names and order."""
    import torch
    from torch import nn

    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.ops.rnn import rnn_infer_shape

    class RNNLM(nn.Module):
        def __init__(self):
            super().__init__()
            shapes = rnn_infer_shape((1, batch, hidden), hidden, num_layers,
                                     mode)[0]
            names = ["parameters", "state", "state_cell"][:len(shapes) - 1]
            args = [("embed_weight", (vocab, hidden))]
            args += [(f"{mode}_{n}", s) for n, s in zip(names, shapes[1:])]
            args += [("cls_weight", (vocab, hidden)), ("cls_bias", (vocab,))]
            for name, shape in args:
                self.register_parameter(name, nn.Parameter(
                    torch.empty(shape, device="meta")))

        def forward(self, data, softmax_label):
            p = self._parameters
            x = ops.Embedding(data, p["embed_weight"])          # (T, N, H)
            y = ops.RNN(x, p[f"{mode}_parameters"], p[f"{mode}_state"],
                        p.get("lstm_state_cell"), state_size=hidden,
                        num_layers=num_layers, mode=mode)
            fc = ops.FullyConnected(y.reshape(-1, hidden), p["cls_weight"],
                                    p["cls_bias"], num_hidden=vocab)
            return ops.SoftmaxOutput(fc, softmax_label.reshape(-1))

    return RNNLM()


def rnn_batch(seed=0):
    rng = np.random.RandomState(seed)
    shape = (RNN_SEQ, RNN_BATCH)
    return {"data": rng.randint(0, RNN_VOCAB, shape).astype(np.int32),
            "softmax_label": rng.randint(0, RNN_VOCAB, shape).astype(
                np.int32)}


def rnn_train_pair(mode, optimizer):
    """(reference trainer, port trainer) on the RNN-op LM, both from the
    reference trainer's initial parameters, rescale_grad = 1/N (the
    batch is axis 1 of the time-major inputs)."""
    import mxnet_tpu as mx
    import mxnet_tpu_torch as mt

    shapes = {"data": (RNN_SEQ, RNN_BATCH),
              "softmax_label": (RNN_SEQ, RNN_BATCH)}
    dtypes = {"data": np.int32, "softmax_label": np.int32}
    common = dict(optimizer=optimizer, optimizer_params=RNN_OPTS[optimizer],
                  input_dtypes=dtypes, rescale_grad=1.0 / RNN_BATCH)
    ref = mx.parallel.ShardedTrainer(
        ref_rnn_lm(mode), shapes, mesh=mx.parallel.make_mesh({"dp": 1}),
        initializer=mx.initializer.Xavier(), **common)
    port = mt.parallel.ShardedTrainer(
        port_rnn_lm(mode), shapes, initializer=mt.initializer.Xavier(),
        device="cpu", **common)
    port.set_params(ref.get_params())
    return ref, port
