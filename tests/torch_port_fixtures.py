"""Shared inputs for the PyTorch-port parity tests (tests/test_torch_*.py).

Seeded tiny gpt() checkpoints built from the reference's own
``infer_shape`` and handed as numpy arrays to both packages: the
GPT-2-style model of ``tests/test_serve.py`` and a llama-style variant
(rope + grouped-query + SwiGLU + RMSNorm + tied head).  Weight scale
0.35 gives greedy argmax varied, non-degenerate sequences with wide
logit margins.
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
