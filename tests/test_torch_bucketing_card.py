"""BucketingModule's kernel path: an RNN-op LSTM language model in float32.

On the CPU (``MXNET_TPU_FUSED_RNN=1``: the kernels' plain versions) a
BucketingModule over buckets 8 and 16 launches no kernel and lowers the
loss.  On the card (``cuda`` marker; skipped here with a stated reason,
and run by ``python3 -m pytest -q -m cuda --noconftest
tests/test_torch_bucketing_card.py``) the same module launches the
float32 fused-LSTM kernels (``lstm_fwd_f32`` and ``lstm_bwd_f32``, the
split-TF32 tensor-core forward and backward) once a layer and
step each, in both buckets, and no bf16 one, and its
parameters after four SGD steps agree with the same module's through the
eager scan (``MXNET_TPU_FUSED_RNN=0``) on the card: each within 4 2^-24
of its value plus 1e-4 of its largest update (float32 products summed in
another order, chip_smoke's train_bucketing bound).  This file imports
no JAX, so it runs on the card.
"""

import numpy as np
import pytest
import torch

import torch_port_fixtures  # noqa: F401  (puts the repo on sys.path)

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import fused_rnn_cuda as frc

V, E, H, L, N = 53, 32, 32, 2, 4
BUCKETS = (16, 8, 16, 8)
SGD = (("learning_rate", 0.1), ("momentum", 0.9), ("wd", 1e-5))


def _lm():
    data = mt.sym.Variable("data")
    emb = mt.sym.Embedding(data, input_dim=V, output_dim=E, name="embed")
    rnn = mt.sym.RNN(mt.sym.SwapAxis(emb, dim1=0, dim2=1), state_size=H,
                     num_layers=L, mode="lstm", name="lstm")
    flat = mt.sym.Reshape(mt.sym.SwapAxis(rnn, dim1=0, dim2=1),
                          shape=(-1, H))
    fc = mt.sym.FullyConnected(flat, num_hidden=V, name="cls")
    label = mt.sym.Reshape(mt.sym.Variable("softmax_label"), shape=(-1,))
    return mt.sym.SoftmaxOutput(fc, label, name="softmax")


def _module(ctx, params=None):
    bm = mt.mod.BucketingModule(
        lambda key: (_lm(), ["data"], ["softmax_label"]),
        default_bucket_key=16, context=ctx)
    bm.bind([("data", (N, 16))], [("softmax_label", (N, 16))])
    if params is None:
        mt.random.seed(4)
        bm.init_params(mt.init.Xavier())
    else:
        bm.set_params(params, {})
    bm.init_optimizer(optimizer="sgd", optimizer_params=SGD)
    return bm


def _train(bm, ctx):
    """SGD steps over BUCKETS; each step's launches and NLL."""
    rng = np.random.RandomState(1)
    launches, nll = [], []
    for T in BUCKETS:
        d = rng.randint(1, V, (N, T)).astype(np.float32)
        db = mt.io.DataBatch(
            [mt.nd.array(d, ctx=ctx)],
            [mt.nd.array(np.roll(d, -1, axis=1), ctx=ctx)], bucket_key=T,
            provide_data=[mt.io.DataDesc("data", (N, T))],
            provide_label=[mt.io.DataDesc("softmax_label", (N, T))])
        before = dict(frc.launches)
        bm.forward(db, is_train=True)
        bm.backward()
        bm.update()
        launches.append({k: v - before[k] for k, v in frc.launches.items()
                         if v != before[k]})
        p = bm.get_outputs()[0].asnumpy()
        lab = db.label[0].asnumpy().reshape(-1).astype(np.int64)
        nll.append(float(-np.log(p[np.arange(lab.size), lab]).mean()))
    return launches, nll


def _values(bm):
    return {k: v.asnumpy() for k, v in bm.get_params()[0].items()}


def test_cpu_bucketing_runs_the_plain_kernel_path_and_learns(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_FUSED_RNN", "1")
    with mt.cpu():
        bm = _module(mt.cpu())
        launches, nll = _train(bm, mt.cpu())
        launches2, nll2 = _train(bm, mt.cpu())
    assert launches == [{}] * len(BUCKETS) == launches2
    assert all(np.isfinite(nll + nll2)) and np.mean(nll2) < np.mean(nll)


@pytest.mark.cuda
def test_card_bucketing_launches_float32_kernels_and_matches_scan(
        monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the Hopper fused-RNN kernels are "
                    "compiled by nvcc for sm_90a and have no CPU or "
                    "interpret mode; chip_smoke.py's train_bucketing phase "
                    "runs them on the card")
    monkeypatch.delenv("MXNET_TPU_FUSED_RNN", raising=False)
    card = _module(mt.gpu(0))
    p0 = _values(card)
    launches, nll = _train(card, mt.gpu(0))
    per_step = {"lstm_fwd_f32": L, "lstm_bwd_f32": L}
    assert launches == [per_step] * len(BUCKETS)
    got = _values(card)
    monkeypatch.setenv("MXNET_TPU_FUSED_RNN", "0")
    scan = _module(mt.gpu(0), p0)
    launches, _ = _train(scan, mt.gpu(0))
    assert launches == [{}] * len(BUCKETS)
    want = _values(scan)
    for k in want:
        allowed = (4 * 2.0 ** -24 * np.abs(want[k])
                   + 1e-4 * float(np.abs(want[k] - p0[k]).max()))
        assert np.all(np.abs(got[k] - want[k]) <= allowed), k
    assert all(np.isfinite(nll))
