"""The port's optimizers, schedulers, metrics, initializers and
``NDArrayIter`` against the reference's.

Every registered optimizer (sgd, ccsgd, nag, adam, adagrad, rmsprop,
adadelta, test, adamw, lars, lamb) runs the same updates in both
packages, from the same seeded numpy weights and gradients, with
rescale_grad, clip_gradient, weight decay and lr/wd multipliers, and the
weights and states are held within 2e-6 relative (float32 in another
order; Adam's bias-corrected step is computed in float32 by both).  SGLD
adds noise from each package's own generator: its noise is held by its
variance.  Metrics and callbacks run the same batches in both packages
and are held equal; initializers seeded the same draw the same values
(the port's RandomState, the reference's global one, call for call).
"""

import logging

import numpy as np
import pytest

import torch_port_fixtures  # noqa: F401  (puts the repo on sys.path)
from torch_port_fixtures import (  # noqa: F401
    collect_engines_after_module)  # (autouse)

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

TOL = 2e-6
OPTS = {
    "sgd": dict(learning_rate=0.1),
    "sgd_momentum": dict(learning_rate=0.1, momentum=0.9, wd=0.01),
    "ccsgd": dict(learning_rate=0.05, momentum=0.5),
    "nag": dict(learning_rate=0.1, momentum=0.9, wd=0.001),
    "adam": dict(learning_rate=0.01, wd=0.01),
    "adagrad": dict(learning_rate=0.1, wd=0.01),
    "rmsprop": dict(learning_rate=0.01, wd=0.01),
    "adadelta": dict(wd=0.01),
    "test": dict(),
    "adamw": dict(learning_rate=0.01, wd=0.1),
    "lars": dict(learning_rate=0.1, momentum=0.9, wd=1e-4),
    "lamb": dict(learning_rate=0.01, wd=0.01),
}


def _run(M, name, w0s, grads, **extra):
    kw = dict(OPTS[name], **extra)
    reg = name.split("_")[0]
    opt = M.optimizer.create(reg, param_idx2name={0: "fc_weight",
                                                  1: "fc_bias"}, **kw)
    with M.cpu():
        ws = [M.nd.array(w) for w in w0s]
        states = [opt.create_state(i, w) for i, w in enumerate(ws)]
        for g in grads:
            for i, (w, s) in enumerate(zip(ws, states)):
                opt.update(i, w, M.nd.array(g[i]), s)
        flat = [s for st in states for s in (
            st if isinstance(st, (tuple, list)) else [st]) if s is not None]
        return [w.asnumpy() for w in ws], [s.asnumpy() for s in flat]


@pytest.mark.parametrize("extra", [
    {}, {"rescale_grad": 0.25, "clip_gradient": 0.5}], ids=["plain", "clip"])
@pytest.mark.parametrize("name", sorted(OPTS))
def test_optimizer_updates_match_reference(name, extra):
    rng = np.random.RandomState(4)
    w0s = [rng.randn(6, 5).astype(np.float32), rng.randn(6).astype(np.float32)]
    grads = [[rng.randn(6, 5).astype(np.float32),
              rng.randn(6).astype(np.float32)] for _ in range(4)]
    ref_w, ref_s = _run(mx, name, w0s, grads, **extra)
    got_w, got_s = _run(mt, name, w0s, grads, **extra)
    for a, b in zip(ref_w + ref_s, got_w + got_s):
        np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)
    assert len(got_s) == len(ref_s)


def test_sgld_noise_by_variance():
    """SGLD: w - lr/2 g + N(0, lr); the noise's variance is lr."""
    lr = 0.04
    opt = mt.optimizer.create("sgld", learning_rate=lr)
    with mt.cpu():
        w = mt.nd.zeros((200, 200))
        opt.update(0, w, mt.nd.zeros((200, 200)), None)
    noise = w.asnumpy()
    assert abs(noise.mean()) < 0.005 and abs(noise.var() / lr - 1) < 0.03


def test_adam_bias_correction_formula():
    """lr_t = lr sqrt(1 - b2^t) / (1 - b1^t), eps outside the sqrt."""
    rng = np.random.RandomState(1)
    w0 = rng.randn(4).astype(np.float32)
    grads = [[rng.randn(4).astype(np.float32)] for _ in range(4)]
    out = _run(mt, "adam", [w0], grads, wd=0.0)[0][0]
    ref, m, v = w0.astype(np.float64), np.zeros(4), np.zeros(4)
    for t, (g,) in enumerate(grads, 1):
        lr_t = 0.01 * np.sqrt(1 - 0.999 ** t) / (1 - 0.9 ** t)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        ref -= lr_t * m / (np.sqrt(v) + 1e-8)
    np.testing.assert_allclose(out, ref, rtol=1e-5)


def test_lr_wd_multipliers_schedulers_and_updater():
    for M in (mx, mt):
        with M.sym.NameManager():
            w = M.sym.Variable("fc_weight", lr_mult=2.0, wd_mult=0.5)
            fc = M.sym.FullyConnected(M.sym.Variable("data"), weight=w,
                                      num_hidden=2, name="fc")
            out = M.sym.SoftmaxOutput(fc)
        opt = M.optimizer.SGD(learning_rate=0.1, wd=0.2, sym=out,
                              param_idx2name={0: "fc_weight", 1: "fc_bias"})
        assert opt._get_lr(0) == pytest.approx(0.2)
        assert opt._get_wd(0) == pytest.approx(0.1)
        assert opt._get_wd(1) == 0.0
    for cls, kw, steps in (
            ("FactorScheduler", dict(step=10, factor=0.5), (5, 11, 25)),
            ("MultiFactorScheduler", dict(step=[4, 8], factor=0.1),
             (2, 5, 9)),
            ("PolyScheduler", dict(max_update=20, warmup_steps=4), (2, 9, 30)),
            ("CosineScheduler", dict(max_update=20, final_lr=0.1),
             (0, 10, 20))):
        a, b = getattr(mx.lr_scheduler, cls)(**kw), getattr(
            mt.lr_scheduler, cls)(**kw)
        a.base_lr = b.base_lr = 1.0
        assert [b(s) for s in steps] == [a(s) for s in steps]
    with mt.cpu():
        upd = mt.optimizer.get_updater(mt.optimizer.SGD(learning_rate=0.5))
        w = mt.nd.ones((2,))
        upd(0, mt.nd.ones((2,)), w)
        np.testing.assert_array_equal(w.asnumpy(), [0.5, 0.5])
        assert 0 in upd.states


METRICS = ["acc", "top_k_accuracy", "f1", "mae", "mse", "rmse", "ce",
           "loss", "torch", "caffe"]


def _metric_batches(rng):
    preds = rng.rand(8, 3).astype(np.float32)
    preds /= preds.sum(1, keepdims=True)
    labels = rng.randint(0, 3, 8).astype(np.float32)
    return labels, preds


@pytest.mark.parametrize("name", METRICS)
@pytest.mark.parametrize("device", [False, True], ids=["host", "device"])
def test_metric_matches_reference(name, device):
    rng = np.random.RandomState(8)
    batches = [_metric_batches(rng) for _ in range(3)]
    if name in ("mae", "mse", "rmse"):       # regression: targets of
        batches = [(p[::-1].copy(), p) for _, p in batches]   # pred's shape
    if name == "f1":
        batches = [(np.minimum(lab, 1), p[:, :2] / p[:, :2].sum(1,
                                                               keepdims=True))
                   for lab, p in batches]
    kw = {"top_k": 2} if name == "top_k_accuracy" else {}
    values = []
    for M in (mx, mt):
        met = M.metric.create(name, **kw)
        if device:
            met.device_accumulate(2)
        with M.cpu():
            for lab, pred in batches:
                if device and met.device_active:
                    met.update_device([M.nd.array(lab)], [M.nd.array(pred)])
                else:
                    met.update([M.nd.array(lab)], [M.nd.array(pred)])
        values.append(met.get_name_value())
    (r_name, r_val), = values[0]
    (p_name, p_val), = values[1]
    assert p_name == r_name
    assert p_val == pytest.approx(r_val, rel=1e-6, abs=1e-7)


def test_composite_custom_and_np_metrics():
    rng = np.random.RandomState(9)
    lab, pred = _metric_batches(rng)
    out = []
    for M in (mx, mt):
        comp = M.metric.create(["acc", "ce"])
        comp.add(M.metric.np(lambda l, p: float(np.abs(l - p.argmax(1)).sum()),
                             name="l1"))
        with M.cpu():
            comp.update([M.nd.array(lab)], [M.nd.array(pred)])
        out.append(comp.get())
        assert comp.get_metric(2).name == "custom(l1)"
    assert out[1][0] == out[0][0]
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=1e-6)


def test_callbacks_log_like_reference(caplog):
    lines = []
    for M in (mx, mt):
        met = M.metric.create("acc")
        met.sum_metric, met.num_inst = 3.0, 4
        caplog.clear()
        with caplog.at_level(logging.INFO):
            M.callback.log_train_metric(1)(M.callback.BatchEndParam(
                epoch=1, nbatch=2, eval_metric=met))
            M.callback.LogValidationMetricsCallback()(
                M.callback.BatchEndParam(epoch=1, nbatch=2, eval_metric=met))
            M.callback.ProgressBar(total=10, length=10)(
                M.callback.BatchEndParam(epoch=1, nbatch=4, eval_metric=met))
            sp = M.callback.Speedometer(batch_size=4, frequent=1)
            sp(M.callback.BatchEndParam(epoch=0, nbatch=0, eval_metric=None))
        lines.append([r.getMessage() for r in caplog.records])
    assert lines[1] == lines[0]


INITS = {
    "uniform": lambda M: M.init.Uniform(0.3),
    "normal": lambda M: M.init.Normal(0.2),
    "xavier": lambda M: M.init.Xavier(),
    "xavier_gauss_in": lambda M: M.init.Xavier("gaussian", "in", 2.0),
    "msraprelu": lambda M: M.init.MSRAPrelu(),
    "orthogonal": lambda M: M.init.Orthogonal(),
    "one": lambda M: M.init.One(),
    "constant": lambda M: M.init.Constant(0.25),
    "mixed": lambda M: M.init.Mixed(["fc.*", ".*"],
                                    [M.init.Xavier(), M.init.Uniform(0.1)]),
}
INIT_NAMES = ["fc_weight", "fc_bias", "ln_gamma", "ln_beta", "bn_moving_mean",
              "bn_moving_var", "conv_weight", "upsampling0_weight",
              "rnn_parameters", "rnn_init_state"]


@pytest.mark.parametrize("kind", sorted(INITS))
def test_initializer_draws_equal_reference(kind, monkeypatch):
    """The reference draws with ``np.random.*``, the port from its own
    RandomState: seeded alike, the values are equal.  The reference's
    draws are routed to a seeded RandomState here (``np.random`` stood
    in for while it runs), so nothing is drawn from numpy's global
    generator."""
    shapes = {"conv_weight": (4, 3, 3, 3), "upsampling0_weight": (2, 1, 4, 4),
              "fc_weight": (6, 5), "rnn_parameters": (7,)}

    def draw(M):
        ini = INITS[kind](M)
        vals = {}
        with M.cpu():
            for n in INIT_NAMES:
                arr = M.nd.zeros(shapes.get(n, (6,)))
                ini(n, arr)
                vals[n] = arr.asnumpy()
        return vals

    mt.random.seed(5)
    got = draw(mt)
    with monkeypatch.context() as m:
        m.setattr(np, "random", np.random.RandomState(5))
        ref = draw(mx)
    for n in INIT_NAMES:
        np.testing.assert_allclose(got[n], ref[n], rtol=1e-6, atol=1e-7,
                                   err_msg=n)


def test_load_and_bilinear_initializers():
    with mt.cpu():
        src = {"arg:fc_weight": mt.nd.array(np.full((2, 3), 7.0, np.float32))}
        ini = mt.init.Load(src, default_init=mt.init.Zero())
        w, b = mt.nd.ones((2, 3)), mt.nd.ones((2,))
        ini("fc_weight", w)
        ini("fc_bias", b)
        assert (w.asnumpy() == 7).all() and (b.asnumpy() == 0).all()
        with pytest.raises(mt.MXNetError, match="shape mismatch"):
            ini("fc_weight", mt.nd.ones((3, 3)))
        bil = mt.nd.zeros((2, 1, 4, 4))
        mt.init.Bilinear()("deconv_weight", bil)
        ref = mx.nd.zeros((2, 1, 4, 4))
        mx.init.Xavier()("upsampling_weight", ref)
        np.testing.assert_array_equal(bil.asnumpy(), ref.asnumpy())
    assert type(mt.initializer.init("xavier")) is mt.init.Xavier


@pytest.mark.parametrize("last", ["pad", "discard", "roll_over"])
def test_ndarray_iter_matches_reference(last):
    rng = np.random.RandomState(2)
    X = rng.randn(10, 3).astype(np.float32)
    Y = rng.randint(0, 3, 10).astype(np.float32)
    out = []
    for M in (mx, mt):
        with M.cpu():
            it = M.io.NDArrayIter(X, Y, batch_size=4, last_batch_handle=last)
            seen = []
            for _ in range(2):
                for b in it:
                    seen.append((b.data[0].asnumpy(), b.label[0].asnumpy(),
                                 b.pad))
                it.reset()
            out.append((seen, [(d.name, d.shape) for d in it.provide_data],
                        [(d.name, d.shape) for d in it.provide_label]))
    assert out[1][1:] == out[0][1:]
    assert len(out[1][0]) == len(out[0][0])
    for (a, b, c), (x, y, z) in zip(out[0][0], out[1][0]):
        np.testing.assert_array_equal(x, a)
        np.testing.assert_array_equal(y, b)
        assert z == c
    desc = mt.io.DataDesc("data", (4, 3), layout="TN")
    assert mt.io.DataDesc.get_batch_axis(desc.layout) == 1
