"""The port's Module (``mxnet_tpu_torch.module``) against the reference's.

- 3 Adam steps of a Module over a tiny ``gpt_symbol`` (the GPT-2-style,
  llama-style and flash-interpret variants of ``torch_port_fixtures``)
  against the reference's Module over its ``gpt()`` from the same
  numpy parameters and batch, through forward / backward / update.
  Head outputs are held at 5e-6 at step 1 and 1e-4 after, parameters
  element by element at the bound of ``test_torch_trainer_adam.py``
  (``adam_param_bound``: Adam moves an element whose gradient is at
  float32-noise level by up to lr either way; each step's term takes
  that step's gradient and its drift, measured here with a probe module
  set to the reference's parameters).
- ``Module.fit`` with ``NDArrayIter``, ``Accuracy`` and ``Speedometer``
  on an MLP of FullyConnected / Activation / SoftmaxOutput, against the
  reference's ``fit``: metric values within 1e-6, parameters within 2e-6.
- A checkpoint written by either package's ``Module.save_checkpoint``
  (symbol JSON + ``.params``, bfloat16 parameters included) loads with
  the other's ``Module.load`` and gives the same outputs.
- score, predict, input gradients, shared modules, borrowed optimizers,
  optimizer states, save/load_params; more than one context raises,
  naming §A18.
"""

import logging

import numpy as np
import pytest
import torch

import torch_port_fixtures as fx
from torch_port_fixtures import (  # noqa: F401
    collect_engines_after_module)  # (autouse)
from test_torch_trainer_adam import (ADAM_PARAM_TOL, GRAD_NOISE,
                                     LATER_OUT_TOL, OUT_TOL, ROUNDING_LEVEL,
                                     _zero_grad_rows)

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

LR = fx.TRAIN_OPTS["adam"]["learning_rate"]
SHAPE = (fx.TRAIN_BATCH, fx.TRAIN_SEQ)


@pytest.fixture(autouse=True)
def _pinned_threads():
    with fx.pinned_threads():
        yield


def _gpt(M, variant):
    kw = {**fx.TRAIN_BASE, **fx.TRAIN_VARIANTS[variant]}
    with M.sym.NameManager():
        if M is mx:
            return mx.models.gpt(fx.VOCAB, fx.TRAIN_SEQ, **kw)
        return mt.models.gpt_symbol(fx.VOCAB, fx.TRAIN_SEQ, **kw)


def _module(M, net, params, optimizer="adam", lr=LR, **bind):
    mod = M.mod.Module(net, context=M.cpu())
    mod.bind([("data", SHAPE)], [("softmax_label", SHAPE)], **bind)
    mod.init_params(arg_params={k: M.nd.array(v) for k, v in params.items()})
    mod.init_optimizer(optimizer=optimizer,
                       optimizer_params=(("learning_rate", lr),))
    return mod


def _batch(M, seed=0):
    b = fx.train_batch(seed)
    return M.io.DataBatch([M.nd.array(b["data"])],
                          [M.nd.array(b["softmax_label"])])


def _fwd_bwd(mod, db):
    mod.forward(db, is_train=True)
    mod.backward()
    exe = mod._exec_group.execs[0]
    return (mod.get_outputs()[0].asnumpy(),
            {k: exe.grad_dict[k].asnumpy() for k in mod._param_names})


def _params(mod):
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def _init_params(net, seed=0):
    """Xavier-like numpy parameters from a seeded RandomState."""
    arg_shapes, _, _ = net.infer_shape(data=SHAPE, softmax_label=SHAPE)
    rng = np.random.RandomState(seed)
    out = {}
    for name, shp in zip(net.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("gamma"):
            out[name] = np.ones(shp, np.float32)
        elif name.endswith(("bias", "beta")):
            out[name] = np.zeros(shp, np.float32)
        else:
            scale = np.sqrt(3.0 / ((shp[0] + np.prod(shp[1:])) / 2.0))
            out[name] = rng.uniform(-scale, scale, shp).astype(np.float32)
    return out


@pytest.mark.parametrize("variant", ["gpt2", "llama", "flash_interpret"])
def test_three_adam_steps_match_reference(variant):
    with mx.cpu():
        ref_net = _gpt(mx, variant)
        params = _init_params(ref_net)
        ref = _module(mx, ref_net, params)
        ref_db = _batch(mx)
    with mt.cpu():
        port = _module(mt, _gpt(mt, variant), params)
        probe = _module(mt, _gpt(mt, variant), params)
        db = _batch(mt)
        step_grads, drifts, outs, ref_outs = [], [], [], []
        for _ in range(3):
            out, grads = _fwd_bwd(port, db)
            probe.set_params(_params(ref), {})
            _, at_ref = _fwd_bwd(probe, db)
            port.update()
            step_grads.append(grads)
            drifts.append({k: np.abs(grads[k] - at_ref[k]) for k in grads})
            outs.append(out)
            with mx.cpu():
                ref.forward(ref_db, is_train=True)
                ref.backward()
                ref.update()
                ref_outs.append(ref.get_outputs()[0].asnumpy())
    for step, (got, want) in enumerate(zip(outs, ref_outs)):
        tol = OUT_TOL if step == 0 else LATER_OUT_TOL
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    want, got = _params(ref), _params(port)
    assert set(got) == set(want)
    for k in want:
        allowed = np.full(want[k].shape, ADAM_PARAM_TOL)
        for grads, drift in zip(step_grads, drifts):
            g = np.abs(grads[k])
            noise = GRAD_NOISE * float(g.max()) + drift[k]
            allowed += LR * np.minimum(2.0, noise / np.maximum(g, 1e-30))
        rows = _zero_grad_rows(k, variant)
        if rows is not None:
            assert max(float(np.abs(g[k][rows]).max())
                       for g in step_grads) <= ROUNDING_LEVEL, k
            allowed[rows] = ADAM_PARAM_TOL + 2 * len(step_grads) * LR
        err = np.abs(got[k] - want[k])
        assert np.all(err <= allowed), (k, float((err / allowed).max()))


def _mlp(M):
    with M.sym.NameManager():
        data = M.sym.Variable("data")
        h = M.sym.FullyConnected(data, name="fc1", num_hidden=16)
        h = M.sym.Activation(h, act_type="relu")
        h = M.sym.FullyConnected(h, name="fc2", num_hidden=4)
        return M.sym.SoftmaxOutput(h, name="softmax")


_RS = np.random.RandomState(0)
X = _RS.randn(64, 10).astype(np.float32)
Y = _RS.randint(0, 4, 64).astype(np.float32)


def _mlp_params(net):
    arg_shapes, _, _ = net.infer_shape(data=(16, 10))
    rng = np.random.RandomState(1)
    return {n: (rng.randn(*s) * 0.3).astype(np.float32)
            for n, s in zip(net.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}


def _fit(M, optimizer, opt_params, caplog):
    with M.cpu():
        net = _mlp(M)
        mod = M.mod.Module(net, context=M.cpu())
        train = M.io.NDArrayIter(X, Y, batch_size=16)
        val = M.io.NDArrayIter(X[:32], Y[:32], batch_size=16)
        acc = M.metric.create("acc")
        epochs = []
        caplog.clear()
        with caplog.at_level(logging.INFO):
            mod.fit(train, eval_data=val, eval_metric=acc,
                    optimizer=optimizer, optimizer_params=opt_params,
                    arg_params={k: M.nd.array(v)
                                for k, v in _mlp_params(net).items()},
                    num_epoch=3,
                    batch_end_callback=M.callback.Speedometer(16, 2),
                    epoch_end_callback=lambda e, s, a, x: epochs.append(
                        acc.get()[1]))
        logs = [r.getMessage() for r in caplog.records
                if "Train-" in r.getMessage() or "Validation" in
                r.getMessage()]
        score = mod.score(val, "acc")
        pred = mod.predict(val).asnumpy()
        return _params(mod), epochs, score, pred, logs


@pytest.mark.parametrize("optimizer,opt_params", [
    ("sgd", (("learning_rate", 0.1), ("momentum", 0.9))),
    ("adam", (("learning_rate", 0.01), ("wd", 0.001)))], ids=["sgd", "adam"])
def test_fit_score_predict_match_reference(optimizer, opt_params, caplog):
    ref = _fit(mx, optimizer, opt_params, caplog)
    got = _fit(mt, optimizer, opt_params, caplog)
    for k in ref[0]:
        np.testing.assert_allclose(got[0][k], ref[0][k], rtol=0, atol=2e-6)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-6)
    assert got[2][0][0] == ref[2][0][0]
    assert got[2][0][1] == pytest.approx(ref[2][0][1], rel=1e-6)
    np.testing.assert_allclose(got[3], ref[3], rtol=0, atol=2e-6)
    # the logged metrics (not the speeds) read the same
    strip = [ln.split("\t")[-1] for ln in ref[4]]
    assert [ln.split("\t")[-1] for ln in got[4]] == strip


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_checkpoint_crosses_packages(direction, tmp_path):
    """Symbol JSON + ``.params`` with a bfloat16 parameter: written by one
    package's Module, loaded by the other's, the same outputs."""
    src, dst = (mx, mt) if direction == "ref_to_port" else (mt, mx)
    prefix = str(tmp_path / "gpt")
    with src.cpu():
        net = _gpt(src, "llama")
        params = _init_params(net, seed=4)
        mod = _module(src, net, params)
        db = _batch(src, seed=2)
        mod.forward(db, is_train=False)
        want = mod.get_outputs()[0].asnumpy()
        mod.save_checkpoint(prefix, 3)
        # a bfloat16 entry rides along in the same file
        args, auxs = mod.get_params()
        args = dict(args)
        args["extra_bf16"] = src.nd.array(np.linspace(-2, 2, 8, dtype=np.float32),
                                          dtype="bfloat16")
        src.model.save_checkpoint(prefix + "_bf", 3, net, args, auxs)
    with dst.cpu():
        loaded = dst.mod.Module.load(prefix, 3, context=dst.cpu())
        loaded.bind([("data", SHAPE)], [("softmax_label", SHAPE)],
                    for_training=False)
        loaded.forward(_batch(dst, seed=2), is_train=False)
        got = loaded.get_outputs()[0].asnumpy()
        _, args2, _ = dst.model.load_checkpoint(prefix + "_bf", 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    bf = args2["extra_bf16"]
    assert dst.base.dtype_name(bf.dtype) == "bfloat16"
    want_bf = torch.from_numpy(np.linspace(-2, 2, 8, dtype=np.float32)
                               ).bfloat16().float().numpy()
    np.testing.assert_array_equal(np.asarray(bf.asnumpy(), np.float32),
                                  want_bf)


def test_input_grads_shared_module_and_states(tmp_path):
    with mt.cpu():
        net = _mlp(mt)
        params = _mlp_params(net)
        mod = mt.mod.Module(net, context=mt.cpu())
        mod.bind([("data", (16, 10))], [("softmax_label", (16,))],
                 inputs_need_grad=True)
        mod.init_params(arg_params={k: mt.nd.array(v)
                                    for k, v in params.items()})
        mod.init_optimizer(optimizer="adam")
        db = mt.io.DataBatch([mt.nd.array(X[:16])], [mt.nd.array(Y[:16])])
        mod.forward_backward(db)
        g_in = mod.get_input_grads()[0].asnumpy()
        assert g_in.shape == (16, 10) and np.abs(g_in).sum() > 0
        # a shared module aliases the parameters and borrows the optimizer
        other = mt.mod.Module(net, context=mt.cpu())
        other.bind([("data", (8, 10))], [("softmax_label", (8,))],
                   shared_module=mod)
        assert other.optimizer_initialized
        assert (other._exec_group.execs[0].arg_dict["fc1_weight"]
                is mod._exec_group.execs[0].arg_dict["fc1_weight"])
        assert mod.train_step(db) is False and mod._fused_reason == "not_ported"
        got = _params(other)
        np.testing.assert_array_equal(got["fc1_weight"],
                                      _params(mod)["fc1_weight"])
        prefix = str(tmp_path / "mlp")
        mod.save_checkpoint(prefix, 1, save_optimizer_states=True)
        mod.save_params(str(tmp_path / "p.params"))
        fresh = mt.mod.Module(net, context=mt.cpu())
        fresh.bind([("data", (16, 10))], [("softmax_label", (16,))])
        fresh.init_params(mt.init.Zero())
        fresh.load_params(str(tmp_path / "p.params"))
        np.testing.assert_array_equal(_params(fresh)["fc2_weight"],
                                      _params(mod)["fc2_weight"])
        import pickle
        with open(prefix + "-0001.states", "rb") as f:
            states = pickle.load(f)
        assert set(states) == set(range(4)) and len(states[0]) == 2
    # the reference reads the same .params
    ref_args = mx.nd.load(str(tmp_path / "p.params"))
    np.testing.assert_array_equal(ref_args["arg:fc2_weight"].asnumpy(),
                                  _params(mod)["fc2_weight"])


def test_multiple_contexts_and_kvstores_raise_naming_a18():
    with mt.sym.NameManager():
        net = _mlp(mt)
    with pytest.raises(NotImplementedError, match="A18"):
        mt.mod.Module(net, context=[mt.cpu(0), mt.cpu(1)])
    mod = mt.mod.Module(net, context=mt.cpu())
    mod.bind([("data", (16, 10))], [("softmax_label", (16,))])
    mod.init_params(mt.init.Xavier())
    with pytest.raises(NotImplementedError, match="A18"):
        mod.init_optimizer(kvstore="dist_sync")
    mod.init_optimizer(kvstore="local")
    assert mod._kvstore is None
    assert mod.output_shapes == [("softmax_output", (16, 4))]
    assert torch.device("cpu") == mod._exec_group.execs[0]._device
