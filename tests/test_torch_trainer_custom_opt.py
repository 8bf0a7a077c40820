"""Custom and unported optimizers of the port's ShardedTrainer against
the JAX reference's, on the CPU.

A custom optimizer is an ``(init, update)`` pair whose ``update`` returns
``(params, state)``.  The reference wraps ``update`` by its signature
(``mxnet_tpu/parallel/trainer.py``): an update that takes ``lr_scale``
(by name or through ``**kwargs``) gets the schedule's scale by keyword,
the legacy 4-positional form gets 1.0, the 3-argument form nothing, and
a schedule with an update that cannot take it is refused.  The forms of
``tests/test_sharded_checkpoint.py``'s custom-optimizer test (written so
that the same function updates jax arrays and torch tensors) train the
tiny ``gpt`` of ``test_torch_trainer.py`` for 3 steps in both
frameworks from the same parameters; parameters are held at 1e-5 after
the last step, as the SGD steps there (float32 sums in other orders,
~1e-6 on gradients of order 1, carried by 3 plain steps of lr <= 0.1),
and must have moved.
"""

import numpy as np
import pytest

import torch_port_fixtures as fx

PARAM_TOL = 1e-5


@pytest.fixture(autouse=True)
def _pinned_threads():
    with fx.pinned_threads():
        yield


def _init(params):
    return {}


def update_kw(grads, state, params, **kw):
    lr = 0.1 * kw.get("lr_scale", 1.0)
    return {k: p - lr * grads[k] for k, p in params.items()}, state


def update_legacy(grads, state, params, scale):
    return {k: p - 0.1 * scale * grads[k] for k, p in params.items()}, state


def update_3arg(grads, state, params):
    return {k: p - 0.05 * grads[k] for k, p in params.items()}, state


FORMS = {"kwargs_scheduled": (update_kw, True),
         "legacy_4arg": (update_legacy, False),
         "three_arg": (update_3arg, False)}


def _pair(update, scheduled):
    """(reference trainer, port trainer) on the tiny gpt with ``(_init,
    update)``, each with its own halving schedule when ``scheduled``."""
    import mxnet_tpu as mx
    import mxnet_tpu_torch as mt

    shapes = {"data": (fx.TRAIN_BATCH, fx.TRAIN_SEQ),
              "softmax_label": (fx.TRAIN_BATCH, fx.TRAIN_SEQ)}
    dtypes = {"data": np.int32, "softmax_label": np.int32}
    sched = (lambda: mx.lr_scheduler.FactorScheduler(step=1, factor=0.5)
             if scheduled else None)
    ref = mx.parallel.ShardedTrainer(
        mx.models.gpt(fx.VOCAB, fx.TRAIN_SEQ, **fx.TRAIN_BASE), shapes,
        mesh=mx.parallel.make_mesh({"dp": 1}), optimizer=(_init, update),
        initializer=mx.initializer.Xavier(), input_dtypes=dtypes,
        lr_scheduler=sched())
    port = mt.parallel.ShardedTrainer(
        mt.models.gpt(fx.VOCAB, fx.TRAIN_SEQ, **fx.TRAIN_BASE), shapes,
        optimizer=(_init, update), initializer=mt.initializer.Xavier(),
        input_dtypes=dtypes, lr_scheduler=sched(), device="cpu")
    port.set_params(ref.get_params())
    return ref, port


@pytest.mark.parametrize("form", sorted(FORMS))
def test_custom_update_forms_train_like_reference(form):
    ref, port = _pair(*FORMS[form])
    start = port.get_params()
    batch = fx.train_batch()
    for _ in range(3):
        ref.step(batch)
        port.step(batch)
    want, got = ref.get_params(), port.get_params()
    moved = max(float(np.abs(got[k] - start[k]).max()) for k in got)
    assert moved > 1e-3
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=PARAM_TOL,
                                   atol=PARAM_TOL, err_msg=k)


@pytest.mark.parametrize("update", [update_legacy, update_3arg])
def test_schedule_refused_for_update_without_lr_scale(update):
    """Both frameworks refuse a schedule the update cannot honour, rather
    than training flat."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu.base import MXNetError as RefError
    from mxnet_tpu_torch.base import MXNetError

    with pytest.raises(RefError, match="lr_scale"):
        _pair(update, True)
    with pytest.raises(MXNetError, match="lr_scale"):
        mt.parallel.ShardedTrainer(
            mt.models.gpt(fx.VOCAB, 8, num_layers=1, d_model=8,
                          num_heads=2),
            {"data": (2, 8), "softmax_label": (2, 8)},
            optimizer=(_init, update), lr_scheduler=lambda step: 0.1,
            device="cpu")


@pytest.mark.parametrize("name", ["lars", "lamb"])
def test_unported_optimizers_raise_naming_the_roadmap(name):
    import mxnet_tpu_torch as mt

    with pytest.raises(NotImplementedError,
                       match=rf"optimizer='{name}' is not ported yet "
                             r"\(ROADMAP §A18\)"):
        mt.parallel.ShardedTrainer(
            mt.models.gpt(fx.VOCAB, 8, num_layers=1, d_model=8,
                          num_heads=2),
            {"data": (2, 8), "softmax_label": (2, 8)}, optimizer=name,
            device="cpu")
