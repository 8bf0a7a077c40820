"""The training frontend's kernel path: a ``gpt_symbol`` Module in
float32.

On the CPU the ``FlashAttention`` op with ``attn_impl="flash"`` runs the
plain flash versions and launches no kernel; a few Adam steps lower the
loss.  On the card (``cuda`` marker; skipped here with a stated reason,
and run by ``python3 -m pytest -q -m cuda --noconftest
tests/test_torch_module_card.py``) the same Module, at head_dim 64 (the
training model's), launches the float32 flash kernels
(the split-TF32 ``flash_fwd_f32`` and ``flash_dkv_f32``, and
``flash_dq_simt``) once a layer and step each, and its outputs and
gradients agree with the CPU Module's from the same parameters: outputs
within 1e-5, each gradient within 2e-5 of its largest (float32-accurate
products summed in another order, as chip_smoke's ``module_small_check``
states).  This file
imports no JAX, so it runs on the card.
"""

import numpy as np
import pytest
import torch

import torch_port_fixtures  # noqa: F401  (puts the repo on sys.path)

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import flash_attention_cuda as fac

CFG = dict(num_layers=2, d_model=64, num_heads=4, fused_qkv=True,
           attn_impl="flash")
# the card's model: head_dim 64, within the split-TF32 forward's and
# dK/dV's limits
CARD_CFG = dict(CFG, d_model=128, num_heads=2)
VOCAB, SEQ, BATCH = 53, 32, 4


def _module(ctx, params=None, cfg=CFG):
    with mt.sym.NameManager():
        net = mt.models.gpt_symbol(VOCAB, SEQ, **cfg)
    mod = mt.mod.Module(net, context=ctx)
    mod.bind([("data", (BATCH, SEQ))], [("softmax_label", (BATCH, SEQ))])
    if params is None:
        mt.random.seed(3)
        mod.init_params(mt.init.Xavier())
    else:
        mod.set_params(params, {})
    mod.init_optimizer(optimizer="adam",
                       optimizer_params=(("learning_rate", 3e-3),))
    return mod


def _batch(ctx):
    rng = np.random.RandomState(1)
    return mt.io.DataBatch(
        [mt.nd.array(rng.randint(0, VOCAB, (BATCH, SEQ)), ctx=ctx)],
        [mt.nd.array(rng.randint(0, VOCAB, (BATCH, SEQ)), ctx=ctx)])


def _nll(mod, db):
    p = mod.get_outputs()[0].asnumpy()
    lab = db.label[0].asnumpy().reshape(-1).astype(np.int64)
    return float(-np.log(p[np.arange(lab.size), lab]).mean())


def test_cpu_module_runs_the_plain_flash_path_and_learns():
    before = dict(fac.launches)
    mod, db = _module(mt.cpu()), _batch(mt.cpu())
    nll = []
    for _ in range(4):
        mod.forward(db, is_train=True)
        mod.backward()
        mod.update()
        nll.append(_nll(mod, db))
    assert fac.launches == before
    assert all(np.isfinite(nll)) and nll[-1] < nll[0]


@pytest.mark.cuda
def test_card_module_launches_float32_kernels_and_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the Hopper flash kernels are compiled "
                    "by nvcc for sm_90a and have no CPU or interpret mode; "
                    "chip_smoke.py's train_module phase runs them on the "
                    "card")
    card = _module(mt.gpu(0), cfg=CARD_CFG)
    params = {k: v.asnumpy() for k, v in card.get_params()[0].items()}
    host = _module(mt.cpu(), params, cfg=CARD_CFG)
    outs, grads = {}, {}
    for tag, mod in (("card", card), ("cpu", host)):
        ctx = mod._context[0]
        db = _batch(ctx)
        before = dict(fac.launches)
        mod.forward(db, is_train=True)
        mod.backward()
        ran = {k: fac.launches[k] - before[k] for k in fac.launches}
        if tag == "card":
            want = CARD_CFG["num_layers"]
            assert ran == {"flash_fwd": 0, "flash_fwd_f32": want,
                           "flash_fwd_simt": 0,
                           "flash_dq": 0, "flash_dq_simt": want,
                           "flash_dkv": 0, "flash_dkv_f32": want,
                           "flash_dkv_simt": 0}
        outs[tag] = mod.get_outputs()[0].asnumpy()
        exe = mod._exec_group.execs[0]
        grads[tag] = {k: exe.grad_dict[k].asnumpy() for k in params}
    np.testing.assert_allclose(outs["card"], outs["cpu"], rtol=0, atol=1e-5)
    for k in params:
        scale = float(np.abs(grads["cpu"][k]).max())
        np.testing.assert_allclose(grads["card"][k], grads["cpu"][k],
                                   rtol=0, atol=2e-5 * max(scale, 1e-30),
                                   err_msg=k)
