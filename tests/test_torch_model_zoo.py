"""The port's image-classification zoo against the reference's, on the CPU.

- Every builder of ``mxnet_tpu_torch.models`` (``resnet`` at depths
  18-152 with the conv7, cifar and s2d stems and both layouts,
  ``inception_bn``, ``inception_bn_small``, ``googlenet``, ``vgg``,
  ``alexnet``, ``lenet``, ``mlp``) gives the reference's Symbol JSON byte
  for byte (both built under fresh NameManagers).
- Each runs an inference forward at a small image size from the same
  numpy parameters and moving statistics, the outputs within 1e-5
  (probabilities; float32 convolutions summed in other orders).
- ResNet-18 (``image_shape=(3, 16, 16)``) through both packages'
  ``Module``: 2 SGD steps (lr 0.1, momentum 0.9, wd 1e-4) from the same
  ``arg_params``/``aux_params`` and batches; outputs, every parameter
  and every moving statistic within 1e-5 of the reference's (float32
  in other orders; about 1e-6 is seen, against steps of up to 0.08),
  and a checkpoint with its ``aux:`` entries loading in the
  other package with the same inference outputs.
"""

import numpy as np
import pytest

import torch_port_fixtures  # noqa: F401  (puts the repo on sys.path)

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

OUT_TOL = 1e-5
PARAM_TOL = 1e-5

BUILDERS = {
    "resnet18_cifar": ("resnet", dict(num_classes=10, num_layers=18,
                                      image_shape=(3, 32, 32))),
    "resnet34": ("resnet", dict(num_layers=34)),
    "resnet50": ("resnet", dict(num_classes=1000, num_layers=50,
                                image_shape=(3, 224, 224))),
    "resnet50_nhwc": ("resnet", dict(num_layers=50, layout="NHWC")),
    "resnet50_s2d": ("resnet", dict(num_layers=50, layout="NHWC",
                                    stem="s2d")),
    "resnet101": ("resnet", dict(num_layers=101)),
    "resnet152": ("resnet", dict(num_layers=152)),
    "inception_bn": ("inception_bn", dict()),
    "inception_bn_nhwc": ("inception_bn", dict(layout="NHWC")),
    "inception_bn_small": ("inception_bn_small", dict(num_classes=10)),
    "inception_bn_small_mirror": ("inception_bn_small",
                                  dict(force_mirroring=True)),
    "googlenet": ("googlenet", dict()),
    "vgg11": ("vgg", dict()),
    "vgg16_bn": ("vgg", dict(num_layers=16, batch_norm=True)),
    "alexnet": ("alexnet", dict()),
    "lenet": ("lenet", dict()),
    "mlp": ("mlp", dict()),
}


def _build(M, name):
    fn, kw = BUILDERS[name]
    with M.sym.NameManager():
        return getattr(M.models, fn)(**kw)


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builder_json_equals_reference(name):
    got, ref = _build(mt, name), _build(mx, name)
    assert got.list_arguments() == ref.list_arguments()
    assert got.list_auxiliary_states() == ref.list_auxiliary_states()
    assert got.tojson() == ref.tojson()


def test_s2d_stem_needs_nhwc():
    with pytest.raises(ValueError, match="NHWC"):
        mt.models.resnet(num_layers=18, stem="s2d")


def _draw(net, shapes, seed):
    """Parameters scaled by 1/sqrt(fan-in), gamma near 1, moving
    statistics near (0, 1): deep nets keep finite, unsaturated
    probabilities."""
    arg_shapes, _, aux_shapes = net.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    args, auxs = {}, {}
    for n, s in zip(net.list_arguments(), arg_shapes):
        if n in shapes:
            continue
        if n.endswith("gamma"):
            v = 1.0 + 0.1 * rng.randn(*s)
        elif n.endswith(("bias", "beta")):
            v = 0.1 * rng.randn(*s)
        else:
            v = rng.randn(*s) / np.sqrt(max(int(np.prod(s[1:])), 1))
        args[n] = v.astype(np.float32)
    for n, s in zip(net.list_auxiliary_states(), aux_shapes):
        v = (0.8 + 0.4 * rng.rand(*s)) if n.endswith("var") else (
            0.1 * rng.randn(*s))
        auxs[n] = v.astype(np.float32)
    return args, auxs


def _predict(M, net, data, args, auxs):
    with M.cpu():
        exe = net.simple_bind(M.cpu(), grad_req="null", data=data.shape)
        exe.copy_params_from({k: M.nd.array(v) for k, v in args.items()},
                             {k: M.nd.array(v) for k, v in auxs.items()},
                             allow_extra_params=True)
        exe.arg_dict["data"][:] = data
        return exe.forward(is_train=False)[0].asnumpy()


FORWARD_CASES = {
    "resnet18_cifar": ("resnet18_cifar", (2, 3, 32, 32)),
    "resnet50_nhwc": ("resnet50_nhwc", (1, 64, 64, 3)),
    "resnet50_s2d": ("resnet50_s2d", (1, 32, 32, 12)),
    "inception_bn_small": ("inception_bn_small", (2, 3, 28, 28)),
    "googlenet": ("googlenet", (1, 3, 64, 64)),
    "vgg16_bn": ("vgg16_bn", (1, 3, 32, 32)),
    "alexnet": ("alexnet", (1, 3, 67, 67)),
    "lenet": ("lenet", (2, 1, 28, 28)),
    "mlp": ("mlp", (4, 20)),
}


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_builder_forward_matches_reference(case):
    name, shape = FORWARD_CASES[case]
    nets = {M: _build(M, name) for M in (mx, mt)}
    args, auxs = _draw(nets[mx], {"data": shape}, seed=1)
    data = np.random.RandomState(2).randn(*shape).astype(np.float32)
    want = _predict(mx, nets[mx], data, args, auxs)
    got = _predict(mt, nets[mt], data, args, auxs)
    assert np.isfinite(want).all() and want.shape == got.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=OUT_TOL)


# -- ResNet-18 through Module ------------------------------------------------
R18 = dict(num_classes=10, num_layers=18, image_shape=(3, 16, 16))
R18_BATCH = 4
R18_SHAPE = (R18_BATCH, 3, 16, 16)
SGD = (("learning_rate", 0.1), ("momentum", 0.9), ("wd", 1e-4))


def _r18(M):
    with M.sym.NameManager():
        return M.models.resnet(**R18)


def _r18_batches(M, n=2):
    rng = np.random.RandomState(3)
    return [M.io.DataBatch(
        [M.nd.array(rng.randn(*R18_SHAPE).astype(np.float32))],
        [M.nd.array(rng.randint(0, 10, R18_BATCH).astype(np.float32))])
        for _ in range(n)]


def _r18_module(M, args, auxs):
    mod = M.mod.Module(_r18(M), context=M.cpu())
    mod.bind([("data", R18_SHAPE)], [("softmax_label", (R18_BATCH,))])
    mod.init_params(arg_params={k: M.nd.array(v) for k, v in args.items()},
                    aux_params={k: M.nd.array(v) for k, v in auxs.items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params=SGD)
    return mod


def _r18_train(M, args, auxs):
    with M.cpu():
        mod = _r18_module(M, args, auxs)
        outs = []
        for db in _r18_batches(M):
            mod.forward(db, is_train=True)
            mod.backward()
            mod.update()
            outs.append(mod.get_outputs()[0].asnumpy())
        arg, aux = mod.get_params()
        return (mod, outs, {k: v.asnumpy() for k, v in arg.items()},
                {k: v.asnumpy() for k, v in aux.items()})


@pytest.fixture(scope="module")
def r18_runs():
    args, auxs = _draw(_r18(mx), {"data": R18_SHAPE}, seed=4)
    return {M: _r18_train(M, args, auxs) for M in (mx, mt)}, auxs


def test_resnet18_module_sgd_steps_match_reference(r18_runs):
    runs, aux0 = r18_runs
    _, want_out, want_arg, want_aux = runs[mx]
    _, got_out, got_arg, got_aux = runs[mt]
    for g, w in zip(got_out, want_out):
        np.testing.assert_allclose(g, w, rtol=0, atol=OUT_TOL)
    assert sorted(got_arg) == sorted(want_arg)
    for k in want_arg:
        np.testing.assert_allclose(got_arg[k], want_arg[k], rtol=0,
                                   atol=PARAM_TOL, err_msg=k)
    assert sorted(got_aux) == sorted(want_aux) == sorted(aux0)
    for k in want_aux:
        np.testing.assert_allclose(got_aux[k], want_aux[k], rtol=0,
                                   atol=PARAM_TOL, err_msg=k)
        # two training forwards moved every moving statistic
        assert np.abs(got_aux[k] - aux0[k]).max() > 1e-3, k


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_resnet18_checkpoint_with_aux_crosses_packages(direction, r18_runs,
                                                      tmp_path):
    runs, _ = r18_runs
    src, dst = (mx, mt) if direction == "ref_to_port" else (mt, mx)
    prefix = str(tmp_path / "r18")
    mod, _, arg, aux = runs[src]
    data = np.random.RandomState(8).randn(*R18_SHAPE).astype(np.float32)
    with src.cpu():
        mod.save_checkpoint(prefix, 2)
        mod.forward(src.io.DataBatch([src.nd.array(data)], None),
                    is_train=False)
        want = mod.get_outputs()[0].asnumpy()
    with dst.cpu():
        _, args2, auxs2 = dst.model.load_checkpoint(prefix, 2)
        assert sorted(auxs2) == sorted(aux)
        for k, v in auxs2.items():
            np.testing.assert_array_equal(v.asnumpy(), aux[k])
        loaded = dst.mod.Module.load(prefix, 2, context=dst.cpu())
        loaded.bind([("data", R18_SHAPE)], [("softmax_label", (R18_BATCH,))],
                    for_training=False)
        loaded.forward(dst.io.DataBatch([dst.nd.array(data)], None),
                       is_train=False)
        got = loaded.get_outputs()[0].asnumpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=OUT_TOL)
