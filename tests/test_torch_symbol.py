"""The port's Symbol (``mxnet_tpu_torch.symbol``) against the reference's.

Graphs are built the same way in both packages, each under a fresh
``NameManager`` so auto-generated names count from zero in both, and
held equal: arguments, outputs, auxiliary states, attributes, inferred
shapes and types, and the JSON text byte for byte.  ``gpt_symbol``
equals the reference's ``gpt()`` for the GPT-2-style and llama-style
variants of ``torch_port_fixtures`` and for fused_qkv, loss="ce",
dropout and remat.  JSON written by either package loads in the other,
binds, and runs forward and backward equal to the reference's executor
within 2e-6 (float32 in another order).
"""

import copy
import json
import pickle

import numpy as np
import pytest

import torch_port_fixtures as fx
from torch_port_fixtures import (  # noqa: F401
    collect_engines_after_module)  # (autouse)

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

TOL = 2e-6


def _in_both(build):
    """``build(M)`` in each package under a fresh NameManager."""
    out = []
    for M in (mx, mt):
        with M.sym.NameManager():
            out.append(build(M))
    return out


def _mlp(M):
    data = M.sym.Variable("data")
    net = M.sym.FullyConnected(data, name="fc1", num_hidden=10)
    net = M.sym.Activation(net, act_type="relu")
    net = M.sym.FullyConnected(net, name="fc2", num_hidden=5)
    return M.sym.SoftmaxOutput(net, name="softmax")


def _compose(M):
    data = M.sym.Variable("data")
    net1 = M.sym.FullyConnected(data, name="fc1", num_hidden=10)
    net1 = M.sym.FullyConnected(net1, name="fc2", num_hidden=100)
    net2 = M.sym.FullyConnected(M.sym.Variable("data2"), name="fc3",
                                num_hidden=10)
    net2 = M.sym.Activation(net2, act_type="relu")
    net2 = M.sym.FullyConnected(net2, name="fc4", num_hidden=20)
    return net2(data2=net1, name="composed")


def _arith(M):
    a, b = M.sym.Variable("a"), M.sym.Variable("b")
    return 2 * a + b / a - 1 + M.sym.pow(a, 2) - M.sym.maximum(b, 1.5)


def _multi(M):
    data = M.sym.Variable("data")
    parts = M.sym.SliceChannel(data, num_outputs=3, axis=1, name="sl")
    return M.sym.Group([parts[1], M.sym.Concat(parts[0], parts[2], dim=1),
                        M.sym.ElementWiseSum(parts[0], parts[1])])


def _aux(M):
    bn = M.sym.BatchNorm(M.sym.Variable("data"), name="bn")
    kl = M.sym.IdentityAttachKLSparseReg(bn, name="kl")
    return M.sym.Convolution(kl, kernel=(3, 3), num_filter=4, name="conv")


def _attrs(M):
    with M.AttrScope(ctx_group="g1", lr_mult="2"):
        data = M.sym.Variable("data", lr_mult=0.5)
        fc = M.sym.FullyConnected(data, name="fc", num_hidden=2,
                                  attr={"wd_mult": "0.1"})
    with M.sym.Prefix("block1_"):
        fc = M.sym.FullyConnected(fc, num_hidden=4)
    return M.sym.LinearRegressionOutput(M.sym.Dropout(fc, p=0.25))


def _ops(M):
    x = M.sym.Variable("x", shape=(4, 6))
    y = M.sym.Reshape(x, shape=(-1, 3, 2))
    y = M.sym.SwapAxis(y, dim1=1, dim2=2)
    y = M.sym.slice_axis(y, axis=2, begin=1, end=3)
    y = M.sym.broadcast_plus(y, M.sym.Variable("b", shape=(1, 2, 1)))
    y = M.sym.LayerNorm(M.sym.Flatten(y), name="ln")
    y = M.sym.LeakyReLU(y, act_type="leaky", slope=0.1)
    y = M.sym.SoftmaxActivation(M.sym.gelu(y) * M.sym.silu(y))
    z = M.sym.Embedding(M.sym.Variable("ids"), input_dim=7, output_dim=4,
                        name="emb")
    return M.sym.Group([y, M.sym.RMSNorm(z, name="rms"),
                        M.sym.sum(z, axis=(1,), keepdims=True),
                        M.sym.BlockGrad(z), M.sym.MakeLoss(M.sym.mean(z))])


GRAPHS = {"mlp": _mlp, "compose": _compose, "arith": _arith,
          "multi": _multi, "aux": _aux, "attrs": _attrs, "ops": _ops}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graph_matches_reference(name):
    ref, got = _in_both(GRAPHS[name])
    assert got.list_arguments() == ref.list_arguments()
    assert got.list_outputs() == ref.list_outputs()
    assert got.list_auxiliary_states() == ref.list_auxiliary_states()
    assert got.attr_dict() == ref.attr_dict()
    assert got.list_attr(recursive=True) == ref.list_attr(recursive=True)
    assert got.tojson() == ref.tojson()
    assert got.debug_str() == ref.debug_str()
    internals = got.get_internals()
    assert internals.list_outputs() == ref.get_internals().list_outputs()


SHAPES = {"mlp": dict(data=(4, 7)), "compose": dict(data=(3, 5)),
          "arith": dict(a=(3,), b=(3,)), "multi": dict(data=(2, 6, 4)),
          "aux": dict(data=(2, 3, 8, 8)),
          "attrs": dict(data=(5, 3)), "ops": dict(ids=(5, 3))}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_infer_shape_and_type_match_reference(name):
    ref, got = _in_both(GRAPHS[name])
    assert got.infer_shape(**SHAPES[name]) == ref.infer_shape(**SHAPES[name])
    assert (got.infer_shape_partial(**SHAPES[name])
            == ref.infer_shape_partial(**SHAPES[name]))
    r_types = ref.infer_type(**{k: "float32" for k in SHAPES[name]})
    p_types = got.infer_type(**{k: "float32" for k in SHAPES[name]})
    assert [[str(t) for t in ts] for ts in p_types] == \
        [[str(t) for t in ts] for ts in r_types]


GPT_CASES = {
    "gpt2": dict(fx.VARIANTS["gpt2"]),
    "llama": dict(fx.VARIANTS["llama"]),
    "gpt2_fused_ce": dict(fx.VARIANTS["gpt2"], fused_qkv=True, loss="ce"),
    "llama_fused_bshd": dict(fx.VARIANTS["llama"], fused_qkv=True,
                             attn_layout="bshd", attn_window=8),
    "gpt2_dropout_remat": dict(fx.VARIANTS["gpt2"], dropout=0.1,
                               remat=True),
}


@pytest.mark.parametrize("case", sorted(GPT_CASES))
def test_gpt_symbol_equals_reference_gpt(case):
    kw = GPT_CASES[case]
    ref, got = _in_both(
        lambda M: (mx.models.gpt if M is mx else mt.models.gpt_symbol)(
            fx.VOCAB, 16, **kw))
    assert got.tojson() == ref.tojson()
    assert got.list_arguments() == ref.list_arguments()
    shapes = dict(data=(2, 16), softmax_label=(2, 16))
    assert got.infer_shape(**shapes) == ref.infer_shape(**shapes)
    assert got.list_attr() == ref.list_attr()


def _bind_run(M, net, shapes, values, ctx, grad_req="write"):
    exe = net.simple_bind(ctx, grad_req=grad_req, **shapes)
    for k, v in values.items():
        exe.arg_dict[k][:] = v
    outs = [o.asnumpy() for o in exe.forward(is_train=True)]
    exe.backward()
    grads = {k: g.asnumpy() for k, g in exe.grad_dict.items()}
    return outs, grads


def _values(net, shapes, seed, ints=()):
    arg_shapes, _, _ = net.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    vals = {}
    for name, shp in zip(net.list_arguments(), arg_shapes):
        if name in ints:
            vals[name] = rng.randint(0, ints[name], shp).astype(np.float32)
        else:
            vals[name] = (rng.randn(*shp) * 0.3).astype(np.float32)
    return vals


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_json_crosses_packages_and_binds(direction):
    """A graph written by one package loads in the other, binds, and its
    forward and backward equal the reference executor's."""
    src, dst = (mx, mt) if direction == "ref_to_port" else (mt, mx)
    with src.sym.NameManager():
        net = (mx.models.gpt if src is mx else mt.models.gpt_symbol)(
            fx.VOCAB, 16, **fx.VARIANTS["llama"])
    js = net.tojson()
    loaded = dst.sym.load_json(js)
    assert loaded.tojson() == js
    ref_net = net if src is mx else loaded
    port_net = loaded if src is mx else net
    shapes = dict(data=(2, 16), softmax_label=(2, 16))
    vals = _values(ref_net, shapes, 5,
                   ints={"data": fx.VOCAB, "softmax_label": fx.VOCAB})
    r_out, r_g = _bind_run(mx, ref_net, shapes, vals, mx.cpu())
    p_out, p_g = _bind_run(mt, port_net, shapes, vals, mt.cpu())
    np.testing.assert_allclose(p_out[0], r_out[0], rtol=0, atol=TOL)
    assert set(p_g) == set(r_g)
    for k in r_g:
        scale = max(float(np.abs(r_g[k]).max()), 1.0)
        np.testing.assert_allclose(p_g[k], r_g[k], rtol=0, atol=TOL * scale)


def test_save_load_files(tmp_path):
    ref, got = _in_both(_mlp)
    got.save(str(tmp_path / "p.json"))
    ref.save(str(tmp_path / "r.json"))
    assert (tmp_path / "p.json").read_text() == (tmp_path / "r.json").read_text()
    assert mt.sym.load(str(tmp_path / "r.json")).tojson() == ref.tojson()
    assert json.loads(got.tojson())["attrs"] == {"mxnet_tpu_version": 1}


def test_symbol_grad_matches_reference():
    def build(M):
        fc = M.sym.FullyConnected(M.sym.Variable("data"), name="fc",
                                  num_hidden=3)
        return M.sym.LinearRegressionOutput(fc, name="lro")

    ref, got = _in_both(build)
    shapes = dict(data=(4, 5), fc_weight=(3, 5), fc_bias=(3,),
                  lro_label=(4, 3))
    vals = _values(ref, shapes, 0)
    outs = []
    for M, net, ctx in ((mx, ref, mx.cpu()), (mt, got, mt.cpu())):
        g = net.grad(["fc_weight", "data"])
        assert g.list_arguments() == net.list_arguments()
        exe = g.simple_bind(ctx, grad_req="null", **shapes)
        for k, v in vals.items():
            exe.arg_dict[k][:] = v
        outs.append([o.asnumpy() for o in exe.forward(is_train=True)])
    for a, b in zip(*outs):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
    with pytest.raises(mt.MXNetError, match="not an argument"):
        got.grad(["nope"])
    with pytest.raises(mt.MXNetError, match="process-local"):
        got.grad(["data"]).tojson()


def test_pickle_deepcopy_and_attr_scope():
    _, got = _in_both(_attrs)
    for clone in (pickle.loads(pickle.dumps(got)), copy.deepcopy(got)):
        assert clone.list_arguments() == got.list_arguments()
        assert clone.tojson() == got.tojson()
    with mt.AttrScope(ctx_group="dev1"):
        a = mt.sym.Variable("a")
    assert a.attr("ctx_group") == "dev1"
    assert mt.sym.Variable("b").attr("ctx_group") is None
    opt = mt.optimizer.create("sgd", param_idx2name={0: "fc_weight"},
                              sym=got, learning_rate=0.05)
    assert pickle.loads(pickle.dumps(opt)).lr == 0.05
    assert mt.attribute.AttrScope is mt.AttrScope


def test_unported_ops_raise_naming_a15b():
    """The vision ops build, infer and serialize like the reference's
    and raise, naming A15b, when run."""
    ref, got = _in_both(_aux)
    assert got.infer_shape(data=(2, 3, 8, 8)) == ref.infer_shape(
        data=(2, 3, 8, 8))
    exe = got.simple_bind(mt.cpu(), data=(2, 3, 8, 8))
    with pytest.raises(NotImplementedError, match="A15b"):
        exe.forward()
    for name in ("Pooling", "LRN", "UpSampling", "Deconvolution",
                 "InstanceNorm", "CTCLoss"):
        assert name.lower() in mt.ops.OP_REGISTRY
    with pytest.raises(NotImplementedError, match="A15b"):
        mt.model.FeedForward(got)
