"""The port's quantized ops and ``contrib.quantization`` against the
reference's, on the CPU.

Ops: ``QuantizedFullyConnected`` and ``QuantizedConvolution`` (NCHW and
NHWC, stride, pad, a 1-tuple kernel, bias and ``no_bias``) built in both
packages (the same JSON) and fed the same int8 weights, float32 scales,
biases and activations drawn from ``numpy.random.default_rng``:

- calibrated (``act_scale > 0``): bit-equal.  The int8 contraction is
  exact int32 in both, and the rescale and bias add round as one fused
  multiply-add in both;
- weight-only: within 1e-5 of the largest output (a float32 product of
  the dequantized weights, summed in other orders).

``quantize_model`` on the cases of ``tests/test_quantization.py``
(weight-only and calibrated MLPs, a grouped convolution and an excluded
layer passing through, a bare-string ``exclude``, a multi-output
calibration tap, NHWC with a ragged final calibration batch, an RNN
state output whose name collides with a variable's, and the checkpoint
round trip): the rewritten JSON byte-equal to the reference's and every
int8 weight and scale bit-equal.  Calibration runs each package's own
float32 graph; its inputs are drawn on a dyadic grid (multiples of 1/4
and 1/16, sums far below 2^24), so every activation is exact in any
summation order and the act_scales, printed with ``repr``, agree to the
last digit.  The RNN case's activations pass through ``tanh`` and
``sigmoid``: its act_scales are held to 1e-6 and the rest of its JSON
byte-equal.  The predict API and the CLI tool of that file are not
ported (ROADMAP §A19).
"""

import json

import numpy as np
import pytest

import torch_port_fixtures  # noqa: F401  (puts the repo on sys.path)

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.contrib import quantization as ref_q
from mxnet_tpu_torch.contrib import quantization as port_q

WEIGHT_ONLY_REL = 1e-5


def _bind_run(M, net, arrays):
    with M.cpu():
        exe = net.simple_bind(M.cpu(), grad_req="null",
                              type_dict={k: v.dtype for k, v in arrays.items()},
                              **{k: v.shape for k, v in arrays.items()})
        for k, v in arrays.items():
            exe.arg_dict[k][:] = v
        return exe.forward(is_train=False)[0].asnumpy()


def _op_pair(build, arrays):
    outs = []
    for M in (mx, mt):
        with M.sym.NameManager():
            net = build(M)
        outs.append((net.tojson(), _bind_run(M, net, arrays)))
    (ref_json, want), (got_json, got) = outs
    assert got_json == ref_json
    assert got.dtype == want.dtype and got.shape == want.shape
    return got, want


def _q_inputs(rng, data_shape, w_shape, bias):
    arrays = {"data": rng.standard_normal(data_shape).astype(np.float32),
              "q_weight": rng.integers(-127, 128, w_shape).astype(np.int8),
              "q_wscale": rng.uniform(1e-3, 2e-2,
                                      w_shape[0]).astype(np.float32)}
    if bias:
        arrays["q_bias"] = rng.standard_normal(w_shape[0]).astype(np.float32)
    return arrays


def _check(got, want, act_scale):
    if act_scale > 0:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= (WEIGHT_ONLY_REL
                                            * np.abs(want).max())


@pytest.mark.parametrize("act_scale", [0.0, 0.0123], ids=["weight_only",
                                                          "calibrated"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
def test_quantized_fc_matches_reference(act_scale, bias):
    rng = np.random.default_rng(0)
    arrays = _q_inputs(rng, (6, 3, 4, 5), (7, 60), bias)
    got, want = _op_pair(lambda M: M.sym.QuantizedFullyConnected(
        M.sym.Variable("data"), num_hidden=7, no_bias=not bias,
        act_scale=act_scale, name="q"), arrays)
    _check(got, want, act_scale)


CONV_CASES = {
    "nchw_stride_pad": (dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1)),
                        (3, 5, 11, 9), "NCHW"),
    "nchw_1x1": (dict(kernel=(1, 1)), (2, 16, 6, 6), "NCHW"),
    "nhwc_1tuple_kernel": (dict(kernel=(3,), pad=(1, 1)), (3, 8, 7, 6),
                           "NHWC"),
    "nhwc_rect_stride": (dict(kernel=(3, 2), stride=(1, 2), pad=(2, 0)),
                         (2, 9, 8, 4), "NHWC"),
}


@pytest.mark.parametrize("act_scale", [0.0, 0.031], ids=["weight_only",
                                                         "calibrated"])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_quantized_conv_matches_reference(case, act_scale):
    kw, shape, layout = CONV_CASES[case]
    bias = case != "nchw_1x1"
    c = shape[3] if layout == "NHWC" else shape[1]
    k = kw["kernel"] * 2 if len(kw["kernel"]) == 1 else kw["kernel"]
    rng = np.random.default_rng(1)
    arrays = _q_inputs(rng, shape, (10, c) + tuple(k), bias)
    got, want = _op_pair(lambda M: M.sym.QuantizedConvolution(
        M.sym.Variable("data"), num_filter=10, no_bias=not bias,
        layout=layout, act_scale=act_scale, name="q", **kw), arrays)
    _check(got, want, act_scale)


def test_calibrated_contraction_is_exact_at_saturation():
    """+-127 activations and weights at K = 4608 (ResNet-50's 3x3x512):
    the int32 sum is 4608 * 127^2 = 74,322,432, past float32's 2^24; the
    quantized conv's y32 is that integer exactly, where a float32 sum of
    the same products (in order) is not."""
    from mxnet_tpu_torch.ops.quantized import conv_y32
    import torch

    rng = np.random.default_rng(2)
    xq = torch.from_numpy(np.where(rng.random((1, 512, 3, 3)) < 0.999, 127,
                                   -127).astype(np.int8))
    wq = torch.full((8, 512, 3, 3), 127, dtype=torch.int8)
    y32 = conv_y32(xq, wq, (1, 1), (0, 0))
    want = (xq.long() * 127).sum().item()
    assert y32.dtype == torch.int32 and (y32 == want).all()
    assert want > 2 ** 24
    prods = (xq.long() * 127).flatten().numpy().astype(np.float32)
    assert np.cumsum(prods, dtype=np.float32)[-1] != want


# -- quantize_model ----------------------------------------------------------
def _dyadic(rng, shape, denom, hi):
    return (rng.integers(-hi, hi + 1, shape) / denom).astype(np.float32)


def _args(net, shapes, rng, data_names=("data", "softmax_label")):
    arg_shapes = net.infer_shape(**shapes)[0]
    return {n: _dyadic(rng, s, 16, 16)
            for n, s in zip(net.list_arguments(), arg_shapes)
            if n not in data_names}


def _mlp(M):
    net = M.sym.FullyConnected(M.sym.Variable("data"), num_hidden=32,
                               name="fc1")
    net = M.sym.Activation(net, act_type="relu")
    net = M.sym.FullyConnected(net, num_hidden=2, name="fc2")
    return M.sym.SoftmaxOutput(net, name="softmax")


def _gconv(M):
    data = M.sym.Variable("data")
    net = M.sym.Convolution(data, kernel=(3, 3), num_filter=4, num_group=2,
                            pad=(1, 1), name="gconv")
    net = M.sym.FullyConnected(M.sym.Flatten(net), num_hidden=3,
                               name="fc_keep")
    net = M.sym.FullyConnected(net, num_hidden=3, name="fc_q")
    return M.sym.SoftmaxOutput(net, name="softmax")


def _nhwc(M):
    net = M.sym.Convolution(M.sym.Variable("data"), kernel=(3,),
                            num_filter=4, pad=(1, 1), layout="NHWC",
                            name="cq")
    net = M.sym.FullyConnected(M.sym.Flatten(net), num_hidden=3, name="fq")
    return M.sym.SoftmaxOutput(net, name="softmax")


def _slice(M):
    parts = M.sym.SliceChannel(M.sym.Variable("data"), num_outputs=2,
                               axis=1, name="slice")
    net = M.sym.FullyConnected(parts[1], num_hidden=3, name="fcm")
    return M.sym.SoftmaxOutput(net, name="softmax")


def _rnn(M):
    rnn = M.sym.RNN(M.sym.Variable("data"), state_size=8, num_layers=1,
                    mode="lstm", state_outputs=True, name="rnn")
    net = M.sym.FullyConnected(rnn[1], num_hidden=3, name="fcs")
    return M.sym.SoftmaxOutput(M.sym.Reshape(net, shape=(-1, 3)),
                               name="softmax")


# name -> (build function, data shape, calibration slices or None, kwargs)
QM_CASES = {
    "mlp_weight_only": (_mlp, (64, 20), None, {}),
    "mlp_calibrated": (_mlp, (64, 20), [(0, 32), (32, 64)], {}),
    "exclude_and_grouped": (_gconv, (2, 4, 6, 6), None,
                            dict(exclude=("fc_keep",))),
    "exclude_and_grouped_calibrated": (_gconv, (2, 4, 6, 6), [(0, 2)],
                                       dict(exclude=("fc_keep",))),
    "string_exclude": (_slice, (8, 4), [(0, 8)], dict(exclude="fcm")),
    "multi_output_tap": (_slice, (8, 4), [(0, 8)], {}),
    "nhwc_ragged": (_nhwc, (48, 8, 8, 2), [(0, 32), (32, 48)], {}),
    "nhwc_weight_only": (_nhwc, (48, 8, 8, 2), None, {}),
    "rnn_state_tap": (_rnn, (5, 2, 4), [(0, 5)], {}),
}


def _quantize(M, q, case, num_calib_batches=5):
    build, shape, calib, kw = QM_CASES[case]
    with M.sym.NameManager():
        net = build(M)
    rng = np.random.default_rng(sorted(QM_CASES).index(case))
    args = _args(net, {"data": shape}, rng)
    X = _dyadic(rng, shape, 4, 8)
    batches = None if calib is None else [X[a:b] for a, b in calib]
    with M.cpu():
        nd_args = {k: M.nd.array(v) for k, v in args.items()}
        qsym, qargs, qaux = q.quantize_model(
            net, nd_args, {}, calib_data=batches,
            num_calib_batches=num_calib_batches, **kw)
    return qsym, {k: v.asnumpy() for k, v in qargs.items()}, qaux, X


def _act_scales(conf):
    return {n["name"]: float(n["param"]["act_scale"]) for n in conf["nodes"]
            if "act_scale" in n.get("param", {})}


@pytest.mark.parametrize("case", sorted(QM_CASES))
def test_quantize_model_matches_reference(case):
    ref_sym, ref_args, _, _ = _quantize(mx, ref_q, case)
    got_sym, got_args, got_aux, _ = _quantize(mt, port_q, case)
    got_conf, ref_conf = json.loads(got_sym.tojson()), json.loads(
        ref_sym.tojson())
    if QM_CASES[case][2] is not None and case != "string_exclude":
        assert _act_scales(got_conf)
    if case == "rnn_state_tap":
        got_s, ref_s = _act_scales(got_conf), _act_scales(ref_conf)
        assert sorted(got_s) == sorted(ref_s) == ["fcs"]
        for k in ref_s:
            assert abs(got_s[k] - ref_s[k]) <= 1e-6 * ref_s[k]
        for conf in (got_conf, ref_conf):
            for n in conf["nodes"]:
                n.get("param", {}).pop("act_scale", None)
        assert got_conf == ref_conf
    else:
        assert got_sym.tojson() == ref_sym.tojson()
    assert got_sym.list_arguments() == ref_sym.list_arguments()
    assert sorted(got_args) == sorted(ref_args) and got_aux == {}
    for k in ref_args:
        assert got_args[k].dtype == ref_args[k].dtype, k
        np.testing.assert_array_equal(got_args[k], ref_args[k], err_msg=k)
    ops = {n["name"]: n["op"] for n in got_conf["nodes"]}
    if QM_CASES[case][0] is _gconv:
        assert ops["gconv"] == "Convolution"
        assert ops["fc_keep"] == "FullyConnected"
        assert ops["fc_q"] == "QuantizedFullyConnected"
    if case == "string_exclude":
        assert ops["fcm"] == "FullyConnected"


@pytest.mark.parametrize("case", ["mlp_calibrated", "nhwc_ragged"])
def test_quantized_graph_runs_like_reference(case):
    """The rewritten graphs run in both packages on the same qargs: the
    probabilities within 1e-5 (the softmax's exp differs by ulps)."""
    ref_sym, qargs, _, X = _quantize(mx, ref_q, case)
    got_sym, _, _, _ = _quantize(mt, port_q, case)
    arrays = {**qargs, "data": X,
              "softmax_label": np.zeros(X.shape[0], np.float32)}
    want = _bind_run(mx, ref_sym, arrays)
    got = _bind_run(mt, got_sym, arrays)
    assert np.abs(got - want).max() <= 1e-5


def test_quantized_checkpoint_round_trip(tmp_path):
    """int8 parameters survive the two-artifact checkpoint; the port
    loads the reference's artifacts and its own alike."""
    qsym, qargs, _, X = _quantize(mt, port_q, "mlp_calibrated")
    ref_sym, ref_args, _, _ = _quantize(mx, ref_q, "mlp_calibrated")
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "ref")
    with mt.cpu():
        qsym.save(ours + "-symbol.json")
        mt.nd.save(ours + "-0000.params",
                   {"arg:" + k: mt.nd.array(v, dtype=v.dtype)
                    for k, v in qargs.items()})
    ref_sym.save(theirs + "-symbol.json")
    mx.nd.save(theirs + "-0000.params",
               {"arg:" + k: mx.nd.array(v, dtype=v.dtype)
                for k, v in ref_args.items()})
    feed = {"data": X, "softmax_label": np.zeros(X.shape[0], np.float32)}
    outs = []
    for prefix in (ours, theirs):
        with mt.cpu():
            sym = mt.sym.load(prefix + "-symbol.json")
            loaded = mt.nd.load(prefix + "-0000.params")
            args = {k[4:]: v.asnumpy() for k, v in loaded.items()}
        assert args["fc1_weight"].dtype == np.int8
        outs.append(_bind_run(mt, sym, {**args, **feed}))
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(
        outs[0], _bind_run(mt, qsym, {**qargs, **feed}))


def test_quantize_weight_matches_reference():
    rng = np.random.default_rng(9)
    w = rng.standard_normal((8, 3, 3, 3)).astype(np.float32)
    w[2] = 0.0
    (gq, gs), (rq, rs) = port_q.quantize_weight(w), ref_q.quantize_weight(w)
    np.testing.assert_array_equal(gq, rq)
    np.testing.assert_array_equal(gs, rs)
    assert gq.dtype == np.int8 and gs[2] == 1.0


def test_calibration_binds_on_the_current_context():
    """Calibration binds on the current default context: under
    ``with mt.cpu():`` the CPU; outside it the card (``gpu(0)``), which
    raises where CUDA is absent."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the refusal is what is tested here")
    with mt.sym.NameManager():
        net = _mlp(mt)
    rng = np.random.default_rng(3)
    with mt.cpu():
        args = {k: mt.nd.array(v) for k, v in _args(
            net, {"data": (4, 20)}, rng).items()}
    X = _dyadic(rng, (4, 20), 4, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_q.quantize_model(net, args, calib_data=[X])
