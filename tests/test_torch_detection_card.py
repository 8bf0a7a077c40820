"""The multibox ops, the quantized ops and custom ops on the card against
the CPU, and chip_smoke's detection helpers on the CPU.

On the card (the ``cuda`` marker; skipped here with a stated reason):

- ``MultiBoxPrior``, ``MultiBoxTarget`` and ``MultiBoxDetection`` on
  identical float32 inputs: bit-equal to the CPU, at constructed ties
  too (all-zero predictions, one box under two classes, scores on three
  levels);
- ``QuantizedConvolution`` (NCHW, NHWC) and ``QuantizedFullyConnected``
  calibrated: bit-equal to the CPU, the contraction through
  ``torch._int_mm``; weight-only within 1e-5 of the largest output
  (cuDNN's float32 convolution, TF32 off, against the CPU's); the
  saturated K = 4608 contraction exact where a float32 one is not;
- examples/numpy_ops.py's ``CustomOp`` softmax through ``sym.Custom``
  after two FullyConnected layers (forward and the op's backward): its
  output on the card, within 3e-5 of the CPU run per element (the same
  host code over float32 products summed in other orders), the weight
  gradient within 1e-5 of its largest.

On the CPU: the planted faults chip_smoke.py's ``detect_small_check``
uses (an unstable ranking reversing ties, the first writer winning the
claim) give valid but different answers; the MultiBoxTarget record and
replay returns the recorded outputs; the saturated int8 case is exact
and not representable in float32; ``quantized_taps`` finds each
calibrated layer's input, output and arguments; the synthetic
detection data has the example's layout.

On the card: ``python3 -m pytest -q -m cuda --noconftest
tests/test_torch_detection_card.py``.  This file imports no JAX.
"""

import numpy as np
import pytest
import torch

import torch_port_fixtures  # noqa: F401  (puts the repo on sys.path)

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import multibox
from mxnet_tpu_torch.ops import quantized as q

import chip_smoke

NO_CUDA = ("no CUDA device: this holds the {} on the card against the "
           "CPU; chip_smoke.py's {} runs them there")


def _need_cuda(what, phase):
    if not torch.cuda.is_available():
        pytest.skip(NO_CUDA.format(what, phase))


def _anchors(ctx, shape=(1, 1, 6, 6)):
    with ctx:
        return mt.nd.MultiBoxPrior(mt.nd.zeros(shape, ctx=ctx),
                                   sizes=(0.3, 0.15), ratios=(1.0, 2.0, 0.5),
                                   clip=True)


def _labels(rng, n, m=4, n_cls=5):
    labels = np.full((n, m, 5), -1.0, np.float32)
    for i in range(n):
        for b in range(int(rng.integers(1, m))):
            x1, y1 = rng.uniform(0, 0.6, 2)
            w, h = rng.uniform(0.1, 0.4, 2)
            labels[i, b] = [rng.integers(0, n_cls), x1, y1,
                            min(x1 + w, 1.0), min(y1 + h, 1.0)]
    return labels


def _multibox_cases(ctx):
    rng = np.random.default_rng(0)
    anchor = _anchors(ctx)
    A = anchor.shape[1]
    label = mt.nd.array(_labels(rng, 3), ctx=ctx)
    cls = mt.nd.array(rng.standard_normal((3, 6, A)).astype(np.float32),
                      ctx=ctx)
    dup = np.full((3, 4, 5), -1.0, np.float32)
    dup[:, 0] = [1, 0.31, 0.22, 0.52, 0.47]
    dup[:, 2] = [4, 0.31, 0.22, 0.52, 0.47]
    levels = rng.choice(np.float32([0.0, 0.25, 0.5]), size=(3, 6, A))
    loc = mt.nd.array((rng.standard_normal((3, A * 4)) * 0.5).astype(
        np.float32), ctx=ctx)
    prob = mt.nd.SoftmaxActivation(cls, mode="channel")

    def target(a, lab, c):
        return mt.nd.MultiBoxTarget(a, lab, c, **chip_smoke.SSD_TARGET_KW)

    def detect(p, lc, a):
        return mt.nd.MultiBoxDetection(p, lc, a, nms_topk=60,
                                       nms_threshold=0.45)

    return {"target": (target, [anchor, label, cls]),
            "target_equal_scores": (target, [anchor, label,
                                             mt.nd.zeros(cls.shape,
                                                         ctx=ctx)]),
            "target_claim_collision": (target, [anchor, mt.nd.array(
                dup, ctx=ctx), cls]),
            "detection": (detect, [prob, loc, anchor]),
            "detection_equal_scores": (detect, [mt.nd.array(levels, ctx=ctx),
                                                loc, anchor])}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["target", "target_equal_scores",
                                  "target_claim_collision", "detection",
                                  "detection_equal_scores"])
def test_multibox_on_the_card_equals_the_cpu(case):
    _need_cuda("multibox ops", "detect_small_check")
    fn, inputs = _multibox_cases(mt.gpu(0))[case]
    got, want, same = chip_smoke.card_and_cpu(fn, inputs)
    assert same, case
    host = _anchors(mt.cpu()).asnumpy()
    np.testing.assert_array_equal(_anchors(mt.gpu(0)).asnumpy(), host)


def _q_arrays(rng, data_shape, w_shape):
    return {"data": rng.standard_normal(data_shape).astype(np.float32),
            "q_weight": rng.integers(-127, 128, w_shape).astype(np.int8),
            "q_wscale": rng.uniform(1e-3, 2e-2, w_shape[0]).astype(
                np.float32),
            "q_bias": rng.standard_normal(w_shape[0]).astype(np.float32)}


Q_CASES = {
    "conv_nchw": (lambda a: mt.sym.QuantizedConvolution(
        mt.sym.Variable("data"), kernel=(3, 3), num_filter=24, pad=(1, 1),
        stride=(2, 2), act_scale=a, name="q"), (4, 32, 15, 15),
        (24, 32, 3, 3)),
    "conv_nhwc": (lambda a: mt.sym.QuantizedConvolution(
        mt.sym.Variable("data"), kernel=(3, 3), num_filter=20, pad=(1, 1),
        layout="NHWC", act_scale=a, name="q"), (3, 9, 9, 12), (20, 12, 3, 3)),
    "fc": (lambda a: mt.sym.QuantizedFullyConnected(
        mt.sym.Variable("data"), num_hidden=30, act_scale=a, name="q"),
        (5, 3, 4, 5), (30, 60)),
}


def _q_run(ctx, net, arrays):
    with ctx:
        exe = net.simple_bind(ctx, grad_req="null",
                              type_dict={k: v.dtype for k, v in arrays.items()},
                              **{k: v.shape for k, v in arrays.items()})
        for k, v in arrays.items():
            exe.arg_dict[k][:] = v
        return exe.forward(is_train=False)[0].asnumpy()


@pytest.mark.cuda
@pytest.mark.parametrize("act_scale", [0.0, 0.02],
                         ids=["weight_only", "calibrated"])
@pytest.mark.parametrize("case", sorted(Q_CASES))
def test_quantized_on_the_card_matches_the_cpu(case, act_scale):
    _need_cuda("quantized ops", "quant_check")
    build, dshape, wshape = Q_CASES[case]
    arrays = _q_arrays(np.random.default_rng(1), dshape, wshape)
    with mt.sym.NameManager():
        net = build(act_scale)
    shapes = []
    with chip_smoke.counted_int_mm(shapes):
        got = _q_run(mt.gpu(0), net, arrays)
    want = _q_run(mt.cpu(), net, arrays)
    if act_scale:
        np.testing.assert_array_equal(got, want)
        assert len(shapes) == 1
    else:
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
        assert not shapes


@pytest.mark.cuda
def test_saturated_contraction_is_exact_on_the_card():
    _need_cuda("int8 contraction", "quant_check")
    xq, wq, exact = chip_smoke.saturated_int8_case("cuda")
    assert (q.conv_y32(xq, wq, (1, 1), (0, 0)) == exact).all()
    f32 = torch.nn.functional.conv2d(xq.float(), wq.float())
    assert (f32.double() != exact).all()


@pytest.mark.cuda
def test_custom_op_on_the_card_matches_the_cpu():
    _need_cuda("custom ops", "custom_op_check")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((8, 10)).astype(np.float32)
    y = rng.integers(0, 10, 8).astype(np.float32)
    net = chip_smoke.custom_net("custom")
    res = {}
    for ctx in (mt.gpu(0), mt.cpu()):
        with ctx:
            exe = net.simple_bind(ctx, data=(8, 784), softmax_label=(8,))
            for k, v in exe.arg_dict.items():
                v[:] = np.float32(0.01) * (np.arange(v.size).reshape(
                    v.shape) % 7)
            exe.arg_dict["data"][:] = np.tile(x, (1, 79))[:, :784]
            exe.arg_dict["softmax_label"][:] = y
            out = exe.forward(is_train=True)[0]
            exe.backward()
            assert out._data.device.type == ctx.torch_device().type
            res[ctx.device_type] = (out.asnumpy(),
                                    exe.grad_dict["fc2_weight"].asnumpy())
    # the same host softmax; its inputs, two float32 FullyConnected
    # layers, are summed in other orders on the card (an H100 read
    # 1.16e-5 relative, 1.08e-6 absolute, at most)
    np.testing.assert_allclose(res["gpu"][0], res["cpu"][0], rtol=3e-5,
                               atol=0)
    np.testing.assert_allclose(res["gpu"][1], res["cpu"][1], rtol=0,
                               atol=1e-5 * np.abs(res["cpu"][1]).max())


# -- chip_smoke's helpers, on the CPU ----------------------------------------
def test_unstable_descending_is_a_descending_order_that_reverses_ties():
    score = torch.tensor([[0.5, 0.0, 0.5, 0.2, 0.0, 0.5]])
    good = multibox.descending(score)
    bad = chip_smoke.unstable_descending(score)
    assert good.tolist() == [[0, 2, 5, 3, 1, 4]]
    assert bad.tolist() == [[5, 2, 0, 3, 4, 1]]
    assert torch.equal(score.gather(1, good), score.gather(1, bad))


def test_first_writer_claim_takes_the_lowest_gt():
    best = torch.tensor([[3, 1, 3, 6]])            # gt 3 pads: sentinel 6
    good = multibox.claim_anchors(best, 6)
    bad = chip_smoke.first_writer_claim(best, 6)
    assert good.tolist() == [[-1, 1, -1, 2, -1, -1]]
    assert bad.tolist() == [[-1, 1, -1, 0, -1, -1]]


@pytest.mark.parametrize("name,fn,case", [
    ("descending", chip_smoke.unstable_descending, "target_equal_scores"),
    ("descending", chip_smoke.unstable_descending,
     "detection_equal_scores"),
    ("claim_anchors", chip_smoke.first_writer_claim,
     "target_claim_collision")])
def test_planted_multibox_faults_change_the_answer(name, fn, case):
    """Each planted fault of detect_small_check changes the op's output
    on its constructed tie, and the op is restored after."""
    with mt.cpu():
        f, inputs = _multibox_cases(mt.cpu())[case]
        want = chip_smoke.listed(f(*inputs))
        with chip_smoke.planted_multibox(name, fn):
            bad = chip_smoke.listed(f(*inputs))
        again = chip_smoke.listed(f(*inputs))
    assert not all(np.array_equal(a, b) for a, b in zip(bad, want))
    assert all(np.array_equal(a, b) for a, b in zip(again, want))


def test_multibox_targets_record_and_replay():
    with mt.cpu():
        f, inputs = _multibox_cases(mt.cpu())["target"]
        records = []
        with chip_smoke.multibox_targets(records):
            want = [o.asnumpy() for o in f(*inputs)]
        zeros = [mt.nd.zeros(x.shape) for x in inputs]
        with chip_smoke.multibox_targets(records, replay=True):
            got = [o.asnumpy() for o in f(*zeros)]
    assert len(records) == 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_saturated_int8_case_is_past_float32():
    xq, wq, exact = chip_smoke.saturated_int8_case("cpu")
    assert exact == 127 * 127 * (4608 - 10) and exact > 2 ** 26
    assert float(np.float32(exact)) != exact
    assert (q.conv_y32(xq, wq, (1, 1), (0, 0)) == exact).all()


def test_quantized_taps_find_each_calibrated_layer():
    from mxnet_tpu_torch.contrib.quantization import quantize_model

    with mt.sym.NameManager():
        net = mt.sym.Convolution(mt.sym.Variable("data"), kernel=(3, 3),
                                 num_filter=4, pad=(1, 1), name="c1")
        net = mt.sym.Activation(net, act_type="relu", name="r1")
        net = mt.sym.FullyConnected(net, num_hidden=3, name="f1")
        net = mt.sym.SoftmaxOutput(net, name="softmax")
    rng = np.random.default_rng(3)
    shapes = dict(zip(net.list_arguments(),
                      net.infer_shape(data=(2, 2, 5, 5))[0]))
    with mt.cpu():
        args = {k: mt.nd.array(rng.standard_normal(s).astype(np.float32))
                for k, s in shapes.items() if k not in ("data",
                                                        "softmax_label")}
        X = rng.standard_normal((2, 2, 5, 5)).astype(np.float32)
        qsym, _, _ = quantize_model(net, args, calib_data=[X])
    taps = chip_smoke.quantized_taps(qsym)
    outs = qsym.get_internals().list_outputs()
    assert [(t.name, outs[t.tap], outs[t.out]) for t in taps] == [
        ("c1", "data", "c1_output"), ("f1", "r1_output", "f1_output")]
    assert [t.args for t in taps] == [["c1_weight", "c1_wscale", "c1_bias"],
                                      ["f1_weight", "f1_wscale", "f1_bias"]]
    assert all(t.params.act_scale > 0 for t in taps)


def test_synthetic_det_follows_the_example():
    X, labels = chip_smoke.synthetic_det(chip_smoke.SSD_SMALL, 5, seed=0)
    assert X.shape == (5, 3, 300, 300) and X.dtype == np.float32
    assert labels.shape == (5, 4, 5)
    valid = labels[..., 0] >= 0
    assert valid[:, 0].all() and not valid[:, 3].any()
    box = labels[valid]
    assert ((box[:, 3] > box[:, 1]) & (box[:, 4] > box[:, 2])).all()
    assert (box[:, 1:] <= 1.0).all() and (box[:, 0] < 20).all()
