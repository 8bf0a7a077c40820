"""The port's vision Symbol ops against the JAX reference's, on the CPU.

Each graph is built in both packages under fresh NameManagers (the same
arguments, auxiliary states and JSON), bound by ``simple_bind`` on the
CPU and fed the same numpy inputs drawn from a seeded RandomState; a
training forward, then a backward with seeded head gradients.  Outputs
and the gradient of every floating input are compared:

- ``Convolution``: NCHW and NHWC (OIHW weights in both), stride, pad,
  dilation, groups, bias and ``no_bias``;
- ``Deconvolution``: stride, pad, ``adj``, groups, bias;
- ``BatchNorm``: ``fix_gamma`` (gamma's gradient 0), ``axis=-1``,
  ``use_global_stats``, ``momentum``/``eps``; the moving statistics
  after a training forward (the biased one-pass variance and
  ``m * old + (1 - m) * batch``), and an inference forward on them;
- ``InstanceNorm``, ``LRN`` (odd and even ``nsize``);
- ``Pooling``: max/avg/sum, ``valid``/``full``, pads over half the
  kernel, ``global_pool``, NHWC;
- ``UpSampling``: nearest with one input and with two (``concat`` and
  ``sum``), bilinear at scales 2 and 3 (its ``weight`` ignored: gradient
  0);
- ``ROIPooling``, ``SpatialTransformer``, ``Correlation``.

float32 throughout: outputs within 1e-5 and gradients within 2e-5 of
each one's largest magnitude (the same float32 math in other orders;
``tests/test_torch_sequence_ops.py`` states the same bounds).  Inputs are
continuous draws, so no pooling window holds a tie (a tied maximum's
gradient goes to one element, and which one differs between JAX and
torch).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import torch_port_fixtures  # noqa: F401  (puts the repo on sys.path)

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

OUT_TOL, GRAD_TOL = 1e-5, 2e-5


def _close(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


def _run(M, net, arrays, aux, heads, is_train=True):
    ctx = M.cpu()
    with ctx:
        exe = net.simple_bind(ctx, grad_req="write",
                              **{k: v.shape for k, v in arrays.items()})
        for k, v in arrays.items():
            exe.arg_dict[k][:] = v
        for k, v in aux.items():
            exe.aux_dict[k][:] = v
        outs = [o.asnumpy() for o in exe.forward(is_train=is_train)]
        grads = {}
        if is_train:
            exe.backward([M.nd.array(h) for h in heads])
            grads = {n: exe.grad_dict[n].asnumpy() for n in arrays}
        auxs = {n: exe.aux_dict[n].asnumpy()
                for n in net.list_auxiliary_states()}
    return outs, grads, auxs


def _pair(build, shapes, seed=0, scale=None, aux=None, is_train=True,
          arrays=None):
    """``build(M)`` in both packages: the same signature and JSON, then
    outputs, input gradients and auxiliary states after one forward
    (training by default) and backward."""
    nets = {}
    for M in (mx, mt):
        with M.sym.NameManager():
            nets[M] = build(M)
    got_net, ref_net = nets[mt], nets[mx]
    assert got_net.list_arguments() == ref_net.list_arguments()
    assert (got_net.list_auxiliary_states()
            == ref_net.list_auxiliary_states())
    assert got_net.tojson() == ref_net.tojson()
    rng = np.random.RandomState(seed)
    arg_shapes, out_shapes, aux_shapes = ref_net.infer_shape(**shapes)
    assert got_net.infer_shape(**shapes) == (arg_shapes, out_shapes,
                                             aux_shapes)
    arrays = dict(arrays or {})
    for n, s in zip(ref_net.list_arguments(), arg_shapes):
        if n not in arrays:
            arrays[n] = (rng.randn(*s) * (scale or {}).get(n, 1.0)).astype(
                np.float32)
    aux = dict(aux or {})
    for n, s in zip(ref_net.list_auxiliary_states(), aux_shapes):
        if n not in aux:
            aux[n] = (rng.rand(*s) + (0.5 if n.endswith("var") else -0.5)
                      ).astype(np.float32)
    heads = [rng.randn(*s).astype(np.float32) for s in out_shapes]
    ref = _run(mx, ref_net, arrays, aux, heads, is_train)
    got = _run(mt, got_net, arrays, aux, heads, is_train)
    for i, (g, w) in enumerate(zip(got[0], ref[0])):
        _close(g, w, OUT_TOL, f"output {i}")
    for n in ref[1]:
        _close(got[1][n], ref[1][n], GRAD_TOL, f"gradient of {n}")
    for n in ref[2]:
        _close(got[2][n], ref[2][n], OUT_TOL, f"aux {n}")
    return got, ref, arrays, aux


# -- Convolution / Deconvolution ---------------------------------------------
CONV_CASES = {
    "nchw_bias_stride_pad": (dict(kernel=(3, 3), num_filter=4, stride=(2, 2),
                                  pad=(1, 1)), (2, 3, 9, 9)),
    "nchw_groups_dilate": (dict(kernel=(3, 3), num_filter=6, num_group=3,
                                dilate=(2, 2), pad=(2, 1), no_bias=True),
                           (2, 6, 10, 9)),
    "nchw_rect_kernel": (dict(kernel=(1, 5), num_filter=5, stride=(1, 2),
                              pad=(0, 2), workspace=64, cudnn_tune="off",
                              cudnn_off=True), (3, 4, 7, 11)),
    "nhwc_bias_stride": (dict(kernel=(3, 3), num_filter=4, stride=(2, 2),
                              pad=(1, 1), layout="NHWC"), (2, 9, 9, 3)),
    "nhwc_groups_dilate": (dict(kernel=(3, 3), num_filter=4, num_group=2,
                                dilate=(2, 2), no_bias=True, layout="NHWC"),
                           (2, 10, 8, 4)),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_convolution_matches_reference(case):
    kw, shape = CONV_CASES[case]
    _pair(lambda M: M.sym.Convolution(M.sym.Variable("data"), name="conv",
                                      **kw), {"data": shape})


def test_convolution_nhwc_equals_nchw_with_the_same_weights():
    """The OIHW weight serves both layouts: the NHWC output is the NCHW
    output transposed."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 3, 8, 8).astype(np.float32)
    w = rng.randn(5, 3, 3, 3).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    outs = {}
    with mt.cpu():
        for layout, data in (("NCHW", x), ("NHWC", x.transpose(0, 2, 3, 1))):
            net = mt.sym.Convolution(mt.sym.Variable("data"), kernel=(3, 3),
                                     num_filter=5, pad=(1, 1), layout=layout,
                                     name="conv")
            exe = net.bind(mt.cpu(), {"data": mt.nd.array(data),
                                      "conv_weight": mt.nd.array(w),
                                      "conv_bias": mt.nd.array(b)})
            outs[layout] = exe.forward()[0].asnumpy()
    np.testing.assert_allclose(outs["NHWC"].transpose(0, 3, 1, 2),
                               outs["NCHW"], rtol=0, atol=1e-5)


DECONV_CASES = {
    "stride2_pad_adj_groups_bias": (dict(kernel=(3, 3), num_filter=4,
                                         stride=(2, 2), pad=(1, 1),
                                         adj=(1, 1), num_group=2,
                                         no_bias=False), (2, 4, 5, 5)),
    "default_no_bias": (dict(kernel=(4, 4), num_filter=3), (2, 2, 5, 6)),
    "stride3_rect": (dict(kernel=(2, 5), num_filter=2, stride=(3, 2),
                          pad=(0, 1), adj=(2, 0)), (1, 3, 4, 4)),
}


@pytest.mark.parametrize("case", sorted(DECONV_CASES))
def test_deconvolution_matches_reference(case):
    kw, shape = DECONV_CASES[case]
    _pair(lambda M: M.sym.Deconvolution(M.sym.Variable("data"),
                                        name="deconv", **kw),
          {"data": shape})


def test_deconvolution_adj_must_be_under_stride():
    with mt.cpu():
        net = mt.sym.Deconvolution(mt.sym.Variable("data"), kernel=(3, 3),
                                   num_filter=2, stride=(2, 2), adj=(2, 2))
        with pytest.raises(mt.MXNetError, match="adj"):
            net.infer_shape(data=(1, 2, 4, 4))


# -- BatchNorm / InstanceNorm -------------------------------------------------
BN_CASES = {
    "fix_gamma_default": (dict(), (4, 3, 5, 5)),
    "free_gamma_momentum_eps": (dict(fix_gamma=False, momentum=0.8,
                                     eps=1e-5), (4, 3, 5, 5)),
    "nhwc_axis_last": (dict(fix_gamma=False, axis=-1, eps=2e-5),
                       (3, 4, 5, 6)),
    "use_global_stats": (dict(fix_gamma=False, use_global_stats=True),
                         (4, 3, 5, 5)),
    "two_d_input": (dict(fix_gamma=False), (16, 7)),
}


@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_batchnorm_train_matches_reference(case):
    """Outputs, the gradients of data, gamma and beta, and the moving
    statistics after one training forward."""
    kw, shape = BN_CASES[case]
    got, ref, arrays, aux = _pair(
        lambda M: M.sym.BatchNorm(M.sym.Variable("data"), name="bn", **kw),
        {"data": shape}, scale={"data": 2.0})
    if kw.get("fix_gamma", True):
        assert not got[1]["bn_gamma"].any()
    moved = not kw.get("use_global_stats", False)
    for n in ("bn_moving_mean", "bn_moving_var"):
        assert (not np.array_equal(got[2][n], aux[n])) == moved, n


def test_batchnorm_moving_statistics_follow_the_reference_rule():
    """The moving statistics are m * old + (1 - m) * batch with the
    biased variance: held against numpy, and against the opposite
    (torch's) rule, which must miss."""
    m = 0.7
    got, _, arrays, aux = _pair(
        lambda M: M.sym.BatchNorm(M.sym.Variable("data"), momentum=m,
                                  fix_gamma=False, name="bn"),
        {"data": (6, 2, 3, 3)}, seed=5)
    x = arrays["data"].astype(np.float64)
    mean = x.mean(axis=(0, 2, 3))
    var = x.var(axis=(0, 2, 3))
    want_mean = m * aux["bn_moving_mean"] + (1 - m) * mean
    want_var = m * aux["bn_moving_var"] + (1 - m) * var
    np.testing.assert_allclose(got[2]["bn_moving_mean"], want_mean, atol=1e-6)
    np.testing.assert_allclose(got[2]["bn_moving_var"], want_var, atol=1e-6)
    n = x.size / x.shape[1]
    torch_var = (1 - m) * aux["bn_moving_var"] + m * var * n / (n - 1)
    assert np.abs(got[2]["bn_moving_var"] - torch_var).max() > 1e-2


@pytest.mark.parametrize("fix_gamma", [True, False])
def test_batchnorm_inference_uses_the_moving_statistics(fix_gamma):
    got, ref, arrays, aux = _pair(
        lambda M: M.sym.BatchNorm(M.sym.Variable("data"), name="bn",
                                  fix_gamma=fix_gamma),
        {"data": (3, 4, 5, 5)}, seed=2, is_train=False)
    x, g, b = arrays["data"], arrays["bn_gamma"], arrays["bn_beta"]
    g = np.ones_like(g) if fix_gamma else g
    mm, mv = aux["bn_moving_mean"], aux["bn_moving_var"]
    sh = (1, -1, 1, 1)
    want = ((x - mm.reshape(sh)) / np.sqrt(mv.reshape(sh) + 1e-3)
            * g.reshape(sh) + b.reshape(sh))
    np.testing.assert_allclose(got[0][0], want, rtol=0, atol=1e-5)
    for n in aux:
        np.testing.assert_array_equal(got[2][n], aux[n])


def test_instancenorm_matches_reference():
    _pair(lambda M: M.sym.InstanceNorm(M.sym.Variable("data"), eps=1e-4,
                                       name="inorm"),
          {"data": (3, 4, 5, 6)}, scale={"data": 3.0})


@pytest.mark.parametrize("nsize", [5, 4])
def test_lrn_matches_reference(nsize):
    _pair(lambda M: M.sym.LRN(M.sym.Variable("data"), nsize=nsize,
                              alpha=0.01, beta=0.75, knorm=1.5, name="lrn"),
          {"data": (2, 7, 4, 5)}, scale={"data": 2.0})


# -- Pooling -----------------------------------------------------------------
POOL_CASES = {
    "max_valid": dict(kernel=(3, 3), stride=(2, 2), pool_type="max"),
    "max_full_pad": dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                         pool_type="max", pooling_convention="full"),
    "max_pad_over_half_kernel": dict(kernel=(3, 3), stride=(1, 1),
                                     pad=(2, 2), pool_type="max"),
    "avg_full_overhang": dict(kernel=(3, 3), stride=(2, 2),
                              pool_type="avg", pooling_convention="full"),
    "avg_pad": dict(kernel=(3, 2), stride=(1, 2), pad=(1, 1),
                    pool_type="avg"),
    "sum_valid": dict(kernel=(2, 2), stride=(2, 2), pool_type="sum"),
    "sum_full_pad": dict(kernel=(3, 3), stride=(3, 3), pad=(1, 0),
                         pool_type="sum", pooling_convention="full"),
    "global_avg": dict(kernel=(7, 7), pool_type="avg", global_pool=True),
    "global_max": dict(kernel=(1, 1), pool_type="max", global_pool=True),
    "nhwc_max_pad": dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                         pool_type="max", layout="NHWC"),
    "nhwc_avg_full": dict(kernel=(2, 2), stride=(2, 2), pool_type="avg",
                          pooling_convention="full", layout="NHWC"),
    "nhwc_global_sum": dict(kernel=(3, 3), pool_type="sum",
                            global_pool=True, layout="NHWC"),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pooling_matches_reference(case):
    kw = POOL_CASES[case]
    shape = (2, 8, 7, 3) if kw.get("layout") == "NHWC" else (2, 3, 8, 7)
    _pair(lambda M: M.sym.Pooling(M.sym.Variable("data"), name="pool", **kw),
          {"data": shape})


# -- UpSampling --------------------------------------------------------------
def test_upsampling_nearest_matches_reference():
    _pair(lambda M: M.sym.UpSampling(M.sym.Variable("data"), scale=3,
                                     sample_type="nearest", name="up"),
          {"data": (2, 3, 4, 5)})


@pytest.mark.parametrize("mode", ["concat", "sum"])
def test_upsampling_multi_input_matches_reference(mode):
    """Two inputs, each scaled to the first's size times ``scale``."""
    c2 = 3 if mode == "sum" else 2
    _pair(lambda M: M.sym.UpSampling(
        M.sym.Variable("a"), M.sym.Variable("b"), scale=2,
        sample_type="nearest", multi_input_mode=mode, name="up"),
        {"a": (2, 3, 4, 4), "b": (2, c2, 2, 2)})


@pytest.mark.parametrize("scale", [2, 3])
def test_upsampling_bilinear_matches_reference_and_ignores_weight(scale):
    """Bilinear resize as jax.image.resize (edge rows included); the
    weight argument's gradient is 0 in both."""
    got, ref, _, _ = _pair(
        lambda M: M.sym.UpSampling(M.sym.Variable("data"), scale=scale,
                                   sample_type="bilinear", num_filter=3,
                                   name="up"),
        {"data": (2, 3, 4, 5)})
    assert not got[1]["up_weight"].any() and not ref[1]["up_weight"].any()


# -- ROIPooling / SpatialTransformer / Correlation ---------------------------
ROIS = np.array([[0, 1.3, 2.1, 9.7, 7.2], [1, 0.0, 0.0, 15.1, 15.3],
                 [0, 6.2, 4.4, 6.9, 5.1], [1, 3.3, 8.8, 12.6, 11.1]],
                np.float32)


def test_roipooling_matches_reference():
    got, _, _, _ = _pair(
        lambda M: M.sym.ROIPooling(M.sym.Variable("data"),
                                   M.sym.Variable("rois"),
                                   pooled_size=(3, 2), spatial_scale=0.5,
                                   name="roi"),
        {"data": (2, 3, 8, 8), "rois": ROIS.shape}, arrays={"rois": ROIS})
    assert not got[1]["rois"].any()


def test_spatial_transformer_matches_reference():
    rng = np.random.RandomState(11)
    loc = (np.array([0.8, 0.1, 0.05, -0.1, 0.9, -0.05], np.float32)
           + rng.randn(3, 6).astype(np.float32) * 0.05)
    _pair(lambda M: M.sym.SpatialTransformer(
        M.sym.Variable("data"), M.sym.Variable("loc"), target_shape=(5, 7),
        transform_type="affine", sampler_type="bilinear", name="st"),
        {"data": (3, 2, 6, 8), "loc": loc.shape}, arrays={"loc": loc})


@pytest.mark.parametrize("kw", [
    dict(kernel_size=1, max_displacement=2, stride1=1, stride2=1),
    dict(kernel_size=3, max_displacement=2, stride1=2, stride2=2,
         pad_size=2, is_multiply=False)], ids=["multiply", "abs_strided"])
def test_correlation_matches_reference(kw):
    _pair(lambda M: M.sym.Correlation(M.sym.Variable("data1"),
                                      M.sym.Variable("data2"), name="corr",
                                      **kw),
          {"data1": (2, 3, 8, 9), "data2": (2, 3, 8, 9)})


def test_registry_lacks_only_multibox_and_quantized():
    """The op names each package registers on import, read in a fresh
    process (tests in this one may register ops of their own): the same
    set.  The multibox and quantized names, the last ones missing, are
    registered and resolve to the reference's spellings."""
    probe = ("import json, mxnet_tpu as mx, mxnet_tpu_torch as mt; "
             "names = lambda R: sorted({op.name for op in "
             "R._entries.values()}); "
             "print(json.dumps([names(mx.ops.op.OP_REGISTRY), "
             "names(mt.ops.OP_REGISTRY)]))")
    out = subprocess.run([sys.executable, "-c", probe], check=True,
                         capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))),
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    ref, got = map(set, json.loads(out.stdout.strip().splitlines()[-1]))
    assert got == ref
    for name in ("MultiBoxPrior", "MultiBoxTarget", "MultiBoxDetection",
                 "QuantizedConvolution", "QuantizedFullyConnected"):
        assert name in got
        assert mt.ops.OP_REGISTRY.get(name).name == name
