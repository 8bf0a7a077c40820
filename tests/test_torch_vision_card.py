"""The vision ops on the card against the CPU, in float32.

Each op of the vision half (``Convolution`` NCHW/NHWC with groups and
dilation, ``Deconvolution``, ``BatchNorm`` with its moving statistics,
``InstanceNorm``, ``Pooling``, ``LRN``, ``UpSampling``, ``ROIPooling``,
``SpatialTransformer``, ``Correlation``) is bound by ``simple_bind`` on
``gpu(0)`` and on ``cpu()`` and fed the same seeded inputs: outputs and
moving statistics within 1e-5 of each one's largest magnitude, every
input gradient within 2e-5 (float32 summed in other orders: cuDNN with
TF32 off against the CPU's kernels).  TF32 is shown off for matmuls and
cuDNN before the comparison: with it on, a convolution keeps ~3 decimal
digits and these bounds would not hold.

The card cases carry the ``cuda`` marker and skip here with a stated
reason; on the card: ``python3 -m pytest -q -m cuda --noconftest
tests/test_torch_vision_card.py``.  This file imports no JAX.

On the CPU: chip_smoke's kernel kinds put cuDNN's convolution and the
pooling kernels in kinds of their own ahead of the matmul keys their
names also hold, and its profile reader attributes each kernel launched
inside a BatchNorm or convolution host range to that range, on a
synthetic trace.
"""

import gzip
import json
import os

import numpy as np
import pytest
import torch

import torch_port_fixtures  # noqa: F401  (puts the repo on sys.path)

import mxnet_tpu_torch as mt

import chip_smoke

OUT_TOL, GRAD_TOL = 1e-5, 2e-5
ROIS = np.array([[0, 1.3, 2.1, 9.7, 7.2], [1, 0.0, 0.0, 15.1, 15.3],
                 [0, 6.2, 4.4, 6.9, 5.1]], np.float32)
LOC = np.array([[0.8, 0.1, 0.05, -0.1, 0.9, -0.05],
                [0.9, -0.1, 0.1, 0.05, 0.85, 0.02]], np.float32)


def _v(name="data"):
    return mt.sym.Variable(name)


CASES = {
    "conv_nchw": (lambda: mt.sym.Convolution(
        _v(), kernel=(3, 3), num_filter=8, stride=(2, 2), pad=(1, 1)),
        {"data": (4, 6, 12, 12)}),
    "conv_nhwc_groups_dilate": (lambda: mt.sym.Convolution(
        _v(), kernel=(3, 3), num_filter=8, num_group=2, dilate=(2, 2),
        pad=(2, 2), no_bias=True, layout="NHWC"), {"data": (4, 10, 10, 6)}),
    "deconv": (lambda: mt.sym.Deconvolution(
        _v(), kernel=(3, 3), num_filter=4, stride=(2, 2), pad=(1, 1),
        adj=(1, 1), num_group=2, no_bias=False), {"data": (2, 4, 6, 6)}),
    "batchnorm": (lambda: mt.sym.BatchNorm(_v(), fix_gamma=False,
                                           momentum=0.8),
                  {"data": (8, 5, 6, 6)}),
    "batchnorm_nhwc_fix_gamma": (lambda: mt.sym.BatchNorm(_v(), axis=-1),
                                 {"data": (8, 6, 6, 5)}),
    "instancenorm": (lambda: mt.sym.InstanceNorm(_v()),
                     {"data": (3, 4, 6, 6)}),
    "pool_max_full_pad": (lambda: mt.sym.Pooling(
        _v(), kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max",
        pooling_convention="full"), {"data": (2, 3, 9, 8)}),
    "pool_avg_nhwc": (lambda: mt.sym.Pooling(
        _v(), kernel=(3, 3), stride=(2, 2), pool_type="avg",
        pooling_convention="full", layout="NHWC"), {"data": (2, 9, 8, 3)}),
    "pool_global_sum": (lambda: mt.sym.Pooling(
        _v(), kernel=(1, 1), pool_type="sum", global_pool=True),
        {"data": (2, 3, 7, 7)}),
    "lrn": (lambda: mt.sym.LRN(_v(), nsize=5, alpha=0.01, knorm=1.5),
            {"data": (2, 7, 5, 5)}),
    "upsampling_multi": (lambda: mt.sym.UpSampling(
        _v("a"), _v("b"), scale=2, sample_type="nearest"),
        {"a": (2, 3, 4, 4), "b": (2, 2, 2, 2)}),
    "upsampling_bilinear": (lambda: mt.sym.UpSampling(
        _v(), scale=2, sample_type="bilinear", num_filter=3),
        {"data": (2, 3, 5, 4)}),
    "roipooling": (lambda: mt.sym.ROIPooling(
        _v(), _v("rois"), pooled_size=(3, 2), spatial_scale=0.5),
        {"data": (2, 3, 8, 8), "rois": ROIS.shape}),
    "spatial_transformer": (lambda: mt.sym.SpatialTransformer(
        _v(), _v("loc"), target_shape=(5, 7)),
        {"data": (2, 3, 6, 8), "loc": LOC.shape}),
    "correlation": (lambda: mt.sym.Correlation(
        _v("data1"), _v("data2"), kernel_size=3, max_displacement=2,
        stride2=2, pad_size=1), {"data1": (2, 3, 8, 8),
                                 "data2": (2, 3, 8, 8)}),
}
FIXED = {"rois": ROIS, "loc": LOC}


def _run(ctx, net, arrays, aux, heads):
    with ctx:
        exe = net.simple_bind(ctx, grad_req="write",
                              **{k: v.shape for k, v in arrays.items()})
        for k, v in arrays.items():
            exe.arg_dict[k][:] = v
        for k, v in aux.items():
            exe.aux_dict[k][:] = v
        outs = [o.asnumpy() for o in exe.forward(is_train=True)]
        exe.backward([mt.nd.array(h, ctx=ctx) for h in heads])
        return (outs, {k: exe.grad_dict[k].asnumpy() for k in arrays},
                {k: exe.aux_dict[k].asnumpy() for k in aux})


def _close(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale, what


def test_tf32_is_off_for_matmuls_and_cudnn():
    """The port keeps float32 float32: importing it turns TF32 off for
    matmuls and cuDNN (``mxnet_tpu_torch/context.py``)."""
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_vision_op_on_the_card_matches_the_cpu(case):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this holds the vision ops on the card "
                    "(cuDNN and CUDA kernels) against the CPU; "
                    "chip_smoke.py's vision_small_check runs them there")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    build, shapes = CASES[case]
    with mt.sym.NameManager():
        net = build()
    arg_shapes, out_shapes, aux_shapes = net.infer_shape(**shapes)
    rng = np.random.RandomState(0)
    arrays = {n: FIXED.get(n, rng.randn(*s).astype(np.float32))
              for n, s in zip(net.list_arguments(), arg_shapes)}
    aux = {n: (rng.rand(*s) + 0.5).astype(np.float32)
           for n, s in zip(net.list_auxiliary_states(), aux_shapes)}
    heads = [rng.randn(*s).astype(np.float32) for s in out_shapes]
    card = _run(mt.gpu(0), net, arrays, aux, heads)
    host = _run(mt.cpu(), net, arrays, aux, heads)
    for i, (g, w) in enumerate(zip(card[0], host[0])):
        _close(g, w, OUT_TOL, f"output {i}")
    for k in arrays:
        _close(card[1][k], host[1][k], GRAD_TOL, f"gradient of {k}")
    for k in aux:
        _close(card[2][k], host[2][k], OUT_TOL, f"aux {k}")


@pytest.mark.parametrize("name,kind", [
    ("sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs", "conv"),
    ("sm80_xmma_wgrad_implicit_gemm_indexed_f32f32", "conv"),
    ("sm80_xmma_dgrad_implicit_gemm_f32f32", "conv"),
    ("void cudnn::winograd_nonfused::winogradWgradData4x4<float, float>",
     "conv"),
    ("void wgrad_alg0_engine<float, 128, 5, 5, 3, 3, 3, false, 512>", "conv"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<float>", "conv"),
    ("void at::native::max_pool_forward_nchw<float, float>", "pool"),
    ("void at::native::avg_pool2d_out_cuda_frame<float, float>", "pool"),
    ("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128", "matmul"),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_64x64_8x5_tn>", "matmul"),
    ("flash_dkv_f32tc_kernel", "flash_dkv"),
    ("void rnn_fwd_f32tc_kernel<4>", "fused_rnn_fwd"),
    ("void at::native::vectorized_elementwise_kernel<4>", "elementwise")])
def test_kernel_kinds_keep_convolutions_out_of_matmul(name, kind):
    assert chip_smoke._kernel_kind(name) == kind


def test_profile_reader_attributes_kernels_to_host_ranges(tmp_path):
    """Kernels launched inside a ``_BNTrain`` or convolution host range
    take its kind whatever their names; a launch outside every range is
    left to the name rules; a launch without its kernel marks the trace
    incomplete."""
    run = tmp_path / "plugins" / "profile" / "run"
    os.makedirs(run)

    def op(name, ts, dur, tid=1):
        return {"ph": "X", "cat": "cpu_op", "name": name, "pid": 1,
                "tid": tid, "ts": ts, "dur": dur}

    def launch(corr, ts, tid=1):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "pid": 1, "tid": tid, "ts": ts, "dur": 1,
                "args": {"correlation": corr}}

    def kernel(corr, name, ts):
        return {"ph": "X", "cat": "kernel", "name": name, "pid": 0,
                "tid": 7, "ts": ts, "dur": 5, "args": {"correlation": corr}}

    events = [op("_BNTrain", 0, 50), launch(1, 10), kernel(1, "reduce_a", 100),
              op("aten::cudnn_convolution", 60, 30), launch(2, 70),
              kernel(2, "sm80_xmma_gemm_cf32cf32", 110),
              op("autograd::engine::evaluate_function: _BNTrainBackward",
                 200, 40, tid=2), launch(3, 210, tid=2),
              kernel(3, "elementwise_b", 300), launch(4, 95),
              kernel(4, "reduce_c", 310)]
    with gzip.open(run / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    kinds, kernels, complete = chip_smoke.range_kinds(
        str(tmp_path), chip_smoke.VISION_RANGES)
    assert kinds == {("reduce_a", 100): "batchnorm",
                     ("sm80_xmma_gemm_cf32cf32", 110): "conv",
                     ("elementwise_b", 300): "batchnorm"}
    assert len(kernels) == 4 and complete
    with gzip.open(run / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events + [launch(5, 96)]}, f)
    assert not chip_smoke.range_kinds(str(tmp_path),
                                      chip_smoke.VISION_RANGES)[2]
