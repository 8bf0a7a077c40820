"""The port's SSD detector (``models.ssd``) against the reference's, on
the CPU.

- ``get_symbol`` gives the reference's JSON byte for byte in
  ``mode="train"`` and ``mode="det"`` (both built under fresh
  NameManagers), at the reference's width and at ``filter_scale=16``.
- The ``det`` graph (300 x 300, batch 2, ``filter_scale=16``) from the
  same weights, in float64 in both packages: every row's class id and
  score order exact, the values within 1e-12 of the largest, and the
  rows cast to float32 bit-equal.
- The ``train`` graph at the same size in float64 in both packages (the
  reference's graph compiled once for the module): the three outputs
  (``cls_prob``, ``loc_loss``, ``cls_label``) and the gradient of every
  parameter after a backward with the loss heads' default head
  gradients, each within 1e-9 of its largest magnitude.  float64 keeps
  float32 drift out: every ReLU takes the same branch and every match
  the same decision, so the comparison checks the graph's ops
  (``Pooling(pooling_convention="full")``, ``fc6``'s dilation,
  ``L2Normalization(mode="channel")``, the multibox ops,
  ``SoftmaxOutput(multi_output, use_ignore, normalization="valid")``,
  ``smooth_l1``, ``MakeLoss``) on the SSD graph itself.
"""

import json

import numpy as np
import pytest

import torch_port_fixtures  # noqa: F401  (puts the repo on sys.path)

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

SHAPE = (2, 3, 300, 300)
FS = 16
N_CLASSES = 3
TRAIN_REL = 1e-9


def _ssd(M, mode, **kw):
    with M.sym.NameManager():
        return M.models.ssd(mode=mode, **kw)


@pytest.mark.parametrize("mode", ["train", "det"])
@pytest.mark.parametrize("kw", [dict(), dict(num_classes=N_CLASSES,
                                             filter_scale=FS, nms_topk=50)],
                         ids=["reference_width", "fs16"])
def test_ssd_json_equals_reference(mode, kw):
    got, ref = _ssd(mt, mode, **kw), _ssd(mx, mode, **kw)
    assert got.list_arguments() == ref.list_arguments()
    assert got.tojson() == ref.tojson()
    ops = {n["op"] for n in json.loads(got.tojson())["nodes"]}
    assert ("MultiBoxDetection" in ops) == (mode == "det")
    assert ("MultiBoxTarget" in ops) == (mode == "train")


def _params(net, shapes, seed):
    """float64 parameters: He-scaled weights, small biases, the L2-norm
    scale at 20 (the reference's initial value)."""
    arg_shapes, _, _ = net.infer_shape(**shapes)
    rng = np.random.default_rng(seed)
    out = {}
    for n, s in zip(net.list_arguments(), arg_shapes):
        if n in shapes:
            continue
        if n == "relu4_3_scale":
            out[n] = np.full(s, 20.0)
        elif n.endswith("weight"):
            out[n] = rng.standard_normal(s) * np.sqrt(2.0 / np.prod(s[1:]))
        else:
            out[n] = rng.standard_normal(s) * 0.01
    return out


def _labels(rng, n=SHAPE[0], m=4):
    labels = np.full((n, m, 5), -1.0)
    for i in range(n):
        for b in range(int(rng.integers(1, m))):
            x1, y1 = rng.uniform(0, 0.6, 2)
            w, h = rng.uniform(0.2, 0.4, 2)
            labels[i, b] = [rng.integers(0, N_CLASSES), x1, y1,
                            min(x1 + w, 1.0), min(y1 + h, 1.0)]
    return labels


def _bind(M, net, arrays, grad_req):
    ctx = M.cpu()
    with ctx:
        exe = net.simple_bind(ctx, grad_req=grad_req,
                              type_dict={k: np.float64 for k in arrays},
                              **{k: v.shape for k, v in arrays.items()
                                 if k in ("data", "label")})
        for k, v in arrays.items():
            exe.arg_dict[k][:] = v
    return exe


def test_ssd_det_rows_match_reference_in_float64():
    nets = {M: _ssd(M, "det", num_classes=N_CLASSES, filter_scale=FS)
            for M in (mx, mt)}
    rng = np.random.default_rng(0)
    arrays = _params(nets[mx], {"data": SHAPE}, seed=1)
    arrays["data"] = rng.standard_normal(SHAPE) * 0.3
    rows = {}
    for M, net in nets.items():
        with M.cpu():
            rows[M] = _bind(M, net, arrays, "null").forward(
                is_train=False)[0].asnumpy()
    got, want = rows[mt], rows[mx]
    assert got.dtype == want.dtype == np.float64
    assert got.shape == want.shape == (SHAPE[0], 8028, 6)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    assert (np.argsort(-got[..., 1], 1, kind="stable")
            == np.argsort(-want[..., 1], 1, kind="stable")).all()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    np.testing.assert_array_equal(got.astype(np.float32),
                                  want.astype(np.float32))
    assert (got[..., 0] >= 0).sum() > 10


@pytest.fixture(scope="module")
def train_runs():
    nets = {M: _ssd(M, "train", num_classes=N_CLASSES, filter_scale=FS)
            for M in (mx, mt)}
    rng = np.random.default_rng(2)
    shapes = {"data": SHAPE, "label": (SHAPE[0], 4, 5)}
    arrays = _params(nets[mx], shapes, seed=3)
    arrays["data"] = rng.standard_normal(SHAPE) * 0.3
    arrays["label"] = _labels(rng)
    runs = {}
    for M, net in nets.items():
        with M.cpu():
            exe = _bind(M, net, arrays, "write")
            outs = [o.asnumpy() for o in exe.forward(is_train=True)]
            exe.backward()
            grads = {k: exe.grad_dict[k].asnumpy() for k in arrays
                     if k not in ("data", "label")}
        runs[M] = (outs, grads)
    return runs


def _close(got, want, what):
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-300)
    assert np.abs(got - want).max() <= TRAIN_REL * scale, what


def test_ssd_train_outputs_match_reference_in_float64(train_runs):
    (got, _), (want, _) = train_runs[mt], train_runs[mx]
    for i, name in enumerate(("cls_prob", "loc_loss", "cls_label")):
        _close(got[i], want[i], name)
    np.testing.assert_array_equal(got[2], want[2])      # the cls targets
    assert (got[2] > 0).any() and (got[2] == 0).any() and (got[2] == -1).any()


def test_ssd_train_gradients_match_reference_in_float64(train_runs):
    (_, got), (_, want) = train_runs[mt], train_runs[mx]
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], f"gradient of {k}")
    assert np.abs(got["conv1_1_weight"]).max() > 0
    assert np.abs(got["relu4_3_scale"]).max() > 0
