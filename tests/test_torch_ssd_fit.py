"""The port's SSD detector trained by ``Module.fit`` against the
reference's, on the CPU.

examples/train_ssd.py's recipe (``Mixed([relu4_3_scale -> Constant(20),
Xavier])`` from ``random.seed(0)``, SGD 0.004, momentum 0.9, wd 5e-4,
``metric.Loss``) at ``filter_scale=16``, 300 x 300, batch 2, over 4
images for 2 epochs, unshuffled, in both packages' ``Module.fit`` (the
reference's SSD training graph compiled once): the seeded initializers
draw the same parameters, each batch's NLL (over the anchors the targets
keep) is within 1e-5 of the reference's and every parameter after the 4
steps within 1e-6 of the reference's, absolute: the weights are
0.01-0.3, the deep biases have moved from 0 by about 1e-4, and float32
gradients summed in other orders leave them ~1e-7 apart (8e-8 is seen).
"""

import numpy as np

import torch_port_fixtures  # noqa: F401  (puts the repo on sys.path)

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

FS = 16


def _labels(rng, n, m=4, n_classes=20):
    labels = np.full((n, m, 5), -1.0, np.float32)
    for i in range(n):
        for b in range(int(rng.integers(1, m))):
            x1, y1 = rng.uniform(0, 0.6, 2)
            w, h = rng.uniform(0.2, 0.4, 2)
            labels[i, b] = [rng.integers(0, n_classes), x1, y1,
                            min(x1 + w, 1.0), min(y1 + h, 1.0)]
    return labels


def _fit_nll(M, X, labels):
    """examples/train_ssd.py's recipe at filter_scale 16 (batch 2, 4
    images, 2 epochs): the NLL of each batch's training forward over the
    anchors the targets keep, and the parameters after."""
    with M.cpu():
        with M.sym.NameManager():
            net = M.models.ssd(num_classes=20, mode="train", filter_scale=FS)
        mod = M.mod.Module(net, data_names=["data"], label_names=["label"],
                           context=M.cpu())
        nll = []

        def record(param):
            prob, _, lab = (o.asnumpy() for o in mod.get_outputs())
            keep = lab >= 0
            p = np.take_along_axis(prob, np.maximum(lab, 0).astype(int)[
                :, None], 1)[:, 0]
            nll.append(float(-(np.log(p) * keep).sum() / keep.sum()))

        M.random.seed(0)
        init = M.init.Mixed(["relu4_3_scale", ".*"],
                            [M.init.Constant(20.0), M.init.Xavier()])
        mod.fit(M.io.NDArrayIter({"data": X}, {"label": labels}, 2,
                                 shuffle=False),
                num_epoch=2, initializer=init, optimizer="sgd",
                optimizer_params={"learning_rate": 0.004, "momentum": 0.9,
                                  "wd": 5e-4},
                eval_metric=M.metric.Loss(), batch_end_callback=record)
        return nll, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def test_ssd_module_fit_matches_reference():
    rng = np.random.default_rng(4)
    X = (rng.standard_normal((4, 3, 300, 300)) * 0.3).astype(np.float32)
    labels = _labels(rng, 4)
    (want_nll, want), (got_nll, got) = (_fit_nll(mx, X, labels),
                                        _fit_nll(mt, X, labels))
    assert len(got_nll) == len(want_nll) == 4
    np.testing.assert_allclose(got_nll, want_nll, rtol=1e-5)
    assert got_nll[-1] < got_nll[0]
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.abs(got[k] - want[k]).max() <= 1e-6, k
