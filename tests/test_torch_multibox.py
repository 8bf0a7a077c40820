"""The port's multibox ops against the JAX reference's, on the CPU.

``MultiBoxPrior``, ``MultiBoxTarget`` and ``MultiBoxDetection`` are built
in both packages under fresh NameManagers (the same JSON), bound by
``simple_bind`` on the CPU and fed the same float32 inputs drawn from
``numpy.random.default_rng``; a training forward, then a backward with
head gradients.

Exact (bit for bit): anchors, ``loc_mask``, ``cls_target``, and every
detection row's class id, score and order, the tie and collision cases
included (first index on an argmax tie, a stable ranking of equal
scores, the higher gt index winning a shared best anchor).  The values
computed through ``log`` and ``exp`` (``loc_target``, the decoded boxes)
are held to 4 float32 ulps of ``max(|value|, 1)`` (``LOC_ULPS``; boxes
are normalized coordinates, and a corner near 0 is a difference of terms
near 1): the reference's compiled CPU code contracts multiply-adds into
FMAs and evaluates float32 ``log``/``exp`` with its own polynomials,
which differ from a correctly rounded result by an ulp in about 10-15 %
of elements, while the port rounds ``log``/``exp`` once from float64 so
that the CPU and the card agree bit for bit.  Every input gradient is
exactly zero.
"""

import numpy as np
import pytest

import torch_port_fixtures  # noqa: F401  (puts the repo on sys.path)

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

LOC_ULPS = 4


def _run(M, net, arrays, heads):
    ctx = M.cpu()
    with ctx:
        exe = net.simple_bind(ctx, grad_req="write",
                              **{k: v.shape for k, v in arrays.items()})
        for k, v in arrays.items():
            exe.arg_dict[k][:] = v
        outs = [o.asnumpy() for o in exe.forward(is_train=True)]
        exe.backward([M.nd.array(h) for h in heads])
        grads = {n: exe.grad_dict[n].asnumpy() for n in arrays}
    return outs, grads


def _pair(build, arrays, seed=0):
    """``build(M)`` in both packages: the same JSON, then the outputs and
    every input's gradient after a forward and a backward."""
    nets = {}
    for M in (mx, mt):
        with M.sym.NameManager():
            nets[M] = build(M)
    assert nets[mt].tojson() == nets[mx].tojson()
    shapes = {k: v.shape for k, v in arrays.items()}
    _, out_shapes, _ = nets[mx].infer_shape(**shapes)
    assert nets[mt].infer_shape(**shapes)[1] == out_shapes
    rng = np.random.default_rng(seed + 100)
    heads = [rng.standard_normal(s).astype(np.float32) for s in out_shapes]
    ref = _run(mx, nets[mx], arrays, heads)
    got = _run(mt, nets[mt], arrays, heads)
    for n in arrays:
        assert not got[1][n].any(), f"gradient of {n}"
        assert not ref[1][n].any(), f"reference gradient of {n}"
    return got[0], ref[0]


def _exact(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


def _ulps(got, want, what, ulps=LOC_ULPS):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    bound = ulps * np.spacing(np.maximum(np.abs(want), 1).astype(np.float32))
    err = np.abs(got.astype(np.float64) - want)
    assert (err <= bound).all(), (what, float((err / bound).max()))


# -- MultiBoxPrior -----------------------------------------------------------
PRIOR_CASES = {
    "ssd_layer": (dict(sizes=(0.2, 0.272), ratios=(1.0, 2.0, 0.5, 3.0,
                                                   1.0 / 3), clip=True),
                  (1, 3, 19, 19)),
    "unclipped_rect": (dict(sizes=(0.9, 0.5, 0.3), ratios=(1.0, 2.0)),
                       (2, 1, 5, 7)),
    "steps_offsets": (dict(sizes=(0.4,), ratios=(0.5, 1.0, 2.0),
                           steps=(0.25, 0.125), offsets=(0.3, 0.7)),
                      (1, 2, 4, 8)),
    "default": ({}, (1, 1, 3, 3)),
}


@pytest.mark.parametrize("case", sorted(PRIOR_CASES))
def test_multibox_prior_matches_reference(case):
    kw, shape = PRIOR_CASES[case]
    rng = np.random.default_rng(1)
    data = rng.standard_normal(shape).astype(np.float32)
    got, want = _pair(lambda M: M.sym.MultiBoxPrior(
        M.sym.Variable("data"), name="anchors", **kw), {"data": data})
    _exact(got[0], want[0], "anchors")


def test_contrib_aliases_are_the_same_ops():
    for name in ("MultiBoxPrior", "MultiBoxTarget", "MultiBoxDetection"):
        assert (mt.ops.OP_REGISTRY.get(f"_contrib_{name}")
                is mt.ops.OP_REGISTRY.get(name))
        assert hasattr(mt.sym, f"_contrib_{name.lower()}")


# -- MultiBoxTarget ----------------------------------------------------------
def _anchors(shape=(1, 1, 6, 6), sizes=(0.3, 0.15), ratios=(1.0, 2.0, 0.5)):
    """Anchors as the reference's MultiBoxPrior makes them."""
    with mx.sym.NameManager():
        s = mx.sym.MultiBoxPrior(mx.sym.Variable("data"), sizes=sizes,
                                 ratios=ratios, clip=True)
    exe = s.simple_bind(mx.cpu(), grad_req="null", data=shape)
    return exe.forward(is_train=False)[0].asnumpy()


def _labels(rng, n, m, n_classes, min_valid=1):
    labels = np.full((n, m, 5), -1.0, np.float32)
    for i in range(n):
        for b in range(int(rng.integers(min_valid, m + 1))):
            x1, y1 = rng.uniform(0, 0.6, 2)
            w, h = rng.uniform(0.1, 0.4, 2)
            labels[i, b] = [rng.integers(0, n_classes), x1, y1,
                            min(x1 + w, 1.0), min(y1 + h, 1.0)]
    return labels


def _target(arrays, **kw):
    return _pair(lambda M: M.sym.MultiBoxTarget(
        M.sym.Variable("anchor"), M.sym.Variable("label"),
        M.sym.Variable("cls_pred"), name="mbt", **kw), arrays)


def _check_target(got, want):
    _ulps(got[0], want[0], "loc_target")
    _exact(got[1], want[1], "loc_mask")
    _exact(got[2], want[2], "cls_target")
    # the loc targets sit exactly where the mask is
    assert ((got[0] != 0) <= (got[1] != 0)).all()


TARGET_CASES = {
    "mining": dict(overlap_threshold=0.5, negative_mining_ratio=3.0),
    "mining_min_neg": dict(overlap_threshold=0.4, negative_mining_ratio=2.0,
                           minimum_negative_samples=7, ignore_label=-2.0),
    "no_mining": dict(overlap_threshold=0.3),
    "variances": dict(variances=(0.2, 0.1, 0.3, 0.25),
                      negative_mining_ratio=1.5),
}


@pytest.mark.parametrize("case", sorted(TARGET_CASES))
def test_multibox_target_matches_reference(case):
    rng = np.random.default_rng(2)
    anchor = _anchors()
    A = anchor.shape[1]
    arrays = {"anchor": anchor, "label": _labels(rng, 3, 4, 5),
              "cls_pred": rng.standard_normal((3, 6, A)).astype(np.float32)}
    got, want = _target(arrays, **TARGET_CASES[case])
    _check_target(got, want)
    assert got[1].any() and (got[2] > 0).any()


def test_multibox_target_two_gts_claim_one_anchor():
    """Rows 0 and 2 hold the same box with other classes: both claim the
    same best anchor, and the higher gt index (row 2) wins, as the
    reference's scatter (last writer) does on the CPU.  Row 1 and the
    fourth row pad (class -1) and route to the dropped sentinel."""
    rng = np.random.default_rng(3)
    anchor = _anchors()
    A = anchor.shape[1]
    label = np.full((2, 4, 5), -1.0, np.float32)
    label[:, 0] = [1, 0.31, 0.22, 0.52, 0.47]
    label[:, 2] = [4, 0.31, 0.22, 0.52, 0.47]
    label[1, 3] = [0, 0.7, 0.7, 0.95, 0.9]
    arrays = {"anchor": anchor, "label": label,
              "cls_pred": rng.standard_normal((2, 6, A)).astype(np.float32)}
    # a threshold no IoU reaches: only the bipartite claims match
    got, want = _target(arrays, overlap_threshold=1.5)
    _check_target(got, want)
    assert (got[2][0] > 0).sum() == 1
    assert got[2][0].max() == 5.0          # class 4 (row 2) + 1
    assert sorted(got[2][1][got[2][1] > 0]) == [1.0, 5.0]


def test_multibox_target_mining_at_equal_scores():
    """Every anchor's background score ties (all-zero predictions): the
    kept negatives are the first unmatched anchors in anchor order, the
    stable ranking's choice."""
    rng = np.random.default_rng(4)
    anchor = _anchors()
    A = anchor.shape[1]
    arrays = {"anchor": anchor, "label": _labels(rng, 2, 3, 4),
              "cls_pred": np.zeros((2, 5, A), np.float32)}
    got, want = _target(arrays, negative_mining_ratio=3.0)
    _check_target(got, want)
    for i in range(2):
        cls_t, pos = got[2][i], got[1][i].reshape(A, 4)[:, 0] > 0
        kept = np.flatnonzero((cls_t == 0) & ~pos)
        n_neg = int(3.0 * pos.sum())
        assert kept.tolist() == np.flatnonzero(~pos)[:n_neg].tolist()


def test_multibox_target_all_padding_and_zero_iou_ties():
    """An image with no valid gt: nothing matches, every anchor's argmax
    over all -1 IoUs is gt 0 and it is masked; with mining 0 negatives
    are kept (0 positives), so every anchor reads ignore_label."""
    rng = np.random.default_rng(5)
    anchor = _anchors()
    A = anchor.shape[1]
    label = _labels(rng, 2, 3, 4)
    label[1] = -1.0
    arrays = {"anchor": anchor, "label": label,
              "cls_pred": rng.standard_normal((2, 5, A)).astype(np.float32)}
    got, want = _target(arrays, negative_mining_ratio=3.0)
    _check_target(got, want)
    assert not got[1][1].any() and (got[2][1] == -1).all()


# -- MultiBoxDetection -------------------------------------------------------
def _det_inputs(rng, n, n_cls, anchor, tie_levels=None):
    A = anchor.shape[1]
    if tie_levels is None:
        logits = rng.standard_normal((n, n_cls + 1, A)) * 2.0
        e = np.exp(logits - logits.max(1, keepdims=True))
        prob = (e / e.sum(1, keepdims=True)).astype(np.float32)
    else:
        # a few probability levels: equal scores everywhere
        prob = rng.choice(np.asarray(tie_levels, np.float32),
                          size=(n, n_cls + 1, A))
    loc = (rng.standard_normal((n, A * 4)) * 0.5).astype(np.float32)
    return {"cls_prob": prob, "loc_pred": loc, "anchor": anchor}


def _detect(arrays, **kw):
    return _pair(lambda M: M.sym.MultiBoxDetection(
        M.sym.Variable("cls_prob"), M.sym.Variable("loc_pred"),
        M.sym.Variable("anchor"), name="det", **kw), arrays)


def _check_rows(got, want):
    g, w = got[0], want[0]
    assert g.dtype == np.float32 and g.shape == w.shape
    _exact(g[..., 0], w[..., 0], "class ids")
    _exact(g[..., 1], w[..., 1], "scores (their order)")
    _ulps(g[..., 2:], w[..., 2:], "boxes")


DET_CASES = {
    "defaults_topk": dict(nms_topk=40),
    "background_2": dict(background_id=2, nms_topk=60, threshold=0.05),
    "force_suppress": dict(force_suppress=True, nms_threshold=0.3,
                           nms_topk=50),
    "no_clip_all_rows": dict(clip=False, threshold=0.2),
    "topk_10": dict(nms_topk=10, nms_threshold=0.45),
}


@pytest.mark.parametrize("case", sorted(DET_CASES))
def test_multibox_detection_matches_reference(case):
    rng = np.random.default_rng(6)
    arrays = _det_inputs(rng, 2, 4, _anchors())
    got, want = _detect(arrays, **DET_CASES[case])
    _check_rows(got, want)
    kept = got[0][..., 0] >= 0
    assert kept.any()
    if "nms_topk" in DET_CASES[case]:
        # nothing past the top nms_topk rows survives
        assert not kept[:, DET_CASES[case]["nms_topk"]:].any()


@pytest.mark.parametrize("force", [False, True])
def test_multibox_detection_equal_scores_keep_anchor_order(force):
    """Scores drawn from three levels (0 included, below the threshold):
    the order is a stable sort, so equal scores keep anchor order, and
    NMS suppresses by that order."""
    rng = np.random.default_rng(7)
    arrays = _det_inputs(rng, 2, 3, _anchors(), tie_levels=(0.0, 0.25, 0.5))
    got, want = _detect(arrays, nms_topk=80, force_suppress=force,
                        threshold=0.1)
    _check_rows(got, want)
    scores = got[0][..., 1]
    assert (np.diff(scores, axis=1) <= 0).all()
