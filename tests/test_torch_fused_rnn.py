"""Fused LSTM and GRU layers of the PyTorch port against the JAX reference.

The port's plain versions (``fused_lstm_fwd_torch``/``_bwd_torch``,
``fused_gru_fwd_torch``/``_bwd_torch``) and their autograd Functions on
CPU tensors are held against the reference's Pallas kernels run in
interpret mode (``fused_lstm(..., interpret=True)``; ``_fwd(...,
save=True)`` for the residuals), differentiated by ``jax.grad``, as
``tests/test_pallas_lstm.py`` and ``tests/test_pallas_gru.py`` run them.
float32 is held at 1e-5 (outputs, residuals) and 2e-5 (gradients): the
same float32 math summed in another order, as the reference's tests
hold the kernels against the scan.  bfloat16 rounds at the same points
on both sides, after float32 sums taken in another order, so a value at
a rounding boundary can land one bf16 ulp apart and carry into the
later steps: held at 2^-6 of each output's scale.

The Hopper kernels' own cases carry the ``cuda`` marker and skip without
a CUDA device: the kernels are compiled by nvcc for sm_90a at first
launch and have no CPU or interpret mode.  ``python3 chip_smoke.py``
holds them against the plain versions on the card at the language
model's shape.  Both bf16 forward kernels and both bf16 backward kernels
(the tensor-core ones, and the others through ``_variant="simt"``) are
held to the plain versions at chip_smoke.py's four check shapes and the
tensor-core kernels' edges.
"""

import numpy as np
import pytest
import torch

import torch_port_fixtures  # noqa: F401  (puts the repo on sys.path)

from mxnet_tpu_torch.ops import fused_gru as fg
from mxnet_tpu_torch.ops import fused_lstm as fl
from mxnet_tpu_torch.ops import fused_rnn_cuda as frc

F32_OUT, F32_GRAD = 1e-5, 2e-5
BF16_REL = 2.0 ** -6
SHAPES = [(6, 4, 8), (13, 3, 16), (1, 2, 8)]
GATES = {"lstm": 4, "gru": 3}


def _rand(mode, T, N, H, seed=0):
    """(gx, h0, c0, wh, bh) as numpy float32 (c0 None for the GRU), the
    reference tests' scales up to H 16; wider, wh shrinks as 1/sqrt(H),
    which keeps the recurrence's gain (~0.3 sqrt(H)) near 1: a chaotic
    recurrence would amplify float32 rounding to O(1) over T steps."""
    G = GATES[mode]
    rng = np.random.RandomState(seed)
    gx = rng.randn(T, N, G * H).astype(np.float32) * 0.5
    h0 = rng.randn(N, H).astype(np.float32) * 0.5
    c0 = rng.randn(N, H).astype(np.float32) * 0.5
    wh = rng.randn(G * H, H).astype(np.float32) * 0.3 * min(1.0,
                                                            (16 / H) ** 0.5)
    bh = rng.randn(G * H).astype(np.float32) * 0.1
    return gx, h0, (c0 if mode == "lstm" else None), wh, bh


def _args(arrays):
    return [a for a in arrays if a is not None]


def _ref_fn(mode):
    from mxnet_tpu.ops.pallas_gru import fused_gru
    from mxnet_tpu.ops.pallas_lstm import fused_lstm

    if mode == "lstm":
        return lambda *a: fused_lstm(*a, interpret=True)
    return lambda *a: fused_gru(*a, interpret=True)


def _port_fn(mode):
    return fl.fused_lstm if mode == "lstm" else fg.fused_gru


def _loss_jax(mode, outs):
    import jax.numpy as jnp

    f32 = [o.astype(jnp.float32) for o in outs]
    loss = jnp.sum(f32[0] * f32[0]) + jnp.sum(jnp.sin(f32[1]))
    if mode == "lstm":
        loss = loss + 2.0 * jnp.sum(f32[2])
    return loss


def _loss_torch(mode, outs):
    f32 = [o.float() for o in outs]
    loss = (f32[0] * f32[0]).sum() + torch.sin(f32[1]).sum()
    if mode == "lstm":
        loss = loss + 2.0 * f32[2].sum()
    return loss


def _ref_grads(mode, arrays, jdtypes):
    import jax
    import jax.numpy as jnp

    args = [jnp.asarray(a, d) for a, d in zip(_args(arrays), jdtypes)]
    fn = _ref_fn(mode)
    outs = fn(*args)
    grads = jax.grad(lambda *a: _loss_jax(mode, fn(*a)),
                     argnums=tuple(range(len(args))))(*args)
    f32 = lambda a: np.asarray(a.astype(jnp.float32))
    return [f32(o) for o in outs], [f32(g) for g in grads]


def _port_grads(mode, arrays, tdtypes):
    args = [torch.from_numpy(a).to(d).requires_grad_()
            for a, d in zip(_args(arrays), tdtypes)]
    outs = _port_fn(mode)(*args)
    _loss_torch(mode, outs).backward()
    return ([o.detach().float().numpy() for o in outs],
            [a.grad.float().numpy() for a in args])


def _names(mode):
    return (["gx", "h0", "c0", "wh", "bh"] if mode == "lstm"
            else ["gx", "h0", "wh", "bh"])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_forward_and_residuals_match_reference(mode, shape):
    import jax.numpy as jnp
    from mxnet_tpu.ops import pallas_gru, pallas_lstm

    arrays = _rand(mode, *shape)
    gx, h0, c0, wh, bh = arrays
    G = GATES[mode]
    j = [jnp.asarray(a) for a in _args(arrays)]
    j[-1] = j[-1].reshape(1, G * shape[2])
    t = [torch.from_numpy(a) for a in _args(arrays)]
    if mode == "lstm":
        ref = pallas_lstm._fwd(*j, True, True)          # ys hT cT acts cells
        got = fl.fused_lstm_fwd_torch(*t, save=True)
    else:
        ref = pallas_gru._fwd(*j, True, True)           # ys hT acts
        ys, hT, acts = fg.fused_gru_fwd_torch(*t, save=True)
        got = (ys, hT, acts)
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=F32_OUT,
                                   atol=F32_OUT)


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_gradients_of_all_inputs_match_reference(mode):
    """A loss touching ys, hT (and cT) exercises every cotangent path."""
    arrays = _rand(mode, 7, 4, 8, seed=1)
    n = len(_args(arrays))
    r_out, r_grad = _ref_grads(mode, arrays, [np.float32] * n)
    p_out, p_grad = _port_grads(mode, arrays, [torch.float32] * n)
    for a, b in zip(p_out, r_out):
        np.testing.assert_allclose(a, b, rtol=F32_OUT, atol=F32_OUT)
    for name, a, b in zip(_names(mode), p_grad, r_grad):
        np.testing.assert_allclose(a, b, rtol=F32_GRAD, atol=F32_GRAD,
                                   err_msg=name)


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_ys_only_loss_gives_exact_zeros_after_the_cut(mode):
    """hT/cT cotangents are zeros; steps after the one the loss reads get
    exactly zero gradient."""
    import jax
    import jax.numpy as jnp

    arrays = _rand(mode, 5, 2, 8, seed=2)
    rest = _args(arrays)[1:]
    fn = _ref_fn(mode)
    want = np.asarray(jax.grad(lambda g: jnp.sum(fn(g, *map(
        jnp.asarray, rest))[0][2]))(jnp.asarray(arrays[0])))
    gx = torch.from_numpy(arrays[0]).requires_grad_()
    _port_fn(mode)(gx, *map(torch.from_numpy, rest))[0][2].sum().backward()
    got = gx.grad.numpy()
    np.testing.assert_allclose(got, want, rtol=F32_OUT, atol=1e-6)
    assert np.all(got[3:] == 0.0)


@pytest.mark.parametrize("wdtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_bf16_activations_match_reference(mode, wdtype):
    """bf16 gx and states with bf16 or float32 (master) weights: outputs
    and every gradient, within a few bf16 ulps of each one's scale."""
    import jax.numpy as jnp

    arrays = _rand(mode, 6, 3, 8, seed=3)
    names = _names(mode)
    jw = jnp.bfloat16 if wdtype == "bfloat16" else jnp.float32
    tw = getattr(torch, wdtype)
    jd = [jw if n == "wh" else jnp.bfloat16 for n in names]
    td = [tw if n == "wh" else torch.bfloat16 for n in names]
    r_out, r_grad = _ref_grads(mode, arrays, jd)
    p_out, p_grad = _port_grads(mode, arrays, td)
    for name, a, b in zip(["ys", "hT", "cT"], p_out, r_out):
        scale = max(float(np.abs(b).max()), 1e-3)
        assert float(np.abs(a - b).max()) <= BF16_REL * scale, name
    for name, a, b in zip(names, p_grad, r_grad):
        scale = max(float(np.abs(b).max()), 1e-3)
        assert float(np.abs(a - b).max()) <= BF16_REL * scale, name


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_mixed_dtype_bias_gradient_keeps_float32(mode):
    """bf16 weights with a float32 bias: the bias gradient is float32 and
    equals the reference's."""
    import jax
    import jax.numpy as jnp

    arrays = _rand(mode, 4, 2, 8, seed=12)
    args = _args(arrays)
    fn = _ref_fn(mode)
    want = jax.grad(lambda b: jnp.sum(fn(*[jnp.asarray(a, jnp.bfloat16)
                                           for a in args[:-1]], b)[0]
                                      .astype(jnp.float32)))(
        jnp.asarray(args[-1]))
    bh = torch.from_numpy(args[-1]).requires_grad_()
    ys = _port_fn(mode)(*[torch.from_numpy(a).bfloat16()
                          for a in args[:-1]], bh)[0]
    ys.float().sum().backward()
    assert bh.grad.dtype == torch.float32 and want.dtype == jnp.float32
    scale = float(np.abs(np.asarray(want)).max())
    assert float(np.abs(bh.grad.numpy() - np.asarray(want)).max()) \
        <= BF16_REL * scale


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_no_residuals_without_a_gradient(mode, monkeypatch):
    """Eval and ``torch.no_grad`` run the forward with save=False (no
    acts/cells written); a differentiable call saves them."""
    mod = fl if mode == "lstm" else fg
    name = f"fused_{mode}_fwd_torch"
    seen = []
    real = getattr(mod, name)
    # the Function passes ``save`` last, positionally
    monkeypatch.setattr(mod, name,
                        lambda *a: seen.append(a[-1]) or real(*a))
    arrays = [torch.from_numpy(a) for a in _args(_rand(mode, 3, 2, 8))]
    with torch.no_grad():
        _port_fn(mode)(*arrays)
    _port_fn(mode)(*arrays)                 # no input requires grad
    arrays[-1].requires_grad_()
    _port_fn(mode)(*arrays)
    assert seen == [False, False, True]


def test_eligibility_rule_and_knob(monkeypatch):
    """A pure function of (T, N, H, dtype) and MXNET_TPU_FUSED_RNN: '0'
    never takes the kernels, '1' (or force) passes the sequence-length
    gate, and the residency rule holds at every setting."""
    monkeypatch.delenv("MXNET_TPU_FUSED_RNN", raising=False)
    for elig in (fl.fused_lstm_eligible, fg.fused_gru_eligible):
        assert elig(128, 32, 512, dtype=torch.bfloat16)   # the LM's shape
        assert elig(128, 32, 512)
        assert elig(8, 3, 200) and not elig(7, 3, 200)
        assert elig(1, 3, 200, force=True)
        assert not elig(128, 32, 512, dtype=torch.float16)
        assert not elig(128, 32, 4096, force=True)        # does not fit
        assert not elig(128, 8192, 512, force=True)
        monkeypatch.setenv("MXNET_TPU_FUSED_RNN", "1")
        assert elig(1, 3, 200) and not elig(1, 32, 4096)
        monkeypatch.setenv("MXNET_TPU_FUSED_RNN", "0")
        assert not elig(128, 32, 512, force=True)
        monkeypatch.delenv("MXNET_TPU_FUSED_RNN")
    # the residency bound (csrc/fused_rnn.cuh, Limits) at its edges: at
    # H 512 the LSTM takes N up to 508 and the GRU up to 766; at N 1 the
    # LSTM takes H up to 627 and the GRU up to 694 (the cuda tests launch
    # the kernels there)
    assert fl.fused_rnn_fits(32, 512, 4) and fl.fused_rnn_fits(3, 200, 3)
    for G, n_max, h_max in ((4, 508, 627), (3, 766, 694)):
        assert fl.fused_rnn_fits(n_max, 512, G)
        assert not fl.fused_rnn_fits(n_max + 1, 512, G)
        assert fl.fused_rnn_fits(1, h_max, G)
        assert not fl.fused_rnn_fits(1, h_max + 1, G)
    assert not fl.fused_rnn_fits(0, 512, 4) and not fl.fused_rnn_fits(1, 0, 4)


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_cpu_tensors_launch_nothing_and_wrappers_refuse_them(mode):
    before = dict(frc.launches)
    arrays = [torch.from_numpy(a) for a in _args(_rand(mode, 3, 2, 8))]
    _port_fn(mode)(*arrays)
    assert frc.launches == before
    fwd = frc.lstm_fwd_cuda if mode == "lstm" else frc.gru_fwd_cuda
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        fwd(*arrays)


def test_wh_shape_is_checked():
    gx, h0, c0, wh, bh = map(torch.from_numpy, _rand("lstm", 3, 2, 8))
    with pytest.raises(ValueError, match="wh must be"):
        fl.fused_lstm(gx, h0, c0, wh[:, :4], bh)
    gx, h0, _, wh, bh = map(lambda a: None if a is None
                            else torch.from_numpy(a), _rand("gru", 3, 2, 8))
    with pytest.raises(ValueError, match="wh must be"):
        fg.fused_gru(gx, h0, wh.t(), bh)


# -- the Hopper kernels (card only) -----------------------------------------
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the Hopper kernels are compiled by "
                    "nvcc for sm_90a and have no CPU or interpret mode; "
                    "chip_smoke.py runs them on the card")


def _kernel_vs_plain(mode, shape, dtype, seed=0):
    """max |kernel - plain| over every output and gradient, each scaled
    by the plain value's max magnitude, at one shape and dtype."""
    arrays = [None if a is None else torch.from_numpy(a)
              for a in _rand(mode, *shape, seed=seed)]
    rng = np.random.RandomState(seed + 1)
    T, N, H = shape
    cot = [torch.from_numpy(rng.randn(*s).astype(np.float32))
           for s in ((T, N, H), (N, H), (N, H))]
    worst = 0.0
    results = {}
    dtypes = [dtype if n in ("gx", "wh") else torch.float32
              for n in _names(mode)]
    for dev in ("cuda", "cpu"):
        args = [a.to(dev, d).requires_grad_()
                for a, d in zip(_args(arrays), dtypes)]
        outs = _port_fn(mode)(*args)
        grads = torch.autograd.grad(outs, args, [c.to(dev, dtype) for c in
                                                 cot[:len(outs)]])
        results[dev] = [t.detach().float().cpu() for t in outs + grads]
    torch.cuda.synchronize()
    for a, b in zip(results["cuda"], results["cpu"]):
        assert bool(torch.isfinite(a).all())
        worst = max(worst, float((a - b).abs().max())
                    / max(float(b.abs().max()), 1e-6))
    return worst


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(6, 4, 8), (13, 3, 16), (1, 3, 200),
                                   (128, 32, 512), (13, 40, 16), (5, 3, 12)])
@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_cuda_kernels_match_plain_versions_f32(mode, shape):
    """The float32 kernels that the rule picks (the tensor-core pair
    within its limits; past N 32 or at an H not a multiple of 8, the
    float32-FMA pair) against the plain versions; the launches are
    counted under the kernels that ran."""
    _need_cuda()
    _, N, H = shape
    suffix = {"tc32": "_f32", "simt": "_simt"}
    fwd = suffix[frc._fwd_variant(torch.float32, N, H, GATES[mode])]
    bwd = suffix[frc._bwd_variant(torch.float32, N, H, GATES[mode])]
    before = dict(frc.launches)
    assert _kernel_vs_plain(mode, shape, torch.float32) <= 1e-5
    assert {k: frc.launches[k] - before[k] for k in frc.launches
            if frc.launches[k] != before[k]} == {f"{mode}_fwd{fwd}": 1,
                                                 f"{mode}_bwd{bwd}": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(13, 3, 16), (128, 32, 512)])
@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_cuda_kernels_track_plain_versions_bf16(mode, shape):
    """One flipped bf16 rounding of h carries through later steps: a
    loose scale-relative bound (chip_smoke derives the tight one)."""
    _need_cuda()
    assert _kernel_vs_plain(mode, shape, torch.bfloat16) <= 0.05


# chip_smoke.py's RNN check shapes (T, N, H): the LM's, H 200 with N 3,
# T 1, and the reverse direction's flipped input
CHECK_SHAPES = {"main": (128, 32, 512), "h200_n3": (35, 3, 200),
                "t1": (1, 32, 512), "flipped": (35, 32, 512)}
# and the tensor-core kernel's edges: the least H, one m16 tile full, a
# ragged second one, the widest H below 512
EDGE_SHAPES = {"n1_h8": (3, 1, 8), "n16_h264": (3, 16, 264),
               "n17_h512": (3, 17, 512), "n32_h504": (3, 32, 504)}


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["tc", "simt"])
@pytest.mark.parametrize("tag", sorted(CHECK_SHAPES) + sorted(EDGE_SHAPES))
@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_cuda_bf16_backward_kernels_track_plain_versions(mode, tag, variant):
    """Each bf16 backward kernel (the tensor-core one, and the other one
    through ``_variant="simt"``) from the forward kernel's residuals,
    against the plain backward from the same residuals on the card, every
    output under the bf16 bound above; the launch is counted under the
    kernel that ran."""
    _need_cuda()
    T, N, H = {**CHECK_SHAPES, **EDGE_SHAPES}[tag]
    G = GATES[mode]
    gx, h0, c0, wh, bh = (None if a is None else torch.from_numpy(a).cuda()
                          for a in _rand(mode, T, N, H, seed=4))
    if tag == "flipped":
        gx = gx.flip(0).contiguous()
    gx, wh = gx.bfloat16(), wh.bfloat16()
    rng = np.random.RandomState(5)
    dys, dhT, dcT = (torch.from_numpy(rng.randn(*s).astype(np.float32))
                     .cuda().bfloat16() for s in ((T, N, H), (N, H), (N, H)))
    before = dict(frc.launches)
    if mode == "lstm":
        ys, _, _, acts, cells = frc.lstm_fwd_cuda(gx, h0, c0, wh, bh)
        got = frc.lstm_bwd_cuda(acts, cells, ys, h0, c0, wh, dys, dhT, dcT,
                                _variant=variant)
        ref = fl.fused_lstm_bwd_torch(acts, cells, ys, h0, c0, wh, dys, dhT,
                                      dcT)
    else:
        ys, _, acts = frc.gru_fwd_cuda(gx, h0, wh, bh)
        got = frc.gru_bwd_cuda(acts, ys, h0, wh, dys, dhT, _variant=variant)
        ref = fg.fused_gru_bwd_torch(acts, ys, h0, wh, dys, dhT)
    torch.cuda.synchronize()
    counted = f"{mode}_bwd" + ("" if variant == "tc" else "_simt")
    assert {k: frc.launches[k] - before[k] for k in frc.launches
            if "bwd" in k and frc.launches[k] != before[k]} == {counted: 1}
    assert G * H == wh.shape[0]
    for a, b in zip(got, ref):
        if b is None:
            continue
        assert bool(torch.isfinite(a).all())
        scale = max(float(b.float().abs().max()), 1e-6)
        assert float((a.float() - b.float()).abs().max()) <= 0.05 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("save", [True, False])
@pytest.mark.parametrize("variant", ["tc", "simt"])
@pytest.mark.parametrize("tag", sorted(CHECK_SHAPES) + sorted(EDGE_SHAPES))
@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_cuda_bf16_forward_kernels_track_plain_versions(mode, tag, variant,
                                                        save):
    """Each bf16 forward kernel (the tensor-core one, and the other one
    through ``_variant="simt"``) against the plain forward on the same
    inputs on the card, every output under the bf16 bound above; without
    ``save`` no residual is returned; the launch is counted under the
    kernel that ran."""
    _need_cuda()
    T, N, H = {**CHECK_SHAPES, **EDGE_SHAPES}[tag]
    gx, h0, c0, wh, bh = (None if a is None else torch.from_numpy(a).cuda()
                          for a in _rand(mode, T, N, H, seed=6))
    if tag == "flipped":
        gx = gx.flip(0).contiguous()
    gx, wh = gx.bfloat16(), wh.bfloat16()
    before = dict(frc.launches)
    if mode == "lstm":
        got = frc.lstm_fwd_cuda(gx, h0, c0, wh, bh, save=save,
                                _variant=variant)
        ref = fl.fused_lstm_fwd_torch(gx, h0, c0, wh, bh, save=save)
    else:
        got = frc.gru_fwd_cuda(gx, h0, wh, bh, save=save, _variant=variant)
        ref = fg.fused_gru_fwd_torch(gx, h0, wh, bh, save=save)
    torch.cuda.synchronize()
    counted = f"{mode}_fwd" + ("" if variant == "tc" else "_simt")
    assert {k: frc.launches[k] - before[k] for k in frc.launches
            if frc.launches[k] != before[k]} == {counted: 1}
    n_out = 3 if mode == "lstm" else 2          # ys, hT (, cT)
    assert all(r is None for r in got[n_out:]) == (not save)
    for a, b in zip(got, ref):
        if b is None:
            continue
        assert bool(torch.isfinite(a).all())
        scale = max(float(b.float().abs().max()), 1e-6)
        assert float((a.float() - b.float()).abs().max()) <= 0.05 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_cuda_kernels_match_cudnn_f32(mode):
    """An independent oracle: cuDNN's nn.LSTM / nn.GRU (same gate
    orders) on the same Wi, Wh, bi, bh, TF32 off."""
    _need_cuda()
    T, N, I, H = 32, 8, 24, 64
    G = GATES[mode]
    g = torch.Generator().manual_seed(0)
    cell = (torch.nn.LSTM if mode == "lstm" else torch.nn.GRU)(I, H).cuda()
    x = torch.randn(T, N, I, generator=g).cuda().requires_grad_()
    h0 = (torch.randn(1, N, H, generator=g) * 0.5).cuda()
    c0 = (torch.randn(1, N, H, generator=g) * 0.5).cuda()
    ref = cell(x, (h0, c0) if mode == "lstm" else h0)[0]
    (dx_ref,) = torch.autograd.grad(ref.sum(), x)
    gx = x @ cell.weight_ih_l0.t() + cell.bias_ih_l0
    if mode == "lstm":
        ys = fl.fused_lstm(gx, h0[0], c0[0], cell.weight_hh_l0,
                           cell.bias_hh_l0)[0]
    else:
        ys = fg.fused_gru(gx, h0[0], cell.weight_hh_l0, cell.bias_hh_l0)[0]
    (dx,) = torch.autograd.grad(ys.sum(), x)
    assert G * H == cell.weight_hh_l0.shape[0]
    assert float((ys - ref).detach().abs().max()) <= 1e-5
    assert float((dx - dx_ref).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_cuda_kernels_take_every_shape_the_rule_admits(mode):
    """The residency rule bounds the kernels' shared memory from above:
    at its edges (the largest N at H 512 and at H 200, the largest H at
    N 1) both kernels launch and return finite values."""
    _need_cuda()
    G = GATES[mode]
    edges = [(max(n for n in range(1, 4096)
                  if fl.fused_rnn_fits(n, H, G)), H) for H in (512, 200)]
    edges.append((1, max(h for h in range(1, 4096)
                         if fl.fused_rnn_fits(1, h, G))))
    for N, H in edges:
        arrays = [None if a is None else torch.from_numpy(a).cuda()
                  for a in _rand(mode, 2, N, H)]
        gx, h0, c0, wh, bh = arrays
        dys = torch.ones(2, N, H, device="cuda")
        dh = torch.ones(N, H, device="cuda")
        if mode == "lstm":
            ys, _, _, acts, cells = frc.lstm_fwd_cuda(gx, h0, c0, wh, bh)
            outs = frc.lstm_bwd_cuda(acts, cells, ys, h0, c0, wh, dys, dh, dh)
        else:
            ys, _, acts = frc.gru_fwd_cuda(gx, h0, wh, bh)
            outs = frc.gru_bwd_cuda(acts, ys, h0, wh, dys, dh)
        torch.cuda.synchronize()
        assert all(bool(torch.isfinite(o).all()) for o in (ys, *outs))


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    _need_cuda()
    gx, h0, c0, wh, bh = (torch.from_numpy(a).cuda()
                          for a in _rand("lstm", 3, 2, 8))
    with pytest.raises(ValueError, match="non-empty sequence"):
        frc.lstm_fwd_cuda(gx[:0], h0, c0, wh, bh)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        frc.lstm_fwd_cuda(gx.half(), h0, c0, wh, bh)
    with pytest.raises(ValueError, match="wh must be"):
        frc.lstm_fwd_cuda(gx, h0, c0, wh[:, :4], bh)
