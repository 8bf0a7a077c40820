"""The float32 fused-RNN forward on tensor cores (``tc32``): the host rule
that picks it, its shared memory in closed form, its wrapper, and torch
models of its split-TF32 product, on the CPU; the kernel itself on the
card.

``csrc/fused_rnn_fwd_f32tc.cuh`` (``rnn_fwd_f32tc_kernel<G>``) runs only
on the card.  Here: ``_fwd_variant`` sends float32 to it at every shape
chip_smoke.py checks and maps every geometry the fused path admits to
exactly one kernel; ``fwd_tc32_smem_bytes`` is the kernel's layout in
closed form; the wrapper (its library replaced by a fake: no device is
needed to pick and call a kernel) counts ``{mode}_fwd_f32``, raises on a
refused launch without running another kernel, and a CPU tensor launches
nothing; ``fused_{lstm,gru}_fwd_tf32`` with three TF32 products sits well
inside chip_smoke.py's float32 bound (``RNN_F32_REL`` of the largest
value) against the plain forward in float64, with one TF32 product it
fails that bound on every output, and the three-product model agrees with
the reference's Pallas forward (interpret mode).  The ``cuda``-marked
cases hold the kernel against the plain forward in float32 at
chip_smoke.py's shapes (and the float32 backward from its residuals
against the plain backward), and check that a launch repeats bit for bit;
they skip here (run on the card by ``python3 -m pytest -q -m cuda
--noconftest tests/test_torch_fused_rnn_fwd_f32tc.py``).  Only the
reference comparison imports JAX, inside its test.
"""

import contextlib

import numpy as np
import pytest
import torch

import torch_port_fixtures  # noqa: F401  (puts the repo on sys.path)

import chip_smoke
from mxnet_tpu_torch.ops import fused_gru as fg
from mxnet_tpu_torch.ops import fused_lstm as fl
from mxnet_tpu_torch.ops import fused_rnn_cuda as frc

GATES = {"lstm": 4, "gru": 3}
SMEM_MAX = 232448


@pytest.mark.parametrize("tag", sorted(chip_smoke.RNN_SHAPES))
@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_float32_forward_runs_tc32_at_the_checked_shapes(mode, tag):
    _, N, H = chip_smoke.RNN_SHAPES[tag]
    assert frc._fwd_variant(torch.float32, N, H, GATES[mode]) == "tc32"


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_each_admitted_float32_geometry_has_one_forward_kernel(mode):
    """N in 1..40 and H <= 600: every geometry the fused path admits maps
    in float32 to tc32 exactly where its limits hold (N <= 32, H a
    multiple of 8 from 8 to 512, the layout within 227 KB), to the FMA
    kernel elsewhere, the same answer twice; bfloat16 never to tc32."""
    G = GATES[mode]
    seen = {"tc32": 0, "simt": 0}
    for N in range(1, 41):
        for H in range(1, 601):
            if not fl.fused_rnn_fits(N, H, G):
                continue
            got = frc._fwd_variant(torch.float32, N, H, G)
            assert got == frc._fwd_variant(torch.float32, N, H, G)
            limits = (N <= 32 and H % 8 == 0 and 8 <= H <= 512
                      and frc.fwd_tc32_smem_bytes(N, H) <= SMEM_MAX)
            assert got == ("tc32" if limits else "simt"), (N, H)
            assert frc._fwd_variant(torch.bfloat16, N, H, G) != "tc32"
            seen[got] += 1
    assert seen["tc32"] and seen["simt"]


def _closed_form(N, H):
    """fwd32_geo's layout written out: two halves of the h tile (rows of H
    padded to 32, + 4 floats), the 8 K parts' partial gate sums (rows of
    40 floats), the staged h_t and two mbarriers (16 bytes)."""
    cdiv = lambda a, b: -(-a // b)
    mt = cdiv(N, 16)
    return (2 * 16 * mt * (cdiv(H, 32) * 32 + 4) * 4
            + 8 * 16 * mt * 40 * 4 + N * 8 * 4 + 16)


@pytest.mark.parametrize("N,H,want", [(32, 512, 174096), (3, 200, 49776),
                                      (16, 8, 25616)])
def test_fwd_tc32_shared_memory_in_closed_form(N, H, want):
    assert frc.fwd_tc32_smem_bytes(N, H) == _closed_form(N, H) == want


def test_fwd_tc32_shared_memory_never_binds_within_the_limits():
    worst = max(frc.fwd_tc32_smem_bytes(N, H) for N in range(1, 33)
                for H in range(8, 513, 8))
    assert worst == frc.fwd_tc32_smem_bytes(32, 512) <= SMEM_MAX


class _FakeLib:
    """Stands in for the kernel library: records the entry points called
    and returns ``rc`` from each."""

    def __init__(self, rc):
        self.rc, self.calls = rc, []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append(name)
            return self.rc
        return entry


def _fwd_on_cpu(monkeypatch, mode, rc, variant=None, dtype=torch.float32,
                save=True):
    """The mode's forward wrapper on CPU tensors of a small layer, with
    the library, the checks and the stream replaced: (fake, launches after
    the call, or the raised error)."""
    T, N, H = 4, 3, 8
    G = GATES[mode]
    fake = _FakeLib(rc)
    monkeypatch.setattr(frc, "launches", dict.fromkeys(frc.launches, 0))
    monkeypatch.setattr(frc, "last_fwd_tc_plan", {})
    monkeypatch.setattr(frc, "_lib", lambda: fake)
    monkeypatch.setattr(frc, "_fwd_checks", lambda *a, **k: (T, N, H))
    monkeypatch.setattr(frc, "_launch_stream",
                        lambda device: contextlib.nullcontext(0))
    gx = torch.zeros(T, N, G * H, dtype=dtype)
    h0, wh, bh = torch.zeros(N, H), torch.zeros(G * H, H), torch.zeros(G * H)
    try:
        if mode == "lstm":
            frc.lstm_fwd_cuda(gx, h0, h0, wh, bh, save=save, _variant=variant)
        else:
            frc.gru_fwd_cuda(gx, h0, wh, bh, save=save, _variant=variant)
    except (RuntimeError, ValueError) as err:
        return fake, err
    return fake, dict(frc.launches)


@pytest.mark.parametrize("save", [True, False])
@pytest.mark.parametrize("variant", [None, "tc32"])
@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_wrapper_counts_the_float32_tensor_core_forward(monkeypatch, mode,
                                                        variant, save):
    fake, launched = _fwd_on_cpu(monkeypatch, mode, 0, variant, save=save)
    assert fake.calls == [f"mxtt_{mode}_fwd_f32tc"]
    assert launched == {**dict.fromkeys(launched, 0), f"{mode}_fwd_f32": 1}
    assert frc.last_fwd_tc_plan["hs"] == frc.TC_HS


@pytest.mark.parametrize("rc", [1, 82])
@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_refused_tc32_forward_raises_without_retreat(monkeypatch, mode, rc):
    """A geometry the kernel refuses (1) or clusters the card cannot hold
    at once (82) raise their cudaError; neither the FMA kernel nor the
    plain version runs, and nothing is counted."""
    fake, err = _fwd_on_cpu(monkeypatch, mode, rc)
    assert isinstance(err, RuntimeError)
    assert f"{mode}_fwd_f32 launch failed with cudaError {rc}" in str(err)
    assert fake.calls == [f"mxtt_{mode}_fwd_f32tc"]
    assert frc.launches == dict.fromkeys(frc.launches, 0)


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_tc32_forward_refuses_bfloat16(monkeypatch, mode):
    fake, err = _fwd_on_cpu(monkeypatch, mode, 0, "tc32", torch.bfloat16)
    assert isinstance(err, ValueError) and "takes float32" in str(err)
    assert fake.calls == []


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_cpu_float32_tensors_launch_nothing(mode):
    before = dict(frc.launches)
    T, N, H = 3, 2, 8
    G = GATES[mode]
    gx, h0 = torch.zeros(T, N, G * H), torch.zeros(N, H)
    wh, bh = torch.zeros(G * H, H), torch.zeros(G * H)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        if mode == "lstm":
            frc.lstm_fwd_cuda(gx, h0, h0, wh, bh)
        else:
            frc.gru_fwd_cuda(gx, h0, wh, bh)
    assert frc.launches == before


# -- the models of the kernel's product ---------------------------------------
def _layer(mode, T, N, H, seed=0, device="cpu"):
    """One layer's forward inputs at the model's initial scale
    (chip_smoke.rnn_case's distributions, drawn with numpy), as a dict."""
    rng = np.random.RandomState(seed)
    G = GATES[mode]
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    u = lambda *s: f(rng.uniform(-0.07, 0.07, s))
    gx, h0, c0 = (f(rng.randn(*s) * 0.5)
                  for s in ((T, N, G * H), (N, H), (N, H)))
    wh, bh = u(G * H, H), u(G * H)
    layer = dict(gx=gx, h0=h0, c0=c0, wh=wh, bh=bh)
    if mode == "gru":
        del layer["c0"]
    return layer


def _fwd(mode, layer, fn=None, **kw):
    """The mode's forward over ``layer`` with residuals: the plain one,
    or ``fn`` (``"tf32"`` the model, ``"cuda"`` the kernel); the outputs
    by name."""
    mod = fl if mode == "lstm" else fg
    name = {None: f"fused_{mode}_fwd_torch", "tf32": f"fused_{mode}_fwd_tf32",
            "cuda": f"{mode}_fwd_cuda"}[fn]
    out = getattr(frc if fn == "cuda" else mod, name)(**layer, save=True,
                                                       **kw)
    names = [n for n in chip_smoke.RNN_OUTPUTS["fwd"]
             if mode == "lstm" or n not in ("cT", "cells")]
    return dict(zip(names, [o for o in out if o is not None]))


def _shares(got, ref):
    """Each output's max |got - ref| over chip_smoke.py's float32 bound,
    RNN_F32_REL of the reference's largest magnitude."""
    return {n: float((got[n].double() - ref[n].double()).abs().max())
            / (chip_smoke.RNN_F32_REL * float(ref[n].double().abs().max()))
            for n in ref}


@pytest.mark.parametrize("shape", [chip_smoke.RNN_SHAPES["main"],
                                   chip_smoke.RNN_SHAPES["h200_n3"]])
@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_tf32_forward_models_against_the_float64_forward(mode, shape):
    """Three TF32 products (the kernel's split) stay within half of the
    float32 bound on every output (ys, hT, cT, acts, cells; CPU readings
    at the main shape 0.02-0.07); one TF32 product of rounded operands
    (the planted fault) fails it on every output by more than twice
    (CPU readings at the main shape 11-55)."""
    layer = _layer(mode, *shape)
    ref = _fwd(mode, {k: v.double() for k, v in layer.items()})
    assert all(r.dtype == torch.float64 for r in ref.values())
    split = _shares(_fwd(mode, layer, "tf32", products=3), ref)
    single = _shares(_fwd(mode, layer, "tf32", products=1), ref)
    assert max(split.values()) <= 0.5, split
    assert min(single.values()) > 2.0, single


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_tf32_forward_model_matches_the_reference(mode):
    """The three-product model against the reference's Pallas forward
    (``_fwd`` in interpret mode, with residuals) at a small size, held at
    1e-5 as tests/test_torch_fused_rnn.py holds the plain forward: the
    split's error (~3 2^-22 a product) is far inside it."""
    import jax.numpy as jnp
    from mxnet_tpu.ops import pallas_gru, pallas_lstm

    T, N, H = 9, 3, 16
    layer = _layer(mode, T, N, H, seed=5)
    j = [jnp.asarray(v.numpy()) for v in layer.values()]
    j[-1] = j[-1].reshape(1, GATES[mode] * H)
    ref = (pallas_lstm if mode == "lstm" else pallas_gru)._fwd(*j, True, True)
    got = _fwd(mode, layer, "tf32", products=3)
    assert len(ref) == len(got)
    for r, g in zip(ref, got.values()):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


def test_tf32_forward_model_takes_float32_only():
    layer = _layer("lstm", 2, 2, 8)
    layer["gx"] = layer["gx"].double()
    with pytest.raises(ValueError, match="takes float32"):
        fl.fused_lstm_fwd_tf32(**layer)


def test_plain_forward_keeps_float32_arithmetic_in_float32():
    """The plain forward's float64 path (the models' reference) leaves
    its float32 path as it was: float32 residuals from float32 inputs."""
    layer = _layer("gru", 3, 2, 8)
    out = _fwd("gru", layer)
    assert all(v.dtype == torch.float32 for v in out.values())


# -- the kernel (card only) ---------------------------------------------------
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the float32 tensor-core forward is "
                    "compiled by nvcc for sm_90a and has no CPU or "
                    "interpret mode; chip_smoke.py runs it on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("tag", sorted(chip_smoke.RNN_SHAPES))
@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_cuda_tc32_forward_tracks_the_plain_version(mode, tag):
    """The kernel against the plain forward on the card, every output
    within RNN_F32_REL of its largest magnitude, one ``{mode}_fwd_f32``
    launch counted; then the float32 backward from the kernel's residuals
    against the plain backward from the plain ones, within the same
    bound."""
    _need_cuda()
    T, N, H = chip_smoke.RNN_SHAPES[tag]
    layer = _layer(mode, T, N, H, seed=3, device="cuda")
    if tag == "flipped":
        layer["gx"] = layer["gx"].flip(0)
    before = dict(frc.launches)
    got = _fwd(mode, layer, "cuda")
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in frc.launches.items()
            if v != before[k]} == {f"{mode}_fwd_f32": 1}
    ref = _fwd(mode, layer)
    assert all(bool(torch.isfinite(g).all()) for g in got.values())
    shares = _shares(got, ref)
    assert max(shares.values()) <= 1.0, shares
    rng = torch.Generator(device="cuda").manual_seed(4)
    dys = torch.randn(T, N, H, device="cuda", generator=rng)
    dhT, dcT = (torch.randn(N, H, device="cuda", generator=rng)
                for _ in range(2))
    if mode == "lstm":
        bwd = lambda o: frc.lstm_bwd_cuda(o["acts"], o["cells"], o["ys"],
                                          layer["h0"], layer["c0"],
                                          layer["wh"], dys, dhT, dcT)
        plain = fl.fused_lstm_bwd_torch(ref["acts"], ref["cells"], ref["ys"],
                                        layer["h0"], layer["c0"],
                                        layer["wh"], dys, dhT, dcT)
    else:
        bwd = lambda o: frc.gru_bwd_cuda(o["acts"], o["ys"], layer["h0"],
                                         layer["wh"], dys, dhT)
        plain = fg.fused_gru_bwd_torch(ref["acts"], ref["ys"], layer["h0"],
                                       layer["wh"], dys, dhT)
    names = chip_smoke.RNN_OUTPUTS["bwd"]
    grads = dict(zip(names, bwd(got)))
    shares = _shares(grads, dict(zip(names, plain)))
    assert max(shares.values()) <= 1.0, shares


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_cuda_tc32_forward_repeats_bit_for_bit(mode):
    _need_cuda()
    layer = _layer(mode, *chip_smoke.RNN_SHAPES["main"], seed=4,
                   device="cuda")
    first = _fwd(mode, layer, "cuda")
    again = _fwd(mode, layer, "cuda")
    torch.cuda.synchronize()
    assert all(torch.equal(first[k], again[k]) for k in first)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_cuda_tc32_forward_without_save_writes_no_residuals(mode):
    _need_cuda()
    layer = _layer(mode, *chip_smoke.RNN_SHAPES["h200_n3"], seed=6,
                   device="cuda")
    fn = frc.lstm_fwd_cuda if mode == "lstm" else frc.gru_fwd_cuda
    out = fn(**layer, save=False)
    ref = _fwd(mode, layer, "cuda")
    torch.cuda.synchronize()
    assert out[-1] is None and (mode == "gru" or out[-2] is None)
    assert torch.equal(out[0], ref["ys"]) and torch.equal(out[1], ref["hT"])
