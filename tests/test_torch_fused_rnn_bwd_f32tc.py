"""The float32 fused-RNN backward on tensor cores (``tc32``): the host rule
that picks it, its shared memory in closed form, its wrapper, and torch
models of its split-TF32 products, on the CPU; the kernel itself on the
card.

``csrc/fused_rnn_bwd_f32tc.cuh`` (``rnn_bwd_f32tc_kernel<G>``) runs only
on the card.  Here: ``_bwd_variant`` sends float32 to it at every shape
chip_smoke.py checks and maps every geometry the fused path admits to
exactly one kernel; ``tc32_smem_bytes`` is the kernel's layout in closed
form; the wrapper (its library replaced by a fake: no device is needed to
pick and call a kernel) counts ``{mode}_bwd_f32``, raises on a refused
launch without running another kernel, and a CPU tensor launches nothing;
``fused_{lstm,gru}_bwd_tf32`` with three TF32 products sits well inside
chip_smoke.py's float32 bound (``RNN_F32_REL`` of the largest value)
against the plain backward in float64, and with one TF32 product it fails
that bound.  The ``cuda``-marked cases hold the kernel against the plain
backward in float32 at chip_smoke.py's shapes and check that a launch
repeats bit for bit; they skip here (run on the card by ``python3 -m
pytest -q -m cuda --noconftest tests/test_torch_fused_rnn_bwd_f32tc.py``).
This file imports no JAX.
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
def test_float32_runs_tc32_at_the_checked_shapes(mode, tag):
    _, N, H = chip_smoke.RNN_SHAPES[tag]
    assert frc._bwd_variant(torch.float32, N, H, GATES[mode]) == "tc32"


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_each_admitted_float32_geometry_has_one_kernel(mode):
    """N in 1..40 and H <= 600: every geometry the fused path admits maps
    in float32 to tc32 exactly where its limits hold (N <= 32, H a
    multiple of 8 from 8 to 512, the layout within 227 KB), to the FMA
    kernel elsewhere, the same answer twice."""
    G = GATES[mode]
    seen = {"tc32": 0, "simt": 0}
    for N in range(1, 41):
        for H in range(1, 601):
            if not fl.fused_rnn_fits(N, H, G):
                continue
            got = frc._bwd_variant(torch.float32, N, H, G)
            assert got == frc._bwd_variant(torch.float32, N, H, G)
            limits = (N <= 32 and H % 8 == 0 and 8 <= H <= 512
                      and frc.tc32_smem_bytes(N, H, G) <= SMEM_MAX)
            assert got == ("tc32" if limits else "simt"), (N, H)
            seen[got] += 1
    assert seen["tc32"] and seen["simt"]


def _closed_form(N, H, G):
    """tc32_geo's layout written out: the split slice of X_t, h_prev,
    the dWh sums, the split dg^T, the staged X_t, the cluster's partials
    and the partials' mbarrier (padded to 16 bytes)."""
    cdiv = lambda a, b: -(-a // b)
    mt, kb = cdiv(N, 16), cdiv(N, 8)
    kc = cdiv(cdiv(G * H, 16), 8) * 8
    return (2 * 16 * mt * (kc + 4) * 4 + 8 * kb * (cdiv(H, 32) * 32 + 8) * 4
            + 8 * 8 * 2 * 32 * 16 + 2 * 32 * (8 * kb + 4) * 4
            + N * 8 * G * 4 + 16 * 16 * mt * 8 * 4 + 16)


@pytest.mark.parametrize("N,H,G,want", [(32, 512, 4, 195600),
                                        (32, 512, 3, 186384),
                                        (3, 200, 4, 92304)])
def test_tc32_shared_memory_in_closed_form(N, H, G, want):
    assert frc.tc32_smem_bytes(N, H, G) == _closed_form(N, H, G) == want


def test_tc32_shared_memory_never_binds_within_the_limits():
    worst = max(frc.tc32_smem_bytes(N, H, G) for N in range(1, 33)
                for H in range(8, 513, 8) for G in (3, 4))
    assert worst == frc.tc32_smem_bytes(32, 512, 4) <= SMEM_MAX


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


def _bwd_on_cpu(monkeypatch, mode, rc, variant=None, dtype=torch.float32):
    """The mode's backward wrapper on CPU tensors of a small layer, with
    the library, the checks and the stream replaced: (fake, launches after
    the call, or the raised error)."""
    T, N, H = 4, 3, 8
    G = GATES[mode]
    fake = _FakeLib(rc)
    monkeypatch.setattr(frc, "launches", dict.fromkeys(frc.launches, 0))
    monkeypatch.setattr(frc, "_lib", lambda: fake)
    monkeypatch.setattr(frc, "_bwd_checks", lambda *a: (T, N, H))
    monkeypatch.setattr(frc, "_launch_stream",
                        lambda device: contextlib.nullcontext(0))
    acts = torch.zeros(T, N, 4 * H)
    ys, h0 = torch.zeros(T, N, H, dtype=dtype), torch.zeros(N, H)
    wh = torch.zeros(G * H, H)
    try:
        if mode == "lstm":
            frc.lstm_bwd_cuda(acts, torch.zeros(T, N, H), ys, h0, h0, wh, ys,
                              ys[0], ys[0], _variant=variant)
        else:
            frc.gru_bwd_cuda(acts, ys, h0, wh, ys, ys[0], _variant=variant)
    except (RuntimeError, ValueError) as err:
        return fake, err
    return fake, dict(frc.launches)


@pytest.mark.parametrize("variant", [None, "tc32"])
@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_wrapper_counts_the_float32_tensor_core_launch(monkeypatch, mode,
                                                       variant):
    fake, launched = _bwd_on_cpu(monkeypatch, mode, 0, variant)
    assert fake.calls == [f"mxtt_{mode}_bwd_f32tc"]
    assert launched == {**dict.fromkeys(launched, 0), f"{mode}_bwd_f32": 1}


@pytest.mark.parametrize("rc", [1, 82])
@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_refused_tc32_launch_raises_without_retreat(monkeypatch, mode, rc):
    """A geometry the kernel refuses (1) or clusters the card cannot hold
    at once (82) raise their cudaError; neither the FMA kernel nor the
    plain version runs, and nothing is counted."""
    fake, err = _bwd_on_cpu(monkeypatch, mode, rc)
    assert isinstance(err, RuntimeError)
    assert f"{mode}_bwd_f32 launch failed with cudaError {rc}" in str(err)
    assert fake.calls == [f"mxtt_{mode}_bwd_f32tc"]
    assert frc.launches == dict.fromkeys(frc.launches, 0)


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_tc32_refuses_bfloat16(monkeypatch, mode):
    fake, err = _bwd_on_cpu(monkeypatch, mode, 0, "tc32", torch.bfloat16)
    assert isinstance(err, ValueError) and "takes float32" in str(err)
    assert fake.calls == []


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_cpu_float32_tensors_launch_nothing(mode):
    before = dict(frc.launches)
    T, N, H = 3, 2, 8
    G = GATES[mode]
    acts, ys = torch.zeros(T, N, 4 * H), torch.zeros(T, N, H)
    h0, wh = torch.zeros(N, H), torch.zeros(G * H, H)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        if mode == "lstm":
            frc.lstm_bwd_cuda(acts, ys, ys, h0, h0, wh, ys, h0, h0)
        else:
            frc.gru_bwd_cuda(acts, ys, h0, wh, ys, h0)
    assert frc.launches == before


# -- the models of the kernel's products ---------------------------------------
def _layer(mode, T, N, H, seed=0, device="cpu"):
    """One layer at the model's initial scale (chip_smoke.rnn_case's
    distributions, drawn with numpy): the plain forward's float32
    residuals and the backward's inputs, as a dict."""
    rng = np.random.RandomState(seed)
    G = GATES[mode]
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    u = lambda *s: f(rng.uniform(-0.07, 0.07, s))
    gx, h0, c0 = (f(rng.randn(*s) * 0.5)
                  for s in ((T, N, G * H), (N, H), (N, H)))
    wh, bh = u(G * H, H), u(G * H)
    dys, dhT, dcT = (f(rng.randn(*s)) for s in ((T, N, H), (N, H), (N, H)))
    if mode == "lstm":
        ys, _, _, acts, cells = fl.fused_lstm_fwd_torch(gx, h0, c0, wh, bh)
        return dict(acts=acts, cells=cells, ys=ys, h0=h0, c0=c0, wh=wh,
                    dys=dys, dhT=dhT, dcT=dcT)
    ys, _, acts = fg.fused_gru_fwd_torch(gx, h0, wh, bh)
    return dict(acts=acts, ys=ys, h0=h0, wh=wh, dys=dys, dhT=dhT)


def _bwd(mode, layer, fn=None, **kw):
    """The mode's backward over ``layer``: the plain one, or ``fn``
    (``"tf32"`` the model, ``"cuda"`` the kernel)."""
    mod = fl if mode == "lstm" else fg
    name = {None: f"fused_{mode}_bwd_torch", "tf32": f"fused_{mode}_bwd_tf32",
            "cuda": f"{mode}_bwd_cuda"}[fn]
    return getattr(frc if fn == "cuda" else mod, name)(**layer, **kw)


def _shares(mode, got, ref):
    """Each output's max |got - ref| over chip_smoke.py's float32 bound,
    RNN_F32_REL of the reference's largest magnitude."""
    names = chip_smoke.RNN_OUTPUTS["bwd"]
    return {n: float((a.double() - b.double()).abs().max())
            / (chip_smoke.RNN_F32_REL * float(b.double().abs().max()))
            for n, a, b in zip(names, got, ref)}


@pytest.mark.parametrize("shape", [(35, 3, 200), (16, 32, 64)])
@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_tf32_models_against_the_float64_backward(mode, shape):
    """Three TF32 products a product (the kernel's split) stay within half
    of the float32 bound on every output; one TF32 product of rounded
    operands (the planted fault) fails it by more than twice."""
    layer = _layer(mode, *shape)
    ref = _bwd(mode, {k: v.double() for k, v in layer.items()})
    assert all(r.dtype == torch.float64 for r in ref)
    split = _shares(mode, _bwd(mode, layer, "tf32", products=3), ref)
    single = _shares(mode, _bwd(mode, layer, "tf32", products=1), ref)
    assert max(split.values()) <= 0.5, split
    assert max(single.values()) > 2.0, single


def test_tf32_model_takes_float32_only():
    layer = _layer("gru", 2, 2, 8)
    layer["ys"] = layer["ys"].double()
    with pytest.raises(ValueError, match="takes float32"):
        fg.fused_gru_bwd_tf32(**layer)


# -- the kernel (card only) ---------------------------------------------------
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the float32 tensor-core backward is "
                    "compiled by nvcc for sm_90a and has no CPU or "
                    "interpret mode; chip_smoke.py runs it on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("tag", sorted(chip_smoke.RNN_SHAPES))
@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_cuda_tc32_backward_tracks_the_plain_version(mode, tag):
    """The kernel from the plain forward's residuals against the plain
    backward on the card, every output within RNN_F32_REL of its largest
    magnitude, one ``{mode}_bwd_f32`` launch counted."""
    _need_cuda()
    layer = _layer(mode, *chip_smoke.RNN_SHAPES[tag], seed=3, device="cuda")
    before = dict(frc.launches)
    got = _bwd(mode, layer, "cuda")
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in frc.launches.items()
            if v != before[k]} == {f"{mode}_bwd_f32": 1}
    ref = _bwd(mode, layer)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    shares = _shares(mode, got, ref)
    assert max(shares.values()) <= 1.0, shares


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_cuda_tc32_backward_repeats_bit_for_bit(mode):
    _need_cuda()
    layer = _layer(mode, *chip_smoke.RNN_SHAPES["main"], seed=4,
                   device="cuda")
    first = _bwd(mode, layer, "cuda")
    again = _bwd(mode, layer, "cuda")
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
