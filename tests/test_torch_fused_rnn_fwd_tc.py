"""The fused-RNN forward's two kernels in the PyTorch port: the host rule
that picks one, and the wrapper around it, on the CPU.

The tensor-core forward (``csrc/fused_rnn_fwd_tc.cuh``) and the float32
FMA forward (``rnn_fwd_kernel`` in ``csrc/fused_rnn.cuh``) run only on the
card; their arithmetic is the plain versions', which
``tests/test_torch_fused_rnn.py`` holds against the reference's Pallas
kernels, and their ``cuda``-marked cases there hold both kernels against
the plain forward on the card.  Here: ``_fwd_variant`` is a pure rule that
maps every geometry the fused path admits (``fused_rnn_fits``) to exactly
one kernel, the tensor-core one at the shapes chip_smoke.py checks; the
wrapper counts the kernel it launched under its own name, raises on a
refused launch without running the other kernel or the plain version, and
a CPU tensor launches nothing.  The wrapper's launch path runs here with
the library replaced by a fake (no device is needed to pick and call a
kernel).
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("tag", sorted(chip_smoke.RNN_SHAPES))
@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_variant_at_the_checked_shapes(mode, tag, dtype):
    """Every shape chip_smoke.py checks runs the tensor-core forward in
    bf16 and the other kernel in float32."""
    _, N, H = chip_smoke.RNN_SHAPES[tag]
    want = "tc" if dtype == torch.bfloat16 else "simt"
    assert frc._fwd_variant(dtype, N, H, GATES[mode]) == want


def _fwd_tc_limits_hold(N, H):
    return (1 <= N <= frc.TC_MAX_N and H % 8 == 0
            and 8 <= H <= frc.TC_MAX_H
            and frc.fwd_tc_smem_bytes(N, H) <= 232448)


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_every_admitted_geometry_maps_to_one_variant(mode):
    """A sweep over H <= 700 and N in {1, 3, 32, 33, 64}: each geometry
    the fused path admits runs on exactly one forward kernel, the
    tensor-core one exactly where its limits hold (bf16) and never in
    float32; the rule is pure (the same answer twice)."""
    G = GATES[mode]
    seen = {"tc": 0, "simt": 0}
    for N in (1, 3, 32, 33, 64):
        for H in range(1, 701):
            if not fl.fused_rnn_fits(N, H, G):
                continue
            got = frc._fwd_variant(torch.bfloat16, N, H, G)
            assert got in ("tc", "simt")
            assert got == frc._fwd_variant(torch.bfloat16, N, H, G)
            assert (got == "tc") == _fwd_tc_limits_hold(N, H), (N, H)
            assert frc._fwd_variant(torch.float32, N, H, G) == "simt"
            seen[got] += 1
    assert seen["tc"] and seen["simt"]        # both sides of the rule met


def test_fwd_tc_shared_memory_in_closed_form():
    """The closed form of the kernel's layout (fwd_geo): two halves of the
    h_{t-1} tile (rows of H padded to 16, + 8), the 4 K-quarters' partial
    gate sums (rows of 40 floats), the staged h_t and two mbarriers."""
    for (N, H), mt in (((32, 512), 2), ((3, 200), 1)):
        hp = -(-H // 16) * 16 + 8
        want = (2 * 16 * mt * hp * 2 + 4 * 16 * mt * 40 * 4 + N * 8 * 2
                + 16)
        assert frc.fwd_tc_smem_bytes(N, H) == want
    assert frc.fwd_tc_smem_bytes(32, 512) == 87568
    assert frc.fwd_tc_smem_bytes(3, 200) == 24128


def _rand(mode, T=4, N=3, H=8, seed=0):
    rng = np.random.RandomState(seed)
    G = GATES[mode]
    arrays = [rng.randn(T, N, G * H) * 0.5, rng.randn(N, H) * 0.5,
              rng.randn(N, H) * 0.5, rng.randn(G * H, H) * 0.3,
              rng.randn(G * H) * 0.1]
    if mode == "gru":
        del arrays[2]
    return [torch.from_numpy(a.astype(np.float32)) for a in arrays]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_cpu_tensors_launch_nothing(mode, dtype):
    """The autograd forward on CPU tensors runs the plain version, with
    and without residuals, in either dtype: no kernel is launched, and
    the forward wrappers refuse CPU tensors, whatever the variant."""
    before = dict(frc.launches)
    fn = fl.fused_lstm if mode == "lstm" else fg.fused_gru
    args = [a.to(dtype) for a in _rand(mode)]
    with torch.no_grad():
        outs = fn(*args)
    assert all(bool(torch.isfinite(o.float()).all()) for o in outs)
    outs = fn(*[a.requires_grad_() for a in args])
    assert outs[0].requires_grad
    assert frc.launches == before
    for variant in (None, "tc", "simt"):
        with pytest.raises(ValueError, match="must be a CUDA tensor"):
            if mode == "lstm":
                frc.lstm_fwd_cuda(*args, _variant=variant)
            else:
                frc.gru_fwd_cuda(*args, _variant=variant)
    assert frc.launches == before


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


def _fwd_on_cpu(monkeypatch, mode, dtype, rc, variant=None, save=True):
    """The mode's forward wrapper on CPU tensors of a small layer, with
    the library, the checks and the stream replaced: (fake, launches after
    the call, or the raised error, outputs or None)."""
    T, N, H = 4, 3, 8
    fake = _FakeLib(rc)
    monkeypatch.setattr(frc, "launches", dict.fromkeys(frc.launches, 0))
    monkeypatch.setattr(frc, "_lib", lambda: fake)
    monkeypatch.setattr(frc, "_fwd_checks", lambda *a: (T, N, H))
    monkeypatch.setattr(frc, "_launch_stream",
                        lambda device: contextlib.nullcontext(0))
    plain = []
    for name in ("fused_lstm_fwd_torch", "fused_gru_fwd_torch"):
        mod = fl if "lstm" in name else fg
        monkeypatch.setattr(mod, name, lambda *a, **k: plain.append(1))
    args = _rand(mode, T, N, H)             # gx, h0[, c0], wh, bh
    args[0], args[-2] = args[0].to(dtype), args[-2].to(dtype)
    try:
        if mode == "lstm":
            outs = frc.lstm_fwd_cuda(*args, save=save, _variant=variant)
        else:
            outs = frc.gru_fwd_cuda(*args, save=save, _variant=variant)
    except RuntimeError as err:
        assert not plain
        return fake, err, None
    assert not plain
    return fake, dict(frc.launches), outs


@pytest.mark.parametrize("dtype,variant,suffix,counted", [
    (torch.bfloat16, None, "_tc", ""),
    (torch.bfloat16, "tc", "_tc", ""),
    (torch.bfloat16, "simt", "", "_simt"),
    (torch.float32, None, "", "_simt")])
@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_wrapper_counts_the_kernel_it_launched(monkeypatch, mode, dtype,
                                               variant, suffix, counted):
    """bf16 goes to the tensor-core entry by the rule, ``_variant="simt"``
    and float32 to the other one; each launch is counted under its own
    kernel's name and nowhere else."""
    fake, launched, _ = _fwd_on_cpu(monkeypatch, mode, dtype, 0, variant)
    assert fake.calls == [f"mxtt_{mode}_fwd{suffix}"]
    assert launched == {**dict.fromkeys(launched, 0),
                        f"{mode}_fwd{counted}": 1}


@pytest.mark.parametrize("save", [True, False])
@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_wrapper_allocates_residuals_only_with_save(monkeypatch, mode, save):
    """The forward's outputs in the layer's shapes; the float32 residuals
    exist only with ``save`` (the eval path and ``torch.no_grad`` get
    None)."""
    T, N, H = 4, 3, 8
    _, _, outs = _fwd_on_cpu(monkeypatch, mode, torch.bfloat16, 0,
                             save=save)
    ys, hT = outs[0], outs[1]
    assert tuple(ys.shape) == (T, N, H) and ys.dtype == torch.bfloat16
    assert tuple(hT.shape) == (N, H) and hT.dtype == torch.bfloat16
    residuals = outs[3:] if mode == "lstm" else outs[2:]
    if save:
        assert tuple(residuals[0].shape) == (T, N, 4 * H)
        assert all(r.dtype == torch.float32 for r in residuals)
    else:
        assert all(r is None for r in residuals)


@pytest.mark.parametrize("rc", [1, 82])
@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_refused_tc_launch_raises_without_retreat(monkeypatch, mode, rc):
    """A geometry the tensor-core kernel refuses (1) or clusters the card
    cannot hold at once (82) raise their cudaError; neither the other
    kernel nor the plain version runs, and nothing is counted."""
    fake, err, _ = _fwd_on_cpu(monkeypatch, mode, torch.bfloat16, rc)
    assert isinstance(err, RuntimeError)
    assert f"{mode}_fwd launch failed with cudaError {rc}" in str(err)
    assert fake.calls == [f"mxtt_{mode}_fwd_tc"]
    assert frc.launches == dict.fromkeys(frc.launches, 0)


@pytest.mark.parametrize("variant", ["wgmma", "tc_f32"])
def test_unknown_or_mistyped_variant_is_refused(monkeypatch, variant):
    """An unknown variant, and the tensor-core forward asked for float32,
    are refused before anything is called."""
    if variant == "wgmma":
        with pytest.raises(ValueError, match="unknown variant"):
            _fwd_on_cpu(monkeypatch, "lstm", torch.bfloat16, 0,
                        variant="wgmma")
    else:
        with pytest.raises(ValueError, match="takes bfloat16"):
            _fwd_on_cpu(monkeypatch, "gru", torch.float32, 0, variant="tc")
    assert frc.launches == dict.fromkeys(frc.launches, 0)
