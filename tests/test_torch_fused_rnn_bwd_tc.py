"""The fused-RNN backward's kernels in the PyTorch port: the host rule
that picks one, and the wrapper around it, on the CPU.

The bf16 tensor-core backward (``csrc/fused_rnn_bwd_tc.cuh``), the
float32 one (``csrc/fused_rnn_bwd_f32tc.cuh``, split TF32) and the
FMA backward (``rnn_bwd_kernel`` in ``csrc/fused_rnn.cuh``) run only on
the card; their arithmetic is the plain versions', which
``tests/test_torch_fused_rnn.py`` holds against the reference's Pallas
kernels, and their ``cuda``-marked cases there hold the kernels against
the plain versions on the card.  Here: ``_bwd_variant`` is a pure rule
that maps every geometry the fused path admits (``fused_rnn_fits``) to
exactly one kernel, a tensor-core one in either dtype at the shapes
chip_smoke.py checks; the wrapper counts the kernel it launched under its
own name, raises on a refused launch without running another kernel,
and a CPU tensor launches nothing.  The wrapper's launch path runs here with the
library replaced by a fake (no device is needed to pick and call a
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
    """Every shape chip_smoke.py checks runs a tensor-core backward: the
    bf16 one in bf16, the split-TF32 one in float32."""
    _, N, H = chip_smoke.RNN_SHAPES[tag]
    want = "tc" if dtype == torch.bfloat16 else "tc32"
    assert frc._bwd_variant(dtype, N, H, GATES[mode]) == want


def _tc_limits_hold(N, H, G, smem=frc.tc_smem_bytes):
    return (1 <= N <= frc.TC_MAX_N and H % 8 == 0
            and 8 <= H <= frc.TC_MAX_H and smem(N, H, G) <= 232448)


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_every_admitted_geometry_maps_to_one_variant(mode):
    """A sweep over H <= 700 and N in {1, 3, 32, 33, 64}: each geometry
    the fused path admits runs on exactly one kernel, the bf16
    tensor-core one exactly where its limits hold in bf16, the float32
    one exactly where its limits hold in float32, the FMA one elsewhere;
    the rule is pure (the same answer twice)."""
    G = GATES[mode]
    seen = {"tc": 0, "tc32": 0, "simt": 0}
    for N in (1, 3, 32, 33, 64):
        for H in range(1, 701):
            if not fl.fused_rnn_fits(N, H, G):
                continue
            got = frc._bwd_variant(torch.bfloat16, N, H, G)
            assert got in ("tc", "simt")
            assert got == frc._bwd_variant(torch.bfloat16, N, H, G)
            assert (got == "tc") == _tc_limits_hold(N, H, G), (N, H)
            seen[got] += 1
            got = frc._bwd_variant(torch.float32, N, H, G)
            assert got in ("tc32", "simt")
            assert got == frc._bwd_variant(torch.float32, N, H, G)
            assert (got == "tc32") == _tc_limits_hold(
                N, H, G, frc.tc32_smem_bytes), (N, H)
            seen[got] += 1
    assert all(seen.values())                 # every side of the rule met


def test_tc_shared_memory_in_closed_form():
    """The closed form of the kernel's layout (tc_geo) at the LM shape:
    the slice of X_t, two halves of h_prev, two of dg_lo^T and of the
    dgates, the staged part of X_t, the cluster's partials and two
    mbarriers (the bytes the card's launch reported)."""
    mt, hp = 2, 512 + 8
    for G in (4, 3):
        kc = G * 512 // 16 + 8
        want = (16 * mt * kc * 2 + 2 * 16 * mt * hp * 2
                + 2 * 32 * (16 * mt + 8) * 2 + 2 * 32 * G * 8 * 4
                + 32 * G * 8 * 2 + 16 * 16 * mt * 8 * 4 + 16)
        assert frc.tc_smem_bytes(32, 512, G) == want
    assert frc.tc_smem_bytes(32, 512, 4) == 107024
    assert frc.tc_smem_bytes(32, 512, 3) == 102416
    assert frc.tc_smem_bytes(3, 200, 4) == 28368


def test_launch_counts_carry_both_backward_kernels():
    assert set(frc.launches) == {"lstm_fwd", "lstm_fwd_f32", "lstm_fwd_simt",
                                 "lstm_bwd", "lstm_bwd_f32", "lstm_bwd_simt",
                                 "gru_fwd", "gru_fwd_f32", "gru_fwd_simt",
                                 "gru_bwd", "gru_bwd_f32", "gru_bwd_simt"}
    assert all(isinstance(v, int) for v in frc.launches.values())


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
    """The autograd path on CPU tensors runs the plain versions, forward
    and backward, in either dtype: no kernel is launched, and the
    backward wrappers refuse CPU tensors."""
    before = dict(frc.launches)
    args = [a.to(dtype).requires_grad_() for a in _rand(mode)]
    fn = fl.fused_lstm if mode == "lstm" else fg.fused_gru
    outs = fn(*args)
    sum(o.float().sum() for o in outs).backward()
    assert all(a.grad is not None for a in args)
    assert frc.launches == before
    G = GATES[mode]
    T, N, H = 4, 3, 8
    acts = torch.zeros(T, N, 4 * H)
    ys = torch.zeros(T, N, H)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        if mode == "lstm":
            frc.lstm_bwd_cuda(acts, torch.zeros(T, N, H), ys,
                              torch.zeros(N, H), torch.zeros(N, H),
                              torch.zeros(G * H, H), ys, ys[0], ys[0])
        else:
            frc.gru_bwd_cuda(acts, ys, torch.zeros(N, H),
                             torch.zeros(G * H, H), ys, ys[0])
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


def _bwd_on_cpu(monkeypatch, mode, dtype, rc, variant=None):
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
    except RuntimeError as err:
        return fake, err
    return fake, dict(frc.launches)


@pytest.mark.parametrize("dtype,variant,suffix,counted", [
    (torch.bfloat16, None, "_tc", ""),
    (torch.bfloat16, "simt", "", "_simt"),
    (torch.float32, None, "_f32tc", "_f32"),
    (torch.float32, "simt", "", "_simt")])
@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_wrapper_counts_the_kernel_it_launched(monkeypatch, mode, dtype,
                                               variant, suffix, counted):
    """bf16 goes to the bf16 tensor-core entry by the rule, float32 to the
    float32 one, ``_variant="simt"`` to the FMA one in either dtype; each
    launch is counted under its own kernel's name and nowhere else."""
    fake, launched = _bwd_on_cpu(monkeypatch, mode, dtype, 0, variant)
    assert fake.calls == [f"mxtt_{mode}_bwd{suffix}"]
    assert launched == {**dict.fromkeys(launched, 0),
                        f"{mode}_bwd{counted}": 1}


@pytest.mark.parametrize("rc", [1, 82])
@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_refused_tc_launch_raises_without_retreat(monkeypatch, mode, rc):
    """A geometry the tensor-core kernel refuses (1) or clusters the card
    cannot hold at once (82) raise their cudaError; neither the other
    kernel nor the plain version runs, and nothing is counted."""
    fake, err = _bwd_on_cpu(monkeypatch, mode, torch.bfloat16, rc)
    assert isinstance(err, RuntimeError)
    assert f"{mode}_bwd launch failed with cudaError {rc}" in str(err)
    assert fake.calls == [f"mxtt_{mode}_bwd_tc"]
    assert frc.launches == dict.fromkeys(frc.launches, 0)


def test_unknown_variant_is_refused(monkeypatch):
    with pytest.raises(ValueError, match="unknown variant"):
        _bwd_on_cpu(monkeypatch, "lstm", torch.bfloat16, 0, variant="wgmma")
