"""The float32 dQ on the tensor cores: split-TF32 products.

``csrc/flash_dq_f32tc.cu`` takes each of the float32 dQ's three products
(S = Q K^T, dP = dO V^T, dQ = dS K) as three TF32 products of operands
split into big + small halves (``csrc/tf32x3.cuh``).  Its arithmetic is
modelled in plain torch by ``ops.flash_attention.flash_attention_dq_tf32``:
here, on the CPU, the three-product model meets the float32 bound
(|dq - plain| <= 1e-5 A + 1e-6, A = |dS| |K|, the sum of the magnitudes
of the terms dq adds up) against the plain backward summed in float32
and in float64, and the one-product model (operands rounded to TF32
once) fails it, so the bound tells the two apart.  The kernel is held,
here on the card and in chip_smoke.py, to the same bound against the
plain backward in float64: float32 arithmetic itself reaches the bound
where dS cancels (a causal row's first keys).  The kernel's own cases carry
the ``cuda`` marker and skip without a card (the kernel is compiled by
nvcc for sm_90a and has no CPU mode); they run on the card with
``python3 -m pytest -q -m cuda --noconftest
tests/test_torch_flash_dq_f32tc.py``.  This file imports no JAX.
"""

import numpy as np
import pytest
import torch

import torch_port_fixtures  # noqa: F401  (puts the repo on sys.path)

from mxnet_tpu_torch.ops import flash_attention_cuda as fac
from mxnet_tpu_torch.ops.flash_attention import (NEG_INF, _keep,
                                                 flash_attention_bwd_torch,
                                                 flash_attention_dq_tf32,
                                                 flash_attention_fwd_torch,
                                                 round_tf32)

F32_REL, F32_ABS = 1e-5, 1e-6   # chip_smoke.py's float32 bound

# (layout, B, Hq, Hkv, Sq, Sk, D, causal, window, q_offset, k_offset)
CASES = {
    "bhsd_causal_gqa": ("bhsd", 2, 4, 2, 128, 128, 64, True, 0, 0, 0),
    # q rows 0..35 (positions 64..99) see no key (positions from 100)
    "bshd_gqa_window_offsets": ("bshd", 1, 6, 2, 100, 150, 64, True, 48,
                                64, 100),
    "bhsd_bidir_ragged": ("bhsd", 1, 2, 2, 70, 90, 64, False, 0, 0, 0),
}


def _kw(case):
    layout, causal, window, qo, ko = (case[0],) + case[7:]
    return dict(causal=causal, q_offset=qo, k_offset=ko, layout=layout,
                window=window)


def _inputs(case, seed=0, device="cpu"):
    """float32 q, k, v, dO and dlse drawn with numpy."""
    layout, B, Hq, Hkv, Sq, Sk, D = case[:7]
    rng = np.random.RandomState(seed)
    qs, ks = (((B, Hq, Sq, D), (B, Hkv, Sk, D)) if layout == "bhsd"
              else ((B, Sq, Hq, D), (B, Sk, Hkv, D)))
    arrays = [rng.randn(*s).astype(np.float32) for s in (qs, ks, ks, qs)]
    arrays.append(rng.randn(B, Hq, Sq).astype(np.float32))
    return [torch.from_numpy(a).to(device) for a in arrays]


def _bhsd(x, layout):
    return x if layout == "bhsd" else x.transpose(1, 2)


def _magnitude(case, q, k, v, o, lse, do, dlse):
    """A of dq (|dS| |K|, K repeated over the GQA group), in the case's
    layout."""
    kw = _kw(case)
    lay = kw["layout"]
    qh, kh, vh, oh, doh = (_bhsd(t, lay).float() for t in (q, k, v, o, do))
    B, H, Sq, D = qh.shape
    Hkv, Sk = kh.shape[1], kh.shape[2]
    kh, vh = (t.repeat_interleave(H // Hkv, dim=1) for t in (kh, vh))
    s = torch.matmul(qh, kh.transpose(-1, -2)) / D ** 0.5
    keep = _keep(Sq, Sk, kw["causal"], kw["q_offset"], kw["k_offset"],
                 kw["window"], q.device)
    if keep is not None:
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.exp(s - lse[..., None])
    if keep is not None:
        p = p.masked_fill(~keep, 0.0)
    delta = (doh * oh).sum(-1)
    ds = p * (torch.matmul(doh, vh.transpose(-1, -2)) - delta[..., None]
              + dlse[..., None]) / D ** 0.5
    return _bhsd(torch.matmul(ds.abs(), kh.abs()), lay)


def _plain_dq(q, k, v, o, lse, do, dlse, kw, reference):
    """The plain backward's dq summed in ``reference`` ("float32" or
    "float64"), from float32 inputs and the forward's o and lse."""
    dt = getattr(torch, reference)
    return flash_attention_bwd_torch(*(t.to(dt) for t in (
        q, k, v, o, lse, do, dlse)), **kw)[0]


def _worst_share(case, got, seed=0, device="cpu", reference="float64"):
    """Worst share of the float32 bound of ``got(q, k, v, o, lse, do,
    dlse, kw)`` -> dq against the plain backward summed in
    ``reference``; asserts dq is finite and 0 on fully-masked rows."""
    q, k, v, do, dlse = _inputs(case, seed, device)
    kw = _kw(case)
    o, lse = flash_attention_fwd_torch(q, k, v, **kw)
    ref = _plain_dq(q, k, v, o, lse, do, dlse, kw, reference)
    dq = got(q, k, v, o, lse, do, dlse, kw)
    assert bool(torch.isfinite(dq).all())
    masked = lse <= -1e29
    assert bool((_bhsd(dq, kw["layout"])[masked] == 0).all())
    A = _magnitude(case, q, k, v, o, lse, do, dlse)
    return float(((dq.double() - ref).abs() / (F32_REL * A + F32_ABS))
                 .max())


def _model(products):
    def run(q, k, v, o, lse, do, dlse, kw):
        return flash_attention_dq_tf32(q, k, v, o, lse, do, dlse,
                                       products=products, **kw)
    return run


@pytest.mark.parametrize("reference", ["float32", "float64"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_split_tf32_dq_model_meets_the_float32_bound(name, reference):
    """The kernel's three-product split, modelled, is float32-accurate:
    within the bound the kernel is held to.  Its worst share sits at a
    causal row's first keys, where ds = p (dp - delta + dlse) scale
    cancels (csrc/flash_dq_f32tc.cu, trouble 3), and reaches ~0.7 here: a
    float32 rounding of dp is a large share of the bound there."""
    share = _worst_share(CASES[name], _model(3), reference=reference)
    assert share <= 1.0, share


@pytest.mark.parametrize("reference", ["float32", "float64"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_single_tf32_product_dq_fails_the_float32_bound(name, reference):
    """One TF32 product of operands rounded once (the planted fault on the
    card) is not float32-accurate: the same bound rejects it."""
    share = _worst_share(CASES[name], _model(1), reference=reference)
    assert share > 2.0, share


def test_dq_model_gives_zero_on_fully_masked_rows():
    """q rows 0..35 of the window case see no key: their lse is -1e30 and
    the model's dq is exactly 0 there, as the kernel's."""
    case = CASES["bshd_gqa_window_offsets"]
    q, k, v, do, dlse = _inputs(case, seed=1)
    kw = _kw(case)
    o, lse = flash_attention_fwd_torch(q, k, v, **kw)
    masked = lse <= -1e29
    assert int(masked.sum()) == case[2] * 36
    for products in (3, 1):
        dq = flash_attention_dq_tf32(q, k, v, o, lse, do, dlse,
                                     products=products, **kw)
        assert bool((_bhsd(dq, "bshd")[masked] == 0).all())
        assert bool((_bhsd(dq, "bshd")[~masked] != 0).any())


def test_dq_model_keeps_the_plain_dq_without_products_to_split():
    """With every operand already a TF32 value the split's small halves
    are zero and the model is the plain dq up to summation order."""
    case = CASES["bhsd_causal_gqa"]
    q, k, v, do, dlse = (round_tf32(t) for t in _inputs(case, seed=2))
    kw = _kw(case)
    o, lse = flash_attention_fwd_torch(q, k, v, **kw)
    ref, _, _ = flash_attention_bwd_torch(q, k, v, o, lse, do, dlse, **kw)
    dq = flash_attention_dq_tf32(q, k, v, o, lse, do, dlse, **kw)
    A = _magnitude(case, q, k, v, o, lse, do, dlse)
    assert bool(((dq - ref).abs() <= F32_REL * A + F32_ABS).all())


@pytest.mark.parametrize("products", [0, 2, 4])
def test_dq_model_rejects_other_product_counts(products):
    case = CASES["bhsd_bidir_ragged"]
    q, k, v, do, dlse = _inputs(case)
    o, lse = flash_attention_fwd_torch(q, k, v, **_kw(case))
    with pytest.raises(ValueError, match="products must be 1 or 3"):
        flash_attention_dq_tf32(q, k, v, o, lse, do, dlse,
                                products=products, **_kw(case))


# -- the kernel (card only) --------------------------------------------------
CUDA_CASES = {
    **CASES,
    "bhsd_causal_d64_256": ("bhsd", 2, 4, 4, 256, 256, 64, True, 0, 0, 0),
    # one ragged tile of 32 rows (the Module card test's sequence)
    "bhsd_causal_short": ("bhsd", 2, 2, 2, 32, 32, 64, True, 0, 0, 0),
    "bshd_gqa_window_offsets_long": ("bshd", 2, 12, 3, 300, 450, 64, True,
                                     256, 64, 100),
}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the split-TF32 dQ is compiled by nvcc "
                    "for sm_90a and has no CPU mode; chip_smoke.py runs it "
                    "on the card")


def _kernel(q, k, v, o, lse, do, dlse, kw):
    delta = (do.float() * o.float()).sum(-1)
    if kw["layout"] == "bshd":
        delta = delta.transpose(1, 2)
    before = dict(fac.launches)
    dq = fac.flash_dq_cuda(q, k, v, do, lse, delta.contiguous(), dlse, **kw)
    torch.cuda.synchronize()
    ran = {n: fac.launches[n] - before[n] for n in fac.launches}
    assert ran == {n: int(n == "flash_dq_f32") for n in ran}
    return dq


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CUDA_CASES))
def test_cuda_split_tf32_dq_within_float32_bound(name):
    _need_cuda()
    share = _worst_share(CUDA_CASES[name], _kernel, seed=3, device="cuda")
    assert share <= 1.0, share


@pytest.mark.cuda
def test_cuda_split_tf32_dq_on_model_operands():
    """q, k, v as bhsd views of one fused QKV projection and dO as the
    bhsd view of a bshd gradient, as the GPT model hands them over; dq is
    made by empty_like of q's fused view."""
    _need_cuda()
    case = ("bhsd", 2, 8, 8, 256, 256, 64, True, 0, 0, 0)
    B, H, S, D = 2, 8, 256, 64
    rng = np.random.RandomState(6)
    qkv = torch.from_numpy(rng.randn(B, S, 3 * H * D).astype(np.float32))
    q, k, v = (x.view(B, S, H, D).transpose(1, 2)
               for x in qkv.cuda().split(H * D, dim=-1))
    do = torch.from_numpy(rng.randn(B, S, H, D).astype(np.float32)).cuda()
    do = do.transpose(1, 2)
    dlse = torch.from_numpy(rng.randn(B, H, S).astype(np.float32)).cuda()
    assert not q.is_contiguous() and not do.is_contiguous()
    kw = _kw(case)
    o, lse = flash_attention_fwd_torch(q, k, v, **kw)
    ref = _plain_dq(q, k, v, o, lse, do, dlse, kw, "float64")
    dq = _kernel(q, k, v, o, lse, do, dlse, kw)
    A = _magnitude(case, q, k, v, o, lse, do, dlse)
    assert bool(((dq.double() - ref).abs() <= F32_REL * A + F32_ABS).all())


@pytest.mark.cuda
def test_cuda_split_tf32_dq_is_bitwise_repeatable():
    """Nothing is summed across heads or CTAs, with no atomics: two runs
    agree bit for bit."""
    _need_cuda()
    case = CUDA_CASES["bshd_gqa_window_offsets_long"]
    q, k, v, do, dlse = _inputs(case, seed=4, device="cuda")
    kw = _kw(case)
    o, lse = flash_attention_fwd_torch(q, k, v, **kw)
    first = _kernel(q, k, v, o, lse, do, dlse, kw)
    second = _kernel(q, k, v, o, lse, do, dlse, kw)
    assert torch.equal(first, second)
