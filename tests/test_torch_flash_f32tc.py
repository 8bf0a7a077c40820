"""The float32 dK/dV on the tensor cores: split-TF32 products.

``csrc/flash_dkv_f32tc.cu`` takes every product of the float32 dK/dV as
three TF32 products of operands split into big + small halves
(``csrc/tf32x3.cuh``).  Its arithmetic is modelled in plain torch by
``ops.flash_attention.flash_attention_dkv_tf32``: here, on the CPU, the
three-product model meets the float32 bound that chip_smoke.py holds
the kernel to (|x - plain| <= 1e-5 A + 1e-6, A the sum of the
magnitudes of the terms x adds up) against the plain backward, and the
one-product model (operands rounded to TF32 once) fails it, so the bound
tells the two apart.  The kernel's own cases carry the ``cuda`` marker
and skip without a card (the kernel is compiled by nvcc for sm_90a and
has no CPU mode); they run on the card with ``python3 -m pytest -q -m
cuda --noconftest tests/test_torch_flash_f32tc.py``.  This file imports
no JAX.
"""

import numpy as np
import pytest
import torch

import torch_port_fixtures  # noqa: F401  (puts the repo on sys.path)

from mxnet_tpu_torch.ops import flash_attention_cuda as fac
from mxnet_tpu_torch.ops.flash_attention import (NEG_INF, _keep,
                                                 flash_attention_bwd_torch,
                                                 flash_attention_dkv_tf32,
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


def _magnitudes(case, q, k, v, o, lse, do, dlse):
    """A of dk (|dS|^T |Q|) and dv (P^T |dO|), summed over the GQA group,
    in the case's layout."""
    kw = _kw(case)
    lay = kw["layout"]
    qh, kh, vh, oh, doh = (_bhsd(t, lay).float() for t in (q, k, v, o, do))
    B, H, Sq, D = qh.shape
    Hkv, Sk = kh.shape[1], kh.shape[2]
    grp = H // Hkv
    kh, vh = (t.repeat_interleave(grp, dim=1) for t in (kh, vh))
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

    def group_sum(x):
        return _bhsd(x.reshape(B, Hkv, grp, Sk, D).sum(2), lay)

    return (group_sum(torch.matmul(ds.abs().transpose(-1, -2), qh.abs())),
            group_sum(torch.matmul(p.transpose(-1, -2), doh.abs())))


def _worst_shares(case, got, seed=0, device="cpu"):
    """Worst share of the float32 bound of ``got(q, k, v, o, lse, do,
    dlse, kw)`` -> (dk, dv) against the plain backward."""
    q, k, v, do, dlse = _inputs(case, seed, device)
    kw = _kw(case)
    o, lse = flash_attention_fwd_torch(q, k, v, **kw)
    _, pdk, pdv = flash_attention_bwd_torch(q, k, v, o, lse, do, dlse, **kw)
    dk, dv = got(q, k, v, o, lse, do, dlse, kw)
    shares = []
    for x, ref, A in zip((dk, dv), (pdk, pdv),
                         _magnitudes(case, q, k, v, o, lse, do, dlse)):
        assert bool(torch.isfinite(x).all())
        shares.append(float(((x - ref).abs() / (F32_REL * A + F32_ABS))
                            .max()))
    return shares


def _model(products):
    def run(q, k, v, o, lse, do, dlse, kw):
        return flash_attention_dkv_tf32(q, k, v, o, lse, do, dlse,
                                        products=products, **kw)
    return run


def test_round_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    x = torch.tensor([one, one + 2 ** -12, one + 2 ** -11,
                      one + 3 * 2 ** -11, -(one + 2 ** -11), 0.0, -0.0,
                      3.0e-39])
    want = torch.tensor([one, one, one + 2 ** -10, one + 2 ** -9,
                         -(one + 2 ** -10), 0.0, -0.0, 3.0e-39])
    got = round_tf32(x)
    assert torch.equal(got.view(torch.int32)[:7], want.view(torch.int32)[:7])
    assert int(got.view(torch.int32)[7]) & 0x1FFF == 0
    r = torch.from_numpy(np.random.RandomState(1).randn(4096)
                         .astype(np.float32))
    big = round_tf32(r)
    assert not bool((big.view(torch.int32) & 0x1FFF).any())
    assert bool(((r - big).abs() <= 2.0 ** -11 * r.abs()).all())
    small = round_tf32(r - big)
    assert bool(((r - big - small).abs() <= 2.0 ** -22 * r.abs()).all())


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_tf32_model_meets_the_float32_bound(name):
    """The kernel's three-product split, modelled, is float32-accurate:
    within the bound chip_smoke.py holds the kernel to."""
    shares = _worst_shares(CASES[name], _model(3))
    assert max(shares) <= 0.5, shares


@pytest.mark.parametrize("name", sorted(CASES))
def test_single_tf32_product_fails_the_float32_bound(name):
    """One TF32 product of operands rounded once (the planted fault on the
    card) is not float32-accurate: the same bound rejects it."""
    shares = _worst_shares(CASES[name], _model(1))
    assert min(shares) > 2.0, shares


def test_model_keeps_the_plain_backward_without_products_to_split():
    """With every operand already a TF32 value the split's small halves
    are zero and the model is the plain backward up to summation order."""
    case = CASES["bhsd_causal_gqa"]
    q, k, v, do, dlse = (round_tf32(t) for t in _inputs(case, seed=2))
    kw = _kw(case)
    o, lse = flash_attention_fwd_torch(q, k, v, **kw)
    _, pdk, pdv = flash_attention_bwd_torch(q, k, v, o, lse, do, dlse, **kw)
    dk, dv = flash_attention_dkv_tf32(q, k, v, o, lse, do, dlse, **kw)
    A = _magnitudes(case, q, k, v, o, lse, do, dlse)
    for x, ref, a in zip((dk, dv), (pdk, pdv), A):
        assert bool(((x - ref).abs() <= F32_REL * a + F32_ABS).all())


def test_model_rejects_other_product_counts():
    case = CASES["bhsd_bidir_ragged"]
    q, k, v, do, dlse = _inputs(case)
    o, lse = flash_attention_fwd_torch(q, k, v, **_kw(case))
    with pytest.raises(ValueError, match="products must be 1 or 3"):
        flash_attention_dkv_tf32(q, k, v, o, lse, do, dlse, products=2,
                                 **_kw(case))


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
        pytest.skip("no CUDA device: the split-TF32 dK/dV is compiled by "
                    "nvcc for sm_90a and has no CPU mode; chip_smoke.py "
                    "runs it on the card")


def _kernel(q, k, v, o, lse, do, dlse, kw):
    delta = (do.float() * o.float()).sum(-1)
    if kw["layout"] == "bshd":
        delta = delta.transpose(1, 2)
    before = dict(fac.launches)
    dk, dv = fac.flash_dkv_cuda(q, k, v, do, lse, delta.contiguous(), dlse,
                                **kw)
    torch.cuda.synchronize()
    ran = {n: fac.launches[n] - before[n] for n in fac.launches}
    assert ran == {n: int(n == "flash_dkv_f32") for n in ran}
    return dk, dv


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CUDA_CASES))
def test_cuda_split_tf32_dkv_within_float32_bound(name):
    _need_cuda()
    shares = _worst_shares(CUDA_CASES[name], _kernel, seed=3, device="cuda")
    assert max(shares) <= 1.0, shares


@pytest.mark.cuda
def test_cuda_split_tf32_dkv_on_model_operands():
    """q, k, v as bhsd views of one fused QKV projection and dO as the
    bhsd view of a bshd gradient, as the GPT model hands them over."""
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
    _, pdk, pdv = flash_attention_bwd_torch(q, k, v, o, lse, do, dlse, **kw)
    dk, dv = _kernel(q, k, v, o, lse, do, dlse, kw)
    for x, ref, A in zip((dk, dv), (pdk, pdv),
                         _magnitudes(case, q, k, v, o, lse, do, dlse)):
        assert bool(((x - ref).abs() <= F32_REL * A + F32_ABS).all())


@pytest.mark.cuda
def test_cuda_split_tf32_dkv_is_bitwise_repeatable():
    """The GQA group sums in registers, with no atomics: two runs agree
    bit for bit."""
    _need_cuda()
    case = CUDA_CASES["bshd_gqa_window_offsets_long"]
    q, k, v, do, dlse = _inputs(case, seed=4, device="cuda")
    kw = _kw(case)
    o, lse = flash_attention_fwd_torch(q, k, v, **kw)
    first = _kernel(q, k, v, o, lse, do, dlse, kw)
    second = _kernel(q, k, v, o, lse, do, dlse, kw)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
