"""The float32 forward on the tensor cores: split-TF32 products.

``csrc/flash_fwd_f32tc.cu`` takes both products of the float32 forward
(S = Q K^T, then P V) as three TF32 products of operands split into
big + small halves (``csrc/tf32x3.cuh``).  Its arithmetic is modelled in
plain torch by ``ops.flash_attention.flash_attention_fwd_tf32``: here,
on the CPU, the three-product model meets the float32 bound that
chip_smoke.py holds the kernel to against the plain forward (o:
|x - plain| <= 1e-5 A + 1e-6 with A = P |V|; lse: 1e-5 (1 + |lse|)),
and the one-product model (operands rounded to TF32 once) fails it on
o, so the bound tells the two apart.  The kernel's own cases carry the
``cuda`` marker and skip without a card (the kernel is compiled by nvcc
for sm_90a and has no CPU mode); they run on the card with ``python3 -m
pytest -q -m cuda --noconftest tests/test_torch_flash_fwd_f32tc.py``.
This file imports no JAX.
"""

import numpy as np
import pytest
import torch

import torch_port_fixtures  # noqa: F401  (puts the repo on sys.path)

from mxnet_tpu_torch.ops import flash_attention_cuda as fac
from mxnet_tpu_torch.ops.flash_attention import (flash_attention_fwd_tf32,
                                                 flash_attention_fwd_torch)

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
    """float32 q, k, v drawn with numpy."""
    layout, B, Hq, Hkv, Sq, Sk, D = case[:7]
    rng = np.random.RandomState(seed)
    qs, ks = (((B, Hq, Sq, D), (B, Hkv, Sk, D)) if layout == "bhsd"
              else ((B, Sq, Hq, D), (B, Sk, Hkv, D)))
    return [torch.from_numpy(rng.randn(*s).astype(np.float32)).to(device)
            for s in (qs, ks, ks)]


def _shares(case, q, k, v, o, lse):
    """Worst shares of the float32 bound of ``o`` and ``lse`` against the
    plain forward on the same float32 inputs, and the fully-masked rows
    (lse exactly -1e30 in both; o exactly 0 there)."""
    kw = _kw(case)
    po, plse = flash_attention_fwd_torch(q, k, v, **kw)
    A, _ = flash_attention_fwd_torch(q, k, v.abs(), **kw)
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(lse).all())
    o_share = float(((o - po).abs() / (F32_REL * A + F32_ABS)).max())
    masked = plse <= -1e29
    assert torch.equal(lse <= -1e29, masked)
    assert bool((lse[masked] == -1e30).all())
    lse_share = float(((lse - plse).abs()[~masked]
                       / (F32_REL * (1 + plse.abs()[~masked]))).max())
    rows = o if case[0] == "bhsd" else o.transpose(1, 2)
    assert bool((rows[masked] == 0).all())
    return o_share, lse_share, int(masked.sum())


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_tf32_forward_model_meets_the_float32_bound(name):
    """The kernel's three-product split, modelled, is float32-accurate:
    within the bound chip_smoke.py holds the kernel to."""
    case = CASES[name]
    q, k, v = _inputs(case)
    o, lse = flash_attention_fwd_tf32(q, k, v, products=3, **_kw(case))
    o_share, lse_share, _ = _shares(case, q, k, v, o, lse)
    assert o_share <= 0.5 and lse_share <= 0.5, (o_share, lse_share)


@pytest.mark.parametrize("name", sorted(CASES))
def test_single_tf32_product_forward_fails_the_float32_bound(name):
    """One TF32 product of operands rounded once (the planted fault on the
    card) is not float32-accurate: the same bound rejects its o."""
    case = CASES[name]
    q, k, v = _inputs(case)
    o, lse = flash_attention_fwd_tf32(q, k, v, products=1, **_kw(case))
    o_share, _, _ = _shares(case, q, k, v, o, lse)
    assert o_share > 2.0, o_share


@pytest.mark.parametrize("products", [1, 3])
def test_forward_model_gives_zero_rows_where_nothing_is_kept(products):
    case = CASES["bshd_gqa_window_offsets"]
    q, k, v = _inputs(case, seed=1)
    o, lse = flash_attention_fwd_tf32(q, k, v, products=products,
                                      **_kw(case))
    assert _shares(case, q, k, v, o, lse)[2] == 6 * 36


@pytest.mark.parametrize("products", [0, 2])
def test_forward_model_rejects_other_product_counts(products):
    case = CASES["bhsd_bidir_ragged"]
    q, k, v = _inputs(case)
    with pytest.raises(ValueError, match="products must be 1 or 3"):
        flash_attention_fwd_tf32(q, k, v, products=products, **_kw(case))


# -- the kernel (card only) --------------------------------------------------
CUDA_CASES = {
    **CASES,
    "bhsd_causal_d64_256": ("bhsd", 2, 4, 4, 256, 256, 64, True, 0, 0, 0),
    # one ragged tile of 32 rows (the Module card test's sequence)
    "bhsd_causal_short": ("bhsd", 2, 2, 2, 32, 32, 64, True, 0, 0, 0),
    "bshd_gqa_window_offsets_long": ("bshd", 2, 12, 3, 300, 450, 64, True,
                                     256, 64, 100),
    # q tiles past every key: whole CTAs with no live k tile
    "bhsd_window_rows_past_keys": ("bhsd", 1, 2, 1, 200, 64, 64, True, 32,
                                   0, 0),
}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the split-TF32 forward is compiled by "
                    "nvcc for sm_90a and has no CPU mode; chip_smoke.py "
                    "runs it on the card")


def _kernel(q, k, v, kw):
    before = dict(fac.launches)
    o, lse = fac.flash_fwd_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    ran = {n: fac.launches[n] - before[n] for n in fac.launches}
    assert ran == {n: int(n == "flash_fwd_f32") for n in ran}
    return o, lse


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CUDA_CASES))
def test_cuda_split_tf32_forward_within_float32_bound(name):
    _need_cuda()
    case = CUDA_CASES[name]
    q, k, v = _inputs(case, seed=3, device="cuda")
    o, lse = _kernel(q, k, v, _kw(case))
    o_share, lse_share, masked = _shares(case, q, k, v, o, lse)
    assert o_share <= 1.0 and lse_share <= 1.0, (o_share, lse_share)
    if name == "bshd_gqa_window_offsets_long":
        assert masked == 2 * 12 * 36


@pytest.mark.cuda
def test_cuda_split_tf32_forward_on_model_operands():
    """q, k, v as bhsd views of one fused QKV projection, as the GPT model
    hands them over (rows 3 d_model apart)."""
    _need_cuda()
    case = ("bhsd", 2, 8, 8, 256, 256, 64, True, 0, 0, 0)
    B, H, S, D = 2, 8, 256, 64
    rng = np.random.RandomState(6)
    qkv = torch.from_numpy(rng.randn(B, S, 3 * H * D).astype(np.float32))
    q, k, v = (x.view(B, S, H, D).transpose(1, 2)
               for x in qkv.cuda().split(H * D, dim=-1))
    assert not q.is_contiguous() and q.stride(2) == 3 * H * D
    o, lse = _kernel(q, k, v, _kw(case))
    o_share, lse_share, _ = _shares(case, q, k, v, o, lse)
    assert o_share <= 1.0 and lse_share <= 1.0, (o_share, lse_share)


@pytest.mark.cuda
def test_cuda_split_tf32_forward_is_bitwise_repeatable():
    """Each CTA sums its rows in a fixed order, with no atomics: two runs
    agree bit for bit."""
    _need_cuda()
    case = CUDA_CASES["bshd_gqa_window_offsets_long"]
    q, k, v = _inputs(case, seed=4, device="cuda")
    first = _kernel(q, k, v, _kw(case))
    second = _kernel(q, k, v, _kw(case))
    assert all(torch.equal(a, b) for a, b in zip(first, second))
