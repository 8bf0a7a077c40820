"""Flash attention of the PyTorch port against the JAX reference.

The port's plain forward (``flash_attention_fwd_torch``: ``o`` and
``lse``) and plain backward (``flash_attention_bwd_torch``: dq, dk, dv
with a non-zero ``dlse``) are held against the reference's
``flash_attention`` run through its Pallas kernels in interpret mode and
differentiated by ``jax.vjp``, as ``tests/test_longcontext.py`` runs
them: both layouts, causal and bidirectional, sliding windows, grouped
query heads, position offsets with Sq != Sk and fully-masked rows.
float32 is held at 2e-6 (outputs, lse) and 1e-5 (gradients): the same
float32 products summed in another order.  bfloat16 is held loosely
(both sides round p and ds to bfloat16 at the same points, but not
after the same float32 sums).

The Hopper kernels' own cases carry the ``cuda`` marker and skip without
a CUDA device: the kernels are compiled by nvcc for sm_90a at first
launch and have no CPU or interpret mode.  ``python3 chip_smoke.py``
holds them against the plain versions on the card at the training
shape.  Which forward kernel takes a call (tensor cores or not) is a
plain function of the operands, tested here on the CPU.
"""

import numpy as np
import pytest
import torch

import torch_port_fixtures  # noqa: F401  (puts the repo on sys.path)

from mxnet_tpu_torch.ops import FlashAttention
from mxnet_tpu_torch.ops import flash_attention_cuda as fac
from mxnet_tpu_torch.ops.flash_attention import (flash_attention,
                                                 flash_attention_bwd_torch,
                                                 flash_attention_fwd_torch)

F32_OUT, F32_GRAD = 2e-6, 1e-5

# (layout, B, Hq, Hkv, Sq, Sk, D, causal, window, q_offset, k_offset)
CASES = {
    "bhsd_causal": ("bhsd", 2, 2, 2, 32, 32, 16, True, 0, 0, 0),
    "bhsd_full": ("bhsd", 2, 2, 2, 32, 32, 16, False, 0, 0, 0),
    "bshd_causal_gqa": ("bshd", 1, 4, 2, 32, 32, 8, True, 0, 0, 0),
    "bhsd_gqa_window": ("bhsd", 1, 4, 1, 48, 48, 8, True, 8, 0, 0),
    "bshd_bidir_window": ("bshd", 2, 2, 2, 32, 32, 8, False, 8, 0, 0),
    "offsets_sq_ne_sk": ("bhsd", 1, 2, 2, 16, 48, 8, True, 0, 32, 0),
    "masked_rows": ("bshd", 1, 2, 2, 32, 32, 8, True, 0, 0, 8),
    "all_masked": ("bhsd", 1, 1, 1, 16, 16, 8, True, 0, 0, 16),
    "bshd_gqa_window_offsets": ("bshd", 1, 6, 3, 16, 32, 8, True, 12, 16,
                                 4),
}


def _inputs(case, seed=0):
    layout, B, Hq, Hkv, Sq, Sk, D = case[:7]
    rng = np.random.RandomState(seed)
    if layout == "bhsd":
        qs, ks = (B, Hq, Sq, D), (B, Hkv, Sk, D)
    else:
        qs, ks = (B, Sq, Hq, D), (B, Sk, Hkv, D)
    q = rng.randn(*qs).astype(np.float32)
    k = rng.randn(*ks).astype(np.float32)
    v = rng.randn(*ks).astype(np.float32)
    do = rng.randn(*qs).astype(np.float32)
    dlse = rng.randn(B, Hq, Sq).astype(np.float32)
    return q, k, v, do, dlse


def _kw(case):
    layout, causal, window, qo, ko = (case[0],) + case[7:]
    return dict(causal=causal, q_offset=qo, k_offset=ko, layout=layout,
                window=window)


def _reference(case, q, k, v, do, dlse, dtype):
    """The reference's flash_attention (Pallas interpret mode off-TPU,
    16-row tiles) and its vjp at (do, dlse)."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.ops.flash_attention import flash_attention as ref_flash

    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    args = [jnp.asarray(a, jd) for a in (q, k, v)]

    def f(q, k, v):
        return ref_flash(q, k, v, block_q=16, block_k=16, return_lse=True,
                         **_kw(case))

    (o, lse), vjp = jax.vjp(f, *args)
    dq, dk, dv = vjp((jnp.asarray(do, jd), jnp.asarray(dlse)))
    f32 = lambda a: np.asarray(a.astype(jnp.float32))
    return f32(o), f32(lse), f32(dq), f32(dk), f32(dv)


def _port(case, q, k, v, do, dlse, dtype):
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v, do)]
    o, lse = flash_attention_fwd_torch(*t[:3], **_kw(case))
    dq, dk, dv = flash_attention_bwd_torch(*t[:3], o, lse, t[3],
                                           torch.from_numpy(dlse),
                                           **_kw(case))
    return [x.float().numpy() for x in (o, lse, dq, dk, dv)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_versions_match_reference_pallas_f32(name):
    case = CASES[name]
    data = _inputs(case)
    ref = _reference(case, *data, torch.float32)
    got = _port(case, *data, torch.float32)
    for label, a, b, tol in zip(("o", "lse", "dq", "dk", "dv"), got, ref,
                                (F32_OUT, F32_OUT) + (F32_GRAD,) * 3):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=label)


@pytest.mark.parametrize("name", ["bhsd_causal", "bshd_causal_gqa",
                                  "bshd_gqa_window_offsets"])
def test_plain_versions_track_reference_bf16(name):
    """bfloat16: same rounding points, other summation orders; held to
    a few bf16 ulps of each output's scale."""
    case = CASES[name]
    data = _inputs(case, seed=1)
    ref = _reference(case, *data, torch.bfloat16)
    got = _port(case, *data, torch.bfloat16)
    for label, a, b in zip(("o", "lse", "dq", "dk", "dv"), got, ref):
        scale = max(float(np.abs(b).max()), 1e-3)
        assert float(np.abs(a - b).max()) <= 2 ** -6 * scale, label


def test_fully_masked_rows_are_zero_with_sentinel_lse():
    case = CASES["masked_rows"]     # k_offset 8: q rows 0..7 see no key
    q, k, v, do, dlse = _inputs(case)
    o, lse, dq, _, _ = _port(case, q, k, v, do, dlse, torch.float32)
    assert np.all(o[:, :8] == 0.0) and np.all(dq[:, :8] == 0.0)
    assert np.all(lse[:, :, :8] == -1e30)
    assert np.all(np.isfinite(o)) and np.all(np.isfinite(dq))
    assert np.all(lse[:, :, 8:] > -1e29)


def test_autograd_on_cpu_tensors_runs_the_plain_versions():
    """flash_attention on CPU tensors goes through _Flash, whose forward
    and backward are exactly the plain versions (dlse included)."""
    case = CASES["bshd_gqa_window_offsets"]
    q, k, v, do, dlse = _inputs(case, seed=2)
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o, lse = flash_attention(*t, return_lse=True, **_kw(case))
    torch.autograd.backward((o, lse), (torch.from_numpy(do),
                                       torch.from_numpy(dlse)))
    po, plse = flash_attention_fwd_torch(*[x.detach() for x in t],
                                         **_kw(case))
    want = flash_attention_bwd_torch(*[x.detach() for x in t], po, plse,
                                     torch.from_numpy(do),
                                     torch.from_numpy(dlse), **_kw(case))
    assert torch.equal(o.detach(), po) and torch.equal(lse.detach(), plse)
    for x, w in zip(t, want):
        assert torch.equal(x.grad, w)


def test_no_kernel_launch_for_cpu_tensors_and_no_fallback_for_wrapper():
    before = dict(fac.launches)
    q, k, v, _, _ = _inputs(CASES["bhsd_causal"])
    t = [torch.from_numpy(a) for a in (q, k, v)]
    flash_attention(*t, causal=True)
    assert fac.launches == before
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        fac.flash_fwd_cuda(*t, causal=True)


@pytest.mark.parametrize("impl", ["auto", "flash", "xla"])
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_op_impls_match_reference_op(impl, layout):
    """The FlashAttention op: auto (dense on the CPU), flash (the plain
    flash versions) and xla agree with the reference op's dense path,
    GQA and window included."""
    import mxnet_tpu as mx

    rng = np.random.RandomState(3)
    B, Hq, Hkv, S, D = 2, 4, 2, 32, 8
    shp = (lambda h: (B, h, S, D)) if layout == "bhsd" else (
        lambda h: (B, S, h, D))
    q = rng.randn(*shp(Hq)).astype(np.float32)
    k = rng.randn(*shp(Hkv)).astype(np.float32)
    v = rng.randn(*shp(Hkv)).astype(np.float32)
    ref = mx.nd.FlashAttention(mx.nd.array(q), mx.nd.array(k),
                               mx.nd.array(v), causal=True, window=6,
                               layout=layout, impl="xla").asnumpy()
    got = FlashAttention(*(torch.from_numpy(a) for a in (q, k, v)),
                         causal=True, window=6, layout=layout, impl=impl)
    np.testing.assert_allclose(got.numpy(), ref, rtol=F32_OUT,
                               atol=F32_OUT)


def test_arguments_are_validated():
    q, k, v, _, _ = _inputs(CASES["bshd_causal_gqa"])
    t = [torch.from_numpy(a) for a in (q, k, v)]
    with pytest.raises(ValueError, match="window must be >= 0"):
        flash_attention(*t, layout="bshd", window=-1)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        flash_attention(t[0][:, :, :3], *t[1:], layout="bshd")
    with pytest.raises(ValueError, match="impl must be"):
        FlashAttention(*t, layout="bshd", impl="pallas")


# -- the Hopper kernels (card only) -----------------------------------------
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the Hopper kernels are compiled by "
                    "nvcc for sm_90a and have no CPU or interpret mode; "
                    "chip_smoke.py runs them on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_kernels_match_plain_versions_f32(name):
    _need_cuda()
    case = CASES[name]
    q, k, v, do, dlse = (torch.from_numpy(a).cuda() for a in _inputs(case))
    o, lse = fac.flash_fwd_cuda(q, k, v, **_kw(case))
    po, plse = flash_attention_fwd_torch(q, k, v, **_kw(case))
    delta = (do * o).sum(-1)
    if case[0] == "bshd":
        delta = delta.transpose(1, 2)
    delta = delta.contiguous()
    dq = fac.flash_dq_cuda(q, k, v, do, lse, delta, dlse, **_kw(case))
    dk, dv = fac.flash_dkv_cuda(q, k, v, do, lse, delta, dlse, **_kw(case))
    want = flash_attention_bwd_torch(q, k, v, o, lse, do, dlse, **_kw(case))
    torch.cuda.synchronize()
    assert float((o - po).abs().max()) <= F32_OUT
    assert torch.equal(lse <= -1e29, plse <= -1e29)
    assert float((lse - plse).abs().max()) <= F32_OUT * 10
    for got, w in zip((dq, dk, dv), want):
        assert float((got - w).abs().max()) <= F32_GRAD


@pytest.mark.cuda
def test_cuda_kernels_reject_what_they_do_not_take():
    _need_cuda()
    q, k, v, _, _ = (torch.from_numpy(a).cuda()
                     for a in _inputs(CASES["bhsd_causal"]))
    with pytest.raises(ValueError, match="dtype"):
        fac.flash_fwd_cuda(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="last dimension"):
        fac.flash_fwd_cuda(q.transpose(-1, -2), k.transpose(-1, -2),
                           v.transpose(-1, -2))
    wide = torch.zeros(1, 1, 4, 160, device="cuda")
    with pytest.raises(RuntimeError, match="cudaError 1 "):
        fac.flash_fwd_cuda(wide, wide, wide)


# -- the forward's two variants ---------------------------------------------
# (dtype, head_dim, q/k/v/o data pointers, batch/head/sequence strides of
# q, k, v, o): the contiguous bhsd training shape, its fused-QKV views
# (rows 3 d_model apart, k and v 1024 and 2048 bytes into the row), and
# one departure from the tensor-core kernel's limits each
_PTRS = (0x7F0000000000, 0x7F0000100000, 0x7F0000200000, 0x7F0000300000)
_BHSD = (8 * 1024 * 64, 1024 * 64, 64) * 4
_FUSED_PTRS = (0x7F0000000000, 0x7F0000000400, 0x7F0000000800,
               0x7F0000300000)
_FUSED = (1024 * 1536, 64, 1536) * 3 + (8 * 1024 * 64, 1024 * 64, 64)
VARIANT_CASES = {
    "bf16_d64": (torch.bfloat16, 64, _PTRS, _BHSD, "tc"),
    "bf16_d128": (torch.bfloat16, 128, _PTRS,
                  tuple(2 * x for x in _BHSD), "tc"),
    "bf16_fused_qkv_views": (torch.bfloat16, 64, _FUSED_PTRS, _FUSED, "tc"),
    "float32": (torch.float32, 64, _PTRS, _BHSD, "simt"),
    "bf16_d80": (torch.bfloat16, 80, _PTRS, (8 * 1024 * 80, 1024 * 80, 80)
                 * 4, "simt"),
    "bf16_d32": (torch.bfloat16, 32, _PTRS, (8 * 1024 * 32, 1024 * 32, 32)
                 * 4, "simt"),
    "bf16_odd_sequence_stride": (torch.bfloat16, 64, _PTRS,
                                 (8 * 1024 * 65, 1024 * 65, 65) * 4, "simt"),
    "bf16_misaligned_k": (torch.bfloat16, 64,
                          (_PTRS[0], _PTRS[1] + 2) + _PTRS[2:], _BHSD,
                          "simt"),
    "bf16_misaligned_o": (torch.bfloat16, 64, _PTRS[:3] + (_PTRS[3] + 8,),
                          _BHSD, "simt"),
}


@pytest.mark.parametrize("name", sorted(VARIANT_CASES))
def test_fwd_variant_follows_the_tensor_core_limits(name):
    dtype, D, ptrs, strides, want = VARIANT_CASES[name]
    assert fac._fwd_variant(dtype, D, ptrs, strides) == want


def test_every_counted_kernel_states_its_limits():
    """The launch error names the kernel that refused and what it takes."""
    assert set(fac.LIMITS) == set(fac.launches)
    assert "head_dim 64 or 128" in fac.LIMITS["flash_fwd"]


# the tensor-core forward on the card, against the plain forward run in
# float32 on the same bf16 values, under chip_smoke.py's bf16 bound:
# |kernel - plain32| <= 2^-8 (|plain32| + A) + 1e-5 A + 1e-6, A = P|V|
# (p rounded to bf16 before P.V: 2^-8 A; o rounded once: 2^-8 |o|)
TC_CASES = {
    "bhsd_causal_d64": ("bhsd", 2, 4, 4, 256, 256, 64, True, 0, 0, 0),
    "bhsd_causal_d128": ("bhsd", 2, 4, 4, 256, 256, 128, True, 0, 0, 0),
    # q rows 0..35 (positions 64..99) see no key (positions from 100)
    "bshd_gqa_window_offsets": ("bshd", 2, 12, 3, 300, 450, 64, True, 256,
                                64, 100),
    "bhsd_bidir_ragged": ("bhsd", 2, 2, 2, 200, 333, 64, False, 0, 0, 0),
    "bshd_bidir_window_ragged": ("bshd", 1, 4, 2, 130, 77, 128, False, 40,
                                 0, 0),
}


def _tc_operands(case, fused=False, seed=4):
    """bf16 CUDA q, k, v: contiguous, or bhsd views of one fused QKV
    projection (B, S, (Hq + 2 Hkv) D) as the GPT model makes them."""
    layout, B, Hq, Hkv, Sq, Sk, D = case[:7]
    rng = np.random.RandomState(seed)
    if fused:
        qkv = torch.from_numpy(rng.randn(B, Sq, (Hq + 2 * Hkv) * D).astype(
            np.float32)).to("cuda", torch.bfloat16)
        parts = qkv.split([Hq * D, Hkv * D, Hkv * D], dim=-1)
        return [x.view(B, Sq, -1, D).transpose(1, 2) for x in parts]
    q, k, v, _, _ = _inputs(case, seed)
    return [torch.from_numpy(a).to("cuda", torch.bfloat16)
            for a in (q, k, v)]


def _within_bf16_bound(case, q, k, v, o, lse):
    """Asserts o and lse within the bf16 bound; returns the number of
    fully-masked rows (o exactly 0, lse exactly -1e30)."""
    up = [t.float() for t in (q, k, v)]
    po, plse = flash_attention_fwd_torch(*up, **_kw(case))
    A, _ = flash_attention_fwd_torch(up[0], up[1], up[2].abs(), **_kw(case))
    allowed = 2.0 ** -8 * (po.abs() + A) + F32_GRAD * A + 1e-6
    assert bool(((o.float() - po).abs() <= allowed).all())
    masked = plse <= -1e29
    assert torch.equal(lse <= -1e29, masked)
    assert bool((lse[masked] == -1e30).all())
    assert bool(((lse - plse).abs()[~masked]
                 <= F32_GRAD * (1 + plse.abs()[~masked])).all())
    rows = o if case[0] == "bhsd" else o.transpose(1, 2)
    assert bool((rows[masked] == 0).all())
    return int(masked.sum())


def _check_tc_forward(case, q, k, v):
    before = dict(fac.launches)
    o, lse = fac.flash_fwd_cuda(q, k, v, **_kw(case))
    torch.cuda.synchronize()
    assert fac.launches["flash_fwd"] == before["flash_fwd"] + 1
    assert fac.launches["flash_fwd_simt"] == before["flash_fwd_simt"]
    return _within_bf16_bound(case, q, k, v, o, lse)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TC_CASES))
def test_cuda_tensor_core_forward_within_bf16_bound(name):
    _need_cuda()
    case = TC_CASES[name]
    masked = _check_tc_forward(case, *_tc_operands(case))
    if name == "bshd_gqa_window_offsets":
        assert masked == 2 * 12 * 36


@pytest.mark.cuda
def test_cuda_tensor_core_forward_on_fused_qkv_views():
    _need_cuda()
    case = ("bhsd", 2, 8, 8, 256, 256, 64, True, 0, 0, 0)
    q, k, v = _tc_operands(case, fused=True)
    assert q.stride(2) == 3 * 8 * 64 and not q.is_contiguous()
    _check_tc_forward(case, q, k, v)


@pytest.mark.cuda
def test_cuda_float32_and_misaligned_bf16_run_the_simt_forward():
    _need_cuda()
    case = TC_CASES["bhsd_causal_d64"]
    q, k, v = _tc_operands(case)
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device="cuda")
    q_off = buf[1:].view(q.shape)       # 2 bytes past a 16-byte boundary
    q_off.copy_(q)
    before = dict(fac.launches)
    fac.flash_fwd_cuda(q.float(), k.float(), v.float(), **_kw(case))
    o_simt, lse_simt = fac.flash_fwd_cuda(q_off, k, v, **_kw(case))
    assert fac.launches["flash_fwd_simt"] == before["flash_fwd_simt"] + 2
    assert fac.launches["flash_fwd"] == before["flash_fwd"]
    torch.cuda.synchronize()
    _within_bf16_bound(case, q, k, v, o_simt, lse_simt)
    wide = torch.zeros(1, 1, 4, 160, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="flash_fwd_simt launch failed "
                                           "with cudaError 1 "):
        fac.flash_fwd_cuda(wide, wide, wide)
