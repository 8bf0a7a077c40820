"""Paged attention of the PyTorch port against the JAX reference.

The port's plain torch path (``paged_attention`` on CPU tensors) is held
against the reference's jnp path AND the reference's Pallas kernel run
through the Pallas interpreter off-TPU (``impl="pallas"``, as
``tests/test_quant_serve.py`` runs it), at max-abs <= 2e-6 in float32
across grouped-query / MHA / MQA / window / int8 / padded / null-block /
empty-row cases.

The CUDA kernels' own cases (the split kernel, and the combine kernel
where a call splits, also at forced split counts) carry the ``cuda``
marker and skip without a CUDA device: the kernels are compiled by nvcc
for sm_90a at first launch and have no CPU or interpret mode.
``python3 chip_smoke.py`` holds them against the plain path on the card.
"""

import numpy as np
import pytest
import torch

import torch_port_fixtures  # noqa: F401  (puts the repo on sys.path)

from mxnet_tpu_torch.ops import attention as port_attn
from mxnet_tpu_torch.ops import paged_attention_cuda as pac
from mxnet_tpu_torch.ops.attention import (paged_attention,
                                           paged_attention_torch,
                                           resolve_paged_impl)

TOL = 2e-6      # the reference's own kernel-vs-jnp bar


def _case(rng, B=3, Hq=8, Hkv=2, Dh=32, bs=4, nb=16, W=6, ctx=(9, 0, 21)):
    """The reference test's padded-table case, as numpy: per-row context
    lengths (0 = dead slot), live blocks drawn without replacement,
    padding at the null block (id 0), whose contents are garbage."""
    q = rng.randn(B, Hq, Dh).astype(np.float32)
    kc = rng.randn(nb, bs, Hkv, Dh).astype(np.float32)
    vc = rng.randn(nb, bs, Hkv, Dh).astype(np.float32)
    bt = np.zeros((B, W), np.int32)
    ctx = np.asarray(ctx, np.int32)
    for b in range(B):
        nblk = -(-int(ctx[b]) // bs)
        bt[b, :nblk] = rng.choice(np.arange(1, nb), nblk, replace=False)
    return q, kc, vc, bt, ctx


W_CASE = 6      # _case's table width


def _int8(rng, args):
    """int8 K/V with per-slot-per-head float32 scales from float32 ones."""
    q, kc, vc, bt, ctx = args
    nb, bs, hkv, _ = kc.shape
    ksc = (rng.rand(nb, bs, hkv) * 0.02 + 0.005).astype(np.float32)
    vsc = (rng.rand(nb, bs, hkv) * 0.02 + 0.005).astype(np.float32)
    kq = np.clip(np.round(kc / ksc[..., None]), -127, 127).astype(np.int8)
    vq = np.clip(np.round(vc / vsc[..., None]), -127, 127).astype(np.int8)
    return (q, kq, vq, bt, ctx), {"k_scale": ksc, "v_scale": vsc}


def _ref():
    """The reference's paged attention and jax.numpy, imported on use so
    the card-only cases below also run where JAX is not installed
    (``pytest -m cuda --noconftest``)."""
    import jax.numpy as jnp
    from mxnet_tpu.ops.attention import paged_attention

    return paged_attention, jnp


def _both_ref(args, **kw):
    ref_paged, jnp = _ref()
    j = [jnp.asarray(a) for a in args]
    jkw = {k: jnp.asarray(v) for k, v in kw.items() if k.endswith("scale")}
    jkw.update({k: v for k, v in kw.items() if not k.endswith("scale")})
    return (np.asarray(ref_paged(*j, impl="jnp", **jkw)),
            np.asarray(ref_paged(*j, impl="pallas", **jkw)))


def _port(args, **kw):
    t = [torch.from_numpy(a) for a in args]
    tkw = {k: (torch.from_numpy(v) if k.endswith("scale") else v)
           for k, v in kw.items()}
    return paged_attention(*t, **tkw).numpy()


@pytest.mark.parametrize("hq,hkv,window", [
    (8, 2, 0),       # grouped-query, full attention
    (8, 2, 5),       # grouped-query, sliding window
    (4, 4, 0),       # MHA
    (4, 1, 3),       # multi-query + window
])
def test_plain_path_matches_reference_jnp_and_pallas(hq, hkv, window):
    args = _case(np.random.RandomState(0), Hq=hq, Hkv=hkv)
    jnp_out, pallas_out = _both_ref(args, window=window)
    out = _port(args, window=window)
    assert np.isfinite(out).all()
    assert np.abs(out - jnp_out).max() <= TOL
    assert np.abs(out - pallas_out).max() <= TOL


def test_plain_path_int8_scales_match_reference():
    rng = np.random.RandomState(1)
    q, kc, vc, bt, ctx = _case(rng)
    nb, bs, hkv, _ = kc.shape
    ksc = (rng.rand(nb, bs, hkv) * 0.02 + 0.005).astype(np.float32)
    vsc = (rng.rand(nb, bs, hkv) * 0.02 + 0.005).astype(np.float32)
    kq = np.clip(np.round(kc / ksc[..., None]), -127, 127).astype(np.int8)
    vq = np.clip(np.round(vc / vsc[..., None]), -127, 127).astype(np.int8)
    args = (q, kq, vq, bt, ctx)
    jnp_out, pallas_out = _both_ref(args, k_scale=ksc, v_scale=vsc)
    out = _port(args, k_scale=ksc, v_scale=vsc)
    assert np.abs(out - jnp_out).max() <= TOL
    assert np.abs(out - pallas_out).max() <= TOL


def test_empty_rows_return_zeros_and_garbage_null_block_is_masked():
    rng = np.random.RandomState(2)
    q, kc, vc, bt, ctx = _case(rng, ctx=(9, 0, 21))
    kc[0], vc[0] = 1e4, -1e4          # the null block holds garbage
    out = _port((q, kc, vc, bt, ctx))
    assert np.isfinite(out).all()
    assert np.abs(out[1]).max() == 0.0
    jnp_out, pallas_out = _both_ref((q, kc, vc, bt, ctx))
    assert np.abs(out - jnp_out).max() <= TOL
    # live rows equal a batch where the dead slot never existed
    sel = np.array([0, 2])
    live = _port((q[sel], kc, vc, bt[sel], ctx[sel]))
    assert np.array_equal(out[sel], live)


def test_padded_decode_row_reads_position_zero_of_the_null_block():
    """Padded decode rows are not empty rows: pos 0, so ctx 1 through an
    all-null table — both packages attend to the null block's slot 0."""
    rng = np.random.RandomState(5)
    q, kc, vc, bt, ctx = _case(rng, ctx=(9, 1, 21))
    bt[1] = 0
    jnp_out, pallas_out = _both_ref((q, kc, vc, bt, ctx))
    out = _port((q, kc, vc, bt, ctx))
    assert np.abs(out - jnp_out).max() <= TOL
    group = q.shape[1] // kc.shape[2]
    expect = np.repeat(vc[0, 0], group, axis=0)   # softmax over one slot
    assert np.abs(out[1] - expect).max() <= TOL


def test_bfloat16_plain_path_tracks_reference():
    """bf16 in both packages: scores and probabilities round to bf16 at
    the same cast points; the two libraries' bf16 matmuls may round
    differently, so the bound is bf16's (2^-7 relative at |out| <= 2)."""
    ref_paged, jnp = _ref()
    args = _case(np.random.RandomState(6))
    j = [jnp.asarray(a, jnp.bfloat16) if a.dtype == np.float32
         else jnp.asarray(a) for a in args]
    ref = np.asarray(ref_paged(*j, impl="jnp").astype(jnp.float32))
    t = [torch.from_numpy(a).to(torch.bfloat16) if a.dtype == np.float32
         else torch.from_numpy(a) for a in args]
    out = paged_attention(*t)
    assert out.dtype == torch.bfloat16
    assert np.abs(out.float().numpy() - ref).max() <= 3e-2


def test_validation_errors_and_impl_selection(monkeypatch):
    q, kc, vc, bt, ctx = [torch.from_numpy(a) for a in
                          _case(np.random.RandomState(3))]
    with pytest.raises(ValueError, match="impl"):
        paged_attention(q, kc, vc, bt, ctx, impl="pallas")
    with pytest.raises(ValueError, match="k_scale and v_scale"):
        paged_attention(q, kc, vc, bt, ctx, k_scale=torch.zeros(kc.shape[:-1]))
    with pytest.raises(ValueError, match="window"):
        paged_attention(q, kc, vc, bt, ctx, window=-1)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        paged_attention(q[:, :7], kc, vc, bt, ctx)
    # auto: CPU tensors take the plain path, CUDA ones the kernel
    assert resolve_paged_impl(4, 32, device="cpu") == "torch"
    assert resolve_paged_impl(16, 64, device="cuda") == "cuda"
    assert resolve_paged_impl(16, 64, "torch", device="cuda") == "torch"
    # a geometry outside the kernel raises on CUDA instead of retreating
    with pytest.raises(ValueError, match="impl='torch'"):
        resolve_paged_impl(2, 64, device="cuda")
    with pytest.raises(ValueError, match="impl='torch'"):
        resolve_paged_impl(16, 60, device="cuda")
    assert (port_attn.paged_eligible(16, 64), port_attn.paged_eligible(2, 64),
            port_attn.paged_eligible(16, 60)) == (True, False, False)
    monkeypatch.setenv("MXTPU_TORCH_PAGED_ATTENTION", "torch")
    assert resolve_paged_impl(16, 64, device="cuda") == "torch"
    monkeypatch.setenv("MXTPU_TORCH_PAGED_ATTENTION", "bogus")
    with pytest.raises(ValueError, match="impl"):
        paged_attention(q, kc, vc, bt, ctx)


def test_cuda_impl_on_cpu_tensors_raises_never_falls_back():
    args = [torch.from_numpy(a) for a in _case(np.random.RandomState(4))]
    before = pac.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        paged_attention(*args, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        pac.paged_attention_cuda(*args)
    assert pac.launches == before
    # the plain path itself runs anywhere and equals the dispatcher's
    assert torch.equal(paged_attention_torch(*args), paged_attention(*args))


# -- the CUDA kernel (needs the card) ----------------------------------------
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the Hopper kernel is compiled by nvcc "
                    "for sm_90a at first launch and has no CPU mode; "
                    "chip_smoke.py holds it against the plain path on "
                    "the card")


# kernel vs plain path on the card, as chip_smoke.py states them: float32
# math summed in another order (max-abs 1e-5); in bfloat16 the kernel
# computes in float32 and rounds once, so each output lies within
# 2^-8 of itself (round to nearest) of the plain path run in float32 on
# the same bf16 values, plus twice the float32 bound
F32_TOL = 1e-5
BF16_REL = 2.0 ** -8


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "int8", "bfloat16"])
@pytest.mark.parametrize("hq,hkv,window", [(8, 2, 0), (8, 2, 5), (4, 4, 0),
                                           (4, 1, 3), (12, 3, 0)])
def test_cuda_kernel_matches_plain_path(dtype, hq, hkv, window):
    _need_cuda()
    rng = np.random.RandomState(7)
    q, kc, vc, bt, ctx = _case(rng, Hq=hq, Hkv=hkv, ctx=(9, 0, 21))
    kw = {}
    if dtype == "int8":
        nb, bs, h, _ = kc.shape
        ksc = (rng.rand(nb, bs, h) * 0.02 + 0.005).astype(np.float32)
        vsc = (rng.rand(nb, bs, h) * 0.02 + 0.005).astype(np.float32)
        kc = np.clip(np.round(kc / ksc[..., None]), -127, 127).astype(np.int8)
        vc = np.clip(np.round(vc / vsc[..., None]), -127, 127).astype(np.int8)
        kw = {"k_scale": torch.from_numpy(ksc).cuda(),
              "v_scale": torch.from_numpy(vsc).cuda()}
    fdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    t = [torch.from_numpy(a).cuda() for a in (q, kc, vc, bt, ctx)]
    t[0] = t[0].to(fdt)
    if dtype == "bfloat16":
        t[1], t[2] = t[1].to(fdt), t[2].to(fdt)
    before = pac.launches
    out = paged_attention(*t, window=window, **kw)
    torch.cuda.synchronize()
    assert pac.launches == before + 1
    assert torch.isfinite(out).all()
    assert float(out[1].abs().max()) == 0.0
    if dtype == "bfloat16":
        ref32 = paged_attention_torch(*[a.float() for a in t[:3]], *t[3:],
                                      window=window)
        dev = (out.float() - ref32).abs()
        assert bool((dev <= BF16_REL * ref32.abs() + 2 * F32_TOL).all())
    else:
        ref = paged_attention_torch(*t, window=window, **kw)
        assert float((out - ref).abs().max()) <= F32_TOL


@pytest.mark.cuda
def test_cuda_kernel_rejects_what_it_does_not_take():
    _need_cuda()
    args = [torch.from_numpy(a).cuda() for a in
            _case(np.random.RandomState(8))]
    with pytest.raises(ValueError, match="int32"):
        pac.paged_attention_cuda(*args[:3], args[3].long(), args[4])
    with pytest.raises(ValueError, match="contiguous"):
        pac.paged_attention_cuda(args[0].transpose(0, 1).contiguous()
                                 .transpose(0, 1), *args[1:])
    with pytest.raises(ValueError, match="dtype"):
        pac.paged_attention_cuda(args[0].double(), *args[1:])
    # a geometry outside the kernel's limits (head_dim not a multiple of
    # 8) passes the wrapper and is refused by the C entry point
    odd = [torch.from_numpy(a).cuda() for a in
           _case(np.random.RandomState(8), Dh=12)]
    before = pac.launches
    with pytest.raises(RuntimeError, match="cudaError 1 "):
        pac.paged_attention_cuda(*odd)
    assert pac.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 2, 7, W_CASE])
@pytest.mark.parametrize("dtype", ["float32", "int8", "bfloat16"])
@pytest.mark.parametrize("hq,hkv,window", [(8, 2, 0), (8, 2, 5), (4, 4, 0),
                                           (4, 1, 3), (12, 3, 0)])
def test_cuda_kernels_match_plain_path_at_forced_splits(dtype, hq, hkv,
                                                        window, splits):
    """test_cuda_kernel_matches_plain_path's cases at forced split
    counts (7 > W leaves a split with nothing live), at the same bounds;
    every call counts once, and combines exactly when it splits."""
    _need_cuda()
    rng = np.random.RandomState(7)
    q, kc, vc, bt, ctx = _case(rng, Hq=hq, Hkv=hkv, ctx=(9, 0, 21))
    kw = {}
    if dtype == "int8":
        (q, kc, vc, bt, ctx), sc = _int8(rng, (q, kc, vc, bt, ctx))
        kw = {k: torch.from_numpy(v).cuda() for k, v in sc.items()}
    fdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    t = [torch.from_numpy(a).cuda() for a in (q, kc, vc, bt, ctx)]
    t[0] = t[0].to(fdt)
    if dtype == "bfloat16":
        t[1], t[2] = t[1].to(fdt), t[2].to(fdt)
    before = (pac.launches, pac.combine_launches)
    out = pac.paged_attention_cuda(*t, window=window, _splits=splits, **kw)
    torch.cuda.synchronize()
    assert pac.launches == before[0] + 1
    assert pac.combine_launches == before[1] + int(splits > 1)
    assert torch.isfinite(out).all()
    assert float(out[1].abs().max()) == 0.0
    if dtype == "bfloat16":
        ref32 = paged_attention_torch(*[a.float() for a in t[:3]], *t[3:],
                                      window=window)
        dev = (out.float() - ref32).abs()
        assert bool((dev <= BF16_REL * ref32.abs() + 2 * F32_TOL).all())
    else:
        ref = paged_attention_torch(*t, window=window, **kw)
        assert float((out - ref).abs().max()) <= F32_TOL


@pytest.mark.cuda
def test_cuda_plan_combines_exactly_when_it_splits():
    """The wrapper's own plan: a wide table splits and combines, a
    one-block table does neither; each call counts once."""
    _need_cuda()
    for W, ctx in ((128, (2048, 0, 1000)), (1, (3, 0, 4))):
        args = [torch.from_numpy(a).cuda() for a in _case(
            np.random.RandomState(16), bs=16, nb=400, W=W, ctx=ctx)]
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        splits, _ = pac._split_plan(3, 2, W, 16, sms)
        before = (pac.launches, pac.combine_launches)
        out = pac.paged_attention_cuda(*args)
        torch.cuda.synchronize()
        assert (splits > 1) == (W > 1)
        assert pac.launches == before[0] + 1
        assert pac.combine_launches == before[1] + int(splits > 1)
        ref = paged_attention_torch(*args)
        assert float((out - ref).abs().max()) <= F32_TOL
