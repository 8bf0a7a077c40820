"""The split and combine decomposition of the port's paged attention.

The Hopper paged-attention decode spreads each row's context over
``splits`` CTAs (each writing float32 partial softmax state) and merges
them in a combine kernel.  Here the decomposition's plain versions,
``paged_partials_torch`` then ``paged_combine_torch``, are held against
the port's plain path and the reference's jnp and Pallas (interpret)
paths at max-abs <= 2e-6 in float32, at several split counts, with
windows that cut through a split, int8 K/V with scales, dead and padded
rows.  ``_split_plan`` (shapes and the SM count only) is held to its
stated limits.

The kernels' own cases at forced split counts are
``test_torch_paged_attention.py``'s ``cuda``-marked tests.
"""

import inspect

import numpy as np
import pytest
import torch

import torch_port_fixtures  # noqa: F401  (puts the repo on sys.path)
from test_torch_paged_attention import TOL, W_CASE, _both_ref, _case, _int8

from mxnet_tpu_torch.ops import paged_attention_cuda as pac
from mxnet_tpu_torch.ops.attention import paged_attention_torch

def _compose(args, splits, **kw):
    """combine(partials) on numpy args, splits forced, bps as the
    wrapper derives it."""
    t = [torch.from_numpy(a) for a in args]
    tkw = {k: (torch.from_numpy(v) if k.endswith("scale") else v)
           for k, v in kw.items()}
    W = t[3].shape[1]
    parts = pac.paged_partials_torch(*t, splits, -(-W // splits), **tkw)
    return pac.paged_combine_torch(*parts, t[0].dtype).numpy(), parts


def _plain(args, **kw):
    t = [torch.from_numpy(a) for a in args]
    tkw = {k: (torch.from_numpy(v) if k.endswith("scale") else v)
           for k, v in kw.items()}
    return paged_attention_torch(*t, **tkw).numpy()


# -- the plan ----------------------------------------------------------------
@pytest.mark.parametrize("B,Hkv,W,bs,sms,expect", [
    (8, 3, 16, 16, 132, (4, 4)),        # the serve decode shape
    (8, 3, 128, 16, 132, (16, 8)),      # the serve config at ctx 2048
    (1, 3, 16, 16, 132, (4, 4)),        # the smallest decode bucket
    (1, 1, 1, 16, 132, (1, 1)),         # one row, one block
    (8, 3, 1, 16, 132, (1, 1)),         # one block
    (8, 3, 7, 16, 132, (1, 7)),         # fewer than two splits' worth
    (64, 8, 128, 16, 132, (1, 128)),    # B * Hkv fills the card
    (2, 1, 2048, 4, 132, None),         # long, small blocks
    (1, 1, 100000, 4, 132, None),       # wider than a CTA's table
])
def test_split_plan_covers_the_table_within_its_limits(B, Hkv, W, bs, sms,
                                                       expect):
    splits, bps = pac._split_plan(B, Hkv, W, bs, sms)
    assert splits * bps >= W and (splits - 1) * bps < W
    assert 1 <= bps <= pac.MAX_TABLE and 1 <= splits <= pac.MAX_SPLITS
    ctas = splits * B * Hkv
    assert ctas <= max(pac._CTAS_PER_SM * sms + B * Hkv,
                       B * Hkv * -(-W // pac.MAX_TABLE))
    if splits > 1:      # each split covers at least one ring slot
        assert bps * bs >= pac._MIN_SPLIT_ROWS
    if expect is not None:
        assert (splits, bps) == expect
    # deterministic: a function of its arguments alone
    assert pac._split_plan(B, Hkv, W, bs, sms) == (splits, bps)


def test_wrapper_never_reads_context_lens_on_the_host():
    src = inspect.getsource(pac.paged_attention_cuda)
    for host_read in (".item(", ".tolist(", ".cpu(", ".numpy(",
                      "context_lens.to(", "int(context_lens"):
        assert host_read not in src
    assert "_split_plan(" in src


# -- the decomposition against the reference ---------------------------------
@pytest.mark.parametrize("splits", [1, 2, 3, W_CASE])
@pytest.mark.parametrize("hq,hkv,window", [(8, 2, 0), (8, 2, 5), (4, 1, 3)])
def test_partials_then_combine_match_reference(splits, hq, hkv, window):
    """bs 4: window 5 and 3 cut through blocks and splits."""
    args = _case(np.random.RandomState(10), Hq=hq, Hkv=hkv)
    out, _ = _compose(args, splits, window=window)
    jnp_out, pallas_out = _both_ref(args, window=window)
    assert np.isfinite(out).all()
    assert np.abs(out - _plain(args, window=window)).max() <= TOL
    assert np.abs(out - jnp_out).max() <= TOL
    assert np.abs(out - pallas_out).max() <= TOL


@pytest.mark.parametrize("splits", [1, 2, 3, W_CASE])
def test_partials_then_combine_int8_scales_match_reference(splits):
    rng = np.random.RandomState(11)
    args, kw = _int8(rng, _case(rng))
    out, _ = _compose(args, splits, **kw)
    jnp_out, pallas_out = _both_ref(args, **kw)
    assert np.abs(out - _plain(args, **kw)).max() <= TOL
    assert np.abs(out - jnp_out).max() <= TOL
    assert np.abs(out - pallas_out).max() <= TOL


@pytest.mark.parametrize("splits", [1, 2, 3, W_CASE])
def test_partials_then_combine_dead_and_padded_rows(splits):
    """A dead row (ctx 0) and a padded row (ctx 1 through an all-null
    table, whose block 0 holds garbage) beside live rows."""
    rng = np.random.RandomState(12)
    q, kc, vc, bt, ctx = _case(rng, B=4, ctx=(9, 0, 1, 21))
    bt[2] = 0
    kc[0], vc[0] = 1e4, -1e4
    args = (q, kc, vc, bt, ctx)
    out, _ = _compose(args, splits)
    jnp_out, pallas_out = _both_ref(args)
    assert np.isfinite(out).all()
    assert np.abs(out[1]).max() == 0.0
    assert np.abs(out - _plain(args)).max() <= TOL
    assert np.abs(out - jnp_out).max() <= TOL
    assert np.abs(out - pallas_out).max() <= TOL


def test_row_whose_every_split_is_empty_gives_exact_zeros():
    rng = np.random.RandomState(13)
    args = _case(rng, ctx=(0, 0, 13))
    out, (acc, m, l) = _compose(args, 3)
    assert np.isfinite(out).all()
    assert (out[:2] == 0.0).all() and np.abs(out[2]).max() > 0
    assert bool((m[:2] == -1e30).all()) and bool((l[:2] == 0).all())
    assert bool((acc[:2] == 0).all())
    # splits beyond a live row's last block are empty too: ctx 13 fills
    # blocks 0..3 of 6
    _, (acc, m, l) = _compose(args, W_CASE)
    assert bool((l[2, :, 4:] == 0).all()) and bool((l[2, :, :4] > 0).all())
    assert bool((m[2, :, 4:] == -1e30).all())
    assert bool((acc[2, :, 4:] == 0).all())


def test_partials_window_band_leaves_splits_below_it_empty():
    """window 5 at ctx 21 keeps positions 16..20: the splits over
    blocks 0..3 hold nothing, those over blocks 4 and 5 all of it."""
    args = _case(np.random.RandomState(14), ctx=(21, 9, 21))
    _, (acc, m, l) = _compose(args, W_CASE, window=5)
    assert bool((l[0, :, :4] == 0).all()) and bool((l[0, :, 4:] > 0).all())
    assert bool((m[0, :, :4] == -1e30).all())


def test_partials_refuse_a_plan_that_does_not_cover_the_table():
    t = [torch.from_numpy(a) for a in _case(np.random.RandomState(15))]
    with pytest.raises(ValueError, match="do not cover"):
        pac.paged_partials_torch(*t, 2, 2)
