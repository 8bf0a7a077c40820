#!/usr/bin/env python3
"""The port's main paths on one NVIDIA GPU: build, check, serve, train,
time.

Run from the root of a checkout:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. set-up: the card's name and power limit (nvidia-smi); the three
     kernel libraries built by nvcc from mxnet_tpu_torch/csrc/, one nvcc
     per source, all started together (build seconds and the ptxas report
     printed), the flash checks' host draws and the profiler's first
     start done meanwhile;
  2. kernels against their plain torch versions on the card, each with
     its stated bound: paged attention (split kernel, plus the combine
     kernel where the plan splits) at the serving decode shape, at ctx
     2048, at a mixed long batch (ctx 0/1 padded/15/16/17/700/1999/2048)
     with and without a 300 window, and at ctx 2048 with the split count
     forced to 1 and to the table width, in bfloat16, float32 and
     int8+scales, each call counted once and combined exactly where it
     split; the paged bound shown to fail on the plain split and combine
     with one split's positions (512-639) dropped; the flash-attention
     forward, dQ and dK/dV kernels (o, lse, dq, dk, dv, with a non-zero
     dlse) in bfloat16 and float32 at the training shape, at the same shape
     with the main path's strides (q, k, v bhsd views of one fused QKV
     projection, dO a bhsd view of a bshd tensor) and at two contract
     shapes (bshd, 12 q / 3 kv heads, Sq != Sk, offsets with fully-masked
     rows, a 256 window; and without a mask).  bfloat16 is
     held element by element, scaled by each output, and the check is
     shown to fail on an output that skipped one tile; each check says
     which forward, dQ and dK/dV kernel ran (bf16: the tensor-core ones;
     float32: the others);
  3. serving: a full-width GPT (the repo's on-chip serve config, its
     depth cut from 12 layers to 4, random weights from a seed) served by
     serve.Engine through the paged kernels — 8 concurrent requests,
     prompts 16/32/64/128, 32 new tokens each — with its launches checked
     against layers x decode steps and its combine launches against the
     decode buckets' split plans;
     one full-width float32 decode step through the kernel and the plain
     path; a small model's tokens against the oracle and the CPU engine;
  4. training: bench.py's on-chip GPT (vocab 32768, S 1024, d_model 512,
     8 heads, fused QKV, batch 16, bf16, Adam 3e-4, Xavier; its depth cut
     from 8 layers to 2) trained by parallel.ShardedTrainer for 2 warm-up
     and 10 timed steps on bench.py's fixed synthetic batch, each flash
     kernel's launches checked against layers x steps (every forward, dQ
     and dK/dV on the tensor-core kernels, none on the others) and the NLL
     finite and falling; one
     full-width float32 step's gradients through the kernels against the
     dense attention, the check shown to fail on a planted fault; a small
     model's CUDA trainer against its CPU
     trainer over 3 Adam steps;
  5. RNN training: the fused-LSTM and fused-GRU forward and backward
     kernels against their plain versions (ys, hT, cT, the residuals,
     dgx, dWh, dbh, dh0, dc0, non-zero hT/cT cotangents) in float32 and
     bfloat16 at the language model's shape (T 128, N 32, H 512) and at
     contract shapes (H 200 with N 3, T 1, a reverse direction's flipped
     input), each bound stated and shown to fail on planted faults, each
     check saying which backward ran (bf16: the tensor-core one, also
     the other one held to the same bounds at the main shape; float32:
     the other one); the
     float32 kernels against cuDNN's nn.LSTM / nn.GRU; the RNN-op LM of
     examples/rnn_time_major.py (vocab 10,000, embedding and hidden 512,
     2 layers, T 128, N 32, bf16, Adam 0.01, Xavier) trained by
     ShardedTrainer for 2 + 10 steps as an LSTM and 2 + 5 as a GRU, each
     kernel's launches checked against 2 x steps (every backward on the
     tensor-core kernel, none on the other) and the NLL finite and
     falling; one full-width float32 step's gradients through the kernels
     against the eager scan, shown to fail on a planted fault; a small
     LSTM LM's CUDA trainer against its CPU trainer over 3 Adam steps;
  6. timings with CUDA events (warm-up excluded, L2 flushed before each
     launch, medians): each kernel, its plain version, a PyTorch
     yardstick (SDPA; cuDNN's nn.LSTM / nn.GRU) and the bound computed
     from this run's shapes (paged: with its split plan and CTAs, at the
     decode, ctx 2048 and mixed shapes, plus bf16 sweeps of forced split
     counts, from which the plan's constants were chosen, the two
     paged kernels' ptxas registers and spills, and the launch floor:
     one and two back-to-back one-element kernels), for the flash forward,
     dQ and dK/dV the other
     (float32-FMA) kernel at the same bf16 shape and the tensor-core
     kernel's ptxas registers and spills, and for the RNN kernels the
     barrier floor (an
     empty cooperative kernel of T grid barriers), and for the RNN
     backward the other kernel at the same bf16 inputs, the tensor-core
     kernel's cluster size, units a CTA, ptxas registers and spills and
     the floor of its split barrier (T arrive/wait pairs alone).

Prints JSON lines, then the card's name and power limit, then the
``kernels`` line, and last ``{"ok": true, "device": {...}}``.  Exits
non-zero without a result when CUDA is unavailable or the package is
missing.  The full report is also written to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time

_T_LAUNCH = time.perf_counter()   # before numpy, torch and the package load
ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

PEAK_BYTES_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_OPS_S = {torch.bfloat16: 989e12, torch.float32: 67e12,
              torch.int8: 1979e12}
# the repo's on-chip serve config (tools/serve_bench.py) at its full width,
# its depth cut from 12 layers to 4 to keep the script's time
SERVE_CFG = dict(vocab=50304, num_layers=4, d_model=768, num_heads=12,
                 kv_heads=3, mlp="swiglu", norm="rmsnorm", pos_embed="rope",
                 tie_embeddings=True)
# stated kernel-vs-plain bounds:
#  float32 / int8 with float32 q: max |kernel - plain| <= F32_BOUND.  The
#    same float32 math summed in another order over <= 2048 positions
#    (plus expf vs torch.exp), ~1e-7 per op: 1e-5 is loose, yet a block
#    dropped or mis-weighted moves outputs by ~1e-3 or more.
#  bfloat16: the kernel reads the bf16 values, computes in float32 and
#    rounds once, to nearest, at the end (|error| <= 2^-8 |x|).  So it is
#    held element by element against the plain path run in float32 on
#    the same values (the upcast is exact):
#        |kernel - plain32| <= 2^-8 |plain32| + 2 * F32_BOUND.
#    The bound scales with each output, so it is as tight at ctx 2048
#    (outputs ~0.03) as at ctx 1 (outputs ~1).  max |kernel - plain| with
#    the plain path in bf16 (which also rounds scores and probabilities)
#    is reported beside it; it obeys the triangle bound
#    2^-8 |plain32| + 2 * F32_BOUND + |plain32 - plain_bf16|, implied.
F32_BOUND = 1e-5
BF16_REL = 2.0 ** -8
# full-width float32 decode-step logits, kernel vs plain attention
# inside the engine: 1e-6-scale attention differences carried through 12
# residual layers and the 768-wide tied head
LOGITS_BOUND = 5e-4
REPORT = {}
DEVICE = "cuda"
PHASE_SECONDS = {}     # seconds of each phase, in the order they ran
_LAP = [None]


def lap(phase):
    """Record the seconds since the previous lap under ``phase``."""
    now = time.perf_counter()
    if _LAP[0] is not None:
        PHASE_SECONDS[phase] = now - _LAP[0]
    _LAP[0] = now


def emit(obj):
    print(json.dumps(obj), flush=True)
    REPORT.setdefault("lines", []).append(obj)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


# -- phase 2: kernel vs plain -----------------------------------------------
def paged_case(ctx, dtype, nb=None, bs=16, Hq=12, Hkv=3, Dh=64, W=None,
               padded=(), seed=0):
    """A decode batch against a random cache: per-row context lengths
    (0 = dead slot), rows in ``padded`` keep an all-null table (a padded
    decode row: pos 0, ctx 1), live blocks drawn without replacement
    from 1..nb-1, and a null block 0 full of large finite garbage (the
    kernel must mask it by position, not by block id)."""
    g = torch.Generator().manual_seed(seed)
    B = len(ctx)
    need = [0 if b in padded else -(-c // bs) for b, c in enumerate(ctx)]
    W = W or max(max(need), 1)
    nb = nb or sum(need) + 1
    quant = dtype == "int8"
    qdt = torch.float32 if dtype in ("float32", "int8") else torch.bfloat16
    q = torch.randn(B, Hq, Dh, generator=g).to(qdt)
    if quant:
        kc = torch.randint(-127, 128, (nb, bs, Hkv, Dh), generator=g,
                           dtype=torch.int8)
        vc = torch.randint(-127, 128, (nb, bs, Hkv, Dh), generator=g,
                           dtype=torch.int8)
        ksc = torch.rand(nb, bs, Hkv, generator=g) * 0.02 + 0.005
        vsc = torch.rand(nb, bs, Hkv, generator=g) * 0.02 + 0.005
    else:
        kc = torch.randn(nb, bs, Hkv, Dh, generator=g).to(qdt)
        vc = torch.randn(nb, bs, Hkv, Dh, generator=g).to(qdt)
        kc[0] = 100.0
        vc[0] = -100.0
        ksc = vsc = None
    perm = torch.randperm(nb - 1, generator=g) + 1
    bt = torch.zeros(B, W, dtype=torch.int32)
    used = 0
    for b, n in enumerate(need):
        bt[b, :n] = perm[used:used + n].to(torch.int32)
        used += n
    dev = torch.device(DEVICE)
    args = [q, kc, vc, bt, torch.tensor(ctx, dtype=torch.int32)]
    args = [a.to(dev) for a in args]
    kw = {}
    if quant:
        kw = {"k_scale": ksc.to(dev), "v_scale": vsc.to(dev)}
    return args, kw


def live_bytes(args, kw):
    q, kc, _, bt, ctx = args
    B, Hq, Dh = q.shape
    _, bs, Hkv, _ = kc.shape
    tokens = int(ctx.sum())
    per_tok = 2 * Hkv * Dh * kc.element_size()
    if kw:
        per_tok += 2 * Hkv * 4
    live_blocks = int(sum(-(-int(c) // bs) for c in ctx.tolist()))
    return (tokens * per_tok + 2 * q.numel() * q.element_size()
            + live_blocks * 4 + ctx.numel() * 4), tokens


def bound_ms(args, kw):
    q, kc = args[0], args[1]
    nbytes, tokens = live_bytes(args, kw)
    Hq, Dh = q.shape[1], q.shape[2]
    ops = 4 * Dh * Hq * tokens            # QK^T and PV multiply-adds
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = ops / PEAK_OPS_S[kc.dtype if kw else q.dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def paged_bound_row(out, args, kw, dtype):
    """Hold ``out`` against the plain path at the stated bound; returns
    (within, row fields)."""
    from mxnet_tpu_torch.ops.attention import paged_attention_torch

    ref = paged_attention_torch(*args, **kw)
    err = float((out.float() - ref.float()).abs().max())
    row = {"max_abs_err": err}
    if dtype == "bfloat16":
        ref32 = paged_attention_torch(*[a.float() if a.is_floating_point()
                                        else a for a in args], **kw)
        dev = (out.float() - ref32).abs()
        allowed = BF16_REL * ref32.abs() + 2 * F32_BOUND
        within = bool((dev <= allowed).all())
        row.update({"max_abs_err_vs_plain_f32": float(dev.max()),
                    "bound": "2^-8 |plain32| + 2e-5 per element",
                    "max_ref_abs": float(ref32.abs().max()),
                    "worst_share_of_bound": float((dev / allowed).max())})
    else:
        within = err <= F32_BOUND
        row["bound"] = F32_BOUND
    return within, row


def paged_plan(args, splits=None):
    """(splits, blocks_per_split, CTAs) the wrapper launches for these
    inputs: its own plan, or ``splits`` forced."""
    from mxnet_tpu_torch.ops import paged_attention_cuda as pac

    q, kc, bt = args[0], args[1], args[3]
    B, W, bs, Hkv = q.shape[0], bt.shape[1], kc.shape[1], kc.shape[2]
    if splits is None:
        splits, bps = pac._split_plan(
            B, Hkv, W, bs,
            torch.cuda.get_device_properties(q.device).multi_processor_count)
    else:
        bps = -(-W // splits)
    return {"splits": splits, "blocks_per_split": bps,
            "ctas": splits * B * Hkv}


def check_kernel(tag, ctx, dtype, splits=None, window=0, **shape):
    from mxnet_tpu_torch.ops import paged_attention_cuda as pac

    args, kw = paged_case(ctx, dtype, **shape)
    if window:
        kw["window"] = window
    before = (pac.launches, pac.combine_launches)
    out = pac.paged_attention_cuda(*args, _splits=splits, **kw)
    torch.cuda.synchronize()
    plan = paged_plan(args, splits)
    # one op call, one combine exactly where it split
    counted = (pac.launches - before[0] == 1
               and pac.combine_launches - before[1]
               == int(plan["splits"] > 1))
    pac.launches, pac.combine_launches = before   # checks are not the path
    within, fields = paged_bound_row(out, args, kw, dtype)
    row = {"phase": "kernel_check", "shape": tag, "dtype": dtype,
           "window": window, "forced_splits": splits, **plan, **fields}
    finite = bool(torch.isfinite(out).all())
    empty = [b for b, c in enumerate(ctx) if c == 0]
    zeros = all(float(out[b].abs().max()) == 0.0 for b in empty)
    ok = finite and zeros and within and counted
    row.update({"finite": finite, "empty_rows_zero": zeros,
                "counted": counted, "ok": ok})
    emit(row)
    if not ok:
        raise SystemExit(f"kernel disagrees with plain path: {tag} {dtype}")
    return fields["max_abs_err"]


def dropped_split_check(ctx, drop=(512, 640)):
    """The bound binds: the plain split and combine with one split's
    positions (``drop``) left out must fail it, in bf16 and float32,
    while the same composition with nothing left out passes."""
    from mxnet_tpu_torch.ops import paged_attention_cuda as pac

    for dtype in ("bfloat16", "float32"):
        args, kw = paged_case(ctx, dtype)
        bs, W = args[1].shape[1], args[3].shape[1]
        bps = (drop[1] - drop[0]) // bs
        splits, s = -(-W // bps), drop[0] // (bps * bs)
        acc, m, l = pac.paged_partials_torch(*args, splits, bps, **kw)
        whole, _ = paged_bound_row(
            pac.paged_combine_torch(acc, m, l, args[0].dtype), args, kw,
            dtype)
        acc[:, :, s], m[:, :, s], l[:, :, s] = 0.0, -1e30, 0.0
        within, fields = paged_bound_row(
            pac.paged_combine_torch(acc, m, l, args[0].dtype), args, kw,
            dtype)
        ok = whole and not within
        emit({"phase": "dropped_split_check", "dtype": dtype,
              "dropped_positions": list(drop), "splits": splits,
              "blocks_per_split": bps, "plain_split_within": whole,
              "dropped_split_caught": not within, **fields, "ok": ok})
        if not ok:
            raise SystemExit(f"paged bound does not bind: {dtype}")


# -- timing -----------------------------------------------------------------
_FLUSH = None


def time_ms(fn, reps=30, warmup=5):
    """Median device ms of one call, L2 flushed before each call.  The
    flush writes 2 GiB (~0.6 ms of device time), so the host has enqueued
    the call before the device reaches the start event: the interval
    holds the device work, not the host's launch path."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(2 << 30, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        _FLUSH.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def sdpa_yardstick(args, kw):
    """One library call computing the same function: SDPA over the
    pre-gathered dense K/V with the same mask (the gather is excluded
    from the timing, and said so)."""
    q, kc, vc, bt, ctx = args
    B, Hq, Dh = q.shape
    _, bs, Hkv, _ = kc.shape
    S = bt.shape[1] * bs
    tables = bt.long()
    k = kc[tables].reshape(B, S, Hkv, Dh).transpose(1, 2)
    v = vc[tables].reshape(B, S, Hkv, Dh).transpose(1, 2)
    if kw:
        ks = kw["k_scale"][tables].reshape(B, S, Hkv).transpose(1, 2)
        vs = kw["v_scale"][tables].reshape(B, S, Hkv).transpose(1, 2)
        k = (k.float() * ks[..., None]).to(q.dtype)
        v = (v.float() * vs[..., None]).to(q.dtype)
    # grouped-query heads expanded to one K/V head per q head
    k = k.repeat_interleave(Hq // Hkv, dim=1).contiguous()
    v = v.repeat_interleave(Hq // Hkv, dim=1).contiguous()
    mask = (torch.arange(S, device=q.device)[None, :]
            < ctx.long()[:, None])[:, None, None, :]
    qq = q[:, :, None, :]
    F = torch.nn.functional

    def call():
        return F.scaled_dot_product_attention(qq, k, v, attn_mask=mask)
    return call


def time_kernel(tag, ctx, dtype, **shape):
    from mxnet_tpu_torch.ops import paged_attention_cuda as pac
    from mxnet_tpu_torch.ops.attention import paged_attention_torch

    args, kw = paged_case(ctx, dtype, **shape)
    saved = (pac.launches, pac.combine_launches)
    k_ms = time_ms(lambda: pac.paged_attention_cuda(*args, **kw))
    pac.launches, pac.combine_launches = saved   # not the path's launches
    p_ms = time_ms(lambda: paged_attention_torch(*args, **kw))
    lib_ms = time_ms(sdpa_yardstick(args, kw))
    b_ms, b_by = bound_ms(args, kw)
    nbytes, tokens = live_bytes(args, kw)
    row = {"phase": "kernel_time", "shape": tag, "dtype": dtype,
           "ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
           "library": "F.scaled_dot_product_attention over pre-gathered "
                      "dense K/V (gather excluded)",
           "bound_ms": b_ms, "bound_by": b_by, "live_bytes": nbytes,
           "live_tokens": tokens, "bound_share": b_ms / k_ms,
           **paged_plan(args)}
    emit(row)
    return row


def launch_floor():
    """ms of one and of two back-to-back one-element kernels under
    time_ms: the floor of a call of one launch and of one of two (the
    split kernel and the combine)."""
    tiny = torch.zeros(1, device=DEVICE)
    row = {"phase": "launch_floor",
           "one_kernel_ms": time_ms(lambda: tiny.add_(1)),
           "two_kernels_ms": time_ms(lambda: (tiny.add_(1), tiny.add_(1)))}
    emit(row)
    return row


def paged_split_sweep(tag, ctx, split_counts, **shape):
    """bf16 kernel ms at forced split counts (the plan's constants are
    chosen from these lines), beside the plan's own choice."""
    from mxnet_tpu_torch.ops import paged_attention_cuda as pac

    args, kw = paged_case(ctx, "bfloat16", **shape)
    saved = (pac.launches, pac.combine_launches)
    ms = {n: time_ms(lambda: pac.paged_attention_cuda(*args, _splits=n,
                                                      **kw))
          for n in split_counts}
    pac.launches, pac.combine_launches = saved
    row = {"phase": "paged_split_sweep", "shape": tag, "dtype": "bfloat16",
           "ms_by_splits": {str(n): t for n, t in ms.items()},
           "plan": paged_plan(args)}
    emit(row)
    return row


# -- phase 3: serving ---------------------------------------------------------
def serve_prompts(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, SERVE_CFG["vocab"], (n,)).astype(np.int32)
            for n in (16, 32, 64, 128, 16, 32, 64, 128)]


def serve_params(seed=0):
    """The serving model's random weights, drawn on the card from a seed
    (a host draw of ~67M values would take seconds): gpt()'s argument
    names and shapes with gpt_params' scales (weights N(0, 0.02^2),
    biases and norm shifts 0, norm gains 1), float32."""
    from mxnet_tpu_torch.models import gpt_arguments

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    params = {}
    for arg, shp in gpt_arguments(SERVE_CFG["vocab"], 256,
                                  **{k: v for k, v in SERVE_CFG.items()
                                     if k != "vocab"}):
        s = 0.02 if arg.endswith("weight") else 0.0
        params[arg] = (torch.randn(shp, generator=g, device=DEVICE) * s
                       + (1.0 if arg.endswith("gamma") else 0.0))
    return params


def full_width_engine(np_params, dtype):
    from mxnet_tpu_torch import serve

    return serve.Engine(np_params, num_heads=SERVE_CFG["num_heads"],
                        window=0, device=DEVICE, dtype=dtype, block_size=16,
                        num_blocks=512, max_batch=8, max_model_len=256)


def serve_main_path(np_params):
    from mxnet_tpu_torch.ops import paged_attention_cuda as pac

    # warm-up on a separate engine: cuBLAS handles, allocator, kernel
    warm = full_width_engine(np_params, torch.bfloat16)
    for p in serve_prompts(1)[:2]:
        warm.submit(p, max_new_tokens=4)
    warm.run()
    warm.shutdown()

    eng = full_width_engine(np_params, torch.bfloat16)
    if eng.paged_impl != "cuda":
        raise SystemExit(f"engine resolved paged_impl={eng.paged_impl}")
    prompts = serve_prompts(0)
    torch.cuda.synchronize()
    pac.launches = pac.combine_launches = 0   # the main path's window opens
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=32) for p in prompts]
    decode_ms = []
    while eng.has_work():
        decode_only = (eng.scheduler.queue_depth == 0
                       and bool(eng.scheduler.running))
        ts = time.perf_counter()
        eng.step()
        if decode_only:
            decode_ms.append(1e3 * (time.perf_counter() - ts))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pac.launches           # ... and closes
    combines = pac.combine_launches
    n_layers = SERVE_CFG["num_layers"]
    toks = [r.tokens for r in reqs]
    # the decode batch buckets' plans (shapes only): every bucket splits
    # its 16-block tables, so every call launches the combine kernel too
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = {b: pac._split_plan(b, SERVE_CFG["kv_heads"], eng.table_width,
                                eng.block_size, sms)
             for b in (1, 2, 4, 8)}
    ok = (all(r.status == "finished" and len(r.tokens) == 32 for r in reqs)
          and all(0 <= t < SERVE_CFG["vocab"] for ts in toks for t in ts)
          and launches == n_layers * eng.decode_steps
          and eng.decode_steps > 0
          and all(n > 1 for n, _ in plans.values())
          and combines == launches)
    st = eng.stats()
    row = {"phase": "serve", "dtype": "bfloat16", "requests": len(reqs),
           "new_tokens": 32, "prompt_lens": [len(p) for p in prompts],
           "decode_steps": eng.decode_steps, "kernel_launches": launches,
           "combine_launches": combines,
           "split_plans": {str(b): list(p) for b, p in plans.items()},
           "launches_per_decode_step": launches / max(1, eng.decode_steps),
           "tokens_generated": st.tokens_generated, "wall_s": wall,
           "tok_per_s": st.tokens_generated / wall,
           "decode_only_steps": len(decode_ms),
           "decode_step_ms_mean": (statistics.mean(decode_ms)
                                   if decode_ms else None),
           "decode_step_ms_median": (statistics.median(decode_ms)
                                     if decode_ms else None),
           "preemptions": st.preemptions, "ok": ok}
    emit(row)
    eng.shutdown()
    if not ok:
        raise SystemExit("full-width serve failed its checks")
    return row


def logits_check(np_params):
    """One full-width float32 decode step, kernel vs plain attention
    inside the engine, on the same cache and inputs."""
    from mxnet_tpu_torch.serve import engine as engine_mod

    eng = full_width_engine(np_params, torch.float32)
    for p in serve_prompts(2):
        eng.submit(p, max_new_tokens=32)
    for _ in range(12):               # 8 prefills, then decode steps
        eng.step()
    reqs = list(eng.scheduler.running)
    B = len(reqs)
    toks = np.zeros(B, np.int32)
    pos = np.zeros(B, np.int32)
    tables = np.zeros((B, eng.table_width), np.int32)
    for i, r in enumerate(reqs):
        eng.blocks.ensure_capacity(r.rid, r.cache_len + 1)
        toks[i], pos[i] = r.tokens[-1], r.cache_len
        t = eng.blocks.table(r.rid)
        tables[i, :len(t)] = t
    outs = {}
    with torch.no_grad():
        for impl in ("cuda", "torch"):
            cfg = eng._cfg._replace(paged_impl=impl)
            outs[impl] = engine_mod._forward_token_batch(
                cfg, eng.params, eng._cache_k.clone(), eng._cache_v.clone(),
                eng._tensor(toks), eng._tensor(pos), eng._tensor(tables))
    err = float((outs["cuda"] - outs["torch"]).abs().max())
    same = bool((outs["cuda"].argmax(-1) == outs["torch"].argmax(-1)).all())
    ok = err <= LOGITS_BOUND and bool(torch.isfinite(outs["cuda"]).all())
    emit({"phase": "logits_check", "dtype": "float32", "batch": B,
          "max_abs_err": err, "bound": LOGITS_BOUND,
          "argmax_equal": same, "ok": ok})
    eng.shutdown()
    if not ok:
        raise SystemExit("engine decode step: kernel vs plain disagree")


def small_model_check():
    """A small seeded model (the reference's serve-test shapes, rope +
    GQA + SwiGLU + RMSNorm + tied): the CUDA engine's greedy tokens must
    equal the single-request oracle's on the card and the CPU engine's."""
    from mxnet_tpu_torch import models, serve

    params = models.gpt_params(53, 96, num_layers=2, d_model=32,
                               num_heads=4, kv_heads=2, mlp="swiglu",
                               norm="rmsnorm", pos_embed="rope",
                               tie_embeddings=True, seed=3, scale=0.35)
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, 53, (rng.randint(6, 22),)).astype(np.int32)
               for _ in range(4)]
    got = {}
    for dev in (DEVICE, "cpu"):
        eng = serve.Engine(params, num_heads=4, window=0, device=dev,
                           block_size=4, num_blocks=64, max_batch=4,
                           max_model_len=64, max_prefills_per_step=2)
        reqs = [eng.submit(p, max_new_tokens=16) for p in prompts]
        eng.run()
        got[dev] = [r.tokens for r in reqs]
    oracle = [models.gpt_generate(params, p[None], 16, num_heads=4,
                                  window=0, device=DEVICE)[0, p.size:]
              .tolist() for p in prompts]
    ok = got[DEVICE] == got["cpu"] == oracle
    emit({"phase": "small_model_check", "cuda_eq_cpu":
          got[DEVICE] == got["cpu"], "cuda_eq_oracle": got[DEVICE] == oracle,
          "ok": ok})
    if not ok:
        raise SystemExit("small-model tokens disagree")


# -- training: flash-attention kernels vs their plain versions ---------------
# the training model: bench.py's on-chip GPT (BENCH_MODEL=gpt) at its full
# width, its depth cut from 8 layers to 2 to keep the script's time
TRAIN_CFG = dict(vocab=32768, seq_len=1024, num_layers=2, d_model=512,
                 num_heads=8, fused_qkv=True, attn_layout="bhsd",
                 loss="softmax")
TRAIN_BATCH = 16
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
# the attention shape of one layer of that model, contiguous and with the
# strides the model gives the kernels ("fused": q, k, v are bhsd views of
# one (B, S, 3 d_model) projection, rows 3 d_model apart, and dO is a
# bhsd view of a bshd tensor), and two contract shapes: bshd with
# grouped-query heads (12 q / 3 kv), ragged lengths Sq != Sk, offsets
# that leave the first 36 q rows fully masked and a 256 window; then the
# same without a mask
FLASH_SHAPES = {
    "train": dict(layout="bhsd", B=16, Hq=8, Hkv=8, Sq=1024, Sk=1024, D=64,
                  causal=True, window=0, q_offset=0, k_offset=0),
    "train_fused": dict(layout="bhsd", B=16, Hq=8, Hkv=8, Sq=1024, Sk=1024,
                        D=64, causal=True, window=0, q_offset=0, k_offset=0,
                        fused=True),
    "contract_window": dict(layout="bshd", B=2, Hq=12, Hkv=3, Sq=300,
                            Sk=450, D=64, causal=True, window=256,
                            q_offset=64, k_offset=100),
    "contract_full": dict(layout="bshd", B=2, Hq=12, Hkv=3, Sq=300, Sk=450,
                          D=64, causal=False, window=0, q_offset=0,
                          k_offset=0),
}
# stated flash kernel-vs-plain bounds, element by element, against the
# plain versions run in float32 on the same (bf16 or f32) values, each
# output X beside A, the sum of the magnitudes of the terms X adds up
# (o: P|V|; dq: |dS||K|; dk: |dS|^T|Q|; dv: P^T|dO|, in float32):
#   float32:  |kernel - plain32| <= F32_REL A + F32_ABS.  The same products
#     summed in another order over <= 1024 terms (~sqrt(1024) 6e-8 A) and
#     expf against torch.exp: 1e-5 A is a 5x margin.
#   bfloat16: |kernel - plain32| <= 2^-8 |plain32| + 2^-8 A + F32_REL A
#     + F32_ABS.  The kernel rounds p (or ds) to bf16 before the product,
#     each term off by at most 2^-8 of itself (2^-8 A in all), and rounds
#     the float32 result once at the end (2^-8 |X|).
#   lse (both): |kernel - plain32| <= F32_REL (1 + |lse|); fully-masked
#     rows exactly -1e30 in both.
# The bound scales with each output, and the check is shown to bind: the
# train-shape bf16 check is run again on the plain output with one k
# tile dropped (forward, dQ) or one q tile dropped (dK/dV), and must fail.
F32_REL, F32_ABS = 1e-5, 1e-6
# full-width float32 step: each parameter's gradient through the kernels
# vs through the dense (impl="xla") attention, max |diff| <= GRAD_REL
# max |grad|.  The float32 kernels differ from the plain versions by
# summation order alone (held per element above, at the main path's
# strides too); carried back through the layers and the softmax head that
# measured 1.9e-6 of max |grad| on an H100 at 8 layers, so 2e-5 leaves a
# 10x margin.
# The check is shown to bind: the same step with a planted fault, a
# forward kernel that stores o through bfloat16 in float32 mode (2^-9
# relative, the size of a float32 path that rounds like the bf16 one),
# must fail it.
GRAD_REL = 2e-5


_FLASH_DRAWS = {}


def flash_draws(shape, seed=0):
    """The float32 host draws of one flash case, drawn once per (shape,
    seed) and shared by its dtypes (they are cast on the way to the
    card): q, k, v, dO (or the fused QKV projection and dO) and dlse."""
    key = (tuple(sorted(shape.items())), seed)
    if key not in _FLASH_DRAWS:
        g = torch.Generator().manual_seed(seed)
        B, Hq, Hkv, Sq, Sk, D = (shape[k] for k in ("B", "Hq", "Hkv", "Sq",
                                                    "Sk", "D"))
        if shape["layout"] == "bhsd":
            qs, ks = (B, Hq, Sq, D), (B, Hkv, Sk, D)
        else:
            qs, ks = (B, Sq, Hq, D), (B, Sk, Hkv, D)
        if shape.get("fused"):
            sizes = [(B, Sq, (Hq + 2 * Hkv) * D), (B, Sq, Hq, D)]
        else:
            sizes = [qs, ks, ks, qs]
        _FLASH_DRAWS[key] = [torch.randn(s, generator=g)
                             for s in sizes + [(B, Hq, Sq)]]
    return _FLASH_DRAWS[key]


def flash_case(shape, dtype, seed=0):
    B, Hq, Hkv, Sq, Sk, D = (shape[k] for k in ("B", "Hq", "Hkv", "Sq",
                                                "Sk", "D"))
    dev = torch.device(DEVICE)
    *draws, dlse = flash_draws(shape, seed)
    if shape.get("fused"):
        # the model's operands: slices of one fused QKV projection (bhsd,
        # Sq == Sk) and dO as the gradient of attn.transpose(1, 2)
        dq_, dkv = Hq * D, Hkv * D
        qkv = draws[0].to(dev, dtype)
        q = qkv[..., :dq_].view(B, Sq, Hq, D).transpose(1, 2)
        k = qkv[..., dq_:dq_ + dkv].view(B, Sk, Hkv, D).transpose(1, 2)
        v = qkv[..., dq_ + dkv:].view(B, Sk, Hkv, D).transpose(1, 2)
        do = draws[1].to(dev, dtype).transpose(1, 2)
    else:
        q, k, v, do = (x.to(dev, dtype) for x in draws)
    dlse = dlse.to(dev)
    kw = {k: shape[k] for k in ("causal", "window", "q_offset", "k_offset",
                                "layout")}
    return (q, k, v, do, dlse), kw


def flash_through_autograd(q, k, v, do, dlse, kw):
    """(o, lse, dq, dk, dv) through flash_attention's autograd Function,
    as the model runs it (kernels on CUDA tensors)."""
    from mxnet_tpu_torch.ops.flash_attention import flash_attention

    qkv = [t.detach().requires_grad_() for t in (q, k, v)]
    o, lse = flash_attention(*qkv, return_lse=True, **kw)
    dq, dk, dv = torch.autograd.grad((o, lse), qkv, (do, dlse))
    return o.detach(), lse.detach(), dq, dk, dv


def _bhsd(x, layout):
    return x if layout == "bhsd" else x.transpose(1, 2)


def magnitude_terms(q, k, v, o, lse, do, dlse, kw, drop_k=None,
                    drop_q=None):
    """Float32 A-terms of each output (see the bounds above), and, with
    ``drop_k``/``drop_q`` (a 64-row tile index), the outputs of a kernel
    that skipped that k tile (forward, dQ) or q tile (dK/dV)."""
    from mxnet_tpu_torch.ops.flash_attention import NEG_INF, _keep

    lay = kw["layout"]
    qh, kh, vh, oh, doh = (_bhsd(t, lay).float() for t in (q, k, v, o, do))
    B, H, Sq, D = qh.shape
    Hkv, Sk = kh.shape[1], kh.shape[2]
    grp = H // Hkv
    kh, vh = (t.repeat_interleave(grp, dim=1) for t in (kh, vh))
    keep = _keep(Sq, Sk, kw["causal"], kw["q_offset"], kw["k_offset"],
                 kw["window"], qh.device)
    if keep is None:
        keep = torch.ones(Sq, Sk, dtype=torch.bool, device=qh.device)
    scale = 1.0 / D ** 0.5
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    p = torch.exp(s.masked_fill(~keep, NEG_INF) - lse[..., None])
    p = p.masked_fill(~keep, 0.0)
    delta = (doh * oh).sum(-1)
    ds = p * (torch.matmul(doh, vh.transpose(-1, -2)) - delta[..., None]
              + dlse[..., None]) * scale

    def group_sum(x):
        return x.reshape(B, Hkv, grp, Sk, D).sum(2)

    def out(x):
        return _bhsd(x, lay)

    if drop_k is not None or drop_q is not None:
        res = {}
        if drop_k is not None:
            cols = torch.zeros(Sk, dtype=torch.bool, device=qh.device)
            cols[64 * drop_k:64 * (drop_k + 1)] = True
            keep_m = keep & ~cols[None, :]
            sm = s.masked_fill(~keep_m, NEG_INF)
            pm = torch.exp(sm - sm.amax(-1, keepdim=True)).masked_fill(
                ~keep_m, 0.0)
            lm = pm.sum(-1, keepdim=True).clamp_min(1e-30)
            res["o"] = out(torch.matmul(pm / lm, vh))
            res["dq"] = out(torch.matmul(ds.masked_fill(cols, 0.0), kh))
        if drop_q is not None:
            rows = torch.zeros(Sq, dtype=torch.bool, device=qh.device)
            rows[64 * drop_q:64 * (drop_q + 1)] = True
            dsm = ds.masked_fill(rows[:, None], 0.0)
            pmq = p.masked_fill(rows[:, None], 0.0)
            res["dk"] = out(group_sum(torch.matmul(dsm.transpose(-1, -2),
                                                   qh)))
            res["dv"] = out(group_sum(torch.matmul(pmq.transpose(-1, -2),
                                                   doh)))
        return res
    return {"o": out(torch.matmul(p, vh.abs())),
            "dq": out(torch.matmul(ds.abs(), kh.abs())),
            "dk": out(group_sum(torch.matmul(ds.abs().transpose(-1, -2),
                                             qh.abs()))),
            "dv": out(group_sum(torch.matmul(p.transpose(-1, -2),
                                             doh.abs())))}


def within_bound(got, ref32, A, dtype):
    dev = (got.float() - ref32).abs()
    allowed = F32_REL * A + F32_ABS
    if dtype == torch.bfloat16:
        allowed = allowed + BF16_REL * (ref32.abs() + A)
    return bool((dev <= allowed).all()), float((dev / allowed).max())


def check_flash(tag, shape, dtype):
    from mxnet_tpu_torch.ops import flash_attention_cuda as fac
    from mxnet_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_torch, flash_attention_fwd_torch)

    args, kw = flash_case(shape, dtype)
    q, k, v, do, dlse = args
    before = dict(fac.launches)
    o, lse, dq, dk, dv = flash_through_autograd(*args, kw)
    torch.cuda.synchronize()
    # every shape here is within the tensor-core forward's, dQ's and
    # dK/dV's limits: bf16 runs them, float32 the others
    fwd_ran, dq_ran, dkv_ran = (
        [n for n in names if fac.launches[n] != before[n]]
        for names in (("flash_fwd", "flash_fwd_simt"),
                      ("flash_dq", "flash_dq_simt"),
                      ("flash_dkv", "flash_dkv_simt")))
    tc = dtype == torch.bfloat16
    fwd_want = "flash_fwd" if tc else "flash_fwd_simt"
    dq_want = "flash_dq" if tc else "flash_dq_simt"
    dkv_want = "flash_dkv" if tc else "flash_dkv_simt"
    up = [t.float() for t in (q, k, v, do)]
    p_o, p_lse = flash_attention_fwd_torch(*up[:3], **kw)
    p_grads = flash_attention_bwd_torch(*up[:3], o.float(), lse, up[3],
                                        dlse, **kw)
    A = magnitude_terms(q, k, v, o, lse, do, dlse, kw)
    got = {"o": o, "dq": dq, "dk": dk, "dv": dv}
    ref = dict(zip(("dq", "dk", "dv"), p_grads), o=p_o)
    row = {"phase": "flash_check", "shape": tag, "dtype": str(dtype)[6:],
           "fwd_kernel": fwd_ran, "dq_kernel": dq_ran,
           "dkv_kernel": dkv_ran}
    ok = (fwd_ran == [fwd_want] and dq_ran == [dq_want]
          and dkv_ran == [dkv_want])
    for name in got:
        fine, share = within_bound(got[name], ref[name], A[name], dtype)
        row[f"{name}_worst_share_of_bound"] = share
        row[f"{name}_max_abs_err_vs_plain32"] = float(
            (got[name].float() - ref[name]).abs().max())
        ok = ok and fine and bool(torch.isfinite(got[name]).all())
    masked = lse <= -1e29
    lse_ok = (torch.equal(masked, p_lse <= -1e29)
              and bool((lse[masked] == -1e30).all())
              and bool(((lse - p_lse).abs()[~masked]
                        <= F32_REL * (1 + p_lse.abs()[~masked])).all()))
    zero_rows = bool((_bhsd(o, kw["layout"])[masked] == 0).all())
    row.update({"masked_rows": int(masked.sum()), "lse_ok": lse_ok,
                "masked_rows_zero": zero_rows})
    ok = ok and lse_ok and zero_rows
    # max |kernel - plain| with the plain versions in the same dtype (the
    # kernels line's max_abs_err)
    s_o, s_lse = flash_attention_fwd_torch(q, k, v, **kw)
    s_grads = flash_attention_bwd_torch(q, k, v, o, lse, do, dlse, **kw)
    same = dict(zip(("dq", "dk", "dv"), s_grads), o=s_o)
    row["max_abs_err_same_dtype"] = {
        n: float((got[n].float() - same[n].float()).abs().max())
        for n in got}
    if tag == "train" and dtype == torch.bfloat16:
        # the check binds: a kernel that skipped one tile must fail it
        mut = {**magnitude_terms(q, k, v, o, lse, do, dlse, kw, drop_k=8),
               **magnitude_terms(q, k, v, o, lse, do, dlse, kw, drop_q=8)}
        caught = {n: not within_bound(mut[n], ref[n], A[n], dtype)[0]
                  for n in mut}
        row["dropped_tile_caught"] = caught
        ok = ok and all(caught.values())
    row["bound"] = ("|k - plain32| <= 2^-8 (|plain32| + A) + 1e-5 A + 1e-6"
                    if dtype == torch.bfloat16 else
                    "|k - plain32| <= 1e-5 A + 1e-6")
    row["ok"] = ok
    emit(row)
    if not ok:
        raise SystemExit(f"flash kernels disagree with plain: {tag} {dtype}")
    return row


def live_pairs(shape):
    """Kept (q, k) score pairs of one (batch, head): the work the data
    needs, whatever tiles the kernel visits."""
    from mxnet_tpu_torch.ops.flash_attention import _keep

    keep = _keep(shape["Sq"], shape["Sk"], shape["causal"],
                 shape["q_offset"], shape["k_offset"], shape["window"],
                 "cpu")
    return (shape["Sq"] * shape["Sk"] if keep is None
            else int(keep.sum()))


def flash_bounds(shape, dtype):
    """Least time of each kernel at ``shape``: each input read once and
    each output written once at the HBM rate, against its products at
    the tensor-core (bf16) or FMA (f32) peak."""
    B, Hq, Hkv, Sq, Sk, D = (shape[k] for k in ("B", "Hq", "Hkv", "Sq",
                                                "Sk", "D"))
    es = torch.tensor([], dtype=dtype).element_size()
    qb, kb = B * Hq * Sq * D * es, B * Hkv * Sk * D * es
    row = B * Hq * Sq * 4
    pairs = B * Hq * live_pairs(shape)
    work = {"flash_fwd": (4 * D * pairs, 2 * qb + 2 * kb + row),
            "flash_dq": (6 * D * pairs, 3 * qb + 2 * kb + 3 * row),
            "flash_dkv": (8 * D * pairs, 2 * qb + 4 * kb + 3 * row)}
    out = {}
    for name, (ops, nbytes) in work.items():
        t_b, t_o = nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S[dtype]
        out[name] = (1e3 * max(t_b, t_o),
                     "bytes" if t_b >= t_o else "operations", ops, nbytes)
    return out


def misaligned_copy(t):
    """A copy of contiguous ``t`` (same shape and strides) whose data
    starts 2 bytes past a 16-byte boundary: the forward's, dQ's and
    dK/dV's variant selectors send it to the float32-FMA kernels."""
    assert t.is_contiguous()
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def ptxas_report(log, kernel, names=("D",)):
    """Registers and spill bytes of each instantiation of ``kernel`` in
    nvcc's -Xptxas -v output, keyed by its integer template arguments
    under ``names`` (the flash kernels' D; the RNN kernel's G)."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            args = re.findall(r"Li(\d+)E", m.group(1))
            key = "_".join(f"{n}{v}" for n, v in zip(names, args))
            cur = (key or m.group(1)) if kernel in m.group(1) else None
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(cur, {}).update(spill_stores=int(m.group(1)),
                                           spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(cur, {})["registers"] = int(m.group(1))
    return out


def time_flash(shape, dtype):
    from mxnet_tpu_torch import _build
    from mxnet_tpu_torch.ops import flash_attention_cuda as fac
    from mxnet_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_torch, flash_attention_fwd_torch)

    F = torch.nn.functional
    (q, k, v, do, dlse), kw = flash_case(shape, dtype, seed=1)
    q_simt = misaligned_copy(q)
    saved = dict(fac.launches)
    o, lse = fac.flash_fwd_cuda(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1).contiguous()
    bwd = (q, k, v, do, lse, delta, dlse)
    # the tensor-core kernels and, in the same run, the other kernels at
    # the same shape (through the selectors: q 2 bytes off alignment)
    fac.launches.update({n: 0 for n in fac.launches})
    t = {"flash_fwd": time_ms(lambda: fac.flash_fwd_cuda(q, k, v, **kw)),
         "flash_dq": time_ms(lambda: fac.flash_dq_cuda(*bwd, **kw)),
         "flash_dkv": time_ms(lambda: fac.flash_dkv_cuda(*bwd, **kw))}
    ms_simt = {
        "flash_fwd": time_ms(lambda: fac.flash_fwd_cuda(q_simt, k, v, **kw)),
        "flash_dq": time_ms(lambda: fac.flash_dq_cuda(q_simt, *bwd[1:],
                                                      **kw)),
        "flash_dkv": time_ms(lambda: fac.flash_dkv_cuda(q_simt, *bwd[1:],
                                                        **kw))}
    timed = dict(fac.launches)
    fac.launches.update(saved)        # timing launches are not the path's
    if len(set(timed.values())) != 1:
        raise SystemExit(f"flash_time: variants not as timed: {timed}")
    plain_fwd = time_ms(lambda: flash_attention_fwd_torch(q, k, v, **kw),
                        reps=10)
    plain_bwd = time_ms(lambda: flash_attention_bwd_torch(
        q, k, v, o, lse, do, dlse, **kw), reps=10)
    # yardsticks the port never calls: SDPA forward, and SDPA's backward
    # alone (dq, dk, dv together) on a retained graph
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True))
    qkv = [x.detach().requires_grad_() for x in (q, k, v)]
    s_out = F.scaled_dot_product_attention(*qkv, is_causal=True)
    lib_bwd = time_ms(lambda: torch.autograd.grad(s_out, qkv, do,
                                                  retain_graph=True))
    bounds = flash_bounds(shape, dtype)
    rows = {}
    for name in t:
        b_ms, b_by, ops, nbytes = bounds[name]
        rows[name] = {
            "phase": "flash_time", "kernel": name, "shape": "train",
            "dtype": str(dtype)[6:], "ms": t[name],
            "plain_ms": plain_fwd if name == "flash_fwd" else plain_bwd,
            "library_ms": lib_fwd if name == "flash_fwd" else lib_bwd,
            "bound_ms": b_ms, "bound_by": b_by, "ops": ops, "bytes": nbytes,
            "bound_share": b_ms / t[name],
            "plain": ("flash_attention_fwd_torch" if name == "flash_fwd" else
                      "flash_attention_bwd_torch (dq, dk, dv together)"),
            "library": ("F.scaled_dot_product_attention(is_causal=True)"
                        if name == "flash_fwd" else
                        "SDPA backward alone (dq, dk, dv together)")}
        if name in ms_simt:
            rows[name].update({
                "source": f"csrc/{name}_tc.cu",
                "ms_simt": ms_simt[name],
                "simt_over_tc": ms_simt[name] / t[name],
                "simt": f"{name}_kernel (csrc/flash_attention.cu), the "
                        "same shape with q 2 bytes off 16-byte alignment",
                "ptxas": ptxas_report(
                    _build.BUILD_LOGS.get(fac.LIB_NAME, ""),
                    f"{name}_tc_kernel")})
        emit(rows[name])
    return rows


# -- training: the main path --------------------------------------------------
def train_batch(vocab, batch, seq_len, seed=0):
    """bench.py's fixed synthetic batch (RandomState(0) ids, labels)."""
    rng = np.random.RandomState(seed)
    data = rng.randint(0, vocab, (batch, seq_len))
    label = rng.randint(0, vocab, (batch, seq_len)).astype(np.int32)
    return {"data": data.astype(np.int32), "softmax_label": label}


def make_trainer(cfg, batch, dtype, optimizer="adam", impl="auto",
                 device=None, **extra):
    from mxnet_tpu_torch import initializer, models, parallel

    net = models.gpt(cfg["vocab"], cfg["seq_len"],
                     num_layers=cfg["num_layers"], d_model=cfg["d_model"],
                     num_heads=cfg["num_heads"], attn_impl=impl,
                     **{k: cfg[k] for k in cfg
                        if k not in ("vocab", "seq_len", "num_layers",
                                     "d_model", "num_heads")})
    shape = (batch, cfg["seq_len"])
    return parallel.ShardedTrainer(
        net, {"data": shape, "softmax_label": shape}, optimizer=optimizer,
        optimizer_params={"learning_rate": 3e-4}, dtype=dtype,
        initializer=initializer.Xavier(),
        input_dtypes={"data": np.int32, "softmax_label": np.int32},
        device=device or DEVICE, **extra)


def nll_of(probs, labels):
    p = probs.float().gather(1, labels.reshape(-1, 1).long())
    return float(-torch.log(p).mean())


def train_main_path():
    from mxnet_tpu_torch.ops import flash_attention_cuda as fac

    cfg = TRAIN_CFG
    tr = make_trainer(cfg, TRAIN_BATCH, "bfloat16")
    placed = tr._place_batch(train_batch(cfg["vocab"], TRAIN_BATCH,
                                         cfg["seq_len"]))
    labels = placed["softmax_label"]
    lap("gpt_train_setup")
    nll = []
    for _ in range(TRAIN_WARMUP):
        nll.append(nll_of(tr.step(placed)[0], labels))
    torch.cuda.synchronize()
    for name in fac.launches:          # the main path's window opens
        fac.launches[name] = 0
    step_ms = []
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        ts = time.perf_counter()
        probs = tr.step(placed)[0]
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - ts))
        nll.append(nll_of(probs, labels))
    wall = time.perf_counter() - t0
    launches = dict(fac.launches)      # ... and closes
    lap("gpt_train_steps")
    profile = train_profile(tr, placed)
    lap("gpt_train_profile")
    want = cfg["num_layers"] * TRAIN_STEPS
    # every bf16 flash launch on the tensor-core kernels, none on the
    # others
    expected = {"flash_fwd": want, "flash_fwd_simt": 0, "flash_dq": want,
                "flash_dq_simt": 0, "flash_dkv": want, "flash_dkv_simt": 0}
    finite = all(np.isfinite(nll))
    ok = (finite and nll[-1] < nll[0] and launches == expected
          and tuple(probs.shape) == (TRAIN_BATCH * cfg["seq_len"],
                                     cfg["vocab"]))
    row = {"phase": "train", "dtype": "bfloat16", "config": cfg,
           "batch": TRAIN_BATCH, "params": sum(p.numel() for p in
                                               tr.params.values()),
           "warmup_steps": TRAIN_WARMUP, "steps": TRAIN_STEPS,
           "kernel_launches": launches, "launches_expected": expected,
           "step_ms": step_ms, "step_ms_median": statistics.median(step_ms),
           "wall_s": wall,
           "tokens_per_s": TRAIN_BATCH * cfg["seq_len"] * TRAIN_STEPS / wall,
           "nll": nll, "peak_mem_gib": torch.cuda.max_memory_allocated()
           / 2 ** 30, "profile": profile, "ok": ok}
    emit(row)
    del tr, placed, probs
    torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("full-width training failed its checks")
    return row


def _kernel_kind(name):
    low = name.lower()
    for key, kind in (("flash_fwd", "flash_fwd"), ("flash_dq", "flash_dq"),
                      ("flash_dkv", "flash_dkv"),
                      ("rnn_fwd_kernel", "fused_rnn_fwd"),
                      ("rnn_fwd_tc_kernel", "fused_rnn_fwd"),
                      ("rnn_bwd_kernel", "fused_rnn_bwd"),
                      ("rnn_bwd_tc_kernel", "fused_rnn_bwd"), ("gemm", "matmul"),
                      ("xmma", "matmul"), ("cutlass", "matmul"),
                      ("nvjet", "matmul"),
                      ("softmax", "softmax"), ("embedding", "embedding"),
                      ("reduce", "reduction"), ("elementwise", "elementwise"),
                      ("vectorized", "elementwise"), ("copy", "copy")):
        if key in low:
            return kind
    return "other"


def profiler_warmup():
    """Start torch.profiler once around one small CUDA op: its first
    start (CUPTI and kineto set-up) takes seconds, spent here, beside the
    build, rather than inside the first profile window's phase."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.ones(8, device=DEVICE).add_(1)
        torch.cuda.synchronize()
    prof.key_averages()


def train_profile(tr, placed, steps=2):
    """Device time by kernel over ``steps`` more train steps
    (torch.profiler), and the device's busy share of their wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            tr.step(placed)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us and getattr(ev, "device_type", None) is not None \
                and "CUDA" in str(ev.device_type):
            kernels[ev.key] = kernels.get(ev.key, 0.0) + us / 1e3
    kinds = {}
    for name, ms in kernels.items():
        kind = _kernel_kind(name)
        kinds[kind] = kinds.get(kind, 0.0) + ms / steps
    device_ms = sum(kernels.values()) / steps
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    return {"steps": steps, "wall_ms_per_step": wall_ms / steps,
            "device_ms_per_step": device_ms,
            "device_busy_share": device_ms * steps / wall_ms,
            "ms_per_step_by_kind": kinds,
            "top_kernels_ms_per_step": [(n[:120], ms / steps)
                                        for n, ms in top]}


def train_grad_check():
    """One full-width float32 step: gradients through the kernels vs the
    same step with the dense (impl="xla") attention, and the same step
    through a planted faulty forward, which must fail the bound."""
    from mxnet_tpu_torch.ops import flash_attention_cuda as fac

    cfg = TRAIN_CFG
    batch = train_batch(cfg["vocab"], TRAIN_BATCH, cfg["seq_len"])
    real_fwd = fac.flash_fwd_cuda

    def planted_fwd(*args, **kw):
        o, lse = real_fwd(*args, **kw)
        return o.to(torch.bfloat16).to(o.dtype), lse

    grads = {}
    start = None
    for arm in ("auto", "xla", "planted"):
        tr = make_trainer(cfg, TRAIN_BATCH, "float32", optimizer="sgd",
                          impl="xla" if arm == "xla" else "auto")
        if start is None:
            start = tr.get_params()
        else:
            tr.set_params(start)
        if arm == "planted":
            fac.flash_fwd_cuda = planted_fwd
        try:
            grads[arm], _ = tr._grads_of(tr._place_batch(batch))
        finally:
            fac.flash_fwd_cuda = real_fwd
        del tr

    def worst_share(arm):
        worst, worst_name = 0.0, None
        for name, gk in grads[arm].items():
            gx = grads["xla"][name]
            share = float((gk - gx).abs().max()) / max(
                float(gx.abs().max()) * GRAD_REL, 1e-30)
            if share > worst:
                worst, worst_name = share, name
        return worst, worst_name

    worst, worst_name = worst_share("auto")
    planted, _ = worst_share("planted")
    finite = all(bool(torch.isfinite(g).all())
                 for g in grads["auto"].values())
    ok = finite and worst <= 1.0 and planted > 1.0
    emit({"phase": "train_grad_check", "dtype": "float32",
          "bound": "max|g_kernel - g_dense| <= 2e-5 max|g_dense| per param",
          "worst_share_of_bound": worst, "worst_param": worst_name,
          "planted_fault": "forward o stored through bfloat16",
          "planted_worst_share_of_bound": planted,
          "planted_caught": planted > 1.0, "ok": ok})
    del grads
    torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("full-width gradients: kernels vs dense disagree")


def small_train_check():
    """A small model: the CUDA trainer (flash kernels) against the CPU
    trainer (dense attention) from the same parameters, 3 Adam steps in
    float32.  Outputs within 1e-5 at step 1 and 1e-4 after (Adam's first
    step moves near-zero-gradient elements by +-lr either way); params
    within 2e-5 + 3 lr min(2, 1e-5 max|g| / |g_i|), the key biases (an
    exactly-zero gradient) within 2e-5 + 6 lr."""
    cfg = dict(vocab=53, seq_len=64, num_layers=2, d_model=64, num_heads=4,
               kv_heads=2, attn_layout="bshd", attn_window=24)
    batch = train_batch(53, 4, 64, seed=3)
    cuda_tr = make_trainer(cfg, 4, "float32")
    cpu_tr = make_trainer(cfg, 4, "float32", device="cpu")
    cpu_tr.set_params(cuda_tr.get_params())
    grads, _ = cpu_tr._grads_of(cpu_tr._place_batch(batch))
    out_err = []
    for step in range(3):
        a = cuda_tr.step(batch)[0].cpu()
        b = cpu_tr.step(batch)[0]
        out_err.append(float((a - b).abs().max()))
    ok = out_err[0] <= 1e-5 and max(out_err) <= 1e-4
    lr, worst = 3e-4, 0.0
    got, want = cuda_tr.get_params(), cpu_tr.get_params()
    for name in want:
        g = grads[name].abs().numpy()
        allowed = 2e-5 + 3 * lr * np.minimum(
            2.0, 1e-5 * float(g.max()) / np.maximum(g, 1e-30))
        if name.endswith("_k_bias"):
            allowed = np.full_like(allowed, 2e-5 + 6 * lr)
        worst = max(worst, float((np.abs(got[name] - want[name])
                                  / allowed).max()))
    ok = ok and worst <= 1.0
    emit({"phase": "small_train_check", "out_max_abs_err": out_err,
          "param_worst_share_of_bound": worst, "ok": ok})
    if not ok:
        raise SystemExit("small-model training: CUDA vs CPU disagree")


# -- RNN training: fused LSTM/GRU kernels vs their plain versions ------------
# the slice's model: the RNN-op language model of examples/rnn_time_major.py
# (Embedding -> RNN, time-major (T, N) -> Reshape(-1, H) -> FullyConnected
# -> SoftmaxOutput) at the fused-RNN benchmark's width (T 128, N 32, H 512),
# 2 layers (examples/lstm_bucketing.py --num-layers 2), embedding 512, PTB's
# 10,000-word vocabulary, bf16, Adam 0.01, Xavier, rescale_grad 1/N
RNN_CFG = dict(vocab=10000, seq_len=128, batch=32, hidden=512,
               num_layers=2)
RNN_WARMUP, RNN_STEPS, GRU_STEPS = 2, 10, 5
# kernel-check shapes: the main path's (T, N, H) and the contract shapes
# (the PTB example's width H 200 with a ragged batch N 3; T 1; and the
# reverse direction's flipped input at the main shape)
RNN_SHAPES = {"main": (128, 32, 512), "h200_n3": (35, 3, 200),
              "t1": (1, 32, 512), "flipped": (35, 32, 512)}
# stated kernel-vs-plain bounds, per output X (ys, hT, cT, the saved
# residuals, dgx, dWh, dbh, dh0, dc0), on the same inputs in the same dtype:
#   float32: max |kernel - plain| <= RNN_F32_REL max |plain|.  The same
#     float32 math summed in another order (~1e-7 relative per product),
#     carried through T 128 steps of a recurrence whose gain is ~1 at the
#     model's initial scale (U(+-0.07) weights): 1e-5 is a wide margin.
#   bfloat16: one flipped bf16 rounding of h at step t feeds every later
#     step, so a single-op bound does not hold.  The bound is derived from
#     the spread of legitimate summation orders instead: the plain version
#     is run twice more with the hidden units permuted (reversed, and a
#     seeded shuffle: the same math, the recurrent products summed in
#     another order), and
#         max |kernel - plain| <= 2 spread + 2^-8 max |plain|,
#     spread = the larger of the two permuted runs' max |alt - plain|; the
#     floor is one bf16 rounding of the output's largest value.
# Each check is shown to bind: the plain output of a forward whose step
# T/2 dropped its recurrent product (the state fed to it zeroed), and the
# backward from its residuals, must fail it for every output.
RNN_F32_REL = 1e-5
# f32 kernels against cuDNN's nn.LSTM / nn.GRU (an independent
# implementation, TF32 off) at the main shape: outputs and input gradients
# within RNN_CUDNN_REL of each one's max magnitude
RNN_CUDNN_REL = 2e-5
# full-width float32 step: each parameter's gradient through the kernels vs
# through the eager scan (MXNET_TPU_FUSED_RNN=0), max |diff| <=
# RNN_GRAD_REL max |grad|: summation order only, ~1e-7 per op carried
# through 128 steps, two layers and the 10,000-way head; the planted fault
# (the forward kernel's ys stored through bfloat16, 2^-9 relative) must fail
RNN_GRAD_REL = 1e-4
_GATES = {"lstm": 4, "gru": 3}
RNN_OUTPUTS = {"fwd": ("ys", "hT", "cT", "acts", "cells"),
               "bwd": ("dgx", "dwh", "dbh", "dh0", "dc0")}


def rnn_lm(mode, cfg, batch):
    """The RNN-op LM as an nn.Module whose parameters carry the reference
    build_net's argument names and order (embed_weight,
    <mode>_parameters, <mode>_state[, lstm_state_cell], cls_weight,
    cls_bias)."""
    from torch import nn

    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.ops.rnn import rnn_infer_shape

    V, H, L = cfg["vocab"], cfg["hidden"], cfg["num_layers"]

    class RNNLM(nn.Module):
        def __init__(self):
            super().__init__()
            shapes = rnn_infer_shape((1, batch, H), H, L, mode)[0][1:]
            names = ["parameters", "state", "state_cell"][:len(shapes)]
            args = [("embed_weight", (V, H))]
            args += [(f"{mode}_{n}", s) for n, s in zip(names, shapes)]
            args += [("cls_weight", (V, H)), ("cls_bias", (V,))]
            for name, shape in args:
                self.register_parameter(name, nn.Parameter(
                    torch.empty(shape, device="meta")))

        def forward(self, data, softmax_label):
            p = self._parameters
            x = ops.Embedding(data, p["embed_weight"])
            y = ops.RNN(x, p[f"{mode}_parameters"], p[f"{mode}_state"],
                        p.get("lstm_state_cell"), state_size=H,
                        num_layers=L, mode=mode)
            fc = ops.FullyConnected(y.reshape(-1, H), p["cls_weight"],
                                    p["cls_bias"], num_hidden=V)
            return ops.SoftmaxOutput(fc, softmax_label.reshape(-1))

    return RNNLM()


def make_rnn_trainer(mode, cfg, batch, dtype, device=None, lr=0.01):
    from mxnet_tpu_torch import initializer, parallel

    shape = (cfg["seq_len"], batch)
    return parallel.ShardedTrainer(
        rnn_lm(mode, cfg, batch), {"data": shape, "softmax_label": shape},
        optimizer="adam", optimizer_params={"learning_rate": lr},
        dtype=dtype, initializer=initializer.Xavier(),
        input_dtypes={"data": np.int32, "softmax_label": np.int32},
        rescale_grad=1.0 / batch, device=device or DEVICE)


def rnn_batch(cfg, batch, seed=0):
    rng = np.random.RandomState(seed)
    shape = (cfg["seq_len"], batch)
    return {"data": rng.randint(0, cfg["vocab"], shape).astype(np.int32),
            "softmax_label": rng.randint(0, cfg["vocab"], shape)
            .astype(np.int32)}


def rnn_case(mode, shape, dtype, seed=0):
    """One layer's kernel inputs at the model's initial scale (recurrent
    weights and bias U(+-0.07), as the Initializer draws *_parameters),
    gx and the initial states N(0, 0.5^2), and non-zero cotangents of
    ys, hT and cT."""
    T, N, H = shape
    G = _GATES[mode]
    g = torch.Generator().manual_seed(seed)
    dev = torch.device(DEVICE)
    u = lambda *s: (torch.rand(*s, generator=g) * 2 - 1) * 0.07
    n = lambda *s: torch.randn(*s, generator=g)
    gx = (n(T, N, G * H) * 0.5).to(dev, dtype)
    ins = {"gx": gx, "h0": (n(N, H) * 0.5).to(dev),
           "c0": (n(N, H) * 0.5).to(dev), "wh": u(G * H, H).to(dev, dtype),
           "bh": u(G * H).to(dev)}
    if mode == "gru":
        del ins["c0"]
    cot = {"dys": n(T, N, H).to(dev, dtype), "dhT": n(N, H).to(dev, dtype),
           "dcT": n(N, H).to(dev, dtype)}
    if mode == "gru":
        del cot["dcT"]
    return ins, cot


def rnn_kernels(mode, ins, cot, variant=None, fwd_variant=None):
    """Kernel outputs by name: the forward kernel with residuals, then the
    backward kernel from them (``fwd_variant`` and ``variant`` force the
    forward's and the backward's: "tc" or "simt"; by default the
    wrappers' rules pick them)."""
    from mxnet_tpu_torch.ops import fused_rnn_cuda as frc

    if mode == "lstm":
        ys, hT, cT, acts, cells = frc.lstm_fwd_cuda(**ins, save=True,
                                                    _variant=fwd_variant)
        dgx, dwh, dbh, dh0, dc0 = frc.lstm_bwd_cuda(
            acts, cells, ys, ins["h0"], ins["c0"], ins["wh"], **cot,
            _variant=variant)
        return dict(ys=ys, hT=hT, cT=cT, acts=acts, cells=cells, dgx=dgx,
                    dwh=dwh, dbh=dbh, dh0=dh0, dc0=dc0)
    ys, hT, acts = frc.gru_fwd_cuda(**ins, save=True, _variant=fwd_variant)
    dgx, dwh, dbh, dh0 = frc.gru_bwd_cuda(acts, ys, ins["h0"], ins["wh"],
                                          **cot, _variant=variant)
    return dict(ys=ys, hT=hT, acts=acts, dgx=dgx, dwh=dwh, dbh=dbh, dh0=dh0)


def rnn_plain(mode, ins, cot, fault_step=None):
    """The plain versions' outputs by name on the same inputs.  With
    ``fault_step`` the forward is a planted fault: that step's recurrent
    product dropped (the state fed to it zeroed), the backward run from
    its residuals."""
    from mxnet_tpu_torch.ops import fused_gru as fg
    from mxnet_tpu_torch.ops import fused_lstm as fl

    lstm = mode == "lstm"
    fwd = fl.fused_lstm_fwd_torch if lstm else fg.fused_gru_fwd_torch
    gx, h0 = ins["gx"], ins["h0"]
    state = (h0, ins["c0"]) if lstm else (h0,)
    rest = (ins["wh"], ins["bh"])
    if fault_step is None:
        out = fwd(gx, *state, *rest, save=True)
    else:
        # steps [0, s), step s fed a zero h (its product dropped; the
        # LSTM's float32 cell carried on), then steps (s, T)
        s = fault_step
        a = fwd(gx[:s], *state, *rest, save=True)
        hz = torch.zeros_like(h0)
        cell = lambda o: (o[4][-1],) if lstm else ()
        b = fwd(gx[s:s + 1], hz, *(cell(a) if s else state[1:]), *rest,
                save=True)
        c = fwd(gx[s + 1:], b[0][-1].float(), *cell(b), *rest, save=True)
        out = [torch.cat([a[0], b[0], c[0]]), c[1]]
        if lstm:
            out += [c[2], torch.cat([a[3], b[3], c[3]]),
                    torch.cat([a[4], b[4], c[4]])]
        else:
            out += [torch.cat([a[2], b[2], c[2]])]
    if lstm:
        ys, hT, cT, acts, cells = out
        dgx, dwh, dbh, dh0, dc0 = fl.fused_lstm_bwd_torch(
            acts, cells, ys, h0, ins["c0"], ins["wh"], **cot)
        return dict(ys=ys, hT=hT, cT=cT, acts=acts, cells=cells, dgx=dgx,
                    dwh=dwh, dbh=dbh, dh0=dh0, dc0=dc0)
    ys, hT, acts = out
    dgx, dwh, dbh, dh0 = fg.fused_gru_bwd_torch(acts, ys, h0, ins["wh"],
                                                **cot)
    return dict(ys=ys, hT=hT, acts=acts, dgx=dgx, dwh=dwh, dbh=dbh, dh0=dh0)


def rnn_plain_permuted(mode, ins, cot, perm):
    """The plain versions with the hidden units permuted by ``perm``
    (gx, wh rows and columns, bh, states, cotangents), outputs permuted
    back: the same math with the recurrent products summed in another
    order."""
    G = _GATES[mode]
    H = ins["h0"].shape[-1]
    rows = torch.cat([perm + q * H for q in range(G)])
    rows4 = torch.cat([perm + q * H for q in range(4)])
    inv = torch.argsort(perm)
    inv_g = torch.argsort(rows)
    p_ins = {"gx": ins["gx"][..., rows], "h0": ins["h0"][:, perm],
             "wh": ins["wh"][rows][:, perm], "bh": ins["bh"][rows]}
    if "c0" in ins:
        p_ins["c0"] = ins["c0"][:, perm]
    p_cot = {k: v[..., perm] for k, v in cot.items()}
    out = rnn_plain(mode, p_ins, p_cot)
    back = {"ys": inv, "hT": inv, "cT": inv, "cells": inv, "dh0": inv,
            "dc0": inv, "dgx": inv_g, "dbh": inv_g,
            "acts": torch.argsort(rows4)}
    res = {k: v[..., back[k]] for k, v in out.items() if k in back}
    res["dwh"] = out["dwh"][inv_g][:, inv]
    return res


def check_rnn(mode, tag, dtype):
    """The forward and backward kernels against their plain versions at
    one shape and dtype (bounds above); returns the report row.  Each is
    the tensor-core kernel in bfloat16 and the other one in float32 (the
    row says which ran); at the main shape in bfloat16 the other forward
    and the other backward (``_variant="simt"``) are held to the same
    bounds, each with the other pass on its tensor-core kernel."""
    from mxnet_tpu_torch.ops import fused_rnn_cuda as frc

    shape = RNN_SHAPES[tag]
    ins, cot = rnn_case(mode, shape, dtype)
    if tag == "flipped":           # the reverse direction's input
        ins["gx"] = ins["gx"].flip(0)
    before = dict(frc.launches)
    got = rnn_kernels(mode, ins, cot)
    torch.cuda.synchronize()
    ran = {kind: [k for k in frc.launches
                  if kind in k and frc.launches[k] != before[k]]
           for kind in ("fwd", "bwd")}
    suffix = "" if dtype == torch.bfloat16 else "_simt"
    want = {kind: f"{mode}_{kind}{suffix}" for kind in ("fwd", "bwd")}
    ref = rnn_plain(mode, ins, cot)
    row = {"phase": "rnn_check", "mode": mode, "shape": tag,
           "tnh": list(shape), "dtype": str(dtype)[6:],
           "fwd_kernel": ran["fwd"], "fwd_kernel_expected": want["fwd"],
           "bwd_kernel": ran["bwd"], "bwd_kernel_expected": want["bwd"]}
    if dtype == torch.bfloat16:
        row["fwd_tc_plan"] = dict(frc.last_fwd_tc_plan)
        row["tc_plan"] = dict(frc.last_tc_plan)
    bound = {}
    if dtype == torch.bfloat16:
        H = shape[2]
        g = torch.Generator().manual_seed(1)
        perms = [torch.arange(H - 1, -1, -1), torch.randperm(H, generator=g)]
        alts = [rnn_plain_permuted(mode, ins, cot, p.to(DEVICE))
                for p in perms]
        spread = {k: max(float((a[k].float() - v.float()).abs().max())
                         for a in alts) for k, v in ref.items()}
        for k, v in ref.items():
            bound[k] = 2 * spread[k] + BF16_REL * float(v.float().abs().max())
        row["spread_of_orders"] = spread
        row["bound"] = "2 spread + 2^-8 max|plain| per output"
    else:
        for k, v in ref.items():
            bound[k] = RNN_F32_REL * float(v.float().abs().max())
        row["bound"] = "1e-5 max|plain| per output"
    err = {k: float((got[k].float() - ref[k].float()).abs().max())
           for k in ref}
    share = {k: err[k] / max(bound[k], 1e-30) for k in ref}
    finite = all(bool(torch.isfinite(v).all()) for v in got.values())
    ok = (finite and all(s <= 1.0 for s in share.values())
          and all(ran[kind] == [want[kind]] for kind in ran))
    if dtype == torch.bfloat16 and tag == "main":
        # the other kernels on the same inputs: the simt backward from the
        # tc forward's residuals, and the simt forward (with the tc
        # backward from its residuals), every output held to the bounds
        for kind, kw in (("bwd", {"variant": "simt"}),
                         ("fwd", {"fwd_variant": "simt"})):
            before = dict(frc.launches)
            simt = rnn_kernels(mode, ins, cot, **kw)
            torch.cuda.synchronize()
            ran_simt = [k for k in frc.launches
                        if kind in k and frc.launches[k] != before[k]]
            outs = RNN_OUTPUTS[kind] if kind == "bwd" else ref
            simt_share = {k: float((simt[k].float() - ref[k].float()).abs()
                                   .max()) / max(bound[k], 1e-30)
                          for k in outs if k in ref}
            row[f"simt_{kind}_share_by_output"] = simt_share
            row[f"simt_{kind}_kernel"] = ran_simt
            ok = (ok and all(v <= 1.0 for v in simt_share.values())
                  and ran_simt == [f"{mode}_{kind}_simt"])
    row.update({"max_abs_err": err, "worst_share_of_bound":
                max(share.values()), "share_by_output": share})
    if tag == "main":
        # the check binds: a plain output with one step's recurrent
        # product dropped must fail it, for every output, at the step
        # nearest that output (0: dh0, dc0; T-1: hT, cT; T/2: the rest)
        caught = {k: [] for k in ref}
        for step in (0, shape[0] // 2, shape[0] - 1):
            bad = rnn_plain(mode, ins, cot, fault_step=step)
            for k in ref:
                diff = float((bad[k].float() - ref[k].float()).abs().max())
                if diff > bound[k]:
                    caught[k].append(step)
        row["planted_fault"] = ("one step's recurrent product dropped, at "
                                "step 0, T/2 or T-1")
        row["planted_caught_at_steps"] = caught
        ok = ok and all(caught.values())
    row.update({"finite": finite, "ok": ok})
    emit(row)
    if not ok:
        raise SystemExit(f"fused {mode} kernels disagree with plain: {tag} "
                         f"{dtype}")
    return row


def cudnn_check(mode):
    """float32 kernels through the port's fused path against cuDNN's
    nn.LSTM / nn.GRU with the same Wi, Wh, bi, bh (gate orders match):
    ys, hT (cT) and the gradients of x, h0 (c0)."""
    from mxnet_tpu_torch.ops.fused_gru import fused_gru
    from mxnet_tpu_torch.ops.fused_lstm import fused_lstm

    T, N, H = RNN_SHAPES["main"]
    g = torch.Generator().manual_seed(5)
    cls = torch.nn.LSTM if mode == "lstm" else torch.nn.GRU
    cell = cls(H, H).to(DEVICE)
    with torch.no_grad():
        for p in cell.parameters():
            p.copy_((torch.rand(p.shape, generator=g) * 2 - 1) * 0.07)
    x = (torch.randn(T, N, H, generator=g) * 0.5).to(DEVICE)
    h0 = (torch.randn(1, N, H, generator=g) * 0.5).to(DEVICE)
    c0 = (torch.randn(1, N, H, generator=g) * 0.5).to(DEVICE)
    cot = [torch.randn(T, N, H, generator=g).to(DEVICE),
           torch.randn(1, N, H, generator=g).to(DEVICE),
           torch.randn(1, N, H, generator=g).to(DEVICE)]
    leaves = [t.clone().requires_grad_() for t in (x, h0, c0)]
    if mode == "lstm":
        ys, (hT, cT) = cell(leaves[0], (leaves[1], leaves[2]))
        ref_out = [ys, hT, cT]
    else:
        ys, hT = cell(leaves[0], leaves[1])
        ref_out = [ys, hT]
        leaves = leaves[:2]
    ref_grads = torch.autograd.grad(ref_out, leaves, cot[:len(ref_out)])
    mine = [t.clone().requires_grad_() for t in (x, h0, c0)][:len(leaves)]
    gx = mine[0] @ cell.weight_ih_l0.t() + cell.bias_ih_l0
    if mode == "lstm":
        out = fused_lstm(gx, mine[1][0], mine[2][0], cell.weight_hh_l0,
                         cell.bias_hh_l0)
    else:
        out = fused_gru(gx, mine[1][0], cell.weight_hh_l0, cell.bias_hh_l0)
    out = [out[0]] + [o[None] for o in out[1:]]
    grads = torch.autograd.grad(out, mine, cot[:len(out)])
    names = ["ys", "hT", "cT"][:len(out)] + ["dx", "dh0", "dc0"][:len(out)]
    share = {}
    for name, a, b in zip(names, list(out) + list(grads),
                          ref_out + list(ref_grads)):
        share[name] = float((a - b).detach().abs().max()) / (
            RNN_CUDNN_REL * float(b.detach().abs().max()))
    ok = max(share.values()) <= 1.0
    emit({"phase": "rnn_cudnn_check", "mode": mode, "dtype": "float32",
          "bound": "max|kernel - cudnn| <= 2e-5 max|cudnn| per output",
          "share_by_output": share, "ok": ok})
    if not ok:
        raise SystemExit(f"fused {mode} kernels disagree with cuDNN")


def rnn_bounds(mode, shape, dtype):
    """Least time of each kernel: each input read once and each output
    written once at the HBM rate, against 2 T N G H^2 (forward) or
    4 T N G H^2 (backward) operations at the dtype's peak."""
    T, N, H = shape
    G = _GATES[mode]
    es = torch.tensor([], dtype=dtype).element_size()
    lstm = mode == "lstm"
    res = T * N * 4 * H * 4 + (T * N * H * 4 if lstm else 0)   # residuals
    states = (2 if lstm else 1) * N * H
    fwd_bytes = (T * N * G * H * es + states * 4 + G * H * H * es + G * H * 4
                 + T * N * H * es + states * es + res)
    bwd_bytes = (res + T * N * H * es + states * 4 + G * H * H * es
                 + T * N * H * es + states * es                 # dys, dhT
                 + T * N * G * H * es + G * H * H * 4 + G * H * 4
                 + states * 4)
    out = {}
    for kind, ops, nbytes in (("fwd", 2 * T * N * G * H * H, fwd_bytes),
                              ("bwd", 4 * T * N * G * H * H, bwd_bytes)):
        t_b, t_o = nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S[dtype]
        out[f"{mode}_{kind}"] = (1e3 * max(t_b, t_o), "bytes" if t_b >= t_o
                                 else "operations", ops, nbytes)
    return out


def time_rnn(mode, dtype=torch.bfloat16):
    """Kernel, plain, library (cuDNN) and barrier-floor times at the main
    shape; the bound from this run's shapes.  The forward and the backward
    are each timed on the tensor-core kernel and, in the same run, on the
    other one (``_variant="simt"``, ``ms_simt``), with the tensor-core
    kernel's plan (cluster size, CTAs, units a CTA, shared memory), its
    ptxas registers and spills and the floor of its split barrier."""
    from mxnet_tpu_torch import _build
    from mxnet_tpu_torch.ops import fused_gru as fg
    from mxnet_tpu_torch.ops import fused_lstm as fl
    from mxnet_tpu_torch.ops import fused_rnn_cuda as frc

    shape = RNN_SHAPES["main"]
    T, N, H = shape
    ins, cot = rnn_case(mode, shape, dtype, seed=1)
    saved = dict(frc.launches)
    res = rnn_kernels(mode, ins, cot)
    if mode == "lstm":
        fwd, bwd = frc.lstm_fwd_cuda, frc.lstm_bwd_cuda
        p_fwd_fn, p_bwd_fn = fl.fused_lstm_fwd_torch, fl.fused_lstm_bwd_torch
        bwd_args = (res["acts"], res["cells"], res["ys"], ins["h0"],
                    ins["c0"], ins["wh"])
    else:
        fwd, bwd = frc.gru_fwd_cuda, frc.gru_bwd_cuda
        p_fwd_fn, p_bwd_fn = fg.fused_gru_fwd_torch, fg.fused_gru_bwd_torch
        bwd_args = (res["acts"], res["ys"], ins["h0"], ins["wh"])

    def timed(fn):
        """fn's time, and the kernels its calls launched."""
        before = dict(frc.launches)
        ms = time_ms(fn)
        return ms, {k for k, v in frc.launches.items() if v != before[k]}

    k_ms, simt_ms, plans, ran = {}, {}, {}, {}
    for kind, call in (("fwd", lambda **kw: fwd(**ins, save=True, **kw)),
                       ("bwd", lambda **kw: bwd(*bwd_args, **cot, **kw))):
        k_ms[kind], ran[kind] = timed(call)
        plans[kind] = dict(frc.last_fwd_tc_plan if kind == "fwd"
                           else frc.last_tc_plan)
        simt_ms[kind], ran[f"{kind}_simt"] = timed(
            lambda: call(_variant="simt"))
    frc.launches.update(saved)        # timing launches are not the path's
    if any(ran[k] != {f"{mode}_{k}"} for k in ran):
        raise SystemExit(f"rnn_time: {mode} kernel variants not as timed: "
                         f"{ran}")
    floor = time_ms(lambda: frc.barrier_floor_cuda(T, H, DEVICE))
    split_floor = time_ms(lambda: frc.split_barrier_floor_cuda(T, N, H,
                                                               DEVICE))
    p_fwd = time_ms(lambda: p_fwd_fn(**ins, save=True), reps=3, warmup=1)
    p_bwd = time_ms(lambda: p_bwd_fn(*bwd_args, **cot), reps=3, warmup=1)
    # the library yardstick the port never calls: cuDNN's nn.LSTM / nn.GRU
    # in the same dtype, forward (with its input projection) and its
    # backward alone on a retained graph
    cls = torch.nn.LSTM if mode == "lstm" else torch.nn.GRU
    cell = cls(H, H).to(DEVICE, dtype)
    cell.flatten_parameters()         # one contiguous weight buffer
    x = torch.randn(T, N, H, device=DEVICE, dtype=dtype).requires_grad_()
    h0 = ins["h0"][None].to(dtype)
    state = (h0, ins["c0"][None].to(dtype)) if mode == "lstm" else h0
    lib_fwd = time_ms(lambda: cell(x, state))
    y = cell(x, state)[0]
    leaves = [x] + list(cell.parameters())
    lib_bwd = time_ms(lambda: torch.autograd.grad(y, leaves, cot["dys"],
                                                  retain_graph=True))
    bounds = rnn_bounds(mode, shape, dtype)
    log = _build.BUILD_LOGS.get(frc.LIB_NAME, "")
    rows = {}
    for kind, p_ms, l_ms in (("fwd", p_fwd, lib_fwd), ("bwd", p_bwd, lib_bwd)):
        name = f"{mode}_{kind}"
        b_ms, b_by, ops, nbytes = bounds[name]
        plan = plans[kind]
        rows[name] = {
            "phase": "rnn_time", "kernel": name, "shape": "main",
            "dtype": str(dtype)[6:], "ms": k_ms[kind], "plain_ms": p_ms,
            "library_ms": l_ms, "bound_ms": b_ms, "bound_by": b_by,
            "ops": ops, "bytes": nbytes, "bound_share": b_ms / k_ms[kind],
            "barrier_floor_ms": floor,
            "library": f"cuDNN nn.{cls.__name__} "
                       + ("forward" if kind == "fwd"
                          else "backward alone on a retained graph"),
            "plain_and_library_cover":
                "the plain times cover the recurrence only; the library "
                "times also include the input projection x Wi^T + bi"
                + (" and its gradients" if kind == "bwd" else ""),
            "source": f"csrc/fused_rnn_{kind}_tc.cuh",
            "ms_simt": simt_ms[kind],
            "simt_over_tc": simt_ms[kind] / k_ms[kind],
            "simt": f"rnn_{kind}_kernel (csrc/fused_rnn.cuh), the same "
                    "inputs through _variant='simt'",
            "cluster_size": plan["C"], "hs": plan["hs"],
            "grid_ctas": plan["grid"], "smem_bytes": plan["smem_bytes"],
            "split_barrier_floor_ms": split_floor,
            "split_barrier_floor": "the tensor-core kernels' split "
                                   f"barrier alone, {T} arrive/wait pairs "
                                   "on the LSTM backward's launch",
            "ptxas": ptxas_report(log, f"rnn_{kind}_tc_kernel",
                                  ("G",)).get(f"G{_GATES[mode]}")}
        emit(rows[name])
    return rows


def rnn_train_main_path(mode, steps):
    """The full-width LM trained by ShardedTrainer: the launches of the
    mode's two kernels counted over ``steps`` timed steps."""
    from mxnet_tpu_torch.ops import fused_rnn_cuda as frc

    cfg = RNN_CFG
    B = cfg["batch"]
    tr = make_rnn_trainer(mode, cfg, B, "bfloat16")
    placed = tr._place_batch(rnn_batch(cfg, B))
    labels = placed["softmax_label"]
    lap(f"{mode}_train_setup")
    nll = []
    for _ in range(RNN_WARMUP):
        nll.append(nll_of(tr.step(placed)[0], labels))
    torch.cuda.synchronize()
    for name in frc.launches:          # the main path's window opens
        frc.launches[name] = 0
    step_ms = []
    t0 = time.perf_counter()
    for _ in range(steps):
        ts = time.perf_counter()
        probs = tr.step(placed)[0]
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - ts))
        nll.append(nll_of(probs, labels))
    wall = time.perf_counter() - t0
    launches = dict(frc.launches)      # ... and closes
    lap(f"{mode}_train_steps")
    profile = train_profile(tr, placed) if mode == "lstm" else None
    lap(f"{mode}_train_profile")
    want = cfg["num_layers"] * steps
    path = {k: v for k, v in launches.items() if k.startswith(mode)}
    # bf16: every forward and backward on the tensor-core kernels, none
    # on the others
    expected = {k: 0 if k.endswith("_simt") else want for k in path}
    tokens = cfg["seq_len"] * B
    # Adam at the example's lr 0.01 spikes the loss around step 5 on the
    # repeated batch: the LSTM's 12 steps end below the start, the GRU's 7
    # are held to having gone below it
    falls = nll[-1] < nll[0] if mode == "lstm" else min(nll[1:]) < nll[0]
    ok = (all(np.isfinite(nll)) and falls
          and path == expected
          and tuple(probs.shape) == (tokens, cfg["vocab"]))
    row = {"phase": f"train_{mode}", "dtype": "bfloat16", "config": cfg,
           "params": sum(p.numel() for p in tr.params.values()),
           "warmup_steps": RNN_WARMUP, "steps": steps,
           "kernel_launches": launches, "launches_expected": expected,
           "step_ms": step_ms, "step_ms_median": statistics.median(step_ms),
           "wall_s": wall, "tokens_per_s": tokens * steps / wall, "nll": nll,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "profile": profile, "ok": ok}
    emit(row)
    del tr, placed, probs
    torch.cuda.empty_cache()
    if not ok:
        raise SystemExit(f"full-width {mode} LM training failed its checks")
    return row


def rnn_grad_check():
    """One full-width float32 LSTM-LM step: gradients through the kernels
    vs through the eager scan (MXNET_TPU_FUSED_RNN=0), and through a
    planted faulty forward kernel, which must fail the bound."""
    from mxnet_tpu_torch.ops import fused_rnn_cuda as frc

    cfg = RNN_CFG
    batch = rnn_batch(cfg, cfg["batch"])
    real_fwd = frc.lstm_fwd_cuda

    def planted_fwd(*args, **kw):
        ys, *rest = real_fwd(*args, **kw)
        return (ys.to(torch.bfloat16).to(ys.dtype), *rest)

    grads, start = {}, None
    env = os.environ.get("MXNET_TPU_FUSED_RNN")
    for arm in ("kernel", "scan", "planted"):
        tr = make_rnn_trainer("lstm", cfg, cfg["batch"], "float32")
        if start is None:
            start = tr.get_params()
        else:
            tr.set_params(start)
        if arm == "scan":
            os.environ["MXNET_TPU_FUSED_RNN"] = "0"
        if arm == "planted":
            frc.lstm_fwd_cuda = planted_fwd
        try:
            grads[arm], _ = tr._grads_of(tr._place_batch(batch))
        finally:
            frc.lstm_fwd_cuda = real_fwd
            if env is None:
                os.environ.pop("MXNET_TPU_FUSED_RNN", None)
            else:
                os.environ["MXNET_TPU_FUSED_RNN"] = env
        del tr

    def worst_share(arm):
        worst, worst_name = 0.0, None
        for name, gk in grads[arm].items():
            gs = grads["scan"][name]
            share = float((gk - gs).abs().max()) / max(
                float(gs.abs().max()) * RNN_GRAD_REL, 1e-30)
            if share > worst:
                worst, worst_name = share, name
        return worst, worst_name

    worst, worst_name = worst_share("kernel")
    planted, _ = worst_share("planted")
    finite = all(bool(torch.isfinite(g).all())
                 for g in grads["kernel"].values())
    ok = finite and worst <= 1.0 and planted > 1.0
    emit({"phase": "rnn_grad_check", "dtype": "float32",
          "bound": "max|g_kernel - g_scan| <= 1e-4 max|g_scan| per param",
          "worst_share_of_bound": worst, "worst_param": worst_name,
          "planted_fault": "forward kernel's ys stored through bfloat16",
          "planted_worst_share_of_bound": planted,
          "planted_caught": planted > 1.0, "ok": ok})
    del grads
    torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("full-width LSTM gradients: kernels vs scan "
                         "disagree")


def rnn_small_train_check():
    """A small LSTM LM (V 53, T 16, N 4, H 32, 2 layers): the CUDA trainer
    (kernels: T >= 8) against the CPU trainer (the eager scan) from the
    same parameters, 3 Adam steps (lr 3e-3) in float32.  Outputs within
    1e-5 at step 1 and 1e-4 after; parameters within 2e-5 + 3 lr
    min(2, 1e-5 max|g| / |g_i|), as the GPT check derives."""
    cfg = dict(vocab=53, seq_len=16, batch=4, hidden=32, num_layers=2)
    batch = rnn_batch(cfg, 4, seed=3)
    lr = 3e-3
    cuda_tr = make_rnn_trainer("lstm", cfg, 4, "float32", lr=lr)
    cpu_tr = make_rnn_trainer("lstm", cfg, 4, "float32", device="cpu",
                              lr=lr)
    cpu_tr.set_params(cuda_tr.get_params())
    grads, _ = cpu_tr._grads_of(cpu_tr._place_batch(batch))
    out_err = []
    for _ in range(3):
        a = cuda_tr.step(batch)[0].cpu()
        b = cpu_tr.step(batch)[0]
        out_err.append(float((a - b).abs().max()))
    ok = out_err[0] <= 1e-5 and max(out_err) <= 1e-4
    worst = 0.0
    got, want = cuda_tr.get_params(), cpu_tr.get_params()
    for name in want:
        g = grads[name].abs().numpy()
        allowed = 2e-5 + 3 * lr * np.minimum(
            2.0, 1e-5 * float(g.max()) / np.maximum(g, 1e-30))
        worst = max(worst, float((np.abs(got[name] - want[name])
                                  / allowed).max()))
    ok = ok and worst <= 1.0
    emit({"phase": "rnn_small_train_check", "out_max_abs_err": out_err,
          "param_worst_share_of_bound": worst, "ok": ok})
    if not ok:
        raise SystemExit("small LSTM LM: CUDA vs CPU trainers disagree")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "chip_smoke.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import mxnet_tpu_torch  # noqa: F401  (fails alone: no package)
    from mxnet_tpu_torch import _build
    from mxnet_tpu_torch.ops import flash_attention_cuda as fac
    from mxnet_tpu_torch.ops import fused_rnn_cuda as frc
    from mxnet_tpu_torch.ops import paged_attention_cuda as pac

    REPORT["phase_seconds"] = PHASE_SECONDS
    _LAP[0] = _T_LAUNCH
    lap("imports_and_cuda_init")
    t_start = _LAP[0]

    card = card_line()
    name = torch.cuda.get_device_name(0)
    emit({"phase": "setup", "device": name, "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    # one nvcc per source, started together; while they run, the host
    # work that needs no kernel: the flash checks' draws and the
    # profiler's first start
    t0 = time.perf_counter()
    libs = (pac._fns, fac._lib, frc._lib)
    builds = [threading.Thread(target=f) for f in libs]
    for b in builds:
        b.start()
    overlap = {}
    for shape in FLASH_SHAPES.values():
        flash_draws(shape)
    flash_draws(FLASH_SHAPES["train"], seed=1)      # the timings' case
    overlap["flash_draws"] = time.perf_counter() - t0
    profiler_warmup()
    overlap["profiler_warmup"] = time.perf_counter() - t0
    for b in builds:
        b.join()
    for f in libs:                    # re-raise a failed build here
        f()
    for lib in (pac.LIB_NAME, fac.LIB_NAME, frc.LIB_NAME):
        emit({"phase": "build", "library": lib,
              "seconds": time.perf_counter() - t0,
              "nvcc_seconds": _build.BUILD_SECONDS.get(lib),
              "ptxas": _build.BUILD_LOGS.get(lib, "").strip()[-3000:]})
    paged_log = _build.BUILD_LOGS.get(pac.LIB_NAME, "")
    paged_ptxas = {k: ptxas_report(paged_log, k)
                   for k in ("paged_attention_split",
                             "paged_attention_combine")}
    emit({"phase": "ptxas", "library": pac.LIB_NAME, **paged_ptxas})
    emit({"phase": "overlapped_with_build", "seconds_since_start": overlap})
    lap("setup_and_build")

    # the slice's decode shape: 8 rows, contexts 1..160, one dead slot,
    # one padded row (table all null, pos 0 -> ctx 1); W = the engine's
    # table width at max_model_len=256
    decode_ctx = [1, 17, 48, 100, 160, 0, 1, 33]
    long_ctx = [2048] * 8
    # a mixed long batch: a dead row, a padded row (ctx 1 through an
    # all-null table), rows around one block, and long rows
    mixed_ctx = [0, 1, 15, 16, 17, 700, 1999, 2048]
    errs = {}
    for dtype in ("bfloat16", "float32", "int8"):
        errs[("decode", dtype)] = check_kernel(
            "decode", decode_ctx, dtype, W=16, nb=512,
            padded=(6,))
        errs[("long", dtype)] = check_kernel("long2048", long_ctx, dtype)
        check_kernel("mixed", mixed_ctx, dtype, padded=(1,))
        check_kernel("mixed_w300", mixed_ctx, dtype, window=300,
                     padded=(1,))
        for n in (1, 2048 // 16):     # one split; one block a split
            check_kernel("long2048", long_ctx, dtype, splits=n)
    dropped_split_check(long_ctx)
    lap("paged_checks")
    flash_rows = {}
    for tag, shape in FLASH_SHAPES.items():
        for dtype in (torch.bfloat16, torch.float32):
            flash_rows[(tag, dtype)] = check_flash(tag, shape, dtype)
    lap("flash_checks")
    rnn_rows = {}
    for mode in ("lstm", "gru"):
        for tag in RNN_SHAPES:
            for dtype in (torch.bfloat16, torch.float32):
                rnn_rows[(mode, tag, dtype)] = check_rnn(mode, tag, dtype)
        cudnn_check(mode)
    torch.cuda.empty_cache()
    lap("rnn_checks")

    small_model_check()
    lap("serve_small_model")
    np_params = serve_params()
    serve = serve_main_path(np_params)
    lap("serve")
    logits_check(np_params)
    del np_params
    lap("serve_logits_check")

    train = train_main_path()
    train_grad_check()
    lap("gpt_train_grad_check")
    small_train_check()
    lap("gpt_train_small_check")

    rnn_train = {"lstm": rnn_train_main_path("lstm", RNN_STEPS),
                 "gru": rnn_train_main_path("gru", GRU_STEPS)}
    lap("rnn_train_end")
    rnn_grad_check()
    lap("rnn_grad_check")
    rnn_small_train_check()
    lap("rnn_small_check")

    timings = {}
    for dtype in ("bfloat16", "float32", "int8"):
        timings[("decode", dtype)] = time_kernel(
            "decode", decode_ctx, dtype, W=16, nb=512,
            padded=(6,))
        timings[("long", dtype)] = time_kernel("long2048", long_ctx, dtype)
        timings[("mixed", dtype)] = time_kernel("mixed", mixed_ctx, dtype,
                                                padded=(1,))
    paged_split_sweep("decode", decode_ctx, (1, 2, 4, 8, 16), W=16, nb=512,
                      padded=(6,))
    paged_split_sweep("long2048", long_ctx, (1, 2, 4, 8, 16, 32, 64, 128))
    floor = launch_floor()
    lap("paged_time")
    flash_t = time_flash(FLASH_SHAPES["train"], torch.bfloat16)
    lap("flash_time")
    rnn_t = {**time_rnn("lstm"), **time_rnn("gru")}
    lap("rnn_time")
    main_t = timings[("decode", "bfloat16")]
    kernels = {"kernels": [{
        "name": "paged_attention_decode", "route": "cuda",
        "cuda_kernels": ["paged_attention_split", "paged_attention_combine"],
        "source": "mxnet_tpu_torch/csrc/paged_attention.cu",
        "replaces": "mxnet_tpu/ops/pallas_paged_attention.py:143",
        "launches": serve["kernel_launches"],
        "combine_launches": serve["combine_launches"],
        "splits": main_t["splits"],
        "blocks_per_split": main_t["blocks_per_split"],
        "max_abs_err": errs[("decode", "bfloat16")],
        "ms": main_t["ms"], "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"], "bound_by": main_t["bound_by"],
        "library_ms": main_t["library_ms"],
        "launch_floor_ms": floor["two_kernels_ms"
                                 if main_t["splits"] > 1
                                 else "one_kernel_ms"],
        "ptxas": paged_ptxas}]}
    train_err = flash_rows[("train", torch.bfloat16)]["max_abs_err_same_dtype"]
    # the plain and library backwards compute dq, dk and dv in one call:
    # the dQ and dK/dV entries carry that whole time, and the two kernels'
    # sum beside it
    bwd_ms = flash_t["flash_dq"]["ms"] + flash_t["flash_dkv"]["ms"]
    for kname, replaces, outs, cover in (
            ("flash_fwd", "mxnet_tpu/ops/flash_attention.py:406", ("o",),
             "o+lse"),
            ("flash_dq", "mxnet_tpu/ops/flash_attention.py:451", ("dq",),
             "dq+dk+dv"),
            ("flash_dkv", "mxnet_tpu/ops/flash_attention.py:497",
             ("dk", "dv"), "dq+dk+dv")):
        t = flash_t[kname]
        entry = {
            "name": kname, "route": "cuda",
            "source": f"mxnet_tpu_torch/csrc/{kname}_tc.cu",
            "replaces": replaces,
            "launches": train["kernel_launches"][kname],
            "max_abs_err": max(train_err[o] for o in outs),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "plain_and_library_cover": cover}
        if cover == "dq+dk+dv":
            entry["kernels_ms_dq_plus_dkv"] = bwd_ms
        kernels["kernels"].append(entry)
    for kname, replaces in (
            ("lstm_fwd", "mxnet_tpu/ops/pallas_lstm.py:102"),
            ("lstm_bwd", "mxnet_tpu/ops/pallas_lstm.py:206"),
            ("gru_fwd", "mxnet_tpu/ops/pallas_gru.py:79"),
            ("gru_bwd", "mxnet_tpu/ops/pallas_gru.py:161")):
        mode, kind = kname.split("_")
        t = rnn_t[kname]
        err = rnn_rows[(mode, "main", torch.bfloat16)]["max_abs_err"]
        entry = {
            "name": kname, "route": "cuda",
            "source": f"mxnet_tpu_torch/{t['source']}",
            "replaces": replaces,
            "launches": rnn_train[mode]["kernel_launches"][kname],
            "max_abs_err": max(err[o] for o in RNN_OUTPUTS[kind]
                               if o in err),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "barrier_floor_ms": t["barrier_floor_ms"],
            "plain_and_library_cover": t["plain_and_library_cover"],
            "launches_simt": rnn_train[mode]["kernel_launches"][
                f"{kname}_simt"]}
        entry.update({k: t[k] for k in (
            "ms_simt", "cluster_size", "hs", "split_barrier_floor_ms",
            "ptxas")})
        kernels["kernels"].append(entry)
    REPORT["kernels"] = kernels
    REPORT["card"] = card
    REPORT["seconds"] = time.perf_counter() - t_start
    REPORT["seconds_since_launch"] = time.perf_counter() - _T_LAUNCH
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(REPORT, f, indent=1)
    emit({"phase": "done", "seconds": REPORT["seconds"],
          "seconds_since_launch": REPORT["seconds_since_launch"],
          "phase_seconds": PHASE_SECONDS})
    print(card)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
