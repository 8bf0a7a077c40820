#!/usr/bin/env python3
"""The port's main paths on one NVIDIA GPU: build, check, serve, train,
time.

Run from the root of a checkout:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. set-up: the card's name and power limit (nvidia-smi); the two kernel
     libraries built by nvcc from mxnet_tpu_torch/csrc/, one nvcc each,
     started together (build seconds and the ptxas report printed);
  2. kernels against their plain torch versions on the card, each with
     its stated bound: paged attention at the serving decode shape and at
     ctx 2048, in bfloat16, float32 and int8+scales; the flash-attention
     forward, dQ and dK/dV kernels (o, lse, dq, dk, dv, with a non-zero
     dlse) in bfloat16 and float32 at the training shape, at the same shape
     with the main path's strides (q, k, v bhsd views of one fused QKV
     projection, dO a bhsd view of a bshd tensor) and at two contract
     shapes (bshd, 12 q / 3 kv heads, Sq != Sk, offsets with fully-masked
     rows, a 256 window; and without a mask).  bfloat16 is
     held element by element, scaled by each output, and the check is
     shown to fail on an output that skipped one tile;
  3. serving: a full-width 12-layer GPT (the repo's on-chip serve config,
     random weights from a seed) served by serve.Engine through the
     paged kernel — 8 concurrent requests, prompts 16/32/64/128, 32 new
     tokens each — with its launches checked against 12 x decode steps;
     one full-width float32 decode step through the kernel and the plain
     path; a small model's tokens against the oracle and the CPU engine;
  4. training: bench.py's on-chip GPT (vocab 32768, S 1024, 8 layers,
     d_model 512, 8 heads, fused QKV, batch 16, bf16, Adam 3e-4, Xavier)
     trained by parallel.ShardedTrainer for 2 warm-up and 10 timed steps
     on bench.py's fixed synthetic batch, each flash kernel's launches
     checked against 8 x steps and the NLL finite and falling; one
     full-width float32 step's gradients through the kernels against the
     dense attention, the check shown to fail on a planted fault; a small
     model's CUDA trainer against its CPU
     trainer over 3 Adam steps;
  5. timings with CUDA events (warm-up excluded, L2 flushed before each
     launch, medians): each kernel, its plain version, a PyTorch
     yardstick (SDPA) and the bound computed from this run's shapes.

Prints JSON lines, then the card's name and power limit, then the
``kernels`` line, and last ``{"ok": true, "device": {...}}``.  Exits
non-zero without a result when CUDA is unavailable or the package is
missing.  The full report is also written to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

PEAK_BYTES_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_OPS_S = {torch.bfloat16: 989e12, torch.float32: 67e12,
              torch.int8: 1979e12}
SERVE_CFG = dict(vocab=50304, num_layers=12, d_model=768, num_heads=12,
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


def check_kernel(tag, ctx, dtype, **shape):
    from mxnet_tpu_torch.ops import paged_attention_cuda as pac
    from mxnet_tpu_torch.ops.attention import paged_attention_torch

    args, kw = paged_case(ctx, dtype, **shape)
    out = pac.paged_attention_cuda(*args, **kw)
    torch.cuda.synchronize()
    ref = paged_attention_torch(*args, **kw)
    err = float((out.float() - ref.float()).abs().max())
    row = {"phase": "kernel_check", "shape": tag, "dtype": dtype,
           "max_abs_err": err}
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
    finite = bool(torch.isfinite(out).all())
    empty = [b for b, c in enumerate(ctx) if c == 0]
    zeros = all(float(out[b].abs().max()) == 0.0 for b in empty)
    ok = finite and zeros and within
    row.update({"finite": finite, "empty_rows_zero": zeros, "ok": ok})
    emit(row)
    if not ok:
        raise SystemExit(f"kernel disagrees with plain path: {tag} {dtype}")
    return err


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
    saved = pac.launches
    k_ms = time_ms(lambda: pac.paged_attention_cuda(*args, **kw))
    pac.launches = saved              # timing launches are not the path's
    p_ms = time_ms(lambda: paged_attention_torch(*args, **kw))
    lib_ms = time_ms(sdpa_yardstick(args, kw))
    b_ms, b_by = bound_ms(args, kw)
    nbytes, tokens = live_bytes(args, kw)
    row = {"phase": "kernel_time", "shape": tag, "dtype": dtype,
           "ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
           "library": "F.scaled_dot_product_attention over pre-gathered "
                      "dense K/V (gather excluded)",
           "bound_ms": b_ms, "bound_by": b_by, "live_bytes": nbytes,
           "live_tokens": tokens, "bound_share": b_ms / k_ms}
    emit(row)
    return row


# -- phase 3: serving ---------------------------------------------------------
def serve_prompts(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, SERVE_CFG["vocab"], (n,)).astype(np.int32)
            for n in (16, 32, 64, 128, 16, 32, 64, 128)]


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
    pac.launches = 0                  # the main path's window opens
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
    n_layers = SERVE_CFG["num_layers"]
    toks = [r.tokens for r in reqs]
    ok = (all(r.status == "finished" and len(r.tokens) == 32 for r in reqs)
          and all(0 <= t < SERVE_CFG["vocab"] for ts in toks for t in ts)
          and launches == n_layers * eng.decode_steps
          and eng.decode_steps > 0)
    st = eng.stats()
    row = {"phase": "serve", "dtype": "bfloat16", "requests": len(reqs),
           "new_tokens": 32, "prompt_lens": [len(p) for p in prompts],
           "decode_steps": eng.decode_steps, "kernel_launches": launches,
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
# the slice's training model: bench.py's on-chip GPT (BENCH_MODEL=gpt)
TRAIN_CFG = dict(vocab=32768, seq_len=1024, num_layers=8, d_model=512,
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
# strides too); carried back through 8 layers and the softmax head that
# measured 1.9e-6 of max |grad| on an H100, so 2e-5 leaves a 10x margin.
# The check is shown to bind: the same step with a planted fault, a
# forward kernel that stores o through bfloat16 in float32 mode (2^-9
# relative, the size of a float32 path that rounds like the bf16 one),
# must fail it.
GRAD_REL = 2e-5


def flash_case(shape, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    B, Hq, Hkv, Sq, Sk, D = (shape[k] for k in ("B", "Hq", "Hkv", "Sq",
                                                "Sk", "D"))
    if shape["layout"] == "bhsd":
        qs, ks = (B, Hq, Sq, D), (B, Hkv, Sk, D)
    else:
        qs, ks = (B, Sq, Hq, D), (B, Sk, Hkv, D)
    dev = torch.device(DEVICE)
    if shape.get("fused"):
        # the model's operands: slices of one fused QKV projection (bhsd,
        # Sq == Sk) and dO as the gradient of attn.transpose(1, 2)
        dq_, dkv = Hq * D, Hkv * D
        qkv = torch.randn(B, Sq, dq_ + 2 * dkv, generator=g).to(dev, dtype)
        q = qkv[..., :dq_].view(B, Sq, Hq, D).transpose(1, 2)
        k = qkv[..., dq_:dq_ + dkv].view(B, Sk, Hkv, D).transpose(1, 2)
        v = qkv[..., dq_ + dkv:].view(B, Sk, Hkv, D).transpose(1, 2)
        do = torch.randn(B, Sq, Hq, D, generator=g).to(dev, dtype)
        do = do.transpose(1, 2)
    else:
        q, k, v, do = (torch.randn(s, generator=g).to(dev, dtype)
                       for s in (qs, ks, ks, qs))
    dlse = torch.randn(B, Hq, Sq, generator=g).to(dev)
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
    from mxnet_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_torch, flash_attention_fwd_torch)

    args, kw = flash_case(shape, dtype)
    q, k, v, do, dlse = args
    o, lse, dq, dk, dv = flash_through_autograd(*args, kw)
    torch.cuda.synchronize()
    up = [t.float() for t in (q, k, v, do)]
    p_o, p_lse = flash_attention_fwd_torch(*up[:3], **kw)
    p_grads = flash_attention_bwd_torch(*up[:3], o.float(), lse, up[3],
                                        dlse, **kw)
    A = magnitude_terms(q, k, v, o, lse, do, dlse, kw)
    got = {"o": o, "dq": dq, "dk": dk, "dv": dv}
    ref = dict(zip(("dq", "dk", "dv"), p_grads), o=p_o)
    row = {"phase": "flash_check", "shape": tag, "dtype": str(dtype)[6:]}
    ok = True
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


def time_flash(shape, dtype):
    from mxnet_tpu_torch.ops import flash_attention_cuda as fac
    from mxnet_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_torch, flash_attention_fwd_torch)

    F = torch.nn.functional
    (q, k, v, do, dlse), kw = flash_case(shape, dtype, seed=1)
    saved = dict(fac.launches)
    o, lse = fac.flash_fwd_cuda(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1).contiguous()
    bwd = (q, k, v, do, lse, delta, dlse)
    t = {"flash_fwd": time_ms(lambda: fac.flash_fwd_cuda(q, k, v, **kw)),
         "flash_dq": time_ms(lambda: fac.flash_dq_cuda(*bwd, **kw)),
         "flash_dkv": time_ms(lambda: fac.flash_dkv_cuda(*bwd, **kw))}
    fac.launches.update(saved)        # timing launches are not the path's
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
    profile = train_profile(tr, placed)
    want = cfg["num_layers"] * TRAIN_STEPS
    finite = all(np.isfinite(nll))
    ok = (finite and nll[-1] < nll[0]
          and all(n == want for n in launches.values())
          and tuple(probs.shape) == (TRAIN_BATCH * cfg["seq_len"],
                                     cfg["vocab"]))
    row = {"phase": "train", "dtype": "bfloat16", "config": cfg,
           "batch": TRAIN_BATCH, "params": sum(p.numel() for p in
                                               tr.params.values()),
           "warmup_steps": TRAIN_WARMUP, "steps": TRAIN_STEPS,
           "kernel_launches": launches, "launches_expected_each": want,
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
                      ("flash_dkv", "flash_dkv"), ("gemm", "matmul"),
                      ("xmma", "matmul"), ("cutlass", "matmul"),
                      ("nvjet", "matmul"),
                      ("softmax", "softmax"), ("embedding", "embedding"),
                      ("reduce", "reduction"), ("elementwise", "elementwise"),
                      ("vectorized", "elementwise"), ("copy", "copy")):
        if key in low:
            return kind
    return "other"


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
    from mxnet_tpu_torch.models import gpt_params
    from mxnet_tpu_torch.ops import flash_attention_cuda as fac
    from mxnet_tpu_torch.ops import paged_attention_cuda as pac

    t_start = time.perf_counter()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    emit({"phase": "setup", "device": name, "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    # one nvcc per library, started together
    t0 = time.perf_counter()
    builds = [threading.Thread(target=f) for f in (pac._fn, fac._lib)]
    for b in builds:
        b.start()
    for b in builds:
        b.join()
    pac._fn(), fac._lib()             # re-raise a failed build here
    for lib in (pac.LIB_NAME, fac.LIB_NAME):
        emit({"phase": "build", "library": lib,
              "seconds": time.perf_counter() - t0,
              "nvcc_seconds": _build.BUILD_SECONDS.get(lib),
              "ptxas": _build.BUILD_LOGS.get(lib, "").strip()[-3000:]})

    # the slice's decode shape: 8 rows, contexts 1..160, one dead slot,
    # one padded row (table all null, pos 0 -> ctx 1); W = the engine's
    # table width at max_model_len=256
    decode_ctx = [1, 17, 48, 100, 160, 0, 1, 33]
    long_ctx = [2048] * 8
    errs = {}
    for dtype in ("bfloat16", "float32", "int8"):
        errs[("decode", dtype)] = check_kernel(
            "decode", decode_ctx, dtype, W=16, nb=512,
            padded=(6,))
        errs[("long", dtype)] = check_kernel("long2048", long_ctx, dtype)
    flash_rows = {}
    for tag, shape in FLASH_SHAPES.items():
        for dtype in (torch.bfloat16, torch.float32):
            flash_rows[(tag, dtype)] = check_flash(tag, shape, dtype)
    torch.cuda.empty_cache()

    small_model_check()
    np_params = gpt_params(SERVE_CFG["vocab"], 256,
                           num_layers=SERVE_CFG["num_layers"],
                           d_model=SERVE_CFG["d_model"],
                           num_heads=SERVE_CFG["num_heads"],
                           kv_heads=SERVE_CFG["kv_heads"],
                           mlp=SERVE_CFG["mlp"], norm=SERVE_CFG["norm"],
                           pos_embed=SERVE_CFG["pos_embed"],
                           tie_embeddings=SERVE_CFG["tie_embeddings"],
                           seed=0)
    serve = serve_main_path(np_params)
    logits_check(np_params)
    del np_params

    train = train_main_path()
    train_grad_check()
    small_train_check()

    timings = {}
    for dtype in ("bfloat16", "float32", "int8"):
        timings[("decode", dtype)] = time_kernel(
            "decode", decode_ctx, dtype, W=16, nb=512,
            padded=(6,))
        timings[("long", dtype)] = time_kernel("long2048", long_ctx, dtype)
    flash_t = time_flash(FLASH_SHAPES["train"], torch.bfloat16)
    main_t = timings[("decode", "bfloat16")]
    kernels = {"kernels": [{
        "name": "paged_attention_decode", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/paged_attention.cu",
        "replaces": "mxnet_tpu/ops/pallas_paged_attention.py:143",
        "launches": serve["kernel_launches"],
        "max_abs_err": errs[("decode", "bfloat16")],
        "ms": main_t["ms"], "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"], "bound_by": main_t["bound_by"],
        "library_ms": main_t["library_ms"]}]}
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
            "source": "mxnet_tpu_torch/csrc/flash_attention.cu",
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
    REPORT["kernels"] = kernels
    REPORT["card"] = card
    REPORT["seconds"] = time.perf_counter() - t_start
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(REPORT, f, indent=1)
    emit({"phase": "done", "seconds": REPORT["seconds"]})
    print(card)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
