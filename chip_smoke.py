#!/usr/bin/env python3
"""The port's main path on one NVIDIA GPU: build, check, serve, time.

Run from the root of a checkout:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. set-up: the card's name and power limit (nvidia-smi), the kernel
     built by nvcc from mxnet_tpu_torch/csrc/ (build seconds printed);
  2. the paged-attention kernel held against its plain torch version on
     the card, at the serving decode shape and at a long-context shape,
     in bfloat16, float32 and int8+scales, each with its stated bound
     (bfloat16 element by element, relative to each output);
  3. the main path: a full-width 12-layer GPT (the repo's on-chip serve
     config, random weights from a seed) served by serve.Engine through
     the kernel — 8 concurrent requests, prompts 16/32/64/128, 32 new
     tokens each — with the kernel's launch count checked against
     12 x decode steps; then one decode step at full width in float32
     through the kernel and through the plain path, and a small model's
     tokens held against the single-request oracle and the CPU engine;
  4. timings with CUDA events (warm-up excluded, L2 flushed before each
     launch, medians): kernel, plain version, the SDPA yardstick, the
     bytes bound, and serving tokens/s.

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
    from mxnet_tpu_torch.ops import paged_attention_cuda as pac

    t_start = time.perf_counter()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    emit({"phase": "setup", "device": name, "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    t0 = time.perf_counter()
    pac._fn()
    emit({"phase": "build", "library": pac.LIB_NAME,
          "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.BUILD_SECONDS.get(pac.LIB_NAME),
          "ptxas": _build.BUILD_LOGS.get(pac.LIB_NAME, "").strip()[-2000:]})

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

    timings = {}
    for dtype in ("bfloat16", "float32", "int8"):
        timings[("decode", dtype)] = time_kernel(
            "decode", decode_ctx, dtype, W=16, nb=512,
            padded=(6,))
        timings[("long", dtype)] = time_kernel("long2048", long_ctx, dtype)
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
