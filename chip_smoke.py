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
     int8+scales (float32 q), and with bfloat16 q over an int8 cache (the
     bf16 engine's kv_dtype="int8" decode) at the decode, ctx 2048 and
     mixed shapes and one forced split, each call counted once and
     combined exactly where it split; the paged bound shown to fail on the plain split and combine
     with one split's positions (512-639) dropped; the flash-attention
     forward, dQ and dK/dV kernels (o, lse, dq, dk, dv, with a non-zero
     dlse) in bfloat16 and float32 at the training shape, at the same shape
     with the main path's strides (q, k, v bhsd views of one fused QKV
     projection, dO a bhsd view of a bshd tensor) and at two contract
     shapes (bshd, 12 q / 3 kv heads, Sq != Sk, offsets with fully-masked
     rows, a 256 window; and without a mask).  bfloat16 is
     held element by element, scaled by each output, and the check is
     shown to fail on an output that skipped one tile; float32 is held
     to its own bound, shown at the training shape to tell the split-TF32
     forward's and dK/dV's three products from one TF32 product (torch
     models of both on the same inputs: the split passes, the single
     product fails); each check says which forward, dQ and dK/dV kernel
     ran (bf16: the tensor-core ones; float32: the split-TF32 forward and
     dK/dV and the float32-FMA dQ);
  3. serving: the paged op captured in a CUDA graph, replayed on new
     inputs, against an eager call (decode shape and ctx 2048, bit for
     bit); a full-width GPT (the repo's on-chip serve config, its depth
     cut from 12 layers to 4, random weights from a seed) served by
     serve.Engine at its defaults (prefix cache on, prefill_chunk 512):
     warmup() captures every (kind, bucket) program as a CUDA graph, then
     8 concurrent requests, prompts 16/32/64/128, 32 new tokens each,
     must capture nothing, with the paged launches, counted through the
     decode graphs' replays, checked against layers x decode steps and
     the combine launches against the decode buckets' split plans; a
     torch.profiler window over 16 decode-only steps (kernel ms, busy
     share, host ms a step) whose trace must hold layers x steps
     instances of each paged kernel, as many as the counters added; a
     restarted engine warmed from the serve
     engine's manifest serving the same prompts with no capture and the
     same tokens; the export store and tensor parallelism (serve_aot_tp,
     weights at std 0.05): a cold bf16 engine exporting the serve
     manifest's programs to a store (every one traced and saved, its
     tokens those of an engine without the store), a fresh process
     warming the manifest from the store (no trace, one capture a
     program, the cold tokens, the restored graphs' paged launches equal
     to a profiler trace's instances), a restamped (stale) artifact
     costing a counted trace and a functionalized program failing the
     in-place check and refused (planted); on
     MXTPU_TORCH_VIRTUAL_DEVICES=3, tp=3 float32 and float32 + int8-K/V
     tokens equal to tp=1's, bf16 flips with their margins, 4 x 3 paged
     launches a decode step counted and traced, a device's K/V bytes a
     third of the total on its shard tensors, a host block fetched and
     restored bit for bit, decode-step ms against tp=1, and a tp=3
     restart from a store with no trace and the same tokens; a float32
     engine with the prefix cache and 64-token
     chunks (8 requests on one 96-token prefix, a 200-token prompt)
     against a cache-off engine, token for token; one full-width float32
     decode step through the kernel and the plain path; a small model's
     captured engine (prefix cache, 8-token chunks) against the oracle
     and the CPU engine; speculative decoding (serve_spec) on
     tools/serve_bench.py's spec A/B (the target damped above its first
     layer, the draft that layer, k 4, 8 repeat-heavy prompts, 32 new
     tokens), bf16 engines spec-off and spec-on warmed over their full
     grids (verify, draft 1-8, draft_chunk 1-256 added), no capture in
     traffic, the paged launches counted through the draft graphs'
     replays against draft calls x (k+1) x draft layers and a profiler
     trace, the draft, verify and decode graphs' device ms, and the
     spec-on tokens against spec-off in float32 (bf16 flips reported
     with their margins); int8 serving (serve_int8): the bf16 engine with
     int8 K/V and with int8 weights and K/V, captured, no capture in
     traffic, launches as in serve, beside the bf16 engine's numbers; a
     float32 int8-K/V engine's decode-step logits through the kernel and
     the plain path, shown to fail on one block's scales zeroed; and the
     spec pairs again over int8 K/V; the host KV tier (serve_host_kv):
     tools/serve_bench.py's offload A/B at its defaults (6 prefixes of
     96 tokens x 6 rounds of 12-token suffixes, 32 new tokens, served
     one at a time) in float32 on a 23-block cache with the tier off
     and on (1 GiB), a 343-block cache and a cache-off engine, each
     warmed: hit rate >= 0.8 of the unconstrained one, >= 2x less
     prefill compute than tier-off, tokens equal in every arm, no
     capture in traffic, every restored block read back bit for bit,
     launches as in serve, a planted layer shift caught, the restore
     program's staging fence held and shown to bind; the pair over
     int8 K/V; a bf16 pair's tok/s, fetch ms, restore graph ms and time
     to first token; per-request sampling (serve_sample): the mixed
     sampling cycle beside a sampling-off engine (no capture in
     traffic, greedy rows equal, logprobs shaped), the captured decode
     graph's draws against the exact warped distribution (TV bound,
     temperature-ignored fault outside it, seeds), spec-off against
     spec-on at temperature 0.25 and their two-sample chi-square over
     192 two-token generations, and one seed's stream repeated; LoRA
     adapters (serve_lora): tools/serve_bench.py's lora A/B (3 adapters
     of rank 4, alpha 8, over every projection; rows cycling base and
     the three; 32 new tokens) in bf16, an adapters-off engine and the
     adapters engine warmed, the mix served twice with every row's
     adapter rotated (no capture), base rows equal to the off engine's,
     launches as in serve, agreement with each adapter's merged-weight
     engine, tok/s, the bucket-8 decode graphs and the decode step's
     kernels beside the off engine's; in float32 the same with exact
     agreement, one adapter row's first-step logits against its merged
     engine's, a fourth adapter registered after capture (its load
     evicting a cold one) serving its merged engine's tokens, and a
     planted load that rebinds the stacks caught; the engine's telemetry
     (serve_telemetry): the bf16 engine with the registry, the HTTP
     endpoint, request traces, flight dumps, every step's program calls
     timed by CUDA events and the NaN watchdog on; warmup() captures the
     grid while a thread polls /statusz.json, /metrics and /healthz
     (every response parses), the 8 prompts give the serve phase's
     tokens with no capture and its launch counts, the perf section's
     call counts equal the programs', the bucket-8 decode's event time
     agrees with its graph ms (TIMING_REL, TIMING_ABS_MS), MFU in (0, 1]
     and the /statusz, /metrics and perf_summary() views agree, each
     step's profile within STEP_WRAP_ABS_MS of this script's clock
     around the step and its dispatch and wait phases holding the
     step's event-timed device time, the artifacts parse and
     tools/metrics_report.py and trace_report.py render them, a
     profiler.trace() of 4 decode steps holds both paged kernels layers
     x 4 times, a float32 engine with a NaN weight row dumps
     numeric_anomaly with the watch on and nothing with it off; then
     tok/s and decode-step ms with telemetry off, on, and on with every
     step sampled, and the host microseconds a decode step spends in
     each part of the telemetry, off and on (recorded, not judged); the
     fleet (serve_fleet): every bf16 engine warmed from the serve
     manifest before traffic, a thread polling each replica's
     /statusz.json and /healthz throughout; one engine driven directly,
     cold and over its own cache; two ReplicaServers behind a Router
     under a Supervisor serving the 8 prompts at once with the serve
     phase's tokens, no capture, and the paged launches counted through
     both engines' replays equal to layers x decode steps and to a
     profiler trace's instances; both slots replaced by fresh engines,
     kill@2 on one mid-stream (every request once, the same tokens), a
     warm crash restart, the dead engine collected, the sibling drained
     and replaced under traffic with no client-visible failure; a
     prefill and a decode replica (host tier on) handing off K/V (bytes =
     blocks x the host block's bytes, restore programs run, the cached
     pass's tokens); an affinity router's pull hint landing a
     shared-prefix chain on the cold replica (prefill tokens computed
     falling by the pulled span, the warm replica's tokens) and a
     corrupted pull degrading to recompute; the process front at the
     serve config's widths spawned, killed by kill@2 and restarted by a
     Supervisor, its tokens an in-process engine's from the same numpy
     draw; tok/s routed and direct, router-added, handoff and pull ms,
     restart seconds; the fleet's sensors (serve_fleet_obs): C8, a
     warmed replica replaying the 8 prompts round after round while an
     unwarmed sibling in the same process serves them and captures in
     traffic, every round and the sibling's tokens the serve phase's,
     then the same in a child process in torch's global capture mode,
     which must fail (planted); a FleetCollector receiving two
     replicas' pushed trace lines, routed tok/s with it idle and
     scraping, decode-step ms inside a /profilez window and outside
     one, a 1.5 s delay fault on one replica breaking MXTPU_SLO_SPEC's
     latency objective until the fast-burn alert captures a trace there
     (done) and its flight dump carries the capture's id, /fleetz.json's
     token totals equal to the replicas' /statusz.json sums;
     capture_fleet over two process replicas under routed traffic, both
     windows accepted, each trace's paged split and combine instances
     (profiler.summarize) equal to layers x the decode steps of its
     window, tools/timeline_report.py --check over the router's and
     replicas' trace lines, their /statusz.json and both captures (rc
     0, nothing unanchored); ServeMonitor with MXTPU_TIMESERIES, a line
     every 8 steps, each a ring sample, the ring's last token count the
     engine's; the paged counters zeroed before the phase equal to
     layers x the decode steps of its in-process engines; the fleet's
     control plane (serve_fleet_control), every replica warmed from the
     serve manifest and the grid before traffic, a FleetCollector
     scraping every 0.3 s: an Autoscaler on AUTOSCALE_BENCH.json's spec
     (both=2:4, up_queue 1.5, down_idle_s 4, cooldown_s 2) scaling a pool
     of 2 up on a burst of 32 requests (24 at once, the collector
     scraping once the replicas queue them; the rest once the new
     replica is READY) and back down after the idle window: no
     client-visible failure, every request's tokens one warmed engine's,
     no capture in traffic, the retired replica collected and
     memory_allocated() back within 16 MiB; a Deployer rolling v2 (the
     weights re-exported through the host) under 8 streaming clients,
     ok with /fleetz.json's versions all v2, and v3 (another seed)
     rolled back on parity with every slot's canary tokens unchanged;
     the same v2 rollout in float32 (the control arm); a
     CatalogRebalancer attached to an adapters pool (rank 8, both=1:2)
     whose a1 burst on slot 0 scales it up, the autoscaler's rebalance
     pass moving a1 onto the new slot, which serves slot 0's a1 tokens;
     MXTPU_COMPILE_CACHE in two child processes (the paged library a
     miss and a put, then a hit with no miss and a paged call within
     its bound), a 15-day-old toolkit namespace pruned and, with
     max_entries 1, the library used last kept; the paged counters
     equal layers x the decode steps of every engine of the phase;
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
     trainer over 3 Adam steps; the same model built as the reference's
     Symbol (models.gpt_symbol) and trained by mod.Module on gpu(0) in
     float32 (the reference Module's dtype; Xavier, Adam 3e-4) for 2 + 10
     steps, each float32 flash kernel's launches checked against layers x
     steps (the forward and dK/dV on the split-TF32 kernels, none on the
     bf16 ones or the float32-FMA forward and dK/dV), the NLL finite and
     falling and
     the output (16384, 32768); the Module against ShardedTrainer from the
     same numpy parameters over 3 Adam steps; a tiny gpt_symbol Module on
     the card against the CPU's plain flash versions (outputs and every
     gradient), and its checkpoint through Module.load giving the same
     outputs;
  5. RNN training: the fused-LSTM and fused-GRU forward and backward
     kernels against their plain versions (ys, hT, cT, the residuals,
     dgx, dWh, dbh, dh0, dc0, non-zero hT/cT cotangents) in float32 and
     bfloat16 at the language model's shape (T 128, N 32, H 512) and at
     contract shapes (H 200 with N 3, T 1, a reverse direction's flipped
     input), each bound stated and shown to fail on planted faults, each
     check saying which forward and backward ran (the tensor-core ones:
     bf16, or float32 through split-TF32 products; the FMA ones held to
     the same bounds at the main shape, where in float32 the torch models
     of the split-TF32 products pass and their one-product models fail);
     the
     float32 kernels against cuDNN's nn.LSTM / nn.GRU; the RNN-op LM of
     examples/rnn_time_major.py (vocab 10,000, embedding and hidden 512,
     2 layers, T 128, N 32, bf16, Adam 0.01, Xavier) trained by
     ShardedTrainer for 2 + 10 steps as an LSTM and 2 + 5 as a GRU, each
     kernel's launches checked against 2 x steps (every backward on the
     tensor-core kernel, none on the other) and the NLL finite and
     falling; one full-width float32 step's gradients through the kernels
     against the eager scan, shown to fail on a planted fault; a small
     LSTM LM's CUDA trainer against its CPU trainer over 3 Adam steps;
     the sequence half of the training framework in float32, where the
     float32 fused kernels run: the RNN-op LM as a Symbol
     (tests/test_rnn.py:124-150 at the same width) trained by
     mod.BucketingModule over buckets 32/64/128 of rnn_io.
     BucketSentenceIter (SGD 0.01, momentum 0.9, wd 1e-5), 2 float32 LSTM
     forward and 2 backward launches a step in every bucket, no other
     launch and no scan step, the buckets' arrays aliased, the NLL of a
     held batch falling, one update a bucket against the float64 scan
     (shown to fail on a planted fault), a profile window and a Monitor
     step; model.FeedForward over the GRU LM (fit, predict, score, a
     save/load round trip predicting identically, the float32 GRU
     launches counted); a SequentialModule (body and head Modules)
     against the one-Module LM over 3 steps; CTCLoss on the card against
     the CPU (blank first and last, repeated and padded labels, lengths);
     the vision half in float32 with TF32 off (plain torch and cuDNN, no
     kernel of the repo): ResNet-18 (cifar stem, 32 x 32, batch 8)
     through mod.Module on the card against the CPU (probabilities, every
     gradient and every moving statistic after a training forward, an
     inference forward, NHWC against NCHW from the same OIHW weights, the
     NLL of a seeded batch falling over 5 SGD steps, a Module.load round
     trip bit for bit, and BatchNorm's moving statistics by F.batch_norm's
     rule planted and caught); ResNet-50 (bench.py:218-258,
     examples/train_imagenet.py's synthetic mode: 1000 classes,
     224 x 224, NCHW, batch 128, 8 batches) trained by
     model.FeedForward.fit (SGD 0.1, momentum 0.9, wd 1e-4,
     Xavier(in, 2.34), kvstore "local", Speedometer): images/s, step ms,
     peak memory, a profile window by kind (conv, batchnorm, pool, matmul,
     elementwise), FLOP/s against the float32 FMA peak, every parameter
     and moving statistic finite and on the card, every BatchNorm's
     moving statistics moved, no TF32 kernel traced, no flash or fused-RNN
     launch; the rest of the vision half in float32: SSD (filter_scale
     16, 300 x 300, batch 2) on the card against the CPU, the multibox
     ops bit for bit on the card's cls_preds, loc_preds and anchors (tie
     and collision cases included; an unstable ranking in mining and in
     NMS and the first writer winning the claim planted and caught) and
     the training graph against the CPU in float64 on the card's ReLU
     branches and matching; SSD-300 (examples/train_ssd.py: VGG16-reduced,
     20 classes, 8028 anchors, batch 32, its synthetic boxes, 5 epochs of
     2 batches) trained by mod.Module.fit (SGD 0.004, momentum 0.9, wd
     5e-4): batch ms, images/s, peak memory, the NLL and loc loss falling,
     a profile window by kind (multibox_target and nms by host range),
     no TF32 kernel, no flash or fused-RNN launch; the det graph over the
     trained weights (nms_topk 400, batch 32): images/s and the NMS ms;
     contrib.quantization on ResNet-18 (calibrated on the card; each
     calibrated layer's int32 product card == CPU bit for bit; the
     contractions through torch._int_mm; a float32 contraction at
     K = 4608 planted and caught) and ResNet-50 at 224 x 224, batch 32,
     float against weight-only against calibrated int8 (images/s,
     agreement); examples/numpy_ops.py's softmax as a CustomOp and a
     NumpyOp trained through Module against the built-in SoftmaxOutput
     (host round-trip ms); and, run after the serve phases,
     serve.Engine(symbol=) over a Module-trained gpt_symbol's checkpoint:
     the explicit-config engine's tokens through the paged kernel,
     launches counted and traced, a one-layer draft from draft_symbol=, a
     contradicting num_heads raising;
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
     kernel's ptxas registers and spills, then the float32 kernels (the
     Module path's) at the training shape beside SDPA in float32, the
     split-TF32 forward and dK/dV each with the float32-FMA one beside
     it, their ptxas registers and spills, and both their bounds (3 TF32
     products at 495 TFLOP/s; float32 FMAs at 67), and
     for the RNN kernels the
     barrier floor (an
     empty cooperative kernel of T grid barriers), and for each RNN
     kernel the other (FMA) kernel at the same inputs, the tensor-core
     kernel's cluster size, units a CTA, microseconds a step, ptxas
     registers and spills and the floor of its split barrier (T
     arrive/wait pairs alone), then the float32 RNN kernels (the Module
     family's path) beside cuDNN in float32, with both their bounds.

Prints JSON lines, then the card's name and power limit, then the
``kernels`` line, and last ``{"ok": true, "device": {...}}``.  Exits
non-zero without a result when CUDA is unavailable or the package is
missing.  The full report is also written to chiprun_out/chip_smoke.json.

    python3 chip_smoke.py --overhead [--package DIR]

runs only serve_telemetry's overhead arms (the paged library built, the
serve config's bf16 engine on the serve prompts) with the package
imported from DIR, the checkout of another commit: an older package
without the telemetry runs the telemetry-off arm alone.  Runs of two
commits in one call, alternated, compare the telemetry-off engine
across them.  Prints the card line and one JSON line.

    python3 chip_smoke.py --fleet

runs only the serve phase, serve_fleet, serve_fleet_obs and
serve_fleet_control (their lines, then the card line).

    python3 chip_smoke.py --aot-tp

runs only the serve phase, serve_restart and serve_aot_tp.

    python3 chip_smoke.py --train-module

runs only the float32 flash checks at every flash shape (with the
planted one-product TF32 dK/dV), the train phase, the float32 gradient
check, train_module, module_vs_trainer, module_small_check and the
float32 flash timings (their lines, then the card line).

    python3 chip_smoke.py --train-seq

runs only the float32 RNN kernel checks at every RNN shape (with the
planted one-product TF32 backward at the main shape) and against cuDNN,
train_bucketing, train_feedforward, module_family_check,
ctc_card_check and the float32 RNN timings (their lines, then the card
line).

    python3 chip_smoke.py --train-vision

runs only vision_small_check and train_vision (their lines, then the
card line).

    python3 chip_smoke.py --detect

runs only serve_symbol, detect_small_check, train_ssd, detect_ssd,
quant_check, infer_int8 and custom_op_check (the paged and flash
libraries built first; their lines, then the card line).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import glob
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
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
PEAK_TF32_OPS_S = 495e12      # dense TF32 on the tensor cores (same sheet)
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
#  bfloat16, and int8 caches with bfloat16 q: the kernel reads the bf16
#    (or int8 and float32 scale) values, computes in float32 and rounds
#    once, to nearest, at the end (|error| <= 2^-8 |x|).  So it is held
#    element by element against the plain path run in float32 on the
#    same values (the upcast is exact; the kernel folds an int8 cache's
#    scales into scores and weights, the plain path into K and V, one
#    float32 rounding apart):
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
    """Collect the garbage the phase left, then record the seconds since
    the previous lap under ``phase``.  An engine is a reference cycle: one
    the collector frees later, inside another phase, shows on that
    phase's /statusz page until then and frees its graphs amid that
    phase's steps."""
    import gc

    gc.collect()
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
    kernel must mask it by position, not by block id).  ``dtype`` is
    "bfloat16", "float32", "int8" (float32 q, int8 cache with scales)
    or "int8_bf16q" (bfloat16 q, int8 cache: the bf16 engine's
    ``kv_dtype="int8"`` decode)."""
    g = torch.Generator().manual_seed(seed)
    B = len(ctx)
    need = [0 if b in padded else -(-c // bs) for b, c in enumerate(ctx)]
    W = W or max(max(need), 1)
    nb = nb or sum(need) + 1
    quant = dtype in ("int8", "int8_bf16q")
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
    if dtype in ("bfloat16", "int8_bf16q"):
        # an int8 cache stays int8: the float32 plain path dequantizes
        # the same values in float32
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


def captured_kernel_check(ctx, tag, **shape):
    """The paged op as the engine's decode graphs hold it: captured in a
    CUDA graph on inputs it then reads anew, a replay must equal an eager
    call on the same inputs bit for bit.  At both shapes the split
    kernel's 4-stage ring of 64-position slots takes 64 KB of shared
    memory, over the 48 KB default, so its launch sets the kernel's
    attribute inside the capture.  The capture itself counts one call on
    the host, as the engine's programs see it."""
    from mxnet_tpu_torch.ops import paged_attention_cuda as pac

    args, kw = paged_case(ctx, "bfloat16", **shape)
    static = [a.clone() for a in args]
    before = (pac.launches, pac.combine_launches)
    pac.paged_attention_cuda(*static, **kw)          # eager first: build
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pac.paged_attention_cuda(*static, **kw)
    counted = pac.launches - before[0] == 2
    pac.launches, pac.combine_launches = before   # checks are not the path
    # new inputs into the captured addresses: q and the cache rows
    fresh, _ = paged_case(ctx, "bfloat16", seed=1, **shape)
    for s, f in zip(static, fresh):
        s.copy_(f)
    graph.replay()
    eager = pac.paged_attention_cuda(*static, **kw)
    torch.cuda.synchronize()
    pac.launches, pac.combine_launches = before
    same = torch.equal(out, eager)
    within, fields = paged_bound_row(out, static, kw, "bfloat16")
    ok = same and within and counted
    emit({"phase": "captured_kernel_check", "shape": tag,
          **paged_plan(static), "replay_equals_eager": same,
          "counted_at_capture": counted, **fields, "ok": ok})
    del graph
    if not ok:
        raise SystemExit(f"captured paged op disagrees: {tag}")


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


def serve_params(seed=0, std=0.02):
    """The serving model's random weights, drawn on the card from a seed
    (a host draw of ~67M values would take seconds): gpt()'s argument
    names and shapes with gpt_params' scales (weights N(0, std^2), std
    0.02 by default, biases and norm shifts 0, norm gains 1),
    float32."""
    from mxnet_tpu_torch.models import gpt_arguments

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    params = {}
    for arg, shp in gpt_arguments(SERVE_CFG["vocab"], 256,
                                  **{k: v for k, v in SERVE_CFG.items()
                                     if k != "vocab"}):
        s = std if arg.endswith("weight") else 0.0
        params[arg] = (torch.randn(shp, generator=g, device=DEVICE) * s
                       + (1.0 if arg.endswith("gamma") else 0.0))
    return params


def full_width_engine(np_params, dtype, **kw):
    """The serve config's engine at the engine's defaults (prefix cache
    on, prefill_chunk 512), 512 blocks of 16, batch 8 and 256 tokens,
    unless ``kw`` says otherwise."""
    from mxnet_tpu_torch import serve

    kw = {"num_blocks": 512, "max_batch": 8, "max_model_len": 256, **kw}
    return serve.Engine(np_params, num_heads=SERVE_CFG["num_heads"],
                        window=0, device=DEVICE, dtype=dtype, block_size=16,
                        **kw)


def captures_expected(eng, ready):
    """What ``warmup()`` of ``ready`` programs captures: one graph each
    on CUDA, none on the CPU (a rehearsal)."""
    return ready if eng.device.type == "cuda" else 0


PAGED_KERNELS = ("paged_attention_split", "paged_attention_combine")


def traced_kernels(logdir):
    """Device ms and instances by kernel name in the newest trace under
    ``logdir``, read by ``profiler.summarize`` (the reader ``/profilez``
    artifacts share): ``({name: ms}, {name: count})``."""
    from mxnet_tpu_torch import profiler

    rows = profiler.summarize(logdir, top=1 << 30)
    return ({name: ms for name, ms, _ in rows},
            {name: n for name, _, n in rows})


def window_kernels(logdir, window):
    """Device ms and instances by kernel name (``traced_kernels``' device
    events) of the work launched inside the range ``window`` (a
    ``profiler.scope``) of the trace under ``logdir``: the events whose
    correlation id is that of a host runtime call inside the range."""
    import gzip

    (trace_file,) = glob.glob(os.path.join(logdir, "plugins", "profile",
                                           "*", "*.trace.json.gz"))
    with gzip.open(trace_file) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    device = ("kernel", "gpu_memcpy", "gpu_memset")
    (rng,) = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("name") == window]
    t0, t1 = rng["ts"], rng["ts"] + rng["dur"]
    corrs = {e["args"]["correlation"] for e in events
             if e.get("cat") not in device and t0 <= e["ts"] <= t1
             and "correlation" in e.get("args", {})}
    ms, counts = collections.Counter(), collections.Counter()
    for e in events:
        if e.get("cat") in device and e.get("args", {}).get(
                "correlation") in corrs:
            ms[e["name"]] += e["dur"] / 1e3
            counts[e["name"]] += 1
    return dict(ms), dict(counts)


def graph_replays(trace_file):
    """The CUDA graph replays of a profiler trace (its ``cudaGraphLaunch``
    runtime events, in time order), each with the device events and
    paged split kernels its correlation id carries: which replays, if
    any, reached the trace without their kernels, and where in the
    window they sat."""
    import gzip

    with gzip.open(trace_file) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    launches = sorted((e for e in events
                       if e.get("name") == "cudaGraphLaunch"),
                      key=lambda e: e["ts"])
    device, split = collections.Counter(), collections.Counter()
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            corr = e.get("args", {}).get("correlation")
            device[corr] += 1
            if PAGED_KERNELS[0] in e["name"]:
                split[corr] += 1
    corrs = [e.get("args", {}).get("correlation") for e in launches]
    empty = [i for i, c in enumerate(corrs) if not device[c]]
    return {"graph_launches": len(launches),
            "launches_without_device_events": empty[:20],
            "split_kernels_by_correlation": sum(split[c] for c in corrs),
            "split_kernels": sum(split.values()),
            "device_events": sum(device.values())}


def replay_gaps(trace_file, per_replay):
    """Where a profiler window's trace lost paged split kernels: each CUDA
    graph replay (``cudaGraphLaunch``, in time order) whose correlation
    id carries other than ``per_replay`` split kernels, with its index,
    its host time after the window's first replay and before its last
    (ms), and the split kernels it carries; plus the split kernels whose
    correlation id is no replay's, and the window's replay count."""
    import gzip

    with gzip.open(trace_file) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    launches = sorted((e for e in events
                       if e.get("name") == "cudaGraphLaunch"),
                      key=lambda e: e["ts"])
    split = collections.Counter()
    for e in events:
        if e.get("cat") == "kernel" and PAGED_KERNELS[0] in e["name"]:
            split[e.get("args", {}).get("correlation")] += 1
    corrs = [e.get("args", {}).get("correlation") for e in launches]
    t_first = launches[0]["ts"] if launches else 0
    t_last = launches[-1]["ts"] if launches else 0
    short = [{"replay": i, "split_kernels": split[c],
              "ms_after_first": (e["ts"] - t_first) / 1e3,
              "ms_before_last": (t_last - e["ts"]) / 1e3}
             for i, (e, c) in enumerate(zip(launches, corrs))
             if split[c] != per_replay]
    return {"replays": len(launches), "short_replays": short[:20],
            "orphan_split_kernels": sum(n for c, n in split.items()
                                        if c not in set(corrs))}


def paged_instances(counts):
    """The paged kernels' instances among ``traced_kernels``' counts."""
    return {k: sum(c for name, c in counts.items() if k in name)
            for k in PAGED_KERNELS}


SERVE_WINDOW = "chip_smoke.serve_window"


def serve_profile(eng, prompts, steps=16):
    """Serve ``prompts`` once more on ``eng`` and profile ``steps``
    decode-only steps (torch.profiler): kernel ms a step, the device's
    busy share of the window's wall time, host ms a step (wall minus
    kernels: the time the device waits for the host), and the paged
    kernels' instances in the trace beside what the op's launch
    counters added over the window.  The window is a range inside the
    capture, after one decode step of its own: the capture's first graph
    replay can reach the trace without its first kernels (ROADMAP
    §C14), so only the work launched inside the range is read."""
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.ops import paged_attention_cuda as pac

    for p in prompts:
        eng.submit(p, max_new_tokens=32)
    sched = eng.scheduler
    while eng.has_work() and (sched.queue_depth or sched.prefilling
                              or not sched.running):
        eng.step()
    torch.cuda.synchronize()
    n = 0
    with tempfile.TemporaryDirectory() as logdir:
        with profiler.trace(logdir):
            eng.step()
            torch.cuda.synchronize()
            counted = (pac.launches, pac.combine_launches)
            with profiler.scope(SERVE_WINDOW):
                t0 = time.perf_counter()
                while n < steps and eng.has_work():
                    eng.step()
                    n += 1
                torch.cuda.synchronize()
                wall_ms = 1e3 * (time.perf_counter() - t0)
        kernels, counts = window_kernels(logdir, SERVE_WINDOW)
        counted = (pac.launches - counted[0],
                   pac.combine_launches - counted[1])
        traced = paged_instances(counts)
        gap = None
        if traced["paged_attention_split"] != counted[0]:
            # which replays lost their kernels, and where in the window
            files = glob.glob(os.path.join(logdir, "plugins", "profile",
                                           "*", "*.trace.json.gz"))
            gap = replay_gaps(files[0], eng._cfg.n_layers * eng.tp) \
                if files else {"trace_files": 0}
            print(json.dumps({"profile_gap": gap, "traced": traced,
                              "counted": counted}), file=sys.stderr,
                  flush=True)
    eng.run()
    kinds = {}
    for name, ms in kernels.items():
        kind = _kernel_kind(name)
        kinds[kind] = kinds.get(kind, 0.0) + ms / n
    device_ms = sum(kernels.values()) / n
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return {"decode_steps": n, "wall_ms_per_step": wall_ms / n,
            "kernel_ms_per_step": device_ms,
            "kernels_per_step": sum(counts.values()) / n,
            "busy_share": device_ms * n / wall_ms,
            "host_ms_per_step": wall_ms / n - device_ms,
            "traced_paged_kernels": traced,
            "counted_paged_launches": {
                "paged_attention_split": counted[0],
                "paged_attention_combine": counted[1]},
            "gap": gap,
            "ms_per_step_by_kind": kinds,
            "top_kernels_ms_per_step": [(k[:120], ms / n) for k, ms in top]}


def serve_main_path(np_params, manifest_path):
    """Serve the 8 prompts through the engine's entry points: every
    program is captured by ``warmup()`` first and the traffic must
    capture nothing; launches counted through the decode graphs'
    replays.  Then a profiler window over decode-only steps, whose trace
    must hold each paged kernel layers x steps times, as many as the
    counters added; and the manifest of what the traffic ran saved to
    ``manifest_path``."""
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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ready = eng.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm_caps = eng.captures
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
    st = eng.stats()
    traffic_caps = eng.captures - warm_caps
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
          and combines == launches
          and ready == len(eng._warmup_grid())
          and warm_caps == captures_expected(eng, ready)
          and traffic_caps == 0)
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
           "preemptions": st.preemptions, "warmup_programs": ready,
           "warmup_s": warm_s, "warmup_captures": warm_caps,
           "traffic_captures": traffic_caps,
           "program_calls": {f"{k}/{b}": p.calls for (k, b), p
                             in sorted(eng._programs.items()) if p.calls}}
    prof = serve_profile(eng, prompts)
    # the trace's own count of the kernels that ran: each decode step
    # launches both paged kernels once a layer, and the counters the
    # replays advanced must agree with it
    want = n_layers * prof["decode_steps"]
    traced = prof["traced_paged_kernels"]
    ok = ok and (prof["decode_steps"] > 0
                 and all(c == want for c in traced.values())
                 and prof["counted_paged_launches"] == traced)
    if decode_ms:
        # an estimate across two windows: the profiled window's kernels
        # against the unprofiled decode-only steps' wall
        step = row["decode_step_ms_mean"]
        prof["busy_share_estimate_unprofiled"] = (
            prof["kernel_ms_per_step"] / step)
        prof["host_ms_per_step_estimate_unprofiled"] = (
            step - prof["kernel_ms_per_step"])
    row["profile"] = prof
    row["ok"] = ok
    emit(row)
    eng.save_manifest(manifest_path)
    eng.shutdown()
    if not ok:
        raise SystemExit("full-width serve failed its checks")
    return row, toks


def serve_restart(np_params, toks_a, manifest_path):
    """The reference's cold/warm restart gate on the card: a new engine
    warms from the serve phase's manifest, then serves the same prompts
    capturing nothing, with the serve phase's tokens."""
    with open(manifest_path) as f:
        listed = sum(1 for line in f if line.strip())
    eng = full_width_engine(np_params, torch.bfloat16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ready = eng.warmup(manifest_path)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    caps = eng.captures
    reqs = [eng.submit(p, max_new_tokens=32) for p in serve_prompts(0)]
    eng.run()
    toks = [r.tokens for r in reqs]
    same = toks == toks_a
    ok = (0 < ready == listed and caps == captures_expected(eng, ready)
          and eng.captures == caps and same)
    row = {"phase": "serve_restart", "manifest_programs": listed,
           "warmup_programs": ready, "warmup_s": warm_s,
           "warmup_captures": caps, "traffic_captures": eng.captures - caps,
           "tokens_identical": same, "ok": ok}
    emit(row)
    eng.shutdown()
    if not ok:
        raise SystemExit("warm restart captured again or changed tokens")
    return row


def first_logits(eng, seq, slot=None):
    """The logits after ``seq`` through ``eng``'s prefill body, eager, on
    a scratch cache, float32; with ``slot`` through that adapter slot's
    stacks."""
    from mxnet_tpu_torch.serve import engine as engine_mod

    n, bs = len(seq), eng.block_size
    shape = (eng._cfg.n_layers, -(-n // bs) + 1, bs, eng._cfg.kv_heads,
             eng._cfg.head_dim)
    ck = torch.zeros(shape, dtype=eng._cache_k.dtype, device=DEVICE)
    cv = torch.zeros_like(ck)
    scales = ()
    if eng._cfg.kv_quant:
        ks = torch.zeros(shape[:-1], dtype=torch.float32, device=DEVICE)
        scales = (ks, torch.zeros_like(ks))
    adp = {}
    if slot is not None:
        adp = {"adp": eng.adapter_store.device,
               "slot": torch.tensor(slot, dtype=torch.int32, device=DEVICE)}
    pos = torch.arange(n, device=DEVICE)
    with torch.no_grad():
        return engine_mod._prefill_logits(
            eng._cfg, n, eng.params, ck, cv,
            torch.tensor(np.asarray(seq), device=DEVICE), n,
            pos // bs + 1, pos % bs, *scales, **adp)[0].float()


def logit_margin(eng, seq):
    """Top-1 minus top-2 logit after ``seq`` (:func:`first_logits`)."""
    top = torch.topk(first_logits(eng, seq), 2).values
    return float(top[0] - top[1])


def flips(eng, prompts, want, got):
    """Each request whose stream differs: its first differing token and
    the logit margin there, on ``eng`` (the engine ``want`` came from)."""
    out = []
    for i, (p, a, b) in enumerate(zip(prompts, want, got)):
        if a == b:
            continue
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        out.append({"request": i, "token": j,
                    "want": a[j] if j < len(a) else None,
                    "got": b[j] if j < len(b) else None,
                    "margin": logit_margin(eng, list(p) + a[:j])})
    return out


def serve_prefix(np_params):
    """Full width, float32 (TF32 off): 8 requests on one 96-token prefix
    with distinct 8-40-token suffixes, and a 200-token prompt prefilled
    in chunks of 64, on the engine with the prefix cache; its tokens must
    equal a prefix_cache=False, prefill_chunk=0 engine's on the card.  A
    flipped token fails the phase, printed with its logit margin."""
    rng = np.random.RandomState(5)
    V = SERVE_CFG["vocab"]
    prefix = rng.randint(0, V, (96,)).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.randint(0, V, (n,))
                               .astype(np.int32)])
               for n in (8, 12, 16, 20, 24, 28, 36, 40)]
    prompts.append(rng.randint(0, V, (200,)).astype(np.int32))
    got = {}
    for tag, kw in (("cached", dict(prefill_chunk=64)),
                    ("cold", dict(prefix_cache=False, prefill_chunk=0))):
        eng = full_width_engine(np_params, torch.float32, **kw)
        reqs = [eng.submit(p, max_new_tokens=16) for p in prompts]
        eng.run()
        got[tag] = (eng, [r.tokens for r in reqs], eng.stats(),
                    {f"{k}/{b}": p.calls for (k, b), p
                     in sorted(eng._programs.items())})
    cold, want, _, _ = got["cold"]
    cached, toks, st, calls = got["cached"]
    bad = flips(cold, prompts, want, toks)
    chunk_calls = {k: n for k, n in calls.items() if k.startswith("chunk")}
    ok = (not bad and st.prefix_hits > 0 and sum(chunk_calls.values()) > 0
          and all(len(t) == 16 for t in toks))
    emit({"phase": "serve_prefix", "dtype": "float32",
          "tf32": torch.backends.cuda.matmul.allow_tf32,
          "prompt_lens": [len(p) for p in prompts], "prefill_chunk": 64,
          "prefix_hits": st.prefix_hits,
          "prefix_tokens_saved": st.prefix_tokens_saved,
          "prefill_tokens_computed": st.prefill_tokens_computed,
          "cold_prefill_tokens_computed":
              got["cold"][2].prefill_tokens_computed,
          "chunk_calls_by_bucket": chunk_calls, "program_calls": calls,
          "captures": cached.captures, "tokens_equal_cold": not bad,
          "flips": bad, "ok": ok})
    for eng, *_ in got.values():
        eng.shutdown()
    if not ok:
        raise SystemExit("prefix-cache serving disagrees with the cold "
                         "engine (or never hit / never chunked)")


def logits_check(np_params):
    """One full-width float32 decode step, kernel vs plain attention
    inside the engine (its decode body, eager), on the same cache and
    inputs."""
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
                *(torch.from_numpy(a).to(DEVICE) for a in (toks, pos,
                                                            tables)))
    err = float((outs["cuda"] - outs["torch"]).abs().max())
    same = bool((outs["cuda"].argmax(-1) == outs["torch"].argmax(-1)).all())
    ok = err <= LOGITS_BOUND and bool(torch.isfinite(outs["cuda"]).all())
    emit({"phase": "logits_check", "dtype": "float32", "batch": B,
          "max_abs_err": err, "bound": LOGITS_BOUND,
          "argmax_equal": same, "ok": ok})
    eng.shutdown()
    if not ok:
        raise SystemExit("engine decode step: kernel vs plain disagree")


# -- serving: speculative decoding and int8 ---------------------------------
# tools/serve_bench.py's spec A/B (--workload spec): --spec-k 4,
# --draft-layers 1, --distill-scale 0.05
SPEC_K = 4
DRAFT_LAYERS = 1
DISTILL_SCALE = 0.05


def distill_family(params, layers, draft_layers=DRAFT_LAYERS,
                   scale=DISTILL_SCALE):
    """tools/serve_bench.py ``distill_family``: the target is ``params``
    with every layer >= ``draft_layers`` damped (proj and ff_down scaled
    by ``scale``), the draft is that target's first ``draft_layers``
    layers."""
    target = dict(params)
    for k, v in params.items():
        for i in range(draft_layers, layers):
            if k.startswith(f"gpt_l{i}_") and (
                    k.endswith("proj_weight")
                    or k.endswith("ff_down_weight")):
                target[k] = v * scale
    cut = tuple(f"gpt_l{i}_" for i in range(draft_layers, layers))
    return target, {k: v for k, v in target.items()
                    if not k.startswith(cut)}


def repeat_heavy_prompts(seed=3):
    """tools/serve_bench.py ``build_repeat_heavy_workload``: 8 requests
    cycling lengths 16/32/64/128, each a random motif of n/8 tokens tiled
    to length n with its last n/8 tokens random."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(8):
        n = (16, 32, 64, 128)[i % 4]
        motif = rng.randint(0, SERVE_CFG["vocab"], (max(2, n // 8),))
        prompt = np.tile(motif, -(-n // motif.size))[:n]
        tail = max(1, n // 8)
        prompt[-tail:] = rng.randint(0, SERVE_CFG["vocab"], (tail,))
        out.append(prompt.astype(np.int32))
    return out


def drive(eng, prompts, new_tokens=32, cfg_fn=None, sequential=False,
          reqs_out=None):
    """Serve ``prompts`` once through the engine's entry points, the
    paged counters set to 0 just before and read just after; the wall
    ms of each decode-only step (nothing queued).  ``cfg_fn(i)`` gives
    request i's sampling kwargs; ``sequential`` serves one request at a
    time, each to its end (tools/serve_bench.py's concurrency 1);
    ``reqs_out`` (a list) receives the request handles."""
    from mxnet_tpu_torch.ops import paged_attention_cuda as pac

    calls0 = {k: p.calls for k, p in eng._programs.items()}
    caps0, steps0 = eng.captures, eng.decode_steps
    gen0 = eng.stats().tokens_generated
    torch.cuda.synchronize()
    pac.launches = pac.combine_launches = 0
    t0 = time.perf_counter()
    reqs = []
    step_ms = []
    for i, p in enumerate(prompts):
        reqs.append(eng.submit(p, max_new_tokens=new_tokens,
                               **(cfg_fn(i) if cfg_fn else {})))
        if sequential:
            eng.run()
    while eng.has_work():
        decode_only = (eng.scheduler.queue_depth == 0
                       and bool(eng.scheduler.running))
        ts = time.perf_counter()
        eng.step()
        if decode_only:
            step_ms.append(1e3 * (time.perf_counter() - ts))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, combines = pac.launches, pac.combine_launches
    calls = {}
    for (kind, b), p in eng._programs.items():
        n = p.calls - calls0.get((kind, b), 0)
        if n:
            calls[kind] = calls.get(kind, 0) + n
    st = eng.stats()
    if reqs_out is not None:
        reqs_out.extend(reqs)
    return {"tokens": [r.tokens for r in reqs],
            "finished": all(r.status == "finished"
                            and len(r.tokens) == new_tokens for r in reqs),
            "kernel_launches": launches, "combine_launches": combines,
            "program_calls": calls,
            "decode_steps": eng.decode_steps - steps0,
            "traffic_captures": eng.captures - caps0,
            "tokens_generated": st.tokens_generated - gen0, "wall_s": wall,
            "tok_per_s": (st.tokens_generated - gen0) / wall,
            "decode_only_steps": len(step_ms),
            "decode_step_ms_mean": (statistics.mean(step_ms)
                                    if step_ms else None),
            "decode_step_ms_median": (statistics.median(step_ms)
                                      if step_ms else None),
            "spec_verifies": st.spec_verifies,
            "spec_accept_rate": st.spec_accept_rate,
            "accepted_per_verify": st.accepted_per_verify,
            "tokens_per_verify": ((st.tokens_generated - len(reqs))
                                  / st.spec_verifies
                                  if st.spec_verifies else None)}


def warm(eng):
    """``eng.warmup()`` of the full grid: (programs, seconds, captures),
    checked against the grid."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ready = eng.warmup()
    torch.cuda.synchronize()
    ok = (ready == len(eng._warmup_grid())
          and eng.captures == captures_expected(eng, ready))
    return {"warmup_programs": ready,
            "warmup_s": time.perf_counter() - t0,
            "warmup_captures": eng.captures, "warmup_ok": ok}


def expected_launches(eng, row):
    """The paged op's launches a drive must count: the draft's (k+1)
    steps a draft layer per draft call, and the target's layers per
    plain decode step."""
    draft = row["program_calls"].get("draft", 0)
    k1_layers = ((eng.spec_k + 1) * eng._spec.cfg.n_layers
                 if eng._spec is not None else 0)
    return draft * k1_layers + eng._cfg.n_layers * row["decode_steps"]


def graph_ms(eng, kind, bucket):
    """Device ms of one replay of ``eng``'s (kind, bucket) graph on its
    last inputs (only after the engine's traffic: a replay rewrites the
    cache slots that call wrote)."""
    if eng.device.type != "cuda":
        return None
    return time_ms(eng._programs[(kind, bucket)]._graph.replay)


def spec_engines(target, draft, dtype, **kw):
    """The spec-off and spec-on (k = SPEC_K) engines on the damped
    target."""
    return (full_width_engine(target, dtype, **kw),
            full_width_engine(target, dtype, spec_k=SPEC_K,
                              draft_params=draft,
                              draft_num_heads=SERVE_CFG["num_heads"],
                              draft_window=0, **kw))


def spec_identity(target, draft, prompts, **kw):
    """Full width, float32 (TF32 off): the spec-on engine's tokens
    against the spec-off engine's, each flip with its logit margin."""
    off, on = spec_engines(target, draft, torch.float32, **kw)
    rows = {tag: drive(eng, prompts) for tag, eng in (("off", off),
                                                      ("on", on))}
    bad = flips(off, prompts, rows["off"]["tokens"], rows["on"]["tokens"])
    ok = (not bad and rows["on"]["spec_verifies"] > 0
          and rows["off"]["finished"] and rows["on"]["finished"])
    out = {"dtype": "float32", "tf32": torch.backends.cuda.matmul.allow_tf32,
           "tokens_equal_spec_off": not bad, "flips": bad,
           "spec_accept_rate": rows["on"]["spec_accept_rate"], "ok": ok}
    off.shutdown()
    on.shutdown()
    return out


def serve_spec(np_params, kv_dtype=None, seed=3):
    """Speculative decoding at full width on tools/serve_bench.py's spec
    A/B: the damped target served spec-off and spec-on (draft = its first
    layer, k = 4), bf16, each engine warmed over its full grid first,
    then 8 repeat-heavy requests, 32 new tokens each.  Held: no capture
    in traffic; the paged launches counted through the draft graphs'
    replays equal draft calls x (k+1) x draft layers (plus the target's
    layers a plain decode step: none); a profiler window traces as many
    paged kernel instances as the counters add; the spec-on tokens
    equal the spec-off tokens, in bf16 and again in float32 (TF32 off),
    each flip printed with its logit margin (in bf16 the verify attends
    densely and rounds scores and probabilities, the decode through the
    kernel in float32: a flip there at a margin of a few bf16 ulps would
    be a near-tie, the float32 pair says whether it is one).
    ``kv_dtype="int8"`` runs the same pairs over int8 K/V (the draft's
    cache stays bf16)."""
    kw = {} if kv_dtype is None else {"kv_dtype": kv_dtype}
    target, draft = distill_family(np_params, SERVE_CFG["num_layers"])
    prompts = repeat_heavy_prompts(seed)
    off, on = spec_engines(target, draft, torch.bfloat16, **kw)
    rows = {}
    for tag, eng in (("off", off), ("on", on)):
        rows[tag] = {**warm(eng), **drive(eng, prompts)}
    bad = flips(off, prompts, rows["off"]["tokens"], rows["on"]["tokens"])
    prof = serve_profile(on, prompts)
    traced = prof["traced_paged_kernels"]
    timing = {"decode_graph_ms_b8": graph_ms(off, "decode", 8),
              "draft_graph_ms_b8": graph_ms(on, "draft", 8),
              "verify_graph_ms_b8": graph_ms(on, "verify", 8)}
    r_on = rows["on"]
    want = expected_launches(on, r_on)
    ok = (all(r["finished"] and r["warmup_ok"]
              and r["traffic_captures"] == 0 for r in rows.values())
          and r_on["spec_verifies"] > 0 and on.decode_steps == 0
          and r_on["kernel_launches"] == want > 0
          and r_on["combine_launches"] == r_on["kernel_launches"]
          and rows["off"]["kernel_launches"]
          == expected_launches(off, rows["off"])
          and traced["paged_attention_split"] > 0
          and prof["counted_paged_launches"] == traced)
    for eng in (off, on):
        eng.shutdown()
    identity = spec_identity(target, draft, prompts, **kw)
    ok = ok and not bad and identity["ok"]
    for r in rows.values():
        del r["tokens"]
    row = {"phase": "serve_spec" if kv_dtype is None else "serve_int8_spec",
           "dtype": "bfloat16", "kv_dtype": kv_dtype or "bfloat16",
           "spec_k": SPEC_K, "draft_layers": DRAFT_LAYERS,
           "distill_scale": DISTILL_SCALE,
           "prompt_lens": [len(p) for p in prompts], "new_tokens": 32,
           "spec_off": rows["off"], "spec_on": r_on,
           "expected_launches": want,
           "tok_per_s_on_over_off": r_on["tok_per_s"]
           / rows["off"]["tok_per_s"],
           "bf16_tokens_equal_spec_off": not bad, "bf16_flips": bad,
           **timing, "float32_identity": identity, "profile_spec_on": prof,
           "ok": ok}
    emit(row)
    if not ok:
        raise SystemExit(f"speculative serving failed its checks "
                         f"(kv_dtype={kv_dtype})")
    return row


def int8_logits_check(np_params):
    """One full-width float32 (TF32 off) decode step on an int8-K/V
    engine, kernel vs plain paged attention inside the engine's decode
    body, on the same cache, scales and inputs: within LOGITS_BOUND.
    Then the same with one block's K and V scales of layer 0 zeroed for
    the kernel only (a planted fault): it must fail the bound."""
    from mxnet_tpu_torch.serve import engine as engine_mod

    eng = full_width_engine(np_params, torch.float32, kv_dtype="int8")
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
    inputs = [torch.from_numpy(a).to(DEVICE) for a in (toks, pos, tables)]

    def logits(impl, fault=False):
        cfg = eng._cfg._replace(paged_impl=impl)
        ksc, vsc = eng._scale_k.clone(), eng._scale_v.clone()
        if fault:
            ksc[0, int(tables[0, 0])] = 0.0
            vsc[0, int(tables[0, 0])] = 0.0
        with torch.no_grad():
            return engine_mod._forward_token_batch(
                cfg, eng.params, eng._cache_k.clone(), eng._cache_v.clone(),
                *inputs, ksc, vsc)

    plain = logits("torch")
    err = float((logits("cuda") - plain).abs().max())
    planted = float((logits("cuda", fault=True) - plain).abs().max())
    ok = (err <= LOGITS_BOUND < planted
          and bool(torch.isfinite(plain).all()))
    emit({"phase": "int8_logits_check", "dtype": "float32",
          "kv_dtype": "int8", "tf32": torch.backends.cuda.matmul.allow_tf32,
          "batch": B, "max_abs_err": err, "bound": LOGITS_BOUND,
          "planted_fault": "layer 0, one block's K and V scales zeroed "
                           "(kernel input only)",
          "planted_max_abs_err": planted, "planted_caught":
              planted > LOGITS_BOUND, "ok": ok})
    eng.shutdown()
    if not ok:
        raise SystemExit("int8 engine decode step: kernel vs plain "
                         "disagree, or the planted fault passed")


def serve_int8(np_params, serve_row, serve_toks):
    """The bf16 serve engine with int8 K/V, and with int8 weights too,
    each warmed over its full grid and then serving the serve phase's 8
    prompts: no capture in traffic, the paged launches (bf16 q over the
    int8 cache) equal layers x decode steps and split as the serve
    phase's do.  Printed beside the bf16 engine's serve numbers: tok/s,
    decode-step ms, cache and scale bytes, and the share of tokens equal
    to the bf16 engine's (int8 rounding may move greedy picks)."""
    rows = {}
    for tag, kw in (("kv_int8", dict(kv_dtype="int8")),
                    ("weights_and_kv_int8", dict(quantize="int8",
                                                 kv_dtype="int8"))):
        eng = full_width_engine(np_params, torch.bfloat16, **kw)
        row = {**warm(eng), **drive(eng, serve_prompts(0))}
        toks = row.pop("tokens")
        pairs = [(a, b) for x, y in zip(serve_toks, toks)
                 for a, b in zip(x, y)]
        row.update({
            "cache_bytes": 2 * eng._cache_k.nbytes,
            "scale_bytes": 2 * eng._scale_k.nbytes,
            "weight_bytes": sum(v.nbytes for v in eng.params.values()),
            "token_agreement_with_bf16": sum(a == b for a, b in pairs)
            / len(pairs),
            "tok_per_s_over_bf16": row["tok_per_s"] / serve_row["tok_per_s"],
            "ok": (row["finished"] and row["warmup_ok"]
                   and row["traffic_captures"] == 0
                   and row["kernel_launches"]
                   == expected_launches(eng, row) > 0
                   and row["combine_launches"] == row["kernel_launches"])})
        rows[tag] = row
        eng.shutdown()
    head_dim = SERVE_CFG["d_model"] // SERVE_CFG["num_heads"]
    bf16_bytes = 2 * (SERVE_CFG["num_layers"] * 512 * 16
                      * SERVE_CFG["kv_heads"] * head_dim * 2)
    ok = all(r["ok"] for r in rows.values())
    emit({"phase": "serve_int8", "dtype": "bfloat16",
          "bf16": {k: serve_row[k] for k in (
              "tok_per_s", "decode_step_ms_mean", "decode_step_ms_median")},
          "bf16_cache_bytes": bf16_bytes, **rows, "ok": ok})
    if not ok:
        raise SystemExit("int8 serving failed its checks")
    return rows


# -- serving: the host KV tier (offload A/B) ---------------------------------
# tools/serve_bench.py's offload workload at its defaults:
# --offload-prefixes 6 --continuations 6 --prefix-len 96 --suffix-len 12
# --max-new 32, block 16, concurrency 1 (sequential)
OFFLOAD = dict(prefixes=6, continuations=6, prefix_len=96, suffix_len=12,
               max_new=32)
HOST_KV_BYTES = 1 << 30


def offload_workload(seed=0):
    """tools/serve_bench.py ``build_offload_workload``: 6 prompts of 96
    tokens x 6 rounds of 12-token suffixes, prefix-major (each round
    touches every prefix once)."""
    rng = np.random.RandomState(seed)
    V = SERVE_CFG["vocab"]
    prefixes = [rng.randint(0, V, (OFFLOAD["prefix_len"],)).astype(np.int32)
                for _ in range(OFFLOAD["prefixes"])]
    return [np.concatenate([p, rng.randint(0, V, (OFFLOAD["suffix_len"],))
                            .astype(np.int32)])
            for _ in range(OFFLOAD["continuations"]) for p in prefixes]


def offload_blocks():
    """tools/serve_bench.py ``run_offload``'s cache sizes: a small cache
    holding the live request plus about two prefix chains, and one no
    request of the workload ever evicts from."""
    from mxnet_tpu_torch.serve.kv_block_manager import blocks_for

    sp_len = OFFLOAD["prefix_len"] + OFFLOAD["suffix_len"] + OFFLOAD["max_new"]
    chain = blocks_for(OFFLOAD["prefix_len"], 16)
    small = 1 + 2 * chain + blocks_for(sp_len + 1, 16) + 1
    n = OFFLOAD["prefixes"] * OFFLOAD["continuations"]
    big = 1 + (n + 2) * blocks_for(sp_len + 1, 16)
    return sp_len, small, big


def raw(t):
    """A tensor's bytes, for bit-for-bit comparisons."""
    return t.contiguous().view(torch.uint8)


def restore_probe(eng, read_back=True):
    """Time each eviction's device->host fetch on ``eng`` (a synchronous
    copy: timing it adds no sync), each restore call and each prefill
    call (host time); with ``read_back``, after each
    ``_restore_pending`` the drained blocks are read back from the cache
    and held against the host copies they were restored from, bit for
    bit (extra syncs: not on a timed arm)."""
    probe = {"blocks": 0, "mismatched": 0, "fetches": [], "restores": [],
             "prefills": []}
    drained = []
    take, restore, fetch = (eng.blocks.take_pending_restores,
                            eng._restore_pending, eng._host_kv_fetch)

    def take_and_keep():
        out = take()
        drained[:] = out
        return out

    def restore_and_read_back():
        restore()
        if not read_back:
            return
        caches = (eng._cache_k, eng._cache_v, eng._scale_k, eng._scale_v)
        for blk, arrays in drained:
            probe["blocks"] += 1
            if not all(torch.equal(raw(c[:, blk].cpu()), raw(a))
                       for c, a in zip(caches, arrays)):
                probe["mismatched"] += 1
        drained.clear()

    def timed(fn, log):
        def run(*args, **kw):
            t0 = time.monotonic()  # the engine's clock (time to first token)
            out = fn(*args, **kw)
            log.append((t0, time.monotonic()))
            return out
        return run

    eng.blocks.take_pending_restores = take_and_keep
    eng._restore_pending = timed(restore_and_read_back, probe["restores"])
    eng.blocks.set_offload_source(timed(fetch, probe["fetches"]))
    eng._run_prefill = timed(eng._run_prefill, probe["prefills"])
    return probe


def ttft_split(probe, reqs):
    """Mean host ms, inside each request's time to first token, of the
    eviction fetches, of the restore calls (staging and enqueue: the
    restore does not wait for the device) and of the prefill call (its
    program waits for the device, the restore's scatter included); the
    rest is the scheduler's host work."""
    def inside(log, r):
        return sum(1e3 * max(0.0, min(b, r.first_token_t)
                             - max(a, r.submit_t)) for a, b in log)
    return {name: statistics.mean(inside(probe[name], r) for r in reqs)
            for name in ("fetches", "restores", "prefills")}


def staging_fence_check(eng):
    """The restore program's pinned staging, twice back to back behind a
    long kernel on the stream, each call writing its own value into its
    own two blocks (zeroed first): with the program's event the second
    ``stage()`` waits for the first copy and both land; with the event
    removed (the planted fault) the first copy reads the refilled
    buffer.  Returns (fenced right, unfenced caught)."""
    prog = eng._programs[("restore", 2)]
    event = prog._copied
    caches = (eng._cache_k, eng._cache_v)

    def trial(fenced, base):
        for c in caches:
            c[:, 1:5] = 0
        prog._copied = event if fenced else None
        for call, blks in enumerate(([1, 2], [3, 4])):
            torch.cuda._sleep(50_000_000)
            h = prog.stage()
            h["blks"][:] = blks
            for n in ("hk", "hv"):
                torch.as_tensor(h[n]).fill_(float(base + call))
            prog()
        torch.cuda.synchronize()
        prog._copied = event
        return all(bool((c[:, blks] == base + call).all())
                   for call, blks in enumerate(([1, 2], [3, 4]))
                   for c in caches)

    return trial(True, 1), not trial(False, 3)


def offload_arm(np_params, dtype, num_blocks, work, probe=None, **kw):
    """One warmed engine serving ``work`` sequentially; its drive row,
    stats and host-tier view, and with ``probe`` the restore probe's
    (``"timed"``: times only, no read-back)."""
    sp_len = offload_blocks()[0]
    eng = full_width_engine(np_params, dtype, num_blocks=num_blocks,
                            max_batch=1, max_model_len=sp_len,
                            max_queue=len(work) + 1, **kw)
    row = warm(eng)
    pr = (restore_probe(eng, read_back=probe != "timed") if probe
          else None)
    reqs = []
    row.update(drive(eng, work, OFFLOAD["max_new"], sequential=True,
                     reqs_out=reqs))
    st = eng.stats()
    row.update(prefix_hit_rate=st.prefix_hit_rate,
               prefill_tokens_computed=st.prefill_tokens_computed,
               prefix_discarded_tokens=st.prefix_discarded_tokens,
               host_kv_hits=st.host_kv_hits,
               host_kv_restored_tokens=st.host_kv_restored_tokens,
               host_kv_offloads=st.host_kv_offloads,
               host_kv=eng.host_kv_stats(),
               ttft_ms_after_round_1=statistics.mean(
                   1e3 * r.ttft() for r in reqs[OFFLOAD["prefixes"]:]),
               launches_ok=(row["kernel_launches"]
                            == expected_launches(eng, row) > 0
                            and row["combine_launches"]
                            == row["kernel_launches"]))
    if pr is not None:
        fetch_ms = [1e3 * (b - a) for a, b in pr["fetches"]]
        row["restore_probe"] = {
            "blocks": pr["blocks"], "mismatched": pr["mismatched"],
            "fetch_ms_per_block": (statistics.median(fetch_ms)
                                   if fetch_ms else None),
            "ttft_ms_after_round_1_inside": ttft_split(
                pr, reqs[OFFLOAD["prefixes"]:])}
    return eng, row


def serve_host_kv(np_params):
    """tools/serve_bench.py's offload A/B at its defaults on the serve
    model: the 36-request prefix-major workload served sequentially by
    four warmed engines, in float32 (TF32 off), where identity is
    judged: the small cache (23 blocks) with the host tier off and on
    (1 GiB), an unconstrained cache (343 blocks) and a cache-off cold
    engine.  Held: the tier recovers >= 0.8 of the unconstrained hit
    rate, the tier-off engine computes >= 2x the prefill tokens of the
    tier-on one, every arm's tokens equal the cold engine's, traffic
    captures nothing, every restored block read back from the cache
    equals its host copy bit for bit, and the paged launches equal
    layers x decode steps.  The pair again over int8 K/V (tokens equal
    within the pair).  A planted fault (host copies shifted by one
    layer) must change tokens; the restore program's staging fence
    must hold, and fail with its event removed.  A bf16 pair reports
    tok/s, the fetch ms a block, each restore bucket's graph ms and
    the time to first token on restored against recomputed prefixes."""
    sp_len, small, big = offload_blocks()
    work = offload_workload()
    f32 = torch.float32
    arms, engines = {}, {}
    for tag, nb, kw in (("cold", big, dict(prefix_cache=False)),
                        ("unconstrained", big, {}),
                        ("off", small, {}),
                        ("on", small, dict(host_kv_bytes=HOST_KV_BYTES))):
        eng, row = offload_arm(np_params, f32, nb, work, probe=tag == "on",
                               **kw)
        arms[tag] = row
        engines[tag] = eng
    on = engines.pop("on")
    fence_ok, fence_fault_caught = staging_fence_check(on)
    on.shutdown()
    for eng in engines.values():
        eng.shutdown()
    cold = arms["cold"]["tokens"]
    ident = {tag: arms[tag]["tokens"] == cold
             for tag in ("unconstrained", "off", "on")}
    # the planted fault: host copies shifted by one layer on the way in
    eng = full_width_engine(np_params, f32, num_blocks=small, max_batch=1,
                            max_model_len=sp_len, max_queue=len(work) + 1,
                            host_kv_bytes=HOST_KV_BYTES)
    fetch = eng._host_kv_fetch
    eng.blocks.set_offload_source(
        lambda blk: tuple(torch.roll(a, 1, 0) for a in fetch(blk)))
    n2 = 2 * OFFLOAD["prefixes"]
    planted = drive(eng, work[:n2], OFFLOAD["max_new"], sequential=True)
    planted_caught = (eng.stats().host_kv_hits > 0
                      and planted["tokens"] != cold[:n2])
    eng.shutdown()
    # the pair over int8 K/V: identity within the pair
    int8 = {}
    for tag, kw in (("off", {}), ("on", dict(host_kv_bytes=HOST_KV_BYTES))):
        eng, int8[tag] = offload_arm(np_params, f32, small, work,
                                     kv_dtype="int8", **kw)
        eng.shutdown()
    int8_ident = int8["on"]["tokens"] == int8["off"]["tokens"]
    # the bf16 pair: what the tier costs and saves
    bf16 = {}
    for tag, kw in (("off", {}), ("on", dict(host_kv_bytes=HOST_KV_BYTES))):
        eng, bf16[tag] = offload_arm(np_params, torch.bfloat16, small, work,
                                     probe="timed" if tag == "on" else None,
                                     **kw)
        if tag == "on":
            bf16[tag]["restore_graph_ms"] = {
                b: graph_ms(eng, "restore", b)
                for b in sorted(b for k, b in eng._programs
                                if k == "restore")}
        eng.shutdown()
    for rows in (arms, int8, bf16):
        for r in rows.values():
            r.pop("tokens")
    on, off, ref = arms["on"], arms["off"], arms["unconstrained"]
    recovery = on["prefix_hit_rate"] / ref["prefix_hit_rate"]
    ratio = off["prefill_tokens_computed"] / on["prefill_tokens_computed"]
    every = [*arms.values(), *int8.values(), *bf16.values()]
    ok = (recovery >= 0.8 and ratio >= 2.0 and all(ident.values())
          and int8_ident and int8["on"]["host_kv_hits"] > 0
          and on["host_kv_hits"] > 0
          and on["restore_probe"]["blocks"] > 0
          and on["restore_probe"]["mismatched"] == 0
          and bf16["on"]["restore_probe"]["fetch_ms_per_block"] is not None
          and all(r["finished"] and r["warmup_ok"] and r["launches_ok"]
                  and r["traffic_captures"] == 0 for r in every)
          and planted_caught and fence_ok and fence_fault_caught)
    emit({"phase": "serve_host_kv", "dtype": "float32",
          "tf32": torch.backends.cuda.matmul.allow_tf32,
          "workload": {**OFFLOAD, "requests": len(work)},
          "num_blocks_small": small, "num_blocks_unconstrained": big,
          "host_kv_bytes": HOST_KV_BYTES, "max_model_len": sp_len,
          "hit_rate_recovery": recovery, "bar_hit_rate_recovery": 0.8,
          "prefill_compute_ratio": ratio, "bar_prefill_compute_ratio": 2.0,
          "tokens_identical": ident, "float32": arms,
          "int8_kv": int8, "int8_tokens_identical": int8_ident,
          "bf16": bf16,
          "bf16_ttft_ms_restored_over_recomputed": (
              bf16["on"]["ttft_ms_after_round_1"]
              / bf16["off"]["ttft_ms_after_round_1"]),
          "planted_fault": "host copies shifted by one layer",
          "planted_caught": planted_caught,
          "staging_fence_ok": fence_ok,
          "staging_fence_fault_caught": fence_fault_caught, "ok": ok})
    if not ok:
        raise SystemExit("host KV tier failed its checks")
    return {"float32_on": on, "bf16_on": bf16["on"], "int8_on": int8["on"]}


# -- serving: per-request sampling -------------------------------------------
# tools/serve_bench.py's sampling workload: SAMPLING_CYCLE (:341-347),
# --sampling-temp 0.25, --agreement-samples 192
SAMPLING_CYCLE = (
    {},
    {"temperature": 0.7},
    {"temperature": 1.0, "top_k": 8},
    {"temperature": 0.9, "top_p": 0.8},
    {"temperature": 0.25, "top_k": 16, "logprobs": 2},
)
SAMPLING_TEMP = 0.25
AGREEMENT_SAMPLES = 192
# the pooled two-sample chi-square of two samples of one distribution
# sits near z = 0 (its df away from the statistic, over sqrt(2 df));
# tests/test_sampling.py's bound
AGREEMENT_Z = 5.0
# draws of the captured decode graph against the exact warped
# distribution p: N draws sit E = 0.5 * sum_i sqrt(2 p_i (1 - p_i) / (pi N))
# away in TV on average (each empirical share's mean absolute error);
# held at SAMPLER_TV_FACTOR x E, computed from this run's p
SAMPLER_TV_FACTOR = 2.0


def sampling_config(i):
    return dict(SAMPLING_CYCLE[i % len(SAMPLING_CYCLE)])


def two_sample_chisq(a, b, min_count=10):
    """tools/serve_bench.py ``_two_sample_chisq``: (z, TV, categories)
    of two samples, rare categories folded together."""
    ca, cb = collections.Counter(a), collections.Counter(b)
    cats = [c for c in set(ca) | set(cb)
            if ca.get(c, 0) + cb.get(c, 0) >= min_count]
    other = [c for c in set(ca) | set(cb) if c not in cats]
    na, nb = len(a), len(b)
    rows = [(ca.get(c, 0), cb.get(c, 0)) for c in cats]
    if other:
        rows.append((sum(ca.get(c, 0) for c in other),
                     sum(cb.get(c, 0) for c in other)))
    stat = 0.0
    for xa, xb in rows:
        tot = xa + xb
        ea, eb = tot * na / (na + nb), tot * nb / (na + nb)
        stat += (xa - ea) ** 2 / ea if ea > 0 else 0.0
        stat += (xb - eb) ** 2 / eb if eb > 0 else 0.0
    df = max(1, len(rows) - 1)
    return ((stat - df) / (2 * df) ** 0.5,
            0.5 * sum(abs(xa / na - xb / nb) for xa, xb in rows), len(rows))


def sampler_check(eng, calls=500):
    """The captured sampling-mode decode graph at bucket 8 on fixed
    inputs (8 rows of one token, position and table), replayed
    ``calls`` times with fresh seeds: the pooled draws against the mean
    of the 8 rows' ``_filtered_probs_full`` of the eager decode's logits
    on the same cache (the rows agree but for the order of tied bf16
    logits at a filter's edge), within SAMPLER_TV_FACTOR times the TV
    the draws' own noise gives on average, for two
    configurations at temperature 0.25; the draws against the
    distribution with temperature ignored (the planted fault) must fall
    outside it.  Also: one seed twice draws the same rows, two seeds
    different ones."""
    from mxnet_tpu_torch.serve import engine as engine_mod

    prog = eng._programs[("decode", 8)]
    cfg = eng._cfg
    rows = {}
    for tag, (t, p, k) in (("temp0.25_topk8", (0.25, 1.0, 8)),
                           ("temp0.25_topp0.8", (0.25, 0.8, 0))):
        def call(seed):
            h = prog.stage()
            h["toks"][:] = 11
            h["pos"][:] = 20
            h["tables"][:, :2] = [1, 2]
            h["temp"][:], h["topp"][:], h["topk"][:] = t, p, k
            h["seed"][0] = seed
            return prog()[0]
        draws = np.concatenate([call(s) for s in range(calls)])
        same = call(7).tolist() == call(7).tolist()
        differ = call(7).tolist() != call(8).tolist()
        dev = eng._cache_k.device
        inputs = (torch.full((8,), 11, dtype=torch.int32, device=dev),
                  torch.full((8,), 20, dtype=torch.int32, device=dev),
                  torch.zeros((8, eng.table_width), dtype=torch.int32,
                              device=dev))
        inputs[2][:, :2] = torch.tensor([1, 2], device=dev)
        with torch.no_grad():
            logits = engine_mod._forward_token_batch(
                cfg, eng.params, eng._cache_k.clone(),
                eng._cache_v.clone(), *inputs)

        def exact(temp):
            one = torch.ones(8, device=dev)
            return engine_mod._filtered_probs_full(
                cfg, logits, one * temp, one * p,
                torch.full((8,), k, dtype=torch.int32,
                           device=dev)).mean(dim=0)

        def tv(probs):
            got = np.bincount(draws, minlength=probs.numel()) / draws.size
            return 0.5 * float(np.abs(got - probs.cpu().numpy()).sum())

        want = exact(t)
        pw = want.double().cpu().numpy()
        noise = 0.5 * float(np.sqrt(2 * pw * (1 - pw)
                                    / (np.pi * draws.size)).sum())
        rows[tag] = {"draws": int(draws.size),
                     "candidates": int((want > 0).sum()),
                     "tv": tv(want), "expected_tv_noise": noise,
                     "bound": SAMPLER_TV_FACTOR * noise,
                     "tv_temperature_ignored": tv(exact(1.0)),
                     "outside_support": int((want.cpu().numpy()[draws]
                                             == 0).sum()),
                     "same_seed_same_draws": same,
                     "two_seeds_differ": differ}
    ok = all(r["tv"] <= r["bound"] < r["tv_temperature_ignored"]
             and r["outside_support"] == 0 and r["same_seed_same_draws"]
             and r["two_seeds_differ"] for r in rows.values())
    return rows, ok


def seeded_streams(np_params):
    """Two engines with one seed serve the same stream; another seed
    another stream (4 prompts, 8 tokens at temperature 1, no warm-up)."""
    out = []
    for seed in (5, 5, 6):
        eng = full_width_engine(np_params, torch.bfloat16, sampling=True,
                                seed=seed)
        reqs = [eng.submit(p, max_new_tokens=8, temperature=1.0)
                for p in serve_prompts(4)[:4]]
        eng.run()
        out.append([r.tokens for r in reqs])
        eng.shutdown()
    return out[0] == out[1], out[0] != out[2]


def serve_sample(np_params):
    """tools/serve_bench.py's sampling workload on the serve model,
    bf16, every engine warmed over its full grid first: (1) the mixed
    SAMPLING_CYCLE on the serve phase's 8 prompts (32 new tokens) beside
    a sampling-off engine: no capture in traffic, the greedy rows equal
    the sampling-off engine's, the logprob outputs shaped as asked,
    the launches as in serve; the sampled decode graph's ms against the
    greedy one's; the sampler check on the card; (2) serve_spec's
    damped target spec-off against spec-on at temperature 0.25
    (rejection sampling), tok/s and the stochastic acceptance rate;
    (3) 192 two-token generations an arm, spec-off against spec-on,
    by the pooled two-sample chi-square (|z| < AGREEMENT_Z); (4) two
    engines with one seed emit one stream."""
    prompts = serve_prompts(0)
    greedy = full_width_engine(np_params, torch.bfloat16)
    samp = full_width_engine(np_params, torch.bfloat16, sampling=True)
    rows, reqs = {}, []
    for tag, eng, cfg in (("greedy", greedy, None),
                          ("sampling", samp, sampling_config)):
        rows[tag] = {**warm(eng), **drive(eng, prompts, cfg_fn=cfg,
                                          reqs_out=reqs if cfg else None)}
        rows[tag]["decode_graph_ms_b8"] = graph_ms(eng, "decode", 8)
        rows[tag]["launches_ok"] = (rows[tag]["kernel_launches"]
                                    == expected_launches(eng, rows[tag]) > 0)
    gt, st = rows["greedy"]["tokens"], rows["sampling"]["tokens"]
    greedy_rows = [i for i in range(len(prompts)) if not sampling_config(i)]
    greedy_equal = all(gt[i] == st[i] for i in greedy_rows)
    logprobs_ok = all(
        len(r.token_logprobs) == len(r.tokens)
        and len(r.top_logprobs) == (len(r.tokens)
                                    if sampling_config(i).get("logprobs")
                                    else 0)
        and all(len(x) == sampling_config(i).get("logprobs", 0)
                for x in r.top_logprobs)
        for i, r in enumerate(reqs))
    sampler, sampler_ok = sampler_check(samp)
    # where a sampled decode step's time goes, beside the greedy one's
    profiles = {tag: serve_profile(eng, prompts)
                for tag, eng in (("greedy", greedy), ("sampling", samp))}
    prof_ok = all(p["counted_paged_launches"] == p["traced_paged_kernels"]
                  for p in profiles.values())
    greedy.shutdown()
    samp.shutdown()
    # spec-off against spec-on at temperature 0.25
    target, draft = distill_family(np_params, SERVE_CFG["num_layers"])
    off, on = spec_engines(target, draft, torch.bfloat16, sampling=True,
                           max_queue=AGREEMENT_SAMPLES + 1)
    stoch = lambda i: {"temperature": SAMPLING_TEMP}   # noqa: E731
    spec = {}
    pairs = {}
    pair_prompt = [repeat_heavy_prompts()[0]] * AGREEMENT_SAMPLES
    for tag, eng in (("off", off), ("on", on)):
        spec[tag] = {**warm(eng), **drive(eng, repeat_heavy_prompts(),
                                          cfg_fn=stoch)}
        st_ = eng.stats()
        spec[tag].update(
            spec_accept_rate_stochastic=st_.spec_accept_rate_stochastic,
            launches_ok=(spec[tag]["kernel_launches"]
                         == expected_launches(eng, spec[tag]) > 0))
        row = drive(eng, pair_prompt, 2, cfg_fn=stoch)
        pairs[tag] = [tuple(t) for t in row["tokens"] if len(t) == 2]
        spec[tag]["agreement_traffic_captures"] = row["traffic_captures"]
    spec["on"]["verify_graph_ms_b8"] = graph_ms(on, "verify", 8)
    spec["on"]["draft_graph_ms_b8"] = graph_ms(on, "draft", 8)
    off.shutdown()
    on.shutdown()
    z, tv, ncat = two_sample_chisq(pairs["off"], pairs["on"])
    same_seed, other_seed = seeded_streams(np_params)
    for r in (*rows.values(), *spec.values()):
        r.pop("tokens")
    r_on = spec["on"]
    ok = (all(r["finished"] and r["warmup_ok"] and r["traffic_captures"] == 0
              and r["launches_ok"]
              for r in (*rows.values(), *spec.values()))
          and all(r["agreement_traffic_captures"] == 0
                  for r in spec.values())
          and greedy_equal and logprobs_ok and sampler_ok and prof_ok
          and r_on["spec_verifies"] > 0
          and min(len(p) for p in pairs.values()) == AGREEMENT_SAMPLES
          and abs(z) < AGREEMENT_Z and same_seed and other_seed)
    emit({"phase": "serve_sample", "dtype": "bfloat16",
          "cycle": [dict(c) for c in SAMPLING_CYCLE],
          "prompt_lens": [len(p) for p in prompts], "new_tokens": 32,
          "greedy": rows["greedy"], "sampling": rows["sampling"],
          "sampled_over_greedy_decode_graph": (
              rows["sampling"]["decode_graph_ms_b8"]
              / rows["greedy"]["decode_graph_ms_b8"]
              if rows["greedy"]["decode_graph_ms_b8"] else None),
          "sampled_over_greedy_decode_step": (
              rows["sampling"]["decode_step_ms_mean"]
              / rows["greedy"]["decode_step_ms_mean"]),
          "profiles": {tag: {k: p[k] for k in (
              "decode_steps", "kernel_ms_per_step", "wall_ms_per_step",
              "ms_per_step_by_kind", "top_kernels_ms_per_step",
              "traced_paged_kernels", "counted_paged_launches", "gap")}
              for tag, p in profiles.items()},
          "greedy_rows": greedy_rows, "greedy_rows_equal": greedy_equal,
          "logprobs_ok": logprobs_ok, "sampler": sampler,
          "spec_temperature": SAMPLING_TEMP, "spec_off": spec["off"],
          "spec_on": r_on,
          "tok_per_s_on_over_off": r_on["tok_per_s"]
          / spec["off"]["tok_per_s"],
          "agreement": {"samples": AGREEMENT_SAMPLES, "z": z, "tv": tv,
                        "categories": ncat, "bound_abs_z": AGREEMENT_Z},
          "same_seed_same_stream": same_seed,
          "other_seed_other_stream": other_seed, "ok": ok})
    if not ok:
        raise SystemExit("sampled serving failed its checks: " + json.dumps(
            {"profiles_ok": prof_ok, "profiles": {
                tag: {k: p[k] for k in ("traced_paged_kernels",
                                        "counted_paged_launches")}
                for tag, p in profiles.items()}}))
    return {"sampling": rows["sampling"], "spec_on": r_on}


# -- serving: multi-tenant LoRA adapters ------------------------------------
# tools/serve_bench.py --workload lora (run_lora :649-760): --lora-adapters
# 3 of --lora-rank 4, alpha 8.0, drawn by build_lora_family (:621-646)
# from seed + 7 over every projection stem; one more drawn after them is
# the adapter registered after capture
LORA_ADAPTERS = 3
LORA_RANK = 4
LORA_ALPHA = 8.0
LORA_SEED = 0 + 7
# one adapter row's first-step float32 logits (TF32 off), the adapters
# engine (x W^T + s (x A^T) B^T) against its merged engine
# (x (W + s B A)^T): a few float32 roundings a projection (~1e-7
# relative) carried through 4 layers and the tied head, as LOGITS_BOUND
# is for the kernel; the adapter itself moves these logits by ~0.1-1,
# which the base engine's logits show beside the bound
LORA_LOGITS_BOUND = 5e-4


def lora_family(params, k=LORA_ADAPTERS + 1):
    """tools/serve_bench.py ``build_lora_family`` on the serve model:
    ``k`` adapters ``{stem: (A, B)}`` (numpy, float32, N(0, 0.1^2)) in
    stem order from one RandomState, and a function giving an adapter's
    merged checkpoint ``W + (alpha/r) B A`` (on the card; the base
    checkpoint for None)."""
    from mxnet_tpu_torch.serve.adapters import gpt_stems

    stems = gpt_stems("gpt", SERVE_CFG["num_layers"], True, True, params)
    rng = np.random.RandomState(LORA_SEED)
    family = {}
    for j in range(k):
        family[f"tenant-{j}"] = {
            stem: ((rng.randn(LORA_RANK, din) * 0.1).astype(np.float32),
                   (rng.randn(dout, LORA_RANK) * 0.1).astype(np.float32))
            for stem, (dout, din) in stems.items()}

    def merged(aid):
        if aid is None:
            return params
        mp = dict(params)
        for stem, (a, b) in family[aid].items():
            w = params[f"{stem}_weight"]
            mp[f"{stem}_weight"] = w + (LORA_ALPHA / LORA_RANK) * (
                torch.from_numpy(b).to(w.device)
                @ torch.from_numpy(a).to(w.device))
        return mp

    return family, merged


def lora_ids():
    """run_lora's assignment: row i serves ``ids[i % 4]`` (base, then
    the three tenants); the rotated pass serves ``ids[(i + 1) % 4]``."""
    return [None] + [f"tenant-{j}" for j in range(LORA_ADAPTERS)]


def lora_cfg(shift):
    ids = lora_ids()
    return lambda i: ({"adapter_id": ids[(i + shift) % len(ids)]}
                      if ids[(i + shift) % len(ids)] else {})


def lora_engine(np_params, family, dtype, load=LORA_ADAPTERS):
    """The adapters engine (3 tenants + the base slot), its first
    ``load`` adapters registered before ``warmup()``."""
    eng = full_width_engine(np_params, dtype, adapters=LORA_ADAPTERS + 1,
                            adapter_rank=LORA_RANK)
    for aid in sorted(family)[:load]:
        eng.adapter_store.register(aid, family[aid], alpha=LORA_ALPHA)
    return eng


def lora_merged(merged, dtype, aid, prompts, reqs_out=None):
    """Serve ``prompts`` on ``aid``'s merged checkpoint (an adapters-off
    engine; the base checkpoint for None); its tokens and the engine."""
    eng = full_width_engine(merged(aid), dtype)
    return drive(eng, prompts, reqs_out=reqs_out)["tokens"], eng


def lora_agreement(merged, dtype, prompts, got, shift):
    """run_lora's agreement: each row of a pass (assignment ``shift``)
    against its adapter's merged engine, token by token; the flips with
    their margins on the merged engine."""
    ids, total, agree, bad = lora_ids(), 0, 0, []
    for aid in ids:
        rows = [i for i in range(len(prompts))
                if ids[(i + shift) % len(ids)] == aid]
        want, eng = lora_merged(merged, dtype, aid,
                                [prompts[i] for i in rows])
        for i, w in zip(rows, want):
            total += len(w)
            agree += sum(int(x == y) for x, y in zip(w, got[i]))
        for f in flips(eng, [prompts[i] for i in rows], want,
                       [got[i] for i in rows]):
            bad.append({**f, "request": rows[f["request"]], "adapter": aid})
        eng.shutdown()
    return agree / total, bad


def rebinding_load(store):
    """The planted fault: a load that rebinds every stack to a copy
    before writing the slot, as the reference's ``.at[slot].set`` does,
    leaving the programs on the old stacks."""
    load = store._load_slot

    def rebind(slot, digest):
        store._device = {k: v.clone() for k, v in store._device.items()}
        load(slot, digest)

    store._load_slot = rebind


def lora_float32(np_params, family, merged, prompts):
    """The float32 (TF32 off) arms: the adapters engine warmed, the mix
    and its rotation served, base rows against an adapters-off engine's,
    agreement with the merged engines (flips with margins), one adapter
    row's first-step logits against its merged engine's; then the
    fourth adapter registered after capture, loaded by evicting a cold
    one, against its merged engine; then the planted rebinding load,
    which must change that adapter's tokens."""
    off_toks, off = lora_merged(merged, torch.float32, None, prompts)
    off.shutdown()
    eng = lora_engine(np_params, family, torch.float32)
    row = warm(eng)
    caps = eng.captures
    passes = [drive(eng, prompts, cfg_fn=lora_cfg(k)) for k in (0, 1)]
    ids = lora_ids()
    base_equal = all(passes[k]["tokens"][i] == off_toks[i]
                     for k in (0, 1) for i in range(len(prompts))
                     if ids[(i + k) % len(ids)] is None)
    agree, bad = lora_agreement(merged, torch.float32, prompts,
                                passes[1]["tokens"], 1)
    # row 1 of the first pass is tenant-0's: its slot (pinned and
    # released: the most recently used), its first logits
    slot = eng.adapter_store.acquire("tenant-0")
    eng.adapter_store.release(slot)
    got = first_logits(eng, prompts[1], slot)
    meng = full_width_engine(merged("tenant-0"), torch.float32)
    want = first_logits(meng, prompts[1])
    meng.shutdown()
    base = first_logits(eng, prompts[1], 0)
    logits = {"max_abs_err_vs_merged": float((got - want).abs().max()),
              "bound": LORA_LOGITS_BOUND,
              "max_abs_diff_base_vs_merged": float(
                  (base - want).abs().max())}
    # the fourth adapter, registered after every capture: its load
    # evicts a cold slot and writes the stacks the graphs read
    late_id = f"tenant-{LORA_ADAPTERS}"
    late_rows = [prompts[1], prompts[5]]
    eng.adapter_store.register(late_id, family[late_id], alpha=LORA_ALPHA)
    evictions = eng.adapter_store.device_evictions
    late = drive(eng, late_rows, cfg_fn=lambda i: {"adapter_id": late_id})
    evictions = eng.adapter_store.device_evictions - evictions
    want_late, meng = lora_merged(merged, torch.float32, late_id, late_rows)
    late_bad = flips(meng, late_rows, want_late, late["tokens"])
    meng.shutdown()
    # planted: the adapter the late load evicted, loaded again by a
    # rebinding load (into the slot of another, colder one)
    gone = [a for a in ids[1:] if a not in eng.adapter_store.loaded()]
    rebinding_load(eng.adapter_store)
    planted = drive(eng, late_rows, cfg_fn=lambda i: {"adapter_id":
                                                      gone[0]})
    want_0, meng = lora_merged(merged, torch.float32, gone[0], late_rows)
    meng.shutdown()
    out = {"dtype": "float32", "tf32": torch.backends.cuda.matmul.allow_tf32,
           **row, "traffic_captures": [p["traffic_captures"]
                                       for p in passes],
           "base_rows_equal_off": base_equal,
           "agreement_vs_merged": agree, "flips": bad,
           "first_step_logits": logits,
           "late_adapter": {"id": late_id, "device_evictions": evictions,
                            "traffic_captures": late["traffic_captures"],
                            "tokens_equal_merged": not late_bad,
                            "flips": late_bad},
           "planted_rebinding_load": {
               "adapter": gone[0] if gone else None,
               "tokens_equal_merged": planted["tokens"] == want_0,
               "caught": planted["tokens"] != want_0}}
    out["ok"] = (row["warmup_ok"] and eng.captures == caps
                 and all(p["finished"] and p["traffic_captures"] == 0
                         for p in (*passes, late))
                 and base_equal and agree == 1.0 and not bad
                 and logits["max_abs_err_vs_merged"] <= LORA_LOGITS_BOUND
                 and logits["max_abs_diff_base_vs_merged"]
                 > LORA_LOGITS_BOUND
                 and out["late_adapter"]["device_evictions"] == 1
                 and not late_bad and len(gone) == 1
                 and out["planted_rebinding_load"]["caught"])
    eng.shutdown()
    return out


def serve_lora(np_params):
    """tools/serve_bench.py's LoRA A/B (``run_lora``) on the serve model:
    3 adapters of rank 4 over every projection, the serve prompts (32
    new tokens), rows cycling base and the three tenants.  bf16: an
    adapters-off engine and the adapters engine (4 slots), each warmed
    over its full grid, the mix served and then served again with every
    row's adapter rotated, which must capture nothing; base rows equal
    the off engine's; the paged launches equal layers x decode steps;
    agreement with one merged-checkpoint engine a tenant (flips with
    their margins); off and adapters tok/s, the bucket-8 decode graphs
    and the decode step's kernels from the profiler.  Then the float32
    arms (``lora_float32``), where agreement must be exact."""
    family, merged = lora_family(np_params)
    prompts = serve_prompts(0)
    off = full_width_engine(np_params, torch.bfloat16)
    rows = {"off": {**warm(off), **drive(off, prompts)}}
    mux = lora_engine(np_params, family, torch.bfloat16)
    if mux.paged_impl != "cuda" and DEVICE == "cuda":
        raise SystemExit(f"engine resolved paged_impl={mux.paged_impl}")
    rows["mux"] = warm(mux)
    caps = mux.captures
    passes = [drive(mux, prompts, cfg_fn=lora_cfg(k)) for k in (0, 1)]
    rows["mux"].update(passes[1])
    rows["mux"]["first_pass_launches"] = passes[0]["kernel_launches"]
    rows["mux"]["first_pass_combine_launches"] = passes[0][
        "combine_launches"]
    ids = lora_ids()
    base_equal = all(passes[k]["tokens"][i] == rows["off"]["tokens"][i]
                     for k in (0, 1) for i in range(len(prompts))
                     if ids[(i + k) % len(ids)] is None)
    launches_ok = all(
        r["kernel_launches"] == expected_launches(eng, r) > 0
        and r["combine_launches"] == r["kernel_launches"]
        for eng, r in ((off, rows["off"]), (mux, passes[0]),
                       (mux, passes[1])))
    timing = {"decode_graph_ms_b8_off": graph_ms(off, "decode", 8),
              "decode_graph_ms_b8_adapters": graph_ms(mux, "decode", 8)}
    profiles = {tag: serve_profile(eng, prompts)
                for tag, eng in (("off", off), ("adapters", mux))}
    prof_ok = all(p["counted_paged_launches"] == p["traced_paged_kernels"]
                  for p in profiles.values())
    info = mux.adapter_info()
    off.shutdown()
    mux.shutdown()
    agree, bad = lora_agreement(merged, torch.bfloat16, prompts,
                                passes[1]["tokens"], 1)
    f32 = lora_float32(np_params, family, merged, prompts)
    for r in (rows["off"], rows["mux"]):
        r.pop("tokens")
    ok = (all(r["finished"] and r["warmup_ok"] for r in rows.values())
          and all(p["finished"] and p["traffic_captures"] == 0
                  for p in passes)
          and mux.captures == caps and base_equal and launches_ok
          and prof_ok and info["slots_used"] == LORA_ADAPTERS
          and info["slots_pinned"] == 0 and f32["ok"])
    kp = {tag: p["kernels_per_step"] for tag, p in profiles.items()}
    row = {"phase": "serve_lora", "dtype": "bfloat16",
           "adapters": LORA_ADAPTERS, "adapter_rank": LORA_RANK,
           "alpha": LORA_ALPHA, "prompt_lens": [len(p) for p in prompts],
           "new_tokens": 32, "off": rows["off"], "adapters_on": rows["mux"],
           "traffic_captures_by_pass": [p["traffic_captures"]
                                        for p in passes],
           "tok_per_s_adapters_over_off": rows["mux"]["tok_per_s"]
           / rows["off"]["tok_per_s"],
           **timing,
           "decode_graph_adapters_over_off": (
               timing["decode_graph_ms_b8_adapters"]
               / timing["decode_graph_ms_b8_off"]
               if timing["decode_graph_ms_b8_off"] else None),
           "decode_step_kernels": kp,
           "extra_kernels_per_decode_step": kp["adapters"] - kp["off"],
           "profiles": {tag: {k: p[k] for k in (
               "decode_steps", "kernel_ms_per_step", "wall_ms_per_step",
               "kernels_per_step", "ms_per_step_by_kind",
               "top_kernels_ms_per_step", "traced_paged_kernels",
               "counted_paged_launches")} for tag, p in profiles.items()},
           "base_rows_equal_off": base_equal, "launches_ok": launches_ok,
           "bf16_agreement_vs_merged": agree, "bf16_flips": bad,
           "adapter_info": info, "float32": f32, "ok": ok}
    emit(row)
    if not ok:
        raise SystemExit("LoRA adapter serving failed its checks")
    return rows["mux"]


# -- serve_telemetry: the engine's telemetry on the card ---------------------
# |PerfAttrib's CUDA-event ms of the bucket-8 decode - graph_ms| must stay
# within TIMING_REL x graph_ms + TIMING_ABS_MS.  The engine's events
# bracket the graph replay alone, in traffic (L2 holding what the last
# call left), where graph_ms times the replay after an L2 flush; the
# launch's own latency (the device may idle while the host submits ~350
# nodes) is in both, tens of microseconds against a ~0.8 ms graph.
TIMING_REL = 0.25
TIMING_ABS_MS = 0.05
# the step profile against clocks it does not keep.  chip_smoke's own
# host clock around each eng.step() may exceed the profile's wall by at
# most STEP_WRAP_ABS_MS (step()'s guard, no_grad and the call, ~10 us).
# On a step whose calls were event-timed, the profile's dispatch and
# device_wait phases must hold the step's event-timed device time: each
# event pair lies inside a dispatch lap, whose end waits for the end
# event; EVENT_SLACK_MS covers the two clocks' resolution
STEP_WRAP_ABS_MS = 0.25
EVENT_SLACK_MS = 0.005
TELEMETRY_ENV = ("MXTPU_TELEMETRY_DIR", "MXTPU_REQUEST_TRACE",
                 "MXTPU_REQUEST_TRACE_FILE", "MXTPU_FLIGHT_DIR",
                 "MXTPU_PERF_ATTRIB_SAMPLE", "MXTPU_NUMERIC_WATCH")


class _Poller:
    """A thread polling /statusz.json, /metrics and /healthz of ``url``
    until stopped: every response must come back 200 and parse."""

    PATHS = ("/statusz.json", "/metrics", "/healthz")

    def __init__(self, url):
        self.url, self.polls, self.errors = url, 0, []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        import urllib.request

        from mxnet_tpu_torch.telemetry.timeseries import \
            parse_prometheus_text
        while not self._stop.is_set():
            for path in self.PATHS:
                try:
                    with urllib.request.urlopen(self.url + path,
                                                timeout=30) as r:
                        body = r.read().decode()
                    if path == "/metrics":
                        if not parse_prometheus_text(body):
                            raise ValueError("empty /metrics")
                    else:
                        json.loads(body)
                except Exception as e:       # counted, then fails the phase
                    self.errors.append(f"{path}: {e!r}")
            self.polls += 1

    def __enter__(self):
        self._thread.start()
        while not self.polls and not self.errors:
            self._stop.wait(0.005)       # the first round is in
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        return False


def _set_env(values):
    """Set (value) or unset (None) each variable; returns the old ones."""
    old = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    return old


def _tool(name, *args):
    """Run ``tools/<name>`` (stdlib only) in a subprocess: (rc, stdout)."""
    out = subprocess.run([sys.executable, os.path.join(ROOT, "tools", name),
                          *args], capture_output=True, text=True,
                         timeout=120)
    return out.returncode, out.stdout + out.stderr


def _prom_series(text, name):
    """[(labels, value)] of the series ``name`` in a Prometheus text
    body (labelled series only)."""
    return [(dict(re.findall(r'([a-z_]+)="([^"]*)"', line)),
             float(line.split()[-1])) for line in text.splitlines()
            if line.startswith(name + "{")]


def nan_watch_check(np_params, tmp):
    """The NaN watchdog binds: a float32 engine with one weight row set
    to NaN writes a numeric_anomaly flight dump with the watch on, and
    none with it off (the flag rides the tokens' copy)."""
    from mxnet_tpu_torch.telemetry import flight

    bad = dict(np_params)
    w = np_params["gpt_l0_q_weight"].clone()
    w[0] = float("nan")
    bad["gpt_l0_q_weight"] = w
    got = {}
    for watch in ("1", None):
        d = os.path.join(tmp, f"nan_{'on' if watch else 'off'}")
        old = _set_env({"MXTPU_NUMERIC_WATCH": watch,
                        "MXTPU_FLIGHT_DIR": d})
        flight.recorder().clear()
        try:
            eng = full_width_engine(bad, torch.float32, num_blocks=64,
                                    max_batch=2)
            for p in serve_prompts(0)[:2]:
                eng.submit(p, max_new_tokens=4)
            eng.run()
            eng.shutdown()
        finally:
            _set_env(old)
        files = sorted(os.listdir(d)) if os.path.isdir(d) else []
        got["on" if watch else "off"] = [
            f for f in files if f.endswith("numeric_anomaly.json")]
    flight.recorder().clear()
    return {"dumps_watch_on": len(got["on"]),
            "dumps_watch_off": len(got["off"]),
            "ok": len(got["on"]) == 1 and not got["off"]}


def timed_steps(eng, until=None):
    """Step ``eng`` while it has work and ``until()`` is false: {step id:
    (host-clock seconds around ``eng.step()``, the step's event-timed
    device seconds)}; every step's calls must be timed
    (MXTPU_PERF_ATTRIB_SAMPLE=1)."""
    out = {}
    while eng.has_work() and not (until is not None and until()):
        t0 = time.perf_counter()
        eng.step()
        out[eng._step_id] = (time.perf_counter() - t0, eng._perf._step_s)
    return out


def step_profile_check(eng, walls):
    """Each timed step's profile entry against ``walls``
    (timed_steps): (ok, {max_wrap_ms, min_held_minus_device_ms, steps,
    device_timed_steps})."""
    entries = {e["step"]: e for e in eng._sprof.recent(len(walls) + 64)}
    wrap, held = [], []
    for sid, (ext_s, dev_s) in walls.items():
        e = entries[sid]
        wrap.append(1e3 * (ext_s - e["wall_s"]))
        if dev_s > 0:
            held.append(1e3 * (sum(v for k, v in e["phases"].items()
                                   if k.endswith("_dispatch")
                                   or k == "device_wait") - dev_s))
    ok = (bool(held) and all(0.0 <= w <= STEP_WRAP_ABS_MS for w in wrap)
          and min(held) >= -EVENT_SLACK_MS)
    return ok, {"steps": len(wrap), "device_timed_steps": len(held),
                "max_wrap_ms": max(wrap), "min_wrap_ms": min(wrap),
                "min_held_minus_device_ms": min(held) if held else None}


def _hot_path_sites():
    """(part, owner, attribute) of every telemetry call on the engine's
    per-step host path: spans (made, entered, left), metric updates,
    request-trace events, flight records, the step profile and
    PerfAttrib's per-call bracket.  Each is wrapped on the class or
    module that defines it, so every caller goes through the wrapper."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.telemetry import (flight, metrics, perf_attrib,
                                           profiling, request_trace,
                                           tracing)

    sites = [("spans", telemetry, "span")]
    sites += [("spans", cls, m) for cls in (tracing._Span, tracing._NoopSpan)
              for m in ("__enter__", "__exit__")]
    for cls in (metrics._Noop, metrics._Family, metrics._CounterChild,
                metrics._GaugeChild, metrics._HistogramChild):
        sites += [("metrics", cls, m)
                  for m in ("labels", "inc", "set", "observe")
                  if m in vars(cls)]
    sites += [("request_trace", request_trace.RequestTracer, m)
              for m in ("event", "terminal")]
    sites.append(("flight", flight.FlightRecorder, "record"))
    sites += [("step_profile", cls, m)
              for cls in (profiling.StepProfiler,
                          profiling._NoopStepProfiler)
              for m in ("begin", "lap", "commit")]
    sites += [("perf_attrib", perf_attrib.PerfAttrib, m)
              for m in ("arm", "t0", "done", "on_step")]
    return sites


class _GcClock:
    """Seconds and count of the garbage collector's passes while
    entered (gc.callbacks)."""

    def __init__(self):
        self.seconds, self.passes, self._t0 = 0.0, 0, None

    def _cb(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.seconds += time.perf_counter() - self._t0
            self.passes += 1
            self._t0 = None

    def __enter__(self):
        import gc

        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self._cb)
        return False


class _TelemetryCalls:
    """Counts and times, on the host clock, the outermost telemetry
    calls while ``on`` (a call made inside another wrapped one, such as
    the flight record of a request-trace event, belongs to its caller
    and only costs it the wrapper's pass-through)."""

    def __init__(self):
        self.on, self.depth = False, 0
        self.calls, self.seconds = collections.Counter(), collections.Counter()
        self._saved = []

    def _wrap(self, fn, key):
        clock = time.perf_counter

        def wrapper(*a, **k):
            if not self.on or self.depth:
                return fn(*a, **k)
            self.depth += 1
            t0 = clock()
            try:
                return fn(*a, **k)
            finally:
                self.seconds[key] += clock() - t0
                self.calls[key] += 1
                self.depth -= 1
        return wrapper

    def __enter__(self):
        for part, owner, attr in _hot_path_sites():
            fn = vars(owner)[attr]
            self._saved.append((owner, attr, fn))
            setattr(owner, attr,
                    self._wrap(fn, (part, f"{owner.__name__}.{attr}")))
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved = []
        return False

    def costs(self, steps):
        """{part: {calls_per_step, us_per_step, sites}}."""
        parts = {}
        for (part, site), count in sorted(self.calls.items()):
            secs = self.seconds[(part, site)]
            row = parts.setdefault(part, {"calls_per_step": 0.0,
                                          "us_per_step": 0.0, "sites": {}})
            row["calls_per_step"] += count / steps
            row["us_per_step"] += 1e6 * secs / steps
            row["sites"][site] = {"calls_per_step": count / steps,
                                  "us_per_call": 1e6 * secs / count}
        return parts


def telemetry_attribution(eng, prompts):
    """Serve ``prompts`` once more (untimed as a whole), counting and
    timing the telemetry calls of its decode-only steps and the garbage
    collector's passes in them: the host microseconds a decode step
    spends in each part of the telemetry."""
    decode_steps = 0
    with _TelemetryCalls() as tc, _GcClock() as gcc:
        for p in prompts:
            eng.submit(p, max_new_tokens=32)
        while eng.has_work():
            tc.on = (eng.scheduler.queue_depth == 0
                     and bool(eng.scheduler.running))
            decode_steps += tc.on
            gc0 = gcc.seconds, gcc.passes
            eng.step()
            if not tc.on:
                gcc.seconds, gcc.passes = gc0
            tc.on = False
    parts = tc.costs(decode_steps)
    return {"decode_steps": decode_steps, "parts": parts,
            "us_per_step": sum(r["us_per_step"] for r in parts.values()),
            "gc_us_per_step": 1e6 * gcc.seconds / decode_steps,
            "gc_passes_per_step": gcc.passes / decode_steps}


def step_phase_ms(eng):
    """Mean ms of each step-profile phase over the decode-only steps in
    the profile's ring (None without a step profile)."""
    sprof = getattr(eng, "_sprof", None)
    if sprof is None or not sprof.enabled:
        return None
    rows = [e for e in sprof.recent(256)
            if e["decodes"] and not e["prefills"]]
    phases = sorted({k for e in rows for k in e["phases"]})
    return {k: 1e3 * sum(e["phases"].get(k, 0.0) for e in rows) / len(rows)
            for k in phases} if rows else None


def telemetry_overhead(np_params, card, arms=("off", "on", "sampled")):
    """tok/s and decode-only step ms of the serve prompts with telemetry
    off, on with sampling off, and on with every step sampled (request
    traces and flight dumps on in both on-arms; the watchdog off in
    all three), each engine warmed, the median of 3 timed passes, the
    garbage collector's ms a step in them and the step profile's phases;
    for the off and on arms also the host microseconds a decode step
    spends in each part of the telemetry (telemetry_attribution).  A
    package
    without the telemetry (``--package`` of an older checkout) runs the
    off arm alone."""
    from mxnet_tpu_torch import telemetry

    ported = hasattr(telemetry, "enable")
    arms = arms if ported else ("off",)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for arm in arms:
            on = arm != "off"
            old = _set_env({
                "MXTPU_REQUEST_TRACE": "1" if on else None,
                "MXTPU_REQUEST_TRACE_FILE": (os.path.join(tmp, f"{arm}.jsonl")
                                             if on else None),
                "MXTPU_FLIGHT_DIR": os.path.join(tmp, arm) if on else None,
                "MXTPU_PERF_ATTRIB_SAMPLE": "1" if arm == "sampled" else None})
            if on:
                telemetry.enable()
            elif ported:
                telemetry.disable()
            try:
                eng = full_width_engine(np_params, torch.bfloat16)
                eng.warmup()
                drive(eng, serve_prompts(0))
                steps0 = eng._step_id
                with _GcClock() as gcc:
                    runs = [drive(eng, serve_prompts(0)) for _ in range(3)]
                steps = eng._step_id - steps0
                phases = step_phase_ms(eng)
                attrib = (telemetry_attribution(eng, serve_prompts(0))
                          if ported and arm != "sampled" else None)
                eng.shutdown()
            finally:
                _set_env(old)
                if ported:
                    telemetry.disable()
                    telemetry.reset()
            out[arm] = {
                "tok_per_s": statistics.median(r["tok_per_s"] for r in runs),
                "decode_step_ms": statistics.median(
                    r["decode_step_ms_mean"] for r in runs),
                "tok_per_s_runs": [r["tok_per_s"] for r in runs],
                "decode_step_ms_runs": [r["decode_step_ms_mean"]
                                        for r in runs],
                "gc_ms_per_step": 1e3 * gcc.seconds / steps,
                "gc_passes": gcc.passes, "steps": steps,
                "decode_step_phase_ms": phases,
                "attribution": attrib}
    res = {"card": card, "arms": out}
    if "on" in out and "off" in out:
        res["on_over_off_tok_per_s"] = (out["on"]["tok_per_s"]
                                        / out["off"]["tok_per_s"])
        res["on_minus_off_step_ms"] = (out["on"]["decode_step_ms"]
                                       - out["off"]["decode_step_ms"])
        res["attributed_on_minus_off_ms"] = 1e-3 * (
            out["on"]["attribution"]["us_per_step"]
            - out["off"]["attribution"]["us_per_step"])
    if "sampled" in out and "off" in out:
        res["sampled_over_off_tok_per_s"] = (out["sampled"]["tok_per_s"]
                                             / out["off"]["tok_per_s"])
    return res


def serve_telemetry(np_params, serve_row, serve_toks, card):
    """The serve config's bf16 engine with the reference's telemetry on:
    the registry and the HTTP endpoint (ephemeral port), request traces
    to a file, MXTPU_FLIGHT_DIR, every step's program calls timed with
    CUDA events (MXTPU_PERF_ATTRIB_SAMPLE=1) and the NaN watchdog
    (MXTPU_NUMERIC_WATCH=1).  Checks: warmup() captures the whole grid
    while a thread polls the endpoints (every response parses); the 8
    serve prompts give the serve phase's tokens with no capture, the
    paged launches as in serve; perf call counts equal the programs';
    the bucket-8 decode's event time agrees with graph_ms; MFU in
    (0, 1], and the /statusz perf section, the /metrics text and
    perf_summary() agree; each step's profile against this script's
    clock and the step's event-timed device time; the artifacts parse and tools/metrics_report.py and
    tools/trace_report.py render them; a profiler.trace() of decode
    steps holds both paged kernels; the NaN watchdog binds.  Then the
    overhead arms (recorded, not judged)."""
    from mxnet_tpu_torch import _build, profiler, telemetry
    from mxnet_tpu_torch.ops import paged_attention_cuda as pac
    from mxnet_tpu_torch.telemetry import flight

    n_layers = SERVE_CFG["num_layers"]
    checks = {}
    with tempfile.TemporaryDirectory() as tmp:
        trace_file = os.path.join(tmp, "requests.jsonl")
        old = _set_env({"MXTPU_TELEMETRY_DIR": os.path.join(tmp, "tel"),
                        "MXTPU_REQUEST_TRACE": "1",
                        "MXTPU_REQUEST_TRACE_FILE": trace_file,
                        "MXTPU_FLIGHT_DIR": os.path.join(tmp, "flight"),
                        "MXTPU_PERF_ATTRIB_SAMPLE": "1",
                        "MXTPU_NUMERIC_WATCH": "1"})
        telemetry.reset()
        flight.recorder().clear()
        telemetry.enable()
        server = telemetry.serve_http(telemetry.registry(), 0)
        url = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            # a library found built counts as a compile-cache hit
            _build.build_library(pac.LIB_NAME, pac.SOURCES)
            eng = full_width_engine(np_params, torch.bfloat16)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _Poller(url) as poller:
                ready = eng.warmup()
                torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            checks["capture_under_poller"] = (
                not poller.errors and poller.polls > 1
                and ready == len(eng._warmup_grid())
                and eng.captures == captures_expected(eng, ready))
            # traffic unpolled: a poller holding the GIL between a
            # call's start event and its graph launch would stretch the
            # event-timed interval
            row = drive(eng, serve_prompts(0))
            for k in ("spec_verifies", "spec_accept_rate",
                      "accepted_per_verify", "tokens_per_verify"):
                row.pop(k)
            toks = row.pop("tokens")
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            plans = {b: pac._split_plan(b, SERVE_CFG["kv_heads"],
                                        eng.table_width, eng.block_size, sms)
                     for b in (1, 2, 4, 8)}
            checks["tokens_and_launches"] = (
                row["finished"] and toks == serve_toks
                and row["traffic_captures"] == 0
                and row["kernel_launches"] == n_layers * row["decode_steps"]
                and row["decode_steps"] > 0
                and all(n > 1 for n, _ in plans.values())
                and row["combine_launches"] == row["kernel_launches"])
            perf = eng.statusz()["perf"]
            rows = {(r["kind"], r["bucket"]): r for r in perf["programs"]}
            checks["counts_agree"] = all(
                rows[k]["dispatches"] == p.calls
                and rows[k]["sampled"] == p.calls
                for k, p in eng._programs.items())
            # the three views, read before anything else runs
            import urllib.request

            with urllib.request.urlopen(url + "/statusz.json",
                                        timeout=30) as r:
                page = json.loads(r.read())
            with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
                prom = r.read().decode()
            # this engine's own section: another engine the collector has
            # not freed yet may share the page
            summary = eng.perf_summary()
            http_perf = (page[eng._statusz_name]["perf"]
                         if eng._statusz_name in page else None)
            prom_counts = {
                (lb["kind"], int(lb["bucket"])): v for lb, v in _prom_series(
                    prom, "mxtpu_serve_program_seconds_count")}
            prom_mfu = {lb["kind"]: v for lb, v in _prom_series(
                prom, "mxtpu_serve_mfu")}
            kind_mfu = {}
            for kind in {k for k, _ in rows}:
                rs = [r for (k, _), r in rows.items()
                      if k == kind and r["sampled"] and r["flops"]]
                if rs:
                    kind_mfu[kind] = (
                        sum(r["flops"] * r["sampled"] for r in rs)
                        / sum(r["mean_s"] * r["sampled"] for r in rs)
                        / perf["peak_flops_per_chip"])
            mfu = perf["mfu"]
            views = {"statusz_engine": eng._statusz_name,
                     "statusz_engines": sorted(k for k in page
                                               if k.startswith("serve.engine")),
                     "mfu": [http_perf and http_perf["mfu"], summary["mfu"],
                             mfu],
                     "sampled": [summary["sampled"],
                                 sum(prom_counts.values())],
                     "prom_kinds": sorted(prom_mfu),
                     "perf_kinds": sorted(kind_mfu)}
            checks["views_agree"] = (
                http_perf is not None
                and http_perf["mfu"] == summary["mfu"] == mfu
                and mfu is not None and 0.0 < mfu <= 1.0
                and summary["sampled"] == sum(prom_counts.values())
                and prom_counts == {k: float(r["sampled"])
                                    for k, r in rows.items() if r["sampled"]}
                and set(prom_mfu) == set(kind_mfu)
                and all(abs(prom_mfu[k] - v) <= 1e-9 * v
                        for k, v in kind_mfu.items())
                and http_perf["sampled_steps"] == perf["sampled_steps"])
            perf_ms = 1e3 * rows[("decode", 8)]["mean_s"]
            g_ms = graph_ms(eng, "decode", 8)
            checks["timing_agrees"] = (
                abs(perf_ms - g_ms) <= TIMING_REL * g_ms + TIMING_ABS_MS)
            sp = eng.statusz()["step_profile"]
            # a device trace of decode steps through the port's profiler;
            # the steps around it timed by this script's clock for the
            # step profile's checks
            for p in serve_prompts(0):
                eng.submit(p, max_new_tokens=8)
            walls = timed_steps(eng, until=lambda: not (
                eng.scheduler.queue_depth or eng.scheduler.prefilling
                or not eng.scheduler.running))
            logdir = os.path.join(tmp, "prof")
            sid0 = eng._step_id
            counted0 = (pac.launches, pac.combine_launches)
            torch.cuda.synchronize()
            with profiler.trace(logdir):
                # idle margins: no kernel sits at the window's edges
                time.sleep(0.01)
                for _ in range(4):
                    eng.step()
                torch.cuda.synchronize()
                time.sleep(0.01)
            counted = {"paged_attention_split": pac.launches - counted0[0],
                       "paged_attention_combine": (pac.combine_launches
                                                   - counted0[1])}
            window_decodes = sum(
                1 for e in eng._sprof.recent(64)
                if sid0 < e["step"] <= sid0 + 4 and e["decodes"])
            walls.update(timed_steps(eng))
            sp_ok, sp_row = step_profile_check(eng, walls)
            checks["step_profile_holds"] = sp["enabled"] and sp_ok
            kernels = profiler.summarize(logdir, top=1000)
            traced = {k: sum(c for n, _, c in kernels if k in n)
                      for k in counted}
            checks["profiler_trace"] = (
                window_decodes == 4 and traced == counted
                and all(c == 4 * n_layers for c in traced.values()))
            captures_by_kind = {
                s["labels"]["kind"]: s["value"]
                for s in telemetry.registry().snapshot().get(
                    "mxtpu_cuda_graph_captures_total",
                    {"samples": []})["samples"]}
            hits = telemetry.registry().snapshot().get(
                "mxtpu_compile_cache_hits", {"samples": [{"value": 0}]})
            checks["cudamon"] = (
                sum(captures_by_kind.values()) == eng.captures
                and hits["samples"][0]["value"] >= 1)
            eng.shutdown()
            paths = telemetry.dump()
            with open(paths["trace"]) as f:
                host_names = {e["name"] for e in json.load(f)["traceEvents"]}
            with open(paths["jsonl"]) as f:
                jl = [json.loads(line) for line in f]
            with open(trace_file) as f:
                req_lines = [json.loads(line) for line in f]
            rc_m, out_m = _tool("metrics_report.py", paths["prometheus"],
                                "--filter", "mxtpu_serve_program")
            rc_t, out_t = _tool("trace_report.py", trace_file, "--check")
            checks["artifacts"] = (
                {"serve.step", "serve.prefill", "serve.decode",
                 "serve.warmup"} <= host_names
                and jl and "mxtpu_serve_steps_total" in jl[-1]["metrics"]
                and len(req_lines) == 2 * len(serve_prompts(0))
                and all(ln["status"] == "finished" for ln in req_lines)
                and rc_m == 0 and "kind=decode" in out_m
                and rc_t == 0)
            dumps = sorted(os.listdir(os.path.join(tmp, "flight"))) \
                if os.path.isdir(os.path.join(tmp, "flight")) else []
            checks["no_dump_without_fault"] = dumps == []
        finally:
            server.shutdown()
            telemetry.disable()
            telemetry.reset()
            _set_env(old)
        nan = nan_watch_check(np_params, tmp)
    checks["nan_watch_binds"] = nan["ok"]
    overhead = telemetry_overhead(np_params, card)
    ok = all(checks.values())
    out = {"phase": "serve_telemetry", "dtype": "bfloat16", "card": card,
           **row, "warmup_programs": ready, "warmup_s": warm_s,
           "warmup_captures": eng.captures,
           "statusz_polls_during_warmup": poller.polls,
           "poll_errors": poller.errors,
           "split_plans": {str(b): list(p) for b, p in plans.items()},
           "perf_decode8_ms": perf_ms, "graph_ms_decode8": g_ms,
           "timing_bound_ms": TIMING_REL * g_ms + TIMING_ABS_MS,
           "mfu": mfu, "mfu_by_kind": kind_mfu, "views": views,
           "achieved_tflops": perf["achieved_tflops"],
           "cost_per_1k_tokens_s": perf["cost_per_1k_tokens_s"],
           "perf_programs": {f"{k}/{b}": {
               "calls": r["dispatches"], "mean_ms": 1e3 * r["mean_s"]
               if r["mean_s"] else None, "share": r["share"]}
               for (k, b), r in sorted(rows.items()) if r["dispatches"]},
           "step_profile_fractions": sp["fractions"],
           "step_profile": sp_row,
           "step_profile_bounds_ms": {"wrap": STEP_WRAP_ABS_MS,
                                      "event_slack": EVENT_SLACK_MS},
           "profiler_traced_paged_kernels": traced,
           "profiler_counted_paged_launches": counted,
           "profiler_window_decode_steps": window_decodes,
           "cuda_graph_captures_by_kind": captures_by_kind,
           "nan_watch": nan, "overhead": overhead,
           "serve_phase_tok_per_s": serve_row["tok_per_s"],
           "checks": checks, "ok": ok}
    emit(out)
    if not ok:
        # stderr is what a refused run shows: the views beside the checks
        raise SystemExit(f"serve_telemetry failed its checks: {checks}; "
                         f"views: {out.get('views')}")
    return out


# -- phase 3b: the fleet (router, replicas, supervisor, process front) -------
# the process front's flags at the serve config's widths
FLEET_FRONT_FLAGS = ["--layers", "4", "--d-model", "768", "--heads", "12",
                     "--kv-heads", "3", "--vocab", "50304",
                     "--max-model-len", "256", "--block-size", "16",
                     "--num-blocks", "512", "--max-batch", "8",
                     "--dtype", "bfloat16"]
FLEET_HOP_S = 120.0            # the routers' per-hop timeout here
FLEET_HOST_KV = 1 << 30        # the decode and pulling replicas' host tier


class _FleetPoller:
    """A thread polling ``/statusz.json`` and ``/healthz`` of every
    in-process replica it is given, throughout the fleet phase: each
    answer from a replica that stays ready must parse and name the
    replica."""

    def __init__(self):
        self.replicas = []             # guarded-by: _lock
        self.polls = 0
        self.errors = []
        self._lock = threading.Lock()  # held through each pass
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def add(self, rep):
        with self._lock:
            self.replicas.append(rep)

    def remove(self, rep):
        """Stop polling ``rep``; on return no pass holds it."""
        with self._lock:
            self.replicas.remove(rep)

    def _run(self):
        import urllib.request

        while not self._stop.wait(0.1):
            with self._lock:
                self._pass(urllib.request)

    def _pass(self, request):
        for rep in self.replicas:
            for path in ("/statusz.json", "/healthz"):
                if rep.state != "ready":
                    continue
                try:
                    with request.urlopen(rep.url + path,
                                         timeout=30) as resp:
                        body = json.loads(resp.read())
                    named = (body["replica"]["replica"]
                             if path == "/statusz.json" else body["state"])
                    if named is None:
                        raise ValueError(f"{path} without its section")
                    self.polls += 1
                except Exception as e:       # counted, judged by the phase
                    if rep.state == "ready":
                        self.errors.append(f"{rep.replica_id}{path}: "
                                           f"{e!r}"[:200])

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=60)


def fleet_warm_engine(np_params, manifest, grid=False, **kw):
    """The serve config's bf16 engine warmed from ``manifest`` (and the
    full bucket grid with ``grid``), before any traffic: a capture here
    can never meet a sibling engine's replays."""
    eng = full_width_engine(np_params, torch.bfloat16, **kw)
    ready = eng.warmup(manifest)
    if grid:
        ready += eng.warmup()
    torch.cuda.synchronize()
    if eng.paged_impl != "cuda":
        raise SystemExit(f"engine resolved paged_impl={eng.paged_impl}")
    return eng, ready


def _route_all(router, prompts, tag, max_new=32, **kw):
    """Every prompt through ``router.generate`` at once, one thread
    each: ``(results by index, failures by index, wall seconds)``."""
    results, failures = {}, {}

    def one(i, p):
        try:
            results[i] = router.generate(p.tolist(), max_new_tokens=max_new,
                                         request_id=f"{tag}-{i}", **kw)
        except Exception as e:       # a client-visible failure: judged
            failures[i] = repr(e)[:300]

    threads = [threading.Thread(target=one, args=(i, p))
               for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return results, failures, time.perf_counter() - t0


def _decode_steps(replicas):
    return {r.replica_id: r.engine.decode_steps for r in replicas}


def _launch_window(pac, replicas, before_steps, before_counts):
    """The paged counts of a window against what the replicas' engines
    launched in it: layers x decode steps each, every call split."""
    n_layers = SERVE_CFG["num_layers"]
    steps = {r.replica_id: r.engine.decode_steps
             - before_steps.get(r.replica_id, 0) for r in replicas}
    counted = (pac.launches - before_counts[0],
               pac.combine_launches - before_counts[1])
    expected = n_layers * sum(steps.values())
    return {"decode_steps": steps, "expected": expected,
            "launches": counted[0], "combine_launches": counted[1],
            "ok": (expected > 0 and counted[0] == expected
                   and counted[1] == expected)}


def _chain_proxy(target, corrupt):
    """A peer that answers ``/chain_export`` with ``target``'s records,
    the last record's K bytes flipped when ``corrupt``: a corrupted wire
    for a pulling replica."""
    import base64
    import http.server
    import urllib.request

    class Proxy(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            body = self.rfile.read(int(self.headers.get("Content-Length",
                                                        0)))
            req = urllib.request.Request(
                target + self.path, data=body, method="POST",
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                out = json.loads(resp.read())
            if corrupt and out.get("records"):
                raw = bytearray(base64.b64decode(out["records"][-1]["k"]))
                raw[len(raw) // 2] ^= 0x40
                out["records"][-1]["k"] = base64.b64encode(
                    bytes(raw)).decode("ascii")
            data = json.dumps(out).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Proxy)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _http(url, path, payload=None, timeout=FLEET_HOP_S):
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url + path, data=data,
                                 method="GET" if data is None else "POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def serve_fleet(np_params, serve_row, serve_toks, manifest, card):
    """The fleet's core on the card (ROADMAP A14b-1), every engine the
    serve config's bf16 engine warmed from the serve phase's
    ``manifest`` before it takes traffic, a poller on every in-process
    replica's ``/statusz.json`` and ``/healthz`` throughout:

    0. one engine driven directly on the 8 serve prompts (tok/s);
    1. two ``ReplicaServer``s behind a ``Router`` under a ``Supervisor``:
       the 8 prompts at once, the serve phase's tokens, no capture in
       traffic, the paged launches counted through both engines' replays
       equal to layers x decode steps of each and to the kernel
       instances in a profiler trace of the window;
    2. ``kill@2`` on one replica mid-stream: every request completes
       once, with step 1's tokens; the supervisor restarts the dead
       slot warm, then the sibling is drained and replaced by a warmed
       engine under client traffic, with no client-visible failure;
    3. a ``prefill`` and a ``decode`` replica (host tier on): step 1's
       tokens, handoff bytes = blocks x the host block's bytes, the
       decode replica's ``restore`` programs ran and its decode graphs
       launched the paged kernels;
    4. ``MXTPU_ROUTE_AFFINITY`` 1: a shared-prefix set served on replica
       A, the router's pull hint lands the chain on B, whose prefill
       tokens computed fall by the pulled span and whose tokens equal
       A's; a corrupted record degrades to recompute, counted, tokens
       unchanged;
    5. a ``Supervisor`` slot spawning the process front at the serve
       config's widths, warmed from a manifest: its tokens equal an
       in-process engine's from the same numpy draw; ``kill@2`` ends
       the child, the supervisor restarts it and a request after the
       restart gets the same tokens."""
    import gc

    from mxnet_tpu_torch import _build
    from mxnet_tpu_torch.fleet import (FaultInjector, ProcessReplica,
                                       ReplicaServer, Router, Supervisor)
    from mxnet_tpu_torch.fleet import serve_replica as front
    from mxnet_tpu_torch.fleet.supervisor import replica_command
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.ops import paged_attention_cuda as pac

    import weakref

    t_phase = time.perf_counter()
    prompts = serve_prompts(0)
    checks, rows = {}, {}
    poller = _FleetPoller()
    live = []                          # every in-process replica started

    class Handle:
        def __init__(self, rep):
            self.replica, self.url = rep, rep.url

        def poll(self):
            return None if self.replica.state != "dead" else 1

        def terminate(self, grace_s=None):
            self.replica.stop()

    def start(eng, rid, **kw):
        rep = ReplicaServer(eng, replica_id=rid, **kw).start()
        live.append(rep)
        poller.add(rep)
        return rep

    try:
        # 0. one engine driven directly, cold; then again over its own
        # cached prompts: every prompt but the 16-token ones then
        # recomputes its last 16 tokens through the chunk program over
        # cached blocks, which a decode replica does over restored ones
        direct, _ = fleet_warm_engine(np_params, manifest, grid=True)
        reqs = [direct.submit(p, max_new_tokens=32) for p in prompts]
        direct.run()
        checks["direct_tokens"] = [r.tokens for r in reqs] == serve_toks
        # the timing prompts (new to every engine): driven directly here,
        # routed in step 1, neither under the profiler
        timing_prompts = serve_prompts(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        treqs = [direct.submit(p, max_new_tokens=32)
                 for p in timing_prompts]
        direct.run()
        torch.cuda.synchronize()
        direct_s = time.perf_counter() - t0
        direct_tok = sum(len(r.tokens) for r in treqs)
        timed_toks = [r.tokens for r in treqs]
        del treqs
        reqs = [direct.submit(p, max_new_tokens=32) for p in prompts]
        direct.run()
        toks_cached = [r.tokens for r in reqs]
        rows["direct"] = {
            "cached_pass_prefix_hits": direct.stats().prefix_hits,
            "cached_pass_flips": flips(direct, prompts, serve_toks,
                                       toks_cached)}
        del reqs

        # 1. two replicas behind the router
        pool = [fleet_warm_engine(np_params, manifest)[0] for _ in range(2)]
        gen = [0]

        def spawn(slot):
            gen[0] += 1
            return Handle(start(pool.pop(0), f"slot{slot}-{gen[0]}"))

        router = Router([], scrape_interval_s=0.2, timeout_s=FLEET_HOP_S,
                        retries=4, backoff_s=0.02, backoff_max_s=0.2,
                        breaker_fails=10)
        sup = Supervisor(spawn, 2, router=router, restart_backoff_s=0.0,
                         drain_timeout_s=120)
        sup.start()
        router.scrape()
        router.start()
        reps = [h.replica for h in sup.handles()]
        caps0 = {r.replica_id: r.engine.captures for r in reps}
        router.scrape()
        tres, tfails, twall = _route_all(router, timing_prompts, "f1t")
        tok_timed = sum(len(r.tokens) for r in tres.values())
        checks["routed_timing_pass"] = not tfails and all(
            tres[i].tokens == direct_t for i, direct_t
            in enumerate(timed_toks))
        # the same again on prompts new to both replicas: the first
        # pass's one-time costs apart
        ares, afails, awall = _route_all(router, serve_prompts(2), "f1a")
        checks["routed_timing_pass"] &= not afails
        steps0 = _decode_steps(reps)
        torch.cuda.synchronize()
        router.scrape()
        pac.launches = pac.combine_launches = 0  # the fleet window opens
        with tempfile.TemporaryDirectory() as logdir:
            with profiler.trace(logdir):
                res, fails, wall = _route_all(router, prompts, "f1")
                torch.cuda.synchronize()
            traced = paged_instances(traced_kernels(logdir)[1])
        window = _launch_window(pac, reps, steps0, (0, 0))
        toks1 = [res[i].tokens if i in res else None
                 for i in range(len(prompts))]
        tok1 = sum(len(t) for t in toks1 if t)
        fleet_launches = [window["launches"], window["combine_launches"]]
        checks["routed_tokens"] = not fails and toks1 == serve_toks
        checks["routed_no_capture"] = all(
            r.engine.captures == caps0[r.replica_id] for r in reps)
        checks["routed_launches"] = window["ok"]
        checks["routed_trace"] = (
            traced["paged_attention_split"] == window["launches"]
            and traced["paged_attention_combine"]
            == window["combine_launches"])
        checks["routed_both_served"] = len(
            {res[i].replica for i in res}) == 2
        rows["routed"] = {
            "tok_per_s": tok_timed / twall, "wall_s": twall,
            "second_pass_tok_per_s": sum(
                len(r.tokens) for r in ares.values()) / awall,
            "second_pass_wall_s": awall,
            "direct_tok_per_s": direct_tok / direct_s,
            "direct_wall_s": direct_s,
            "profiled_window_tok_per_s": tok1 / wall,
            "router_added_ms_mean": 1e3 * statistics.mean(
                r.added_s for r in tres.values()) if tres else None,
            "router_added_ms_max": 1e3 * max(
                (r.added_s for r in tres.values()), default=0.0),
            "replicas": sorted({res[i].replica for i in res}),
            "launch_window": window, "traced_paged_kernels": traced,
            "failures": fails}

        # 2. chaos on fresh replicas (a replica whose prefix cache holds
        # a prompt recomputes only its last span, another path): both
        # slots replaced, without traffic, by engines warmed meanwhile;
        # then kill@2 on slot 0 mid-stream
        del reps
        for slot in (0, 1):
            pool.append(fleet_warm_engine(np_params, manifest)[0])
            sup.replace_slot(slot)
        victim = sup.handles()[0].replica
        sibling = sup.handles()[1].replica
        victim.faults = FaultInjector("kill@2")
        caps2 = {r.replica_id: r.engine.captures for r in (victim, sibling)}
        steps2 = _decode_steps([victim, sibling])
        before = (pac.launches, pac.combine_launches)
        router.scrape()         # both idle: the picks alternate
        res2, fails2, wall2 = _route_all(router, prompts, "f2")
        torch.cuda.synchronize()
        toks2 = [res2[i].tokens if i in res2 else None
                 for i in range(len(prompts))]
        killed = victim.state == "dead" and bool(victim.faults.fired)
        window2 = _launch_window(pac, [victim, sibling], steps2, before)
        fleet_launches[0] += window2["launches"]
        fleet_launches[1] += window2["combine_launches"]
        retried = sum(1 for r in res2.values() if r.attempts > 1)
        checks["chaos_killed"] = killed
        checks["chaos_tokens"] = not fails2 and toks2 == toks1
        chaos_flips = flips(direct, prompts, toks1,
                            [t or [] for t in toks2])
        checks["chaos_once_each"] = (
            len(res2) == len(prompts)
            and len({r.request_id for r in res2.values()}) == len(prompts))
        checks["chaos_retried"] = retried > 0
        checks["chaos_launches"] = window2["ok"]
        checks["chaos_no_capture"] = all(
            r.engine.captures == caps2[r.replica_id]
            for r in (victim, sibling))
        fired = [(i, repr(f)) for i, f in victim.faults.fired]
        # the dead slot back, warm: captured before it takes traffic
        pool.append(fleet_warm_engine(np_params, manifest)[0])
        t0 = time.perf_counter()
        restarted = sup.check()
        crash_restart_s = time.perf_counter() - t0
        # the abandoned engine goes when it is collected: its weights,
        # cache and graphs back to the allocator
        victim_bytes = sum(int(t.nbytes)
                           for t in victim.engine.params.values())
        torch.cuda.synchronize()
        mem_dead = torch.cuda.memory_allocated()
        live.remove(victim)
        poller.remove(victim)
        gone = weakref.ref(victim.engine)
        del victim
        t0 = time.perf_counter()
        gc.collect()
        while gone() is not None and time.perf_counter() < t0 + 30:
            time.sleep(0.1)           # its HTTP and step threads end
            gc.collect()
        collect_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        mem_collected = torch.cuda.memory_allocated()
        mem_freed = mem_dead - mem_collected >= victim_bytes
        router.scrape()
        # the sibling drained and replaced under client traffic, by an
        # engine warmed before the drain
        pool.append(fleet_warm_engine(np_params, manifest)[0])
        loads = {}
        load_t = threading.Thread(target=lambda: loads.update(zip(
            ("res", "fails", "wall"),
            _route_all(router, prompts, "f2b", max_new=32))))
        t0 = time.perf_counter()
        load_t.start()
        time.sleep(0.05)
        sup.replace_slot(1)
        rolling_s = time.perf_counter() - t0
        load_t.join(timeout=600)
        toks2b = [loads["res"][i].tokens if i in loads.get("res", {})
                  else None for i in range(len(prompts))]
        checks["restart_crash_slot"] = restarted == [0]
        checks["restart_dead_engine_freed"] = mem_freed
        # a request the drained sibling served may hit its cache (its
        # prompts ran there before): the cached pass's tokens then
        checks["restart_no_client_failure"] = (
            not loads.get("fails")
            and all(t in (toks1[i], toks_cached[i])
                    for i, t in enumerate(toks2b)))
        checks["restart_replaced"] = sibling.state == "dead" and all(
            h.replica.state == "ready" for h in sup.handles())
        rows["chaos"] = {
            "killed": killed, "retried_requests": retried,
            "flips": chaos_flips,
            "replicas_and_attempts": {i: (r.replica, r.attempts)
                                      for i, r in res2.items()},
            "fired": fired, "victim_weight_bytes": victim_bytes,
            "launch_window": window2, "failures": fails2,
            "crash_restart_s": crash_restart_s,
            "drain_replace_s": rolling_s,
            "load_during_replace_failures": loads.get("fails"),
            "load_during_replace_flips": flips(
                direct, prompts, toks1, [t or [] for t in toks2b]),
            "memory_allocated_before_after_collect": [mem_dead,
                                                      mem_collected],
            "collected_after_s": collect_s}
        sup.stop()
        router.stop()
        del sup, sibling
        gc.collect()

        # 3. disaggregation: a prefill and a decode replica
        pre = start(fleet_warm_engine(np_params, manifest, grid=True)[0],
                    "prefill", role="prefill")
        dec = start(fleet_warm_engine(np_params, manifest, grid=True,
                                      host_kv_bytes=FLEET_HOST_KV)[0],
                    "decode", role="decode")
        drouter = Router([pre.url, dec.url], scrape_interval_s=0,
                         timeout_s=FLEET_HOP_S, retries=4, backoff_s=0.02,
                         backoff_max_s=0.2)
        drouter.scrape()
        caps3 = {r.replica_id: r.engine.captures for r in (pre, dec)}
        steps3 = _decode_steps([pre, dec])
        restores0 = sum(p.calls for (k, _), p in dec.engine._programs.items()
                        if k == "restore")
        before = (pac.launches, pac.combine_launches)
        res3, fails3, wall3 = _route_all(drouter, prompts, "f3")
        torch.cuda.synchronize()
        window3 = _launch_window(pac, [pre, dec], steps3, before)
        fleet_launches[0] += window3["launches"]
        fleet_launches[1] += window3["combine_launches"]
        toks3 = [res3[i].tokens if i in res3 else None
                 for i in range(len(prompts))]
        ph = pre._replica_state()["handoff"]
        dh = dec._replica_state()["handoff"]
        block_bytes = dec.engine.host_kv_stats()["block_bytes"]
        blocks = sum(len(p) // dec.engine.block_size for p in prompts)
        restores = sum(p.calls for (k, _), p
                       in dec.engine._programs.items()
                       if k == "restore") - restores0
        handoff_ms = [1e3 * h["wall_s"] for r in res3.values()
                      for h in r.hops if h.get("hop") == "handoff"]
        prefill_hop_ms = [1e3 * h["wall_s"] for r in res3.values()
                          for h in r.hops if h.get("hop") is None]
        # the wire alone for the 128-token prompt's 8 blocks: the
        # prefill replica's export (the handoff's export path) and the
        # decode replica's verified decode of the records
        t0 = time.perf_counter()
        wire = _http(pre.url, "/chain_export", {"prompt":
                                                prompts[3].tolist()})
        wire_parsed, wire_bytes = dec._decode_records(wire["records"])
        wire_ms = 1e3 * (time.perf_counter() - t0)
        # the decode replica recomputes each prompt's last span over
        # restored blocks, bit for bit the blocks a cached pass reads
        checks["disagg_tokens"] = not fails3 and toks3 == toks_cached
        checks["disagg_bytes"] = (ph["exported"] == len(prompts)
                                  and ph["bytes_exported"]
                                  == blocks * block_bytes
                                  and dh["bytes_received"]
                                  == ph["bytes_exported"])
        checks["disagg_restored"] = (restores > 0
                                     and dh["blocks_imported"] > 0
                                     and dec.engine.stats()
                                     .host_kv_restored_tokens > 0)
        checks["disagg_launches"] = (window3["ok"]
                                     and window3["decode_steps"]["decode"]
                                     > 0)
        checks["disagg_no_capture"] = all(
            r.engine.captures == caps3[r.replica_id] for r in (pre, dec))
        rows["disagg"] = {
            "handoff": {"prefill": ph, "decode": dh},
            "flips_against_cold": flips(direct, prompts, toks1,
                                        [t or [] for t in toks3]),
            "blocks": blocks, "block_bytes": block_bytes,
            "restore_calls": restores, "launch_window": window3,
            "handoff_hop_ms_mean": (statistics.mean(handoff_ms)
                                    if handoff_ms else None),
            "handoff_hop_ms_max": max(handoff_ms, default=None),
            "prefill_hop_ms_mean": (statistics.mean(prefill_hop_ms)
                                    if prefill_hop_ms else None),
            "handoff_wire_ms_128": wire_ms,
            "handoff_wire_blocks_128": len(wire_parsed),
            "handoff_wire_bytes_128": wire_bytes,
            "tok_per_s": sum(len(t) for t in toks3 if t) / wall3,
            "failures": fails3}
        drouter.stop()
        for rep in (pre, dec):
            rep.stop()
        direct.shutdown()
        del direct

        # 4. affinity and pull
        rng = np.random.RandomState(5)
        vocab = SERVE_CFG["vocab"]
        prefix = rng.randint(0, vocab, 96).tolist()
        primer = prefix + rng.randint(0, vocab, 16).tolist()
        shared = [prefix + rng.randint(0, vocab, 16).tolist()
                  for _ in range(4)]
        longer = prefix + rng.randint(0, vocab, 32).tolist()
        a = start(fleet_warm_engine(np_params, manifest, grid=True,
                                    host_kv_bytes=FLEET_HOST_KV)[0], "aff-a")
        b = start(fleet_warm_engine(np_params, manifest, grid=True,
                                    host_kv_bytes=FLEET_HOST_KV)[0], "aff-b")
        caps4 = {r.replica_id: r.engine.captures for r in (a, b)}
        steps4 = _decode_steps([a, b])
        before = (pac.launches, pac.combine_launches)
        a_toks = {}
        for i, p in enumerate([primer] + shared + [longer]):
            a_toks[i] = _http(a.url, "/generate",
                              {"prompt": p, "max_new_tokens": 16})["tokens"]
        arouter = Router([a.url, b.url], scrape_interval_s=0,
                         timeout_s=FLEET_HOP_S, retries=4, affinity=1.0,
                         pull=True)
        b_computed0 = b.engine.stats().prefill_tokens_computed
        b_toks, hints, pull_ms = {}, 0, []
        for i, p in enumerate(shared, start=1):
            arouter.scrape()
            with arouter._lock:
                for st in arouter._replicas:
                    if st.url == a.url:
                        st.load = 50.0    # A saturated: the pick is B
            plan = arouter._affinity_plan(p)
            hints += int(arouter._pull_hint(plan, arouter._replicas[1])
                         is not None)
            t0 = time.perf_counter()
            r = arouter.generate(p, max_new_tokens=16)
            pull_ms.append(1e3 * (time.perf_counter() - t0))
            b_toks[i] = r.tokens
            if r.replica != "aff-b":
                b_toks[i] = None
        bst = b.engine.stats()
        pull = b._replica_state()["pull"]
        span = 96 * len(shared)              # the prefix, never recomputed
        computed = bst.prefill_tokens_computed - b_computed0
        # a corrupted record: B pulls the longer chain through a proxy
        # that flips a byte of its last record
        proxy = _chain_proxy(a.url, corrupt=True)
        try:
            out = _http(b.url, "/generate", {
                "prompt": longer, "max_new_tokens": 16,
                "kv_pull": {"peer": f"http://127.0.0.1:"
                                    f"{proxy.server_address[1]}",
                            "tokens": 112}})
        finally:
            proxy.shutdown()
            proxy.server_close()
        pull2 = b._replica_state()["pull"]
        t0 = time.perf_counter()
        export = _http(a.url, "/chain_export", {"prompt": longer})
        parsed, nbytes = b._decode_records(export["records"])
        export_ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        window4 = _launch_window(pac, [a, b], steps4, before)
        fleet_launches[0] += window4["launches"]
        fleet_launches[1] += window4["combine_launches"]
        checks["affinity_hint"] = hints == 1 and pull["attempts"] == 1
        # A exports the first prompt's whole chain (7 full blocks); B's
        # walk restores all but the last, which it recomputes
        checks["affinity_pulled"] = (pull["blocks_imported"]
                                     == len(shared[0]) // 16
                                     and pull["failures"] == 0
                                     and bst.host_kv_restored_tokens == 96)
        checks["affinity_computed_falls"] = computed == sum(
            len(p) for p in shared) - span
        checks["affinity_tokens"] = all(b_toks[i] == a_toks[i]
                                        for i in b_toks)
        checks["corrupt_counted"] = (pull2["failures"] == 1
                                     and pull2["attempts"] == 2
                                     and pull2["blocks_imported"]
                                     == pull["blocks_imported"])
        checks["corrupt_tokens"] = out["tokens"] == a_toks[5]
        checks["affinity_launches"] = window4["ok"]
        checks["affinity_no_capture"] = all(
            r.engine.captures == caps4[r.replica_id] for r in (a, b))
        rows["affinity"] = {
            "pull": pull2, "pull_hints": hints,
            "b_prefill_tokens_computed": computed,
            "b_prompt_tokens": sum(len(p) for p in shared),
            "b_host_kv_restored_tokens": bst.host_kv_restored_tokens,
            "routed_ms_with_pull_first": pull_ms[0],
            "routed_ms_after": pull_ms[1:],
            "chain_export_and_decode_ms": export_ms,
            "chain_export_blocks": len(parsed),
            "chain_export_bytes": nbytes, "launch_window": window4}
        arouter.stop()
        for rep in (a, b):
            rep.stop()
        poller.stop()
        checks["poller"] = poller.polls > 0 and not poller.errors
        rows["poller"] = {"polls": poller.polls,
                          "errors": poller.errors[:10]}
        gc.collect()

        # 5. the process front under a supervisor
        args = front.parse_args(FLEET_FRONT_FLAGS)
        cfg, front_params = front.build_model(args)
        eng = full_width_engine(front_params, torch.bfloat16,
                                max_prefills_per_step=2, max_queue=32)
        eng.warmup(manifest)
        front_prompts = serve_prompts(0)[:3]
        want = []
        for p in front_prompts:          # one at a time, as the child
            r = eng.submit(p, max_new_tokens=16)
            eng.run()
            want.append(r.tokens)
        with tempfile.TemporaryDirectory() as tmp:
            front_manifest = os.path.join(tmp, "front.jsonl")
            eng.save_manifest(front_manifest)
            eng.shutdown()
            del eng, front_params
            env = dict(os.environ, PYTHONPATH=ROOT,
                       MXTPU_TORCH_BUILD_DIR=_build.build_dir(),
                       MXTPU_WARMUP_MANIFEST=front_manifest)
            for var in ("MXTPU_FAULT_SPEC", "MXTPU_AOT_DIR",
                        "MXTPU_FLEET_ROLE", "MXTPU_COMPILE_CACHE"):
                env.pop(var, None)
            spawned = []

            def spawn_proc(slot):
                e = dict(env)
                if not spawned:
                    e["MXTPU_FAULT_SPEC"] = "kill@2"
                t0 = time.perf_counter()
                h = ProcessReplica(replica_command(
                    0, FLEET_FRONT_FLAGS + ["--device", DEVICE]), env=e)
                spawned.append(h)
                h.wait_ready(timeout_s=300)
                h.spawn_to_ready_s = time.perf_counter() - t0
                h.ready = next(json.loads(ln) for ln in
                               h.output_tail().splitlines()
                               if ln.startswith('{"ready"'))
                return h

            prouter = Router([], scrape_interval_s=0, timeout_s=FLEET_HOP_S,
                             retries=2)
            psup = Supervisor(spawn_proc, 1, router=prouter,
                              restart_backoff_s=0.0)
            try:
                psup.start()
                first = psup.handles()[0]
                prouter.scrape()
                got = [prouter.generate(front_prompts[0].tolist(),
                                        max_new_tokens=16).tokens]
                try:                    # the child's second arrival: kill
                    _http(first.url, "/generate",
                          {"prompt": front_prompts[1].tolist(),
                           "max_new_tokens": 16})
                    killed_proc = False
                except Exception:
                    killed_proc = True
                rc = first.proc.wait(timeout=60)
                t0 = time.perf_counter()
                restarted = psup.check()
                restart_s = time.perf_counter() - t0
                prouter.scrape()
                for p in front_prompts[1:]:
                    got.append(prouter.generate(
                        p.tolist(), max_new_tokens=16).tokens)
                second = psup.handles()[0]
            finally:
                psup.stop()
                prouter.stop()
            stopped = all(h.poll() is not None for h in spawned)
        checks["process_tokens"] = got == want
        checks["process_killed"] = killed_proc and rc == 1
        checks["process_restarted"] = (restarted == [0]
                                       and second is not first)
        # the child records what its traffic ran into the manifest it
        # warmed from: the restarted child warms from that
        checks["process_warmed"] = (first.ready["warmed"] > 0
                                    and second.ready["warmed"] > 0
                                    and first.ready["backend"] == DEVICE)
        checks["process_stopped"] = stopped
        rows["process"] = {
            "ready": [first.ready, second.ready],
            "ready_s": [first.ready["ready_s"], second.ready["ready_s"]],
            "spawn_to_ready_s": [first.spawn_to_ready_s,
                                 second.spawn_to_ready_s],
            "restart_to_ready_s": restart_s,
            "warmed": [first.ready["warmed"], second.ready["warmed"]],
            "exit_code_after_kill": rc}
    finally:
        poller.stop()
        for rep in live:
            if rep.state != "dead":
                rep.stop()
    ok = all(checks.values())
    emit({"phase": "serve_fleet_summary", "card": card,
          "router_tok_per_s": rows.get("routed", {}).get("tok_per_s"),
          "direct_tok_per_s": rows.get("routed", {}).get(
              "direct_tok_per_s"),
          "router_added_ms_mean": rows.get("routed", {}).get(
              "router_added_ms_mean"),
          "handoff_hop_ms_mean": rows.get("disagg", {}).get(
              "handoff_hop_ms_mean"),
          "handoff_wire_ms_128": rows.get("disagg", {}).get(
              "handoff_wire_ms_128"),
          "routed_ms_with_pull": rows.get("affinity", {}).get(
              "routed_ms_with_pull_first"),
          "chain_export_and_decode_ms": rows.get("affinity", {}).get(
              "chain_export_and_decode_ms"),
          "crash_restart_s": rows.get("chaos", {}).get("crash_restart_s"),
          "drain_replace_s": rows.get("chaos", {}).get("drain_replace_s"),
          "process_ready_s": rows.get("process", {}).get("ready_s"),
          "process_restart_to_ready_s": rows.get("process", {}).get(
              "restart_to_ready_s"),
          "process_warmed": rows.get("process", {}).get("warmed")})
    out = {"phase": "serve_fleet", "dtype": "bfloat16", "card": card,
           "requests": len(prompts), "new_tokens": 32,
           "serve_phase_tok_per_s": serve_row["tok_per_s"],
           "kernel_launches": fleet_launches[0],
           "combine_launches": fleet_launches[1],
           "seconds": time.perf_counter() - t_phase,
           **rows, "checks": checks, "ok": ok}
    emit(out)
    if not ok:
        raise SystemExit("serve_fleet failed its checks: "
                         + ", ".join(k for k, v in checks.items() if not v))
    return out


# -- the fleet's sensors (serve_fleet_obs) -----------------------------------
OBS_SLO = "total_p90_ms=1000"  # a routed request here takes ~0.1-0.3 s
OBS_SLO_FAST_S = 15            # the SLO windows: the burn's requests alone
OBS_SLO_SLOW_S = 60
OBS_DELAY_S = 1.5              # the delay fault that breaks it on one replica
OBS_WINDOW_S = 2.0             # capture_fleet's windows on the process pair
OBS_ROUNDS = 4                 # tok/s arms, alternating idle/scraping
OBS_ARM_ROUNDS = 6             # rounds of 8 fresh prompts an arm
OBS_MONITOR_INTERVAL = 8       # ServeMonitor: a line every 8 steps
OBS_HOP_S = 60.0               # the phase's bound on one HTTP request
OBS_SERVE_LINE = re.compile(
    r"^Serve: step +\d+ queue=\d+ running=\d+ done=\d+ rej=\d+\[[^\]]*\] "
    r"preempt=\d+ blocks=\d+/\d+ \(\d+%\) ttft_ms=(-|[0-9.]+) "
    r"tok/s=(-|[0-9.]+)( spec=\S+)?( mfu=\S+ tok_flops=\S+)?$")


def _generate_all(url, prompts, tag, max_new=32, timeout=OBS_HOP_S):
    """Every prompt to one replica's ``/generate`` at once, a thread
    each: ``(tokens by index, failures by index)``."""
    toks, fails = {}, {}

    def one(i, p):
        try:
            toks[i] = _http(url, "/generate",
                            {"prompt": p.tolist(), "max_new_tokens": max_new,
                             "request_id": f"{tag}-{i}"},
                            timeout=timeout)["tokens"]
        except Exception as e:       # a client-visible failure: judged
            fails[i] = repr(e)[:300]

    threads = [threading.Thread(target=one, args=(i, p))
               for i, p in enumerate(prompts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout + 30)
    return [toks.get(i) for i in range(len(prompts))], fails


def _wait_capture(url, cap_id, timeout=60.0):
    """A capture's metadata once it left ``running`` (or at timeout)."""
    deadline = time.monotonic() + timeout
    meta = _http(url, f"/profilez/{cap_id}")
    while meta.get("state") in ("starting", "opening", "running") \
            and time.monotonic() < deadline:
        time.sleep(0.05)
        meta = _http(url, f"/profilez/{cap_id}")
    return meta


def c8_check(np_params, manifest, want, mode):
    """C8 (a capture beside a sibling engine's replays, one process):
    replica A, warmed from ``manifest`` and the grid, serves the 8
    prompts round after round on its step thread while replica B, not
    warmed, serves them once from another thread and so captures its
    programs in traffic, with ``serve.engine._CAPTURE_MODE = mode``.
    Both prefix caches are off, so every round is a cold pass: A's
    rounds and B's tokens must be ``want``, B must capture in traffic, A
    must not, and neither replica may die."""
    from mxnet_tpu_torch.fleet import ReplicaServer
    from mxnet_tpu_torch.serve import engine as engine_mod

    engine_mod._CAPTURE_MODE = mode
    prompts = serve_prompts(0)
    a_eng = fleet_warm_engine(np_params, manifest, grid=True,
                              prefix_cache=False)[0]
    b_eng = full_width_engine(np_params, torch.bfloat16, prefix_cache=False)
    a = ReplicaServer(a_eng, replica_id="c8-a").start()
    b = ReplicaServer(b_eng, replica_id="c8-b").start()
    a_caps = a_eng.captures
    stop, a_rounds, a_fails = threading.Event(), [], {}

    def drive_a():
        while not stop.is_set():
            toks, fails = _generate_all(a.url, prompts,
                                        f"a{len(a_rounds)}", timeout=30)
            a_rounds.append(toks)
            a_fails.update(fails)
            if fails or a.state == "dead":
                return

    t0 = time.perf_counter()
    th = threading.Thread(target=drive_a, daemon=True)
    th.start()
    try:
        while a_eng.decode_steps == 0 and th.is_alive():
            time.sleep(0.001)
        b_toks, b_fails = _generate_all(b.url, prompts, "b", timeout=30)
    finally:
        stop.set()
        th.join(timeout=120)
    checks = {"a_tokens": bool(a_rounds) and all(r == want
                                                 for r in a_rounds),
              "b_tokens": b_toks == want,
              "b_captured_in_traffic": b_eng.captures > 0,
              "a_no_capture": a_eng.captures == a_caps,
              "no_failure": not a_fails and not b_fails,
              "alive": a.state == b.state == "ready"}
    row = {"mode": mode, "a_rounds": len(a_rounds),
           "b_captures_in_traffic": b_eng.captures,
           "a_captures_in_traffic": a_eng.captures - a_caps,
           "decode_steps": {"a": a_eng.decode_steps,
                            "b": b_eng.decode_steps},
           "states": {"a": a.state, "b": b.state},
           "failures": {**{f"a{i}": f for i, f in a_fails.items()},
                        **{f"b{i}": f for i, f in b_fails.items()}},
           "seconds": time.perf_counter() - t0,
           "checks": checks, "ok": all(checks.values())}
    engine_mod._CAPTURE_MODE = "thread_local"
    for rep in (a, b):
        if rep.state != "dead":
            rep.stop()
    return row


def c8_planted(directory):
    """``--c8-planted DIR``: ``c8_check`` in torch's global capture mode
    (the parent commit's), in a process of its own (a capture error may
    leave the CUDA context unusable), from DIR's ``manifest.jsonl`` and
    ``tokens.json``; prints its row as one JSON line.  It must fail."""
    from mxnet_tpu_torch.ops import paged_attention_cuda as pac

    pac._fns()
    with open(os.path.join(directory, "manifest.jsonl")) as f:
        manifest = [json.loads(ln) for ln in f if ln.strip()]
    with open(os.path.join(directory, "tokens.json")) as f:
        want = json.load(f)
    try:
        row = c8_check(serve_params(), manifest, want, "global")
    except Exception as e:           # the fault may surface anywhere
        row = {"mode": "global", "ok": False, "raised": repr(e)[:500]}
    print(json.dumps({"phase": "c8_planted", **row}), flush=True)
    os._exit(0)          # replicas a capture error left behind: no join


def monitor_check(np_params, manifest):
    """``ServeMonitor`` with ``MXTPU_TIMESERIES``: telemetry on, a warmed
    engine serves 8 fresh prompts with a ``tic()`` every step; a line
    every ``OBS_MONITOR_INTERVAL`` steps in the reference's format, each
    line a ring sample (``MXTPU_TIMESERIES_INTERVAL`` 0), the ring's
    last tokens sample the engine's own count, and its windowed tok/s
    beside the engine's."""
    import logging

    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.monitor import ServeMonitor
    from mxnet_tpu_torch.telemetry import timeseries

    old = _set_env({"MXTPU_TIMESERIES": "4096",
                    "MXTPU_TIMESERIES_INTERVAL": "0"})
    telemetry.reset()
    telemetry.enable()
    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    logger = logging.getLogger("chip_smoke.serve_monitor")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    keep = Keep(level=logging.INFO)
    logger.addHandler(keep)
    eng = None
    try:
        eng = fleet_warm_engine(np_params, manifest, grid=True)[0]
        mon = ServeMonitor(eng, interval=OBS_MONITOR_INTERVAL, logger=logger)
        for p in serve_prompts(4):
            eng.submit(p, max_new_tokens=32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while eng.has_work():
            eng.step()
            mon.tic()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        mon.log_now()                    # the closing sample and line
        ring = timeseries.ring()
        st = eng.stats()
        name = "mxtpu_serve_tokens_generated_total"
        ring_rate = ring.rate(name, wall + 60.0) if ring else None
        checks = {
            "monitor_lines": (len(lines) == mon.step // OBS_MONITOR_INTERVAL
                              + 1 and all(OBS_SERVE_LINE.match(ln)
                                          for ln in lines)),
            "monitor_ring_sampled": (ring is not None
                                     and ring.taken == len(lines)),
            "monitor_ring_tokens": (ring is not None and ring.latest(name)
                                    == st.tokens_generated)}
        row = {"lines": len(lines), "decode_steps": eng.decode_steps,
               "first_line": lines[0] if lines else None,
               "last_line": lines[-1] if lines else None,
               "steps": mon.step, "ring_samples": ring.taken if ring else 0,
               "ring_tok_per_s": ring_rate,
               "engine_decode_tok_per_s": st.decode_tok_per_sec,
               "engine_total_tok_per_s": st.total_tok_per_sec,
               "tokens_over_wall_tok_per_s": st.tokens_generated / wall,
               "wall_s": wall, "checks": checks}
    finally:
        logger.removeHandler(keep)
        timeseries.configure(0)
        telemetry.disable()
        telemetry.reset()
        _set_env(old)
        if eng is not None:
            eng.shutdown()
    return row


def _steps_ms(eng, lo, hi):
    """Mean wall ms of the engine's decode-only steps with ids in
    [lo, hi] (its step profile ring), and how many there were."""
    walls = [1e3 * e["wall_s"] for e in eng._sprof.recent(256)
             if e["decodes"] and not e["prefills"] and lo <= e["step"] <= hi]
    return (statistics.mean(walls) if walls else None), len(walls)


def sensors_check(np_params, manifest, tmp):
    """The in-process sensors over two warmed replicas behind a router,
    a ``FleetCollector`` receiving both replicas' pushed traces: a
    ``delay`` fault on one replica breaks ``MXTPU_SLO_SPEC``'s latency
    objective (requests one at a time, a scrape and evaluation after
    each) until the fast-burn alert fires on that replica, captures a
    trace there (``done``) and writes a flight dump carrying the
    capture's id; then, fault and evaluator gone, routed tok/s in arms
    alternating without and with a second collector scraping every
    0.5 s (fresh prompts); one replica's decode steps inside a
    ``/profilez`` window against outside one (a round of fresh prompts
    each); last, ``/fleetz.json``'s token totals against the replicas'
    own ``/statusz.json`` sums."""
    from mxnet_tpu_torch.fleet import (FaultInjector, FleetCollector,
                                       ReplicaServer, Router)

    caps, flight = os.path.join(tmp, "caps"), os.path.join(tmp, "flight")
    old = _set_env({"MXTPU_SLO_SPEC": OBS_SLO,
                    "MXTPU_SLO_FAST_WINDOW": str(OBS_SLO_FAST_S),
                    "MXTPU_SLO_SLOW_WINDOW": str(OBS_SLO_SLOW_S),
                    "MXTPU_SLO_FAST_BURN": "2",
                    "MXTPU_SLO_SLOW_BURN": "1", "MXTPU_SLO_MIN_REQUESTS": "5",
                    "MXTPU_PROFILEZ_BURN_S": "1.0",
                    "MXTPU_PROFILEZ_INTERVAL_S": "0",
                    "MXTPU_PROFILEZ_DIR": caps, "MXTPU_FLIGHT_DIR": flight,
                    "MXTPU_TRACE_PUSH_URL": None})
    checks, row, live = {}, {}, []
    col = router = None
    try:
        col = FleetCollector(urls=[], interval_s=0, port=0).start()
        os.environ["MXTPU_TRACE_PUSH_URL"] = col.url + "/trace"
        for rid in ("obs-slow", "obs-good"):
            rep = ReplicaServer(fleet_warm_engine(np_params, manifest)[0],
                                replica_id=rid).start()
            live.append(rep)
            col.add_replica(rep.url)
        slow, good = live
        router = Router([r.url for r in live], scrape_interval_s=0.2,
                        timeout_s=FLEET_HOP_S, retries=4, backoff_s=0.02,
                        backoff_max_s=0.2, breaker_fails=10)
        router.scrape()
        router.start()
        # the burn: every arrival at the slow replica waits OBS_DELAY_S;
        # requests one at a time (the router's picks alternate) until the
        # alert has captured and dumped there, or 64 requests
        slow.faults = FaultInjector(";".join(
            f"delay@{k}:{OBS_DELAY_S}" for k in range(1, 400)))

        def dumped():
            for ann in col.annotations(500):
                if ann["kind"] == "slo_flight_dump":
                    for d in ann["dumps"]:
                        if d["replica"] == "obs-slow" \
                                and d.get("capture_id"):
                            return d
            return None

        burn_fails, entry, sent = {}, None, 0
        rng = np.random.RandomState(8)
        while entry is None and sent < 64:
            p = rng.randint(0, SERVE_CFG["vocab"], (32,))
            try:
                router.generate(p.tolist(), max_new_tokens=16,
                                request_id=f"obs-burn-{sent}")
            except Exception as e:   # a client-visible failure: judged
                burn_fails[sent] = repr(e)[:300]
            sent += 1
            col.scrape()             # scrape, then evaluate, as live
            entry = dumped()
        deadline = time.monotonic() + 30
        while entry is None and time.monotonic() < deadline:
            time.sleep(0.5)
            col.scrape()
            entry = dumped()
        slo = col.slo.statusz()["objectives"][0]
        burn_meta = (_wait_capture(slow.url, entry["capture_id"])
                     if entry else {})
        dump_extra = {}
        if entry and entry.get("path"):
            with open(entry["path"]) as f:
                dump_extra = json.load(f).get("extra", {})
        checks["burn_fired"] = (entry is not None and slo["fired_total"] > 0
                                and not burn_fails)
        checks["burn_capture_done"] = burn_meta.get("state") == "done"
        checks["burn_dump_carries_capture"] = (
            entry is not None
            and dump_extra.get("capture_id") == entry["capture_id"]
            and dump_extra.get("replica") == "obs-slow")
        row["burn"] = {"objective": slo, "dump": entry,
                       "capture": {k: burn_meta.get(k) for k in (
                           "id", "state", "reason", "steps",
                           "decode_steps", "open_wait_s", "error")},
                       "dump_extra": dump_extra, "requests": sent,
                       "failures": burn_fails}
        # the burn's end: no fault, and no evaluator (its later dumps
        # and captures would land in the timed arms)
        slow.faults = FaultInjector()
        col.slo = None

        # routed tok/s, alternating arms without and with a second
        # collector scraping both replicas every 0.5 s
        arms = {"collector_idle": [0, 0.0], "collector_scraping": [0, 0.0]}
        arm_fails = {}
        for rnd in range(OBS_ROUNDS):
            arm = ("collector_idle", "collector_scraping")[rnd % 2]
            scraper = None
            if arm == "collector_scraping":
                scraper = FleetCollector(urls=[r.url for r in live],
                                         interval_s=0.5).start()
            try:
                for k in range(OBS_ARM_ROUNDS):
                    router.scrape()
                    res, f, w = _route_all(
                        router, serve_prompts(100 + OBS_ARM_ROUNDS * rnd
                                              + k), f"obs-{rnd}-{k}")
                    arms[arm][0] += sum(len(r.tokens)
                                        for r in res.values())
                    arms[arm][1] += w
                    arm_fails.update(f)
            finally:
                if scraper is not None:
                    row.setdefault("scraper_passes", []).append(
                        scraper._scrape_passes)
                    scraper.stop()
        row["routed"] = {arm: {"tok_per_s": t / w, "wall_s": w}
                         for arm, (t, w) in arms.items()}
        row["routed"]["failures"] = arm_fails
        checks["routed_served"] = not arm_fails

        # decode steps inside a window against outside one, one replica
        s0 = good.engine._step_id
        _, out_fails = _generate_all(good.url, serve_prompts(5), "out")
        outside = _steps_ms(good.engine, s0 + 1, good.engine._step_id)
        t0 = time.perf_counter()
        cap = _http(good.url, "/profilez", {"duration_s": 1.0,
                                            "reason": "step_ms"})
        handler_s = time.perf_counter() - t0
        _, in_fails = _generate_all(good.url, serve_prompts(6), "in")
        meta = _wait_capture(good.url, cap["id"])
        ids = meta.get("step_ids") or (1, 0)
        inside = _steps_ms(good.engine, *ids)
        checks["window_done"] = (meta["state"] == "done"
                                 and not out_fails and not in_fails
                                 and inside[1] > 0)
        row["profilez_window"] = {
            "decode_step_ms_inside": inside[0], "steps_inside": inside[1],
            "decode_step_ms_outside": outside[0],
            "steps_outside": outside[1], "window_steps": meta.get("steps"),
            "handler_wait_s": handler_s,
            "open_wait_s": meta.get("open_wait_s")}

        # three views: /fleetz.json against the replicas' own sums
        col.scrape()
        fleetz = _http(col.url, "/fleetz.json")
        truth = sum(_http(r.url, "/statusz.json")["replica"]["stats"][
            "tokens_generated"] for r in live)
        checks["fleetz_totals"] = (
            fleetz["totals"]["tokens_generated"] == truth > 0
            and fleetz["totals"]["stale"] == 0)
        row["fleetz"] = {"tokens_generated": fleetz["totals"][
            "tokens_generated"], "replicas_sum": truth,
            "traces_received": fleetz["traces"]["received"],
            "scrape_passes": col._scrape_passes}
        row["decode_steps"] = {r.replica_id: r.engine.decode_steps
                               for r in live}
    finally:
        if router is not None:
            router.stop()
        if col is not None:
            col.stop()
        for rep in live:
            if rep.state != "dead":
                rep.stop()
        _set_env({**old, "MXTPU_TRACE_PUSH_URL": old.get(
            "MXTPU_TRACE_PUSH_URL")})
    return row, checks


def process_capture_check(tmp):
    """``capture_fleet`` over two process replicas on the one card (the
    process front at the serve config's widths, the full grid warmed at
    start, the built libraries' directory handed to the children):
    under routed traffic both windows open concurrently and are
    accepted; each trace holds ``paged_attention_split`` and
    ``_combine`` instances equal to layers x the decode steps that
    replica ran inside its window (from its own counters); then
    ``tools/timeline_report.py --check`` over the router's and the
    replicas' trace lines, their ``/statusz.json`` and both captures."""
    from mxnet_tpu_torch import _build
    from mxnet_tpu_torch.fleet import FleetCollector, ProcessReplica, Router
    from mxnet_tpu_torch.fleet.supervisor import replica_command

    n_layers = SERVE_CFG["num_layers"]
    router_trace = os.path.join(tmp, "router.jsonl")
    old = _set_env({"MXTPU_REQUEST_TRACE": router_trace,
                    "MXTPU_TRACE_PUSH_URL": None})
    checks, row, procs = {}, {}, []
    router = col = None
    try:
        t0 = time.perf_counter()
        for i in range(2):
            env = dict(os.environ, PYTHONPATH=ROOT,
                       MXTPU_TORCH_BUILD_DIR=_build.build_dir(),
                       MXTPU_REQUEST_TRACE=os.path.join(tmp, f"rep{i}.jsonl"),
                       MXTPU_PROFILEZ_DIR=os.path.join(tmp, f"pcaps{i}"),
                       MXTPU_PROFILEZ_INTERVAL_S="0")
            for var in ("MXTPU_FAULT_SPEC", "MXTPU_WARMUP_MANIFEST",
                        "MXTPU_SLO_SPEC", "MXTPU_FLIGHT_DIR",
                        "MXTPU_COMPILE_CACHE"):
                env.pop(var, None)
            procs.append(ProcessReplica(replica_command(
                0, FLEET_FRONT_FLAGS + ["--device", DEVICE, "--warmup",
                                        "full", "--replica-id",
                                        f"obs-p{i}"]), env=env))
        for h in procs:
            h.wait_ready(timeout_s=300)
        row["spawn_to_ready_s"] = time.perf_counter() - t0
        urls = [h.url for h in procs]
        router = Router(urls, scrape_interval_s=0, timeout_s=FLEET_HOP_S,
                        retries=2)
        router.scrape()
        col = FleetCollector(urls=urls, interval_s=0)
        col.scrape()
        stop, fails, rounds = threading.Event(), {}, [0]

        def traffic():
            while not stop.is_set():
                router.scrape()
                _, f, _ = _route_all(router, serve_prompts(10 + rounds[0]),
                                     f"cf{rounds[0]}")
                fails.update(f)
                rounds[0] += 1

        th = threading.Thread(target=traffic, daemon=True)
        th.start()
        time.sleep(0.3)                       # traffic on both replicas
        t0 = time.perf_counter()
        results = col.capture_fleet(duration_s=OBS_WINDOW_S,
                                    reason="chip_smoke")
        open_s = time.perf_counter() - t0
        metas = {}
        for name, payload in results.items():
            metas[name] = (_wait_capture(col.url_for_replica(name),
                                         payload["id"])
                           if payload else None)
        stop.set()
        th.join(timeout=300)
        checks["captures_accepted"] = (
            len(results) == 2 and all(results.values()))
        traced, windows = {}, {}
        for name, meta in metas.items():
            if meta is None or meta.get("state") != "done":
                traced[name] = None
                continue
            counts = traced_kernels(meta["logdir"])[1]
            traced[name] = paged_instances(counts)
            windows[name] = {k: meta.get(k) for k in (
                "id", "started_epoch", "steps", "decode_steps", "step_ids",
                "open_wait_s", "duration_s")}
            windows[name]["expected_each"] = n_layers * meta["decode_steps"]
            windows[name]["replays"] = graph_replays(meta["trace_file"])
        checks["captures_done"] = (len(metas) == 2 and all(
            m is not None and m.get("state") == "done"
            for m in metas.values()))
        checks["captures_trace_launches"] = checks["captures_done"] and all(
            t is not None and windows[n]["decode_steps"] > 0
            and all(c == windows[n]["expected_each"] for c in t.values())
            for n, t in traced.items())
        # every graph replay in a window reached the trace with its
        # device events (CUPTI's last records come after the stop's
        # settle, profiler.STOP_SETTLE_S)
        checks["captures_replays_whole"] = bool(windows) and all(
            w["replays"]["graph_launches"] > 0
            and not w["replays"]["launches_without_device_events"]
            for w in windows.values()) and len(windows) == 2
        starts = [m["started_epoch"] for m in metas.values() if m]
        row["capture_fleet"] = {
            "windows": windows, "traced_paged_kernels": traced,
            "handler_to_both_open_s": open_s,
            "started_epoch_spread_s": (max(starts) - min(starts)
                                       if len(starts) == 2 else None),
            "rounds": rounds[0], "failures": fails}
        checks["captures_traffic_served"] = not fails and rounds[0] > 0

        # the stitched timeline
        args = []
        for i, h in enumerate(procs):
            snap = os.path.join(tmp, f"statusz{i}.json")
            with open(snap, "w") as f:
                json.dump(_http(h.url, "/statusz.json"), f)
            args += ["--trace", os.path.join(tmp, f"rep{i}.jsonl"),
                     "--statusz", snap]
        for name, meta in metas.items():
            if meta:
                path = os.path.join(tmp, f"capture-{name}.json")
                with open(path, "w") as f:
                    json.dump(meta, f)
                args += ["--capture", path]
        summary_path = os.path.join(tmp, "timeline_summary.json")
        rc, out = _tool("timeline_report.py", "--trace", router_trace,
                        *args, "--out", os.path.join(tmp, "TIMELINE.json"),
                        "--json", summary_path, "--check")
        summary = {}
        if os.path.exists(summary_path):
            with open(summary_path) as f:
                summary = json.load(f)["summary"]
        checks["timeline_check"] = (
            rc == 0 and summary.get("unanchored") == 0
            and summary.get("device_events", 0) > 0
            and summary.get("captures_missing") == 0)
        row["timeline"] = {"rc": rc, **{k: summary.get(k) for k in (
            "requests", "hops", "router_hops", "steps", "device_events",
            "device_events_dropped", "unanchored", "captures_missing")},
            "output_tail": out[-600:] if rc else None}
    finally:
        if router is not None:
            router.stop()
        if col is not None:
            col.stop()
        for h in procs:
            h.terminate()
        _set_env(old)
    row["stopped"] = all(h.poll() is not None for h in procs)
    checks["processes_stopped"] = row["stopped"]
    return row, checks


def serve_fleet_obs(np_params, serve_row, serve_toks, manifest, card):
    """The fleet's sensors on the card (ROADMAP A14b-2), at the serve
    config's full width (bf16, 4 layers), every in-process engine but
    C8's B warmed from the serve phase's ``manifest`` before traffic:

    1. C8: ``c8_check`` in the port's capture mode (passes), then in a
       process of its own with the parent's global mode (a planted
       fault: the check must fail there);
    2. ``sensors_check``: the collector, the burn alert's capture and
       flight dump, ``/fleetz.json`` against the replicas' sums, routed
       tok/s with the collector idle and scraping, decode-step ms inside
       a ``/profilez`` window and outside it;
    3. ``process_capture_check``: ``capture_fleet`` over two process
       replicas, traced paged instances = layers x each window's decode
       steps, ``timeline_report --check``;
    4. ``monitor_check``: ``ServeMonitor`` lines and the time-series
       ring.

    The paged counters are zeroed before the phase and read after it:
    they must equal layers x the decode steps of every in-process engine
    the phase ran."""
    from mxnet_tpu_torch.ops import paged_attention_cuda as pac

    t_phase = time.perf_counter()
    n_layers = SERVE_CFG["num_layers"]
    checks, rows = {}, {}

    pac.launches = pac.combine_launches = 0   # the phase's window opens
    c8 = c8_check(np_params, manifest, serve_toks, "thread_local")
    rows["c8"] = c8
    checks.update({f"c8_{k}": v for k, v in c8["checks"].items()})
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "manifest.jsonl"), "w") as f:
            for e in manifest:
                f.write(json.dumps(e) + "\n")
        with open(os.path.join(tmp, "tokens.json"), "w") as f:
            json.dump(serve_toks, f)
        env = dict(os.environ, PYTHONPATH=ROOT)
        from mxnet_tpu_torch import _build

        env["MXTPU_TORCH_BUILD_DIR"] = _build.build_dir()
        env.pop("MXTPU_COMPILE_CACHE", None)   # the build dir names it
        t0 = time.perf_counter()
        try:
            out = subprocess.run(
                [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                 "--c8-planted", tmp], capture_output=True, text=True,
                timeout=300, env=env, cwd=ROOT)
            planted = next((json.loads(ln) for ln in out.stdout.splitlines()
                            if ln.startswith('{"phase": "c8_planted"')),
                           {"ok": None, "rc": out.returncode,
                            "tail": (out.stdout + out.stderr)[-800:]})
        except subprocess.TimeoutExpired:
            planted = {"ok": False, "timed_out": True}
        planted["seconds"] = time.perf_counter() - t0
    rows["c8_planted_global_mode"] = planted
    checks["c8_planted_fault_fails"] = planted.get("ok") is False
    emit({"phase": "c8_planted_fault", "card": card, **planted})
    with tempfile.TemporaryDirectory() as tmp:
        rows["sensors"], sc = sensors_check(np_params, manifest, tmp)
    checks.update(sc)
    with tempfile.TemporaryDirectory() as tmp:
        rows["process_pair"], pc = process_capture_check(tmp)
    checks.update(pc)
    rows["monitor"] = monitor_check(np_params, manifest)
    checks.update(rows["monitor"].pop("checks"))
    decode_steps = (sum(c8["decode_steps"].values())
                    + sum(rows["sensors"].get("decode_steps", {}).values())
                    + rows["monitor"]["decode_steps"])
    launches, combines = pac.launches, pac.combine_launches
    checks["launches_counted"] = (
        decode_steps > 0 and launches == combines == n_layers * decode_steps)
    ok = all(checks.values())
    out = {"phase": "serve_fleet_obs", "dtype": "bfloat16", "card": card,
           "serve_phase_tok_per_s": serve_row["tok_per_s"],
           "kernel_launches": launches, "combine_launches": combines,
           "in_process_decode_steps": decode_steps,
           "seconds": time.perf_counter() - t_phase,
           **rows, "checks": checks, "ok": ok}
    emit(out)
    if not ok:
        raise SystemExit("serve_fleet_obs failed its checks: "
                         + ", ".join(k for k, v in checks.items() if not v))
    return out


# -- the fleet's control plane (serve_fleet_control) -------------------------
# tools/fleet_bench.py --autoscale-spec's setting, as AUTOSCALE_BENCH.json
# records it
CONTROL_SPEC = "both=2:4;up_queue=1.5;down_idle_s=4;cooldown_s=2"
# the phase's checkpoints: the serve config's draw at std 0.05.  At
# gpt_params' 0.02 every greedy stream repeats its prompt's last token
# whatever the seed, so no canary could tell two checkpoints apart; at
# 0.05 the tokens depend on the weights
CONTROL_WEIGHT_STD = 0.05
CONTROL_BURST = 32             # requests of the burst, 32 new tokens each
CONTROL_BURST_STEP = 24        # arriving at once; the rest once the
#                                scaled-up replica is READY
CONTROL_SCRAPE_S = 0.3         # the collectors' scrape period
CONTROL_EVAL_S = 0.05          # the autoscalers' policy period
# memory_allocated() after the scaled-up replica retired and was collected
# against before the scale-up: 16 MiB, plus the one cuBLAS workspace
# (32 MiB on sm_90) torch keeps for the engine's capture thread and
# stream, which a later thread given the same cuBLAS handle reuses.  The
# engine alone holds its bf16 weights (~146 MB) and cache (~25 MB)
CONTROL_MEM_SLACK = (16 + 32) << 20
CONTROL_STREAM = 8             # concurrent clients of the deploy arm
CONTROL_HOP_S = 30.0           # the phase's routers' per-hop timeout
CONTROL_WATCHDOG_S = 200.0     # every thread's stack to stderr past this
CONTROL_IDLE_S = 2.0           # the stream's window without a rollout
CATALOG_SPEC = "both=1:2"
CATALOG_RANK = 8
CATALOG_ALPHA = 16.0
CATALOG_BURST = 24             # a1 requests at once, 16 new tokens each
CATALOG_MODEL = "gpt-serve"


class _Ledger:
    """Every engine the phase ran: its captures after warm-up and, once
    it retired, its decode steps and its captures in traffic.  Holds
    engines by weak reference only, so a retired one can be collected."""

    def __init__(self):
        self.rows = {}
        self._lock = threading.Lock()

    def add(self, name, eng, spawn_s=None):
        import weakref

        with self._lock:
            self.rows[name] = {"ready_t": time.monotonic(),
                               "spawn_s": spawn_s,
                               "warm_captures": eng.captures,
                               "engine": weakref.ref(eng)}

    def retire(self, name, eng):
        with self._lock:
            row = self.rows[name]
            if "decode_steps" not in row:
                row["decode_steps"] = eng.decode_steps
                row["captures_in_traffic"] = (eng.captures
                                              - row["warm_captures"])

    def close(self):
        """Retire every engine still alive; the table without the
        references."""
        for name, row in list(self.rows.items()):
            eng = row["engine"]()
            if eng is not None:
                self.retire(name, eng)
        return {name: {k: v for k, v in row.items() if k != "engine"}
                for name, row in self.rows.items()}


class _CtlHandle:
    """A supervisor handle over an in-process replica; retiring it
    records its engine in the ledger."""

    def __init__(self, rep, ledger):
        self.replica, self.url, self.ledger = rep, rep.url, ledger

    def poll(self):
        return None if self.replica.state != "dead" else 1

    def terminate(self, grace_s=None):
        self.replica.stop()
        self.ledger.retire(self.replica.replica_id, self.replica.engine)


def _control_engine(params, manifest, dtype=torch.bfloat16, before=None,
                    **kw):
    """The serve config's engine in ``dtype`` warmed from ``manifest``
    (entries of another engine's digest are skipped) and the full bucket
    grid; ``before(eng)`` runs ahead of the warm-up."""
    eng = full_width_engine(params, dtype, **kw)
    if before is not None:
        before(eng)
    eng.warmup(manifest)
    eng.warmup()
    torch.cuda.synchronize()
    if eng.paged_impl != "cuda":
        raise SystemExit(f"engine resolved paged_impl={eng.paged_impl}")
    return eng


def _control_spawn(params, manifest, ledger, version, tag, dtype=None,
                   before=None, replica_kw=None, **kw):
    """``spawn(slot)`` for a Supervisor: a warmed replica of the serve
    config, tagged ``version``, its engine in the ledger."""
    import itertools

    from mxnet_tpu_torch.fleet import ReplicaServer

    gen = itertools.count(1)

    def spawn(slot):
        t0 = time.perf_counter()
        eng = _control_engine(params, manifest, dtype or torch.bfloat16,
                              before=(lambda e: before(slot, e))
                              if before else None, **kw)
        rid = f"{tag}-{version}-s{slot}-{next(gen)}"
        rep = ReplicaServer(eng, replica_id=rid, version=version,
                            **(replica_kw or {})).start()
        ledger.add(rid, eng, time.perf_counter() - t0)
        return _CtlHandle(rep, ledger)

    return spawn


def _progress(step, **fields):
    """One line a step of the phase, flushed: where a slow or stuck run
    got to."""
    print(json.dumps({"phase": "serve_fleet_control_progress",
                      "step": step, "t": round(time.perf_counter(), 3),
                      **fields}), flush=True)


def _wait(pred, timeout, poll=0.005):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            return False
        time.sleep(poll)
    return True


def _serving(sup):
    """Replicas of the pool that are up (a slot being spawned has no
    handle yet)."""
    return sum(1 for h in sup.handles()
               if h is not None and h.replica.state == "ready")


def _queued(sup):
    """Requests waiting in the pool's engines' queues (host state)."""
    return sum(h.replica.engine.scheduler.queue_depth
               for h in sup.handles() if h is not None)


def _counter_rows(name):
    from mxnet_tpu_torch import telemetry

    snap = telemetry.registry().snapshot().get(name) or {}
    return [{"labels": s["labels"], "value": s["value"]}
            for s in snap.get("samples", ())]


def _counter_delta(name, before):
    """``{label values: increase}`` of counter ``name`` since the rows
    ``before`` (:func:`_counter_rows`), the unmoved series left out."""
    def by_labels(rows):
        return {tuple(r["labels"].values()): r["value"] for r in rows}

    was = by_labels(before)
    return {k: v - was.get(k, 0.0)
            for k, v in by_labels(_counter_rows(name)).items()
            if v != was.get(k, 0.0)}


class _Stream:
    """``n`` closed-loop clients through ``router``: each sends a fresh
    prompt (16-128 tokens, ``max_new`` new) as soon as its previous one
    returned, until stopped; each completion's time and tokens, each
    client-visible failure."""

    def __init__(self, router, n, seed, max_new=16):
        self.router, self.n, self.max_new = router, n, max_new
        self.seed = seed
        self.done, self.failures, self.slow = [], [], []
        self._stop = threading.Event()
        self._threads = []

    def _client(self, k):
        rng = np.random.RandomState(self.seed * 100 + k)
        i = 0
        while not self._stop.is_set():
            p = rng.randint(0, SERVE_CFG["vocab"],
                            (int(rng.randint(16, 129)),))
            t0 = time.monotonic()
            try:
                r = self.router.generate(p.tolist(),
                                         max_new_tokens=self.max_new,
                                         request_id=f"s{self.seed}-{k}-{i}")
                now = time.monotonic()
                self.done.append((now, len(r.tokens)))
                if now - t0 > 5.0:        # a stall: where it waited
                    self.slow.append({"s": now - t0, "at": t0,
                                      "attempts": r.attempts,
                                      "hops": r.hops})
            except Exception as e:   # a client-visible failure: judged
                self.failures.append(repr(e)[:300])
            i += 1

    def start(self):
        self._threads = [threading.Thread(target=self._client, args=(k,),
                                          daemon=True)
                         for k in range(self.n)]
        for t in self._threads:
            t.start()
        return self

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=CONTROL_HOP_S * 5 + 30)

    def tok_per_s(self, a, b):
        toks = sum(n for t, n in list(self.done) if a <= t <= b)
        return toks / (b - a) if b > a else None


def control_autoscale(np_params, manifest, ledger):
    """The autoscale arm: a pool of 2 under ``CONTROL_SPEC``, the
    burst's first ``CONTROL_BURST_STEP`` requests at once (the collector
    scrapes once the replicas queue them), the rest once the scaled-up
    replica is READY; then quiet until the pool is back at 2.  Tokens
    against one warmed engine serving every prompt; the retired replica
    collected and its memory released."""
    import gc

    from mxnet_tpu_torch.fleet import (Autoscaler, FleetCollector, Router,
                                       Supervisor)

    checks, row = {}, {}
    rng = np.random.RandomState(21)
    prompts = [rng.randint(0, SERVE_CFG["vocab"], (int(n),)).astype(np.int32)
               for n in rng.randint(16, 129, CONTROL_BURST)]
    ref = _control_engine(np_params, manifest)
    ledger.add("autoscale-reference", ref)
    reqs = [ref.submit(p, max_new_tokens=32) for p in prompts]
    ref.run()
    want = [r.tokens for r in reqs]
    del reqs
    _progress("autoscale_reference_served")
    router = Router([], scrape_interval_s=0.2, timeout_s=CONTROL_HOP_S,
                    retries=4, backoff_s=0.02, backoff_max_s=0.2,
                    breaker_fails=10)
    col = FleetCollector(router=router, interval_s=CONTROL_SCRAPE_S,
                         slo_spec="")
    sup = Supervisor(_control_spawn(np_params, manifest, ledger, "v1",
                                    "auto"), 2, router=router,
                     collector=col, restart_backoff_s=0.0,
                     drain_timeout_s=120)
    scaler = Autoscaler(col, sup, spec=CONTROL_SPEC,
                        interval_s=CONTROL_EVAL_S)
    results, fails, done_t = {}, {}, {}
    sizes = []
    try:
        sup.start()
        _progress("autoscale_pool_started")
        router.scrape()
        router.start()
        col.scrape()
        col.start()
        gc.collect()
        torch.cuda.synchronize()
        mem_before = torch.cuda.memory_allocated()
        scaler.start()
        stop_mon = threading.Event()

        def monitor():
            while not stop_mon.wait(0.02):
                sizes.append((time.monotonic(), _serving(sup)))

        mon = threading.Thread(target=monitor, daemon=True)
        mon.start()

        def one(i):
            try:
                results[i] = router.generate(prompts[i].tolist(),
                                             max_new_tokens=32,
                                             request_id=f"burst-{i}")
                done_t[i] = time.monotonic()
            except Exception as e:   # a client-visible failure: judged
                fails[i] = repr(e)[:300]

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(CONTROL_BURST_STEP)]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        need = scaler.cfg["up_queue"] * 2
        queued = _wait(lambda: _queued(sup) >= need, 10.0, poll=0.001)
        queued_t = time.monotonic()
        # forced by this script: the burst's queue can end within one
        # scrape period, unseen by the autoscaler (the reaction times
        # below include this scrape, not the collector's period)
        col.scrape()
        _progress("autoscale_queue", seen=queued, queued=_queued(sup))
        grew = _wait(lambda: _serving(sup) > 2, 60.0)
        _progress("autoscale_grew", grew=grew, serving=_serving(sup))
        fresh_ids = [h.replica.replica_id for h in sup.handles()[2:]
                     if h is not None]
        router.scrape()
        rest = [threading.Thread(target=one, args=(i,))
                for i in range(CONTROL_BURST_STEP, CONTROL_BURST)]
        for t in rest:
            t.start()
            time.sleep(0.1)
        for t in threads + rest:
            t.join(timeout=CONTROL_HOP_S * 5 + 30)
        _progress("autoscale_burst_done", completed=len(results),
                  failures=len(fails))
        t_end = max(done_t.values(), default=t0)
        settled = _wait(lambda: sup.pool_size() == 2
                        and time.monotonic() - t_end > 4.0, 60.0)
        stop_mon.set()
        mon.join(timeout=5)
        scaler.stop()
        _progress("autoscale_settled", settled=settled,
                  serving=_serving(sup))
        fresh = {rid: ledger.rows[rid] for rid in fresh_ids}
        gone = all(r["engine"]() is None for r in fresh.values())
        t_gc = time.monotonic()
        while not gone and time.monotonic() < t_gc + 30:
            gc.collect()
            time.sleep(0.1)     # its HTTP and step threads end
            gone = all(r["engine"]() is None for r in fresh.values())
        torch.cuda.synchronize()
        mem_after = torch.cuda.memory_allocated()
        anns = col.annotations(500)
    finally:
        scaler.stop()
        col.stop()
        router.stop()
        sup.stop()
    got = [results[i].tokens if i in results else None
           for i in range(CONTROL_BURST)]
    ups = [a for a in anns if a["kind"] == "autoscale"
           and a["direction"] == "up"]
    downs = [a for a in anns if a["kind"] == "autoscale"
             and a["direction"] == "down"]
    fresh_served = sorted(done_t[i] for i, r in results.items()
                          if r.replica in fresh_ids)
    peak = max((n for _, n in sizes), default=0)
    checks["autoscale_scaled_up"] = grew and peak >= 3 and bool(ups)
    checks["autoscale_scaled_down"] = (settled and bool(downs)
                                       and sup.pool_size() == 2)
    checks["autoscale_completed"] = (not fails
                                     and len(results) == CONTROL_BURST)
    checks["autoscale_tokens"] = got == want
    checks["autoscale_fresh_served"] = bool(fresh_served)
    checks["autoscale_retired_collected"] = gone
    checks["autoscale_memory_released"] = (
        mem_after - mem_before <= CONTROL_MEM_SLACK)
    tokens = sum(len(t) for t in got if t)
    step_done = [done_t[i] for i in range(CONTROL_BURST_STEP) if i in done_t]
    row.update({
        "spec": CONTROL_SPEC, "requests": CONTROL_BURST,
        "arriving_at_once": CONTROL_BURST_STEP,
        "queue_seen": queued, "queue_seen_s": queued_t - t0,
        "reaction_s": {
            "scale_up_spawn_began": (min(r["ready_t"] - r["spawn_s"]
                                         for r in fresh.values()) - t0
                                     if fresh else None),
            "autoscale_annotation": (ups[0]["t"] - t0) if ups else None,
            "fresh_ready": (min(r["ready_t"] for r in fresh.values()) - t0
                            if fresh else None),
            "fresh_first_served": (fresh_served[0] - t0
                                   if fresh_served else None)},
        "fresh_spawn_s": [r["spawn_s"] for r in fresh.values()],
        "fresh_requests_served": len(fresh_served),
        "peak_replicas": peak, "settled_replicas": sup.pool_size(),
        "scale_down_s_after_last_request": (
            downs[0]["t"] - t_end if downs else None),
        "burst_tok_per_s": tokens / (t_end - t0) if t_end > t0 else None,
        "step_tok_per_s": (sum(len(got[i]) for i in range(CONTROL_BURST_STEP)
                               if got[i]) / (max(step_done) - t0)
                           if step_done else None),
        "failures": fails,
        "flips": flips(ref, prompts, want, [t or [] for t in got]),
        "memory_allocated_before_scale_up": mem_before,
        "memory_allocated_after_retire": mem_after,
        "memory_bound_bytes": CONTROL_MEM_SLACK,
        "annotations": [{k: a.get(k) for k in ("kind", "direction",
                                               "reason", "slot",
                                               "pool_size", "phase")}
                        for a in anns if a["kind"].startswith(
                            ("autoscale", "scale_"))]})
    ref.shutdown()
    ledger.retire("autoscale-reference", ref)
    del ref
    return row, checks


def _fleetz_versions(col):
    col.scrape()
    view = _http(col.url, "/fleetz.json", timeout=30)
    return (view.get("roles") or {}).get("both", {}).get("versions")


def _rollout_walls(anns):
    """Each replacement's drain-to-ready seconds in the order they ran,
    split at the rollback's start: (rollout slots, rollback slots)."""
    out, back, rolling_back = [], [], False
    for a in anns:
        if a["kind"] == "deploy_rollback" and a.get("phase") == "start":
            rolling_back = True
        elif (a["kind"] == "deploy_replace_slot"
              and a.get("phase") == "respawned"):
            (back if rolling_back else out).append(a["wall_s"])
    return out, back


def control_deploy(np_params, manifest, ledger, dtype, v3=True):
    """The deploy arm in ``dtype``: a pool of 2 (``v1``) under a stream
    of ``CONTROL_STREAM`` clients; rollout ``v2`` (the same weights,
    re-exported through the host) must end ``ok`` with every slot ``v2``
    in ``/fleetz.json``; with ``v3``, weights from another seed must
    roll back on ``parity``, every slot back on ``v2`` and serving the
    canary signatures it served before; no client-visible failure."""
    from mxnet_tpu_torch.fleet import (Deployer, FleetCollector, Router,
                                       Supervisor)

    tag = {torch.bfloat16: "bf16", torch.float32: "f32"}[dtype]
    checks, row = {}, {}
    params_v2 = {k: torch.from_numpy(v.detach().cpu().numpy()).to(DEVICE)
                 for k, v in np_params.items()}
    spawn_v1 = _control_spawn(np_params, manifest, ledger, "v1", tag,
                              dtype=dtype)
    spawn_v2 = _control_spawn(params_v2, manifest, ledger, "v2", tag,
                              dtype=dtype)
    router = Router([], scrape_interval_s=0.2, timeout_s=CONTROL_HOP_S,
                    retries=4, backoff_s=0.02, backoff_max_s=0.2,
                    breaker_fails=10)
    col = FleetCollector(router=router, interval_s=CONTROL_SCRAPE_S, port=0,
                         slo_spec="")
    sup = Supervisor(spawn_v1, 2, router=router, collector=col,
                     restart_backoff_s=0.0, drain_timeout_s=120)
    dep = Deployer(sup, collector=col)
    stream = _Stream(router, CONTROL_STREAM, seed=31 if v3 else 32)
    params_v3 = None
    try:
        sup.start()
        router.scrape()
        router.start()
        col.start()
        stream.start()
        t_idle = time.monotonic()
        time.sleep(CONTROL_IDLE_S)
        t2 = time.monotonic()
        row["t_v2_start"] = t2
        _progress(f"deploy_{tag}_v2_start")
        report2 = dep.rollout(spawn_v2, version="v2", old_factory=spawn_v1)
        t2_end = time.monotonic()
        row["t_v2_done"] = t2_end
        _progress(f"deploy_{tag}_v2_done", status=report2["status"],
                  reason=report2["reason"])
        versions2 = _fleetz_versions(col)
        anns2 = col.annotations(500)
        row["v2"] = {k: report2[k] for k in ("status", "reason", "replaced",
                                             "rolled_back", "refs")}
        row["v2"].update(wall_s=t2_end - t2, versions=versions2,
                         slot_wall_s=_rollout_walls(anns2)[0])
        checks[f"deploy_{tag}_v2_ok"] = (report2["status"] == "ok"
                                         and report2["replaced"] == 2)
        checks[f"deploy_{tag}_v2_versions"] = versions2 == {"v2": 2}
        row["stream_tok_per_s_idle"] = stream.tok_per_s(t_idle, t2)
        row["stream_tok_per_s_rollout_v2"] = stream.tok_per_s(t2, t2_end)
        if v3:
            before = {s: dep.probe(sup.handles()[s].url, "both")
                      for s in sup.active_slots()}
            params_v3 = serve_params(1, std=CONTROL_WEIGHT_STD)
            spawn_v3 = _control_spawn(params_v3, manifest, ledger, "v3",
                                      tag, dtype=dtype)
            n_anns = len(col.annotations(500))
            t3 = time.monotonic()
            report3 = dep.rollout(spawn_v3, version="v3",
                                  old_factory=spawn_v2)
            t3_end = time.monotonic()
            _progress(f"deploy_{tag}_v3_done", status=report3["status"],
                      reason=report3["reason"])
            versions3 = _fleetz_versions(col)
            after = {s: dep.probe(sup.handles()[s].url, "both")
                     for s in sup.active_slots()}
            out3, back3 = _rollout_walls(col.annotations(500)[n_anns:])
            row["v3"] = {k: report3[k] for k in (
                "status", "reason", "replaced", "rolled_back", "refs")}
            row["v3"].update(wall_s=t3_end - t3, versions=versions3,
                             slot_wall_s=out3, rollback_slot_wall_s=back3,
                             rollback_wall_s=sum(back3))
            row["stream_tok_per_s_rollout_v3"] = stream.tok_per_s(t3,
                                                                  t3_end)
            checks[f"deploy_{tag}_v3_rolled_back_on_parity"] = (
                report3["status"] == "rolled_back"
                and report3["reason"] == "parity"
                and report3["rolled_back"] == report3["replaced"] >= 1)
            checks[f"deploy_{tag}_v3_back_on_v2"] = versions3 == {"v2": 2}
            checks[f"deploy_{tag}_v3_tokens_unchanged"] = (
                after == before and len(after) == 2)
            row["canary_signatures"] = {str(s): [list(t) for t in sig]
                                        for s, sig in before.items()}
        stream.stop()
        _progress(f"deploy_{tag}_stream_stopped")
        row["stream_requests"] = len(stream.done)
        row["stream_slow_requests"] = stream.slow[:10]
        row["stream_failures"] = stream.failures[:10]
        checks[f"deploy_{tag}_no_client_failure"] = (
            not stream.failures and len(stream.done) > 0)
        row["counters"] = {
            name: _counter_rows(name) for name in (
                "mxtpu_deploy_slots_replaced_total",
                "mxtpu_deploy_rollbacks_total")}
    finally:
        stream.stop()
        col.stop()
        router.stop()
        sup.stop()
    _progress(f"deploy_{tag}_stopped")
    del params_v2, params_v3
    return row, checks


def control_catalog(np_params, manifest, ledger):
    """The catalog arm: an adapters pool (rank ``CATALOG_RANK``) under
    ``CATALOG_SPEC``, adapter ``a1`` on slot 0 only; a burst of a1
    requests queues there and scales the pool up; the autoscaler's
    ``rebalance_catalog`` pass (the supervisor's, over an unmodified
    ``CatalogRebalancer``) moves a1 onto the fresh slot, which then
    serves a1 with slot 0's tokens (one request at a time to each)."""
    from mxnet_tpu_torch.fleet import (Autoscaler, CatalogRebalancer,
                                       FleetCollector, Router, Supervisor)
    from mxnet_tpu_torch.serve.adapters import gpt_stems

    checks, row = {}, {}
    stems = gpt_stems("gpt", SERVE_CFG["num_layers"], True, True, np_params)
    rng = np.random.RandomState(41)
    a1 = {stem: ((rng.randn(CATALOG_RANK, din) * 0.1).astype(np.float32),
                 (rng.randn(dout, CATALOG_RANK) * 0.1).astype(np.float32))
          for stem, (dout, din) in stems.items()}

    def before(slot, eng):
        if slot == 0:
            eng.adapter_store.register("a1", a1, alpha=CATALOG_ALPHA)

    router = Router([], scrape_interval_s=0.2, timeout_s=CONTROL_HOP_S,
                    retries=4, backoff_s=0.02, backoff_max_s=0.2,
                    breaker_fails=10)
    col = FleetCollector(router=router, interval_s=CONTROL_SCRAPE_S,
                         slo_spec="")
    moves_before = _counter_rows("mxtpu_fleet_catalog_moves_total")
    sup = Supervisor(_control_spawn(
        np_params, manifest, ledger, "v1", "cat", before=before,
        replica_kw={"model": CATALOG_MODEL}, adapters=4,
        adapter_rank=CATALOG_RANK), 1, router=router, collector=col,
        catalog=CatalogRebalancer(col), restart_backoff_s=0.0,
        drain_timeout_s=120)
    scaler = Autoscaler(col, sup, spec=CATALOG_SPEC,
                        interval_s=CONTROL_EVAL_S)
    rng = np.random.RandomState(42)
    prompts = [rng.randint(0, SERVE_CFG["vocab"], (int(n),))
               for n in rng.randint(16, 129, CATALOG_BURST)]
    results, fails = {}, {}

    def one(i):
        try:
            results[i] = router.generate(
                prompts[i].tolist(), max_new_tokens=16, model=CATALOG_MODEL,
                adapter="a1", request_id=f"a1-{i}")
        except Exception as e:   # a client-visible failure: judged
            fails[i] = repr(e)[:300]

    try:
        sup.start()
        router.scrape()
        router.start()
        # a1 in use before the burst: its goodput is on the collector's
        # view whenever the scale-up's pass plans
        router.generate(prompts[0].tolist(), max_new_tokens=16,
                        model=CATALOG_MODEL, adapter="a1",
                        request_id="a1-first")
        col.scrape()
        col.start()
        scaler.start()
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(CATALOG_BURST)]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        need = scaler.cfg["up_queue"]
        queued = _wait(lambda: _queued(sup) >= need, 10.0, poll=0.001)
        # forced by this script: the burst's queue can end within one
        # scrape period, unseen by the autoscaler
        col.scrape()
        _progress("catalog_queue", seen=queued, queued=_queued(sup))
        moved = _wait(lambda: any(
            a["kind"] == "catalog_rebalance"
            and a.get("reason") == "scale_up_both"
            for a in col.annotations(500)), 60.0)
        t_moved = time.monotonic()
        _progress("catalog_moved", moved=moved)
        for t in threads:
            t.join(timeout=CONTROL_HOP_S * 5 + 30)
        scaler.stop()
        handles = [h for h in sup.handles() if h is not None]
        slot0 = handles[0]
        fresh = handles[1] if len(handles) > 1 else None
        fresh_ads = (_http(fresh.url, "/healthz")["adapters"]
                     if fresh is not None else None)
        probe = np.random.RandomState(43).randint(
            0, SERVE_CFG["vocab"], (40,)).tolist()
        toks = {}
        for name, h in (("slot0", slot0), ("fresh", fresh)):
            if h is not None and (name == "slot0" or fresh_ads == ["a1"]):
                toks[name] = _http(h.url, "/generate", {
                    "prompt": probe, "max_new_tokens": 32, "adapter": "a1",
                    "model": CATALOG_MODEL})["tokens"]
        base = _http(slot0.url, "/generate", {
            "prompt": probe, "max_new_tokens": 32})["tokens"]
        t_export = time.perf_counter()
        export = json.dumps(_http(slot0.url, "/adapter_export",
                                  {"adapter": "a1"})).encode()
        export_ms = 1e3 * (time.perf_counter() - t_export)
        anns = col.annotations(500)
    finally:
        scaler.stop()
        col.stop()
        router.stop()
        sup.stop()
    moves = _counter_delta("mxtpu_fleet_catalog_moves_total", moves_before)
    ups = [a for a in anns if a["kind"] == "autoscale"
           and a.get("direction") == "up"]
    passes = [a for a in anns if a["kind"] == "catalog_rebalance"
              and a.get("reason") == "scale_up_both"]
    checks["catalog_scaled_up"] = moved and fresh is not None
    # only the autoscaler's passes load adapters in this arm
    checks["catalog_moved_by_autoscaler"] = (
        fresh_ads == ["a1"] and bool(passes)
        and passes[0].get("applied") == passes[0].get("ok") == 1
        and moves == {("spread", "ok"): 1.0})
    checks["catalog_tokens"] = ("fresh" in toks
                                and toks["fresh"] == toks["slot0"])
    checks["catalog_adapter_moves_tokens"] = base != toks["slot0"]
    checks["catalog_burst_completed"] = (not fails
                                         and len(results) == CATALOG_BURST)
    row.update({
        "spec": CATALOG_SPEC, "rank": CATALOG_RANK, "requests":
        CATALOG_BURST, "queue_seen": queued,
        "moved_s_after_burst_start": t_moved - t0,
        "moves_by_action_outcome": {"/".join(k): v
                                    for k, v in moves.items()},
        # the scale-up's catalog pass, its autoscale annotation to its
        # catalog_rebalance one: the supervisor's scrape, the plan and
        # the export -> load move
        "scale_up_pass_ms": (1e3 * (passes[0]["t"] - ups[0]["t"])
                             if passes and ups else None),
        "export_ms": export_ms, "move_wire_bytes": len(export),
        "fresh_adapters": fresh_ads, "failures": fails,
        "annotations": [{k: a.get(k) for k in (
            "kind", "reason", "applied", "ok", "direction")}
            for a in anns if a["kind"].startswith(
                ("catalog", "autoscale"))]})
    return row, checks


def _cache_env(cache_dir):
    env = dict(os.environ, PYTHONPATH=ROOT, MXTPU_COMPILE_CACHE=cache_dir)
    for var in ("MXTPU_TORCH_BUILD_DIR", "MXTPU_COMPILE_CACHE_MAX_BYTES",
                "MXTPU_COMPILE_CACHE_MAX_ENTRIES",
                "MXTPU_COMPILE_CACHE_MIN_COMPILE_SECS", "MXTPU_TELEMETRY"):
        env.pop(var, None)
    return env


def _cache_child_start(cache_dir, stage):
    return subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
         "--cache-child", str(stage)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=_cache_env(cache_dir),
        cwd=ROOT)


def _cache_child_row(proc, timeout=600):
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    row = next((json.loads(ln) for ln in out.splitlines()
                if ln.startswith('{"phase": "cache_child"')), None)
    return row or {"rc": proc.returncode, "tail": (out + err)[-800:]}


def cache_child(stage):
    """``--cache-child STAGE``: with ``MXTPU_COMPILE_CACHE`` set (and
    honoured at import), build or load the paged library through the
    managed cache, telemetry on; stage 2 also runs one paged decode call
    against its plain version.  Prints one JSON line."""
    from mxnet_tpu_torch import _build, telemetry
    from mxnet_tpu_torch.aot import cache
    from mxnet_tpu_torch.ops import paged_attention_cuda as pac

    telemetry.enable()
    mgr = cache.active()
    t0 = time.perf_counter()
    pac._fns()
    load_s = time.perf_counter() - t0
    sz = mgr.statusz() if mgr is not None else {}
    row = {"phase": "cache_child", "stage": stage,
           "build_dir": _build.build_dir(),
           "namespace": getattr(mgr, "namespace", None),
           "load_s": load_s,
           "nvcc_s": _build.BUILD_SECONDS.get(pac.LIB_NAME),
           "libraries": [os.path.basename(p) for p, _, _ in mgr._entries()]
           if mgr is not None else [],
           **{k: sz.get(k) for k in ("hits", "misses", "puts", "entries",
                                     "bytes", "dir")}}
    if stage == 2:
        args, kw = paged_case([1, 17, 48, 100, 160, 0, 1, 33], "bfloat16",
                              W=16, nb=512, padded=(6,))
        out = pac.paged_attention_cuda(*args, **kw)
        torch.cuda.synchronize()
        within, fields = paged_bound_row(out, args, kw, "bfloat16")
        row.update(paged_within=within, launches=pac.launches, **fields)
    print(json.dumps(row), flush=True)
    return 0


def control_compile_cache(tmp, child1):
    """The compile-cache arm over ``tmp``/cache: child 1 (started by the
    caller) built the paged library there, a miss and a put; the library
    is dated an hour back and a copy under another name half an hour
    back; child 2 loads it (a hit, no miss) and runs one paged decode
    call; a namespace dated 15 days back and a fresh one are planted;
    ``prune`` with ``max_entries=1`` keeps the library used last (the
    paged one, built first) and drops the stale namespace."""
    import shutil

    from mxnet_tpu_torch.aot import cache

    checks = {}
    cache_dir = os.path.join(tmp, "cache")
    first = _cache_child_row(child1)
    _progress("cache_child_1", row=first)
    mgr = cache.CompileCacheManager(cache_dir, max_entries=1)
    libs = [p for p, _, _ in mgr._entries()]
    now = time.time()
    probe = None
    if len(libs) == 1:
        os.utime(libs[0], (now - 3600, now - 3600))
        probe = os.path.join(mgr.dir, "libmxtt_cache_probe-000000000000.so")
        shutil.copyfile(libs[0], probe)
        os.utime(probe, (now - 1800, now - 1800))
    second = _cache_child_row(_cache_child_start(cache_dir, 2))
    stale = os.path.join(cache_dir, "nvcc-11.0-sm_90a")
    sibling = os.path.join(cache_dir, "nvcc-99.0-sm_90a")
    for d, stamp in ((stale, now - 15 * 86400), (sibling, now)):
        os.makedirs(d, exist_ok=True)
        lib = os.path.join(d, "libmxtt_old-000000000000.so")
        with open(lib, "wb") as f:
            f.write(b"\0" * 64)
        os.utime(lib, (stamp, stamp))
        os.utime(d, (stamp, stamp))
    removed = mgr.prune()
    left = [os.path.basename(p) for p, _, _ in mgr._entries()]
    checks["cache_miss_then_put"] = (
        first.get("dir") == mgr.dir and first.get("misses") == 1.0
        and first.get("puts") == 1.0 and first.get("hits") == 0.0
        and first.get("entries") == 1 and first.get("nvcc_s") is not None)
    checks["cache_hit_no_miss"] = (
        second.get("hits") == 1.0 and second.get("misses") == 0.0
        and second.get("puts") == 0.0 and second.get("nvcc_s") is None
        and second.get("paged_within") is True)
    checks["cache_stale_namespace_pruned"] = (not os.path.exists(stale)
                                              and os.path.isdir(sibling))
    checks["cache_used_last_survives"] = (
        probe is not None and left == [os.path.basename(libs[0])]
        and not os.path.exists(probe))
    row = {"namespace": mgr.namespace, "miss": first, "hit": second,
           "miss_build_s": first.get("load_s"),
           "miss_nvcc_s": first.get("nvcc_s"),
           "hit_load_s": second.get("load_s"),
           "pruned_files": removed, "left": left}
    return row, checks


def serve_fleet_control(serve_row, manifest, card):
    """The fleet's control plane on the card (ROADMAP A14b-3) and the
    compile cache (A12), at the serve config's full width, every replica
    an in-process ``ReplicaServer`` on an engine warmed from the serve
    phase's ``manifest`` and the grid before it takes traffic, a
    ``FleetCollector`` scraping every ``CONTROL_SCRAPE_S``, a ``Router``
    and a ``Supervisor`` whose spawn builds such a replica:

    1. autoscale (``control_autoscale``): scale up on the burst's queue
       and back down after the idle window, no client-visible failure,
       each request's tokens one warmed engine's, the scaled-up replica
       capturing nothing in traffic, collected when it retired, its
       memory released;
    2. deploy (``control_deploy``), bf16: ``v2`` (re-exported weights)
       ``ok`` under a stream of 8 clients, ``v3`` (another seed) rolled
       back on ``parity`` with the canary tokens unchanged; a float32
       control arm's ``v2`` rollout (tells a bf16 batching flip of the
       canary from a fault);
    3. catalog (``control_catalog``): ``a1`` moved by the autoscaler's
       rebalance pass onto the scaled-up slot, served with slot 0's
       tokens;
    4. compile cache (``control_compile_cache``): two child processes
       with ``MXTPU_COMPILE_CACHE`` (miss and put, then hit and a paged
       call), pruning and eviction by access.

    The weights: the serve phase's seed at ``CONTROL_WEIGHT_STD``.  The
    paged counters are zeroed before the phase and read after it:
    every replica's and reference engine's decode steps x layers."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.ops import paged_attention_cuda as pac

    import faulthandler

    t_phase = time.perf_counter()
    faulthandler.dump_traceback_later(CONTROL_WATCHDOG_S, repeat=True)
    n_layers = SERVE_CFG["num_layers"]
    checks, rows, seconds = {}, {}, {}
    was_on = telemetry.enabled()
    telemetry.reset()
    telemetry.enable()
    ledger = _Ledger()
    np_params = serve_params(0, std=CONTROL_WEIGHT_STD)
    with tempfile.TemporaryDirectory() as tmp:
        old = _set_env({"MXTPU_FLIGHT_DIR": os.path.join(tmp, "flight")})
        child1 = _cache_child_start(os.path.join(tmp, "cache"), 1)
        try:
            pac.launches = pac.combine_launches = 0   # the window opens
            for name, arm in (
                    ("autoscale", lambda: control_autoscale(
                        np_params, manifest, ledger)),
                    ("deploy_bf16", lambda: control_deploy(
                        np_params, manifest, ledger, torch.bfloat16)),
                    ("deploy_f32_control", lambda: control_deploy(
                        np_params, manifest, ledger, torch.float32,
                        v3=False)),
                    ("catalog", lambda: control_catalog(
                        np_params, manifest, ledger))):
                t0 = time.perf_counter()
                _progress(f"{name}_start")
                rows[name], c = arm()
                checks.update(c)
                seconds[name] = time.perf_counter() - t0
                _progress(f"{name}_done", seconds=seconds[name],
                          failed=[k for k, v in c.items() if not v])
                torch.cuda.empty_cache()
            launches, combines = pac.launches, pac.combine_launches
            t0 = time.perf_counter()
            rows["compile_cache"], c = control_compile_cache(tmp, child1)
            checks.update(c)
            seconds["compile_cache"] = time.perf_counter() - t0
            flight = os.path.join(tmp, "flight")
            rows["flight_dumps"] = sorted(
                n.split("-", 2)[-1] for n in (os.listdir(flight)
                                              if os.path.isdir(flight)
                                              else ()))
        finally:
            if child1.poll() is None:
                child1.kill()
                child1.wait()
            _set_env(old)
    faulthandler.cancel_dump_traceback_later()
    del np_params
    engines = ledger.close()
    decode_steps = sum(r.get("decode_steps", 0) for r in engines.values())
    checks["no_capture_in_traffic"] = all(
        r.get("captures_in_traffic") == 0 for r in engines.values())
    checks["launches_counted"] = (
        decode_steps > 0 and launches == combines == n_layers * decode_steps)
    rows["counters"] = {name: _counter_rows(name) for name in (
        "mxtpu_fleet_scale_events_total",
        "mxtpu_fleet_autoscaler_errors_total",
        "mxtpu_deploy_slots_replaced_total", "mxtpu_deploy_rollbacks_total",
        "mxtpu_fleet_catalog_moves_total")}
    telemetry.disable()
    telemetry.reset()
    if was_on:
        telemetry.enable()
    ok = all(checks.values())
    auto, dep = rows["autoscale"], rows["deploy_bf16"]
    emit({"phase": "serve_fleet_control_summary", "card": card,
          "reaction_s": auto["reaction_s"],
          "peak_replicas": auto["peak_replicas"],
          "settled_replicas": auto["settled_replicas"],
          "burst_tok_per_s": auto["burst_tok_per_s"],
          "v2_wall_s": dep["v2"]["wall_s"],
          "v2_slot_wall_s": dep["v2"]["slot_wall_s"],
          "v3_wall_s": dep.get("v3", {}).get("wall_s"),
          "v3_rollback_wall_s": dep.get("v3", {}).get("rollback_wall_s"),
          "stream_tok_per_s": {k: dep.get(k) for k in (
              "stream_tok_per_s_idle", "stream_tok_per_s_rollout_v2",
              "stream_tok_per_s_rollout_v3")},
          "catalog_scale_up_pass_ms": rows["catalog"]["scale_up_pass_ms"],
          "catalog_export_ms": rows["catalog"]["export_ms"],
          "catalog_move_wire_bytes": rows["catalog"]["move_wire_bytes"],
          "cache_miss_build_s": rows["compile_cache"]["miss_build_s"],
          "cache_hit_load_s": rows["compile_cache"]["hit_load_s"],
          "paged_launches": launches, "combine_launches": combines,
          "layers_x_decode_steps": n_layers * decode_steps,
          "arm_seconds": seconds})
    out = {"phase": "serve_fleet_control", "dtype": "bfloat16", "card": card,
           "serve_phase_tok_per_s": serve_row["tok_per_s"],
           "kernel_launches": launches, "combine_launches": combines,
           "decode_steps": decode_steps, "engines": engines,
           "seconds": time.perf_counter() - t_phase, "arm_seconds": seconds,
           **rows, "checks": checks, "ok": ok}
    emit(out)
    if not ok:
        raise SystemExit("serve_fleet_control failed its checks: "
                         + ", ".join(k for k, v in checks.items() if not v))
    return out


# -- serve_aot_tp: the export store and tensor-parallel serving ---------------
AOT_TP = 3                      # divides the serve config's 12 and 3 heads
AOT_TP_PROMPTS = 4              # the identity pairs' prompts (16..128)


def _aot_counts():
    """The export store's counters now: program resolutions by source
    and artifact errors by kind (telemetry on)."""
    from mxnet_tpu_torch import telemetry

    snap = telemetry.registry().snapshot()

    def by(name, label):
        out = collections.Counter()
        for s in snap.get(name, {"samples": []})["samples"]:
            out[s["labels"].get(label)] += s["value"]
        return out

    return {"programs": dict(by("mxtpu_aot_programs_total", "source")),
            "errors": dict(by("mxtpu_aot_errors_total", "kind"))}


def _count_delta(after, before, group, key):
    return (after[group].get(key, 0) - before[group].get(key, 0))


def _drive(eng, prompts, new_tokens=32):
    """Serve ``prompts`` on ``eng`` from zeroed paged counters: (tokens,
    split launches, combine launches, decode-only step ms, traffic
    captures)."""
    from mxnet_tpu_torch.ops import paged_attention_cuda as pac

    caps = eng.captures
    torch.cuda.synchronize()
    pac.launches = pac.combine_launches = 0
    reqs = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    step_ms = []
    while eng.has_work():
        decode_only = (eng.scheduler.queue_depth == 0
                       and bool(eng.scheduler.running)
                       and not eng.scheduler.prefilling)
        ts = time.perf_counter()
        eng.step()
        if decode_only:
            step_ms.append(1e3 * (time.perf_counter() - ts))
    torch.cuda.synchronize()
    toks = [list(r.tokens) for r in reqs]
    ok = all(r.status == "finished" for r in reqs)
    return {"tokens": toks, "launches": pac.launches,
            "combine_launches": pac.combine_launches,
            "decode_steps": eng.decode_steps, "step_ms": step_ms,
            "traffic_captures": eng.captures - caps, "finished": ok}


def _warm_timed(eng, manifest):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ready = eng.warmup(manifest)
    torch.cuda.synchronize()
    return ready, time.perf_counter() - t0


def _restamp(store_dir, field="num_blocks"):
    """Rewrite every artifact header under ``store_dir`` to another
    fingerprint (``field`` + 1), the program bytes kept: a stale
    store."""
    from mxnet_tpu_torch.aot import export_store

    for path, _ in export_store.ExportStore(store_dir).entries():
        with open(path, "rb") as f:
            raw = f.read()
        n = int.from_bytes(raw[8:16], "little")
        hdr = json.loads(raw[16:16 + n])
        hdr["fingerprint"][field] = hdr["fingerprint"][field] + 1
        other = json.dumps(hdr, sort_keys=True).encode()
        with open(path, "wb") as f:
            f.write(raw[:8] + len(other).to_bytes(8, "little") + other
                    + raw[16 + n:])


def aot_child(store, manifest_path, tp):
    """``--aot-child STORE``: a fresh process builds the serve config's
    bf16 engine (weights at ``CONTROL_WEIGHT_STD``) on the export store
    ``STORE`` and warms ``--aot-manifest``: every program loaded, none
    traced, each captured.  Then it serves the 8 prompts from zeroed
    counters and profiles 16 decode-only steps over the restored graphs.
    Prints one JSON line."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.ops import paged_attention_cuda as pac

    telemetry.enable()
    pac._fns()
    params = serve_params(std=CONTROL_WEIGHT_STD)
    before = _aot_counts()
    t0 = time.perf_counter()
    eng = full_width_engine(params, torch.bfloat16, aot_dir=store, tp=tp)
    build_s = time.perf_counter() - t0
    ready, warm_s = _warm_timed(eng, manifest_path)
    after = _aot_counts()
    drive = _drive(eng, serve_prompts(0))
    prof = serve_profile(eng, serve_prompts(0))
    row = {"phase": "aot_child", "tp": tp, "build_s": build_s,
           "warmup_s": warm_s, "warmup_programs": ready,
           "warmup_captures": eng.captures - drive["traffic_captures"],
           "captures_expected": captures_expected(eng, ready),
           "traces": _count_delta(after, before, "programs", "trace"),
           "artifacts": _count_delta(after, before, "programs", "artifact"),
           "errors": after["errors"], "tokens": drive["tokens"],
           "launches": drive["launches"],
           "combine_launches": drive["combine_launches"],
           "decode_steps": drive["decode_steps"],
           "traffic_captures": drive["traffic_captures"],
           "profile": {k: prof[k] for k in (
               "decode_steps", "traced_paged_kernels",
               "counted_paged_launches", "wall_ms_per_step",
               "kernel_ms_per_step")}}
    eng.shutdown()
    print(json.dumps(row), flush=True)
    return 0


def _aot_child_start(store, manifest_path, tp):
    """Start the ``--aot-child`` process; ``(process, start time)``."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("MXTPU_TELEMETRY", None)
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--aot-child",
         store, "--aot-manifest", manifest_path, "--aot-child-tp", str(tp)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT)
    return proc, time.perf_counter()


def _aot_child_row(child, timeout=600):
    """The ``--aot-child`` process's JSON line (its output's tail when it
    printed none), with its seconds from start to exit."""
    proc, t0 = child
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    row = next((json.loads(ln) for ln in out.splitlines()
                if ln.startswith('{"phase": "aot_child"')), None)
    if row is None:
        return {"rc": proc.returncode, "tail": (out + err)[-2000:]}
    row["process_s"] = time.perf_counter() - t0
    return row


def inplace_fault(params, store_dir, manifest):
    """The loaded decode program writes its caches in place (no copy of
    a cache-sized tensor in its graph); the same program decomposed
    (functionalized) copies them back, fails that check, and an engine
    finding it in the store refuses it: a counted ``inplace`` error and
    a trace."""
    from mxnet_tpu_torch.aot import export_store

    eng = full_width_engine(params, torch.bfloat16, aot_dir=store_dir)
    bucket = max(e["bucket"] for e in manifest if e["kind"] == "decode")
    fp, label = eng._aot_fp("decode", bucket), f"serve-decode{bucket}"
    store = export_store.ExportStore(store_dir)
    ep = store.load(fp, label=label)
    numel = eng._cache_k[0].numel()
    loaded = export_store.cache_copies(ep.module(), numel)
    flat = ep.run_decompositions()
    planted = export_store.cache_copies(flat.module(), numel)
    store.save(fp, flat, label=label)
    eng.shutdown()
    before = _aot_counts()
    eng = full_width_engine(params, torch.bfloat16, aot_dir=store_dir)
    eng.warmup([{"kind": "decode", "bucket": bucket}])
    after = _aot_counts()
    eng.shutdown()
    refused = (_count_delta(after, before, "errors", "inplace") == 1
               and _count_delta(after, before, "programs", "trace") == 1)
    return {"loaded_cache_copies": loaded, "planted_cache_copies":
            len(planted), "engine_refused": refused,
            "ok": loaded == [] and len(planted) > 0 and refused}


def stale_fault(params, store_dir, manifest):
    """Every artifact's header restamped to another fingerprint: the
    program the engine warms (the manifest's first decode) costs a
    counted stale error and a trace."""
    _restamp(store_dir)
    entry = next(e for e in manifest if e["kind"] == "decode")
    before = _aot_counts()
    eng = full_width_engine(params, torch.bfloat16, aot_dir=store_dir)
    ready = eng.warmup([entry])
    after = _aot_counts()
    eng.shutdown()
    stale = _count_delta(after, before, "errors", "stale")
    traces = _count_delta(after, before, "programs", "trace")
    return {"programs": ready, "stale_errors": stale, "traces": traces,
            "ok": ready == stale == traces == 1}


def host_round_trip(eng):
    """A used block fetched to the host (every shard's heads gathered),
    restored through the restore program into a free block, and fetched
    again: bit for bit, and each shard holding its heads."""
    used = next(b for b in range(1, eng.num_blocks)
                if bool(eng._cache_k[0][:, b].abs().sum() > 0))
    parts = eng._host_kv_fetch(used)
    dst = eng.num_blocks - 1
    prog = eng._program("restore", 1)
    h = prog.stage()
    h["blks"][0] = dst
    for name, a in zip(("hk", "hv", "hks", "hvs"), parts):
        torch.as_tensor(h[name][:, 0]).copy_(a)
    prog()
    torch.cuda.synchronize()
    back = eng._host_kv_fetch(dst)
    per = eng._cfg.kv_heads // eng.tp
    shards_ok = all(
        torch.equal(eng._cache_k[s][:, dst].cpu(),
                    parts[0][:, :, s * per:(s + 1) * per])
        for s in range(eng.tp))
    return {"block": used, "into": dst,
            "bit_exact": all(torch.equal(a, b) for a, b in zip(parts, back)),
            "shards_hold_their_heads": shards_ok}


def serve_aot_tp(manifest, restart_row, card):
    """The export store and tensor-parallel serving on one card, with
    weights at ``CONTROL_WEIGHT_STD`` (at 0.02 every stream repeats its
    prompt's last token): (1) a cold bf16 engine on a new store warms the
    serve phase's manifest (exporting every program), serves the 8
    prompts, and a manifest-only engine (no store) gives the same
    tokens; a fresh process, run meanwhile, restarts from the store with
    no trace, the cold tokens, and its restored graphs' paged launches
    equal to a profiler trace's instances; a stale artifact and a
    functionalized program are refused (planted).  (2) tp = 3 on this
    one card (``MXTPU_TORCH_VIRTUAL_DEVICES``): float32 and float32 +
    int8 K/V tokens equal tp=1's, bf16 agreement with each flip's
    margin, the paged op launched layers x 3 times a decode step
    (counted and traced), a device's K/V bytes the total / 3 on its
    shard tensors, a host block's round trip bit for bit, decode-step ms
    against tp=1, and a tp=3 restart from a store with no trace and the
    same tokens."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.aot import export_store
    from mxnet_tpu_torch.parallel import mesh as mesh_mod

    telemetry.reset()
    telemetry.enable()
    params = serve_params(std=CONTROL_WEIGHT_STD)
    prompts = serve_prompts(0)
    L = SERVE_CFG["num_layers"]
    checks = {}
    row = {"phase": "serve_aot_tp", "card": card,
           "manifest_programs": len(manifest), "tp": AOT_TP}
    old_virtual = os.environ.get(mesh_mod.ENV_VIRTUAL)
    with tempfile.TemporaryDirectory() as tmp:
        mpath = os.path.join(tmp, "manifest.jsonl")
        with open(mpath, "w") as f:
            for e in manifest:
                f.write(json.dumps(e) + "\n")
        store = os.path.join(tmp, "aot")
        # (1) cold: trace, export, save and capture every program
        before = _aot_counts()
        cold = full_width_engine(params, torch.bfloat16, aot_dir=store)
        ready, cold_s = _warm_timed(cold, manifest)
        after = _aot_counts()
        drive = _drive(cold, prompts)
        toks = drive["tokens"]
        entries = export_store.ExportStore(store).entries()
        checks["cold_traced_every_program"] = (
            ready == len(manifest)
            == _count_delta(after, before, "programs", "trace")
            == len(entries)
            and _count_delta(after, before, "programs", "artifact") == 0)
        checks["cold_no_traffic_capture"] = drive["traffic_captures"] == 0
        checks["cold_launches"] = (drive["launches"]
                                   == L * drive["decode_steps"] > 0)
        cold.shutdown()
        plain = full_width_engine(params, torch.bfloat16)
        _, manifest_s = _warm_timed(plain, manifest)
        checks["store_tokens_equal_traced_body"] = \
            _drive(plain, prompts)["tokens"] == toks
        plain.shutdown()
        row["store"] = {"artifacts": len(entries),
                        "bytes": sum(b for _, b in entries)}
        # the fresh process restarts from the store while this one goes
        # on with the planted faults and the identity pairs (its profile
        # counts its own kernels only)
        stale_dir = os.path.join(tmp, "stale")
        shutil.copytree(store, stale_dir)
        flat_dir = os.path.join(tmp, "flat")
        shutil.copytree(store, flat_dir)
        child_proc = _aot_child_start(store, mpath, 1)
        row["planted_stale"] = stale_fault(params, stale_dir, manifest)
        checks["planted_stale_costs_a_trace"] = row["planted_stale"]["ok"]
        row["planted_functionalized"] = inplace_fault(params, flat_dir,
                                                      manifest)
        checks["planted_functionalized_fails_inplace"] = \
            row["planted_functionalized"]["ok"]
        # (2) tp = 3 on this one card
        os.environ[mesh_mod.ENV_VIRTUAL] = str(AOT_TP)
        try:
            few = prompts[:AOT_TP_PROMPTS]
            pairs = {}
            for tag, kw in (("float32", {}), ("int8_kv",
                                              {"kv_dtype": "int8"})):
                got = {}
                for tp in (1, AOT_TP):
                    eng = full_width_engine(params, torch.float32, tp=tp,
                                            **kw)
                    got[tp] = _drive(eng, few)
                    eng.shutdown()
                same = got[1]["tokens"] == got[AOT_TP]["tokens"]
                pairs[tag] = {"identical": same,
                              "launches_tp": got[AOT_TP]["launches"],
                              "decode_steps_tp":
                                  got[AOT_TP]["decode_steps"]}
                checks[f"{tag}_tp{AOT_TP}_tokens_equal_tp1"] = same
            row["tp_pairs"] = pairs
            child = _aot_child_row(child_proc)
            prof = child.get("profile", {})
            traced = prof.get("traced_paged_kernels")
            checks["restart_zero_traces"] = (child.get("traces") == 0 and
                                             child.get("artifacts")
                                             == len(manifest))
            checks["restart_captures"] = (
                child.get("warmup_programs") == len(manifest)
                and child.get("warmup_captures")
                == child.get("captures_expected")
                and child.get("traffic_captures") == 0)
            checks["restart_tokens"] = child.get("tokens") == toks
            checks["restart_launches_traced"] = (
                bool(traced) and prof.get("counted_paged_launches") == traced
                and traced.get("paged_attention_split")
                == L * prof.get("decode_steps", 0) > 0
                and child.get("launches")
                == L * child.get("decode_steps", -1))
            row["start_seconds"] = {
                "cold_store_warmup_s": cold_s,
                "manifest_only_warmup_s": manifest_s,
                "serve_restart_warmup_s": restart_row.get("warmup_s"),
                "store_warm_warmup_s": child.get("warmup_s"),
                "store_warm_engine_build_s": child.get("build_s"),
                "store_warm_process_s": child.get("process_s")}
            row["restart"] = {k: child.get(k) for k in (
                "traces", "artifacts", "warmup_captures",
                "captures_expected", "launches", "decode_steps",
                "traffic_captures", "errors", "rc", "tail")}
            row["restart"]["profile"] = prof
            # bf16: tp=1 against tp=3 (the tier on: a host block's round
            # trip), each warmed from the manifest's programs (its lines'
            # spec digest is the tp=1 engine's: unstamped, trusted)
            grid = [{"kind": e["kind"], "bucket": e["bucket"]}
                    for e in manifest]
            e1 = full_width_engine(params, torch.bfloat16)
            e1.warmup(grid)
            d1 = _drive(e1, prompts)
            p1 = serve_profile(e1, prompts)
            e3 = full_width_engine(params, torch.bfloat16, tp=AOT_TP,
                                   host_kv_bytes=1 << 26)
            e3.warmup(grid)
            d3 = _drive(e3, prompts)
            p3 = serve_profile(e3, prompts)
            flipped = flips(e1, prompts, d1["tokens"], d3["tokens"])
            kv = e3.kv_cache_stats()
            shard0 = int(e3._cache_k[0].nbytes + e3._cache_v[0].nbytes)
            rt = host_round_trip(e3)
            e1.shutdown()
            e3.shutdown()
            per_step = L * AOT_TP
            traced3 = p3["traced_paged_kernels"]
            checks["tp_launches_per_decode_step"] = (
                d3["launches"] == per_step * d3["decode_steps"] > 0)
            checks["tp_launches_traced"] = (
                traced3["paged_attention_split"]
                == per_step * p3["decode_steps"] > 0
                and p3["counted_paged_launches"] == traced3)
            checks["tp_bytes_per_device"] = (
                shard0 == kv["bytes_per_device"]
                and kv["bytes_per_device"] * AOT_TP == kv["bytes_total"])
            checks["tp_host_round_trip"] = (rt["bit_exact"]
                                            and rt["shards_hold_their_heads"])
            checks["tp_no_traffic_capture"] = d3["traffic_captures"] == 0
            # the tp=3 restart from a store: two 16-token prompts (one
            # prefill and one decode program), traced in the cold
            # engine's traffic, loaded by the warm one's warmup
            pair = [prompts[0], prompts[4]]
            tp_store = os.path.join(tmp, "aot_tp")
            before = _aot_counts()
            c3 = full_width_engine(params, torch.bfloat16, tp=AOT_TP,
                                   aot_dir=tp_store)
            t0 = time.perf_counter()
            dc3 = _drive(c3, pair)
            cold3_s = time.perf_counter() - t0
            mid = _aot_counts()
            tp_manifest = c3.manifest()
            c3.shutdown()
            w3 = full_width_engine(params, torch.bfloat16, tp=AOT_TP,
                                   aot_dir=tp_store)
            ready_w3, warm3_s = _warm_timed(w3, tp_manifest)
            after = _aot_counts()
            dw3 = _drive(w3, pair)
            w3.shutdown()
            checks["tp_cold_traced"] = (
                _count_delta(mid, before, "programs", "trace")
                == len(tp_manifest) > 0)
            checks["tp_restart_zero_traces"] = (
                _count_delta(after, mid, "programs", "trace") == 0
                and _count_delta(after, mid, "programs", "artifact")
                == ready_w3 == len(tp_manifest))
            checks["tp_restart_tokens"] = dw3["tokens"] == dc3["tokens"]
            row["bf16"] = {
                "flips": flipped,
                "requests_identical": sum(
                    a == b for a, b in zip(d1["tokens"], d3["tokens"])),
                "decode_step_ms_mean_tp1": statistics.mean(d1["step_ms"]),
                f"decode_step_ms_mean_tp{AOT_TP}":
                    statistics.mean(d3["step_ms"]),
                "profile_tp1": {k: p1[k] for k in (
                    "wall_ms_per_step", "kernel_ms_per_step",
                    "kernels_per_step", "busy_share")},
                f"profile_tp{AOT_TP}": {k: p3[k] for k in (
                    "wall_ms_per_step", "kernel_ms_per_step",
                    "kernels_per_step", "busy_share",
                    "traced_paged_kernels", "counted_paged_launches")},
                "launches": d3["launches"],
                "combine_launches": d3["combine_launches"],
                "decode_steps": d3["decode_steps"],
                "launches_per_decode_step":
                    d3["launches"] / max(1, d3["decode_steps"])}
            row["tp_kv"] = {**kv, "shard0_bytes": shard0}
            row["tp_host_round_trip"] = rt
            row["tp_store"] = {"programs": len(tp_manifest),
                               "cold_traffic_s": cold3_s,
                               "store_warm_warmup_s": warm3_s}
        finally:
            if old_virtual is None:
                os.environ.pop(mesh_mod.ENV_VIRTUAL, None)
            else:
                os.environ[mesh_mod.ENV_VIRTUAL] = old_virtual
            if child_proc[0].poll() is None:
                child_proc[0].kill()
                child_proc[0].wait()
    telemetry.disable()
    telemetry.reset()
    row["checks"] = checks
    row["ok"] = all(checks.values())
    emit(row)
    if not row["ok"]:
        raise SystemExit("serve_aot_tp failed: " + ", ".join(
            k for k, v in checks.items() if not v))
    return {"kernel_launches": d3["launches"],
            "combine_launches": d3["combine_launches"],
            "restored_launches": child.get("launches", 0),
            "restored_combine_launches": child.get("combine_launches", 0)}


def small_model_check():
    """A small seeded model (the reference's serve-test shapes, rope +
    GQA + SwiGLU + RMSNorm + tied): the captured CUDA engine's greedy
    tokens, prefix cache on and prefill_chunk 8, with a prompt sharing
    another's prefix and a 40-token prompt that chunks, must equal the
    single-request oracle's on the card and the CPU engine's."""
    from mxnet_tpu_torch import models, serve

    params = models.gpt_params(53, 96, num_layers=2, d_model=32,
                               num_heads=4, kv_heads=2, mlp="swiglu",
                               norm="rmsnorm", pos_embed="rope",
                               tie_embeddings=True, seed=3, scale=0.35)
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, 53, (rng.randint(6, 22),)).astype(np.int32)
               for _ in range(4)]
    prompts.append(np.concatenate([prompts[0], rng.randint(0, 53, (5,))
                                   .astype(np.int32)]))
    prompts.append(rng.randint(0, 53, (40,)).astype(np.int32))
    got, st = {}, {}
    for dev in (DEVICE, "cpu"):
        eng = serve.Engine(params, num_heads=4, window=0, device=dev,
                           block_size=4, num_blocks=64, max_batch=4,
                           max_model_len=64, max_prefills_per_step=2,
                           prefill_chunk=8)
        reqs = [eng.submit(p, max_new_tokens=16) for p in prompts]
        eng.run()
        got[dev] = [r.tokens for r in reqs]
        st[dev] = (eng.stats().prefix_hits, eng.captures,
                   sum(p.calls for (k, _), p in eng._programs.items()
                       if k == "chunk"), len(eng._programs))
        # a dropped engine lives on (in /statusz too) until the cyclic
        # collector runs
        eng.shutdown()
    oracle = [models.gpt_generate(params, p[None], 16, num_heads=4,
                                  window=0, device=DEVICE)[0, p.size:]
              .tolist() for p in prompts]
    hits, captures, chunks, programs = st[DEVICE]
    ok = (got[DEVICE] == got["cpu"] == oracle and hits > 0 and chunks > 0
          and captures == (programs if DEVICE == "cuda" else 0))
    emit({"phase": "small_model_check", "cuda_eq_cpu":
          got[DEVICE] == got["cpu"], "cuda_eq_oracle": got[DEVICE] == oracle,
          "prefix_hits": hits, "chunk_calls": chunks, "captures": captures,
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
# stated flash kernel-vs-plain bounds, element by element, each output X
# beside A, the sum of the magnitudes of the terms X adds up (o: P|V|; dq:
# |dS||K|; dk: |dS|^T|Q|; dv: P^T|dO|, in float32):
#   float32, tensor-core kernels (split TF32): |kernel - plain64| <=
#     F32_REL A + F32_ABS, plain64 being the plain versions run on float64
#     copies of the same values.  For o, dk and dv, float32 sums of <= 1024
#     terms (~sqrt(1024) 6e-8 A) and expf against exp leave 1e-5 A a 5x
#     margin.  For dq they do not: dS cancels (ds = p (dp - delta + dlse)
#     scale with dp near delta at a causal row's first keys, where |ds| is
#     ~|dlse| scale while dp is ~8), and a rounding of dp within a few
#     float32 ulps is a large share of 1e-5 |dS||K|.  float32 arithmetic
#     itself fails the bound there: the float32 plain version reads
#     1.03-1.10 of it against plain64 (train, train_fused, contract_window
#     on an H100).  So the dq margin is no error analysis but the shares
#     measured: the kernel's, the three-product model's and the float32
#     plain version's, at three draws of train and train_fused
#     (dq_seed_shares), each row beside the bound: the kernel read at most
#     0.79 of it there, the model up to 1.30 (its products rounded apart).
#   float32, FMA kernels (flash_attention.cu, reached through a copy of q
#     off 16-byte alignment): they take the same products and sum them in
#     float32 as the float32 plain version does, so they are held to that
#     version: |kernel - plain32| <= F32_REL A + F32_ABS, as every float32
#     kernel was before the tensor-core ones; their share against plain64
#     is reported beside.
#   bfloat16 (both kinds): |kernel - plain32| <= 2^-8 |plain32| + 2^-8 A
#     + F32_REL A + F32_ABS.  The kernel rounds p (or ds) to bf16 before
#     the product, each term off by at most 2^-8 of itself (2^-8 A in
#     all), and rounds the float32 result once at the end (2^-8 |X|).
#   lse (all): |kernel - plain32| <= F32_REL (1 + |lse|); fully-masked
#     rows exactly -1e30 in both.
# The bound scales with each output, and the check is shown to bind: the
# train-shape bf16 check is run again on the plain output with one k
# tile dropped (forward, dQ) or one q tile dropped (dK/dV), and must fail;
# at float32, one-product TF32 models of the kernels must fail it.
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


def plain_outputs(q, k, v, o, lse, do, dlse, kw, wide=False):
    """The plain versions' o and lse (flash_attention_fwd_torch) and dq,
    dk, dv (flash_attention_bwd_torch, from the kernel's o and lse), on
    float32 copies of the inputs or, ``wide``, on float64 copies: plain32
    and plain64 of the bounds above; in the case's layout."""
    from mxnet_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_torch, flash_attention_fwd_torch)

    dt = torch.float64 if wide else torch.float32
    up = [t.to(dt) for t in (q, k, v)]
    out = dict(zip(("o", "lse"), flash_attention_fwd_torch(*up, **kw)))
    out.update(zip(("dq", "dk", "dv"), flash_attention_bwd_torch(
        *up, o.to(dt), lse.to(dt), do.to(dt), dlse.to(dt), **kw)))
    return out


def plain64(q, k, v, o, lse, do, dlse, kw):
    return plain_outputs(q, k, v, o, lse, do, dlse, kw, wide=True)


def within_bound(got, ref, A, dtype):
    dev = (got.double() - ref).abs()
    allowed = F32_REL * A + F32_ABS
    if dtype == torch.bfloat16:
        allowed = allowed + BF16_REL * (ref.abs() + A)
    return bool((dev <= allowed).all()), float((dev / allowed).max())


def lse_check(lse, p_lse, o, kw):
    """(lse within its bound of the plain lse with the same fully-masked
    rows at exactly -1e30, o exactly 0 on those rows, their number)."""
    masked = lse <= -1e29
    lse_ok = (torch.equal(masked, p_lse <= -1e29)
              and bool((lse[masked] == -1e30).all())
              and bool(((lse - p_lse).abs()[~masked]
                        <= F32_REL * (1 + p_lse.abs()[~masked])).all()))
    zero_rows = bool((_bhsd(o, kw["layout"])[masked] == 0).all())
    return lse_ok, zero_rows, int(masked.sum())


FLASH_KINDS = (("flash_fwd", "flash_fwd_f32", "flash_fwd_simt"),
               ("flash_dq", "flash_dq_f32", "flash_dq_simt"),
               ("flash_dkv", "flash_dkv_f32", "flash_dkv_simt"))
# the cases at which check_flash also holds the FMA kernels (contiguous
# q, so a misaligned copy of it exists; a causal one and the windowed one
# with offsets, GQA and fully-masked rows)
FMA_CHECK_TAGS = ("train", "contract_window")


def check_flash(tag, shape, dtype):
    from mxnet_tpu_torch.ops import flash_attention_cuda as fac

    args, kw = flash_case(shape, dtype)
    q, k, v, do, dlse = args
    before = dict(fac.launches)
    o, lse, dq, dk, dv = flash_through_autograd(*args, kw)
    torch.cuda.synchronize()
    # every shape here is within the tensor-core kernels' limits: bf16
    # runs them, float32 the split-TF32 forward, dQ and dK/dV
    fwd_ran, dq_ran, dkv_ran = (
        [n for n in names if fac.launches[n] != before[n]]
        for names in FLASH_KINDS)
    tc = dtype == torch.bfloat16
    fwd_want = "flash_fwd" if tc else "flash_fwd_f32"
    dq_want = "flash_dq" if tc else "flash_dq_f32"
    dkv_want = "flash_dkv" if tc else "flash_dkv_f32"
    ref = plain_outputs(q, k, v, o, lse, do, dlse, kw)
    p_lse = ref["lse"]
    A = magnitude_terms(q, k, v, o, lse, do, dlse, kw)
    got = {"o": o, "dq": dq, "dk": dk, "dv": dv}
    row = {"phase": "flash_check", "shape": tag, "dtype": str(dtype)[6:],
           "fwd_kernel": fwd_ran, "dq_kernel": dq_ran,
           "dkv_kernel": dkv_ran,
           "reference": "plain32" if tc else "plain64"}
    ok = (fwd_ran == [fwd_want] and dq_ran == [dq_want]
          and dkv_ran == [dkv_want])
    if not tc:
        # the float32 kernels against the plain versions in float64; the
        # float32 plain versions' own shares beside them
        ref32, ref = ref, plain64(q, k, v, o, lse, do, dlse, kw)
        row["worst_share_vs_plain32"] = {
            n: within_bound(got[n], ref32[n], A[n], dtype)[1] for n in got}
        row["plain32_worst_share_vs_plain64"] = {
            n: within_bound(ref32[n], ref[n], A[n], dtype)[1] for n in got}
        del ref32
    for name in got:
        fine, share = within_bound(got[name], ref[name], A[name], dtype)
        row[f"{name}_worst_share_of_bound"] = share
        row[f"{name}_max_abs_err_vs_{row['reference']}"] = float(
            (got[name].double() - ref[name]).abs().max())
        ok = ok and fine and bool(torch.isfinite(got[name]).all())
    lse_ok, zero_rows, n_masked = lse_check(lse, p_lse, o, kw)
    row.update({"masked_rows": n_masked, "lse_ok": lse_ok,
                "masked_rows_zero": zero_rows})
    ok = ok and lse_ok and zero_rows
    # max |kernel - plain| with the plain versions in the same dtype (the
    # kernels line's max_abs_err)
    same = plain_same_dtype(q, k, v, o, lse, do, dlse, kw)
    row["max_abs_err_same_dtype"] = {
        n: float((got[n].float() - same[n].float()).abs().max())
        for n in got}
    del same
    if tag == "train" and dtype == torch.bfloat16:
        # the check binds: a kernel that skipped one tile must fail it
        mut = {**magnitude_terms(q, k, v, o, lse, do, dlse, kw, drop_k=8),
               **magnitude_terms(q, k, v, o, lse, do, dlse, kw, drop_q=8)}
        caught = {n: not within_bound(mut[n], ref[n], A[n], dtype)[0]
                  for n in mut}
        row["dropped_tile_caught"] = caught
        ok = ok and all(caught.values())
    if tag == "train" and dtype == torch.float32:
        row["tf32_models"] = tf32_models(q, k, v, o, lse, do, dlse, kw, ref,
                                         A, row)
        ok = ok and row["tf32_models"]["ok"]
    del ref, A, got
    if not tc and tag in ("train", "train_fused"):
        row["dq_seed_shares"] = dq_seed_shares(shape)
        ok = ok and row["dq_seed_shares"]["ok"]
    if tag in FMA_CHECK_TAGS:
        row["fma_kernels"] = check_flash_fma(args, kw, dtype)
        ok = ok and row["fma_kernels"]["ok"]
    row["bound"] = ("|k - plain32| <= 2^-8 (|plain32| + A) + 1e-5 A + 1e-6"
                    if tc else "|k - plain64| <= 1e-5 A + 1e-6")
    row["ok"] = ok
    emit(row)
    torch.cuda.empty_cache()
    if not ok:
        raise SystemExit(f"flash kernels disagree with plain: {tag} {dtype}")
    return row


def plain_same_dtype(q, k, v, o, lse, do, dlse, kw):
    """The plain versions' outputs with the inputs in their own dtype."""
    from mxnet_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_torch, flash_attention_fwd_torch)

    out = {"o": flash_attention_fwd_torch(q, k, v, **kw)[0]}
    out.update(zip(("dq", "dk", "dv"), flash_attention_bwd_torch(
        q, k, v, o, lse, do, dlse, **kw)))
    return out


def check_flash_fma(args, kw, dtype):
    """The FMA kernels of csrc/flash_attention.cu (the forward, dQ and
    dK/dV the port ships for float32 outside the tensor-core kernels'
    limits and for bf16 outside the bf16 ones), through the autograd
    Function on a copy of q 2 (bf16) or 4 (float32) bytes off 16-byte
    alignment, where the variant selectors send all three.  Each must
    launch once; o, lse, dq, dk and dv are held to the plain versions
    summed in float32 (plain32, see the bounds above), with the float32
    ones' share against plain64 beside."""
    from mxnet_tpu_torch.ops import flash_attention_cuda as fac

    q, k, v, do, dlse = args
    q_fma = misaligned_copy(q)
    before = dict(fac.launches)
    o, lse, dq, dk, dv = flash_through_autograd(q_fma, k, v, do, dlse, kw)
    torch.cuda.synchronize()
    ran = {n: fac.launches[n] - before[n] for n in fac.launches
           if fac.launches[n] != before[n]}
    want = {names[2]: 1 for names in FLASH_KINDS}
    got = {"o": o, "dq": dq, "dk": dk, "dv": dv}
    ref = plain_outputs(q, k, v, o, lse, do, dlse, kw)
    A = magnitude_terms(q, k, v, o, lse, do, dlse, kw)
    res = {"launched": ran, "reference": "plain32",
           "misaligned_bytes": q.element_size()}
    ok = ran == want
    for name in got:
        fine, share = within_bound(got[name], ref[name], A[name], dtype)
        res[f"{name}_worst_share_of_bound"] = share
        ok = ok and fine and bool(torch.isfinite(got[name]).all())
    lse_ok, zero_rows, n_masked = lse_check(lse, ref["lse"], o, kw)
    res.update({"masked_rows": n_masked, "lse_ok": lse_ok,
                "masked_rows_zero": zero_rows})
    ok = ok and lse_ok and zero_rows
    if dtype == torch.float32:
        del ref
        ref = plain64(q, k, v, o, lse, do, dlse, kw)
        res["worst_share_vs_plain64"] = {
            n: within_bound(got[n], ref[n], A[n], dtype)[1] for n in got}
    res["ok"] = ok
    return res


def dq_seed_shares(shape, seeds=(1, 2)):
    """dq's worst share of the float32 bound against plain64 at more
    draws of one case (the seed-0 row carries the first): the split-TF32
    kernel's, through the autograd Function, the three-product model's
    and the float32 plain version's.  The kernel must meet the bound at
    each draw.  The model and the plain version are reported only: the
    bound is at float32's own rounding where dS cancels, and the model's
    three products, each rounded to float32 before they are added, read
    1.30 of it at train_fused's seed 1 on an H100, where the kernel, which
    adds them in its accumulators, reads 0.79."""
    from mxnet_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_torch, flash_attention_dq_tf32)

    out, ok = {}, True
    for seed in seeds:
        args, kw = flash_case(shape, torch.float32, seed)
        q, k, v, do, dlse = args
        o, lse, dq, _, _ = flash_through_autograd(*args, kw)
        A = magnitude_terms(q, k, v, o, lse, do, dlse, kw)["dq"]
        ref = plain64(q, k, v, o, lse, do, dlse, kw)["dq"]
        shares = {
            "kernel": within_bound(dq, ref, A, torch.float32),
            "split_3_model": within_bound(flash_attention_dq_tf32(
                q, k, v, o, lse, do, dlse, products=3, **kw), ref, A,
                torch.float32),
            "plain32": within_bound(flash_attention_bwd_torch(
                q, k, v, o, lse, do, dlse, **kw)[0], ref, A,
                torch.float32)}
        out[f"seed_{seed}"] = {n: sh for n, (_, sh) in shares.items()}
        ok = ok and shares["kernel"][0]
    out["ok"] = ok
    return out


def tf32_models(q, k, v, o, lse, do, dlse, kw, ref, A, row):
    """The float32 bound tells split TF32 from plain TF32: o from torch
    models of the forward kernel's two products, dq from models of the dQ
    kernel's three and dK/dV from models of the dK/dV kernel's four, on
    the same inputs, with the three-product split (it must pass) and with
    one TF32 product of operands rounded once (a planted fault: it must
    fail on every output); each one's worst share of the bound beside the
    kernel's (``row``)."""
    from mxnet_tpu_torch.ops.flash_attention import (
        flash_attention_dkv_tf32, flash_attention_dq_tf32,
        flash_attention_fwd_tf32)

    res = {}
    for products in (3, 1):
        mo, _ = flash_attention_fwd_tf32(q, k, v, products=products, **kw)
        res[f"products_{products}"] = {
            "o": within_bound(mo, ref["o"], A["o"], torch.float32)}
        del mo
        dq = flash_attention_dq_tf32(q, k, v, o, lse, do, dlse,
                                     products=products, **kw)
        res[f"products_{products}"]["dq"] = within_bound(
            dq, ref["dq"], A["dq"], torch.float32)
        del dq
        dk, dv = flash_attention_dkv_tf32(q, k, v, o, lse, do, dlse,
                                          products=products, **kw)
        res[f"products_{products}"].update(
            (n, within_bound(x, ref[n], A[n], torch.float32))
            for n, x in (("dk", dk), ("dv", dv)))
        del dk, dv
        torch.cuda.empty_cache()
    split, single = res["products_3"], res["products_1"]
    caught = all(not fine for fine, _ in single.values())
    return {"split_3_worst_share": {n: v[1] for n, v in split.items()},
            "single_1_worst_share": {n: v[1] for n, v in single.items()},
            "kernel_worst_share": {n: row[f"{n}_worst_share_of_bound"]
                                   for n in split},
            "split_passes": all(fine for fine, _ in split.values()),
            "single_caught": caught,
            "ok": caught and all(fine for fine, _ in split.values())}


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
    under ``names`` (the flash kernels' D; the RNN kernel's G), or by
    ``kernel`` for a kernel that is not a template."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            args = re.findall(r"Li(\d+)E", m.group(1))
            key = "_".join(f"{n}{v}" for n, v in zip(names, args))
            cur = (key or kernel) if kernel in m.group(1) else None
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
    tc = dtype == torch.bfloat16
    (q, k, v, do, dlse), kw = flash_case(shape, dtype, seed=1)
    saved = dict(fac.launches)
    o, lse = fac.flash_fwd_cuda(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1).contiguous()
    bwd = (q, k, v, do, lse, delta, dlse)
    # bf16: the tensor-core kernels and, in the same run, the other
    # kernels at the same shape (through the selectors: q 2 bytes off
    # alignment); float32: the split-TF32 forward, dQ and dK/dV beside
    # the float32-FMA ones (q 4 bytes off alignment)
    fac.launches.update({n: 0 for n in fac.launches})
    t = {"flash_fwd": time_ms(lambda: fac.flash_fwd_cuda(q, k, v, **kw)),
         "flash_dq": time_ms(lambda: fac.flash_dq_cuda(*bwd, **kw)),
         "flash_dkv": time_ms(lambda: fac.flash_dkv_cuda(*bwd, **kw))}
    q_simt = misaligned_copy(q)
    ms_simt = {
        "flash_fwd": time_ms(lambda: fac.flash_fwd_cuda(q_simt, k, v, **kw)),
        "flash_dq": time_ms(lambda: fac.flash_dq_cuda(q_simt, *bwd[1:],
                                                      **kw)),
        "flash_dkv": time_ms(lambda: fac.flash_dkv_cuda(q_simt, *bwd[1:],
                                                        **kw))}
    timed = dict(fac.launches)
    fac.launches.update(saved)        # timing launches are not the path's
    ran = {n: c for n, c in timed.items() if c}
    names = {n: (n if tc else f"{n}_f32") for n in t}
    want = set(names.values()) | {f"{n}_simt" for n in t}
    if set(ran) != want or len(set(ran.values())) != 1:
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
            "phase": "flash_time", "kernel": names[name],
            "shape": "train",
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
        src = f"{name}_tc" if tc else f"{name}_f32tc"
        rows[name].update({
            "source": f"csrc/{src}.cu",
            "ms_simt": ms_simt[name],
            "simt_over_tc": ms_simt[name] / t[name],
            "simt": f"{name}_kernel (csrc/flash_attention.cu), the "
                    f"same shape with q {q.element_size()} bytes off "
                    "16-byte alignment",
            "ptxas": ptxas_report(
                _build.BUILD_LOGS.get(fac.LIB_NAME, ""), f"{src}_kernel")})
        if not tc:
            # its products are three TF32 ones: that bound, and the
            # float32-FMA one of the same work beside it
            t_b, t_o = nbytes / PEAK_BYTES_S, 3 * ops / PEAK_TF32_OPS_S
            rows[name].update({
                "bound_ms": 1e3 * max(t_b, t_o),
                "bound_by": "bytes" if t_b >= t_o else "operations",
                "bound_share": 1e3 * max(t_b, t_o) / t[name],
                "bound_rule": "3 x ops at 495 TFLOP/s (split TF32) vs "
                              "bytes at 3.35 TB/s",
                "bound_fma_ms": b_ms, "bound_fma_by": b_by,
                "bound_fma_rule": "ops at 67 TFLOP/s (float32 FMA) vs "
                                  "bytes at 3.35 TB/s"})
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
    profile = train_profile(lambda: tr.step(placed))
    lap("gpt_train_profile")
    want = cfg["num_layers"] * TRAIN_STEPS
    # every bf16 flash launch on the tensor-core kernels, none on the
    # others
    expected = {"flash_fwd": want, "flash_fwd_f32": 0, "flash_fwd_simt": 0,
                "flash_dq": want, "flash_dq_f32": 0, "flash_dq_simt": 0,
                "flash_dkv": want, "flash_dkv_f32": 0, "flash_dkv_simt": 0}
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
                      ("rnn_fwd_f32tc_kernel", "fused_rnn_fwd"),
                      ("rnn_bwd_kernel", "fused_rnn_bwd"),
                      ("rnn_bwd_tc_kernel", "fused_rnn_bwd"),
                      ("rnn_bwd_f32tc_kernel", "fused_rnn_bwd"),
                      ("paged_attention", "paged_attention"),
                      ("indexselect", "gather"),
                      # cuDNN's convolutions, batch norm and pooling
                      # before the matmul keys, which their names hold
                      ("fprop", "conv"), ("dgrad", "conv"),
                      ("wgrad", "conv"), ("convolve", "conv"),
                      ("conv2d", "conv"), ("winograd", "conv"),
                      ("fft2d", "conv"), ("conv_depthwise", "conv"),
                      ("nchwtonhwc", "conv"), ("nhwctonchw", "conv"),
                      ("scalepackedtensor", "conv"),
                      ("batch_norm", "batchnorm"), ("bn_fw", "batchnorm"),
                      ("bn_bw", "batchnorm"), ("pool", "pool"),
                      ("gemm", "matmul"),
                      ("xmma", "matmul"), ("cutlass", "matmul"),
                      ("nvjet", "matmul"),
                      ("softmax", "softmax"), ("embedding", "embedding"),
                      ("reduce", "reduction"), ("elementwise", "elementwise"),
                      ("vectorized", "elementwise"), ("copy", "copy"),
                      ("topk", "topk_sort"), ("sort", "topk_sort"),
                      ("radix", "topk_sort"), ("scan", "scan")):
        if key in low:
            return kind
    return "other"


def profiler_warmup():
    """Start torch.profiler once around one small CUDA op: its first
    start (CUPTI and kineto set-up) takes seconds, spent here, beside the
    build, rather than inside the first profile window's phase."""
    from mxnet_tpu_torch import profiler

    with tempfile.TemporaryDirectory() as logdir:
        with profiler.trace(logdir):
            torch.ones(8, device=DEVICE).add_(1)
            torch.cuda.synchronize()
        traced_kernels(logdir)


def _launch_kind(name):
    """The trace kind of a launch counter's name: the fused-RNN
    counters (``lstm_fwd_f32``, ...) by direction, the rest as traced."""
    if name.startswith(("lstm_", "gru_")):
        return "fused_rnn_" + name.split("_")[1]
    return _kernel_kind(name)


def train_profile(step, steps=2, counted="flash"):
    """Device time and kernel instances by kind over ``steps`` more calls
    of ``step`` (one train step each; torch.profiler), and the device's
    busy share of their wall time.  The ``counted`` wrappers' launches
    (the flash kernels', or the fused RNN kernels' with ``"rnn"``) are
    counted over the same window: ``<counted>_traced_vs_launched``
    holds, for each of their kinds, the instances in the trace beside the
    launches, and ``trace_complete`` says whether the trace holds every
    one (a kind's ms a step is read only from a complete window; an
    incomplete one is reported, not re-run)."""
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.ops import flash_attention_cuda as fac
    from mxnet_tpu_torch.ops import fused_rnn_cuda as frc

    counters = fac.launches if counted == "flash" else frc.launches
    torch.cuda.synchronize()
    saved = dict(counters)
    counters.update(dict.fromkeys(counters, 0))
    with tempfile.TemporaryDirectory() as logdir:
        with profiler.trace(logdir):
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        kernels, counts = traced_kernels(logdir)
    counted_now = dict(counters)
    counters.update({n: saved[n] + c for n, c in counted_now.items()})
    kinds, instances = {}, {}
    for name, ms in kernels.items():
        kind = _kernel_kind(name)
        kinds[kind] = kinds.get(kind, 0.0) + ms / steps
        instances[kind] = instances.get(kind, 0) + counts[name]
    launched = {}
    for name, c in counted_now.items():
        kind = _launch_kind(name)
        launched[kind] = launched.get(kind, 0) + c
    traced = {kind: {"traced": instances.get(kind, 0), "launched": c}
              for kind, c in launched.items()
              if c or instances.get(kind, 0)}
    complete = all(v["traced"] == v["launched"] for v in traced.values())
    if not complete:
        print(f"train_profile: trace incomplete: {traced}", file=sys.stderr)
    device_ms = sum(kernels.values()) / steps
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    return {"steps": steps, "wall_ms_per_step": wall_ms / steps,
            "device_ms_per_step": device_ms,
            "device_busy_share": device_ms * steps / wall_ms,
            "ms_per_step_by_kind": kinds,
            "kernels_traced_by_kind": instances,
            f"{counted}_traced_vs_launched": traced,
            "trace_complete": complete,
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


# -- training through the Symbol frontend: module.Module ---------------------
# The train phase's model built as the reference's Symbol
# (models.gpt_symbol at TRAIN_CFG) and trained by module.Module on
# gpu(0) in float32, the reference Module's bind dtype, with Xavier and
# Adam(3e-4): its attention runs the split-TF32 float32 flash kernels
# (flash_fwd_f32, flash_dq_f32 and flash_dkv_f32), never the bf16
# tensor-core ones.
MODULE_LR = 3e-4
# the card-vs-CPU model: 2 layers, d_model 64, 4 heads, S 128, with
# attn_impl="flash" (the kernels on the card, their plain versions on
# the CPU)
MODULE_TINY = dict(vocab=53, seq_len=128, num_layers=2, d_model=64,
                   num_heads=4, fused_qkv=True, attn_layout="bhsd",
                   loss="softmax")
MODULE_TINY_BATCH = 4
# card vs CPU, float32, the same parameters and batch: probabilities
# within MODULE_OUT_ABS; each parameter's gradient within GRAD_REL of its
# largest (the kernels and the plain versions differ by summation order
# alone, held per element by the flash checks above)
MODULE_OUT_ABS = 1e-5


def module_ctx():
    import mxnet_tpu_torch as mt

    return mt.cpu() if DEVICE == "cpu" else mt.gpu(0)


def gpt_module(cfg, batch, impl="auto", ctx=None, params=None, seed=0):
    """A bound, initialised Module over ``gpt_symbol(cfg)`` with Adam:
    Xavier from ``mt.random.seed(seed)``, or ``params`` (numpy)."""
    import mxnet_tpu_torch as mt

    net = mt.models.gpt_symbol(
        cfg["vocab"], cfg["seq_len"], attn_impl=impl,
        **{k: v for k, v in cfg.items() if k not in ("vocab", "seq_len")})
    mod = mt.mod.Module(net, context=ctx or module_ctx())
    shape = (batch, cfg["seq_len"])
    mod.bind([("data", shape)], [("softmax_label", shape)])
    if params is None:
        mt.random.seed(seed)
        mod.init_params(mt.init.Xavier())
    else:
        mod.set_params(params, {})
    mod.init_optimizer(optimizer="adam",
                       optimizer_params=(("learning_rate", MODULE_LR),))
    return mod


def module_batch(cfg, batch, ctx, seed=0):
    import mxnet_tpu_torch as mt

    b = train_batch(cfg["vocab"], batch, cfg["seq_len"], seed=seed)
    return mt.io.DataBatch([mt.nd.array(b["data"], ctx=ctx)],
                           [mt.nd.array(b["softmax_label"], ctx=ctx)])


def module_step(mod, db):
    """forward(is_train=True) / backward() / update(): the head's
    probabilities."""
    mod.forward(db, is_train=True)
    mod.backward()
    mod.update()
    return mod.get_outputs()[0]._data


def module_params(mod):
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def train_module_main_path(train_row):
    from mxnet_tpu_torch.ops import flash_attention_cuda as fac

    cfg = TRAIN_CFG
    torch.cuda.reset_peak_memory_stats()
    mod = gpt_module(cfg, TRAIN_BATCH)
    db = module_batch(cfg, TRAIN_BATCH, module_ctx())
    labels = db.label[0]._data
    lap("module_train_setup")
    nll = [nll_of(module_step(mod, db), labels)
           for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    for name in fac.launches:          # the main path's window opens
        fac.launches[name] = 0
    step_ms = []
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        ts = time.perf_counter()
        probs = module_step(mod, db)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - ts))
        nll.append(nll_of(probs, labels))
    wall = time.perf_counter() - t0
    launches = dict(fac.launches)      # ... and closes
    lap("module_train_steps")
    profile = train_profile(lambda: module_step(mod, db))
    lap("module_train_profile")
    want = cfg["num_layers"] * TRAIN_STEPS
    # every float32 flash launch on the split-TF32 kernels, none on the
    # float32-FMA or the bf16 tensor-core ones
    expected = {"flash_fwd": 0, "flash_fwd_f32": want, "flash_fwd_simt": 0,
                "flash_dq": 0, "flash_dq_f32": want, "flash_dq_simt": 0,
                "flash_dkv": 0, "flash_dkv_f32": want, "flash_dkv_simt": 0}
    finite = all(np.isfinite(nll))
    shape = tuple(probs.shape)
    ok = (finite and nll[-1] < nll[0] and launches == expected
          and shape == (TRAIN_BATCH * cfg["seq_len"], cfg["vocab"]))
    median = statistics.median(step_ms)
    tok_s = TRAIN_BATCH * cfg["seq_len"] * TRAIN_STEPS / wall
    row = {"phase": "train_module", "dtype": "float32", "config": cfg,
           "entry": "models.gpt_symbol + mod.Module (bind, init_params("
                    "Xavier), init_optimizer(adam, 3e-4), forward/backward/"
                    "update)",
           "batch": TRAIN_BATCH, "output_shape": shape,
           "warmup_steps": TRAIN_WARMUP, "steps": TRAIN_STEPS,
           "kernel_launches": launches, "launches_expected": expected,
           "step_ms": step_ms, "step_ms_median": median, "wall_s": wall,
           "tokens_per_s": tok_s, "nll": nll,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "profile": profile,
           "vs_train_bf16": {
               "step_ms_median_ratio": median / train_row["step_ms_median"],
               "tokens_per_s_ratio": tok_s / train_row["tokens_per_s"]},
           "ok": ok}
    emit(row)
    del mod, db, probs, labels
    torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("Module training failed its checks")
    return row


def adam_param_worst(got, want, grads, lr):
    """Worst share of the bound |got - want| <= 2e-5 + 3 lr min(2, 1e-5
    max|g| / |g_i|) (small_train_check's: Adam's first steps move an
    element whose gradient is near zero by up to lr either way), the
    key biases (an exactly-zero gradient) within 2e-5 + 6 lr."""
    worst, worst_name = 0.0, None
    for name in want:
        g = np.abs(grads[name])
        allowed = 2e-5 + 3 * lr * np.minimum(
            2.0, 1e-5 * float(g.max()) / np.maximum(g, 1e-30))
        if name.endswith(("_k_bias", "_qkv_bias")):
            allowed = np.maximum(allowed, 2e-5 + 6 * lr)
        share = float((np.abs(got[name] - want[name]) / allowed).max())
        if share > worst:
            worst, worst_name = share, name
    return worst, worst_name


def module_trainer_check():
    """Module against ShardedTrainer on the card at TRAIN_CFG width:
    the same numpy parameters (Module.set_params, the trainer's
    set_params through convert), the same float32 Adam and batch, 3
    steps.  Both launch the same kernels; they differ in summation order
    alone.  Probabilities within 1e-5 at step 1 and 1e-4 after;
    parameters within adam_param_worst's bound."""
    cfg = TRAIN_CFG
    mod = gpt_module(cfg, TRAIN_BATCH, seed=1)
    start = module_params(mod)
    tr = make_trainer(cfg, TRAIN_BATCH, "float32")
    tr.set_params(start)
    batch = train_batch(cfg["vocab"], TRAIN_BATCH, cfg["seq_len"], seed=5)
    db = module_batch(cfg, TRAIN_BATCH, module_ctx(), seed=5)
    exe = mod._exec_group.execs[0]
    out_err, grads = [], None
    for step in range(3):
        mod.forward(db, is_train=True)
        mod.backward()
        if grads is None:
            grads = {k: exe.grad_dict[k].asnumpy() for k in start}
        mod.update()
        a = mod.get_outputs()[0]._data
        b = tr.step(batch)[0]
        out_err.append(float((a - b).abs().max()))
    worst, worst_name = adam_param_worst(module_params(mod),
                                         tr.get_params(), grads, MODULE_LR)
    ok = out_err[0] <= 1e-5 and max(out_err) <= 1e-4 and worst <= 1.0
    emit({"phase": "module_vs_trainer", "dtype": "float32", "steps": 3,
          "out_max_abs_err": out_err,
          "param_worst_share_of_bound": worst, "worst_param": worst_name,
          "bound": "out <= 1e-5 (step 1), 1e-4 (after); params "
                   "2e-5 + 3 lr min(2, 1e-5 max|g|/|g_i|)", "ok": ok})
    del mod, tr, db
    torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("Module and ShardedTrainer disagree")


def module_small_check():
    """A tiny gpt_symbol through Module on the card (the flash kernels)
    and on the CPU (their plain versions), the same parameters and
    batch: outputs and every gradient within the stated float32 bounds;
    then the card module's checkpoint loaded by Module.load gives the
    same outputs."""
    import mxnet_tpu_torch as mt

    cfg, B = MODULE_TINY, MODULE_TINY_BATCH
    card = gpt_module(cfg, B, impl="flash", seed=2)
    params = module_params(card)
    host = gpt_module(cfg, B, impl="flash", ctx=mt.cpu(), params=params)
    outs, grads = {}, {}
    for tag, mod in (("card", card), ("cpu", host)):
        db = module_batch(cfg, B, mod._context[0], seed=3)
        mod.forward(db, is_train=True)
        mod.backward()
        outs[tag] = mod.get_outputs()[0].asnumpy()
        exe = mod._exec_group.execs[0]
        grads[tag] = {k: exe.grad_dict[k].asnumpy() for k in params}
    out_err = float(np.abs(outs["card"] - outs["cpu"]).max())
    grad_share = max(
        float(np.abs(grads["card"][k] - grads["cpu"][k]).max())
        / max(GRAD_REL * float(np.abs(grads["cpu"][k]).max()), 1e-30)
        for k in params)
    db = module_batch(cfg, B, module_ctx(), seed=4)
    card.forward(db, is_train=False)
    before = card.get_outputs()[0].asnumpy()
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "gpt_module")
        card.save_checkpoint(prefix, 1)
        loaded = mt.mod.Module.load(prefix, 1, context=module_ctx())
    loaded.bind(*[[(d.name, d.shape) for d in descs]
                  for descs in (card.data_shapes, card.label_shapes)],
                for_training=False)
    loaded.forward(db, is_train=False)
    after = loaded.get_outputs()[0].asnumpy()
    same = bool(np.array_equal(before, after))
    ok = (out_err <= MODULE_OUT_ABS and grad_share <= 1.0 and same
          and bool(np.isfinite(outs["card"]).all()))
    emit({"phase": "module_small_check", "config": cfg, "batch": B,
          "out_max_abs_err": out_err, "grad_worst_share_of_bound": grad_share,
          "bound": "out <= 1e-5; max|g_card - g_cpu| <= 2e-5 max|g_cpu| "
                   "per param",
          "checkpoint_round_trip_identical": same, "ok": ok})
    if not ok:
        raise SystemExit("Module: card vs CPU or checkpoint round trip "
                         "disagree")


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
    forward's and the backward's: "tc", "tc32" or "simt"; by default the
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
    one shape and dtype (bounds above); returns the report row.  In
    bfloat16 both are the bf16 tensor-core kernels; in float32 both are
    the split-TF32 tensor-core ones (the row says which ran).  At the
    main shape the FMA backward (``_variant="simt"``) and the FMA forward
    are held to the same bounds, each with the other pass on its rule's
    kernel; in float32 the torch models of the forward's and the
    backward's split-TF32 products must pass and their one-product
    models must fail (``rnn_tf32_models``)."""
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
    bf16 = dtype == torch.bfloat16
    want = {kind: f"{mode}_{kind}" + ("" if bf16 else "_f32")
            for kind in ("fwd", "bwd")}
    ref = rnn_plain(mode, ins, cot)
    row = {"phase": "rnn_check", "mode": mode, "shape": tag,
           "tnh": list(shape), "dtype": str(dtype)[6:],
           "fwd_kernel": ran["fwd"], "fwd_kernel_expected": want["fwd"],
           "bwd_kernel": ran["bwd"], "bwd_kernel_expected": want["bwd"],
           "fwd_tc_plan": dict(frc.last_fwd_tc_plan),
           "tc_plan": dict(frc.last_tc_plan)}
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
    if tag == "main":
        # the other kernels on the same inputs: the simt backward from the
        # rule's forward's residuals, and the simt forward (with the rule's
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
    if tag == "main" and not bf16:
        row["tf32_models"] = rnn_tf32_models(mode, ins, cot, ref, bound)
        ok = ok and row["tf32_models"]["ok"]
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


def rnn_tf32_models(mode, ins, cot, ref, bound):
    """The float32 bound tells split TF32 from plain TF32: the outputs of
    torch models of the float32 tensor-core kernels' recurrent products,
    the forward's (``fused_{lstm,gru}_fwd_tf32``) on the kernels' inputs
    and the backward's (``fused_{lstm,gru}_bwd_tf32``) on the plain
    forward's residuals, with the three-product split (it must pass) and
    with one TF32 product of operands rounded once (a planted fault: it
    must fail on every output); each output's share of the bound."""
    from mxnet_tpu_torch.ops import fused_gru as fg
    from mxnet_tpu_torch.ops import fused_lstm as fl

    shares = {}
    for products in (3, 1):
        if mode == "lstm":
            fwd = fl.fused_lstm_fwd_tf32(**ins, save=True, products=products)
            bwd = fl.fused_lstm_bwd_tf32(
                ref["acts"], ref["cells"], ref["ys"], ins["h0"], ins["c0"],
                ins["wh"], **cot, products=products)
        else:
            fwd = fg.fused_gru_fwd_tf32(**ins, save=True, products=products)
            bwd = fg.fused_gru_bwd_tf32(ref["acts"], ref["ys"], ins["h0"],
                                        ins["wh"], **cot, products=products)
        names = [k for k in RNN_OUTPUTS["fwd"] if k in ref]
        out = dict(zip(names, (o for o in fwd if o is not None)))
        out.update(zip(RNN_OUTPUTS["bwd"], bwd))
        shares[products] = {
            k: float((o.float() - ref[k].float()).abs().max())
            / max(bound[k], 1e-30)
            for k, o in out.items() if o is not None}
    split = all(v <= 1.0 for v in shares[3].values())
    caught = all(v > 1.0 for v in shares[1].values())
    return {"split_3_share": shares[3], "single_1_share": shares[1],
            "split_passes": split, "single_caught": caught,
            "ok": split and caught}


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
    shape; the bound from this run's shapes.  Each tensor-core kernel (the
    forward and the backward, bf16 or float32) is timed beside the FMA
    kernel on the same inputs in the same run (``_variant="simt"``,
    ``ms_simt``), with its plan (cluster size, CTAs, units a CTA, shared
    memory), its microseconds a step, its ptxas registers and spills and
    the floor of its split barrier.  float32: cuDNN in float32 (TF32 off) beside
    them; the bounds at three TF32 products (495 TFLOP/s), the FMA bound
    (67 TFLOP/s) beside each."""
    from mxnet_tpu_torch import _build
    from mxnet_tpu_torch.ops import fused_gru as fg
    from mxnet_tpu_torch.ops import fused_lstm as fl
    from mxnet_tpu_torch.ops import fused_rnn_cuda as frc

    shape = RNN_SHAPES["main"]
    T, N, H = shape
    f32 = dtype == torch.float32
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

    k_ms, simt_ms, plans, ran, want = {}, {}, {}, {}, {}
    for kind, call in (("fwd", lambda **kw: fwd(**ins, save=True, **kw)),
                       ("bwd", lambda **kw: bwd(*bwd_args, **cot, **kw))):
        k_ms[kind], ran[kind] = timed(call)
        want[kind] = {f"{mode}_{kind}" + ("_f32" if f32 else "")}
        want[f"{kind}_simt"] = {f"{mode}_{kind}_simt"}
        plans[kind] = dict(frc.last_fwd_tc_plan if kind == "fwd"
                           else frc.last_tc_plan)
        simt_ms[kind], ran[f"{kind}_simt"] = timed(
            lambda: call(_variant="simt"))
    frc.launches.update(saved)        # timing launches are not the path's
    if ran != want:
        raise SystemExit(f"rnn_time: {mode} kernel variants not as timed: "
                         f"{ran}")
    floor = time_ms(lambda: frc.barrier_floor_cuda(T, H, DEVICE))
    split_floor = time_ms(lambda: frc.split_barrier_floor_cuda(
        T, N, H, DEVICE))
    p_fwd = time_ms(lambda: p_fwd_fn(**ins, save=True), reps=3, warmup=1)
    p_bwd = time_ms(lambda: p_bwd_fn(*bwd_args, **cot), reps=3, warmup=1)
    # the library yardstick the port never calls: cuDNN's nn.LSTM / nn.GRU
    # in the same dtype (float32 with TF32 off, the port's setting),
    # forward (with its input projection) and its backward alone on a
    # retained graph
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
        rows[name] = {
            "phase": "rnn_time", "kernel": name, "shape": "main",
            "dtype": str(dtype)[6:], "ms": k_ms[kind], "plain_ms": p_ms,
            "library_ms": l_ms, "library_over_kernel": l_ms / k_ms[kind],
            "bound_ms": b_ms, "bound_by": b_by,
            "ops": ops, "bytes": nbytes, "bound_share": b_ms / k_ms[kind],
            "barrier_floor_ms": floor,
            "library": f"cuDNN nn.{cls.__name__} "
                       + ("forward" if kind == "fwd"
                          else "backward alone on a retained graph"),
            "plain_and_library_cover":
                "the plain times cover the recurrence only; the library "
                "times also include the input projection x Wi^T + bi"
                + (" and its gradients" if kind == "bwd" else "")}
        G = _GATES[mode]
        fma_ptxas = ptxas_report(log, f"rnn_{kind}_kernelIf",
                                 ("G",)).get(f"G{G}")
        plan = plans[kind]
        tc = f"{kind}_f32tc" if f32 else f"{kind}_tc"
        tc_kernel = f"rnn_{tc}_kernel"
        rows[name].update({
            "source": f"csrc/fused_rnn_{tc}.cuh",
            "cuda_kernel": f"{tc_kernel}<{G}>",
            "us_per_step": 1e3 * k_ms[kind] / T,
            "ms_simt": simt_ms[kind],
            "simt_over_tc": simt_ms[kind] / k_ms[kind],
            "simt": f"rnn_{kind}_kernel (csrc/fused_rnn.cuh), the same "
                    "inputs through _variant='simt'",
            "cluster_size": plan["C"], "hs": plan["hs"],
            "grid_ctas": plan["grid"], "smem_bytes": plan["smem_bytes"],
            "split_barrier_floor_ms": split_floor,
            "split_barrier_floor_us_per_step": 1e3 * split_floor / T,
            "split_barrier_floor": "the tensor-core kernels' split "
                                   f"barrier alone, {T} arrive/wait pairs "
                                   "on the bf16 LSTM backward's launch",
            "ptxas": ptxas_report(log, tc_kernel, ("G",)).get(f"G{G}")})
        if f32:
            # its products are three TF32 ones: that bound, and the
            # float32-FMA one of the same work beside it
            t_b, t_o = nbytes / PEAK_BYTES_S, 3 * ops / PEAK_TF32_OPS_S
            rows[name].update({
                "bound_ms": 1e3 * max(t_b, t_o),
                "bound_by": "bytes" if t_b >= t_o else "operations",
                "bound_share": 1e3 * max(t_b, t_o) / k_ms[kind],
                "bound_rule": "3 x ops at 495 TFLOP/s (split TF32) vs "
                              "bytes at 3.35 TB/s",
                "bound_fma_ms": b_ms, "bound_fma_by": b_by,
                "bound_fma_rule": "ops at 67 TFLOP/s (float32 FMA) vs "
                                  "bytes at 3.35 TB/s",
                "ptxas_simt": fma_ptxas})
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
    profile = (train_profile(lambda: tr.step(placed)) if mode == "lstm"
               else None)
    lap(f"{mode}_train_profile")
    want = cfg["num_layers"] * steps
    path = {k: v for k, v in launches.items() if k.startswith(mode)}
    # bf16: every forward and backward on the bf16 tensor-core kernels,
    # none on the others
    expected = {k: want if k in (f"{mode}_fwd", f"{mode}_bwd") else 0
                for k in path}
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


# -- the sequence half of the training framework on the card ----------------
# The RNN-op language model of tests/test_rnn.py:124-150 (batch-major
# (N, T) tokens -> Embedding -> SwapAxis -> RNN -> SwapAxis -> Reshape(-1, H)
# -> FullyConnected -> SoftmaxOutput) as a Symbol, at RNN_CFG's width
# (vocabulary 10,000, embedding 512, H 512, 2 layers, batch 32), trained by
# the Module family on gpu(0) in float32, the reference Module's dtype: its
# LSTM and GRU layers run the float32 fused kernels (rnn_fwd_f32tc_kernel<G>
# and rnn_bwd_f32tc_kernel<G>: the "_f32" forward and backward launch
# counters), never the bf16 tensor-core ones.  SGD as examples/lstm_bucketing.py:74-79 (lr 0.01,
# momentum 0.9, wd 1e-5), Xavier.  BucketingModule's buckets are 32, 64 and
# 128 (the default), fed by rnn_io.BucketSentenceIter over a seeded corpus of
# lengths 5-128 that follows examples/rnn_time_major.py:98-102's successor
# rule (the next token is the successor with probability 0.9).
SEQ_BUCKETS = (32, 64, 128)
SEQ_SENTENCES = 480
SEQ_SGD = (("learning_rate", 0.01), ("momentum", 0.9), ("wd", 1e-5))
# One update in each bucket (32, 64, 128 in turn) through the kernels in
# float32 against the same three updates through the eager scan in float64
# (MXNET_TPU_FUSED_RNN=0), parameter by parameter:
#     |p32 - p64| <= 4 2^-24 |p64| + SEQ_AGREE_REL max|p64 - p0|,
# the first term the float32 rounding of p over three updates, the second
# the float32 gradients' error as a share of the tensor's largest update
# (rnn_grad_check's kernels-vs-scan gradient bound, 1e-4 of the largest
# gradient).  The planted fault, the float64 scan with its forget gate's
# recurrent bias dropped, must fail it.  module_family_check holds a
# SequentialModule to the one-Module LM at the same bound.
SEQ_AGREE_REL = 1e-4
# CTCLoss on the card against the port on the CPU, the same float32 inputs:
# max|loss_card - loss_cpu| <= CTC_REL max|loss_cpu|, and the same for the
# gradient with respect to data (float32 log-space sums over T 24 steps in
# another order and another libm)
CTC_REL = 2e-5
CTC_SHAPE = (24, 32, 9)        # examples/speech_ctc.py: T 24, batch 32, 8+1


def seq_sentence(rng, length):
    """``length`` token ids 1..V-1 (0 pads) by the successor rule."""
    V = RNN_CFG["vocab"]
    tok, sent = int(rng.randint(1, V)), []
    for _ in range(length):
        sent.append(tok)
        tok = (tok % (V - 1) + 1 if rng.rand() < 0.9
               else int(rng.randint(1, V)))
    return sent


def seq_corpus(n=SEQ_SENTENCES, seed=7):
    """``n`` sentences of lengths 5-128."""
    rng = np.random.RandomState(seed)
    return [seq_sentence(rng, int(rng.randint(5, SEQ_BUCKETS[-1] + 1)))
            for _ in range(n)]


def seq_lm_body(mode):
    """The LM's body: (N, T) tokens -> Embedding -> SwapAxis -> RNN ->
    SwapAxis -> (N, T, H)."""
    import mxnet_tpu_torch as mt

    V, H, L = RNN_CFG["vocab"], RNN_CFG["hidden"], RNN_CFG["num_layers"]
    emb = mt.sym.Embedding(mt.sym.Variable("data"), input_dim=V,
                           output_dim=H, name="embed")          # (N, T, E)
    rnn = mt.sym.RNN(mt.sym.SwapAxis(emb, dim1=0, dim2=1), state_size=H,
                     num_layers=L, mode=mode, name=mode)       # (T, N, H)
    return mt.sym.SwapAxis(rnn, dim1=0, dim2=1)


def seq_lm_symbol(mode):
    """The LM as tests/test_rnn.py:124-150 builds it: the body, then
    Reshape(-1, H) -> FullyConnected -> SoftmaxOutput over the flattened
    labels."""
    import mxnet_tpu_torch as mt

    V, H = RNN_CFG["vocab"], RNN_CFG["hidden"]
    fc = mt.sym.FullyConnected(mt.sym.Reshape(seq_lm_body(mode),
                                              shape=(-1, H)),
                               num_hidden=V, name="cls")       # (N T, V)
    label = mt.sym.Reshape(mt.sym.Variable("softmax_label"), shape=(-1,))
    return mt.sym.SoftmaxOutput(fc, label, name="softmax")


def seq_lm_parts(mode, T):
    """The LM's body and a head ((N, T, H) -> the vocabulary's softmax,
    (N, V, T)) at sequence length ``T``: the head gives its logits the
    batch axis back (SoftmaxOutput's multi_output over axis 1), so a
    module of it infers its outputs from its data alone and slices its
    data and (N, T) labels on one batch axis."""
    import mxnet_tpu_torch as mt

    V, H = RNN_CFG["vocab"], RNN_CFG["hidden"]
    fc = mt.sym.FullyConnected(
        mt.sym.Reshape(mt.sym.Variable("data"), shape=(-1, H)),
        num_hidden=V, name="cls")                               # (N T, V)
    logits = mt.sym.transpose(mt.sym.Reshape(fc, shape=(-1, T, V)),
                              axes=(0, 2, 1))                   # (N, V, T)
    return seq_lm_body(mode), mt.sym.SoftmaxOutput(
        logits, mt.sym.Variable("softmax_label"), multi_output=True,
        name="softmax")


def seq_bucket_module(params=None, seed=0):
    """A bound, initialised BucketingModule over the LSTM LM with SGD:
    Xavier from ``mt.random.seed(seed)``, or ``params`` (numpy)."""
    import mxnet_tpu_torch as mt

    N, T = RNN_CFG["batch"], SEQ_BUCKETS[-1]
    bm = mt.mod.BucketingModule(
        lambda key: (seq_lm_symbol("lstm"), ["data"], ["softmax_label"]),
        default_bucket_key=T, context=module_ctx())
    bm.bind([("data", (N, T))], [("softmax_label", (N, T))])
    if params is None:
        mt.random.seed(seed)
        bm.init_params(mt.init.Xavier())
    else:
        bm.set_params(params, {})
    bm.init_optimizer(optimizer="sgd", optimizer_params=SEQ_SGD)
    return bm


def seq_batches():
    """The corpus's batches, in BucketSentenceIter's order (seed 0)."""
    import mxnet_tpu_torch as mt

    with module_ctx():
        return list(mt.rnn_io.BucketSentenceIter(
            seq_corpus(), RNN_CFG["batch"], buckets=list(SEQ_BUCKETS),
            seed=0))


@contextlib.contextmanager
def scan_steps(counts, fault=False):
    """Counts the eager scan's steps (``ops.rnn._cell_step``'s step
    calls) in ``counts[0]``; with ``fault``, its LSTM step drops the
    forget gate's recurrent bias (the planted fault)."""
    from mxnet_tpu_torch.ops import rnn as rnn_op

    real = rnn_op._cell_step

    def cell_step(mode, H):
        step = real(mode, H)

        def counted(carry, gx, wh, bh):
            counts[0] += 1
            if fault:
                bh = torch.cat([bh[:H], torch.zeros_like(bh[H:2 * H]),
                                bh[2 * H:]])
            return step(carry, gx, wh, bh)
        return counted

    rnn_op._cell_step = cell_step
    try:
        yield counts
    finally:
        rnn_op._cell_step = real


def seq_step(mod, db):
    mod.forward(db, is_train=True)
    mod.backward()
    mod.update()
    return mod.get_outputs()[0]._data


def seq_launches(before):
    from mxnet_tpu_torch.ops import fused_rnn_cuda as frc

    return {k: v - before[k] for k, v in frc.launches.items()
            if v != before[k]}


def seq_eval_nll(mod, db):
    mod.forward(db, is_train=False)
    return nll_of(mod.get_outputs()[0]._data, db.label[0]._data)


def seq_param_share(got, want, p0):
    """The worst share of SEQ_AGREE_REL's bound over every parameter."""
    worst, worst_name = 0.0, None
    for k in want:
        allowed = (4 * 2.0 ** -24 * np.abs(want[k])
                   + SEQ_AGREE_REL * float(np.abs(want[k] - p0[k]).max()))
        share = float((np.abs(got[k] - want[k])
                       / np.maximum(allowed, 1e-300)).max())
        if share > worst:
            worst, worst_name = share, k
    return worst, worst_name


def seq_reference_updates(p0, batches, fault=False):
    """``batches``' updates in float64 through the eager scan: one
    Executor a bucket, the port's SGD created as ``Module.init_optimizer``
    creates it (rescale 1/N, the Symbol's wd multipliers), applied in
    Module's parameter order."""
    import mxnet_tpu_torch as mt

    N, ctx = RNN_CFG["batch"], module_ctx()
    sym = seq_lm_symbol("lstm")
    args = sym.list_arguments()
    names = [n for n in args if n not in ("data", "softmax_label")]
    W = {n: mt.nd.array(p0[n], ctx=ctx, dtype=np.float64) for n in names}
    optimizer = mt.opt.create(
        "sgd", param_idx2name=dict(enumerate(names)), sym=sym,
        rescale_grad=1.0 / N, **dict(SEQ_SGD))
    updater = mt.opt.get_updater(optimizer)
    env = os.environ.get("MXNET_TPU_FUSED_RNN")
    os.environ["MXNET_TPU_FUSED_RNN"] = "0"
    steps = [0]
    try:
        with scan_steps(steps, fault=fault):
            for db in batches:
                T = db.bucket_key
                exe = sym.simple_bind(
                    ctx, grad_req={n: "write" if n in W else "null"
                                   for n in args},
                    type_dict={n: np.float64 for n in args},
                    data=(N, T), softmax_label=(N, T))
                for n in names:
                    exe.arg_dict[n][:] = W[n]
                exe.arg_dict["data"][:] = db.data[0]
                exe.arg_dict["softmax_label"][:] = db.label[0]
                exe.forward(is_train=True)
                exe.backward()
                for i, n in enumerate(names):
                    updater(i, exe.grad_dict[n], W[n])
    finally:
        if env is None:
            os.environ.pop("MXNET_TPU_FUSED_RNN", None)
        else:
            os.environ["MXNET_TPU_FUSED_RNN"] = env
    if not steps[0]:
        raise SystemExit("seq_reference_updates: the scan did not run")
    return {n: W[n].asnumpy() for n in names}


def bucket_agreement(batches):
    """One update in each bucket through the kernels (float32) against
    the float64 scan, and against the planted fault."""
    firsts = [next(b for b in batches if b.bucket_key == k)
              for k in SEQ_BUCKETS]
    bm = seq_bucket_module(seed=1)
    p0 = {k: v.asnumpy() for k, v in bm.get_params()[0].items()}
    for db in firsts:
        seq_step(bm, db)
    got = {k: v.asnumpy() for k, v in bm.get_params()[0].items()}
    del bm
    want = seq_reference_updates(p0, firsts)
    share, name = seq_param_share(got, want, p0)
    planted, _ = seq_param_share(
        got, seq_reference_updates(p0, firsts, fault=True), p0)
    return {"buckets": list(SEQ_BUCKETS),
            "bound": "|p32 - p64| <= 4 2^-24 |p64| + 1e-4 max|p64 - p0| "
                     "per parameter, one SGD update a bucket",
            "worst_share_of_bound": share, "worst_param": name,
            "planted_fault": "float64 scan with the forget gate's "
                             "recurrent bias dropped",
            "planted_worst_share_of_bound": planted,
            "planted_caught": planted > 1.0,
            "ok": share <= 1.0 and planted > 1.0}


def train_bucketing_main_path():
    """The LSTM LM by BucketingModule over buckets 32, 64 and 128 for one
    pass of the corpus: 2 float32 LSTM forward and 2 backward (split-TF32
    tensor-core) launches a step in every bucket, no bf16
    launch, no scan step; the buckets' arrays alias the default bucket's;
    the held batch's NLL falls; then
    the agreement with the float64 scan, a profile window and a
    Monitor step."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import fused_rnn_cuda as frc

    N = RNN_CFG["batch"]
    torch.cuda.reset_peak_memory_stats()
    batches = seq_batches()
    bm = seq_bucket_module()
    held = next(b for b in batches if b.bucket_key == SEQ_BUCKETS[-1])
    nll_before = seq_eval_nll(bm, held)
    lap("bucketing_setup")
    by_bucket = {k: {"step_ms": [], "launches": []} for k in SEQ_BUCKETS}
    scans = [0]
    torch.cuda.synchronize()
    for name in frc.launches:          # the main path's window opens
        frc.launches[name] = 0
    with scan_steps(scans):
        for db in batches:
            before = dict(frc.launches)
            ts = time.perf_counter()
            seq_step(bm, db)
            torch.cuda.synchronize()
            row = by_bucket[db.bucket_key]
            row["step_ms"].append(1e3 * (time.perf_counter() - ts))
            row["launches"].append(seq_launches(before))
    launches = dict(frc.launches)      # ... and closes
    lap("bucketing_steps")
    nll_after = seq_eval_nll(bm, held)
    steps = len(batches)
    per_step = {"lstm_fwd_f32": 2, "lstm_bwd_f32": 2}
    expected = {k: 0 for k in launches}
    expected.update({k: v * steps for k, v in per_step.items()})
    every_step = all(d == per_step for r in by_bucket.values()
                     for d in r["launches"])
    # aliasing: every bucket's parameter arrays are the default bucket's
    # storage; a switch after the updates reads the trained values
    def ptrs(mod):
        exe = mod._exec_group.execs[0]
        return {n: exe.arg_dict[n]._data.data_ptr() for n in mod._param_names}
    default = bm._buckets[SEQ_BUCKETS[-1]]
    aliased = all(ptrs(m) == ptrs(default) for m in bm._buckets.values())
    seq_step(bm, held)
    trained = {n: default._exec_group.execs[0].arg_dict[n].asnumpy()
               for n in default._param_names}
    bm.switch_bucket(SEQ_BUCKETS[0], [("data", (N, SEQ_BUCKETS[0]))],
                     [("softmax_label", (N, SEQ_BUCKETS[0]))])
    small = bm._curr_module._exec_group.execs[0].arg_dict
    got = bm.get_params()[0]
    switch_sees = all(np.array_equal(small[n].asnumpy(), v)
                      and np.array_equal(got[n].asnumpy(), v)
                      for n, v in trained.items())
    lap("bucketing_checks")
    profile = train_profile(lambda: seq_step(bm, held), counted="rnn")
    lap("bucketing_profile")
    mon = mt.monitor.Monitor(1, pattern=".*weight")
    bm.install_monitor(mon)
    mon.tic()
    seq_step(bm, held)
    stats = mon.toc()
    names = sorted({n for _, n, _ in stats})
    monitor_ok = (names == ["cls_weight", "cls_weight_grad", "embed_weight",
                            "embed_weight_grad"]
                  and all(np.isfinite(v) for _, _, v in stats))
    agree = bucket_agreement(batches)
    lap("bucketing_agreement")
    timed = {k: r["step_ms"][1:] for k, r in by_bucket.items()}
    tokens = sum(N * k * len(v) for k, v in timed.items())
    secs = sum(sum(v) for v in timed.values()) / 1e3
    ok = (launches == expected and every_step and scans[0] == 0
          and aliased and switch_sees and monitor_ok and agree["ok"]
          and bool(np.isfinite(nll_after)) and nll_after < nll_before)
    row = {"phase": "train_bucketing", "dtype": "float32",
           "config": RNN_CFG, "mode": "lstm", "buckets": list(SEQ_BUCKETS),
           "entry": "mod.BucketingModule(sym_gen) over rnn_io."
                    "BucketSentenceIter (bind, init_params(Xavier), "
                    "init_optimizer(sgd 0.01, momentum 0.9, wd 1e-5), "
                    "forward/backward/update)",
           "steps": steps,
           "steps_by_bucket": {k: len(r["step_ms"])
                               for k, r in by_bucket.items()},
           "kernel_launches": launches, "launches_expected": expected,
           "launches_every_step": per_step, "every_step_as_expected":
               every_step, "scan_steps": scans[0],
           "step_ms_by_bucket": {k: r["step_ms"]
                                 for k, r in by_bucket.items()},
           "step_ms_median_by_bucket": {k: statistics.median(v)
                                        for k, v in timed.items() if v},
           "tokens_per_s": tokens / secs if secs else None,
           "nll_held_before": nll_before, "nll_held_after": nll_after,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "aliased_to_default_bucket": aliased,
           "switch_after_update_sees_trained_values": switch_sees,
           "monitor": {"names": names, "stats": len(stats), "ok": monitor_ok},
           "agreement": agree, "profile": profile, "ok": ok}
    emit(row)
    del bm, batches, held
    torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("BucketingModule training failed its checks")
    return row


def seq_rows(n, seed=5):
    """``n`` rows of the successor rule at T 128: tokens and next-token
    labels (numpy float32, as NDArrayIter feeds them)."""
    T = SEQ_BUCKETS[-1]
    rng = np.random.RandomState(seed)
    rows = np.array([seq_sentence(rng, T + 1) for _ in range(n)],
                    np.float32)
    return rows[:, :T], rows[:, 1:]


def train_feedforward_main_path():
    """FeedForward over the GRU LM: fit for one epoch of 3 batches (1
    float32 GRU forward and 1 backward launch a layer and step), then
    predict and score, then a save/load round trip that predicts
    identically."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import fused_rnn_cuda as frc

    N = RNN_CFG["batch"]
    X, y = seq_rows(3 * N)
    mt.random.seed(2)
    ff = mt.model.FeedForward(
        seq_lm_symbol("gru"), ctx=module_ctx(), num_epoch=1, epoch_size=3,
        optimizer="sgd", initializer=mt.init.Xavier(), numpy_batch_size=N,
        **dict(SEQ_SGD))
    torch.cuda.synchronize()
    for name in frc.launches:          # the main path's window opens
        frc.launches[name] = 0
    t0 = time.perf_counter()
    ff.fit(X, y)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(frc.launches)      # ... and closes
    before = dict(frc.launches)
    # predict from an iterator with labels: a module bound without the
    # label's shape cannot infer the label's Reshape (the reference's
    # FeedForward.predict on numpy alone fails there the same way)
    with module_ctx():
        probs = ff.predict(mt.io.NDArrayIter(X[:N], y[:N], N))
    acc = float(ff.score(X, y))
    eval_launches = seq_launches(before)
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "gru_lm")
        ff.save(prefix, 1)
        loaded = mt.model.FeedForward.load(prefix, 1, ctx=module_ctx(),
                                           numpy_batch_size=N)
        with module_ctx():
            again = loaded.predict(mt.io.NDArrayIter(X[:N], y[:N], N))
    steps = 3
    per_layer = {"gru_fwd_f32": RNN_CFG["num_layers"] * steps,
                 "gru_bwd_f32": RNN_CFG["num_layers"] * steps}
    expected = {k: 0 for k in launches}
    expected.update(per_layer)
    same = bool(np.array_equal(probs, again))
    shape = tuple(probs.shape)
    ok = (launches == expected and same and bool(np.isfinite(probs).all())
          and shape == (N * SEQ_BUCKETS[-1], RNN_CFG["vocab"])
          and bool(np.isfinite(acc)))
    row = {"phase": "train_feedforward", "dtype": "float32",
           "config": RNN_CFG, "mode": "gru",
           "entry": "model.FeedForward(sym, ctx=gpu(0), num_epoch=1, "
                    "optimizer='sgd', Xavier).fit(X, y), predict, score, "
                    "save, FeedForward.load",
           "rows": int(X.shape[0]), "steps": steps, "fit_s": fit_s,
           "kernel_launches": launches, "launches_expected": expected,
           "eval_launches": eval_launches, "predict_shape": shape,
           "score_acc": acc, "save_load_predicts_identically": same,
           "ok": ok}
    emit(row)
    del ff, loaded, probs, again
    torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("FeedForward failed its checks")
    return row


def module_family_check():
    """A SequentialModule of the LM's body (Embedding and the LSTM) and
    head (FullyConnected, SoftmaxOutput: take_labels, auto_wiring) against
    the one-Module LM at train_bucketing's width, 3 SGD steps from the
    same parameters and batches: parameters within SEQ_AGREE_REL's
    bound, the kernels launched as in one Module."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import fused_rnn_cuda as frc

    N, T = RNN_CFG["batch"], SEQ_BUCKETS[-1]
    ctx = module_ctx()
    data, label = [("data", (N, T))], [("softmax_label", (N, T))]
    body, head = seq_lm_parts("lstm", T)
    one = mt.mod.Module(head(data=body), context=ctx)
    one.bind(data, label)
    mt.random.seed(3)
    one.init_params(mt.init.Xavier())
    one.init_optimizer(optimizer="sgd", optimizer_params=SEQ_SGD)
    p0 = module_params(one)
    seq = mt.mod.SequentialModule()
    seq.add(mt.mod.Module(body, label_names=[], context=ctx))
    seq.add(mt.mod.Module(head, context=ctx), take_labels=True,
            auto_wiring=True)
    seq.bind(data, label)
    seq.init_params(arg_params=p0)
    seq.init_optimizer(optimizer="sgd", optimizer_params=SEQ_SGD)
    X, y = seq_rows(3 * N, seed=9)
    out_err, launches = [], []
    for i in range(3):
        db = mt.io.DataBatch(
            [mt.nd.array(X[i * N:(i + 1) * N], ctx=ctx)],
            [mt.nd.array(y[i * N:(i + 1) * N], ctx=ctx)])
        a = seq_step(one, db)
        before = dict(frc.launches)
        b = seq_step(seq, db)
        launches.append(seq_launches(before))
        out_err.append(float((a - b).abs().max()))
    got = {k: v.asnumpy() for k, v in seq.get_params()[0].items()}
    share, name = seq_param_share(got, module_params(one), p0)
    per_step = {"lstm_fwd_f32": 2, "lstm_bwd_f32": 2}
    ok = (share <= 1.0 and sorted(got) == sorted(p0)
          and all(d == per_step for d in launches)
          and all(np.isfinite(out_err)))
    emit({"phase": "module_family_check", "dtype": "float32", "steps": 3,
          "modules": ["Module(Embedding, LSTM)",
                      "Module(FullyConnected, SoftmaxOutput): take_labels, "
                      "auto_wiring"],
          "out_max_abs_err": out_err, "launches_by_step": launches,
          "bound": "|p_seq - p_one| <= 4 2^-24 |p_one| + 1e-4 "
                   "max|p_one - p0| per parameter",
          "param_worst_share_of_bound": share, "worst_param": name,
          "ok": ok})
    del one, seq
    torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("SequentialModule and Module disagree")


def ctc_card_check():
    """CTCLoss's forward and data gradient through an Executor on the
    card against the port on the CPU at the same float32 inputs: blank
    first (padded labels, repeated labels) and blank last (label and data
    lengths)."""
    import mxnet_tpu_torch as mt

    T, N, C = CTC_SHAPE
    rng = np.random.RandomState(11)
    x = rng.standard_normal((T, N, C)).astype(np.float32)
    L = 4
    first = rng.randint(1, C, (N, L)).astype(np.float32)
    first[::3, 1] = first[::3, 0]                 # repeated labels
    first[1::4, 2:] = -1                          # padded tails
    last = rng.randint(0, C - 1, (N, L)).astype(np.float32)
    last[::2, 3] = last[::2, 2]
    label_lens = rng.randint(1, L + 1, N).astype(np.float32)
    data_lens = rng.randint(T // 2, T + 1, N).astype(np.float32)
    cases = {"blank_first": ({"blank_label": "first"}, first, {}),
             "blank_last": ({"blank_label": "last", "use_label_lengths": True,
                             "use_data_lengths": True}, last,
                            {"data_lengths": data_lens,
                             "label_lengths": label_lens})}
    rows, ok = {}, True
    for tag, (kw, lab, extra) in cases.items():
        sym = mt.sym.ctc_loss(*[mt.sym.Variable(n) for n in (
            "data", "label", *extra)], **kw)
        res = {}
        for where, ctx in (("card", module_ctx()), ("cpu", mt.cpu())):
            arrays = {"data": x, "label": lab, **extra}
            exe = sym.simple_bind(
                ctx, grad_req={n: "write" if n == "data" else "null"
                               for n in sym.list_arguments()},
                **{k: v.shape for k, v in arrays.items()})
            for k, v in arrays.items():
                exe.arg_dict[k][:] = v
            loss = exe.forward(is_train=True)[0].asnumpy()
            exe.backward()
            res[where] = (loss, exe.grad_dict["data"].asnumpy())
        (l_card, g_card), (l_cpu, g_cpu) = res["card"], res["cpu"]
        loss_share = float(np.abs(l_card - l_cpu).max()
                           / (CTC_REL * np.abs(l_cpu).max()))
        grad_share = float(np.abs(g_card - g_cpu).max()
                           / (CTC_REL * np.abs(g_cpu).max()))
        good = (loss_share <= 1.0 and grad_share <= 1.0
                and bool(np.isfinite(l_card).all())
                and bool(np.isfinite(g_card).all()))
        rows[tag] = {"loss_share_of_bound": loss_share,
                     "grad_share_of_bound": grad_share,
                     "loss_mean": float(l_cpu.mean()), "ok": good}
        ok = ok and good
    emit({"phase": "ctc_card_check", "shape_TNC": CTC_SHAPE,
          "bound": "max|card - cpu| <= 2e-5 max|cpu|, loss and data "
                   "gradient", "cases": rows, "ok": ok})
    if not ok:
        raise SystemExit("CTCLoss: card vs CPU disagree")


# -- the vision half: Convolution, BatchNorm, Pooling through Module --------
# vision_small_check's model: ResNet-18 with the cifar stem, 10 classes,
# 32 x 32 images, batch 8, NCHW (and NHWC from the same OIHW weights)
VISION_SMALL = dict(num_classes=10, num_layers=18, image_shape=(3, 32, 32))
VISION_SMALL_BATCH = 8
# card against the port's CPU path in float64 from the same parameters
# and batch, on the branches the card took at every ReLU (the reference
# replays the card's masks: an input within float32 noise of 0 takes
# either branch, and one element's flip moves a conv's weight gradient
# by a few per cent at this size): probabilities and moving statistics
# within VISION_OUT_REL of each one's largest magnitude, each parameter's
# gradient within VISION_GRAD_REL of its largest.  The gradient bound is
# 5x the flash checks' GRAD_REL: with benchmark off cuDNN's heuristics
# take Winograd F(4x4, 3x3) weight-gradient kernels (winograd_nonfused)
# here, whose float32 error is about ten times a direct sum's (on an
# H100: 2.2e-5 of the largest gradient; the CPU's direct sums 2.5e-6)
VISION_OUT_REL = 1e-5
VISION_GRAD_REL = 1e-4
# train_vision: bench.py:218-258 and examples/train_imagenet.py (its
# synthetic mode, through examples/common.py's FeedForward): ResNet-50,
# 1000 classes, 224 x 224, NCHW, float32, batch 128, 8 batches, SGD 0.1,
# momentum 0.9, wd 1e-4, Xavier(factor_type="in", magnitude=2.34)
VISION_CFG = dict(num_classes=1000, num_layers=50, image_shape=(3, 224, 224),
                  batch=128, batches=8, warmup=2)
VISION_SGD = dict(learning_rate=0.1, momentum=0.9, wd=1e-4)


def vision_symbol(cfg, layout="NCHW"):
    import mxnet_tpu_torch as mt

    with mt.sym.NameManager():
        return mt.models.resnet(num_classes=cfg["num_classes"],
                                num_layers=cfg["num_layers"],
                                image_shape=cfg["image_shape"], layout=layout)


def vision_module(cfg, batch, ctx, layout="NCHW", params=None, seed=0):
    """A bound ResNet Module with SGD: Xavier(in, 2.34) from
    ``mt.random.seed(seed)``, or ``params`` = (arg, aux) NDArray dicts."""
    import mxnet_tpu_torch as mt

    shape = (batch,) + tuple(cfg["image_shape"])
    if layout == "NHWC":
        shape = (batch,) + shape[2:] + shape[1:2]
    mod = mt.mod.Module(vision_symbol(cfg, layout), context=ctx)
    mod.bind([("data", shape)], [("softmax_label", (batch,))])
    if params is None:
        mt.random.seed(seed)
        mod.init_params(mt.init.Xavier(factor_type="in", magnitude=2.34))
    else:
        mod.set_params(*params)
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params=tuple(VISION_SGD.items()))
    return mod


def vision_batch(cfg, batch, ctx, layout="NCHW", seed=0):
    import mxnet_tpu_torch as mt

    rng = np.random.RandomState(seed)
    x = rng.standard_normal((batch,) + tuple(cfg["image_shape"])).astype(
        np.float32)
    if layout == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    y = rng.randint(0, cfg["num_classes"], batch).astype(np.float32)
    return mt.io.DataBatch([mt.nd.array(x, ctx=ctx)],
                           [mt.nd.array(y, ctx=ctx)])


def _share(got, want, rel):
    """max |got - want| over ``rel`` times max |want|."""
    return float(np.abs(got - want).max()
                 / max(rel * float(np.abs(want).max()), 1e-30))


@contextlib.contextmanager
def torch_convention_batchnorm():
    """The planted fault: BatchNorm's moving statistics updated as
    ``F.batch_norm`` updates its running ones (the unbiased variance and
    ``new = (1 - m) old + m batch``); the outputs are unchanged."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import nn as port_nn

    def forward(self, params, inputs, aux, train, key):
        x, gamma, beta = inputs
        if params.fix_gamma:
            gamma = torch.ones_like(gamma)
        rm, rv = aux[0].clone(), aux[1].clone()
        y = F.batch_norm(x, rm, rv, gamma, beta, training=True,
                         momentum=params.momentum, eps=params.eps)
        return [y], [rm, rv]

    saved = port_nn.BatchNormOp.forward
    port_nn.BatchNormOp.forward = forward
    try:
        yield
    finally:
        port_nn.BatchNormOp.forward = saved


@contextlib.contextmanager
def relu_branches(masks, replay=False):
    """Every ReLU of the graph records its branch mask (``x >= 0``, the
    gradient's) into ``masks``, in the executor's order; with ``replay``
    it takes the recorded masks instead, ``x * mask`` (the same branch
    on another device or dtype)."""
    from mxnet_tpu_torch.ops import nn as port_nn

    saved = port_nn.ActivationOp.forward
    replayed = iter(masks)

    def forward(self, params, inputs, aux, train, key):
        if params.act_type != "relu":
            return saved(self, params, inputs, aux, train, key)
        x = inputs[0]
        if replay:
            return [x * next(replayed).to(x.device, x.dtype)], []
        masks.append((x >= 0).detach().cpu())
        return saved(self, params, inputs, aux, train, key)

    port_nn.ActivationOp.forward = forward
    try:
        yield
    finally:
        port_nn.ActivationOp.forward = saved


def vision_fwd_bwd(mod, db, masks=None):
    """One training forward and backward (its ReLU branches recorded
    into ``masks``): the probabilities, every parameter's gradient and
    every moving statistic after it."""
    with relu_branches([] if masks is None else masks):
        mod.forward(db, is_train=True)
        mod.backward()
    exe = mod._exec_group.execs[0]
    return (mod.get_outputs()[0].asnumpy(),
            {k: exe.grad_dict[k].asnumpy() for k in mod._param_names},
            {k: v.asnumpy() for k, v in exe.aux_dict.items()})


def vision_float64(cfg, layout, params, db, masks=None):
    """The port's CPU path in float64: the same graph bound with float64
    arrays, ``params`` and ``db``'s arrays cast up; a training forward
    and backward on ``masks``' ReLU branches, or, without masks, an
    inference forward.  (probabilities, gradients, moving statistics)."""
    import mxnet_tpu_torch as mt

    net = vision_symbol(cfg, layout)
    x, y = db.data[0].asnumpy(), db.label[0].asnumpy()
    with mt.cpu():
        exe = net.simple_bind(
            mt.cpu(), type_dict=dict.fromkeys(net.list_arguments(),
                                              np.float64),
            data=x.shape, softmax_label=y.shape)
        for src, dst in ((params[0], exe.arg_dict), (params[1],
                                                     exe.aux_dict)):
            for k, v in src.items():
                dst[k][:] = v.asnumpy().astype(np.float64)
        exe.arg_dict["data"][:] = x.astype(np.float64)
        exe.arg_dict["softmax_label"][:] = y.astype(np.float64)
        if masks is None:
            return exe.forward(is_train=False)[0].asnumpy(), {}, {}
        with relu_branches(masks, replay=True):
            out = exe.forward(is_train=True)[0].asnumpy()
            exe.backward()
        return (out, {k: exe.grad_dict[k].asnumpy() for k in params[0]},
                {k: v.asnumpy() for k, v in exe.aux_dict.items()})


def vision_shares(got, want):
    """Worst shares of the bounds: probabilities, gradients (by
    parameter), moving statistics."""
    return {"out": _share(got[0], want[0], VISION_OUT_REL),
            "grad": max(_share(got[1][k], want[1][k], VISION_GRAD_REL)
                        for k in want[1]),
            "aux": max(_share(got[2][k], want[2][k], VISION_OUT_REL)
                       for k in want[2])}


def vision_small_check():
    """ResNet-18 (cifar stem, 10 classes, 32 x 32, batch 8) through Module
    on the card from Xavier parameters, held to the port's CPU path in
    float64 on the card's ReLU branches: the probabilities, every
    gradient and every moving statistic after one training forward, then
    an inference forward on the moving statistics; the same net in NHWC
    on the card (the same OIHW weights) held the same way; the port's
    CPU path in float32 held the same way; the NLL of one seeded batch
    falling over 5 SGD steps; a Module.load round trip after them giving
    bit-identical inference outputs; and the planted fault (moving
    statistics by F.batch_norm's rule) failing the moving-statistic
    bound.  Beside them, not judged: the card's shares with cuDNN allowed
    TF32 for one run (``tf32_on``), which shows what the bounds tell
    apart."""
    import mxnet_tpu_torch as mt

    cfg, B = VISION_SMALL, VISION_SMALL_BATCH
    ctx = module_ctx()
    card = vision_module(cfg, B, ctx, seed=4)
    args, auxs = card.get_params()
    params = ({k: v.copy() for k, v in args.items()},
              {k: v.copy() for k, v in auxs.items()})
    shares = {}
    for tag, layout, where in (("card", "NCHW", ctx),
                               ("card_nhwc", "NHWC", ctx),
                               ("cpu_float32", "NCHW", mt.cpu()),
                               ("tf32_on", "NCHW", ctx)):
        mod = card if tag == "card" else vision_module(
            cfg, B, where, layout=layout, params=params)
        db = vision_batch(cfg, B, where, layout=layout, seed=5)
        masks = []
        torch.backends.cudnn.allow_tf32 = tag == "tf32_on"
        try:
            got = vision_fwd_bwd(mod, db, masks)
        finally:
            torch.backends.cudnn.allow_tf32 = False
        want = vision_float64(cfg, layout, params, db, masks)
        shares[tag] = vision_shares(got, want)
        if tag == "card":
            moved = all(not np.array_equal(got[2][k], params[1][k].asnumpy())
                        for k in got[2])
            finite = bool(np.isfinite(got[0]).all())
            want_aux = want[2]
    # inference on the moving statistics after that training forward
    db = vision_batch(cfg, B, ctx, seed=6)
    card.forward(db, is_train=False)
    after = ({k: v.copy() for k, v in params[0].items()},
             {k: mt.nd.array(v, ctx=mt.cpu()) for k, v in want_aux.items()})
    infer_share = _share(card.get_outputs()[0].asnumpy(),
                         vision_float64(cfg, "NCHW", after, db)[0],
                         VISION_OUT_REL)
    # the planted fault: torch's running-statistic rule on the card
    with torch_convention_batchnorm():
        faulty = vision_module(cfg, B, ctx, params=params)
        _, _, a_f = vision_fwd_bwd(faulty, vision_batch(cfg, B, ctx, seed=5))
    planted_share = max(_share(a_f[k], want_aux[k], VISION_OUT_REL)
                        for k in want_aux)
    # 5 SGD steps on one seeded batch
    db = vision_batch(cfg, B, ctx, seed=7)
    labels = db.label[0]._data
    nll = []
    for _ in range(5):
        card.forward(db, is_train=True)
        card.backward()
        card.update()
        nll.append(nll_of(card.get_outputs()[0]._data, labels))
    # Module.load round trip after the steps (an update marks the
    # module's parameters for the sync that save_checkpoint reads, as
    # the reference's does), inference bit for bit
    db = vision_batch(cfg, B, ctx, seed=6)
    card.forward(db, is_train=False)
    want = card.get_outputs()[0].asnumpy()
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "resnet18")
        card.save_checkpoint(prefix, 1)
        loaded = mt.mod.Module.load(prefix, 1, context=ctx)
    loaded.bind([("data", (B,) + cfg["image_shape"])],
                [("softmax_label", (B,))], for_training=False)
    loaded.forward(db, is_train=False)
    same = bool(np.array_equal(loaded.get_outputs()[0].asnumpy(), want))
    ok = (all(v <= 1.0 for tag, sh in shares.items() if tag != "tf32_on"
              for v in sh.values())
          and infer_share <= 1.0 and moved and finite and same
          and planted_share > 1.0 and bool(np.isfinite(nll).all())
          and nll[-1] < nll[0])
    emit({"phase": "vision_small_check", "config": cfg, "batch": B,
          "dtype": "float32",
          "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                   "cudnn": torch.backends.cudnn.allow_tf32},
          "shares_of_bound_vs_cpu_float64": shares,
          "moving_stats_moved": moved,
          "inference_share_of_bound": infer_share,
          "planted_torch_rule_moving_stats_share": planted_share,
          "checkpoint_round_trip_identical": same, "sgd_nll": nll,
          "bound": "against the port's CPU path in float64 on the same "
                   "ReLU branches: probabilities and moving statistics "
                   "max|got - want| <= 1e-5 max|want|; gradients 1e-4 "
                   "max|want| per param; the planted fault must exceed "
                   "the moving-statistic bound; tf32_on is reported "
                   "(cuDNN allowed TF32 for one run), not judged",
          "ok": ok})
    del card, loaded, faulty, mod
    torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("vision: the card or the CPU against float64, the "
                         "checkpoint or the planted BatchNorm fault check "
                         "failed")


# host ranges whose kernels vision_profile counts by the range: the
# _BNTrain autograd Function (forward and backward) and the convolution
# operators, forward and backward
VISION_RANGES = {"_BNTrain": "batchnorm", "aten::cudnn_convolution": "conv",
                 "aten::convolution_backward": "conv"}


def range_kinds(logdir, markers):
    """The kernels of the newest trace under ``logdir``, those launched
    inside a host range whose name holds a key of ``markers`` mapped
    ``{(name, ts): kind}`` (the kind of a range holding the launch), and whether every kernel launch the host
    recorded reached the trace as a kernel and every kernel has its
    launch: ``(kinds, kernels, complete)``."""
    import gzip

    path = sorted(glob.glob(os.path.join(logdir, "plugins", "profile", "*",
                                         "*.trace.json.gz")),
                  key=os.path.getmtime)[-1]
    with gzip.open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    ranges = collections.defaultdict(list)
    launches, kernels = {}, []
    for e in events:
        cat, name = e.get("cat"), e.get("name", "")
        if cat in ("cpu_op", "user_annotation"):
            # operators, and the port's record_function ranges
            for key, kind in markers.items():
                if key in name:
                    ranges[e["pid"], e["tid"]].append(
                        (e["ts"], e["ts"] + e.get("dur", 0), kind))
        elif cat in ("cuda_runtime", "cuda_driver") and "LaunchKernel" in name:
            launches[e.get("args", {}).get("correlation")] = e
        elif cat == "kernel":
            kernels.append(e)
    kinds = {}
    for k in kernels:
        launch = launches.get(k.get("args", {}).get("correlation"))
        if launch is None:
            continue
        for t0, t1, kind in ranges[launch["pid"], launch["tid"]]:
            if t0 <= launch["ts"] <= t1:
                kinds[k["name"], k["ts"]] = kind
                break
    corrs = {k.get("args", {}).get("correlation") for k in kernels}
    return kinds, kernels, corrs == set(launches)


def vision_profile(step, steps=2, ranges=VISION_RANGES):
    """Device ms a step by kind over ``steps`` more calls of ``step``
    (torch.profiler): every kernel launched inside a host range of
    ``ranges`` by that range (the port's BatchNorm, forward and
    backward: its reductions and elementwise passes; cuDNN's
    convolutions: their GEMM, FFT and layout kernels too), the rest by
    ``_kernel_kind`` (pool, matmul, elementwise, ...); the device's busy
    share of the window's wall time; the traced kernel names holding
    ``tf32``; and ``trace_complete``."""
    from mxnet_tpu_torch import profiler

    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as logdir:
        with profiler.trace(logdir):
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        by_range, kernels, complete = range_kinds(logdir, ranges)
    kinds, instances, by_name = {}, {}, {}
    for k in kernels:
        kind = (by_range.get((k["name"], k["ts"]))
                or _kernel_kind(k["name"]))
        ms = k.get("dur", 0) / 1e3 / steps
        kinds[kind] = kinds.get(kind, 0.0) + ms
        instances[kind] = instances.get(kind, 0) + 1
        by_name[k["name"]] = by_name.get(k["name"], 0.0) + ms
    if not complete:
        print("vision_profile: trace incomplete", file=sys.stderr)
    device_ms = sum(kinds.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"steps": steps, "wall_ms_per_step": wall_ms / steps,
            "device_ms_per_step": device_ms,
            "device_busy_share": device_ms * steps / wall_ms,
            "ms_per_step_by_kind": kinds,
            "kernels_traced_by_kind": instances,
            "tf32_kernels": sorted(n for n in by_name if "tf32" in n.lower()),
            "trace_complete": complete,
            "top_kernels_ms_per_step": [(n[:120], ms) for n, ms in top]}


class _StepClock:
    """A batch_end_callback: the card synchronised and the host clock
    read at the end of every batch."""

    def __init__(self):
        self.stamps = [time.perf_counter()]

    def __call__(self, param):
        torch.cuda.synchronize()
        self.stamps.append(time.perf_counter())


def train_vision_main_path():
    """ResNet-50 (1000 classes, 224 x 224, NCHW, float32) trained by
    FeedForward.fit over examples/train_imagenet.py's synthetic iterator
    (standard-normal images, random labels, seed 0, 8 batches of 128), as
    examples/common.py builds it: SGD 0.1, momentum 0.9, wd 1e-4,
    Xavier(in, 2.34), kvstore "local", Speedometer.  Images/s and step ms
    after the warm-up batches, peak memory, a profile window of two more
    Module steps by kind, FLOP/s against the float32 FMA peak; every
    parameter and moving statistic finite and on the card, every
    BatchNorm's moving statistics moved, no TF32 kernel traced, no flash
    or fused-RNN launch."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import flash_attention_cuda as fac
    from mxnet_tpu_torch.ops import fused_rnn_cuda as frc

    cfg, B = VISION_CFG, VISION_CFG["batch"]
    net = vision_symbol(cfg)
    rng = np.random.RandomState(0)
    n = B * cfg["batches"]
    X = rng.standard_normal((n,) + tuple(cfg["image_shape"])).astype(
        np.float32)
    y = rng.randint(0, cfg["num_classes"], n).astype(np.float32)
    train = mt.io.NDArrayIter(X, y, B)
    del X
    mt.random.seed(0)
    ff = mt.model.FeedForward(
        net, ctx=module_ctx(), num_epoch=1, optimizer="sgd",
        initializer=mt.init.Xavier(factor_type="in", magnitude=2.34),
        **VISION_SGD)
    lap("vision_train_setup")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = (fac.launches, frc.launches)
    before = [dict(c) for c in counters]
    clock = _StepClock()
    speed = mt.callback.Speedometer(B, 2)
    ff.fit(train, kvstore="local", batch_end_callback=[speed, clock])
    torch.cuda.synchronize()
    moved_launches = {k: c[k] - b[k] for c, b in zip(counters, before)
                      for k in c if c[k] != b[k]}
    steps = np.diff(clock.stamps) * 1e3
    timed = steps[cfg["warmup"]:]
    images_s = B * len(timed) / (timed.sum() / 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    lap("vision_train_fit")
    mod = ff._module
    exe = mod._exec_group.execs[0]
    on_card = all(a._data.device.type == torch.device(DEVICE).type
                  for a in [*exe.arg_dict.values(), *exe.aux_dict.values()])
    finite = all(bool(np.isfinite(v.asnumpy()).all())
                 for v in [*ff.arg_params.values(), *ff.aux_params.values()])
    bn_names = [k[:-len("_moving_mean")] for k in ff.aux_params
                if k.endswith("_moving_mean")]
    bn_moved = all(
        bool(np.abs(ff.aux_params[k + "_moving_mean"].asnumpy()).max() > 0)
        and bool(np.abs(ff.aux_params[k + "_moving_var"].asnumpy()
                        - 1.0).max() > 0) for k in bn_names)
    train.reset()
    db = next(iter(train))

    def step():
        mod.forward_backward(db)
        mod.update()

    profile = vision_profile(step)
    lap("vision_train_profile")
    fwd_flops = mt.flops.count_flops(
        net, data=(B,) + tuple(cfg["image_shape"])) / B
    flops_s = 3 * fwd_flops * images_s
    probs = mod.get_outputs()[0].asnumpy()
    ok = (on_card and finite and bn_moved and not moved_launches
          and not profile["tf32_kernels"] and bool(np.isfinite(probs).all())
          and probs.shape == (B, cfg["num_classes"]))
    row = {"phase": "train_vision", "dtype": "float32",
           "config": {k: cfg[k] for k in ("num_classes", "num_layers",
                                          "image_shape")},
           "layout": "NCHW", "batch": B, "batches": cfg["batches"],
           "entry": "models.resnet + model.FeedForward(ctx=gpu(0), sgd 0.1, "
                    "momentum 0.9, wd 1e-4, Xavier(in, 2.34)).fit("
                    "io.NDArrayIter, kvstore='local', Speedometer)",
           "warmup_batches": cfg["warmup"], "step_ms": steps.tolist(),
           "step_ms_median": float(np.median(timed)),
           "images_per_s": images_s,
           "speedometer_last_samples_per_s": speed.last_speed,
           "peak_mem_gib": peak, "profile": profile,
           "forward_gflops_per_image": fwd_flops / 1e9,
           "train_tflops_per_s_at_3x_forward": flops_s / 1e12,
           "share_of_float32_fma_peak": flops_s / PEAK_OPS_S[torch.float32],
           "cudnn_benchmark": torch.backends.cudnn.benchmark,
           "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                    "cudnn": torch.backends.cudnn.allow_tf32},
           "params_on_card": on_card, "params_finite": finite,
           "batchnorm_layers": len(bn_names),
           "batchnorm_moving_stats_moved": bn_moved,
           "flash_rnn_launches_moved": moved_launches, "ok": ok}
    emit(row)
    del ff, mod, exe, train, db
    torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("ResNet-50 FeedForward training failed its checks")
    return row


# -- the rest of A15b-2: SSD, int8 inference, Custom ops, serving from a
# Symbol ---------------------------------------------------------------------
# train_ssd: examples/train_ssd.py at the reference's width (SSD-300 over
# VGG16-reduced, 20 classes, filter_scale 1: 8028 anchors), float32 with
# TF32 off, NCHW, batch 32 (the example's default is 8: 32 keeps the
# matching pass at 8028 x 32), its synthetic_det_iter (64 images from
# RandomState(0), unshuffled) over 5 epochs: 10 batches, the first 2 the
# warm-up; SGD 0.004, momentum 0.9, wd 5e-4,
# Mixed([relu4_3_scale -> Constant(20), Xavier])
SSD_CFG = dict(num_classes=20, filter_scale=1, data_shape=300, batch=32,
               images=64, epochs=5, warmup=2)
SSD_SGD = dict(learning_rate=0.004, momentum=0.9, wd=5e-4)
# detect_small_check and the card tests: the same graph at filter_scale 16,
# batch 2
SSD_SMALL = dict(num_classes=20, filter_scale=16, data_shape=300, batch=2)
# the multibox ops as models/ssd.py's get_symbol calls them
SSD_TARGET_KW = dict(overlap_threshold=0.5, ignore_label=-1,
                     negative_mining_ratio=3.0, minimum_negative_samples=0,
                     negative_mining_thresh=0.5)
SSD_DET_KW = dict(nms_threshold=0.5, clip=True, nms_topk=400)
SSD_HEADS = ("multibox_loc_pred_output", "multibox_cls_pred_output",
             "multibox_anchors_output")
# profile kinds by host range: the multibox matching and the NMS loop
DETECT_RANGES = {**VISION_RANGES, "multibox_target": "multibox_target",
                 "nms": "nms"}
# quant_check: examples/quantize_resnet.py (ResNet-18, 1000 classes,
# 32 x 32 images, batch 8, weights N(0, 0.05^2), 4 calibration batches
# U(-1, 1), the stem conv0 excluded); infer_int8: ResNet-50 at 224 x 224,
# batch 32 (Xavier(in, 2.34) weights, moving statistics 0 and 1), float
# against weight-only against calibrated int8
QUANT_SMALL = dict(num_classes=1000, num_layers=18, image_shape=(3, 32, 32),
                   batch=8)
QUANT_CFG = dict(num_classes=1000, num_layers=50, image_shape=(3, 224, 224),
                 batch=32, warmup=2, reps=10)
# custom_op_check: examples/numpy_ops.py's MLP (784-128-10) and data
# (RandomState(0), the label's column lifted by 2), batch 100, 5 batches,
# SGD 0.1 with momentum 0.9; the custom softmaxes' parameters after the
# epoch within 1e-4 of each one's largest of the built-in SoftmaxOutput's
CUSTOM_N, CUSTOM_BATCH, CUSTOM_REL = 500, 100, 1e-4
# serve_symbol: the train_module model (TRAIN_CFG) trained 3 Module steps
# at batch 4, served from its checkpoint at the serve engines' sizes
SYMBOL_STEPS, SYMBOL_BATCH = 3, 4


def ssd_symbol(cfg, mode):
    import mxnet_tpu_torch as mt

    with mt.sym.NameManager():
        return mt.models.ssd(num_classes=cfg["num_classes"], mode=mode,
                             filter_scale=cfg["filter_scale"])


def ssd_shape(cfg, batch):
    return (batch, 3, cfg["data_shape"], cfg["data_shape"])


def synthetic_det(cfg, n, seed=0):
    """examples/train_ssd.py's synthetic_det_iter data: standard-normal
    images, then 1-3 boxes an image (class, corners in [0, 1]) padded to
    4 rows of class -1, from RandomState(seed)."""
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((n, 3, cfg["data_shape"],
                             cfg["data_shape"])).astype(np.float32)
    labels = np.full((n, 4, 5), -1.0, np.float32)
    for i in range(n):
        for b in range(rng.randint(1, 4)):
            cls = rng.randint(0, cfg["num_classes"])
            x1, y1 = rng.uniform(0, 0.6, 2)
            w, h = rng.uniform(0.2, 0.4, 2)
            labels[i, b] = [cls, x1, y1, min(x1 + w, 1.0), min(y1 + h, 1.0)]
    return X, labels


def ssd_initializer():
    """relu4_3's learned L2-norm scale at 20, everything else Xavier
    (examples/train_ssd.py)."""
    import mxnet_tpu_torch as mt

    return mt.init.Mixed(["relu4_3_scale", ".*"],
                         [mt.init.Constant(20.0), mt.init.Xavier()])


def ssd_module(cfg, batch, ctx, params=None, seed=0):
    """A bound SSD training Module with SGD (``SSD_SGD``): the example's
    initializer from ``mt.random.seed(seed)``, or ``params``."""
    import mxnet_tpu_torch as mt

    mod = mt.mod.Module(ssd_symbol(cfg, "train"), data_names=["data"],
                        label_names=["label"], context=ctx)
    mod.bind([("data", ssd_shape(cfg, batch))], [("label", (batch, 4, 5))])
    if params is None:
        mt.random.seed(seed)
        mod.init_params(ssd_initializer())
    else:
        mod.set_params(*params)
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params=tuple(SSD_SGD.items()))
    return mod


def ssd_batch(cfg, batch, ctx, seed=0):
    import mxnet_tpu_torch as mt

    X, labels = synthetic_det(cfg, batch, seed)
    return mt.io.DataBatch([mt.nd.array(X, ctx=ctx)],
                           [mt.nd.array(labels, ctx=ctx)])


def ssd_losses(outputs):
    """0-dim tensors (NLL over the anchors the targets keep, loc loss an
    image) of a training forward's outputs (cls_prob, loc_loss,
    cls_label), left on the device."""
    prob, loc, label = (o._data for o in outputs)
    keep = label >= 0
    p = prob.float().gather(1, label.clamp_min(0).long()[:, None])[:, 0]
    nll = -(torch.log(p.clamp_min(1e-30)) * keep).sum() / keep.sum()
    return nll, loc.float().sum() / loc.shape[0]


def ssd_heads(cfg, params, data, ctx):
    """The SSD graph's loc_preds, cls_preds and anchors (``SSD_HEADS``)
    from ``params`` and ``data`` on ``ctx``: NDArrays."""
    import mxnet_tpu_torch as mt

    internals = ssd_symbol(cfg, "train").get_internals()
    group = mt.sym.Group([internals[n] for n in SSD_HEADS])
    with ctx:
        exe = group.simple_bind(ctx, grad_req="null", data=data.shape)
        for k, v in params[0].items():
            if k in exe.arg_dict:
                exe.arg_dict[k][:] = v
        exe.arg_dict["data"][:] = data
        return exe.forward(is_train=False)


def listed(out):
    """An op call's output (one NDArray or a list) as a list of numpy
    arrays."""
    return [o.asnumpy() for o in (out if isinstance(out, (list, tuple))
                                  else [out])]


def card_and_cpu(fn, inputs):
    """``fn`` on NDArrays ``inputs`` and again on their CPU copies:
    (outputs as numpy, the CPU's as numpy, bit-equal)."""
    import mxnet_tpu_torch as mt

    got = listed(fn(*inputs))
    with mt.cpu():
        want = listed(fn(*[mt.nd.array(a.asnumpy(), ctx=mt.cpu())
                           for a in inputs]))
    same = all(g.dtype == w.dtype and np.array_equal(g, w)
               for g, w in zip(got, want))
    return got, want, same


def unstable_descending(score):
    """An unstable sort's order at ties: equal scores in reverse index
    order (the planted fault for every multibox ranking)."""
    n = score.shape[1]
    return (n - 1) - torch.argsort(-score.flip(1), dim=1, stable=True)


def first_writer_claim(best_anchor, n_anchor):
    """The claim with the lowest gt index winning a shared anchor (the
    planted fault for MultiBoxTarget's bipartite claim)."""
    N, M = best_anchor.shape
    dev = best_anchor.device
    claimed = torch.full((N, n_anchor + 1), M, dtype=torch.long, device=dev)
    claimed = claimed.scatter_reduce(
        1, best_anchor, torch.arange(M, device=dev).expand(N, M),
        "amin")[:, :n_anchor]
    return torch.where(claimed < M, claimed, torch.full_like(claimed, -1))


@contextlib.contextmanager
def planted_multibox(name, fn):
    """``ops.multibox.<name>`` replaced by ``fn`` inside the block."""
    from mxnet_tpu_torch.ops import multibox

    saved = getattr(multibox, name)
    setattr(multibox, name, fn)
    try:
        yield
    finally:
        setattr(multibox, name, saved)


@contextlib.contextmanager
def multibox_targets(records, replay=False):
    """MultiBoxTarget records its outputs into ``records``; with
    ``replay`` it returns the recorded ones instead (on the run's device
    and dtype): the card's matching decisions replayed on the CPU in
    float64, as the ReLU branches are."""
    from mxnet_tpu_torch.ops import multibox

    op = multibox.MultiBoxTargetOp
    saved = op.forward
    replayed = iter(records)

    def forward(self, params, inputs, aux, train, key):
        if replay:
            x = inputs[2]
            return [r.to(x.device, x.dtype) for r in next(replayed)], []
        outs, new_aux = saved(self, params, inputs, aux, train, key)
        records.append([o.detach().cpu() for o in outs])
        return outs, new_aux

    op.forward = forward
    try:
        yield
    finally:
        op.forward = saved


def ssd_float64(cfg, params, db, masks, targets):
    """The port's CPU path in float64 over the SSD training graph: a
    training forward and backward on the card's ReLU branches and
    matching (``masks``, ``targets``): (outputs, parameter gradients)."""
    import mxnet_tpu_torch as mt

    net = ssd_symbol(cfg, "train")
    x, lab = db.data[0].asnumpy(), db.label[0].asnumpy()
    with mt.cpu():
        exe = net.simple_bind(
            mt.cpu(), type_dict=dict.fromkeys(net.list_arguments(),
                                              np.float64),
            data=x.shape, label=lab.shape)
        for k, v in params[0].items():
            exe.arg_dict[k][:] = v.asnumpy().astype(np.float64)
        exe.arg_dict["data"][:] = x.astype(np.float64)
        exe.arg_dict["label"][:] = lab.astype(np.float64)
        with relu_branches(masks, replay=True), \
                multibox_targets(targets, replay=True):
            outs = [o.asnumpy() for o in exe.forward(is_train=True)]
            exe.backward()
        return outs, {k: exe.grad_dict[k].asnumpy() for k in params[0]}


def detect_small_check():
    """SSD (filter_scale 16, 300 x 300, batch 2, 20 classes) on the card
    against the port's CPU path.  The multibox ops on identical inputs
    (the card's cls_preds, loc_preds and anchors, copied to the CPU):
    anchors, the three targets and the detection rows bit-equal, and at
    constructed ties (all-zero predictions: mining over equal scores; one
    box twice under two classes: two gts claiming one anchor; scores on
    three levels: NMS over equal scores).  The planted faults must break
    that equality: an unstable order (ties reversed) in mining and in the
    detection's score order, and the first writer winning the claim.
    Then the whole training graph: the card's forward and backward held
    to the CPU path in float64 on the card's ReLU branches and matching,
    outputs within VISION_OUT_REL and each gradient within
    VISION_GRAD_REL of its largest."""
    import mxnet_tpu_torch as mt

    cfg, B = SSD_SMALL, SSD_SMALL["batch"]
    ctx = module_ctx()
    card = ssd_module(cfg, B, ctx, seed=8)
    args, auxs = card.get_params()
    params = ({k: v.copy() for k, v in args.items()},
              {k: v.copy() for k, v in auxs.items()})
    db = ssd_batch(cfg, B, ctx, seed=9)
    label = db.label[0]
    loc, cls, anchors = ssd_heads(cfg, params, db.data[0], ctx)
    with mt.cpu():
        host_anchors = ssd_heads(cfg, params, db.data[0].asnumpy(),
                                 mt.cpu())[2].asnumpy()
    exact = {"anchors": bool(np.array_equal(anchors.asnumpy(),
                                            host_anchors))}

    def target(a, lab, c):
        return mt.nd.MultiBoxTarget(a, lab, c, **SSD_TARGET_KW)

    def detect(p, lc, a):
        return mt.nd.MultiBoxDetection(p, lc, a, **SSD_DET_KW)

    cls_prob = mt.nd.SoftmaxActivation(cls, mode="channel")
    got_t, _, exact["targets"] = card_and_cpu(target, [anchors, label, cls])
    got_d, _, exact["detection"] = card_and_cpu(detect,
                                                [cls_prob, loc, anchors])
    # constructed ties
    zeros = mt.nd.zeros(cls.shape, ctx=ctx)
    dup = np.full(label.shape, -1.0, np.float32)
    dup[:, 0] = [1, 0.31, 0.22, 0.52, 0.47]
    dup[:, 2] = [7, 0.31, 0.22, 0.52, 0.47]
    dup = mt.nd.array(dup, ctx=ctx)
    rng = np.random.RandomState(10)
    levels = mt.nd.array(rng.choice(np.float32([0.0, 0.25, 0.5]),
                                    size=cls.shape), ctx=ctx)
    ties = {"mining_equal_scores": (target, [anchors, label, zeros]),
            "claim_collision": (target, [anchors, dup, cls]),
            "nms_equal_scores": (detect, [levels, loc, anchors])}
    tie_outs = {}
    for tag, (fn, ins) in ties.items():
        tie_outs[tag], _, exact[tag] = card_and_cpu(fn, ins)
    # one box under two classes (rows 0 and 2): the anchors over the IoU
    # threshold take row 0 (argmax's first index: class 1 + 1), the one
    # anchor both rows claim takes row 2 (the highest index: 7 + 1)
    claimed = tie_outs["claim_collision"][2]
    claim_ok = bool(((claimed == 8).sum(1) == 1).all())
    # planted faults, each on the card against the CPU's correct output
    planted = {}
    for tag, name, fn, case in (
            ("unstable_mining", "descending", unstable_descending,
             "mining_equal_scores"),
            ("unstable_nms_order", "descending", unstable_descending,
             "nms_equal_scores"),
            ("first_writer_claim", "claim_anchors", first_writer_claim,
             "claim_collision")):
        f, ins = ties[case]
        with planted_multibox(name, fn):
            faulty = listed(f(*ins))
        planted[tag] = not all(np.array_equal(g, w) for g, w in
                               zip(faulty, tie_outs[case]))
    # the whole graph against float64 on the card's branches and matching
    masks, targets = [], []
    with relu_branches(masks), multibox_targets(targets):
        card.forward(db, is_train=True)
        card.backward()
    exe = card._exec_group.execs[0]
    got = ([o.asnumpy() for o in card.get_outputs()],
           {k: exe.grad_dict[k].asnumpy() for k in card._param_names})
    want = ssd_float64(cfg, params, db, masks, targets)
    shares = {"cls_prob": _share(got[0][0], want[0][0], VISION_OUT_REL),
              "loc_loss": _share(got[0][1], want[0][1], VISION_OUT_REL),
              "grad": max(_share(got[1][k], want[1][k], VISION_GRAD_REL)
                          for k in want[1])}
    cls_label_same = bool(np.array_equal(got[0][2], want[0][2]))
    rows = got_d[0]
    n_pos = int((got_t[1] > 0).sum() // 4)
    ok = (all(exact.values()) and claim_ok and all(planted.values())
          and all(v <= 1.0 for v in shares.values()) and cls_label_same
          and n_pos > 0 and bool(np.isfinite(rows).all())
          and len(masks) > 0 and len(targets) == 1)
    emit({"phase": "detect_small_check", "config": cfg, "batch": B,
          "dtype": "float32", "anchors": int(host_anchors.shape[1]),
          "bit_equal_card_vs_cpu": exact,
          "claim_collision_highest_gt_wins": claim_ok,
          "planted_faults_caught": planted,
          "positive_anchors": n_pos,
          "detections_kept": int((rows[..., 0] >= 0).sum()),
          "graph_shares_of_bound_vs_cpu_float64": shares,
          "cls_label_equal": cls_label_same,
          "bound": "multibox ops on identical inputs (the card's "
                   "cls_preds, loc_preds, anchors): card == cpu bit for "
                   "bit, ties included; each planted fault must break "
                   "that; the training graph against the CPU path in "
                   "float64 on the card's ReLU branches and matching: "
                   "outputs <= 1e-5, gradients <= 1e-4 of max|want|",
          "ok": ok})
    del card
    torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("SSD: the multibox ops card vs CPU, a planted "
                         "fault or the float64 graph check failed")


class _SSDLosses:
    """A batch_end_callback: each batch's NLL and loc loss
    (``ssd_losses``), left on the device until read."""

    def __init__(self, mod):
        self.mod, self.values = mod, []

    def __call__(self, param):
        self.values.append(ssd_losses(self.mod.get_outputs()))

    def read(self):
        return ([float(n) for n, _ in self.values],
                [float(c) for _, c in self.values])


def train_ssd_main_path():
    """SSD-300 (``SSD_CFG``) trained by Module.fit as
    examples/train_ssd.py runs it: batch ms and images/s after the
    warm-up batches, peak memory, the NLL and the loc loss of each batch
    (the last epoch's mean below the first's), a profile window of two
    more steps by kind (``multibox_target`` and ``nms`` by host range),
    every parameter finite and on the card, no TF32 kernel traced and no
    flash or fused-RNN launch.  Returns (row, module)."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import flash_attention_cuda as fac
    from mxnet_tpu_torch.ops import fused_rnn_cuda as frc

    cfg, B = SSD_CFG, SSD_CFG["batch"]
    X, labels = synthetic_det(cfg, cfg["images"], seed=0)
    train = mt.io.NDArrayIter({"data": X}, {"label": labels}, B,
                              shuffle=False)
    del X
    mod = mt.mod.Module(ssd_symbol(cfg, "train"), data_names=["data"],
                        label_names=["label"], context=module_ctx())
    lap("ssd_train_setup")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = (fac.launches, frc.launches)
    before = [dict(c) for c in counters]
    clock, losses = _StepClock(), _SSDLosses(mod)
    speed = mt.callback.Speedometer(B, 2)
    mt.random.seed(0)
    mod.fit(train, num_epoch=cfg["epochs"], initializer=ssd_initializer(),
            optimizer="sgd", optimizer_params=SSD_SGD,
            eval_metric=mt.metric.Loss(),
            batch_end_callback=[speed, clock, losses])
    torch.cuda.synchronize()
    moved_launches = {k: c[k] - b[k] for c, b in zip(counters, before)
                      for k in c if c[k] != b[k]}
    steps = np.diff(clock.stamps) * 1e3
    timed = steps[cfg["warmup"]:]
    images_s = B * len(timed) / (timed.sum() / 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    nll, loc = losses.read()
    lap("ssd_train_fit")
    per_epoch = len(nll) // cfg["epochs"]
    falling = {k: float(np.mean(v[-per_epoch:])) < float(np.mean(
        v[:per_epoch])) for k, v in (("nll", nll), ("loc", loc))}
    exe = mod._exec_group.execs[0]
    args, _ = mod.get_params()
    on_card = all(a._data.device.type == torch.device(DEVICE).type
                  for a in exe.arg_dict.values())
    finite = all(bool(np.isfinite(v.asnumpy()).all()) for v in args.values())
    train.reset()
    db = next(iter(train))

    def step():
        mod.forward_backward(db)
        mod.update()

    profile = vision_profile(step, ranges=DETECT_RANGES)
    lap("ssd_train_profile")
    probs = mod.get_outputs()[0].asnumpy()
    anchors = probs.shape[2]
    fwd_flops = mt.flops.count_flops(ssd_symbol(cfg, "train"),
                                     data=ssd_shape(cfg, 1),
                                     label=(1, 4, 5))
    flops_s = 3 * fwd_flops * images_s
    ok = (on_card and finite and all(falling.values()) and not moved_launches
          and not profile["tf32_kernels"] and bool(np.isfinite(nll).all())
          and bool(np.isfinite(loc).all()) and bool(np.isfinite(probs).all())
          and probs.shape == (B, cfg["num_classes"] + 1, anchors)
          and profile["ms_per_step_by_kind"].get("multibox_target", 0) > 0)
    row = {"phase": "train_ssd", "dtype": "float32",
           "config": {k: cfg[k] for k in ("num_classes", "filter_scale",
                                          "data_shape")},
           "anchors": anchors, "layout": "NCHW", "batch": B,
           "batches": len(steps), "epochs": cfg["epochs"],
           "entry": "models.ssd(mode='train') + mod.Module(context=gpu(0))"
                    ".fit(io.NDArrayIter, sgd 0.004, momentum 0.9, wd 5e-4, "
                    "Mixed([relu4_3_scale -> Constant(20), Xavier]), "
                    "metric.Loss, Speedometer)",
           "warmup_batches": cfg["warmup"], "step_ms": steps.tolist(),
           "step_ms_median": float(np.median(timed)),
           "images_per_s": images_s,
           "speedometer_last_samples_per_s": speed.last_speed,
           "peak_mem_gib": peak,
           "forward_gflops_per_image": fwd_flops / 1e9,
           "train_tflops_per_s_at_3x_forward": flops_s / 1e12,
           "share_of_float32_fma_peak": flops_s / PEAK_OPS_S[torch.float32],
           "nll": nll, "loc_loss_per_image": loc,
           "falling_last_epoch_vs_first": falling, "profile": profile,
           "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                    "cudnn": torch.backends.cudnn.allow_tf32},
           "params_on_card": on_card, "params_finite": finite,
           "flash_rnn_launches_moved": moved_launches, "ok": ok}
    emit(row)
    del exe, train, db
    if not ok:
        raise SystemExit("SSD-300 Module training failed its checks")
    return row, mod


def wall_ms(fn, reps=10, warmup=2):
    """Median host ms of one synchronised call (the card idle before
    each): the time a host-driven loop takes end to end."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def detect_ssd(train_mod):
    """The ``mode="det"`` graph (``nms_topk`` 400) over ``train_mod``'s
    trained weights, batch 32, bound by simple_bind(grad_req="null"):
    images/s over synchronised forwards; the MultiBoxDetection op's and
    its NMS loop's wall ms (8028 anchors, the top 400 a image, every
    image of the batch in one tensor), a profile of one forward by kind;
    the rows finite, in score order, at most 400 kept an image, class
    ids in [-1, 20)."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import OP_REGISTRY, multibox

    cfg, B = SSD_CFG, SSD_CFG["batch"]
    ctx = module_ctx()
    args, _ = train_mod.get_params()
    net = ssd_symbol(cfg, "det")
    exe = net.simple_bind(ctx, grad_req="null", data=ssd_shape(cfg, B))
    for k, v in args.items():
        if k in exe.arg_dict:
            exe.arg_dict[k][:] = v
    X, _ = synthetic_det(cfg, B, seed=1)
    exe.arg_dict["data"][:] = X

    def forward():
        exe.forward(is_train=False)

    batch_ms = wall_ms(forward, reps=5)
    rows = exe.outputs[0].asnumpy()
    internals = net.get_internals()
    group = mt.sym.Group([internals[n] for n in (
        "cls_prob_output", "multibox_loc_pred_output",
        "multibox_anchors_output")])
    heads = group.simple_bind(ctx, grad_req="null", data=ssd_shape(cfg, B))
    for k, v in args.items():
        if k in heads.arg_dict:
            heads.arg_dict[k][:] = v
    heads.arg_dict["data"][:] = X
    prob, loc, anchors = heads.forward(is_train=False)
    params = OP_REGISTRY.get("MultiBoxDetection").make_params(SSD_DET_KW)
    boxes_o, cls_o, _ = multibox.decode_sorted(params, prob._data,
                                               loc._data, anchors._data)
    k = SSD_DET_KW["nms_topk"]
    nms_ms = wall_ms(lambda: multibox.nms_keep(
        boxes_o[:, :k], cls_o[:, :k], SSD_DET_KW["nms_threshold"], False))
    op_ms = wall_ms(lambda: mt.nd.MultiBoxDetection(prob, loc, anchors,
                                                    **SSD_DET_KW))
    profile = vision_profile(forward, ranges=DETECT_RANGES)
    kept = (rows[..., 0] >= 0).sum(1)
    ok = (rows.shape == (B, anchors.shape[1], 6)
          and bool(np.isfinite(rows).all())
          and bool((np.diff(rows[..., 1], axis=1) <= 0).all())
          and bool((kept <= k).all()) and int(kept.sum()) > 0
          and bool(((rows[..., 0] >= -1)
                    & (rows[..., 0] < cfg["num_classes"])).all())
          and not profile["tf32_kernels"])
    row = {"phase": "detect_ssd", "dtype": "float32", "batch": B,
           "anchors": int(anchors.shape[1]), "nms_topk": k,
           "entry": "models.ssd(mode='det').simple_bind(gpu(0), "
                    "grad_req='null') over train_ssd's parameters",
           "batch_ms_median": batch_ms, "images_per_s": B / batch_ms * 1e3,
           "detection_op_wall_ms": op_ms, "nms_wall_ms": nms_ms,
           "kept_per_image": kept.tolist(), "profile": profile, "ok": ok}
    emit(row)
    del exe, heads
    torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("SSD-300 detection failed its checks")
    return row


@contextlib.contextmanager
def counted_int_mm(shapes):
    """Every ``torch._int_mm`` call inside the block records its (M, K,
    N) into ``shapes``."""
    saved = torch._int_mm

    def counted(a, b):
        shapes.append((a.shape[0], a.shape[1], b.shape[1]))
        return saved(a, b)

    torch._int_mm = counted
    try:
        yield
    finally:
        torch._int_mm = saved


def resnet_symbol(cfg):
    import mxnet_tpu_torch as mt

    with mt.sym.NameManager():
        return mt.models.resnet(num_classes=cfg["num_classes"],
                                num_layers=cfg["num_layers"],
                                image_shape=cfg["image_shape"])


def quant_params(net, cfg, ctx, xavier):
    """ResNet parameters on ``ctx``: N(0, 0.05^2) from RandomState(0) as
    examples/quantize_resnet.py draws them, or ``xavier``:
    Xavier(in, 2.34) from ``mt.random.seed(0)``; moving means 0,
    variances 1."""
    import mxnet_tpu_torch as mt

    shape = (cfg["batch"],) + tuple(cfg["image_shape"])
    arg_shapes, _, aux_shapes = net.infer_shape(data=shape)
    rng = np.random.RandomState(0)
    init = mt.init.Xavier(factor_type="in", magnitude=2.34)
    mt.random.seed(0)
    args = {}
    for n, s in zip(net.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        if xavier:
            args[n] = mt.nd.zeros(s, ctx=ctx)
            init(n, args[n])
        else:
            args[n] = mt.nd.array(rng.standard_normal(s).astype(np.float32)
                                  * 0.05, ctx=ctx)
    auxs = {n: (mt.nd.ones(s, ctx=ctx) if n.endswith("var")
                else mt.nd.zeros(s, ctx=ctx))
            for n, s in zip(net.list_auxiliary_states(), aux_shapes)}
    return args, auxs


def bound_forward(sym, args, auxs, data, ctx):
    """``sym`` bound by simple_bind(grad_req="null") on ``ctx`` with
    ``args``/``auxs`` and ``data``: (executor, forward)."""
    shapes = {"data": data.shape}
    if "softmax_label" in sym.list_arguments():
        shapes["softmax_label"] = (data.shape[0],)
    with ctx:
        exe = sym.simple_bind(ctx, grad_req="null", **shapes)
        for k, v in args.items():
            if k in exe.arg_dict:
                exe.arg_dict[k][:] = v
        for k, v in auxs.items():
            if k in exe.aux_dict:
                exe.aux_dict[k][:] = v
        exe.arg_dict["data"][:] = data

    def forward():
        return exe.forward(is_train=False)[0]

    return exe, forward


QuantTap = collections.namedtuple("QuantTap", "name op params args tap out")


def quantized_taps(qsym):
    """Every calibrated quantized layer of ``qsym`` as a ``QuantTap``: its
    node name, op and params, the names of its other arguments (weight,
    wscale[, bias]), and the internal-output indices of its data input
    (``quantize_model``'s calibration tap, by the same
    ``_internal_offsets``) and of its output."""
    from mxnet_tpu_torch.contrib.quantization import _internal_offsets
    from mxnet_tpu_torch.ops import OP_REGISTRY

    nodes = json.loads(qsym.tojson())["nodes"]
    offsets, _ = _internal_offsets(nodes)
    out = []
    for i, node in enumerate(nodes):
        if node["op"].startswith("Quantized") and "act_scale" in node.get(
                "param", {}):
            op = OP_REGISTRY.get(node["op"])
            src, idx = node["inputs"][0][:2]
            out.append(QuantTap(
                node["name"], op, op.make_params(node["param"]),
                [nodes[j[0]]["name"] for j in node["inputs"][1:]],
                offsets[src] + idx, offsets[i]))
    return out


def layer_y32(params, xq, wq):
    """A quantized layer's exact int32 product of int8 ``xq`` and
    ``wq``."""
    from mxnet_tpu_torch.ops import quantized as q
    from mxnet_tpu_torch.ops.nn import _pair

    if hasattr(params, "kernel"):
        pad = _pair(params.pad, 2) if params.pad else (0, 0)
        return q.conv_y32(xq, wq, _pair(params.stride), pad, params.layout)
    return q.int8_matmul(xq.reshape(xq.shape[0], -1), wq)


def saturated_int8_case(device):
    """+-127 activations (5 of them -127) and all-127 weights at K = 4608
    (ResNet-50's 3x3x512): the exact sum 127^2 * 4598 = 74,161,142 is
    past 2^26 and no multiple of 8, so float32 cannot hold it."""
    xq = torch.full((1, 512, 3, 3), 127, dtype=torch.int8)
    flat = xq.view(-1)
    flat[np.random.RandomState(11).choice(4608, 5, replace=False)] = -127
    wq = torch.full((8, 512, 3, 3), 127, dtype=torch.int8)
    exact = int((xq.long() * 127).sum())
    return xq.to(device), wq.to(device), exact


def quant_check():
    """``contrib.quantization.quantize_model`` on ResNet-18 (``QUANT_SMALL``,
    examples/quantize_resnet.py), calibrated on 4 seeded batches on the
    card, then the same qsym and qargs on the card and on the CPU: each
    calibrated layer's int8 input, int32 product and output (the card's
    bound graph against the op's forward on the CPU) bit-equal on
    identical float inputs (the card's); the card's contractions through
    ``torch._int_mm``; the whole network's probabilities card vs CPU
    (reported: a float activation an ulp apart may round to another int8
    step); the planted fault (a float32 contraction of the saturated
    K = 4608 case) differs from the exact product, which the int path
    gives on both."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.contrib.quantization import quantize_model
    from mxnet_tpu_torch.ops import quantized as q

    cfg, B = QUANT_SMALL, QUANT_SMALL["batch"]
    ctx = module_ctx()
    net = resnet_symbol(cfg)
    args, auxs = quant_params(net, cfg, ctx, xavier=False)
    rng = np.random.RandomState(0)
    shape = (B,) + tuple(cfg["image_shape"])
    calib = [rng.uniform(-1, 1, shape).astype(np.float32) for _ in range(4)]
    with ctx:
        qsym, qargs, qaux = quantize_model(net, args, auxs, calib_data=calib,
                                           exclude=("conv0",))
    taps = quantized_taps(qsym)
    X = rng.uniform(-1, 1, shape).astype(np.float32)
    internals = qsym.get_internals()
    group = mt.sym.Group([internals[i] for t in taps for i in (t.tap, t.out)])
    exe_g, _ = bound_forward(group, qargs, qaux, X, ctx)
    outs = [o._data for o in exe_g.forward(is_train=False)]
    layers = {}
    for t, x, y in zip(taps, outs[0::2], outs[1::2]):
        wq = qargs[t.name + "_weight"]._data
        xq = q.quantize_act(x, t.params.act_scale)
        xq_cpu = q.quantize_act(x.cpu(), t.params.act_scale)
        y_card = layer_y32(t.params, xq, wq).cpu()
        y_cpu = layer_y32(t.params, xq.cpu(), wq.cpu())
        # the whole op (quantize, contraction, rescale, bias, layout) on
        # the CPU against the card's bound graph, on the card's input
        ins = [x.cpu()] + [qargs[a]._data.cpu() for a in t.args]
        out_cpu = t.op.forward(t.params, ins, [], False, None)[0][0]
        layers[t.name] = {"xq_equal": bool(torch.equal(xq.cpu(), xq_cpu)),
                          "y32_equal": bool(torch.equal(y_card, y_cpu)),
                          "out_equal": bool(torch.equal(y.cpu(), out_cpu))}
    shapes = []
    _, fwd_card = bound_forward(qsym, qargs, qaux, X, ctx)
    with counted_int_mm(shapes):
        p_card = fwd_card().asnumpy()
    _, fwd_cpu = bound_forward(qsym, qargs, qaux, X, mt.cpu())
    p_cpu = fwd_cpu().asnumpy()
    xq, wq, exact = saturated_int8_case(DEVICE)
    y_int = q.conv_y32(xq, wq, (1, 1), (0, 0))
    y_int_cpu = q.conv_y32(xq.cpu(), wq.cpu(), (1, 1), (0, 0))
    f32 = torch.nn.functional.conv2d(xq.float(), wq.float())
    planted = {"int_path_exact_card": bool((y_int == exact).all()),
               "int_path_exact_cpu": bool((y_int_cpu == exact).all()),
               "float32_contraction_caught": bool(
                   (f32.double() != exact).any())}
    via_int_mm = len(shapes) >= len(taps) if DEVICE == "cuda" else True
    ok = (len(taps) > 0 and all(all(v.values()) for v in layers.values())
          and via_int_mm and all(planted.values())
          and bool(np.isfinite(p_card).all()) and p_card.shape == (
              B, cfg["num_classes"]))
    emit({"phase": "quant_check", "config": {k: cfg[k] for k in (
              "num_classes", "num_layers", "image_shape")}, "batch": B,
          "calibrated_layers": len(taps), "excluded": ["conv0"],
          "layers_bit_equal": sum(all(v.values()) for v in layers.values()),
          "layers_not_equal": {k: v for k, v in layers.items()
                               if not all(v.values())},
          "int_mm_calls_card_forward": len(shapes),
          "int_mm_shapes_mkn": shapes[:4],
          "probs_card_vs_cpu_max_abs": float(np.abs(p_card - p_cpu).max()),
          "top1_card_vs_cpu": float((p_card.argmax(1)
                                     == p_cpu.argmax(1)).mean()),
          "planted": planted,
          "bound": "each calibrated layer: int8 input, int32 product and "
                   "the op's float output (the card's bound graph against "
                   "the op's forward on the CPU) card == cpu bit for bit "
                   "on the card's float input; "
                   "the card's int8 contractions through torch._int_mm; "
                   "a float32 contraction of the saturated K=4608 case "
                   "must differ from the exact sum",
          "ok": ok})
    if not ok:
        raise SystemExit("int8: a quantized layer differs card vs CPU, the "
                         "int path or the planted float32 check failed")


# infer_int8's agreement with the float net on its held-out batch: an
# H100 read top-1 1.0 and max |p - p_float| 1.28e-5 (weight-only) and
# 2.46e-5 (calibrated) in every run (PERF.md); the bounds stand
# about four times above, far below what a wrong scale or layout gives
# (p itself is about 1e-3 over 1000 classes)
INT8_TOP1 = 0.9
INT8_PROB_BOUND = {"weight_only": 5e-5, "int8": 1e-4}


def infer_int8():
    """ResNet-50 (``QUANT_CFG``) at 224 x 224, batch 32: the float net,
    its weight-only int8 rewrite and its calibrated int8 rewrite
    (``quantize_model``, 4 seeded calibration batches, conv0 excluded),
    each through simple_bind(grad_req="null") on the card: images/s over
    synchronised forwards, top-1 agreement and max |p - p_float| on a
    held-out batch (each held to ``INT8_TOP1`` and ``INT8_PROB_BOUND``),
    the calibrated forward's ``torch._int_mm`` calls."""
    from mxnet_tpu_torch.contrib.quantization import quantize_model

    cfg, B = QUANT_CFG, QUANT_CFG["batch"]
    ctx = module_ctx()
    net = resnet_symbol(cfg)
    args, auxs = quant_params(net, cfg, ctx, xavier=True)
    rng = np.random.RandomState(1)
    shape = (B,) + tuple(cfg["image_shape"])
    calib = [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]
    X = rng.standard_normal(shape).astype(np.float32)
    with ctx:
        wsym, wargs, _ = quantize_model(net, args, auxs, exclude=("conv0",))
        csym, cargs, _ = quantize_model(net, args, auxs, calib_data=calib,
                                        exclude=("conv0",))
    del calib
    rows, probs = {}, {}
    for tag, sym, a in (("float", net, args), ("weight_only", wsym, wargs),
                        ("int8", csym, cargs)):
        shapes = []
        exe, fwd = bound_forward(sym, a, auxs, X, ctx)
        with counted_int_mm(shapes):
            ms = wall_ms(fwd, reps=cfg["reps"], warmup=cfg["warmup"])
            probs[tag] = fwd().asnumpy()
        rows[tag] = {"batch_ms_median": ms, "images_per_s": B / ms * 1e3,
                     "int_mm_calls_a_forward": len(shapes) // (
                         cfg["reps"] + cfg["warmup"] + 1)}
        del exe, fwd
        torch.cuda.empty_cache()
    for tag in ("weight_only", "int8"):
        rows[tag]["top1_agreement_with_float"] = float(
            (probs[tag].argmax(1) == probs["float"].argmax(1)).mean())
        rows[tag]["max_abs_prob_diff"] = float(
            np.abs(probs[tag] - probs["float"]).max())
    n_q = len(quantized_taps(csym))
    ok = (all(bool(np.isfinite(p).all()) and p.shape == (
        B, cfg["num_classes"]) for p in probs.values())
          and (DEVICE != "cuda" or rows["int8"]["int_mm_calls_a_forward"]
               >= n_q)
          and rows["weight_only"]["int_mm_calls_a_forward"] == 0
          and all(rows[t]["top1_agreement_with_float"] >= INT8_TOP1
                  and rows[t]["max_abs_prob_diff"] <= bound
                  for t, bound in INT8_PROB_BOUND.items()))
    emit({"phase": "infer_int8", "config": {k: cfg[k] for k in (
              "num_classes", "num_layers", "image_shape")}, "batch": B,
          "quantized_layers": n_q, "excluded": ["conv0"],
          "entry": "contrib.quantization.quantize_model + "
                   "simple_bind(gpu(0), grad_req='null')",
          "arms": rows,
          "bound": {"top1_agreement_with_float": INT8_TOP1,
                    "max_abs_prob_diff": INT8_PROB_BOUND},
          "ok": ok})
    if not ok:
        raise SystemExit("int8 ResNet-50 inference failed its checks")
    return rows


class _NumpySoftmaxOps:
    """examples/numpy_ops.py's softmax as a CustomOp (registered as
    ``chip_smoke_softmax``) and as a NumpyOp, registered once."""

    ops = None

    @classmethod
    def get(cls):
        if cls.ops is not None:
            return cls.ops
        import mxnet_tpu_torch as mt

        op = mt.operator

        class Softmax(op.CustomOp):
            def forward(self, is_train, req, in_data, out_data, aux):
                x = in_data[0].asnumpy()
                e = np.exp(x - x.max(axis=1, keepdims=True))
                self.assign(out_data[0], req[0],
                            mt.nd.array(e / e.sum(axis=1, keepdims=True)))

            def backward(self, req, out_grad, in_data, out_data, in_grad,
                         aux):
                lab = in_data[1].asnumpy().ravel().astype(np.int64)
                y = out_data[0].asnumpy().copy()
                y[np.arange(lab.shape[0]), lab] -= 1.0
                self.assign(in_grad[0], req[0], mt.nd.array(y))

        @op.register("chip_smoke_softmax")
        class SoftmaxProp(op.CustomOpProp):
            def __init__(self):
                super().__init__(need_top_grad=False)

            def list_arguments(self):
                return ["data", "label"]

            def list_outputs(self):
                return ["output"]

            def infer_shape(self, in_shape):
                return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

            def create_operator(self, ctx, shapes, dtypes):
                return Softmax()

        class NumpySoftmax(op.NumpyOp):
            def __init__(self):
                super().__init__(need_top_grad=False)

            def list_arguments(self):
                return ["data", "label"]

            def list_outputs(self):
                return ["output"]

            def infer_shape(self, in_shape):
                return [in_shape[0], (in_shape[0][0],)], [in_shape[0]]

            def forward(self, in_data, out_data):
                x = in_data[0]
                e = np.exp(x - x.max(axis=1, keepdims=True))
                out_data[0][:] = e / e.sum(axis=1, keepdims=True)

            def backward(self, out_grad, in_data, out_data, in_grad):
                lab = in_data[1].ravel().astype(np.int64)
                y = out_data[0].copy()
                y[np.arange(lab.shape[0]), lab] -= 1.0
                in_grad[0][:] = y

        cls.ops = NumpySoftmax()
        return cls.ops


def custom_net(kind):
    """examples/numpy_ops.py's MLP with its softmax as ``kind``
    (``custom``, ``numpy``) or the built-in SoftmaxOutput."""
    import mxnet_tpu_torch as mt

    numpy_op = _NumpySoftmaxOps.get()
    with mt.sym.NameManager():
        data = mt.sym.Variable("data")
        fc1 = mt.sym.FullyConnected(data, name="fc1", num_hidden=128)
        act1 = mt.sym.Activation(fc1, act_type="relu")
        fc2 = mt.sym.FullyConnected(act1, name="fc2", num_hidden=10)
        label = mt.sym.Variable("softmax_label")
        if kind == "custom":
            return mt.sym.Custom(fc2, label, name="softmax",
                                 op_type="chip_smoke_softmax")
        if kind == "numpy":
            return numpy_op(data=fc2, label=label, name="softmax")
        return mt.sym.SoftmaxOutput(fc2, label, name="softmax")


def custom_op_check():
    """examples/numpy_ops.py's softmax as a CustomOp and as a NumpyOp
    trained through Module.fit on the card (``CUSTOM_N`` images, batch
    ``CUSTOM_BATCH``, SGD 0.1, momentum 0.9, one epoch, unshuffled) from
    the same initial parameters as the built-in SoftmaxOutput: every
    parameter within ``CUSTOM_REL`` of its largest of the built-in's,
    on the card; the host round trip of one call (nd.Custom) beside the
    built-in op's, synchronised wall ms."""
    import mxnet_tpu_torch as mt

    ctx = module_ctx()
    rng = np.random.RandomState(0)
    y = rng.randint(0, 10, CUSTOM_N)
    X = rng.standard_normal((CUSTOM_N, 784)).astype(np.float32) * 0.3
    X[np.arange(CUSTOM_N), y * 78] += 2.0
    y = y.astype(np.float32)
    init_rng = np.random.RandomState(1)
    base = custom_net("builtin")
    shapes = base.infer_shape(data=(CUSTOM_BATCH, 784),
                              softmax_label=(CUSTOM_BATCH,))[0]
    init = {n: (init_rng.standard_normal(s) * 0.05).astype(np.float32)
            for n, s in zip(base.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}
    trained, on_card = {}, {}
    for kind in ("builtin", "custom", "numpy"):
        mod = mt.mod.Module(custom_net(kind), context=ctx)
        mod.fit(mt.io.NDArrayIter(X, y, CUSTOM_BATCH), num_epoch=1,
                optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                arg_params={k: mt.nd.array(v, ctx=ctx)
                            for k, v in init.items()})
        exe = mod._exec_group.execs[0]
        on_card[kind] = all(a._data.device.type == torch.device(DEVICE).type
                            for a in exe.arg_dict.values())
        trained[kind] = {k: v.asnumpy() for k, v in
                         mod.get_params()[0].items()}
        del mod, exe
    shares = {kind: max(_share(trained[kind][k], trained["builtin"][k],
                               CUSTOM_REL) for k in init)
              for kind in ("custom", "numpy")}
    moved = max(float(np.abs(trained["builtin"][k] - init[k]).max())
                for k in init)
    x = mt.nd.array(rng.standard_normal((CUSTOM_BATCH, 10)).astype(
        np.float32), ctx=ctx)
    lab = mt.nd.array(y[:CUSTOM_BATCH], ctx=ctx)
    custom_ms = wall_ms(lambda: mt.nd.Custom(x, lab,
                                             op_type="chip_smoke_softmax"),
                        reps=20)
    builtin_ms = wall_ms(lambda: mt.nd.SoftmaxOutput(x, lab), reps=20)
    out = mt.nd.Custom(x, lab, op_type="chip_smoke_softmax")
    ok = (all(v <= 1.0 for v in shares.values()) and all(on_card.values())
          and moved > 1e-3 and out._data.device.type == torch.device(
              DEVICE).type)
    emit({"phase": "custom_op_check", "images": CUSTOM_N,
          "batch": CUSTOM_BATCH, "entry": "operator.register + sym.Custom "
          "/ operator.NumpyOp under mod.Module(context=gpu(0)).fit",
          "shares_of_bound_vs_builtin": shares,
          "largest_step_from_init": moved, "params_on_card": on_card,
          "host_round_trip_ms": custom_ms, "builtin_call_ms": builtin_ms,
          "bound": "each parameter after the epoch within 1e-4 of its "
                   "largest of the built-in SoftmaxOutput's",
          "ok": ok})
    if not ok:
        raise SystemExit("Custom ops: training through a custom softmax "
                         "diverged from the built-in one")


def symbol_prompts(vocab, seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (n,)).astype(np.int32)
            for n in (16, 32, 64, 128, 16, 32, 64, 128)]


def serve_symbol():
    """``gpt_symbol`` at the train_module width (TRAIN_CFG) trained
    ``SYMBOL_STEPS`` Module steps (float32, batch ``SYMBOL_BATCH``),
    saved by ``save_checkpoint`` and read back by
    ``model.load_checkpoint``; its NDArray parameters served by
    ``Engine(symbol=sym)`` and by ``Engine(num_heads=8, window=0)``: the
    same greedy tokens through the paged kernel, the symbol engine's
    launches counted (layers x decode steps); a profile window whose
    trace must hold each paged kernel layers x steps times, as many as
    the counters added over it (as ``serve_main_path``'s); a one-layer
    draft (the first
    layer) read from its own symbol through ``draft_symbol=`` with
    ``spec_k`` 4, its tokens the plain engine's; a ``num_heads`` that
    contradicts the symbol raising."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import paged_attention_cuda as pac

    cfg = TRAIN_CFG
    mod = gpt_module(cfg, SYMBOL_BATCH, seed=5)
    for i in range(SYMBOL_STEPS):
        module_step(mod, module_batch(cfg, SYMBOL_BATCH, module_ctx(),
                                      seed=20 + i))
    extra = {k: v for k, v in cfg.items() if k not in ("vocab", "seq_len")}
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "gpt")
        mod.save_checkpoint(prefix, SYMBOL_STEPS)
        sym, args, _ = mt.model.load_checkpoint(prefix, SYMBOL_STEPS)
    del mod
    draft = {k: v for k, v in args.items() if not k.startswith("gpt_l1_")}
    with mt.sym.NameManager():
        draft_sym = mt.models.gpt_symbol(cfg["vocab"], cfg["seq_len"],
                                         **{**extra, "num_layers": 1})
    kw = dict(device=DEVICE, block_size=16, num_blocks=512, max_batch=8,
              max_model_len=256)
    prompts = symbol_prompts(cfg["vocab"])

    def serve(eng, count=False):
        eng.warmup()
        torch.cuda.synchronize()
        if count:
            pac.launches = pac.combine_launches = 0   # the window opens
        reqs = [eng.submit(p, max_new_tokens=32) for p in prompts]
        eng.run()
        torch.cuda.synchronize()
        n = (pac.launches, pac.combine_launches)      # ... and closes
        return [r.tokens for r in reqs], n

    eng = mt.serve.Engine(args, symbol=sym, **kw)
    config = (eng.num_heads, eng.window, str(eng.params[
        "gpt_tok_embed_weight"].dtype))
    toks, (launches, combines) = serve(eng, count=True)
    steps = eng.decode_steps
    prof = serve_profile(eng, prompts)
    eng.shutdown()
    plain = mt.serve.Engine(args, num_heads=cfg["num_heads"], window=0,
                            **kw)
    plain_toks, _ = serve(plain)
    plain.shutdown()
    spec = mt.serve.Engine(args, symbol=sym, spec_k=4, draft_params=draft,
                           draft_symbol=draft_sym, **kw)
    spec_toks, (spec_launches, spec_combines) = serve(spec, count=True)
    st = spec.stats()
    spec.shutdown()
    try:
        mt.serve.Engine(args, symbol=sym, num_heads=cfg["num_heads"] // 2,
                        **kw)
        contradiction = None
    except ValueError as e:
        contradiction = str(e)[:120]
    n_layers = cfg["num_layers"]
    # the trace's own count of the paged kernels, as serve_main_path
    # holds it: each kind layers x steps, as many as the counters added
    want = n_layers * prof["decode_steps"]
    traced = prof["traced_paged_kernels"]
    trace_whole = (prof["decode_steps"] > 0
                   and all(c == want for c in traced.values())
                   and prof["counted_paged_launches"] == traced)
    ok = (config[:2] == (cfg["num_heads"], 0) and toks == plain_toks
          and spec_toks == toks and all(len(t) == 32 for t in toks)
          and launches == n_layers * steps and steps > 0
          and combines == launches and trace_whole
          and spec_launches > 0 and st.spec_verifies > 0
          and contradiction is not None and "contradicts" in contradiction)
    row = {"phase": "serve_symbol", "dtype": config[2],
           "config": {k: cfg[k] for k in ("vocab", "seq_len", "num_layers",
                                          "d_model", "num_heads")},
           "module_steps": SYMBOL_STEPS,
           "entry": "Module.save_checkpoint -> model.load_checkpoint -> "
                    "serve.Engine(arg_params, symbol=sym)",
           "decode_config_from_symbol": {"num_heads": config[0],
                                         "window": config[1]},
           "tokens_equal_explicit_config": toks == plain_toks,
           "spec_tokens_equal": spec_toks == toks,
           "decode_steps": steps, "kernel_launches": launches,
           "combine_launches": combines,
           "spec_draft_launches": spec_launches,
           "spec_draft_combine_launches": spec_combines,
           "spec_acceptance": st.accepted_per_verify,
           "profile": {k: prof[k] for k in (
               "decode_steps", "traced_paged_kernels",
               "counted_paged_launches", "gap", "kernel_ms_per_step",
               "busy_share")},
           "profile_trace_holds_every_launch": trace_whole,
           "contradicting_num_heads_raises": contradiction, "ok": ok}
    emit(row)
    if not ok:
        raise SystemExit("serve.Engine(symbol=) failed its checks")
    return row


def detect_phases():
    """The slice's training and inference phases in order:
    detect_small_check, train_ssd, detect_ssd, quant_check, infer_int8,
    custom_op_check.  (``serve_symbol`` runs right after the serve
    phases.)"""
    detect_small_check()
    lap("detect_small_check")
    _, mod = train_ssd_main_path()
    lap("train_ssd")
    detect_ssd(mod)
    del mod
    torch.cuda.empty_cache()
    lap("detect_ssd")
    quant_check()
    lap("quant_check")
    infer_int8()
    lap("infer_int8")
    custom_op_check()
    lap("custom_op_check")


def overhead_main(args):
    """``--overhead``: the telemetry overhead arms alone, on the
    package ``args.package`` (default: this checkout's)."""
    import mxnet_tpu_torch
    from mxnet_tpu_torch.ops import paged_attention_cuda as pac

    pac._fns()
    card = card_line()
    res = telemetry_overhead(serve_params(), card)
    res["package"] = os.path.dirname(os.path.abspath(
        mxnet_tpu_torch.__file__))
    print(card)
    print(json.dumps({"phase": "telemetry_overhead", **res}), flush=True)
    return 0


def fleet_main():
    """``--fleet``: the paged library built, the serve phase (its tokens
    and manifest), then ``serve_fleet``, ``serve_fleet_obs`` and
    ``serve_fleet_control``."""
    from mxnet_tpu_torch.ops import paged_attention_cuda as pac

    pac._fns()
    card = card_line()
    np_params = serve_params()
    with tempfile.TemporaryDirectory() as tmp:
        manifest = os.path.join(tmp, "manifest.jsonl")
        serve, serve_toks = serve_main_path(np_params, manifest)
        with open(manifest) as f:
            entries = [json.loads(ln) for ln in f if ln.strip()]
    serve_fleet(np_params, serve, serve_toks, entries, card)
    serve_fleet_obs(np_params, serve, serve_toks, entries, card)
    serve_fleet_control(serve, entries, card)
    print(card)
    return 0


def aot_tp_main():
    """``--aot-tp``: the paged library built, the serve phase (its tokens
    and manifest), ``serve_restart``, then ``serve_aot_tp``."""
    from mxnet_tpu_torch.ops import paged_attention_cuda as pac

    pac._fns()
    card = card_line()
    np_params = serve_params()
    with tempfile.TemporaryDirectory() as tmp:
        manifest = os.path.join(tmp, "manifest.jsonl")
        _, serve_toks = serve_main_path(np_params, manifest)
        restart = serve_restart(np_params, serve_toks, manifest)
        with open(manifest) as f:
            entries = [json.loads(ln) for ln in f if ln.strip()]
    del np_params
    t0 = time.perf_counter()
    serve_aot_tp(entries, restart, card)
    print(json.dumps({"phase": "serve_aot_tp_seconds",
                      "seconds": time.perf_counter() - t0}))
    print(card)
    return 0


def train_module_main():
    """``--train-module``: the flash library built, the float32 flash
    checks at every flash shape (the split-TF32 forward and dK/dV and
    their planted one-product faults), the bf16 ``train`` phase (the
    ratio's other side), the float32 gradient check, then ``train_module``,
    ``module_vs_trainer``, ``module_small_check`` and the float32
    kernels' timings."""
    from mxnet_tpu_torch.ops import flash_attention_cuda as fac

    fac._lib()
    card = card_line()
    for tag, shape in FLASH_SHAPES.items():
        check_flash(tag, shape, torch.float32)
    train = train_main_path()
    train_grad_check()
    train_module_main_path(train)
    module_trainer_check()
    module_small_check()
    time_flash(FLASH_SHAPES["train"], torch.float32)
    print(card)
    return 0


def train_seq_main():
    """``--train-seq``: the fused-RNN library built, the float32 kernel
    checks at every RNN shape and against cuDNN, then ``train_bucketing``,
    ``train_feedforward``, ``module_family_check``, ``ctc_card_check`` and
    the float32 RNN kernels' timings."""
    from mxnet_tpu_torch.ops import fused_rnn_cuda as frc

    frc._lib()
    card = card_line()
    profiler_warmup()
    for mode in ("lstm", "gru"):
        for tag in RNN_SHAPES:
            check_rnn(mode, tag, torch.float32)
        cudnn_check(mode)
    train_bucketing_main_path()
    train_feedforward_main_path()
    module_family_check()
    ctc_card_check()
    time_rnn("lstm", torch.float32)
    time_rnn("gru", torch.float32)
    print(card)
    return 0


def train_vision_main():
    """``--train-vision``: ``vision_small_check`` and ``train_vision``
    (ResNet-50 through FeedForward), then the card line."""
    card = card_line()
    profiler_warmup()
    vision_small_check()
    train_vision_main_path()
    print(card)
    return 0


def detect_main():
    """``--detect``: the paged and flash libraries built (serve_symbol's
    engines and Module), then ``serve_symbol`` and the slice's other
    phases (``detect_phases``), then the card line."""
    from mxnet_tpu_torch.ops import flash_attention_cuda as fac
    from mxnet_tpu_torch.ops import paged_attention_cuda as pac

    card = card_line()
    libs = (pac._fns, fac._lib)
    builds = [threading.Thread(target=f) for f in libs]
    for b in builds:
        b.start()
    profiler_warmup()
    for b in builds:
        b.join()
    for f in libs:                    # re-raise a failed build here
        f()
    serve_symbol()
    detect_phases()
    print(card)
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "chip_smoke.json"))
    ap.add_argument("--overhead", action="store_true",
                    help="run only the telemetry overhead arms")
    ap.add_argument("--package", default=None,
                    help="with --overhead: import mxnet_tpu_torch from "
                         "this checkout")
    ap.add_argument("--fleet", action="store_true",
                    help="run only the serve phase, serve_fleet, "
                         "serve_fleet_obs and serve_fleet_control")
    ap.add_argument("--c8-planted", metavar="DIR", default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--cache-child", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--aot-tp", dest="aot_tp_only", action="store_true",
                    help="run only the serve phase, serve_restart and "
                         "serve_aot_tp")
    ap.add_argument("--train-module", dest="train_module_only",
                    action="store_true",
                    help="run only the float32 flash checks, the train "
                         "phase, the float32 gradient check and the "
                         "Module phases")
    ap.add_argument("--train-seq", dest="train_seq_only",
                    action="store_true",
                    help="run only the float32 RNN checks, the sequence "
                         "phases (BucketingModule, FeedForward, "
                         "SequentialModule, CTCLoss) and the float32 RNN "
                         "timings")
    ap.add_argument("--train-vision", dest="train_vision_only",
                    action="store_true",
                    help="run only the vision phases: vision_small_check "
                         "(ResNet-18 card vs CPU) and train_vision "
                         "(ResNet-50 through FeedForward)")
    ap.add_argument("--detect", dest="detect_only", action="store_true",
                    help="run only the symbol-serving, detection, int8 "
                         "and custom-op phases: serve_symbol, "
                         "detect_small_check, train_ssd, detect_ssd, "
                         "quant_check, infer_int8, custom_op_check")
    ap.add_argument("--aot-child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--aot-manifest", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--aot-child-tp", type=int, default=1,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if args.package:
        sys.path.insert(0, os.path.abspath(args.package))
    import mxnet_tpu_torch  # noqa: F401  (fails alone: no package)
    if args.overhead:
        return overhead_main(args)
    if args.c8_planted:
        return c8_planted(args.c8_planted)
    if args.cache_child:
        return cache_child(args.cache_child)
    if args.aot_child:
        return aot_child(args.aot_child, args.aot_manifest, args.aot_child_tp)
    if args.aot_tp_only:
        return aot_tp_main()
    if args.train_module_only:
        return train_module_main()
    if args.train_seq_only:
        return train_seq_main()
    if args.train_vision_only:
        return train_vision_main()
    if args.detect_only:
        return detect_main()
    if args.fleet:
        return fleet_main()
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
    # the bf16 engine's int8 K/V decode: bfloat16 q over an int8 cache
    errs[("decode", "int8_bf16q")] = check_kernel(
        "decode", decode_ctx, "int8_bf16q", W=16, nb=512, padded=(6,))
    errs[("long", "int8_bf16q")] = check_kernel("long2048", long_ctx,
                                                "int8_bf16q")
    check_kernel("mixed", mixed_ctx, "int8_bf16q", padded=(1,))
    check_kernel("long2048", long_ctx, "int8_bf16q", splits=1)
    dropped_split_check(long_ctx)
    captured_kernel_check(decode_ctx, "decode", W=16, nb=512, padded=(6,))
    captured_kernel_check(long_ctx, "long2048")
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
    with tempfile.TemporaryDirectory() as tmp:
        manifest = os.path.join(tmp, "manifest.jsonl")
        serve, serve_toks = serve_main_path(np_params, manifest)
        lap("serve")
        restart = serve_restart(np_params, serve_toks, manifest)
        lap("serve_restart")
        with open(manifest) as f:
            serve_manifest = [json.loads(ln) for ln in f if ln.strip()]
    aot_tp = serve_aot_tp(serve_manifest, restart, card)
    lap("serve_aot_tp")
    serve_prefix(np_params)
    lap("serve_prefix")
    logits_check(np_params)
    lap("serve_logits_check")
    spec = serve_spec(np_params)
    lap("serve_spec")
    int8 = serve_int8(np_params, serve, serve_toks)
    int8_logits_check(np_params)
    serve_spec(np_params, kv_dtype="int8")
    lap("serve_int8")
    host_kv = serve_host_kv(np_params)
    lap("serve_host_kv")
    sample = serve_sample(np_params)
    lap("serve_sample")
    lora = serve_lora(np_params)
    lap("serve_lora")
    tel = serve_telemetry(np_params, serve, serve_toks, card)
    lap("serve_telemetry")
    fleet = serve_fleet(np_params, serve, serve_toks, serve_manifest, card)
    lap("serve_fleet")
    fleet_obs = serve_fleet_obs(np_params, serve, serve_toks, serve_manifest,
                                card)
    del np_params
    lap("serve_fleet_obs")
    control = serve_fleet_control(serve, serve_manifest, card)
    lap("serve_fleet_control")
    symbol_serve = serve_symbol()
    lap("serve_symbol")

    train = train_main_path()
    train_grad_check()
    lap("gpt_train_grad_check")
    small_train_check()
    lap("gpt_train_small_check")
    train_module = train_module_main_path(train)
    module_trainer_check()
    lap("module_vs_trainer")
    module_small_check()
    lap("module_small_check")

    rnn_train = {"lstm": rnn_train_main_path("lstm", RNN_STEPS),
                 "gru": rnn_train_main_path("gru", GRU_STEPS)}
    lap("rnn_train_end")
    rnn_grad_check()
    lap("rnn_grad_check")
    rnn_small_train_check()
    lap("rnn_small_check")
    seq = {"lstm": train_bucketing_main_path(),
           "gru": train_feedforward_main_path()}
    lap("train_seq")
    module_family_check()
    lap("module_family_check")
    ctc_card_check()
    lap("ctc_card_check")
    vision_small_check()
    lap("vision_small_check")
    train_vision_main_path()
    lap("train_vision")
    detect_phases()

    timings = {}
    for dtype in ("bfloat16", "float32", "int8", "int8_bf16q"):
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
    flash_t32 = time_flash(FLASH_SHAPES["train"], torch.float32)
    lap("flash_time")
    rnn_t = {**time_rnn("lstm"), **time_rnn("gru")}
    rnn_t32 = {**time_rnn("lstm", torch.float32),
               **time_rnn("gru", torch.float32)}
    lap("rnn_time")
    main_t = timings[("decode", "bfloat16")]
    q8_t = timings[("decode", "int8_bf16q")]
    # the paged op's launches on each main path's drive: the serve
    # engine's decode, the spec engine's draft, the int8 engines' decode,
    # the host-tier engines' decode over restored blocks (float32, bf16,
    # int8 K/V), the sampling engine's decode, the sampling spec
    # engine's draft, the adapters engine's decode (both passes), the
    # telemetry-on engine's decode, the fleet replicas' decode (two
    # routed replicas, the chaos pair, the decode role over handed-off
    # blocks, the pulling pair), the sensors phase's in-process
    # engines (C8's pair, the collector's pair, the monitor's engine)
    # and the control plane's (autoscaled, redeployed, rolled back and
    # adapter-loaded replicas, their reference engine), the tp=3
    # engine's decode (layers x 3 a step), the store-warm child
    # process's restored decode graphs, and the engines serve_symbol reads
    # from a Module checkpoint's Symbol (its decode and its draft's)
    paged_paths = {"serve": (serve["kernel_launches"],
                             serve["combine_launches"]),
                   "serve_spec_draft": (spec["spec_on"]["kernel_launches"],
                                        spec["spec_on"]["combine_launches"]),
                   **{f"serve_{k}": (r["kernel_launches"],
                                     r["combine_launches"])
                      for k, r in int8.items()},
                   **{f"serve_host_kv_{k}": (r["kernel_launches"],
                                             r["combine_launches"])
                      for k, r in host_kv.items()},
                   "serve_sample": (sample["sampling"]["kernel_launches"],
                                    sample["sampling"]["combine_launches"]),
                   "serve_sample_spec_draft": (
                       sample["spec_on"]["kernel_launches"],
                       sample["spec_on"]["combine_launches"]),
                   "serve_lora_first_pass": (
                       lora["first_pass_launches"],
                       lora["first_pass_combine_launches"]),
                   "serve_lora": (lora["kernel_launches"],
                                  lora["combine_launches"]),
                   "serve_telemetry": (tel["kernel_launches"],
                                       tel["combine_launches"]),
                   "serve_fleet": (fleet["kernel_launches"],
                                   fleet["combine_launches"]),
                   "serve_fleet_obs": (fleet_obs["kernel_launches"],
                                       fleet_obs["combine_launches"]),
                   "serve_fleet_control": (control["kernel_launches"],
                                           control["combine_launches"]),
                   "serve_aot_tp": (aot_tp["kernel_launches"],
                                    aot_tp["combine_launches"]),
                   "serve_symbol": (symbol_serve["kernel_launches"],
                                    symbol_serve["combine_launches"]),
                   "serve_symbol_spec_draft": (
                       symbol_serve["spec_draft_launches"],
                       symbol_serve["spec_draft_combine_launches"]),
                   "serve_aot_store_warm": (
                       aot_tp["restored_launches"],
                       aot_tp["restored_combine_launches"])}
    kernels = {"kernels": [{
        "name": "paged_attention_decode", "route": "cuda",
        "cuda_kernels": ["paged_attention_split", "paged_attention_combine"],
        "source": "mxnet_tpu_torch/csrc/paged_attention.cu",
        "replaces": "mxnet_tpu/ops/pallas_paged_attention.py:143",
        "launches": sum(n for n, _ in paged_paths.values()),
        "combine_launches": sum(c for _, c in paged_paths.values()),
        "launches_by_path": {k: n for k, (n, _) in paged_paths.items()},
        "splits": main_t["splits"],
        "blocks_per_split": main_t["blocks_per_split"],
        "max_abs_err": errs[("decode", "bfloat16")],
        "ms": main_t["ms"], "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"], "bound_by": main_t["bound_by"],
        "library_ms": main_t["library_ms"],
        "launch_floor_ms": floor["two_kernels_ms"
                                 if main_t["splits"] > 1
                                 else "one_kernel_ms"],
        "int8_bf16q": {"max_abs_err": errs[("decode", "int8_bf16q")],
                       "ms": q8_t["ms"], "plain_ms": q8_t["plain_ms"],
                       "bound_ms": q8_t["bound_ms"],
                       "bound_by": q8_t["bound_by"],
                       "library_ms": q8_t["library_ms"]},
        "ptxas": paged_ptxas}]}
    train_err = flash_rows[("train", torch.bfloat16)]["max_abs_err_same_dtype"]
    train_err32 = flash_rows[("train", torch.float32)]["max_abs_err_same_dtype"]
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
        # the float32 variant: the Module path's (train_module) kernel
        t32 = flash_t32[kname]
        k32 = t32["kernel"]
        entry["launches_by_path"] = {
            "train": train["kernel_launches"][kname],
            "train_module": train_module["kernel_launches"][k32]}
        entry["float32"] = {
            "name": k32, "route": "cuda",
            "source": f"mxnet_tpu_torch/{t32['source']}",
            "replaces": replaces,
            "launches": train_module["kernel_launches"][k32],
            "max_abs_err": max(train_err32[o] for o in outs),
            "ms": t32["ms"], "plain_ms": t32["plain_ms"],
            "bound_ms": t32["bound_ms"], "bound_by": t32["bound_by"],
            "library_ms": t32["library_ms"]}
        entry["float32"].update({key: t32[key] for key in (
            "ms_simt", "bound_fma_ms", "ptxas") if key in t32})
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
        # the float32 variant: the Module family's path (train_bucketing's
        # LSTM, train_feedforward's GRU)
        t32 = rnn_t32[kname]
        err32 = rnn_rows[(mode, "main", torch.float32)]["max_abs_err"]
        k32 = f"{kname}_f32"
        n32 = seq[mode]["kernel_launches"][k32]
        entry["launches_by_path"] = {
            f"train_{mode}": entry["launches"],
            ("train_bucketing" if mode == "lstm" else "train_feedforward"):
                n32}
        entry["float32"] = {
            "name": k32, "route": "cuda",
            "cuda_kernel": t32["cuda_kernel"],
            "source": f"mxnet_tpu_torch/{t32['source']}",
            "replaces": replaces, "launches": n32,
            "max_abs_err": max(err32[o] for o in RNN_OUTPUTS[kind]
                               if o in err32),
            "ms": t32["ms"], "plain_ms": t32["plain_ms"],
            "bound_ms": t32["bound_ms"], "bound_by": t32["bound_by"],
            "library_ms": t32["library_ms"],
            "barrier_floor_ms": t32["barrier_floor_ms"],
            "ptxas": t32["ptxas"]}
        entry["float32"].update({key: t32[key] for key in (
            "ms_simt", "bound_fma_ms", "ptxas_simt", "cluster_size",
            "split_barrier_floor_ms") if key in t32})
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
