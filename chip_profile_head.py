#!/usr/bin/env python3
"""Where a profile capture's trace loses its head, on one card (ROADMAP §C14).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_profile_head.py [--rest]

Runs ``chip_smoke.py``'s whole sequence and, at ``serve_symbol``'s place
(after the serve and fleet phases, where its window lost a paged kernel
in every full run), opens profile windows of 16 decode-only steps over
the float32 ``Engine(symbol=)`` that phase builds (``gpt_symbol`` at
``TRAIN_CFG``, trained by ``Module`` and read back by
``load_checkpoint``), in arms:

- ``plain``: the steps right after the capture's start, as
  ``serve_profile`` read them before its range (twice on one engine);
- ``warm``: one decode step inside the capture first, the counted steps
  after it (``serve_profile``'s window now);
- ``settle``: ``plain`` with ``profiler.START_SETTLE_S`` at 0.5 s;
- ``eager_probe``: two eager kernels, a synchronize and 50 ms inside the
  capture, then the steps;

and one ``plain`` window over chip_smoke's bf16 full-width engine.  One
JSON line a window: the paged launches the counters added over the
counted steps, the split kernels the trace holds for them and in all,
and for each CUDA graph replay (``cudaGraphLaunch``, in time order) its
split kernels and all its kernels; the first four replays' first kernel
less its launch (us), and the first replay's first kernels.  Lines also
go to ``chiprun_out/profile_head.jsonl``.  Then the process exits, or
with ``--rest`` runs ``serve_symbol`` and the rest of chip_smoke.
"""

import argparse
import collections
import glob
import gzip
import json
import os
import sys
import tempfile
import time

import torch

import chip_smoke as cs

OUT = os.path.join(cs.ROOT, "chiprun_out", "profile_head.jsonl")


def emit(obj):
    print(json.dumps(obj), flush=True)
    with open(OUT, "a") as f:
        f.write(json.dumps(obj) + "\n")


def replays(trace_file):
    """Each graph replay's split kernels and kernels, in time order, and
    the first replay's first kernels with their offsets from its launch."""
    with gzip.open(trace_file) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    launches = sorted((e for e in events
                       if e.get("name") == "cudaGraphLaunch"),
                      key=lambda e: e["ts"])
    kernels = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "kernel":
            kernels[e.get("args", {}).get("correlation")].append(e)
    rows = []
    for launch in launches:
        ks = sorted(kernels[launch.get("args", {}).get("correlation")],
                    key=lambda e: e["ts"])
        rows.append((launch, ks))
    return {"split_per_replay": [
                sum(cs.PAGED_KERNELS[0] in k["name"] for k in ks)
                for _, ks in rows],
            "kernels_per_replay": [len(ks) for _, ks in rows],
            "first_kernel_after_launch_us": [
                ks[0]["ts"] - launch["ts"] if ks else None
                for launch, ks in rows[:4]],
            "replay0_first_kernels": [
                (k["name"][:60], k["ts"] - rows[0][0]["ts"])
                for k in rows[0][1][:4]] if rows else []}


def window(tag, eng, prompts, warm=0, settle=None, probe=False, steps=16):
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.ops import paged_attention_cuda as pac

    for p in prompts:
        eng.submit(p, max_new_tokens=32)
    sched = eng.scheduler
    while eng.has_work() and (sched.queue_depth or sched.prefilling
                              or not sched.running):
        eng.step()
    torch.cuda.synchronize()
    saved = profiler.START_SETTLE_S
    if settle is not None:
        profiler.START_SETTLE_S = settle
    try:
        with tempfile.TemporaryDirectory() as logdir:
            with profiler.trace(logdir):
                if probe:
                    torch.ones(8, device="cuda").add_(1)
                    torch.cuda.synchronize()
                    time.sleep(0.05)
                for _ in range(warm):
                    eng.step()
                torch.cuda.synchronize()
                before = pac.launches
                n = 0
                while n < steps and eng.has_work():
                    eng.step()
                    n += 1
                torch.cuda.synchronize()
                counted = pac.launches - before
            (trace,) = glob.glob(os.path.join(
                logdir, "plugins", "profile", "*", "*.trace.json.gz"))
            got = replays(trace)
    finally:
        profiler.START_SETTLE_S = saved
    eng.run()
    split = got["split_per_replay"]
    emit({"window": tag, "warm_steps": warm, "start_settle_s": settle,
          "eager_probe": probe, "counted_split": counted,
          "traced_split_counted_steps": sum(split[warm:]),
          "traced_split_all": sum(split),
          "whole": sum(split[warm:]) == counted, **got})


def symbol_engines():
    """A maker of warmed float32 ``Engine(symbol=)`` engines over
    serve_symbol's trained checkpoint, and its prompts."""
    import mxnet_tpu_torch as mt

    cfg = cs.TRAIN_CFG
    mod = cs.gpt_module(cfg, cs.SYMBOL_BATCH, seed=5)
    for i in range(cs.SYMBOL_STEPS):
        cs.module_step(mod, cs.module_batch(cfg, cs.SYMBOL_BATCH,
                                            cs.module_ctx(), seed=20 + i))
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "gpt")
        mod.save_checkpoint(prefix, cs.SYMBOL_STEPS)
        sym, args, _ = mt.model.load_checkpoint(prefix, cs.SYMBOL_STEPS)
    del mod
    kw = dict(device="cuda", block_size=16, num_blocks=512, max_batch=8,
              max_model_len=256)

    def make():
        eng = mt.serve.Engine(args, symbol=sym, **kw)
        eng.warmup()
        torch.cuda.synchronize()
        return eng

    return make, cs.symbol_prompts(cfg["vocab"])


def arms(make, prompts):
    eng = make()
    window("plain", eng, prompts)
    window("plain_same_engine_again", eng, prompts)
    eng.shutdown()
    for tag, kw in (("warm", {"warm": 1}), ("plain", {}),
                    ("settle", {"settle": 0.5}),
                    ("eager_probe", {"probe": True}),
                    ("warm", {"warm": 1}), ("plain", {})):
        eng = make()
        window(tag, eng, prompts, **kw)
        eng.shutdown()
    eng = cs.full_width_engine(cs.serve_params(), torch.bfloat16)
    eng.warmup()
    window("bf16_full_width_plain", eng, cs.serve_prompts(0))
    eng.shutdown()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rest", action="store_true",
                    help="after the windows, run serve_symbol and the rest "
                         "of chip_smoke")
    args = ap.parse_args()
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    if os.path.exists(OUT):
        os.remove(OUT)
    phase = cs.serve_symbol

    def at_serve_symbol():
        emit({"card": cs.card_line(), "torch": torch.__version__,
              "cuda": torch.version.cuda})
        make, prompts = symbol_engines()
        arms(make, prompts)
        if not args.rest:
            sys.stdout.flush()
            os._exit(0)
        return phase()

    cs.serve_symbol = at_serve_symbol
    sys.argv = [sys.argv[0]]
    return cs.main()


if __name__ == "__main__":
    sys.exit(main())
