"""How many of a profiler window's CUDA graph replays lose their kernels in
the trace, at its tail or at its head, on the card, at each of a few
settle times.

    python3 chip_profiler_tail.py [--settle 0,0.1] [--windows 6]
    python3 chip_profiler_tail.py --start-settle 0,0.05 --steps 16 \\
        --windows 300

The serve config of chip_smoke.py (bf16, 4 layers, 8 rows decoding)
steps under ``profiler.start``/``stop`` for ``--window-s`` seconds, or
for ``--steps`` decode steps after a device synchronize (the pattern of
chip_smoke's profile windows), with ``profiler.STOP_SETTLE_S`` set to
each ``--settle`` value and ``profiler.START_SETTLE_S`` to each
``--start-settle`` value in turn.  For each window it reports the paged
split kernels traced against layers x the decode steps the engine ran,
how many replays reached the trace without device events
(``chip_smoke.graph_replays``), and the replays holding fewer than
layers split kernels, at the window's head (the first two) and
elsewhere (``chip_smoke.replay_gaps``); one JSON line a pair of settle
times.  Needs a CUDA device; imports no JAX.
"""

import argparse
import glob
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--settle", default=None,
                    help="comma-separated profiler.STOP_SETTLE_S values "
                         "(default: the package's)")
    ap.add_argument("--start-settle", default=None,
                    help="comma-separated profiler.START_SETTLE_S values "
                         "(default: the package's)")
    ap.add_argument("--windows", type=int, default=6)
    ap.add_argument("--window-s", type=float, default=2.0)
    ap.add_argument("--steps", type=int, default=0,
                    help="a window of this many decode steps after a "
                         "synchronize instead of --window-s seconds")
    args = ap.parse_args(argv)
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.ops import paged_attention_cuda as pac

    settles = ([float(v) for v in args.settle.split(",")]
               if args.settle else [profiler.STOP_SETTLE_S])
    starts = ([float(v) for v in args.start_settle.split(",")]
              if args.start_settle else [profiler.START_SETTLE_S])
    layers = cs.SERVE_CFG["num_layers"]
    pac._fns()
    cs.profiler_warmup()
    eng = cs.full_width_engine(cs.serve_params(), torch.bfloat16)
    eng.warmup()
    prompts = cs.serve_prompts(0)

    def keep_busy():
        while eng.scheduler.queue_depth + len(eng.scheduler.running) < 8:
            eng.submit(prompts[0][:16], max_new_tokens=200)

    def window():
        d0 = eng.decode_steps
        if args.steps:
            keep_busy()
            eng.step()              # any prefill before the window
            torch.cuda.synchronize()
            d0 = eng.decode_steps
            profiler.start(logdir)
            for _ in range(args.steps):
                eng.step()
            torch.cuda.synchronize()
        else:
            profiler.start(logdir)
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < args.window_s:
                eng.step()
                keep_busy()
        steps = eng.decode_steps - d0
        profiler.stop()
        return steps

    for start_settle in starts:
        for settle in settles:
            profiler.STOP_SETTLE_S = settle
            profiler.START_SETTLE_S = start_settle
            rows = []
            for _ in range(args.windows):
                keep_busy()
                with tempfile.TemporaryDirectory() as logdir:
                    steps = window()
                    trace = sorted(glob.glob(os.path.join(
                        logdir, "plugins", "profile", "*",
                        "*.trace.json.gz")))[-1]
                    r = cs.graph_replays(trace)
                    gaps = cs.replay_gaps(trace, layers)
                short = gaps["short_replays"]
                rows.append({
                    "expected": layers * steps,
                    "traced": r["split_kernels"],
                    "replays": r["graph_launches"],
                    "replays_without_device_events":
                        len(r["launches_without_device_events"]),
                    "short_at_head": [g for g in short
                                      if g["replay"] < 2],
                    "short_elsewhere": [g for g in short
                                        if g["replay"] >= 2]})
            lossy = [r for r in rows if r["traced"] != r["expected"]]
            print(json.dumps({
                "settle_s": settle, "start_settle_s": start_settle,
                "card": torch.cuda.get_device_name(0),
                "windows": len(rows),
                "windows_losing_replays": len(lossy),
                "windows_short_at_head": sum(
                    bool(r["short_at_head"]) for r in rows),
                "windows_short_elsewhere": sum(
                    bool(r["short_elsewhere"]) for r in rows),
                "lossy_windows": lossy[:20]}), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
