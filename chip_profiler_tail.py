"""How many of a profiler window's last CUDA graph replays lose their
kernels in the trace, on the card, at each of a few settle times.

    python3 chip_profiler_tail.py [--settle 0,0.1] [--windows 6]

The serve config of chip_smoke.py (bf16, 4 layers, 8 rows decoding)
steps for ``--window-s`` seconds under ``profiler.start``/``stop`` with
``profiler.STOP_SETTLE_S`` set to each ``--settle`` value in turn; for
each window it reports the paged split kernels traced against layers x
the decode steps the engine ran, and how many replays at the window's
tail reached the trace without device events
(``chip_smoke.graph_replays``); one JSON line a settle time.  Needs a
CUDA device; imports no JAX.
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
    ap.add_argument("--windows", type=int, default=6)
    ap.add_argument("--window-s", type=float, default=2.0)
    args = ap.parse_args(argv)
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.ops import paged_attention_cuda as pac

    settles = ([float(v) for v in args.settle.split(",")]
               if args.settle else [profiler.STOP_SETTLE_S])
    pac._fns()
    cs.profiler_warmup()
    eng = cs.full_width_engine(cs.serve_params(), torch.bfloat16)
    eng.warmup()
    prompts = cs.serve_prompts(0)

    def keep_busy():
        while eng.scheduler.queue_depth + len(eng.scheduler.running) < 8:
            eng.submit(prompts[0][:16], max_new_tokens=200)

    for settle in settles:
        profiler.STOP_SETTLE_S = settle
        rows = []
        for _ in range(args.windows):
            keep_busy()
            with tempfile.TemporaryDirectory() as logdir:
                d0 = eng.decode_steps
                profiler.start(logdir)
                t0 = time.perf_counter()
                while time.perf_counter() - t0 < args.window_s:
                    eng.step()
                    keep_busy()
                steps = eng.decode_steps - d0
                profiler.stop()
                trace = sorted(glob.glob(os.path.join(
                    logdir, "plugins", "profile", "*",
                    "*.trace.json.gz")))[-1]
                r = cs.graph_replays(trace)
            rows.append({"expected": cs.SERVE_CFG["num_layers"] * steps,
                         "traced": r["split_kernels"],
                         "replays": r["graph_launches"],
                         "replays_without_device_events":
                             len(r["launches_without_device_events"])})
        print(json.dumps({"settle_s": settle,
                          "card": torch.cuda.get_device_name(0),
                          "windows_losing_replays": sum(
                              r["traced"] != r["expected"] for r in rows),
                          "windows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
