#!/usr/bin/env python3
"""Rolling float32 deploys on one card, counting the requests that stall.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_rollout_stall.py [--iters 6] [--dtype float32]

Each iteration is ``chip_smoke.control_deploy`` without its ``v3`` arm: a
pool of two in-process replicas of the serve config (the control plane's
weights), 8 streaming clients through a router, and a ``v2`` rollout
that replaces both slots.  Prints one JSON line an iteration: its
seconds, failed checks, each slot's drain-to-ready seconds, and every
request that took over 5 s with its hops (a hop that timed out waited
the router's whole per-hop timeout); then the card's name and power
limit.  Every thread's stack goes to stderr if a run passes
``--watchdog`` seconds.
"""

import argparse
import faulthandler
import json
import os
import sys
import time

import torch


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--watchdog", type=float, default=400.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_rollout_stall: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.ops import paged_attention_cuda as pac

    faulthandler.dump_traceback_later(args.watchdog)
    pac._fns()
    telemetry.enable()
    dtype = getattr(torch, args.dtype)
    params = cs.serve_params(0, std=cs.CONTROL_WEIGHT_STD)
    for it in range(args.iters):
        t0 = time.perf_counter()
        row, checks = cs.control_deploy(params, [], cs._Ledger(), dtype,
                                        v3=False)
        print(json.dumps({
            "iter": it, "dtype": args.dtype,
            "seconds": time.perf_counter() - t0,
            "failed": [k for k, v in checks.items() if not v],
            "slot_wall_s": row["v2"]["slot_wall_s"],
            "stream_requests": row["stream_requests"],
            "slow_requests": row["stream_slow_requests"]}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
