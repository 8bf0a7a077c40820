#!/usr/bin/env python3
"""Repeat the serve phases whose profile and view checks can fail, on one card.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_serve_repeat.py [--iters 3] [--package DIR]

Builds the paged library, runs chip_smoke's serve phase once (its tokens
and row), then ``--iters`` times each of ``serve_sample``, ``serve_lora``
and ``serve_telemetry`` in this process, as the whole script runs them
after its earlier serve phases.  Prints one JSON line a phase run: the
phase, whether it passed, its error if it raised, and what its flaky
checks compare: each profile's traced and counted paged kernels
(``serve_sample``, ``serve_lora``), the three telemetry views and the
failed checks (``serve_telemetry``); then the card's name and power
limit.  ``--package`` imports ``mxnet_tpu_torch`` from another checkout
(chip_smoke still from this one), so two versions of the package run in
one call; ``--smoke`` imports chip_smoke from another checkout too.
``--phases`` runs only the phases named.  ``--after-small-model`` runs
chip_smoke's small-model check first, as the whole script does, and
``--gc-off`` turns the cyclic garbage collector off before any engine
is built, so an engine dropped without ``shutdown()`` stays alive.
``--start-settle 0,0.05`` gives the iterations each value of
``profiler.START_SETTLE_S`` in turn (ROADMAP §C14).
"""

import gc

import argparse
import json
import os
import sys
import tempfile
import time

import torch


def _profiles(line):
    return {tag: {"traced": p["traced_paged_kernels"],
                  "counted": p["counted_paged_launches"],
                  "gap": p.get("gap")}
            for tag, p in (line.get("profiles") or {}).items()}


def _telemetry(line):
    return {"views": line.get("views"),
            "failed": [k for k, v in (line.get("checks") or {}).items()
                       if not v]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--package", default=None,
                    help="import mxnet_tpu_torch from this checkout")
    ap.add_argument("--smoke", default=None,
                    help="import chip_smoke from this checkout")
    ap.add_argument("--phases", default="serve_sample,serve_lora,"
                    "serve_telemetry", help="comma-separated phases to run")
    ap.add_argument("--after-small-model", action="store_true",
                    help="run chip_smoke's small-model check first")
    ap.add_argument("--gc-off", action="store_true",
                    help="turn the cyclic garbage collector off")
    ap.add_argument("--start-settle", default=None,
                    help="comma-separated profiler.START_SETTLE_S values, "
                         "taken in turn by the iterations")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_serve_repeat: CUDA is not available", file=sys.stderr)
        return 2
    if args.package:
        sys.path.insert(0, os.path.abspath(args.package))
    # before chip_smoke, which puts this checkout first on the path
    import mxnet_tpu_torch
    from mxnet_tpu_torch.ops import paged_attention_cuda as pac

    sys.path.insert(1, os.path.abspath(args.smoke) if args.smoke
                    else os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs

    if args.gc_off:
        gc.disable()
    pac._fns()
    card = cs.card_line()
    if args.after_small_model:
        cs.small_model_check()
    package = os.path.dirname(os.path.abspath(mxnet_tpu_torch.__file__))
    np_params = cs.serve_params()
    with tempfile.TemporaryDirectory() as tmp:
        serve, serve_toks = cs.serve_main_path(
            np_params, os.path.join(tmp, "manifest.jsonl"))
    phases = (("serve_sample", lambda: cs.serve_sample(np_params),
               _profiles),
              ("serve_lora", lambda: cs.serve_lora(np_params), _profiles),
              ("serve_telemetry", lambda: cs.serve_telemetry(
                  np_params, serve, serve_toks, card), _telemetry))
    wanted = set(args.phases.split(","))
    phases = [ph for ph in phases if ph[0] in wanted]
    from mxnet_tpu_torch import profiler

    starts = ([float(v) for v in args.start_settle.split(",")]
              if args.start_settle else [profiler.START_SETTLE_S])
    failures = 0
    for it in range(args.iters):
        profiler.START_SETTLE_S = starts[it % len(starts)]
        for name, run, fields in phases:
            n_lines = len(cs.REPORT.get("lines", ()))
            t0 = time.perf_counter()
            error = None
            try:
                run()
            except (SystemExit, Exception) as e:   # recorded, then judged
                error = repr(e)[:300]
            line = next((ln for ln in reversed(cs.REPORT.get("lines", ())[
                n_lines:]) if ln.get("phase") == name), {})
            failures += error is not None
            print(json.dumps({"iter": it, "phase": name,
                              "ok": error is None, "error": error,
                              "seconds": time.perf_counter() - t0,
                              "package": package,
                              "smoke": os.path.dirname(cs.__file__),
                              "gc_enabled": gc.isenabled(),
                              "start_settle_s": profiler.START_SETTLE_S,
                              **fields(line)}),
                  flush=True)
    print(card, flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
