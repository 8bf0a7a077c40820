#!/usr/bin/env python3
"""Spread of the port's Adam steps against the reference's, by draw.

``tests/test_torch_trainer_adam.py::test_three_adam_steps_match_reference``
starts both trainers from the reference's ``Xavier`` draw, which comes
from numpy's global RNG.  This script seeds that RNG per draw, takes the
test's 3 Adam steps in both frameworks and prints, for each seed, one
JSON line: the worst share of the test's per-element bound (port against
reference) and its parameter, and the worst share between the port's own
parameters at two torch thread counts (two summation orders).

    JAX_PLATFORMS=cpu python tests/torch_adam_spread.py --seeds 0:40

Runs on the CPU; each draw takes a few seconds.  Not a test module: it
measures what the test's bound covers (ROADMAP §C4).
"""

import argparse
import json
import os
import sys

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(TESTS), TESTS]

import numpy as np  # noqa: E402
import torch  # noqa: E402


def worst_share(got, want, grads, variant):
    """Worst |got - want| / allowed of the test's bound, and its name."""
    import torch_port_fixtures as fx
    from test_torch_trainer_adam import (ADAM_PARAM_TOL, GRAD_NOISE,
                                         _zero_grad_rows)

    lr = fx.TRAIN_OPTS["adam"]["learning_rate"]
    worst = (-1.0, "")
    for k in want:
        g = grads[k].abs().numpy()
        allowed = ADAM_PARAM_TOL + 3 * lr * np.minimum(
            2.0, GRAD_NOISE * float(g.max()) / np.maximum(g, 1e-30))
        rows = _zero_grad_rows(k, variant)
        if rows is not None:
            allowed[rows] = ADAM_PARAM_TOL + 6 * lr
        share = float((np.abs(got[k] - want[k]) / allowed).max())
        worst = max(worst, (share, k))
    return worst


def port_steps(start, threads, variant):
    """The port's parameters after the test's 3 Adam steps from
    ``start`` at ``threads`` torch threads, and its first gradients."""
    import mxnet_tpu_torch as mt
    import torch_port_fixtures as fx

    shape = (fx.TRAIN_BATCH, fx.TRAIN_SEQ)
    with fx.pinned_threads(threads):
        port = mt.parallel.ShardedTrainer(
            mt.models.gpt(fx.VOCAB, fx.TRAIN_SEQ, **fx.TRAIN_BASE,
                          **fx.TRAIN_VARIANTS[variant]),
            {"data": shape, "softmax_label": shape}, optimizer="adam",
            optimizer_params=fx.TRAIN_OPTS["adam"],
            input_dtypes={"data": np.int32, "softmax_label": np.int32},
            device="cpu")
        port.set_params(start)
        batch = fx.train_batch()
        grads, _ = port._grads_of(port._place_batch(batch))
        for _ in range(3):
            port.step(batch)
        return port.get_params(), grads


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", default="fused_qkv")
    ap.add_argument("--seeds", default="0:10", help="first:end")
    ap.add_argument("--threads", default="1,8",
                    help="the two torch thread counts compared")
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch_port_fixtures as fx

    t1, t2 = (int(t) for t in args.threads.split(","))
    lo, hi = (int(x) for x in args.seeds.split(":"))
    for seed in range(lo, hi):
        np.random.seed(seed)
        ref, _ = fx.train_pair(args.variant, "adam")
        start = ref.get_params()
        batch = fx.train_batch()
        for _ in range(3):
            ref.step(batch)
        a, grads = port_steps(start, t1, args.variant)
        b, _ = port_steps(start, t2, args.variant)
        share, name = worst_share(a, ref.get_params(), grads, args.variant)
        order, _ = worst_share(a, b, grads, args.variant)
        print(json.dumps({"seed": seed, "variant": args.variant,
                          "worst_share_vs_reference": share,
                          "worst_param": name,
                          f"share_threads_{t1}_vs_{t2}": order,
                          "torch": torch.__version__}), flush=True)


if __name__ == "__main__":
    main()
