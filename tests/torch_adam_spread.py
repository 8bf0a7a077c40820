#!/usr/bin/env python3
"""Spread of the port's Adam steps against the reference's, by draw.

``tests/test_torch_trainer_adam.py::test_three_adam_steps_match_reference``
starts both trainers from the reference's ``Xavier`` draw, which comes
from numpy's global RNG, seeded by ``train_pair`` (the test's seed is
``TRAIN_INIT_SEED``).  This script draws at other seeds, takes the
test's 3 Adam steps in both frameworks and prints, for each seed, one
JSON line: the worst share of the test's per-element bound
(``adam_param_bound``, port against reference) and its parameter, and
the worst share between the port's own parameters at two torch thread
counts (two summation orders).

    JAX_PLATFORMS=cpu python tests/torch_adam_spread.py --seeds 0:40

ROADMAP §C4 records the spread over seeds 0-39, 1000-1039, ..., 5000-5039.

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


def worst_share(got, want, step_grads, drifts, variant, drift=True):
    """Worst |got - want| / allowed of the test's bound, and its name;
    with ``drift`` False, of the bound without the drift term."""
    from test_torch_trainer_adam import adam_param_bound

    if not drift:
        drifts = [{k: torch.zeros_like(g) for k, g in d.items()}
                  for d in drifts]
    worst = (-1.0, "")
    for k in want:
        allowed = adam_param_bound(k, step_grads, drifts, variant)
        share = float((np.abs(got[k] - want[k]) / allowed).max())
        worst = max(worst, (share, k))
    return worst


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
    from test_torch_trainer_adam import adam_steps

    t1, t2 = (int(t) for t in args.threads.split(","))
    lo, hi = (int(x) for x in args.seeds.split(":"))
    batch = fx.train_batch()
    for seed in range(lo, hi):
        ref, port = fx.train_pair(args.variant, "adam", seed=seed)
        other = fx.port_trainer(args.variant, "adam")
        other.set_params(ref.get_params())
        probe = fx.port_trainer(args.variant, "adam")
        with fx.pinned_threads(t1):
            _, _, grads, drifts = adam_steps(ref, port, probe, batch)
        with fx.pinned_threads(t2):
            for _ in range(3):
                other.step(batch)
        a, want = port.get_params(), ref.get_params()
        share, name = worst_share(a, want, grads, drifts, args.variant)
        no_drift, nd_name = worst_share(a, want, grads, drifts,
                                        args.variant, drift=False)
        order, _ = worst_share(a, other.get_params(), grads, drifts,
                               args.variant)
        print(json.dumps({"seed": seed, "variant": args.variant,
                          "worst_share_vs_reference": share,
                          "worst_param": name,
                          "worst_share_without_drift": no_drift,
                          "worst_param_without_drift": nd_name,
                          f"share_threads_{t1}_vs_{t2}": order,
                          "torch": torch.__version__}), flush=True)


if __name__ == "__main__":
    main()
