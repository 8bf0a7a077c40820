"""Deterministic fault injection for the fleet chaos tests.

A copy of the reference's ``mxnet_tpu/fleet/faults.py`` (stdlib only):
the same grammar, knobs and matching rules.

Chaos testing is only worth anything when the chaos is reproducible:
"the replica died at some point and things mostly recovered" proves
nothing, "the replica dies exactly at its 5th request, mid-stream, and
every client request still completes with identical tokens" is a gate.
The injector triggers on the ARRIVAL INDEX of ``/generate`` requests at
one replica (1-based, counted by that replica's injector), so a fault
spec plus a deterministic workload pins the exact failure point.

Spec grammar (``MXTPU_FAULT_SPEC``, or the ``spec=`` argument)::

  spec    := rule (";" rule)*
  rule    := action "@" k [":" arg]
  action  := "kill" | "delay" | "refuse" | "hang"
  k       := 1-based /generate arrival index at this replica
  arg     :=  delay: seconds to sleep before serving (default 0.05)
              refuse: how many consecutive requests to 503 (default 1)
              hang: seconds to hold the connection without answering
                    (default 3600 — practically forever)
              kill: ignored

Examples::

  kill@5                die (hard process exit / in-process hard stop)
                        while serving the 5th request, mid-stream
  delay@2:0.25          sleep 250ms before serving request 2
  refuse@3:2            503 requests 3 and 4 (retriable rejection)
  hang@7:30             hold request 7 open unanswered for 30s
  refuse@1;kill@9       rules compose; first matching rule wins

The supervisor/bench inject a spec into ONE replica's environment; the
others run clean.  An empty/unset spec parses to an injector that never
fires, so the hook can stay unconditionally wired in the replica.

Host-KV restore-delay fault (not arrival-indexed)
-------------------------------------------------

``MXTPU_FAULT_HOST_RESTORE_DELAY=<seconds>`` simulates a slow
DRAM→HBM copy on every host-KV-tier restore claim inside the serve
engine (``serve.kv_block_manager.HostKVPool``).  With
``MXTPU_SERVE_HOST_KV_RESTORE_BUDGET`` set, a delay past the budget
DEGRADES that radix hit to recompute — the entry stays hosted, the
engine prefills the span as if it missed — instead of stalling the
step loop on the copy; the pool's ``degraded`` counter and the
replica's ``host_kv_utilization`` load signal make the degradation
observable fleet-wide.  Read at pool construction (engine start), so
the chaos harness sets it in the target replica's environment like
``MXTPU_FAULT_SPEC``.

Handoff faults (disaggregated prefill/decode fleets)
----------------------------------------------------

Two chaos knobs target the prefill→decode KV handoff a role-split
fleet rides (docs/how_to/fleet.md "Disaggregated prefill/decode"):

``MXTPU_FAULT_HANDOFF_DELAY=<seconds>`` sleeps that long at the START
of every ``/handoff`` arrival at the target replica — a simulated slow
wire.  Pushed past the router's per-hop timeout it exercises the
retry-on-sibling re-handoff path (the router still holds the payload).

``MXTPU_FAULT_HANDOFF_DROP=<n>`` discards the KV records of the first
``n`` handoff arrivals at the target replica before import — the
payload "arrives truncated".  The receiving replica degrades to
recompute-from-prompt (the handoff body always carries the prompt),
so tokens stay byte-identical to a role="both" run; only the prefill
compute is re-paid and the replica's ``handoff`` counters show zero
imports.

Both are read at ``ReplicaServer`` construction (constructor arguments
``handoff_delay_s=`` / ``handoff_drop=`` win), set per target replica
like ``MXTPU_FAULT_SPEC``.  The arrival-indexed grammar above also
covers ``/handoff``: the injector counts handoff arrivals through the
same ``on_request`` hook, so ``kill@2`` on a decode replica kills it
mid-stream while serving its 2nd handoff.
"""

from __future__ import annotations

import threading

__all__ = ["Fault", "FaultInjector", "parse_fault_spec", "ENV_SPEC",
           "ENV_HOST_RESTORE_DELAY", "ENV_HOST_RESTORE_BUDGET",
           "ENV_HANDOFF_DELAY", "ENV_HANDOFF_DROP", "ACTIONS"]

ENV_SPEC = "MXTPU_FAULT_SPEC"

# declared as plain strings (NOT imported from serve.kv_block_manager,
# whose module also names them — that import would drag torch and the
# serve chain into this deliberately stdlib-only module); the
# canonical reader is serve.kv_block_manager.HostKVPool
ENV_HOST_RESTORE_DELAY = "MXTPU_FAULT_HOST_RESTORE_DELAY"
ENV_HOST_RESTORE_BUDGET = "MXTPU_SERVE_HOST_KV_RESTORE_BUDGET"

# prefill→decode handoff chaos (canonical reader: replica.ReplicaServer)
ENV_HANDOFF_DELAY = "MXTPU_FAULT_HANDOFF_DELAY"
ENV_HANDOFF_DROP = "MXTPU_FAULT_HANDOFF_DROP"

ACTIONS = ("kill", "delay", "refuse", "hang")

_DEFAULT_ARGS = {"delay": 0.05, "refuse": 1.0, "hang": 3600.0}


class Fault:
    """One parsed rule: ``action`` at arrival index ``at`` with ``arg``."""

    __slots__ = ("action", "at", "arg")

    def __init__(self, action, at, arg=None):
        if action not in ACTIONS:
            raise ValueError(f"unknown fault action {action!r} "
                             f"(one of {', '.join(ACTIONS)})")
        self.action = action
        self.at = int(at)
        if self.at < 1:
            raise ValueError(f"fault index must be >= 1 (got {at})")
        self.arg = float(_DEFAULT_ARGS.get(action, 0.0)
                         if arg is None else arg)

    def matches(self, index):
        """Whether this rule fires for the ``index``-th request.
        ``refuse`` covers a RANGE (``arg`` consecutive requests);
        everything else is a single index."""
        if self.action == "refuse":
            return self.at <= index < self.at + max(1, int(self.arg))
        return index == self.at

    def __repr__(self):
        return f"Fault({self.action}@{self.at}:{self.arg})"


def parse_fault_spec(spec):
    """Parse the ``MXTPU_FAULT_SPEC`` grammar into ``[Fault, ...]``.
    Raises ``ValueError`` on malformed rules — a chaos run with a typo'd
    spec silently testing nothing would be worse than a crash."""
    faults = []
    for rule in (spec or "").split(";"):
        rule = rule.strip()
        if not rule:
            continue
        if "@" not in rule:
            raise ValueError(
                f"malformed fault rule {rule!r}: expected action@k[:arg]")
        action, _, rest = rule.partition("@")
        at, _, arg = rest.partition(":")
        try:
            faults.append(Fault(action.strip(), int(at),
                                float(arg) if arg else None))
        except ValueError as e:
            raise ValueError(f"malformed fault rule {rule!r}: {e}") from e
    return faults


class FaultInjector:
    """Thread-safe arrival counter + rule matcher for one replica.

    ``spec=None`` reads ``MXTPU_FAULT_SPEC`` (unset -> no faults).  The
    replica calls :meth:`on_request` once per ``/generate`` arrival and
    interprets the returned :class:`Fault` (or ``None``); the injector
    itself never sleeps or kills — policy stays in one place, the
    replica, where the test can also stub it in-process.
    """

    def __init__(self, spec=None):
        if spec is None:
            import os

            spec = os.environ.get(ENV_SPEC, "")
        self.faults = (list(spec) if isinstance(spec, (list, tuple))
                       else parse_fault_spec(spec))
        self._lock = threading.Lock()
        self._count = 0            # guarded-by: _lock
        self.fired = []            # guarded-by: _lock

    @property
    def count(self):
        with self._lock:
            return self._count

    def on_request(self):
        """Count one arrival; return the first matching ``Fault`` (and
        record it in :attr:`fired`) or ``None``."""
        with self._lock:
            self._count += 1
            index = self._count
            for f in self.faults:
                if f.matches(index):
                    self.fired.append((index, f))
                    return f
        return None
