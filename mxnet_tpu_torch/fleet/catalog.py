"""Fleet model-catalog rebalancer: adapter placement follows traffic.

A copy of the reference's ``mxnet_tpu/fleet/catalog.py`` over the port's
telemetry; its actuators are the port replica's adapter endpoints
(``/adapter_export`` -> ``/load_adapter``, ``/unload_adapter``), whose
wire records a replica of either package reads.

The adapter half of the multi-tenant catalog is per-replica state: a
replica serves only the LoRA adapters registered in its own
``AdapterStore`` (advertised on ``/statusz.json`` and scraped into the
collector's per-model aggregates).  Left alone, placement drifts away
from demand — a freshly scaled-up replica carries no adapters at all,
and a traffic shift can leave a hot adapter registered on one replica
while the router load-balances its requests across five.

``CatalogRebalancer`` closes that gap with the same sensor the
autoscaler uses — ``FleetCollector.fleet_view()`` — and the replica
adapter endpoints as actuators:

* **plan()** compares each model's per-adapter goodput
  (``models[tag]["adapter_goodput"]``) against placement (each fresh
  replica's advertised adapter ids) and emits moves: ``spread`` a
  hot adapter (observed traffic, missing from some replica of its
  model) from a replica that has it to each replica that doesn't;
  optionally ``retire`` idle adapters (registered, zero observed
  traffic) when ``retire_idle`` is set.
* **apply()** executes moves replica-to-replica with no shared
  filesystem: ``/adapter_export`` on the source (sha1-stamped wire
  records) piped into ``/load_adapter`` on the destination; ``retire``
  posts ``/unload_adapter`` (a 503 ``adapter_pinned`` — requests still
  running on the adapter — is reported, not retried; the next pass
  will catch it).

Moves are capped per pass (``max_moves``) so one rebalance can never
turn into a fleet-wide copy storm; what was dropped is visible in the
returned plan vs applied counts.  Every applied move increments
``mxtpu_fleet_catalog_moves_total{action,outcome}`` and lands on the
collector's fleet timeline.

The ``Supervisor.rebalance_catalog`` actuator (invoked by the
autoscaler after a scale-up, or manually) is a thin wrapper over
:meth:`rebalance`.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request

from .. import telemetry

__all__ = ["CatalogRebalancer"]


def _post_json(url, path, body, timeout_s):
    req = urllib.request.Request(
        f"{url.rstrip('/')}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        return json.loads(resp.read())


class CatalogRebalancer:
    """Plan/apply adapter placement moves for one fleet.

    Args:
      collector: the ``FleetCollector`` whose ``fleet_view()`` supplies
        both traffic (per-model adapter goodput) and placement (each
        replica's advertised adapter ids).
      max_moves: cap on moves applied per :meth:`rebalance` pass.
      retire_idle: also unload adapters with zero observed traffic
        (default off — goodput rings start empty, and "no traffic yet"
        must not de-catalog a freshly loaded adapter).
      timeout_s: per-HTTP-call timeout for export/load/unload.
      clock: injectable monotonic clock (tests).
    """

    def __init__(self, collector, max_moves=4, retire_idle=False,
                 timeout_s=30.0, clock=time.monotonic):
        self.collector = collector
        self.max_moves = int(max_moves)
        self.retire_idle = bool(retire_idle)
        self.timeout_s = float(timeout_s)
        self.clock = clock
        self._m_moves = telemetry.counter(
            "mxtpu_fleet_catalog_moves_total",
            "catalog rebalance moves by action and outcome",
            ("action", "outcome"))

    # -- planning ------------------------------------------------------------
    def plan(self, view=None):
        """Placement moves implied by one fleet view (no side effects).

        Returns ``[{"action", "model", "adapter", "src", "dst"}, ...]``
        ordered hot-adapters-first; ``dst`` is None for ``retire``.
        """
        if view is None:
            view = self.collector.fleet_view()
        fresh = [r for r in (view.get("replicas") or [])
                 if not r.get("stale") and r.get("adapters") is not None]
        moves = []
        for tag in sorted(view.get("models") or {}):
            m = view["models"][tag]
            carriers = [r for r in fresh if r.get("model") == tag]
            if len(carriers) < 1:
                continue
            traffic = m.get("adapter_goodput") or {}
            # spread: every adapter with observed traffic belongs on
            # every fresh replica of its model (the router can only
            # route an adapter request to a replica advertising it)
            for a in sorted(traffic, key=lambda k: -traffic[k]):
                if not traffic[a]:
                    continue
                have = [r for r in carriers if a in r["adapters"]]
                if not have:
                    continue         # traffic but no live copy: stuck
                for dst in carriers:
                    if a not in dst["adapters"]:
                        moves.append({
                            "action": "spread", "model": tag,
                            "adapter": a, "src": have[0]["url"],
                            "dst": dst["url"]})
            if self.retire_idle:
                for r in carriers:
                    for a in sorted(r["adapters"]):
                        if not traffic.get(a):
                            moves.append({
                                "action": "retire", "model": tag,
                                "adapter": a, "src": r["url"],
                                "dst": None})
        return moves

    # -- actuation -----------------------------------------------------------
    def _apply_one(self, mv):
        if mv["action"] == "spread":
            payload = _post_json(mv["src"], "/adapter_export",
                                 {"adapter": mv["adapter"]},
                                 self.timeout_s)
            _post_json(mv["dst"], "/load_adapter", payload,
                       self.timeout_s)
        else:
            _post_json(mv["src"], "/unload_adapter",
                       {"adapter": mv["adapter"]}, self.timeout_s)

    def apply(self, moves):
        """Execute up to ``max_moves`` planned moves; a failed move
        (unreachable peer, pinned adapter, corrupt wire payload) is
        reported in its result row and never aborts the rest."""
        results = []
        for mv in moves[:self.max_moves]:
            row = dict(mv, ok=True)
            try:
                self._apply_one(mv)
            except urllib.error.HTTPError as e:
                row["ok"] = False
                try:
                    row["error"] = (json.loads(e.read())
                                    .get("error") or f"http_{e.code}")
                except (ValueError, OSError):
                    row["error"] = f"http_{e.code}"
            except (urllib.error.URLError, OSError, ValueError) as e:
                row["ok"] = False
                row["error"] = str(e)[:200]
            self._m_moves.labels(
                action=mv["action"],
                outcome="ok" if row["ok"] else "error").inc()
            results.append(row)
        return results

    def rebalance(self, view=None):
        """One plan+apply pass; returns the applied result rows and
        stamps the fleet timeline with what happened (planned count
        included so capped passes are visible as planned > applied)."""
        moves = self.plan(view)
        results = self.apply(moves)
        if results:
            try:
                self.collector.annotate(
                    "catalog_rebalance", planned=len(moves),
                    applied=len(results),
                    ok=sum(1 for r in results if r["ok"]))
            # mxtpu-lint: disable=swallowed-exception (timeline is
            # observability; a broken collector endpoint must never
            # abort a rebalance mid-pass)
            except Exception:
                pass
        return results
