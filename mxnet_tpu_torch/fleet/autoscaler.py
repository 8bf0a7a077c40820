"""Role-aware fleet autoscaler: the policy half of the control plane.

A copy of the reference's ``mxnet_tpu/fleet/autoscaler.py`` over the
port's telemetry and flight recorder.  The sensor plane
(``FleetCollector``'s role-keyed ``/fleetz`` aggregates + burn-rate SLO
alerts) and the actuators (``Supervisor`` spawn/drain, the
prefill/decode role split) exist; this module closes the loop.  A
DistServe-shaped disaggregated fleet saturates its two pools on
*different* signals — prefill replicas on prompt queue depth and TTFT,
decode replicas on pending handoff ingests and KV/host-KV headroom and
TPOT — so the autoscaler scales each role's pool independently on its
own signals, within per-role min/max bounds.

Spec grammar (``MXTPU_AUTOSCALE_SPEC``)::

  spec     := entry (";" entry)*
  entry    := role "=" min ":" max        # a managed pool's bounds
            | knob "=" number             # policy knob
  role     := "both" | "prefill" | "decode"
  knob     := "up_queue"      # queued prompts per fresh replica that
                              #   mean "underprovisioned" (default 8)
            | "up_handoffs"   # waiting handoff ingests per fresh
                              #   decode replica (default 4)
            | "up_kv"         # mean device-KV occupancy (default 0.85)
            | "up_host_kv"    # mean host-KV occupancy (default 0.85)
            | "down_idle_s"   # quiet seconds before ONE scale-down
                              #   (default 30)
            | "cooldown_s"    # min seconds between actuations per
                              #   role, either direction (default 15)

Example: ``prefill=1:4;decode=1:8;up_queue=16;down_idle_s=30``.  Only
roles named in the spec are managed — an unlisted pool is never
touched, which is also what keeps prefill pressure from ever growing
the decode pool.

Hysteresis is deliberately asymmetric: scale-UP happens on the first
pressured evaluation (underprovisioning costs user latency *now*),
scale-DOWN only after ``down_idle_s`` of consecutively quiet windows
(capacity is cheap to keep for a beat, and load is bursty).  A
per-role cooldown bounds actuation frequency in both directions so a
chaos restart — which briefly looks like pressure (its queue drains
on siblings) then like idleness — cannot oscillate the fleet.

Staleness: pressure is computed over FRESH replicas only (the
collector's role aggregates already exclude replicas past the scrape
age cap), and a role with zero fresh replicas is held as-is — the
autoscaler never scales on dead data.

Every actuation increments
``mxtpu_fleet_scale_events_total{role,direction,reason}``, lands on
the collector's fleet timeline, and flight-dumps the surrounding
telemetry ring (``MXTPU_FLIGHT_DIR``) for post-mortems.
"""

from __future__ import annotations

import os
import threading
import time

from .. import telemetry
from ..telemetry import flight as flight_mod

__all__ = ["Autoscaler", "parse_autoscale_spec", "ENV_SPEC"]

ENV_SPEC = "MXTPU_AUTOSCALE_SPEC"

_ROLES = ("both", "prefill", "decode")
_KNOB_DEFAULTS = {
    "up_queue": 8.0,
    "up_handoffs": 4.0,
    "up_kv": 0.85,
    "up_host_kv": 0.85,
    "down_idle_s": 30.0,
    "cooldown_s": 15.0,
}


def parse_autoscale_spec(spec):
    """Parse the declarative autoscale spec (grammar above) into
    ``{"bounds": {role: (min, max)}, <knob>: float, ...}``.  Raises
    ``ValueError`` on malformed entries — a half-understood scaling
    policy must never run."""
    cfg = {"bounds": {}}
    cfg.update(_KNOB_DEFAULTS)
    for entry in str(spec).split(";"):
        entry = entry.strip()
        if not entry:
            continue
        key, sep, value = entry.partition("=")
        key, value = key.strip(), value.strip()
        if not sep or not value:
            raise ValueError(
                f"malformed autoscale entry {entry!r}: expected "
                "role=min:max or knob=number")
        if key in _ROLES:
            lo, sep2, hi = value.partition(":")
            try:
                lo, hi = int(lo), int(hi)
            except ValueError as e:
                raise ValueError(
                    f"malformed autoscale bounds {entry!r}: "
                    "expected role=min:max") from e
            if not sep2 or lo < 0 or hi < lo:
                raise ValueError(
                    f"bad autoscale bounds {entry!r}: need "
                    "0 <= min <= max")
            if key in cfg["bounds"]:
                raise ValueError(f"duplicate role in spec: {key!r}")
            cfg["bounds"][key] = (lo, hi)
        elif key in _KNOB_DEFAULTS:
            try:
                cfg[key] = float(value)
            except ValueError as e:
                raise ValueError(
                    f"malformed autoscale knob {entry!r}") from e
            if cfg[key] < 0:
                raise ValueError(f"negative autoscale knob {entry!r}")
        else:
            raise ValueError(
                f"unknown autoscale key {key!r} (roles: {_ROLES}; "
                f"knobs: {tuple(_KNOB_DEFAULTS)})")
    if not cfg["bounds"]:
        raise ValueError(
            f"autoscale spec {spec!r} names no role bounds "
            "(nothing to manage)")
    return cfg


def _objective_firing(slo_section, prefix):
    """True when any firing SLO objective's key starts with
    ``prefix`` (e.g. ``"ttft"``) — the burn-rate input per role."""
    if not slo_section:
        return False
    return any(o.get("firing") and str(o.get("objective", "")
                                       ).startswith(prefix)
               for o in slo_section.get("objectives") or ())


class Autoscaler:
    """The policy loop: read ``collector.fleet_view()``, scale each
    managed role's ``Supervisor`` pool.

    Args:
      collector: the ``FleetCollector`` whose role aggregates (and SLO
        section) drive the policy.
      pools: ``{role: Supervisor}`` — the per-role actuators (a bare
        ``Supervisor`` is accepted as ``{"both": sup}``).
      spec: the declarative policy — a spec string, a parsed dict from
        :func:`parse_autoscale_spec`, or None to read
        ``MXTPU_AUTOSCALE_SPEC`` (required: no spec, no autoscaler).
      interval_s: background-loop period (:meth:`start`); tests drive
        :meth:`evaluate` manually.
      clock: injectable monotonic clock (tests).
    """

    def __init__(self, collector, pools, spec=None, interval_s=2.0,
                 clock=time.monotonic):
        if spec is None:
            spec = os.environ.get(ENV_SPEC)
        if spec is None:
            raise ValueError(
                "no autoscale spec (pass spec= or set "
                f"{ENV_SPEC}, e.g. 'prefill=1:4;decode=1:8')")
        self.cfg = (spec if isinstance(spec, dict)
                    else parse_autoscale_spec(spec))
        if hasattr(pools, "add_slot"):     # a bare Supervisor
            pools = {"both": pools}
        self.pools = dict(pools)
        for role in self.cfg["bounds"]:
            if role not in self.pools:
                raise ValueError(
                    f"spec bounds name role {role!r} but no such "
                    f"pool was passed (pools: {tuple(self.pools)})")
        self.collector = collector
        self.interval_s = float(interval_s)
        self.clock = clock
        self._lock = threading.Lock()
        self._quiet_since = {}       # guarded-by: _lock — role -> t
        self._last_action_t = {}     # guarded-by: _lock — role -> t
        self._loop = None
        self._stop_evt = threading.Event()
        self._m_events = telemetry.counter(
            "mxtpu_fleet_scale_events_total",
            "autoscaler actuations by role, direction and reason",
            ("role", "direction", "reason"))

    # -- signals -------------------------------------------------------------
    def _pressure(self, role, agg, slo_section):
        """Scale-up reason for one role's FRESH aggregate, or None.
        Prefill saturates on prompt backlog + TTFT burn; decode on
        pending handoff ingests + KV headroom + TPOT burn; a classic
        "both" pool on any of them."""
        fresh = agg["replicas"] - agg["stale"]
        if fresh <= 0:
            return None              # dead data: never scale on it
        cfg = self.cfg
        if role in ("prefill", "both"):
            if agg["queue_depth"] / fresh >= cfg["up_queue"]:
                return "queue"
            if _objective_firing(slo_section, "ttft"):
                return "ttft_burn"
        if role in ("decode", "both"):
            if agg["waiting_handoffs"] / fresh >= cfg["up_handoffs"]:
                return "handoffs"
            kv = agg.get("kv_utilization_mean")
            if kv is not None and kv >= cfg["up_kv"]:
                return "kv"
            hkv = agg.get("host_kv_utilization_mean")
            if hkv is not None and hkv >= cfg["up_host_kv"]:
                return "host_kv"
            if _objective_firing(slo_section, "tpot"):
                return "tpot_burn"
        return None

    def _quiet(self, role, agg, slo_section):
        """True when the role carries no load at all — the only state
        that accrues scale-down credit."""
        if agg["replicas"] - agg["stale"] <= 0:
            return False             # unknown load is not "idle"
        if agg["queue_depth"] or agg["running"] \
                or agg["waiting_handoffs"]:
            return False
        if _objective_firing(slo_section, ""):
            return False             # any firing objective: not quiet
        return True

    # -- the policy step -----------------------------------------------------
    def evaluate(self, now=None):
        """One policy pass: at most ONE actuation per managed role.
        Returns ``[(role, direction, reason), ...]`` for what fired."""
        now = self.clock() if now is None else now
        view = self.collector.fleet_view()
        roles = view.get("roles") or {}
        slo_section = view.get("slo")
        actions = []
        for role, (lo, hi) in self.cfg["bounds"].items():
            sup = self.pools[role]
            size = sup.pool_size()
            agg = roles.get(role)
            with self._lock:
                last_t = self._last_action_t.get(role)
            in_cooldown = (last_t is not None
                           and now - last_t < self.cfg["cooldown_s"])
            if size < lo and not in_cooldown:
                # below the floor (e.g. a first pass, or bounds raised
                # live): restore minimum capacity before any policy
                self._actuate(sup, role, "up", "min_bound", now)
                actions.append((role, "up", "min_bound"))
                continue
            if agg is None:
                continue             # role not scraped yet: hold
            reason = self._pressure(role, agg, slo_section)
            if reason is not None:
                with self._lock:
                    self._quiet_since.pop(role, None)
                if size < hi and not in_cooldown:
                    self._actuate(sup, role, "up", reason, now)
                    actions.append((role, "up", reason))
                continue
            if not self._quiet(role, agg, slo_section):
                with self._lock:
                    self._quiet_since.pop(role, None)
                continue
            with self._lock:
                since = self._quiet_since.setdefault(role, now)
            if now - since < self.cfg["down_idle_s"]:
                continue             # quiet, but not for long enough
            if size > lo and not in_cooldown:
                self._actuate(sup, role, "down", "idle", now)
                actions.append((role, "down", "idle"))
        return actions

    def _actuate(self, sup, role, direction, reason, now):
        """One scaling action: spawn a fresh slot or drain out the
        newest one, then stamp the cooldown + observability trail."""
        if direction == "up":
            slot = sup.add_slot()
        else:
            slot = sup.active_slots()[-1]
            sup.remove_slot(slot)
        with self._lock:
            self._last_action_t[role] = now
            # an actuation resets the idle ledger either way: the next
            # scale-down needs a full fresh quiet window
            self._quiet_since.pop(role, None)
        self._m_events.labels(role=role, direction=direction,
                              reason=reason).inc()
        size = sup.pool_size()
        try:
            self.collector.annotate(
                "autoscale", role=role, direction=direction,
                reason=reason, slot=slot, pool_size=size)
        # mxtpu-lint: disable=swallowed-exception (the timeline is
        # observability; a broken collector endpoint must never abort
        # a scaling actuation mid-flight)
        except Exception:
            pass
        flight_mod.recorder().dump(
            f"autoscale_{direction}_{role}",
            extra={"role": role, "direction": direction,
                   "reason": reason, "slot": slot, "pool_size": size})
        if direction == "up" and hasattr(sup, "rebalance_catalog"):
            # a scaled-up replica starts with an empty adapter store:
            # one catalog pass spreads the hot adapters onto the pool
            # (no-op without an attached rebalancer — and the fresh
            # replica converges on later passes once it is scraped)
            sup.rebalance_catalog(reason=f"scale_up_{role}")

    # -- background loop -----------------------------------------------------
    def start(self):
        """Background policy thread pumping :meth:`evaluate` every
        ``interval_s`` (errors counted, never fatal — a flaky scrape
        must not kill the control loop)."""
        if self._loop is not None:
            return self
        self._stop_evt.clear()

        def loop():
            while not self._stop_evt.wait(self.interval_s):
                try:
                    self.evaluate()
                except Exception:
                    telemetry.counter(
                        "mxtpu_fleet_autoscaler_errors_total",
                        "autoscaler evaluate() failures").inc()

        self._loop = threading.Thread(
            target=loop, daemon=True, name="mxtpu-fleet-autoscaler")
        self._loop.start()
        return self

    def stop(self):
        self._stop_evt.set()
        if self._loop is not None:
            self._loop.join(timeout=5)
            self._loop = None

    def statusz(self):
        """Policy state for dashboards: bounds, knobs, per-role idle
        ledger and cooldown stamps."""
        with self._lock:
            return {
                "bounds": {r: list(b)
                           for r, b in self.cfg["bounds"].items()},
                "knobs": {k: self.cfg[k] for k in _KNOB_DEFAULTS},
                "pool_size": {r: self.pools[r].pool_size()
                              for r in self.cfg["bounds"]},
                "quiet_since": dict(self._quiet_since),
                "last_action_t": dict(self._last_action_t),
            }
