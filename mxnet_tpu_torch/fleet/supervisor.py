"""Replica supervisor: spawn N replicas, restart crashes, roll restarts.

The port of ``mxnet_tpu/fleet/supervisor.py``: the same slot logic, its
default spawn target is the port's process front
(``python -m mxnet_tpu_torch.fleet.serve_replica``).

The supervisor owns the fleet's process story the way dmlc-core's
tracker owned the reference's cluster jobs: it spawns N replica slots,
probes their ``/healthz``, restarts a crashed slot with capped
exponential backoff, and performs the drain -> checkpointless warm
restart sequence that makes a rolling restart of the whole fleet
invisible to clients:

  1. POST /drain — the replica stops admitting (router retries those
     rejections on siblings) and finishes its in-flight work
     token-identically;
  2. wait until ``/healthz`` reports the drain complete (no queued, no
     running, no in-flight handler work);
  3. terminate the process and spawn the replacement — which starts
     WARM: the export store and the warmup manifest (``MXTPU_AOT_DIR``
     / ``MXTPU_WARMUP_MANIFEST``, carried in the spawn's environment)
     load and capture every bucket program the traffic ran, without a
     fresh trace, before the ready line, so the slot is back in
     rotation without capturing under traffic;
  4. next slot.

The supervisor is deliberately transport-agnostic: a *handle* is
anything with ``poll() -> None | returncode``, ``terminate()`` and a
``url``.  :class:`ProcessReplica` is the real one (process-front
subprocesses); tests drive the same
supervisor with in-process handles, so the restart/drain logic is
tier-1-testable without process spawn latency.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
import urllib.request

from .. import telemetry
from ..base import env_float

__all__ = ["Supervisor", "ProcessReplica", "probe_health"]


def probe_health(url, timeout=2.0):
    """GET ``<url>/healthz`` -> dict, or None when unreachable (the
    liveness probe — rides the cheap endpoint, never /statusz)."""
    try:
        with urllib.request.urlopen(f"{url.rstrip('/')}/healthz",
                                    timeout=timeout) as resp:
            return json.loads(resp.read())
    except (OSError, ValueError):
        return None


class ProcessReplica:
    """One replica subprocess (the process front,
    ``mxnet_tpu_torch/fleet/serve_replica.py``).

    The child prints a single ``{"ready": true, "port": N, ...}`` JSON
    line once serving; :meth:`wait_ready` blocks on it.  Stdout is
    drained by a daemon thread so the child can never block on a full
    pipe; the last lines are kept for post-mortems.
    """

    def __init__(self, args, env=None):
        self.args = list(args)
        self.proc = subprocess.Popen(
            self.args, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env)
        self.url = None
        self.port = None
        self._lock = threading.Lock()
        self._lines = []           # guarded-by: _lock
        self._ready = threading.Event()
        self._reader = threading.Thread(target=self._drain, daemon=True)
        self._reader.start()

    def _drain(self):
        for line in self.proc.stdout:
            line = line.rstrip("\n")
            with self._lock:
                self._lines.append(line)
                del self._lines[:-50]
            if not self._ready.is_set() and line.startswith("{"):
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if rec.get("ready"):
                    self.port = int(rec["port"])
                    host = rec.get("host", "127.0.0.1")
                    self.url = f"http://{host}:{self.port}"
                    self._ready.set()

    def wait_ready(self, timeout_s=120.0):
        """Block until the child printed its ready line (-> url) or
        died; returns the url or raises RuntimeError with the tail of
        its output."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self._ready.wait(0.1):
                return self.url
            if self.proc.poll() is not None:
                break
        with self._lock:
            tail = "\n".join(self._lines[-15:])
        raise RuntimeError(
            f"replica process not ready (rc={self.proc.poll()}):\n{tail}")

    def poll(self):
        return self.proc.poll()

    def terminate(self, grace_s=10.0):
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=grace_s)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=grace_s)

    def output_tail(self):
        with self._lock:
            return "\n".join(self._lines[-50:])


def replica_command(port=0, extra_args=(), python=None):
    """argv for one process-front child (``python -m
    mxnet_tpu_torch.fleet.serve_replica``, the default
    :class:`Supervisor` spawn target).  The child imports this package,
    so its parent directory must be on the child's ``sys.path`` (run
    from the repository root, or set ``PYTHONPATH``)."""
    return ([python or sys.executable, "-m",
             "mxnet_tpu_torch.fleet.serve_replica",
             "--port", str(port)] + list(extra_args))


class Supervisor:
    """Spawn/monitor/restart N replica slots.

    Args (env default in parens):
      spawn: ``spawn(slot) -> handle`` (poll/terminate/url — see
        module docstring).  For processes, wrap :class:`ProcessReplica`
        and call ``wait_ready`` inside your spawn.
      n: number of slots.
      restart_backoff_s / restart_backoff_max_s: capped exponential
        backoff between a slot's crash-restarts
        (``MXTPU_FLEET_RESTART_BACKOFF`` 0.5 /
        ``MXTPU_FLEET_RESTART_BACKOFF_MAX`` 30).
      drain_timeout_s: max wait for a drain to complete before the
        slot is restarted anyway (``MXTPU_FLEET_DRAIN_TIMEOUT``, 120).
      router: optional ``fleet.Router`` whose membership follows
        respawns (old url out, new url in).
      collector: optional ``fleet.FleetCollector`` — lifecycle events
        (crash-restart, drain, respawn, rolling-restart phases) are
        pushed as annotations onto its fleet timeline, so ``/fleetz``
        explains a load dip ("slot 2 was rolling") without log
        archaeology.
      catalog: optional ``fleet.CatalogRebalancer`` behind
        :meth:`rebalance_catalog`.
      clock/sleep: injectable (tests).
    """

    def __init__(self, spawn, n, restart_backoff_s=None,
                 restart_backoff_max_s=None, drain_timeout_s=None,
                 router=None, collector=None, catalog=None,
                 clock=time.monotonic, sleep=time.sleep):
        self.spawn = spawn
        self.n = int(n)
        # optional CatalogRebalancer: the adapter-placement actuator
        # behind rebalance_catalog() (wired once at construction,
        # read-only afterwards — no lock needed)
        self.catalog = catalog
        self.restart_backoff_s = (
            float(restart_backoff_s) if restart_backoff_s is not None
            else env_float("MXTPU_FLEET_RESTART_BACKOFF", 0.5))
        self.restart_backoff_max_s = (
            float(restart_backoff_max_s)
            if restart_backoff_max_s is not None
            else env_float("MXTPU_FLEET_RESTART_BACKOFF_MAX", 30.0))
        self.drain_timeout_s = (
            float(drain_timeout_s) if drain_timeout_s is not None
            else env_float("MXTPU_FLEET_DRAIN_TIMEOUT", 120.0))
        self.router = router
        self.collector = collector
        self.clock = clock
        self.sleep = sleep
        self._lock = threading.RLock()
        self._handles = [None] * self.n      # guarded-by: _lock
        self._restarts = [0] * self.n        # guarded-by: _lock
        self._next_restart_t = [0.0] * self.n  # guarded-by: _lock
        # slots mid-drain_and_restart: the crash monitor must not also
        # respawn them (it would see the intentionally-terminated
        # handle as a crash and double-spawn an orphan replica)
        self._rolling = set()                # guarded-by: _lock
        # slots drained out by scale-down.  Indices are NEVER reused —
        # a slot keeps its identity in metrics/annotations forever, so
        # "slot 3 restarted twice" stays meaningful across pool resizes
        self._retired = set()                # guarded-by: _lock
        self._monitor = None
        self._stop_evt = threading.Event()
        self._m_restarts = telemetry.counter(
            "mxtpu_fleet_restarts_total",
            "replica restarts by slot and reason (crash / rolling)",
            ("slot", "reason"))

    def _annotate(self, kind, **fields):
        """Push one lifecycle event onto the fleet timeline (no-op
        without a collector; a broken collector must never take the
        supervisor down with it)."""
        if self.collector is None:
            return
        try:
            self.collector.annotate(kind, **fields)
        except Exception:
            telemetry.counter(
                "mxtpu_fleet_supervisor_errors_total",
                "supervisor monitor failures").inc()

    # -- membership ----------------------------------------------------------
    def handles(self):
        with self._lock:
            return list(self._handles)

    def urls(self):
        return [h.url for h in self.handles() if h is not None]

    def active_slots(self):
        """Slot indices currently backing the pool (retired scale-down
        slots excluded)."""
        with self._lock:
            return [s for s in range(self.n) if s not in self._retired]

    def pool_size(self):
        return len(self.active_slots())

    def start(self):
        """Spawn every slot (serially — replica startup may compile)."""
        for slot in range(self.n):
            self._spawn_slot(slot)
        return self

    def _spawn_slot(self, slot, factory=None):
        with self._lock:
            old = self._handles[slot]
        # the old url leaves the rotation BEFORE the (slow) spawn: a
        # connect to a stopped replica's port is not always refused (on
        # some hosts it goes unanswered until the router's hop timeout)
        self._out_of_rotation(old)
        handle = (factory or self.spawn)(slot)
        with self._lock:
            self._handles[slot] = handle
        if self.router is not None and handle.url:
            self.router.add_replica(handle.url)
        return handle

    def _out_of_rotation(self, handle):
        if self.router is not None and handle is not None and handle.url:
            self.router.remove_replica(handle.url)

    # -- crash monitoring ----------------------------------------------------
    def check(self):
        """One monitor pass: restart every crashed slot whose backoff
        window has elapsed.  Returns the slots restarted."""
        restarted = []
        now = self.clock()
        for slot in range(self.n):
            with self._lock:
                h = self._handles[slot]
                due = self._next_restart_t[slot] <= now
                rolling = slot in self._rolling
            if rolling or h is None or h.poll() is None:
                continue
            if not due:
                continue            # crashed, but inside backoff
            with self._lock:
                # claim the slot for the duration of the (slow) spawn:
                # a drain_and_restart that starts meanwhile must wait
                # rather than double-spawn an orphan replica
                if slot in self._rolling:
                    continue
                self._rolling.add(slot)
                self._restarts[slot] += 1
                n_restarts = self._restarts[slot]
                backoff = min(self.restart_backoff_max_s,
                              self.restart_backoff_s
                              * 2 ** (n_restarts - 1))
                self._next_restart_t[slot] = now + backoff
            self._m_restarts.labels(slot=str(slot), reason="crash").inc()
            self._annotate("replica_crash_restart", slot=slot,
                           url=getattr(h, "url", None),
                           restarts=n_restarts,
                           backoff_s=round(backoff, 3))
            try:
                handle = self._spawn_slot(slot)
                self._annotate("replica_respawn", slot=slot,
                               url=getattr(handle, "url", None),
                               reason="crash")
            finally:
                with self._lock:
                    self._rolling.discard(slot)
            restarted.append(slot)
        return restarted

    def note_healthy(self, slot):
        """Reset a slot's crash-backoff (call once its replacement
        serves traffic again)."""
        with self._lock:
            self._restarts[slot] = 0
            self._next_restart_t[slot] = 0.0

    def run(self, interval_s=1.0):
        """Background monitor thread pumping :meth:`check`."""
        if self._monitor is not None:
            return self
        self._stop_evt.clear()

        def loop():
            while not self._stop_evt.wait(interval_s):
                try:
                    self.check()
                except Exception:
                    telemetry.counter(
                        "mxtpu_fleet_supervisor_errors_total",
                        "supervisor monitor failures").inc()

        self._monitor = threading.Thread(
            target=loop, daemon=True, name="mxtpu-fleet-supervisor")
        self._monitor.start()
        return self

    def stop(self, terminate=True):
        self._stop_evt.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5)
            self._monitor = None
        if terminate:
            for h in self.handles():
                if h is not None:
                    h.terminate()

    # -- drain / rolling restart ---------------------------------------------
    def drain(self, slot):
        """POST /drain to one slot; returns True when accepted."""
        h = self.handles()[slot]
        if h is None or not h.url:
            return False
        try:
            req = urllib.request.Request(f"{h.url}/drain", data=b"",
                                         method="POST")
            with urllib.request.urlopen(req, timeout=5.0):
                return True
        except (OSError, ValueError):
            return False

    def wait_drained(self, slot, timeout_s=None):
        """Poll the slot's /healthz until its drain completed (state
        draining, nothing queued/running/in flight).  True on success,
        False on timeout or replica death (either way the caller may
        terminate — a dead replica has nothing left to finish)."""
        timeout_s = (self.drain_timeout_s if timeout_s is None
                     else timeout_s)
        h = self.handles()[slot]
        if h is None:
            return False            # empty/retired slot: nothing to wait on
        deadline = self.clock() + timeout_s
        while self.clock() < deadline:
            if h.poll() is not None:
                return False        # died mid-drain
            hz = probe_health(h.url)
            if hz is not None and hz.get("state") == "draining" \
                    and not hz.get("in_flight") \
                    and not hz.get("queue_depth") \
                    and not hz.get("running") \
                    and not hz.get("waiting_handoffs"):
                # waiting_handoffs: a decode replica mid-KV-ingest has
                # work the queue/running counts don't show yet — a
                # drain is not complete until those land or resolve
                # (absent on legacy replicas: falsy, same decision)
                return True
            self.sleep(0.05)
        return False

    def _claim(self, slot):
        """Claim a slot EXCLUSIVELY: if the crash monitor is mid-spawn
        on it (it holds the claim across its slow spawn), wait for it
        to finish rather than replacing a handle it is about to set
        (which would orphan the monitor's live replacement process)."""
        while True:
            with self._lock:
                if slot not in self._rolling:
                    self._rolling.add(slot)
                    return
            self.sleep(0.05)

    def replace_slot(self, slot, factory=None, reason="rolling"):
        """The zero-downtime slot replacement: drain (out of the
        router's rotation) -> wait -> terminate -> spawn-with-``factory``
        (default: this supervisor's own ``spawn``, i.e. a plain restart
        — warm via the AOT store and warmup-manifest env the spawn
        command carries) under the ``_rolling`` exclusive claim, so the
        deployer never races the crash monitor.  Returns the replacement handle, or
        None for a retired slot."""
        with self._lock:
            if slot in self._retired:
                return None
        t0 = self.clock()
        kind = ("rolling_restart_slot" if reason == "rolling"
                else "deploy_replace_slot")
        self._claim(slot)
        try:
            self._annotate(kind, slot=slot, phase="drain")
            self.drain(slot)
            # a draining replica only refuses new work: out of rotation
            # now, so nothing is routed to it once it stops
            self._out_of_rotation(self.handles()[slot])
            self.wait_drained(slot)
            h = self.handles()[slot]
            if h is not None:
                self._annotate(kind, slot=slot, phase="terminate",
                               url=getattr(h, "url", None))
                h.terminate()
            handle = self._spawn_slot(slot, factory)
            self._m_restarts.labels(slot=str(slot),
                                    reason=reason).inc()
            self._annotate(kind, slot=slot, phase="respawned",
                           url=getattr(handle, "url", None),
                           wall_s=round(self.clock() - t0, 3))
        finally:
            with self._lock:
                self._rolling.discard(slot)
        self.note_healthy(slot)
        telemetry.histogram(
            "mxtpu_fleet_slot_restart_seconds",
            "drain-to-ready wall time of rolling-restart slots"
        ).observe(self.clock() - t0)
        return handle

    def drain_and_restart(self, slot):
        """The zero-downtime slot restart (same-factory
        :meth:`replace_slot`).  Returns the replacement handle."""
        return self.replace_slot(slot)

    def rolling_restart(self):
        """Drain-and-restart every slot, one at a time — the fleet
        never loses more than one replica of capacity, and the router
        retries each drain's rejections on the live siblings."""
        slots = self.active_slots()
        self._annotate("rolling_restart", phase="start",
                       slots=len(slots))
        for slot in slots:
            self.drain_and_restart(slot)
        self._annotate("rolling_restart", phase="done",
                       slots=len(slots))
        return self.urls()

    # -- pool resizing (the autoscaler's actuations) -------------------------
    def add_slot(self, factory=None):
        """Grow the pool by one slot: append a fresh slot index and
        spawn it (claimed in ``_rolling`` for the duration so the
        crash monitor never touches a half-born slot).  Returns the
        new slot index."""
        with self._lock:
            slot = self.n
            self.n += 1
            self._handles.append(None)
            self._restarts.append(0)
            self._next_restart_t.append(0.0)
            self._rolling.add(slot)
        try:
            handle = self._spawn_slot(slot, factory)
        except Exception:
            with self._lock:
                # a slot whose first spawn failed never joined the
                # pool; retire it so monitors/rolls skip the stub
                self._retired.add(slot)
            raise
        finally:
            with self._lock:
                self._rolling.discard(slot)
        self._annotate("scale_up_slot", slot=slot,
                       url=getattr(handle, "url", None))
        return slot

    def remove_slot(self, slot):
        """Shrink the pool by one slot: drain (out of the router's
        rotation) -> wait -> terminate, then RETIRE the index.  Returns
        True when the slot was removed, False when already retired."""
        with self._lock:
            if slot in self._retired:
                return False
        self._claim(slot)
        try:
            with self._lock:
                if slot in self._retired:
                    return False
            self._annotate("scale_down_slot", slot=slot, phase="drain")
            self.drain(slot)
            self._out_of_rotation(self.handles()[slot])
            self.wait_drained(slot)
            with self._lock:
                h = self._handles[slot]
                self._handles[slot] = None
                self._retired.add(slot)
            if h is not None:
                h.terminate()
            self._annotate("scale_down_slot", slot=slot,
                           phase="terminated",
                           url=getattr(h, "url", None))
        finally:
            with self._lock:
                self._rolling.discard(slot)
        return True

    def rebalance_catalog(self, reason="manual"):
        """Catalog-rebalance actuator: one plan+apply pass of the
        attached ``CatalogRebalancer`` (adapter placement follows
        traffic — see fleet/catalog.py).  Invoked manually or by the
        autoscaler after a scale-up so a fresh replica picks up the
        hot adapters.  The pass plans on a scrape it makes first: a
        replica spawned since the collector's last scrape (the
        scale-up's) is not in the older view, and no later pass runs
        by itself (ROADMAP §C13; the reference plans on the older view).
        No-op (empty list) without an attached rebalancer; a failing
        pass is annotated, never raised — the catalog converging late
        must not take the pool down."""
        if self.catalog is None:
            return []
        try:
            self.catalog.collector.scrape()
            results = self.catalog.rebalance()
        except Exception:
            telemetry.counter(
                "mxtpu_fleet_supervisor_errors_total",
                "supervisor monitor failures").inc()
            self._annotate("catalog_rebalance_failed", reason=reason)
            return []
        if results:
            self._annotate("catalog_rebalance", reason=reason,
                           applied=len(results),
                           ok=sum(1 for r in results if r["ok"]))
        return results
