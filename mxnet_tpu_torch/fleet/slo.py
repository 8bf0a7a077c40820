"""Declarative SLOs with multi-window burn-rate alerting.

A copy of the reference's ``mxnet_tpu/fleet/slo.py`` over the port's
telemetry: the same grammar, burn math, offenders and burn-triggered
captures and dumps, so an evaluator of either package judges the same
trace lines alike.

The Google SRE workbook's alerting recipe, applied to the fleet
collector's live series: an *objective* declares what fraction of
requests must be good ("99% of requests first-token within 500ms",
"99.9% of requests served at all"), which implies an **error budget**
(the tolerated bad fraction).  The *burn rate* is how fast the fleet
is spending that budget right now:

    burn = (bad requests / all requests, over a window) / budget

``burn == 1`` spends exactly the budget; ``burn == 14.4`` exhausts a
30-day budget in ~2 days.  Alerting on ONE window is the classic
trap — a short window pages on blips, a long one pages an hour late —
so an alert here fires only when BOTH a fast window (is it happening
*now*?) and a slow window (is it *sustained*?) burn past their
thresholds.  The textbook pairing (5m/1h at 14.4x) assumes a 30-day
budget; the defaults below are scaled to a serving fleet's timescale
and every knob is an env/constructor setting.

Spec grammar (``MXTPU_SLO_SPEC``)::

  spec       := objective (";" objective)*
  objective  := "availability" "=" fraction          # good = finished
              | metric "_p" QQ "_ms" "=" millis      # latency tail
  metric     := "ttft" | "tpot" | "total"
  QQ         := "50" | "90" | "99" | "99_9" | ...    # pNN[_N]

``ttft_p99_ms=500`` reads "99% of finished requests reach their first
token within 500ms" — budget 1%, a request counts *bad* when its TTFT
exceeds 500ms.  ``availability=0.999`` reads "99.9% of requests
finish" — budget 0.1%, a request counts bad when it terminates
rejected/cancelled.  Example: ``MXTPU_SLO_SPEC="ttft_p99_ms=500;
availability=0.999;tpot_p99_ms=80"``.

The per-request good/bad events come from the terminal request-trace
lines replicas push to the collector (``MXTPU_TRACE_PUSH_URL``), so
the math is exact request counting, never percentile-of-percentiles.
One CLIENT request can push several lines — the serving engine's, the
router's, and (disaggregated) the prefill replica's — so the burn math
first groups lines by trace id (:func:`group_requests`) and judges ONE
verdict per request (:meth:`Objective.judge`): the router line is the
client truth for availability when present; latency takes the worst
value any line observed.  Without grouping a total decode outage would
read as ~1/3 bad and an alert could sleep through it.

A FIRING alert (evaluated after every collector scrape pass):

* increments ``mxtpu_slo_burning{objective}`` (registry-direct — it
  must count even without ``MXTPU_TELEMETRY``, like the numeric
  watchdog),
* annotates the fleet timeline (visible at ``/fleetz`` next to the
  series that explain it), and
* triggers a rate-limited flight-recorder dump **on the offending
  replicas** — the replicas that served the bad requests in the fast
  window — so the post-mortem ring is captured while the incident is
  live, not after someone ssh'd in.

Chaos-provable: tests/test_torch_fleet_obs.py injects kill/delay faults
(``MXTPU_FAULT_SPEC``) under a fake clock and pins that the alert
fires — and stays silent on a clean run.
"""

from __future__ import annotations

import re
import threading
import time

from ..base import env_flag, env_float, env_int

__all__ = ["Objective", "SLOEvaluator", "parse_slo_spec",
           "group_requests", "request_failed", "ENV_SPEC",
           "ENV_FAST_WINDOW", "ENV_SLOW_WINDOW", "ENV_FAST_BURN",
           "ENV_SLOW_BURN", "ENV_MIN_REQUESTS"]

ENV_SPEC = "MXTPU_SLO_SPEC"
ENV_FAST_WINDOW = "MXTPU_SLO_FAST_WINDOW"
ENV_SLOW_WINDOW = "MXTPU_SLO_SLOW_WINDOW"
ENV_FAST_BURN = "MXTPU_SLO_FAST_BURN"
ENV_SLOW_BURN = "MXTPU_SLO_SLOW_BURN"
ENV_MIN_REQUESTS = "MXTPU_SLO_MIN_REQUESTS"
ENV_BURN_CAPTURE = "MXTPU_PROFILEZ_ON_BURN"
ENV_BURN_CAPTURE_S = "MXTPU_PROFILEZ_BURN_S"

_LATENCY_KEY = re.compile(r"^(ttft|tpot|total)_p(\d+(?:_\d+)?)_ms$")
# trace-summary field each latency metric reads
_METRIC_FIELD = {"ttft": "ttft_s", "tpot": "tpot_s", "total": "total_s"}


def group_requests(records):
    """Group trace-line summaries into CLIENT requests by trace id (a
    line without one is its own request).  One request retried across
    replicas — or split across prefill/decode roles, or observed by
    both its serving engine and the router — is ONE unit of SLO
    accounting, not several."""
    groups, solo = {}, []
    for rec in records:
        tid = rec.get("trace_id")
        if tid is None:
            solo.append([rec])
        else:
            groups.setdefault(tid, []).append(rec)
    return list(groups.values()) + solo


def request_failed(group):
    """Client-level failure verdict for one request's trace lines:
    the router's line is the client truth when present (it saw the
    final outcome across every retry/handoff hop); otherwise any
    rejected/cancelled line fails the request.  None = no terminal
    signal usable for availability (nothing to count)."""
    router = [r for r in group if r.get("source") == "router"]
    if router:
        return any(r["status"] != "finished" for r in router)
    if any(r["status"] in ("rejected", "cancelled") for r in group):
        return True
    if any(r["status"] == "finished" for r in group):
        return False
    return None


class Objective:
    """One parsed objective: its key, kind, target and error budget."""

    __slots__ = ("key", "kind", "metric", "q", "target", "budget")

    def __init__(self, key, kind, target, metric=None, q=None):
        self.key = key
        self.kind = kind              # "availability" | "latency"
        self.target = float(target)
        self.metric = metric          # "ttft"/"tpot"/"total" (latency)
        self.q = q                    # the percentile (latency)
        if kind == "availability":
            if not 0.0 < self.target < 1.0:
                raise ValueError(
                    f"availability target must be in (0, 1) "
                    f"(got {target})")
            self.budget = 1.0 - self.target
        else:
            if self.target <= 0:
                raise ValueError(
                    f"{key}: latency target must be > 0 ms "
                    f"(got {target})")
            self.budget = 1.0 - q

    def is_bad(self, rec):
        """Whether ONE trace line spends error budget — None when the
        record carries no signal for this objective (e.g. a rejected
        request has no TTFT).  Line-level: offender attribution reads
        this; the burn math itself judges whole requests
        (:meth:`judge`)."""
        if self.kind == "availability":
            return rec["status"] != "finished"
        if rec["status"] != "finished":
            return None
        v = rec.get(_METRIC_FIELD[self.metric])
        if v is None:
            return None
        return v * 1e3 > self.target

    def judge(self, group):
        """One verdict per CLIENT request (a ``group_requests`` group):
        availability follows :func:`request_failed`; latency takes the
        WORST value any of the request's lines observed (the router's
        total includes retries and handoff hops; the engine lines
        carry TTFT/TPOT).  None = no signal for this objective."""
        if self.kind == "availability":
            return request_failed(group)
        field = _METRIC_FIELD[self.metric]
        vals = [r[field] for r in group
                if r["status"] == "finished"
                and r.get(field) is not None]
        if not vals:
            return None
        return max(vals) * 1e3 > self.target

    def __repr__(self):
        return f"Objective({self.key}={self.target})"


def parse_slo_spec(spec):
    """Parse the ``MXTPU_SLO_SPEC`` grammar into ``[Objective, ...]``.
    Raises ``ValueError`` on anything unrecognized — an SLO spec with
    a typo silently guarding nothing would be worse than a crash (the
    fault-spec philosophy)."""
    objectives = []
    for entry in (spec or "").split(";"):
        entry = entry.strip()
        if not entry:
            continue
        if "=" not in entry:
            raise ValueError(
                f"malformed SLO objective {entry!r}: expected key=value")
        key, _, value = entry.partition("=")
        key = key.strip()
        try:
            target = float(value)
        except ValueError as e:
            raise ValueError(
                f"malformed SLO objective {entry!r}: {e}") from e
        if key == "availability":
            objectives.append(Objective(key, "availability", target))
            continue
        m = _LATENCY_KEY.match(key)
        if not m:
            raise ValueError(
                f"unknown SLO objective {key!r} (use availability= or "
                f"<ttft|tpot|total>_p<NN>_ms=)")
        q = float(m.group(2).replace("_", ".")) / 100.0
        if not 0.0 < q < 1.0:
            raise ValueError(f"{key}: percentile must be in (0, 100)")
        objectives.append(Objective(key, "latency", target,
                                    metric=m.group(1), q=q))
    if len({o.key for o in objectives}) != len(objectives):
        raise ValueError(f"duplicate objective in {spec!r}")
    return objectives


class SLOEvaluator:
    """Multi-window burn-rate evaluation over a collector's records.

    Args (env default in parens):
      objectives: ``[Objective]`` (``parse_slo_spec``).
      collector: anything with ``trace_records(window_s, now=)``,
        ``annotate(kind, **f)``, ``url_for_replica(name)`` and
        ``request_flight_dump(url, reason)`` — in practice the
        ``FleetCollector`` that owns this evaluator.
      fast_s / slow_s: the two windows (``MXTPU_SLO_FAST_WINDOW`` 60 /
        ``MXTPU_SLO_SLOW_WINDOW`` 300 seconds).
      fast_burn / slow_burn: firing thresholds
        (``MXTPU_SLO_FAST_BURN`` 10 / ``MXTPU_SLO_SLOW_BURN`` 5) —
        an alert fires only when BOTH windows burn at or past their
        threshold.
      min_requests: fewest fast-window requests worth judging
        (``MXTPU_SLO_MIN_REQUESTS`` 10) — burn math over three
        requests is noise, not signal.
      dump_interval_s: per-objective floor between offender flight
        dumps (30) on top of each replica's own per-reason limit.
      clock: injectable monotonic clock (fake-clock chaos tests).
    """

    def __init__(self, objectives, collector, fast_s=None, slow_s=None,
                 fast_burn=None, slow_burn=None, min_requests=None,
                 dump_interval_s=30.0, clock=time.monotonic):
        self.objectives = list(objectives)
        self.collector = collector
        self.fast_s = (float(fast_s) if fast_s is not None
                       else env_float(ENV_FAST_WINDOW, 60.0))
        self.slow_s = (float(slow_s) if slow_s is not None
                       else env_float(ENV_SLOW_WINDOW, 300.0))
        self.fast_burn = (float(fast_burn) if fast_burn is not None
                          else env_float(ENV_FAST_BURN, 10.0))
        self.slow_burn = (float(slow_burn) if slow_burn is not None
                          else env_float(ENV_SLOW_BURN, 5.0))
        self.min_requests = (int(min_requests)
                             if min_requests is not None
                             else env_int(ENV_MIN_REQUESTS, 10))
        self.dump_interval_s = float(dump_interval_s)
        # fast-burn auto-profiling: alongside each offender's flight
        # dump, open a short /profilez capture window on it so the
        # page links straight to a device trace of the burn
        # (MXTPU_PROFILEZ_ON_BURN=0 keeps dumps only)
        self.capture_on_burn = env_flag(ENV_BURN_CAPTURE, True)
        self.capture_s = env_float(ENV_BURN_CAPTURE_S, 0.5)
        self.clock = clock
        self._lock = threading.Lock()
        # objective key -> {"firing", "since", "fired_total", ...}
        self._state = {o.key: {"firing": False, "since": None,
                               "fired_total": 0, "transitions": 0}
                       for o in self.objectives}   # guarded-by: _lock
        self._last_dump_t = {}                     # guarded-by: _lock
        self._last_eval = []                       # guarded-by: _lock

    # -- burn math -----------------------------------------------------------
    def _window_burn(self, obj, window_s, now):
        """(burn_rate, bad, total) over one trailing window — the bad
        fraction divided by the objective's error budget.  Counted per
        CLIENT request (lines grouped by trace id), so a request that
        pushed three lines is one unit; requests that carry no signal
        for the objective are excluded from its denominator."""
        bad = total = 0
        for group in group_requests(
                self.collector.trace_records(window_s, now=now)):
            verdict = obj.judge(group)
            if verdict is None:
                continue
            total += 1
            if verdict:
                bad += 1
        if total == 0:
            return 0.0, 0, 0
        return (bad / total) / obj.budget, bad, total

    def _offenders(self, obj, now):
        """Replica names of the fast window's bad requests, worst
        first — where the flight dumps go."""
        counts = {}
        for rec in self.collector.trace_records(self.fast_s, now=now):
            if obj.is_bad(rec) and rec.get("replica"):
                counts[rec["replica"]] = counts.get(rec["replica"], 0) + 1
        return [name for name, _ in
                sorted(counts.items(), key=lambda kv: -kv[1])]

    # -- the evaluation pass (collector runs this after each scrape) ---------
    def evaluate(self, now=None):
        """One evaluation pass; returns the per-objective state list
        (also kept for :meth:`statusz`).  A FIRING objective counts
        ``mxtpu_slo_burning{objective}`` every pass (the counter's
        growth rate IS the burn duration), annotates the fleet
        timeline on each transition, and flight-dumps the offenders
        (rate-limited)."""
        now = self.clock() if now is None else now
        out = []
        for obj in self.objectives:
            burn_fast, bad_f, total_f = self._window_burn(
                obj, self.fast_s, now)
            burn_slow, bad_s, total_s = self._window_burn(
                obj, self.slow_s, now)
            firing = (total_f >= self.min_requests
                      and burn_fast >= self.fast_burn
                      and burn_slow >= self.slow_burn)
            with self._lock:
                st = self._state[obj.key]
                transition = firing != st["firing"]
                st["firing"] = firing
                if firing:
                    st["fired_total"] += 1
                    if transition:
                        st["since"] = now
                        st["transitions"] += 1
                elif transition:
                    st["since"] = None
                    st["transitions"] += 1
            if firing:
                self._count_burning(obj.key)
            if transition:
                self.collector.annotate(
                    "slo_alert", objective=obj.key,
                    state="firing" if firing else "resolved",
                    burn_fast=round(burn_fast, 3),
                    burn_slow=round(burn_slow, 3),
                    bad_fast=bad_f, total_fast=total_f)
            if firing:
                self._dump_offenders(obj, now)
            out.append({
                "objective": obj.key, "kind": obj.kind,
                "target": obj.target, "budget": round(obj.budget, 6),
                "burn_fast": round(burn_fast, 4),
                "burn_slow": round(burn_slow, 4),
                "bad_fast": bad_f, "total_fast": total_f,
                "bad_slow": bad_s, "total_slow": total_s,
                "firing": firing})
        with self._lock:
            self._last_eval = out
        return out

    @staticmethod
    def _count_burning(objective):
        # registry-direct (not the enabled-gated accessor): an SLO
        # burning must count even when MXTPU_TELEMETRY is unset — the
        # same rule the numeric watchdog follows
        from mxnet_tpu_torch import telemetry

        telemetry.registry().counter(
            "mxtpu_slo_burning",
            "evaluation passes with this objective's burn-rate alert "
            "firing", ("objective",)).labels(objective=objective).inc()

    def _dump_offenders(self, obj, now):
        with self._lock:
            last = self._last_dump_t.get(obj.key)
            if last is not None \
                    and now - last < self.dump_interval_s:
                return []
            self._last_dump_t[obj.key] = now
        dumped = []
        for name in self._offenders(obj, now):
            url = self.collector.url_for_replica(name)
            if url is None:
                continue
            # capture first: the flight dump then embeds the capture
            # id (and the last step-decomposition ring entries ride
            # the dump's statusz snapshot), so one page links alert →
            # post-mortem → device trace.  The replica's own 409/429
            # policy bounds profiling cost; a refused capture degrades
            # to a plain dump (capture_id None)
            capture_id = None
            request_capture = getattr(
                self.collector, "request_profile_capture", None)
            if self.capture_on_burn and request_capture is not None:
                cap = request_capture(
                    url, duration_s=self.capture_s,
                    reason=f"slo_burn_{obj.key}")
                capture_id = (cap or {}).get("id")
            if capture_id is None:
                # positional call keeps pre-capture collector doubles
                # (and subclasses with the old signature) working
                path = self.collector.request_flight_dump(
                    url, f"slo_burn_{obj.key}")
            else:
                path = self.collector.request_flight_dump(
                    url, f"slo_burn_{obj.key}", capture_id=capture_id)
            dumped.append({"replica": name, "path": path,
                           "capture_id": capture_id})
        if dumped:
            self.collector.annotate("slo_flight_dump",
                                    objective=obj.key, dumps=dumped)
        return dumped

    # -- introspection -------------------------------------------------------
    def statusz(self):
        """The ``/fleetz`` ``slo`` section: objectives with their last
        evaluated burn rates and firing state."""
        with self._lock:
            last = {e["objective"]: e for e in self._last_eval}
            out = []
            for obj in self.objectives:
                st = self._state[obj.key]
                row = {"objective": obj.key, "kind": obj.kind,
                       "target": obj.target,
                       "budget": round(obj.budget, 6),
                       "firing": st["firing"],
                       "firing_since": st["since"],
                       "fired_total": st["fired_total"]}
                row.update({k: v for k, v in
                            (last.get(obj.key) or {}).items()
                            if k.startswith(("burn_", "bad_",
                                             "total_"))})
                out.append(row)
        return {"fast_window_s": self.fast_s,
                "slow_window_s": self.slow_s,
                "fast_burn": self.fast_burn,
                "slow_burn": self.slow_burn,
                "min_requests": self.min_requests,
                "objectives": out}
