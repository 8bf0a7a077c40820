"""Per-step host-overhead decomposition for the serve engine.

A copy of ``mxnet_tpu/telemetry/profiling.py``.  Answers "where did
the *host* wall-clock go?" inside every ``Engine._step_inner``
iteration — the baseline any multi-step host loop has to beat, phase by
phase.

**Lap/cursor model.**  ``begin(step_id)`` stamps the step start and
resets the cursor; every ``lap(phase)`` attributes the time elapsed
since the cursor to ``phase`` and advances the cursor; ``commit(...)``
sweeps whatever remains into ``callbacks`` and seals the entry.  Every
nanosecond between begin and commit lands in exactly one phase, so the
per-step phase seconds sum to the step wall time by construction
(pinned in tests/test_profiling.py and tests/test_torch_telemetry.py).  Phases:

  schedule          admission fanout + scheduler.schedule() +
                    host-KV restore dispatch + utilization sampling
  prefill_dispatch  host operand staging + the prefill/chunk program
                    call (on CUDA the graph replay and the output's
                    copy back, waited for inside the call)
  decode_dispatch   the same for decode/draft/verify (spec ingest
                    rides here too)
  device_wait       what is left between the call and the tokens on
                    the host (the port's program call already waited
                    for its output, so this phase is small)
  host_sync         post-sync host bookkeeping: token append, radix/
                    scheduler updates, request-trace events
  callbacks         step tail: flight record, stats/perf callbacks,
                    spec-window prune, telemetry gauges

**Cost.**  A lap is one ``perf_counter`` read and a dict add — the
recorder is default ON (``MXTPU_STEP_PROFILE=0`` to disable).
Disabled, the engine holds the NOOP recorder whose methods are empty —
zero clock reads on the hot path.

Surfaces: a bounded ring of per-step entries (``MXTPU_STEP_PROFILE_RING``,
default 256), cumulative per-phase totals, the ``step_profile`` engine
statusz section (which flight dumps embed via the statusz snapshot),
and ``mxtpu_step_phase_seconds{phase}`` histograms.  The statusz
section carries a perf_counter↔epoch clock anchor so
tools/timeline_report.py can place the rings on the fleet timeline.

Inertness contract: the recorder never touches
tokens, program cache keys, or AOT fingerprints — on or off, greedy
output is byte-identical and ``_spec_digest`` unchanged.
"""

from __future__ import annotations

import collections
import time

from ..base import env_flag, env_int

__all__ = ["StepProfiler", "NOOP_STEP_PROFILER", "make_step_profiler",
           "PHASES", "ENV_ENABLE", "ENV_RING", "PHASE_SECONDS_BUCKETS"]

ENV_ENABLE = "MXTPU_STEP_PROFILE"        # step decomposition (default on)
ENV_RING = "MXTPU_STEP_PROFILE_RING"     # per-step entry ring size

PHASES = ("schedule", "prefill_dispatch", "decode_dispatch",
          "device_wait", "host_sync", "callbacks")

# host phases live well below program dispatches: 1us .. 100ms band
PHASE_SECONDS_BUCKETS = (1e-6, 2.5e-6, 5e-6, 1e-5, 2.5e-5, 5e-5,
                         1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3,
                         1e-2, 2.5e-2, 5e-2, 0.1, 0.25)

_STATUSZ_RECENT = 50     # ring tail carried on statusz / flight dumps


class _NoopStepProfiler:
    """Shared disabled recorder: every hot-path call is a no-op pass.

    The engine holds this singleton when ``MXTPU_STEP_PROFILE=0`` so
    the step loop pays one attribute load + empty call per lap and
    zero clock reads."""

    enabled = False

    def begin(self, step_id):
        pass

    def lap(self, phase):
        pass

    def commit(self, emitted=0, prefills=0, decodes=0):
        pass

    def recent(self, n=_STATUSZ_RECENT):
        return []

    def summary(self):
        return None

    def statusz(self):
        return {"enabled": False}


NOOP_STEP_PROFILER = _NoopStepProfiler()


class StepProfiler:
    """One per engine, constructed AFTER ``telemetry.enable()`` (the
    handle-caching asymmetry: the phase histogram handle is cached here
    at construction).  Single-writer: only the engine step loop calls
    begin/lap/commit; readers (statusz handlers on HTTP threads) see a
    consistent tail because entries are appended whole."""

    enabled = True

    def __init__(self, clock=time.perf_counter, ring=None):
        self._clock = clock
        n = ring if ring is not None else env_int(ENV_RING, 256)
        self._ring = collections.deque(maxlen=max(1, int(n)))
        self._totals = {p: 0.0 for p in PHASES}
        self._steps = 0
        self._wall_s = 0.0
        self._emitted = 0
        self._cur = {}            # in-flight step: phase -> seconds
        self._step_id = 0
        self._t_begin = 0.0
        self._t_cursor = 0.0
        # perf_counter<->epoch anchor: lets timeline_report place ring
        # entries (perf-domain t0s) on the fleet's wall-clock axis.
        # mxtpu-lint: disable=wall-clock (one-shot epoch anchor for trace stitching)
        self._anchor = {"perf": clock(), "epoch": time.time()}
        from .. import telemetry as tel

        self._hist = tel.histogram(
            "mxtpu_step_phase_seconds",
            "host wall-time per serve-step phase", ("phase",),
            buckets=PHASE_SECONDS_BUCKETS)

    # -- hot path (engine step loop only) --------------------------------
    def begin(self, step_id):
        """Stamp the step start; resets the lap cursor."""
        self._step_id = step_id
        self._t_begin = self._t_cursor = self._clock()
        self._cur = {}

    def lap(self, phase):
        """Attribute elapsed-since-cursor to ``phase``; advance cursor."""
        now = self._clock()
        self._cur[phase] = self._cur.get(phase, 0.0) + (now - self._t_cursor)
        self._t_cursor = now

    def commit(self, emitted=0, prefills=0, decodes=0):
        """Seal the in-flight step: the residual since the last lap goes
        to ``callbacks``, the entry enters the ring, totals/histograms
        update."""
        now = self._clock()
        cur = self._cur
        cur["callbacks"] = cur.get("callbacks", 0.0) + (now - self._t_cursor)
        self._t_cursor = now
        wall = now - self._t_begin
        entry = {
            "step": self._step_id,
            "t0": self._t_begin,
            "wall_s": wall,
            "emitted": int(emitted),
            "prefills": int(prefills),
            "decodes": int(decodes),
            "phases": cur,
        }
        self._ring.append(entry)
        self._cur = {}
        self._steps += 1
        self._wall_s += wall
        self._emitted += int(emitted)
        totals = self._totals
        hist = self._hist
        for phase, dt in cur.items():
            totals[phase] = totals.get(phase, 0.0) + dt
            hist.labels(phase=phase).observe(dt)

    # -- surfaces --------------------------------------------------------
    def recent(self, n=_STATUSZ_RECENT):
        """The last ``n`` ring entries, oldest first."""
        if n <= 0:
            return []
        ring = list(self._ring)
        return ring[-n:]

    def fractions(self):
        """{phase: fraction of recorded wall time}, or None pre-step."""
        if self._wall_s <= 0.0:
            return None
        return {p: self._totals[p] / self._wall_s for p in PHASES}

    def summary(self):
        """Compact dict for monitor tails / fleet scrape rows."""
        return {
            "steps": self._steps,
            "wall_s": self._wall_s,
            "emitted": self._emitted,
            "fractions": self.fractions(),
        }

    def statusz(self):
        """The engine statusz ``step_profile`` section.  Unlike perf
        attribution this knob is default-on, so the section always
        reports its enabled state rather than collapsing to None."""
        # mxtpu-lint: disable=wall-clock (refreshed epoch anchor for trace stitching)
        anchor = {"perf": self._clock(), "epoch": time.time()}
        return {
            "enabled": True,
            "ring": self._ring.maxlen,
            "steps": self._steps,
            "wall_s": self._wall_s,
            "emitted": self._emitted,
            "totals_s": dict(self._totals),
            "fractions": self.fractions(),
            "clock_anchor": anchor,
            "recent": self.recent(),
        }


def make_step_profiler(clock=time.perf_counter):
    """The engine's constructor hook: a live recorder when
    ``MXTPU_STEP_PROFILE`` is on (the default), the shared NOOP
    otherwise."""
    if env_flag(ENV_ENABLE, True):
        return StepProfiler(clock=clock)
    return NOOP_STEP_PROFILER
