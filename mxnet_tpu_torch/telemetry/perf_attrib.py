"""Per-program performance attribution for the serve engine.

The port of ``mxnet_tpu/telemetry/perf_attrib.py``.  Answers "where did
the device time go?" per serve program — (kind, bucket) =
prefill/chunk/decode/draft/draft_chunk/verify/restore x batch bucket —
with two independently-gated halves:

**Cost table (default ON, ``MXTPU_PERF_ATTRIB=0`` to disable).**  The
port has no XLA ``cost_analysis()``.  At program-resolve time the
engine hands each (kind, bucket) its analytic cost, the GQA-aware
closed forms of ``flops.py`` over the padded program shapes
(``Engine._analytic_cost``), which :meth:`PerfAttrib.note_cost` records
with ``source: "analytic"`` — the reference's fallback branch, taken
always.  Those forms give flops for every kind but ``restore`` and
bytes for ``restore`` only, so MBU is None for every other kind, as in
the reference's fallback.  Pure host bookkeeping at resolve cadence.

**Sampled device timing (default OFF, ``MXTPU_PERF_ATTRIB_SAMPLE=N``
samples every Nth step).**  On sampled steps only, each program call is
bracketed ``t0()`` .. ``done()``: on CUDA ``t0`` gives a pair of
``torch.cuda.Event(enable_timing=True)``, which the program's launch
records on the engine's stream just before and just after its graph
replay; ``done`` synchronises the second and adds
``elapsed_time`` to a ``mxtpu_serve_program_seconds{kind,bucket}``
histogram plus derived achieved-TFLOP/s, MFU (vs
``flops.peak_flops_per_chip``), MBU (vs ``flops.peak_hbm_bytes_per_chip``)
and cost-per-1k-tokens gauges.  The events sit on the stream outside
the captured graph (an event recorded inside a capture becomes a graph
node and cannot be timed), around the replay alone: the time is the
graph's on the device, where the reference's (host clock around a
dispatch plus ``block_until_ready``) includes the dispatch.  Bracketing
the input staging too would count the device's idle wait for the host's
Python between the events.  On the CPU the host clock stands in.  An
unarmed step (sampling off, the default) pays a dict lookup and an
integer add a call: no event, no sync.

Inertness contract: attribution never touches tokens, program keys,
captures or fingerprints — both knobs in any combination leave greedy
output byte-identical and ``_spec_digest`` unchanged (pinned in
tests/test_torch_perf_attrib.py).
"""

from __future__ import annotations

import time

from ..base import env_flag, env_int

__all__ = ["PerfAttrib", "ENV_ENABLE", "ENV_SAMPLE",
           "PROGRAM_SECONDS_BUCKETS"]

ENV_ENABLE = "MXTPU_PERF_ATTRIB"          # cost table (default on)
ENV_SAMPLE = "MXTPU_PERF_ATTRIB_SAMPLE"   # sample every Nth step (0=off)

# finer-grained than metrics.DEFAULT_BUCKETS: bucketed serve programs
# live in the 10us .. 1s band on real chips
PROGRAM_SECONDS_BUCKETS = (1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4,
                           1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
                           0.1, 0.25, 0.5, 1.0, 2.5)

_RECENT = 512    # per-program recent-sample window for p99


class _Prog:
    """Per-(kind,bucket) dispatch/timing accumulator."""

    __slots__ = ("dispatches", "sampled", "total_s", "recent")

    def __init__(self):
        self.dispatches = 0
        self.sampled = 0
        self.total_s = 0.0
        self.recent = []          # bounded ring of sampled seconds

    def record(self, dt):
        if self.sampled < _RECENT:
            self.recent.append(dt)
        else:
            self.recent[self.sampled % _RECENT] = dt
        self.sampled += 1
        self.total_s += dt

    def p99(self):
        if not self.recent:
            return None
        s = sorted(self.recent)
        return s[min(len(s) - 1, int(0.99 * len(s)))]

    def mean(self):
        return self.total_s / self.sampled if self.sampled else None


class PerfAttrib:
    """One per engine, constructed AFTER ``telemetry.enable()`` (the
    handle-caching asymmetry: metric handles are cached here at
    construction).  The engine is never referenced: this object must
    not keep a retired engine alive."""

    def __init__(self, clock=time.perf_counter, device=None):
        self.enabled = env_flag(ENV_ENABLE, True)
        self.sample_every = max(0, env_int(ENV_SAMPLE, 0))
        self._clock = clock
        # timing by CUDA events on a CUDA engine, else the host clock
        self._cuda = device is not None and device.type == "cuda"
        self._cost = {}           # (kind, bucket) -> cost-table entry
        self._prog = {}           # (kind, bucket) -> _Prog
        self._armed = False
        self._step_s = 0.0        # timed seconds within the armed step
        self._sampled_steps = 0
        self._tokens = 0          # all emitted tokens (cheap int add)
        self._sampled_tokens = 0  # emitted during sampled steps
        self._device_s = 0.0      # timed seconds across sampled steps
        self.cost_errors = 0      # peak lookups that raised (statusz)
        try:
            from .. import flops as _flops

            self.peak_flops = _flops.peak_flops_per_chip(device)
            self.peak_bytes = _flops.peak_hbm_bytes_per_chip(device)
        except Exception:
            # utilization columns degrade to None, attribution still
            # works
            self.peak_flops = None
            self.peak_bytes = None
            self.cost_errors += 1
        from .. import telemetry as tel

        self._hist = tel.histogram(
            "mxtpu_serve_program_seconds",
            "sampled device wall-time per serve program dispatch",
            ("kind", "bucket"), buckets=PROGRAM_SECONDS_BUCKETS)
        self._g_tflops = tel.gauge(
            "mxtpu_serve_achieved_tflops",
            "achieved TFLOP/s over sampled dispatches", ("kind",))
        self._g_mfu = tel.gauge(
            "mxtpu_serve_mfu",
            "achieved FLOP/s over peak_flops_per_chip", ("kind",))
        self._g_mbu = tel.gauge(
            "mxtpu_serve_mbu",
            "achieved bytes/s over peak HBM bandwidth", ("kind",))
        self._g_cost = tel.gauge(
            "mxtpu_serve_cost_per_1k_tokens_seconds",
            "sampled device-seconds per 1000 emitted tokens")

    # -- cost table (compile cadence) -----------------------------------
    def note_cost(self, kind, bucket, flops=None, bytes_accessed=None):
        """Record (kind, bucket)'s analytic cost, idempotent per key:
        ``flops`` and ``bytes_accessed`` (either may be None) with
        ``source: "analytic"``, the reference's fallback entry."""
        if not self.enabled:
            return
        key = (kind, int(bucket))
        if key in self._cost:
            return
        ent = {"flops": None, "bytes_accessed": None,
               "output_bytes": None, "source": None}
        if flops:
            ent["flops"] = float(flops)
            ent["source"] = "analytic"
        if bytes_accessed:
            ent["bytes_accessed"] = float(bytes_accessed)
        self._cost[key] = ent

    def cost(self, kind, bucket):
        """The cost-table entry for (kind, bucket), or None."""
        return self._cost.get((kind, int(bucket)))

    # -- sampled timing (step cadence) ----------------------------------
    def arm(self, step_id):
        """Called once at the top of every engine step: decides whether
        THIS step's dispatches are timed (every ``sample_every``-th
        step).  Never armed when sampling is off (the default)."""
        if self.sample_every > 0 and step_id % self.sample_every == 0:
            self._armed = True
            self._step_s = 0.0
        else:
            self._armed = False

    def t0(self):
        """Call-start stamp on an armed step: on a CUDA engine a (start,
        end) pair of timing events for the program's launch to record
        around its graph replay, on the CPU a clock read; None otherwise
        (the default — no event, no sync)."""
        if not self._armed:
            return None
        if self._cuda:
            import torch

            return (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
        return self._clock()

    def done(self, t0, kind, bucket):
        """Call-end bracket.  Always counts the call (dict lookup + int
        add); on armed steps additionally waits for the end event the
        launch recorded and records the device seconds between the
        two."""
        key = (kind, int(bucket))
        p = self._prog.get(key)
        if p is None:
            p = self._prog[key] = _Prog()
        p.dispatches += 1
        if t0 is None:
            return
        if self._cuda:
            start, end = t0
            # rate-gated sampled sync (armed steps only)
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            dt = self._clock() - t0
        p.record(dt)
        self._step_s += dt
        self._hist.labels(kind=kind, bucket=str(int(bucket))).observe(dt)

    def on_step(self, emitted):
        """Called once per engine step with the tokens emitted; closes
        out an armed step (token accounting + gauge refresh)."""
        self._tokens += int(emitted)
        if not self._armed:
            return
        self._armed = False
        self._sampled_steps += 1
        self._sampled_tokens += int(emitted)
        self._device_s += self._step_s
        self._update_gauges()

    # -- derived utilization --------------------------------------------
    def _kind_rates(self):
        """{kind: (seconds, achieved_flops, achieved_bytes)} over the
        sampled dispatches (flops/bytes from the cost table, so a
        missing entry contributes time but no utilization)."""
        agg = {}
        for (kind, bucket), p in self._prog.items():
            if not p.sampled:
                continue
            ent = self._cost.get((kind, bucket)) or {}
            s, f, b = agg.get(kind, (0.0, 0.0, 0.0))
            s += p.total_s
            f += (ent.get("flops") or 0.0) * p.sampled
            b += (ent.get("bytes_accessed") or 0.0) * p.sampled
            agg[kind] = (s, f, b)
        return agg

    def _totals(self):
        """(seconds, flops, bytes) across all sampled dispatches."""
        s = f = b = 0.0
        for ks, kf, kb in self._kind_rates().values():
            s += ks
            f += kf
            b += kb
        return s, f, b

    def _update_gauges(self):
        for kind, (s, f, b) in self._kind_rates().items():
            if s <= 0.0:
                continue
            self._g_tflops.labels(kind=kind).set(f / s / 1e12)
            if self.peak_flops:
                self._g_mfu.labels(kind=kind).set(f / s / self.peak_flops)
            if self.peak_bytes:
                self._g_mbu.labels(kind=kind).set(b / s / self.peak_bytes)
        if self._sampled_tokens:
            self._g_cost.set(
                1000.0 * self._device_s / self._sampled_tokens)

    def mfu(self):
        """Overall sampled MFU, or None (no samples / unknown peak)."""
        s, f, _ = self._totals()
        if s <= 0.0 or not self.peak_flops:
            return None
        return f / s / self.peak_flops

    def tok_flops(self):
        """Achieved FLOPs per emitted token over sampled steps."""
        _, f, _ = self._totals()
        if not self._sampled_tokens or f <= 0.0:
            return None
        return f / self._sampled_tokens

    # -- surfaces --------------------------------------------------------
    def summary(self):
        """Compact dict for ServeMonitor tails and fleet scrape rows;
        None when attribution is disabled."""
        if not self.enabled:
            return None
        s, f, b = self._totals()
        sampled = sum(p.sampled for p in self._prog.values())
        out = {
            "sampled": sampled,
            "achieved_tflops": (f / s / 1e12) if s > 0.0 else None,
            "mfu": self.mfu(),
            "mbu": (b / s / self.peak_bytes
                    if s > 0.0 and self.peak_bytes else None),
            "tok_flops": self.tok_flops(),
            "cost_per_1k_tokens_s": (
                1000.0 * self._device_s / self._sampled_tokens
                if self._sampled_tokens else None),
        }
        return out

    def statusz(self):
        """The engine statusz ``perf`` section: knob state, overall
        goodput, and the per-program table; None when disabled."""
        if not self.enabled:
            return None
        total_s, total_f, _ = self._totals()
        progs = []
        for key in sorted(set(self._cost) | set(self._prog)):
            kind, bucket = key
            ent = self._cost.get(key) or {}
            p = self._prog.get(key)
            mean = p.mean() if p else None
            flops = ent.get("flops")
            row = {
                "kind": kind,
                "bucket": bucket,
                "dispatches": p.dispatches if p else 0,
                "sampled": p.sampled if p else 0,
                "mean_s": mean,
                "p99_s": p.p99() if p else None,
                "flops": flops,
                "bytes_accessed": ent.get("bytes_accessed"),
                "output_bytes": ent.get("output_bytes"),
                "source": ent.get("source"),
                "achieved_tflops": (flops / mean / 1e12
                                    if flops and mean else None),
                "mfu": (flops / mean / self.peak_flops
                        if flops and mean and self.peak_flops else None),
                "share": (p.total_s / total_s
                          if p and total_s > 0.0 else None),
            }
            progs.append(row)
        out = {
            "enabled": True,
            "sample_every": self.sample_every,
            "sampled_steps": self._sampled_steps,
            "sampled_tokens": self._sampled_tokens,
            "tokens": self._tokens,
            "device_seconds": self._device_s,
            "cost_errors": self.cost_errors,
            "peak_flops_per_chip": self.peak_flops,
            "peak_hbm_bytes_per_chip": self.peak_bytes,
            "achieved_tflops": (total_f / total_s / 1e12
                                if total_s > 0.0 else None),
            "mfu": self.mfu(),
            "tok_flops": self.tok_flops(),
            "cost_per_1k_tokens_s": (
                1000.0 * self._device_s / self._sampled_tokens
                if self._sampled_tokens else None),
            "programs": progs,
        }
        return out
