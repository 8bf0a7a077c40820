"""Monitors: the port of ``mxnet_tpu/monitor.py``.

``Monitor`` installs a per-output callback on executors
(``Executor.set_monitor_callback``) and, every ``interval`` steps,
collects a statistic of each node output, argument and argument
gradient whose name matches ``pattern`` (``tic`` before the step,
``toc``/``toc_print`` after it).  Its default statistic is the mean
absolute value; the reference's default, ``abs(x)`` of an NDArray,
raises there (its NDArray has no ``__abs__``), so the port computes it
on the host copy.

``ServeMonitor`` logs the reference's line, byte for byte on the same
``Engine.stats()`` values, and samples the process-global time-series
ring (``MXTPU_TIMESERIES``) on each log tick.
"""

from __future__ import annotations

import logging
import re

import numpy as np

__all__ = ["Monitor", "ServeMonitor"]


def _mean_abs(x):
    return np.abs(x.asnumpy()).mean()


class Monitor:
    """Tensor statistics of executors every ``interval`` steps
    (reference ``monitor.Monitor``): ``stat_func(NDArray)`` of each
    matching node output during the forward, and of each matching
    argument and gradient (``<name>_grad``) at ``toc``."""

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        self.stat_func = stat_func or _mean_abs
        self.interval = interval
        self.activated = False
        self.queue = []
        self.step = 0
        self.exes = []
        self.re_prog = re.compile(pattern)
        self.sort = sort

        def stat_helper(name, arr):
            if not self.activated or not self.re_prog.match(name):
                return
            self.queue.append((self.step, name, self.stat_func(arr)))

        self.stat_helper = stat_helper

    def install(self, exe):
        exe.set_monitor_callback(self.stat_helper)
        self.exes.append(exe)

    def tic(self):
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        """The collected ``(step, name, stat)`` triples of the step that
        ``tic`` activated, arguments and gradients appended; [] when it
        did not activate one."""
        if not self.activated:
            return []
        self.activated = False
        for exe in self.exes:
            for name, array in zip(exe.arg_names, exe.arg_arrays):
                if self.re_prog.match(name):
                    self.queue.append((self.step, name, self.stat_func(array)))
            for name, array in zip(exe.arg_names, exe.grad_arrays):
                if array is not None and self.re_prog.match(name):
                    self.queue.append((self.step, name + "_grad",
                                       self.stat_func(array)))
        res = sorted(self.queue, key=lambda x: x[1]) if self.sort else self.queue
        self.queue = []
        return res

    def toc_print(self):
        for n, k, v_list in self.toc():
            logging.info("Batch: %7d %30s %s", n, k, str(v_list))


class ServeMonitor:
    """Periodic logger for the serving engine, the inference-side
    analog of ``callback.Speedometer``'s samples/sec line and this
    module's tic/toc convention: call :meth:`tic` once per engine
    step; every ``interval`` steps it snapshots
    ``serve.Engine.stats()`` and logs one line.

        mon = mt.monitor.ServeMonitor(engine, interval=100)
        while engine.scheduler.has_work():
            engine.step()
            mon.tic()
    """

    def __init__(self, engine, interval=100, logger=None):
        self.engine = engine
        self.interval = int(interval)
        if self.interval < 1:
            raise ValueError(
                f"interval must be >= 1 (got {interval})")
        self.step = 0
        self.logger = logger or logging.getLogger(__name__)

    def tic(self):
        self.step += 1
        if self.step % self.interval == 0:
            self.log_now()

    @staticmethod
    def _fmt(value):
        """Grep/parse-stable field: ``-`` for not-yet-measured (None),
        one decimal otherwise (raw floats would make the line width and
        precision vary run to run)."""
        return "-" if value is None else f"{float(value):.1f}"

    @staticmethod
    def _fmt_reasons(reasons):
        """Cumulative rejection reasons as a grep-stable bracket:
        ``[deadline=2,queue_full=1]`` sorted by reason, ``[-]`` when
        none — back-pressure and its cause are visible straight from
        the log line, no metrics endpoint needed."""
        if not reasons:
            return "-"
        return ",".join(f"{k}={reasons[k]}" for k in sorted(reasons))

    def log_now(self):
        # the periodic logging cadence doubles as the local time-series
        # sampling beat: with MXTPU_TIMESERIES set, each log tick also
        # snapshots the metrics registry into the bounded ring (rate-
        # limited per MXTPU_TIMESERIES_INTERVAL), so windowed rates —
        # tok/s over the last minute, reject rate over five — are
        # readable from /statusz without any external scraper.  A
        # no-op (None check) when the ring is unconfigured.
        from .telemetry import timeseries

        timeseries.sample()
        s = self.engine.stats()
        rate = (s.decode_tok_per_sec if s.decode_tok_per_sec is not None
                else s.total_tok_per_sec)
        # the tok/s above is fed from ACTUAL per-iteration emitted
        # counts, so it stays honest with speculative decoding on; the
        # spec tail (acceptance rate / mean accepted-per-verify) only
        # appears once a verify has run — plain-decode lines are
        # byte-identical to the pre-spec format
        spec = ""
        if getattr(s, "spec_verifies", 0):
            spec = (f" spec={s.spec_accept_rate:.2f}"
                    f"/{s.accepted_per_verify:.2f}")
        # performance-attribution tail (the same only-once-measured
        # rule as the spec tail): appears only after a sampled timing
        # exists (MXTPU_PERF_ATTRIB_SAMPLE>0 and a sampled step ran),
        # so plain lines stay byte-identical to the pre-attribution
        # format — and engines without perf_summary (fakes, older
        # duck-typed drivers) log exactly as before
        perf = ""
        summary = getattr(self.engine, "perf_summary", None)
        p = summary() if callable(summary) else None
        if p and p.get("sampled"):
            mfu = p.get("mfu")
            mfu_s = "-" if mfu is None else f"{100.0 * mfu:.1f}%"
            tf = p.get("tok_flops")
            tf_s = "-" if tf is None else f"{tf / 1e6:.2f}M"
            perf = f" mfu={mfu_s} tok_flops={tf_s}"
        self.logger.info(
            "Serve: step %7d queue=%d running=%d done=%d rej=%d[%s] "
            "preempt=%d blocks=%d/%d (%.0f%%) ttft_ms=%s tok/s=%s%s%s",
            s.steps, s.queue_depth, s.running, s.completed, s.rejected,
            self._fmt_reasons(getattr(s, "reject_reasons", None)),
            s.preemptions, s.blocks_in_use, s.blocks_total,
            100.0 * s.block_utilization, self._fmt(s.ttft_ms_mean),
            self._fmt(rate), spec, perf)
        return s
