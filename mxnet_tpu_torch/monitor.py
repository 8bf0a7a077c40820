"""Serving monitor: the port of ``mxnet_tpu/monitor.py``'s
``ServeMonitor``.

``ServeMonitor`` logs the reference's line, byte for byte on the same
``Engine.stats()`` values, and samples the process-global time-series
ring (``MXTPU_TIMESERIES``) on each log tick.  The training ``Monitor``
(tensor-stat hooks on executors) comes with the rest of the training
framework (ROADMAP §A15b) and raises on access until then.
"""

from __future__ import annotations

import logging

__all__ = ["ServeMonitor"]


def __getattr__(name):
    if name == "Monitor":
        raise NotImplementedError(
            "mxnet_tpu_torch.monitor.Monitor (tensor-stat hooks on "
            "executors) is not ported yet (ROADMAP §A item 15: A15b)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


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
