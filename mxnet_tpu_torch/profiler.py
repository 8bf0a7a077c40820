"""Profiling / tracing on ``torch.profiler``.

The port of ``mxnet_tpu/profiler.py``: the same surface over
``torch.profiler`` in place of the JAX/XLA profiler.

  profiler.start("/tmp/prof"); ...; profiler.stop()
  with profiler.trace("/tmp/prof"): ...
  with profiler.scope("step"): ...
  profiler.annotate("h2d-copy") decorator
  profiler.summarize("/tmp/prof")     # [(kernel, total_ms, count)]

A capture records the host (CPU) activity, and the card's kernels when
CUDA is available, and ``stop`` writes it as a gzipped Chrome trace
under ``<logdir>/plugins/profile/<run>/`` (the reference's layout), which
Perfetto and chrome://tracing open.  While a capture is active every
telemetry span also appears in it (``telemetry/tracing.py``).

torch's profiler records the host operators of the thread that starts
it, and must be stopped on that thread: a window over a serving engine
is opened and closed by the thread that steps it
(``fleet/replica.py``'s step loop owns ``/profilez`` windows).  The
card's kernels are recorded process-wide, CUDA graph replays included.

No profiler start or stop lands inside a CUDA graph capture:
:data:`capture_lock` is held by a capture and its warm-up runs
(``serve/engine.py`` ``_Program._capture``) and taken by ``start`` (for
at most ``CAPTURE_WAIT_S`` seconds, then :class:`ProfilerActive`) and
``stop``.  Other engines' device work goes on during a capture (the
capture runs in ``"thread_local"`` mode).
"""

from __future__ import annotations

import contextlib
import functools
import os
import socket
import tempfile
import threading
import time

import torch

__all__ = ["start", "stop", "trace", "scope", "annotate", "active_logdir",
           "ProfilerActive", "device_memory", "summarize", "capture_lock",
           "prime",
           "CAPTURE_WAIT_S", "STOP_SETTLE_S", "START_SETTLE_S"]

# the profiler is process-global and start/stop may arrive from two
# threads; every transition of the active-capture state happens under
# _lock, so a concurrent start sees a coherent already-active answer
_lock = threading.Lock()
_active_logdir = None    # guarded-by: _lock
_active = None           # guarded-by: _lock (the running profile)
_primed = False          # set once by prime()

CAPTURE_WAIT_S = 5.0     # the longest a profiler start waits for a capture
# the wait between the card's last kernel and the profiler's stop:
# CUPTI hands over the records of the last kernels some time after they
# ran, and a stop right after a synchronize can lose the window's last
# graph replays from the trace (chip_profiler_tail.py measures it)
STOP_SETTLE_S = 0.1
# the wait between the profiler's start and its return: CUPTI turns the
# card's kernel records on some time after the start, and a CUDA graph
# replayed at once can reach the trace with only its later kernels (the
# window's first decode replay held 3 of its 4 paged split kernels;
# chip_profiler_tail.py --start-settle measures it)
START_SETTLE_S = 0.05


# held by every CUDA graph capture of the process (with its warm-up
# runs) and by the profiler's start and stop
capture_lock = threading.Lock()


class ProfilerActive(RuntimeError):
    """A capture is already running (distinguished from plain
    RuntimeError so an HTTP surface can map it to a clean 409)."""


def active_logdir():
    """The logdir of the capture in flight, or None."""
    with _lock:
        return _active_logdir


def _start_capture(logdir):
    """Start a torch.profiler capture outside any CUDA graph capture,
    returning once the card records kernels (``START_SETTLE_S`` after
    the start); returns the running profile."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    if not capture_lock.acquire(timeout=CAPTURE_WAIT_S):
        raise ProfilerActive(
            f"a CUDA graph capture held the capture lock for "
            f"{CAPTURE_WAIT_S} s; the profiler did not start")
    try:
        prof.start()
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
            time.sleep(START_SETTLE_S)
    finally:
        capture_lock.release()
    return prof


def _stop_capture(prof, logdir):
    """Stop ``prof`` outside any CUDA graph capture, once the card's
    records of the work before it have come in, and write its trace under
    ``logdir``."""
    with capture_lock:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
            time.sleep(STOP_SETTLE_S)
        prof.stop()
    run = os.path.join(logdir, "plugins", "profile",
                       time.strftime("%Y_%m_%d_%H_%M_%S"))
    os.makedirs(run, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        run, f"{socket.gethostname()}.{os.getpid()}.trace.json.gz"))


def start(logdir):
    """Begin capturing a trace into ``logdir``.

    Raises :class:`ProfilerActive` when a capture is already active."""
    global _active_logdir, _active
    with _lock:
        if _active_logdir is not None:
            raise ProfilerActive(
                f"a profiler trace is already active (logdir="
                f"{_active_logdir!r}); call profiler.stop() before "
                "starting a new capture")
        _active = _start_capture(logdir)
        _active_logdir = logdir


def stop():
    """Finish the capture started by ``start`` and write its trace.  The
    active-capture state resets even when stopping raises (a failed
    capture must not wedge every later ``start``)."""
    global _active_logdir, _active
    with _lock:
        try:
            _stop_capture(_active, _active_logdir)
        finally:
            _active_logdir = None
            _active = None


def prime():
    """Start and stop one throwaway capture, once a process: the
    profiler's first start in a process sets CUPTI up, seconds on the
    card, which a first window would otherwise pay.  True when this call
    primed it; False once done, or while another capture holds the
    profiler (which then has paid)."""
    global _primed
    if _primed:
        return False
    with tempfile.TemporaryDirectory() as logdir:
        try:
            start(logdir)
        except ProfilerActive:
            return False
        stop()
    _primed = True
    return True


@contextlib.contextmanager
def trace(logdir):
    """Capture a trace around a block."""
    start(logdir)
    try:
        yield
    finally:
        stop()


def scope(name):
    """Named region inside an active capture (shows as a span)."""
    return torch.profiler.record_function(name)


def annotate(name=None):
    """Decorator: wrap a function in a named trace span."""

    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kw):
            with torch.profiler.record_function(label):
                return fn(*args, **kw)

        return wrapper

    return deco


def device_memory(device=None):
    """Caching-allocator statistics per CUDA device (``{"cuda:i":
    stats}``; empty without CUDA)."""
    if not torch.cuda.is_available():
        return {}
    devs = ([torch.device(device)] if device is not None else
            [torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    out = {}
    for d in devs:
        try:
            stats = torch.cuda.memory_stats(d)
        except Exception:
            stats = None
        out[str(d)] = stats
    return out


def summarize(logdir, top=20, device_only=True):
    """Aggregate device time per kernel from the newest trace under
    ``logdir``; returns [(name, total_ms, count)] sorted by time.

    Device events are the trace's kernel, memcpy and memset events (or
    those of a GPU process); a trace without any (a CPU-only capture)
    aggregates its host events instead, with a warning."""
    import glob
    import gzip
    import json

    candidates = sorted(
        glob.glob(os.path.join(logdir, "plugins", "profile", "*",
                               "*.trace.json.gz")),
        key=os.path.getmtime)
    if not candidates:
        raise FileNotFoundError(f"no trace found under {logdir}; call "
                                "profiler.start/stop first")
    with gzip.open(candidates[-1]) as f:
        events = json.load(f)["traceEvents"]
    device_pids = set()
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pname = str(e.get("args", {}).get("name", ""))
            if "GPU" in pname:
                device_pids.add(e["pid"])

    def on_device(e):
        return (e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                or e.get("pid") in device_pids)

    device = [e for e in events if e.get("ph") == "X" and on_device(e)]
    if device_only and not device:
        import warnings

        warnings.warn("profiler.summarize: no device events in this trace "
                      "(CPU-only capture?); aggregating host events instead",
                      stacklevel=2)
    chosen = device if (device_only and device) else [
        e for e in events if e.get("ph") == "X"]
    totals, counts = {}, {}
    for e in chosen:
        name = e["name"]
        totals[name] = totals.get(name, 0.0) + e.get("dur", 0) / 1e3
        counts[name] = counts.get(name, 0) + 1
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    return [(name, round(ms, 3), counts[name]) for name, ms in ranked]
