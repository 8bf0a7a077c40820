"""CUDA-side events into the metrics registry: kernel builds and graph
captures.

The port's counterpart of ``mxnet_tpu/telemetry/jaxmon.py``.  The
reference bridges ``jax.monitoring`` compile events; the port's compile
path is its own ``nvcc`` build of each kernel library
(``_build.build_library``, a hash-named directory of built libraries)
and its serving programs' CUDA-graph captures, so those are what it
counts:

  mxtpu_compile_cache_hits         a library found already built
  mxtpu_compile_cache_misses       a library that had to be built
  mxtpu_compile_cache_puts         a built library written to the
                                   directory (the reference's names;
                                   a miss that builds IS a put)
  mxtpu_cuda_nvcc_seconds{library} wall seconds of one library's build
                                   (every unit compiled, then linked)
  mxtpu_cuda_graph_captures_total{kind}
                                   serving programs captured as CUDA
                                   graphs, by program kind

The hooks gate on the telemetry enabled flag at *call* time and
re-resolve their families per event (builds and captures are rare), so
``telemetry.disable()`` or a test's ``registry.clear()`` needs no
unhooking.  Before :func:`install` they do nothing.
"""

from __future__ import annotations

__all__ = ["install", "note_build", "note_capture", "COMPILE_BUCKETS"]

# build durations stretch far beyond the request-latency defaults (the
# reference's compile buckets)
COMPILE_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                   30.0, 60.0, 120.0, 300.0)

_hooks = None        # (registry, enabled_fn) once installed


def install(registry, enabled_fn):
    """Feed ``registry`` from the build and capture hooks;
    ``enabled_fn() -> bool`` is consulted on every event."""
    global _hooks
    _hooks = (registry, enabled_fn)
    return True


def _live():
    if _hooks is None or not _hooks[1]():
        return None
    return _hooks[0]


def note_build(library, hit, seconds=None):
    """One ``build_library`` call: ``hit`` when the library was already
    built, else a build of ``seconds`` that wrote it."""
    reg = _live()
    if reg is None:
        return
    if hit:
        reg.counter("mxtpu_compile_cache_hits",
                    "persistent compile-cache hits").inc()
        return
    reg.counter("mxtpu_compile_cache_misses",
                "persistent compile-cache misses").inc()
    reg.counter("mxtpu_compile_cache_puts",
                "persistent compile-cache writes").inc()
    if seconds is not None:
        reg.histogram("mxtpu_cuda_nvcc_seconds",
                      "nvcc build seconds of one kernel library",
                      ("library",), buckets=COMPILE_BUCKETS
                      ).labels(library=library).observe(seconds)


def note_capture(kind):
    """One serving program captured as a CUDA graph."""
    reg = _live()
    if reg is None:
        return
    reg.counter("mxtpu_cuda_graph_captures_total",
                "serving programs captured as CUDA graphs",
                ("kind",)).labels(kind=kind).inc()
