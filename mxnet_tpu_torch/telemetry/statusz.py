"""/statusz: live process introspection behind the telemetry HTTP server.

The port of ``mxnet_tpu/telemetry/statusz.py``.  The reference's ``jax``
section becomes a ``torch`` section (torch version, CUDA runtime, each
card's name, capability and allocator bytes), and
:func:`bytes_by_device` counts torch tensors.  Every provider reads host
state only: a provider runs on the HTTP thread, and a CUDA call there
(a synchronise, a copy, an ``.item()``) while the step thread captures
a CUDA graph would invalidate the capture.

Metrics answer "how fast"; `/statusz` answers "what is the process
doing RIGHT NOW": in-flight serve requests with ages and phases, queue
depth, KV block-manager occupancy, program and warm-start state, the
torch and card inventory, and uptime — one JSON (``/statusz.json``) or HTML
(``/statusz``) snapshot assembled from registered *providers*.

A provider is a zero-arg callable returning a JSON-serializable dict.
Subsystems register at construction time (``serve.Engine``,
``CompileCacheManager``, the fused-step selector); long-lived objects
register through a weakref (:func:`register_weak`) so a retired engine
drops out of the page instead of pinning multi-GB parameter dicts.  A
provider that raises contributes ``{"error": ...}`` — one broken
subsystem never takes down the page.

The snapshot is also embedded in every flight-recorder dump, so
post-mortems carry the same live-state view the endpoint would have
served.
"""

from __future__ import annotations

import itertools
import os
import threading
import time

__all__ = ["register", "register_weak", "unregister", "snapshot",
           "render_html", "bytes_by_device", "register_health",
           "unregister_health", "health"]

_lock = threading.Lock()
_providers = {}                  # name -> zero-arg callable
_health_providers = {}           # name -> zero-arg callable
# uptime is an ELAPSED quantity: monotonic, so an NTP step can't make
# a 2-minute-old process report hours (or negative seconds) of uptime
_start_m = time.monotonic()
_uid = itertools.count()


def register(name, fn):
    """Register provider ``fn`` under ``name`` (replacing any previous
    one).  Returns ``name`` for a later :func:`unregister`."""
    with _lock:
        _providers[str(name)] = fn
    return str(name)


def register_weak(obj, name, method="statusz"):
    """Register ``obj.<method>()`` without keeping ``obj`` alive; the
    entry auto-unregisters once ``obj`` is collected."""
    import weakref

    name = f"{name}#{next(_uid)}"
    ref = weakref.ref(obj)

    def provider():
        target = ref()
        if target is None:
            unregister(name)
            return None
        return getattr(target, method)()

    return register(name, provider)


def unregister(name):
    with _lock:
        _providers.pop(name, None)


# -- /healthz: liveness/readiness, deliberately CHEAP -------------------------
# A supervisor or router probing every replica every few hundred ms
# must not pay the /statusz.json assembly cost (every provider runs,
# the torch inventory, JSON of the whole engine state).  Health providers are
# a separate, tiny registry: each returns a small dict with a
# ``status`` field ("ok" / "draining" / anything else = unhealthy) and
# the endpoint renders only those.
def register_health(name, fn):
    """Register health provider ``fn`` (zero-arg -> small dict with a
    ``status`` key) under ``name``; returns ``name``."""
    with _lock:
        _health_providers[str(name)] = fn
    return str(name)


def unregister_health(name):
    with _lock:
        _health_providers.pop(name, None)


def health():
    """One cheap liveness/readiness snapshot: ``status`` is "ok" when
    every provider reports ok, else the first non-ok status (providers
    that raise report status "error" without taking the page down).
    Never touches the metrics registry or the statusz providers."""
    with _lock:
        providers = dict(_health_providers)
    out = {"status": "ok", "pid": os.getpid(),
           "uptime_s": round(time.monotonic() - _start_m, 3)}
    checks = {}
    for name, fn in sorted(providers.items()):
        try:
            c = fn()
        except Exception as e:
            c = {"status": "error", "error": repr(e)}
        if c is None:               # dead weakref-style provider
            continue
        checks[name] = c
        st = c.get("status") if isinstance(c, dict) else None
        if st is not None and st != "ok" and out["status"] == "ok":
            out["status"] = str(st)
    if checks:
        out["checks"] = checks
    return out


def bytes_by_device(arrays):
    """Per-device resident bytes for a collection of torch tensors:
    ``{device_index: bytes}``, the CPU under ``"cpu"``.  Each storage
    counts once, however many views of it are passed (an engine's
    program inputs are views of one buffer).  Non-tensor leaves (numpy,
    None) are skipped, so callers can pass a mixed parameter dict's
    values directly.  Reads tensor metadata only, never the device."""
    out = {}
    seen = set()
    for arr in arrays:
        dev = getattr(arr, "device", None)
        storage = getattr(arr, "untyped_storage", None)
        if dev is None or storage is None:
            continue
        try:
            st = storage()
            key = (str(dev), st.data_ptr())
            if key in seen:
                continue
            seen.add(key)
            idx = "cpu" if dev.type == "cpu" else int(dev.index or 0)
            out[idx] = out.get(idx, 0) + int(st.nbytes())
        except (RuntimeError, ValueError):
            continue                 # freed or meta tensor
    return out


def _torch_inventory():
    """The torch section: version, CUDA runtime, and each card's name,
    capability and caching-allocator bytes.  Host reads only: the
    properties are cached by torch at initialisation and the allocator
    keeps its counters on the host; CUDA is never initialised here."""
    try:
        import torch

        out = {"version": torch.__version__,
               "cuda_runtime": torch.version.cuda,
               "cuda_initialized": torch.cuda.is_initialized()}
        if not out["cuda_initialized"]:
            return out
        devices = []
        for i in range(torch.cuda.device_count()):
            props = torch.cuda.get_device_properties(i)
            devices.append({
                "index": i, "name": props.name,
                "capability": f"{props.major}.{props.minor}",
                "total_bytes": int(props.total_memory),
                "allocated_bytes": int(torch.cuda.memory_allocated(i)),
                "reserved_bytes": int(torch.cuda.memory_reserved(i))})
        out["device_count"] = len(devices)
        out["devices"] = devices
        return out
    except Exception as e:
        return {"error": repr(e)}


def snapshot():
    """One JSON-serializable snapshot of every registered provider plus
    the process section (pid, uptime, torch inventory)."""
    with _lock:
        providers = dict(_providers)
    out = {"process": {"pid": os.getpid(),
                       "uptime_s": round(time.monotonic() - _start_m, 3),
                       # mxtpu-lint: disable=wall-clock (the "time"
                       # field IS the wall timestamp readers correlate
                       # with their logs)
                       "time": round(time.time(), 3)},
           "torch": _torch_inventory()}
    for name, fn in sorted(providers.items()):
        try:
            section = fn()
        except Exception as e:
            section = {"error": repr(e)}
        if section is not None:                  # None = dead weakref
            out[name] = section
    return out


def _html_value(value):
    import html as _html
    import json as _json

    return ("<pre>"
            + _html.escape(_json.dumps(value, indent=2, default=str))
            + "</pre>")


def render_html(snap=None):
    """Minimal dependency-free HTML view of :func:`snapshot` — one
    <section> per provider with the JSON pretty-printed."""
    import html as _html

    snap = snapshot() if snap is None else snap
    parts = ["<!doctype html><html><head><title>mxtpu /statusz</title>",
             "<style>body{font-family:monospace;margin:1em}",
             "h2{border-bottom:1px solid #999;margin:1em 0 .2em}",
             "pre{margin:.2em 0 .8em;white-space:pre-wrap}</style>",
             "</head><body><h1>mxtpu /statusz</h1>"]
    for name in snap:
        parts.append(f"<h2>{_html.escape(str(name))}</h2>")
        parts.append(_html_value(snap[name]))
    parts.append("</body></html>")
    return "".join(parts)
