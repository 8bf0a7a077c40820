"""Request tracing: the no-op tracer the scheduler and engine default to.

The reference's ``RequestTracer`` (per-request JSONL timelines) is a
later port; its disabled stand-in is all the slice needs.
"""

from __future__ import annotations

__all__ = ["NOOP_TRACER"]


class _NoopTracer:
    """Do-nothing stand-in (scheduler default, so a bare Scheduler in a
    test needs no wiring)."""

    __slots__ = ()
    enabled = False

    def submitted(self, req):
        pass

    def event(self, req, name, **args):
        pass

    def terminal(self, req, name, **args):
        pass

    def close(self):
        pass


NOOP_TRACER = _NoopTracer()
