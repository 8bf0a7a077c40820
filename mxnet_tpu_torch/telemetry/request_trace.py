"""Request tracing: the no-op tracer the scheduler and engine default to.

The reference's ``RequestTracer`` (per-request JSONL timelines) is a
later port; its disabled stand-in is all the slice needs, plus
:class:`HookTracer`, the stand-in with the reference tracer's
``on_terminal`` hook (an adapters engine drops a request's slot pin
there).
"""

from __future__ import annotations

__all__ = ["NOOP_TRACER", "HookTracer"]


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


class HookTracer(_NoopTracer):
    """The no-op tracer that calls ``on_terminal(req, name, args)`` on
    every request's terminal event (finished, cancelled, rejected), as
    the reference ``RequestTracer``'s hook does.  A preemption is an
    event, never a terminal."""

    __slots__ = ("on_terminal",)

    def __init__(self, on_terminal):
        self.on_terminal = on_terminal

    def terminal(self, req, name, **args):
        self.on_terminal(req, name, args)
