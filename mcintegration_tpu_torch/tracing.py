"""Spans of the port's own host work, on the profiler's clock.

``integrate`` opens a span at each boundary of the driver and of the solver
iteration (the names are listed in ``integrate``'s docstring).  A span is
recorded while an operator has called :func:`enable` (until
:func:`disable`), or while a ``torch.profiler`` profile is active; at any
other time :func:`span` returns one shared no-op object, at the cost of a
flag test and the profiler's own "is a profiler enabled" check, and never
opens a profiler range.

A recorded span appends one record to a bounded buffer (:data:`MAXLEN`
records, the oldest dropped first), read by :func:`spans` and emptied by
:func:`clear`:

- ``name``, ``id`` and ``parent`` (the id of the span open around it on the
  same thread, or None);
- ``call``: the id of the enclosing ``mct.call`` span, so every span of one
  ``integrate`` call shares it (None outside a call);
- ``t0_ns``, ``t1_ns``: ``time.perf_counter_ns()`` at its start and end;
- ``attrs``: the keywords it was opened with, and those :meth:`set` adds.

While a profiler is active a span also opens a profiler range of the same
name, so it sits on the profiler's host timeline, aligned with the device's,
and in the chrome trace the profiler exports.  The range is the profiler's
low-cost one (``_RecordFunctionFast``, about 2 us a span on a CPU core
against 16 us for ``torch.profiler.record_function``), which keeps what the
spans add to a profiled run small.

A span only reads the clock: recording adds no synchronize, barrier or
collective, so ranks of a mesh may record or not each on its own.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time

import torch

MAXLEN = 65536

_BUFFER: collections.deque = collections.deque(maxlen=MAXLEN)
_IDS = itertools.count(1)
_LOCAL = threading.local()          # .stack: the spans open on this thread
_enabled = False
_profiler_enabled = torch._C._autograd._profiler_enabled
_profiler_range = torch._C._profiler._RecordFunctionFast


def enable():
    """Record spans from now on, profiler or not."""
    global _enabled
    _enabled = True


def disable():
    """Record spans only while a profiler is active."""
    global _enabled
    _enabled = False


def recording() -> bool:
    """Is a span opened now recorded?"""
    return _enabled or _profiler_enabled()


def spans() -> list:
    """The recorded spans, oldest first, as dicts."""
    return list(_BUFFER)


def clear():
    """Empty the buffer."""
    _BUFFER.clear()


class _Off:
    """The span while recording is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "call", "t0_ns", "_rf")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def set(self, **attrs):
        """Add attributes to the span's record."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        up = stack[-1] if stack else None
        self.id = next(_IDS)
        self.parent = None if up is None else up.id
        self.call = self.id if self.name == "mct.call" else None if up is None else up.call
        self._rf = None
        if _profiler_enabled():
            self._rf = _profiler_range(self.name)
            self._rf.__enter__()
        stack.append(self)
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1_ns = time.perf_counter_ns()
        _LOCAL.stack.pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        _BUFFER.append(dict(name=self.name, id=self.id, parent=self.parent, call=self.call,
                            t0_ns=self.t0_ns, t1_ns=t1_ns, attrs=self.attrs))
        return False


def span(name: str, **attrs):
    """A context manager around host work named ``name``; recorded only
    while :func:`recording`."""
    if not (_enabled or _profiler_enabled()):
        return _OFF
    return _Span(name, attrs)

