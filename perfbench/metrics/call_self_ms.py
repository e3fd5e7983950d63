"""``call_self_ms`` (driver): the mean over the profiled calls of the
``mct.call`` span's milliseconds less its ``mct.iteration`` children: the
variables' set-up, the cache key, the build of the iteration on a miss and
the ``Result``, timed inside the program (``call_overhead_ms`` times the
same from outside the call)."""

from harness.spans import child_ms, ms, profiled_calls


def read(ctx, arg=None):
    got = profiled_calls(ctx)
    if got is None:
        return None
    calls, children = got
    return sum(ms(c) - child_ms(c, children, ("mct.iteration",)) for c in calls) / len(calls)
