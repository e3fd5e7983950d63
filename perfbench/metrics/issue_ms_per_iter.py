"""``issue_ms_per_iter`` (solver iteration): the mean milliseconds an
iteration spends in its ``mct.issue`` span, in the profiled calls: the host
issuing the iteration's launches, from the solver's ``run`` to its first
read from the device."""

from harness.spans import child_ms, iterations, profiled_calls


def read(ctx, arg=None):
    got = profiled_calls(ctx)
    if got is None:
        return None
    its = iterations(*got)
    if not its:
        return None
    return sum(child_ms(s, got[1], ("mct.issue",)) for s in its) / len(its)
