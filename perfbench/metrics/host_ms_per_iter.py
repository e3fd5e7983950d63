"""``host_ms_per_iter`` (driver): the host's milliseconds in an iteration
once the device has drained, the mean over the profiled calls'
``mct.iteration`` spans of each span's duration less its ``mct.issue`` and
``mct.wait`` children: the rest of the statistics' copy and shaping, the ranks' gather,
reallocation, the merge, training and the snapshot, with nothing queued on
the device."""

from harness.spans import child_ms, iterations, ms, profiled_calls


def read(ctx, arg=None):
    got = profiled_calls(ctx)
    if got is None:
        return None
    its = iterations(*got)
    if not its:
        return None
    children = got[1]
    return sum(ms(s) - child_ms(s, children, ("mct.issue", "mct.wait")) for s in its) / len(its)
