"""``call_overhead_ms`` (driver): the host's milliseconds in an
``integrate`` call outside its iterations, a call's wall time on the host's
clock less the sum of its ``Result.iteration_times``, the mean over the
window's calls (in a traced run, over the calls that were not profiled).
It holds the build of the call's iteration (the iteration cache keys on the
seed, so each call of the window builds its own), the variables' set-up and
the ``Result``'s statistics."""


def read(ctx, arg=None):
    calls = [c for c in ctx["calls"] if not c["profiled"]]
    if not calls:
        return None
    return 1e3 * sum(c["t1"] - c["t0"] - sum(c["iter_times"]) for c in calls) / len(calls)
