"""The port's own spans (``mcintegration_tpu_torch.tracing``) in a traced
run's profiled calls.

The port records its spans while a ``torch.profiler`` profile is active, so
a traced run's buffer holds the spans of the calls :data:`window.PROFILED`
names.  A ``mct.call`` span belongs to a profiled call when it lies inside
that call's ``[t0, t1]``: both are on the ``perf_counter`` clock.  A port
without the module, or one that recorded no such call, gives nothing to
read.
"""

from __future__ import annotations


def profiled_calls(ctx):
    """``(calls, children)``: the ``mct.call`` span of each profiled call,
    and every recorded span's children by parent id; None when there are
    none."""
    try:
        from mcintegration_tpu_torch import tracing
    except ImportError:
        return None
    windows = [(c["t0"] * 1e9, c["t1"] * 1e9) for c in ctx["calls"] if c["profiled"]]
    recs = tracing.spans()
    calls = [s for s in recs if s["name"] == "mct.call"
             and any(a <= s["t0_ns"] and s["t1_ns"] <= b for a, b in windows)]
    if not calls:
        return None
    children = {}
    for s in recs:
        children.setdefault(s["parent"], []).append(s)
    return calls, children


def ms(s) -> float:
    """A span's duration in milliseconds."""
    return 1e-6 * (s["t1_ns"] - s["t0_ns"])


def iterations(calls, children) -> list:
    """The ``mct.iteration`` spans of ``calls``."""
    return [s for c in calls for s in children.get(c["id"], []) if s["name"] == "mct.iteration"]


def child_ms(s, children, names) -> float:
    """Milliseconds of ``s``'s children named in ``names``."""
    return sum(ms(k) for k in children.get(s["id"], []) if k["name"] in names)
