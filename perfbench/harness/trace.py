"""Reading a ``torch.profiler`` trace of whole calls.

A traced run profiles a few whole ``integrate`` calls from the steady part
of its window, each inside a ``perfbench.call`` span.  :func:`summarize`
reduces the profiler's events to what the per-layer readers and the
result's ``device`` and ``breakdown`` take: each device operation's name,
launches and seconds; the union of the device's busy intervals over the
profiled calls (from the first call's start to the last one's end); and the
idle gaps in that union, each named by what the host was doing at its
middle: the innermost profiled host span covering it (a torch op, a CUDA
runtime call, or a span of :data:`SPANS`).

``SPANS`` are the program's functions that a traced run wraps in spans of
its own, from outside the program (``mcintegration_tpu_torch`` itself has
none yet): the driver's host work between iterations, the iteration's
launches.
"""

from __future__ import annotations

import contextlib
import importlib
import re

# (module, attribute path, span name)
SPANS = [
    ("mcintegration_tpu_torch.main", "mean_std", "driver.mean_std"),
    ("mcintegration_tpu_torch.main", "_snapshot_config", "driver.snapshot_config"),
    ("mcintegration_tpu_torch.main", "block_keys", "driver.block_keys"),
    ("mcintegration_tpu_torch.models.variable", "Continuous.train", "driver.train_continuous"),
    ("mcintegration_tpu_torch.models.variable", "Discrete.train", "driver.train_discrete"),
    ("mcintegration_tpu_torch.solvers.vegasplus", "VegasPlusIteration.run", "iteration.run"),
    ("mcintegration_tpu_torch.solvers.vegasplus", "VegasPlusIteration.reallocate",
     "iteration.reallocate"),
    ("mcintegration_tpu_torch.solvers.vegas", "VegasIteration.run", "iteration.run"),
    ("mcintegration_tpu_torch.solvers.vegas", "VegasMixedIteration.run", "iteration.run"),
]
CALL_SPAN = "perfbench.call"


def _resolve(modname: str, path: str):
    obj = importlib.import_module(modname)
    *owners, attr = path.split(".")
    for o in owners:
        obj = getattr(obj, o)
    return obj, attr


@contextlib.contextmanager
def spans():
    """Wrap each function of :data:`SPANS` in a ``record_function`` span
    while the block runs; put them back after."""
    from torch.profiler import record_function

    saved = []
    try:
        for modname, path, span in SPANS:
            owner, attr = _resolve(modname, path)
            fn = getattr(owner, attr)

            def wrapped(*a, __fn=fn, __span=span, **kw):
                with record_function(__span):
                    return __fn(*a, **kw)

            saved.append((owner, attr, fn))
            setattr(owner, attr, wrapped)
        yield
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)


def is_kernel(name: str) -> bool:
    """A device operation that is a kernel: not a memory copy or fill."""
    return not name.startswith(("Memcpy", "Memset"))


def matches(name: str, kmod) -> bool:
    """Is ``name`` one of kernel module ``kmod``'s ``NAMES`` (patterns of
    the demangled names a device trace gives)?"""
    return any(re.search(p, name) for p in kmod.NAMES)


def owner(name: str, kernels: dict):
    """The name of the port's kernel (``kernels/*.py``) a device operation
    belongs to, or None for any other (a torch op's kernel)."""
    return next((k for k, mod in kernels.items() if matches(name, mod)), None)


def union_s(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    busy, reach = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > reach:
            busy += b - max(a, reach)
            reach = b
    return busy


def gaps(intervals, lo: float, hi: float):
    """The stretches of ``[lo, hi]`` that no interval covers, as
    ``(start, end)``."""
    out, reach = [], lo
    for a, b in sorted(intervals):
        if a > reach:
            out.append((reach, min(a, hi)))
        reach = max(reach, b)
        if reach >= hi:
            break
    if reach < hi:
        out.append((reach, hi))
    return [(a, b) for a, b in out if b > a]


def summarize(device_ops, host_ops, top: int = 10) -> dict:
    """``device_ops``: ``(name, start, end)`` of every device operation, in
    seconds on the profiler's clock; ``host_ops``: ``(name, start, end)`` of
    every host event, ``CALL_SPAN`` included.  Returns the profiled window,
    the device's busy seconds in it, its operations by name and the idle
    gaps by what the host was doing."""
    calls = [(a, b) for name, a, b in host_ops if name == CALL_SPAN]
    if not calls:
        raise ValueError("the trace holds no profiled call")
    lo, hi = min(a for a, _ in calls), max(b for _, b in calls)
    inside = [(n, max(a, lo), min(b, hi)) for n, a, b in device_ops if b > lo and a < hi]
    busy = union_s([(a, b) for _, a, b in inside])
    by_name = {}
    for n, a, b in inside:
        cnt, sec = by_name.get(n, (0, 0.0))
        by_name[n] = (cnt + 1, sec + (b - a))
    host = sorted((a, b, n) for n, a, b in host_ops if n != CALL_SPAN and b > a)
    idle, active, i = {}, [], 0
    for a, b in sorted(gaps([(x, y) for _, x, y in inside], lo, hi),
                       key=lambda g: g[0] + g[1]):
        mid = 0.5 * (a + b)                  # a sweep: the host spans open at mid
        while i < len(host) and host[i][0] <= mid:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] >= mid]
        label = min(active, key=lambda h: h[1] - h[0])[2] if active else \
            "host: python, no profiled op"
        idle[label] = idle.get(label, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return {
        "window_s": hi - lo,
        "busy_s": busy,
        "ops": {n: {"launches": c, "seconds": s} for n, (c, s) in by_name.items()},
        "device_ops": [[n[:160], s] for n, (_, s) in ops[:top]],
        "idle_gaps": sorted(([n[:160], s] for n, s in idle.items()), key=lambda x: -x[1])[:top],
    }


def events(prof):
    """``(device_ops, host_ops)`` of a finished ``torch.profiler.profile``,
    in seconds."""
    from torch.autograd import DeviceType

    dev, host = [], []
    spans = {CALL_SPAN} | {span for _, _, span in SPANS}
    for e in prof.events():
        rng = (e.time_range.start * 1e-6, e.time_range.end * 1e-6)
        # a span's copy on the device's timeline is no device operation
        annotation = getattr(e, "is_user_annotation", False) or e.name in spans
        if e.device_type == DeviceType.CUDA and not annotation:
            dev.append((e.name, *rng))
        elif e.device_type == DeviceType.CPU:
            host.append((e.name, *rng))
    return dev, host
