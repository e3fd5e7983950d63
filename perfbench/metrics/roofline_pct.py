"""``roofline_pct.<kernel>`` (kernels): the kernel's bound over its device
time a launch, in percent.

The bound is ``harness/peaks.py:bound_s`` of the bytes and operations
``kernels/<kernel>.py:counts`` gives at the launch's shape, against the
H100 SXM's published peaks; the device time is the profiled calls' time in
the kernel's names over its launches.  A launch's samples ``n`` are the
profiled calls' evaluations over those launches.  Nothing to read in a
cell whose file does not list the kernel, or where it did not run."""

from harness.peaks import bound_s
from harness.trace import matches


def read(ctx, arg):
    prof = ctx.get("profile")
    k = ctx["kernels"].get(arg)
    if not prof or arg not in ctx["cell"].get("kernels", []) or not hasattr(k, "counts"):
        return None
    launches = seconds = 0
    for name, o in prof["ops"].items():
        if matches(name, k):
            launches += o["launches"]
            seconds += o["seconds"]
    if not launches or seconds <= 0:
        return None
    shape = dict(ctx["shape"], n=ctx["profiled_evals"] // launches)
    nbytes, flops, int_ops = k.counts(shape)
    f64 = shape["itemsize"] == 8
    return 100.0 * bound_s(nbytes, flops, int_ops, f64) / (seconds / launches)
