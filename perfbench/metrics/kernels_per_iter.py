"""``kernels_per_iter`` (solver iteration): device kernels of every name
an iteration, in the profiled calls (memory copies and fills are not
kernels)."""

from harness.trace import is_kernel


def read(ctx, arg=None):
    prof = ctx.get("profile")
    if not prof or not ctx["profiled_iters"]:
        return None
    n = sum(o["launches"] for name, o in prof["ops"].items() if is_kernel(name))
    return n / ctx["profiled_iters"] if n else None
