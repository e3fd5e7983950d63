"""``integrand_pct`` (integrand and measure): the share of the device's busy
time, in the profiled calls, in kernels that are not the port's own
(``kernels/*.py`` name those): the integrand's and the measure's torch ops,
the non-finite guard and the measure's flattening."""

from harness.trace import is_kernel, owner


def read(ctx, arg=None):
    prof = ctx.get("profile")
    if not prof or prof["busy_s"] <= 0:
        return None
    other = sum(o["seconds"] for name, o in prof["ops"].items()
                if is_kernel(name) and owner(name, ctx["kernels"]) is None)
    return 100.0 * other / prof["busy_s"]
