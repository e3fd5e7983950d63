"""``idle_pct`` (device): the share of the profiled calls' wall time in
which no device operation runs (the union of the device's intervals)."""


def read(ctx, arg=None):
    prof = ctx.get("profile")
    if not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
