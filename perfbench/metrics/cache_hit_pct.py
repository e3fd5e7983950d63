"""``cache_hit_pct`` (driver): the iteration cache's hits, in percent of
the profiled calls that looked it up and could use it: the ``mct.call``
spans whose ``cache`` attribute is ``hit`` over those with ``hit`` or
``miss`` (``uncacheable`` and ``off`` calls are left out)."""

from harness.spans import profiled_calls


def read(ctx, arg=None):
    got = profiled_calls(ctx)
    if got is None:
        return None
    looked = [c["attrs"].get("cache") for c in got[0]]
    looked = [x for x in looked if x in ("hit", "miss")]
    if not looked:
        return None
    return 100.0 * looked.count("hit") / len(looked)
