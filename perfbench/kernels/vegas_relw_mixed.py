"""``vegas_relw_mixed``: the mixed route's relative weights for a custom
measure, the relw mode (third template argument 2) of
``vegas_reduce_mixed_kernel`` (csrc/vegas_mixed.cu).  Named so that the
device trace counts it among the port's own kernels; no cell reports its
roofline yet."""

NAMES = [r"\bvegas_reduce_mixed_kernel\s*<\s*\w+\s*,\s*\w+\s*,\s*(\(\w+\))?2\s*,"]
