"""``vegas_relw`` (csrc/vegas_reduce.cu): a custom measure's relative
weights on :vegas' uniform route.  Named so that the device trace counts it
among the port's own kernels; no cell reports its roofline yet."""

NAMES = [r"\bvegas_relw_kernel\s*<"]
