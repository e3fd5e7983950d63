"""``vplus_relw`` (csrc/vplus_reduce.cu): a custom measure's relative
weights on :vegasplus.  Named here so that the device trace counts it among
the port's own kernels; no cell reports its roofline yet."""

NAMES = [r"\bvplus_relw_kernel\s*<"]
