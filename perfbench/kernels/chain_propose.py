"""``chain_propose`` (csrc/chain_propose.cu), a kernel of the Markov solvers.  Named so
that the device trace counts it among the port's own kernels; no cell runs
it yet."""

NAMES = [r"\bchain_propose_kernel\b"]
