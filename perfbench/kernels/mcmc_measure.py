"""``mcmc_measure`` (csrc/mcmc_measure.cu), a kernel of the Markov solvers.  Named so
that the device trace counts it among the port's own kernels; no cell runs
it yet."""

NAMES = [r"\bmcmc_measure_kernel\b"]
