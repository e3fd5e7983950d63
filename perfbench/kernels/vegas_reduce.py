"""``vegas_reduce`` (csrc/vegas_reduce.cu): the observable sums and the
training histogram of :vegas' uniform route.

Bytes the law needs at a launch of ``n`` samples: each sample's weights, and
each stratum row's density and permuted stratum, read once; the blocks'
sums and the histograms written once.  Operations: 8 float32 ones per
sample and integrand or slot.
"""

NAMES = [r"\bvegas_reduce_kernel\s*<"]


def counts(s):
    n, S, N, isz = s["n"], s["S"], s["N"], s["itemsize"]
    rows = S * (n // s["m"])
    nbytes = N * n * isz + rows * (isz + 4) + s["B"] * s["ncomp"] * 8 + s["nhist"] * 8
    return nbytes, 8 * n * (N + S), 0
