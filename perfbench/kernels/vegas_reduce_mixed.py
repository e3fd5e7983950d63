"""``vegas_reduce_mixed`` (csrc/vegas_mixed.cu) given a custom measure's
output: the measure's sums and the maps' training histograms of a launch of
the mixed route.

Bytes the law needs at a launch of ``n`` samples: each sample's weights,
bins per slot and measure components read once, the maps and slot tables
read once; the blocks' sums and the histograms written once.  Operations:
per sample one per slot (the density), 8 per integrand (the padding factor,
the histogram weight) and one per measure component.

Only the given-m instantiations count (the kernel's third template argument
is its mode: 0 default, 1 given m, 2 relative weights); the relative
weights are ``vegas_relw_mixed``'s.
"""

NAMES = [r"\bvegas_reduce_mixed_kernel\s*<\s*\w+\s*,\s*\w+\s*,\s*(\(\w+\))?1\s*,"]


def counts(s):
    n, S, N, isz, ncomp = s["n"], s["S"], s["N"], s["itemsize"], s["ncomp"]
    nbytes = (N * n * isz + S * n * 4 + ncomp * n * isz + s["tables"] * isz + s["meta"] * 4
              + s["B"] * ncomp * 8 + s["nhist"] * 8)
    return nbytes, n * (S + 8 * N) + n * ncomp, 0
