"""``vplus_reduce`` (csrc/vplus_reduce.cu, its default mode): the sampling
density, the padded observable sums, the per-cube second moments and the
maps' training histograms of a launch.

Bytes the law needs at a launch of ``n`` samples: each sample's weights and
map increments read once, the cube table, the cubes' factors, the maps and
the slot table read once; the blocks' sums, the cubes' second moments and
the histograms written once.  Operations: 40 float32 ones per sample, slot
and integrand.  Both bodies of the kernel count here: the float32 default
(``vplus_reduce_kernel``) and the chunked one (``vplus_reduce_chunks_kernel``,
the complex and float64 defaults).
"""

NAMES = [r"\bvplus_reduce_kernel\s*<", r"\bvplus_reduce_chunks_kernel\s*<"]


def counts(s):
    n, S, N, isz = s["n"], s["S"], s["N"], s["itemsize"]
    nbytes = (N * n * isz + S * n * 4 + s["chunk"] * 4 + s["ncubes"] * 4
              + s["tables"] * isz + s["meta"] * 4
              + s["B"] * s["ncomp"] * 8 + s["ncubes"] * 8 + s["nhist"] * 8)
    return nbytes, 40 * n * (S + N), 0
