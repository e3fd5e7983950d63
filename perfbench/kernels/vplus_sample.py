"""``vplus_sample`` (csrc/vplus_sample.cu): every sample drawn inside its
hypercube through the maps.

Bytes the law needs at a launch of ``n`` samples: the blocks' seeds, the
cube of each sample of a chunk, the maps and the slot table read once, and
each sample's value and map increment per slot written once.  Operations:
per drawn value 12 float32 ones (the uniform's convert, add and multiply,
the in-cube coordinate's convert, add and division, the map's six) and the
integer work of its uniform (a lowbias32 round, 8, with the counter add and
shift) and of its cube's coordinate (a multiply and shift, a multiply and
subtract), with the sample's keyed hash once a sample.
"""

NAMES = [r"\bvplus_sample_kernel\s*<"]
MIX32 = 8


def counts(s):
    n, S, isz = s["n"], s["S"], s["itemsize"]
    nbytes = (s["B"] * 2 * 4 + s["chunk"] * 4 + s["tables"] * isz + s["meta"] * 4
              + S * n * (isz + 4))
    return nbytes, 12 * n * S, (MIX32 + 2 + 4) * n * S + (MIX32 + 2) * n
