"""``vegas_sample_mixed`` (csrc/vegas_mixed.cu): the draw of :vegas' mixed
route (Discrete pools, or pools of different ``ninc``).

Bytes the law needs at a launch of ``n`` samples: the blocks' seeds, the
maps and CDFs, the multiplier and slot tables read once; each sample's
value and bin per slot written once.  Operations: per sample the hash of
its index, per value a lowbias32 round and the mixing (salt, mask), 10
integer operations each; 5 float32 operations per value (the uniform, the
map).
"""

NAMES = [r"\bvegas_sample_mixed_kernel\s*<"]
MIX32 = 8


def counts(s):
    n, S, isz = s["n"], s["S"], s["itemsize"]
    nbytes = s["B"] * 2 * 4 + s["tables"] * isz + s["meta"] * 4 + S * 64 * 4 + S * n * (isz + 4)
    return nbytes, 5 * n * S, n * (MIX32 + 2) + n * S * (MIX32 + 2)
