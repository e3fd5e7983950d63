"""``vegas_sample`` (csrc/vegas_sample.cu): the stratified draw of :vegas'
uniform route.

Bytes the law needs at a launch of ``n`` samples: the blocks' seeds (int64),
the multiplier table and the maps read once; each sample's value per slot,
and each stratum row's density and permuted stratum (``m`` samples a row)
written once.  Operations: per drawn value 5 float32 ones (the uniform's
convert, add and multiply, the map's multiply and add) and 19 integer ones
(two lowbias32 rounds and the mixing of the draw's index: i ^ k1, + k2 +
salt, & 0xFFFFFF).
"""

NAMES = [r"\bvegas_sample_kernel\s*<"]
MIX32 = 8
DRAW_INT = 2 * MIX32 + 3


def counts(s):
    n, S, isz = s["n"], s["S"], s["itemsize"]
    rows = S * (n // s["m"])
    nbytes = s["B"] * 2 * 8 + S * 64 * 4 + s["tables"] * isz + S * n * isz + rows * (isz + 4)
    return nbytes, 5 * n * S, DRAW_INT * n * S
