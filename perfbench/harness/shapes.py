"""A cell's launch shapes, from its configuration and the solvers' plans.

The kernels' byte and operation counts (``kernels/*.py``) take a launch's
shape: its samples ``n`` (from the device trace: the profiled calls'
evaluations over the kernel's launches), the slots ``S``, integrands
``N``, observable components ``ncomp``, blocks ``B``, the map tables' and
histograms' sizes, and on :vegasplus the hypercubes and the chunk, on
:vegas' uniform route the samples a stratum holds in a chunk.  The plans
are frozen copies of the solvers' laws (``solvers/vegasplus.py:shape_plan``,
``solvers/vegas.py:pick_m_tile``), so a change to the program moves the
time it takes and not the yardstick.
"""

from __future__ import annotations

import math


def vplus_plan(D: int, nevalperblock: int, max_cubes=16384, max_chunk=131072):
    """``(nstrat, ncubes, chunk, nchunks)`` of :vegasplus over ``D``
    stratified dimensions."""
    c = max(1, min(int(nevalperblock), max_chunk))
    nstrat = max(2, int(max_cubes ** (1.0 / D)))
    while nstrat ** D > max_cubes:
        nstrat -= 1
    nstrat = max(nstrat, 1 if D > 8 else 2)
    ncubes = nstrat ** D
    c = max(c, 2 * ncubes)
    return nstrat, ncubes, c, max(1, -(-int(nevalperblock) // c))


def samples_per_stratum(nslots: int, N: int, nb: int, m_avail: int) -> int:
    """Samples per stratum and chunk of :vegas' uniform route."""
    lev = max(8, -(-int(math.ceil(math.sqrt(max(nb, 1)))) // 8) * 8)
    live_per_m = (nslots + N + 6) * lev * lev * 4
    m = 128
    while m * 2 <= min(2048, m_avail) and live_per_m * m * 2 <= 44 * 2 ** 20:
        m *= 2
    return min(m, max(1, m_avail)) if m_avail < 128 else m


def launch_shape(cell: dict, cfg) -> dict:
    """The shape fields every launch of ``cell`` shares (all but ``n``)."""
    vars_ = cfg.VARS
    cont = [v for v in vars_ if v["kind"] == "continuous"]
    S = sum(v["draws"] for v in vars_)
    N = 1
    ncomp = len(cfg.EXACT) if getattr(cfg, "measure", None) is not None else N
    itemsize = 8 if cell.get("dtype", "float32") == "float64" else 4
    tables = sum(2 * v["ninc"] for v in cont) + sum(
        2 * (v["upper"] - v["lower"] + 1) + 1 for v in vars_ if v["kind"] == "discrete")
    B = cell["block"]
    npb = cell["neval"] // cell["block"]
    shape = dict(S=S, N=N, ncomp=ncomp, B=B, itemsize=itemsize, tables=tables,
                 nhist=sum(v["ninc"] for v in cont), meta=8 * S)
    if cell["solver"] == "vegasplus":
        D = sum(v["draws"] for v in cont)
        _, shape["ncubes"], shape["chunk"], _ = vplus_plan(D, npb)
    elif cell["solver"] == "vegas":
        nb = cont[0]["ninc"]
        m = samples_per_stratum(S, N, nb, max(1, npb // nb))
        while m > 128 and nb * m * max(1, -(-npb // (nb * m))) > 1.1 * npb:
            m //= 2
        shape["strata"], shape["m"] = nb, m
    return shape
