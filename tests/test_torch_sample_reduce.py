"""PyTorch port: what ``vplus_sample``, ``vegas_sample`` and ``chain_propose``
take from the host, and what ``vegas_reduce`` does.

Three kernels divide by a runtime divisor as a multiply and a shift by
``(mul, shift)``, which the launch computes on the host
(``csrc/divide.cuh:divisor``).  ``divisor`` below is its model: the tests
hold it, and every quotient the kernels form with it, against floor
division and ``%``.  ``vplus_sample`` forms a sample's stratified
coordinates by successive divisions of its cube index by ``nstrat``, and
takes the d-th stratified slot's coordinate from the d-th division, which
needs the layout to give the stratified slots the strides ``nstrat^d`` in
slot order.  ``vegas_sample`` forms a draw's stratum ``p = e / m`` (of its
quad ``Q = e / 4`` by ``m / 4`` where ``m % 4 == 0``) and the permuted
stratum ``(a*p + s) mod nb``; ``chain_propose`` a walker's block ``w / wb``.
``tools/sample_reduce_variants.py`` times variants of ``vegas_reduce``,
``vplus_sample`` and ``vegas_sample`` built from edited copies of their
sources; each edit must still find its line.  The kernels themselves are
held to their plain versions on the card (``tests/test_torch_cuda.py``).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import mcintegration_tpu_torch as mt
from mcintegration_tpu_torch.ops import _build, vplus_kernels as vp
from mcintegration_tpu_torch.solvers.engine import Spec
from mcintegration_tpu_torch.solvers.vegasplus import MAX_DIMS

MAX_CUBES = 16384    # the solver's default bound on nstrat^D (solvers/vegasplus.py)


def divisor(n):
    """``(mul, shift)`` of ``csrc/divide.cuh:divisor``."""
    l = 0
    while (1 << l) < n:
        l += 1
    shift = 31 + l
    return ((1 << shift) + n - 1) // n, shift


def divide(x, mul, shift):
    """floor(x / n) as the kernel forms it, for uint64 arrays x < 2^31."""
    return (x * np.uint64(mul)) >> np.uint64(shift)


@pytest.mark.parametrize("D", range(1, MAX_DIMS + 1))
def test_coordinates_by_multiply_and_shift(D):
    """For every nstrat whose nstrat^D cubes stay within the default
    max_cubes, every cube index below nstrat^D: the d-th of D successive
    divisions gives (cube // nstrat^d) % nstrat, the plain version's
    coordinate.  The multiplier fits in 32 bits."""
    n = 1
    while n ** D <= MAX_CUBES:
        mul, shift = divisor(n)
        assert mul < 2 ** 32
        cube = np.arange(n ** D, dtype=np.uint64)
        q = cube
        for d in range(D):
            nxt = divide(q, mul, shift)
            assert np.array_equal(q - nxt * np.uint64(n), (cube // n ** d) % n), (n, D, d)
            q = nxt
        assert not q.any(), (n, D)
        n += 1


def test_divisor_exact_below_2_31():
    """floor(x / n) for the edges of every quotient and random x up to
    2^31 - 1, at divisors beyond the default max_cubes: the powers of two and
    their neighbours, large primes, and random ones."""
    rng = np.random.default_rng(10)
    ns = {1, 2, 3, 5, 7, 25, 16383, 16385, 65537, 1000003, 2 ** 31 - 1}
    ns |= {2 ** k + e for k in range(1, 31) for e in (-1, 0, 1)}
    ns |= set(rng.integers(1, 2 ** 31, size=200).tolist())
    top = 2 ** 31 - 1
    for n in sorted(ns):
        mul, shift = divisor(n)
        assert mul < 2 ** 32, n
        k = np.unique(np.minimum(rng.integers(0, top // n + 1, size=500), top // n))
        edges = np.concatenate([k * n, k * n + n - 1, k * n - 1, [0, top]])
        x = np.concatenate([edges, rng.integers(0, top + 1, size=2000)])
        x = x[(x >= 0) & (x <= top)].astype(np.uint64)
        assert np.array_equal(divide(x, mul, shift), x // np.uint64(n)), n


MAX_STRATA = 32768   # ops/vegas_kernels.py
MAX_M_TILE = 2048    # solvers/vegas.py:pick_m_tile


def _vegas_strata(m, chunk, vec):
    """(p, q) of every draw index e < chunk as vegas_sample forms them: of
    its quad Q = e / 4 by m / 4 (vec), or of e by m."""
    e = np.arange(chunk, dtype=np.uint64)
    if vec:
        mul, shift = divisor(m // 4)
        p = divide(e // np.uint64(4), mul, shift)
    else:
        mul, shift = divisor(m)
        p = divide(e, mul, shift)
    return p, e - p * np.uint64(m)


def _index_model_e_over_m_quads():
    """p and q of every draw of the largest chunk (MAX_STRATA strata of
    MAX_M_TILE samples) and of every chunk of m = 4..MAX_M_TILE in steps of
    4 at a few strata counts, from the quads."""
    mul, shift = divisor(MAX_M_TILE // 4)
    step = 2 ** 21
    for q0 in range(0, MAX_STRATA * MAX_M_TILE // 4, step):   # every quad, in pieces
        Q = np.arange(q0, q0 + step, dtype=np.uint64)
        assert np.array_equal(divide(Q, mul, shift), Q // np.uint64(MAX_M_TILE // 4)), q0
    for m in range(4, MAX_M_TILE + 1, 4):
        for nb in (1, 7, 1024):
            e = np.arange(nb * m, dtype=np.uint64)
            p, q = _vegas_strata(m, nb * m, True)
            assert np.array_equal(p, e // np.uint64(m)) and np.array_equal(q, e % np.uint64(m)), m


def _index_model_e_over_m_scalar():
    """p and q of every draw of every chunk of m = 1..MAX_M_TILE at a few
    strata counts, and of the largest flat index the scalar path takes
    (below 2^31) at every m < 128 (pick_m_tile's other sizes)."""
    for m in range(1, MAX_M_TILE + 1):
        for nb in (1, 3, 37):
            e = np.arange(nb * m, dtype=np.uint64)
            p, q = _vegas_strata(m, nb * m, False)
            assert np.array_equal(p, e // np.uint64(m)) and np.array_equal(q, e % np.uint64(m)), m
    top = 2 ** 31 - 1
    for m in range(1, 128):
        mul, shift = divisor(m)
        e = np.arange(top - 4096, top + 1, dtype=np.uint64)
        e = np.concatenate([e, np.arange(0, top, top // 8191, dtype=np.uint64)])
        assert np.array_equal(divide(e, mul, shift), e // np.uint64(m)), m


def _index_model_strata_permutation():
    """(a*p + s) mod nb for every nb <= MAX_STRATA, with the largest
    multiplier and stratum (nb - 1) and every s, and with random a, p, s:
    a*p + s < nb^2 <= 2^30 stays inside the divisor's exact range."""
    rng = np.random.default_rng(11)
    for nb in range(1, MAX_STRATA + 1):
        mul, shift = divisor(nb)
        s = np.arange(nb, dtype=np.uint64)
        big = np.uint64(nb - 1)
        r = np.concatenate([big * big + s, rng.integers(0, nb, 64, dtype=np.uint64)
                            * rng.integers(0, nb, 64, dtype=np.uint64)
                            + rng.integers(0, nb, 64, dtype=np.uint64)])
        assert int(r.max()) < 2 ** 31
        pm = r - divide(r, mul, shift) * np.uint64(nb)
        assert np.array_equal(pm, r % np.uint64(nb)), nb


def _index_model_walker_decode():
    """w -> (b, j) = (w / wb, w - b*wb) for the walker counts a block may
    hold: every w at small wb, the edges of every block and random w at
    large ones, up to W = block * wb < 2^31."""
    rng = np.random.default_rng(12)
    for wb in list(range(1, 2049)) + [4095, 65536, 65537, 2 ** 20 - 1, 2 ** 20, 2 ** 27 + 3,
                                      2 ** 30, 2 ** 31 - 1]:
        block = max(1, min(64, (2 ** 31 - 1) // wb))
        mul, shift = divisor(wb)
        if wb <= 2048:
            w = np.arange(block * wb, dtype=np.uint64)
        else:
            k = np.arange(block, dtype=np.uint64) * np.uint64(wb)
            w = np.concatenate([k, k + np.uint64(wb - 1), k[1:] - np.uint64(1),
                                rng.integers(0, block * wb, 4096, dtype=np.uint64)])
        b = divide(w, mul, shift)
        assert np.array_equal(b, w // np.uint64(wb)), wb
        assert np.array_equal(w - b * np.uint64(wb), w % np.uint64(wb)), wb


INDEX_MODELS = {"e / m, quads": _index_model_e_over_m_quads,
                "e / m, scalar": _index_model_e_over_m_scalar,
                "(a*p + s) mod nb": _index_model_strata_permutation,
                "walker decode": _index_model_walker_decode}


@pytest.mark.parametrize("name", list(INDEX_MODELS))
def test_index_model_by_multiply_and_shift(name):
    """Every quotient vegas_sample and chain_propose form by multiply and
    shift (csrc/divide.cuh) is the floor division over its whole range."""
    INDEX_MODELS[name]()


SPECS = ["3-D", "passenger between pools", "composite with a passenger"]


def _spec_config(name):
    c, d = mt.Continuous, mt.Discrete
    if name == "3-D":
        return mt.Configuration(var=c(0.0, 1.0), dof=[[3]], seed=1)
    if name == "passenger between pools":
        return mt.Configuration(var=(c(0.0, 1.0), d(1, 5), c(0.0, 2.0, ninc=64)),
                                dof=[[2, 1, 1], [1, 2, 3]], seed=1)
    return mt.Configuration(var=(mt.CompositeVar(c(0.0, 1.0, ninc=100), d(1, 7)),
                                 c(-1.0, 1.0, adapt=False)), dof=[[1, 0], [2, 1]], seed=1)


@pytest.mark.parametrize("name", SPECS)
@pytest.mark.parametrize("nstrat", [1, 3, 25])
def test_stratified_strides_in_slot_order(name, nstrat):
    """The layout gives the d-th stratified (Continuous) slot, in slot
    order, the stride nstrat^d, and every Discrete slot the stride 0: what
    vplus_sample's successive divisions assume."""
    lay = vp.VplusLayout.build(Spec(_spec_config(name), torch.device("cpu")), nstrat)
    strides = [int(r[5]) for r in lay.slots if r[0] == 0]
    assert strides == [nstrat ** d for d in range(lay.D)]
    assert all(int(r[5]) == 0 for r in lay.slots if r[0] == 1)
    assert len(strides) == lay.D >= 1


def _variants_module():
    path = Path(__file__).resolve().parents[1] / "tools" / "sample_reduce_variants.py"
    spec = importlib.util.spec_from_file_location("sample_reduce_variants", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_MODULE = _variants_module()
_VARIANTS = _MODULE.variants() + _MODULE.ablations()


@pytest.mark.parametrize("k", range(len(_VARIANTS)), ids=[v[0] for v in _VARIANTS])
def test_sample_reduce_variant_edits_find_their_lines(k):
    """Each variant and ablation of tools/sample_reduce_variants.py changes
    the kept kernels: every source edit replaces a line found exactly once
    in csrc/, and each touches vegas_reduce.cu, vplus_sample.cu or
    vegas_sample.cu."""
    name, edits = _VARIANTS[k]
    csrc = Path(_build.CSRC)
    assert edits, name
    for f, old, new in edits:
        assert f in (_MODULE.REDUCE, _MODULE.SAMPLE, _MODULE.VSAMPLE), (name, f)
        assert (csrc / f).read_text().count(old) == 1, (name, f, old)
        assert new != old, (name, old)


def test_kernel_names_in_the_sass():
    """The SASS's mangled names map to the kernels' short names, with their
    template arguments."""
    kn = _MODULE.kernel_name
    assert kn("_ZN12_GLOBAL__N_119vplus_sample_kernelILi3EEEvPKjiiiiiijjiPKiS3_PKfPiS6_") \
        == "vplus_sample_kernel<3>"
    assert kn("_ZN12_GLOBAL__N_119vegas_reduce_kernelILb1EEEvPKfS2_") == \
        "vegas_reduce_kernel<1>"
    assert kn("_ZN12_GLOBAL__N_119vplus_sample_kernelEPKjiiiiiiPKiS2_PKfPiS5_") == \
        "vplus_sample_kernel"
    assert kn("_ZN12_GLOBAL__N_119vegas_sample_kernelILb1EEEvPKjijjiijijiPKiPKfS6_S4_PfS7_Pi") \
        == "vegas_sample_kernel<1>"
    assert kn("_ZN12_GLOBAL__N_117vegas_relw_kernelEPKfS1_") is None
