"""PyTorch port: what ``vplus_sample`` and ``vegas_reduce`` take from the host.

``vplus_sample`` forms a sample's stratified coordinates by successive
divisions of its cube index by ``nstrat``, each a multiply and a shift by
``(mul, shift)``, which the launch computes on the host
(``csrc/vplus_sample.cu:divisor``).  ``divisor`` below is its model: the
tests hold it, and the coordinates it gives, against floor division and
``%``.  The kernel takes the d-th stratified slot's coordinate from the
d-th division, which needs the layout to give the stratified slots the
strides ``nstrat^d`` in slot order.
``tools/sample_reduce_variants.py`` times variants of both kernels built
from edited copies of their sources; each edit must still find its line.
The kernels themselves are held to their plain versions on the card
(``tests/test_torch_cuda.py``).
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
    """``(mul, shift)`` of ``csrc/vplus_sample.cu:divisor``."""
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
    in csrc/, and each touches vegas_reduce.cu or vplus_sample.cu."""
    name, edits = _VARIANTS[k]
    csrc = Path(_build.CSRC)
    assert edits, name
    for f, old, new in edits:
        assert f in (_MODULE.REDUCE, _MODULE.SAMPLE), (name, f)
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
    assert kn("_ZN12_GLOBAL__N_117vegas_relw_kernelEPKfS1_") is None
