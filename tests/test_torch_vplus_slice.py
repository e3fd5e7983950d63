"""PyTorch port: the :vegasplus slice end to end on the CPU.

``integrate(..., solver="vegasplus", device="cpu")`` runs the plain versions
of ``vplus_sample`` and ``vplus_reduce``.  Every case of
``tests/test_vegasplus.py`` that the slice serves is held against its exact
value at the reference's own 7 sigma (``tests/conftest.py:check``) and
against the JAX package's result on the same problem and budget within 6
combined sigma (the random streams differ).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mcintegration_tpu as mj
import mcintegration_tpu_torch as mt
from mcintegration_tpu_torch.ops import vplus_kernels as vp
from mcintegration_tpu_torch.ops.rng import block_keys
from mcintegration_tpu_torch.solvers.engine import Spec
from mcintegration_tpu_torch.solvers.vegasplus import VegasPlusIteration
from conftest import check

torch.set_num_threads(1)


def _np(pkg):
    return jnp if pkg is mj else torch


def _f32(pkg, d):
    return d.astype(jnp.float32) if pkg is mj else d.to(torch.float32)


def _pi(pkg):
    return lambda x, c: _np(pkg).where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0)


def _sing3(pkg):
    p = _np(pkg)

    def f(x, c):
        ca, cb = p.cos(x[0]), p.cos(x[1])
        s2a = 2 * p.sin(x[0] / 2) ** 2
        s2b = 2 * p.sin(x[1] / 2) ** 2
        s2c = 2 * p.sin(x[2] / 2) ** 2
        return 1.0 / (s2a + ca * s2b + ca * cb * s2c) / np.pi ** 3
    return f


def _multi(pkg):
    return lambda x, c: (x[0] ** 2 + x[1] ** 2, x[0] * x[1])


def _pad(pkg):
    return lambda x, c: (x[0], _np(pkg).where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0))


def _passenger(pkg):
    def f(x, c):
        t, d = x
        return t[0] * t[1] * _f32(pkg, d[0])
    return f


def _passenger_pad(pkg):
    def f(x, c):
        t, d = x
        return t[0], t[0] * t[1] * _f32(pkg, d[0])
    return f


def _logsing(pkg):
    return lambda x, c: _np(pkg).log(x[0]) / _np(pkg).sqrt(x[0])


def _cont(upper=1.0):
    return lambda pkg: pkg.Continuous(0.0, upper)


def _cont_disc(pkg):
    return (pkg.Continuous(0.0, 1.0), pkg.Discrete(1, 4))


# the cases and budgets of tests/test_vegasplus.py
CASES = {
    "pi": (_pi, _cont(), [[2]], dict(neval=1e5, niter=10, seed=8), [np.pi / 4]),
    "singular_3d": (_sing3, _cont(np.pi), [[3]], dict(neval=2e5, niter=10, seed=9),
                    [1.3932039]),
    "multi_integrand": (_multi, _cont(), [[2], [2]], dict(neval=5e4, niter=8, seed=10),
                        [2.0 / 3.0, 0.25]),
    "padding": (_pad, _cont(), [[1], [2]], dict(neval=1e5, niter=8, seed=4),
                [0.5, np.pi / 4]),
    "passenger": (_passenger, _cont_disc, [[2, 1]], dict(neval=2e5, niter=8, seed=6), [2.5]),
    "passenger_padding": (_passenger_pad, _cont_disc, [[1, 0], [2, 1]],
                          dict(neval=2e5, niter=8, seed=7), [0.5, 2.5]),
    "log_singular": (_logsing, _cont(), [[1]], dict(neval=1e5, niter=6, seed=22), [-4.0]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_vegasplus_against_exact_and_jax(case):
    f, var, dof, kw, exact = CASES[case]
    solver = "vegas+" if case == "singular_3d" else "vegasplus"
    vp.reset_launch_counts()
    res = mt.integrate(f(mt), var=var(mt), dof=dof, solver=solver, verbose=-2, device="cpu", **kw)
    assert vp.launch_counts == {"vplus_sample": 0, "vplus_reduce": 0, "vplus_reduce_measure": 0,
                                "vplus_reduce_complex": 0, "vplus_relw": 0}
    assert res.backend == "torch" and res.backend_reason == ""
    check(res, exact)
    if case == "pi":   # hypercube stratification beats plain vegas by a lot here
        assert float(res.stdev[0]) < 5e-4
    ref = mj.integrate(f(mj), var=var(mj), dof=dof, solver=solver, verbose=-2, **kw)
    assert res.neval == ref.neval
    for i in range(len(exact)):
        m, s = float(res.mean[i]), float(res.stdev[i])
        mr, sr = float(np.asarray(ref.mean[i])), float(np.asarray(ref.stdev[i]))
        assert abs(m - mr) < 6 * np.hypot(s, sr), (i, m, s, mr, sr)
        assert 0.2 < s / sr < 5.0, (i, s, sr)      # the same law earns a like error bar


def _peak(x, c):
    return torch.exp(-50 * ((x[0] - 0.3) ** 2 + (x[1] - 0.7) ** 2))


def test_counts_adapt_and_keep_their_sum_and_floor():
    spec = Spec(mt.Configuration(var=mt.Continuous(0.0, 1.0), dof=[[2]], seed=2), "cpu")
    it = VegasPlusIteration(spec, _peak, block=8, nevalperblock=40000)
    c0 = it.counts.copy()
    st = it.run(spec.device_params(), block_keys(2, 0, 0, 8))
    it.reallocate(st["sig"])
    assert it.counts.sum() == c0.sum() == it.chunk
    assert not np.array_equal(it.counts, c0), "counts should adapt"
    assert it.counts.min() >= 2
    # the samples moved toward the peak: the centre of the reallocated ones
    extra = (it.counts - 2).reshape(it.nstrat, it.nstrat)        # [coord_1, coord_0]
    mid = (np.arange(it.nstrat) + 0.5) / it.nstrat
    centre = np.array([extra.sum(axis=0) @ mid, extra.sum(axis=1) @ mid]) / extra.sum()
    assert np.all(np.abs(centre - np.array([0.3, 0.7])) < 0.05), centre
    assert st["neval"] == 8 * it.nevalperblock and st["obs_blocks"].shape == (8, 1)
    assert np.array_equal(st["norm_blocks"], np.full(8, float(it.nevalperblock)))
    it.reset_state()
    assert np.array_equal(it.counts, c0)


def test_rejects_pure_discrete_and_fermik():
    with pytest.raises(NotImplementedError, match="stratifies over Continuous"):
        mt.integrate(lambda x, c: 1.0, var=mt.Discrete(1, 3), dof=[[1]], neval=1e4,
                     solver="vegasplus", verbose=-2, seed=3, device="cpu")
    with pytest.raises(NotImplementedError, match=":mcmc solver only"):
        mt.integrate(lambda x, c: 1.0, var=(mt.Continuous(0.0, 1.0), mt.FermiK(3, 1.0, 0.2, 10.0)),
                     dof=[[1, 1]], neval=1e4, solver="vegasplus", verbose=-2, device="cpu")
    with pytest.raises(ValueError, match="up to 10 stratified"):
        mt.integrate(lambda x, c: x[0], var=mt.Continuous(0.0, 1.0), dof=[[11]], neval=1e4,
                     solver="vegasplus", verbose=-2, device="cpu")


def test_same_seed_gives_the_same_bits():
    f, var, dof, kw, _ = CASES["passenger_padding"]
    kw = dict(kw, neval=2e4, niter=4)
    a = mt.integrate(f(mt), var=var(mt), dof=dof, solver="vegasplus", verbose=-2, device="cpu", **kw)
    b = mt.integrate(f(mt), var=var(mt), dof=dof, solver=":vegasplus", verbose=-2, device="cpu", **kw)
    assert a.mean == b.mean and a.stdev == b.stdev
    for (_, la), (_, lb) in zip(a.config.var_leaves(), b.config.var_leaves()):
        assert np.array_equal(la.histogram, lb.histogram)
    c = mt.integrate(f(mt), var=var(mt), dof=dof, solver="vegasplus", verbose=-2, device="cpu",
                     **dict(kw, seed=kw["seed"] + 1))
    assert c.mean != a.mean


def test_vmap_fallback_sets_backend_reason():
    """An integrand that is not elementwise over the samples runs per sample
    under torch.func.vmap, between the same two wrappers."""
    def coupled(x, c):          # mean over ALL values when called batched
        return x[0] * torch.mean(x)

    res = mt.integrate(coupled, var=mt.Continuous(0.0, 1.0), dof=[[2]], neval=2e4, niter=4,
                       solver="vegasplus", verbose=-2, seed=1, device="cpu")
    assert res.backend == "torch" and "torch.func.vmap" in res.backend_reason
    check(res, (1 / 3 + 1 / 4) / 2)   # per sample: x0 * (x0 + x1) / 2


def test_inplace_and_trained_maps():
    """``inplace=True`` integrands, and the maps train (Continuous and the
    Discrete passenger) while a non-adaptive pool keeps its grid."""
    def f(x, w, c):
        t, d, e = x
        w[0] = t[0] * _f32(mt, d[0]) * (1.0 + e[0])

    var = (mt.Continuous(0.0, 1.0, ninc=64), mt.Discrete(1, 4),
           mt.Continuous(0.0, 1.0, ninc=16, adapt=False))
    res = mt.integrate(f, var=var, dof=[[1, 1, 1]], neval=4e4, niter=5, solver="vegasplus",
                       inplace=True, verbose=-2, seed=3, device="cpu")
    check(res, 0.5 * 10.0 * 1.5)
    t, d, e = [leaf for _, leaf in res.config.var_leaves()]
    assert not np.allclose(t.grid, np.linspace(0.0, 1.0, 65))
    assert d.distribution[3] > d.distribution[0]
    assert np.array_equal(e.grid, np.linspace(0.0, 1.0, 17))
