"""PyTorch port: the :vegasmc slice through ``integrate`` on the CPU.

Mirrors the ``vegasmc`` cases of ``tests/test_montecarlo.py`` with torch
integrands (the plain versions of the chain kernels run on the CPU), each
held to its exact value within 7 sigma, and the error-bar honesty gate of
``tests/test_honesty.py`` on the port's chain.  The battery keeps the JAX
tests' evaluation counts and chain lengths but runs 5 iterations where they
run 10 (``singular1`` keeps 10, for its stderr bound): on the CPU the plain
chain is bound by per-op overhead.
"""

import numpy as np
import pytest
import torch

import mcintegration_tpu_torch as mt
from mcintegration_tpu_torch.models.variable import FermiK
from mcintegration_tpu_torch.solvers.engine import Spec
from mcintegration_tpu_torch.solvers.vegasmc import VegasMCIteration

torch.set_num_threads(1)

PI4 = np.pi / 4.0
SPHERE3 = 4.0 * np.pi / 3.0 / 8.0
NEVAL = 100_000
NITER = 5


def _check(res, expect, ratio=7.0):
    for i, e in enumerate(expect):
        m, s = float(res.mean[i]), float(res.stdev[i])
        assert abs(m - e) < ratio * max(s, 1e-12), (i, m, s, e)


def _ind(c):
    return torch.where(c, 1.0, 0.0)


def _run(*args, niter=NITER, **kwargs):
    """integrate() on the CPU, quiet, with the default solver."""
    return mt.integrate(*args, niter=niter, device="cpu", verbose=-2, **kwargs)


def sphere1():
    return _run(lambda x, c: _ind(x[0] ** 2 + x[1] ** 2 < 1.0),
                var=mt.Continuous(0.0, 1.0), dof=[[2]], neval=NEVAL, seed=17), [PI4]


def sphere2(offset=0):
    def f(x, c):
        r2 = x[0 + offset] ** 2 + x[1 + offset] ** 2
        return _ind(r2 < 1.0), _ind(r2 + x[2 + offset] ** 2 < 1.0)

    t = mt.Continuous(0.0, 1.0, 2 + offset, offset=offset)
    cfg = mt.Configuration(var=(t,), dof=[[2], [3]], neighbor=[(0, 2), (0, 1)])
    return _run(f, config=cfg, neval=2 * NEVAL, seed=23), [PI4, SPHERE3]


def discrete():
    cfg = mt.Configuration(var=(mt.Discrete(1, 3),), dof=[[1]])
    return _run(lambda x, c: x[0].to(torch.float32), config=cfg, neval=NEVAL,
                seed=31), [6.0]


def discrete2():
    cfg = mt.Configuration(var=(mt.Discrete([(1, 3), (1, 4)]),), dof=[[1]])
    return _run(lambda x, c: 1.0, config=cfg, neval=NEVAL, seed=37), [12.0]


def singular1():
    res = _run(lambda x, c: torch.log(x[0]) / torch.sqrt(x[0]),
               var=mt.Continuous(0.0, 1.0), dof=[[1]], neval=NEVAL, seed=41, niter=10)
    # stderr regression bound (reference test/montecarlo.jl:364)
    assert float(res.stdev[0]) < 0.0007
    return res, [-4.0]


def singular2_composite():
    def f(cv, c):
        x, y, z = cv
        return 1.0 / (1.0 - torch.cos(x[0]) * torch.cos(y[0]) * torch.cos(z[0])) / np.pi ** 3

    cvar = mt.CompositeVar(mt.Continuous(0.0, np.pi), mt.Continuous(0.0, np.pi),
                           mt.Continuous(0.0, np.pi))
    return _run(f, var=cvar, dof=1, neval=NEVAL, seed=47), [1.3932]


def hypersphere_inplace_vector(nmax=3):
    def vol_inv(d):
        return (d / (2 * np.pi * np.e)) ** (d / 2) * np.sqrt(d) * np.sqrt(np.pi)

    def f(x, w, c):
        acc = x[0] ** 2
        for i in range(c.userdata):
            acc = acc + x[i + 1] ** 2
            w[i] = torch.where(acc < 1.0, vol_inv(i + 2), 0.0)

    res = _run(f, var=mt.Continuous(-1.0, 1.0), dof=[[i + 2] for i in range(nmax)],
               userdata=nmax, neval=2 * NEVAL, seed=71, inplace=True)
    return res, [0.9230, 0.94724, 0.96118]


CASES = {"sphere1": sphere1, "sphere2": sphere2, "sphere2_offset": lambda: sphere2(offset=2),
         "discrete": discrete, "discrete2": discrete2, "singular1": singular1,
         "singular2_composite": singular2_composite,
         "hypersphere_inplace_vector": hypersphere_inplace_vector}


@pytest.mark.parametrize("name", list(CASES))
def test_montecarlo_battery(name):
    res, exact = CASES[name]()
    assert res.backend == "torch"
    _check(res, exact)


def test_same_seed_reproduces_and_measurefreq():
    kw = dict(dof=[[2]], neval=2 ** 14, niter=4, solver="vegasmc", seed=4)
    f = lambda x, c: _ind(x[0] ** 2 + x[1] ** 2 < 1.0)
    a = _run(f, var=mt.Continuous(0.0, 1.0), **kw)
    b = _run(f, var=mt.Continuous(0.0, 1.0), **kw)
    assert a.mean == b.mean and a.stdev == b.stdev
    assert np.array_equal(a.config.var[0].grid, b.config.var[0].grid)
    assert np.array_equal(a.config.reweight, b.config.reweight)
    c = _run(f, var=mt.Continuous(0.0, 1.0), measurefreq=2, **kw)
    assert c.mean != a.mean
    _check(c, [PI4])
    assert c.neval == a.neval
    # the tallies and visited counts reached the configuration
    assert a.config.propose[1, 0, 0] > 2 ** 14 and a.config.visited.sum() > 1


@pytest.mark.parametrize("kwargs,item", [
    ({"measure": lambda v, relw, c: relw}, "item 14"),
    ({"type": complex}, "item 14"),
], ids=["measure", "complex"])
def test_unported_vegasmc_options_raise(kwargs, item):
    with pytest.raises(NotImplementedError, match=item):
        mt.integrate(lambda x, c: x[0], var=mt.Continuous(0.0, 1.0), dof=[[1]],
                     neval=2 ** 12, solver="vegasmc", device="cpu", verbose=-2, **kwargs)
    with pytest.raises(NotImplementedError, match=":mcmc solver only"):
        mt.integrate(lambda x, c: 1.0, var=FermiK(3, 1.0, 0.5, 2.0), dof=[[1]],
                     neval=2 ** 12, solver="vegasmc", device="cpu", verbose=-2)


def _estimate(it, seed):
    """(mean, stderr) the way Result computes them: block-ratio spread."""
    kd = np.random.default_rng(seed).integers(0, 2 ** 32, (it.block, 2), dtype=np.uint32)
    st = it.run(it.spec.device_params(), kd)
    m = st["obs_blocks"][:, 0] / st["norm_blocks"]
    return float(m.mean()), float(m.std(ddof=1) / np.sqrt(len(m)))


@pytest.mark.slow
def test_chain_error_bar_honesty():
    """Empirical seed-to-seed spread ~ mean reported stderr (the gate of
    tests/test_honesty.py:48-80 on the port's chain, plain versions, at its
    sizes: about 20 s on one CPU thread, hence ``slow``)."""
    spec = Spec(mt.Configuration(var=mt.Continuous(0.0, 1.0), dof=[[2]], seed=1), "cpu")
    it = VegasMCIteration(spec, lambda x, c: _ind(x[0] ** 2 + x[1] ** 2 < 1.0), block=4,
                          nevalperblock=2 ** 19, nwalkers=4096)
    assert (it.nwalkers, it.nsteps) == (4096, 512)
    means, errs = np.asarray([_estimate(it, 100 + s) for s in range(16)]).T
    z = (means - PI4) / errs
    assert np.all(np.abs(z) < 6.0), z
    r = np.sqrt(means.var(ddof=1) / np.mean(errs ** 2))
    assert 0.75 < r < 1.6, (
        f"reported error bars dishonest: spread/reported = {r:.2f} "
        f"(spread {means.std(ddof=1):.2e}, reported {np.mean(errs):.2e})")
