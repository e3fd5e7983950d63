"""PyTorch port: the whole :vegas slice through ``integrate`` on the CPU.

The port and the JAX package draw from different random streams here
(per-block seeds from numpy vs JAX's threefry split), so a run agrees with
the exact value and with the JAX ``integrate`` only statistically: within
7 sigma of the exact value, and within 7 combined sigma of each other.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mcintegration_tpu as mj
import mcintegration_tpu_torch as mt

torch.set_num_threads(1)

SINGULAR = (lambda x, c: -torch.log(x[0]) / torch.sqrt(x[0]) / 4.0,
            lambda x, c: -jnp.log(x[0]) / jnp.sqrt(x[0]) / 4.0)
PI = (lambda x, c: torch.where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0),
      lambda x, c: jnp.where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0))


def _within(res, exact, k=7.0):
    for i, e in enumerate(exact):
        m, s = float(res.mean[i]), float(res.stdev[i])
        assert abs(m - e) < k * max(s, 1e-12), (i, m, s, e)


@pytest.mark.parametrize("name,dof,exact", [("pi", [[2]], [np.pi / 4]),
                                            ("singular", [[1]], [1.0])])
def test_integrate_against_exact_and_jax(name, dof, exact):
    ft, fj = {"pi": PI, "singular": SINGULAR}[name]
    kw = dict(var=None, dof=dof, neval=2 ** 16, niter=4, block=16, solver="vegas",
              seed=11, verbose=-2)
    rt = mt.integrate(ft, device="cpu", **{**kw, "var": mt.Continuous(0.0, 1.0)})
    rj = mj.integrate(fj, **{**kw, "var": mj.Continuous(0.0, 1.0)})
    assert rt.backend == "torch" and rt.backend_reason == ""
    assert rt.neval == rj.neval == 4 * 2 ** 16
    _within(rt, exact)
    _within(rj, exact)
    d = abs(float(rt.mean[0]) - float(rj.mean[0]))
    assert d < 7.0 * np.hypot(float(rt.stdev[0]), float(rj.stdev[0]))
    assert len(rt.iteration_times) == 4


def test_same_seed_reproduces_run():
    # a fresh pool per run: integrate() trains the pool it is given
    kw = dict(dof=[[2]], neval=2 ** 14, niter=3, solver="vegas", seed=4, verbose=-2,
              device="cpu")
    a = mt.integrate(PI[0], var=mt.Continuous(0.0, 1.0), **kw)
    b = mt.integrate(PI[0], var=mt.Continuous(0.0, 1.0), **kw)
    assert a.mean == b.mean and a.stdev == b.stdev
    assert np.array_equal(a.config.var[0].grid, b.config.var[0].grid)


def test_timers_do_not_change_the_numbers(capsys):
    """Timers and verbose > 0 are polled between iterations: the run is the
    one without them, bit for bit, and each timer is checked once per
    iteration."""
    kw = dict(dof=[[2]], neval=2 ** 14, niter=3, solver="vegas", seed=4, device="cpu")
    quiet = mt.integrate(PI[0], var=mt.Continuous(0.0, 1.0), verbose=-2, **kw)
    fired = []
    timer = type("T", (), {"check": lambda self, cfg: fired.append(cfg.neval)})()
    loud = mt.integrate(PI[0], var=mt.Continuous(0.0, 1.0), verbose=1, timer=[timer],
                        **kw)
    assert loud.mean == quiet.mean and loud.stdev == quiet.stdev
    assert np.array_equal(loud.config.var[0].grid, quiet.config.var[0].grid)
    assert fired == [2 ** 14, 2 ** 15, 3 * 2 ** 14]
    assert "Total time" in capsys.readouterr().out


def test_composite_offset_and_padding():
    """CompositeVar pools, a user-pinned offset slot and padding factors."""
    def f(x, c):
        a, b = x
        # slot 0 of each pool is pinned by offset=1; the MC owns slots 1..
        return (a[1] * b[1], torch.where(a[1] ** 2 + b[2] ** 2 < 1.0, 1.0, 0.0))

    var = mt.Continuous([(0.0, 1.0), (0.0, 2.0)], offset=1)
    res = mt.integrate(f, var=var, dof=[[1], [2]], neval=2 ** 16, niter=4,
                       solver="vegas", seed=3, verbose=-2, device="cpu")
    # integrand 0 over (a1, b1): int a*b = 1/2 * 2 = 1; integrand 1 over
    # (a1, a2, b1, b2): pi/4 from (a1, b2), times the volume 1 * 2 of (a2, b1)
    _within(res, [1.0, np.pi / 2])


def test_inplace_and_vmap_fallback():
    def inplace(x, w, c):
        w[0] = x[0] * x[1]

    res = mt.integrate(inplace, inplace=True, var=mt.Continuous(0.0, 1.0), dof=[[2]],
                       neval=2 ** 14, niter=3, solver="vegas", seed=2, verbose=-2,
                       device="cpu")
    assert res.backend_reason == ""
    _within(res, [0.25])

    def coupled(x, c):          # mean over ALL values when called batched
        return x[0] * torch.mean(x)

    res = mt.integrate(coupled, var=mt.Continuous(0.0, 1.0), dof=[[2]], neval=2 ** 14,
                       niter=3, solver="vegas", seed=2, verbose=-2, device="cpu")
    assert "torch.func.vmap" in res.backend_reason
    _within(res, [(1 / 3 + 1 / 4) / 2])   # per sample: x0 * (x0 + x1) / 2


def test_nonadaptive_pool_keeps_its_grid():
    var = mt.Continuous(0.0, 1.0, adapt=False)
    res = mt.integrate(PI[0], var=var, dof=[[2]], neval=2 ** 14, niter=2,
                       solver="vegas", seed=2, verbose=-2, device="cpu")
    assert np.array_equal(res.config.var[0].grid, np.linspace(0, 1, 1025))
    _within(res, [np.pi / 4])
