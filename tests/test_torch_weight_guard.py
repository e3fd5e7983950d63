"""PyTorch port: the weights' non-finite guard, on the CPU.

The evaluation hands the integrand's values to the solvers as they come;
the :vegas and :vegasplus kernels read each weight through the guard (a
value that is not finite, or a complex one with a part that is not, counts
as 0), and so do their plain versions, which these runs take; the Markov
solvers guard the integrand's output in torch.

- integrands that return ``inf``, ``-inf`` and ``NaN`` on known regions give
  the ``Result``, bit for bit, of the same integrand guarded by the user
  (``torch.where(torch.isfinite(w), w, 0)``) at the same seed: :vegas on the
  uniform and the mixed route and :vegasplus, each with the default and a
  custom measure, real and complex weights, float32 and float64; :vegasmc
  and :mcmc as well;
- a non-finite value at a probe point keeps the batched evaluation;
- with one integrand the batched evaluation is a view of its output, the
  non-finite values left in it.
"""

import math

import numpy as np
import pytest
import torch

import mcintegration_tpu_torch as mt
from mcintegration_tpu_torch.solvers.engine import Spec

torch.set_num_threads(1)

INF, NAN = math.inf, math.nan


def _weight(a, b, cplx):
    """``1 + a b`` (complex: ``+ i a``), ``inf`` for a < 0.1, ``-inf`` for
    0.1 <= a < 0.2 and ``NaN`` for b > 0.9; a complex weight's imaginary
    part alone is ``NaN`` for b < 0.1 and ``inf`` for 0.3 <= a < 0.35."""
    re = 1.0 + a * b
    re = torch.where(a < 0.1, INF, torch.where(a < 0.2, -INF, re))
    re = torch.where(b > 0.9, NAN, re)
    if not cplx:
        return re
    im = torch.where(b < 0.1, NAN, torch.where((a >= 0.3) & (a < 0.35), INF, a))
    return torch.complex(re, im)


def _guarded(f):
    """``f`` with the user's own guard on its output."""
    def g(*args):
        w = f(*args)
        return torch.where(torch.isfinite(w), w, 0)
    return g


# each route: its pools, dof, how to read the two coordinates (a, b) off the
# integrand's view, and the solver's keywords
ROUTES = {
    "vegas": dict(solver="vegas", var=lambda: mt.Continuous(0.0, 1.0, ninc=64),
                  dof=[[2]], ab=lambda x: (x[0], x[1])),
    "vegas-mixed": dict(solver="vegas",
                        var=lambda: (mt.Continuous(0.0, 1.0, ninc=64), mt.Discrete(1, 4)),
                        dof=[[1, 1]], ab=lambda x: (x[0][0], x[1][0].to(x[0].dtype) / 4.5)),
    "vegasplus": dict(solver="vegasplus", var=lambda: mt.Continuous(0.0, 1.0, ninc=64),
                      dof=[[2]], ab=lambda x: (x[0], x[1])),
    "vegasmc": dict(solver="vegasmc", var=lambda: mt.Continuous(0.0, 1.0, ninc=64),
                    dof=[[2]], ab=lambda x: (x[0], x[1])),
}


def _integrand(route, cplx):
    ab = ROUTES[route]["ab"]
    return lambda x, c: _weight(*ab(x), cplx)


def _measure(route):
    """Two observables: relw, and relw where a < 0.5."""
    ab = ROUTES[route]["ab"]

    def m(x, relw, c):
        a, _ = ab(x)
        return [torch.stack([relw[0], relw[0] * (a < 0.5)])]
    return m


def _run(route, f, cplx=False, dtype=torch.float32, measure=None, seed=11, **kw):
    opts = ROUTES[route]
    if measure is not None:
        kw.update(measure=measure, obs=[np.zeros(2, np.complex128 if cplx else np.float64)])
    return mt.integrate(f, var=opts["var"](), dof=opts["dof"], solver=opts["solver"],
                        neval=2 ** 13, niter=3, block=4, seed=seed, verbose=-2,
                        device="cpu", cache=False, type=complex if cplx else float,
                        dtype=dtype, **kw)


def _same(a, b) -> bool:
    flat = lambda r: [np.asarray(r.mean), np.asarray(r.stdev), np.asarray(r.chi2),
                      *[np.asarray(v) for it in r.iterations for v in it[:2]]]
    maps = lambda r: [np.asarray(getattr(leaf, "grid", leaf.histogram))
                      for _, leaf in r.config.var_leaves()]
    return all(np.array_equal(u, v) for u, v in zip(flat(a) + maps(a), flat(b) + maps(b)))


def _finite(r) -> bool:
    return bool(np.all(np.isfinite(np.asarray(r.mean))) and
                np.all(np.isfinite(np.asarray(r.stdev))))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("custom", [False, True], ids=["default", "measure"])
@pytest.mark.parametrize("route", ["vegas", "vegas-mixed", "vegasplus"])
def test_guard_gives_the_users_guarded_bits(route, custom, cplx, dtype):
    f = _integrand(route, cplx)
    m = _measure(route) if custom else None
    got = _run(route, f, cplx, dtype, m)
    want = _run(route, _guarded(f), cplx, dtype, m)
    assert got.backend_reason == "" and want.backend_reason == ""
    assert _finite(got)
    assert _same(got, want)


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_vegasmc_guards_in_torch(cplx):
    f = _integrand("vegasmc", cplx)
    got = _run("vegasmc", f, cplx, min_steps_per_walker=16)
    want = _run("vegasmc", _guarded(f), cplx, min_steps_per_walker=16)
    assert _finite(got)
    assert _same(got, want)


def test_mcmc_guards_in_torch():
    f = _integrand("vegas", False)
    kw = dict(var=mt.Continuous(0.0, 1.0, ninc=64), dof=[[2]], solver="mcmc", neval=2 ** 13,
              niter=3, block=4, seed=11, verbose=-2, device="cpu", cache=False,
              min_steps_per_walker=16)
    got = mt.integrate(lambda i, x, c: f(x, c), **kw)
    kw["var"] = mt.Continuous(0.0, 1.0, ninc=64)
    want = mt.integrate(lambda i, x, c: _guarded(f)(x, c), **kw)
    assert _finite(got)
    assert _same(got, want)


@pytest.mark.parametrize("route", ROUTES)
def test_nan_at_a_probe_point_keeps_the_batched_route(route):
    """NaN wherever a < 0.5, which the probe's points reach: the batched
    call and the per-sample one agree once guarded, so the integrand runs
    batched."""
    ab = ROUTES[route]["ab"]
    f = lambda x, c: torch.where(ab(x)[0] < 0.5, NAN, 1.0 + ab(x)[1])
    spec = Spec(mt.Configuration(var=ROUTES[route]["var"](), dof=ROUTES[route]["dof"], seed=3),
                "cpu")
    leaf_vals = spec.probe_leaf_values(np.random.default_rng(12345))
    assert torch.isnan(spec.make_eval_batched(f, False)(leaf_vals)).any()
    evaluate, why = spec.pick_eval(f, False)
    assert why == ""
    res = _run(route, f, min_steps_per_walker=16)
    assert res.backend_reason == "" and _finite(res)


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_one_integrand_is_a_view_of_its_output(cplx):
    """No stack and no guard pass: the batched evaluation of one integrand
    shares the integrand's storage and keeps its non-finite values."""
    seen = []

    def f(x, c):
        seen.append(_weight(x[0], x[1], cplx))
        return seen[-1]

    spec = Spec(mt.Configuration(var=mt.Continuous(0.0, 1.0), dof=[[2]],
                                 type=complex if cplx else float), "cpu")
    leaf_vals = [torch.rand((2, 5, 7), generator=torch.Generator().manual_seed(1))]
    leaf_vals[0][0, 0, 0] = 0.05                       # inf
    w = spec.make_eval_batched(f, False)(leaf_vals)
    assert w.shape == (1, 5, 7) and w.data_ptr() == seen[-1].data_ptr()
    assert torch.isinf(w[0, 0, 0].real if cplx else w[0, 0, 0])
