"""PyTorch port: ``integrate(debug=True)`` (``mcintegration_tpu_torch/debug.py``)
against the JAX package's ``mcintegration_tpu/debug.py``.

The same bad integrands and measures go through both probes: the same
exception class and message (or its prefix, where the inner error is each
package's own), or the same warning.  Two checks of the JAX package's probe
never fire, because it looks at the weights after its non-finite guard and
its float32 cast: complex weights without ``type=complex`` and non-finite
weights.  The port looks at the values the integrand returned and gives
the JAX package's own message for each; the tests hold both behaviours.
``check_iteration_stats`` gives the same return value and stderr text on the
same statistics, and ``debug=True`` leaves every solver's result as it is,
bit for bit.
"""

import inspect
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcintegration_tpu as mj
import mcintegration_tpu.debug as jdebug
import mcintegration_tpu_torch as mt
import mcintegration_tpu_torch.debug as tdebug
from mcintegration_tpu.solvers.engine import Spec as JSpec
from mcintegration_tpu_torch.solvers.engine import Spec

torch.set_num_threads(1)


def _boom(*args):
    raise RuntimeError("boom")


def _mcmc_second_fails(i, x, c):
    if i == 1:
        raise RuntimeError("boom")
    return x[0] * x[1]


# name: (integrand, solver, N, measure, obs, complex)
CASES = {
    "raises": (lambda x, c: _boom(), "vegas", 1, None, None, False),
    "wrong-count": (lambda x, c: (x[0], x[1]), "vegas", 1, None, None, False),
    "wrong-count-2": (lambda x, c: (x[0], x[1], x[0]), "vegasmc", 2, None, None, False),
    "measure-fails": (lambda x, c: x[0], "vegas", 1, lambda x, relw, c: _boom(),
                      [np.zeros(1)], False),
    "mcmc-index-fails": (_mcmc_second_fails, "mcmc", 2, None, None, False),
    "complex-no-type": (lambda x, c: x[0] * 1j, "vegas", 1, None, None, False),
    "non-finite": (lambda x, c: x[0] / 0.0, "vegas", 1, None, None, False),
    "good-complex": (lambda x, c: x[0] * 1j, "vegas", 1, None, None, True),
    "good-measure": (lambda x, c: x[0], "vegasmc", 1, lambda x, relw, c: [relw[0]],
                     [np.zeros(1)], False),
}


def _probe(pkg, case):
    f, solver, n, measure, obs, cplx = CASES[case]
    typ = complex if cplx else float
    var = pkg.Continuous(0.0, 1.0)
    cfg = pkg.Configuration(var=var, dof=[[2]] * n, obs=obs, type=typ)
    with warnings.catch_warnings(record=True) as ws:
        warnings.simplefilter("always")
        try:
            if pkg is mj:
                wd = jnp.complex64 if cplx else jnp.float32
                jdebug.probe_integrand(JSpec(cfg), f, measure, False, solver, wd)
            else:
                tdebug.probe_integrand(Spec(cfg, "cpu"), f, measure, False, solver, obs)
            err = None
        except Exception as e:
            err = e
    return err, [str(w.message) for w in ws]


def _prefix(e):
    """The message without the inner error's text."""
    msg, inner = str(e), str(e.__cause__ or "")
    return msg[: len(msg) - len(inner)] if inner and msg.endswith(inner) else msg


@pytest.mark.parametrize("case", ["raises", "measure-fails", "mcmc-index-fails"])
def test_same_error_as_jax(case):
    (je, jw), (te, tw) = _probe(mj, case), _probe(mt, case)
    assert type(je) is type(te) is TypeError
    assert str(te) == str(je)


@pytest.mark.parametrize("case", ["wrong-count", "wrong-count-2"])
def test_same_error_prefix_as_jax(case):
    (je, _), (te, _) = _probe(mj, case), _probe(mt, case)
    assert type(je) is type(te) is TypeError
    assert _prefix(te) == _prefix(je)
    assert "wrong number of weights (expected" in _prefix(te)


@pytest.mark.parametrize("case", ["good-complex", "good-measure"])
def test_good_integrands_pass_both(case):
    (je, jw), (te, tw) = _probe(mj, case), _probe(mt, case)
    assert je is None and te is None and tw == []


def test_complex_weights_without_type_complex():
    """The JAX probe casts to float32 first (a ComplexWarning, no error);
    the port raises the TypeError the JAX probe's code words."""
    (je, jw), (te, tw) = _probe(mj, "complex-no-type"), _probe(mt, "complex-no-type")
    assert je is None and any("imaginary part" in w for w in jw)
    assert type(te) is TypeError
    assert str(te) in inspect.getsource(jdebug.probe_integrand).replace('"\n' + " " * 16 + '"',
                                                                         "")


def test_non_finite_weights_warn():
    """The JAX probe looks after its non-finite guard (no warning); the port
    warns with the JAX probe's message."""
    (je, jw), (te, tw) = _probe(mj, "non-finite"), _probe(mt, "non-finite")
    assert je is None and jw == []
    assert te is None and len(tw) == 1
    src = inspect.getsource(jdebug.probe_integrand).replace('"\n' + " " * 16 + '"', "")
    assert tw[0] in src


STATS = {
    "finite": {"obs_blocks": np.ones((4, 2)), "norm_blocks": np.ones(4),
               "hists": [np.ones(3), np.ones(5)]},
    "obs-pytree": {"obs_blocks": [np.ones((4, 3)), np.array([[1.0], [np.nan], [1], [1]])],
                   "norm_blocks": np.ones(4), "hists": [np.ones(3)]},
    "all-bad": {"obs_blocks": np.array([[np.inf]]), "norm_blocks": np.array([np.nan]),
                "hists": [np.ones(2), np.array([np.inf])]},
    "norm-only": {"obs_blocks": np.ones((2, 1)), "norm_blocks": np.array([1.0, -np.inf]),
                  "hists": [np.ones(2)]},
}


@pytest.mark.parametrize("case", list(STATS))
def test_check_iteration_stats_matches_jax(case, capsys):
    ok_j = jdebug.check_iteration_stats(STATS[case], 3)
    err_j = capsys.readouterr().err
    ok_t = tdebug.check_iteration_stats(STATS[case], 3)
    err_t = capsys.readouterr().err
    assert ok_t == ok_j == (case == "finite")
    assert err_t == err_j


def _pi(x, c):
    return torch.where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0) * torch.exp(x[1])


@pytest.mark.parametrize("solver", ["vegas", "vegasmc", "mcmc", "vegasplus"])
def test_debug_leaves_result_bits(solver, capsys):
    f = (lambda i, x, c: _pi(x, c)) if solver == "mcmc" else _pi

    def run(debug):
        return mt.integrate(f, var=mt.Continuous(0.0, 1.0), dof=[[2]], neval=2 ** 12,
                            niter=2, solver=solver, device="cpu", verbose=-2, seed=4,
                            debug=debug, cache=False, min_steps_per_walker=32)

    a, b = run(False), run(True)
    assert np.array_equal(a.mean, b.mean) and np.array_equal(a.stdev, b.stdev)
    for (ma, sa, ca), (mb, sb, cb) in zip(a.iterations, b.iterations):
        assert np.array_equal(ma, mb) and np.array_equal(sa, sb)
        assert np.array_equal(ca.reweight, cb.reweight)
    assert capsys.readouterr().err == ""


def _probe64(pkg, case):
    """``_probe`` at float64: the JAX probe under jax.enable_x64 with
    float64 weights, the port's probe on a float64 Spec."""
    f, solver, n, measure, obs, cplx = CASES[case]
    cfg = pkg.Configuration(var=pkg.Continuous(0.0, 1.0), dof=[[2]] * n, obs=obs,
                            type=complex if cplx else float)
    with warnings.catch_warnings(record=True) as ws:
        warnings.simplefilter("always")
        try:
            if pkg is mj:
                import jax
                with jax.enable_x64(True):
                    wd = jnp.complex64 if cplx else jnp.float64
                    jdebug.probe_integrand(JSpec(cfg, dtype=jnp.float64), f, measure, False,
                                           solver, wd)
            else:
                tdebug.probe_integrand(Spec(cfg, "cpu", torch.float64), f, measure, False,
                                       solver, obs)
            err = None
        except Exception as e:
            err = e
    return err, [str(w.message) for w in ws]


@pytest.mark.parametrize("case", ["raises", "measure-fails", "wrong-count", "good-measure",
                                  "non-finite", "complex-no-type"])
def test_float64_probe(case):
    """At float64 the probe gives the JAX package's message (or its prefix)
    for a call that fails, the wrong count and a failing measure, passes a
    good measure, warns on non-finite weights, and raises the complex-weights
    TypeError, which the JAX probe, comparing its weights' dtype with
    float32, skips at float64."""
    te, tw = _probe64(mt, case)
    if case in ("good-measure", "non-finite"):
        assert te is None and len(tw) == (case == "non-finite")
        return
    assert type(te) is TypeError
    if case == "complex-no-type":
        je, _ = _probe64(mj, case)
        assert je is None and "type=complex" in str(te)
        return
    je, _ = _probe64(mj, case)
    assert type(je) is TypeError and _prefix(te) == _prefix(je)


def test_debug_leaves_a_float64_run_bits():
    def f(x, c):
        return torch.exp(30.0 * x[0]) * x[1]

    def run(debug, solver):
        return mt.integrate(f, var=mt.Continuous(0.0, 1.0), dof=[[2]], neval=2 ** 12, niter=2,
                            solver=solver, device="cpu", verbose=-2, seed=4, debug=debug,
                            cache=False, dtype=torch.float64)

    for solver in ("vegas", "vegasplus"):
        a, b = run(False, solver), run(True, solver)
        assert np.array_equal(a.mean, b.mean) and np.array_equal(a.stdev, b.stdev)


def test_non_finite_measure_writes_the_line(capsys):
    """The integrand's non-finite values are zeroed before any sum (both
    packages' guard), so a measure with inf at known samples is what makes an
    iteration's statistics non-finite; debug=True names them on stderr."""
    def measure(x, relw, c):
        return [torch.where(x[0] > 0.5, torch.inf, 1.0) * relw[0]]

    res = mt.integrate(lambda x, c: x[0], var=mt.Continuous(0.0, 1.0), dof=[[1]],
                       obs=[0.0], measure=measure, neval=2 ** 12, niter=2, solver="vegas",
                       device="cpu", verbose=-2, debug=True, cache=False)
    err = capsys.readouterr().err
    assert "iteration 0: non-finite observable statistics" in err
    assert "iteration 1: non-finite observable statistics" in err
    assert not np.isfinite(res.mean[0])
