"""PyTorch port: the :mcmc slice through ``integrate`` on the CPU.

Mirrors ``tests/test_bubble_fermik.py`` (the Lindhard bubble with a FermiK
momentum pool and a custom measure of four ``q`` bins, held to the
analytic Lindhard function at 7 sigma) with torch integrand and measure, on
the kernels' plain versions.  The JAX test's size (400,000 evals per
iteration, 128 walkers x 4,062 steps, 10 iterations) takes about six
minutes on one CPU thread, so it is marked ``slow``; the unmarked case runs a tenth of
the evaluations for three iterations.  Beside it: a custom measure that is
not batchable runs under ``torch.func.vmap`` and says so, ``measurefreq``,
``thermal_ratio`` and reweighting over two integrands.
"""

import numpy as np
import pytest
import torch

import mcintegration_tpu_torch as mt
from mcintegration_tpu_torch.ops import mcmc_kernels as mk

torch.set_num_threads(1)

QSIZE = 4
RS, BETA, SPIN, DIM, ME = 1.0, 25.0, 2, 3, 0.5
KF = (9 * np.pi / (2 * SPIN)) ** (1 / 3) / RS
BETA_PHYS = BETA / (KF ** 2 / (2 * ME))
EXTQ = np.array([[q, 0.0, 0.0] for q in np.linspace(0.0, 1.5 * KF, QSIZE)])


def lindhard(q):
    density = ME * KF / (2 * np.pi ** 2)
    q = max(q, 1e-6)
    x = q / 2 / KF
    if abs(q - 2 * KF) > 1e-6:
        p = 1 + (1 - x ** 2) * np.log1p(4 * x / ((1 - x) ** 2)) / 4 / x
    else:
        p = 1.0
    return -p * density * SPIN / 2


def green(tau, omega, beta):
    pos = tau >= 0.0
    gp = torch.where(omega > 0.0, torch.exp(-omega * tau) / (1 + torch.exp(-omega * beta)),
                     torch.exp(omega * (beta - tau)) / (1 + torch.exp(omega * beta)))
    gn = torch.where(omega > 0.0, -torch.exp(-omega * (tau + beta)) / (1 + torch.exp(-omega * beta)),
                     -torch.exp(-omega * tau) / (1 + torch.exp(omega * beta)))
    return torch.where(pos, gp, gn)


def integrand(idx, vars, c):
    """Batched: ``k[0]`` is ``[3, *batch]``, ``ext[0]`` is ``[*batch]``."""
    t, k, ext = vars
    kvec = k[0]
    q = torch.as_tensor(EXTQ, dtype=torch.float32, device=kvec.device)[ext[0] - 1].movedim(-1, 0)
    kq = kvec + q
    w1 = ((kvec * kvec).sum(0) - KF ** 2) / (2 * ME)
    w2 = ((kq * kq).sum(0) - KF ** 2) / (2 * ME)
    return green(t[0], w1, BETA_PHYS) * green(-t[0], w2, BETA_PHYS) * SPIN / (2 * np.pi) ** 3


def measure(idx, vars, relw, c):
    return [mt.onehot(vars[-1][0], 1, QSIZE, relw.dtype, like=relw) * relw]


def _bubble(**kw):
    var = (mt.Continuous(0.0, BETA_PHYS, alpha=3.0), mt.FermiK(3, KF, 0.2 * KF, 10.0 * KF),
           mt.Discrete(1, QSIZE, adapt=False))
    return mt.integrate(integrand, measure=measure, var=var, dof=[[1, 1, 1]],
                        obs=[np.zeros(QSIZE)], solver="mcmc", verbose=-2, block=16, seed=211,
                        nwalkers=128, thermal_ratio=0.3, device="cpu", **kw)


def _check_lindhard(res):
    avg, std = np.asarray(res.mean[0]), np.asarray(res.stdev[0])
    assert avg.shape == std.shape == (QSIZE,)
    for i in range(QSIZE):
        exact = lindhard(EXTQ[i][0])
        assert abs(avg[i] - exact) < 7.0 * max(std[i], 1e-10), (
            f"q/kF={EXTQ[i][0] / KF:.3f}: {avg[i]:.6f} ± {std[i]:.6f} vs {exact:.6f}")


def test_bubble_fermik_mcmc(capsys):
    mk.reset_launch_counts()
    res = _bubble(neval=40_000, niter=3)
    assert res.backend == "torch" and res.backend_reason == ""
    assert sum(mk.launch_counts.values()) == 0           # plain versions on the CPU
    assert res.neval == 3 * 128 * (312 + 93)
    _check_lindhard(res)
    # the tallies reached the configuration: CV on all three variables, and
    # jumps between integrand 0 and the normalization sector both ways
    cfg = res.config
    assert np.all(cfg.propose[1, 0, :3] > 1000) and cfg.propose[0, 0, 1] > 100
    assert cfg.propose[0, 1, 0] > 100 and cfg.visited.sum() > res.neval / 2
    mt.report(res)
    assert "Integral 0" in capsys.readouterr().out


@pytest.mark.slow
def test_bubble_fermik_mcmc_at_jax_size():
    """``tests/test_bubble_fermik.py:81-97`` at its size (about six minutes)."""
    _check_lindhard(_bubble(neval=400_000))


def _td(i, x, c):
    t, d = x
    return t[0] * d[0].to(torch.float32)


def _bins_batched(i, x, relw, c):
    return [mt.onehot(x[1][0], 1, 4, relw.dtype, like=relw) * relw]


def _bins_per_sample(i, x, relw, c):
    """``arange == d`` is a one-hot for one sample only: not batchable."""
    return [(torch.arange(1, 5) == x[1][0]).to(relw.dtype) * relw]


def test_custom_measure_runs_under_vmap_when_not_batchable():
    kw = dict(var=(mt.Continuous(0.0, 1.0, ninc=64), mt.Discrete(1, 4)), dof=[[1, 1]],
              obs=[np.zeros(4)], solver="mcmc", neval=2 ** 15, niter=3, block=16, seed=13,
              verbose=-2, device="cpu")
    a = mt.integrate(_td, measure=_bins_batched, **kw)
    kw["var"] = (mt.Continuous(0.0, 1.0, ninc=64), mt.Discrete(1, 4))
    b = mt.integrate(_td, measure=_bins_per_sample, **kw)
    assert a.backend_reason == ""
    assert "measure" in b.backend_reason and "torch.func.vmap" in b.backend_reason
    np.testing.assert_allclose(np.asarray(b.mean[0]), np.asarray(a.mean[0]), rtol=1e-12)
    avg, std = np.asarray(a.mean[0]), np.asarray(a.stdev[0])
    exact = np.arange(1, 5) / 2.0                     # the integral of t*d over t, per d
    assert np.all(np.abs(avg - exact) < 7 * std), (avg, std)


def _pi(i, x, c):
    return torch.where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0)


def _run_pi(**kw):
    return mt.integrate(_pi, var=mt.Continuous(0.0, 1.0, ninc=64), dof=[[2]], solver="mcmc",
                        neval=2 ** 15, niter=3, block=16, seed=17, verbose=-2, device="cpu",
                        nwalkers=512, **kw)


def test_measurefreq_and_thermal_ratio():
    a = _run_pi()
    b = _run_pi(measurefreq=2)
    c = _run_pi(thermal_ratio=0.5)
    assert a.mean != b.mean and a.neval == b.neval == 3 * 512 * (64 + 6)
    assert c.neval == 3 * 512 * (64 + 32)
    for r in (a, b, c):
        assert abs(float(r.mean[0]) - np.pi / 4) < 7 * float(r.stdev[0])
    assert float(b.stdev[0]) > float(a.stdev[0])          # half the measurements
    with pytest.raises(ValueError, match="thermal_ratio"):
        _run_pi(thermal_ratio=-0.1)


def test_two_integrands_reweight():
    """Unit balls over one pool: changeIntegrand between dof 2 and 3, and
    reweighting from the visited counts after every iteration."""
    def balls(i, x, c):
        r2 = x[0] ** 2 + x[1] ** 2 + (x[2] ** 2 if i == 1 else 0.0)
        return torch.where(r2 < 1.0, 1.0, 0.0)

    res = mt.integrate(balls, var=mt.Continuous(0.0, 1.0, ninc=64), dof=[[2], [3]],
                       solver="mcmc", neval=2 ** 16, niter=4, block=16, seed=19, verbose=-2,
                       device="cpu", nwalkers=1024)
    for i, exact in enumerate((np.pi / 4, np.pi / 6)):
        assert abs(float(res.mean[i]) - exact) < 7 * float(res.stdev[i])
    first = res.iterations[0][2].reweight
    assert not np.allclose(first, 1 / 3) and np.isclose(first.sum(), 1.0)
    assert res.config.accept[0, 0, 1] > 0 and res.config.accept[2, 1, 0] > 0
