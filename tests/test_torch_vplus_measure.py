"""PyTorch port: custom measures on :vegasplus.

- The quickstart's 10-bin histogram (``examples/quickstart.py:75-85``) and
  the identity measure ``[relw[0]]``: one iteration against the JAX
  package's XLA route (``backend="xla"``), which samples the same law from
  another random stream, every bin within 7 combined sigma, and against the
  exact values within 7 sigma; a complex one-hot measure on a complex run
  against its exact values.
- The identity measure against the default one from the same seeds:
  observables within rel 1e-12, the per-cube second moments, the
  histograms and the next counts equal.
- ``vplus_relw_plain`` and ``vplus_reduce_plain`` given a measure's output
  against values worked by hand.

Sigma is each package's block spread (16 blocks).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mcintegration_tpu as mj
from mcintegration_tpu.solvers.engine import Spec as JSpec
from mcintegration_tpu.solvers.vegasplus import VegasPlusIteration as JVegasPlusIteration

import mcintegration_tpu_torch as mt
from mcintegration_tpu_torch.ops import vplus_kernels as vp
from mcintegration_tpu_torch.solvers.engine import Spec
from mcintegration_tpu_torch.solvers.vegasplus import VegasPlusIteration

torch.set_num_threads(1)

NBIN = 10
Q = 3
PHASE = np.sin(1.0) + 1j * (1.0 - np.cos(1.0))       # int_0^1 e^{it} dt
KW = dict(block=16, nevalperblock=2 ** 13, max_cubes=256)


def hist_f(pkg):
    def f(v, c):
        x, y = v
        return x[0] ** 2 + y[0] ** 2
    return f


def hist_measure(pkg, nbin=NBIN):
    """The quickstart's histogram of x, written to broadcast over a batch."""
    def measure(v, relw, c):
        x, _ = v
        if pkg is jnp:
            b = jnp.clip((x[0] * nbin).astype(jnp.int32), 0, nbin - 1)
            bins = jnp.arange(nbin).reshape((nbin,) + (1,) * b.ndim)
            return [(bins == b).astype(relw.dtype) * relw[0] * nbin]
        b = torch.clamp((x[0] * nbin).to(torch.int32), 0, nbin - 1)
        bins = torch.arange(nbin).reshape((nbin,) + (1,) * b.ndim)
        return [(bins == b).to(relw.dtype) * relw[0] * nbin]
    return measure


def hist_exact(nbin=NBIN):
    """Each bin's exact value, the mean of x^2 + 1/3 over [a, a+h), h = 1/nbin."""
    h = 1.0 / nbin
    a = np.arange(nbin) * h
    return a * a + a * h + h * h / 3 + 1.0 / 3


def pi_f(pkg):
    return lambda x, c: pkg.where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0)


def identity_measure(pkg):
    return lambda x, relw, c: [relw[0]]


CASES = {   # var, dof, obs, integrand, measure, exact
    "histogram": (lambda pkg: (pkg.Continuous(0.0, 1.0, ninc=64), pkg.Continuous(0.0, 1.0, ninc=64)),
                  [[1, 1]], [np.zeros(NBIN)], hist_f, hist_measure, hist_exact()),
    "identity": (lambda pkg: pkg.Continuous(0.0, 1.0, ninc=64), [[2]], [0.0], pi_f,
                 identity_measure, np.pi / 4),
}


def _estimate(m):
    return m.mean(axis=0), m.std(axis=0, ddof=1) / np.sqrt(len(m))


def _kd(seed, block=16):
    return np.random.default_rng(seed).integers(0, 2 ** 32, (block, 2), dtype=np.uint32)


@pytest.mark.parametrize("case", list(CASES))
def test_measure_matches_jax_xla_route(case):
    var, dof, obs, f, measure, exact = CASES[case]
    tspec = Spec(mt.Configuration(var=var(mt), dof=dof, obs=obs, seed=5), "cpu")
    tit = VegasPlusIteration(tspec, f(torch), measure=measure(torch), obs_proto=obs, **KW)
    jspec = JSpec(mj.Configuration(var=var(mj), dof=dof, obs=obs, seed=5))
    jit = JVegasPlusIteration(jspec, f(jnp), measure=measure(jnp), obs_proto=obs,
                              backend="xla", **KW)
    assert tit.backend_reason == "" and tit.nevalperblock == jit.nevalperblock
    vp.reset_launch_counts()
    st = tit.run(tspec.device_params(), _kd(6))
    assert sum(vp.launch_counts.values()) == 0                # the plain versions
    sj = jit.run(jspec.device_params(), jax.random.key(6))
    norm_t, norm_j = st["norm_blocks"], np.asarray(sj["norm_blocks"], np.float64)
    assert np.array_equal(norm_t, norm_j)
    ob_t = np.asarray(st["obs_blocks"][0]).reshape(16, -1)
    ob_j = np.asarray(sj["obs_blocks"][0]).reshape(16, -1)
    mt_, et = _estimate(ob_t / norm_t[:, None])
    mj_, ej = _estimate(ob_j / norm_j[:, None])
    assert np.all(np.abs(mt_ - mj_) < 7 * np.hypot(et, ej)), (mt_, mj_, et, ej)
    assert np.all(np.abs(mt_ - exact) < 7 * et), (mt_, exact, et)


def test_measure_integrate_histogram():
    var, dof, obs, f, measure, exact = CASES["histogram"]
    res = mt.integrate(f(torch), var=var(mt), dof=dof, obs=obs, measure=measure(torch),
                       solver="vegasplus", neval=2 ** 16, niter=3, device="cpu", verbose=-2,
                       seed=8)
    mean, err = np.asarray(res.mean[0]), np.asarray(res.stdev[0])
    assert res.backend == "torch" and res.backend_reason == ""
    assert mean.shape == (NBIN,) and np.all(np.abs(mean - exact) < 7 * err), (mean, err)


def _onehot_measure(v, relw, c):
    t, d = v
    bins = torch.arange(1, Q + 1).reshape((Q,) + (1,) * d[0].ndim)
    return [(bins == d[0][None]).to(torch.float32) * relw[0][None]]


def test_complex_onehot_measure():
    """A complex run, a Discrete passenger and a complex observable: every
    bin of e^{it} binned by the Discrete(1, 3) value is sin 1 + i(1 - cos 1)."""
    res = mt.integrate(lambda x, c: torch.exp(1j * x[0][0]),
                       var=(mt.Continuous(0.0, 1.0, ninc=64), mt.Discrete(1, Q)), dof=[[1, 1]],
                       obs=[np.zeros(Q, np.complex64)], measure=_onehot_measure, type=complex,
                       solver="vegasplus", neval=2 ** 15, niter=3, device="cpu", verbose=-2,
                       seed=9)
    mean, err = np.asarray(res.mean[0]), np.asarray(res.stdev[0])
    assert mean.shape == (Q,) and np.iscomplexobj(mean)
    assert np.all(np.abs(mean.real - PHASE.real) < 7 * err.real), (mean, err)
    assert np.all(np.abs(mean.imag - PHASE.imag) < 7 * err.imag), (mean, err)


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_identity_measure_matches_default(cplx):
    """Two integrands with padding, one iteration from the same seeds: the
    identity measures [relw[0]] and [relw[1]] give the default observables
    to rel 1e-12 (the same float32 terms, summed in another order), and
    the second moments, histograms and next counts as the default run."""
    var = mt.CompositeVar(mt.Continuous(0.0, 1.0, ninc=64), mt.Continuous(0.0, 2.0, ninc=64))

    def f(x, c):
        a, b = x
        w0, w1 = torch.exp(-a[0]) * b[0], torch.cos(3.0 * a[1]) + a[0] * b[1]
        return (w0 * torch.exp(1j * b[0]), w1 + 0.5j) if cplx else (w0, w1)

    typ = complex if cplx else float
    obs = [0j, 0j] if cplx else [0.0, 0.0]
    spec = Spec(mt.Configuration(var=var, dof=[[1], [2]], obs=obs, seed=2, type=typ), "cpu")
    a = VegasPlusIteration(spec, f, **KW)
    b = VegasPlusIteration(spec, f, measure=lambda x, relw, c: [relw[0], relw[1]],
                           obs_proto=obs, **KW)
    ra, rb = a.run(spec.device_params(), _kd(4)), b.run(spec.device_params(), _kd(4))
    ob = np.stack([np.asarray(o) for o in rb["obs_blocks"]], axis=1)
    assert ob.shape == ra["obs_blocks"].shape and np.iscomplexobj(ob) == cplx
    np.testing.assert_allclose(ob, ra["obs_blocks"], rtol=1e-12, atol=0)
    assert np.array_equal(ra["norm_blocks"], rb["norm_blocks"])
    assert np.array_equal(a.last_sig, b.last_sig) and np.array_equal(a.counts, b.counts)
    assert all(np.array_equal(x, y) for x, y in zip(ra["hists"], rb["hists"]))


def _hand_case(cplx):
    """One Continuous pool of two bins, two integrands (the first leaves
    slot 1 unused), nstrat 2 on both slots, one block of two chunks
    of four samples; the samples sit in two of the four cubes."""
    spec = Spec(mt.Configuration(var=mt.Continuous(0.0, 1.0, ninc=2), dof=[[1], [2]], seed=1,
                                 type=complex if cplx else float), "cpu")
    lay = vp.VplusLayout.build(spec, 2)
    tab = torch.tensor([0.0, 0.25, 0.25, 0.75, 2.0, 2.0 / 3.0])   # grid, inc, rho
    gidx = torch.tensor([[[[0, 0, 1, 1], [1, 0, 1, 0]]],
                         [[[1, 0, 0, 1], [0, 0, 1, 1]]]], dtype=torch.int32)
    cube = torch.tensor([0, 0, 1, 1], dtype=torch.int32)          # 2 samples a cube
    cfac = torch.tensor([1.0, 1.0])                               # n_c * ncubes / c
    w = torch.arange(1.0, 17.0).reshape(2, 1, 2, 4)
    if cplx:
        w = torch.complex(w, -0.5 * w)
    return lay, tab, w, gidx, cube, cfac


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_vplus_relw_plain_by_hand(cplx):
    lay, tab, w, gidx, cube, cfac = _hand_case(cplx)
    rho = torch.tensor([2.0, 2.0 / 3.0])
    r0, r1 = rho[gidx[0].long()], rho[gidx[1].long()]
    jac = 1.0 / (cfac[cube.long()] * (r0 * r1))
    relw = vp.vplus_relw(lay, tab, w, gidx, cube, cfac)
    assert relw.dtype == w.dtype and relw.shape == w.shape
    # integrand 0 leaves slot 1 unused: its padding factor is slot 1's density
    want = [w[0] * (jac * (torch.ones(()) * r1)), w[1] * jac]
    for i in range(2):
        assert torch.equal(relw[i], want[i])
    assert vp.launch_counts["vplus_relw"] == 0


def test_vplus_reduce_plain_given_m_by_hand():
    """Given m, obs are its sums (gated with measurefreq 3: the samples of
    index 3 and 6 of the block, chunk 0's s = 2 and chunk 1's s = 1); sig
    and hist come from w, as without m."""
    lay, tab, w, gidx, cube, cfac = _hand_case(False)
    m = torch.arange(24.0).reshape(3, 1, 2, 4) * 0.5
    obs0, sig0, hist0 = vp.vplus_reduce(lay, tab, w, gidx, cube, cfac)
    obs, sig, hist = vp.vplus_reduce(lay, tab, w, gidx, cube, cfac, m)
    assert obs.shape == (1, 2, 3) and torch.equal(sig, sig0) and torch.equal(hist, hist0)
    assert torch.equal(obs, m.double().sum(dim=-1).permute(1, 2, 0))
    obs3, sig3, hist3 = vp.vplus_reduce(lay, tab, w, gidx, cube, cfac, m, mf=3)
    assert torch.equal(sig3, sig0) and torch.equal(hist3, hist0)
    for q in range(3):
        assert obs3[0, 0, q] == m[q, 0, 0, 2] and obs3[0, 1, q] == m[q, 0, 1, 1]
    # chunks 5 and 6 of a block (t0 = 5): indices 21..28, of which 21, 24, 27
    obs5, _, _ = vp.vplus_reduce(lay, tab, w, gidx, cube, cfac, m, mf=3, t0=5)
    for q in range(3):
        assert obs5[0, 0, q] == m[q, 0, 0, 0] + m[q, 0, 0, 3]
        assert obs5[0, 1, q] == m[q, 0, 1, 2]
