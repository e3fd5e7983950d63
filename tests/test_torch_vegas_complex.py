"""PyTorch port: complex weights (``type=complex``) on :vegas and :vegasplus.

- ``complex1``, ``complex2`` and ``complex2_inplace`` of
  ``tests/test_montecarlo.py:136-165`` and the quarter disc times
  ``e^{i(x+y)}`` (``tests/test_pallas.py:385-420``): one iteration of each
  solver against the JAX package's XLA route at complex64, which samples
  the same law from another random stream, within 7 combined sigma on the
  real and on the imaginary part separately, and against the exact values
  within 7 sigma.
- ``f + 0j`` reproduces the real run: over one iteration the real parts of
  the observables, the histograms and (``:vegasplus``) the per-cube second
  moments and the next counts are bit-equal and the imaginary parts exactly
  0 (``sqrt(fl(x x)) = |x|`` in binary floating point); over a run of
  ``integrate`` the trained grids are bit-equal.
- ``vegas_reduce_plain``'s complex algebra by hand on a few samples.
- A complex :vegas run's trained state moves between the packages.

Sigma is each package's block spread (16 blocks).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mcintegration_tpu as mj
from mcintegration_tpu.solvers.engine import Spec as JSpec
from mcintegration_tpu.solvers.vegas import VegasIteration as JVegasIteration
from mcintegration_tpu.solvers.vegasplus import VegasPlusIteration as JVegasPlusIteration

import mcintegration_tpu_torch as mt
from mcintegration_tpu_torch.ops import vegas_kernels as vk, vplus_kernels as vp
from mcintegration_tpu_torch.solvers.engine import Spec
from mcintegration_tpu_torch.solvers.vegas import VegasIteration
from mcintegration_tpu_torch.solvers.vegasplus import VegasPlusIteration

torch.set_num_threads(1)

# the quarter disc's integral, by quadrature (chip_smoke.py:qdisc_exact);
# test_pallas.py:398's 0.4930385477642199 + 0.5622057316603964j is off by
# 2.4e-5 and 4.3e-5
QDISC = 0.4930146509292773 + 0.5621624711036073j
BLOCK = 16
KW = {"vegas": dict(block=BLOCK, nevalperblock=2 ** 13),
      "vegasplus": dict(block=BLOCK, nevalperblock=2 ** 13, max_cubes=256)}
CLASSES = {"vegas": (VegasIteration, JVegasIteration),
           "vegasplus": (VegasPlusIteration, JVegasPlusIteration)}


def _complex1(pkg):
    return (lambda x, c: x[0] + x[0] ** 2 * 1j), [[1]], [0.5 + 1j / 3], False


def _complex2(pkg):
    return (lambda x, c: (x[0] + 0j, x[0] ** 2 * 1j)), [[1], [1]], [0.5, 1j / 3], False


def _complex2_inplace(pkg):
    def f(x, w, c):
        w[0] = x[0] + 0j
        w[1] = x[0] ** 2 * 1j
    return f, [[1], [1]], [0.5, 1j / 3], True


def _qdisc(pkg):
    def f(x, c):
        inside = pkg.where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0)
        return inside * pkg.exp(1j * (x[0] + x[1]))
    return f, [[2]], [QDISC], False


CASES = {"complex1": _complex1, "complex2": _complex2, "complex2_inplace": _complex2_inplace,
         "qdisc": _qdisc}


def _estimate(m):
    """Mean and block error of per-block estimates ``m [block, ...]``, the
    real and imaginary parts apart."""
    err = (m.real.std(axis=0, ddof=1) + 1j * m.imag.std(axis=0, ddof=1)) / np.sqrt(len(m))
    return m.mean(axis=0), err


def _within(a, b, err, k=7.0):
    """|a - b| < k*err on the real and on the imaginary parts (an exactly
    zero part may have a zero error)."""
    a, b, err = np.asarray(a), np.asarray(b), np.asarray(err) + 1e-12 * (1 + 1j)
    return (np.all(np.abs(a.real - b.real) < k * err.real)
            and np.all(np.abs(a.imag - b.imag) < k * err.imag))


def _kd(seed, block=BLOCK):
    return np.random.default_rng(seed).integers(0, 2 ** 32, (block, 2), dtype=np.uint32)


def _combined(et, ej):
    return np.hypot(et.real, ej.real) + 1j * np.hypot(et.imag, ej.imag)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("solver", ["vegas", "vegasplus"])
def test_complex_matches_jax_xla_route(solver, case):
    f, dof, exact, inplace = CASES[case](torch)
    jf = CASES[case](jnp)[0]
    tcls, jcls = CLASSES[solver]
    tspec = Spec(mt.Configuration(var=mt.Continuous(0.0, 1.0, ninc=64), dof=dof, seed=5,
                                  type=complex), "cpu")
    tit = tcls(tspec, f, inplace=inplace, **KW[solver])
    jspec = JSpec(mj.Configuration(var=mj.Continuous(0.0, 1.0, ninc=64), dof=dof, seed=5,
                                   type=complex))
    jit = jcls(jspec, jf, inplace=inplace, backend="xla", weight_dtype=jnp.complex64,
               **KW[solver])
    assert tit.backend_reason == "" and tit.nevalperblock == jit.nevalperblock
    vk.reset_launch_counts()
    vp.reset_launch_counts()
    st = tit.run(tspec.device_params(), _kd(3))
    assert sum(vk.launch_counts.values()) + sum(vp.launch_counts.values()) == 0   # plain
    sj = jit.run(jspec.device_params(), jax.random.key(3))
    ob = st["obs_blocks"]
    assert np.iscomplexobj(ob) and ob.shape == (BLOCK, len(exact))
    assert np.array_equal(st["norm_blocks"], np.asarray(sj["norm_blocks"], np.float64))
    mt_, et = _estimate(ob / st["norm_blocks"][:, None])
    mj_, ej = _estimate(np.asarray(sj["obs_blocks"]) / np.asarray(sj["norm_blocks"])[:, None])
    assert _within(mt_, mj_, _combined(et, ej)), (mt_, mj_, et, ej)
    assert _within(mt_, exact, et), (mt_, exact, et)


def _identity_case(cplx):
    var = mt.CompositeVar(mt.Continuous(0.0, 1.0, ninc=64), mt.Continuous(0.0, 2.0, ninc=64))

    def f(x, c):
        a, b = x
        w0 = torch.exp(-a[0]) * b[0]
        w1 = torch.cos(3.0 * a[1]) + a[0] * b[1]
        return (w0 + 0j, w1 + 0j) if cplx else (w0, w1)
    return var, f


@pytest.mark.parametrize("solver", ["vegas", "vegasplus"])
def test_real_integrand_plus_0j_reproduces_the_real_run(solver):
    """One iteration from the same seeds, two integrands with padding:
    obs real parts, histograms, sig and the next counts bit for bit."""
    out, its = {}, {}
    for cplx in (False, True):
        var, f = _identity_case(cplx)
        spec = Spec(mt.Configuration(var=var, dof=[[1], [2]], seed=2,
                                     type=complex if cplx else float), "cpu")
        it = CLASSES[solver][0](spec, f, **KW[solver])
        out[cplx], its[cplx] = it.run(spec.device_params(), _kd(5)), it
    real, cpx = out[False], out[True]
    assert np.array_equal(cpx["obs_blocks"].real, real["obs_blocks"])
    assert np.all(cpx["obs_blocks"].imag == 0.0)
    assert np.array_equal(cpx["norm_blocks"], real["norm_blocks"])
    assert all(np.array_equal(a, b) for a, b in zip(cpx["hists"], real["hists"]))
    if solver == "vegasplus":
        assert np.array_equal(its[True].last_sig, its[False].last_sig)
        assert np.array_equal(its[True].counts, its[False].counts)


@pytest.mark.parametrize("solver", ["vegas", "vegasplus"])
def test_real_integrand_plus_0j_integrate(solver):
    """The same over a run of ``integrate``: training sees bit-equal
    histograms, so the grids stay bit-equal.  Each iteration's means agree
    to rel 1e-15 (numpy divides a complex number by a real one as a product
    with its reciprocal); the weighted mean over iterations to rel 1e-12,
    since the block variance, a difference of squares, spreads that ulp to
    its weights."""
    res = {}
    for cplx in (False, True):
        var, f = _identity_case(cplx)
        res[cplx] = mt.integrate(f, var=var, dof=[[1], [2]], neval=2 ** 14, niter=3,
                                 solver=solver, type=complex if cplx else float,
                                 device="cpu", verbose=-2, seed=3)
    a, b = res[False], res[True]
    for (_, la), (_, lb) in zip(a.config.var_leaves(), b.config.var_leaves()):
        assert np.array_equal(la.histogram, lb.histogram)
        assert np.array_equal(la.grid, lb.grid)
    for ia, ib in zip(a.iterations, b.iterations):
        for ma, mb in zip(ia[0], ib[0]):
            assert mb.imag == 0.0 and abs(mb.real - ma) <= 1e-15 * abs(ma)
    for ma, mb in zip(a.mean, b.mean):
        assert mb.imag == 0.0 and abs(mb.real - ma) <= 1e-12 * abs(ma)


def test_vegas_reduce_plain_complex_by_hand():
    """One slot, one block, one chunk, two strata of two samples, complex
    w: Re and Im of w * jac in components 0 and 1, the histogram term
    (|w| jac)^2 at the permuted stratum; with measurefreq 3 and t0 = 1 only
    the sample of index 1*4 + 0*2 + 1 + 1 = 6 is measured."""
    w = torch.tensor([[[[[3 + 4j, -1 + 0j], [0.5j, 2 - 2j]]]]], dtype=torch.complex64)
    invp = torch.tensor([[[[0.5, 4.0]]]])
    perm = torch.tensor([[[[1, 0]]]], dtype=torch.int32)
    pad = torch.zeros((1, 1), dtype=torch.int32)
    pair_slots = torch.tensor([[0]], dtype=torch.int32)
    used = torch.ones((1, 1), dtype=torch.int32)
    obs, hrow = vk.vegas_reduce(w, invp, perm, pad, pair_slots, used)
    assert obs.shape == (1, 1, 2) and obs.dtype == torch.float64
    # jac per stratum: 0.5 and 4.0
    assert obs[0, 0, 0] == 3 * 0.5 - 1 * 0.5 + 0 * 4.0 + 2 * 4.0
    assert obs[0, 0, 1] == 4 * 0.5 + 0 * 0.5 + 0.5 * 4.0 - 2 * 4.0
    row0 = (5 * 0.5) ** 2 + (1 * 0.5) ** 2
    a = np.float32(np.sqrt(8.0)) * np.float32(4.0)          # |2 - 2i| * jac, float32
    row1 = (0.5 * 4.0) ** 2 + float(a * a)
    assert torch.equal(hrow[0, 0, 0], torch.tensor([row1, row0], dtype=torch.float64))
    obs3, hrow3 = vk.vegas_reduce(w, invp, perm, pad, pair_slots, used, mf=3, t0=1)
    assert obs3[0, 0].tolist() == [-1 * 0.5, 0.0]
    assert torch.equal(hrow3, hrow)
    relw = vk.vegas_relw(w, invp, pad, pair_slots)
    assert relw.dtype == torch.complex64
    assert torch.equal(relw[0, 0, 0], torch.tensor([[1.5 + 2j, -0.5 + 0j], [2j, 8 - 8j]]))


def test_complex_vegas_state_moves_between_packages(tmp_path):
    """A complex :vegas run trains real maps: its state loads into the JAX
    package's configuration and back, bit for bit."""
    var, f = _identity_case(True)
    res = mt.integrate(f, var=var, dof=[[1], [2]], neval=2 ** 13, niter=2, solver="vegas",
                       type=complex, device="cpu", verbose=-2, seed=4)
    mt.save_state(res.config, tmp_path / "torch.npz")
    jvar = mj.CompositeVar(mj.Continuous(0.0, 1.0, ninc=64), mj.Continuous(0.0, 2.0, ninc=64))
    jc = mj.Configuration(var=jvar, dof=[[1], [2]], seed=4, type=complex)
    mj.load_state(jc, tmp_path / "torch.npz")
    for (_, a), (_, b) in zip(jc.var_leaves(), res.config.var_leaves()):
        assert np.array_equal(a.grid, b.grid) and np.array_equal(a.histogram, b.histogram)
    mj.save_state(jc, tmp_path / "jax.npz")
    var2, _ = _identity_case(True)
    back = mt.load_state(mt.Configuration(var=var2, dof=[[1], [2]], seed=4, type=complex),
                         tmp_path / "jax.npz")
    for (_, a), (_, b) in zip(back.var_leaves(), res.config.var_leaves()):
        assert np.array_equal(a.grid, b.grid) and np.array_equal(a.histogram, b.histogram)
