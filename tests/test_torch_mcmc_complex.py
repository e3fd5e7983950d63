"""PyTorch port: complex weights on :mcmc (``type=complex``).

The port (the kernels' plain versions on the CPU) against the JAX package
at complex64, run as ``tests/test_torch_mcmc_parity.py`` runs it: K3 in
interpret mode (``backend="pallas"``, 2 blocks of 1024 walkers, its error
bar taken as the port's where smaller) and the XLA route (16 blocks of
128), one iteration each at the same walker count and chain length.  Per
case, on the real and the imaginary part separately: the port's mean
within 7 sigma of the exact value, and within 7 combined sigma of each JAX
route (a channel whose error bar is 0 must agree exactly).

- ``exp(i x)`` on ``Continuous(0, 1)``: ``sin 1 + i(1 - cos 1)``;
- the complex one-hot measure of ``tests/test_pallas.py:838-870``: every
  bin of ``Discrete(1, 3)`` at ``sin 1 + i(1 - cos 1)``;
- ``(1 + x) exp(i x)``: ``(e^i - 1)(1 - i) - i e^i``;
- two complex integrands, ``x`` and ``i x^2`` (``tests/test_montecarlo.py:
  146-152``), which takes the grouped sector calls: 1/2 and i/3.

The XLA route draws one update kind per step for every walker of every
block (``mcintegration_tpu/solvers/mcmc.py``, ``u_kind``), so the sector
occupancy moves alike in all blocks and its block error bar misses that
noise.  Where ``|w|`` is constant, as for ``exp(i x)`` and the one-hot
measure, the estimate is all occupancy, and the route lands many of its
own error bars from the exact value.  Those two cases are held to K3 and
the exact value only; ``(1 + x) exp(i x)`` holds the port to the XLA route
on a complex integrand.

``f + 0j`` reproduces the real run over one iteration: normalization,
visited counts, tallies and histograms bit for bit, the imaginary parts
exactly 0, and the real parts of the observables at rel 1e-6 (``x *
fl(1/|x|)`` can miss ``sign(x)`` by an ulp).  ``mcmc_accept_plain``'s
complex branch by hand: the phase ``w/|w|`` over ``rcur``, its guard at
``|w| <= 1e-38``, a jump into the normalization sector zeroing both parts,
and a custom measure's ``relw = w/prob``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mcintegration_tpu as mj
from mcintegration_tpu import onehot as jonehot
from mcintegration_tpu.solvers.engine import Spec as JSpec
from mcintegration_tpu.solvers.mcmc import MCMCIteration as JMCMCIteration

import mcintegration_tpu_torch as mt
from mcintegration_tpu_torch.ops import mcmc_kernels as mk
from mcintegration_tpu_torch.solvers.engine import Spec
from mcintegration_tpu_torch.solvers.mcmc import MCMCIteration

torch.set_num_threads(1)

W, NSTEPS, THERMAL = 2048, 160, 0.3
Q = 3
PHASE = np.sin(1.0) + 1j * (1.0 - np.cos(1.0))       # int_0^1 e^{it} dt


def _exp_ix(pkg):
    return lambda i, x, c: pkg.exp(1j * x[0])


def _phase_td(pkg):
    return lambda i, x, c: pkg.exp(1j * x[0][0])


def _ramp(pkg):
    return lambda i, x, c: (1.0 + x[0]) * pkg.exp(1j * x[0])


def _two(pkg):
    return lambda i, x, c: x[0] + 0j if i == 0 else x[0] ** 2 * 1j


def _onehot_measure(pkg):
    oh = jonehot if pkg is jnp else mt.onehot

    def meas(i, x, w, c):
        t, d = x
        return [oh(d[0], 1, Q, w.dtype) * w]
    return meas


E_I = np.exp(1j)
CASES = {   # var, dof, integrand, measure, exact, the JAX routes it is held to
    "exp_ix": (lambda p: p.Continuous(0.0, 1.0), [[1]], _exp_ix, None, [PHASE], ("pallas",)),
    "onehot": (lambda p: (p.Continuous(0.0, 1.0), p.Discrete(1, Q)), [[1, 1]], _phase_td,
               _onehot_measure, [[PHASE] * Q], ("pallas",)),
    "ramp": (lambda p: p.Continuous(0.0, 1.0), [[1]], _ramp, None,
             [(E_I - 1) * (1 - 1j) - 1j * E_I], ("pallas", "xla")),
    "two": (lambda p: p.Continuous(0.0, 1.0), [[1], [1]], _two, None, [0.5, 1j / 3],
            ("pallas", "xla")),
}


def _obs(measure):
    return [np.zeros(Q, np.complex64)] if measure else None


def _jax_run(case, backend, block):
    var, dof, f, meas = CASES[case][:4]
    obs = _obs(meas)
    spec = JSpec(mj.Configuration(var=var(mj), dof=dof, seed=5, obs=obs, type=complex))
    kw = dict(measure=meas(jnp), obs_proto=obs) if meas else {}
    it = JMCMCIteration(spec, f(jnp), block=block, nevalperblock=W * NSTEPS // block,
                        backend=backend, nwalkers=W, thermal_ratio=THERMAL,
                        weight_dtype=jnp.complex64, **kw)
    assert it.backend == backend, it.backend_reason
    assert (it.nwalkers, it.nsteps) == (W, NSTEPS)
    return it.run(spec.device_params(), jax.random.key(4))


def _port_run(case, seed=3):
    var, dof, f, meas = CASES[case][:4]
    obs = _obs(meas)
    spec = Spec(mt.Configuration(var=var(mt), dof=dof, seed=5, obs=obs, type=complex), "cpu")
    kw = dict(measure=meas(torch), obs_proto=obs) if meas else {}
    it = MCMCIteration(spec, f(torch), block=16, nevalperblock=W * NSTEPS // 16, nwalkers=W,
                       thermal_ratio=THERMAL, **kw)
    kd = np.random.default_rng(seed).integers(0, 2 ** 32, (16, 2), dtype=np.uint32)
    return it, it.run(spec.device_params(), kd)


def _estimate(st, measured):
    """Per-block obs/norm: mean and block error, real and imaginary parts
    apart; the bins of the measure's one observable, or one per sector."""
    ob = np.asarray(st["obs_blocks"][0] if measured else st["obs_blocks"])
    m = ob / np.asarray(st["norm_blocks"])[:, None]
    err = (m.real.std(axis=0, ddof=1) + 1j * m.imag.std(axis=0, ddof=1)) / np.sqrt(len(m))
    return m.mean(axis=0), err


def _within(a, b, err, k=7.0):
    a, b, err = np.asarray(a), np.asarray(b), np.asarray(err)
    return (np.all(np.abs(a.real - b.real) <= k * err.real)
            and np.all(np.abs(a.imag - b.imag) <= k * err.imag))


def _hyp(a, b):
    return np.hypot(a.real, b.real) + 1j * np.hypot(a.imag, b.imag)


@pytest.mark.parametrize("case", list(CASES))
def test_run_matches_jax(case):
    measured = CASES[case][3] is not None
    it, st = _port_run(case)
    assert it.layout.spec.wdtype == torch.complex64
    assert mk.launch_counts["mcmc_accept_complex"] == 0          # plain versions on the CPU
    mean, err = _estimate(st, measured)
    exact = np.asarray(CASES[case][4]).reshape(mean.shape)
    assert np.iscomplexobj(mean)
    assert _within(mean, exact, err), (mean, err, exact)
    for backend in CASES[case][5]:
        block = 2 if backend == "pallas" else 16
        mj_, ej = _estimate(_jax_run(case, backend, block), measured)
        if backend == "pallas":     # two blocks: no error bar of its own
            ej = np.maximum(ej.real, err.real) + 1j * np.maximum(ej.imag, err.imag)
        assert _within(mean, mj_, _hyp(err, ej)), (backend, mean, mj_, err, ej)


def _identity_run(cplx):
    var = (mt.Continuous(0.0, 1.0), mt.Discrete(1, 4))

    def f(i, x, c):
        t, d = x
        w = torch.exp(-t[0]) * d[0].to(torch.float32) if i == 0 else torch.cos(3.0 * t[0])
        return w + 0j if cplx else w
    spec = Spec(mt.Configuration(var=var, dof=[[1, 1], [1, 0]], seed=2,
                                 type=complex if cplx else float), "cpu")
    it = MCMCIteration(spec, f, block=4, nevalperblock=2 ** 12, nwalkers=256,
                       thermal_ratio=0.2)
    kd = np.random.default_rng(6).integers(0, 2 ** 32, (4, 2), dtype=np.uint32)
    return it.run(spec.device_params(), kd)


def test_real_integrand_plus_0j_reproduces_the_real_run():
    real, cpx = _identity_run(False), _identity_run(True)
    for key in ("norm_blocks", "visited", "propose", "accept"):
        assert np.array_equal(cpx[key], real[key]), key
    assert all(np.array_equal(a, b) for a, b in zip(cpx["hists"], real["hists"]))
    assert np.all(cpx["obs_blocks"].imag == 0.0)
    np.testing.assert_allclose(cpx["obs_blocks"].real, real["obs_blocks"], rtol=1e-6)


def _hand_state(custom):
    """One integrand of one Continuous slot, four walkers in one block."""
    spec = Spec(mt.Configuration(var=mt.Continuous(0.0, 1.0, ninc=4), dof=[[1]], seed=1,
                                 type=complex), "cpu")
    lay = mk.McmcLayout.build(spec, 1, 4, 2 if not custom else 1, custom)
    st = mk.McmcState.zeros(lay)
    st.weight.copy_(torch.tensor([3 + 4j, -2 + 0j, 1e-39 + 0j, -1 - 1j], dtype=torch.complex64))
    st.prob.copy_(torch.tensor([2.5, 1.0, 0.0, 0.0]))
    st.rcur.copy_(torch.tensor([0.5, 0.25, 0.5, 0.5]))
    st.degc.fill_(1.0)
    st.picv.fill_(1.0 / 3.0)
    st.dof.fill_(1)
    st.prop.fill_(1.0)
    st.move[0, 3] = mk.ROLE_NJ                 # walker 3 jumps to the normalization sector
    rw = torch.tensor([0.5, 2.0])
    sched = torch.zeros((2, 1), dtype=torch.int32)
    tab = lay.tables(spec.device_params())
    return lay, st, rw, sched, tab


@pytest.mark.parametrize("custom", [False, True], ids=["default", "custom"])
def test_mcmc_accept_plain_complex_by_hand(custom):
    lay, st, rw, sched, tab = _hand_state(custom)
    w0 = st.weight.clone()
    kd = torch.zeros((1, 2), dtype=torch.int32)
    mk.mcmc_accept_plain(lay, tab, rw, kd, sched, 1, st, torch.zeros(4, dtype=torch.complex64),
                         measure=True)
    # the jump: both parts scaled by 0, so (-1 - 1i) keeps its zeros' signs
    assert int(st.curr[3]) == 1 and st.prob[3] == rw[1]
    re3, im3 = torch.view_as_real(st.weight)[3]
    assert re3 == 0.0 and im3 == 0.0 and torch.signbit(re3) and torch.signbit(im3)
    assert torch.equal(st.nrm, torch.tensor([0.0, 0.0, 0.0, 1.0 / 2.0], dtype=torch.float64))
    re, im = w0.real, w0.imag
    if custom:                  # relw = w/prob where prob > 1e-38, outside the norm sector
        invp = torch.tensor([1.0 / 2.5, 1.0, 0.0, 0.0])
        assert torch.equal(st.relw.real, re * invp) and torch.equal(st.relw.imag, im * invp)
        assert not st.obs.any()
        return
    # the phase w/|w| over rcur into components 0 (Re) and 1 (Im) of sector 0:
    # |3 + 4i| = 5; |-2| = 2, a sign; |1e-39| rounds to 0 <= 1e-38, nothing
    inv_abs = torch.tensor([1.0 / 5.0, 0.5, 0.0, 0.0])
    invr = 1.0 / st.rcur
    want_re, want_im = re * inv_abs * invr, im * inv_abs * invr
    want_re[3] = want_im[3] = 0.0
    assert torch.equal(st.obs[0], want_re.double()) and torch.equal(st.obs[1], want_im.double())
    assert st.obs[0, 1] == -4.0 and st.obs[1, 1] == 0.0 and st.obs[0, 2] == 0.0
