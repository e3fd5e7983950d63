"""PyTorch port: complex weights on :vegasmc (``type=complex``).

- The quarter-disc phase integral ``e^{i(x+y)}`` (``tests/test_pallas.py:
  385-420``): one ``VegasMCIteration.run`` against the JAX package's XLA
  route at complex64, which samples the same law from another random
  stream, within 7 combined sigma on the real and the imaginary part
  separately; and ``integrate`` against the exact value within 7 sigma on
  each part.
- The complex one-hot measure on ``Discrete(1, Q)`` (``test_pallas.py:
  423-460``): every bin, real and imaginary part, within 7 sigma of ``sin 1
  + i(1 - cos 1)``, and within 7 combined sigma of the XLA route.
- ``complex2`` and ``complex2_inplace`` (``tests/test_montecarlo.py:
  146-165``): two integrands against 1/2 and i/3, within 7 sigma.
- ``f + 0j`` reproduces the real run: over one iteration the real parts of
  the observables, the normalization, the visited sums, the histograms and
  the tallies are bit-equal and the imaginary parts exactly 0 (``sqrt(fl(x
  x)) = |x|`` in binary floating point); over a run of ``integrate`` the
  trained grids and the reweighting are bit-equal, and the means agree to
  rel 1e-15 (numpy divides complex numbers by a real one as a product with
  its reciprocal).
- ``chain_accept_plain``'s complex algebra by hand on four walkers:
  ``|w|`` in the joint density and the visited sums, ``|w|^2`` in the
  histogram weight, the relative weights in components ``2i`` and
  ``2i + 1``, or in ``relw`` with a custom measure.

Sigma is each package's block spread (16 blocks).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mcintegration_tpu as mj
from mcintegration_tpu.solvers.engine import Spec as JSpec
from mcintegration_tpu.solvers.vegasmc import VegasMCIteration as JVegasMCIteration

import mcintegration_tpu_torch as mt
from mcintegration_tpu_torch.ops import chain_kernels as ck
from mcintegration_tpu_torch.solvers.engine import Spec
from mcintegration_tpu_torch.solvers.vegasmc import VegasMCIteration

torch.set_num_threads(1)

QDISC = 0.4930385477642199 + 0.5622057316603964j    # test_pallas.py:396
PHASE = np.sin(1.0) + 1j * (1.0 - np.cos(1.0))       # int_0^1 e^{it} dt
Q = 3
KW = dict(block=16, nevalperblock=2 ** 13, nwalkers=2048)   # 64 steps per walker


def _qdisc(pkg):
    def f(x, c):
        inside = pkg.where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0)
        return inside * pkg.exp(1j * (x[0] + x[1]))
    return f


def _phase(pkg):
    return lambda x, c: pkg.exp(1j * x[0][0])


def _onehot_measure(pkg):
    def meas(v, relw, c):
        t, d = v
        bins = pkg.arange(1, Q + 1).reshape((Q,) + (1,) * d[0].ndim)
        oh = bins == d[0][None]
        oh = oh.astype(jnp.float32) if pkg is jnp else oh.to(torch.float32)
        return [oh * relw[0][None]]
    return meas


def _estimate(m):
    """Mean and block error of per-block estimates ``m [block, ...]``, the
    real and imaginary parts apart."""
    err = (m.real.std(axis=0, ddof=1) + 1j * m.imag.std(axis=0, ddof=1)) / np.sqrt(len(m))
    return m.mean(axis=0), err


def _within(a, b, err, k=7.0):
    """|a - b| < k*err on the real and on the imaginary parts."""
    a, b, err = np.asarray(a), np.asarray(b), np.asarray(err)
    return (np.all(np.abs(a.real - b.real) < k * err.real)
            and np.all(np.abs(a.imag - b.imag) < k * err.imag))


def _kd(seed, block=16):
    return np.random.default_rng(seed).integers(0, 2 ** 32, (block, 2), dtype=np.uint32)


def test_quarter_disc_matches_jax_xla_route():
    jspec = JSpec(mj.Configuration(var=mj.Continuous(0.0, 1.0), dof=[[2]], seed=5,
                                   type=complex))
    jit = JVegasMCIteration(jspec, _qdisc(jnp), backend="xla", weight_dtype=jnp.complex64,
                            **KW)
    tspec = Spec(mt.Configuration(var=mt.Continuous(0.0, 1.0), dof=[[2]], seed=5,
                                  type=complex), "cpu")
    tit = VegasMCIteration(tspec, _qdisc(torch), **KW)
    assert tspec.wdtype == torch.complex64 and tit.layout.ncomp == 2
    assert (tit.nwalkers, tit.nsteps) == (jit.nwalkers, jit.nsteps)
    ck.reset_launch_counts()
    st = tit.run(tspec.device_params(), _kd(3))
    assert sum(ck.launch_counts.values()) == 0              # plain versions on the CPU
    sj = jit.run(jspec.device_params(), jax.random.key(3))
    assert np.iscomplexobj(st["obs_blocks"]) and st["obs_blocks"].shape == (16, 1)
    mt_, et = _estimate(st["obs_blocks"][:, 0] / st["norm_blocks"])
    mj_, ej = _estimate(np.asarray(sj["obs_blocks"])[:, 0] / np.asarray(sj["norm_blocks"]))
    assert _within(mt_, mj_, np.hypot(et.real, ej.real) + 1j * np.hypot(et.imag, ej.imag)), \
        (mt_, mj_, et, ej)
    assert _within(mt_, QDISC, et), (mt_, et)


def test_quarter_disc_integrate_matches_exact():
    res = mt.integrate(_qdisc(torch), var=mt.Continuous(0.0, 1.0), dof=[[2]], neval=2 ** 15,
                       niter=4, type=complex, device="cpu", verbose=-2, seed=7)
    assert res.backend == "torch"
    assert np.iscomplexobj(res.mean[0]) and np.iscomplexobj(res.stdev[0])
    assert _within(res.mean[0], QDISC, res.stdev[0]), (res.mean, res.stdev)


def test_complex_onehot_measure_matches_exact_and_jax():
    obs = [np.zeros(Q, np.complex64)]
    jspec = JSpec(mj.Configuration(var=(mj.Continuous(0.0, 1.0), mj.Discrete(1, Q)),
                                   dof=[[1, 1]], seed=4, obs=obs, type=complex))
    jit = JVegasMCIteration(jspec, _phase(jnp), backend="xla", weight_dtype=jnp.complex64,
                            measure=_onehot_measure(jnp), obs_proto=obs, **KW)
    tspec = Spec(mt.Configuration(var=(mt.Continuous(0.0, 1.0), mt.Discrete(1, Q)),
                                  dof=[[1, 1]], seed=4, obs=obs, type=complex), "cpu")
    tit = VegasMCIteration(tspec, _phase(torch), measure=_onehot_measure(torch),
                           obs_proto=obs, **KW)
    assert tit.backend_reason == "" and tit.layout.ncomp == 2 * Q
    assert tit.layout.custom and tit.layout.spec.cplx
    st = tit.run(tspec.device_params(), _kd(8))
    sj = jit.run(jspec.device_params(), jax.random.key(8))
    ob = st["obs_blocks"][0]
    assert np.iscomplexobj(ob) and ob.shape == (16, Q)
    mt_, et = _estimate(ob / st["norm_blocks"][:, None])
    mj_, ej = _estimate(np.asarray(sj["obs_blocks"][0]) / np.asarray(sj["norm_blocks"])[:, None])
    assert _within(mt_, PHASE, et), (mt_, et)
    assert _within(mt_, mj_, np.hypot(et.real, ej.real) + 1j * np.hypot(et.imag, ej.imag)), \
        (mt_, mj_, et, ej)


def test_complex_onehot_measure_integrate():
    """The same measure through ``integrate``: the result's observable is
    one complex vector of Q bins."""
    res = mt.integrate(_phase(torch), var=(mt.Continuous(0.0, 1.0), mt.Discrete(1, Q)),
                       dof=[[1, 1]], obs=[np.zeros(Q, np.complex64)],
                       measure=_onehot_measure(torch), neval=2 ** 15, niter=4, type=complex,
                       device="cpu", verbose=-2, seed=9)
    mean, err = np.asarray(res.mean[0]), np.asarray(res.stdev[0])
    assert mean.shape == (Q,) and np.iscomplexobj(mean)
    assert _within(mean, PHASE, err), (mean, err)


def _complex2(inplace):
    if inplace:
        def f(x, w, c):
            w[0] = x[0]
            w[1] = x[0] ** 2 * 1j
    else:
        def f(x, c):
            return x[0], x[0] ** 2 * 1j
    return mt.integrate(f, dof=[[1], [1]], neval=2 ** 15, niter=4, type=complex,
                        device="cpu", verbose=-2, seed=61, inplace=inplace,
                        var=mt.Continuous(0.0, 1.0))


@pytest.mark.parametrize("inplace", [False, True], ids=["complex2", "complex2_inplace"])
def test_two_complex_integrands(inplace):
    res = _complex2(inplace)
    for mean, err, exact in zip(res.mean, res.stdev, (0.5, 1j / 3)):
        assert _within(mean, exact, err + 1e-12 * (1 + 1j)), (res.mean, res.stdev)
    assert res.mean[0].imag == 0.0 and res.mean[1].real == 0.0


def _identity_case(cplx):
    var = mt.CompositeVar(mt.Continuous(0.0, 1.0), mt.Discrete(1, 4))

    def f(x, c):
        a, d = x
        w0 = torch.exp(-a[0]) * d[0].to(torch.float32)
        w1 = torch.cos(3.0 * a[1]) + a[0]
        return (w0 + 0j, w1 + 0j) if cplx else (w0, w1)
    return var, f


def test_real_integrand_plus_0j_reproduces_the_real_run():
    """One iteration from the same seeds, several integrands with padding
    and a Discrete pool: every statistic of the real run, bit for bit."""
    out = {}
    for cplx in (False, True):
        var, f = _identity_case(cplx)
        spec = Spec(mt.Configuration(var=var, dof=[[1], [2]], seed=2,
                                     type=complex if cplx else float), "cpu")
        it = VegasMCIteration(spec, f, block=4, nevalperblock=2 ** 12, nwalkers=256)
        out[cplx] = it.run(spec.device_params(), _kd(5, 4))
    real, cpx = out[False], out[True]
    assert np.array_equal(cpx["obs_blocks"].real, real["obs_blocks"])
    assert np.all(cpx["obs_blocks"].imag == 0.0)
    for key in ("norm_blocks", "visited", "propose", "accept"):
        assert np.array_equal(cpx[key], real[key]), key
    assert all(np.array_equal(a, b) for a, b in zip(cpx["hists"], real["hists"]))


def test_real_integrand_plus_0j_integrate():
    """The same over a run of ``integrate``: training and reweighting see
    bit-equal statistics."""
    res = {}
    for cplx in (False, True):
        var, f = _identity_case(cplx)
        res[cplx] = mt.integrate(f, var=var, dof=[[1], [2]], neval=2 ** 13, niter=3,
                                 type=complex if cplx else float, device="cpu", verbose=-2,
                                 seed=3)
    a, b = res[False], res[True]
    assert np.array_equal(a.config.reweight, b.config.reweight)
    assert np.array_equal(a.config.visited, b.config.visited)
    for (_, la), (_, lb) in zip(a.config.var_leaves(), b.config.var_leaves()):
        assert np.array_equal(la.histogram, lb.histogram)
        assert np.array_equal(getattr(la, "grid", la.histogram), getattr(lb, "grid", lb.histogram))
    for ma, mb in zip(a.mean, b.mean):
        assert mb.imag == 0.0 and abs(mb.real - ma) <= 1e-15 * abs(ma)


def _hand_layout(custom):
    """Two integrands of one Continuous slot, four walkers in one block."""
    spec = Spec(mt.Configuration(var=mt.Continuous(0.0, 1.0, ninc=4), dof=[[1], [1]], seed=1,
                                 type=complex), "cpu")
    ncomp = 2 * spec.N if not custom else 3
    lay = ck.ChainLayout.build(spec, 1, 4, ncomp, custom)
    st = ck.ChainState.zeros(lay)
    st.prp_prob[0] = torch.tensor([0.5, 1.0, 2.0, 4.0])
    st.prp_gidx[0] = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    st.prop.fill_(1.0)
    st.p.fill_(1e-30)                   # every proposal is accepted
    nw = torch.tensor([[3 + 4j, -5 + 12j, 0.25 - 0.5j, -1 + 0j],
                       [1j, 8 - 6j, 0j, 2 + 2j]], dtype=torch.complex64)
    rw = torch.tensor([0.5, 2.0, 0.25])
    return lay, st, nw, rw


@pytest.mark.parametrize("custom", [False, True], ids=["default", "custom"])
def test_chain_accept_plain_complex_by_hand(custom):
    lay, st, nw, rw = _hand_layout(custom)
    kd = torch.zeros((1, 2), dtype=torch.int32)
    ck.chain_accept_plain(lay, rw, kd, 1, st, nw, measure=True)
    assert torch.equal(st.w, nw) and int(st.ac.sum()) == 4
    # both integrands use the one slot; the normalization sector pads it
    prob = torch.tensor([0.5, 1.0, 2.0, 4.0])
    assert torch.equal(st.pad[:2], torch.ones((2, 4))) and torch.equal(st.pad[2], prob)
    # |w| = sqrt(re^2 + im^2) rounded once: 5, 13, sqrt(0.3125), 1; 1, 10, 0, sqrt(8)
    absw = torch.sqrt((nw.real.double() ** 2 + nw.imag.double() ** 2)).float()
    assert absw[0, 0] == 5.0 and absw[0, 1] == 13.0 and absw[1, 1] == 10.0
    p = rw[2] * prob + absw[0] * rw[0] + absw[1] * rw[1]     # float32, in integrand order
    assert torch.equal(st.p, p)
    assert torch.equal(st.vis[:2], (absw * rw[:2, None] / p).double())
    assert torch.equal(st.vis[2], (rw[2] * (prob / p)).double())
    assert torch.equal(st.nrm, (prob / p).double())
    # histogram: bin gidx of the slot takes sum_i |w_i|^2 / prob * pad_i / p
    want = sum(((nw[i].real ** 2 + nw[i].imag ** 2) / prob / p).double() for i in range(2))
    assert torch.allclose(st.hist[:4], want, rtol=1e-15)
    relw = [(nw[i].real * (1.0 / st.p), nw[i].imag * (1.0 / st.p)) for i in range(2)]
    if custom:
        assert st.relw.dtype == torch.complex64
        for i in range(2):
            assert torch.equal(st.relw[i].real, relw[i][0])
            assert torch.equal(st.relw[i].imag, relw[i][1])
        assert not st.obs.any()
    else:                           # Re w_i in component 2i, Im w_i in 2i + 1
        assert st.obs.shape == (4, 4)
        for i in range(2):
            assert torch.equal(st.obs[2 * i], relw[i][0].double())
            assert torch.equal(st.obs[2 * i + 1], relw[i][1].double())


def test_complex_measure_value_into_real_leaf_raises():
    """On a complex run a real observable leaf refuses complex values: the
    imaginary part would be dropped."""
    with pytest.raises(ValueError, match="declare it complex"):
        mt.integrate(_phase(torch), var=mt.Continuous(0.0, 1.0), dof=[[1]],
                     obs=[np.zeros(2)], measure=lambda v, relw, c: [torch.stack([relw[0]] * 2)],
                     neval=2 ** 12, niter=1, type=complex, device="cpu", verbose=-2)
