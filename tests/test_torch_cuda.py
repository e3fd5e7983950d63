"""PyTorch port: the CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (decided inside the
fixture, never at import).  Run on a machine with a card; ``--noconftest``
skips ``tests/conftest.py``, which sets up JAX (not needed here):

    python -m pytest tests/test_torch_cuda.py --noconftest -q -p no:randomly

``vegas_sample`` must match its plain version bit for bit; ``vegas_reduce``
forms the same float32 products and sums them in float64 in another order,
so obs and histograms agree to rel 1e-9.  ``chain_propose`` and
``chain_accept`` must match theirs bit for bit from one state, but for the
chain histogram (float64 atomics in another order: rel 1e-9).  The :mcmc
kernels ``mcmc_propose``, ``mcmc_accept`` and ``mcmc_measure`` match theirs
bit for bit, histograms included (they add exact 1.0s).  ``vplus_sample``
matches its plain version bit for bit; ``vplus_reduce`` forms the same float32
terms and sums them in float64 in another order (atomics), so obs, the
per-cube second moments and the histograms agree to rel 1e-12.
"""

import numpy as np
import pytest
import torch

import mcintegration_tpu_torch as mt
from mcintegration_tpu_torch.ops import (chain_kernels as ck, mcmc_kernels as mk,
                                         vegas_kernels as vk, vplus_kernels as vp)
from mcintegration_tpu_torch.ops.rng import block_keys
from mcintegration_tpu_torch.solvers.engine import Spec
from mcintegration_tpu_torch.solvers.mcmc import MCMCIteration
from mcintegration_tpu_torch.solvers.vegas import VegasIteration
from mcintegration_tpu_torch.solvers.vegasmc import VegasMCIteration
from mcintegration_tpu_torch.solvers.vegasplus import VegasPlusIteration

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _two(x, c):
    a, b = x
    return (a[0] * b[0], torch.where(a[0] ** 2 + b[1] ** 2 < 1.0, 1.0, 0.0))


@pytest.mark.parametrize("ninc,npb", [(1024, 2 ** 16), (1000, 2 ** 14), (64, 24576)])
def test_kernels_match_plain(cuda, ninc, npb):
    var = mt.Continuous([(0.0, 1.0), (0.0, 2.0)], ninc=ninc)
    for leaf in var:
        leaf.histogram = np.random.default_rng(ninc).gamma(0.5, 1.0, ninc) + 1e-3
        leaf.train()
    spec = Spec(mt.Configuration(var=var, dof=[[1], [2]], seed=3), cuda)
    it = VegasIteration(spec, _two, block=4, nevalperblock=npb)
    inputs = it.kernel_inputs(spec.device_params(), block_keys(3, 0, 0, 4))
    T = it.chunks_per_launch
    before = dict(vk.launch_counts)
    got = vk.vegas_sample(t0=1, T=T, m=it.m_tile, **inputs)
    want = vk.vegas_sample_plain(t0=1, T=T, m=it.m_tile, **inputs)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    x, invp, perm = got
    w = it.evaluate(it.leaf_values(x))
    masks = (it.pad, it.pair_slots, it.used)
    obs, hrow = vk.vegas_reduce(w, invp, perm, *masks)
    obs_p, hrow_p = vk.vegas_reduce_plain(w, invp, perm, *masks)
    torch.cuda.synchronize()
    torch.testing.assert_close(obs, obs_p, rtol=1e-9, atol=0)
    torch.testing.assert_close(hrow, hrow_p, rtol=1e-9, atol=0)
    assert vk.launch_counts["vegas_sample"] == before["vegas_sample"] + 1
    assert vk.launch_counts["vegas_reduce"] == before["vegas_reduce"] + 1


def test_cuda_run_reproduces_and_integrates(cuda):
    kw = dict(dof=[[2]], neval=2 ** 22, niter=4, solver="vegas", seed=5, verbose=-2,
              device="cuda")
    f = lambda x, c: torch.where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0)
    a = mt.integrate(f, var=mt.Continuous(0.0, 1.0), **kw)
    b = mt.integrate(f, var=mt.Continuous(0.0, 1.0), **kw)
    assert a.backend == "cuda"
    assert a.mean == b.mean and a.stdev == b.stdev
    assert abs(a.mean[0] - np.pi / 4) < 7 * a.stdev[0]


def _bits_equal(a, b):
    if a.dtype == torch.float64:
        return torch.equal(a.view(torch.int64), b.view(torch.int64))
    return torch.equal(a.view(torch.int32), b.view(torch.int32)) if a.dtype == torch.float32 \
        else torch.equal(a, b)


def _chain_two(x, c):
    a, b = x
    return (a[0] * b[0].to(torch.float32), torch.where(a[1] < 0.5, 1.0, 0.0) * (b[1] <= 20))


@pytest.mark.parametrize("ninc,lower,upper", [(1000, 1, 40), (8192, -3, 2000)],
                         ids=["shared-memory", "global-memory"])
def test_chain_kernels_match_plain(cuda, ninc, lower, upper):
    """The second case reads its Discrete CDF (nbin > 1024) and adds its
    histograms (more than 6144 bins) in device memory, not shared memory."""
    rng = np.random.default_rng(4)
    c, d = mt.Continuous(0.0, 1.0, ninc=ninc), mt.Discrete(lower, upper)
    for leaf in (c, d):
        leaf.histogram = rng.gamma(0.5, 1.0, leaf.nhist) + 1e-3
        leaf.train()
    spec = Spec(mt.Configuration(var=mt.CompositeVar(c, d), dof=[[1], [2]], seed=2), cuda)
    it = VegasMCIteration(spec, _chain_two, block=4, nevalperblock=2 ** 16, nwalkers=2 ** 14)
    kd = it.seeds(block_keys(2, 0, 0, 4))
    before = dict(ck.launch_counts)
    tab, rw, st = it.start(spec.device_params(), kd)
    for t in range(3):
        it.step(tab, rw, kd, st, t)
    ref = st.clone()
    ck.chain_propose(it.layout, tab, kd, 3, st)
    ck.chain_propose_plain(it.layout, tab, kd, 3, ref)
    nw = it.weights(st)
    ck.chain_accept(it.layout, rw, kd, 3, st, nw, measure=True)
    ck.chain_accept_plain(it.layout, rw, kd, 3, ref, nw, measure=True)
    torch.cuda.synchronize()
    for name in vars(st):
        a, b = getattr(st, name), getattr(ref, name)
        if name == "hist":
            torch.testing.assert_close(a, b, rtol=1e-9, atol=0)
        else:
            assert _bits_equal(a, b), name
    assert ck.launch_counts["chain_propose"] == before["chain_propose"] + 5
    assert ck.launch_counts["chain_accept"] == before["chain_accept"] + 5


def test_cuda_vegasmc_integrates(cuda):
    f = lambda x, c: torch.where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0)
    ck.reset_launch_counts()
    res = mt.integrate(f, var=mt.Continuous(0.0, 1.0), dof=[[2]], neval=2 ** 22, niter=4,
                       seed=5, verbose=-2, device="cuda")
    assert res.backend == "cuda"
    assert ck.launch_counts["chain_propose"] == ck.launch_counts["chain_accept"] > 4
    assert abs(res.mean[0] - np.pi / 4) < 7 * res.stdev[0]


def _mcmc_iteration(device, big):
    """Every branch of the :mcmc kernels: a trained map and a Discrete pool in
    a CompositeVar, FermiK pools in 3-D and 2-D, groups of two slots (swap),
    integrands of different dof and a custom measure.  ``big`` reads its
    Discrete CDF (2004 bins) and adds its histogram (8192 bins) and its 21
    sectors' tallies in device memory, not shared memory."""
    rng = np.random.default_rng(5)
    c = mt.Continuous(0.0, 1.0, ninc=8192 if big else 1000)
    d = mt.Discrete(-3, 2000) if big else mt.Discrete(1, 40)
    for leaf in (c, d):
        leaf.histogram = rng.gamma(0.5, 1.0, leaf.nhist) + 1e-3
        leaf.train()
    var = (mt.CompositeVar(c, d), mt.FermiK(3, 1.0, 0.3, 10.0), mt.FermiK(2, 1.0, 0.3, 10.0))
    dof = [[2, 1, 0], [1, 2, 1]] * (10 if big else 1)
    obs = [np.zeros(2)] * len(dof)

    def f(i, x, cc):
        (a, dd), k3, k2 = x
        w = a[0] * (1.0 + dd[0].to(torch.float32).abs() / 40.0)
        if i % 2 == 0:
            return w * torch.exp(-(k3[0] * k3[0]).sum(0))
        return w * torch.exp(-(k2[0] * k2[0]).sum(0) - (k3[1] * k3[1]).sum(0))

    def meas(i, x, relw, cc):
        out = [torch.zeros((2,) + relw.shape, device=relw.device)] * len(obs)
        out[i] = torch.stack([relw, relw * x[0][0][0]])
        return out

    spec = Spec(mt.Configuration(var=var, dof=dof, seed=2, obs=obs), device)
    return MCMCIteration(spec, f, measure=meas, obs_proto=obs, block=4, nevalperblock=2 ** 18,
                         nwalkers=2 ** 14, thermal_ratio=0.1)


@pytest.mark.parametrize("big", [False, True], ids=["shared-memory", "global-memory"])
def test_mcmc_kernels_match_plain(cuda, big):
    it = _mcmc_iteration(cuda, big)
    lay = it.layout
    assert (lay.smem_floats > 0, lay.nhist <= mk.SMEM_HIST_BINS,
            lay.counters <= mk.SMEM_COUNTERS) == (not big,) * 3
    kd_np = block_keys(2, 0, 0, it.block)
    sched, groups = it.schedule(kd_np)
    kd = it.seeds(kd_np)
    before = dict(mk.launch_counts)
    tab, rw, st = it.start(it.spec.device_params(), kd, sched)
    for t in range(3):
        it.step(tab, rw, kd, sched, groups[t], st, t)
    ref = st.clone()
    mk.mcmc_propose(lay, tab, kd, sched, 3, st)
    mk.mcmc_propose_plain(lay, tab, kd, sched, 3, ref)
    nw = it.weights(st, groups[3])
    mk.mcmc_accept(lay, tab, rw, kd, sched, 3, st, nw, measure=True)
    mk.mcmc_accept_plain(lay, tab, rw, kd, sched, 3, ref, nw, measure=True)
    m = it.measure[1](lay.leaf_values(st.cur_val), st.relw).contiguous()
    mk.mcmc_measure(lay, 1, m, st)
    mk.mcmc_measure_plain(lay, 1, m, ref)
    torch.cuda.synchronize()
    for name in vars(st):
        assert _bits_equal(getattr(st, name), getattr(ref, name)), name
    assert int(st.tally[1].sum()) > 0 and float(st.hist.sum()) > 0
    assert mk.launch_counts["mcmc_propose"] == before["mcmc_propose"] + 15
    assert mk.launch_counts["mcmc_accept"] == before["mcmc_accept"] + 15
    assert mk.launch_counts["mcmc_measure"] > before["mcmc_measure"]


def test_cuda_mcmc_integrates(cuda):
    f = lambda i, x, c: torch.where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0)
    mk.reset_launch_counts()
    res = mt.integrate(f, var=mt.Continuous(0.0, 1.0), dof=[[2]], neval=2 ** 22, niter=4,
                       solver="mcmc", seed=5, verbose=-2, device="cuda")
    assert res.backend == "cuda"
    assert mk.launch_counts["mcmc_propose"] == mk.launch_counts["mcmc_accept"] > 4
    assert abs(res.mean[0] - np.pi / 4) < 7 * res.stdev[0]


def _vplus_two(x, c):
    (t, d), u, v = x
    return (t[0] * (1.0 + u[0]) + 0.1,
            (t[0] + t[1]) * d[1].to(torch.float32) * torch.exp(-u[0] * v[0]) + 0.2)


@pytest.mark.parametrize("ninc,npb", [(1000, 2 ** 16), (6000, 3000)],
                         ids=["shared-memory", "global-memory"])
def test_vplus_kernels_match_plain(cuda, ninc, npb):
    """Two pools of different ninc, a Discrete passenger in a CompositeVar, a
    non-adaptive pool, two integrands with dof < maxdof, after one
    reallocation.  The second case adds its histogram (more than 4096 bins)
    in device memory, and its chunk is no multiple of the kernel's span."""
    rng = np.random.default_rng(6)
    a, b = mt.Continuous(0.0, 1.0, ninc=ninc), mt.Continuous(0.0, 2.0, ninc=64)
    d, e = mt.Discrete(1, 7), mt.Continuous(-1.0, 1.0, ninc=48, adapt=False)
    for leaf in (a, b, d):
        leaf.histogram = rng.gamma(0.5, 1.0, leaf.nhist) + 1e-3
        leaf.train()
    cfg = mt.Configuration(var=(mt.CompositeVar(a, d), b, e), dof=[[1, 1, 0], [2, 1, 1]], seed=3)
    spec = Spec(cfg, cuda)
    it = VegasPlusIteration(spec, _vplus_two, block=4, nevalperblock=npb, max_cubes=81)
    lay, params = it.layout, spec.device_params()
    assert (lay.nhist <= vp.SMEM_HIST_BINS) == (ninc == 1000)
    before = dict(vp.launch_counts)
    it.run(params, block_keys(3, 0, 0, 4))
    assert it.counts.max() > it.counts.min()
    tab, kd = lay.tables(params), it.seeds(block_keys(3, 1, 0, 4))
    cube, cfac = it.cube_tables()
    x, gidx = vp.vplus_sample(lay, tab, kd, 1, 2, cube)
    xp, gidxp = vp.vplus_sample_plain(lay, tab, kd, 1, 2, cube)
    assert torch.equal(x.view(torch.int32), xp.view(torch.int32)) and torch.equal(gidx, gidxp)
    w = it.evaluate(lay.leaf_values(x)).contiguous()
    got = vp.vplus_reduce(lay, tab, w, gidx, cube, cfac)
    want = vp.vplus_reduce_plain(lay, tab, w, gidx, cube, cfac)
    torch.cuda.synchronize()
    for g, p in zip(got, want):
        torch.testing.assert_close(g, p, rtol=1e-12, atol=0)
    assert float(got[1].sum()) > 0 and float(got[2].sum()) > 0
    n = it.launches_per_run + 1
    assert vp.launch_counts == {"vplus_sample": before["vplus_sample"] + n,
                                "vplus_reduce": before["vplus_reduce"] + n}


def test_cuda_vegasplus_integrates(cuda):
    f = lambda x, c: torch.where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0)
    vp.reset_launch_counts()
    res = mt.integrate(f, var=mt.Continuous(0.0, 1.0), dof=[[2]], neval=2 ** 22, niter=4,
                       solver="vegasplus", seed=5, verbose=-2, device="cuda")
    assert res.backend == "cuda"
    assert vp.launch_counts["vplus_sample"] == vp.launch_counts["vplus_reduce"] >= 4
    assert abs(res.mean[0] - np.pi / 4) < 7 * res.stdev[0]
