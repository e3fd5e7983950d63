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
bit for bit, histograms included (they add exact 1.0s); ``mcmc_measure``
takes every sector in one launch, up to ``MAX_SECTORS``.  ``vplus_sample``
matches its plain version bit for bit; ``vplus_reduce`` forms the same float32
terms and sums them in float64 in another order (atomics), so obs, the
per-cube second moments and the histograms agree to rel 1e-12.  With a
custom measure, ``chain_accept`` writing ``relw``, ``chain_measure`` and
``vegas_relw`` match theirs bit for bit, and ``vegas_reduce`` given the
measure's output ``m`` to rel 1e-9.  With complex weights (``type=complex``)
``chain_accept_complex`` and ``mcmc_accept_complex`` match their plain
versions bit for bit, both parts of every complex field included (the chain
histogram to rel 1e-9).
"""

import importlib.util
from pathlib import Path

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


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = _chip_smoke()      # the edge shapes and inputs its phases 3, 3b and 3d check


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
    if a.dtype == torch.complex64:
        a, b = torch.view_as_real(a), torch.view_as_real(b)
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


def _mcmc_iteration(device, big, cplx=False, custom=True):
    """Every branch of the :mcmc kernels: a trained map and a Discrete pool in
    a CompositeVar, FermiK pools in 3-D and 2-D, groups of two slots (swap),
    integrands of different dof and a custom measure (or, without
    ``custom``, the default one).  ``big`` adds its histograms (10196 bins)
    and its 21 sectors' tallies in device memory, not shared memory;
    ``cplx`` multiplies each integrand by a phase (complex weights and
    observables)."""
    rng = np.random.default_rng(5)
    c = mt.Continuous(0.0, 1.0, ninc=8192 if big else 1000)
    d = mt.Discrete(-3, 2000) if big else mt.Discrete(1, 40)
    for leaf in (c, d):
        leaf.histogram = rng.gamma(0.5, 1.0, leaf.nhist) + 1e-3
        leaf.train()
    var = (mt.CompositeVar(c, d), mt.FermiK(3, 1.0, 0.3, 10.0), mt.FermiK(2, 1.0, 0.3, 10.0))
    dof = [[2, 1, 0], [1, 2, 1]] * (10 if big else 1)
    obs = [np.zeros(2, complex if cplx else float)] * len(dof)

    def f(i, x, cc):
        (a, dd), k3, k2 = x
        w = a[0] * (1.0 + dd[0].to(torch.float32).abs() / 40.0)
        if i % 2 == 0:
            w = w * torch.exp(-(k3[0] * k3[0]).sum(0))
        else:
            w = w * torch.exp(-(k2[0] * k2[0]).sum(0) - (k3[1] * k3[1]).sum(0))
        return w * torch.exp(1j * (4.0 * a[0] + k3[0][0])) if cplx else w

    def meas(i, x, relw, cc):
        out = [torch.zeros((2,) + relw.shape, device=relw.device)] * len(obs)
        out[i] = torch.stack([relw, relw * x[0][0][0]])
        return out

    spec = Spec(mt.Configuration(var=var, dof=dof, seed=2, obs=obs,
                                 type=complex if cplx else float), device)
    kw = dict(measure=meas, obs_proto=obs) if custom else {}
    return MCMCIteration(spec, f, block=4, nevalperblock=2 ** 18, nwalkers=2 ** 14,
                         thermal_ratio=0.1, **kw)


def _bubble_iteration(device):
    """The Lindhard bubble's shape (chip_smoke.py phase 4c): N = 1, a
    Continuous leaf of 1024 bins (its histogram), a 3-D FermiK shell,
    Discrete(1, 4, adapt=False), dof [[1, 1, 1]] and a custom measure into
    four bins; almost every walker of a warp counts into the same counter."""
    var = (mt.Continuous(0.0, 2.0, alpha=3.0), mt.FermiK(3, 1.0, 0.2, 10.0),
           mt.Discrete(1, 4, adapt=False))
    obs = [np.zeros(4)]

    def f(i, x, cc):
        t, k, e = x
        return torch.exp(-t[0] - (k[0] * k[0]).sum(0)) * e[0].to(torch.float32)

    def meas(i, x, relw, cc):
        return [mt.onehot(x[-1][0], 1, 4, relw.dtype, like=relw) * relw]

    spec = Spec(mt.Configuration(var=var, dof=[[1, 1, 1]], seed=3, obs=obs), device)
    return MCMCIteration(spec, f, measure=meas, obs_proto=obs, block=4, nevalperblock=2 ** 18,
                         nwalkers=2 ** 14, thermal_ratio=0.5)


@pytest.mark.parametrize("case", ["shared-memory", "global-memory", "bubble"])
def test_mcmc_kernels_match_plain(cuda, case):
    """One measured and one unmeasured step from the same state, every field
    bit-equal; ``mcmc_accept`` counts and bins in shared memory, or (the
    global-memory case) in device memory."""
    it = _bubble_iteration(cuda) if case == "bubble" else _mcmc_iteration(
        cuda, case == "global-memory")
    lay = it.layout
    assert (lay.hist_smem, lay.cnt_smem) == ((case != "global-memory"),) * 2
    kd_np = block_keys(2, 0, 0, it.block)
    sched, groups = it.schedule(kd_np)
    kd = it.seeds(kd_np)
    before = dict(mk.launch_counts)
    tab, rw, st = it.start(it.spec.device_params(), kd, sched)
    for t in range(3):
        it.step(tab, rw, kd, sched, groups[t], st, t)
    for t, measure in ((3, True), (4, False)):
        ref = st.clone()
        mk.mcmc_propose(lay, tab, kd, sched, t, st)
        mk.mcmc_propose_plain(lay, tab, kd, sched, t, ref)
        nw = it.weights(st, groups[t])
        mk.mcmc_accept(lay, tab, rw, kd, sched, t, st, nw, measure=measure)
        mk.mcmc_accept_plain(lay, tab, rw, kd, sched, t, ref, nw, measure=measure)
        if measure:
            vals = lay.leaf_values(st.cur_val)
            ms = [m(vals, st.relw).contiguous() for m in it.measure]
            mk.mcmc_measure(lay, ms, st)
            mk.mcmc_measure_plain(lay, ms, ref)
        torch.cuda.synchronize()
        for name in vars(st):
            assert _bits_equal(getattr(st, name), getattr(ref, name)), (t, name)
    assert int(st.tally[1].sum()) > 0 and float(st.hist.sum()) > 0
    assert mk.launch_counts["mcmc_propose"] == before["mcmc_propose"] + 16
    assert mk.launch_counts["mcmc_accept"] == before["mcmc_accept"] + 16
    assert mk.launch_counts["mcmc_measure"] > before["mcmc_measure"]


@pytest.mark.parametrize("case", ["bubble", "phase 3c's spec"])
def test_mcmc_measure_one_launch_per_measured_step(cuda, case):
    """mcmc_measure bit-equal to its plain version on a measured step of one
    sector (the bubble's layout) and of two (phase 3c's spec at 2^20
    walkers), one launch each, and one launch per measured step over a
    whole iteration."""
    it = _bubble_iteration(cuda) if case == "bubble" else cs.mcmc_allbranch(mt, 2 ** 20)
    kd_np = block_keys(2, 0, 0, it.block)
    sched, groups = it.schedule(kd_np)
    kd = it.seeds(kd_np)
    tab, rw, st = it.start(it.spec.device_params(), kd, sched)
    for t in range(8):
        it.step(tab, rw, kd, sched, groups[t], st, t)
    before = mk.launch_counts["mcmc_measure"]
    errs = cs.mcmc_one_step(it, mk, st, tab, rw, kd, sched, groups[8], 8, case)
    assert errs[2] == 0.0 and mk.launch_counts["mcmc_measure"] == before + 1
    before = mk.launch_counts["mcmc_measure"]
    it.run(it.spec.device_params(), block_keys(2, 1, 0, it.block))
    assert mk.launch_counts["mcmc_measure"] - before == it.nsteps


def test_mcmc_measure_over_more_sectors_than_a_launch_takes(cuda):
    """MAX_SECTORS + 1 sectors: two launches, bit-equal to the plain version."""
    err, launches = cs.measure_many_sectors(mt, mk)
    assert err == 0.0 and launches == 2


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
    it.reallocate(it.run(params, block_keys(3, 0, 0, 4))["sig"])
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
    assert vp.launch_counts == {**before, "vplus_sample": before["vplus_sample"] + n,
                                "vplus_reduce": before["vplus_reduce"] + n}


def test_cuda_vegasplus_integrates(cuda):
    f = lambda x, c: torch.where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0)
    vp.reset_launch_counts()
    res = mt.integrate(f, var=mt.Continuous(0.0, 1.0), dof=[[2]], neval=2 ** 22, niter=4,
                       solver="vegasplus", seed=5, verbose=-2, device="cuda")
    assert res.backend == "cuda"
    assert vp.launch_counts["vplus_sample"] == vp.launch_counts["vplus_reduce"] >= 4
    assert abs(res.mean[0] - np.pi / 4) < 7 * res.stdev[0]


def _qs(device, nbin):
    """The quickstart's histogram (examples/quickstart.py:71-91), its
    measure written to broadcast over a batch."""
    def f(v, c):
        x, y = v
        return x[0] ** 2 + y[0] ** 2

    def measure(v, relw, c):
        x, _ = v
        b = torch.clamp((x[0] * nbin).to(torch.int32), 0, nbin - 1)
        bins = torch.arange(nbin, device=b.device).reshape((nbin,) + (1,) * b.ndim)
        return [(bins == b).to(relw.dtype) * relw[0] * nbin]

    cfg = mt.Configuration(var=(mt.Continuous(0.0, 1.0), mt.Continuous(0.0, 1.0)),
                           dof=[[1, 1]], obs=[np.zeros(nbin)], seed=6)
    return Spec(cfg, device), f, measure


@pytest.mark.parametrize("nbin", [10, 64])
def test_chain_measure_kernels_match_plain(cuda, nbin):
    """chain_accept writing relw and chain_measure, from one state, bit for
    bit (the histogram to rel 1e-9)."""
    spec, f, measure = _qs(cuda, nbin)
    it = VegasMCIteration(spec, f, measure=measure, obs_proto=spec.cfg.observable, block=4,
                          nevalperblock=2 ** 16, nwalkers=2 ** 14)
    kd = it.seeds(block_keys(6, 0, 0, 4))
    tab, rw, st = it.start(spec.device_params(), kd)
    for t in range(3):
        it.step(tab, rw, kd, st, t)
    ck.chain_propose(it.layout, tab, kd, 3, st)
    ref = st.clone()
    nw = it.weights(st)
    before = dict(ck.launch_counts)
    ck.chain_accept(it.layout, rw, kd, 3, st, nw, measure=True)
    ck.chain_accept_plain(it.layout, rw, kd, 3, ref, nw, measure=True)
    m = it.measure(it.leaf_values(st.cur_val), st.relw).contiguous()
    ck.chain_measure(it.layout, m, st)
    ck.chain_measure_plain(it.layout, m, ref)
    torch.cuda.synchronize()
    for name in vars(st):
        a, b = getattr(st, name), getattr(ref, name)
        if name == "hist":
            torch.testing.assert_close(a, b, rtol=1e-9, atol=0)
        else:
            assert _bits_equal(a, b), name
    assert st.obs.abs().sum() > 0
    assert ck.launch_counts["chain_accept"] == before["chain_accept"] + 1
    assert ck.launch_counts["chain_measure"] == before["chain_measure"] + 1


def test_vegas_measure_kernels_match_plain(cuda):
    """vegas_relw bit for bit; vegas_reduce given m to rel 1e-9; given m =
    relw[:1], the default sums bit for bit."""
    spec, f, measure = _qs(cuda, 10)
    it = VegasIteration(spec, f, measure=measure, obs_proto=spec.cfg.observable, block=4,
                        nevalperblock=2 ** 16)
    inputs = it.kernel_inputs(spec.device_params(), block_keys(6, 0, 0, 4))
    x, invp, perm = vk.vegas_sample(t0=0, T=it.chunks_per_launch, m=it.m_tile, **inputs)
    w = it.evaluate(it.leaf_values(x)).contiguous()
    before = dict(vk.launch_counts)
    relw = vk.vegas_relw(w, invp, it.pad, it.pair_slots)
    relw_p = vk.vegas_relw_plain(w, invp, it.pad, it.pair_slots)
    masks = (it.pad, it.pair_slots, it.used)
    m = it.measure(it.leaf_values(x), relw).contiguous()
    obs, hrow = vk.vegas_reduce(w, invp, perm, *masks, m)
    obs_p, hrow_p = vk.vegas_reduce_plain(w, invp, perm, *masks, m)
    obs_i, hrow_i = vk.vegas_reduce(w, invp, perm, *masks, relw[:1].contiguous())
    obs_d, hrow_d = vk.vegas_reduce(w, invp, perm, *masks)
    torch.cuda.synchronize()
    assert _bits_equal(relw, relw_p)
    torch.testing.assert_close(obs, obs_p, rtol=1e-9, atol=0)
    torch.testing.assert_close(hrow, hrow_p, rtol=1e-9, atol=0)
    assert _bits_equal(obs_i, obs_d) and _bits_equal(hrow_i, hrow_d)
    assert vk.launch_counts["vegas_relw"] == before["vegas_relw"] + 1
    assert vk.launch_counts["vegas_reduce_measure"] == before["vegas_reduce_measure"] + 2
    assert vk.launch_counts["vegas_reduce"] == before["vegas_reduce"] + 1


@pytest.mark.parametrize("solver", ["vegas", "vegasmc"])
def test_cuda_measure_integrates(cuda, solver):
    """Every bin of the quickstart's histogram within 7 sigma of its exact
    value, the mean of x^2 + 1/3 over the bin."""
    spec, f, measure = _qs(cuda, 10)
    vk.reset_launch_counts()
    ck.reset_launch_counts()
    res = mt.integrate(f, config=spec.cfg, measure=measure, neval=2 ** 22, niter=4,
                       solver=solver, verbose=-2, device="cuda")
    assert res.backend == "cuda" and res.backend_reason == ""
    if solver == "vegas":
        assert vk.launch_counts["vegas_relw"] == vk.launch_counts["vegas_reduce_measure"] >= 4
    else:
        assert ck.launch_counts["chain_measure"] > 4
    a = np.arange(10) / 10
    exact = a * a + a / 10 + 1 / 300 + 1 / 3
    mean, std = np.asarray(res.mean[0]), np.asarray(res.stdev[0])
    assert np.all(np.abs(mean - exact) < 7 * std), (mean - exact) / std


def _chain_two_complex(x, c):
    a, _ = x
    w0, w1 = _chain_two(x, c)
    return w0 * torch.exp(3j * a[0]), w1 * torch.exp(-2j * a[1])


def _phase_measure(v, relw, c):
    return [mt.onehot(v[1][0], 1, 3, relw.dtype) * relw[0]]


@pytest.mark.parametrize("mode", ["measured", "unmeasured", "custom"])
def test_chain_accept_complex_matches_plain(cuda, mode):
    """chain_accept_complex from one state: two integrands with a phase
    each (the default measure, on a measured and an unmeasured step), or a
    complex one-hot measure over Discrete(1, 3) (relw written, then
    chain_measure), every field bit for bit (the histogram to rel 1e-9)."""
    if mode == "custom":
        obs = [np.zeros(3, np.complex64)]
        spec = Spec(mt.Configuration(var=(mt.Continuous(0.0, 1.0), mt.Discrete(1, 3)),
                                     dof=[[1, 1]], obs=obs, type=complex, seed=3), cuda)
        it = VegasMCIteration(spec, lambda x, c: torch.exp(1j * x[0][0]), measure=_phase_measure,
                              obs_proto=obs, block=4, nevalperblock=2 ** 16, nwalkers=2 ** 14)
    else:
        var = mt.CompositeVar(mt.Continuous(0.0, 1.0, ninc=1000), mt.Discrete(1, 40))
        spec = Spec(mt.Configuration(var=var, dof=[[1], [2]], seed=2, type=complex), cuda)
        it = VegasMCIteration(spec, _chain_two_complex, block=4, nevalperblock=2 ** 16,
                              nwalkers=2 ** 14)
    assert it.spec.cplx and it.backend_reason == ""
    kd = it.seeds(block_keys(2, 0, 0, 4))
    tab, rw, st = it.start(spec.device_params(), kd)
    for t in range(3):
        it.step(tab, rw, kd, st, t)
    ck.chain_propose(it.layout, tab, kd, 3, st)
    ref = st.clone()
    nw = it.weights(st)
    assert nw.dtype == torch.complex64
    before = dict(ck.launch_counts)
    measure = mode != "unmeasured"
    ck.chain_accept(it.layout, rw, kd, 3, st, nw, measure=measure)
    ck.chain_accept_plain(it.layout, rw, kd, 3, ref, nw, measure=measure)
    if mode == "custom":
        m = it.measure(it.leaf_values(st.cur_val), st.relw).contiguous()
        ck.chain_measure(it.layout, m, st)
        ck.chain_measure_plain(it.layout, m, ref)
    torch.cuda.synchronize()
    for name in vars(st):
        a, b = getattr(st, name), getattr(ref, name)
        if name == "hist":
            torch.testing.assert_close(a, b, rtol=1e-9, atol=0)
        else:
            assert _bits_equal(a, b), name
    assert ck.launch_counts["chain_accept_complex"] == before["chain_accept_complex"] + 1
    assert ck.launch_counts["chain_accept"] == before["chain_accept"]


@pytest.mark.parametrize("custom", [False, True], ids=["default", "custom"])
def test_mcmc_accept_complex_matches_plain(cuda, custom):
    """mcmc_accept_complex on every branch of the :mcmc kernels with a
    phase on each integrand: one measured and one unmeasured step from the
    same state, with the default measure or a complex custom one, every
    field bit for bit."""
    it = _mcmc_iteration(cuda, False, cplx=True, custom=custom)
    lay = it.layout
    assert lay.spec.cplx and it.backend_reason == ""
    kd_np = block_keys(2, 0, 0, it.block)
    sched, groups = it.schedule(kd_np)
    kd = it.seeds(kd_np)
    tab, rw, st = it.start(it.spec.device_params(), kd, sched)
    for t in range(3):
        it.step(tab, rw, kd, sched, groups[t], st, t)
    before = dict(mk.launch_counts)
    for t, measure in ((3, True), (4, False)):
        ref = st.clone()
        mk.mcmc_propose(lay, tab, kd, sched, t, st)
        mk.mcmc_propose_plain(lay, tab, kd, sched, t, ref)
        nw = it.weights(st, groups[t])
        assert nw.dtype == torch.complex64
        mk.mcmc_accept(lay, tab, rw, kd, sched, t, st, nw, measure=measure)
        mk.mcmc_accept_plain(lay, tab, rw, kd, sched, t, ref, nw, measure=measure)
        torch.cuda.synchronize()
        for name in vars(st):
            assert _bits_equal(getattr(st, name), getattr(ref, name)), (t, name)
    assert int(st.tally[1].sum()) > 0
    assert bool(st.relw.abs().sum() > 0) if custom else bool(st.obs.any())
    assert mk.launch_counts["mcmc_accept_complex"] == before["mcmc_accept_complex"] + 2
    assert mk.launch_counts["mcmc_accept"] == before["mcmc_accept"]


@pytest.mark.parametrize("solver", ["vegasmc", "mcmc"])
def test_cuda_complex_integrates(cuda, solver):
    """e^{i(x+y)} over [0, 1)^2 with type=complex through the complex
    kernels: the real and imaginary parts within 7 sigma of (sin 1 + i(1 -
    cos 1))^2."""
    exact = (np.sin(1.0) + 1j * (1.0 - np.cos(1.0))) ** 2
    f = lambda x, c: torch.exp(1j * (x[0] + x[1]))
    mod, key = (ck, "chain_accept_complex") if solver == "vegasmc" else (mk, "mcmc_accept_complex")
    mod.reset_launch_counts()
    res = mt.integrate(f if solver == "vegasmc" else (lambda i, x, c: f(x, c)),
                       var=mt.Continuous(0.0, 1.0), dof=[[2]], neval=2 ** 22, niter=4,
                       solver=solver, type=complex, seed=5, verbose=-2, device="cuda")
    assert res.backend == "cuda" and mod.launch_counts[key] > 4
    assert mod.launch_counts[key.replace("_complex", "")] == 0
    m, e = res.mean[0], res.stdev[0]
    assert abs(m.real - exact.real) < 7 * e.real and abs(m.imag - exact.imag) < 7 * e.imag


def _chain_case(device, mode, ninc):
    """A VegasMCIteration on one Continuous(ninc) pool of two slots (two
    slots of two pools with a measure, which bins the first): ``mode`` real, relw (the
    quickstart's histogram as a custom measure), complex (a phase, the
    default measure) or complex relw (a complex one-hot measure)."""
    kw = dict(block=4, nevalperblock=2 ** 16, nwalkers=2 ** 14)
    cplx = mode.startswith("complex")
    f = (lambda x, c: torch.exp(1j * (x[0] + x[1]))) if cplx else \
        (lambda x, c: torch.where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0))
    if not mode.endswith("relw"):
        cfg = mt.Configuration(var=mt.Continuous(0.0, 1.0, ninc=ninc), dof=[[2]], seed=7,
                               type=complex if cplx else float)
        return VegasMCIteration(Spec(cfg, device), f, **kw)
    if not cplx:
        spec, g, measure = _qs(device, 10)
        leaves = [mt.Continuous(0.0, 1.0, ninc=ninc), mt.Continuous(0.0, 1.0, ninc=ninc)]
        cfg = mt.Configuration(var=tuple(leaves), dof=[[1, 1]], obs=[np.zeros(10)], seed=7)
        return VegasMCIteration(Spec(cfg, device), g, measure=measure, obs_proto=cfg.observable,
                                **kw)
    obs = [np.zeros(3, np.complex64)]
    cfg = mt.Configuration(var=(mt.Continuous(0.0, 1.0, ninc=ninc), mt.Discrete(1, 3)),
                           dof=[[1, 1]], obs=obs, type=complex, seed=7)
    return VegasMCIteration(Spec(cfg, device), lambda x, c: torch.exp(1j * x[0][0]),
                            measure=_phase_measure, obs_proto=obs, **kw)


def _chain_accept_vs_plain(it, hot):
    """One measured chain_accept from the state after three steps and a
    proposal, against the plain version: every field bit for bit, the
    histogram to rel 1e-9.  With ``hot`` every slot of every walker, in
    both copies, sits in bin 0 of its leaf first, and the histogram starts
    from 0."""
    kd = it.seeds(block_keys(7, 0, 0, 4))
    tab, rw, st = it.start(it.spec.device_params(), kd)
    for t in range(3):
        it.step(tab, rw, kd, st, t)
    ck.chain_propose(it.layout, tab, kd, 3, st)
    if hot:
        st.cur_gidx.zero_()
        st.prp_gidx.zero_()
        st.hist.zero_()
    ref = st.clone()
    nw = it.weights(st)
    name = "chain_accept_complex" if it.spec.cplx else "chain_accept"
    before = ck.launch_counts[name]
    ck.chain_accept(it.layout, rw, kd, 3, st, nw, measure=True)
    ck.chain_accept_plain(it.layout, rw, kd, 3, ref, nw, measure=True)
    if it.measure is not None:
        m = it.measure(it.leaf_values(st.cur_val), st.relw).contiguous()
        ck.chain_measure(it.layout, m, st)
        ck.chain_measure_plain(it.layout, m, ref)
    torch.cuda.synchronize()
    for field in vars(st):
        a, b = getattr(st, field), getattr(ref, field)
        if field == "hist":
            torch.testing.assert_close(a, b, rtol=1e-9, atol=0)
        else:
            assert _bits_equal(a, b), field
    assert float(st.hist.sum()) > 0
    if hot:   # every add went to bin 0 of a leaf's histogram
        offsets = {int(off) for off in it.layout.leaf[:, 6] if off >= 0}
        assert set(torch.nonzero(st.hist).flatten().tolist()) <= offsets
    assert ck.launch_counts[name] == before + 1


@pytest.mark.parametrize("hot", [False, True], ids=["spread", "one-bin"])
@pytest.mark.parametrize("ninc", [500, 8000])
@pytest.mark.parametrize("mode", ["real", "relw", "complex", "complex relw"])
def test_chain_accept_histogram_paths(cuda, mode, ninc, hot):
    """chain_accept in each mode with its histogram in shared memory and in
    device memory (more than SMEM_HIST_BINS bins), its walkers' bins spread
    or every walker in one bin."""
    it = _chain_case(cuda, mode, ninc)
    assert (it.layout.nhist <= ck.SMEM_HIST_BINS) == (ninc == 500)
    _chain_accept_vs_plain(it, hot)


def test_chain_accept_beyond_register_cache(cuda):
    """Six integrands of one to six slots of one pool: more (group, slot)
    pairs and pads than the kernel keeps in registers, so it forms the
    others again, bit for bit."""
    def f(x, c):
        return tuple(torch.exp(-x[:k].sum(0)) for k in range(1, 7))

    for cplx in (False, True):
        cfg = mt.Configuration(var=mt.Continuous(0.0, 1.0, ninc=64),
                               dof=[[k] for k in range(1, 7)], seed=8,
                               type=complex if cplx else float)
        g = (lambda x, c: tuple(w * torch.exp(1j * x[0]) for w in f(x, c))) if cplx else f
        it = VegasMCIteration(Spec(cfg, cuda), g, block=4, nevalperblock=2 ** 16,
                              nwalkers=2 ** 14)
        assert it.layout.spec.N + 1 > 4 and it.layout.S > 4
        _chain_accept_vs_plain(it, hot=False)


@pytest.mark.parametrize("hot", [False, True], ids=["spread", "one-bin"])
@pytest.mark.parametrize("memory", ["shared", "device", "all-branch beyond SMEM_HIST_BINS"])
def test_vplus_reduce_histogram_paths(cuda, memory, hot):
    """vplus_reduce with its histogram whole in shared memory, and beyond
    SMEM_HIST_BINS bins (added in windows of that many), after one
    reallocation; the last case is phase 3d's all-branch spec with
    ninc=5000 at its launch shape, at 3 seeds; with ``hot`` every sample of
    the first span of each chunk in bin 0 of each slot."""
    if memory.startswith("all-branch"):
        its = [(cs.vplus_allbranch(mt, 2 ** 20, ninc=5000, device=cuda), seed)
               for seed in (9, 10, 11)]
    else:
        ninc = 1000 if memory == "shared" else 5000
        f = lambda x, c: 1.0 / (1.0 + 10.0 * (x[0] * x[1] + x[2]))
        cfg = mt.Configuration(var=mt.Continuous(0.0, 1.0, ninc=ninc), dof=[[3]], seed=9)
        its = [(VegasPlusIteration(Spec(cfg, cuda), f, block=4, nevalperblock=2 ** 16), 9)]
    for it, seed in its:
        lay, params = it.layout, it.spec.device_params()
        assert (lay.nhist <= vp.SMEM_HIST_BINS) == (memory == "shared")
        it.run(params, block_keys(seed, 0, 0, it.block))
        tab, kd = lay.tables(params), it.seeds(block_keys(seed, 1, 0, it.block))
        cube, cfac = it.cube_tables()
        x, gidx = vp.vplus_sample(lay, tab, kd, 0, it.chunks_per_launch, cube)
        w = it.evaluate(lay.leaf_values(x)).contiguous()
        if hot:
            gidx[..., :vp.SPAN] = 0
        before = vp.launch_counts["vplus_reduce"]
        got = vp.vplus_reduce(lay, tab, w, gidx, cube, cfac)
        want = vp.vplus_reduce_plain(lay, tab, w, gidx, cube, cfac)
        torch.cuda.synchronize()
        for g, p in zip(got, want):
            torch.testing.assert_close(g, p, rtol=1e-12, atol=0)
        assert float(got[1].sum()) > 0 and float(got[2].sum()) > 0
        assert vp.launch_counts["vplus_reduce"] == before + 1




def _reduce_vs_plain(args, mobs):
    """vegas_reduce in both modes against its plain version (rel 1e-9); the
    identity measure m = relw (from vegas_relw) bit-equal to the default
    sums; two calls bit-equal."""
    w, invp, perm, pad, pair_slots, used = args
    before = dict(vk.launch_counts)
    got = vk.vegas_reduce(*args)
    again = vk.vegas_reduce(*args)
    got_m = vk.vegas_reduce(*args, mobs)
    relw = vk.vegas_relw(w, invp, pad, pair_slots)
    ident = vk.vegas_reduce(*args, relw)
    want, want_m = vk.vegas_reduce_plain(*args), vk.vegas_reduce_plain(*args, mobs)
    torch.cuda.synchronize()
    for g, p in (*zip(got, want), *zip(got_m, want_m)):
        torch.testing.assert_close(g, p, rtol=1e-9, atol=0)
    for a, b in (*zip(got, again), *zip(got, ident)):
        assert _bits_equal(a, b)
    assert vk.launch_counts["vegas_reduce"] == before["vegas_reduce"] + 2
    assert vk.launch_counts["vegas_reduce_measure"] == before["vegas_reduce_measure"] + 2


@pytest.mark.parametrize("ncomp", [1, 10, 64])
@pytest.mark.parametrize("N", [1, 3, 300])
@pytest.mark.parametrize("m", [1, 3, 100, 1024])
def test_vegas_reduce_shapes(cuda, m, N, ncomp):
    """vegas_reduce at short rows (scalar loads, several columns a warp) and
    long ones (16-byte loads, a warp a column), with one integrand and with
    several (300 leave fewer rows a tile than the warps could take)."""
    _reduce_vs_plain(*cs.reduce_inputs(m, N, ncomp, device=cuda))


def test_vegas_reduce_most_integrands(cuda):
    """MAX_INTEGRANDS integrands: one row a tile."""
    _reduce_vs_plain(*cs.reduce_inputs(5, vk.MAX_INTEGRANDS, 3, 1, 2, 5, device=cuda))


@pytest.mark.parametrize("k", range(len(cs.VPLUS_EDGES)), ids=[e[0] for e in cs.VPLUS_EDGES])
def test_vplus_sample_shapes(cuda, k):
    """vplus_sample bit-equal to its plain version after one reallocation
    (chip_smoke.VPLUS_EDGES): 1 to 6 slots, chunks that are and are not a
    multiple of 4, a Discrete
    passenger, nstrat from 1 to 5000; two calls bit-equal."""
    _, var, dof, nstrat, npb = cs.VPLUS_EDGES[k]
    cfg = mt.Configuration(var=var(mt), dof=dof, seed=8)
    it = VegasPlusIteration(Spec(cfg, cuda), cs._first, block=3, nevalperblock=npb,
                            nstrat=nstrat)
    lay, params = it.layout, it.spec.device_params()
    assert it.nstrat == nstrat and lay.S == sum(map(sum, dof))
    it.run(params, block_keys(8, 0, 0, 3))
    tab, kd = lay.tables(params), it.seeds(block_keys(8, 1, 0, 3))
    cube, _ = it.cube_tables()
    before = vp.launch_counts["vplus_sample"]
    x, gidx = vp.vplus_sample(lay, tab, kd, 1, 2, cube)
    x2, gidx2 = vp.vplus_sample(lay, tab, kd, 1, 2, cube)
    xp, gidxp = vp.vplus_sample_plain(lay, tab, kd, 1, 2, cube)
    torch.cuda.synchronize()
    assert _bits_equal(x, xp) and torch.equal(gidx, gidxp)
    assert _bits_equal(x, x2) and torch.equal(gidx, gidx2)
    assert vp.launch_counts["vplus_sample"] == before + 2


@pytest.mark.parametrize("k", range(len(cs.VEGAS_EDGES)), ids=[e[0] for e in cs.VEGAS_EDGES])
def test_vegas_sample_shapes(cuda, k):
    """vegas_sample bit-equal to its plain version (chip_smoke.VEGAS_EDGES):
    one stratum, 7 and 32768 strata, m with scalar draws and with quads
    (the main path's 1024), slots on two leaves, t0 > 0 and T > 1; two
    calls bit-equal."""
    before = vk.launch_counts["vegas_sample"]
    cs.vegas_sample_edge(mt, vk, cs.VEGAS_EDGES[k], device=cuda)
    assert vk.launch_counts["vegas_sample"] == before + 2


@pytest.mark.parametrize("k", range(len(cs.PROPOSE_EDGES)),
                         ids=[e[0] for e in cs.PROPOSE_EDGES])
def test_chain_propose_shapes(cuda, k):
    """chain_propose bit-equal to its plain version (chip_smoke.PROPOSE_EDGES)
    with init = 1 and on a step: a Discrete CDF staged and one searched in
    device memory, groups of different maxdof with fewer eligible groups
    than pools, and Monte Carlo blocks and walker counts that are not a
    multiple of the kernel's thread blocks."""
    ck.reset_launch_counts()
    cs.chain_propose_edge(mt, ck, cs.PROPOSE_EDGES[k], device=cuda)
    assert ck.launch_counts["chain_propose"] == 5     # init, start, two steps, the step


@pytest.mark.parametrize("mf", [1, 4])
@pytest.mark.parametrize("m", [3, 100, 1024])
def test_vegas_reduce_complex_and_gate_match_plain(cuda, m, mf):
    """The complex instantiations of vegas_reduce (default measure and given
    m) and the gate of measurefreq mf against the plain versions (rel 1e-9);
    vegas_relw_complex bit-equal; given m = relw's components, the default
    complex sums' histogram bit for bit and their observables to rel 1e-12
    (the kernel's row partials are the same; the wrapper sums a complex
    run's real and imaginary parts apart); the real kernel with the gate
    against plain."""
    args, mobs = cs.reduce_inputs(m, 3, 10, cplx=True, device=cuda)
    w, invp, perm, pad, pair_slots, used = args
    before = dict(vk.launch_counts)
    got = vk.vegas_reduce(*args, mf=mf, t0=5)
    got_m = vk.vegas_reduce(*args, mobs, mf=mf, t0=5)
    relw = vk.vegas_relw(w, invp, pad, pair_slots)
    ident = vk.vegas_reduce(*args, cs.relw_components(relw), mf=mf, t0=5)
    real_args = (w.real.contiguous(), *args[1:])
    got_r = vk.vegas_reduce(*real_args, mf=mf, t0=5)
    want = vk.vegas_reduce_plain(*args, mf=mf, t0=5)
    want_m = vk.vegas_reduce_plain(*args, mobs, mf=mf, t0=5)
    want_r = vk.vegas_reduce_plain(*real_args, mf=mf, t0=5)
    relw_p = vk.vegas_relw_plain(w, invp, pad, pair_slots)
    torch.cuda.synchronize()
    assert got[0].shape == (2, 3, 6) and relw.dtype == torch.complex64
    for g, p in (*zip(got, want), *zip(got_m, want_m), *zip(got_r, want_r)):
        torch.testing.assert_close(g, p, rtol=1e-9, atol=0)
    assert _bits_equal(relw, relw_p)
    torch.testing.assert_close(ident[0], got[0], rtol=1e-12, atol=0)
    assert _bits_equal(ident[1], got[1])
    assert vk.launch_counts["vegas_reduce_complex"] == before["vegas_reduce_complex"] + 3
    assert vk.launch_counts["vegas_relw_complex"] == before["vegas_relw_complex"] + 1
    assert vk.launch_counts["vegas_reduce"] == before["vegas_reduce"] + 1


@pytest.mark.parametrize("mf", [1, 4])
@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_vplus_measure_branches_match_plain(cuda, cplx, mf):
    """On phase 3d's all-branch spec after one reallocation, chunks 1-2:
    vplus_relw bit-equal to its plain version; vplus_reduce (complex
    weights, a measure's output, the gate of measurefreq mf with its random
    shifts) against plain to rel 1e-12; given m = relw's components, the
    default observables bit for bit (real weights) or to rel 1e-12 (complex:
    the wrapper sums the real and imaginary parts apart)."""
    it = cs.vplus_allbranch(mt, 2 ** 16, device=cuda, cplx=cplx)
    lay, params = it.layout, it.spec.device_params()
    it.run(params, block_keys(4, 0, 0, it.block))
    tab, kd = lay.tables(params), it.seeds(block_keys(4, 1, 0, it.block))
    cube, cfac = it.cube_tables()
    x, gidx = vp.vplus_sample(lay, tab, kd, 1, 2, cube)
    w = it.evaluate(lay.leaf_values(x)).contiguous()
    assert w.is_complex() == cplx
    mobs = torch.randn((5,) + tuple(w.shape[1:]), generator=torch.Generator(cuda).manual_seed(3),
                       device=cuda)
    shift = vp.gate_shifts(kd, 1, 2, it.chunk) if mf > 1 else None
    before = dict(vp.launch_counts)
    relw = vp.vplus_relw(lay, tab, w, gidx, cube, cfac)
    got = vp.vplus_reduce(lay, tab, w, gidx, cube, cfac, None, mf, 1, shift)
    got_m = vp.vplus_reduce(lay, tab, w, gidx, cube, cfac, mobs, mf, 1, shift)
    ident = vp.vplus_reduce(lay, tab, w, gidx, cube, cfac, cs.relw_components(relw), mf, 1,
                            shift)
    relw_p = vp.vplus_relw_plain(lay, tab, w, gidx, cube, cfac)
    want = vp.vplus_reduce_plain(lay, tab, w, gidx, cube, cfac, None, mf, 1, shift)
    want_m = vp.vplus_reduce_plain(lay, tab, w, gidx, cube, cfac, mobs, mf, 1, shift)
    torch.cuda.synchronize()
    assert _bits_equal(relw, relw_p)
    assert got[0].shape == (it.block, 2, 4 if cplx else 2)
    for g, p in (*zip(got, want), *zip(got_m, want_m)):
        torch.testing.assert_close(g, p, rtol=1e-12, atol=0)
    if cplx:
        torch.testing.assert_close(ident[0], got[0], rtol=1e-12, atol=0)
    else:
        assert _bits_equal(ident[0], got[0])
    for g, p in zip(ident[1:], got[1:]):
        torch.testing.assert_close(g, p, rtol=1e-12, atol=0)
    key = "vplus_reduce_complex" if cplx else "vplus_reduce_measure"
    assert vp.launch_counts["vplus_relw"] == before["vplus_relw"] + 1
    assert vp.launch_counts[key] == before[key] + (3 if cplx else 2)


@pytest.mark.parametrize("solver", ["vegas", "vegasplus"])
def test_cuda_plus_0j_reproduces_the_real_run(cuda, solver):
    """One iteration of f and of f + 0j from the same seeds on the card: the
    real parts of the observables bit-equal, the imaginary parts 0, the
    histograms bit-equal on :vegas (float64 atomics: rel 1e-12 on
    :vegasplus)."""
    cls = VegasIteration if solver == "vegas" else VegasPlusIteration
    out = {}
    for cplx in (False, True):
        spec = Spec(mt.Configuration(var=mt.Continuous(0.0, 1.0), dof=[[1], [2]], seed=3,
                                     type=complex if cplx else float), cuda)
        f = (lambda x, c: tuple(w + 0j for w in _two(x, c))) if cplx else _two
        it = cls(spec, lambda x, c: f((x, x), c), block=4, nevalperblock=2 ** 18)
        out[cplx] = it.run(spec.device_params(), block_keys(3, 0, 0, 4))
    a, b = out[False], out[True]
    assert np.array_equal(b["obs_blocks"].real, a["obs_blocks"])
    assert np.all(b["obs_blocks"].imag == 0.0)
    tol = 0.0 if solver == "vegas" else 1e-12
    for h, r in zip(b["hists"], a["hists"]):
        np.testing.assert_allclose(h, r, rtol=tol, atol=0)


@pytest.mark.parametrize("solver", ["vegas", "vegasplus"])
def test_cuda_item14_routes_integrate(cuda, solver):
    """The quarter disc times e^{i(x+y)} with measurefreq 3 and the
    quickstart's histogram on the card, within 7 sigma of their exact
    values."""
    vk.reset_launch_counts()
    vp.reset_launch_counts()
    res = mt.integrate(cs._qdisc, var=mt.Continuous(0.0, 1.0), dof=[[2]], neval=2 ** 22,
                       niter=4, solver=solver, type=complex, measurefreq=3, seed=5,
                       verbose=-2, device="cuda")
    exact = cs.qdisc_exact()
    mean, err = complex(res.mean[0]), complex(res.stdev[0])
    assert res.backend == "cuda"
    assert abs(mean.real - exact.real) < 7 * err.real and abs(mean.imag - exact.imag) < 7 * err.imag
    if solver == "vegas":
        assert vk.launch_counts["vegas_reduce_complex"] == vk.launch_counts["vegas_sample"] >= 4
    else:
        assert vp.launch_counts["vplus_reduce_complex"] == vp.launch_counts["vplus_sample"] >= 4
    spec, f, measure = _qs(cuda, 10)
    res = mt.integrate(f, config=spec.cfg, measure=measure, neval=2 ** 22, niter=4,
                       solver=solver, verbose=-2, device="cuda")
    a = np.arange(10) / 10
    exact = a * a + a / 10 + 1 / 300 + 1 / 3
    mean, std = np.asarray(res.mean[0]), np.asarray(res.stdev[0])
    assert np.all(np.abs(mean - exact) < 7 * std), (mean - exact) / std


@pytest.mark.parametrize("k", range(len(cs.MIXED_SPECS)), ids=[e[0] for e in cs.MIXED_SPECS])
@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_vegas_mixed_kernels_match_plain(cuda, cplx, k):
    """The mixed route on phase 3h's specs, with fewer blocks:
    vegas_sample_mixed and vegas_relw_mixed bit for bit; vegas_reduce_mixed
    (default, given a measure's output; mf 1 and 4) obs to rel 1e-9 and the
    histograms to rel 1e-12 (float64 adds in another order)."""
    name, var, dof, f, npb, _, T = cs.MIXED_SPECS[k]
    before = dict(vk.launch_counts)
    it, lay, tab, kd, t0, T, x, gidx, w = cs.mixed_launch(mt, var(mt), dof, f, min(npb, 2 ** 20),
                                                          2, T, cplx=cplx)
    want = vk.vegas_sample_mixed_plain(lay, tab, kd, t0, T)
    assert _bits_equal(x, want[0]) and torch.equal(gidx, want[1])
    relw = vk.vegas_relw_mixed(lay, tab, w, gidx)
    assert _bits_equal(relw, vk.vegas_relw_mixed_plain(lay, tab, w, gidx))
    m = cs._measure_of(relw)
    for mf in (1, 4):
        for given in (None, m):
            obs, hist = vk.vegas_reduce_mixed(lay, tab, w, gidx, given, mf, t0)
            obs_p, hist_p = vk.vegas_reduce_mixed_plain(lay, tab, w, gidx, given, mf, t0)
            torch.cuda.synchronize()
            torch.testing.assert_close(obs, obs_p, rtol=1e-9, atol=0)
            torch.testing.assert_close(hist, hist_p, rtol=1e-12, atol=0)
    assert vk.launch_counts["vegas_sample_mixed"] == before["vegas_sample_mixed"] + 1
    assert vk.launch_counts["vegas_relw_mixed"] == before["vegas_relw_mixed"] + 1
    assert vk.launch_counts["vegas_reduce_mixed"] == before["vegas_reduce_mixed"] + 4


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_vegas_mixed_scalar_path(cuda, cplx):
    """vegas_reduce_mixed and vegas_relw_mixed with w and m one element off
    16-byte alignment, at c % 4 == 0 (the scalar loads and stores of the
    kernel that otherwise takes 16 bytes at a time): relw bit for bit, the
    reduce in every mode against plain."""
    name, var, dof, f, npb, _, T = cs.MIXED_SPECS[1]
    it, lay, tab, kd, t0, T, x, gidx, w = cs.mixed_launch(mt, var(mt), dof, f, npb, 2, T,
                                                          cplx=cplx)
    assert lay.chunk % vk.PER_THREAD == 0
    wu = cs.misaligned(w)
    relw = vk.vegas_relw_mixed(lay, tab, wu, gidx)
    assert _bits_equal(relw, vk.vegas_relw_mixed_plain(lay, tab, w, gidx))
    m = cs._measure_of(relw)
    for mf in (1, 4):
        for given in (None, cs.misaligned(m)):
            obs, hist = vk.vegas_reduce_mixed(lay, tab, wu, gidx, given, mf, t0)
            obs_p, hist_p = vk.vegas_reduce_mixed_plain(lay, tab, w, gidx, given, mf, t0)
            torch.cuda.synchronize()
            torch.testing.assert_close(obs, obs_p, rtol=1e-9, atol=0)
            torch.testing.assert_close(hist, hist_p, rtol=1e-12, atol=0)


@pytest.mark.parametrize("mf", [1, 4])
@pytest.mark.parametrize("ncomp", [1, 3, 10])
@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_vplus_given_m_components(cuda, cplx, ncomp, mf):
    """vplus_reduce given a measure's output of 1, 3 and 10 components (its
    sums formed four chunks at a time) against plain to rel 1e-12,
    on phase 3d's all-branch spec, chunks 1-2, with and without the gate;
    given relw's components, the default observables bit for bit on real
    weights."""
    it = cs.vplus_allbranch(mt, 2 ** 16, device=cuda, cplx=cplx)
    lay, params = it.layout, it.spec.device_params()
    it.run(params, block_keys(4, 0, 0, it.block))
    tab, kd = lay.tables(params), it.seeds(block_keys(4, 1, 0, it.block))
    cube, cfac = it.cube_tables()
    x, gidx = vp.vplus_sample(lay, tab, kd, 1, 2, cube)
    w = it.evaluate(lay.leaf_values(x)).contiguous()
    mobs = torch.randn((ncomp,) + tuple(w.shape[1:]),
                       generator=torch.Generator(cuda).manual_seed(ncomp), device=cuda)
    shift = vp.gate_shifts(kd, 1, 2, it.chunk) if mf > 1 else None
    got = vp.vplus_reduce(lay, tab, w, gidx, cube, cfac, mobs, mf, 1, shift)
    want = vp.vplus_reduce_plain(lay, tab, w, gidx, cube, cfac, mobs, mf, 1, shift)
    torch.cuda.synchronize()
    assert got[0].shape == (it.block, 2, ncomp)
    for g, p in zip(got, want):
        torch.testing.assert_close(g, p, rtol=1e-12, atol=0)
    if not cplx:
        relw = vp.vplus_relw(lay, tab, w, gidx, cube, cfac)
        ident = vp.vplus_reduce(lay, tab, w, gidx, cube, cfac, cs.relw_components(relw), mf, 1,
                                shift)
        default = vp.vplus_reduce(lay, tab, w, gidx, cube, cfac, None, mf, 1, shift)
        assert _bits_equal(ident[0], default[0])


def test_cuda_vegas_mixed_integrates(cuda):
    """t d^2 over Continuous(0, 1) x Discrete(1, 100) and
    Discrete([(1, 3), (1, 4)]) on the card, within 7 sigma of their exact
    values, through the mixed route's kernels."""
    vk.reset_launch_counts()
    res = mt.integrate(cs._td2, var=(mt.Continuous(0.0, 1.0), mt.Discrete(1, 100)),
                       dof=[[1, 1]], neval=2 ** 22, niter=5, solver="vegas", seed=5,
                       verbose=-2, device="cuda")
    assert res.backend == "cuda"
    assert abs(res.mean[0] - 338350 / 2) < 7 * res.stdev[0]
    res = mt.integrate(cs._one, var=mt.Discrete([(1, 3), (1, 4)]), dof=[[1]], neval=2 ** 22,
                       niter=5, solver="vegas", seed=5, verbose=-2, device="cuda")
    # sigma at least 12 * 2^-23: a weight is a float32 product (chip_smoke.py:_z)
    assert abs(res.mean[0] - 12.0) < 7 * max(res.stdev[0], 12.0 * 2.0 ** -23)
    assert vk.launch_counts["vegas_sample_mixed"] == vk.launch_counts["vegas_reduce_mixed"] >= 10
    assert vk.launch_counts["vegas_sample"] == 0


def _vplus_launch(it, cuda, seed=4):
    """(lay, tab, kd, cube, cfac, gidx, w) of chunks 0.. of one launch of
    ``it`` after one reallocation."""
    lay, params = it.layout, it.spec.device_params()
    it.run(params, block_keys(seed, 0, 0, it.block))
    tab, kd = lay.tables(params), it.seeds(block_keys(seed, 1, 0, it.block))
    cube, cfac = it.cube_tables()
    x, gidx = vp.vplus_sample(lay, tab, kd, 0, it.chunks_per_launch, cube)
    return lay, tab, kd, cube, cfac, gidx, it.evaluate(lay.leaf_values(x)).contiguous()


@pytest.mark.parametrize("case", ["misaligned w", "chunk 3003", "chunk 1022"])
@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_vplus_relw_scalar_paths(cuda, cplx, case):
    """vplus_relw's scalar accesses bit-equal to its plain version on phase
    3d's all-branch spec (padding, a Discrete passenger): w one element off
    16-byte alignment, and chunks of 3003 and 1022 samples (c % 4 != 0; the
    second shorter than a block's RELW_SPAN)."""
    c = {"misaligned w": 4096, "chunk 3003": 3003, "chunk 1022": 1022}[case]
    it = cs.vplus_allbranch(mt, 3 * c, device=cuda, cplx=cplx, max_cubes=81, max_chunk=c)
    assert it.chunk == c and it.chunks_per_launch == 3
    lay, tab, _, cube, cfac, gidx, w = _vplus_launch(it, cuda)
    if case == "misaligned w":
        buf = torch.empty(w.numel() + 1, dtype=w.dtype, device=cuda)
        w = buf[1:].view(w.shape).copy_(w)
        assert w.data_ptr() % 16 != 0
    before = vp.launch_counts["vplus_relw"]
    relw = vp.vplus_relw(lay, tab, w, gidx, cube, cfac)
    want = vp.vplus_relw_plain(lay, tab, w, gidx, cube, cfac)
    torch.cuda.synchronize()
    assert _bits_equal(relw, want)
    assert vp.launch_counts["vplus_relw"] == before + 1


@pytest.mark.parametrize("mf", [1, 4])
@pytest.mark.parametrize("npb,block", [(2 ** 20, 16), (5 * 2 ** 17, 3), (2 ** 17, 2)],
                         ids=["128 chunks", "15 chunks", "2 chunks"])
def test_vplus_reduce_complex_chunk_rounds(cuda, npb, block, mf):
    """vplus_reduce's complex default (a thread takes four chunks at once)
    against plain to rel 1e-12 on the quarter disc times e^{i(x+y)} at
    131,072-sample chunks: 128 chunks (a block row walks several rounds of
    four, the last one short, at six or eight blocks an SM alike), 15 and 2
    (fewer chunks than block rows); gated with its random shifts or not.
    w + 0i: the real parts' partial rows bit-equal to the real kernel's."""
    cfg = mt.Configuration(var=mt.Continuous(0.0, 1.0), dof=[[2]], seed=5, type=complex)
    it = VegasPlusIteration(Spec(cfg, cuda), cs._qdisc, block=block, nevalperblock=npb)
    assert it.chunk == 2 ** 17
    lay, tab, kd, cube, cfac, gidx, w = _vplus_launch(it, cuda)
    T = it.chunks_per_launch
    shift = vp.gate_shifts(kd, 0, T, it.chunk) if mf > 1 else None
    before = vp.launch_counts["vplus_reduce_complex"]
    got = vp.vplus_reduce(lay, tab, w, gidx, cube, cfac, None, mf, 0, shift)
    want = vp.vplus_reduce_plain(lay, tab, w, gidx, cube, cfac, None, mf, 0, shift)
    torch.cuda.synchronize()
    assert vp.launch_counts["vplus_reduce_complex"] == before + 1
    assert got[0].shape == (block, T, 2)
    for g, p in zip(got, want):
        torch.testing.assert_close(g, p, rtol=1e-12, atol=0)
    wr = w.real.contiguous()
    wz = torch.complex(wr, torch.zeros_like(wr)).contiguous()
    lib = vp._build.load()
    rows = []
    for entry, ww in ((lib.mci_vplus_reduce_complex, wz), (lib.mci_vplus_reduce, wr)):
        obs_rows, sig, hist = vp._reduce_outputs(lay, ww, cfac)
        err = entry(*vp._reduce_args(lay, tab, ww, gidx, cube, cfac, obs_rows, sig, hist, None,
                                     mf, 0, shift), torch.cuda.current_stream().cuda_stream)
        vp._build.check(lib, err, "vplus_reduce")
        rows.append(obs_rows)
    torch.cuda.synchronize()
    assert _bits_equal(rows[0][..., 0::2].contiguous(), rows[1])
    assert not rows[0][..., 1::2].any()
