"""PyTorch port: the :vegasmc pieces against the JAX package.

- ``do_reweight`` is float64 numpy in both packages: bit for bit.
- Padding factors and the joint density from the same float32 slot
  probabilities and weights: rel 1e-6 (the JAX package multiplies with
  ``jnp.prod``, the port in a fixed (group, slot) order, as the kernel does).
- One ``VegasMCIteration.run`` against the JAX XLA route, which samples the
  same law from another random stream: per-block means within 7 combined
  sigma, acceptance rates within 0.01, visited shares within 0.02.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mcintegration_tpu as mj
from mcintegration_tpu import main as jmain
from mcintegration_tpu.solvers.engine import Spec as JSpec
from mcintegration_tpu.solvers.vegasmc import VegasMCIteration as JVegasMCIteration

import mcintegration_tpu_torch as mt
from mcintegration_tpu_torch import main as tmain
from mcintegration_tpu_torch.ops import chain_kernels as ck
from mcintegration_tpu_torch.solvers.engine import Spec
from mcintegration_tpu_torch.solvers.vegasmc import VegasMCIteration

torch.set_num_threads(1)


@pytest.mark.parametrize("goal", [None, [1.0, 2.0, 0.5, 3.0]])
def test_do_reweight_matches_jax(goal):
    rng = np.random.default_rng(0)
    jc = mj.Configuration(var=mj.Continuous(0.0, 1.0), dof=[[1], [2], [3]], seed=1)
    tc = mt.Configuration(var=mt.Continuous(0.0, 1.0), dof=[[1], [2], [3]], seed=1)
    for it in range(3):
        vis = rng.gamma(1.0, 1e4, 4)
        vis[it] = 0.5                      # a sector visited less than once
        jc.visited = vis.copy()
        tc.visited = vis.copy()
        jmain.do_reweight(jc, 0.7, goal)
        tmain.do_reweight(tc, 0.7, goal)
        assert np.array_equal(tc.reweight, jc.reweight)


def _cases():
    comp = dict(var=lambda pkg: pkg.CompositeVar(pkg.Continuous(0.0, 1.0), pkg.Discrete(1, 4)),
                dof=[[1], [2]])
    pad = dict(var=lambda pkg: pkg.Continuous(0.0, 1.0), dof=[[1], [2]])
    groups = dict(var=lambda pkg: (pkg.Continuous(0.0, 1.0), pkg.Discrete(1, 4)),
                  dof=[[1, 2], [2, 0], [0, 1]])
    return {"padding": pad, "composite": comp, "groups": groups}


@pytest.mark.parametrize("case", ["padding", "composite", "groups"])
def test_pads_and_joint_density_match_jax(case):
    c = _cases()[case]
    jspec = JSpec(mj.Configuration(var=c["var"](mj), dof=c["dof"], seed=1))
    tspec = Spec(mt.Configuration(var=c["var"](mt), dof=c["dof"], seed=1), "cpu")
    rng = np.random.default_rng(2)
    W, n, nd = 512, tspec.N, tspec.N + 1
    probs = [rng.uniform(0.05, 3.0, (W, li.ndraw)).astype(np.float32) for li in tspec.leaves]
    w = rng.normal(0.0, 1.0, (W, n)).astype(np.float32)
    r = rng.uniform(0.1, 1.0, nd).astype(np.float32)

    jslot = jspec.slot_probs([{"prob": jnp.asarray(p)} for p in probs])
    jpad = jnp.stack([jspec.padding_probability(jslot, i) for i in range(nd)], axis=-1)
    rj = jnp.asarray(r)     # joint_probability of mcintegration_tpu/solvers/vegasmc.py:276-281
    jp = rj[n] * jpad[:, n] + jnp.sum(jnp.abs(jnp.asarray(w)) * rj[None, :n] * jpad[:, :n], axis=-1)
    jprob = jnp.stack([jspec.probability(jslot, i) for i in range(n)], axis=-1)

    tslot = tspec.slot_probs([torch.as_tensor(p.T.copy()) for p in probs])
    tpad = torch.stack([tspec.padding_probability(tslot, i) for i in range(nd)])
    tp = tspec.joint_probability(torch.as_tensor(w.T.copy()), tpad, torch.as_tensor(r))
    tprob = torch.stack([tspec.probability(tslot, i) for i in range(n)])
    np.testing.assert_allclose(tslot.numpy(), np.moveaxis(np.asarray(jslot), 0, -1), rtol=1e-6)
    np.testing.assert_allclose(tpad.numpy(), np.asarray(jpad).T, rtol=1e-6)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6)
    np.testing.assert_allclose(tprob.numpy(), np.asarray(jprob).T, rtol=1e-6)


def _pi(pkg):
    def f(x, c):
        return pkg.where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0)
    return f


def _td(pkg):
    def f(x, c):
        t, d = x
        return t[0] * d[0].astype(jnp.float32) if pkg is jnp else t[0] * d[0].to(torch.float32)
    return f


def _two(pkg):
    def f(x, c):
        return (x[0], pkg.where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0))
    return f


STAT_CASES = {
    "pi": (lambda pkg: pkg.Continuous(0.0, 1.0), [[2]], _pi),
    "discrete": (lambda pkg: (pkg.Continuous(0.0, 1.0), pkg.Discrete(1, 4)), [[1, 1]], _td),
    "padding": (lambda pkg: pkg.Continuous(0.0, 1.0), [[1], [2]], _two),
}


def _summary(st):
    m = st["obs_blocks"] / st["norm_blocks"][:, None]
    acc = st["accept"][1, 0] / np.maximum(st["propose"][1, 0], 1)
    return (m.mean(axis=0), m.std(axis=0, ddof=1) / np.sqrt(m.shape[0]), acc,
            st["visited"] / st["visited"].sum())


@pytest.mark.parametrize("case", list(STAT_CASES))
def test_run_matches_jax_xla_route(case):
    var, dof, f = STAT_CASES[case]
    kw = dict(block=4, nevalperblock=2 ** 15, nwalkers=8192)
    jspec = JSpec(mj.Configuration(var=var(mj), dof=dof, seed=5))
    jit = JVegasMCIteration(jspec, f(jnp), backend="xla", **kw)
    tspec = Spec(mt.Configuration(var=var(mt), dof=dof, seed=5), "cpu")
    tit = VegasMCIteration(tspec, f(torch), **kw)
    assert (tit.nwalkers, tit.nsteps, tit.neval) == (jit.nwalkers, jit.nsteps, jit.neval)
    ck.reset_launch_counts()
    st_t = tit.run(tspec.device_params(),
                   np.random.default_rng(3).integers(0, 2 ** 32, (4, 2), dtype=np.uint32))
    assert ck.launch_counts == {"chain_propose": 0, "chain_accept": 0, "chain_measure": 0,
                                "chain_accept_complex": 0}
    st_j = jit.run(jspec.device_params(), jax.random.key(3))
    mt_, st_, at, vt = _summary(st_t)
    mj_, sj, aj, vj = _summary(st_j)
    assert np.all(np.abs(mt_ - mj_) < 7 * np.hypot(st_, sj)), (mt_, mj_, st_, sj)
    assert np.all(np.abs(at - aj) < 0.01), (at, aj)
    assert np.all(np.abs(vt - vj) < 0.02), (vt, vj)
    assert st_t["propose"][1, 0].sum() == tit.nwalkers * tit.nsteps
    for li, h in zip(tspec.leaves, st_t["hists"]):
        assert h.shape == (li.nhist,) and h.sum() > 0


def test_plain_step_keeps_the_mirror_and_counts():
    """After each accept the proposal mirror equals the current state, and
    every walker's move is tallied once."""
    var, dof, f = STAT_CASES["discrete"]
    spec = Spec(mt.Configuration(var=var(mt), dof=dof, seed=2), "cpu")
    it = VegasMCIteration(spec, f(torch), block=4, nevalperblock=2 ** 10, nwalkers=256)
    kd = it.seeds(np.arange(8, dtype=np.uint32).reshape(4, 2) * 977)
    tab, rw, st = it.start(spec.device_params(), kd)
    for t in range(5):
        it.step(tab, rw, kd, st, t)
        for a, b in ((st.cur_val, st.prp_val), (st.cur_gidx, st.prp_gidx),
                     (st.cur_prob, st.prp_prob)):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert int(st.pc.sum()) == 5 * it.nwalkers
    vals = it.leaf_values(st.cur_val)[1]
    assert vals.dtype == torch.int32 and int(vals.min()) >= 1 and int(vals.max()) <= 4


def test_chain_wrappers_refuse_other_devices():
    """Off the CPU a wrapper launches its kernel or raises: never the plain path."""
    spec = Spec(mt.Configuration(var=mt.Continuous(0.0, 1.0), dof=[[2]], seed=1), "cpu")
    it = VegasMCIteration(spec, _pi(torch), block=4, nevalperblock=2 ** 10, nwalkers=256)
    st = ck.ChainState.zeros(it.layout)
    meta = ck.ChainState(**{k: v.to("meta") for k, v in vars(st).items()})
    kd = torch.zeros((4, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ck.chain_propose(it.layout, torch.zeros(2048, device="meta"), kd, 0, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        ck.chain_accept(it.layout, torch.zeros(2, device="meta"), kd, 0, meta,
                        torch.zeros((1, 256), device="meta"))


def test_chain_layout_paths():
    """Which tables and histograms the kernels keep in shared memory."""
    for ninc, lower, upper, smem in [(1000, 1, 40, (40, True)), (8192, -3, 2000, (0, False))]:
        var = mt.CompositeVar(mt.Continuous(0.0, 1.0, ninc=ninc), mt.Discrete(lower, upper))
        spec = Spec(mt.Configuration(var=var, dof=[[1], [2]], seed=2), "cpu")
        lay = ck.ChainLayout.build(spec, 4, 64)
        assert (lay.smem_floats, lay.nhist <= ck.SMEM_HIST_BINS) == smem
