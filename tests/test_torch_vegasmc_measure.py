"""PyTorch port: custom measures on :vegasmc (K2's branch, pallas_chain.py:829-842).

- One ``VegasMCIteration.run`` against the JAX XLA route, which samples
  the same law from another random stream: per-component means within 7
  combined sigma, on the quickstart's 10-bin histogram and on
  ``sphere3``'s mixed ``[scalar, vector-of-2]`` observables
  (tests/test_montecarlo.py:59-81).
- The identity measure ``[relw[0]]`` gives the default measure's sums bit
  for bit; a measure that does not broadcast runs under ``torch.func.vmap``
  and agrees; ``chain_accept``'s plain version writes ``relw`` in place of
  the ``obs`` adds, and ``chain_measure``'s adds ``m`` in float64.
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

from test_torch_vegas_measure import NBIN, hist_f, hist_measure, sphere3_f, sphere3_measure

torch.set_num_threads(1)

CASES = {   # var, dof, obs, integrand, measure
    "histogram": (lambda pkg: (pkg.Continuous(0.0, 1.0), pkg.Continuous(0.0, 1.0)),
                  [[1, 1]], [np.zeros(NBIN)], hist_f, hist_measure),
    "sphere3": (lambda pkg: pkg.Continuous(0.0, 1.0), [[2], [3]], [0.0, np.zeros(2)],
                sphere3_f, sphere3_measure),
}


def _block_means(st):
    """Per component: the mean over blocks of obs/norm and its error."""
    norm = st["norm_blocks"]
    out = []
    for ob in jax.tree_util.tree_leaves(st["obs_blocks"]):
        m = np.asarray(ob, np.float64).reshape(len(norm), -1) / norm[:, None]
        out.append((m.mean(axis=0), m.std(axis=0, ddof=1) / np.sqrt(len(norm))))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_run_matches_jax_xla_route(case):
    var, dof, obs, f, measure = CASES[case]
    kw = dict(block=8, nevalperblock=2 ** 15, nwalkers=8192)
    jspec = JSpec(mj.Configuration(var=var(mj), dof=dof, obs=obs, seed=5))
    jit = JVegasMCIteration(jspec, f(jnp), backend="xla", measure=measure(jnp),
                            obs_proto=obs, **kw)
    tspec = Spec(mt.Configuration(var=var(mt), dof=dof, obs=obs, seed=5), "cpu")
    tit = VegasMCIteration(tspec, f(torch), measure=measure(torch), obs_proto=obs, **kw)
    assert tit.backend_reason == ""
    assert (tit.nwalkers, tit.nsteps, tit.neval) == (jit.nwalkers, jit.nsteps, jit.neval)
    ck.reset_launch_counts()
    st_t = tit.run(tspec.device_params(),
                   np.random.default_rng(3).integers(0, 2 ** 32, (8, 2), dtype=np.uint32))
    assert sum(ck.launch_counts.values()) == 0            # plain versions on the CPU
    st_j = jit.run(jspec.device_params(), jax.random.key(3))
    assert isinstance(st_t["obs_blocks"], list) and len(st_t["obs_blocks"]) == len(obs)
    for ob, proto in zip(st_t["obs_blocks"], obs):
        assert ob.shape == (8,) + np.shape(proto)
    for (mt_, st_), (mj_, sj) in zip(_block_means(st_t), _block_means(st_j)):
        assert np.all(st_ > 0) and np.all(np.isfinite(mt_))
        assert np.all(np.abs(mt_ - mj_) < 7 * np.hypot(st_, sj)), (mt_, mj_, st_, sj)


def _pi(x, c):
    return torch.where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0)


def test_identity_measure_is_the_default_bit_for_bit():
    spec = Spec(mt.Configuration(var=mt.Continuous(0.0, 1.0), dof=[[2]], seed=1), "cpu")
    kd = np.random.default_rng(4).integers(0, 2 ** 32, (4, 2), dtype=np.uint32)
    kw = dict(block=4, nevalperblock=2 ** 12, nwalkers=1024, warmup=0.1)
    a = VegasMCIteration(spec, _pi, **kw).run(spec.device_params(), kd)
    b = VegasMCIteration(spec, _pi, measure=lambda v, relw, c: [relw[0]], obs_proto=[0.0],
                         **kw).run(spec.device_params(), kd)
    assert np.array_equal(a["obs_blocks"][:, 0], b["obs_blocks"][0])
    for key in ("norm_blocks", "visited", "propose", "accept"):
        assert np.array_equal(a[key], b[key]), key


def test_non_broadcasting_measure_runs_under_vmap():
    def per_sample(v, relw, c):
        x, _ = v
        b = torch.clamp((x[0] * NBIN).to(torch.int32), 0, NBIN - 1)
        return [(torch.arange(NBIN) == b).to(relw.dtype) * relw[0] * NBIN]

    var, dof, obs, f, _ = CASES["histogram"]
    spec = Spec(mt.Configuration(var=var(mt), dof=dof, obs=obs, seed=2), "cpu")
    kd = np.random.default_rng(5).integers(0, 2 ** 32, (4, 2), dtype=np.uint32)
    kw = dict(obs_proto=obs, block=4, nevalperblock=2 ** 12, nwalkers=1024)
    vm = VegasMCIteration(spec, f(torch), measure=per_sample, **kw)
    assert "measure:" in vm.backend_reason and "torch.func.vmap" in vm.backend_reason
    bc = VegasMCIteration(spec, f(torch), measure=hist_measure(torch), **kw)
    assert bc.backend_reason == ""
    a, b = vm.run(spec.device_params(), kd), bc.run(spec.device_params(), kd)
    np.testing.assert_allclose(a["obs_blocks"][0], b["obs_blocks"][0], rtol=1e-12, atol=0)


def test_measure_returning_complex_values_raises():
    spec = Spec(mt.Configuration(var=mt.Continuous(0.0, 1.0), dof=[[2]], seed=1), "cpu")
    it = VegasMCIteration(spec, _pi, measure=lambda v, relw, c: [relw[0] * (1 + 1j)],
                          obs_proto=[0.0], block=2, nevalperblock=512, nwalkers=64)
    with pytest.raises(NotImplementedError, match="complex observables .* type=complex"):
        it.run(spec.device_params(), np.zeros((2, 2), np.uint32))


def test_accept_writes_relw_and_measure_adds_by_hand():
    """On a measured step the custom layout's accept writes relw = w*(pad/p)
    and leaves obs alone; chain_measure_plain adds m in float64."""
    var, dof, obs, f, measure = CASES["sphere3"]
    spec = Spec(mt.Configuration(var=var(mt), dof=dof, obs=obs, seed=2), "cpu")
    it = VegasMCIteration(spec, f(torch), measure=measure(torch), obs_proto=obs, block=2,
                          nevalperblock=512, nwalkers=64)
    lay = it.layout
    assert (lay.ncomp, lay.custom) == (3, True)
    kd = it.seeds(np.arange(4, dtype=np.uint32).reshape(2, 2) * 977)
    tab, rw, st = it.start(spec.device_params(), kd)
    assert tuple(st.relw.shape) == (2, 64) and tuple(st.obs.shape) == (3, 64)
    ck.chain_propose(lay, tab, kd, 0, st)
    ck.chain_accept(lay, rw, kd, 0, st, it.weights(st), measure=True)
    assert torch.equal(st.relw, st.w * (st.pad[:2] / st.p))
    assert not st.obs.any()
    m = torch.as_tensor(np.random.default_rng(1).normal(size=(3, 64)), dtype=torch.float32)
    before = st.obs.clone()
    ck.chain_measure(lay, m, st)
    assert torch.equal(st.obs, before + m.double())
    default = ck.ChainState.zeros(ck.ChainLayout.build(spec, 2, 32))
    assert tuple(default.relw.shape) == (0, 64) and tuple(default.obs.shape) == (2, 64)
