"""PyTorch port: custom measures on :vegas (K1's branch, pallas_vegas.py:488-503).

- The same numpy per-block seeds ``kd`` and the same non-uniform map go to
  the JAX ``VegasIteration(..., backend="pallas", measure=...)`` (K1's
  custom-measure branch in interpret mode on the CPU) and to the port's
  ``VegasIteration.run`` (the plain versions of ``vegas_sample``,
  ``vegas_relw`` and ``vegas_reduce``): both draw the identical samples, so
  per-block ``obs`` agree at rel 1e-5 (float32 Kahan sums in JAX, float64 in
  the port) and ``norm`` exactly.  The ``count`` case has strata rows that
  pad K1's chunk to its square (ninc=1000): a measure term that does not
  depend on ``relw`` counts the same samples in both.
- The identity measure ``[relw[0]]`` gives the default measure's sums bit
  for bit; a measure that does not broadcast runs under ``torch.func.vmap``
  and agrees; the memory cap on a launch changes nothing but the summation
  order; the plain versions against values computed by hand.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mcintegration_tpu as mj
from mcintegration_tpu.ops.grid import train_grid
from mcintegration_tpu.solvers.engine import Spec as JSpec
from mcintegration_tpu.solvers.vegas import VegasIteration as JVegasIteration

import mcintegration_tpu_torch as mt
from mcintegration_tpu_torch.checkpoint import params_from_jax
from mcintegration_tpu_torch.ops import vegas_kernels as vk
from mcintegration_tpu_torch.solvers import vegas as tv
from mcintegration_tpu_torch.solvers.engine import Spec
from mcintegration_tpu_torch.solvers.vegas import VegasIteration

torch.set_num_threads(1)

NBIN = 10


def _grid(ninc, seed):
    h = np.random.default_rng(seed).gamma(0.5, 1.0, ninc) + 1e-3
    return train_grid(np.linspace(0.0, 1.0, ninc + 1), h, 2.0)


def hist_f(pkg):
    def f(v, c):
        x, y = v
        return x[0] ** 2 + y[0] ** 2
    return f


def hist_measure(pkg, nbin=NBIN):
    """The quickstart's histogram of x (examples/quickstart.py:75-85),
    written to broadcast over a batch."""
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


def sphere3_f(pkg):
    def f(x, c):
        r2 = x[0] ** 2 + x[1] ** 2
        return pkg.where(r2 < 1.0, 1.0, 0.0), pkg.where(r2 + x[2] ** 2 < 1.0, 1.0, 0.0)
    return f


def sphere3_measure(pkg):
    """tests/test_montecarlo.py:73-74: [scalar, vector-of-2]."""
    def measure(x, relw, c):
        return [relw[0], pkg.stack([relw[1], relw[1] * 2.0])]
    return measure


def count_measure(pkg):
    """relw[0] and a term that does not depend on relw: the sample count."""
    def measure(x, relw, c):
        return [pkg.stack([relw[0], x[0] * 0.0 + 1.0])]
    return measure


def _hist_var(pkg, ninc):
    return (pkg.Continuous(0.0, 1.0, grid=_grid(ninc, 1)),
            pkg.Continuous(0.0, 1.0, grid=_grid(ninc, 2)))


CASES = {   # var, dof, obs, integrand, measure, ninc
    "histogram": (_hist_var, [[1, 1]], [np.zeros(NBIN)], hist_f, hist_measure, 64),
    "sphere3": (lambda pkg, ninc: pkg.Continuous(0.0, 1.0, grid=_grid(ninc, 3)),
                [[2], [3]], [0.0, np.zeros(2)], sphere3_f, sphere3_measure, 64),
    "count": (lambda pkg, ninc: pkg.Continuous(0.0, 1.0, grid=_grid(ninc, 4)),
              [[2]], [np.zeros(2)], lambda pkg: (lambda x, c: x[0] * x[1]), count_measure, 1000),
}


@pytest.mark.parametrize("case", list(CASES))
def test_k1_measure_parity(case):
    var, dof, obs, f, measure, ninc = CASES[case]
    kw = dict(block=4, nevalperblock=2 ** 14)
    jspec = JSpec(mj.Configuration(var=var(mj, ninc), dof=dof, obs=obs, seed=5))
    jit = JVegasIteration(jspec, f(jnp), mesh=None, backend="pallas", measure=measure(jnp),
                          obs_proto=obs, **kw)
    assert jit.backend == "pallas", jit.backend_reason
    tspec = Spec(mt.Configuration(var=var(mt, ninc), dof=dof, obs=obs, seed=5), "cpu")
    tit = VegasIteration(tspec, f(torch), measure=measure(torch), obs_proto=obs, **kw)
    assert tit.backend_reason == ""
    assert (tit.chunk, tit.nchunks) == (jit.chunk, jit.nchunks)
    kd = np.random.default_rng(7).integers(0, 2 ** 32, (4, 2), dtype=np.uint32)
    jparams = jspec.device_params()
    obs_j, norm_j, _ = jit.raw_fn(jparams, jnp.asarray(kd))
    st = tit.run(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tspec), kd)

    assert np.array_equal(st["norm_blocks"], np.asarray(norm_j, np.float64))
    leaves_j = jax.tree_util.tree_leaves(obs_j)
    assert isinstance(st["obs_blocks"], list) and len(st["obs_blocks"]) == len(obs)
    for got, want, proto in zip(st["obs_blocks"], leaves_j, obs):
        assert got.shape == (4,) + np.shape(proto)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=0)
    if case == "count":         # every sample the port draws is real
        assert np.array_equal(st["obs_blocks"][0][:, 1], st["norm_blocks"])


def _pi(x, c):
    return torch.where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0)


def test_identity_measure_is_the_default_bit_for_bit():
    spec = Spec(mt.Configuration(var=mt.Continuous(0.0, 1.0, ninc=64), dof=[[2]], seed=1),
                "cpu")
    kd = np.random.default_rng(3).integers(0, 2 ** 32, (4, 2), dtype=np.uint32)
    a = VegasIteration(spec, _pi, block=4, nevalperblock=24576).run(spec.device_params(), kd)
    b = VegasIteration(spec, _pi, measure=lambda v, relw, c: [relw[0]], obs_proto=[0.0],
                       block=4, nevalperblock=24576).run(spec.device_params(), kd)
    assert np.array_equal(a["obs_blocks"][:, 0], b["obs_blocks"][0])
    assert np.array_equal(a["hists"][0], b["hists"][0])


def test_non_broadcasting_measure_runs_under_vmap():
    """The quickstart's own measure compares arange(nbin) with the bin
    index: it does not broadcast over a batch, so the probe sends it to
    torch.func.vmap, with the same sums as the broadcasting form."""
    def per_sample(v, relw, c):
        x, _ = v
        b = torch.clamp((x[0] * NBIN).to(torch.int32), 0, NBIN - 1)
        return [(torch.arange(NBIN) == b).to(relw.dtype) * relw[0] * NBIN]

    var, dof, obs, f, _, ninc = CASES["histogram"]
    spec = Spec(mt.Configuration(var=var(mt, ninc), dof=dof, obs=obs, seed=2), "cpu")
    kd = np.random.default_rng(5).integers(0, 2 ** 32, (4, 2), dtype=np.uint32)
    kw = dict(obs_proto=obs, block=4, nevalperblock=2 ** 13)
    vm = VegasIteration(spec, f(torch), measure=per_sample, **kw)
    assert "measure:" in vm.backend_reason and "torch.func.vmap" in vm.backend_reason
    bc = VegasIteration(spec, f(torch), measure=hist_measure(torch), **kw)
    assert bc.backend_reason == ""
    a, b = vm.run(spec.device_params(), kd), bc.run(spec.device_params(), kd)
    np.testing.assert_allclose(a["obs_blocks"][0], b["obs_blocks"][0], rtol=1e-12, atol=0)


def test_measure_returning_complex_values_raises():
    spec = Spec(mt.Configuration(var=mt.Continuous(0.0, 1.0, ninc=64), dof=[[2]], seed=1),
                "cpu")
    it = VegasIteration(spec, _pi, measure=lambda v, relw, c: [relw[0] * (1 + 1j)],
                        obs_proto=[0.0], block=2, nevalperblock=4096)
    with pytest.raises(NotImplementedError, match="complex observables .* type=complex"):
        it.run(spec.device_params(), np.zeros((2, 2), np.uint32))


def test_memory_cap_splits_launches(monkeypatch):
    """The measure's bytes cap the samples of a launch; cutting an iteration
    into more launches changes only the float64 summation order."""
    var, dof, obs, f, measure, ninc = CASES["histogram"]
    spec = Spec(mt.Configuration(var=var(mt, ninc), dof=dof, obs=obs, seed=2), "cpu")
    kd = np.random.default_rng(6).integers(0, 2 ** 32, (4, 2), dtype=np.uint32)
    kw = dict(measure=measure(torch), obs_proto=obs, block=4, nevalperblock=24576)
    one = VegasIteration(spec, f(torch), **kw)
    per_sample = 4 * (2 + 2 * 1 + NBIN)          # x, w, relw and m of one sample
    monkeypatch.setattr(tv, "MEASURE_LAUNCH_BYTES", per_sample * 4 * one.chunk)
    split = VegasIteration(spec, f(torch), **kw)
    assert (one.launches_per_run, split.launches_per_run) == (1, 3)
    a, b = one.run(spec.device_params(), kd), split.run(spec.device_params(), kd)
    np.testing.assert_allclose(a["obs_blocks"][0], b["obs_blocks"][0], rtol=1e-12)


def test_relw_and_reduce_plain_by_hand():
    """Two slots, two integrands; integrand 1 pads slot 1 (pair 0 holds it)."""
    rng = np.random.default_rng(0)
    invp = rng.uniform(0.5, 2.0, (2, 1, 1, 3)).astype(np.float32)      # [S, B, T, nb]
    w = rng.normal(size=(2, 1, 1, 3, 4)).astype(np.float32)            # [N, B, T, nb, m]
    pad = torch.tensor([[0], [1]], dtype=torch.int32)
    pair_slots = torch.tensor([[1]], dtype=torch.int32)
    jac = invp[0] * invp[1]
    factor = [jac, jac * (np.float32(1.0) / invp[1])]
    want = np.stack([w[i] * factor[i][..., None] for i in range(2)])
    relw = vk.vegas_relw_plain(torch.as_tensor(w), torch.as_tensor(invp), pad, pair_slots)
    assert np.array_equal(relw.numpy(), want)

    m = rng.normal(size=(3, 1, 1, 3, 4)).astype(np.float32)
    perm = torch.tensor([[[[2, 0, 1]]], [[[0, 1, 2]]]], dtype=torch.int32)
    used = torch.ones((2, 2), dtype=torch.int32)
    obs, hrow = vk.vegas_reduce_plain(torch.as_tensor(w), torch.as_tensor(invp), perm, pad,
                                      pair_slots, used, torch.as_tensor(m))
    assert obs.shape == (1, 1, 3)
    np.testing.assert_allclose(obs.numpy()[0, 0], m.astype(np.float64).sum(axis=(1, 2, 3, 4)),
                               rtol=1e-15)
    _, hrow_d = vk.vegas_reduce_plain(torch.as_tensor(w), torch.as_tensor(invp), perm, pad,
                                      pair_slots, used)
    assert torch.equal(hrow, hrow_d)         # the histogram ignores m
