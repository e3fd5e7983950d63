"""PyTorch port: Discrete pools and the chain's map draws against the JAX
package.

Host training is float64 numpy in both packages, so the Discrete state is
held bit for bit.  The draws take the same float32 uniforms and tables on
both sides, so ``gidx``/``iy`` are exact and ``x``/``prob`` equal in
float32.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mcintegration_tpu as mj
from mcintegration_tpu.ops import grid as jgrid
from mcintegration_tpu.solvers.engine import Spec as JSpec

import mcintegration_tpu_torch as mt
from mcintegration_tpu_torch.checkpoint import params_from_jax
from mcintegration_tpu_torch.ops import grid as tgrid
from mcintegration_tpu_torch.solvers.engine import Spec

torch.set_num_threads(1)


def _hist(n, seed):
    return np.random.default_rng(seed).gamma(0.5, 1.0, n) + 1e-3


@pytest.mark.parametrize("lower,upper,alpha", [(1, 3, 2.0), (-5, 94, 1.5), (0, 0, 2.0)])
def test_discrete_host_state_matches_jax(lower, upper, alpha):
    a = mt.Discrete(lower, upper, alpha=alpha)
    b = mj.Discrete(lower, upper, alpha=alpha)
    assert (a.nbin, a.nhist) == (b.nbin, b.nhist)
    for it in range(3):
        h = _hist(a.nbin, it)
        a.add_statistics(h)
        b.add_statistics(h)
        a.train()
        b.train()
        assert np.array_equal(a.distribution, b.distribution)
        assert np.array_equal(a.accumulation, b.accumulation)
        assert np.array_equal(a.histogram, b.histogram)
    assert np.array_equal(a.fixed_values(), b.fixed_values())
    assert a.fixed_values().dtype == np.int32
    cdf, dist = a.device_params("cpu")
    jp = b.device_params()
    assert np.array_equal(cdf.numpy(), np.asarray(jp["cdf"]))
    assert np.array_equal(dist.numpy(), np.asarray(jp["dist_tab"]).reshape(-1)[: a.nbin])


def test_discrete_constructors_and_composite():
    comp = mt.Discrete([(1, 3), (1, 4)])
    assert isinstance(comp, mt.CompositeVar) and [v.nbin for v in comp] == [3, 4]
    assert mt.Discrete((2, 5)).nbin == 4
    d = mt.Discrete(0, 3, distribution=[1.0, 2.0, 3.0, 4.0])
    assert np.array_equal(d.distribution, mj.Discrete(0, 3, distribution=[1, 2, 3, 4]).distribution)
    mixed = mt.CompositeVar(mt.Continuous(0.0, 1.0), mt.Discrete(1, 4), adapt=False, offset=1)
    assert all(v.offset == 1 and not v.adapt for v in mixed)


def _cdf(nbin, seed, short=False):
    dist = np.random.default_rng(seed).gamma(0.5, 1.0, nbin) + 1e-3
    _, acc = tgrid.build_cdf(dist)
    if short:       # float32 rounding left cdf[nbin] below 1
        acc[-1] = 0.999
    return acc.astype(np.float32)


@pytest.mark.parametrize("nbin,short", [(4, False), (100, False), (1500, False), (40, True)])
def test_sample_discrete_matches_jax(nbin, short):
    cdf = _cdf(nbin, nbin, short)
    dist = np.diff(cdf.astype(np.float64)).astype(np.float32)
    rng = np.random.default_rng(0)
    u = rng.uniform(0, 1, 4096).astype(np.float32)
    # u on, and one float32 step around, every threshold; and above cdf[nbin]
    th = cdf[1:]
    u = np.concatenate([u, th, np.nextafter(th, np.float32(0)), np.nextafter(th, np.float32(2)),
                        np.float32([0.9995, 1.0 - 2 ** -24])]).astype(np.float32)
    u = np.clip(u, np.float32(2 ** -25), np.float32(1.0))
    gt, pt = tgrid.sample_discrete(torch.as_tensor(u), torch.as_tensor(cdf), torch.as_tensor(dist))
    from mcintegration_tpu.ops.lookup import pack_table
    gj, pj = jgrid.sample_discrete_cdf(jnp.asarray(u), jnp.asarray(cdf),
                                       jnp.asarray(pack_table(dist), jnp.float32), nbin)
    assert gt.dtype == torch.int32
    assert np.array_equal(gt.numpy(), np.asarray(gj))
    assert np.array_equal(pt.numpy(), np.asarray(pj))
    assert gt.max() <= nbin - 1
    if short:
        assert gt[-2].item() == nbin - 1


@pytest.mark.parametrize("ninc", [1024, 1000, 7])
def test_chain_continuous_draw_matches_jax(ninc):
    """The chain's Continuous draw (``sample_continuous`` on the port's
    ``(grid[:-1], inc)`` tables) equals ``sample_continuous_packed``."""
    leaf_t, leaf_j = mt.Continuous(0.0, 2.0, ninc=ninc), mj.Continuous(0.0, 2.0, ninc=ninc)
    h = _hist(ninc, 3)
    for leaf in (leaf_t, leaf_j):
        leaf.histogram = h.copy()
        leaf.train()
    u = np.random.default_rng(1).uniform(0, 1, 8192).astype(np.float32)
    u[:2] = [np.float32(0.5 * 2 ** -24), np.float32(1.0)]
    g, inc = leaf_t.device_params("cpu")
    xt, it, pt = tgrid.sample_continuous(torch.as_tensor(u), g, inc)
    xj, ij, pj = jgrid.sample_continuous_packed(jnp.asarray(u), leaf_j.device_params()["tab"], ninc)
    assert np.array_equal(it.numpy(), np.asarray(ij))
    assert np.array_equal(xt.numpy(), np.asarray(xj))
    assert np.array_equal(pt.numpy(), np.asarray(pj))


def test_params_from_jax_maps_discrete_leaves():
    d = dict(var=(mj.Continuous(0.0, 1.0, ninc=64), mj.Discrete(1, 37)), dof=[[1, 2]], seed=2)
    jc = mj.Configuration(**d)
    jc.var[1].histogram = _hist(37, 4)
    jc.var[1].train()
    tc = mt.Configuration(var=(mt.Continuous(0.0, 1.0, ninc=64), mt.Discrete(1, 37)),
                          dof=[[1, 2]], seed=2)
    tc.var[1].distribution = jc.var[1].distribution.copy()
    tc.var[1].accumulation = jc.var[1].accumulation.copy()
    import jax
    jparams = jax.tree_util.tree_map(np.asarray, JSpec(jc).device_params())
    tspec = Spec(tc, "cpu")
    got = params_from_jax(jparams, tspec)
    want = tspec.device_params()
    for (a, b), (c, e) in zip(got["leaf"], want["leaf"]):
        assert torch.equal(a, c) and torch.equal(b, e)
    assert torch.equal(got["reweight"], want["reweight"])


def test_probe_draws_int32_in_range_for_discrete():
    seen = []

    def f(x, c):
        t, d = x
        seen.append(d)
        return t[0] * d[0].to(torch.float32)

    spec = Spec(mt.Configuration(var=(mt.Continuous(0.0, 1.0), mt.Discrete(3, 5)),
                                 dof=[[1, 2]], seed=1), "cpu")
    ok, reason = spec.probe_batched(spec.make_eval_batched(f, False),
                                    spec.make_eval_vmapped(f, False))
    assert ok and reason == ""
    batched = [d for d in seen if d.ndim == 3]
    assert batched and all(d.dtype == torch.int32 for d in batched)
    assert all(int(d.min()) >= 3 and int(d.max()) <= 5 for d in batched)
