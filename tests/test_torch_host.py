"""PyTorch port: host-side math held bit for bit against the JAX package.

Grid training, statistics, configuration and the dof masks are float64
numpy (or plain Python) in both packages, copied verbatim into the port, so
every comparison here is exact equality on the same numpy inputs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mcintegration_tpu import configuration as jconf
from mcintegration_tpu import statistics as jstats
from mcintegration_tpu.common import onehot as j_onehot
from mcintegration_tpu.models.variable import Continuous as JContinuous
from mcintegration_tpu.ops import grid as jgrid
from mcintegration_tpu.solvers.engine import Spec as JSpec

from mcintegration_tpu_torch import configuration as tconf
from mcintegration_tpu_torch import statistics as tstats
from mcintegration_tpu_torch.common import onehot as t_onehot
from mcintegration_tpu_torch.models.variable import Continuous as TContinuous
from mcintegration_tpu_torch.ops import grid as tgrid
from mcintegration_tpu_torch.solvers.engine import Spec as TSpec

torch.set_num_threads(1)


def _hist(n, seed):
    return np.random.default_rng(seed).gamma(0.5, 1.0, n) + 1e-3


@pytest.mark.parametrize("ninc,alpha,seed", [(1024, 2.0, 0), (1000, 1.5, 1), (7, 0.5, 2)])
def test_train_grid_exact(ninc, alpha, seed):
    grid = np.sort(np.random.default_rng(seed).uniform(-1.0, 3.0, ninc + 1))
    hist = _hist(ninc, seed)
    assert np.array_equal(tgrid.train_grid(grid, hist, alpha),
                          jgrid.train_grid(grid, hist, alpha))
    assert np.array_equal(tgrid.smooth(hist, 6.0), jgrid.smooth(hist, 6.0))
    assert np.array_equal(tgrid.rescale(hist, alpha), jgrid.rescale(hist, alpha))
    for a, b in zip(tgrid.train_discrete(hist, alpha), jgrid.train_discrete(hist, alpha)):
        assert np.array_equal(a, b)
    for a, b in zip(tgrid.build_cdf(hist), jgrid.build_cdf(hist)):
        assert np.array_equal(a, b)
    acc = np.concatenate([[0.0], np.cumsum(hist)])
    for p in np.random.default_rng(seed).uniform(0, acc[-1], 50):
        assert tgrid.locate(acc, p) == jgrid.locate(acc, p)


def test_sample_continuous_matches_jax():
    # same float32 inputs, same float32 ops on both sides: exact
    rng = np.random.default_rng(3)
    grid = tgrid.train_grid(np.linspace(0, 2, 65), _hist(64, 3), 2.0)
    inc = np.diff(grid).astype(np.float32)
    g32 = grid.astype(np.float32)
    y = rng.uniform(0, 1, 4096).astype(np.float32)
    xt, it, pt = tgrid.sample_continuous(torch.as_tensor(y), torch.as_tensor(g32),
                                         torch.as_tensor(inc))
    xj, ij, pj = jgrid.sample_continuous(jnp.asarray(y), jnp.asarray(g32), jnp.asarray(inc))
    assert np.array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))


class _Cfg:
    def __init__(self, n=2, neval=100):
        self.N = n
        self.neval = neval


def test_statistics_exact():
    rng = np.random.default_rng(4)
    history = []
    for _ in range(5):
        m = rng.normal(1.0, 0.1, (16, 2))
        obs_sum, obs_sq = list(m.sum(axis=0)), list((m ** 2).sum(axis=0))
        tm, ts = tstats.mean_std(obs_sum, obs_sq, 16)
        jm, js = jstats.mean_std(obs_sum, obs_sq, 16)
        assert np.array_equal(tm, jm) and np.array_equal(ts, js)
        history.append((tm, ts, _Cfg()))
    for init in (0, 1, 3):
        for i in range(2):
            a = tstats.average(history, i, init=init)
            b = jstats.average(history, i, init=init)
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
    rt, rj = tstats.Result(history, 1), jstats.Result(history, 1)
    assert rt.mean == rj.mean and rt.stdev == rj.stdev and rt.chi2 == rj.chi2
    assert rt.neval == rj.neval and rt.dof() == rj.dof()
    assert tstats.tostring(rt.mean[0], rt.stdev[0]) == jstats.tostring(rj.mean[0], rj.stdev[0])


@pytest.mark.parametrize("dof", [[[2]], [[1], [2]], [[1, 0], [2, 1]]])
def test_configuration_and_spec_masks_match_jax(dof):
    nvar = len(dof[0])
    jc = jconf.Configuration(var=tuple(JContinuous(0.0, 1.0) for _ in range(nvar)),
                             dof=dof, seed=5, reweight=np.arange(1, len(dof) + 2))
    tc = tconf.Configuration(var=tuple(TContinuous(0.0, 1.0) for _ in range(nvar)),
                             dof=dof, seed=5, reweight=np.arange(1, len(dof) + 2))
    assert (tc.N, tc.dof, tc.maxdof, tc.norm, tc.neighbor) == \
        (jc.N, jc.dof, jc.maxdof, jc.norm, jc.neighbor)
    assert np.array_equal(tc.reweight, jc.reweight)
    js, ts = JSpec(jc), TSpec(tc, "cpu")
    assert np.array_equal(ts.mask_used, np.asarray(js.mask_used))
    assert np.array_equal(ts.mask_pad, np.asarray(js.mask_pad))
    assert ts.pad_trivial == js.pad_trivial
    assert ts.group_leaves == js.group_leaves


def test_onehot_matches_jax():
    idx = np.array([[1, 3], [5, 2]])
    relw = np.ones((2, 2), np.float32)
    a = t_onehot(torch.as_tensor(idx), 1, 5, torch.float32)
    b = j_onehot(jnp.asarray(idx), 1, 5, jnp.float32)
    assert np.array_equal(a.numpy(), np.asarray(b))
    a = t_onehot(torch.tensor(2), 0, 3, like=torch.as_tensor(relw))
    b = j_onehot(jnp.asarray(2), 0, 3, like=jnp.asarray(relw))
    assert np.array_equal(a.numpy(), np.asarray(b))


def test_device_params_cast_after_float64_diff():
    leaf = TContinuous(0.0, 1.0, ninc=64)
    leaf.histogram = _hist(64, 5)
    leaf.train()
    g, inc = leaf.device_params("cpu")
    assert g.dtype == inc.dtype == torch.float32 and g.shape == inc.shape == (64,)
    assert np.array_equal(inc.numpy(), np.diff(leaf.grid).astype(np.float32))
    assert np.array_equal(g.numpy(), leaf.grid[:-1].astype(np.float32))
