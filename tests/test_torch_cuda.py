"""PyTorch port: the CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (decided inside the
fixture, never at import).  Run on a machine with a card; ``--noconftest``
skips ``tests/conftest.py``, which sets up JAX (not needed here):

    python -m pytest tests/test_torch_cuda.py --noconftest -q -p no:randomly

``vegas_sample`` must match its plain version bit for bit; ``vegas_reduce``
forms the same float32 products and sums them in float64 in another order,
so obs and histograms agree to rel 1e-9.
"""

import numpy as np
import pytest
import torch

import mcintegration_tpu_torch as mt
from mcintegration_tpu_torch.ops import vegas_kernels as vk
from mcintegration_tpu_torch.ops.rng import block_keys
from mcintegration_tpu_torch.solvers.engine import Spec
from mcintegration_tpu_torch.solvers.vegas import VegasIteration

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
