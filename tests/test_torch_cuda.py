"""PyTorch port: the CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (decided inside the
fixture, never at import).  Run on a machine with a card; ``--noconftest``
skips ``tests/conftest.py``, which sets up JAX (not needed here):

    python -m pytest tests/test_torch_cuda.py --noconftest -q -p no:randomly

``vegas_sample`` must match its plain version bit for bit; ``vegas_reduce``
forms the same float32 products and sums them in float64 in another order,
so obs and histograms agree to rel 1e-9.  ``chain_propose`` and
``chain_accept`` must match theirs bit for bit from one state, but for the
chain histogram (float64 atomics in another order: rel 1e-9).
"""

import numpy as np
import pytest
import torch

import mcintegration_tpu_torch as mt
from mcintegration_tpu_torch.ops import chain_kernels as ck, vegas_kernels as vk
from mcintegration_tpu_torch.ops.rng import block_keys
from mcintegration_tpu_torch.solvers.engine import Spec
from mcintegration_tpu_torch.solvers.vegas import VegasIteration
from mcintegration_tpu_torch.solvers.vegasmc import VegasMCIteration

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
