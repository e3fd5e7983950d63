"""PyTorch port: ``measurefreq = k > 1`` on :vegas and :vegasplus.

- The 2-D pi problem with ``k = 3``: one iteration of each solver against
  the JAX package's XLA route (``backend="xla"``), which samples the same
  law from another random stream, within 7 combined sigma, with the same
  normalization ``nevalperblock // k``.
- ``norm_blocks == nevalperblock // k`` exactly, which is the count of the
  samples the gate measures (``vegas_kernels.measured_mask`` and
  ``vplus_kernels.measured_mask`` over every chunk of a block).
- The gate in ``vegas_reduce_plain`` by hand.
- On :vegasplus' cube-major chunks the reference's gate, where ``k``
  divides the chunk, measures floor or ceil(n_c/k) of a cube's ``n_c``
  samples in every chunk, and so weights the cubes unevenly (a fault of the
  reference); the port's random cyclic shift of the gate's positions per
  (block, chunk) measures every cube at the rate ``1/k`` exactly in
  expectation and keeps each chunk's count.
- A fault of the reference (ROADMAP.md, known faults in the reference): its
  XLA routes pass ``relw`` zeroed at unmeasured samples to a custom measure
  and sum the measure's output over every sample, so a measure term that
  does not scale with ``relw`` counts unmeasured samples too.  A measure
  returning 1 per sample with ``k = 4`` gives a mean of exactly 1 in the
  port (the gate of ``montecarlo.jl:148``) and 4 in the reference.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mcintegration_tpu as mj
from mcintegration_tpu.solvers.engine import Spec as JSpec
from mcintegration_tpu.solvers.vegas import VegasIteration as JVegasIteration
from mcintegration_tpu.solvers.vegasplus import VegasPlusIteration as JVegasPlusIteration

import mcintegration_tpu_torch as mt
from mcintegration_tpu_torch.ops import vegas_kernels as vk, vplus_kernels as vp
from mcintegration_tpu_torch.solvers.engine import Spec
from mcintegration_tpu_torch.solvers.vegas import VegasIteration
from mcintegration_tpu_torch.solvers.vegasplus import VegasPlusIteration

torch.set_num_threads(1)

KW = {"vegas": dict(block=16, nevalperblock=2 ** 13),
      "vegasplus": dict(block=16, nevalperblock=2 ** 13, max_cubes=256)}
CLASSES = {"vegas": (VegasIteration, JVegasIteration),
           "vegasplus": (VegasPlusIteration, JVegasPlusIteration)}


def pi_f(pkg):
    return lambda x, c: pkg.where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0)


def _estimate(m):
    return m.mean(axis=0), m.std(axis=0, ddof=1) / np.sqrt(len(m))


def _kd(seed, block=16):
    return np.random.default_rng(seed).integers(0, 2 ** 32, (block, 2), dtype=np.uint32)


@pytest.mark.parametrize("solver", ["vegas", "vegasplus"])
def test_measurefreq_matches_jax_xla_route(solver):
    tcls, jcls = CLASSES[solver]
    tspec = Spec(mt.Configuration(var=mt.Continuous(0.0, 1.0, ninc=64), dof=[[2]], seed=5), "cpu")
    tit = tcls(tspec, pi_f(torch), measurefreq=3, **KW[solver])
    jspec = JSpec(mj.Configuration(var=mj.Continuous(0.0, 1.0, ninc=64), dof=[[2]], seed=5))
    jit = jcls(jspec, pi_f(jnp), measurefreq=3, backend="xla", **KW[solver])
    assert tit.nevalperblock == jit.nevalperblock
    st = tit.run(tspec.device_params(), _kd(7))
    sj = jit.run(jspec.device_params(), jax.random.key(7))
    norm_t, norm_j = st["norm_blocks"], np.asarray(sj["norm_blocks"], np.float64)
    assert np.all(norm_t == tit.nevalperblock // 3) and np.array_equal(norm_t, norm_j)
    mt_, et = _estimate(st["obs_blocks"][:, 0] / norm_t)
    mj_, ej = _estimate(np.asarray(sj["obs_blocks"])[:, 0] / norm_j)
    assert abs(mt_ - mj_) < 7 * np.hypot(et, ej), (mt_, mj_, et, ej)
    assert abs(mt_ - np.pi / 4) < 7 * et, (mt_, et)


@pytest.mark.parametrize("k", [1, 2, 3, 7, 5000])
@pytest.mark.parametrize("solver", ["vegas", "vegasplus"])
def test_norm_counts_the_measured_samples(solver, k):
    """A block's normalization is nevalperblock // k, the samples the gate
    opens for over every chunk of the block; a measure that returns 1 per
    sample sums to it exactly."""
    spec = Spec(mt.Configuration(var=mt.Continuous(0.0, 1.0, ninc=64), dof=[[2]], obs=[0.0],
                                 seed=5), "cpu")
    kw = dict(KW[solver], block=2)
    it = CLASSES[solver][0](spec, pi_f(torch), measurefreq=k,
                            measure=lambda x, relw, c: [torch.ones_like(relw[0])],
                            obs_proto=[0.0], **kw)
    st = it.run(spec.device_params(), _kd(1, 2))
    if solver == "vegas":
        gate = vk.measured_mask(it.nchunks, it.nb, it.m_tile, k, 0, "cpu")
    else:
        gate = vp.measured_mask(it.nchunks, it.chunk, k, 0, "cpu")
    assert int(gate.sum()) == it.nevalperblock // k
    assert np.all(st["norm_blocks"] == it.nevalperblock // k)
    assert np.array_equal(st["obs_blocks"][0], st["norm_blocks"])


def test_vegas_reduce_plain_gate_by_hand():
    """One slot, one block, two chunks (t0 = 2) of one stratum of three
    samples: indices 7..12 of the block, of which 8 and 12 are measured at
    k = 4; the histogram takes all six."""
    w = torch.tensor([[[[[1.0, 2.0, 4.0]], [[8.0, 16.0, 32.0]]]]])
    invp = torch.full((1, 1, 2, 1), 0.5)
    perm = torch.zeros((1, 1, 2, 1), dtype=torch.int32)
    pad = torch.zeros((1, 1), dtype=torch.int32)
    pair_slots = torch.tensor([[0]], dtype=torch.int32)
    used = torch.ones((1, 1), dtype=torch.int32)
    obs, hrow = vk.vegas_reduce(w, invp, perm, pad, pair_slots, used, mf=4, t0=2)
    assert obs[0, :, 0].tolist() == [2.0 * 0.5, 32.0 * 0.5]
    assert hrow[0, 0, :, 0].tolist() == [0.25 * (1 + 4 + 16), 0.25 * (64 + 256 + 1024)]
    m = torch.arange(12.0).reshape(2, 1, 2, 1, 3)
    obs_m, _ = vk.vegas_reduce(w, invp, perm, pad, pair_slots, used, m, mf=4, t0=2)
    assert obs_m[0].tolist() == [[1.0, 7.0], [5.0, 11.0]]


def _ones_measure(pkg):
    def measure(x, relw, c):
        one = relw[0] * 0.0 + 1.0
        return [one if pkg is jnp else torch.ones_like(relw[0])]
    return measure


@pytest.mark.parametrize("solver", ["vegas", "vegasplus"])
def test_measure_term_without_relw_is_gated_unlike_the_reference(solver):
    kw = dict(var=mt.Continuous(0.0, 1.0, ninc=64), dof=[[2]], obs=[0.0], neval=2 ** 14,
              niter=2, solver=solver, measurefreq=4, verbose=-2, seed=3)
    res = mt.integrate(pi_f(torch), measure=_ones_measure(torch), device="cpu", **kw)
    assert float(res.mean[0]) == 1.0 and float(res.stdev[0]) == 0.0
    kw["var"] = mj.Continuous(0.0, 1.0, ninc=64)
    ref = mj.integrate(pi_f(jnp), measure=_ones_measure(jnp), backend="xla", **kw)
    assert float(ref.mean[0]) == 4.0 and float(ref.stdev[0]) == 0.0


def test_vegasplus_gate_measures_every_cube_at_rate_1_over_k():
    c, k = 64, 4
    counts = np.array([2, 3, 2, 9, 5, 2, 7, 2, 10, 2, 3, 6, 2, 3, 6])
    assert counts.sum() == c and c % k == 0
    cube = np.repeat(np.arange(len(counts)), counts)
    fixed = vp.measured_mask(1, c, k, 0, "cpu")[0].numpy()           # the reference's gate
    share = k * np.bincount(cube, fixed, len(counts)) / counts
    assert share.min() == 0.0 and share.max() == 2.0
    every = vp.measured_mask(1, c, k, 0, "cpu", torch.arange(c, dtype=torch.int32)[:, None])
    assert every.shape == (c, 1, c) and np.all(every.sum(dim=-1).numpy() == c // k)
    measured = sum(np.bincount(cube, g[0].numpy(), len(counts)) for g in every)
    assert np.array_equal(measured * k, counts * c)                # n_c / k a shift, on average
    kd = torch.as_tensor(_kd(2, 3).view(np.int32))
    sh = vp.gate_shifts(kd, 5, 4, 1000)
    assert sh.shape == (3, 4) and sh.dtype == torch.int32
    assert int(sh.min()) >= 0 and int(sh.max()) < 1000 and len(set(sh.flatten().tolist())) > 8
    assert torch.equal(sh[:, 1:], vp.gate_shifts(kd, 6, 3, 1000))
