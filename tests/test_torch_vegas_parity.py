"""PyTorch port: kernel K1 (pallas_vegas.build_run_all) against its port.

The same numpy per-block seeds ``kd`` and the same non-uniform map go to
the JAX ``VegasIteration(..., backend="pallas").raw_fn`` (the Pallas kernel
in interpret mode on the CPU) and to the port's ``VegasIteration.run`` (the
plain PyTorch versions of ``vegas_sample`` and ``vegas_reduce``).  Both
draw the identical samples (same counter hash, same multiplier table, same
chunks), so the only difference is accumulation: float32 with Kahan
summation in JAX, float64 in the port.  Tolerances: ``norm`` exact, per-block
``obs`` rel 1e-5, histogram rel 1e-4 (float32 row sums of up to 2048
squared weights in JAX).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mcintegration_tpu.configuration import Configuration as JConfiguration
from mcintegration_tpu.models.variable import Continuous as JContinuous
from mcintegration_tpu.ops.grid import train_grid
from mcintegration_tpu.solvers.engine import Spec as JSpec
from mcintegration_tpu.solvers.vegas import VegasIteration as JVegasIteration

import mcintegration_tpu_torch as mt
from mcintegration_tpu_torch.checkpoint import params_from_jax
from mcintegration_tpu_torch.ops import vegas_kernels as vk
from mcintegration_tpu_torch.solvers.engine import Spec
from mcintegration_tpu_torch.solvers.vegas import VegasIteration

torch.set_num_threads(1)


def _pi_j(x, c):
    return jnp.where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0)


def _pi_t(x, c):
    return torch.where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0)


def _two_j(x, c):
    return (x[0], jnp.where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0))


def _two_t(x, c):
    return (x[0], torch.where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0))


def _comp_j(x, c):      # CompositeVar of two pools: a 2-leaf padding group
    a, b = x
    return (a[0] * b[0], jnp.where(a[0] ** 2 + b[1] ** 2 < 1.0, 1.0, 0.0))


def _comp_t(x, c):
    a, b = x
    return (a[0] * b[0], torch.where(a[0] ** 2 + b[1] ** 2 < 1.0, 1.0, 0.0))


def _grid(ninc, seed):
    h = np.random.default_rng(seed).gamma(0.5, 1.0, ninc) + 1e-3
    return train_grid(np.linspace(0.0, 1.0, ninc + 1), h, 2.0)


def _var(pkg, ninc, composite):
    if composite:
        return pkg.Continuous([(0.0, 1.0), (0.0, 1.0)],
                              grid=[_grid(ninc, 1), _grid(ninc, 2)])
    return pkg.Continuous(0.0, 1.0, grid=_grid(ninc, 1))


def _pair(ninc, npb, dof, fj, ft, composite=False):
    import mcintegration_tpu as mj

    jspec = JSpec(JConfiguration(var=_var(mj, ninc, composite), dof=dof, seed=5))
    jit = JVegasIteration(jspec, fj, block=4, nevalperblock=npb, mesh=None,
                          backend="pallas")
    assert jit.backend == "pallas", jit.backend_reason
    tspec = Spec(mt.Configuration(var=_var(mt, ninc, composite), dof=dof, seed=5), "cpu")
    tit = VegasIteration(tspec, ft, block=4, nevalperblock=npb)
    return jspec, jit, tspec, tit


CASES = [  # (ninc, nevalperblock) -> (chunk, nchunks) = (8192, 1), (8192, 3), (16000, 2)
    (1024, 2 ** 13, [[2]], _pi_j, _pi_t, False),
    (64, 24576, [[2]], _pi_j, _pi_t, False),
    (1000, 2 ** 14, [[2]], _pi_j, _pi_t, False),
    (64, 24576, [[1], [2]], _two_j, _two_t, False),
    (64, 8192, [[1], [2]], _comp_j, _comp_t, True),
]


@pytest.mark.parametrize("ninc,npb,dof,fj,ft,composite", CASES,
                         ids=["1024", "64", "1000", "padding", "composite"])
def test_k1_parity(ninc, npb, dof, fj, ft, composite):
    jspec, jit, tspec, tit = _pair(ninc, npb, dof, fj, ft, composite)
    assert (tit.chunk, tit.nchunks, tit.nevalperblock) == \
        (jit.chunk, jit.nchunks, jit.nevalperblock)
    kd = np.random.default_rng(7).integers(0, 2 ** 32, (4, 2), dtype=np.uint32)
    jparams = jspec.device_params()
    obs_j, norm_j, hists_j = jit.raw_fn(jparams, jnp.asarray(kd))
    st = tit.run(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tspec), kd)

    assert np.array_equal(st["norm_blocks"], np.asarray(norm_j, np.float64))
    np.testing.assert_allclose(st["obs_blocks"], np.asarray(obs_j), rtol=1e-5, atol=0)
    for li, hj, ht in zip(tspec.leaves, hists_j, st["hists"]):
        assert ht.shape == (li.nhist,)
        np.testing.assert_allclose(ht, np.asarray(hj)[: li.nhist], rtol=1e-4, atol=0)
        assert ht.sum() > 0


def test_run_is_deterministic_and_counts_no_cpu_launch():
    spec = Spec(mt.Configuration(var=mt.Continuous(0.0, 1.0, ninc=64), dof=[[2]], seed=1),
                "cpu")
    it = VegasIteration(spec, _pi_t, block=4, nevalperblock=2 ** 13)
    kd = np.random.default_rng(3).integers(0, 2 ** 32, (4, 2), dtype=np.uint32)
    vk.reset_launch_counts()
    a, b = it.run(spec.device_params(), kd), it.run(spec.device_params(), kd)
    assert np.array_equal(a["obs_blocks"], b["obs_blocks"])
    assert np.array_equal(a["hists"][0], b["hists"][0])
    assert vk.launch_counts == {"vegas_sample": 0, "vegas_reduce": 0, "vegas_relw": 0,
                                "vegas_reduce_measure": 0, "vegas_reduce_complex": 0,
                                "vegas_relw_complex": 0, "vegas_sample_mixed": 0,
                                "vegas_reduce_mixed": 0, "vegas_relw_mixed": 0}


def test_launch_splitting_matches_one_launch(monkeypatch):
    """Cutting an iteration into several launches changes nothing but the
    float64 summation order (rel 1e-12)."""
    spec = Spec(mt.Configuration(var=mt.Continuous(0.0, 1.0, ninc=64), dof=[[2]], seed=1),
                "cpu")
    kd = np.random.default_rng(4).integers(0, 2 ** 32, (4, 2), dtype=np.uint32)
    one = VegasIteration(spec, _pi_t, block=4, nevalperblock=24576)
    import mcintegration_tpu_torch.solvers.vegas as tv
    monkeypatch.setattr(tv, "SAMPLES_PER_LAUNCH", 4 * one.chunk)   # one chunk per launch
    split = VegasIteration(spec, _pi_t, block=4, nevalperblock=24576)
    assert (one.launches_per_run, split.launches_per_run) == (1, 3)
    a, b = one.run(spec.device_params(), kd), split.run(spec.device_params(), kd)
    np.testing.assert_allclose(a["obs_blocks"], b["obs_blocks"], rtol=1e-12)
    np.testing.assert_allclose(a["hists"][0], b["hists"][0], rtol=1e-12)


def test_wrappers_refuse_other_devices():
    """Off the CPU a wrapper launches its kernel or raises: never the plain path."""
    meta = torch.device("meta")
    kd = torch.zeros((2, 2), dtype=torch.int64, device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        vk.vegas_sample(kd, 0, 1, torch.zeros((1, 64), dtype=torch.int32, device=meta),
                        torch.zeros((1, 8), device=meta), torch.zeros((1, 8), device=meta),
                        torch.zeros(1, dtype=torch.int32, device=meta), 4)
    w = torch.zeros((1, 2, 1, 8, 4), device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        vk.vegas_reduce(w, None, None, None, None, None)


def test_strata_bound_is_checked_on_every_device():
    """(a*p + s) mod nb is int32 in the kernel: more than 32768 strata raise,
    on the CPU as on the card, before anything is drawn."""
    big = vk.MAX_STRATA + 1
    with pytest.raises(ValueError, match="strata outside"):
        vk.vegas_sample(torch.zeros((2, 2), dtype=torch.int64), 0, 1,
                        torch.ones((1, 64), dtype=torch.int32), torch.zeros((1, big)),
                        torch.zeros((1, big)), torch.zeros(1, dtype=torch.int32), 1)
    spec = Spec(mt.Configuration(var=mt.Continuous(0.0, 1.0, ninc=big), dof=[[1]], seed=1),
                "cpu")
    it = VegasIteration(spec, lambda x, c: x[0], block=2, nevalperblock=big)
    with pytest.raises(ValueError, match="strata outside"):
        it.run(spec.device_params(), np.zeros((2, 2), np.uint32))
