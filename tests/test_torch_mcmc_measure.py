"""PyTorch port: ``mcmc_measure``, the :mcmc custom-measure accumulation.

On a measured step every sector's measure runs first, and one
``mcmc_measure`` call adds each walker's own sector's output into its
float64 accumulators (one launch on the card per ``MAX_SECTORS`` sectors).
Here, on the CPU:

- its plain version against the per-sector masked adds it replaced, written
  out below, bit for bit: one, two and three sectors, real and
  realified-complex components (all real parts, then all imaginary parts),
  walkers in the normalization sector;
- the sector runs a launch takes, and the argument list of the C entry
  point;
- two integrands with a custom measure per sector (the unit balls of
  ``tests/test_torch_mcmc_parity.py``), the port against the JAX package's
  :mcmc, K3 in interpret mode and the XLA route, within 7 combined sigma,
  and against the exact values.
"""

import ctypes
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mcintegration_tpu as mj
from mcintegration_tpu.solvers.engine import Spec as JSpec
from mcintegration_tpu.solvers.mcmc import MCMCIteration as JMCMCIteration

import mcintegration_tpu_torch as mt
from mcintegration_tpu_torch.ops import _build, mcmc_kernels as mk
from mcintegration_tpu_torch.solvers.engine import Spec
from mcintegration_tpu_torch.solvers.mcmc import MCMCIteration

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _layout(N, ncomp, W=96, block=4):
    spec = Spec(mt.Configuration(var=mt.Continuous(0.0, 1.0), dof=[[1]] * N, seed=1), CPU)
    return mk.McmcLayout.build(spec, block, W // block, ncomp, True)


def _inputs(lay, cplx, seed):
    """A state whose walkers sit in every sector, the normalization sector
    included, with accumulators already holding sums (zeros among them), and
    one output per sector (NaN in some columns of walkers elsewhere); complex
    outputs realified into ``[re; im]``."""
    rng = np.random.default_rng(seed)
    N, W, ncomp = lay.spec.N, lay.W, lay.ncomp
    st = mk.McmcState.zeros(lay)
    curr = rng.integers(0, N + 1, W).astype(np.int32)
    curr[:N + 1] = np.arange(N + 1)
    st.curr.copy_(torch.as_tensor(curr))
    obs = rng.normal(size=(ncomp, W))
    obs[:, ::5] = 0.0
    st.obs.copy_(torch.as_tensor(obs))
    if cplx:
        z = rng.normal(size=(N, ncomp // 2, W)) + 1j * rng.normal(size=(N, ncomp // 2, W))
        m = np.concatenate([z.real, z.imag], axis=1)
    else:
        m = rng.normal(size=(N, ncomp, W))
    for i in range(N):               # NaN where the walker sits in another sector
        m[i][:, (curr != i) & (np.arange(W) % 7 == 1)] = np.nan
    m = m.astype(np.float32)
    return st, [torch.as_tensor(m[i]) for i in range(N)]


def _per_sector(lay, ms, st):
    """The per-sector sequence of the one-launch-per-sector version."""
    for i in range(lay.spec.N):
        st.obs.add_(torch.where(st.curr == i, ms[i], 0.0).double())


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("N", [1, 2, 3])
def test_plain_matches_the_per_sector_adds(N, cplx):
    lay = _layout(N, 6)
    st, ms = _inputs(lay, cplx, seed=10 * N + cplx)
    ref = st.clone()
    mk.reset_launch_counts()
    mk.mcmc_measure(lay, ms, st)           # CPU tensors: the plain version
    _per_sector(lay, ms, ref)
    assert torch.equal(st.obs.view(torch.int64), ref.obs.view(torch.int64))
    norm = (st.curr == N).numpy()
    assert norm.any() and np.array_equal(st.obs.numpy()[:, norm], ref.obs.numpy()[:, norm])
    assert mk.launch_counts["mcmc_measure"] == 0
    with pytest.raises(ValueError, match="outputs for"):
        mk.mcmc_measure(lay, ms[:-1] if N > 1 else ms * 2, st)


def _source_constant(name):
    text = (Path(_build.CSRC) / "mcmc_measure.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


@pytest.mark.parametrize("n,want", [
    (1, [(0, 1)]),
    (mk.MAX_SECTORS, [(0, mk.MAX_SECTORS)]),
    (mk.MAX_SECTORS + 1, [(0, mk.MAX_SECTORS), (mk.MAX_SECTORS, mk.MAX_SECTORS + 1)])])
def test_sector_chunks(n, want):
    """Runs of at most MAX_SECTORS sectors (kMaxSectors of the kernel), in
    order, covering every sector once."""
    assert mk.MAX_SECTORS == _source_constant("kMaxSectors")
    chunks = mk.sector_chunks(n)
    assert chunks == want
    assert [i for lo, hi in chunks for i in range(lo, hi)] == list(range(n))
    assert all(0 < hi - lo <= mk.MAX_SECTORS for lo, hi in chunks)


@pytest.mark.parametrize("N", [2, mk.MAX_SECTORS + 1])
def test_argument_list_matches_the_c_signature(N):
    """Per launch: the first sector and the count, ncomp and W as C ints,
    then the host array of the run's output pointers, curr and obs."""
    lay = _layout(N, 4)
    st, ms = _inputs(lay, False, seed=N)
    types = _build._SIGNATURES["mci_mcmc_measure"]
    for lo, hi in mk.sector_chunks(N):
        args = mk._measure_args(lay, ms, st, lo, hi)
        assert args[:4] == (lo, hi - lo, lay.ncomp, lay.W)
        assert len(args) == len(types) - 1 and types[-1] is ctypes.c_void_p
        assert all(ty is ctypes.c_int for ty in types[:4])
        assert all(ty is ctypes.c_void_p for ty in types[4:])
        assert [p for p in args[4]] == [m.data_ptr() for m in ms[lo:hi]]
        assert args[5:] == (st.curr.data_ptr(), st.obs.data_ptr())


def test_many_sectors_helper_of_chip_smoke():
    """chip_smoke.py's check over MAX_SECTORS + 1 sectors runs on the CPU's
    plain path too (no launch)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert cs.measure_many_sectors(mt, mk, W=256, device="cpu") == (0.0, 0)


# ---------------------------------------------------------------------------
# two integrands, a custom measure per sector: the port against the JAX package
# ---------------------------------------------------------------------------

W, NSTEPS, THERMAL = 2048, 160, 0.2
OBS = [np.zeros(2), np.zeros(2)]
# sector i fills observable i with (1, x0) * relw: the ball's volume and its
# first moment; the quarter disc's is 1/3, the octant's pi/16
EXACT = [[np.pi / 4, 1.0 / 3.0], [np.pi / 6, np.pi / 16]]


def _balls(pkg):
    def f(i, x, c):
        r2 = x[0] ** 2 + x[1] ** 2 + (x[2] ** 2 if i == 1 else 0.0)
        return (jnp.where if pkg is jnp else torch.where)(r2 < 1.0, 1.0, 0.0)
    return f


def _balls_measure(pkg):
    def meas(i, x, relw, c):
        zero = pkg.zeros_like(relw)
        out = [pkg.stack([zero, zero]), pkg.stack([zero, zero])]
        out[i] = pkg.stack([relw, relw * x[0]])
        return out
    return meas


def _jax_run(backend, block):
    spec = JSpec(mj.Configuration(var=mj.Continuous(0.0, 1.0, ninc=128), dof=[[2], [3]],
                                  seed=5, obs=OBS))
    it = JMCMCIteration(spec, _balls(jnp), measure=_balls_measure(jnp), obs_proto=OBS,
                        block=block, nevalperblock=W * NSTEPS // block, backend=backend,
                        nwalkers=W, thermal_ratio=THERMAL)
    assert it.backend == backend, it.backend_reason
    return it.run(spec.device_params(), jax.random.key(4))


def _port_run(seed=3):
    spec = Spec(mt.Configuration(var=mt.Continuous(0.0, 1.0, ninc=128), dof=[[2], [3]],
                                 seed=5, obs=OBS), "cpu")
    it = MCMCIteration(spec, _balls(torch), measure=_balls_measure(torch), obs_proto=OBS,
                       block=16, nevalperblock=W * NSTEPS // 16, nwalkers=W,
                       thermal_ratio=THERMAL)
    assert it.backend_reason == ""
    kd = np.random.default_rng(seed).integers(0, 2 ** 32, (16, 2), dtype=np.uint32)
    return it.run(spec.device_params(), kd)


def _estimate(st):
    """Per-block obs/norm of both observables: mean and block error."""
    ob = np.concatenate([np.asarray(o).reshape(len(st["norm_blocks"]), -1)
                         for o in st["obs_blocks"]], axis=1)
    m = ob / np.asarray(st["norm_blocks"])[:, None]
    return m.mean(axis=0), m.std(axis=0, ddof=1) / np.sqrt(len(m))


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_two_sector_custom_measure_matches_jax(backend):
    mean, err = _estimate(_port_run())
    exact = np.ravel(EXACT)
    assert np.all(np.abs(mean - exact) < 7 * err), (mean, err, exact)
    mj_, ej = _estimate(_jax_run(backend, 2 if backend == "pallas" else 16))
    if backend == "pallas":     # two blocks: no error bar of its own
        ej = np.maximum(ej, err)
    assert np.all(np.abs(mean - mj_) < 7 * np.hypot(err, ej)), (backend, mean, mj_, err, ej)
