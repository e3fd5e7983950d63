"""PyTorch port: ``MCMCIteration.run`` against the JAX package's :mcmc.

The port (the kernels' plain versions on the CPU) samples the law of K3,
``pallas_mcmc.py:build_mcmc_run_all``, which the JAX package runs here in
interpret mode (``backend="pallas"``), from another random stream; its XLA
route (``backend="xla"``) samples the reference's unscheduled law.  Per
case, from one iteration of each at the same walker count and chain
length:

- obs/norm per integrand within 7 combined sigma of each JAX route, and of
  the exact value;
- visited shares within 0.02;
- the same occupied propose cells, and acceptance within 0.05 in every cell
  with more than 100 proposals (``tests/test_pallas.py:706-727``);
- the histograms' total mass within 5 % (K3 subsamples it by 8).

The JAX kernel route needs ``block * 1024`` walkers per tile, so it runs 2
blocks of 1024 walkers where the port and the XLA route run 16 of 128: its
two-block spread is no error bar, so the port's, from the same law at the
same size, stands for it.  With two schedules only, its visited shares
spread more too: on the unit balls sector 0's share moves by a few
hundredths from key to key, where the port's 16 schedules hold it within
0.01 over seeds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mcintegration_tpu as mj
from mcintegration_tpu.solvers.engine import Spec as JSpec
from mcintegration_tpu.solvers.mcmc import MCMCIteration as JMCMCIteration

import mcintegration_tpu_torch as mt
from mcintegration_tpu_torch.ops import mcmc_kernels as mk
from mcintegration_tpu_torch.ops.rng import schedule, schedule_np
from mcintegration_tpu_torch.solvers.engine import Spec
from mcintegration_tpu_torch.solvers.mcmc import MCMCIteration, choose_walkers

torch.set_num_threads(1)

W, NSTEPS, THERMAL = 2048, 160, 0.2
KF3, DK3, KF2, DK2 = 1.0, 0.2, 1.0, 0.3


def _where(pkg, c, a, b):
    return jnp.where(c, a, b) if pkg is jnp else torch.where(c, a, b)


def _pi(pkg):
    return lambda i, x, c: _where(pkg, x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0)


def _balls(pkg):
    def f(i, x, c):
        r2 = x[0] ** 2 + x[1] ** 2 + (x[2] ** 2 if i == 1 else 0.0)
        return _where(pkg, r2 < 1.0, 1.0, 0.0)
    return f


def _td(pkg):
    def f(i, x, c):
        t, d = x
        return t[0] * (d[0].astype(jnp.float32) if pkg is jnp else d[0].to(torch.float32))
    return f


def _shell3(pkg):
    def f(i, x, c):
        K, T = x
        k2 = K[0][0] ** 2 + K[0][1] ** 2 + K[0][2] ** 2
        k = pkg.sqrt(k2)
        return _where(pkg, (k > KF3 - DK3) & (k < KF3 + DK3), k2 * pkg.exp(-T[0]), 0.0)
    return f


def _shell2(pkg):
    def f(i, x, c):
        k2 = x[0][0] ** 2 + x[0][1] ** 2
        k = pkg.sqrt(k2)
        return _where(pkg, (k > KF2 - DK2) & (k < KF2 + DK2), k2, 0.0)
    return f


CASES = {
    "pi": (lambda p: p.Continuous(0.0, 1.0, ninc=128), [[2]], _pi, [np.pi / 4]),
    "balls": (lambda p: p.Continuous(0.0, 1.0, ninc=128), [[2], [3]], _balls,
              [np.pi / 4, np.pi / 6]),
    "discrete": (lambda p: (p.Continuous(0.0, 1.0, ninc=128), p.Discrete(1, 4)), [[1, 1]],
                 _td, [5.0]),
    "fermik3": (lambda p: (p.FermiK(3, KF3, DK3, 10.0), p.Continuous(0.0, 1.0, ninc=128)),
                [[1, 1]], _shell3,
                [4 * np.pi / 5 * ((KF3 + DK3) ** 5 - (KF3 - DK3) ** 5) * (1 - np.exp(-1.0))]),
    "fermik2": (lambda p: p.FermiK(2, KF2, DK2, 10.0), [[1]], _shell2,
                [np.pi / 2 * ((KF2 + DK2) ** 4 - (KF2 - DK2) ** 4)]),
}


def _jax_run(case, backend, block):
    var, dof, f, _ = CASES[case]
    spec = JSpec(mj.Configuration(var=var(mj), dof=dof, seed=5))
    it = JMCMCIteration(spec, f(jnp), block=block, nevalperblock=W * NSTEPS // block,
                        backend=backend, nwalkers=W, thermal_ratio=THERMAL)
    assert it.backend == backend, it.backend_reason
    assert (it.nwalkers, it.nsteps) == (W, NSTEPS)
    return it.run(spec.device_params(), jax.random.key(4))


def _port_run(case, seed=3):
    var, dof, f, _ = CASES[case]
    spec = Spec(mt.Configuration(var=var(mt), dof=dof, seed=5), "cpu")
    it = MCMCIteration(spec, f(torch), block=16, nevalperblock=W * NSTEPS // 16, nwalkers=W,
                       thermal_ratio=THERMAL)
    kd = np.random.default_rng(seed).integers(0, 2 ** 32, (16, 2), dtype=np.uint32)
    return it, it.run(spec.device_params(), kd)


def _estimate(st):
    m = st["obs_blocks"] / st["norm_blocks"][:, None]
    return m.mean(axis=0), m.std(axis=0, ddof=1) / np.sqrt(m.shape[0])


def _acceptance(st):
    p, a = st["propose"], st["accept"]
    return p > 1.0, a / np.maximum(p, 1e-9), p > 100


@pytest.mark.parametrize("case", list(CASES))
def test_run_matches_jax(case):
    mk.reset_launch_counts()
    it, st = _port_run(case)
    assert mk.launch_counts == {"mcmc_propose": 0, "mcmc_accept": 0, "mcmc_measure": 0,
                                "mcmc_accept_complex": 0}
    assert st["neval"] == W * (NSTEPS + int(NSTEPS * THERMAL)) == it.neval
    assert st["visited"].sum() == it.neval            # every walker, every step
    mean, err = _estimate(st)
    exact = np.asarray(CASES[case][3])
    assert np.all(np.abs(mean - exact) < 7 * err), (mean, err, exact)
    occ, acc, busy = _acceptance(st)
    for backend, block in (("pallas", 2), ("xla", 16)):
        sj = _jax_run(case, backend, block)
        mj_, ej = _estimate(sj)
        if backend == "pallas":
            ej = np.maximum(ej, err)
            assert sj["neval"] == st["neval"]
        assert np.all(np.abs(mean - mj_) < 7 * np.hypot(err, ej)), (backend, mean, mj_, err, ej)
        vt, vj = st["visited"] / st["visited"].sum(), sj["visited"] / sj["visited"].sum()
        assert np.all(np.abs(vt - vj) < 0.02), (backend, vt, vj)
        occ_j, acc_j, busy_j = _acceptance(sj)
        # the XLA route tallies a swap on every swap step, also where the two
        # slots coincide (a group of one slot); K3 and the port only a move
        rows = 3 if backend == "pallas" else 2
        assert np.array_equal(occ[:rows], occ_j[:rows]), (backend, st["propose"], sj["propose"])
        both = busy & busy_j
        assert both.any() and np.all(np.abs(acc - acc_j)[both] < 0.05), (backend, acc, acc_j)
        for h, hj, li in zip(st["hists"], sj["hists"], it.spec.leaves):
            if li.leaf.adapt:
                assert abs(h.sum() / hj.sum() - 1) < 0.05, (backend, h.sum(), hj.sum())


def test_same_seed_reproduces_bit_for_bit():
    _, a = _port_run("balls", seed=7)
    _, b = _port_run("balls", seed=7)
    for key in ("obs_blocks", "norm_blocks", "visited", "propose", "accept"):
        assert np.array_equal(a[key], b[key]), key
    assert all(np.array_equal(x, y) for x, y in zip(a["hists"], b["hists"]))


def test_blocks_draw_independent_schedules():
    """Each block draws its own sector per step from its own seed: columns
    differ, each is uniform over the sectors, and a block's column depends on
    its seed alone (so the block error bars see the schedule's noise)."""
    kd = np.random.default_rng(0).integers(0, 2 ** 32, (16, 2), dtype=np.uint32)
    s = schedule_np(kd, 4000, 3, 5, True)
    assert np.array_equal(s, schedule(torch.as_tensor(kd.astype(np.int64)), 4000, 3, 5,
                                      True).numpy())
    j, sw = s >> 1, s & 1
    assert len({tuple(col) for col in j.T}) == 16
    assert np.all(np.abs(np.stack([np.bincount(c, minlength=3) for c in j.T]) / 4000 - 1 / 3)
                  < 0.03)
    assert abs(sw.mean() - 1 / 5) < 0.01
    kd2 = kd.copy()
    kd2[5] += 1
    s2 = schedule_np(kd2, 4000, 3, 5, True)
    assert np.array_equal(np.delete(s, 5, axis=1), np.delete(s2, 5, axis=1))
    assert not np.array_equal(s[:, 5], s2[:, 5])
    assert not schedule_np(kd, 50, 3, 5, False).__and__(1).any()      # no swap flag


@pytest.mark.parametrize("n,nvar,neval,nwalkers,min_steps,want", [
    (1, 1, 2 ** 20, None, 256, (5456, 192)),     # steps_min = 256*1*3//4 = 192
    (3, 2, 2 ** 20, None, 256, (1632, 642)),     # steps_min = 256*3*5//6 = 640
    (1, 1, 2 ** 30, None, 256, (65536, 16384)),  # capped at 65536 walkers
    (1, 1, 10 ** 4, None, 256, (48, 208)),       # rounded down to the block
    (1, 1, 2 ** 16, None, 16, (1024, 64)),       # at least 64 steps per walker
    (1, 1, 2 ** 20, 1000, 256, (992, 1057)),     # nwalkers overrides
])
def test_choose_walkers(n, nvar, neval, nwalkers, min_steps, want):
    """The JAX kernel route's steps rule (solvers/mcmc.py:154-156)."""
    assert choose_walkers(neval, 16, nwalkers, min_steps, n, nvar) == want
