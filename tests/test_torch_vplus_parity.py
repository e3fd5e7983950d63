"""PyTorch port: the :vegasplus pieces against the JAX package.

- The shape plan, the uniform counts and the Neyman reallocation are float64
  numpy and integers in both packages: bit for bit.
- One ``VegasPlusIteration.run`` against the JAX XLA route
  (``mcintegration_tpu/solvers/vegasplus.py:168-318``) from the same trained
  float32 maps and the same non-uniform counts (one Neyman reallocation from
  uniform).  The two sample the same law from different random streams, so
  they agree statistically: per-block means within 6 combined sigma; each
  leaf's histogram, normalised and summed into 8 coarse bins, within 0.02 of
  the total; the per-cube second moments, normalised and summed over each
  coarse row of cubes, within 0.03 (from seed to seed either package moves
  by about 0.005 and 0.01 there).
- One run against kernel K4 (``pallas_vplus.build_vplus_run_all``) in
  interpret mode.  K4's law is the port's with ``counts = lanes * spp`` on
  the coarsened grid ``leaf.grid[::k]``: block means within 6 combined sigma,
  the second moments per coarse row (after K4's host-side undo) within 0.03,
  the folded histogram in 8 coarse bins within 0.02, and the shares of the
  budget that each side's reallocation then gives the cubes within 0.15 in
  total variation.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mcintegration_tpu as mj
from mcintegration_tpu.ops.grid import train_grid
from mcintegration_tpu.solvers.engine import Spec as JSpec
from mcintegration_tpu.solvers.vegasplus import VegasPlusIteration as JVegasPlusIteration

import mcintegration_tpu_torch as mt
from mcintegration_tpu_torch.checkpoint import params_from_jax
from mcintegration_tpu_torch.ops import vplus_kernels as vp
from mcintegration_tpu_torch.solvers.engine import Spec
from mcintegration_tpu_torch.solvers.vegasplus import VegasPlusIteration, shape_plan

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# host math, bit for bit
# ---------------------------------------------------------------------------

def _jax_iteration(D, **kw):
    spec = JSpec(mj.Configuration(var=mj.Continuous(0.0, 1.0, ninc=16), dof=[[D]], seed=1))
    return JVegasPlusIteration(spec, lambda x, c: x[0], block=2, backend="xla", **kw)


def _torch_iteration(D, **kw):
    spec = Spec(mt.Configuration(var=mt.Continuous(0.0, 1.0, ninc=16), dof=[[D]], seed=1), "cpu")
    return VegasPlusIteration(spec, lambda x, c: x[0], block=2, **kw)


@pytest.mark.parametrize("D", [1, 2, 3, 5, 9, 10])
def test_shape_plan_matches_jax(D):
    for npb in (100, 5000, 40000, 300000):
        for max_cubes in (16, 256, 16384):
            j = _jax_iteration(D, nevalperblock=npb, max_cubes=max_cubes)
            plan = shape_plan(D, npb, None, max_cubes)
            assert plan == (j.nstrat, j.ncubes, j.chunk, j.nchunks), (npb, max_cubes)
    t = _torch_iteration(D, nevalperblock=5000, max_cubes=256)
    j = _jax_iteration(D, nevalperblock=5000, max_cubes=256)
    assert (t.nstrat, t.ncubes, t.chunk, t.nchunks, t.nevalperblock) == \
        (j.nstrat, j.ncubes, j.chunk, j.nchunks, j.nevalperblock)
    assert t.counts.dtype == j.counts.dtype and np.array_equal(t.counts, j.counts)
    j2 = _jax_iteration(D, nevalperblock=5000, nstrat=3)
    assert shape_plan(D, 5000, 3) == (j2.nstrat, j2.ncubes, j2.chunk, j2.nchunks)


def _sigs(ncubes, chunk):
    rng = np.random.default_rng(11)
    peaked = np.full(ncubes, 1e-12)
    peaked[:3] = [4.0, 1.0, 0.5]                 # most cubes floor to 2: excess > 0
    nan = rng.gamma(1.0, 1.0, ncubes)
    nan[5] = np.nan
    return {"random": rng.gamma(0.3, 1.0, ncubes), "zero": np.zeros(ncubes), "nan": nan,
            "negative": -rng.gamma(1.0, 1.0, ncubes), "excess>0": peaked,
            "excess<0": np.ones(ncubes) + 1e-3 * rng.uniform(size=ncubes),
            "padded": np.concatenate([rng.gamma(0.3, 1.0, ncubes), np.full(7, 9e9)])}


@pytest.mark.parametrize("case", ["random", "zero", "nan", "negative", "excess>0", "excess<0",
                                  "padded"])
def test_reallocate_matches_jax(case):
    kw = dict(nevalperblock=5000, max_cubes=256)
    j, t = _jax_iteration(2, **kw), _torch_iteration(2, **kw)
    sig = _sigs(t.ncubes, t.chunk)[case]
    start = t.counts.copy()
    for _ in range(2):                           # the second from non-uniform counts
        j._reallocate(sig)
        t._reallocate(sig)
        assert np.array_equal(t.counts, j.counts)
        assert t.counts.sum() == t.chunk and t.counts.min() >= 2
    moved = not np.array_equal(t.counts, start)
    assert moved == (case not in ("zero", "nan", "negative"))
    if case.startswith("excess"):               # the branch the case is named for
        d = np.sqrt(sig / start)
        d = (d / d.sum()) ** t.beta
        raw = np.maximum(2, np.floor(d / d.sum() * t.chunk).astype(np.int64))
        assert (raw.sum() > t.chunk) == (case == "excess>0") and raw.sum() != t.chunk
    t.reset_state()
    assert np.array_equal(t.counts, start)


# ---------------------------------------------------------------------------
# the law of the kernels against the XLA route
# ---------------------------------------------------------------------------

def _grid(lower, upper, ninc, seed):
    h = np.random.default_rng(seed).gamma(0.5, 1.0, ninc) + 1e-3
    return train_grid(np.linspace(lower, upper, ninc + 1), h, 2.0)


def _where(pkg):
    return jnp.where if pkg is mj else torch.where


def _f32(pkg, d):
    return d.astype(jnp.float32) if pkg is mj else d.to(torch.float32)


def _peak(pkg):
    exp = jnp.exp if pkg is mj else torch.exp
    return lambda x, c: exp(-20 * ((x[0] - 0.3) ** 2 + (x[1] - 0.7) ** 2))


def _peak3(pkg):
    exp = jnp.exp if pkg is mj else torch.exp
    return lambda x, c: exp(-8 * ((x[0] - 0.3) ** 2 + (x[1] - 0.7) ** 2 + (x[2] - 0.5) ** 2))


def _two(pkg):
    where = _where(pkg)
    return lambda x, c: (x[0], where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0))


def _passenger(pkg):
    def f(x, c):
        t, d = x
        return t[0], t[0] * t[1] * _f32(pkg, d[0])
    return f


LAW_CASES = {
    # name: (var, dof, integrand, nevalperblock, max_cubes)
    "2d": (lambda p: p.Continuous(0.0, 1.0, grid=_grid(0, 1, 64, 1)), [[2]], _peak, 2 ** 14, 256),
    # nstrat = 6 does not divide ninc = 64: a cube's edge falls inside a bin
    "3d-ragged": (lambda p: p.Continuous(0.0, 1.0, grid=_grid(0, 1, 64, 2)), [[3]], _peak3,
                  2 ** 14, 216),
    "padding": (lambda p: p.Continuous(0.0, 1.0, grid=_grid(0, 1, 32, 3)), [[1], [2]], _two,
                2 ** 14, 64),
    "passenger": (lambda p: (p.Continuous(0.0, 1.0, grid=_grid(0, 1, 32, 4)), p.Discrete(1, 4)),
                  [[1, 0], [2, 1]], _passenger, 2 ** 14, 64),
}


def _counts(ncubes, chunk, seed):
    """Non-uniform counts with the floor of 2 that sum to the chunk."""
    w = np.random.default_rng(seed).gamma(0.4, 1.0, ncubes)
    counts = 2 + np.floor(w / w.sum() * (chunk - 2 * ncubes)).astype(np.int64)
    counts[np.argmax(counts)] += chunk - counts.sum()
    return counts


def _block_stats(obs_blocks, norm_blocks):
    m = np.asarray(obs_blocks, np.float64) / np.asarray(norm_blocks, np.float64)[:, None]
    return m.mean(axis=0), m.std(axis=0, ddof=1) / np.sqrt(m.shape[0])


def _coarse(h, nbins=8):
    """A histogram normalised to 1 and summed into ``nbins`` coarse bins."""
    h = np.asarray(h, np.float64)
    edges = np.linspace(0, len(h), nbins + 1).astype(int)
    return np.add.reduceat(h, edges[:-1]) / h.sum()


def _rows(sig, nstrat, D):
    """Per-cube second moments normalised to 1 and summed over each coarse
    row of cubes: for every dim, the share of each of its ``nstrat`` slabs."""
    s = np.asarray(sig, np.float64).reshape((nstrat,) * D) / np.sum(sig)
    return np.stack([s.sum(axis=tuple(a for a in range(D) if a != d)) for d in range(D)])


@pytest.mark.parametrize("case", list(LAW_CASES))
def test_run_matches_jax_xla_route(case):
    var, dof, f, npb, max_cubes = LAW_CASES[case]
    kw = dict(block=8, nevalperblock=npb, max_cubes=max_cubes)
    jspec = JSpec(mj.Configuration(var=var(mj), dof=dof, seed=5))
    jit = JVegasPlusIteration(jspec, f(mj), backend="xla", **kw)
    tspec = Spec(mt.Configuration(var=var(mt), dof=dof, seed=5), "cpu")
    tit = VegasPlusIteration(tspec, f(torch), **kw)
    assert (tit.nstrat, tit.ncubes, tit.chunk, tit.nchunks) == \
        (jit.nstrat, jit.ncubes, jit.chunk, jit.nchunks)
    if case == "3d-ragged":
        assert tspec.leaves[0].leaf.ninc % tit.nstrat != 0
    jparams = dict(jspec.device_params())
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tspec)
    tit.run(tparams, np.random.default_rng(9).integers(0, 2 ** 32, (8, 2), dtype=np.uint32))
    counts = tit.counts.copy()                   # one reallocation from uniform
    assert counts.max() > 2 * counts.min()
    jparams["counts"] = jnp.asarray(counts, jnp.int32)
    kd_j = jax.random.key_data(jax.random.split(jax.random.key(3), 8))
    obs_j, norm_j, hists_j, sig_j = jit._fn(jparams, kd_j)

    tit.counts = counts.copy()
    vp.reset_launch_counts()
    st = tit.run(tparams, np.random.default_rng(3).integers(0, 2 ** 32, (8, 2), dtype=np.uint32))
    assert vp.launch_counts == {"vplus_sample": 0, "vplus_reduce": 0, "vplus_reduce_measure": 0,
                                "vplus_reduce_complex": 0, "vplus_relw": 0}
    assert np.array_equal(st["norm_blocks"], np.asarray(norm_j, np.float64))

    mt_, st_ = _block_stats(st["obs_blocks"], st["norm_blocks"])
    mj_, sj = _block_stats(np.asarray(obs_j), np.asarray(norm_j))
    assert np.all(np.abs(mt_ - mj_) < 6 * np.hypot(st_, sj)), (mt_, mj_, st_, sj)
    for li, hj, ht in zip(tspec.leaves, hists_j, st["hists"]):
        assert ht.shape == (li.nhist,) and ht.sum() > 0
        hj = np.asarray(hj, np.float64)[: li.nhist]
        assert np.abs(_coarse(ht) - _coarse(hj)).max() < 0.02, (_coarse(ht), _coarse(hj))
    D = tit.layout.D
    rows_t = _rows(tit.last_sig, tit.nstrat, D)
    rows_j = _rows(np.asarray(sig_j, np.float64)[: tit.ncubes], tit.nstrat, D)
    assert np.abs(rows_t - rows_j).max() < 0.03, (rows_t, rows_j)
    assert tit.counts.sum() == tit.chunk and tit.counts.min() >= 2
    assert not np.array_equal(tit.counts, counts)


# ---------------------------------------------------------------------------
# against kernel K4 in interpret mode
# ---------------------------------------------------------------------------

def test_run_matches_k4_interpret():
    grid = _grid(0, 1, 1024, 7)
    jspec = JSpec(mj.Configuration(var=mj.Continuous(0.0, 1.0, grid=grid), dof=[[2]], seed=31))
    jit = JVegasPlusIteration(jspec, _peak(mj), block=4, nevalperblock=40000, backend="pallas")
    assert jit.backend == "pallas", jit.backend_reason
    plan = jit._plan
    k = 1024 // plan["ninc_effs"][0]
    assert k > 1 and plan["nchunks"] == 1

    jit.run(jspec.device_params(), jax.random.key(0))          # lanes move off uniform
    lanes = jit.lanes.copy()
    assert lanes.max() > lanes.min()
    seen = {}
    reallocate = jit._reallocate_lanes

    def spy(sig_flat):
        # the per-cube second moments after K4's host-side undo (vegasplus.py:499-502)
        acc = np.bincount(jit._cube_of_lane, weights=sig_flat, minlength=jit.ncubes)
        seen["acc"] = acc * (lanes * jit.ncubes / float(plan["NL"])) ** 2
        reallocate(sig_flat)

    jit._reallocate_lanes = spy
    st_j = jit.run(jspec.device_params(), jax.random.key(1))

    tspec = Spec(mt.Configuration(var=mt.Continuous(0.0, 1.0, grid=grid[::k]), dof=[[2]],
                                  seed=31), "cpu")
    tit = VegasPlusIteration(tspec, _peak(torch), block=4, nevalperblock=jit.nevalperblock,
                             nstrat=jit.nstrat)
    assert (tit.ncubes, tit.chunk, tit.nchunks) == (jit.ncubes, plan["NL"] * plan["spp"], 1)
    tit.counts = lanes * plan["spp"]
    st_t = tit.run(tspec.device_params(),
                   np.random.default_rng(1).integers(0, 2 ** 32, (4, 2), dtype=np.uint32))

    mt_, se_t = _block_stats(st_t["obs_blocks"], st_t["norm_blocks"])
    mj_, se_j = _block_stats(st_j["obs_blocks"], st_j["norm_blocks"])
    assert np.all(np.abs(mt_ - mj_) < 6 * np.hypot(se_t, se_j)), (mt_, mj_, se_t, se_j)
    rows_t = _rows(tit.last_sig, tit.nstrat, 2)
    rows_j = _rows(seen["acc"], jit.nstrat, 2)
    assert np.abs(rows_t - rows_j).max() < 0.03, (rows_t, rows_j)
    # K4 smears its coarse histogram over the user's bins; fold it back
    folded = np.asarray(st_j["hists"][0]).reshape(-1, k).sum(axis=1)
    assert np.abs(_coarse(st_t["hists"][0]) - _coarse(folded)).max() < 0.02
    share_t, share_j = tit.counts / tit.chunk, jit.lanes / plan["NL"]
    assert 0.5 * np.abs(share_t - share_j).sum() < 0.15, 0.5 * np.abs(share_t - share_j).sum()


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def test_launch_splitting_matches_one_launch(monkeypatch):
    """Cutting an iteration into several launches changes nothing but the
    float64 summation order (rel 1e-12)."""
    var, dof, f, _, max_cubes = LAW_CASES["passenger"]
    spec = Spec(mt.Configuration(var=var(mt), dof=dof, seed=1), "cpu")
    kd = np.random.default_rng(4).integers(0, 2 ** 32, (4, 2), dtype=np.uint32)
    kw = dict(block=4, nevalperblock=3 * 2048, max_cubes=max_cubes, max_chunk=2048)
    one = VegasPlusIteration(spec, f(torch), **kw)
    import mcintegration_tpu_torch.solvers.vegasplus as tv
    monkeypatch.setattr(tv, "SAMPLES_PER_LAUNCH", 4 * one.chunk)   # one chunk per launch
    split = VegasPlusIteration(spec, f(torch), **kw)
    assert (one.launches_per_run, split.launches_per_run) == (1, 3)
    a, b = one.run(spec.device_params(), kd), split.run(spec.device_params(), kd)
    np.testing.assert_allclose(a["obs_blocks"], b["obs_blocks"], rtol=1e-12)
    np.testing.assert_allclose(one.last_sig, split.last_sig, rtol=1e-12)
    for ha, hb in zip(a["hists"], b["hists"]):
        np.testing.assert_allclose(ha, hb, rtol=1e-12)
    assert np.array_equal(one.counts, split.counts)


def test_plain_sample_stays_in_its_cube_and_layout():
    """Every stratified coordinate lands in its cube's slab of y-space, a
    Discrete passenger in its range; the layout orders the slots by leaf."""
    var, dof, f, _, max_cubes = LAW_CASES["passenger"]
    spec = Spec(mt.Configuration(var=var(mt), dof=dof, seed=1), "cpu")
    it = VegasPlusIteration(spec, f(torch), block=2, nevalperblock=4096, max_cubes=max_cubes)
    lay = it.layout
    assert lay.slots[:, 0].tolist() == [0, 0, 1] and lay.slots[:, 5].tolist() == [1, it.nstrat, 0]
    assert lay.pad.tolist() == [[0, 1, 1], [0, 0, 0]] and lay.used.tolist() == [[1, 1], [0, 1], [0, 1]]
    params = spec.device_params()
    it.counts = _counts(it.ncubes, it.chunk, 2)
    cube, cfac = it.cube_tables()
    assert cube.shape == (it.chunk,) and bool((cube[1:] >= cube[:-1]).all())
    np.testing.assert_allclose(cfac.numpy(), it.counts * it.ncubes / it.chunk, rtol=1e-6)
    x, gidx = vp.vplus_sample(lay, lay.tables(params), it.seeds(np.arange(4).reshape(2, 2)),
                              0, 2, cube)
    grid = np.append(params["leaf"][0][0].numpy(), 1.0)
    for d in range(2):
        coord = (cube.numpy() // it.nstrat ** d) % it.nstrat
        y = (np.searchsorted(grid, x[d].numpy(), side="right") - 1
             + (x[d].numpy() - grid[gidx[d].numpy()]) / np.diff(grid)[gidx[d].numpy()]) / 32
        assert np.all(np.floor(y * it.nstrat + 1e-4).clip(max=it.nstrat - 1) >= coord)
        assert np.all(y * it.nstrat <= coord + 1 + 1e-4)
    vals = lay.leaf_values(x)[1]
    assert vals.dtype == torch.int32 and int(vals.min()) >= 1 and int(vals.max()) <= 4
    assert torch.equal(vals[0] - 1, gidx[2])


def test_vplus_wrappers_refuse_other_devices():
    """Off the CPU a wrapper launches its kernel or raises: never the plain path."""
    spec = Spec(mt.Configuration(var=mt.Continuous(0.0, 1.0, ninc=16), dof=[[2]], seed=1), "cpu")
    it = VegasPlusIteration(spec, lambda x, c: x[0], block=2, nevalperblock=1024, max_cubes=16)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        vp.vplus_sample(it.layout, None, torch.zeros((2, 2), dtype=torch.int32, device=meta),
                        0, 1, None)
    with pytest.raises(ValueError, match="unsupported device"):
        vp.vplus_reduce(it.layout, None, torch.zeros((1, 2, 1, 1024), device=meta), None, None,
                        None)
    it.counts = it.counts[:-1]
    with pytest.raises(ValueError, match="counts must be"):
        it.cube_tables()
