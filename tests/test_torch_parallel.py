"""PyTorch port: runs over several ranks (``mcintegration_tpu_torch.parallel``).

One spawn of ``world`` processes per world size, joined by a gloo group on
``tcp://127.0.0.1``, runs all four solvers on the CPU.  Rank 0 also runs
each case on one rank (``parallel="none"``), the reference the ranks are
held to:

- every rank returns the same ``Result``, bit for bit;
- iteration 0's per-block observables and norms, and its tallies, equal the
  one-rank run's bit for bit (a block's seeds and walkers are the one-rank
  run's, and every per-block sum has a fixed order);
- with ``adapt=False`` the :vegas means and error bars equal the one-rank
  run's bit for bit; with training :vegas agrees to rtol 1e-4 (the JAX
  package's bound, tests/test_parallel.py) and every solver lands within
  5 sigma of pi/4;
- ``block`` is rounded to a multiple of the ranks, and ``make_mesh(1)``
  runs rank 0 alone while rank 1 raises;
- ``gather_rows`` concatenates the ranks' rows and ``ordered_sum`` adds
  their parts in rank order;
- against the JAX package over a CPU mesh of as many devices, on the same
  seed, blocks and evaluations: the same ``neval`` and block rounding, and
  every mean within 7 combined sigma of the JAX run's (the two draw from
  different random streams, as in test_torch_slice.py).
"""

import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

import mcintegration_tpu as mj
from mcintegration_tpu.main import _standardize_block as jax_standardize_block

ROOT = Path(__file__).resolve().parents[1]
PI4 = np.pi / 4


def _f(x, c):
    import torch
    disc = torch.where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0)
    return disc, torch.exp(x[0]) * (1.0 + x[1])


def _f_idx(i, x, c):
    return _f(x, c)[i]


def _fj(x, c):
    disc = jnp.where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0)
    return disc, jnp.exp(x[0]) * (1.0 + x[1])


def _fj_idx(i, x, c):
    return jnp.stack(_fj(x, c))[i]


CASES = {
    "vegas": dict(solver="vegas", neval=2 ** 14),
    "vegasmc": dict(solver="vegasmc", neval=2 ** 13, use_mesh=True),
    "mcmc": dict(solver="mcmc", neval=2 ** 13),
    "vegasplus": dict(solver="vegasplus", neval=2 ** 14, use_mesh=True),
    "vegas-fixed": dict(solver="vegas", neval=2 ** 14, adapt=False),
}


def _run(mt, case, *, block=8, seed=7, **kw):
    opts = dict(CASES[case])
    solver, neval = opts.pop("solver"), opts.pop("neval")
    use_mesh = opts.pop("use_mesh", False)
    if use_mesh and "parallel" not in kw and "mesh" not in kw:
        kw["mesh"] = mt.make_mesh()
    seen = []
    import mcintegration_tpu_torch.main as main
    check = main.check_iteration_stats
    main.check_iteration_stats = lambda stats, it: (seen.append(stats), check(stats, it))[1]
    try:
        res = mt.integrate(_f_idx if solver == "mcmc" else _f,
                           var=mt.Continuous(0.0, 1.0), dof=[[2], [2]], neval=neval,
                           niter=3, block=block, solver=solver, seed=seed, device="cpu",
                           verbose=-2, debug=True, min_steps_per_walker=32, **opts, **kw)
    finally:
        main.check_iteration_stats = check
    first = seen[0]
    return {
        "mean": np.asarray(res.mean), "stdev": np.asarray(res.stdev),
        "iterations": [(np.asarray(m), np.asarray(s)) for m, s, _ in res.iterations],
        "neval": res.neval,
        "tallies": [np.asarray(getattr(res.config, k)) for k in ("visited", "propose",
                                                                    "accept")],
        "reweight": np.asarray(res.config.reweight),
        "obs0": np.asarray(first["obs_blocks"]), "norm0": np.asarray(first["norm_blocks"]),
        "tallies0": [np.asarray(first[k]) for k in ("visited", "propose", "accept")
                     if k in first],
        "neval0": first["neval"],
    }


def _worker(rank: int, world: int, port: int, out: str):
    """One rank: every case over the world, and on rank 0 on one rank."""
    import torch
    torch.set_num_threads(1)
    import mcintegration_tpu_torch as mt
    from mcintegration_tpu_torch.parallel import gather_rows, ordered_sum
    mt.init_distributed(f"127.0.0.1:{port}", world, rank)
    mesh = mt.make_mesh()
    got = {"world": {c: _run(mt, c) for c in CASES},
           "rows": gather_rows(np.full((2, 3), float(rank)), mesh),
           "sum": ordered_sum(np.full(3, 0.1 * (rank + 1)), mesh)}
    got["rounded"] = len(_run(mt, "vegas", block=2 * world + 1)["norm0"])
    sub = mt.make_mesh(1)
    try:
        got["mesh1"] = _run(mt, "vegas", mesh=sub)
    except ValueError as e:
        got["mesh1"] = f"ValueError: {e}"
    if rank == 0:
        got["one"] = {c: _run(mt, c, parallel="none") for c in CASES}
    with open(out, "wb") as fh:
        pickle.dump(got, fh)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(world: int, tmp: Path):
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    code = ("import sys; sys.path.insert(0, {tests!r}); import test_torch_parallel as t; "
            "t._worker({rank}, {world}, {port}, {out!r})")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code.format(tests=str(ROOT / "tests"), rank=r, world=world,
                                           port=port, out=str(tmp / f"rank{r}.pkl"))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=240)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log}"
    out = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as fh:
            out.append(pickle.load(fh))
    return out


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(a, b)
    return a == b


@pytest.fixture(scope="module", params=[2, 4])
def spawned(request, tmp_path_factory):
    """``(world, every rank's results)``: one spawn per world size."""
    world = request.param
    return world, _spawn(world, tmp_path_factory.mktemp(f"world{world}"))


def test_ranks_match_one_rank(spawned):
    world, ranks = spawned
    one = ranks[0]["one"]
    for r in range(1, world):
        assert _equal(ranks[r]["world"], ranks[0]["world"]), f"rank {r} differs from rank 0"
    for case, got in ranks[0]["world"].items():
        ref = one[case]
        assert got["obs0"].shape == ref["obs0"].shape == (8, 2)
        assert np.array_equal(got["obs0"], ref["obs0"]), case
        assert np.array_equal(got["norm0"], ref["norm0"]), case
        assert _equal(got["tallies0"], ref["tallies0"]), case
        assert got["neval0"] == ref["neval0"] and got["neval"] == ref["neval"], case
        mean, err = got["mean"], got["stdev"]
        assert abs(mean[0] - PI4) < 5 * err[0], (case, mean, err)
    fixed, fixed_one = ranks[0]["world"]["vegas-fixed"], one["vegas-fixed"]
    assert np.array_equal(fixed["mean"], fixed_one["mean"])
    assert np.array_equal(fixed["stdev"], fixed_one["stdev"])
    assert _equal(fixed["iterations"], fixed_one["iterations"])
    trained, trained_one = ranks[0]["world"]["vegas"], one["vegas"]
    np.testing.assert_allclose(trained["mean"], trained_one["mean"], rtol=1e-4)
    np.testing.assert_allclose(trained["stdev"], trained_one["stdev"], rtol=1e-4)
    assert all(r["rounded"] == 2 * world for r in ranks)
    rows = np.repeat(np.arange(world, dtype=float), 2)[:, None] * np.ones((1, 3))
    total = 0.1
    for r in range(1, world):
        total = total + 0.1 * (r + 1)        # in rank order
    for r in ranks:
        assert np.array_equal(r["rows"], rows)
        assert np.array_equal(r["sum"], np.full(3, total))
    assert _equal(ranks[0]["mesh1"], one["vegas"])
    assert all(isinstance(r["mesh1"], str) and "not in this mesh" in r["mesh1"]
               for r in ranks[1:])


def test_ranks_match_jax_mesh(spawned):
    """The port over ``world`` ranks against ``mcintegration_tpu.integrate``
    over a mesh of ``world`` CPU devices, case by case."""
    world, ranks = spawned
    for case, got in ranks[0]["world"].items():
        opts = dict(CASES[case])
        solver, neval = opts.pop("solver"), opts.pop("neval")
        opts.pop("use_mesh", None)
        ref = mj.integrate(_fj_idx if solver == "mcmc" else _fj, var=mj.Continuous(0.0, 1.0),
                           dof=[[2], [2]], neval=neval, niter=3, block=8, solver=solver,
                           seed=7, verbose=-2, min_steps_per_walker=32,
                           mesh=mj.make_mesh(world), **opts)
        assert got["neval"] == ref.neval, (case, got["neval"], ref.neval)
        mean, err = got["mean"], got["stdev"]
        rmean, rerr = np.asarray(ref.mean, np.float64), np.asarray(ref.stdev, np.float64)
        assert np.all(np.abs(mean - rmean) < 7.0 * np.hypot(err, rerr)), \
            (case, mean, err, rmean, rerr)
    assert all(r["rounded"] == jax_standardize_block(2 ** 14, 2 * world + 1, world)[1]
               for r in ranks)
