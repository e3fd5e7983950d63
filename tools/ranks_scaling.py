"""The port over several ranks: one process per rank, each on its own card,
the statistics through a gloo group on the host.

    python3 tools/ranks_scaling.py [--ranks 1,2,4] [--solvers vegas,vegasmc,mcmc]
                                   [--repeats 2] [--seconds 5] [--device cuda|cpu]
                                   [--small]

Runs the rank counts in turns, reversed on every other repeat (1, 2, 4, 4,
2, 1 for two repeats).  For each rank count R it spawns R processes with
``LOCAL_RANK=r``, so that ``device="cuda"`` puts rank r on
``cuda:{r % device_count}``.  Each solver runs at ``chip_smoke.py``'s
main-path widths, one problem's 16 blocks split over the ranks: ``:vegas``
on pi at 2^30 evals an iteration, ``:vegasmc`` on pi at 2^28 with 2^20
walkers, ``:mcmc`` on the Lindhard bubble at 2^28 with 2^18 walkers.  A
first call of two iterations with ``debug=True`` warms the rank up and
gives iteration 0's per-block observables, which must equal the R = 1
run's bit for bit.  Then, after a barrier, a call with ``debug=False`` runs
as many iterations as fill about ``--seconds`` (the most any rank asks
for, from its first call's second iteration), and every rank must return
the same ``Result`` bit for bit.  Prints each run's evals/s over that call
(the slowest rank's wall time) and the share of it the ranks spent in the
statistics' reduce (the gather, and the wait there for the slowest rank),
beside the card's name and power limit, then each solver's runs side by
side.  ``--small`` (with ``--device cpu``) runs the
same at 2^14 evaluations.
"""

import argparse
import math
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def _cases(mt, device, dev, small):
    big = not small
    pi = dict(dof=[[2]], block=16, device=device, seed=cs.SEED, verbose=-2)
    return {
        "vegas": lambda: (cs._pi, dict(pi, var=mt.Continuous(0.0, 1.0),
                                       neval=2 ** 30 if big else 2 ** 14, solver="vegas")),
        "vegasmc": lambda: (cs._pi, dict(pi, var=mt.Continuous(0.0, 1.0),
                                         neval=2 ** 28 if big else 2 ** 14, solver="vegasmc",
                                         nwalkers=2 ** 20 if big else 2 ** 8)),
        # the bubble's q table on the rank's own card
        "mcmc": lambda: (cs.make_bubble(str(dev)), dict(
            neval=2 ** 28 if big else 2 ** 14, nwalkers=2 ** 18 if big else 2 ** 8,
            device=device, seed=cs.SEED, verbose=-2, **cs.bubble_kw(mt))),
    }


def worker(rank: int, world: int, port: int, out: str, solvers: str, seconds: float,
           device: str, small: bool):
    """One rank: each solver's checked first call, then its timed call."""
    import torch
    import torch.distributed as dist
    import mcintegration_tpu_torch as mt
    import mcintegration_tpu_torch.main as tmain
    mt.init_distributed(f"127.0.0.1:{port}", world, rank)
    dev = tmain._resolve_device(device, mt.default_mesh())     # integrate's choice
    cases = _cases(mt, device, dev, small)
    got = {}
    for name in solvers.split(","):
        seen, check = [], tmain.check_iteration_stats
        tmain.check_iteration_stats = lambda stats, it: (seen.append(stats), check(stats, it))[1]
        f, kw = cases[name]()
        first = mt.integrate(f, niter=2, debug=True, **kw)
        tmain.check_iteration_stats = check
        want = torch.tensor([max(3, math.ceil(seconds / first.iteration_times[-1]))])
        dist.all_reduce(want, op=dist.ReduceOp.MAX)
        niter = int(want.item())
        f, kw = cases[name]()
        reduce, in_reduce = tmain._reduce_stats, [0.0]

        def timed_reduce(stats, mesh):
            t = time.perf_counter()
            out = reduce(stats, mesh)
            in_reduce[0] += time.perf_counter() - t
            return out

        tmain._reduce_stats = timed_reduce
        dist.barrier()
        t = time.perf_counter()
        res = mt.integrate(f, niter=niter, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t
        tmain._reduce_stats = reduce
        obs = seen[0]["obs_blocks"]          # the bubble's: a list of one leaf
        got[name] = {"numbers": cs._run_numbers(res), "wall": wall, "neval": res.neval,
                     "reduce_share": in_reduce[0] / wall,
                     "niter": niter, "obs0": np.asarray(obs[0] if isinstance(obs, list) else obs),
                     "device": str(dev)}
    with open(out, "wb") as fh:
        pickle.dump(got, fh)
    dist.barrier()
    dist.destroy_process_group()


def spawn(world: int, args, tmp: Path) -> list:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(world):
        env = {**os.environ, "LOCAL_RANK": str(r)}
        code = (f"import sys; sys.path.insert(0, {str(ROOT / 'tools')!r}); import ranks_scaling "
                f"as t; t.worker({r}, {world}, {port}, {str(tmp / f'rank{r}.pkl')!r}, "
                f"{args.solvers!r}, {args.seconds}, {args.device!r}, {args.small})")
        procs.append(subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    try:
        logs = [p.communicate(timeout=1200)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [f"rank {r} of {world} exited with {p.returncode}:\n{log}"
              for r, (p, log) in enumerate(zip(procs, logs)) if p.returncode != 0]
    if failed:
        raise RuntimeError("\n".join(failed))
    out = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as fh:
            out.append(pickle.load(fh))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", default="1,2,4")
    ap.add_argument("--solvers", default="vegas,vegasmc,mcmc")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args(argv)
    card = "CPU"
    if args.device == "cuda":
        import torch
        from mcintegration_tpu_torch.ops import _build
        if not torch.cuda.is_available():
            print("ranks_scaling: no CUDA device", file=sys.stderr)
            return 1
        card = cs.card_line()
        _build.load()                 # built once here; the ranks load it
        print(f"{torch.cuda.device_count()} card(s): {card}")
    counts = [int(r) for r in args.ranks.split(",")]
    solvers = args.solvers.split(",")
    rates = {name: {w: [] for w in counts} for name in solvers}
    ref = {}
    with tempfile.TemporaryDirectory() as tmp:
        for rep in range(args.repeats):
            for world in counts if rep % 2 == 0 else counts[::-1]:
                sub = Path(tmp) / f"rep{rep}_world{world}"
                sub.mkdir()
                ranks = spawn(world, args, sub)
                for name in solvers:
                    got = [r[name] for r in ranks]
                    for r, g in enumerate(got):
                        assert all(np.array_equal(x, y) for x, y in
                                   zip(g["numbers"], got[0]["numbers"])), (name, world, r)
                    one = ref.setdefault(name, got[0]["obs0"])
                    assert np.array_equal(got[0]["obs0"], one), (name, world)
                    wall = max(g["wall"] for g in got)
                    rate = got[0]["neval"] / wall
                    rates[name][world].append(rate)
                    shares = [g["reduce_share"] for g in got]
                    print(f"{name}: repeat {rep}, {world} rank(s) on "
                          f"{sorted({g['device'] for g in got})}: {got[0]['niter']} "
                          f"iterations in {wall!r} s, {rate!r} evals/s; in the reduce "
                          f"{float(np.mean(shares))!r} of the time (mean of the ranks), "
                          f"{max(shares)!r} (most); every rank the same Result, iteration "
                          f"0's per-block observables the one-rank run's [{card}]", flush=True)
    for name in solvers:
        print(f"{name}: evals/s by rank count, every run: "
              + "; ".join(f"{w}: {rates[name][w]!r}" for w in counts) + f" [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
