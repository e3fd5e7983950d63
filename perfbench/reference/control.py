"""The control of the correctness check: the plain reference integrator put
in the port's place, one precision below the configuration's.

    python3 perfbench/reference/control.py --workload <cell> --seeds 1,2,3
        [--dtype bfloat16] [--calls 2] [--neval N] [--device cuda]

For each seed it runs ``--calls`` calls of ``reference/plain_vegas.py`` at
the cell's own size (its traffic's ``neval``, ``block`` and ``niter``;
``--neval`` for a smaller check), every per-sample operation in ``--dtype``
(bfloat16, the step below float32, by default), and judges their answers
with the run's own comparison (``harness/checks.py``): against the exact
values and one float64 call of the reference, with the cell's limits.  Prints one JSON line per seed with each number compared and
whether the answers pass.  The check is sound only if the control reads
``correct: false`` on every seed; at ``--dtype float32`` or ``float64`` the
same integrator is a witness that a sound integrator passes.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

from harness import cells, checks  # noqa: E402
from reference import plain_vegas  # noqa: E402


def run(cell: dict, cfg, seed: int, calls: int, dtype, device: str, neval=None) -> dict:
    answers = []
    cell = dict(cell, neval=int(neval or cell["neval"]))
    for k in range(calls):
        got = plain_vegas.run(cfg, neval=cell["neval"], niter=cell["niter"],
                              block=cell["block"], seed=seed + k, device=device, dtype=dtype)
        seen = (cell["neval"] // cell["block"]) * cell["block"] * cell["niter"]
        answers.append(dict(got, neval=seen, seen=seen))
    ref = checks.reference(cell, cfg, seed, device)
    correct, failed, numbers = checks.judge(answers, cfg.EXACT, cell["limits"], ref)
    return {"workload": cell["name"], "seed": seed, "dtype": str(dtype).replace("torch.", ""),
            "neval": cell["neval"], "calls": calls, "correct": correct, "failed": failed,
            "numbers": {name: value for name, value, _ in numbers}}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--calls", type=int, default=2)
    ap.add_argument("--neval", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = cells.workload(args.workload)
    cfg = cells.config(cell["config"])
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(run(cell, cfg, seed, args.calls, getattr(torch, args.dtype),
                             args.device, args.neval)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
