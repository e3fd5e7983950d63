"""The benchmark of ``mcintegration_tpu_torch`` on NVIDIA H100 cards.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs cell ``<cell>`` of ``BENCHMARK.json`` from the root of a checkout: set
up, then ``integrate`` calls back to back for ``<s>`` seconds
(``harness/window.py``), then one call of the plain reference at the
cell's size and the check of every call's answer against it and the exact
values (``harness/checks.py``).  With ``--trace 0`` the last line of
standard output is a JSON object with the cell's end-to-end metrics; with
``--trace 1`` a profiled run's per-layer metrics, the device's busy and
traced seconds and a breakdown of its time.  The numbers compared and their
limits come last on standard error and last in that object, under
``checks``.  Exits 1, printing no result, without as many CUDA cards as the
cell asks for, and 2 if JAX, Flax or the JAX package was imported.
"""

import time

T0 = time.time()                       # the process's start, for setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(ROOT))

from harness import cells, checks, shapes, window  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "mcintegration_tpu"}


def p95(values):
    """The 95th percentile, nearest rank: the smallest value that at least
    95 % of ``values`` do not exceed."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def end_to_end(out, t0):
    """``evals_per_s``, ``iter_ms_p95`` and ``setup_s`` of the process's
    measurements."""
    calls = out["calls"]
    evals = sum(c["seen"] for c in calls)
    wall = calls[-1]["t1"] - calls[0]["t0"]
    iters = [x for c in calls for x in c["iter_times"]]
    return {"evals_per_s": evals / wall, "iter_ms_p95": 1e3 * p95(iters),
            "setup_s": out["t_ready"] - t0}


def per_layer(out, cell, cfg, bench):
    """Each per-layer metric of the cell; a metric whose reader finds
    nothing to read is left out."""
    ctx = dict(out, cell=cell, shape=shapes.launch_shape(cell, cfg),
               kernels=cells.all_kernels())
    got = {}
    for m in cells.per_layer_for(cell["name"], bench):
        read, arg = cells.metric_reader(m["name"])
        v = read(ctx, arg)
        if v is not None:
            got[m["name"]] = {"value": v, "unit": m["unit"]}
    return got


def power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True, text=True,
                             timeout=20)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def main(argv=None, device="cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = cells.benchmark()
    cell = cells.workload(args.workload, bench)
    cfg = cells.config(cell["config"])

    import torch
    marks = [("start", T0), ("torch imported", time.time())]

    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell["chips"]):
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: cell {cell['name']} needs {cell['chips']} CUDA card(s), found "
              f"{found}", file=sys.stderr)
        return 1
    marks.append(("cards counted", time.time()))

    trace = bool(args.trace)
    out = window.run(cell, cfg, args.seed, args.seconds, trace, device)

    # the window has closed, the peak is read and the port's state freed:
    # the plain reference integrates the problem once at the cell's size,
    # and every call is judged
    marks.append(("window closed", time.time()))
    ref = checks.reference(cell, cfg, args.seed, device)
    marks.append(("reference", time.time()))
    calls = out["calls"]
    correct, failed, numbers = checks.judge(calls, cfg.EXACT, cell["limits"], ref)

    bad = sorted(FORBIDDEN & {m.split(".")[0] for m in sys.modules})
    if bad:
        print(f"perfbench: modules {bad} were imported by the run", file=sys.stderr)
        return 2

    if trace:
        metrics = per_layer(out, cell, cfg, bench)
    else:
        units = {m["name"]: m["unit"] for m in cells.end_to_end_for(cell["name"], bench)}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in end_to_end(out, T0).items()
                   if k in units}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": cell["chips"], "memory_peak_bytes": out["peak"],
           "power_limit_w": power_limit() if device == "cuda" else None}
    result = {"correct": correct, "attempted": len(calls), "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        prof = out["profile"]
        if device == "cuda" and not (prof and prof["busy_s"] > 0):
            print("perfbench: the traced calls ran nothing on the device", file=sys.stderr)
            return 1
        dev["busy_s"], dev["window_s"] = prof["busy_s"], prof["window_s"]
        result["breakdown"] = {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
    result["checks"] = {n: {"value": v, "limit": lim, **({"at_least": True} if n in checks.LOWER
                                                         else {})} for n, v, lim in numbers}
    iters = sum(len(c["iter_times"]) for c in calls)
    marks = sorted(marks + [(k, v) for k, v in out["marks"].items() if k != "start"],
                   key=lambda m: m[1])
    print("perfbench: stages: " + ", ".join(
        f"{b[0]} {b[1] - a[1]:.3f} s" for a, b in zip(marks, marks[1:])), file=sys.stderr)
    print(f"perfbench: {cell['name']}: {len(calls)} calls, {iters} iterations, seeds "
          f"{calls[0]['seed']}..{calls[-1]['seed']}; on {dev['kind']}, power limit "
          f"{dev['power_limit_w']} W", file=sys.stderr)
    print(f"perfbench: correct {correct}: {checks.line(numbers)}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
