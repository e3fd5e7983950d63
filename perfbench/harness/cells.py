"""Finding a cell's parts by name.

``BENCHMARK.json`` at the root of the checkout lists the metrics and the
cells.  Everything that belongs to one cell, configuration, per-layer
metric or kernel lives in a file of its own under ``perfbench/``, found by
the name ``BENCHMARK.json`` gives it:

- ``workloads/<cell>.json``: the cell's configuration and traffic, the
  kernels whose rooflines it reports and its correctness limits;
- ``traffic/<traffic>.json``: a traffic mix, how a problem is integrated:
  the solver, ``neval`` (evaluations an iteration), ``block``, ``niter``
  (iterations a call) and ``dtype``;
- ``configs/<config>.py``: the integrand, the variables, the measure, the
  exact values and ``SOURCE``;
- ``metrics/<metric>.py``, or ``metrics/<head>.py`` for a metric named
  ``<head>.<arg>`` (``roofline_pct.vplus_reduce`` reads
  ``metrics/roofline_pct.py`` with ``arg="vplus_reduce"``): ``read(ctx, arg)``;
- ``kernels/<kernel>.py``: the kernel's names in a device trace and its
  bytes and operations at a launch's shape.

A later cell, configuration, metric or kernel is a new file; no file here
names one.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]          # perfbench/
ROOT = HERE.parent                                   # the checkout
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def _checked(name: str, what: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"{what} name {name!r} is not a benchmark name")
    return name


def _module(path: Path, modname: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _modname(kind: str, name: str) -> str:
    return "perfbench_" + kind + "_" + re.sub(r"\W", "_", name)


def workload(name: str, bench: dict = None, here: Path = HERE) -> dict:
    """The cell ``name``: its entry in ``BENCHMARK.json`` merged with its
    file ``workloads/<name>.json`` and its traffic's ``traffic/<traffic>.json``."""
    bench = benchmark(here.parent) if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    with open(here / "workloads" / f"{_checked(name, 'workload')}.json") as fh:
        cell = json.load(fh)
    for key in ("config", "traffic"):
        if cell[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json has {key} {cell[key]!r}, BENCHMARK.json "
                             f"says {entry[key]!r}")
    with open(here / "traffic" / f"{_checked(entry['traffic'], 'traffic')}.json") as fh:
        traffic = json.load(fh)
    return {**traffic, **cell, "name": name, "chips": entry["chips"]}


def config(name: str, here: Path = HERE):
    """The configuration module ``configs/<name>.py``."""
    return _module(here / "configs" / f"{_checked(name, 'config')}.py", _modname("config", name))


def metric_reader(name: str, here: Path = HERE):
    """``(read, arg)`` of per-layer metric ``name``: ``metrics/<name>.py``,
    else ``metrics/<head>.py`` with the rest of the name as ``arg``."""
    _checked(name, "metric")
    path = here / "metrics" / f"{name}.py"
    arg = None
    if not path.is_file() and "." in name:
        head, arg = name.split(".", 1)
        path = here / "metrics" / f"{head}.py"
    return _module(path, _modname("metric", path.stem)).read, arg


def kernel(name: str, here: Path = HERE):
    """The kernel module ``kernels/<name>.py``."""
    return _module(here / "kernels" / f"{_checked(name, 'kernel')}.py", _modname("kernel", name))


def all_kernels(here: Path = HERE) -> dict:
    """Every kernel module under ``kernels/``, by name."""
    return {p.stem: kernel(p.stem, here) for p in sorted((here / "kernels").glob("*.py"))
            if not p.stem.startswith("_")}


def per_layer_for(cell: str, bench: dict) -> list:
    """The per-layer metrics a cell reports: those that list it, and those
    without a ``workloads`` key."""
    return [m for m in bench["per_layer"] if cell in m.get("workloads", [cell])]


def end_to_end_for(cell: str, bench: dict) -> list:
    return [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
