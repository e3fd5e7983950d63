"""BENCHMARK.json against the rules it is written to, and every name in it
found as a file."""

import json
import re

import pytest

from conftest import PERFBENCH, REPO
from harness import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    # a full check of 24 cells fits: 2 + 14 runs a cell, each the window plus
    # 60 s, 180 s of compile a cell and 1200 s spare
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_command_and_paths():
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p) and not p.startswith("/")
        assert ".." not in p.split("/") and not p.endswith("_torch")
    for word in BENCH["command"]:
        assert _line(word)


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES
    if metric in BENCH["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves",
                               "workloads"}
        assert _line(metric["layer"])
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        if metric["name"].startswith("roofline_pct.") or "mfu" in metric["name"]:
            assert metric["unit"] == "%"
    for w in metric.get("workloads", []):
        assert w in {c["name"] for c in BENCH["workloads"]}


def test_setup_s_is_an_end_to_end_metric_bounded_at_a_quarter():
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_configs(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert _line(cfg["source"]) and _line(cfg["why"])
    assert cfg["file"].startswith("perfbench/") and (REPO / cfg["file"]).is_file()
    assert len(cfg["reduced"]) <= 16
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])
    mod = cells.config(cfg["name"])
    assert mod.SOURCE == cfg["source"]
    assert len(mod.EXACT) == len(mod.LABELS)


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workloads(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4) and _line(w["why"])
    assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    cell = cells.workload(w["name"])
    assert cell["why"] == w["why"]
    assert {"z_max", "z_rms", "stats_gap", "chi2_median", "map_gap"} <= set(cell["limits"]) <= \
        {"z_max", "z_rms", "stats_gap", "chi2_median", "map_gap", "stdev_ratio"}
    for k in cell["kernels"]:
        assert hasattr(cells.kernel(k), "counts")
        assert any(m["name"] == f"roofline_pct.{k}" and w["name"] in m["workloads"]
                   for m in BENCH["per_layer"])
    # every cell reports setup_s, another end-to-end metric and a per-layer one
    e2e = {m["name"] for m in cells.end_to_end_for(w["name"], BENCH)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cells.per_layer_for(w["name"], BENCH)


def test_pairs_and_four_chip_share():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_per_layer_metric_has_a_reader(metric):
    read, arg = cells.metric_reader(metric["name"])
    assert callable(read)
    if arg is not None:
        assert hasattr(cells.kernel(arg), "counts")


def test_files_under_paths_are_named_from_name_characters():
    for p in PERFBENCH.rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(REPO).as_posix()
        assert re.match(r"^[A-Za-z0-9_.\-/]+$", rel), rel
