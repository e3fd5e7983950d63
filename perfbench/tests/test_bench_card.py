"""On the card: each cell runs a short window and its answers pass.  Skips
without a card.  Run on the chip with

    python -m pytest perfbench/tests/test_bench_card.py -q -p no:randomly
"""

import json
import subprocess
import sys

import pytest

from conftest import REPO

pytestmark = pytest.mark.cuda
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"] if w["chips"] == 1])
def test_a_short_run_of_each_cell(card, cell, trace):
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
                        "3000000123", "--seconds", "10", "--trace", str(trace)], cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["kind"] == card and res["device"]["platform"] == "gpu"
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        for name, m in res["metrics"].items():
            if name.startswith("roofline_pct."):
                assert 0 < m["value"] <= 105, (name, m)
