"""Fixtures of the benchmark's own tests: a copy of the benchmark at a size
the CPU can hold, and a run of it on the CPU in a process of its own.

``run.main(..., device="cpu")`` skips the look for a card and runs the
port's plain PyTorch versions; the command line always asks for a card.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

PERFBENCH = Path(__file__).resolve().parents[1]
REPO = PERFBENCH.parent
TINY_NEVAL = 2 ** 16        # evaluations an iteration in the tiny copy

sys.path.insert(0, str(PERFBENCH))


def make_copy(dst: Path, neval: int = TINY_NEVAL) -> Path:
    """``dst`` holding ``BENCHMARK.json`` and ``perfbench/`` with every
    traffic mix cut to ``neval`` evaluations an iteration."""
    dst.mkdir(parents=True, exist_ok=True)
    shutil.copytree(PERFBENCH, dst / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    for p in (dst / "perfbench" / "traffic").glob("*.json"):
        t = json.loads(p.read_text())
        t["neval"] = neval
        p.write_text(json.dumps(t))
    return dst


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    """Two torch threads in each test process: the tests run in several
    workers at once."""
    import torch
    torch.set_num_threads(2)


@pytest.fixture
def tiny(tmp_path):
    return make_copy(tmp_path / "checkout")


def run_cpu(checkout: Path, argv, fault=None, timeout=600):
    """Run ``run.main(argv, device="cpu")`` of ``checkout`` in a process of
    its own, with fault ``fault`` of ``tests/faults.py`` planted in the port
    first; returns ``(rc, result, stderr)``."""
    tests = str(Path(__file__).resolve().parent)
    code = (f"import sys; sys.path[:0] = [{str(checkout / 'perfbench')!r}, {tests!r}]\n"
            "import faults, run\n"
            f"faults.plant({fault!r})\n"
            f"sys.exit(run.main({list(argv)!r}, device='cpu'))\n")
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2"}
    p = subprocess.run([sys.executable, "-c", code], cwd=checkout, env=env,
                       capture_output=True, text=True, timeout=timeout)
    lines = p.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else None
    return p.returncode, result, p.stderr


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided here, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.cuda.get_device_name(0)
