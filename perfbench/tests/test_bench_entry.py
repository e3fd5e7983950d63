"""The command line: no card, no result; JAX or the JAX package in the
process, no result; a checkout of the benchmark's files alone, no result."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import PERFBENCH, REPO, run_cpu

ARGS = ["--workload", "sing3d.vegasplus", "--seed", "2147483700", "--seconds", "1",
        "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "perfbench/run.py", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, **(env or {})})


def test_fails_without_a_card():
    p = _run(REPO, {"CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert not p.stdout.strip()
    assert "needs 1 CUDA card" in p.stderr


def test_fails_with_only_the_benchmark_files(tmp_path):
    shutil.copytree(PERFBENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "perfbench/run.py", *ARGS], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert not p.stdout.strip()


@pytest.mark.parametrize("module", ["jax", "jaxlib.xla_client", "flax", "mcintegration_tpu.main"])
def test_a_jax_module_in_the_process_refuses_the_result(tiny, module):
    # planted as an empty module, so the check sees its name and nothing runs
    stub = tiny / "stubs"
    path = stub.joinpath(*module.split("."))
    path.mkdir(parents=True)
    for d in [stub.joinpath(*module.split(".")[:i + 1]) for i in range(module.count(".") + 1)]:
        (d / "__init__.py").write_text("")
    code = (f"import sys; sys.path[:0] = [{str(stub)!r}, {str(tiny / 'perfbench')!r}]\n"
            f"import {module}, run\n"
            f"sys.exit(run.main({ARGS!r}, device='cpu'))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=tiny, capture_output=True, text=True,
                       timeout=300, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert p.returncode == 2
    assert not p.stdout.strip()
    assert module.split(".")[0] in p.stderr


def test_the_port_itself_passes_the_module_check(tiny):
    rc, res, err = run_cpu(tiny, ARGS)
    assert rc == 0, err
    assert set(res) == {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert json.dumps(res)
