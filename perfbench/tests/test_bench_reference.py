"""The plain reference: its exact values, its integrator against the port
on the CPU at a small size, the bfloat16 control that the check must
reject, and its independence from the port."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import PERFBENCH, REPO
from harness import cells
from reference import exact, plain_vegas
from reference.control import run as control_run


def test_exact_values():
    sing = cells.config("sing3d")
    assert sing.EXACT[0] == pytest.approx(exact.WATSON, rel=1e-15)
    bub = cells.config("bubble")
    got = [exact.bubble_exact(q, bub.BETA_PHYS, bub.KF) for q in bub.EXTQ[:, 0]]
    assert np.allclose(got, bub.EXACT, rtol=1e-12, atol=0)
    # the zero-temperature limit lies below by 6.6e-4 to 2.0e-3 of it
    lin = np.array([exact.lindhard(q, bub.KF) for q in bub.EXTQ[:, 0]])
    assert np.all((bub.EXACT - lin) / np.abs(lin) > 6e-4)
    assert np.all((bub.EXACT - lin) / np.abs(lin) < 2.1e-3)


@pytest.mark.parametrize("name,neval", [("sing3d", 2 ** 20), ("bubble", 2 ** 21)])
def test_reference_and_port_agree_on_the_cpu(name, neval):
    """The plain reference at float64 and the port's plain path on the CPU
    estimate the same integral: within 5 combined sigma of each other, and
    the reference within 5 sigma of the exact values."""
    import mcintegration_tpu_torch as mt

    cfg = cells.config(name)
    ref = plain_vegas.run(cfg, neval=neval, niter=6, block=16, seed=3, device="cpu",
                          dtype=torch.float64)
    ref_mean, ref_std = ref["mean"], ref["stdev"]
    res = mt.integrate(cfg.port_integrand("cpu"), solver="vegas", neval=neval, niter=6,
                       block=16, seed=3, verbose=-2, device="cpu",
                       **cfg.port_kwargs(mt, "cpu"))
    mean = np.ravel(np.asarray(res.mean[0], np.float64))
    std = np.ravel(np.asarray(res.stdev[0], np.float64))
    assert np.all(np.abs(mean - ref_mean) < 5 * np.hypot(std, ref_std))
    assert np.all(np.abs(ref_mean - cfg.EXACT) < 5 * ref_std)


@pytest.mark.parametrize("cell", ["sing3d.vegasplus", "sing3d.vegas", "bubble.vegas"])
def test_the_bfloat16_control_is_rejected(cell):
    c = cells.workload(cell)
    cfg = cells.config(c["config"])
    for seed in (11, 12, 13):
        bad = control_run(c, cfg, seed, 2, torch.bfloat16, "cpu", neval=2 ** 20)
        assert bad["correct"] is False, bad
        assert bad["numbers"]["z_max"] > c["limits"]["z_max"], bad


# :vegasplus stratifies, and its stdev_ratio limit holds it to a fifth or so
# of the plain reference's error bar, which the plain reference cannot meet
@pytest.mark.parametrize("cell", ["sing3d.vegas", "bubble.vegas"])
def test_the_float64_reference_passes(cell):
    c = cells.workload(cell)
    good = control_run(c, cells.config(c["config"]), 11, 2, torch.float64, "cpu", neval=2 ** 20)
    assert good["correct"] is True, good


def test_the_reference_imports_nothing_of_the_port_or_jax():
    banned = {"jax", "jaxlib", "flax", "mcintegration_tpu", "mcintegration_tpu_torch"}
    for p in list((PERFBENCH / "reference").glob("*.py")) + list(
            (PERFBENCH / "configs").glob("*.py")):
        for node in ast.walk(ast.parse(p.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            assert not banned & {n.split(".")[0] for n in names}, (p, names)
    code = ("import sys; sys.path.insert(0, %r); import reference.plain_vegas, "
            "reference.exact, reference.control; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(PERFBENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
                         cwd=REPO, check=True).stdout
    assert not {"jax", "jaxlib", "flax", "mcintegration_tpu",
                "mcintegration_tpu_torch"} & set(json.loads(out.replace("'", '"')))
