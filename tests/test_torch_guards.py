"""PyTorch port: what it refuses, what it never imports, and the state it
shares with the JAX package."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mcintegration_tpu as mj
import mcintegration_tpu_torch as mt
from mcintegration_tpu_torch.models.variable import Discrete, FermiK

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _pi(x, c):
    return torch.where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0)


def _python(code_or_args, cwd):
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    args = ["-c", code_or_args] if isinstance(code_or_args, str) else code_or_args
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax():
    code = ("import sys, mcintegration_tpu_torch, mcintegration_tpu_torch.main, "
            "mcintegration_tpu_torch.ops.vegas_kernels, mcintegration_tpu_torch.ops._build, "
            "mcintegration_tpu_torch.ops.chain_kernels, mcintegration_tpu_torch.ops.mcmc_kernels, "
            "mcintegration_tpu_torch.ops.fermik, mcintegration_tpu_torch.solvers.mcmc, "
            "mcintegration_tpu_torch.solvers.vegasmc, mcintegration_tpu_torch.checkpoint, "
            "mcintegration_tpu_torch.ops.vplus_kernels, mcintegration_tpu_torch.solvers.vegasplus\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', "
            "'mcintegration_tpu.'))]\n"
            "assert not bad, bad\n")
    proc = _python(code, ROOT)
    assert proc.returncode == 0, proc.stderr


def test_cuda_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mt.integrate(_pi, var=mt.Continuous(0.0, 1.0), dof=[[2]], neval=2 ** 12,
                     solver="vegas", device="cuda")


@pytest.mark.parametrize("kwargs,item", [
    ({"solver": "vegasmc", "measure": lambda v, relw, c: relw}, "item 14"),
    ({"solver": ":mcmc", "type": complex}, "item 14"),
    ({"solver": "vegasplus", "measure": lambda v, relw, c: relw}, "item 14"),
    ({"solver": "vegas+", "measurefreq": 2}, "item 14"),
    ({"solver": ":vegasplus", "type": complex}, "item 14"),
    ({"measure": lambda v, relw, c: relw}, "item 14"),
    ({"measurefreq": 2}, "item 14"),
    ({"type": complex}, "item 14"),
    ({"mesh": object()}, "item 15"),
    ({"debug": True}, "item 16"),
    ({"var": (mt.Continuous(0.0, 1.0, ninc=64), mt.Continuous(0.0, 1.0, ninc=32)),
      "dof": [[1, 1]]}, "item 14"),
], ids=["vegasmc", "mcmc", "vegasplus-measure", "vegasplus-measurefreq", "vegasplus-complex",
        "measure", "measurefreq", "complex", "mesh",
        "debug", "mixed-ninc"])
def test_unported_options_raise(kwargs, item):
    kw = {"var": mt.Continuous(0.0, 1.0), "dof": [[2]], "neval": 2 ** 12,
          "solver": "vegas", "device": "cpu", "verbose": -2, **kwargs}
    with pytest.raises(NotImplementedError, match=item):
        mt.integrate(lambda x, c: x[0][0] * 1.0 if isinstance(x, tuple) else x[0], **kw)


def test_default_solver_is_not_served_and_unknown_solver_fails():
    """The default solver (:vegasmc) now runs; an unknown solver fails."""
    res = mt.integrate(_pi, var=mt.Continuous(0.0, 1.0), dof=[[2]], neval=2 ** 12,
                       niter=2, device="cpu", verbose=-2, seed=1)
    assert res.backend == "torch" and res.neval == 2 * 2 ** 12
    assert abs(float(res.mean[0]) - np.pi / 4) < 7 * float(res.stdev[0])
    for solver in ("nope", "vegasplusplus", ":vegas++"):
        with pytest.raises(ValueError, match="not supported"):
            mt.integrate(_pi, solver=solver, device="cpu")


@pytest.mark.parametrize("cls,item", [(Discrete, "item 14"), (FermiK, ":mcmc solver only")],
                         ids=["cls0-item 14", "cls1-item 12"])
def test_unported_pools_raise(cls, item):
    """A Discrete pool runs on :vegasmc and :mcmc but not on the :vegas
    kernels; a FermiK pool runs on :mcmc only, and raises on :vegas and
    :vegasmc as in the JAX package (tests/test_bubble_fermik.py:63-70)."""
    if cls is Discrete:
        with pytest.raises(NotImplementedError, match=item):
            mt.integrate(lambda x, c: x[0], var=cls(1, 10), dof=[[1]], neval=2 ** 12,
                         solver="vegas", device="cpu", verbose=-2)
        return
    for solver in ("vegas", "vegasmc"):
        with pytest.raises(NotImplementedError, match=item):
            mt.integrate(lambda x, c: 1.0, var=(mt.Continuous(0.0, 1.0), cls(3, 1.0, 0.2, 10.0)),
                         dof=[[1, 1]], neval=2 ** 12, solver=solver, device="cpu", verbose=-2)


def _vars(pkg):
    """Two Continuous pools in a CompositeVar, and a Discrete pool."""
    return (pkg.Continuous([(0.0, 1.0), (0.0, 2.0)], ninc=64), pkg.Discrete(1, 7))


def _same_leaf_state(a, b):
    if hasattr(b, "grid"):
        assert np.array_equal(a.grid, b.grid)
    else:
        assert np.array_equal(a.distribution, b.distribution)
        assert np.array_equal(a.accumulation, b.accumulation)
    assert np.array_equal(a.histogram, b.histogram)


def test_state_moves_between_packages(tmp_path):
    rng = np.random.default_rng(0)
    jc = mj.Configuration(var=_vars(mj), dof=[[1, 1], [2, 0]], seed=9,
                          reweight=[1.0, 2.0, 3.0])
    for _, leaf in jc.var_leaves():
        leaf.histogram = rng.gamma(0.5, 1.0, leaf.nhist) + 1e-3
        leaf.train()
        leaf.histogram = rng.gamma(0.5, 1.0, leaf.nhist)
    mj.save_state(jc, tmp_path / "jax.npz")
    tc = mt.Configuration(var=_vars(mt), dof=[[1, 1], [2, 0]], seed=9)
    mt.load_state(tc, tmp_path / "jax.npz")
    assert np.array_equal(tc.reweight, jc.reweight)
    for (_, a), (_, b) in zip(tc.var_leaves(), jc.var_leaves()):
        _same_leaf_state(a, b)

    mt.save_state(tc, tmp_path / "torch.npz")
    jc2 = mj.Configuration(var=_vars(mj), dof=[[1, 1], [2, 0]], seed=9)
    mj.load_state(jc2, tmp_path / "torch.npz")
    for (_, a), (_, b) in zip(jc2.var_leaves(), jc.var_leaves()):
        _same_leaf_state(a, b)
    with np.load(tmp_path / "torch.npz") as t, np.load(tmp_path / "jax.npz") as j:
        assert sorted(t.files) == sorted(j.files)


def test_chip_smoke_refuses_without_card_or_package(tmp_path):
    """No CUDA device, or no package beside it: non-zero exit, no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    proc = _python(["chip_smoke.py"], ROOT)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
