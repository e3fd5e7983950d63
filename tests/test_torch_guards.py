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
            "mcintegration_tpu_torch.ops.vplus_kernels, mcintegration_tpu_torch.solvers.vegasplus, "
            "mcintegration_tpu_torch.solvers.vegas, mcintegration_tpu_torch.debug, "
            "mcintegration_tpu_torch.parallel.mesh, mcintegration_tpu_torch.examples.quickstart, "
            "mcintegration_tpu_torch.examples.bubble\n"
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


def _complex_obs(solver):
    if solver == "mcmc":
        measure = lambda i, v, relw, c: [relw * torch.ones(2)]
    else:
        measure = lambda v, relw, c: [relw[0] * torch.ones(2)]
    return {"solver": solver, "obs": [np.zeros(2, complex)], "measure": measure}


@pytest.mark.parametrize("kwargs,item", [
    ({"dtype": torch.float64}, "item 22"),
    ({"solver": "vegasmc", "dtype": np.float16}, "item 22"),
    ({"backend": "xla"}, "one route per device"),
    ({"solver": "mcmc", "backend": "pallas"}, "one route per device"),
    (_complex_obs("vegas"), "complex observables .* type=complex"),
    (_complex_obs("vegasmc"), "complex observables .* type=complex"),
    (_complex_obs("mcmc"), "complex observables .* type=complex"),
], ids=["dtype", "dtype-vegasmc",
        "backend", "backend-mcmc", "complex-obs-vegas",
        "complex-obs-vegasmc", "complex-obs-mcmc"])
def test_unported_options_raise(kwargs, item):
    kw = {"var": mt.Continuous(0.0, 1.0), "dof": [[2]], "neval": 2 ** 12,
          "solver": "vegas", "device": "cpu", "verbose": -2, **kwargs}
    with pytest.raises(NotImplementedError, match=item):
        mt.integrate(lambda x, c: x[0][0] * 1.0 if isinstance(x, tuple) else x[0], **kw)


@pytest.mark.parametrize("kwargs", [
    {"mesh": object()},
    {"debug": True},
    {"cache": False},
    {"parallel": "nothread"},
], ids=["mesh", "debug", "cache", "parallel"])
def test_served_keywords(kwargs):
    """The keywords of ROADMAP.md items 15-17, which raised before:
    ``debug=True`` and ``parallel="nothread"`` (one rank without a process
    group) run, ``cache=False`` runs and adds no cache entry, and a mesh that
    is not the port's raises naming ``make_mesh``."""
    from mcintegration_tpu_torch.main import _KERNEL_CACHE
    mt.clear_kernel_cache()
    kw = {"var": mt.Continuous(0.0, 1.0), "dof": [[2]], "neval": 2 ** 12, "niter": 2,
          "solver": "vegas", "device": "cpu", "verbose": -2, "seed": 3, **kwargs}
    if "mesh" in kwargs:
        with pytest.raises(TypeError, match="make_mesh"):
            mt.integrate(_pi, **kw)
        return
    res = mt.integrate(_pi, **kw)
    assert len(_KERNEL_CACHE) == (0 if kwargs.get("cache") is False else 1)
    assert abs(res.mean[0] - np.pi / 4) < 7 * res.stdev[0]
    one = mt.integrate(_pi, **{**kw, "var": mt.Continuous(0.0, 1.0), "debug": False,
                               "cache": False, "parallel": "none"})
    assert np.array_equal(res.mean, one.mean) and np.array_equal(res.stdev, one.stdev)


def _cx(x, c):
    return x[0] + 1j * x[1] ** 2


@pytest.mark.parametrize("kwargs,exact", [
    ({"solver": "vegasplus", "measure": lambda v, relw, c: [relw[0]], "obs": [0.0]}, 0.5),
    ({"solver": "vegas+", "measurefreq": 2}, 0.5),
    ({"solver": ":vegasplus", "type": complex, "f": _cx}, 0.5 + 1j / 3),
    ({"measurefreq": 2}, 0.5),
    ({"type": complex, "f": _cx}, 0.5 + 1j / 3),
    ({"type": complex, "measure": lambda v, relw, c: [relw[0]], "obs": [0j], "f": _cx},
     0.5 + 1j / 3),
    ({"var": Discrete(1, 10), "dof": [[1]], "f": lambda x, c: x[0].to(torch.float32)}, 55.0),
    ({"var": (mt.Continuous(0.0, 1.0, ninc=64), mt.Continuous(0.0, 1.0, ninc=32)),
      "dof": [[1, 1]], "f": lambda x, c: x[0][0] * x[1][0]}, 0.25),
], ids=["vegasplus-measure", "vegasplus-measurefreq", "vegasplus-complex",
        "measurefreq", "complex", "complex-measure-vegas", "discrete", "mixed-ninc"])
def test_item14_routes_run(kwargs, exact):
    """The routes of ROADMAP.md item 14, which raised before, run on the
    CPU and land within 7 sigma of the exact value, both parts of a complex
    mean."""
    kwargs = dict(kwargs)
    f = kwargs.pop("f", lambda x, c: x[0])
    kw = {"var": mt.Continuous(0.0, 1.0), "dof": [[2]], "neval": 2 ** 14, "niter": 3,
          "solver": "vegas", "device": "cpu", "verbose": -2, "seed": 11, **kwargs}
    res = mt.integrate(f, **kw)
    mean, err = complex(np.asarray(res.mean[0])), complex(np.asarray(res.stdev[0]))
    assert res.backend == "torch"
    assert abs(mean.real - exact.real) < 7 * err.real, (mean, err)
    assert abs(mean.imag - complex(exact).imag) < 7 * err.imag + 1e-12, (mean, err)


@pytest.mark.parametrize("obs,value", [(np.zeros(2, complex), 1.0), (np.zeros(2), 1j)],
                         ids=["complex-leaf", "complex-values"])
def test_real_weight_mcmc_refuses_complex_observables(obs, value):
    """A real-weight :mcmc run with a complex observable leaf, or whose
    measure returns complex values for a real one, raises: the reference's
    XLA route drops the imaginary part there."""
    with pytest.raises(NotImplementedError, match="complex observables .* type=complex"):
        mt.integrate(lambda i, x, c: x[0] * 1.0, var=mt.Continuous(0.0, 1.0), dof=[[2]],
                     neval=2 ** 12, niter=1, solver="mcmc", device="cpu", verbose=-2,
                     obs=[obs], measure=lambda i, v, relw, c: [torch.stack([relw, relw]) * value])


def test_reference_keyword_defaults_run():
    """dtype, backend, cache and parallel at the reference's defaults (and
    float32 named three ways) are served, not dropped in **kwargs."""
    for dtype in (torch.float32, np.float32, "float32"):
        res = mt.integrate(_pi, var=mt.Continuous(0.0, 1.0), dof=[[2]], neval=2 ** 12,
                           niter=2, solver="vegas", device="cpu", verbose=-2, seed=1,
                           dtype=dtype, backend="auto", cache=True, parallel="auto")
        assert res.backend == "torch"


def test_average_is_exported():
    from mcintegration_tpu_torch import average
    from mcintegration_tpu_torch.statistics import average as stats_average

    assert average is stats_average and "average" in mt.__all__
    res = mt.integrate(_pi, var=mt.Continuous(0.0, 1.0), dof=[[2]], neval=2 ** 12,
                       niter=3, solver="vegas", device="cpu", verbose=-2, seed=1)
    m, e, chi2 = average(res.iterations, 0, init=1)
    assert np.isfinite(m) and e > 0 and np.isfinite(chi2)


def test_state_round_trips_with_array_observable(tmp_path):
    """save_state and load_state carry the trained maps of a config whose
    observable is an array; the observable itself is not state."""
    obs = [np.zeros(10)]
    cfg = mt.Configuration(var=(mt.Continuous(0.0, 1.0), mt.Continuous(0.0, 1.0)),
                           dof=[[1, 1]], obs=obs, seed=4)
    for _, leaf in cfg.var_leaves():
        leaf.histogram = np.random.default_rng(1).gamma(0.5, 1.0, leaf.nhist) + 1e-3
        leaf.train()
    mt.save_state(cfg, tmp_path / "s.npz")
    back = mt.load_state(mt.Configuration(var=(mt.Continuous(0.0, 1.0), mt.Continuous(0.0, 1.0)),
                                          dof=[[1, 1]], obs=[np.zeros(10)], seed=4),
                         tmp_path / "s.npz")
    for (_, a), (_, b) in zip(back.var_leaves(), cfg.var_leaves()):
        assert np.array_equal(a.grid, b.grid) and np.array_equal(a.histogram, b.histogram)
    assert np.shape(back.observable[0]) == (10,)


def test_default_solver_is_not_served_and_unknown_solver_fails():
    """The default solver (:vegasmc) now runs; an unknown solver fails."""
    res = mt.integrate(_pi, var=mt.Continuous(0.0, 1.0), dof=[[2]], neval=2 ** 12,
                       niter=2, device="cpu", verbose=-2, seed=1)
    assert res.backend == "torch" and res.neval == 2 * 2 ** 12
    assert abs(float(res.mean[0]) - np.pi / 4) < 7 * float(res.stdev[0])
    for solver in ("nope", "vegasplusplus", ":vegas++"):
        with pytest.raises(ValueError, match="not supported"):
            mt.integrate(_pi, solver=solver, device="cpu")


@pytest.mark.parametrize("cls,item", [(FermiK, ":mcmc solver only")], ids=["cls1-item 12"])
def test_unported_pools_raise(cls, item):
    """A FermiK pool runs on :mcmc only, and raises on :vegas and :vegasmc
    as in the JAX package (tests/test_bubble_fermik.py:63-70)."""
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
