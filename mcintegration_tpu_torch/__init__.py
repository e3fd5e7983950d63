"""mcintegration_tpu_torch — the PyTorch/CUDA port of mcintegration_tpu.

Serves ``integrate(..., solver="vegasmc")`` (the default) on ``Continuous``
and ``Discrete`` pools, ``integrate(..., solver="mcmc")`` on those and
``FermiK`` pools, with custom measures, ``integrate(..., solver="vegas")``
on ``Continuous`` pools, and ``integrate(..., solver="vegasplus")`` on
``Continuous`` pools with ``Discrete`` passengers, on one NVIDIA GPU: the
chain steps' proposals and Metropolis accepts (:vegasmc, :mcmc), the
stratified Vegas draw and the observable/histogram reduction (:vegas), and
the hypercube draw and the density, second-moment and histogram reduction
(:vegasplus) are hand-written CUDA kernels (``csrc/``); the user integrand
and measure run as torch ops between them, and map training, reweighting,
the reallocation of samples to hypercubes and statistics run in float64
numpy on the host.  With ``device="cpu"`` the kernels' plain PyTorch
versions run instead.

The JAX package ``mcintegration_tpu`` stays the reference; this package
imports torch and numpy, never jax.  ROADMAP.md lists what is not ported yet.
"""

from .checkpoint import load_state, save_state
from .common import onehot
from .configuration import Configuration
from .main import integrate
from .models.variable import CompositeVar, Continuous, Discrete, FermiK
from .statistics import Result, report

__version__ = "0.1.0"

__all__ = [
    "Configuration",
    "Continuous",
    "CompositeVar",
    "Discrete",
    "FermiK",
    "Result",
    "integrate",
    "report",
    "save_state",
    "load_state",
    "onehot",
]
