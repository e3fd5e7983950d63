"""mcintegration_tpu_torch — the PyTorch/CUDA port of mcintegration_tpu.

Serves ``integrate(..., solver="vegasmc")`` (the default) on ``Continuous``
and ``Discrete`` pools and ``integrate(..., solver="vegas")`` on
``Continuous`` pools, also bundled in a ``CompositeVar``, on one NVIDIA GPU:
the chain step's proposal and Metropolis accept (:vegasmc), and the
stratified Vegas draw and the observable/histogram reduction (:vegas), are
hand-written CUDA kernels (``csrc/``); the user integrand runs as torch ops
between them, and map training, reweighting and statistics run in float64
numpy on the host.  With ``device="cpu"`` the kernels' plain PyTorch
versions run instead.

The JAX package ``mcintegration_tpu`` stays the reference; this package
imports torch and numpy, never jax.  ROADMAP.md lists what is not ported yet.
"""

from .checkpoint import load_state, save_state
from .configuration import Configuration
from .main import integrate
from .models.variable import CompositeVar, Continuous, Discrete
from .statistics import Result, report

__version__ = "0.1.0"

__all__ = [
    "Configuration",
    "Continuous",
    "CompositeVar",
    "Discrete",
    "Result",
    "integrate",
    "report",
    "save_state",
    "load_state",
]
