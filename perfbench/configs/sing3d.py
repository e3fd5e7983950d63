"""``sing3d``: Watson's integral, the singular 3-D test of Lepage's VEGAS.

    I = (1/pi^3) int_[0,pi)^3 dx dy dz / (1 - cos x cos y cos z) = 1.3932039296856768

Source: MCIntegration.jl ``example/benchmark/vegas/benchmark1.jl`` and
``test/montecarlo.jl:119-164`` (Lepage's VEGAS test).  Nothing of the problem
is cut; the evaluations an iteration are set on our side (``assumed``).

The integrand is the folded form free of cancellation in float32 at the four
singular corners (0,0,0), (pi,pi,0), (pi,0,pi), (0,pi,pi): each angle is
folded to its distance u from the nearer of 0 and pi, the denominator is
2 sin^2(ua/2) + cos ua 2 sin^2(ub/2) + cos ua cos ub 2 sin^2(uc/2) (a sum of
non-negative terms), and an odd number of angles beyond pi/2 flips the
product's sign, so the denominator is 2 minus that sum.  Written in plain
torch, in the dtype of its input, so the plain reference evaluates the same
function in float64 or at lower precision.

This module imports neither the port nor JAX: ``port_kwargs(mt, device)``
takes the port's module to build its variables.
"""

import math

import numpy as np
import torch

SOURCE = "https://github.com/numericalEFT/MCIntegration.jl/blob/master/example/benchmark/vegas/benchmark1.jl"
DTYPE = "float32"
EXACT = np.array([1.3932039296856768])     # Watson's integral, bcc lattice: Gamma(1/4)^4 / (4 pi^3)
LABELS = ["I"]

# The problem as the reference states it: one Continuous pool on [0, pi),
# three draws of it, a map of 1,000 increments (``Continuous``' default in
# MCIntegration.jl, ``src/distribution/variable.jl``) and alpha 2.
VARS = [{"kind": "continuous", "lower": 0.0, "upper": math.pi, "ninc": 1000, "alpha": 2.0,
         "draws": 3}]

# pi = PI_HI + PI_LO to float32's double precision, so pi - t is exact near pi
PI_HI = float(np.float32(np.pi))
PI_LO = np.pi - PI_HI

# Evaluations the integrand has received, counted where they arrive (the
# harness reads and resets it; a module global, so the port's iteration
# cache, which hashes what a closure captures, does not see it change).
# Batches of at most PROBE samples are the port's probe of a fresh build
# (4 x 2 samples, or one under vmap), no part of the integration.
EVALS = [0]
PROBE = 8


def integrand(x, c=None):
    """The folded Watson integrand of a batch ``x[k]`` (k = 0, 1, 2)."""
    if x[0].numel() > PROBE:
        EVALS[0] += x[0].numel()
    u = [torch.minimum(t, (PI_HI - t) + PI_LO) for t in x]
    ca, cb = torch.cos(u[0]), torch.cos(u[1])
    s2a = 2 * torch.sin(u[0] / 2) ** 2
    s2b = 2 * torch.sin(u[1] / 2) ** 2
    s2c = 2 * torch.sin(u[2] / 2) ** 2
    below = s2a + ca * s2b + ca * cb * s2c               # 1 - |cos a cos b cos c|
    odd = (x[0] > np.pi / 2) ^ (x[1] > np.pi / 2) ^ (x[2] > np.pi / 2)
    return 1.0 / torch.where(odd, 2.0 - below, below) / np.pi ** 3


def port_kwargs(mt, device):
    """``integrate`` keywords of the problem for the port's module ``mt``,
    with fresh variable pools (one call's)."""
    v = VARS[0]
    return dict(var=mt.Continuous(v["lower"], v["upper"], ninc=v["ninc"], alpha=v["alpha"]),
                dof=[[v["draws"]]])


def reference_integrand(xs, device):
    """The plain reference's integrand over its per-variable draws: the
    three angles."""
    return integrand(xs[0]).unsqueeze(0)


def port_integrand(device):
    """The integrand the port's runs take (one object, so the iteration
    cache sees the same function)."""
    return integrand
