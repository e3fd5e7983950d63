"""``bubble``: the Lindhard polarisation bubble of the 3-D electron gas.

    P(q) = SPIN int d^3k/(2 pi)^3 int_0^beta dtau G(tau, e_k) G(-tau, e_{k+q})

in spherical coordinates, k = r/(1 - r) (sin th cos ph, sin th sin ph,
cos th), with the external momentum q one of four values from 0 to 1.5 kF,
drawn as a Discrete(1, 4) variable that does not adapt and binned by a
one-hot measure.  Physics: rs = 1, SPIN = 2, me = 1/2, beta = 25 / E_F.

Source: MCIntegration.jl ``test/bubble.jl:8-136``.  Nothing is cut; the
evaluations an iteration are set on our side (``assumed``).

``EXACT`` holds the integral at that temperature for each q, computed once
by quadrature (``reference/exact.py:bubble_exact``, where the radial
integral is done in closed form over the angles); its zero-temperature
limit is the Lindhard function ``reference/exact.py:lindhard(q)``, which
lies below it by 6.6e-4 to 2.0e-3 of it.

This module imports neither the port nor JAX: ``port_kwargs(mt, device)``
takes the port's module to build its variables.
"""

import math

import numpy as np
import torch

SOURCE = "https://github.com/numericalEFT/MCIntegration.jl/blob/master/test/bubble.jl"
DTYPE = "float32"
QSIZE = 4
RS, BETA, SPIN, ME = 1.0, 25.0, 2, 0.5
KF = (9 * math.pi / (2 * SPIN)) ** (1 / 3) / RS
BETA_PHYS = BETA / (KF ** 2 / (2 * ME))
EXTQ = np.array([[q, 0.0, 0.0] for q in np.linspace(0.0, 1.5 * KF, QSIZE)])
# bubble_exact(q) for q in EXTQ[:, 0], at BETA_PHYS (scipy quad, epsrel 1e-13)
EXACT = np.array([-0.09716126865385111, -0.09510537068597599, -0.08858162927185152,
                  -0.07605300600570583])
LABELS = [f"q={q:.4f}" for q in EXTQ[:, 0]]

# r, theta, phi, tau as Continuous maps of alpha 3, the external q a
# Discrete(1, 4) that does not adapt (test/bubble.jl:80-90); each map of
# 1,000 increments, ``Continuous``' default in MCIntegration.jl
VARS = [{"kind": "continuous", "lower": 0.0, "upper": 1.0, "ninc": 1000, "alpha": 3.0, "draws": 1},
        {"kind": "continuous", "lower": 0.0, "upper": math.pi, "ninc": 1000, "alpha": 3.0,
         "draws": 1},
        {"kind": "continuous", "lower": 0.0, "upper": 2 * math.pi, "ninc": 1000, "alpha": 3.0,
         "draws": 1},
        {"kind": "continuous", "lower": 0.0, "upper": BETA_PHYS, "ninc": 1000, "alpha": 3.0,
         "draws": 1},
        {"kind": "discrete", "lower": 1, "upper": QSIZE, "draws": 1}]

# Evaluations the integrand has received (see configs/sing3d.py)
EVALS = [0]
PROBE = 8


def _green(tau, omega, beta):
    pos = tau >= 0.0
    gp = torch.where(omega > 0.0, torch.exp(-omega * tau) / (1 + torch.exp(-omega * beta)),
                     torch.exp(omega * (beta - tau)) / (1 + torch.exp(omega * beta)))
    gn = torch.where(omega > 0.0, -torch.exp(-omega * (tau + beta)) / (1 + torch.exp(-omega * beta)),
                     -torch.exp(-omega * tau) / (1 + torch.exp(omega * beta)))
    return torch.where(pos, gp, gn)


def make_integrand(device, dtype=torch.float32):
    """The bubble, batched (``v[k][0]`` is variable k's values), with its q
    table on ``device`` once: a copy from the host in every call would wait
    for the device."""
    extq = torch.as_tensor(EXTQ, dtype=dtype, device=device)

    def bubble(v, c=None):
        R, Th, Ph, T, Ext = v
        if R[0].numel() > PROBE:
            EVALS[0] += R[0].numel()
        r = R[0] / (1 - R[0])
        th, ph = Th[0], Ph[0]
        k = torch.stack([r * torch.sin(th) * torch.cos(ph), r * torch.sin(th) * torch.sin(ph),
                         r * torch.cos(th)])
        factor = r ** 2 / (1 - R[0]) ** 2 * torch.sin(th) / (2 * np.pi) ** 3
        kq = k + extq[Ext[0] - 1].movedim(-1, 0)
        w1 = ((k * k).sum(0) - KF ** 2) / (2 * ME)
        w2 = ((kq * kq).sum(0) - KF ** 2) / (2 * ME)
        return _green(T[0], w1, BETA_PHYS) * _green(-T[0], w2, BETA_PHYS) * SPIN * factor

    return bubble


def measure(v, relw, c=None):
    """relw[0] into the bin of the external momentum (test/bubble.jl:74-77):
    ``[QSIZE, *batch]``."""
    ext = v[-1][0]
    bins = torch.arange(1, QSIZE + 1, device=ext.device).reshape((-1,) + (1,) * ext.ndim)
    return [(bins == ext).to(relw.dtype) * relw[0]]


def port_kwargs(mt, device):
    """``integrate`` keywords of the problem for the port's module ``mt``,
    with fresh variable pools (one call's)."""
    var = tuple(mt.Continuous(v["lower"], v["upper"], ninc=v["ninc"], alpha=v["alpha"])
                if v["kind"] == "continuous" else mt.Discrete(v["lower"], v["upper"], adapt=False)
                for v in VARS)
    return dict(var=var, dof=[[1] * len(VARS)], obs=[np.zeros(QSIZE)], measure=measure)


def reference_integrand(xs, device):
    """The plain reference's weights ``[QSIZE, n]``: the bubble's value in
    the bin of each sample's q, as the one-hot measure bins it."""
    w = make_integrand(device, xs[0].dtype)(xs)
    return measure(xs, w.unsqueeze(0))[0]


def port_integrand(device):
    """The integrand the port's runs take, its q table on ``device``."""
    return make_integrand(device)
