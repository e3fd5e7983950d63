"""The exact values of the configurations, worked out by plain numpy and
scipy quadrature (frozen copies of the laws the configurations state).

- ``bubble_exact(q)``: the Lindhard bubble as posed, at inverse temperature
  ``beta``: ``-SPIN ME / (2 pi^2 q) int_0^inf k f(e_k) ln|(2k + q) / (2k - q)|
  dk`` (the angles done in closed form; ``-SPIN ME / (2 pi^2) int f dk`` at
  q = 0), ``f`` the Fermi function and ``e_k = (k^2 - KF^2) / (2 ME)``.
  ``configs/bubble.py:EXACT`` holds its four values, which a test recomputes.
- ``lindhard(q)``: its zero-temperature limit.
- ``WATSON``: Watson's integral for the body-centred cubic lattice,
  ``(1/pi^3) int_[0,pi)^3 1/(1 - cos x cos y cos z)``, in closed form
  ``Gamma(1/4)^4 / (4 pi^3)``.
"""

import math

import numpy as np

WATSON = math.gamma(0.25) ** 4 / (4 * math.pi ** 3)


def lindhard(q, KF, ME=0.5, SPIN=2):
    density = ME * KF / (2 * np.pi ** 2)
    q = max(q, 1e-6)
    x = q / 2 / KF
    p = 1 + (1 - x ** 2) * np.log1p(4 * x / ((1 - x) ** 2)) / 4 / x if abs(q - 2 * KF) > 1e-6 else 1.0
    return -p * density * SPIN / 2


def bubble_exact(q, beta, KF, ME=0.5, SPIN=2):
    from scipy.integrate import quad
    fermi = lambda k: 0.5 * (1.0 - np.tanh(0.5 * beta * (k * k - KF ** 2) / (2 * ME)))
    if q == 0:
        f, cut, scale = fermi, [0.0, KF, 4 * KF], -SPIN * ME / (2 * np.pi ** 2)
    else:
        f = lambda k: k * fermi(k) * np.log(abs((2 * k + q) / (2 * k - q)))
        cut = sorted({0.0, q / 2, KF, 4 * KF})
        scale = -SPIN * ME / (2 * np.pi ** 2 * q)
    return scale * sum(quad(f, a, b, epsabs=0.0, epsrel=1e-13, limit=500)[0]
                       for a, b in zip(cut[:-1], cut[1:]))
