"""Quickstart examples on the PyTorch port (counterpart of
``examples/quickstart.py``): a one-dimensional singular integral, the
quarter unit circle, composite variables, discrete variables, several
integrands with shared pools, and a histogram observable through a custom
measure.

Run: python -m mcintegration_tpu_torch.examples.quickstart [neval] [--device cpu] [--niter N]
"""

import argparse

import numpy as np
import torch

from mcintegration_tpu_torch import (
    CompositeVar,
    Configuration,
    Continuous,
    Discrete,
    integrate,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("neval", nargs="?", type=float, default=100_000)
    ap.add_argument("--device", default="cuda", help="'cuda' (the kernels) or 'cpu'")
    ap.add_argument("--niter", type=int, default=10, help="iterations of each run")
    args = ap.parse_args(argv)
    neval, dev, niter = int(args.neval), args.device, args.niter

    # --- 1) 1-D singular integral: ∫₀¹ log(x)/√x dx = -4 ------------------
    res = integrate(lambda x, c: torch.log(x[0]) / torch.sqrt(x[0]),
                    var=Continuous(0.0, 1.0), dof=[[1]],
                    neval=neval, solver="vegas", verbose=-2, device=dev, niter=niter)
    print("log(x)/sqrt(x)  :", res, " (exact -4)")

    # --- 2) π/4 from the quarter unit circle ------------------------------
    res = integrate(lambda x, c: torch.where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0),
                    var=Continuous(0.0, 1.0), dof=[[2]],
                    neval=neval, solver="vegasmc", verbose=-2, device=dev, niter=niter)
    print("quarter circle  :", res, f" (exact {np.pi/4:.6f})")

    # --- 3) polar-coordinate variant with a CompositeVar ------------------
    def f_polar(v, c):
        r, th = v
        return r[0]  # ∫ r dr dθ over r∈[0,1], θ∈[0,π/2] = π/4

    cv = CompositeVar(Continuous(0.0, 1.0), Continuous(0.0, np.pi / 2))
    res = integrate(f_polar, var=cv, dof=1, neval=neval,
                    solver="vegasmc", verbose=-2, device=dev, niter=niter)
    print("polar circle    :", res, f" (exact {np.pi/4:.6f})")

    # --- 4) discrete variable: Σ_{n=1..100} 1 = 100 ----------------------
    res = integrate(lambda idx, n, c: 1.0, var=Discrete(1, 100), dof=[[1]],
                    neval=neval, solver="mcmc", verbose=-2, device=dev, niter=niter)
    print("discrete sum    :", res, " (exact 100)")

    # --- 5) two integrands sharing pools (mcmc, one eval per step) -------
    def f2(idx, x, c):
        if idx == 0:
            return x[0] ** 2
        return x[0] ** 2 + x[1] ** 2

    res = integrate(f2, var=Continuous(0.0, 1.0), dof=[[1], [2]],
                    neval=neval, solver="mcmc", verbose=-2, device=dev, niter=niter)
    print("bundle          :", res, " (exact 1/3, 2/3)")

    # --- 6) histogram observable via custom measure ----------------------
    # measure ∫ dy f(x, y) binned over x — a 10-bin histogram observable
    nbin = 10

    def f(v, c):
        x, y = v
        return x[0] ** 2 + y[0] ** 2

    def measure(v, relw, c):
        x, _ = v
        b = torch.clamp((x[0] * nbin).to(torch.int32), 0, nbin - 1)
        return [torch.stack([(b == k).to(relw.dtype) for k in range(nbin)]) * relw[0] * nbin]

    cfg = Configuration(var=(Continuous(0.0, 1.0), Continuous(0.0, 1.0)),
                        dof=[[1, 1]], obs=[np.zeros(nbin)])
    res = integrate(f, config=cfg, measure=measure, neval=neval,
                    solver="vegasmc", verbose=-2, device=dev, niter=niter)
    got = np.asarray(res.mean[0])
    centers = (np.arange(nbin) + 0.5) / nbin
    print("histogram obs   : max|err| =",
          np.max(np.abs(got - (centers**2 + 1 / 3))), " (binned x^2+1/3)")


if __name__ == "__main__":
    main()
