"""Physics demo on the PyTorch port (counterpart of ``examples/bubble.py``):
the Lindhard polarization bubble of free electrons, a 4-variable
spherical-coordinate integral with a discrete external-momentum index, a
vector observable through a custom measure and a warm-started refinement
run, checked against the analytic Lindhard function.

Run: python -m mcintegration_tpu_torch.examples.bubble [neval] [solver] [--device cpu]
     [--niter N]
"""

import argparse

import numpy as np
import torch

from mcintegration_tpu_torch import Continuous, Discrete, integrate

QSIZE = 8
RS, BETA, SPIN, DIM, ME = 1.0, 25.0, 2, 3, 0.5
KF = (9 * np.pi / (2 * SPIN)) ** (1 / 3) / RS
BETA_PHYS = BETA / (KF**2 / (2 * ME))
EXTQ = np.array([[q, 0.0, 0.0] for q in np.linspace(0.0, 1.5 * KF, QSIZE)])


def lindhard(q):
    density = ME * KF / (2 * np.pi**2)
    q = max(q, 1e-6)
    x = q / 2 / KF
    if abs(q - 2 * KF) > 1e-6:
        p = 1 + (1 - x**2) * np.log1p(4 * x / ((1 - x) ** 2)) / 4 / x
    else:
        p = 1.0
    return -p * density * SPIN / 2


def green(tau, omega, beta):
    pos = tau >= 0.0
    gp = torch.where(omega > 0.0,
                     torch.exp(-omega * tau) / (1 + torch.exp(-omega * beta)),
                     torch.exp(omega * (beta - tau)) / (1 + torch.exp(omega * beta)))
    gn = torch.where(omega > 0.0,
                     -torch.exp(-omega * (tau + beta)) / (1 + torch.exp(-omega * beta)),
                     -torch.exp(-omega * tau) / (1 + torch.exp(omega * beta)))
    return torch.where(pos, gp, gn)


def integrand(v, c):
    """Elementwise over the sample axes: the external q is a one-hot sum."""
    R, TH, PH, T, EXT = v
    r = R[0] / (1 - R[0])
    th, ph = TH[0], PH[0]
    k = [r * torch.sin(th) * torch.cos(ph),
         r * torch.sin(th) * torch.sin(ph),
         r * torch.cos(th)]
    factor = r**2 / (1 - R[0]) ** 2 * torch.sin(th) / (2 * np.pi) ** DIM
    tau = T[0]
    e = EXT[0]
    oh = [(e == j + 1).to(torch.float32) for j in range(QSIZE)]
    q = [sum(oh[j] * float(EXTQ[j, d]) for j in range(QSIZE)) for d in range(DIM)]
    k2 = sum(kc * kc for kc in k)
    kq2 = sum((kc + qc) ** 2 for kc, qc in zip(k, q))
    g1 = green(tau, (k2 - KF**2) / (2 * ME), BETA_PHYS)
    g2 = green(-tau, (kq2 - KF**2) / (2 * ME), BETA_PHYS)
    return g1 * g2 * SPIN * factor


def measure(v, relw, c):
    """The observable axis as one-hot rows of the external-momentum index."""
    ext = v[-1][0]
    return [torch.stack([(ext == j + 1).to(relw.dtype) * relw[0] for j in range(QSIZE)])]


def measure_mcmc(idx, v, relw, c):
    ext = v[-1][0]
    return [torch.stack([(ext == j + 1).to(relw.dtype) * relw for j in range(QSIZE)])]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("neval", nargs="?", type=float, default=1_000_000)
    ap.add_argument("solver", nargs="?", default="vegasmc")
    ap.add_argument("--device", default="cuda", help="'cuda' (the kernels) or 'cpu'")
    ap.add_argument("--niter", type=int, default=10, help="iterations of each run")
    args = ap.parse_args(argv)
    neval, solver, dev = int(args.neval), args.solver, args.device
    fi = (lambda idx, v, c: integrand(v, c)) if solver == "mcmc" else integrand
    m = measure_mcmc if solver == "mcmc" else measure

    var = (Continuous(0.0, 1.0, alpha=3.0),
           Continuous(0.0, np.pi, alpha=3.0),
           Continuous(0.0, 2 * np.pi, alpha=3.0),
           Continuous(0.0, BETA_PHYS, alpha=3.0),
           Discrete(1, QSIZE, adapt=False))
    res = integrate(fi, measure=m, var=var, dof=[[1, 1, 1, 1, 1]],
                    obs=[np.zeros(QSIZE)], solver=solver, neval=neval,
                    verbose=-2, block=16, device=dev, niter=args.niter)
    # warm-started refinement run on the trained grids (bubble.jl:111-113)
    res = integrate(fi, measure=m, var=var, dof=[[1, 1, 1, 1, 1]],
                    obs=[np.zeros(QSIZE)], solver=solver, neval=neval * 4,
                    verbose=-2, block=64, niter=2, config=res.config, device=dev)

    avg, std = np.asarray(res.mean[0]), np.asarray(res.stdev[0])
    print(f"solver = {solver}")
    print(f"{'q/kF':>10s} {'avg':>12s} {'err':>10s} {'exact':>12s} {'sigma':>7s}")
    for i in range(QSIZE):
        exact = lindhard(EXTQ[i][0])
        ns = abs(avg[i] - exact) / max(std[i], 1e-12)
        print(f"{EXTQ[i][0]/KF:10.4f} {avg[i]:12.6f} {std[i]:10.6f} "
              f"{exact:12.6f} {ns:7.2f}")
    return res


if __name__ == "__main__":
    main()
