"""The Lindhard bubble on :vegas against its exact value, over seeds and routes.

    python3 tools/bubble_witness.py [--seeds N]     # on a CUDA card

Runs the bubble of ``chip_smoke.py``'s phase 4h through
``integrate(solver="vegas", device="cuda")`` at 2^30 evaluations an
iteration, 16 blocks and 10 iterations:

- on the mixed route, as phase 4h does (the ``Discrete(1, 4,
  adapt=False)`` q index and the one-hot measure), for N seeds (default 4)
  after phase 4h's own;
- on the uniform route, one run per q with q fixed: the four
  ``Continuous`` pools of one ninc, no Discrete pool and no measure.

Per run and q bin it prints the distance in sigma from ``lindhard(q)``
(the zero-temperature function) and from ``bubble_exact(q)`` (the
integral at the bubble's temperature), for the inverse-variance weighted
mean that ``integrate`` returns and for the plain mean of the iterations
(its sigma from the iterations' own error bars), then the mean and rms of
each distance over all runs and bins.  A bias that is the law's shows on
both routes and in both means; one of the mixed route alone would be the
port's.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np


def _fixed_q_bubble(cs, q):
    """The bubble's integrand at one external momentum ``(q, 0, 0)``, batched."""
    import torch

    def f(v, c):
        R, Th, Ph, T = v
        r = R[0] / (1 - R[0])
        th, ph = Th[0], Ph[0]
        k = torch.stack([r * torch.sin(th) * torch.cos(ph), r * torch.sin(th) * torch.sin(ph),
                         r * torch.cos(th)])
        factor = r ** 2 / (1 - R[0]) ** 2 * torch.sin(th) / (2 * np.pi) ** 3
        kq = torch.stack([k[0] + q, k[1], k[2]])
        w1 = ((k * k).sum(0) - cs.KF ** 2) / (2 * cs.ME)
        w2 = ((kq * kq).sum(0) - cs.KF ** 2) / (2 * cs.ME)
        return (cs._green(T[0], w1, cs.BETA_PHYS) * cs._green(-T[0], w2, cs.BETA_PHYS)
                * cs.SPIN * factor)

    return f


def _distances(res, exact):
    """(weighted z, plain z) of a result's first observable against ``exact``."""
    mean, std = np.atleast_1d(res.mean[0]), np.atleast_1d(res.stdev[0])
    its = np.asarray([np.atleast_1d(h[0][0]) for h in res.iterations])
    errs = np.asarray([np.atleast_1d(h[1][0]) for h in res.iterations])
    plain = its.mean(0)
    plain_std = np.sqrt((errs ** 2).sum(0)) / len(its)
    return (mean - exact) / std, (plain - exact) / plain_std, mean, std


def main() -> int:
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("bubble_witness: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import mcintegration_tpu_torch as mt

    nseeds = int(sys.argv[sys.argv.index("--seeds") + 1]) if "--seeds" in sys.argv else 4
    card = cs.card_line()
    qs = [q[0] for q in cs.EXTQ]
    lind = np.asarray([cs.lindhard(q) for q in qs])
    law = np.asarray([cs.bubble_exact(q) for q in qs])
    print(f"bubble_witness: lindhard(q) {lind.tolist()}, bubble_exact(q) {law.tolist()}, "
          f"relative offset {((law - lind) / np.abs(lind)).tolist()} [{card}]", flush=True)
    kw = dict(solver="vegas", neval=cs.VEGAS_NEVAL, niter=10, block=16, device="cuda",
              verbose=-2)
    zl, zt, pl, pt = [], [], [], []

    def record(what, res, bins):
        z_l, p_l, mean, std = _distances(res, lind[bins])
        z_t, p_t, _, _ = _distances(res, law[bins])
        zl.extend(z_l), zt.extend(z_t), pl.extend(p_l), pt.extend(p_t)
        print(f"bubble_witness: {what}: {mean.tolist()} +- {std.tolist()}; sigma from "
              f"lindhard {np.round(z_l, 2).tolist()}, from bubble_exact "
              f"{np.round(z_t, 2).tolist()}; plain mean of the iterations: from lindhard "
              f"{np.round(p_l, 2).tolist()}, from bubble_exact {np.round(p_t, 2).tolist()}",
              flush=True)

    bubble = cs.make_vegas_bubble("cuda")
    for seed in range(cs.SEED + 1, cs.SEED + 1 + nseeds):
        res = mt.integrate(bubble, seed=seed, **kw, **cs.vegas_bubble_kw(mt))
        assert res.backend == "cuda", res.backend
        record(f"mixed route, seed {seed}", res, slice(None))
    C = mt.Continuous
    for i, q in enumerate(qs):
        var = (C(0.0, 1.0, alpha=3.0), C(0.0, np.pi, alpha=3.0), C(0.0, 2 * np.pi, alpha=3.0),
               C(0.0, cs.BETA_PHYS, alpha=3.0))
        res = mt.integrate(_fixed_q_bubble(cs, q), var=var, dof=[[1, 1, 1, 1]], seed=cs.SEED,
                           **kw)
        assert res.backend == "cuda", res.backend
        record(f"uniform route, q = {q!r}", res, slice(i, i + 1))
    for what, z in (("sigma from lindhard", zl), ("sigma from bubble_exact", zt),
                    ("plain mean, sigma from lindhard", pl),
                    ("plain mean, sigma from bubble_exact", pt)):
        z = np.asarray(z)
        print(f"bubble_witness: {what} over {len(z)} bins: mean {z.mean()!r}, rms "
              f"{np.sqrt((z ** 2).mean())!r}, largest |z| {np.abs(z).max()!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
