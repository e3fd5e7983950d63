"""A plain VEGAS integrator in torch: the benchmark's reference integrator.

It integrates a configuration (``configs/<name>.py``: ``VARS``,
``reference_integrand``) as MCIntegration.jl's ``:vegas`` does, written
straight from the method and independent of the port: every iteration
draws ``block`` blocks of ``neval // block`` samples, each variable through
its own adaptive map (a Continuous variable's piecewise-linear inverse CDF
of ``ninc`` increments; a Discrete variable that does not adapt uniformly),
weighs each sample by the integrand times the maps' Jacobian, takes each
block's mean, and trains each map on the histogram of the squared weights
that fell in its increments (the smoothing, damping and equal-mass
refinement of ``train_grid`` below, a frozen copy of the law of
MCIntegration.jl ``src/distribution/variable.jl:206-239`` and
``common.jl:43-100``).  The iterations' estimates are combined by inverse
variance, the first one left out (``src/statistics.jl:186-220``).  Its
samples are drawn independently, as MCIntegration.jl's ``:vegas`` draws
them: its mean estimates the same integral as the port's, its trained maps
are the maps the port's training should approach, and its error bar is
the yardstick ``harness/checks.py`` holds the port's against.

``dtype`` is the precision of every per-sample operation: the uniforms,
the maps, the integrand and the weights.  A weight that rounds to a
non-finite value (an overflow at a singular point) counts as 0, as the port
counts it.  Sums over samples are taken in
float64 whatever ``dtype`` (as the port takes them), statistics and
training in float64 on the host.  Run at float64 it is the plain reference;
run one step below the configuration's float32, in bfloat16, in the port's
place, it is the control that the correctness check must reject.

It imports neither JAX nor anything of ``mcintegration_tpu_torch``.
"""

from __future__ import annotations

import numpy as np
import torch

HIST_FLOOR = 1.0e-10        # an increment's histogram before any sample
BATCH = 2 ** 24             # samples a pass


def smooth(dist, factor=6.0):
    """Neighbour smoothing 1 : factor : 1, endpoints (factor+1) : 1."""
    dist = np.asarray(dist, np.float64)
    out = np.empty_like(dist)
    out[0] = (dist[0] * (factor + 1) + dist[1]) / (factor + 2)
    out[-1] = (dist[-1] * (factor + 1) + dist[-2]) / (factor + 2)
    out[1:-1] = (dist[:-2] + dist[1:-1] * factor + dist[2:]) / (factor + 2)
    return out


def rescale(dist, alpha):
    """d -> ((1 - d) / ln(1/d))^alpha of the normalised distribution."""
    dist = np.asarray(dist, np.float64)
    dist = dist / dist.sum()
    out = dist.copy()
    mask = (dist > 0) & (dist <= 0.99999999)
    out[mask] = (-(1.0 - dist[mask]) / np.log(dist[mask])) ** alpha
    return out


def train_grid(grid, hist, alpha):
    """A new grid whose increments hold equal shares of the smoothed,
    damped histogram's mass."""
    ninc = grid.shape[0] - 1
    avg = rescale(smooth(hist), alpha)
    cum = np.cumsum(avg)
    targets = cum[-1] / ninc * np.arange(1, ninc)
    j = np.minimum(np.searchsorted(cum, targets, side="left"), ninc - 1)
    new = np.empty_like(grid)
    new[0], new[-1] = grid[0], grid[-1]
    new[1:-1] = grid[j + 1] - ((cum[j] - targets) / avg[j]) * (grid[j + 1] - grid[j])
    return new


class Map:
    """A Continuous variable's adaptive map, or a Discrete one's uniform
    draw."""

    def __init__(self, spec):
        self.spec = spec
        self.continuous = spec["kind"] == "continuous"
        if self.continuous:
            self.grid = np.linspace(spec["lower"], spec["upper"], spec["ninc"] + 1)
            self.hist = np.full(spec["ninc"], HIST_FLOOR)

    def draw(self, gen, n, dtype, device):
        """``(x [draws, n], jac [n], bins [draws, n] or None)``."""
        d = self.spec["draws"]
        if not self.continuous:
            lo, hi = self.spec["lower"], self.spec["upper"]
            x = torch.randint(lo, hi + 1, (d, n), generator=gen, device=device, dtype=torch.int32)
            return x, torch.full((n,), float(hi - lo + 1) ** d, dtype=dtype, device=device), None
        ninc = self.spec["ninc"]
        grid = torch.as_tensor(self.grid[:-1], dtype=dtype, device=device)
        inc = torch.as_tensor(np.diff(self.grid), dtype=dtype, device=device)
        y = torch.rand((d, n), generator=gen, device=device, dtype=dtype) * ninc
        bins = y.to(torch.int64).clamp_(0, ninc - 1)
        dx = inc[bins]
        x = grid[bins] + (y - bins.to(dtype)) * dx
        return x, (ninc * dx).prod(0), bins

    def add(self, bins, h):
        if self.continuous:
            for row in bins:
                self.hist += torch.bincount(row, weights=h, minlength=self.hist.shape[0]) \
                    .cpu().numpy()

    def train(self):
        if self.continuous:
            self.grid = train_grid(self.grid, self.hist, self.spec["alpha"])
            self.hist = np.full(self.spec["ninc"], HIST_FLOOR)


def combine(means, stds, ignore=1):
    """The iterations' inverse-variance mean, its error and the reduced
    chi2 of the iterations about that mean, past ``ignore`` (elementwise
    over components; with one iteration past ``ignore``, that iteration and
    a chi2 of 0)."""
    m = np.asarray(means[ignore:], np.float64)
    s = np.asarray(stds[ignore:], np.float64)
    if len(m) < 2:
        return m[0], s[0], np.zeros_like(m[0])
    w = 1.0 / (s + 1e-10) ** 2
    mean = (w * m).sum(0) / w.sum(0)
    chi2 = (w * (m - mean) ** 2).sum(0) / (len(m) - 1)
    return mean, 1.0 / np.sqrt(w.sum(0)), chi2


def run(cfg, *, neval, niter, block, seed, device, dtype=torch.float64) -> dict:
    """One call: ``mean``, ``stdev`` and ``chi2`` per observable component
    of configuration module ``cfg``, over ``niter`` iterations of ``neval``
    samples in ``block`` blocks, each iteration's estimates (``it_means``,
    ``it_stds``; the first ``ignore`` left out of the combination), and
    ``grids``, each Continuous variable's map after the last iteration's
    training."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2 ** 63)
    maps = [Map(v) for v in cfg.VARS]
    npb = int(neval) // int(block)
    it_means, it_stds = [], []
    for _ in range(niter):
        blocks = []
        for _ in range(block):
            acc = 0.0
            for start in range(0, npb, BATCH):
                n = min(BATCH, npb - start)
                draws = [m.draw(gen, n, dtype, device) for m in maps]
                jac = draws[0][1]
                for _, j, _ in draws[1:]:
                    jac = jac * j
                w = cfg.reference_integrand([x for x, _, _ in draws], device) * jac   # [ncomp, n]
                w = torch.where(torch.isfinite(w), w, torch.zeros_like(w))
                acc = acc + w.sum(1, dtype=torch.float64)
                h = w.to(torch.float64).abs().sum(0) ** 2
                for m, (_, _, bins) in zip(maps, draws):
                    m.add(bins, h)
            blocks.append((acc / npb).cpu().numpy())
        b = np.asarray(blocks)
        mean = b.mean(0)
        std = np.sqrt(np.maximum((np.mean(b ** 2, 0) - mean ** 2) / (block - 1), 0.0))
        it_means.append(mean)
        it_stds.append(std)
        for m in maps:
            m.train()
    mean, std, chi2 = combine(it_means, it_stds)
    return {"mean": mean, "stdev": std, "chi2": chi2, "it_means": it_means, "it_stds": it_stds,
            "ignore": 1, "grids": [m.grid.copy() for m in maps if m.continuous]}

