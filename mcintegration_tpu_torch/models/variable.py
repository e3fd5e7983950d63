"""Variable pools (the adaptive-distribution models) of the PyTorch port.

Counterpart of ``mcintegration_tpu/models/variable.py``.  A pool is a
*spec + trained state* object on the host (numpy float64 grid or
categorical distribution and histogram, trained once per iteration);
sampling happens on the device through the hand-written kernels of
``ops/vegas_kernels.py``, ``ops/chain_kernels.py`` and ``ops/mcmc_kernels.py``.

Semantics preserved from the reference (src/distribution/variable.jl):

- a pool is a set of slots sharing ONE learned 1-D map (a Vegas grid for
  ``Continuous``), so unbounded dimensionality shares a single trained map
  (variable.jl:87-153);
- ``offset`` reserves leading slots the MC never touches (user-set
  "external" variables, variable.jl:93);
- ``CompositeVar`` bundles pools that are drawn jointly with product
  probability (variable.jl:397-507).

``Discrete`` pools (a learned categorical map, variable.jl:272-328) run on
:vegasmc and :mcmc; :vegas does not serve them yet.  ``FermiK`` pools (a
momentum shell, sampler.jl:109-250) run on :mcmc only, as in the reference;
a ``CompositeVar`` bundles ``Continuous`` and ``Discrete`` pools, and a
``FermiK`` stands alone as its own variable.
"""

from __future__ import annotations

import numpy as np
import torch

from ..common import MAX_ORDER
from ..ops.grid import build_cdf, train_discrete, train_grid

HIST_FLOOR = 1.0e-10  # clearStatistics! floor (variable.jl:565)


def is_variable(v) -> bool:
    return isinstance(v, (Continuous, Discrete, FermiK, CompositeVar))


class _LeafVar:
    """Histogram state shared by the leaf pools."""

    @property
    def nhist(self) -> int:
        return self.histogram.shape[0]

    def clear_statistics(self):
        self.histogram.fill(HIST_FLOOR)

    def add_statistics(self, histogram):
        """Merge a device-produced histogram into the host accumulator.

        Non-finite bins are replaced by the largest finite bin — training
        consumes ratios, so this only caps how fast a bin can attract grid
        nodes.
        """
        h = np.asarray(histogram, dtype=np.float64)
        if not np.all(np.isfinite(h)):
            finite = h[np.isfinite(h)]
            cap = finite.max() if finite.size else 1.0
            h = np.nan_to_num(h, nan=cap, posinf=cap, neginf=0.0)
        self.histogram += h


class Continuous(_LeafVar):
    """Pool of floats in [lower, upper) sampled through a learned Vegas map.

    Mirrors ``Dist.Continuous`` (variable.jl:87-153).  ``Continuous(bounds)``
    with a list of (lower, upper) pairs returns a :class:`CompositeVar` of
    independent pools, mirroring variable.jl:174-187.

    ``ninc`` counts grid INCREMENTS (``linspace(lower, upper, ninc+1)``),
    as in the JAX package; the default is 1024.
    """

    def __new__(cls, lower=None, upper=None, size=MAX_ORDER, **kwargs):
        if lower is None:
            return super().__new__(cls)  # copy/pickle protocol path
        if upper is None or isinstance(lower, (list, tuple)) and not np.isscalar(lower):
            # vectorized ctor: Continuous([(a,b), (c,d), ...])
            bounds = lower
            if upper is not None:
                raise TypeError("pass bounds as first argument only")
            grids = kwargs.pop("grid", [None] * len(bounds))
            nincs = kwargs.pop("ninc", [1024] * len(bounds))
            if np.isscalar(nincs):
                nincs = [nincs] * len(bounds)
            members = [
                Continuous(b[0], b[1], size, ninc=nincs[i], grid=grids[i], **kwargs)
                for i, b in enumerate(bounds)
            ]
            return CompositeVar(
                *members,
                adapt=kwargs.get("adapt", True),
                offset=kwargs.get("offset", 0),
                size=size,
            )
        return super().__new__(cls)

    def __init__(self, lower, upper=None, size=MAX_ORDER, *, offset=0, alpha=2.0,
                 adapt=True, ninc=1024, grid=None):
        if upper is None:
            return  # composite path handled in __new__
        lower, upper = float(lower), float(upper)
        assert upper > lower, f"upper={upper} must exceed lower={lower}"
        assert offset + 1 < size
        self.lower = lower
        self.upper = upper
        self.range = upper - lower
        self.offset = int(offset)
        self.alpha = float(alpha)
        self.adapt = bool(adapt)
        self.size = int(size)
        if grid is None:
            grid = np.linspace(lower, upper, int(ninc) + 1, dtype=np.float64)
        self.grid = np.asarray(grid, dtype=np.float64).copy()
        self.ninc = self.grid.shape[0] - 1
        self.histogram = np.full(self.ninc, HIST_FLOOR, dtype=np.float64)

    def __repr__(self):
        tag = "Adaptive" if self.adapt else "Nonadaptive"
        return f"{tag} Continuous variable in [{self.lower}, {self.upper})."

    # ---- host side --------------------------------------------------
    def train(self):
        """Grid refinement (variable.jl:206-239)."""
        if not self.adapt:
            return
        self.grid = train_grid(self.grid, self.histogram, self.alpha)
        self.clear_statistics()

    def device_params(self, device, dtype=torch.float32):
        """(grid[:-1], inc) tensors of ``dtype`` on ``device``.

        ``inc`` is differenced in float64 and then cast, so adjacent-node
        cancellation never happens in float32 (JAX variable.py:192); at
        float64 both are the host's arrays as they are.
        """
        inc = np.diff(self.grid)
        return (torch.as_tensor(self.grid[:-1], dtype=dtype, device=device),
                torch.as_tensor(inc, dtype=dtype, device=device))

    def fixed_values(self, dtype=np.float32):
        """Deterministic initial values for offset (user-pinned) slots.

        The reference initializes pool data to an interior linspace
        (variable.jl:141); users overwrite offset slots by hand.
        """
        n = self.size
        t = self.lower + self.range * (np.arange(1, n + 1) - 0.5) / n
        return t.astype(dtype)


class Discrete(_LeafVar):
    """Pool of integers in [lower, upper] with a learned categorical map.

    Mirrors ``Dist.Discrete`` (variable.jl:272-328).  ``Discrete(bounds)``
    with a list of (lower, upper) pairs returns a :class:`CompositeVar`
    (variable.jl:342-353); ``Discrete((lower, upper))`` is one pool.
    """

    def __new__(cls, lower=None, upper=None, size=MAX_ORDER, **kwargs):
        if lower is None:
            return super().__new__(cls)  # copy/pickle protocol path
        if isinstance(lower, (list, tuple)) and not np.isscalar(lower):
            if isinstance(lower[0], (list, tuple, np.ndarray)):
                bounds = lower
                dists = kwargs.pop("distribution", [None] * len(bounds))
                members = [
                    Discrete(int(b[0]), int(b[1]), size, distribution=dists[i], **kwargs)
                    for i, b in enumerate(bounds)
                ]
                return CompositeVar(
                    *members,
                    adapt=kwargs.get("adapt", True),
                    offset=kwargs.get("offset", 0),
                    size=size,
                )
        return super().__new__(cls)

    def __init__(self, lower, upper=None, size=MAX_ORDER, *, distribution=None,
                 offset=0, alpha=2.0, adapt=True):
        if isinstance(lower, (list, tuple)) and not np.isscalar(lower):
            if isinstance(lower[0], (list, tuple, np.ndarray)):
                return  # composite path handled in __new__
            lower, upper = int(lower[0]), int(lower[1])  # (l, u) tuple form
        lower, upper = int(lower), int(upper)
        assert upper >= lower
        assert offset + 1 < size
        self.lower = lower
        self.upper = upper
        self.nbin = upper - lower + 1
        self.offset = int(offset)
        self.alpha = float(alpha)
        self.adapt = bool(adapt)
        self.size = int(size)
        self.histogram = np.full(self.nbin, HIST_FLOOR, dtype=np.float64)
        if distribution is None:
            distribution = np.ones(self.nbin, dtype=np.float64)
        else:
            distribution = np.asarray(distribution, dtype=np.float64)
            assert distribution.shape[0] == self.nbin
        self.distribution, self.accumulation = build_cdf(distribution)

    def __repr__(self):
        tag = "Adaptive" if self.adapt else "Nonadaptive"
        return f"{tag} Discrete variable in [{self.lower}, ..., {self.upper}]."

    # ---- host side --------------------------------------------------
    def train(self):
        """Categorical refinement (variable.jl:369-382)."""
        if not self.adapt:
            return
        self.distribution, self.accumulation = train_discrete(self.histogram, self.alpha)
        self.clear_statistics()

    def device_params(self, device, dtype=torch.float32):
        """(cdf [nbin+1], dist [nbin]) tensors of ``dtype`` on ``device``."""
        return (torch.as_tensor(self.accumulation, dtype=dtype, device=device),
                torch.as_tensor(self.distribution, dtype=dtype, device=device))

    def fixed_values(self, dtype=np.int32):
        """Deterministic values for offset (user-pinned) slots."""
        n = self.size
        vals = self.lower + (np.arange(n) % self.nbin)
        return vals.astype(dtype)


class FermiK(_LeafVar):
    """Pool of D-dim momenta sampled near the Fermi surface |K| in (kF-dk, kF+dk).

    Mirrors ``Dist.FermiK`` (variable.jl:1-35, sampler.jl:109-250) and the
    JAX package's ``FermiK``.  Not adaptive (one floor histogram bin, no
    training); served by the :mcmc solver only, as in the reference
    (test/bubble_FermiK.jl:2).  A slot holds ``dim`` float32 components, so
    the integrand sees a leaf as ``[nslots, dim, *batch]``.  The draw,
    density and shift are ``ops/fermik.py``.
    """

    adapt = False

    def __init__(self, dim, kF, delta_k, maxK, size=MAX_ORDER, *, offset=0):
        assert dim in (2, 3), "FermiK supports D=2 or 3"
        assert offset + 1 < size
        self.dim = int(dim)
        self.value_width = self.dim
        self.kF = float(kF)
        self.delta_k = float(delta_k)
        self.maxK = float(maxK)
        self.offset = int(offset)
        self.size = int(size)
        self.alpha = 0.0
        self.histogram = np.full(1, HIST_FLOOR, dtype=np.float64)  # no adaptation

    def __repr__(self):
        return f"{self.dim}D FermiK variable in [0, {self.maxK})."

    # ---- host side --------------------------------------------------
    def train(self):
        return

    def device_params(self, device, dtype=torch.float32):
        """(kF, delta_k) float64 scalars on ``device``, whatever ``dtype``
        (FermiK pools run on :mcmc, at float32 only); the solver derives its
        float32 constants from them (ops/fermik.py:constants)."""
        return (torch.tensor(self.kF, dtype=torch.float64, device=device),
                torch.tensor(self.delta_k, dtype=torch.float64, device=device))

    def fixed_values(self, dtype=np.float32):
        """Values of offset (user-pinned) slots: ``[size, dim]`` at kF/sqrt(dim)."""
        return np.full((self.size, self.dim), self.kF / np.sqrt(self.dim), dtype)


class CompositeVar:
    """A joint bundle of leaf pools drawn together.

    Mirrors ``Dist.CompositeVar`` (variable.jl:397-507): the slot probability
    is the product of the members' slot probabilities, and adaptive training
    recurses into the members.
    """

    def __init__(self, *members, adapt=True, offset=0, size=MAX_ORDER):
        assert all(isinstance(v, (Continuous, Discrete)) for v in members), \
            "CompositeVar members must be Continuous or Discrete pools in the PyTorch port"
        for v in members:
            v.adapt = adapt
            v.offset = offset
        self.vars = tuple(members)
        self.adapt = bool(adapt)
        self.offset = int(offset)
        self.size = int(size)

    def __repr__(self):
        tag = "Adaptive" if self.adapt else "Nonadaptive"
        return f"{tag} CompositeVar with {len(self.vars)} components."

    def __len__(self):
        return len(self.vars)

    def __getitem__(self, i):
        return self.vars[i]

    def __iter__(self):
        return iter(self.vars)

    # host side
    def train(self):
        for v in self.vars:
            v.train()

    def clear_statistics(self):
        for v in self.vars:
            v.clear_statistics()


def leaves_of(var) -> tuple:
    """Flatten a (possibly composite) variable into its leaf pools."""
    if isinstance(var, CompositeVar):
        return var.vars
    return (var,)
