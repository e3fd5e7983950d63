"""Configuration: the static description + trained state of an MC integration.

Counterpart of ``mcintegration_tpu/configuration.py`` and of the reference's
``Configuration{NI,V,P,O,T}`` (src/configuration.jl:37-236).  Differences by
design:

- no mutable walker state lives here: walkers are dense device batches owned
  by the solvers; the Configuration holds the *specs* (var tuple, dof,
  neighbor graph) and the *trained state* (grids/CDFs inside the var objects,
  reweight vector) plus host-side run statistics (visited / propose / accept
  tallies, filled from device reductions once per iteration);
- the sampler's RNG is a counter hash keyed by per-block seeds derived from
  ``seed`` with numpy (ops/rng.py), replacing the per-config MersenneTwister
  (configuration.jl:39-40);
- the neighbor graph is validated connected with a plain BFS instead of
  Graphs.jl (configuration.jl:201-227).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np

from .models.variable import CompositeVar, Continuous, Discrete, is_variable, leaves_of
from .utils.color import green, yellow


def _parse_dof(dof, nvar: int):
    """Normalize dof to a list of per-integrand lists (configuration.jl:133-151)."""
    if isinstance(dof, (int, np.integer)):
        assert nvar == 1, "Only one type of variable is allowed when dof is an integer"
        return [[int(dof)]]
    dof = list(dof)
    if len(dof) == 0:
        raise ValueError("dof must not be empty")
    first = dof[0]
    if isinstance(first, (int, np.integer)):
        # vector of ints: one dof per integrand with a single variable type
        return [[int(d)] for d in dof]
    out = []
    for d in dof:
        d = [int(x) for x in d]
        assert len(d) == nvar, (
            f"Each element of dof should have the same dimension as var "
            f"({nvar}); got {d}"
        )
        out.append(d)
    return out


def _maxdof(dof_rows):
    return [max(row[v] for row in dof_rows) for v in range(len(dof_rows[0]))]


def _neighbor(neighbor, nd: int):
    """Default chain topology or user pairs with connectivity check.

    Reference: configuration.jl:201-227.  All indices are 0-based here; the
    normalization integrand is index nd-1.
    """
    if neighbor is None:
        adj = [[d - 1, d + 1] for d in range(nd)]
        adj[0] = [1] if nd == 2 else [nd - 1, 1]
        adj[-1] = [0]
        if nd >= 3:
            adj[-2] = [nd - 3]
        return adj
    # user-provided edge list of (i, j) pairs (0-based)
    adj = [[] for _ in range(nd)]
    for (a, b) in neighbor:
        a, b = int(a), int(b)
        assert 0 <= a < nd and 0 <= b < nd, f"edge ({a},{b}) out of range for {nd} integrands"
        if b not in adj[a]:
            adj[a].append(b)
        if a not in adj[b]:
            adj[b].append(a)
    # BFS connectivity check
    seen = {0}
    frontier = [0]
    while frontier:
        nxt = []
        for u in frontier:
            for v in adj[u]:
                if v not in seen:
                    seen.add(v)
                    nxt.append(v)
        frontier = nxt
    assert len(seen) == nd, "The neighbor graph is not connected."
    return adj


class Configuration:
    """Holds variable pools, dof table, neighbor graph and run statistics.

    Keyword arguments mirror the reference constructor
    (configuration.jl:105-194): ``var``, ``dof``, ``type``, ``obs``,
    ``reweight``, ``seed``, ``neighbor``, ``userdata``.
    """

    def __init__(self, *, var=None, dof=None, type=float, obs=None,
                 reweight=None, seed: Optional[int] = None, neighbor=None,
                 userdata=None, **unused_kwargs):
        if var is None:
            var = (Continuous(0.0, 1.0),)
        if is_variable(var):
            var = (var,)
        else:
            var = tuple(var)
            assert all(is_variable(v) for v in var), \
                "All elements in var must be variables"
        self.var = var
        nvar = len(var)

        if dof is None:
            dof = [[1] * nvar]
        dof_rows = _parse_dof(dof, nvar)
        self.N = len(dof_rows)  # number of user integrands
        dof_rows = dof_rows + [[0] * nvar]  # normalization row (configuration.jl:153)
        self.dof = dof_rows
        self.maxdof = _maxdof(dof_rows)
        nd = self.N + 1
        self.norm = nd - 1  # 0-based index of the normalization integrand

        for v, mx in zip(self.var, self.maxdof):
            need = mx + getattr(v, "offset", 0) + 2
            if v.size < need:
                v.size = need  # pools auto-grow (configuration.jl:155-160)

        self.type = complex if type in (complex, np.complex64, np.complex128) else float

        if obs is None:
            obs = [0.0 if self.type is float else 0.0 + 0.0j] * self.N
        obs = list(obs)
        assert len(obs) == self.N, \
            "The number of observables should equal the number of integrands"
        self.observable = obs

        if reweight is None:
            reweight = np.ones(nd, dtype=np.float64)
        reweight = np.asarray(reweight, dtype=np.float64).copy()
        assert reweight.shape[0] == nd, (
            "Wrong reweight vector size! The last element is for the "
            "normalization integrand."
        )
        assert np.all(reweight > 0), "All reweight factors should be positive."
        self.reweight = reweight / reweight.sum()

        self.neighbor = _neighbor(neighbor, nd)
        self.userdata = userdata

        if seed is None:
            seed = int(np.random.SeedSequence().generate_state(1)[0] % 1000000) + 1
        self.seed = int(seed)

        # run statistics (host side), same shapes as configuration.jl:182-187
        self.neval = 0
        self.normalization = 1.0e-10
        self.visited = np.zeros(nd, dtype=np.float64) + 1.0e-8
        nmax = max(nd, nvar)
        self.propose = np.zeros((3, nd, nmax), dtype=np.float64) + 1.0e-8
        self.accept = np.zeros((3, nd, nmax), dtype=np.float64) + 1.0e-10

    # ------------------------------------------------------------------
    @property
    def nvar(self) -> int:
        return len(self.var)

    def var_leaves(self):
        """(group_index, leaf) pairs: composites flattened, slots shared."""
        out = []
        for gi, v in enumerate(self.var):
            for leaf in leaves_of(v):
                out.append((gi, leaf))
        return out

    def nslots(self, vi: int) -> int:
        v = self.var[vi]
        return getattr(v, "offset", 0) + self.maxdof[vi]

    def clear_statistics(self):
        """Reference clearStatistics! (configuration.jl:238-250)."""
        for i in range(self.N):
            self.observable[i] = _zero_like(self.observable[i])
        self.neval = 0
        self.normalization = 1.0e-10
        self.visited.fill(1.0e-8)
        self.propose.fill(1.0e-8)
        self.accept.fill(1.0e-10)
        for _, leaf in self.var_leaves():
            leaf.clear_statistics()

    def reset_seed(self, seed: int):
        self.seed = int(seed)

    # ------------------------------------------------------------------
    def report(self, total_neval=None):
        """Pretty-print proposal/acceptance tables (configuration.jl:345-465)."""
        nd = self.N + 1
        neval = max(self.neval, 1)
        bar = "-" * 85
        lines = ["=" * 28 + "  Configuration  " + "=" * 40, bar]
        lines.append(yellow(
            f"Integral num = {self.N}, dof = {self.dof[:-1]}, with variables:"))
        for vi, v in enumerate(self.var):
            lines.append(f"{vi}. {v!r}")
        lines.append(bar)

        def _row(label, p, a):
            ratio = a / p if p > 0 else 0.0
            return f"{label:<22s} {p / neval * 100:11.6f}% {a / neval * 100:11.6f}% {ratio:12.6f}"

        lines.append(yellow(f"{'ChangeIntegrand':<22s} {'Proposed':>12s} {'Accepted':>12s} {'Ratio':>12s}"))
        for n in self.neighbor[self.norm]:
            lines.append(_row(f"Norm -> {n}:", self.propose[0, self.norm, n], self.accept[0, self.norm, n]))
        for idx in range(nd - 1):
            for n in self.neighbor[idx]:
                tgt = "Norm" if n == self.norm else f"{n}"
                lines.append(_row(f"  {idx} -> {tgt}:", self.propose[0, idx, n], self.accept[0, idx, n]))
        lines.append(bar)
        lines.append(yellow(f"{'ChangeVariable':<22s} {'Proposed':>12s} {'Accepted':>12s} {'Ratio':>12s}"))
        for idx in range(nd - 1):
            for vi, v in enumerate(self.var):
                lines.append(_row(f"  {idx} / {_typestr(v)}:", self.propose[1, idx, vi], self.accept[1, idx, vi]))
        lines.append(bar)
        lines.append(yellow(f"{'SwapVariable':<22s} {'Proposed':>12s} {'Accepted':>12s} {'Ratio':>12s}"))
        for idx in range(nd - 1):
            for vi, v in enumerate(self.var):
                lines.append(_row(f"  {idx} / {_typestr(v)}:", self.propose[2, idx, vi], self.accept[2, idx, vi]))
        lines.append(bar)
        lines.append(yellow("Integrand            Visited      ReWeight"))
        lines.append(f"  Norm   :     {self.visited[-1]:12.0f} {self.reweight[-1]:12.6f}")
        for idx in range(nd - 1):
            lines.append(f"  Order{idx:2d}:     {self.visited[idx]:12.0f} {self.reweight[idx]:12.6f}")
        lines.append(bar)
        lines.append(yellow(f"Integrand evaluation = {self.neval}"))
        text = "\n".join(lines)
        print(text)
        return None

    def __repr__(self):
        return (
            f"Configuration for {self.N} integrands involves {self.nvar} types "
            f"of variables.\nNumber of variables for each integrand: "
            f"{self.dof[:-1]}."
        )


def _typestr(v):
    if isinstance(v, Continuous):
        return "Continuous"
    if isinstance(v, Discrete):
        return "Discrete"
    if isinstance(v, CompositeVar):
        return "Composite"
    return type(v).__name__


def _zero_like(x):
    if isinstance(x, (int, float)):
        return 0.0
    if isinstance(x, complex):
        return 0.0 + 0.0j
    if isinstance(x, np.ndarray):
        return np.zeros_like(x)
    if isinstance(x, (list, tuple)):
        t = type(x)
        return t(_zero_like(e) for e in x)
    return x * 0
