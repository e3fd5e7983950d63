"""The :vegasmc solver — hybrid Vegas + Markov chain over W walkers.

Counterpart of ``mcintegration_tpu/solvers/vegasmc.py`` on the law of its
XLA route (lines 250-450); reference semantics src/vegas_mc/montecarlo.jl:
112-241 and updates.jl:45-106.  One walker samples the joint density

    p(x) = r_norm * pad_norm(x) + sum_i |w_i(x)| * r_i * pad_i(x)

with the single update changeVariable: redraw one random slot of one random
variable group through the learned maps, re-evaluate all integrand weights
and Metropolis-accept with R = prop * p_new / p_old.  Measurements after a
warmup accumulate ``obs[i] += w_i * pad_i / p`` and ``norm += pad_norm / p``;
visited tallies drive reweighting; the per-slot histogram weight is
``(|w_i|^2 / prob_i) * pad_i / p``.  A custom ``measure(x, relw, c)``
takes the place of the ``obs`` sums: it sees the state after the move and
``relw [N, *batch]``, ``relw[i] = w_i * pad_i / p``, and its output, shaped
like the observable pytree, is added per walker.  With ``type=complex`` the
weights and ``relw`` are complex64, ``|w_i|`` is ``sqrt(re^2 + im^2)``, and
the real and imaginary parts of every observable are summed as independent
channels (``chain_accept_complex``).

One step is two kernel launches with the integrand between them:
``chain_propose`` → the integrand as torch ops on the proposed state →
``chain_accept`` (ops/chain_kernels.py); with a custom measure, a measured
step adds the measure as torch ops on the state after the move →
``chain_measure``.  An iteration adds one launch of ``chain_propose`` and
``chain_accept`` for the walkers' first draw.  The walkers are grouped into
``block`` lanes of ``W / block`` for the reference's block error bars; each
walker keeps float64 accumulators, summed per block in a fixed order at the
end.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..models.variable import Discrete
from ..ops import chain_kernels
from ..ops.chain_kernels import ChainLayout, ChainState
from ..ops._build import tree_sum
from .engine import Spec, block_sums, obs_components, obs_tree, refuse_fermik


def choose_walkers(neval: int, block: int, nwalkers, min_steps: int,
                   max_walkers: int = 65536):
    """Pick (W, nsteps) with W a multiple of block and W*nsteps ≈ neval."""
    if nwalkers is None:
        w = max(block, min(int(neval) // max(min_steps, 1), max_walkers))
    else:
        w = max(int(nwalkers), block)
    w = (w // block) * block
    nsteps = max(int(neval) // w, 8)
    return w, nsteps


def check_supported(spec: Spec):
    """The specs the chain kernels serve; anything else raises."""
    refuse_fermik(spec, ":vegasmc")
    if not any(li.ndraw > 0 for li in spec.leaves):
        raise ValueError("no MC-owned slots to draw (every dof is 0)")


class VegasMCIteration:
    """One :vegasmc iteration over ``block`` blocks on ``spec.device``."""

    def __init__(self, spec: Spec, integrand: Callable, *, measure=None, obs_proto=None,
                 inplace=False, measurefreq=1, block=16, nevalperblock=10000,
                 nwalkers=None, min_steps_per_walker=256, warmup=0.01, nranks=1):
        check_supported(spec)
        if not 0.0 <= warmup < 1.0:
            raise ValueError(f"warmup fraction must be in [0,1), got {warmup}")
        if int(measurefreq) < 1:
            raise ValueError(f"measurefreq must be >= 1, got {measurefreq}")
        self.spec = spec
        self.block = block
        self.measurefreq = int(measurefreq)
        # ``block`` is this rank's share of the ``nranks`` ranks' blocks: the
        # walkers are chosen for them all, so a block's chain is the one-rank
        # run's
        R = int(nranks)
        W, self.nsteps = choose_walkers(nevalperblock * block * R, block * R, nwalkers,
                                        min_steps_per_walker)
        W //= R
        self.nwalkers = W
        self.neval = W * self.nsteps
        # burn-in discard: measure only after `warmup` of each chain
        # (reference: fixed 1%, montecarlo.jl:213)
        self.warmup = int(self.nsteps * warmup)
        self.obs_proto = None if measure is None else obs_proto
        self.layout = ChainLayout.build(spec, block, W // block,
                                        obs_components(spec, self.obs_proto), measure is not None)

        # ---- the integrand and the measure: batched, or per sample under vmap ----
        eval_b = spec.make_eval_batched(integrand, inplace)
        eval_v = spec.make_eval_vmapped(integrand, inplace)
        ok, why = spec.probe_batched(eval_b, eval_v)
        self.evaluate = eval_b if ok else eval_v
        self.measure, why_m = (None, "") if measure is None else \
            spec.pick_measure(measure, obs_proto)
        self.backend_reason = "; ".join(r for r in (why, why_m) if r)
        self.backend = "cuda" if spec.device.type == "cuda" else "torch"

    def reset_state(self):
        """Nothing carries over from one run to the next: a cached iteration
        starts as a fresh one (the JAX package's no-op)."""

    # ------------------------------------------------------------------
    def leaf_values(self, val: torch.Tensor):
        """Per spec leaf, its ``[ndraw, W]`` values from a slot field
        (int32 for a Discrete leaf)."""
        out = []
        for li, rows in zip(self.spec.leaves, self.layout.leaf_rows(val)):
            out.append(rows.view(torch.int32) if isinstance(li.leaf, Discrete) else rows)
        return out

    def weights(self, st: ChainState) -> torch.Tensor:
        """The integrand on the proposed state: ``[N, W]`` float32, or
        complex64 with ``type=complex``."""
        return self.evaluate(self.leaf_values(st.prp_val)).contiguous()

    def seeds(self, kd: np.ndarray) -> torch.Tensor:
        """Per-block seeds ``kd [block, 2]`` uint32 as the int32 bit
        patterns the chain kernels take, on the device."""
        return torch.as_tensor(np.asarray(kd, np.uint32).view(np.int32),
                               device=self.spec.device)

    def start(self, params, kd: torch.Tensor):
        """``(tab, rw, state)``: this iteration's tables and the walkers
        after their first draw (init launches of both kernels)."""
        lay = self.layout
        tab = lay.tables(params)
        rw = params["reweight"].to(torch.float32).contiguous()
        st = ChainState.zeros(lay)
        chain_kernels.chain_propose(lay, tab, kd, 0, st, init=True)
        chain_kernels.chain_accept(lay, rw, kd, 0, st, self.weights(st), init=True)
        return tab, rw, st

    def step(self, tab, rw, kd: torch.Tensor, st: ChainState, t: int):
        """Chain step ``t`` of every walker, in place on ``st``."""
        lay = self.layout
        chain_kernels.chain_propose(lay, tab, kd, t, st)
        measured = t % self.measurefreq == 0 and t >= self.warmup
        chain_kernels.chain_accept(lay, rw, kd, t, st, self.weights(st),
                                   measure=measured)
        if measured and self.measure is not None:
            # the state after the move: cur and prp are equal again
            m = self.measure(self.leaf_values(st.cur_val), st.relw)
            chain_kernels.chain_measure(lay, m.contiguous(), st)

    def run(self, params, kd: np.ndarray):
        """Execute one iteration with per-block seeds ``kd [block, 2]``
        uint32; returns host-side numpy statistics."""
        spec, lay = self.spec, self.layout
        kd = self.seeds(kd)
        tab, rw, st = self.start(params, kd)
        for t in range(self.nsteps):
            self.step(tab, rw, kd, st, t)

        nd, nvar, B = spec.N + 1, spec.nvar, self.block
        obs_b = obs_tree(block_sums(st.obs, B), spec, self.obs_proto)
        norm_b = tree_sum(st.nrm.view(B, lay.wb), -1).cpu().numpy()
        visited = st.vis.sum(dim=-1).cpu().numpy()
        pc = st.pc.sum(dim=-1).cpu().numpy().astype(np.float64)
        ac = st.ac.sum(dim=-1).cpu().numpy().astype(np.float64)
        hist = st.hist.cpu().numpy()
        hists = []
        for lidx, li in enumerate(spec.leaves):
            off = (int(lay.leaf[lay.dleaf.index(lidx), 6])
                   if lidx in lay.dleaf else -1)
            hists.append(hist[off:off + li.nhist].copy() if off >= 0
                         else np.zeros(li.nhist, np.float64))
        propose = np.zeros((3, nd, max(nd, nvar)))
        accept = np.zeros((3, nd, max(nd, nvar)))
        propose[1, 0, :nvar] = pc
        accept[1, 0, :nvar] = ac
        return {
            "obs_blocks": obs_b,       # [block, N] (complex128), or the observable pytree
            "norm_blocks": norm_b,     # [block]
            "visited": visited,        # [nd]
            "hists": hists,            # per-leaf histogram sums
            "propose": propose,
            "accept": accept,
            "neval": self.neval,
        }
