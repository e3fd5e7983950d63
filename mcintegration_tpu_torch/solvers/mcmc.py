"""The :mcmc solver — Metropolis over the extended (integrand index, vars) space.

Counterpart of ``mcintegration_tpu/solvers/mcmc.py`` on the law of its
kernel route, ``ops/pallas_mcmc.py:build_mcmc_run_all`` (K3); reference
semantics src/mcmc/montecarlo.jl:72-184 and updates.jl.  A walker's state
is (curr, its variables, weight, probability = |weight|*reweight[curr]);
changeVariable, swapVariable and changeIntegrand moves run on K3's
scheduled single-sector law (``ops/mcmc_kernels.py``): each (block, step)
draws one active sector, and every walker of the block evaluates that
sector's integrand once, so a step costs one evaluation per walker
whatever the number of integrands.  Measurements past the burn-in
accumulate ``sign(weight)/reweight[curr]`` into ``obs[curr]`` (or a custom
``measure(idx, x, relw, c)`` with ``relw = weight/probability``) and
``1/reweight[norm]`` into the normalization in its sector; histograms count
the used slots of adaptive pools.  With ``type=complex`` the weights and
``relw`` are complex64, ``probability = |weight|*reweight[curr]`` stays
real, and the default measure adds the phase ``weight/|weight|`` in place of
the sign (``mcmc_accept_complex``).

One step is ``mcmc_propose`` → the scheduled sectors' integrands as torch
ops on the proposed state → ``mcmc_accept``; on a measured step with a
custom measure, the measure of each sector as torch ops → one
``mcmc_measure`` over all of them.
A block's walkers are contiguous (``w = b*wb + j``); a step calls each
sector that some block drew once, on the walkers of those blocks (a gather
of their rows and a scatter of the weights, unless every block drew it).
An iteration starts every walker in integrand 0 with one draw and ten
masked retries (``NRETRY``), each one launch of both kernels.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .. import tracing
from ..models.variable import Continuous, Discrete, FermiK
from ..ops import mcmc_kernels
from ..ops.mcmc_kernels import NRETRY, McmcLayout, McmcState
from ..ops._build import tree_sum
from ..ops.rng import schedule_np
from . import vegasmc
from .engine import Spec, block_sums, obs_components, obs_tree


def choose_walkers(neval: int, block: int, nwalkers, min_steps: int, n: int, nvar: int):
    """(W, nsteps) for the scheduled law (``solvers/mcmc.py:154-156`` of the
    JAX package): a walker moves on about (C+1)/(N*C) of the steps
    (C = 2*nvar + 1), so it needs ``min_steps*N*C/(C+1)`` steps (at least
    64) for ``min_steps`` moves; then the :vegasmc rule (``nwalkers``
    overrides W; W is a multiple of ``block``, at most 65536)."""
    C = 2 * nvar + 1
    steps_min = max(int(min_steps) * n * C // (C + 1), 64)
    return vegasmc.choose_walkers(neval, block, nwalkers, steps_min)


def check_supported(spec: Spec):
    """The specs the :mcmc kernels serve; anything else raises."""
    if not any(li.ndraw > 0 for li in spec.leaves):
        raise ValueError("no MC-owned slots to draw (every dof is 0)")
    for li in spec.leaves:
        if not isinstance(li.leaf, (Continuous, Discrete, FermiK)):
            raise NotImplementedError(f"{type(li.leaf).__name__} pools are not served")
    for i, nbrs in enumerate(spec.cfg.neighbor):
        if i in nbrs:
            raise ValueError(f"integrand {i} neighbours itself: the neighbor graph "
                             "must have no self-loops")


class MCMCIteration:
    """One :mcmc iteration over ``block`` blocks on ``spec.device``."""

    guard = "torch"      # where the weights' non-finite guard runs (``mct.call``)

    def __init__(self, spec: Spec, integrand: Callable, *, measure=None, obs_proto=None,
                 measurefreq=1, block=16, nevalperblock=10000, nwalkers=None,
                 min_steps_per_walker=256, thermal_ratio=0.1, nranks=1):
        check_supported(spec)
        if int(measurefreq) < 1:
            raise ValueError(f"measurefreq must be >= 1, got {measurefreq}")
        if not thermal_ratio >= 0.0:
            raise ValueError(f"thermal_ratio must be >= 0, got {thermal_ratio}")
        self.spec = spec
        self.block = block
        self.measurefreq = int(measurefreq)
        # ``block`` is this rank's share of the ``nranks`` ranks' blocks: the
        # walkers are chosen for them all, so a block's chain is the one-rank
        # run's
        R = int(nranks)
        W, self.nsteps = choose_walkers(nevalperblock * block * R, block * R, nwalkers,
                                        min_steps_per_walker, spec.N, spec.nvar)
        W //= R
        self.nwalkers = W
        self.nburnin = int(np.floor(self.nsteps * thermal_ratio))
        self.ntot = self.nsteps + self.nburnin
        # every step evaluates every walker once (pallas_mcmc.py:1291)
        self.neval = W * self.ntot
        self.obs_proto = None if measure is None else obs_proto
        self.layout = McmcLayout.build(spec, block, W // block,
                                       obs_components(spec, self.obs_proto), measure is not None)

        # ---- the integrand and the measure: batched, or under vmap ----
        reasons = []
        eval_b = spec.make_eval_batched_idx(integrand)
        eval_v = spec.make_eval_vmapped_idx(integrand)
        ok, why = spec.probe_batched(_stacked(eval_b), _stacked(eval_v))
        self.evaluate = eval_b if ok else eval_v
        if why:
            reasons.append(f"integrand: {why}")
        self.measure = None
        if measure is not None:
            m_b = spec.make_measure_batched_idx(measure, obs_proto)
            m_v = spec.make_measure_vmapped_idx(measure, obs_proto)
            ok, why = spec.probe_batched(_stacked(m_b), _stacked(m_v), spec.probe_relw((4, 2)))
            self.measure = m_b if ok else m_v
            if why:
                reasons.append(f"measure: {why}")
        self.backend_reason = "; ".join(reasons)
        self.backend = "cuda" if spec.device.type == "cuda" else "torch"

    def reset_state(self):
        """Nothing carries over from one run to the next: a cached iteration
        starts as a fresh one (the JAX package's no-op)."""

    # ------------------------------------------------------------------
    def seeds(self, kd: np.ndarray) -> torch.Tensor:
        """Per-block seeds ``kd [block, 2]`` uint32 as the int32 bit
        patterns the kernels take, on the device."""
        return torch.as_tensor(np.asarray(kd, np.uint32).view(np.int32),
                               device=self.spec.device)

    def schedule(self, kd: np.ndarray):
        """``(sched, groups)``: the iteration's schedule ``[ntot, B]`` on the
        device, and per step the sectors it calls, as ``(i, blocks)`` pairs
        with ``blocks`` a device index tensor, or None for every block."""
        lay = self.layout
        sched = schedule_np(kd, self.ntot, self.spec.N, lay.C, lay.any_swap)
        jt = sched >> 1
        if self.spec.N == 1:
            groups = [[(0, None)]] * self.ntot
        else:
            order = np.argsort(jt, axis=1, kind="stable")
            order_t = torch.as_tensor(order, dtype=torch.int64, device=self.spec.device)
            counts = np.stack([np.bincount(r, minlength=self.spec.N) for r in jt])
            starts = np.cumsum(counts, axis=1) - counts
            groups = [[(i, None if n == self.block else order_t[t, s:s + n])
                       for i, (n, s) in enumerate(zip(counts[t], starts[t])) if n]
                      for t in range(self.ntot)]
        return torch.as_tensor(sched, device=self.spec.device), groups

    def weights(self, st: McmcState, group) -> torch.Tensor:
        """``nw [W]``: each walker's weight under its block's sector, on the
        proposed state (complex64 with ``type=complex``)."""
        lay = self.layout
        if len(group) == 1 and group[0][1] is None:
            return self.evaluate[group[0][0]](lay.leaf_values(st.prp_val)).contiguous()
        nw = torch.empty(lay.W, dtype=self.spec.wdtype, device=st.prp_val.device)
        rows = st.prp_val.view(lay.V, self.block, lay.wb)
        for i, blocks in group:
            vals = rows.index_select(1, blocks).reshape(lay.V, -1)
            w = self.evaluate[i](lay.leaf_values(vals))
            nw.view(self.block, lay.wb).index_copy_(0, blocks, w.view(-1, lay.wb))
        return nw

    def start(self, params, kd: torch.Tensor, sched: torch.Tensor):
        """``(tab, rw, state)``: this iteration's tables and the walkers in
        integrand 0 after their first draw and ``NRETRY`` masked retries."""
        lay = self.layout
        tab = lay.tables(params)
        rw = params["reweight"].to(torch.float32).contiguous()
        st = McmcState.zeros(lay)
        for r in range(NRETRY + 1):
            mcmc_kernels.mcmc_propose(lay, tab, kd, sched, r, st, init=True)
            nw = self.evaluate[0](lay.leaf_values(st.prp_val)).contiguous()
            mcmc_kernels.mcmc_accept(lay, tab, rw, kd, sched, r, st, nw, init=True)
        return tab, rw, st

    def measured(self, t: int) -> bool:
        return t >= self.nburnin and (t - self.nburnin) % self.measurefreq == 0

    def step(self, tab, rw, kd, sched, group, st: McmcState, t: int):
        """Chain step ``t`` of every walker, in place on ``st``; ``group``
        is step ``t``'s entry of :meth:`schedule`."""
        lay = self.layout
        mcmc_kernels.mcmc_propose(lay, tab, kd, sched, t, st)
        measured = self.measured(t)
        mcmc_kernels.mcmc_accept(lay, tab, rw, kd, sched, t, st, self.weights(st, group),
                                 measure=measured)
        if measured and self.measure is not None:
            vals = lay.leaf_values(st.cur_val)
            mcmc_kernels.mcmc_measure(lay, [m(vals, st.relw).contiguous() for m in self.measure],
                                      st)

    def run(self, params, kd: np.ndarray):
        """Execute one iteration with per-block seeds ``kd [block, 2]``
        uint32; returns host-side numpy statistics in the JAX package's
        layout (``solvers/mcmc.py:628-686``)."""
        spec, lay, B = self.spec, self.layout, self.block
        with tracing.span("mct.issue"):
            sched, groups = self.schedule(kd)
            kd = self.seeds(kd)
            tab, rw, st = self.start(params, kd, sched)
            for t in range(self.ntot):
                self.step(tab, rw, kd, sched, groups[t], st, t)
        with tracing.span("mct.wait"):
            obs_b = block_sums(st.obs, B)

        with tracing.span("mct.collect"):
            obs_b = obs_tree(obs_b, spec, self.obs_proto)
            hist = st.hist.cpu().numpy()
            hists = []
            for lidx, li in enumerate(spec.leaves):
                off = (int(lay.leaf[lay.dleaf.index(lidx), 8]) if lidx in lay.dleaf else -1)
                hists.append(hist[off:off + li.nhist].copy() if off >= 0
                             else np.zeros(li.nhist, np.float64))
            tally = st.tally.cpu().numpy().astype(np.float64)
            return {
                "obs_blocks": obs_b,       # [block, N] (complex128), or the observable pytree
                "norm_blocks": tree_sum(st.nrm.view(B, lay.wb), -1).cpu().numpy(),
                "visited": st.vis.cpu().numpy().astype(np.float64),
                "hists": hists,
                "propose": tally[0],       # [3, nd, max(nd, nvar)]: CI, CV, swap
                "accept": tally[1],
                "neval": self.neval,
            }


def _stacked(fns):
    """One function of the probe: the per-sector functions' outputs stacked."""
    return lambda *args: torch.stack([f(*args) for f in fns])
