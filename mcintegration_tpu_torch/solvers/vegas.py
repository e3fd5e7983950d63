"""The :vegas solver — stratified Vegas importance sampling, batched.

Counterpart of ``mcintegration_tpu/solvers/vegas.py`` on its fused-kernel
route (lines 56-199, 367-418).  Reference semantics
(src/vegas/montecarlo.jl:72-191): every sample redraws ALL ``maxdof`` slots
through the learned maps, computes jac = prod 1/prob, evaluates the full
weight vector once, accumulates ``obs[i] += w[i] * padding_probability[i] *
jac`` and per-slot histogram weight ``(|w[i]|*jac)^2``.

Stratification: a chunk of ``nb * m_tile`` samples gives each of the ``nb``
map increments exactly ``m_tile`` samples, through a random affine strata
permutation ``(a*p + s) mod nb`` per (slot, chunk); ``a`` comes from a
host-drawn table of multipliers coprime to ``nb``.  The chunk shaping
(plans, ``a_tab``, ``pick_m_tile``, the overshoot loop) is the reference's,
so the port and the JAX kernel cut an iteration into the same chunks.

One iteration is a few launches, each over all blocks and a range of
chunks holding about ``SAMPLES_PER_LAUNCH`` samples: ``vegas_sample`` →
the integrand as torch ops → ``vegas_reduce`` (ops/vegas_kernels.py).  The
per-(block, chunk) float64 partial sums are then added in a fixed order.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from ..models.variable import Continuous
from ..ops import vegas_kernels
from .engine import Spec, refuse_fermik

N_MULT = vegas_kernels.N_MULT
SAMPLES_PER_LAUNCH = 2 ** 26   # per slot; bounds x at 4 bytes * slots * this


def level_size(nb: int) -> int:
    """Side of the TPU kernel's padded strata square (ops/lookup.py); kept
    because ``pick_m_tile`` sizes chunks with it."""
    l = int(math.ceil(math.sqrt(max(nb, 1))))
    return max(8, -(-l // 8) * 8)


def pick_m_tile(spec: Spec, nb: int, m_avail: int) -> int:
    """Samples per stratum per chunk (pallas_vegas.py:277-287, unchanged)."""
    np_pad = level_size(nb) ** 2
    nslots = sum(li.ndraw for li in spec.leaves)
    live_per_m = (nslots + spec.N + 6) * np_pad * 4
    m = 128
    while m * 2 <= min(2048, m_avail) and live_per_m * m * 2 <= 44 * 2 ** 20:
        m *= 2
    return min(m, max(1, m_avail)) if m_avail < 128 else m


def _coprime_multipliers(rng: np.random.Generator, nb: int, count: int):
    """Random multipliers coprime to nb (so b -> (a*b+s) mod nb permutes)."""
    out = []
    while len(out) < count:
        a = int(rng.integers(1, max(nb, 2)))
        if math.gcd(a, nb) == 1:
            out.append(a)
    return out


def check_supported(spec: Spec):
    """The specs the kernels serve; anything else raises (pallas_vegas.py:
    eligible, lines 290-340).  The strata bound is checked by
    ``vegas_kernels.vegas_sample``."""
    refuse_fermik(spec, ":vegas")
    drawn = [li for li in spec.leaves if li.ndraw > 0]
    if not drawn:
        raise ValueError("no MC-owned slots to draw (every dof is 0)")
    if any(not isinstance(li.leaf, Continuous) for li in drawn):
        raise NotImplementedError(
            "only Continuous pools are ported (ROADMAP.md, queue 1, item 14)")
    nbs = {li.leaf.ninc for li in drawn}
    if len(nbs) != 1:
        raise NotImplementedError(
            "drawn pools with different ninc are not ported (ROADMAP.md, "
            "queue 1, item 14)")
    return nbs.pop()


class VegasIteration:
    """One :vegas iteration over ``block`` blocks on ``spec.device``."""

    def __init__(self, spec: Spec, integrand: Callable, *, inplace=False,
                 block=16, nevalperblock=10000):
        self.spec = spec
        self.block = block
        dev = spec.device
        nb = check_supported(spec)
        self.nb = nb

        # ---- chunk shaping (solvers/vegas.py:176-191) ----
        m_tile = pick_m_tile(spec, nb, max(1, nevalperblock // nb))

        def _overshoot(m):
            ch = nb * m
            return ch * max(1, -(-nevalperblock // ch))
        while m_tile > 128 and _overshoot(m_tile) > 1.1 * nevalperblock:
            m_tile //= 2
        self.m_tile = m_tile
        self.chunk = nb * m_tile
        self.nchunks = max(1, -(-nevalperblock // self.chunk))
        self.nevalperblock = self.chunk * self.nchunks
        self.chunks_per_launch = max(1, min(
            self.nchunks, SAMPLES_PER_LAUNCH // (block * self.chunk)))
        self.launches_per_run = -(-self.nchunks // self.chunks_per_launch)

        # ---- multiplier tables, drawn in leaf order (vegas.py:100-127) ----
        host_rng = np.random.default_rng(spec.cfg.seed + 77)
        self.dleaf = [i for i, li in enumerate(spec.leaves) if li.ndraw > 0]
        a_tabs = {}
        for lidx in self.dleaf:
            li = spec.leaves[lidx]
            a_list = _coprime_multipliers(host_rng, nb, N_MULT * li.ndraw)
            a_tabs[lidx] = np.asarray(a_list, np.int32).reshape(li.ndraw, N_MULT)
        # kernel slots: (leaf, slot) in drawn-leaf order, slot-minor
        self.slot_map = [(lidx, s) for lidx in self.dleaf
                         for s in range(spec.leaves[lidx].ndraw)]
        kslot = {ls: k for k, ls in enumerate(self.slot_map)}
        nslots, n = len(self.slot_map), spec.N

        def i32(a):
            return torch.as_tensor(np.asarray(a, np.int32), device=dev)

        self.atab = i32([a_tabs[lidx][s] for lidx, s in self.slot_map])
        self.slot_leaf = i32([self.dleaf.index(lidx) for lidx, _ in self.slot_map])

        # ---- padding factors: (group, slot) pairs, gi-major (:471-478) ----
        pairs = [(gi, s) for gi in range(spec.nvar) for s in range(spec.maxdof[gi])]
        maxmem = max(len(g) for g in spec.group_leaves)
        pair_slots = np.full((max(len(pairs), 1), maxmem), -1, np.int32)
        for g, (gi, s) in enumerate(pairs):
            for mm, lidx in enumerate(spec.group_leaves[gi]):
                pair_slots[g, mm] = kslot[(lidx, s)]
        pad = np.zeros((n, pair_slots.shape[0]), np.int32)
        for i in range(n):
            if not spec.pad_trivial[i]:
                for g, (gi, s) in enumerate(pairs):
                    pad[i, g] = s >= spec.cfg.dof[i][gi]
        # ---- histogram feeds: integrands using the slot, adaptive leaves ----
        used = np.zeros((nslots, n), np.int32)
        for k, (lidx, s) in enumerate(self.slot_map):
            li = spec.leaves[lidx]
            if li.leaf.adapt:
                used[k] = spec.mask_used[:n, li.group, s]
        self.pad, self.pair_slots, self.used = i32(pad), i32(pair_slots), i32(used)

        # ---- the integrand: batched, or per sample under vmap ----
        eval_b = spec.make_eval_batched(integrand, inplace)
        eval_v = spec.make_eval_vmapped(integrand, inplace)
        ok, self.backend_reason = spec.probe_batched(eval_b, eval_v)
        self.evaluate = eval_b if ok else eval_v
        self.backend = "cuda" if dev.type == "cuda" else "torch"

    # ------------------------------------------------------------------
    def kernel_inputs(self, params, kd: np.ndarray):
        """The launch-invariant inputs of ``vegas_sample`` for ``params``
        and per-block seeds ``kd [block, 2]`` uint32."""
        dev = self.spec.device
        return {
            "kd": torch.as_tensor(np.asarray(kd).astype(np.int64), device=dev),
            "atab": self.atab,
            "grid": torch.stack([params["leaf"][l][0] for l in self.dleaf]),
            "inc": torch.stack([params["leaf"][l][1] for l in self.dleaf]),
            "slot_leaf": self.slot_leaf,
        }

    def leaf_values(self, x):
        """Split kernel-slot samples ``x [S, ...]`` into per-leaf views."""
        out, k = [], 0
        for li in self.spec.leaves:
            out.append(x[k:k + li.ndraw])
            k += li.ndraw
        return out

    def launch(self, inputs, t0: int, T: int):
        """Chunks [t0, t0+T) of every block: obs [B,T,N], hrow [S,B,T,nb]."""
        x, invp, perm = vegas_kernels.vegas_sample(t0=t0, T=T, m=self.m_tile,
                                                   **inputs)
        w = self.evaluate(self.leaf_values(x))
        del x
        return vegas_kernels.vegas_reduce(w.contiguous(), invp, perm, self.pad,
                                          self.pair_slots, self.used)

    def run(self, params, kd: np.ndarray):
        """Execute one iteration; returns host-side numpy statistics."""
        spec = self.spec
        inputs = self.kernel_inputs(params, kd)
        obs_parts = []
        hsum = torch.zeros((len(self.slot_map), self.nb), dtype=torch.float64,
                           device=spec.device)
        for t0 in range(0, self.nchunks, self.chunks_per_launch):
            T = min(self.chunks_per_launch, self.nchunks - t0)
            obs_part, hrow = self.launch(inputs, t0, T)
            obs_parts.append(obs_part)
            hsum += hrow.sum(dim=(1, 2))
        obs_b = torch.cat(obs_parts, dim=1).sum(dim=1).cpu().numpy()   # [B, N]
        hsum = hsum.cpu().numpy()
        hists, k = [], 0
        for li in spec.leaves:
            h = np.zeros(li.nhist, np.float64)
            for s in range(li.ndraw):
                h = h + hsum[k + s]
            hists.append(h)
            k += li.ndraw
        return {
            "obs_blocks": obs_b,      # [block, N]
            "norm_blocks": np.full(self.block, float(self.nevalperblock)),
            "hists": hists,           # per-leaf histogram sums
            "neval": self.block * self.nevalperblock,
        }
