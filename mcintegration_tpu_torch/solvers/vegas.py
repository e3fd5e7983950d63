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
the integrand as torch ops → ``vegas_reduce`` (ops/vegas_kernels.py).  With
a custom ``measure(x, relw, c)`` (K1's branch, pallas_vegas.py:488-503) a
launch is ``vegas_sample`` → the integrand → ``vegas_relw`` → the measure
as torch ops → ``vegas_reduce`` of the measure's output, and the measure's
``ncomp`` float32 values per sample cap the samples of a launch
(``MEASURE_LAUNCH_BYTES``).  The per-(block, chunk) float64 partial sums
are then added in a fixed order.

Complex weights (``type=complex``) and ``measurefreq = k > 1`` are the
reference's XLA route (``mcintegration_tpu/solvers/vegas.py:201-357``): the
same kernels take complex64 ``w`` and ``relw`` (``|w| = sqrt(re^2 + im^2)``
in the histogram), and ``vegas_reduce`` sums only the samples whose index
in their block ``k`` divides, so a block's normalization is
``nevalperblock // k``.  Unlike that route, a custom measure's output is
summed over the measured samples only (the gate of ``montecarlo.jl:148``;
the route sums it over every sample with ``relw`` zeroed at the others,
ROADMAP.md, known faults in the reference); for a measure linear in
``relw`` the two agree.

``integrate(dtype=torch.float64)`` runs both routes on the kernels'
float64 instantiations (``Spec.dtype``): the tables, ``x``, the
densities and real weights in float64, the uniforms float32, the
reference's float64 law.

Discrete pools, and drawn pools whose ``ninc`` differ, take the mixed
route (``VegasMixedIteration``; ``make_vegas_iteration`` picks the route):
the reference's XLA path (``mcintegration_tpu/solvers/vegas.py:82-356``),
which K1 never serves.  Its chunk shaping is that path's (``mixed_plan``):
a drawn Continuous pool whose ``ninc`` divides the chunk is stratified on
its own strata, every other drawn pool is drawn per sample through its map,
and one launch is ``vegas_sample_mixed`` → the integrand (→
``vegas_relw_mixed`` → the measure) → ``vegas_reduce_mixed``, with complex
weights and ``measurefreq`` as above.  Specs of Continuous pools of one
``ninc`` keep the uniform route and its chunk shaping unchanged.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from .. import tracing
from ..models.variable import Continuous
from ..ops import vegas_kernels
from ..ops._build import tree_sum
from ..ops.vplus_kernels import leaf_values, slot_tables
from .engine import Spec, obs_components, obs_tree, refuse_fermik

N_MULT = vegas_kernels.N_MULT
SAMPLES_PER_LAUNCH = 2 ** 26   # per slot; bounds x at 4 (float64: 8) bytes * slots * this
# with a custom measure, x, w, relw and the measure's output m of one launch
# (per sample: the dtype's 4 or 8 bytes a slot, integrand (8 if complex),
# integrand (8 if complex: relw stays complex64 at float64) and component (4
# if complex)) stay within this many bytes; the measure's own temporaries
# come on top
MEASURE_LAUNCH_BYTES = 8 * 2 ** 30


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
    """The strata count of the uniform route (pallas_vegas.py: eligible,
    lines 290-340: every drawn pool Continuous, all with one ninc), or None
    for a spec the mixed route serves.  FermiK pools and specs with nothing
    to draw raise.  The strata bound is checked by the sample kernels."""
    refuse_fermik(spec, ":vegas")
    drawn = [li for li in spec.leaves if li.ndraw > 0]
    if not drawn:
        raise ValueError("no MC-owned slots to draw (every dof is 0)")
    nbs = {li.leaf.ninc if isinstance(li.leaf, Continuous) else None for li in drawn}
    return nbs.pop() if len(nbs) == 1 and None not in nbs else None


def make_vegas_iteration(spec: Spec, integrand: Callable, **kw):
    """The :vegas iteration of ``spec``: the uniform route where it serves
    the spec, else the mixed route."""
    cls = VegasIteration if check_supported(spec) is not None else VegasMixedIteration
    return cls(spec, integrand, **kw)


def launch_chunks(spec: Spec, block: int, chunk: int, nchunks: int, measure, obs_proto,
                  gidx: bool = False) -> int:
    """Chunks of every block a launch takes: about ``SAMPLES_PER_LAUNCH``
    samples, and with a measure x, w, relw and m (and ``gidx``, 4 bytes a
    slot) within ``MEASURE_LAUNCH_BYTES``."""
    samples = SAMPLES_PER_LAUNCH
    if measure is not None:
        samples = min(samples, MEASURE_LAUNCH_BYTES //
                      measure_sample_bytes(spec, obs_proto, 4 if gidx else 0))
    return max(1, min(nchunks, samples // (block * chunk)))


def measure_sample_bytes(spec: Spec, obs_proto, per_slot: int = 0) -> int:
    """Bytes of one sample's x, w, relw and measure output m (and
    ``per_slot`` more a slot, as gidx) at the spec's dtype and weights."""
    nslots = sum(li.ndraw for li in spec.leaves)
    return (spec.dtype.itemsize + per_slot) * nslots + 2 * spec.wdtype.itemsize * spec.N + \
        spec.mdtype.itemsize * obs_components(spec, obs_proto)


def _evaluators(spec: Spec, integrand: Callable, inplace: bool, measure, obs_proto):
    """``(evaluate, measure, backend_reason)``: the integrand and the measure
    batched, or per sample under ``torch.func.vmap`` where the probe finds
    the batched call wrong, and why."""
    evaluate, why = spec.pick_eval(integrand, inplace)
    m, why_m = (None, "") if measure is None else spec.pick_measure(measure, obs_proto)
    return evaluate, m, "; ".join(r for r in (why, why_m) if r)


def _leaf_hists(spec: Spec, hsum: torch.Tensor) -> list:
    """Per spec leaf, the sum of its slots' histograms from ``hsum [S, >=
    nhist]`` (kernel slots in leaf order), on the host."""
    hsum = hsum.cpu().numpy()
    hists, k = [], 0
    for li in spec.leaves:
        h = np.zeros(li.nhist, np.float64)
        for s in range(li.ndraw):
            h = h + hsum[k + s, :li.nhist]
        hists.append(h)
        k += li.ndraw
    return hists


class VegasIteration:
    """One :vegas iteration over ``block`` blocks on ``spec.device``."""

    guard = "kernel"     # where the weights' non-finite guard runs (``mct.call``)

    def __init__(self, spec: Spec, integrand: Callable, *, measure=None, obs_proto=None,
                 inplace=False, measurefreq=1, block=16, nevalperblock=10000):
        self.spec = spec
        self.block = block
        if int(measurefreq) < 1:
            raise ValueError(f"measurefreq must be >= 1, got {measurefreq}")
        self.measurefreq = int(measurefreq)
        dev = spec.device
        nb = check_supported(spec)
        if nb is None:
            raise ValueError("VegasIteration serves Continuous pools of one ninc; "
                             "make_vegas_iteration picks the mixed route for this spec")
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
        self.chunks_per_launch = launch_chunks(spec, block, self.chunk, self.nchunks, measure,
                                               obs_proto)
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

        def i32(a):
            return torch.as_tensor(np.asarray(a, np.int32), device=dev)

        self.atab = i32([a_tabs[lidx][s] for lidx, s in self.slot_map])
        self.slot_leaf = i32([self.dleaf.index(lidx) for lidx, _ in self.slot_map])
        # padding factors of the (group, slot) pairs, gi-major (:471-478), and
        # the histogram feeds: integrands using the slot, adaptive leaves
        pad, pair_slots, used = slot_tables(spec, {ls: k for k, ls in enumerate(self.slot_map)})
        self.pad, self.pair_slots, self.used = i32(pad), i32(pair_slots), i32(used)

        self.obs_proto = obs_proto
        self.evaluate, self.measure, self.backend_reason = _evaluators(
            spec, integrand, inplace, measure, obs_proto)
        self.backend = "cuda" if dev.type == "cuda" else "torch"

    def reset_state(self):
        """Nothing carries over from one run to the next: a cached iteration
        starts as a fresh one (the JAX package's no-op)."""

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
        return leaf_values(self.spec, x)

    def launch(self, inputs, t0: int, T: int):
        """Chunks [t0, t0+T) of every block: the observables' partial sums
        [B,T,R,ncomp] (``vegas_reduce``'s rows), hrow [S,B,T,nb]."""
        x, invp, perm = vegas_kernels.vegas_sample(t0=t0, T=T, m=self.m_tile,
                                                   **inputs)
        w = self.evaluate(self.leaf_values(x)).contiguous()
        m = None
        if self.measure is not None:
            # every sample drawn is real: the JAX kernel's rowmask
            # (pallas_vegas.py:394, :501) masks the strata rows that pad its
            # chunk to an L x L square, and the port draws no such rows, so
            # a measure term that does not depend on relw is summed over the
            # same samples as in JAX
            relw = vegas_kernels.vegas_relw(w, invp, self.pad, self.pair_slots)
            m = self.measure(self.leaf_values(x), relw).contiguous()
            del relw
        del x
        return vegas_kernels.vegas_reduce(w, invp, perm, self.pad, self.pair_slots,
                                          self.used, m, self.measurefreq, t0, rows=True)

    def run(self, params, kd: np.ndarray):
        """Execute one iteration; returns host-side numpy statistics."""
        spec = self.spec
        with tracing.span("mct.issue"):
            inputs = self.kernel_inputs(params, kd)
            obs_parts = []
            hsum = torch.zeros((len(self.slot_map), self.nb), dtype=torch.float64,
                               device=spec.device)
            for t0 in range(0, self.nchunks, self.chunks_per_launch):
                T = min(self.chunks_per_launch, self.nchunks - t0)
                obs_part, hrow = self.launch(inputs, t0, T)
                obs_parts.append(obs_part)
                hsum += hrow.sum(dim=(1, 2))
            # every row of every launch in one fixed-order pass: [B, ncomp]
            obs_b = tree_sum(torch.cat(obs_parts, dim=1).flatten(1, 2), 1)
        with tracing.span("mct.wait"):
            obs_b = obs_b.cpu()
        with tracing.span("mct.collect"):
            obs_b = obs_tree(obs_b.numpy(), spec,
                             self.obs_proto if self.measure is not None else None)
            return {
                "obs_blocks": obs_b,      # [block, N], or the observable pytree
                # the samples the gate measures: the indices 1..nevalperblock
                # that measurefreq divides
                "norm_blocks": np.full(self.block,
                                       float(self.nevalperblock // self.measurefreq)),
                "hists": _leaf_hists(spec, hsum),   # per-leaf histogram sums
                "neval": self.block * self.nevalperblock,
            }


MAX_CHUNK = 131072   # the mixed route's largest chunk (mcintegration_tpu/solvers/vegas.py:63)


def mixed_plan(spec: Spec, nevalperblock: int):
    """``(chunk, nchunks, stratified leaves)`` of the mixed route
    (``mcintegration_tpu/solvers/vegas.py:82-127``): ``c = min(nevalperblock,
    MAX_CHUNK)``; with ``nb0`` the largest drawn Continuous ninc, ``c = nb0 *
    m`` for ``m = c // nb0``, rounded down to a multiple of 128 when it is
    at least 128; a drawn Continuous leaf whose ninc divides ``c`` is
    stratified, every other drawn leaf is drawn per sample."""
    nincs = sorted({li.leaf.ninc for li in spec.leaves
                    if isinstance(li.leaf, Continuous) and li.ndraw > 0}, reverse=True)
    c = max(1, min(int(nevalperblock), MAX_CHUNK))
    if nincs and c >= nincs[0]:
        m = max(1, c // nincs[0])
        if m >= 128:
            m = (m // 128) * 128
        c = nincs[0] * m
    strat = [lidx for lidx, li in enumerate(spec.leaves)
             if isinstance(li.leaf, Continuous) and li.ndraw > 0 and c % li.leaf.ninc == 0]
    return c, max(1, -(-int(nevalperblock) // c)), strat


class VegasMixedIteration:
    """One :vegas iteration of the mixed route over ``block`` blocks on
    ``spec.device``: Discrete pools, and pools of different ninc
    (``ops/vegas_kernels.py``, the mixed route's notes).

    A launch is ``vegas_sample_mixed`` → the integrand → ``vegas_reduce_mixed``,
    with ``vegas_relw_mixed`` and the measure before the reduce given a
    custom measure.  The chunk shaping, the stratified leaves and their
    multiplier tables (``default_rng(seed + 77)``, stratified leaves only,
    in leaf order, each coprime to its own nb) are the reference XLA
    route's; so are complex weights and ``measurefreq``.
    """

    guard = "kernel"     # where the weights' non-finite guard runs (``mct.call``)

    def __init__(self, spec: Spec, integrand: Callable, *, measure=None, obs_proto=None,
                 inplace=False, measurefreq=1, block=16, nevalperblock=10000):
        self.spec = spec
        self.block = block
        if int(measurefreq) < 1:
            raise ValueError(f"measurefreq must be >= 1, got {measurefreq}")
        self.measurefreq = int(measurefreq)
        check_supported(spec)
        self.chunk, self.nchunks, strat = mixed_plan(spec, nevalperblock)
        self.nevalperblock = self.chunk * self.nchunks
        self.chunks_per_launch = launch_chunks(spec, block, self.chunk, self.nchunks, measure,
                                               obs_proto, gidx=True)
        self.launches_per_run = -(-self.nchunks // self.chunks_per_launch)
        host_rng = np.random.default_rng(spec.cfg.seed + 77)
        atabs = {}
        for lidx in strat:
            li = spec.leaves[lidx]
            a_list = _coprime_multipliers(host_rng, li.leaf.ninc, N_MULT * li.ndraw)
            atabs[lidx] = np.asarray(a_list, np.int32).reshape(li.ndraw, N_MULT)
        self.layout = vegas_kernels.MixedLayout.build(spec, self.chunk, atabs)

        self.obs_proto = obs_proto
        self.evaluate, self.measure, self.backend_reason = _evaluators(
            spec, integrand, inplace, measure, obs_proto)
        self.backend = "cuda" if spec.device.type == "cuda" else "torch"

    def reset_state(self):
        """Nothing carries over from one run to the next: a cached iteration
        starts as a fresh one (the JAX package's no-op)."""

    def seeds(self, kd: np.ndarray) -> torch.Tensor:
        """Per-block seeds ``kd [block, 2]`` uint32 as the int32 bit
        patterns the kernels take, on the device."""
        return torch.as_tensor(np.asarray(kd, np.uint32).view(np.int32),
                               device=self.spec.device)

    def launch(self, tab, kd: torch.Tensor, t0: int, T: int):
        """Chunks [t0, t0+T) of every block: obs [B,T,ncomp], hist [S,nbmax]."""
        lay = self.layout
        x, gidx = vegas_kernels.vegas_sample_mixed(lay, tab, kd, t0, T)
        w = self.evaluate(lay.leaf_values(x)).contiguous()
        m = None
        if self.measure is not None:
            relw = vegas_kernels.vegas_relw_mixed(lay, tab, w, gidx)
            m = self.measure(lay.leaf_values(x), relw).contiguous()
            del relw
        del x
        return vegas_kernels.vegas_reduce_mixed(lay, tab, w, gidx, m, self.measurefreq, t0)

    def run(self, params, kd: np.ndarray):
        """Execute one iteration; returns host-side numpy statistics."""
        spec, lay = self.spec, self.layout
        with tracing.span("mct.issue"):
            tab, kd = lay.tables(params), self.seeds(kd)
            obs_parts, hsum = [], 0.0
            for t0 in range(0, self.nchunks, self.chunks_per_launch):
                T = min(self.chunks_per_launch, self.nchunks - t0)
                obs_part, hist = self.launch(tab, kd, t0, T)
                obs_parts.append(obs_part)
                hsum = hsum + hist
            obs = torch.cat(obs_parts, dim=1).movedim(-1, 0)                  # [ncomp, B, nchunks]
            obs_b = vegas_kernels.sum_components(obs, -1)                    # [B, ncomp]
        with tracing.span("mct.wait"):
            obs_b = obs_b.cpu()
        with tracing.span("mct.collect"):
            obs_b = obs_tree(obs_b.numpy(), spec,
                             self.obs_proto if self.measure is not None else None)
            return {
                "obs_blocks": obs_b,      # [block, N], or the observable pytree
                "norm_blocks": np.full(self.block,
                                       float(self.nevalperblock // self.measurefreq)),
                "hists": _leaf_hists(spec, hsum),   # per-leaf histogram sums
                "neval": self.block * self.nevalperblock,
            }
