"""The :vegasplus solver — Vegas importance sampling with adaptive hypercube
stratification (Lepage 2021 "vegas+").

Counterpart of ``mcintegration_tpu/solvers/vegasplus.py``.  Plain Vegas
learns a separable density; vegas+ adds a coarse grid of ``nstrat^D``
hypercubes in the mapped y-space and moves samples toward the cubes of high
variance (Neyman allocation), which attacks the non-separable variance.  The
sampling density is ``p(x) = n_c * ncubes / T * prod_d rho_d(x_d)`` with
``n_c`` the samples of the point's cube and ``T`` the chunk; the estimator
``obs[i] += w_i * pad_i / p`` and the statistics are those of :vegas.
``Discrete`` pools ride along as non-stratified passengers whose density
joins ``p``; ``dof < maxdof`` works through the padding factors.

The law is the JAX package's XLA route (lines 95-340 there): integer counts
per cube with a floor of 2, cube-major samples, the maps at their full
``ninc``, any ``nstrat``.  The shape plan and the host-side reallocation
(float64 numpy) are the reference's, bit for bit.  The TPU kernel's
quantisation of the counts to whole 128-wide lanes, its coarsened and pow2
shadow maps and its histogram subsample are not carried over.

One iteration is a few launches, each over all blocks and a range of chunks
holding about ``SAMPLES_PER_LAUNCH`` samples: ``vplus_sample`` → the
integrand as torch ops → ``vplus_reduce`` (ops/vplus_kernels.py).  The
per-cube second moments come back to the host once per iteration, where the
next iteration's counts are made: one wait for the device per iteration is
inherent in the method.

The route also serves complex weights (``type=complex``, ``|w| = sqrt(re^2
+ im^2)`` in the scores and histograms), a custom ``measure(x, relw, c)``
and ``measurefreq = k > 1``, as the reference's XLA route does (lines
131-312 there).  A launch with a measure is ``vplus_sample`` → the
integrand → ``vplus_relw`` → the measure as torch ops → ``vplus_reduce``
given its output, and ``MEASURE_LAUNCH_BYTES`` caps its samples.  With
``k > 1`` a ``k``-th of each chunk's samples count in the observables (a
block's normalization is ``nevalperblock // k``, as in the reference); the
scores and histograms take every sample.  Two deliberate differences from
the reference's route, each a fault of it (ROADMAP.md, known faults in the
reference): the gate's positions are shifted at random per (block, chunk)
(``vplus_kernels.gate_shifts``), since the route's fixed positions weight
the cubes of a cube-major chunk unevenly where ``k`` divides the chunk (at
2^30 evaluations an iteration its estimate of pi/4 lands 6.5 to 16 sigma
off); and a measure's output is summed over the measured samples only,
where the route sums it over every sample with ``relw`` zeroed at the
others (for a measure linear in ``relw`` the two agree).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..models.variable import Discrete
from ..ops import vplus_kernels
from ..ops._build import tree_sum
from ..ops.vplus_kernels import VplusLayout
from .engine import Spec, obs_components, obs_tree, refuse_fermik

SAMPLES_PER_LAUNCH = 2 ** 26   # per slot; bounds x and gidx at 8 bytes * slots * this
# with a custom measure, x, gidx, w, relw and the measure's output m of one
# launch (8 bytes per slot, 4 (8 if complex) per integrand twice and 4 per
# component of a sample) stay within this many bytes; the measure's own
# temporaries come on top
MEASURE_LAUNCH_BYTES = 8 * 2 ** 30
MAX_DIMS = 10


def shape_plan(D: int, nevalperblock: int, nstrat=None, max_cubes=16384,
               max_chunk=131072):
    """``(nstrat, ncubes, chunk, nchunks)`` for ``D`` stratified dimensions
    (``mcintegration_tpu/solvers/vegasplus.py:115-123``, unchanged)."""
    c = max(1, min(int(nevalperblock), max_chunk))
    if nstrat is None:
        nstrat = max(2, int((max_cubes) ** (1.0 / D)))
        while nstrat**D > max_cubes:
            nstrat -= 1
        nstrat = max(nstrat, 1 if D > 8 else 2)
    ncubes = nstrat**D
    c = max(c, 2 * ncubes)
    nchunks = max(1, -(-int(nevalperblock) // c))
    return nstrat, ncubes, c, nchunks


class VegasPlusIteration:
    """One :vegasplus iteration over ``block`` blocks on ``spec.device``.

    ``counts [ncubes]`` (int64, sum = ``chunk``) is the adaptive state: the
    samples each cube gets in every chunk of the next ``run``.
    """

    def __init__(self, spec: Spec, integrand: Callable, *, measure=None, obs_proto=None,
                 inplace=False, measurefreq=1, block=16, nevalperblock=10000, nstrat=None,
                 max_cubes=16384, beta=0.75, max_chunk=131072):
        self.spec = spec
        self.block = block
        self.beta = beta
        refuse_fermik(spec, ":vegasplus")
        if int(measurefreq) < 1:
            raise ValueError(f"measurefreq must be >= 1, got {measurefreq}")
        self.measurefreq = int(measurefreq)
        D = sum(li.ndraw for li in spec.leaves if not isinstance(li.leaf, Discrete))
        if D == 0:
            raise NotImplementedError(
                ":vegasplus stratifies over Continuous slots and this spec "
                "has none; a pure-Discrete integrand gains nothing from "
                "hypercube stratification — use :vegas")
        if D > MAX_DIMS:
            raise ValueError(f"vegasplus supports up to {MAX_DIMS} stratified "
                             f"(Continuous) dimensions, got {D}")
        self.nstrat, self.ncubes, self.chunk, self.nchunks = shape_plan(
            D, nevalperblock, nstrat, max_cubes, max_chunk)
        self.nevalperblock = self.chunk * self.nchunks
        samples = SAMPLES_PER_LAUNCH
        if measure is not None:
            nslots = sum(li.ndraw for li in spec.leaves)
            wbytes = 8 if spec.cplx else 4
            per_sample = 8 * nslots + 2 * wbytes * spec.N + 4 * obs_components(spec, obs_proto)
            samples = min(samples, MEASURE_LAUNCH_BYTES // per_sample)
        self.chunks_per_launch = max(1, min(self.nchunks, samples // (block * self.chunk)))
        self.launches_per_run = -(-self.nchunks // self.chunks_per_launch)
        self.counts = self._uniform_counts()
        self.layout = VplusLayout.build(spec, self.nstrat)

        # ---- the integrand and the measure: batched, or per sample under vmap ----
        eval_b = spec.make_eval_batched(integrand, inplace)
        eval_v = spec.make_eval_vmapped(integrand, inplace)
        ok, why = spec.probe_batched(eval_b, eval_v)
        self.evaluate = eval_b if ok else eval_v
        self.obs_proto = obs_proto
        self.measure, why_m = (None, "") if measure is None else \
            spec.pick_measure(measure, obs_proto)
        self.backend_reason = "; ".join(r for r in (why, why_m) if r)
        self.backend = "cuda" if spec.device.type == "cuda" else "torch"

    # ------------------------------------------------------------------
    def _uniform_counts(self) -> np.ndarray:
        base = self.chunk // self.ncubes
        counts = np.full(self.ncubes, base, dtype=np.int64)
        counts[: self.chunk - base * self.ncubes] += 1
        return counts

    def reallocate(self, sig: np.ndarray):
        """Reallocate the counts from ``sig``, the per-cube second moments of
        ``run``'s statistics summed over every rank's blocks (``integrate``
        does this after the reduce, so every rank gets the same counts)."""
        self.last_sig = sig
        self._reallocate(sig)

    def _reallocate(self, sig: np.ndarray):
        """Neyman reallocation with ^beta damping (Lepage 2021 Eq.(24))."""
        acc = np.asarray(sig[: self.ncubes], dtype=np.float64)
        d = np.sqrt(np.maximum(acc / np.maximum(self.counts, 1), 0.0))
        if d.sum() <= 0 or not np.all(np.isfinite(d)):
            return
        d = (d / d.sum()) ** self.beta
        d /= d.sum()
        counts = np.maximum(2, np.floor(d * self.chunk).astype(np.int64))
        # fix the total back to the chunk size
        excess = counts.sum() - self.chunk
        if excess > 0:
            order = np.argsort(-counts)
            for i in order:
                take = min(counts[i] - 2, excess)
                counts[i] -= take
                excess -= take
                if excess <= 0:
                    break
        elif excess < 0:
            counts[np.argmax(counts)] += -excess
        if counts.sum() == self.chunk:
            self.counts = counts

    def reset_state(self):
        """Drop the adaptive stratification state, so a reused iteration
        starts like a fresh one."""
        self.counts = self._uniform_counts()

    # ------------------------------------------------------------------
    def seeds(self, kd: np.ndarray) -> torch.Tensor:
        """Per-block seeds ``kd [block, 2]`` uint32 as the int32 bit
        patterns the kernels take, on the device."""
        return torch.as_tensor(np.asarray(kd, np.uint32).view(np.int32),
                               device=self.spec.device)

    def cube_tables(self):
        """``(cube [chunk] int32, cfac [ncubes] float32)`` of the current
        counts, on the device: the cube of every sample of a chunk
        (cube-major) and the stratification's factor ``n_c * ncubes / chunk``
        of the density, rounded as the reference rounds it."""
        counts = np.asarray(self.counts, np.int64)
        if counts.shape != (self.ncubes,) or counts.sum() != self.chunk or counts.min() < 0:
            raise ValueError("counts must be non-negative, one per cube, and sum to the chunk")
        cube = np.repeat(np.arange(self.ncubes, dtype=np.int32), counts)
        cfac = counts.astype(np.float32) * np.float32(float(self.ncubes) / self.chunk)
        dev = self.spec.device
        return torch.as_tensor(cube, device=dev), torch.as_tensor(cfac, device=dev)

    def launch(self, tab, kd: torch.Tensor, cube, cfac, t0: int, T: int):
        """Chunks [t0, t0+T) of every block: obs [B,T,ncomp], sig [ncubes],
        hist [H], all float64."""
        lay = self.layout
        x, gidx = vplus_kernels.vplus_sample(lay, tab, kd, t0, T, cube)
        w = self.evaluate(lay.leaf_values(x)).contiguous()
        m = None
        if self.measure is not None:
            relw = vplus_kernels.vplus_relw(lay, tab, w, gidx, cube, cfac)
            m = self.measure(lay.leaf_values(x), relw).contiguous()
            del relw
        del x
        shift = None
        if self.measurefreq > 1:
            shift = vplus_kernels.gate_shifts(kd, t0, T, self.chunk)
        return vplus_kernels.vplus_reduce(lay, tab, w, gidx, cube, cfac, m,
                                          self.measurefreq, t0, shift)

    def run(self, params, kd: np.ndarray):
        """Execute one iteration with per-block seeds ``kd [block, 2]``
        uint32; returns host-side numpy statistics, ``sig`` the per-cube
        second moments that :meth:`reallocate` takes."""
        spec, lay = self.spec, self.layout
        tab = lay.tables(params)
        kd = self.seeds(kd)
        cube, cfac = self.cube_tables()
        obs_parts, sig, hist = [], 0.0, 0.0
        for t0 in range(0, self.nchunks, self.chunks_per_launch):
            T = min(self.chunks_per_launch, self.nchunks - t0)
            obs_part, sig_part, hist_part = self.launch(tab, kd, cube, cfac, t0, T)
            obs_parts.append(obs_part)
            sig, hist = sig + sig_part, hist + hist_part
        obs_b = tree_sum(torch.cat(obs_parts, dim=1), 1).cpu().numpy()     # [B, ncomp]
        obs_b = obs_tree(obs_b, spec, self.obs_proto if self.measure is not None else None)
        hist = hist.cpu().numpy()
        hists = []
        for li, off in zip(spec.leaves, lay.hist_off):
            hists.append(hist[off:off + li.nhist].copy() if off >= 0
                         else np.zeros(li.nhist, np.float64))
        return {
            "obs_blocks": obs_b,      # [block, N], or the observable pytree
            # the samples the gate measures: the indices 1..nevalperblock
            # that measurefreq divides
            "norm_blocks": np.full(self.block, float(self.nevalperblock // self.measurefreq)),
            "hists": hists,           # per-leaf histogram sums
            "neval": self.block * self.nevalperblock,
            "sig": sig.cpu().numpy(),  # [ncubes], this rank's blocks
        }
