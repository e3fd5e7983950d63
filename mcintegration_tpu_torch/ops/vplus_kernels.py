"""Wrappers of the two CUDA kernels of the :vegasplus solver, with their
plain PyTorch versions.

Together they replace ``mcintegration_tpu/ops/pallas_vplus.py:
build_vplus_run_all`` (kernel K4) as a split path: ``vplus_sample`` draws
every sample inside its hypercube through the Vegas maps, the user
integrand runs as torch ops on the samples, and ``vplus_reduce`` forms the
sampling density, the padded observable sums, the per-cube clipped second
moments of the Neyman reallocation and the maps' training histograms.  The
law is the JAX package's XLA route (``mcintegration_tpu/solvers/
vegasplus.py:168-301``): integer sample counts per cube, cube-major samples,
the maps at their full ``ninc`` by a plain gather, any ``nstrat``,
histograms on every sample, float64 sums.  K4's lanes, its R-way select on
a coarsened map, the pow2 shadow maps, ``HIST_EVERY`` and the Kahan pairs
are not carried over; K4's law is the special case ``counts = lanes * spp``
on the grid ``leaf.grid[::k]``.

``vplus_reduce`` and ``vplus_relw`` read ``w`` through the non-finite
guard: a weight that is not finite, or a complex one with a part that is
not, counts as 0 (``common.finite_guard``, which their plain versions apply
to ``w``).

Each wrapper takes its plain version only for tensors on the CPU.  For CUDA
tensors it launches its kernel (``csrc/vplus_*.cu``, built by
``ops/_build.py``) or raises; there is no fallback.  ``launch_counts``
counts the kernel launches of each wrapper.

Shapes (``S`` = kernel slots, ``B`` = blocks, ``T`` = chunks of this launch,
``c`` = samples per chunk, ``N`` = integrands, ``H`` = histogram bins of the
adaptive leaves, one leaf after the other):

- ``vplus_sample(lay, tab, kd [B,2] i32, t0, T, cube [c] i32) ->
  x [S,B,T,c] f32 (int32 bits for a Discrete slot), gidx [S,B,T,c] i32``;
- ``vplus_reduce(lay, tab, w [N,B,T,c] f32 or c64, gidx, cube, cfac
  [ncubes] f32, m=None, mf=1, t0=0) -> obs [B,T,ncomp] f64, sig [ncubes]
  f64, hist [H] f64``: ``ncomp = N``, or ``2N`` for complex ``w`` (Re and
  Im of integrand ``i`` in components ``2i``, ``2i+1``); given a custom
  measure's output ``m [ncomp,B,T,c] f32``, the sums of ``m``;
- ``vplus_relw(lay, tab, w, gidx, cube, cfac) -> relw [N,B,T,c]`` of
  ``w``'s dtype: ``w_i * (jac * pad_i)`` per sample, what a custom measure
  reads (a streaming kernel of ``csrc/vplus_reduce.cu``, the density formed
  as in the reduce: a thread takes four consecutive samples of a chunk, a
  block ``RELW_SPAN`` of them).

With ``mf > 1`` (``measurefreq``) sample ``s`` of chunk ``t`` (``t0`` plus
its index in the launch) of block ``b`` counts in ``obs`` only if ``(t*c +
(s + shift[b, t]) % c + 1) % mf == 0``; ``sig`` and ``hist`` take every
sample.  Without ``shift`` this is the reference's gate
(``mcintegration_tpu/solvers/vegasplus.py:255-262``), which, where ``mf``
divides ``c``, measures the same positions of every cube-major chunk and
so weights a cube of ``n_c`` samples by ``mf * m_c / n_c`` (0 to 2) for its
``m_c`` measured ones: a biased estimate (ROADMAP.md, known faults in the
reference).  ``gate_shifts`` draws a random cyclic shift per (block,
chunk), which measures every cube at the rate ``1/mf`` in expectation and
keeps each chunk's count.  Complex weights, measures and the gate are the
reference's XLA route, which K4 never runs.

``cube[s]`` is the hypercube of sample ``s`` of every chunk (cube-major, so
non-decreasing); ``cfac[cube] = counts[cube] * ncubes / c`` is the
stratification's factor of the density.  Kernel slots are the (leaf, slot)
pairs in leaf order, slot-minor; a Continuous slot is stratified (its
``stride`` is ``nstrat^d``), a Discrete slot is a passenger drawn from its
CDF.  The slots of one leaf share the leaf's histogram.

Random bits: the counter hash of ``ops/rng.py`` keyed by the per-block
seeds ``kd`` (int32 tensors holding the uint32 bits), with the chunk as
``t``, the sample's index in its chunk as the flat index and the salt
``k + 1`` for kernel slot ``k``; a uniform is ``((bits >> 8) + 0.5) * 2^-24``.
The kernels and the plain versions draw the same bits and form the same
float32 products in the same order: ``vplus_sample`` agrees bit for bit,
``vplus_reduce`` to the rounding of float64 sums taken in another order.

float64 (``integrate(dtype=torch.float64)``): given a float64 ``tab``,
``x`` is float64 (a Discrete slot's int32 value sign-extended to 64 bits)
and so are the densities, ``jac``, ``pad_i`` and real ``w``, ``relw`` and
``m``, the reference's float64 law (``mcintegration_tpu/solvers/
vegasplus.py:184-300`` under x64); the in-cube ``y``, its bin's fraction
and ``cfac`` stay float32 there and here, and complex ``w`` stays
complex64, scaled by its factor rounded to float32.  A wrapper picks its
kernel's ``_f64`` entry point by ``tab``'s dtype and counts it in
``launch_counts_f64`` under the float32 launch's key; it never casts a
float64 input down.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List

import numpy as np
import torch

from ..common import finite_guard, weight_abs, weight_parts, weight_scale
from ..models.variable import Discrete
from . import _build
from ._build import check_tensor as _check
from .grid import sample_continuous, sample_discrete
from .rng import MASK32, chunk_keys, draw

CLIP = 1e17              # clip of the scores and histogram weights (vegasplus.py:283-289)
SALT_GATE = 0x47415445   # the gate's shift: a salt no slot's draw uses
SLOT_FIELDS = 8          # kind, nb, tab_off, -1, lower, stride, hist_off, salt
SPAN = 256               # samples of a chunk per thread block of vplus_reduce
WARPS = 8                # warps per thread block of vplus_reduce
RELW_SPAN = 1024         # samples of a chunk per thread block of vplus_relw, four a thread
RELW_WARPS = 8           # warps per thread block of vplus_relw
SMEM_HIST_BINS = 4096    # 32 KiB of float64 histogram per thread block; a larger
                         # one is added in windows of this many bins

# "vplus_reduce_measure" counts vplus_reduce given m, "vplus_reduce_complex"
# its complex instantiations (given m or not), "vplus_relw" both of its own;
# launch_counts_f64 counts the float64 instantiations' launches under the
# same keys
launch_counts = {"vplus_sample": 0, "vplus_reduce": 0, "vplus_reduce_measure": 0,
                 "vplus_reduce_complex": 0, "vplus_relw": 0}
launch_counts_f64 = dict.fromkeys(launch_counts, 0)
_BITS = {torch.float32: torch.int32, torch.float64: torch.int64}   # x's bits beside tab


def _suffix(tab, name: str) -> str:
    """The entry-point suffix of a kernel reading ``tab``: "" for float32,
    "_f64" for float64; any other dtype raises."""
    if tab.dtype not in _BITS:
        raise ValueError(f"{name}: tables of {tab.dtype}, not float32 or float64")
    return "_f64" if tab.dtype == torch.float64 else ""


def reset_launch_counts():
    for counts in (launch_counts, launch_counts_f64):
        for k in counts:
            counts[k] = 0


def _count(key: str, f64: str):
    """One launch of ``key``'s kernel, float32 or (``f64``) float64."""
    (launch_counts_f64 if f64 else launch_counts)[key] += 1


@dataclasses.dataclass
class VplusLayout:
    """The static shape of a spec as the :vegasplus kernels read it.

    Per kernel slot ``k`` a row of ``slots``: ``kind`` (0 Continuous, 1
    Discrete), ``nb`` (bins), ``tab_off`` (its leaf's table in ``tab``, of
    the spec's dtype: grid, inc and the density ``rho = 1/(nb*inc)``, or cdf then
    dist), -1 (no staged CDF), ``lower``,
    ``stride`` (``nstrat^d`` for the d-th stratified slot, 0 for a
    passenger), ``hist_off`` (its leaf's histogram in ``hist``, -1 if the
    leaf does not adapt) and the slot's ``salt``.  ``pad [N, P]`` says
    whether the (group, slot) pair ``g`` enters integrand ``i``'s padding
    factor, ``pair_slots [P, M]`` lists the kernel slots of the pair's
    leaves, Continuous leaves first (``-1`` padded), and ``used [S, N]``
    whether integrand ``i``'s weight feeds slot ``k``'s histogram.
    """

    spec: Any
    nstrat: int
    D: int
    slots: np.ndarray        # [S, SLOT_FIELDS] int32
    pad: np.ndarray          # [N, P] int32
    pair_slots: np.ndarray   # [P, M] int32
    used: np.ndarray         # [S, N] int32
    dleaf: List[int]         # spec leaves with drawn slots
    hist_off: List[int]      # per spec leaf, -1 without a histogram
    tab_size: int
    nhist: int
    meta: torch.Tensor       # slots, pad, pair_slots, used: int32 on the device

    @property
    def S(self) -> int:
        return self.slots.shape[0]

    @staticmethod
    def build(spec, nstrat: int) -> "VplusLayout":
        rows, kslot, hist_off = [], {}, []
        tab_off = h_off = d = 0
        dleaf = [i for i, li in enumerate(spec.leaves) if li.ndraw > 0]
        for lidx, li in enumerate(spec.leaves):
            disc = isinstance(li.leaf, Discrete)
            nb = li.leaf.nbin if disc else li.leaf.ninc
            hist = -1
            if li.ndraw > 0 and li.leaf.adapt:
                hist, h_off = h_off, h_off + li.nhist
            hist_off.append(hist)
            for s in range(li.ndraw):
                stride = 0
                # nstrat^d for the d-th stratified slot in slot order: vplus_sample
                # divides the cube index by nstrat once per stratified slot, in this order
                if not disc:
                    stride, d = nstrat ** d, d + 1
                kslot[(lidx, s)] = len(rows)
                rows.append([int(disc), nb, tab_off, -1, li.leaf.lower if disc else 0,
                             stride, hist, len(rows) + 1])
            if li.ndraw > 0:
                tab_off += 2 * nb + 1 if disc else 3 * nb
        slots = np.asarray(rows, np.int32).reshape(-1, SLOT_FIELDS)
        pad, pair_slots, used = slot_tables(spec, kslot)
        return VplusLayout(spec=spec, nstrat=nstrat, D=d, slots=slots, pad=pad,
                           pair_slots=pair_slots, used=used, dleaf=dleaf, hist_off=hist_off,
                           tab_size=tab_off, nhist=h_off,
                           meta=pack_meta(spec.device, slots, pad, pair_slots, used))

    def tables(self, params) -> torch.Tensor:
        """The map tables ``tab`` of this iteration's ``params``, of the
        spec's dtype."""
        parts = []
        for lidx in self.dleaf:
            a, b = (t.reshape(-1).to(self.spec.dtype) for t in params["leaf"][lidx])
            parts += [a, b]
            if not isinstance(self.spec.leaves[lidx].leaf, Discrete):
                parts.append(1.0 / (b.shape[0] * b))     # rho, as the reference rounds it
        return torch.cat(parts).contiguous()

    def leaf_values(self, x: torch.Tensor):
        """Per spec leaf, its rows of ``x`` (``leaf_values``)."""
        return leaf_values(self.spec, x)


def slot_tables(spec, kslot):
    """The padding and histogram tables of the kernel slots ``kslot
    {(spec leaf, slot): kernel slot}``: ``pad [N, P]`` (whether the (group,
    slot) pair ``q``, group-major, enters integrand ``i``'s padding
    factor), ``pair_slots [P, M]`` (the kernel slots of the pair's leaves,
    Continuous leaves first, ``-1`` padded) and ``used [S, N]`` (whether
    integrand ``i``'s weight feeds slot ``k``'s histogram: adaptive leaves
    only)."""
    n = spec.N
    pairs = [(g, s) for g in range(spec.nvar) for s in range(spec.maxdof[g])]
    maxmem = max(len(g) for g in spec.group_leaves)
    pair_slots = np.full((max(len(pairs), 1), maxmem), -1, np.int32)
    for q, (g, s) in enumerate(pairs):
        members = sorted(spec.group_leaves[g],
                         key=lambda l: isinstance(spec.leaves[l].leaf, Discrete))
        for mm, lidx in enumerate(members):
            pair_slots[q, mm] = kslot[(lidx, s)]
    pad = np.zeros((n, pair_slots.shape[0]), np.int32)
    for i in range(n):
        for q, (g, s) in enumerate(pairs):
            pad[i, q] = s >= spec.cfg.dof[i][g]
    used = np.zeros((len(kslot), n), np.int32)
    for (lidx, s), k in kslot.items():
        li = spec.leaves[lidx]
        if li.leaf.adapt:
            used[k] = spec.mask_used[:n, li.group, s]
    return pad, pair_slots, used


def pack_meta(device, *tables) -> torch.Tensor:
    """The int32 ``tables`` raveled into one tensor on ``device``."""
    return torch.as_tensor(np.concatenate([np.asarray(t, np.int32).ravel() for t in tables]),
                           device=device)


def leaf_values(spec, x: torch.Tensor):
    """Per spec leaf, its ``[ndraw, ...]`` rows of the kernel-slot samples
    ``x`` (slots in leaf order; int32 for a Discrete leaf, whose value a
    float64 ``x`` holds as int64 bits)."""
    out, k = [], 0
    for li in spec.leaves:
        rows = x[k:k + li.ndraw]
        if isinstance(li.leaf, Discrete):
            rows = rows.view(_BITS[x.dtype]).to(torch.int32)
        out.append(rows)
        k += li.ndraw
    return out


def _device_of(t: torch.Tensor, name: str) -> torch.device:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device


def _slot_rho(lay: VplusLayout, tab, k: int, g):
    """Slot ``k``'s map density at the bins ``g`` (int64): the table's
    ``1/(ninc*inc)`` for a Continuous slot, the bin's mass for a Discrete one."""
    kind, nb, off = (int(v) for v in lay.slots[k, :3])
    lo = off + nb + 1 if kind == 1 else off + 2 * nb
    return tab[lo:lo + nb][g]


# ---------------------------------------------------------------------------
# vplus_sample
# ---------------------------------------------------------------------------

def vplus_sample_plain(lay: VplusLayout, tab, kd, t0: int, T: int, cube):
    """Plain torch version of ``csrc/vplus_sample.cu`` (same bits)."""
    dev = kd.device
    B, c, S = kd.shape[0], cube.shape[0], lay.S
    t = torch.arange(t0, t0 + T, dtype=torch.int64, device=dev)
    k1, k2 = chunk_keys((kd.long() & MASK32)[:, None, :], t[None, :])      # [B, T]
    idx = torch.arange(c, dtype=torch.int64, device=dev)
    # a tensor divisor: a Python number would divide as a multiplication by
    # its reciprocal on the card
    nstrat = torch.full((1,), float(lay.nstrat), dtype=torch.float32, device=dev)
    x = torch.empty((S, B, T, c), dtype=tab.dtype, device=dev)
    gidx = torch.empty((S, B, T, c), dtype=torch.int32, device=dev)
    xbits = x.view(_BITS[tab.dtype])
    for k in range(S):
        kind, nb, off, _, lower, stride, _, salt = (int(v) for v in lay.slots[k])
        bits = draw(k1[..., None], k2[..., None], idx, salt)
        u = ((bits >> 8).to(torch.float32) + 0.5) * 2.0 ** -24
        if kind == 1:
            g, _ = sample_discrete(u, tab[off:off + nb + 1], tab[off + nb + 1:off + 2 * nb + 1])
            xbits[k], gidx[k] = g + lower, g
        else:
            coord = (torch.div(cube, stride, rounding_mode="floor") % lay.nstrat)
            y = (coord.to(torch.float32) + u) / nstrat
            xk, g, _ = sample_continuous(y, tab[off:off + nb], tab[off + nb:off + 2 * nb])
            x[k], gidx[k] = xk, g
    return x, gidx


def _sample_args(lay: VplusLayout, tab, kd, t0: int, T: int, cube, x, gidx):
    """The argument list of ``mci_vplus_sample`` (without the stream)."""
    return (kd.data_ptr(), t0, kd.shape[0], T, cube.shape[0], lay.S, lay.nstrat,
            cube.data_ptr(), lay.meta.data_ptr(), tab.data_ptr(), x.data_ptr(),
            gidx.data_ptr())


def vplus_sample(lay: VplusLayout, tab, kd, t0: int, T: int, cube):
    """Chunks ``[t0, t0+T)`` of every block: each sample drawn inside its
    hypercube through the maps (see module docstring)."""
    dev = _device_of(kd, "vplus_sample")
    f64 = _suffix(tab, "vplus_sample")
    if dev.type == "cpu":
        return vplus_sample_plain(lay, tab, kd, t0, T, cube)
    B, c, S = kd.shape[0], cube.shape[0], lay.S
    _check(kd, "kd", torch.int32, (B, 2), dev)
    _check(cube, "cube", torch.int32, (c,), dev)
    _check(tab, "tab", lay.spec.dtype, (lay.tab_size,), dev)
    _check(lay.meta, "meta", torch.int32, lay.meta.shape, dev)
    if not (0 <= t0 and T >= 1 and t0 + T < 2 ** 31 and c < 2 ** 31):
        raise ValueError("vplus_sample: chunk or chunk index out of range")
    x = torch.empty((S, B, T, c), dtype=tab.dtype, device=dev)
    gidx = torch.empty((S, B, T, c), dtype=torch.int32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, "mci_vplus_sample" + f64)(
            *_sample_args(lay, tab, kd, t0, T, cube, x, gidx), stream)
    _build.check(lib, err, "vplus_sample" + f64)
    _count("vplus_sample", f64)
    return x, gidx


# ---------------------------------------------------------------------------
# vplus_reduce
# ---------------------------------------------------------------------------

def _density(lay: VplusLayout, tab, gidx, cube, cfac):
    """``(jac, denom, pads)`` of every sample ``[B, T, c]``, in the kernels'
    order and ``tab``'s dtype (``dens`` takes the float32 ``cfac``):
    ``1/dens``, the map density ``prob (* pass)`` and each integrand's
    padding factor ``pad_i``."""
    dev = gidx.device
    g = gidx.long()
    cont = [k for k in range(lay.S) if lay.slots[k, 0] == 0]
    disc = [k for k in range(lay.S) if lay.slots[k, 0] == 1]
    rho = [_slot_rho(lay, tab, k, g[k]) for k in range(lay.S)]
    prob = rho[cont[0]]
    for k in cont[1:]:
        prob = prob * rho[k]                                   # [B, T, c]
    dens = cfac[cube.long()] * prob
    denom = prob
    if disc:
        pp = rho[disc[0]]
        for k in disc[1:]:
            pp = pp * rho[k]
        dens, denom = dens * pp, prob * pp
    jac = 1.0 / dens
    gprob = []
    for members in lay.pair_slots.tolist():
        gp = None
        for k in members:
            if k >= 0:
                gp = rho[k] if gp is None else gp * rho[k]
        gprob.append(gp)
    pads = []
    for i in range(lay.spec.N):
        pad_i = torch.ones((), dtype=torch.float32, device=dev)
        for q, on in enumerate(lay.pad[i]):
            if on:
                pad_i = pad_i * gprob[q]
        pads.append(pad_i)
    return jac, denom, pads


def vplus_relw_plain(lay: VplusLayout, tab, w, gidx, cube, cfac):
    """Plain torch version of ``vplus_relw`` (``csrc/vplus_reduce.cu``):
    ``w_i * (jac * pad_i)``, each part of a complex weight scaled alone,
    of ``w`` through the non-finite guard."""
    w = finite_guard(w)
    jac, _, pads = _density(lay, tab, gidx, cube, cfac)
    return torch.stack([weight_scale(w[i], jac * pads[i]) for i in range(w.shape[0])])


def gate_shifts(kd, t0: int, T: int, c: int):
    """``[B, T]`` int32: the gate's cyclic shift of chunks ``t0..t0+T-1`` of
    every block, uniform in ``[0, c)``: a draw of the counter hash keyed by
    the block seeds ``kd [B, 2]`` (int32 bits) and the chunk, at flat index
    0 with the salt ``SALT_GATE``."""
    t = torch.arange(t0, t0 + T, dtype=torch.int64, device=kd.device)
    k1, k2 = chunk_keys((kd.long() & MASK32)[:, None, :], t[None, :])
    return (draw(k1, k2, torch.zeros_like(k1), SALT_GATE) % c).to(torch.int32)


def measured_mask(T: int, c: int, mf: int, t0: int, device, shift=None):
    """Which samples of chunks ``t0..t0+T-1`` the gate of ``measurefreq =
    mf`` measures: ``[T, c]`` bool by their position ``s`` (the reference's
    gate), or ``[B, T, c]`` with the shifts ``shift [B, T]`` (see module
    docstring)."""
    s = torch.arange(c, dtype=torch.int64, device=device)
    if shift is not None:
        s = (s + shift.long()[..., None]) % c
    t = torch.arange(t0, t0 + T, dtype=torch.int64, device=device)[:, None]
    return (t * c + s + 1) % mf == 0


def vplus_reduce_plain(lay: VplusLayout, tab, w, gidx, cube, cfac, m=None, mf=1, t0=0,
                       shift=None):
    """Plain torch version of ``csrc/vplus_reduce.cu``: the same products
    (in ``tab``'s dtype; a complex relw's |relw| in float32), summed in
    float64 in another order (a sample the gate shuts adds a zero), of
    ``w`` through the non-finite guard."""
    w = finite_guard(w)
    N, B, T, c = w.shape
    dev = w.device
    g = gidx.long()
    jac, denom, pads = _density(lay, tab, gidx, cube, cfac)
    gate = measured_mask(T, c, mf, t0, dev, shift) if mf > 1 else None

    def sums(v):
        v = v.double()
        if gate is not None:
            v = torch.where(gate, v, torch.zeros((), dtype=v.dtype, device=dev))
        return v.sum(dim=-1)

    obs, sq = [], []
    score = torch.zeros((B, T, c), dtype=jac.dtype, device=dev)
    for i in range(N):
        relw = weight_scale(w[i], jac * pads[i])
        score = score + weight_abs(w[i]) * pads[i]
        if m is None:                # complex: Re and Im of integrand i in 2i, 2i+1
            obs += [sums(p) for p in weight_parts(relw)]
        a = torch.clamp(weight_abs(relw), max=CLIP)
        sq.append((a * a).double())
    if m is not None:
        obs = [sums(mk) for mk in m]
    wj = torch.clamp(score / denom, max=CLIP)
    sig = torch.zeros(cfac.shape[0], dtype=torch.float64, device=dev)
    sig.index_add_(0, cube.long(), (wj * wj).double().sum(dim=(0, 1)))
    hist = torch.zeros(max(lay.nhist, 1), dtype=torch.float64, device=dev)
    for k in range(lay.S):
        feeds = [i for i in range(N) if lay.used[k, i]]
        off = int(lay.slots[k, 6])
        if off < 0 or not feeds:
            continue
        h = sq[feeds[0]]
        for i in feeds[1:]:
            h = h + sq[i]
        hist.index_add_(0, (g[k] + off).reshape(-1), h.reshape(-1))
    return torch.stack(obs, dim=-1), sig, hist


def _reduce_outputs(lay: VplusLayout, w, cfac, ncomp=None):
    """The kernel's outputs: per-warp partial sums ``obs_rows [B, T, R,
    ncomp]`` (written whole; ``ncomp`` is N, or 2N for complex ``w``, unless
    given), and zeroed ``sig [ncubes]`` and ``hist [H]``."""
    N, B, T, c = w.shape
    if ncomp is None:
        ncomp = 2 * N if w.is_complex() else N
    rows = -(-c // SPAN) * WARPS
    f64 = dict(dtype=torch.float64, device=w.device)
    return (torch.empty((B, T, rows, ncomp), **f64), torch.zeros(cfac.shape[0], **f64),
            torch.zeros(max(lay.nhist, 1), **f64))


def _reduce_args(lay: VplusLayout, tab, w, gidx, cube, cfac, obs_rows, sig, hist, m=None,
                 mf=1, t0=0, shift=None):
    """The argument list of ``mci_vplus_reduce`` (without the stream); a
    null pointer is 0."""
    N, B, T, c = w.shape
    P, M = lay.pair_slots.shape
    ptr = lambda t: 0 if t is None else t.data_ptr()
    return (w.data_ptr(), gidx.data_ptr(), cube.data_ptr(), cfac.data_ptr(), tab.data_ptr(),
            lay.meta.data_ptr(), N, lay.S, P, M, B * T, c, cfac.shape[0], lay.nhist,
            int(lay.nhist <= SMEM_HIST_BINS), SPAN, WARPS, ptr(m), obs_rows.shape[-1], mf, t0,
            T, ptr(shift), obs_rows.data_ptr(), sig.data_ptr(), hist.data_ptr())


def _check_inputs(name, lay: VplusLayout, tab, w, gidx, cube, cfac) -> str:
    """Raise unless the inputs are what the kernel reads; returns the entry
    points' suffix (``_suffix``)."""
    dev = w.device
    N, B, T, c = w.shape
    f64 = _suffix(tab, name)
    _check(w, "w", torch.complex64 if w.is_complex() else tab.dtype, (N, B, T, c), dev)
    _check(gidx, "gidx", torch.int32, (lay.S, B, T, c), dev)
    _check(cube, "cube", torch.int32, (c,), dev)
    _check(cfac, "cfac", torch.float32, (cfac.shape[0],), dev)
    _check(tab, "tab", lay.spec.dtype, (lay.tab_size,), dev)
    _check(lay.meta, "meta", torch.int32, lay.meta.shape, dev)
    if N != lay.spec.N:
        raise ValueError(f"{name}: {N} integrands, expected {lay.spec.N}")
    return f64


def vplus_reduce(lay: VplusLayout, tab, w, gidx, cube, cfac, m=None, mf=1, t0=0, shift=None):
    """Observable sums, per-cube second moments and training histograms of
    one launch (see module docstring)."""
    dev = _device_of(w, "vplus_reduce")
    if mf < 1 or t0 < 0:
        raise ValueError(f"vplus_reduce: measurefreq {mf} < 1 or first chunk {t0} < 0")
    if dev.type == "cpu":
        return vplus_reduce_plain(lay, tab, w, gidx, cube, cfac, m, mf, t0, shift)
    f64 = _check_inputs("vplus_reduce", lay, tab, w, gidx, cube, cfac)
    N, B, T, c = w.shape
    if shift is not None:
        _check(shift, "shift", torch.int32, (B, T), dev)
    ncomp = None
    if m is not None:
        ncomp = m.shape[0]
        _check(m, "m", torch.float32 if w.is_complex() else tab.dtype, (ncomp, B, T, c), dev)
        if ncomp < 1:
            raise ValueError("vplus_reduce: a measure with no components")
    if t0 + T >= 2 ** 31:
        raise ValueError("vplus_reduce: chunk index too large")
    cplx = w.is_complex()
    obs_rows, sig, hist = _reduce_outputs(lay, w, cfac, ncomp)
    lib = _build.load()
    entry = getattr(lib, ("mci_vplus_reduce_complex" if cplx else "mci_vplus_reduce") + f64)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = entry(*_reduce_args(lay, tab, w, gidx, cube, cfac, obs_rows, sig, hist, m, mf, t0,
                                  shift), stream)
    _build.check(lib, err, "vplus_reduce" + f64)
    key = "vplus_reduce_complex" if cplx else "vplus_reduce" if m is None else \
        "vplus_reduce_measure"
    _count(key, f64)
    # the kernel writes one partial per warp; this sum over the partials is
    # the first step of the fixed-order float64 reduction of the observables
    return _build.tree_sum(obs_rows, 2), sig, hist


def _relw_args(lay: VplusLayout, tab, w, gidx, cube, cfac, relw):
    """The argument list of ``mci_vplus_relw`` (without the stream)."""
    N, B, T, c = w.shape
    P, M = lay.pair_slots.shape
    return (w.data_ptr(), gidx.data_ptr(), cube.data_ptr(), cfac.data_ptr(), tab.data_ptr(),
            lay.meta.data_ptr(), N, lay.S, P, M, B * T, c, RELW_SPAN, RELW_WARPS,
            relw.data_ptr())


def vplus_relw(lay: VplusLayout, tab, w, gidx, cube, cfac):
    """The relative weights ``relw_i = w_i * (jac * pad_i)`` of every sample
    of one launch, for a custom measure (see module docstring)."""
    dev = _device_of(w, "vplus_relw")
    if dev.type == "cpu":
        return vplus_relw_plain(lay, tab, w, gidx, cube, cfac)
    f64 = _check_inputs("vplus_relw", lay, tab, w, gidx, cube, cfac)
    relw = torch.empty_like(w)
    lib = _build.load()
    entry = getattr(lib, ("mci_vplus_relw_complex" if w.is_complex() else "mci_vplus_relw") +
                    f64)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = entry(*_relw_args(lay, tab, w, gidx, cube, cfac, relw), stream)
    _build.check(lib, err, "vplus_relw" + f64)
    _count("vplus_relw", f64)
    return relw
