"""Wrappers of the two CUDA kernels of the :vegas solver, with their plain
PyTorch versions.

Together they replace ``mcintegration_tpu/ops/pallas_vegas.py:build_run_all``
(kernel K1) as a split path: ``vegas_sample`` draws the samples, the user
integrand runs as torch ops on them, and ``vegas_reduce`` forms the
observable sums and the training histogram.  With a custom measure (K1's
branch, ``pallas_vegas.py:488-503``), ``vegas_relw`` (the second entry
point of ``csrc/vegas_reduce.cu``) forms the relative weights between the
integrand and the measure, and ``vegas_reduce`` sums the measure's output
``m`` in place of the weighted integrands.  The reference's XLA route
(``mcintegration_tpu/solvers/vegas.py:201-357``) also serves complex
weights and ``measurefreq > 1``, which K1 never does: ``vegas_reduce`` and
``vegas_relw`` take complex64 ``w`` (the ``_complex`` entry points of
``csrc/vegas_reduce.cu``), and ``vegas_reduce`` a measurement gate.

Discrete pools and pools of different ninc take the mixed route, the
reference's XLA route again: ``vegas_sample_mixed``, ``vegas_relw_mixed``
and ``vegas_reduce_mixed`` (``csrc/vegas_mixed.cu``), at the end of this
module with their notes.

Each wrapper takes its plain version only for tensors on the CPU.  For CUDA
tensors it launches its kernel (``csrc/*.cu``, built by ``ops/_build.py``)
or raises; there is no fallback.  ``launch_counts`` counts the kernel
launches of each wrapper, so a run can show that it went through them.

Shapes (``S`` = slots, ``B`` = blocks, ``T`` = chunks of this launch,
``nb`` = strata, ``m`` = samples per stratum, ``N`` = integrands):

- ``vegas_sample(kd [B,2] i64, t0, T, atab [S,64] i32, grid/inc [L,nb] f32,
  slot_leaf [S] i32, m) -> x [S,B,T,nb,m] f32, invp [S,B,T,nb] f32,
  perm [S,B,T,nb] i32``;
- ``vegas_relw(w [N,B,T,nb,m] f32 or c64, invp, pad, pair_slots) -> relw
  [N,B,T,nb,m]`` of ``w``'s dtype;
- ``vegas_reduce(w [N,B,T,nb,m] f32 or c64, invp, perm, pad [N,P] i32,
  pair_slots [P,M] i32, used [S,N] i32, m=None, mf=1, t0=0) -> obs
  [B,T,ncomp] f64, hrow [S,B,T,nb] f64``: ``ncomp = N``, or ``2N`` for
  complex ``w`` (Re and Im of integrand ``i`` in components ``2i``,
  ``2i+1``); given ``m [ncomp,B,T,nb,m] f32``, the sums of ``m``.

With ``mf > 1`` (``measurefreq``) sample ``j`` of stratum row ``p`` of
chunk ``t`` (``t0`` plus its index in the launch) counts in ``obs`` only if
``(t*nb*m + p*m + j + 1) % mf == 0``, the reference's gate
(``solvers/vegas.py:327-335``, ``montecarlo.jl:148``); every sample feeds
the histogram.

``kd`` holds uint32 seeds in int64.  ``pad[i, g]`` says whether the
(group, slot) pair ``g`` enters integrand ``i``'s padding factor;
``pair_slots[g]`` lists the kernel slots of the pair's leaves (``-1``
padded); ``used[k, i]`` says whether integrand ``i``'s weight feeds slot
``k``'s histogram.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List

import numpy as np
import torch

from ..common import weight_abs, weight_parts, weight_scale
from ..models.variable import Discrete
from . import _build
from ._build import check_tensor as _check
from .grid import sample_continuous, sample_discrete
from .rng import MASK32, chunk_keys, draw
from .vplus_kernels import _device_of, leaf_values, pack_meta, slot_tables

N_MULT = 64          # multiplier-table width (solvers/vegas.py)
HIST_CLIP = 1e17     # histogram weight clip (pallas_vegas.py:507)
MAX_INTEGRANDS = 2048  # shared-memory bound of vegas_reduce
MAX_STRATA = 32768     # int32 guard of (a*p + s) mod nb, which stays below 2^30

# "vegas_reduce_measure" counts the launches of vegas_reduce given m, the
# "_complex" keys those of the complex instantiations (given m or not);
# "vegas_reduce_mixed" counts every instantiation of the mixed route's
# reduce (real or complex, given m or not, gated or not), "vegas_relw_mixed"
# both of its own
launch_counts = {"vegas_sample": 0, "vegas_reduce": 0, "vegas_relw": 0,
                 "vegas_reduce_measure": 0, "vegas_reduce_complex": 0,
                 "vegas_relw_complex": 0, "vegas_sample_mixed": 0,
                 "vegas_reduce_mixed": 0, "vegas_relw_mixed": 0}


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# vegas_sample
# ---------------------------------------------------------------------------

def vegas_sample_plain(kd, t0: int, T: int, atab, grid, inc, slot_leaf, m: int):
    """Plain torch version of ``csrc/vegas_sample.cu`` (same bits)."""
    dev = kd.device
    nslots, B, nb = atab.shape[0], kd.shape[0], grid.shape[1]
    t = torch.arange(t0, t0 + T, dtype=torch.int64, device=dev)
    k1, k2 = chunk_keys(kd[:, None, :], t[None, :])                # [B,T]
    p = torch.arange(nb, dtype=torch.int64, device=dev)
    idx = p[:, None] * m + torch.arange(m, dtype=torch.int64, device=dev)
    zero = torch.zeros_like(k1)
    x = torch.empty((nslots, B, T, nb, m), dtype=torch.float32, device=dev)
    invp = torch.empty((nslots, B, T, nb), dtype=torch.float32, device=dev)
    perm = torch.empty((nslots, B, T, nb), dtype=torch.int32, device=dev)
    for k in range(nslots):
        s = (draw(k1, k2, zero, 3 * k + 1) & 0x7FFFFFFF) % nb
        j = (draw(k1, k2, zero, 3 * k + 2) & 0x7FFFFFFF) % N_MULT
        a = atab[k].long()[j]
        pk = (a[..., None] * p + s[..., None]) % nb                  # [B,T,nb]
        leaf = int(slot_leaf[k])
        g, dx = grid[leaf][pk], inc[leaf][pk]
        u = draw(k1[..., None, None], k2[..., None, None], idx, 3 * k + 3)
        dy = ((u & 0xFFFFFF).to(torch.float32) + 0.5) * 2.0 ** -24
        x[k] = g[..., None] + dy * dx[..., None]
        invp[k] = dx * nb
        perm[k] = pk.to(torch.int32)
    return x, invp, perm


def vegas_sample(kd, t0: int, T: int, atab, grid, inc, slot_leaf, m: int):
    """Stratified draw through the Vegas maps (see module docstring)."""
    nb = grid.shape[-1]
    if not 1 <= nb <= MAX_STRATA:
        raise ValueError(f"vegas_sample: {nb} strata outside [1, {MAX_STRATA}] "
                         "(int32 guard of (a*p + s) mod nb)")
    if kd.device.type == "cpu":
        return vegas_sample_plain(kd, t0, T, atab, grid, inc, slot_leaf, m)
    if kd.device.type != "cuda":
        raise ValueError(f"vegas_sample: unsupported device {kd.device}")
    dev = kd.device
    nslots, B = atab.shape[0], kd.shape[0]
    nleaf, nb = grid.shape
    _check(kd, "kd", torch.int64, (B, 2), dev)
    _check(atab, "atab", torch.int32, (nslots, N_MULT), dev)
    _check(grid, "grid", torch.float32, (nleaf, nb), dev)
    _check(inc, "inc", torch.float32, (nleaf, nb), dev)
    _check(slot_leaf, "slot_leaf", torch.int32, (nslots,), dev)
    # the kernel's flat indices: a quad's below 2^30 (m % 4 == 0), else a
    # draw's below 2^31, and the (slot, block, chunk) group's below 2^31
    if (nb * m >= 2 ** (32 if m % 4 == 0 else 31) or t0 + T >= 2 ** 31
            or nslots * B * T >= 2 ** 31):
        raise ValueError("vegas_sample: chunk or chunk index too large")
    kd32 = torch.where(kd >= 2 ** 31, kd - 2 ** 32, kd).to(torch.int32)
    x = torch.empty((nslots, B, T, nb, m), dtype=torch.float32, device=dev)
    invp = torch.empty((nslots, B, T, nb), dtype=torch.float32, device=dev)
    perm = torch.empty((nslots, B, T, nb), dtype=torch.int32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mci_vegas_sample(
            kd32.data_ptr(), t0, B, T, nb, m, nslots, atab.data_ptr(),
            grid.data_ptr(), inc.data_ptr(), slot_leaf.data_ptr(),
            x.data_ptr(), invp.data_ptr(), perm.data_ptr(), stream)
    _build.check(lib, err, "vegas_sample")
    launch_counts["vegas_sample"] += 1
    return x, invp, perm


# ---------------------------------------------------------------------------
# vegas_reduce
# ---------------------------------------------------------------------------

def _row_factors(invp, pad, pair_slots):
    """``(jac [B,T,nb], [factor_i [B,T,nb]])``: the jacobian and each
    integrand's padding-weighted factor, in the kernels' float32 order."""
    nslots = invp.shape[0]
    jac = invp[0]
    for k in range(1, nslots):
        jac = jac * invp[k]
    gprob = []
    for members in pair_slots.tolist():
        gp = None
        for k in members:
            if k < 0:
                break
            q = 1.0 / invp[k]
            gp = q if gp is None else gp * q
        gprob.append(gp)
    factors = []
    for row in pad.tolist():
        f = jac
        for g, on in enumerate(row):
            if on:
                f = f * gprob[g]
        factors.append(f)
    return jac, factors


def vegas_relw_plain(w, invp, pad, pair_slots):
    """Plain torch version of ``vegas_relw`` (``csrc/vegas_reduce.cu``): the
    same float32 products, each part of a complex weight scaled alone."""
    _, factors = _row_factors(invp, pad, pair_slots)
    return torch.stack([weight_scale(w[i], f[..., None]) for i, f in enumerate(factors)])


def vegas_relw(w, invp, pad, pair_slots):
    """Per-sample relative weights ``relw_i = w_i * factor_i`` (see module
    docstring)."""
    if w.device.type == "cpu":
        return vegas_relw_plain(w, invp, pad, pair_slots)
    if w.device.type != "cuda":
        raise ValueError(f"vegas_relw: unsupported device {w.device}")
    dev = w.device
    N, B, T, nb, m = w.shape
    nslots = invp.shape[0]
    npair, maxmem = pair_slots.shape
    cplx = w.dtype == torch.complex64
    _check(w, "w", torch.complex64 if cplx else torch.float32, (N, B, T, nb, m), dev)
    _check(invp, "invp", torch.float32, (nslots, B, T, nb), dev)
    _check(pad, "pad", torch.int32, (N, npair), dev)
    _check(pair_slots, "pair_slots", torch.int32, (npair, maxmem), dev)
    if N > MAX_INTEGRANDS:
        raise ValueError(f"vegas_relw: {N} integrands > {MAX_INTEGRANDS}")
    relw = torch.empty_like(w)
    name = "vegas_relw_complex" if cplx else "vegas_relw"
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, "mci_" + name)(w.data_ptr(), invp.data_ptr(), pad.data_ptr(),
                                          pair_slots.data_ptr(), N, nslots, npair, maxmem,
                                          B * T * nb, m, relw.data_ptr(), stream)
    _build.check(lib, err, name)
    launch_counts[name] += 1
    return relw


def measured_mask(T: int, nb: int, m: int, mf: int, t0: int, device):
    """``[T, nb, m]`` bool: which samples of chunks ``t0..t0+T-1`` the gate
    of ``measurefreq = mf`` measures, by their index ``t*nb*m + p*m + j + 1``
    in the block (see module docstring)."""
    e = torch.arange(t0 * nb * m + 1, (t0 + T) * nb * m + 1, dtype=torch.int64, device=device)
    return (e % mf == 0).reshape(T, nb, m)


def vegas_reduce_plain(w, invp, perm, pad, pair_slots, used, m=None, mf=1, t0=0):
    """Plain torch version of ``csrc/vegas_reduce.cu``: the same float32
    products, summed in float64 in another order (a sample the gate shuts
    adds a zero)."""
    N, nslots = w.shape[0], invp.shape[0]
    used = used.tolist()
    jac, factors = _row_factors(invp, pad, pair_slots)
    gate = None
    if mf > 1:
        _, _, T, nb, ms = w.shape
        gate = measured_mask(T, nb, ms, mf, t0, w.device)

    def sums(v):
        v = v.double()
        if gate is not None:
            v = torch.where(gate, v, torch.zeros((), dtype=v.dtype, device=v.device))
        return v.sum(dim=(-2, -1))

    whsum = []
    for i in range(N):
        a = torch.clamp(weight_abs(w[i]) * jac[..., None], max=HIST_CLIP)
        whsum.append((a * a).double().sum(dim=-1))
    if m is not None:
        obs = [sums(mk) for mk in m]
    else:                            # complex: Re and Im of integrand i in 2i, 2i+1
        obs = [sums(p) for i, f in enumerate(factors)
               for p in weight_parts(weight_scale(w[i], f[..., None]))]
    hrow = torch.empty(invp.shape, dtype=torch.float64, device=w.device)
    for k in range(nslots):
        h = torch.zeros(invp.shape[1:], dtype=torch.float64, device=w.device)
        for i in range(N):
            if used[k][i]:
                h = h + whsum[i]
        hrow[k].scatter_(-1, perm[k].long(), h)
    return torch.stack(obs, dim=-1), hrow


def vegas_reduce(w, invp, perm, pad, pair_slots, used, m=None, mf=1, t0=0, rows=False):
    """Observable sums and training histogram (see module docstring).  With
    ``rows`` the observables are the partial sums ``[B, T, R, ncomp]`` for
    the caller to reduce (the kernel's R = nb rows of a chunk; the plain
    version's one row, the chunk's sum), so that an iteration sums all its
    launches' rows in one pass."""
    if mf < 1 or t0 < 0:
        raise ValueError(f"vegas_reduce: measurefreq {mf} < 1 or first chunk {t0} < 0")
    if w.device.type == "cpu":
        obs, hrow = vegas_reduce_plain(w, invp, perm, pad, pair_slots, used, m, mf, t0)
        return (obs.unsqueeze(2) if rows else obs), hrow
    if w.device.type != "cuda":
        raise ValueError(f"vegas_reduce: unsupported device {w.device}")
    dev = w.device
    N, B, T, nb, ms = w.shape
    nslots = invp.shape[0]
    npair, maxmem = pair_slots.shape
    cplx = w.dtype == torch.complex64
    _check(w, "w", torch.complex64 if cplx else torch.float32, (N, B, T, nb, ms), dev)
    _check(invp, "invp", torch.float32, (nslots, B, T, nb), dev)
    _check(perm, "perm", torch.int32, (nslots, B, T, nb), dev)
    _check(pad, "pad", torch.int32, (N, npair), dev)
    _check(pair_slots, "pair_slots", torch.int32, (npair, maxmem), dev)
    _check(used, "used", torch.int32, (nslots, N), dev)
    if N > MAX_INTEGRANDS:
        raise ValueError(f"vegas_reduce: {N} integrands > {MAX_INTEGRANDS}")
    if t0 + T >= 2 ** 31:
        raise ValueError("vegas_reduce: chunk index too large")
    ncomp = 2 * N if cplx else N
    if m is not None:
        ncomp = m.shape[0]
        _check(m, "m", torch.float32, (ncomp, B, T, nb, ms), dev)
        if ncomp < 1:
            raise ValueError("vegas_reduce: a measure with no components")
    R = B * T * nb
    obs_rows = torch.empty((B, T, nb, ncomp), dtype=torch.float64, device=dev)
    hrow = torch.empty((nslots, B, T, nb), dtype=torch.float64, device=dev)
    lib = _build.load()
    entry = lib.mci_vegas_reduce_complex if cplx else lib.mci_vegas_reduce
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = entry(
            w.data_ptr(), invp.data_ptr(), perm.data_ptr(), pad.data_ptr(),
            pair_slots.data_ptr(), used.data_ptr(), N, nslots, npair, maxmem,
            R, nb, ms, None if m is None else m.data_ptr(), ncomp, mf, t0, T,
            obs_rows.data_ptr(), hrow.data_ptr(), stream)
    _build.check(lib, err, "vegas_reduce")
    key = "vegas_reduce_complex" if cplx else "vegas_reduce" if m is None else \
        "vegas_reduce_measure"
    launch_counts[key] += 1
    # the kernel writes one partial per stratum row; this sum over the rows
    # is the first step of the fixed-order float64 reduction
    return (obs_rows if rows else _build.tree_sum(obs_rows, 2)), hrow


# ---------------------------------------------------------------------------
# The mixed route: Discrete pools and pools of different ninc
# ---------------------------------------------------------------------------
#
# The reference's XLA route (mcintegration_tpu/solvers/vegas.py:82-127,
# 218-262, 292-356) stratifies a drawn Continuous pool whose ninc divides
# the chunk c on its own nb = ninc strata, m_k = c // nb samples a stratum,
# and draws every other drawn pool per sample through its map: a Discrete
# pool, or a Continuous pool whose ninc does not divide c.  K1 serves
# neither (pallas_vegas.py:323-328).  ``csrc/vegas_mixed.cu`` serves them
# in three entry points, each with its plain version below:
#
# - ``vegas_sample_mixed(lay, tab, kd [B,2] i32, t0, T) -> x [S,B,T,c] f32
#   (int32 bits for a Discrete slot), gidx [S,B,T,c] i32``.  Sample q of a
#   chunk in a stratified slot k lies in stratum row p = q // m_k, drawn as
#   in ``vegas_sample`` (the salts 3k+1, 3k+2, 3k+3, the row's permuted
#   stratum pk = (a*p + s) mod nb, x = grid[pk] + dy*inc[pk]), and its
#   gidx is pk; so a spec that ``vegas_sample`` serves gives the same x bit
#   for bit.  A per-sample slot draws its map (``ops/grid.py``) at the
#   uniform ((bits & 0xFFFFFF) + 0.5) * 2^-24 of the same salt 3k+3 and
#   index q, and gidx is the map bin it hits.
# - ``vegas_relw_mixed(lay, tab, w [N,B,T,c], gidx) -> relw [N,B,T,c]``:
#   w_i * factor_i, what a custom measure reads.
# - ``vegas_reduce_mixed(lay, tab, w, gidx, m=None, mf=1, t0=0) -> obs
#   [B,T,ncomp] f64, hist [S,nbmax] f64``: the observable sums (as
#   ``vegas_reduce``'s, over the samples of a chunk) and each slot's
#   histogram at its nb bins (zero beyond them, and for a slot that feeds
#   none), a scatter by gidx of sum over the integrands that use the slot of
#   min(|w_i| * jac, 1e17)^2.
#
# Per sample the density comes from the tables at gidx: invp_k = nb *
# inc[g] for a Continuous slot (the product ``vegas_sample`` writes, so a
# stratified slot gives its bits) and 1 / dist[g] for a Discrete one; jac
# and factor_i are formed from the invp_k as ``_row_factors`` forms them.
# With mf > 1 sample q of chunk t counts in obs only if (t*c + q + 1) % mf
# == 0 (``mcintegration_tpu/solvers/vegas.py:327-335``).

MIXED_FIELDS = 7         # kind, nb, tab_off, sm_off, lower, m_k, hist_off
KIND_MAP, KIND_DISC, KIND_STRAT = 0, 1, 2   # per-sample Continuous, Discrete, stratified
SMEM_CDF_BINS = 1024     # a Discrete CDF of at most this many bins is staged in shared memory
SMEM_CDF_FLOATS = 8192   # the staged CDFs of a spec together: 32 KiB
PER_THREAD = 4           # consecutive samples of a chunk per thread of vegas_reduce_mixed
SPAN = 1024              # samples of a chunk per thread block of vegas_reduce_mixed:
                         # 256 threads x PER_THREAD
WARPS = 8                # warps per thread block of vegas_reduce_mixed
SMEM_HIST_BINS = 4096    # 32 KiB of float64 histogram per thread block; a larger
                         # one is added in windows of this many bins


@dataclasses.dataclass
class MixedLayout:
    """The static shape of a spec as the mixed-route kernels read it.

    Kernel slots are the (leaf, slot) pairs of the drawn leaves in leaf
    order, slot-minor.  Per slot ``k`` a row of ``slots``: ``kind``
    (``KIND_MAP``, ``KIND_DISC`` or ``KIND_STRAT``), ``nb`` (strata, ninc or
    nbin), ``tab_off`` (its leaf's table in the float32 ``tab``: grid then
    inc, or cdf [nb+1] then dist), ``sm_off`` (its CDF's offset in shared
    memory, or -1), ``lower`` (a Discrete leaf's), ``m_k`` (samples per
    stratum, 0 unless stratified) and ``hist_off`` (its bins in the compact
    histogram, -1 if it feeds none: a leaf that does not adapt, or a slot no
    integrand uses).  ``atab [S, N_MULT]`` holds a stratified slot's
    multipliers (zeros for the others); ``pad [N, P]``, ``pair_slots [P,
    M]`` and ``used [S, N]`` are ``vplus_kernels.slot_tables``'.
    """

    spec: Any
    chunk: int
    slots: np.ndarray        # [S, MIXED_FIELDS] int32
    atab: torch.Tensor       # [S, N_MULT] int32 on the device
    pad: np.ndarray          # [N, P] int32
    pair_slots: np.ndarray   # [P, M] int32
    used: np.ndarray         # [S, N] int32
    dleaf: List[int]         # spec leaves with drawn slots
    tab_size: int
    smem_floats: int         # staged CDF floats
    nhist: int               # bins of the compact histogram
    nbmax: int
    hist_index: torch.Tensor  # [nhist] int64: each compact bin's place in [S, nbmax]
    meta: torch.Tensor       # slots, pad, pair_slots, used: int32 on the device

    @property
    def S(self) -> int:
        return self.slots.shape[0]

    @staticmethod
    def build(spec, chunk: int, atabs) -> "MixedLayout":
        """The layout at chunk ``chunk``; ``atabs`` maps each stratified
        leaf to its multipliers ``[ndraw, N_MULT]`` (the leaves it names
        stratify, the others draw per sample)."""
        rows, kslot, arows = [], {}, []
        tab_off = sm_off = 0
        dleaf = [i for i, li in enumerate(spec.leaves) if li.ndraw > 0]
        for lidx in dleaf:
            li = spec.leaves[lidx]
            disc = isinstance(li.leaf, Discrete)
            nb = li.leaf.nbin if disc else li.leaf.ninc
            sm = -1
            if disc and nb <= SMEM_CDF_BINS and sm_off + nb <= SMEM_CDF_FLOATS:
                sm, sm_off = sm_off, sm_off + nb
            strat = lidx in atabs
            kind = KIND_DISC if disc else KIND_STRAT if strat else KIND_MAP
            for s in range(li.ndraw):
                kslot[(lidx, s)] = len(rows)
                rows.append([kind, nb, tab_off, sm, li.leaf.lower if disc else 0,
                             chunk // nb if strat else 0, -1])
                arows.append(atabs[lidx][s] if strat else np.zeros(N_MULT, np.int32))
            tab_off += 2 * nb + 1 if disc else 2 * nb
        slots = np.asarray(rows, np.int32).reshape(-1, MIXED_FIELDS)
        pad, pair_slots, used = slot_tables(spec, kslot)
        nbmax = int(slots[:, 1].max())
        h_off, index = 0, []
        for k in range(len(rows)):
            if used[k].any():
                slots[k, 6], h_off = h_off, h_off + int(slots[k, 1])
                index.append(k * nbmax + np.arange(slots[k, 1]))
        dev = spec.device
        return MixedLayout(
            spec=spec, chunk=chunk, slots=slots,
            atab=torch.as_tensor(np.asarray(arows, np.int32).reshape(-1, N_MULT), device=dev),
            pad=pad, pair_slots=pair_slots, used=used, dleaf=dleaf, tab_size=tab_off,
            smem_floats=sm_off, nhist=h_off, nbmax=nbmax,
            hist_index=torch.as_tensor(np.concatenate(index) if index else
                                       np.zeros(0, np.int64), device=dev),
            meta=pack_meta(dev, slots, pad, pair_slots, used))

    def tables(self, params) -> torch.Tensor:
        """The float32 map tables ``tab`` of this iteration's ``params``:
        per drawn leaf its (grid, inc), or (cdf, dist)."""
        return torch.cat([t.reshape(-1).to(torch.float32) for lidx in self.dleaf
                          for t in params["leaf"][lidx]]).contiguous()

    def leaf_values(self, x: torch.Tensor):
        """Per spec leaf, its rows of ``x`` (``vplus_kernels.leaf_values``)."""
        return leaf_values(self.spec, x)

    def padded_hist(self, hist: torch.Tensor) -> torch.Tensor:
        """The compact histogram ``[nhist]`` as ``[S, nbmax]``."""
        out = torch.zeros(self.S * self.nbmax, dtype=torch.float64, device=hist.device)
        out[self.hist_index] = hist[:self.nhist]
        return out.reshape(self.S, self.nbmax)


def _slot_table(lay: MixedLayout, tab, k: int):
    """Slot ``k``'s two tables: (grid, inc) or (cdf, dist)."""
    kind, nb, off = (int(v) for v in lay.slots[k, :3])
    if kind == KIND_DISC:
        return tab[off:off + nb + 1], tab[off + nb + 1:off + 2 * nb + 1]
    return tab[off:off + nb], tab[off + nb:off + 2 * nb]


def vegas_sample_mixed_plain(lay: MixedLayout, tab, kd, t0: int, T: int):
    """Plain torch version of ``vegas_sample_mixed`` (same bits)."""
    dev = kd.device
    B, c, S = kd.shape[0], lay.chunk, lay.S
    t = torch.arange(t0, t0 + T, dtype=torch.int64, device=dev)
    k1, k2 = chunk_keys((kd.long() & MASK32)[:, None, :], t[None, :])      # [B, T]
    q = torch.arange(c, dtype=torch.int64, device=dev)
    zero = torch.zeros_like(k1)
    x = torch.empty((S, B, T, c), dtype=torch.float32, device=dev)
    gidx = torch.empty((S, B, T, c), dtype=torch.int32, device=dev)
    xbits = x.view(torch.int32)
    for k in range(S):
        kind, nb, _, _, lower, m, _ = (int(v) for v in lay.slots[k])
        a_tab, b_tab = _slot_table(lay, tab, k)
        bits = draw(k1[..., None], k2[..., None], q, 3 * k + 3)
        u = ((bits & 0xFFFFFF).to(torch.float32) + 0.5) * 2.0 ** -24
        if kind == KIND_STRAT:
            s = (draw(k1, k2, zero, 3 * k + 1) & 0x7FFFFFFF) % nb
            j = (draw(k1, k2, zero, 3 * k + 2) & 0x7FFFFFFF) % N_MULT
            a = lay.atab[k].long()[j]
            pk = (a[..., None] * (q // m) + s[..., None]) % nb                # [B, T, c]
            x[k] = a_tab[pk] + u * b_tab[pk]
            gidx[k] = pk.to(torch.int32)
        elif kind == KIND_DISC:
            g, _ = sample_discrete(u, a_tab, b_tab)
            xbits[k], gidx[k] = g + lower, g
        else:
            xk, g, _ = sample_continuous(u, a_tab, b_tab)
            x[k], gidx[k] = xk, g
    return x, gidx


def vegas_sample_mixed(lay: MixedLayout, tab, kd, t0: int, T: int):
    """Chunks ``[t0, t0+T)`` of every block through the mixed route's plan
    (see the section's notes)."""
    dev = _device_of(kd, "vegas_sample_mixed")
    strat = lay.slots[:, 0] == KIND_STRAT
    if strat.any() and int(lay.slots[strat, 1].max()) > MAX_STRATA:
        raise ValueError(f"vegas_sample_mixed: more than {MAX_STRATA} strata "
                         "(int32 guard of (a*p + s) mod nb)")
    if dev.type == "cpu":
        return vegas_sample_mixed_plain(lay, tab, kd, t0, T)
    B, c, S = kd.shape[0], lay.chunk, lay.S
    _check(kd, "kd", torch.int32, (B, 2), dev)
    _check(tab, "tab", torch.float32, (lay.tab_size,), dev)
    _check(lay.atab, "atab", torch.int32, (S, N_MULT), dev)
    _check(lay.meta, "meta", torch.int32, lay.meta.shape, dev)
    if not (0 <= t0 and T >= 1 and t0 + T < 2 ** 31 and c < 2 ** 31 and B * T < 2 ** 31):
        raise ValueError("vegas_sample_mixed: chunk or chunk index out of range")
    x = torch.empty((S, B, T, c), dtype=torch.float32, device=dev)
    gidx = torch.empty((S, B, T, c), dtype=torch.int32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mci_vegas_sample_mixed(kd.data_ptr(), t0, B, T, c, S, lay.meta.data_ptr(),
                                         lay.atab.data_ptr(), tab.data_ptr(), lay.smem_floats,
                                         x.data_ptr(), gidx.data_ptr(), stream)
    _build.check(lib, err, "vegas_sample_mixed")
    launch_counts["vegas_sample_mixed"] += 1
    return x, gidx


def _mixed_invp(lay: MixedLayout, tab, gidx):
    """``[S, B, T, c]`` float32: each slot's 1/probability at its bin,
    ``nb * inc[g]`` or ``1 / dist[g]``."""
    out = []
    for k in range(lay.S):
        nb = int(lay.slots[k, 1])
        _, b_tab = _slot_table(lay, tab, k)
        v = b_tab[gidx[k].long()]
        out.append(1.0 / v if lay.slots[k, 0] == KIND_DISC else v * nb)
    return torch.stack(out)


def vegas_relw_mixed_plain(lay: MixedLayout, tab, w, gidx):
    """Plain torch version of ``vegas_relw_mixed``: the same float32
    products, each part of a complex weight scaled alone."""
    _, factors = _row_factors(_mixed_invp(lay, tab, gidx), lay.pad, lay.pair_slots)
    return torch.stack([weight_scale(w[i], f) for i, f in enumerate(factors)])


def vegas_reduce_mixed_plain(lay: MixedLayout, tab, w, gidx, m=None, mf=1, t0=0):
    """Plain torch version of ``vegas_reduce_mixed``: the same float32
    terms, summed in float64 in another order (a sample the gate shuts adds
    a zero)."""
    N, B, T, c = w.shape
    dev = w.device
    jac, factors = _row_factors(_mixed_invp(lay, tab, gidx), lay.pad, lay.pair_slots)
    gate = measured_mask(T, c, 1, mf, t0, dev).reshape(T, c) if mf > 1 else None

    def sums(v):
        v = v.double()
        if gate is not None:
            v = torch.where(gate, v, torch.zeros((), dtype=v.dtype, device=dev))
        return v.sum(dim=-1)

    sq = []
    for i in range(N):
        a = torch.clamp(weight_abs(w[i]) * jac, max=HIST_CLIP)
        sq.append((a * a).double())
    if m is not None:
        obs = [sums(mk) for mk in m]
    else:                            # complex: Re and Im of integrand i in 2i, 2i+1
        obs = [sums(p) for i, f in enumerate(factors) for p in weight_parts(weight_scale(w[i], f))]
    hist = torch.zeros(max(lay.nhist, 1), dtype=torch.float64, device=dev)
    for k in range(lay.S):
        off = int(lay.slots[k, 6])
        if off < 0:
            continue
        feeds = [i for i in range(N) if lay.used[k, i]]
        h = sq[feeds[0]]
        for i in feeds[1:]:
            h = h + sq[i]
        hist.index_add_(0, (gidx[k].long() + off).reshape(-1), h.reshape(-1))
    return torch.stack(obs, dim=-1), lay.padded_hist(hist)


def sum_components(t, dim: int):
    """``t [ncomp, ...]`` summed over ``dim`` into ``[..., ncomp]`` in the
    fixed order of :func:`_build.tree_sum` (the real parts of a complex
    run's ``w + 0j`` sum as the real run's ``w``)."""
    return _build.tree_sum(t, dim).movedim(0, -1)


def _mixed_check(name, lay: MixedLayout, tab, w, gidx):
    """Raise unless the inputs are what the reduce kernel reads."""
    dev = w.device
    N, B, T, c = w.shape
    _check(w, "w", torch.complex64 if w.is_complex() else torch.float32, (N, B, T, c), dev)
    _check(gidx, "gidx", torch.int32, (lay.S, B, T, c), dev)
    _check(tab, "tab", torch.float32, (lay.tab_size,), dev)
    _check(lay.meta, "meta", torch.int32, lay.meta.shape, dev)
    if N != lay.spec.N or c != lay.chunk:
        raise ValueError(f"{name}: w is [{N}, ..., {c}], expected [{lay.spec.N}, ..., "
                         f"{lay.chunk}]")


def _mixed_outputs(lay: MixedLayout, w, ncomp: int):
    """The reduce kernel's outputs: per-warp partial sums ``obs_rows
    [ncomp, B, T, R]`` (written whole; a row per warp of the ``ceil(c /
    SPAN)`` blocks a chunk) and the zeroed compact histogram."""
    N, B, T, c = w.shape
    f64 = dict(dtype=torch.float64, device=w.device)
    return (torch.empty((ncomp, B, T, -(-c // SPAN) * WARPS), **f64),
            torch.zeros(max(lay.nhist, 1), **f64))


def _mixed_args(lay: MixedLayout, tab, w, gidx, obs_rows, hist, m=None, mf=1, t0=0):
    """The argument list of ``mci_vegas_reduce_mixed`` (without the
    stream); a null pointer is 0."""
    N, B, T, c = w.shape
    P, M = lay.pair_slots.shape
    return (w.data_ptr(), gidx.data_ptr(), tab.data_ptr(), lay.meta.data_ptr(), N, lay.S, P, M,
            B * T, c, lay.nhist, int(lay.nhist <= SMEM_HIST_BINS), SPAN, WARPS,
            0 if m is None else m.data_ptr(), obs_rows.shape[0], mf, t0, T,
            obs_rows.data_ptr(), hist.data_ptr())


def vegas_reduce_mixed(lay: MixedLayout, tab, w, gidx, m=None, mf=1, t0=0):
    """Observable sums and per-slot training histograms of one launch of
    the mixed route (see the section's notes)."""
    dev = _device_of(w, "vegas_reduce_mixed")
    if mf < 1 or t0 < 0:
        raise ValueError(f"vegas_reduce_mixed: measurefreq {mf} < 1 or first chunk {t0} < 0")
    if dev.type == "cpu":
        return vegas_reduce_mixed_plain(lay, tab, w, gidx, m, mf, t0)
    _mixed_check("vegas_reduce_mixed", lay, tab, w, gidx)
    N, B, T, c = w.shape
    cplx = w.is_complex()
    ncomp = 2 * N if cplx else N
    if m is not None:
        ncomp = m.shape[0]
        _check(m, "m", torch.float32, (ncomp, B, T, c), dev)
        if ncomp < 1:
            raise ValueError("vegas_reduce_mixed: a measure with no components")
    if t0 + T >= 2 ** 31:
        raise ValueError("vegas_reduce_mixed: chunk index too large")
    obs_rows, hist = _mixed_outputs(lay, w, ncomp)
    lib = _build.load()
    entry = lib.mci_vegas_reduce_mixed_complex if cplx else lib.mci_vegas_reduce_mixed
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = entry(*_mixed_args(lay, tab, w, gidx, obs_rows, hist, m, mf, t0), stream)
    _build.check(lib, err, "vegas_reduce_mixed")
    launch_counts["vegas_reduce_mixed"] += 1
    # the kernel writes one partial per warp; this sum over the partials is
    # the first step of the fixed-order float64 reduction of the observables
    return sum_components(obs_rows, -1), lay.padded_hist(hist)


def vegas_relw_mixed(lay: MixedLayout, tab, w, gidx):
    """The relative weights ``relw_i = w_i * factor_i`` of every sample of
    one launch of the mixed route, for a custom measure."""
    dev = _device_of(w, "vegas_relw_mixed")
    if dev.type == "cpu":
        return vegas_relw_mixed_plain(lay, tab, w, gidx)
    _mixed_check("vegas_relw_mixed", lay, tab, w, gidx)
    N, B, T, c = w.shape
    P, M = lay.pair_slots.shape
    relw = torch.empty_like(w)
    lib = _build.load()
    entry = lib.mci_vegas_relw_mixed_complex if w.is_complex() else lib.mci_vegas_relw_mixed
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = entry(w.data_ptr(), gidx.data_ptr(), tab.data_ptr(), lay.meta.data_ptr(), N,
                    lay.S, P, M, B * T, c, SPAN, WARPS, relw.data_ptr(), stream)
    _build.check(lib, err, "vegas_relw_mixed")
    launch_counts["vegas_relw_mixed"] += 1
    return relw

