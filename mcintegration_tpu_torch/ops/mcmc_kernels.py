"""Wrappers of the three CUDA kernels of the :mcmc solver, with their plain
PyTorch versions.

Together they replace ``mcintegration_tpu/ops/pallas_mcmc.py:
build_mcmc_run_all`` (kernel K3) as a split step: ``mcmc_propose`` draws
each walker's move for the step's scheduled sector, the user integrand of
that sector runs as torch ops on the proposed state, ``mcmc_accept`` takes
the Metropolis decision, commits, tallies and measures, and on measured
steps with a custom measure the user's measure of every sector runs as
torch ops and one ``mcmc_measure`` launch adds each walker's own sector's
output into its float64 accumulators.

The law is K3's scheduled single-sector law (``pallas_mcmc.py:20-53``).
Each (block, step) has an active sector ``j`` and a swap flag from the
schedule (``ops/rng.py:schedule``).  A walker draws one role uniform ``u``
against ``q = picv/N`` (``picv = 1/(deg_curr*C)``, ``C = 2*nvar + 1``), with
these roles:

- ``u < q`` and the walker's sector neighbours the normalization
  sector: a jump there (NJ), which needs no evaluation;
- ``u >= q`` and the walker is at ``j``: a changeVariable (CV), or a
  swapVariable (SW) when the flag is set;
- ``q <= u < q + picv`` and the walker's sector neighbours ``j``: a
  changeIntegrand to ``j`` (CI), creating and removing the dof difference.

The Hastings factor is the bare degree ratio.  So every step costs one
evaluation per walker, of its block's sector.  The TPU kernel's
workarounds are not carried: map draws are a gather for any ``ninc``,
Discrete CDFs a binary search of any size, adjacency an ``[nd, nd]``
table, and histograms, tallies and visited counts are exact counts on
every step (no ``HIST_EVERY`` or ``TALLY_EVERY``), in integer or float64
accumulators (no Kahan pairs).

Weights are float32, or complex64 when ``spec.cplx`` (``type=complex``,
K3's branch at ``pallas_mcmc.py:526-551`` and ``:1217-1252``): ``nw``,
``weight`` and ``relw`` are complex64, read by the kernel as interleaved
(re, im) float32 pairs.  ``prob = |weight|*rcur`` stays real, with ``|w| =
sqrt(re*re + im*im)`` (``common.py:weight_abs``); the default measure adds
the phase ``w/|w|`` over ``rcur`` (0 where ``|w| <= 1e-38``, as in the
normalization sector) into components ``2*curr`` and ``2*curr + 1``; a
custom measure gets ``relw = w/prob``.  ``mcmc_accept_complex`` is that
instantiation of ``csrc/mcmc_accept.cu``; ``mcmc_propose`` and
``mcmc_measure`` do not see weights.

Each wrapper takes its plain version only for tensors on the CPU.  For CUDA
tensors it launches its kernel (``csrc/mcmc_*.cu``, built by
``ops/_build.py``) or raises; there is no fallback.  ``launch_counts``
counts the kernel launches of each wrapper, the complex ``mcmc_accept``
apart.

Layout.  One walker per thread, structure of arrays ``[..., W]``, walkers
block-major (``w = b*wb + j``).  Kernel slot ``k`` is a (drawn leaf, slot)
pair in leaf order, slot-minor, with ``gidx`` and ``prob`` rows; its value
takes ``width`` rows of ``val`` (1, or D for a FermiK leaf).  The state
holds the current slots ``cur_*`` and a mirror ``prp_*`` equal to them
between steps: ``mcmc_propose`` writes the proposal into the mirror (the
integrand reads it there) and ``mcmc_accept`` copies the touched slots one
way or the other.  Slots that a changeIntegrand creates commit even on
reject, as in the reference (createRollback! is a no-op, sampler.jl:306).
A Discrete slot's ``val`` holds the int32 value in the float32 buffer's
bits; a FermiK slot keeps ``gidx`` 0 and its draw's prob, which nothing
reads (its removal density is recomputed from the value).

Random bits: the counter hash of ``ops/rng.py`` keyed by the block seeds
``kd [B, 2]``, with the step (or, at the start, the retry ``r``) in place of
the chunk, the walker's index within its block as the flat index, and a
salt per draw (the ``SALT_*`` constants).  The kernels and the plain
versions draw the same bits and compute the same float32 operations in the
same order, so from one state they agree bit for bit; the float64
histogram adds exact 1.0s, so it agrees bit for bit too.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Any, List

import numpy as np
import torch

from ..common import weight_abs, weight_scale
from ..models.variable import Discrete, FermiK
from ..solvers.engine import obs_components
from . import _build, fermik
from ._build import check_tensor as _check
from .chain_kernels import _bits, _uniform, _walker_base
from .grid import sample_continuous, sample_discrete
from .rng import MASK32, mix32

SALT_ROLE, SALT_VI, SALT_S1, SALT_S2, SALT_ACCEPT = 1, 2, 3, 4, 5
SALT_CV = 1 << 12       # + 4*d + c: changeVariable redraw of drawn leaf d
SALT_SHIFT = 1 << 14    # + 8*d + c: FermiK shift of drawn leaf d (sel, u1, u2, uj...)
SALT_CI = 1 << 16       # + 4*k + c: changeIntegrand creation of kernel slot k
SALT_INIT = 1 << 20     # + 4*k + c: first draw (and retries) of kernel slot k
ROLE_NONE, ROLE_CV, ROLE_SW, ROLE_CI, ROLE_NJ = 0, 1, 2, 3, 4
KIND_CONT, KIND_DISC, KIND_FERMIK = 0, 1, 2
TINY = fermik.TINY      # common.TINY_F32 as a float32 value
NRETRY = 10             # masked re-draws of walkers whose start weight is 0
SMEM_HIST_BINS = 4096   # 16 KiB of 32-bit histogram counts per thread block
SMEM_COUNTERS = 2048    # 8 KiB of 32-bit visited and tally counts
MAX_SECTORS = 32        # sectors an mcmc_measure launch takes (kMaxSectors)
# kind, nb, tab_off, sm_off, lower, slot0, vrow0, width, hist_off, group, ndraw
LEAF_FIELDS = 11

launch_counts = {"mcmc_propose": 0, "mcmc_accept": 0, "mcmc_measure": 0,
                 "mcmc_accept_complex": 0}


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


@dataclasses.dataclass
class McmcLayout:
    """The static shape of a spec as the :mcmc kernels read it.

    Per drawn leaf ``d`` (``dleaf``, the leaves with ``ndraw > 0``), a row of
    ``leaf [L, LEAF_FIELDS]``: ``kind``; ``nb`` (bins, or D for FermiK);
    ``tab_off`` (its table in the float32 ``tab``: grid then inc, cdf then
    dist, or the FermiK constants of ``ops/fermik.py:constants``);
    ``sm_off`` (-1: the kernels read every table in device memory);
    ``lower``; ``slot0`` and ``vrow0`` (first kernel slot and value row);
    ``width``; ``hist_off`` (its bins in ``hist``, -1 if not adaptive);
    ``group``; ``ndraw``.  ``groups [nvar, 3]``: drawn-leaf range and maxdof.
    ``tab`` starts with ``deg [nd]`` and ``f32(1/N)``.  ``meta`` packs
    ``leaf``, ``groups``, the dof table ``[nd, nvar]`` and the adjacency
    ``[nd, nd]`` as int32 for the kernels.  ``mcmc_accept`` keeps its
    histogram bins and its counters in shared memory when they fit
    (``hist_smem``, ``cnt_smem``).
    """

    spec: Any
    block: int
    wb: int
    ncomp: int              # observable components (engine.obs_components)
    custom: bool            # a custom measure: accept writes relw, not obs
    dleaf: List[int]
    leaf: np.ndarray        # [L, LEAF_FIELDS] int32
    groups: np.ndarray      # [nvar, 3] int32: dlo, dhi, maxdof
    S: int
    V: int
    tab_size: int
    nhist: int
    meta: torch.Tensor      # int32 on the device
    widx: torch.Tensor      # [W] int64: walker index within its block
    adj_t: torch.Tensor     # [nd, nd] bool
    dof_t: torch.Tensor     # [nd, nvar] int32
    deg_t: torch.Tensor     # [nd] float32

    @property
    def W(self) -> int:
        return self.block * self.wb

    @property
    def nd(self) -> int:
        return self.spec.N + 1

    @property
    def ncol(self) -> int:
        return max(self.nd, self.spec.nvar)

    @property
    def C(self) -> int:
        return 2 * self.spec.nvar + 1

    @property
    def any_swap(self) -> bool:
        return bool(np.any(self.groups[:, 2] > 1))

    @property
    def counters(self) -> int:
        """Visited and tally counters: ``nd + 2*3*nd*ncol``."""
        return self.nd + 6 * self.nd * self.ncol

    @property
    def hist_smem(self) -> bool:
        return self.nhist <= SMEM_HIST_BINS

    @property
    def cnt_smem(self) -> bool:
        return self.counters <= SMEM_COUNTERS

    @staticmethod
    def build(spec, block: int, wb: int, ncomp=None, custom=False) -> "McmcLayout":
        """The layout of ``spec`` for ``block`` blocks of ``wb`` walkers;
        ``ncomp`` observable components (default: the default measure's,
        ``engine.obs_components(spec)``), ``custom`` for a custom measure.
        The weights' dtype is ``spec.wdtype``."""
        cfg = spec.cfg
        nd = spec.N + 1
        dleaf = [i for i, li in enumerate(spec.leaves) if li.ndraw > 0]
        rows, slot0, vrow0, h_off = [], 0, 0, 0
        tab_off = nd + 1
        for lidx in dleaf:
            li = spec.leaves[lidx]
            leaf = li.leaf
            hist = -1
            if isinstance(leaf, FermiK):
                kind, nb, width, lower, size = KIND_FERMIK, leaf.dim, leaf.dim, 0, fermik.FK_FIELDS
            elif isinstance(leaf, Discrete):
                kind, nb, width, lower = KIND_DISC, leaf.nbin, 1, leaf.lower
                size = 2 * nb + 1
            else:
                kind, nb, width, lower, size = KIND_CONT, leaf.ninc, 1, 0, 2 * leaf.ninc
            if leaf.adapt:
                hist, h_off = h_off, h_off + li.nhist
            rows.append([kind, nb, tab_off, -1, lower, slot0, vrow0, width, hist,
                         li.group, li.ndraw])
            tab_off += size
            slot0 += li.ndraw
            vrow0 += li.ndraw * width
        groups = []
        for g in range(spec.nvar):
            ds = [d for d, lidx in enumerate(dleaf) if spec.leaves[lidx].group == g]
            groups.append([ds[0], ds[-1] + 1, spec.maxdof[g]] if ds else [0, 0, 0])
        leaf = np.asarray(rows, np.int32).reshape(-1, LEAF_FIELDS)
        groups = np.asarray(groups, np.int32).reshape(-1, 3)
        dof = np.asarray(cfg.dof, np.int32).reshape(nd, spec.nvar)
        adj = np.zeros((nd, nd), np.int32)
        for i, nbrs in enumerate(cfg.neighbor):
            adj[i, list(nbrs)] = 1
        deg = np.asarray([len(a) for a in cfg.neighbor], np.float32)
        meta = np.concatenate([leaf.ravel(), groups.ravel(), dof.ravel(),
                               adj.ravel()]).astype(np.int32)
        dev = spec.device
        return McmcLayout(
            spec=spec, block=block, wb=wb,
            ncomp=obs_components(spec) if ncomp is None else ncomp, custom=custom,
            dleaf=dleaf,
            leaf=leaf, groups=groups, S=slot0, V=vrow0,
            tab_size=tab_off, nhist=h_off,
            meta=torch.as_tensor(meta, device=dev),
            widx=torch.arange(wb, dtype=torch.int64, device=dev).repeat(block),
            adj_t=torch.as_tensor(adj != 0, device=dev),
            dof_t=torch.as_tensor(dof, device=dev),
            deg_t=torch.as_tensor(deg, device=dev))

    def tables(self, params) -> torch.Tensor:
        """The float32 ``tab`` of this iteration's ``params``."""
        dev = self.spec.device
        parts = [self.deg_t, torch.tensor([fermik.f32(1.0 / self.spec.N)],
                                          dtype=torch.float32, device=dev)]
        for lidx in self.dleaf:
            leaf = self.spec.leaves[lidx].leaf
            a, b = params["leaf"][lidx]
            if isinstance(leaf, FermiK):
                parts.append(torch.as_tensor(
                    fermik.constants(float(a), float(b), leaf.dim), device=dev))
            else:
                parts += [a.reshape(-1).to(torch.float32), b.reshape(-1).to(torch.float32)]
        return torch.cat(parts).contiguous()

    @functools.cached_property
    def _fields(self):
        names = ("kind", "nb", "tab_off", "sm_off", "lower", "slot0", "vrow0",
                 "width", "hist_off", "group", "ndraw")
        return [dict(zip(names, (int(x) for x in row))) for row in self.leaf]

    def fields(self, d: int) -> dict:
        """Drawn leaf ``d``'s row as a dict of ints."""
        return self._fields[d]

    def leaf_values(self, val: torch.Tensor):
        """Per spec leaf, its values from a ``[V, *batch]`` value field:
        ``[ndraw, *batch]`` (int32 for Discrete) or ``[ndraw, D, *batch]``
        for FermiK; empty for a leaf with nothing drawn."""
        out, r = [], 0
        batch = tuple(val.shape[1:])
        for li in self.spec.leaves:
            width = li.leaf.dim if isinstance(li.leaf, FermiK) else 1
            rows = val[r:r + li.ndraw * width]
            r += li.ndraw * width
            if width > 1:
                rows = rows.reshape((li.ndraw, width) + batch)
            elif isinstance(li.leaf, Discrete):
                rows = rows.view(torch.int32)
            out.append(rows)
        return out


@dataclasses.dataclass
class McmcState:
    """The walkers' state and accumulators, all on one device.

    Slots: ``cur_val``/``prp_val [V, W]`` float32 (int32 bits for a Discrete
    slot), ``*_gidx [S, W]`` int32, ``*_prob [S, W]`` float32.  Per walker:
    ``curr`` (sector), ``weight`` (complex64 with complex weights, as
    ``relw``), ``prob`` (``|weight|*rw[curr]``, or
    ``rw[norm]`` in the normalization sector), ``rcur``/``degc``/``picv``
    (``rw``, degree and ``1/(deg*C)`` of ``curr``), ``dof [nvar, W]`` (of
    ``curr``); the step's proposal factor ``prop`` and ``move [4, W]`` (role,
    var group, slot 1, slot 2); ``relw`` (custom measure).  Float64
    accumulators ``obs [ncomp, W]`` and ``nrm [W]``; int64 counts ``vis
    [nd]`` and ``tally [2, 3, nd, ncol]`` (propose, accept; rows CI, CV,
    swap); float64 histograms ``hist [H]``.
    """

    cur_val: torch.Tensor
    cur_gidx: torch.Tensor
    cur_prob: torch.Tensor
    prp_val: torch.Tensor
    prp_gidx: torch.Tensor
    prp_prob: torch.Tensor
    curr: torch.Tensor
    weight: torch.Tensor
    prob: torch.Tensor
    rcur: torch.Tensor
    degc: torch.Tensor
    picv: torch.Tensor
    dof: torch.Tensor
    prop: torch.Tensor
    move: torch.Tensor
    relw: torch.Tensor
    obs: torch.Tensor
    nrm: torch.Tensor
    vis: torch.Tensor
    tally: torch.Tensor
    hist: torch.Tensor

    @staticmethod
    def zeros(lay: McmcLayout) -> "McmcState":
        dev = lay.spec.device
        return McmcState(**{name: torch.zeros(shape, dtype=dtype, device=dev)
                            for name, dtype, shape in _state_fields(lay)})

    def clone(self) -> "McmcState":
        return McmcState(**{f.name: getattr(self, f.name).clone()
                            for f in dataclasses.fields(self)})


def _state_fields(lay: McmcLayout):
    """``(name, dtype, shape)`` of every McmcState field for ``lay``."""
    S, V, W, nd, nvar = lay.S, lay.V, lay.W, lay.nd, lay.spec.nvar
    f32, i32, f64, i64, wt = torch.float32, torch.int32, torch.float64, torch.int64, lay.spec.wdtype
    return (("cur_val", f32, (V, W)), ("cur_gidx", i32, (S, W)), ("cur_prob", f32, (S, W)),
            ("prp_val", f32, (V, W)), ("prp_gidx", i32, (S, W)), ("prp_prob", f32, (S, W)),
            ("curr", i32, (W,)), ("weight", wt, (W,)), ("prob", f32, (W,)),
            ("rcur", f32, (W,)), ("degc", f32, (W,)), ("picv", f32, (W,)),
            ("dof", i32, (nvar, W)), ("prop", f32, (W,)), ("move", i32, (4, W)),
            ("relw", wt, (W,)), ("obs", f64, (lay.ncomp, W)), ("nrm", f64, (W,)),
            ("vis", i64, (nd,)), ("tally", i64, (2, 3, nd, lay.ncol)),
            ("hist", f64, (max(lay.nhist, 1),)))


def _check_state(lay: McmcLayout, st: McmcState, dev):
    for name, dtype, shape in _state_fields(lay):
        _check(getattr(st, name), name, dtype, shape, dev)
    _check(lay.meta, "meta", torch.int32, lay.meta.shape, dev)


def _device_of(st: McmcState, name: str) -> torch.device:
    dev = st.cur_prob.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def _check_step(lay: McmcLayout, tab, kd, sched, t: int, dev, name: str):
    _check(tab, "tab", torch.float32, (lay.tab_size,), dev)
    _check(kd, "kd", torch.int32, (lay.block, 2), dev)
    _check(sched, "sched", torch.int32, (sched.shape[0], lay.block), dev)
    if not 0 <= t < max(sched.shape[0], NRETRY + 1):
        raise ValueError(f"{name}: step {t} out of range")


# ---------------------------------------------------------------------------
# shared pieces of the plain versions
# ---------------------------------------------------------------------------

def _uniforms(base, salts):
    """``[len(salts), W]``: ``chain_kernels._uniform(base, c)`` for each salt,
    in one pass."""
    c = torch.tensor([(x * 0x85EBCA6B) & MASK32 for x in salts], dtype=torch.int64,
                     device=base.device)[:, None]
    bits = mix32((base[None] + c) & MASK32)
    return ((bits >> 8).to(torch.float32) + 0.5) * 2.0 ** -24


def _draw(lay: McmcLayout, tab, d: int, base, salt: int):
    """Drawn leaf ``d``'s fresh draw from uniforms ``salt + c``: (value
    rows ``[width, W]`` as int32 bits, gidx, prob)."""
    f = lay.fields(d)
    nb, off = f["nb"], f["tab_off"]
    if f["kind"] == KIND_FERMIK:
        const = tab[off:off + fermik.FK_FIELDS].tolist()
        u = _uniforms(base, [salt + c for c in range(nb)])
        value, prob = fermik.fermik_draw(u[0], u[1], u[-1], const, nb)
        return value.view(torch.int32), torch.zeros_like(base, dtype=torch.int32), prob
    u = _uniform(base, salt)
    if f["kind"] == KIND_DISC:
        gidx, prob = sample_discrete(u, tab[off:off + nb + 1], tab[off + nb + 1:off + 2 * nb + 1])
        return (gidx + f["lower"])[None], gidx, prob
    x, iy, prob = sample_continuous(u, tab[off:off + nb], tab[off + nb:off + 2 * nb])
    return x.view(torch.int32)[None], iy, prob


def _old_density(lay: McmcLayout, tab, st: McmcState, d: int, s: int):
    """The removal density of slot ``s`` of drawn leaf ``d``: its stored
    prob, or the FermiK shell density of its value."""
    f = lay.fields(d)
    if f["kind"] == KIND_FERMIK:
        r0 = f["vrow0"] + s * f["width"]
        const = tab[f["tab_off"]:f["tab_off"] + fermik.FK_FIELDS].tolist()
        return fermik.fermik_density(st.cur_val[r0:r0 + f["width"]], const, f["nb"])
    return st.cur_prob[f["slot0"] + s]


def _slot_rows(lay: McmcLayout, st: McmcState, d: int, prefix: str):
    """(val rows ``[ndraw, width, W]`` as int32 bits, gidx ``[ndraw, W]``,
    prob ``[ndraw, W]``) views of drawn leaf ``d``'s slots in ``prefix``."""
    f = lay.fields(d)
    k0, r0, n, wd = f["slot0"], f["vrow0"], f["ndraw"], f["width"]
    val = _bits(getattr(st, prefix + "_val"))[r0:r0 + n * wd].view(n, wd, -1)
    return (val, getattr(st, prefix + "_gidx")[k0:k0 + n],
            _bits(getattr(st, prefix + "_prob"))[k0:k0 + n])


def _get(rows, s, md: int):
    """``rows[s[w], ..., w]`` per walker (``rows`` slot-major, ``md`` slots)."""
    if md == 1:
        return rows[0]
    idx = s.long().reshape((1,) + (1,) * (rows.ndim - 2) + (-1,))
    return rows.gather(0, idx.expand((1,) + tuple(rows.shape[1:])))[0]


def _put(rows, s, sel, new, md: int):
    """``rows[s[w], ..., w] = new[..., w]`` where ``sel``."""
    if md == 1:
        rows[0] = torch.where(sel, new, rows[0])
        return
    idx = s.long().reshape((1,) + (1,) * (rows.ndim - 2) + (-1,))
    idx = idx.expand((1,) + tuple(rows.shape[1:]))
    rows.scatter_(0, idx, torch.where(sel, new, rows.gather(0, idx)[0])[None])


def _walker_sched(lay: McmcLayout, sched, t: int):
    """Per walker: (active sector, swap flag) of its block at step ``t``."""
    code = sched[t].repeat_interleave(lay.wb)
    return code >> 1, (code & 1) == 1


def _picv(deg, C: int):
    return 1.0 / (deg * float(C))


# ---------------------------------------------------------------------------
# mcmc_propose
# ---------------------------------------------------------------------------
# The plain versions skip the work of a role no walker takes (``mask.any()``
# guards): a ``where`` under an all-False mask changes nothing, so the result
# is the same, and the CPU path runs several times faster.

def mcmc_propose_plain(lay: McmcLayout, tab, kd, sched, t: int, st: McmcState, init=False):
    """Plain torch version of ``csrc/mcmc_propose.cu`` (same bits)."""
    base = _walker_base(lay, kd, t)
    if init:                         # retry t: fresh draws for the walkers at prob 0
        bad = st.prob <= TINY
        if not bool(bad.any()):
            return
        for d in range(len(lay.dleaf)):
            f = lay.fields(d)
            for s in range(f["ndraw"]):
                val, gidx, prob = _draw(lay, tab, d, base, SALT_INIT + 4 * (f["slot0"] + s))
                for pre in ("cur", "prp"):
                    v, g, p = _slot_rows(lay, st, d, pre)
                    v[s] = torch.where(bad, val, v[s])
                    g[s] = torch.where(bad, gidx, g[s])
                    p[s] = torch.where(bad, prob.view(torch.int32), p[s])
        return
    nvar, norm = lay.spec.nvar, lay.nd - 1
    jt, swap = _walker_sched(lay, sched, t)
    jl, c = jt.long(), st.curr.long()
    adjn = lay.adj_t[c, norm]
    qw = torch.where(adjn, st.picv * tab[lay.nd], 0.0)
    u_role, u_vi, u_s1, u_s2 = _uniforms(base, [SALT_ROLE, SALT_VI, SALT_S1, SALT_S2])
    nj = adjn & (u_role < qw)
    at_jt = (st.curr == jt) & (u_role >= qw)
    ci = lay.adj_t[c, jl] & (u_role >= qw) & (u_role < qw + st.picv)
    if nvar > 1:
        vi = torch.clamp((u_vi * float(nvar)).to(torch.int32), max=nvar - 1)
    else:
        vi = torch.zeros_like(st.curr)
    dof_vi = st.dof.gather(0, vi.long()[None])[0]
    dvf = dof_vi.to(torch.float32)
    top = torch.clamp(dof_vi - 1, min=0)
    idx1 = torch.minimum((u_s1 * dvf).to(torch.int32), top)
    can_move = at_jt & (dof_vi > 0)
    if lay.any_swap:
        idx2 = torch.minimum((u_s2 * dvf).to(torch.int32), top)
        cv = can_move & ~swap
        sw = can_move & swap & (idx1 != idx2)
    else:
        idx2 = torch.zeros_like(idx1)
        cv, sw = can_move, torch.zeros_like(can_move)
    role = torch.where(cv, ROLE_CV, torch.where(sw, ROLE_SW, torch.where(
        ci, ROLE_CI, torch.where(nj, ROLE_NJ, ROLE_NONE)))).to(torch.int32)

    prop = torch.ones(lay.W, dtype=torch.float32, device=st.prob.device)
    for g in range(nvar):
        dlo, dhi, md = (int(x) for x in lay.groups[g])
        if md == 0:
            continue
        sel_cv, sel_sw = cv & (vi == g), sw & (vi == g)
        do_cv, do_sw = bool(sel_cv.any()), md > 1 and bool(sel_sw.any())
        dc, dj = st.dof[g], lay.dof_t[jl, g]
        created = [ci & (s >= dc) & (s < dj) for s in range(md)]
        removed = [ci & (s >= dj) & (s < dc) for s in range(md)]
        for d in range(dlo, dhi):
            f = lay.fields(d)
            cval, cgidx, cprob = _slot_rows(lay, st, d, "cur")
            pval, pgidx, pprob = _slot_rows(lay, st, d, "prp")
            # changeVariable: a fresh map draw, or the FermiK three-way shift
            if do_cv and f["kind"] == KIND_FERMIK:
                const = tab[f["tab_off"]:f["tab_off"] + fermik.FK_FIELDS].tolist()
                old = _get(cval, idx1, md).view(torch.float32)
                u = _uniforms(base, [SALT_SHIFT + 8 * d + k for k in range(3 + f["width"])])
                new, sprop = fermik.fermik_shift(old, u[0], u[1], u[2], u[3:], const, f["nb"])
                prop = torch.where(sel_cv, prop * sprop, prop)
                _put(pval, idx1, sel_cv, new.view(torch.int32), md)
            elif do_cv:
                val, gidx, pr = _draw(lay, tab, d, base, SALT_CV + 4 * d)
                p_old = _get(cprob, idx1, md).view(torch.float32)
                prop = torch.where(sel_cv, prop * (p_old / pr), prop)
                _put(pval, idx1, sel_cv, val, md)
                _put(pgidx, idx1, sel_cv, gidx, md)
                _put(pprob, idx1, sel_cv, pr.view(torch.int32), md)
            # swapVariable: exchange slots idx1 and idx2
            if do_sw:
                for cur, prp in ((cval, pval), (cgidx, pgidx), (cprob, pprob)):
                    a, b = _get(cur, idx1, md), _get(cur, idx2, md)
                    _put(prp, idx1, sel_sw, b, md)
                    _put(prp, idx2, sel_sw, a, md)
            # changeIntegrand: create [dof_curr, dof_j), remove [dof_j, dof_curr)
            for s in range(md):
                if bool(created[s].any()):
                    val, gidx, pr = _draw(lay, tab, d, base, SALT_CI + 4 * (f["slot0"] + s))
                    if f["kind"] == KIND_FERMIK:
                        div = torch.where(pr > 0.0, prop / torch.clamp(pr, min=TINY), 0.0)
                    else:
                        div = prop / pr
                    prop = torch.where(created[s], div, prop)
                    pval[s] = torch.where(created[s], val, pval[s])
                    pgidx[s] = torch.where(created[s], gidx, pgidx[s])
                    pprob[s] = torch.where(created[s], pr.view(torch.int32), pprob[s])
                if bool(removed[s].any()):
                    prop = torch.where(removed[s], prop * _old_density(lay, tab, st, d, s), prop)
    # jump into the normalization sector removes every slot of curr's dof
    for g in range(nvar):
        dlo, dhi, md = (int(x) for x in lay.groups[g])
        for d in range(dlo, dhi):
            for s in range(md):
                rem = nj & (s < st.dof[g])
                if bool(rem.any()):
                    prop = torch.where(rem, prop * _old_density(lay, tab, st, d, s), prop)
    st.prop.copy_(prop)
    st.move.copy_(torch.stack([role, vi, idx1, idx2]))


def _propose_args(lay: McmcLayout, tab, kd, sched, t: int, st: McmcState, init: bool):
    """The argument list of ``mci_mcmc_propose`` (without the stream)."""
    return (kd.data_ptr(), sched.data_ptr(), t, int(init), lay.W, lay.wb,
            len(lay.dleaf), lay.spec.nvar, lay.nd, int(lay.any_swap),
            lay.meta.data_ptr(), tab.data_ptr(),
            st.cur_val.data_ptr(), st.cur_gidx.data_ptr(), st.cur_prob.data_ptr(),
            st.prp_val.data_ptr(), st.prp_gidx.data_ptr(), st.prp_prob.data_ptr(),
            st.curr.data_ptr(), st.prob.data_ptr(), st.picv.data_ptr(),
            st.dof.data_ptr(), st.prop.data_ptr(), st.move.data_ptr())


def mcmc_propose(lay: McmcLayout, tab, kd, sched, t: int, st: McmcState, init=False):
    """Step ``t``'s proposal into ``st.prp_*``, ``st.prop`` and ``st.move``;
    with ``init``, retry ``t``'s draws for the walkers still at prob 0
    (every walker on a fresh state), into both copies."""
    dev = _device_of(st, "mcmc_propose")
    if dev.type == "cpu":
        return mcmc_propose_plain(lay, tab, kd, sched, t, st, init)
    _check_state(lay, st, dev)
    _check_step(lay, tab, kd, sched, t, dev, "mcmc_propose")
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mci_mcmc_propose(*_propose_args(lay, tab, kd, sched, t, st, init), stream)
    _build.check(lib, err, "mcmc_propose")
    launch_counts["mcmc_propose"] += 1


# ---------------------------------------------------------------------------
# mcmc_accept
# ---------------------------------------------------------------------------

def _count(tab, idx, mask):
    """``tab.view(-1)[idx[w]] += 1`` where ``mask``."""
    tab.view(-1).add_(torch.bincount(idx[mask], minlength=tab.numel()))


def mcmc_accept_plain(lay: McmcLayout, tab, rw, kd, sched, t: int, st: McmcState, nw,
                      init=False, measure=False):
    """Plain torch version of ``csrc/mcmc_accept.cu``, both instantiations
    (same bits)."""
    nd, norm, nvar, C = lay.nd, lay.nd - 1, lay.spec.nvar, lay.C
    deg = lay.deg_t
    if init:
        bad = st.prob <= TINY
        st.weight.copy_(torch.where(bad, nw, st.weight))
        st.prob.copy_(torch.where(bad, weight_abs(nw) * rw[0], st.prob))
        st.curr.fill_(0)
        st.rcur.copy_(rw[0].expand(lay.W))
        st.degc.copy_(deg[0].expand(lay.W))
        st.picv.copy_(_picv(deg[0], C).expand(lay.W))
        st.dof.copy_(lay.dof_t[0][:, None].expand(nvar, lay.W))
        return
    jt, _ = _walker_sched(lay, sched, t)
    jl = jt.long()
    role, vi, idx1, idx2 = st.move
    c = st.curr.long()
    _count(st.vis, c, torch.ones_like(role, dtype=torch.bool))
    u = _uniform(_walker_base(lay, kd, t), SALT_ACCEPT)
    p_old = torch.clamp(st.prob, min=TINY)
    anw = weight_abs(nw)
    p_mv = anw * st.rcur
    r_jt, deg_jt = rw[jl], deg[jl]
    p_ci = anw * r_jt
    prop = st.prop
    acc_cv = (role == ROLE_CV) & (u < prop * p_mv / p_old) & (prop > TINY)
    acc_sw = (role == ROLE_SW) & (u < p_mv / p_old)
    acc_ci = (role == ROLE_CI) & (u < prop * (st.degc / deg_jt) * p_ci / p_old) & (prop > TINY)
    acc_nj = (role == ROLE_NJ) & (u < prop * (st.degc / deg[norm]) * rw[norm] / p_old)
    ncol = lay.ncol
    pc, ac = st.tally[0], st.tally[1]
    ci_cell = c * ncol + jl
    nj_cell = c * ncol + norm
    mv_cell = jl * ncol + vi.long()
    for row, cell, prp_mask, acc in ((0, ci_cell, role == ROLE_CI, acc_ci),
                                     (0, nj_cell, role == ROLE_NJ, acc_nj),
                                     (1, mv_cell, role == ROLE_CV, acc_cv),
                                     (2, mv_cell, role == ROLE_SW, acc_sw)):
        _count(pc[row], cell, prp_mask)
        _count(ac[row], cell, acc)

    # commit the touched slots: CV/swap one way or the other, created always
    for g in range(nvar):
        dlo, dhi, md = (int(x) for x in lay.groups[g])
        if md == 0:
            continue
        dc, dj = st.dof[g], lay.dof_t[jl, g]
        moves = [(sel, acc, s) for sel, acc, s in (
            ((role == ROLE_CV) & (vi == g), acc_cv, idx1),
            ((role == ROLE_SW) & (vi == g), acc_sw, idx1),
            ((role == ROLE_SW) & (vi == g), acc_sw, idx2)) if bool(sel.any())]
        created = [(role == ROLE_CI) & (s >= dc) & (s < dj) for s in range(md)]
        created = [(s, m) for s, m in enumerate(created) if bool(m.any())]
        for d in range(dlo, dhi):
            for cur, prp in zip(_slot_rows(lay, st, d, "cur"), _slot_rows(lay, st, d, "prp")):
                for sel, acc, s in moves:
                    merged = torch.where(acc, _get(prp, s, md), _get(cur, s, md))
                    _put(cur, s, sel, merged, md)
                    _put(prp, s, sel, merged, md)
                for s, m in created:
                    cur[s] = torch.where(m, prp[s], cur[s])

    acc_mv = acc_cv | acc_sw
    r_norm, deg_norm = rw[norm], deg[norm]
    st.weight.copy_(torch.where(acc_mv | acc_ci, nw,
                                torch.where(acc_nj, weight_scale(st.weight, 0.0), st.weight)))
    st.prob.copy_(torch.where(acc_mv, p_mv, torch.where(acc_ci, p_ci,
                                                        torch.where(acc_nj, r_norm, st.prob))))
    st.rcur.copy_(torch.where(acc_ci, r_jt, torch.where(acc_nj, r_norm, st.rcur)))
    st.degc.copy_(torch.where(acc_ci, deg_jt, torch.where(acc_nj, deg_norm, st.degc)))
    st.picv.copy_(torch.where(acc_ci, _picv(deg_jt, C),
                              torch.where(acc_nj, _picv(deg_norm, C), st.picv)))
    for g in range(nvar):
        st.dof[g] = torch.where(acc_ci, lay.dof_t[jl, g], torch.where(acc_nj, 0, st.dof[g]))
    st.curr.copy_(torch.where(acc_ci, jt, torch.where(acc_nj, norm, st.curr)))
    if not measure:
        return

    # measurement (pallas_mcmc.py:1208-1289), on the state after the move
    in_norm = st.curr == norm
    if lay.custom:
        ok = ~in_norm & (st.prob > TINY)
        invp = torch.where(ok, 1.0 / torch.where(ok, st.prob, 1.0), 0.0)
        st.relw.copy_(weight_scale(st.weight, invp))
    elif lay.spec.cplx:
        # the phase w/|w| over rcur (pallas_mcmc.py:1217-1233)
        absw = weight_abs(st.weight)
        inv_abs = torch.where(absw > TINY, 1.0 / torch.clamp(absw, min=TINY), 0.0)
        phase = weight_scale(weight_scale(st.weight, inv_abs), 1.0 / st.rcur)
        re, im = torch.view_as_real(phase).unbind(-1)
        for i in range(lay.spec.N):
            st.obs[2 * i] += torch.where(st.curr == i, re, 0.0).double()
            st.obs[2 * i + 1] += torch.where(st.curr == i, im, 0.0).double()
    else:
        contrib = torch.sign(st.weight) * (1.0 / st.rcur)
        for i in range(lay.spec.N):
            st.obs[i] += torch.where(st.curr == i, contrib, 0.0).double()
    st.nrm.add_(torch.where(in_norm, 1.0 / r_norm, 0.0).double())
    for d in range(len(lay.dleaf)):
        f = lay.fields(d)
        if f["hist_off"] < 0:
            continue
        for s in range(f["ndraw"]):
            sel = ~in_norm & (s < st.dof[f["group"]])
            bins = st.cur_gidx[f["slot0"] + s].long() + f["hist_off"]
            st.hist.index_add_(0, bins[sel], torch.ones_like(st.hist[:1]).expand(int(sel.sum())))


def _accept_args(lay: McmcLayout, tab, rw, kd, sched, t: int, st: McmcState, nw,
                 init: bool, measure: bool):
    """The argument list of ``mci_mcmc_accept`` (without the stream)."""
    return (kd.data_ptr(), sched.data_ptr(), t, int(init), int(measure), int(lay.custom),
            lay.W, lay.wb, len(lay.dleaf), lay.spec.nvar, lay.nd, lay.C,
            lay.meta.data_ptr(), tab.data_ptr(), rw.data_ptr(), nw.data_ptr(),
            lay.nhist, int(lay.hist_smem), int(lay.cnt_smem),
            st.cur_val.data_ptr(), st.cur_gidx.data_ptr(), st.cur_prob.data_ptr(),
            st.prp_val.data_ptr(), st.prp_gidx.data_ptr(), st.prp_prob.data_ptr(),
            st.curr.data_ptr(), st.weight.data_ptr(), st.prob.data_ptr(),
            st.rcur.data_ptr(), st.degc.data_ptr(), st.picv.data_ptr(),
            st.dof.data_ptr(), st.prop.data_ptr(), st.move.data_ptr(),
            st.relw.data_ptr(), st.obs.data_ptr(), st.nrm.data_ptr(),
            st.vis.data_ptr(), st.tally.data_ptr(), st.hist.data_ptr())


def mcmc_accept(lay: McmcLayout, tab, rw, kd, sched, t: int, st: McmcState, nw,
                init=False, measure=False):
    """Step ``t``'s Metropolis decision on the proposal, whose walkers'
    weights under their block's sector are ``nw [W]`` (``spec.wdtype``),
    in place on ``st``; with ``init``, take retry ``t``'s
    weights of integrand 0."""
    dev = _device_of(st, "mcmc_accept")
    if dev.type == "cpu":
        return mcmc_accept_plain(lay, tab, rw, kd, sched, t, st, nw, init, measure)
    _check_state(lay, st, dev)
    _check_step(lay, tab, kd, sched, t, dev, "mcmc_accept")
    _check(nw, "nw", lay.spec.wdtype, (lay.W,), dev)
    _check(rw, "rw", torch.float32, (lay.nd,), dev)
    name = "mcmc_accept_complex" if lay.spec.cplx else "mcmc_accept"
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, "mci_" + name)(
            *_accept_args(lay, tab, rw, kd, sched, t, st, nw, init, measure), stream)
    _build.check(lib, err, name)
    launch_counts[name] += 1


# ---------------------------------------------------------------------------
# mcmc_measure
# ---------------------------------------------------------------------------

def sector_chunks(n: int):
    """``(lo, hi)`` of each ``mcmc_measure`` launch over ``n`` sectors:
    consecutive runs of at most ``MAX_SECTORS`` sectors, in sector order."""
    return [(lo, min(lo + MAX_SECTORS, n)) for lo in range(0, n, MAX_SECTORS)]


def mcmc_measure_plain(lay: McmcLayout, ms, st: McmcState):
    """Plain torch version of ``csrc/mcmc_measure.cu``: one masked add per
    sector, in sector order."""
    for i, m in enumerate(ms):
        st.obs.add_(torch.where(st.curr == i, m, 0.0).double())


def _measure_args(lay: McmcLayout, ms, st: McmcState, lo: int, hi: int):
    """The argument list of ``mci_mcmc_measure`` (without the stream) for
    sectors ``lo .. hi - 1``: their outputs' pointers in a host array."""
    ptrs = (ctypes.c_void_p * (hi - lo))(*(m.data_ptr() for m in ms[lo:hi]))
    return (lo, hi - lo, lay.ncomp, lay.W, ptrs, st.curr.data_ptr(), st.obs.data_ptr())


def mcmc_measure(lay: McmcLayout, ms, st: McmcState):
    """Add the custom-measure outputs ``ms`` (one ``[ncomp, W]`` float32
    tensor per sector) into the float64 accumulators ``st.obs``: each walker
    outside the normalization sector adds its own sector's output.  One
    launch per ``MAX_SECTORS`` sectors."""
    dev = _device_of(st, "mcmc_measure")
    if len(ms) != lay.spec.N:
        raise ValueError(f"mcmc_measure: {len(ms)} outputs for {lay.spec.N} sectors")
    if dev.type == "cpu":
        return mcmc_measure_plain(lay, ms, st)
    for i, m in enumerate(ms):
        _check(m, f"m[{i}]", torch.float32, (lay.ncomp, lay.W), dev)
    _check(st.curr, "curr", torch.int32, (lay.W,), dev)
    _check(st.obs, "obs", torch.float64, (lay.ncomp, lay.W), dev)
    if lay.ncomp * lay.W >= 2 ** 31:
        raise ValueError(f"mcmc_measure: {lay.ncomp} x {lay.W} accumulators exceed 32-bit "
                         "indices")
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for lo, hi in sector_chunks(len(ms)):
            err = lib.mci_mcmc_measure(*_measure_args(lay, ms, st, lo, hi), stream)
            _build.check(lib, err, "mcmc_measure")
            launch_counts["mcmc_measure"] += 1
