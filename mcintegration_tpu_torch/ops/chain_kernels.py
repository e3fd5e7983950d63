"""Wrappers of the two CUDA kernels of the :vegasmc solver, with their plain
PyTorch versions.

Together they replace ``mcintegration_tpu/ops/pallas_chain.py:
build_chain_run_all`` (kernel K2) as a split step: ``chain_propose`` draws
each walker's changeVariable proposal, the user integrand runs as torch ops
on the proposed state, and ``chain_accept`` forms the padding factors and
the joint density, takes the Metropolis decision and accumulates tallies,
histograms and measurements.  With a custom measure (K2's branch at
``pallas_chain.py:829-842``), ``chain_accept`` writes each walker's
relative weights ``relw`` on a measured step in place of the ``obs`` adds,
the user's measure runs as torch ops on the state after the move, and
``chain_measure`` adds its output into the float64 accumulators.  The law
is the JAX package's XLA route
(``mcintegration_tpu/solvers/vegasmc.py:250-450``): every walker redraws
the chosen slot of every leaf of its chosen group through the leaf's map,
with a fresh uniform of its own.

Weights are float32, or complex64 when ``spec.cplx`` (``type=complex``,
K2's branch at ``pallas_chain.py:459-488`` and ``:818-842``): ``nw``,
``w`` and ``relw`` are complex64 and the kernel reads them as interleaved
(re, im) float32 pairs through ``torch.view_as_real``, with no copy.  Their
algebra is written out on the pair (``common.py:weight_abs``): ``|w| =
sqrt(re*re + im*im)`` in the joint density and the visited sums, ``re*re
+ im*im`` in the histogram weight, and ``(re*f, im*f)`` for a relative
weight, whose parts the default measure adds into components ``2i`` and
``2i+1`` of ``obs``.  ``chain_accept_complex`` is that instantiation of
``csrc/chain_accept.cu``; ``chain_propose`` and ``chain_measure`` do not
see weights.

Each wrapper takes its plain version only for tensors on the CPU.  For CUDA
tensors it launches its kernel (``csrc/chain_*.cu``, built by
``ops/_build.py``) or raises; there is no fallback.  ``launch_counts``
counts the kernel launches of each wrapper, the complex ``chain_accept``
apart.

Layout.  One walker per thread, structure of arrays: every field is
``[..., W]`` with walkers block-major, ``w = b*wb + j``.  Kernel slots are
the (drawn leaf, slot) pairs in leaf order, slot-minor.  The state holds the
current slots ``cur_*`` and a mirror ``prp_*`` that equals them between
steps; ``chain_propose`` writes the proposal into the mirror (the integrand
reads it there), and ``chain_accept`` copies the changed slots one way or
the other, so a step moves only the slots it touches.  A Discrete slot's
``val`` holds the int32 value ``lower + gidx`` in the float32 buffer's bits.

Random bits: the counter hash of ``ops/rng.py``, keyed by the per-block
seeds ``kd [B, 2]`` (int32 tensors holding the uint32 bits), with the step
``t`` in place of the chunk, the walker's index ``j`` within its block as the flat index,
and a salt per draw: ``SALT_GROUP``, ``SALT_SLOT``, ``SALT_ACCEPT``,
``SALT_LEAF + d`` for drawn leaf ``d``, and ``SALT_INIT + k`` for the first
draw of kernel slot ``k``.  The kernels and the plain versions draw the same
bits and compute the same float32 operations in the same order, so from one
state they agree bit for bit; only the histogram's float64 atomics add in
another order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List

import numpy as np
import torch

from ..common import TINY_F32, weight_abs, weight_abs2, weight_scale
from ..models.variable import Discrete
from ..solvers.engine import obs_components
from . import _build
from ._build import check_tensor as _check
from .grid import sample_continuous, sample_discrete
from .rng import MASK32, chunk_keys, mix32

SALT_GROUP, SALT_SLOT, SALT_ACCEPT, SALT_LEAF = 1, 2, 3, 4
SALT_INIT = 1 << 20
HIST_CLIP = 1e34            # histogram weight clip (vegasmc.py:363-365)
SMEM_CDF_NBIN = 1024        # Discrete CDFs up to this size go to shared memory
SMEM_CDF_FLOATS = 12288     # 48 KiB of staged CDF thresholds per thread block
SMEM_HIST_BINS = 6144       # 48 KiB of float64 histogram per thread block
LEAF_FIELDS = 8             # kind, nb, tab_off, sm_off, lower, slot0, hist_off, group

launch_counts = {"chain_propose": 0, "chain_accept": 0, "chain_measure": 0,
                 "chain_accept_complex": 0}


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


@dataclasses.dataclass
class ChainLayout:
    """The static shape of a spec as the chain kernels read it.

    ``dleaf`` lists the spec's drawn leaves (``ndraw > 0``); per drawn leaf
    ``d``: ``kind`` (0 Continuous, 1 Discrete), ``nb`` (bins), ``tab_off``
    (its table in the float32 ``tab``: grid then inc, or cdf then dist),
    ``sm_off`` (its staged CDF in shared memory, -1 if read from global),
    ``lower``, ``slot0`` (first kernel slot), ``hist_off`` (its histogram in
    the float64 ``hist``, -1 if not adaptive) and ``group``.  Groups give
    their drawn-leaf range ``[glo, ghi)`` and ``maxdof``; ``elig`` lists
    the groups a step may pick; ``hfeed [S, N]`` says which integrands'
    histogram weights feed kernel slot ``k``.  ``meta`` packs it all as
    int32 for the kernels: leaf fields ``[L, 8]``, groups ``[nvar, 3]``,
    ``elig``, ``padm [nd, P]`` and ``usedm [N, P]`` (the (group, slot)
    pairs, group-major, of each integrand's padding factor and probability:
    ``spec.mask_pad`` and ``spec.mask_used``), ``hfeed``, ``sleaf [S]``.
    """

    spec: Any
    block: int
    wb: int
    ncomp: int              # observable components (engine.obs_components)
    custom: bool            # a custom measure: accept writes relw, not obs
    dleaf: List[int]
    leaf: np.ndarray        # [L, LEAF_FIELDS] int32
    groups: np.ndarray      # [nvar, 3] int32: glo, ghi, maxdof
    elig: List[int]
    hfeed: np.ndarray       # [S, N] int32
    sleaf: List[int]        # drawn-leaf ordinal of each kernel slot
    tab_size: int
    smem_floats: int
    nhist: int
    meta: torch.Tensor      # int32 on the device
    widx: torch.Tensor      # [W] int64: walker index within its block
    elig_t: torch.Tensor    # elig, int64 on the device
    gmd_t: torch.Tensor     # [nvar] int32 maxdof on the device

    @property
    def W(self) -> int:
        return self.block * self.wb

    @property
    def S(self) -> int:
        return len(self.sleaf)

    @staticmethod
    def build(spec, block: int, wb: int, ncomp=None, custom=False) -> "ChainLayout":
        """The layout of ``spec`` for ``block`` blocks of ``wb`` walkers;
        ``ncomp`` observable components (default: the default measure's,
        ``engine.obs_components(spec)``), ``custom`` for a custom measure.
        The weights' dtype is ``spec.wdtype``."""
        dleaf = [i for i, li in enumerate(spec.leaves) if li.ndraw > 0]
        rows, slot0, tab_off, sm_off, h_off = [], 0, 0, 0, 0
        for d, lidx in enumerate(dleaf):
            li = spec.leaves[lidx]
            disc = isinstance(li.leaf, Discrete)
            nb = li.leaf.nbin if disc else li.leaf.ninc
            sm = -1
            if disc and nb <= SMEM_CDF_NBIN and sm_off + nb <= SMEM_CDF_FLOATS:
                sm, sm_off = sm_off, sm_off + nb
            hist = -1
            if li.leaf.adapt:
                hist, h_off = h_off, h_off + li.nhist
            rows.append([int(disc), nb, tab_off, sm, li.leaf.lower if disc else 0,
                         slot0, hist, li.group])
            tab_off += 2 * nb + (1 if disc else 0)
            slot0 += li.ndraw
        groups = []
        for g in range(spec.nvar):
            ds = [d for d, lidx in enumerate(dleaf) if spec.leaves[lidx].group == g]
            groups.append([ds[0], ds[-1] + 1, spec.maxdof[g]] if ds else [0, 0, 0])
        pairs = [(g, s) for g in range(spec.nvar) for s in range(spec.maxdof[g])]
        padm = np.asarray([[spec.mask_pad[i, g, s] for g, s in pairs]
                           for i in range(spec.N + 1)], np.int32).reshape(spec.N + 1, -1)
        usedm = np.asarray([[spec.mask_used[i, g, s] for g, s in pairs]
                            for i in range(spec.N)], np.int32).reshape(spec.N, -1)
        sleaf = [d for d, lidx in enumerate(dleaf) for _ in range(spec.leaves[lidx].ndraw)]
        hfeed = np.zeros((len(sleaf), spec.N), np.int32)
        k = 0
        for lidx in dleaf:
            li = spec.leaves[lidx]
            for s in range(li.ndraw):
                if li.leaf.adapt:
                    hfeed[k] = spec.mask_used[:spec.N, li.group, s]
                k += 1
        leaf = np.asarray(rows, np.int32).reshape(-1, LEAF_FIELDS)
        groups = np.asarray(groups, np.int32).reshape(-1, 3)
        elig = [g for g in range(spec.nvar) if spec.maxdof[g] > 0]
        meta = np.concatenate([leaf.ravel(), groups.ravel(), elig, padm.ravel(),
                               usedm.ravel(), hfeed.ravel(), sleaf]).astype(np.int32)
        dev = spec.device
        widx = torch.arange(wb, dtype=torch.int64, device=dev).repeat(block)
        if ncomp is None:
            ncomp = obs_components(spec)
        return ChainLayout(spec=spec, block=block, wb=wb, ncomp=ncomp, custom=custom,
                           dleaf=dleaf, leaf=leaf,
                           groups=groups, elig=elig, hfeed=hfeed, sleaf=sleaf, tab_size=tab_off,
                           smem_floats=sm_off, nhist=h_off,
                           meta=torch.as_tensor(meta, device=dev), widx=widx,
                           elig_t=torch.as_tensor(elig, dtype=torch.int64, device=dev),
                           gmd_t=torch.as_tensor(groups[:, 2], device=dev))

    def tables(self, params) -> torch.Tensor:
        """The float32 map tables ``tab`` of this iteration's ``params``."""
        parts = []
        for lidx in self.dleaf:
            a, b = params["leaf"][lidx]
            parts += [a.reshape(-1), b.reshape(-1)]
        return torch.cat(parts).to(torch.float32).contiguous()

    def leaf_rows(self, slots: torch.Tensor):
        """Per spec leaf, its ``[ndraw, W]`` rows of a ``[S, W]`` slot field
        (empty for a leaf with nothing drawn)."""
        out, k = [], 0
        for li in self.spec.leaves:
            out.append(slots[k:k + li.ndraw])
            k += li.ndraw
        return out


@dataclasses.dataclass
class ChainState:
    """The walkers' state and accumulators, all on one device.

    Slots ``[S, W]``: ``cur_val``/``prp_val`` float32 (int32 bits for a
    Discrete slot), ``*_gidx`` int32, ``*_prob`` float32.  ``prop [W]``,
    ``move [2, W]`` (group, slot), weights ``w [N, W]`` (``spec.wdtype``,
    as ``relw``), padding factors
    ``pad [nd, W]``, joint density ``p [W]``; float64 accumulators ``obs
    [ncomp, W]``, ``nrm [W]``, ``vis [nd, W]``; int32 tallies ``pc``/``ac
    [nvar, W]``; float64 histograms ``hist [H]``, the adaptive leaves' bins
    one after the other; with a custom measure, the relative weights
    ``relw [N, W]`` of the last measured step (``[0, W]`` without).
    """

    cur_val: torch.Tensor
    cur_gidx: torch.Tensor
    cur_prob: torch.Tensor
    prp_val: torch.Tensor
    prp_gidx: torch.Tensor
    prp_prob: torch.Tensor
    prop: torch.Tensor
    move: torch.Tensor
    w: torch.Tensor
    pad: torch.Tensor
    p: torch.Tensor
    obs: torch.Tensor
    nrm: torch.Tensor
    vis: torch.Tensor
    pc: torch.Tensor
    ac: torch.Tensor
    hist: torch.Tensor
    relw: torch.Tensor

    @staticmethod
    def zeros(lay: ChainLayout) -> "ChainState":
        dev = lay.spec.device
        return ChainState(**{name: torch.zeros(shape, dtype=dtype, device=dev)
                             for name, dtype, shape in _state_fields(lay)})

    def clone(self) -> "ChainState":
        return ChainState(**{f.name: getattr(self, f.name).clone()
                             for f in dataclasses.fields(self)})


def _state_fields(lay: ChainLayout):
    """``(name, dtype, shape)`` of every ChainState field for ``lay``."""
    spec, S, W = lay.spec, lay.S, lay.W
    n, nd = spec.N, spec.N + 1
    f32, i32, f64, wt = torch.float32, torch.int32, torch.float64, spec.wdtype
    return (("cur_val", f32, (S, W)), ("cur_gidx", i32, (S, W)), ("cur_prob", f32, (S, W)),
            ("prp_val", f32, (S, W)), ("prp_gidx", i32, (S, W)), ("prp_prob", f32, (S, W)),
            ("prop", f32, (W,)), ("move", i32, (2, W)), ("w", wt, (n, W)),
            ("pad", f32, (nd, W)), ("p", f32, (W,)), ("obs", f64, (lay.ncomp, W)),
            ("nrm", f64, (W,)), ("vis", f64, (nd, W)), ("pc", i32, (spec.nvar, W)),
            ("ac", i32, (spec.nvar, W)), ("hist", f64, (max(lay.nhist, 1),)),
            ("relw", wt, (n if lay.custom else 0, W)))


def _check_state(lay: ChainLayout, st: ChainState, dev):
    for name, dtype, shape in _state_fields(lay):
        _check(getattr(st, name), name, dtype, shape, dev)
    _check(lay.meta, "meta", torch.int32, lay.meta.shape, dev)


def _device_of(st: ChainState, name: str) -> torch.device:
    dev = st.cur_prob.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


# ---------------------------------------------------------------------------
# random bits shared by the plain versions
# ---------------------------------------------------------------------------

def _walker_base(lay: ChainLayout, kd: torch.Tensor, t: int) -> torch.Tensor:
    """``mix32(j ^ k1) + k2`` per walker: every draw of step ``t`` is
    ``mix32(base + c*0x85EBCA6B)`` (``ops/rng.py:draw``)."""
    tt = torch.full((kd.shape[0],), t, dtype=torch.int64, device=kd.device)
    k1, k2 = chunk_keys(kd.long() & MASK32, tt)
    k1 = k1.repeat_interleave(lay.wb)
    k2 = k2.repeat_interleave(lay.wb)
    return (mix32(lay.widx ^ k1) + k2) & MASK32


def _uniform(base: torch.Tensor, c: int) -> torch.Tensor:
    """Uniform in (0, 1) from the ``c``-th draw: ``((bits >> 8) + 0.5)
    * 2^-24``, the grain of ``mcintegration_tpu/ops/grid.py:uniform_open01``."""
    bits = mix32((base + ((c * 0x85EBCA6B) & MASK32)) & MASK32)
    return ((bits >> 8).to(torch.float32) + 0.5) * 2.0 ** -24


def _draw_leaf(lay: ChainLayout, tab: torch.Tensor, d: int, u: torch.Tensor):
    """Drawn leaf ``d``'s map draw: (val's bits as int32, gidx, prob).

    The plain versions move ``val`` as int32 bits, so a Discrete value is
    never touched by float arithmetic (its bits may read as a denormal)."""
    kind, nb, off, _, lower = (int(x) for x in lay.leaf[d, :5])
    if kind == 1:
        gidx, prob = sample_discrete(u, tab[off:off + nb + 1], tab[off + nb + 1:off + 2 * nb + 1])
        return gidx + lower, gidx, prob
    x, iy, prob = sample_continuous(u, tab[off:off + nb], tab[off + nb:off + 2 * nb])
    return x.view(torch.int32), iy, prob


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


# ---------------------------------------------------------------------------
# chain_propose
# ---------------------------------------------------------------------------

def chain_propose_plain(lay: ChainLayout, tab, kd, t: int, st: ChainState, init=False):
    """Plain torch version of ``csrc/chain_propose.cu`` (same bits)."""
    base = _walker_base(lay, kd, t)
    if init:
        for k, d in enumerate(lay.sleaf):
            val, gidx, prob = _draw_leaf(lay, tab, d, _uniform(base, SALT_INIT + k))
            for v_, g_, p_ in ((st.cur_val, st.cur_gidx, st.cur_prob),
                               (st.prp_val, st.prp_gidx, st.prp_prob)):
                _bits(v_)[k], g_[k], p_[k] = val, gidx, prob
        return
    e = (_uniform(base, SALT_GROUP) * len(lay.elig)).to(torch.int32).clamp_(max=len(lay.elig) - 1)
    g = lay.elig_t[e.long()]
    md_i = lay.gmd_t[g]
    s = torch.minimum((_uniform(base, SALT_SLOT) * md_i.to(torch.float32)).to(torch.int32),
                      md_i - 1)
    prop = torch.ones(lay.W, dtype=torch.float32, device=kd.device)
    for gg in lay.elig:
        glo, ghi, md = (int(x) for x in lay.groups[gg])
        sel = g == gg
        sg = s.clamp(max=md - 1).long()[None]
        pg = torch.ones_like(prop)
        for d in range(glo, ghi):
            val, gidx, prob = _draw_leaf(lay, tab, d, _uniform(base, SALT_LEAF + d))
            k0 = int(lay.leaf[d, 5])
            rows = slice(k0, k0 + md)
            pg = pg * (st.cur_prob[rows].gather(0, sg)[0] / prob)
            for buf, new in ((_bits(st.prp_val), val), (st.prp_gidx, gidx),
                             (st.prp_prob, prob)):
                old = buf[rows].gather(0, sg)[0]
                buf[rows] = buf[rows].scatter(0, sg, torch.where(sel, new, old)[None])
        prop = torch.where(sel, pg, prop)
    st.prop.copy_(prop)
    st.move[0] = g.to(torch.int32)
    st.move[1] = s


def _propose_args(lay: ChainLayout, tab, kd, t: int, st: ChainState, init: bool):
    """The argument list of ``mci_chain_propose`` (without the stream)."""
    return (kd.data_ptr(), t, int(init), lay.W, lay.wb, len(lay.dleaf), lay.S,
            lay.spec.nvar, len(lay.elig), lay.meta.data_ptr(), tab.data_ptr(),
            lay.smem_floats, st.cur_val.data_ptr(), st.cur_gidx.data_ptr(),
            st.cur_prob.data_ptr(), st.prp_val.data_ptr(), st.prp_gidx.data_ptr(),
            st.prp_prob.data_ptr(), st.prop.data_ptr(), st.move.data_ptr())


def chain_propose(lay: ChainLayout, tab, kd, t: int, st: ChainState, init=False):
    """Step ``t``'s proposal into ``st.prp_*``, ``st.prop`` and ``st.move``;
    with ``init``, the first draw of every slot into both copies."""
    dev = _device_of(st, "chain_propose")
    if dev.type == "cpu":
        return chain_propose_plain(lay, tab, kd, t, st, init)
    _check_state(lay, st, dev)
    _check(tab, "tab", torch.float32, (lay.tab_size,), dev)
    _check(kd, "kd", torch.int32, (lay.block, 2), dev)
    if not 0 <= t < 2 ** 31:
        raise ValueError(f"chain_propose: step {t} out of range")
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mci_chain_propose(*_propose_args(lay, tab, kd, t, st, init), stream)
    _build.check(lib, err, "chain_propose")
    launch_counts["chain_propose"] += 1


# ---------------------------------------------------------------------------
# chain_accept
# ---------------------------------------------------------------------------

def chain_accept_plain(lay: ChainLayout, rw, kd, t: int, st: ChainState, nw,
                       init=False, measure=False):
    """Plain torch version of ``csrc/chain_accept.cu``, both
    instantiations: the same float32 operations, and float64 histogram sums
    in another order."""
    spec = lay.spec
    n, nd, norm = spec.N, spec.N + 1, spec.norm
    slotp = spec.slot_probs(lay.leaf_rows(st.prp_prob))
    npad = torch.stack([spec.padding_probability(slotp, i) for i in range(nd)])
    new_p = spec.joint_probability(nw, npad, rw)
    if init:
        accept = torch.ones(lay.W, dtype=torch.bool, device=nw.device)
    else:
        u = _uniform(_walker_base(lay, kd, t), SALT_ACCEPT)
        accept = (u < st.prop * new_p / st.p) & (st.prop > TINY_F32)
        for cur, prp in ((st.cur_val, st.prp_val), (st.cur_gidx, st.prp_gidx),
                         (st.cur_prob, st.prp_prob)):
            cur, prp = _bits(cur), _bits(prp)
            merged = torch.where(accept, prp, cur)
            cur.copy_(merged)
            prp.copy_(merged)
    st.w.copy_(torch.where(accept, nw, st.w))
    st.pad.copy_(torch.where(accept, npad, st.pad))
    st.p.copy_(torch.where(accept, new_p, st.p))
    if init:
        return
    for g in lay.elig:
        sel = st.move[0] == g
        st.pc[g] += sel.to(torch.int32)
        st.ac[g] += (sel & accept).to(torch.int32)
    # histogram weight of the state after the move (vegasmc.py:359-368)
    slotp = spec.slot_probs(lay.leaf_rows(st.cur_prob))
    for i in range(n):
        feeds = np.nonzero(lay.hfeed[:, i])[0]
        if len(feeds) == 0:
            continue
        prob_i = spec.probability(slotp, i)
        wf2 = torch.clamp(weight_abs2(st.w[i]) / prob_i * st.pad[i] / st.p,
                          max=HIST_CLIP).double()
        for k in feeds:
            off = int(lay.leaf[lay.sleaf[k], 6])
            st.hist.index_add_(0, st.cur_gidx[k].long() + off, wf2)
    if measure:                                # (vegasmc.py:371-390)
        for i in range(n):
            relw = weight_scale(st.w[i], st.pad[i] / st.p)
            if lay.custom:
                st.relw[i] = relw
            elif lay.spec.cplx:
                re, im = torch.view_as_real(relw).unbind(-1)
                st.obs[2 * i] += re.double()
                st.obs[2 * i + 1] += im.double()
            else:
                st.obs[i] += relw.double()
            st.vis[i] += (weight_abs(st.w[i]) * st.pad[i] * rw[i] / st.p).double()
        norm_w = st.pad[norm] / st.p
        st.nrm.add_(norm_w.double())
        st.vis[norm] += (rw[norm] * norm_w).double()


def _accept_args(lay: ChainLayout, rw, kd, t: int, st: ChainState, nw,
                 init: bool, measure: bool):
    """The argument list of ``mci_chain_accept`` (without the stream)."""
    return (kd.data_ptr(), t, int(init), int(measure), int(lay.custom), lay.W, lay.wb,
            len(lay.dleaf), lay.S, lay.spec.nvar, len(lay.elig), lay.spec.N,
            lay.meta.data_ptr(), rw.data_ptr(), lay.nhist,
            int(lay.nhist <= SMEM_HIST_BINS), st.prp_val.data_ptr(),
            st.prp_gidx.data_ptr(), st.prp_prob.data_ptr(), st.cur_val.data_ptr(),
            st.cur_gidx.data_ptr(), st.cur_prob.data_ptr(), nw.data_ptr(),
            st.prop.data_ptr(), st.move.data_ptr(), st.w.data_ptr(),
            st.pad.data_ptr(), st.p.data_ptr(), st.obs.data_ptr(),
            st.nrm.data_ptr(), st.vis.data_ptr(), st.pc.data_ptr(),
            st.ac.data_ptr(), st.hist.data_ptr(), st.relw.data_ptr())


def chain_accept(lay: ChainLayout, rw, kd, t: int, st: ChainState, nw,
                 init=False, measure=False):
    """Step ``t``'s Metropolis decision on the proposal with weights ``nw
    [N, W]`` (``spec.wdtype``), in place on ``st``; with
    ``init``, take the first state.  On a ``measure`` step the default
    measure adds into ``st.obs``, and a custom one (``lay.custom``) writes
    ``st.relw``."""
    dev = _device_of(st, "chain_accept")
    if dev.type == "cpu":
        return chain_accept_plain(lay, rw, kd, t, st, nw, init, measure)
    spec = lay.spec
    _check_state(lay, st, dev)
    _check(nw, "nw", spec.wdtype, (spec.N, lay.W), dev)
    _check(rw, "rw", torch.float32, (spec.N + 1,), dev)
    _check(kd, "kd", torch.int32, (lay.block, 2), dev)
    if not 0 <= t < 2 ** 31:
        raise ValueError(f"chain_accept: step {t} out of range")
    name = "chain_accept_complex" if spec.cplx else "chain_accept"
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, "mci_" + name)(
            *_accept_args(lay, rw, kd, t, st, nw, init, measure), stream)
    _build.check(lib, err, name)
    launch_counts[name] += 1


# ---------------------------------------------------------------------------
# chain_measure
# ---------------------------------------------------------------------------

def chain_measure_plain(lay: ChainLayout, m, st: ChainState):
    """Plain torch version of ``csrc/chain_measure.cu``."""
    st.obs.add_(m.double())


def chain_measure(lay: ChainLayout, m, st: ChainState):
    """Add the custom measure's output ``m [ncomp, W]`` float32 into the
    walkers' float64 accumulators ``st.obs``."""
    dev = _device_of(st, "chain_measure")
    if dev.type == "cpu":
        return chain_measure_plain(lay, m, st)
    _check(m, "m", torch.float32, (lay.ncomp, lay.W), dev)
    _check(st.obs, "obs", torch.float64, (lay.ncomp, lay.W), dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mci_chain_measure(lay.ncomp, lay.W, m.data_ptr(), st.obs.data_ptr(), stream)
    _build.check(lib, err, "chain_measure")
    launch_counts["chain_measure"] += 1
