"""Configuration → static :class:`Spec`, and the integrand contract.

Counterpart of ``mcintegration_tpu/solvers/engine.py:35-286``.  A
:class:`~mcintegration_tpu_torch.configuration.Configuration` compiles into
a static :class:`Spec` (leaf layout, dof and padding masks) plus
per-iteration device parameters (each leaf's float32 grid and increments,
or CDF and masses).  The walker probability algebra (``slot_probs``,
``padding_probability``, ``probability``, ``joint_probability``) works on
``[..., W]`` tensors with the slot axis leading; it is the plain version of
the padding factors and joint density inside ``csrc/chain_accept.cu``.

User integrands are torch functions ``f(x, c)`` where ``x[k]`` is slot
``k``'s values, a tensor of any batch shape (the batched call of
``pallas_vegas.make_eval_batched`` written in torch).  An integrand that is
not elementwise across samples is detected by :meth:`Spec.probe_batched`
and then evaluated per sample under ``torch.func.vmap``.

Weights are float32, or complex64 for ``Configuration(type=complex)``
(``Spec.wdtype``, as ``mcintegration_tpu/main.py:341``).  A complex
observable leaf is two groups of real components, all its real parts and
then all its imaginary parts (``pallas_chain.py:447-458``); the solvers
accumulate real float64 sums and :func:`obs_tree` recombines them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List

import numpy as np
import torch

from ..common import weight_abs
from ..configuration import Configuration
from ..models.variable import CompositeVar, Discrete, FermiK, leaves_of
from ..ops._build import tree_sum


class UserConfig:
    """The lightweight config object passed into user integrands.

    Exposes the commonly used attributes of the reference ``Configuration``
    (userdata, dof, N, norm, maxdof).
    """

    def __init__(self, cfg: Configuration):
        self.userdata = cfg.userdata
        self.dof = cfg.dof
        self.N = cfg.N
        self.norm = cfg.norm
        self.maxdof = cfg.maxdof


class WeightBuffer:
    """Mutable weights buffer for ``inplace=True`` integrands.

    The reference's inplace mode writes weights into a preallocated array
    (src/vegas/montecarlo.jl:141-144); here the integrand assigns one
    tensor (or number) per integrand index.
    """

    def __init__(self, n: int):
        self.n = n
        self._vals = [0.0] * n

    def __setitem__(self, i, v):
        self._vals[i] = v

    def __getitem__(self, i):
        return self._vals[i]

    def __len__(self):
        return self.n


@dataclasses.dataclass
class LeafInfo:
    group: int          # which var-type (dof column) this leaf belongs to
    leaf: Any           # the host-side variable object
    offset: int         # leading user-pinned slots
    ndraw: int          # = maxdof of the group: slots the MC owns
    nslots: int         # offset + ndraw (visible to the integrand)
    nhist: int          # histogram bins


class Spec:
    """Static compilation of a Configuration for the device path."""

    def __init__(self, cfg: Configuration, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.N = cfg.N
        self.norm = cfg.norm
        self.nvar = cfg.nvar
        self.maxdof = list(cfg.maxdof)
        self.uconfig = UserConfig(cfg)
        # the weights' dtype: complex64 for type=complex (main.py:341 of the
        # JAX package), else float32
        self.cplx = cfg.type is complex
        self.wdtype = torch.complex64 if self.cplx else torch.float32

        self.leaves: List[LeafInfo] = []
        self.group_leaves: List[List[int]] = [[] for _ in range(cfg.nvar)]
        for gi, v in enumerate(cfg.var):
            for leaf in leaves_of(v):
                li = LeafInfo(
                    group=gi,
                    leaf=leaf,
                    offset=getattr(leaf, "offset", 0),
                    ndraw=cfg.maxdof[gi],
                    nslots=getattr(leaf, "offset", 0) + cfg.maxdof[gi],
                    nhist=leaf.nhist,
                )
                self.group_leaves[gi].append(len(self.leaves))
                self.leaves.append(li)
        # values of the user-pinned offset slots, on the device once
        self.fixed = [torch.as_tensor(li.leaf.fixed_values()[: li.offset], device=self.device)
                      for li in self.leaves]

        nd = cfg.N + 1
        # dof mask [nd, nvar, max_maxdof]: True where slot pos < dof[i][v]
        mm = max(max(self.maxdof), 1)
        used = np.zeros((nd, cfg.nvar, mm), dtype=bool)
        for i in range(nd):
            for v in range(cfg.nvar):
                used[i, v, : cfg.dof[i][v]] = True
        self.mask_used = used
        # padding mask: slot used by the FULL space but not by integrand i
        full = np.zeros((cfg.nvar, mm), dtype=bool)
        for v in range(cfg.nvar):
            full[v, : cfg.maxdof[v]] = True
        self.mask_pad = full[None, :, :] & ~used
        # integrands whose dof == maxdof need no padding factor
        self.pad_trivial = [bool(np.all(~self.mask_pad[i])) for i in range(nd)]

    # ------------------------------------------------------------------
    def device_params(self):
        """Per-iteration device constants: each leaf's (grid, inc), or (cdf,
        dist) for a Discrete leaf, and the reweight vector."""
        return {
            "leaf": [li.leaf.device_params(self.device) for li in self.leaves],
            "reweight": torch.as_tensor(self.cfg.reweight, dtype=torch.float32,
                                        device=self.device),
        }

    def view(self, leaf_vals):
        """User-facing variable view over leaf values ``[ndraw, *batch]``.

        Offset (user-pinned) slots are prepended as constants broadcast to
        the batch shape; CompositeVar groups become tuples of member views.
        Discrete values are int32 and pass through as they are.  Works per
        sample (``batch == ()``, also under ``torch.func.vmap``) and batched.
        """
        views = []
        for gi, v in enumerate(self.cfg.var):
            member_views = []
            for lidx in self.group_leaves[gi]:
                li = self.leaves[lidx]
                drawn = leaf_vals[lidx]
                if li.offset > 0:
                    fixed = self.fixed[lidx]            # [offset] or [offset, D]
                    lead = tuple(fixed.shape)
                    batch = tuple(drawn.shape[len(lead):])
                    fixed = fixed.reshape(lead + (1,) * len(batch)).expand(lead + batch)
                    full = torch.cat([fixed, drawn])
                else:
                    full = drawn
                member_views.append(full)
            if isinstance(v, CompositeVar):
                views.append(tuple(member_views))
            else:
                views.append(member_views[0])
        if len(views) == 1:
            return views[0]
        return tuple(views)

    # ------------------------------------------------------------------
    # walker probability algebra (reference variable.jl:587-678)
    # ------------------------------------------------------------------
    def slot_probs(self, probs):
        """Per-group slot probabilities ``[nvar, mm, *batch]``, padded with 1.

        ``probs[lidx]`` is leaf ``lidx``'s ``[ndraw, *batch]`` slot
        probabilities; a CompositeVar group multiplies its members' in leaf
        order (``mcintegration_tpu/solvers/engine.py:195-209``).
        """
        batch = tuple(probs[0].shape[1:])
        mm = max(max(self.maxdof), 1)
        out = []
        for gi in range(self.nvar):
            lidxs = self.group_leaves[gi]
            p = probs[lidxs[0]]
            for lidx in lidxs[1:]:
                p = p * probs[lidx]
            ndraw = self.leaves[lidxs[0]].ndraw
            if ndraw < mm:
                p = torch.cat([p, torch.ones((mm - ndraw,) + batch, dtype=p.dtype,
                                             device=p.device)])
            out.append(p)
        return torch.stack(out)

    @staticmethod
    def _masked_prod(slotp, mask):
        """Product of ``slotp[g, s]`` over the True entries of ``mask``, in
        (group, slot) order, as the accept kernel multiplies them."""
        f = torch.ones(slotp.shape[2:], dtype=slotp.dtype, device=slotp.device)
        for g, s in zip(*np.nonzero(mask)):
            f = f * slotp[g, s]
        return f

    def padding_probability(self, slotp, i: int):
        """prod of probs over slots NOT used by integrand i (variable.jl:628-641)."""
        return self._masked_prod(slotp, self.mask_pad[i])

    def probability(self, slotp, i: int):
        """prod of probs over slots used by integrand i (variable.jl:606-619)."""
        return self._masked_prod(slotp, self.mask_used[i])

    def joint_probability(self, weights, pads, reweight):
        """p = r_norm*pad_norm + sum_i |w_i|*r_i*pad_i (montecarlo.jl:161-166).

        ``weights [N, *batch]`` (float32 or complex64), ``pads [nd, *batch]``,
        ``reweight [nd]``; the terms are added in integrand order.
        """
        p = reweight[self.norm] * pads[self.norm]
        for i in range(self.N):
            p = p + weight_abs(weights[i]) * reweight[i] * pads[i]
        return p

    # ------------------------------------------------------------------
    # integrand evaluation
    # ------------------------------------------------------------------
    def _call(self, integrand, inplace, leaf_vals):
        v = self.view(leaf_vals)
        if inplace:
            buf = WeightBuffer(self.N)
            integrand(v, buf, self.uconfig)
            return [buf[i] for i in range(self.N)]
        return integrand(v, self.uconfig)

    def make_eval(self, integrand: Callable, inplace: bool):
        """Per-sample evaluation: f(leaf_vals [ndraw]) -> weights [N]."""
        def _eval(leaf_vals):
            w = self._call(integrand, inplace, leaf_vals)
            return _finite_guard(pack_weights(w, self.N, self.device, self.wdtype))

        return _eval

    def make_eval_batched(self, integrand: Callable, inplace: bool):
        """Batched evaluation: f(leaf_vals [ndraw, *batch]) -> [N, *batch].

        Reference-style integrands are elementwise in the sample axes, so
        one call on the batched tensors evaluates every sample at once.
        """
        n = self.N

        def _eval(leaf_vals):
            shape = tuple(leaf_vals[0].shape[1:])
            w = self._call(integrand, inplace, leaf_vals)
            ws = list(w) if isinstance(w, (tuple, list)) else [w]
            if len(ws) == 1 and n > 1:
                ws = [ws[0][i] for i in range(n)]
            if len(ws) != n:
                raise ValueError(f"integrand returned {len(ws)} weights, want {n}")
            return torch.stack([
                torch.broadcast_to(_finite_guard(_as_weight(wi, self.device, self.wdtype)),
                                   shape)
                for wi in ws])

        return _eval

    def make_eval_vmapped(self, integrand: Callable, inplace: bool):
        """Per-sample evaluation under ``torch.func.vmap`` over the batch:
        f(leaf_vals [ndraw, *batch]) -> [N, *batch]."""
        return self._vmapped(self.make_eval(integrand, inplace), (self.N,))

    # ---- leaf shapes: a leaf is [ndraw, *batch], a FermiK leaf [ndraw, D, *batch]
    def _lead(self, lidx: int) -> int:
        return 2 if isinstance(self.leaves[lidx].leaf, FermiK) else 1

    def batch_shape(self, leaf_vals) -> tuple:
        return tuple(leaf_vals[0].shape[self._lead(0):])

    def _vmapped(self, per_sample: Callable, out_lead: tuple, extra_lead: int = 0):
        """``per_sample(leaf_vals, *extra)`` mapped over the batch axes of
        the leaves (and of each extra ``[*lead, *batch]`` argument, with
        ``extra_lead`` leading axes) with ``torch.func.vmap``; its output
        ``out_lead`` gains the batch axes."""
        def _eval(leaf_vals, *extra):
            shape = self.batch_shape(leaf_vals)
            leads = [self._lead(i) for i in range(len(leaf_vals))]
            flat = [v.reshape(tuple(v.shape[:k]) + (-1,)) for v, k in zip(leaf_vals, leads)]
            ex = [e.reshape(tuple(e.shape[:extra_lead]) + (-1,)) for e in extra]
            out = torch.func.vmap(per_sample, in_dims=(leads,) + (extra_lead,) * len(ex),
                                  out_dims=len(out_lead))(flat, *ex)
            return out.reshape(out_lead + shape)

        return _eval

    # ---- the mcmc conventions: f(idx, x, c) and measure(idx, x, relw, c) ----
    def make_eval_batched_idx(self, integrand: Callable) -> List[Callable]:
        """One batched evaluation per integrand index ``i`` for the mcmc
        convention ``integrand(i, x, c)`` (pallas_mcmc.py:233-254):
        f_i(leaf_vals [.., *batch]) -> [*batch] of the weight dtype."""
        def make(i):
            def _eval(leaf_vals):
                w = integrand(i, self.view(leaf_vals), self.uconfig)
                return torch.broadcast_to(_finite_guard(_as_weight(w, self.device, self.wdtype)),
                                          self.batch_shape(leaf_vals))
            return _eval

        return [make(i) for i in range(self.N)]

    def make_eval_vmapped_idx(self, integrand: Callable) -> List[Callable]:
        """The per-sample ``integrand(i, x, c)`` under ``torch.func.vmap``."""
        def make(i):
            def per_sample(leaf_vals):
                w = integrand(i, self.view(leaf_vals), self.uconfig)
                return _finite_guard(_as_weight(w, self.device, self.wdtype).reshape(()))
            return self._vmapped(per_sample, ())

        return [make(i) for i in range(self.N)]

    def _measure_components(self, out, leaves, batch: tuple):
        """A measure's output pytree as ``[ncomp, *batch]`` float32: its
        leaves flattened in order, each broadcast to ``shape + batch``, a
        complex leaf as its real parts and then its imaginary parts.
        ``leaves`` is :func:`obs_leaves` of the observable pytree."""
        out = tree_leaves(out)
        if len(out) != len(leaves):
            raise ValueError(f"measure returned {len(out)} observables, want {len(leaves)}")
        parts = []
        for k, (z, (sh, cplx)) in enumerate(zip(out, leaves)):
            if not cplx and (z.is_complex() if isinstance(z, torch.Tensor)
                             else np.iscomplexobj(z)):
                if not self.cplx:
                    refuse_complex()
                raise ValueError(f"observable leaf {k} is real, but the measure returned "
                                 "complex values for it: declare it complex in obs")
            z = torch.broadcast_to(_as_weight(z, self.device, torch.complex64 if cplx
                                              else torch.float32), sh + batch)
            if cplx:
                parts += [p.reshape((-1,) + batch) for p in torch.view_as_real(z).unbind(-1)]
            else:
                parts.append(z.reshape((-1,) + batch))
        # one leaf needs no copy: at 2^26 samples a launch, the copy of ten
        # components would move 5 GiB
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def probe_relw(self, shape) -> torch.Tensor:
        """The relative weights a measure's probe passes: uniform in [0.1, 1)
        (pallas_chain.py:272-321), with imaginary parts in [-0.5, 0.5) on a
        complex run (``validate_measure_batched_pairs``)."""
        rng = np.random.default_rng(98765)
        relw = torch.as_tensor(rng.uniform(0.1, 1.0, shape), dtype=torch.float32,
                               device=self.device)
        if self.cplx:
            im = torch.as_tensor(rng.uniform(-0.5, 0.5, shape), dtype=torch.float32,
                                 device=self.device)
            relw = torch.complex(relw, im)
        return relw

    def make_measure_batched(self, measure: Callable, obs_proto) -> Callable:
        """The batched custom measure of the :vegas and :vegasmc convention
        ``measure(x, relw, c)`` (pallas_chain.py:245-269): m(leaf_vals,
        relw [N, *batch]) -> [ncomp, *batch] float32.  ``relw[i]`` is
        integrand ``i``'s relative weight (complex64 on a complex run), so
        ``relw[0]`` reads as it does per sample."""
        leaves = obs_leaves(obs_proto, self.cplx)

        def _m(leaf_vals, relw):
            out = measure(self.view(leaf_vals), relw, self.uconfig)
            return self._measure_components(out, leaves, tuple(relw.shape[1:]))

        return _m

    def make_measure_vmapped(self, measure: Callable, obs_proto) -> Callable:
        """The per-sample ``measure(x, relw, c)`` under ``torch.func.vmap``."""
        return self._vmapped(self.make_measure_batched(measure, obs_proto),
                             (obs_components(self, obs_proto),), extra_lead=1)

    def pick_measure(self, measure: Callable, obs_proto):
        """``(m, reason)``: the batched custom measure where the probe
        (pallas_chain.py:272-321) reproduces the per-sample one, else the
        measure under ``torch.func.vmap``, and why (empty when batched)."""
        m_b = self.make_measure_batched(measure, obs_proto)
        m_v = self.make_measure_vmapped(measure, obs_proto)
        ok, why = self.probe_batched(m_b, m_v, self.probe_relw((self.N, 4, 2)))
        return (m_b if ok else m_v), (f"measure: {why}" if why else "")

    def make_measure_batched_idx(self, measure: Callable, obs_proto) -> List[Callable]:
        """One batched custom measure per integrand index for the mcmc
        convention ``measure(i, x, relw, c)`` (pallas_mcmc.py:332-358):
        m_i(leaf_vals, relw [*batch]) -> [ncomp, *batch] float32, the
        observable pytree's leaves flattened in order."""
        leaves = obs_leaves(obs_proto, self.cplx)

        def make(i):
            def _m(leaf_vals, relw):
                out = measure(i, self.view(leaf_vals), relw, self.uconfig)
                return self._measure_components(out, leaves, tuple(relw.shape))
            return _m

        return [make(i) for i in range(self.N)]

    def make_measure_vmapped_idx(self, measure: Callable, obs_proto) -> List[Callable]:
        """The per-sample custom measure under ``torch.func.vmap``."""
        ncomp = obs_components(self, obs_proto)
        batched = self.make_measure_batched_idx(measure, obs_proto)
        return [self._vmapped(m, (ncomp,)) for m in batched]

    def probe_leaf_values(self, rng: np.random.Generator, batch=(4, 2)):
        """In-domain probe values ``[ndraw(, D), *batch]`` per leaf: map
        interiors, Discrete values, FermiK momenta on the shell
        (pallas_mcmc.py:206-230)."""
        leaf_vals = []
        for li in self.leaves:
            leaf = li.leaf
            if isinstance(leaf, Discrete):
                v = rng.integers(leaf.lower, leaf.upper + 1, (li.ndraw,) + batch)
                leaf_vals.append(torch.as_tensor(v, dtype=torch.int32, device=self.device))
            elif isinstance(leaf, FermiK):
                kamp = leaf.kF + (rng.uniform(size=(li.ndraw, 1) + batch) - 0.5) * leaf.delta_k
                dirs = rng.normal(size=(li.ndraw, leaf.dim) + batch)
                dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
                leaf_vals.append(torch.as_tensor(kamp * dirs, dtype=torch.float32,
                                                 device=self.device))
            else:
                u = rng.uniform(0.05, 0.95, (li.ndraw,) + batch)
                leaf_vals.append(torch.as_tensor(leaf.lower + leaf.range * u,
                                                 dtype=torch.float32, device=self.device))
        return leaf_vals

    def probe_batched(self, eval_batched, eval_vmapped, *extra):
        """Does the batched call reproduce the per-sample one?

        Evaluates both on a small in-domain batch (the reference's
        ``validate_batched``, pallas_vegas.py:237-274); ``extra`` arguments
        (a custom measure's ``relw``) follow the leaf values; complex outputs
        are compared on ``torch.view_as_real``.  Returns ``(ok, reason)``;
        ``reason`` is empty when ``ok``.
        """
        leaf_vals = self.probe_leaf_values(np.random.default_rng(12345))
        try:
            wv = eval_vmapped(leaf_vals, *extra)
        except Exception as e:  # the user's integrand, any failure
            return True, (f"the per-sample probe failed under torch.func.vmap "
                          f"({type(e).__name__}: {e}); the batched call runs "
                          "unchecked")
        try:
            wb = eval_batched(leaf_vals, *extra)
        except Exception as e:  # the user's integrand, any failure
            return False, (f"the batched call failed "
                           f"({type(e).__name__}: {e}); it runs "
                           "per sample under torch.func.vmap")
        if wb.is_complex() and wv.is_complex():
            wb, wv = torch.view_as_real(wb), torch.view_as_real(wv)
        if wb.shape == wv.shape and torch.allclose(wb, wv, rtol=1e-5, atol=1e-6):
            return True, ""
        return False, ("the batched probe did not reproduce the "
                       "per-sample evaluation (not elementwise); "
                       "it runs per sample under torch.func.vmap")


def tree_leaves(tree) -> list:
    """The leaves of a list/tuple tree, depth first (an observable pytree)."""
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_unflatten(proto, leaves):
    """``leaves`` (in :func:`tree_leaves` order) in the structure of ``proto``."""
    it = iter(leaves)

    def build(p):
        if isinstance(p, (list, tuple)):
            return type(p)(build(x) for x in p)
        return next(it)

    return build(proto)


def obs_components(spec: Spec, obs_proto=None) -> int:
    """Real float64 components a run accumulates.  The default measure
    (``obs_proto`` None): one per integrand, or two with complex weights,
    Re w_i in component 2i and Im w_i in 2i+1 (``pallas_chain.py:459-462``).
    A custom measure's observable pytree: one per scalar of a real leaf,
    two per scalar of a complex one (see :func:`obs_tree`)."""
    if obs_proto is None:
        return 2 * spec.N if spec.cplx else spec.N
    return sum(int(np.prod(sh)) * (2 if c else 1) for sh, c in obs_leaves(obs_proto, spec.cplx))


def refuse_complex():
    raise NotImplementedError(
        "complex observables on a real-weight run are not served: the JAX package's "
        "XLA routes drop their imaginary part (ROADMAP.md, known faults in the "
        "reference); pass type=complex, which every solver serves")


def obs_leaves(obs_proto, cplx: bool = False) -> list:
    """``(shape, complex)`` of each leaf of the observable pytree.  A complex
    leaf on a real-weight run (``cplx`` False) raises."""
    out = []
    for p in tree_leaves(obs_proto):
        if np.iscomplexobj(p) and not cplx:
            refuse_complex()
        out.append((np.shape(p), bool(np.iscomplexobj(p))))
    return out


def obs_tree(obs_b: np.ndarray, spec: Spec, obs_proto=None):
    """Per-block sums ``obs_b [block, ncomp]`` (:func:`obs_components`) as
    ``obs_blocks``, the JAX package's layout.  The default measure
    (``obs_proto`` None) gives ``[block, N]``, complex128 with complex
    weights.  A custom measure gives the observable pytree with a leading
    ``[block]`` axis: a complex leaf's group of real parts, then its group
    of imaginary parts, recombine into complex128 (``decode_complex_numpy``,
    ``mcintegration_tpu/solvers/engine.py:289-320``)."""
    if obs_proto is None:
        return obs_b[:, 0::2] + 1j * obs_b[:, 1::2] if spec.cplx else obs_b
    cols, k, B = [], 0, obs_b.shape[0]
    for sh, c in obs_leaves(obs_proto, spec.cplx):
        m = int(np.prod(sh))
        col = obs_b[:, k:k + m].reshape((B,) + sh)
        if c:
            col = col + 1j * obs_b[:, k + m:k + 2 * m].reshape((B,) + sh)
        cols.append(col)
        k += 2 * m if c else m
    return tree_unflatten(obs_proto, cols)


def block_sums(acc: torch.Tensor, block: int) -> np.ndarray:
    """Per-walker float64 accumulators ``acc [ncomp, W]`` (walkers
    block-major) summed per block: ``[block, ncomp]`` on the host, in the
    fixed order of :func:`~mcintegration_tpu_torch.ops._build.tree_sum`, so
    a block's sums do not depend on how many blocks or components there
    are."""
    if acc.shape[0] == 0:
        return np.zeros((block, 0))
    return tree_sum(acc.view(acc.shape[0], block, -1), -1).T.cpu().numpy()


def refuse_fermik(spec: Spec, solver: str):
    """FermiK pools run on :mcmc only, as in the reference
    (test/bubble_FermiK.jl:2): any other solver raises."""
    if any(isinstance(li.leaf, FermiK) for li in spec.leaves):
        raise NotImplementedError(f"FermiK pools run on the :mcmc solver only, not on {solver}")


def tree_map(f, tree):
    """``f`` applied to every leaf of a list/tuple tree."""
    return tree_unflatten(tree, [f(x) for x in tree_leaves(tree)])


def _as_weight(w, device, dtype=torch.float32):
    if isinstance(w, torch.Tensor):
        return w.to(device=device, dtype=dtype)
    return torch.tensor(w, dtype=dtype, device=device)


def _finite_guard(w):
    """Zero out non-finite integrand values.

    In float32 a singular integrand can overflow to inf within ~1 ulp of its
    singular point; an inf/NaN weight would poison every accumulator.  The
    zeroed region is O(ulp)-measure, far below the statistical error.  A
    complex value is kept only if both parts are finite (``torch.isfinite``
    of a complex tensor; ``mcintegration_tpu/solvers/engine.py:260-271``).
    """
    return torch.where(torch.isfinite(w), w, torch.zeros_like(w))


def pack_weights(w, n: int, device, dtype=torch.float32):
    """Normalize a user integrand return (scalar/tuple/list/tensor) to [n]."""
    if isinstance(w, (tuple, list)):
        if len(w) != n:
            raise ValueError(f"integrand returned {len(w)} weights, expected {n}")
        return torch.stack([_as_weight(x, device, dtype) for x in w])
    w = _as_weight(w, device, dtype)
    if w.ndim == 0 and n == 1:
        return w[None]
    if tuple(w.shape) != (n,):
        raise ValueError(f"integrand returned shape {tuple(w.shape)}, expected ({n},)")
    return w
