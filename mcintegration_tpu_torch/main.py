"""``integrate`` — the user entry point of the PyTorch port.

Counterpart of ``mcintegration_tpu/main.py`` for ``solver="vegas"``,
``solver="vegasmc"``, ``solver="mcmc"`` and ``solver="vegasplus"`` and of the
reference's ``integrate`` (src/main.jl:71-218): niter rounds of (blocks ->
reduce -> reweight -> train), on one device or on each rank of a mesh of
processes (``parallel/mesh.py``).  Host-side per-iteration math (block
statistics src/main.jl:296-320, reweighting, grid training) runs in float64
numpy, alike on every rank.
"""

from __future__ import annotations

import copy
import hashlib
import os
import sys
import threading
import time
import types
import weakref
from typing import Callable, Optional

import numpy as np
import torch

from .configuration import Configuration
from .debug import check_iteration_stats, probe_integrand
from .ops.rng import block_keys
from .parallel.mesh import Mesh, allgather, default_mesh, mesh_size, sum_in_order
from .solvers.engine import Spec, tree_leaves, tree_map, tree_unflatten
from .solvers.mcmc import MCMCIteration
from .solvers.vegas import make_vegas_iteration
from .solvers.vegasmc import VegasMCIteration
from .solvers.vegasplus import VegasPlusIteration
from .statistics import Result, mean_std, report
from .utils import ProgressBar, StopWatch, red, yellow


# ---------------------------------------------------------------------------
# The iteration cache (``mcintegration_tpu/main.py:31-211``).
#
# Repeated integrate() calls over one problem shape reuse the built
# iteration: its integrand and measure probes, its layout tables and
# multiplier tables.  All run-to-run inputs (grids, reweight, per-block
# seeds) flow through run(params, kd), so a hit is bit-identical to a fresh
# build; :vegasplus' adaptive counts are reset on every hit (reset_state).
# Unlike the JAX package's cache, lookup and insertion hold a lock, and an
# iteration is handed to one caller at a time: it leaves the cache while it
# runs and goes back after, so a concurrent caller builds its own.
# ---------------------------------------------------------------------------
_KERNEL_CACHE: dict = {}
_KERNEL_CACHE_MAX = 16   # LRU cap: each entry pins its device tables
_CACHE_LOCK = threading.Lock()


def clear_kernel_cache():
    """Drop every cached iteration (and its device-resident tables)."""
    with _CACHE_LOCK:
        _KERNEL_CACHE.clear()


_LEAF_SIG_FIELDS = ("ninc", "nbin", "lower", "upper", "range", "offset",
                    "size", "alpha", "adapt", "nhist", "dim", "kF",
                    "delta_k", "maxK", "value_width")


def _value_sig(v, _depth=0):
    """Hashable signature of a captured value, or None if uncacheable.

    Scalars hash by value; tensors and numpy arrays by (shape, dtype,
    content digest); containers recurse.  Anything else returns None so the
    caller refuses to cache."""
    if _depth > 4:
        return None
    if v is None or isinstance(v, (bool, int, float, complex, str, bytes)):
        return ("s", v)
    if isinstance(v, types.ModuleType):
        return ("mod", v.__name__)
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu().contiguous().reshape(-1)
        return ("a", tuple(v.shape), str(v.dtype), v.device.type,
                hashlib.sha1(t.view(torch.uint8).numpy().tobytes()).hexdigest())
    if isinstance(v, (np.ndarray, np.generic)):
        a = np.asarray(v)
        if a.dtype == object:
            return None
        return ("a", a.shape, a.dtype.name,
                hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest())
    if isinstance(v, (tuple, list)):
        sub = tuple(_value_sig(x, _depth + 1) for x in v)
        return None if any(s is None for s in sub) else ("t", type(v).__name__, sub)
    if isinstance(v, dict):
        if not all(isinstance(k, str) for k in v):
            return None
        sub = tuple((k, _value_sig(v[k], _depth + 1)) for k in sorted(v))
        return None if any(s is None for _, s in sub) else ("d", sub)
    if isinstance(v, types.FunctionType):
        return _callable_sig(v, _depth + 1)
    return None


def _callable_sig(fn, _depth=0):
    """Signature of a callable's captured state (closure cells, instance
    attributes), or None if any captured value is unhashable.

    The key holds a weakref to the callable itself, which pins identity;
    this adds the contents, so a lambda over a changed closure cell, or a
    callable object whose attributes changed, misses the cache."""
    if _depth > 4:
        return None
    if isinstance(fn, types.MethodType):
        inner = _callable_sig(fn.__func__, _depth + 1)
        self_sig = _value_sig(getattr(fn, "__self__", None), _depth + 1)
        if self_sig is None:
            self_sig = _instance_sig(fn.__self__, _depth + 1)
        return None if inner is None or self_sig is None else ("m", inner, self_sig)
    if isinstance(fn, types.FunctionType):
        parts = [("code", id(fn.__code__))]
        for cell in fn.__closure__ or ():
            try:
                cv = cell.cell_contents
            except ValueError:
                return None
            s = _value_sig(cv, _depth + 1)
            if s is None:
                return None
            parts.append(s)
        if fn.__dict__:
            s = _value_sig(dict(fn.__dict__), _depth + 1)
            if s is None:
                return None
            parts.append(("attrs", s))
        return ("f", tuple(parts))
    if callable(fn):
        inst = _instance_sig(fn, _depth + 1)
        return None if inst is None else ("o", type(fn).__qualname__, inst)
    return None


def _instance_sig(obj, _depth=0):
    d = getattr(obj, "__dict__", None)
    if d is None:
        return ("i", type(obj).__qualname__)
    s = _value_sig(dict(d), _depth)
    return None if s is None else ("i", type(obj).__qualname__, s)


def _leaf_sig(leaf):
    vals = []
    for f in _LEAF_SIG_FIELDS:
        if not hasattr(leaf, f):
            continue
        s = _value_sig(getattr(leaf, f))
        if s is None:   # unhashable leaf field: make the key unique
            return (type(leaf).__name__, "nocache", id(leaf), object())
        vals.append((f, s))
    return (type(leaf).__name__,) + tuple(vals)


def _tree_sig(tree):
    def struct(t):
        if isinstance(t, (list, tuple)):
            return (type(t).__name__, tuple(struct(x) for x in t))
        return "*"
    return (struct(tree),) + tuple(
        (np.shape(x), np.asarray(x).dtype.name) for x in tree_leaves(tree))


def _cache_key(config, kernel_kind, integrand, measure, **knobs):
    """Structural cache key, or None when caching would be unsound."""
    if config.userdata is not None:
        # integrands read userdata at every call; two configs with different
        # userdata must not share an iteration probed with one of them
        return None
    fn_sig = _callable_sig(integrand)
    if fn_sig is None:
        return None
    ms_sig = None
    if measure is not None:
        ms_sig = _callable_sig(measure)
        if ms_sig is None:
            return None
    try:
        fn_ref = weakref.ref(integrand)
        ms_ref = weakref.ref(measure) if measure is not None else None
    except TypeError:
        return None
    mesh = knobs.pop("mesh", None)
    mesh_sig = None if mesh is None else (mesh.ranks, mesh.rank)
    return (
        kernel_kind, fn_ref, fn_sig, ms_ref, ms_sig, mesh_sig,
        tuple(sorted(knobs.items())),
        int(config.seed), config.N, config.norm, config.type.__name__,
        tuple(tuple(int(x) for x in row) for row in config.dof),
        tuple(tuple(int(x) for x in row) for row in config.neighbor),
        tuple(_leaf_sig(leaf) for _, leaf in config.var_leaves()),
        _tree_sig(config.observable),
    )


def _checkout(key):
    """The cached iteration of ``key``, taken out of the cache, or None."""
    if key is None:
        return None
    with _CACHE_LOCK:
        return _KERNEL_CACHE.pop(key, None)


def _checkin(key, it):
    """Put ``it`` (back) at the young end of the LRU."""
    if key is None:
        return
    with _CACHE_LOCK:
        _KERNEL_CACHE.pop(key, None)
        _KERNEL_CACHE[key] = it
        while len(_KERNEL_CACHE) > _KERNEL_CACHE_MAX:
            _KERNEL_CACHE.pop(next(iter(_KERNEL_CACHE)))


def _standardize_block(neval, nblock, nworker=1):
    """Round block count to a multiple of the worker count.

    Reference: _standardize_block (src/main.jl:220-234) with MPI ranks as
    the workers.
    """
    neval = int(neval)
    nblock = int(nblock)
    if neval <= nblock:
        raise ValueError(f"neval={neval} should be larger than block={nblock}")
    if nblock > nworker:
        nblock = (nblock // nworker) * nworker
    else:
        nblock = nworker
    nevalperblock = neval // nblock
    return nevalperblock, nblock


def do_reweight(config: Configuration, gamma: float, reweight_goal):
    """Visited-count reweighting (src/main.jl:322-346)."""
    avgstep = float(np.sum(config.visited))
    for vi in range(len(config.visited)):
        v = config.visited[vi]
        if v <= 1:
            config.reweight[vi] *= avgstep**gamma
        else:
            config.reweight[vi] *= (avgstep / v) ** gamma
    if reweight_goal is not None:
        goal = np.asarray(reweight_goal, dtype=np.float64)
        config.reweight *= goal / goal.sum()
    config.reweight /= config.reweight.sum()


def _resolve_device(device, mesh=None) -> torch.device:
    """The run's device.  On a rank of a mesh, ``"cuda"`` means
    ``cuda:{LOCAL_RANK % device_count}``; an explicit ``cuda:k`` is
    honoured."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but no CUDA device is available; pass "
                "device='cpu' to run the kernels' plain PyTorch versions")
        if dev.index is None and mesh is not None:
            local = int(os.environ.get("LOCAL_RANK", mesh.ranks[mesh.rank]))
            dev = torch.device("cuda", local % torch.cuda.device_count())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def _resolve_mesh(mesh, parallel):
    """The mesh of ranks the run spans, or None for one rank: ``mesh``, or
    with none given ``default_mesh()`` for the reference's ``parallel``
    values that do not turn the ranks off."""
    if mesh is not None:
        if not isinstance(mesh, Mesh):
            raise TypeError(
                f"mesh={type(mesh).__module__}.{type(mesh).__qualname__}: pass a mesh of "
                "ranks from mcintegration_tpu_torch.make_mesh(n), or None")
        mesh.rank                              # raises for a rank outside it
        return mesh
    if parallel in ("auto", "thread", ":thread", "nothread", ":nothread"):
        return default_mesh()
    return None


def _not_ported(what: str, item: int):
    raise NotImplementedError(
        f"{what} is not ported to mcintegration_tpu_torch yet (ROADMAP.md, "
        f"queue 1, item {item}); mcintegration_tpu serves it")


def _check_keywords(dtype, backend):
    """The reference's ``dtype`` and ``backend`` keywords: their defaults
    are served, any other value raises."""
    if dtype is not torch.float32:
        try:
            f32 = np.dtype(dtype) == np.float32
        except TypeError:
            f32 = False
        if not f32:
            _not_ported(f"dtype={dtype} (only float32)", 22)
    if backend != "auto":
        raise NotImplementedError(
            f"backend={backend!r}: mcintegration_tpu_torch has one route per device, "
            "the CUDA kernels on device='cuda' and their plain PyTorch versions on "
            "device='cpu'; pass device= instead")


def _reduce_stats(stats, mesh):
    """One iteration's statistics over the mesh's ranks, the same bits on
    every rank: the per-block rows gathered in rank order, the sums added
    in rank order (the reference's ``MPIreduceConfig!``)."""
    parts = allgather(stats, mesh)
    out = dict(stats)
    obs = [tree_leaves(p["obs_blocks"]) for p in parts]
    out["obs_blocks"] = tree_unflatten(stats["obs_blocks"], [
        np.concatenate([o[k] for o in obs]) for k in range(len(obs[0]))])
    out["norm_blocks"] = np.concatenate([p["norm_blocks"] for p in parts])
    out["hists"] = [sum_in_order([p["hists"][k] for p in parts])
                    for k in range(len(stats["hists"]))]
    for k in ("visited", "propose", "accept", "sig"):
        if k in stats:
            out[k] = sum_in_order([p[k] for p in parts])
    out["neval"] = sum(int(p["neval"]) for p in parts)
    return out


def integrate(integrand: Callable, *,
              solver: str = "vegasmc",
              config: Optional[Configuration] = None,
              neval=1e4,
              niter: int = 10,
              block: int = 16,
              verbose: int = -1,
              gamma: float = 1.0,
              adapt: bool = True,
              debug: bool = False,
              reweight_goal=None,
              ignore: Optional[int] = None,
              measure: Optional[Callable] = None,
              measurefreq: int = 1,
              thermal_ratio: float = 0.1,
              inplace: bool = False,
              parallel: str = "auto",
              print: int = -1,  # legacy alias of verbose (src/main.jl:92-93)
              timer=None,
              mesh=None,
              nwalkers: Optional[int] = None,
              min_steps_per_walker: int = 256,
              warmup: Optional[float] = None,
              dtype=torch.float32,
              backend: str = "auto",
              cache: bool = True,
              device="cuda",
              **kwargs):
    """Calculate the integrals; returns a :class:`Result`.

    Mirrors ``mcintegration_tpu.integrate`` (and the reference keyword
    surface, src/main.jl:71-90) for ``solver="vegasmc"`` (the default) on
    ``Continuous`` and ``Discrete`` pools, for ``solver="mcmc"`` on those and
    ``FermiK`` pools, for ``solver="vegas"`` on ``Continuous`` and ``Discrete``
    pools of any ``ninc`` (the uniform route for Continuous pools of one
    ``ninc``, the mixed route of the reference's XLA path otherwise), and for
    ``solver="vegasplus"`` (or ``"vegas+"``) on ``Continuous`` pools with
    ``Discrete`` pools riding along unstratified;
    ``Continuous`` and ``Discrete`` pools may be bundled in a
    ``CompositeVar``.  ``device`` names the device explicitly: ``"cuda"``
    (the default) runs the hand-written kernels and raises when no card is
    present; ``"cpu"`` runs their plain PyTorch versions.  The integrand is
    a torch function ``f(x, c)``, or ``f(idx, x, c)`` for integrand ``idx``
    on :mcmc; ``x[k]`` is slot ``k``'s values as a tensor of any batch shape
    (int32 for a Discrete pool, ``[D, *batch]`` for a FermiK pool).
    ``nwalkers``, ``min_steps_per_walker`` and ``warmup`` (the burn-in
    fraction of each chain, default 0.01) shape the :vegasmc chains as in
    the JAX package; ``nwalkers``, ``min_steps_per_walker`` and
    ``thermal_ratio`` (burn-in steps as a fraction of the measured ones,
    default 0.1) the :mcmc chains.  A custom measure returns the
    observables' contributions, shaped like ``obs``: ``measure(x, relw, c)``
    on :vegas, :vegasmc and :vegasplus, with ``relw [N, *batch]`` the
    integrands' relative weights (``relw[0]`` reads as it does per sample),
    and ``measure(idx, x, relw, c)`` on :mcmc.  ``measurefreq = k`` measures
    a k-th of the samples on every solver: every k-th step of a chain on the
    Markov solvers, every k-th sample of a block on :vegas, and on
    :vegasplus a k-th of each chunk at positions shifted at random per
    chunk; a custom measure's output is summed over the measured samples
    only.

    Weights are float32, or complex64 with ``type=complex`` on every
    solver: the integrand may return complex values, ``|w|`` (``sqrt(re^2 +
    im^2)``) drives the chains, reweighting, histograms and hypercube
    allocation, ``relw`` reaches a custom measure as complex64, observables
    may have complex leaves, and the result's means and error bars are
    complex, real and imaginary parts estimated as independent channels
    (src/statistics.jl:24-55).

    ``debug=True`` probes the integrand and the measure on a 4-sample batch
    before the run (``debug.probe_integrand``: a ``TypeError`` for a call
    that fails, the wrong number of weights, complex weights without
    ``type=complex`` or a measure that fails; a warning for non-finite
    weights) and writes a red line to stderr for each iteration whose
    statistics are not finite; it leaves the result's bits as they are.

    **The iteration cache.**  Repeated calls over one problem shape reuse
    the built iteration (up to ``_KERNEL_CACHE_MAX`` = 16, LRU), with the
    JAX package's rules: the key holds the integrand and measure by weakref
    and a content hash of their captured state (closure cells, attributes),
    the seed, the device and the mesh; userdata or unhashable captured
    state refuse the cache.  Values reached through module globals are
    invisible to it: an integrand that reads a changed global must pass
    ``cache=False`` (build fresh, the cache left as it was) or call
    :func:`clear_kernel_cache`.  The cache is safe across threads: a cached
    iteration serves one call at a time.

    **Ranks.**  Under a process group (``init_distributed``, or
    ``torchrun``), ``parallel`` in ``"auto"``, ``"thread"``, ``":thread"``,
    ``"nothread"``, ``":nothread"`` spans every rank (``default_mesh()``),
    ``mesh=make_mesh(n)`` the first ``n``, and any other ``parallel`` value
    runs one rank.  ``block`` is rounded to a multiple of the ranks; rank
    ``r`` of ``R`` runs blocks ``[r*block/R, (r+1)*block/R)`` of the
    one-rank run's seeds (the Markov solvers with the one-rank run's
    walkers a block) on ``cuda:{LOCAL_RANK % device_count}`` for
    ``device="cuda"``; each iteration's per-block rows are gathered and its
    sums added in rank order through a gloo group, so every rank trains
    alike and returns the same :class:`Result`.  Only rank 0 prints.

    ``dtype`` and ``backend`` are the reference's keywords; the port serves
    their defaults (float32, ``"auto"``) and raises on any other value,
    naming the ROADMAP.md item that will port float64.  Complex observables
    on a real-weight run raise (the reference drops their imaginary part),
    and FermiK pools raise on every solver but :mcmc, as in the reference.

    ``result.backend`` is ``"cuda"`` or ``"torch"``; ``backend_reason``
    says why, when the integrand or the measure runs per sample under
    ``torch.func.vmap``.
    """
    solver = str(solver).lstrip(":")
    if solver == "vegas+":
        solver = "vegasplus"
    if solver not in ("vegas", "vegasmc", "mcmc", "vegasplus"):
        raise ValueError(f"Solver {solver} is not supported!")
    _check_keywords(dtype, backend)
    mesh = _resolve_mesh(mesh, parallel)
    nranks = mesh_size(mesh)
    rank = 0 if mesh is None else mesh.rank
    dev = _resolve_device(device, mesh)
    lead = rank == 0          # the rank that prints

    verbose = max(print, verbose)
    if config is None:
        config = Configuration(**kwargs)
    if gamma > 1.0 and verbose >= 0 and lead:
        sys.stderr.write(red("learning rate gamma should be less than 1.0") + "\n")
    if ignore is None:
        ignore = 1 if adapt else 0

    timers = list(timer) if timer is not None else []
    if verbose > 0 and lead:
        timers.append(StopWatch(verbose, lambda cfg, *_: cfg.report()))

    nevalperblock, block = _standardize_block(neval, block, nranks)
    lo, hi = rank * block // nranks, (rank + 1) * block // nranks
    spec = Spec(config, dev)
    if debug:
        probe_integrand(spec, integrand, measure, inplace, solver, config.observable)

    key = None if not cache else _cache_key(
        config, solver, integrand, measure, mesh=mesh, device=str(dev),
        npb=int(nevalperblock), block=int(block), measurefreq=int(measurefreq),
        inplace=bool(inplace), nwalkers=nwalkers,
        min_steps_per_walker=int(min_steps_per_walker), warmup=warmup,
        thermal_ratio=float(thermal_ratio))
    it_kernel = _checkout(key)
    if it_kernel is not None:
        # a hit: this call's spec (its live config), and no state carried over
        it_kernel.spec = spec
        it_kernel.reset_state()
    else:
        it_kernel = _build_iteration(
            solver, spec, integrand, measure=measure, obs_proto=config.observable,
            inplace=inplace, measurefreq=measurefreq, block=hi - lo,
            nevalperblock=nevalperblock, nwalkers=nwalkers,
            min_steps_per_walker=min_steps_per_walker, warmup=warmup,
            thermal_ratio=thermal_ratio, nranks=nranks)
    backend_reason = it_kernel.backend_reason
    if verbose >= 0 and backend_reason and lead:
        sys.stdout.write(yellow(f"{solver}: {backend_reason}\n"))

    progress = ProgressBar(niter * block, desc="iters x blocks: ",
                           enabled=(verbose >= -1 and lead))
    start = time.time()
    results, iter_times = [], []
    for it in range(niter):
        t_it = time.time()
        # one iteration shape whatever the timers: they are polled between
        # iterations, so a progress report never changes the numbers
        kd = block_keys(config.seed, it, 0, block)[lo:hi]
        stats = it_kernel.run(spec.device_params(), kd)
        if nranks > 1:
            stats = _reduce_stats(stats, mesh)
        if debug:
            check_iteration_stats(stats, it)
        if "sig" in stats:
            # :vegasplus' cubes, from the second moments of every rank's
            # blocks: the same counts on each rank
            it_kernel.reallocate(stats["sig"])
        # ---- merge device statistics into the host config (the
        # reference's addConfig!/MPIreduceConfig!, configuration.jl:238-299)
        config.neval += stats["neval"]
        for lidx, (_, leaf) in enumerate(config.var_leaves()):
            leaf.add_statistics(stats["hists"][lidx])
        if "visited" in stats:
            config.visited += stats["visited"]
            config.propose += stats["propose"]
            config.accept += stats["accept"]

        norm_b = stats["norm_blocks"]
        if not np.all(norm_b > 0):
            raise RuntimeError(
                f"Block normalization = {norm_b.min()} is not positively defined!")
        config.normalization += float(norm_b.sum())

        # ---- block statistics (src/main.jl:275-287, 296-320) ----
        obs_sum, obs_sq = [], []
        for o in range(config.N):
            m = _divide_norm(_component(stats["obs_blocks"], o), norm_b)
            obs_sum.append(tree_map(lambda a: a.sum(axis=0), m))
            obs_sq.append(tree_map(_sq_sum_blocks, m))
        means, stds = mean_std(obs_sum, obs_sq, block)

        # ---- self-learning (src/main.jl:183-199) ----
        if solver in ("mcmc", "vegasmc"):
            do_reweight(config, gamma, reweight_goal)
        if adapt:
            for v in config.var:
                v.train()

        results.append((means, stds, _snapshot_config(config, stats["neval"])))
        iter_times.append(time.time() - t_it)
        progress.update(block, evals=stats["neval"])
        for t in timers:
            t.check(config)

    result = Result(results, ignore, config=config)
    result.backend = it_kernel.backend
    result.backend_reason = backend_reason
    result.wall_time = time.time() - start
    result.evals_per_s = result.neval / max(result.wall_time, 1e-12)
    result.iteration_times = iter_times
    _checkin(key, it_kernel)
    if verbose >= 0 and lead:
        report(result)
        if verbose > 0:
            sys.stdout.write(yellow(
                f"Total time: {time.time() - start:.2f} seconds.\n"))
    return result


def _build_iteration(solver, spec, integrand, *, measure, obs_proto, inplace, measurefreq,
                     block, nevalperblock, nwalkers, min_steps_per_walker, warmup,
                     thermal_ratio, nranks):
    """A fresh iteration of ``solver`` over this rank's ``block`` blocks of
    the ``nranks`` ranks'."""
    common = dict(measure=measure, obs_proto=obs_proto, measurefreq=measurefreq,
                  block=block, nevalperblock=nevalperblock)
    if solver == "mcmc":
        return MCMCIteration(spec, integrand, nwalkers=nwalkers,
                             min_steps_per_walker=min_steps_per_walker,
                             thermal_ratio=thermal_ratio, nranks=nranks, **common)
    if solver == "vegasmc":
        return VegasMCIteration(spec, integrand, inplace=inplace, nwalkers=nwalkers,
                                min_steps_per_walker=min_steps_per_walker,
                                warmup=0.01 if warmup is None else warmup, nranks=nranks,
                                **common)
    if solver == "vegasplus":
        return VegasPlusIteration(spec, integrand, inplace=inplace, **common)
    return make_vegas_iteration(spec, integrand, inplace=inplace, **common)


def _component(obs_blocks, o: int):
    """Integrand ``o``'s observable from the per-block observables: a pytree
    with a leading [block] axis (custom measure) or an array [block, N]."""
    if isinstance(obs_blocks, (list, tuple)):
        return obs_blocks[o]
    return np.asarray(obs_blocks)[:, o]


def _divide_norm(ob, norm_b):
    def f(a):
        a = np.asarray(a, dtype=np.complex128 if np.iscomplexobj(a) else np.float64)
        return a / norm_b.reshape((-1,) + (1,) * (a.ndim - 1))
    return tree_map(f, ob)


def _sq_sum_blocks(a):
    """Sum over blocks of the squares (complex: re and im squared apart)."""
    if np.iscomplexobj(a):
        return (a.real ** 2 + 1j * a.imag ** 2).sum(axis=0)
    return (a ** 2).sum(axis=0)


def _snapshot_config(config, iter_neval: int):
    """Full per-iteration config snapshot for the Result history.

    A deep copy of the Configuration — trained grids, reweight, tallies —
    like the reference's per-iteration deep-copied configs
    (src/main.jl:296-320).  ``neval`` is THIS iteration's eval count so
    ``Result.neval`` sums correctly.  ``userdata`` is shared by reference.
    """
    ud = config.userdata
    config.userdata = None
    try:
        snap = copy.deepcopy(config)
    finally:
        config.userdata = ud
    snap.userdata = ud
    snap.neval = int(iter_neval)
    return snap
