"""PyTorch port: the iteration cache (``mcintegration_tpu_torch.main``), with
the JAX package's rules (tests/test_interface.py's cache tests) on all four
solvers, and its lock: a cached iteration serves one call at a time."""

import threading

import numpy as np
import pytest
import torch

import mcintegration_tpu_torch as mt
import mcintegration_tpu_torch.main as tmain
from mcintegration_tpu_torch.main import _KERNEL_CACHE, _cache_key, _callable_sig

torch.set_num_threads(1)

SOLVERS = ["vegas", "vegasmc", "mcmc", "vegasplus"]


def _pi(x, c):
    return torch.where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0) * (1.0 + x[1])


def _pi_idx(i, x, c):
    return _pi(x, c)


def _run(f, solver="vegas", seed=7, neval=2 ** 12, **kw):
    f = _pi_idx if f is _pi and solver == "mcmc" else f
    return mt.integrate(f, var=mt.Continuous(0.0, 1.0), dof=[[2]], neval=neval, niter=3,
                        solver=solver, device="cpu", verbose=-2, seed=seed,
                        min_steps_per_walker=32, **kw)


def _same(a, b) -> bool:
    return (np.array_equal(a.mean, b.mean) and np.array_equal(a.stdev, b.stdev)
            and all(np.array_equal(x[0], y[0]) for x, y in zip(a.iterations, b.iterations)))


@pytest.mark.parametrize("solver", SOLVERS)
def test_hit_is_bit_equal_to_a_fresh_build(solver):
    mt.clear_kernel_cache()
    first = _run(_pi, solver)                  # builds and caches
    assert len(_KERNEL_CACHE) == 1
    hit = _run(_pi, solver)                    # a hit: no new entry
    assert len(_KERNEL_CACHE) == 1
    fresh = _run(_pi, solver, cache=False)     # builds, leaves the cache as it was
    assert len(_KERNEL_CACHE) == 1
    assert _same(first, hit) and _same(hit, fresh)
    assert not _same(hit, _run(_pi, solver, seed=8))     # another seed: another key
    assert len(_KERNEL_CACHE) == 2


def test_float32_and_float64_each_get_their_own_build():
    """The dtype is part of the key: a float64 call of one problem does not
    hit the float32 call's iteration, and each then hits its own."""
    mt.clear_kernel_cache()
    r32 = _run(_pi)
    r64 = _run(_pi, dtype=torch.float64)
    assert len(_KERNEL_CACHE) == 2
    assert not _same(r32, r64)
    assert _same(r64, _run(_pi, dtype="float64")) and _same(r32, _run(_pi))
    assert len(_KERNEL_CACHE) == 2


def test_a_different_integrand_closure_or_attribute_misses():
    mt.clear_kernel_cache()

    def make(s):
        return lambda x, c: x[0] * 0.0 + s

    r1 = _run(make(1.0))
    r2 = _run(make(2.0))                       # same code, another closure value
    assert abs(float(r1.mean[0]) - 1.0) < 1e-6 and abs(float(r2.mean[0]) - 2.0) < 1e-6
    g = lambda x, c: x[0] * 0.0 + 0.25       # another function object
    assert abs(float(_run(g).mean[0]) - 0.25) < 1e-6

    class F:
        def __init__(self):
            self.s = 1.0

        def __call__(self, x, c):
            return x[0] * 0.0 + self.s

    h = F()
    ra = _run(h)
    h.s = 3.0
    rb = _run(h)
    assert abs(float(ra.mean[0]) - 1.0) < 1e-6
    assert abs(float(rb.mean[0]) - 3.0) < 1e-6, "a stale iteration after an attribute change"
    w = torch.tensor([1.0, 2.0])
    fw = lambda x, c: x[0] * 0.0 + w[0]
    _run(fw)
    n = len(_KERNEL_CACHE)
    w[0] = 5.0                                 # a captured tensor's contents change
    assert abs(float(_run(fw).mean[0]) - 5.0) < 1e-6
    assert len(_KERNEL_CACHE) == n + 1


def test_userdata_and_unhashable_captures_refuse():
    cfg = mt.Configuration(var=mt.Continuous(0.0, 1.0), dof=[[2]], seed=7, userdata=2.0)
    assert _cache_key(cfg, "vegas", _pi, None, mesh=None, npb=1) is None

    class Opaque:
        __slots__ = ("x",)

    h = (lambda o: lambda x, c: (o, x[0])[1])(Opaque())
    assert _callable_sig(h) is None
    mt.clear_kernel_cache()
    _run(h)
    assert len(_KERNEL_CACHE) == 0
    cfg = mt.Configuration(var=mt.Continuous(0.0, 1.0), dof=[[2]], seed=7, userdata=2.0)
    mt.integrate(_pi, config=cfg, neval=2 ** 12, niter=1, solver="vegas", device="cpu",
                 verbose=-2)
    assert len(_KERNEL_CACHE) == 0


def test_vegasplus_same_result_twice():
    """:vegasplus carries its cube counts from run to run: a hit resets them,
    so a second call gives the first call's result."""
    mt.clear_kernel_cache()
    a, b = _run(_pi, "vegasplus", neval=2 ** 14), _run(_pi, "vegasplus", neval=2 ** 14)
    assert len(_KERNEL_CACHE) == 1
    assert _same(a, b)


def test_clear_and_lru_bound():
    mt.clear_kernel_cache()
    fns = [(lambda s: lambda x, c: x[0] * 0.0 + s)(float(k)) for k in range(18)]
    for f in fns:
        mt.integrate(f, var=mt.Continuous(0.0, 1.0), dof=[[1]], neval=1024, niter=1,
                     solver="vegas", device="cpu", verbose=-2)
    assert len(_KERNEL_CACHE) == tmain._KERNEL_CACHE_MAX == 16
    firsts = {key[1]() for key in _KERNEL_CACHE}
    assert fns[0] not in firsts and fns[1] not in firsts and fns[17] in firsts
    mt.clear_kernel_cache()
    assert len(_KERNEL_CACHE) == 0


_BARRIER = threading.Barrier(2)
_WAITED = {}


def _synced(x, c):
    """The integrand of the two threads: each waits once for the other, so
    both calls are inside integrate at the same time, and notes the batch
    shape of its first call (the build's probe, or the run)."""
    me = threading.get_ident()
    if me in _SYNCED_THREADS and me not in _WAITED:
        _WAITED[me] = tuple(x[0].shape)
        _BARRIER.wait(timeout=60)
    return _pi(x, c)


_SYNCED_THREADS = set()


def _run_vplus(grid, **kw):
    """:vegasplus, whose cube counts two runs sharing an iteration would mix,
    from the grid ``grid`` (not part of the key: both threads ask for it)."""
    return mt.integrate(_synced, var=mt.Continuous(0.0, 1.0, grid=grid), dof=[[2]],
                        neval=2 ** 12, niter=3, solver="vegasplus", device="cpu",
                        verbose=-2, seed=7, **kw)


def test_two_threads_each_get_a_fresh_build():
    mt.clear_kernel_cache()
    grids = [np.linspace(0.0, 1.0, 1025), np.linspace(0.0, 1.0, 1025) ** 1.5]
    fresh = [_run_vplus(g, cache=False) for g in grids]
    _run_vplus(grids[0])                       # one cached iteration
    assert len(_KERNEL_CACHE) == 1
    out, errors = [None, None], []

    def work(k):
        _SYNCED_THREADS.add(threading.get_ident())
        try:
            out[k] = _run_vplus(grids[k])
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert len(_WAITED) == 2                   # both met inside integrate
    # one thread ran the cached iteration (its first call on a launch's
    # [block, chunks, chunk] samples), the other built its own: its first call
    # was the build's probe of the integrand
    assert sorted(len(shape) == 3 for shape in _WAITED.values()) == [False, True], _WAITED
    assert _same(out[0], fresh[0]) and _same(out[1], fresh[1])
    assert not _same(fresh[0], fresh[1])
    assert len(_KERNEL_CACHE) == 1
