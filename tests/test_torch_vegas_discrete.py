"""PyTorch port: the :vegas solver's mixed route, Discrete pools and pools
of different ninc (``solvers/vegas.py:VegasMixedIteration``, the mixed
section of ``ops/vegas_kernels.py``).

- ``vegas_sample_mixed_plain`` against the reference's law written out by
  hand: the JAX package's ``ops/grid.py:sample_discrete`` and
  ``sample_continuous`` on the same uniforms, and the stratified rows'
  permuted strata.
- A spec the uniform route serves through both plain routes at one chunk
  shape: x bit for bit, obs and the histograms within rel 1e-12 (float64
  sums in another order).
- ``vegas_reduce_mixed_plain``'s histogram against a numpy one-hot
  accumulation of ``min(|w| jac, 1e17)^2`` over the integrands that use
  each slot.
- One iteration of each case of ``CASES``, and ``integrate`` over four,
  against the JAX package's XLA ``:vegas`` route (which samples the same
  law from another random stream) within 7 combined sigma, and against the
  exact values within 7 sigma:
  ``run_discrete`` and ``run_discrete2`` of ``tests/test_montecarlo.py:84-98``,
  ``t * d`` with padding and an offset, mixed ninc (64 and 32 stratified,
  1000 drawn per sample), a complex case and a ``measurefreq=3`` case.
- The Lindhard bubble on ``:vegas`` at ``tests/test_bubble.py``'s size,
  every bin within its 20 sigma of ``lindhard(q)`` (``test_bubble.py:117``).

Sigma is each package's block spread (16 blocks).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mcintegration_tpu as mj
from mcintegration_tpu.ops import grid as jgrid
from mcintegration_tpu.solvers.engine import Spec as JSpec
from mcintegration_tpu.solvers.vegas import VegasIteration as JVegasIteration

import mcintegration_tpu_torch as mt
from mcintegration_tpu_torch.ops import vegas_kernels as vk
from mcintegration_tpu_torch.ops.rng import MASK32, chunk_keys, draw
from mcintegration_tpu_torch.solvers.engine import Spec
from mcintegration_tpu_torch.solvers.vegas import (VegasIteration, VegasMixedIteration,
                                                   make_vegas_iteration, mixed_plan)

torch.set_num_threads(1)

BLOCK = 16
C, D = mt.Continuous, mt.Discrete


def _kd(seed, block=BLOCK):
    return np.random.default_rng(seed).integers(0, 2 ** 32, (block, 2), dtype=np.uint32)


def _train(cfg, seed=5):
    """Random trained maps on every adaptive leaf."""
    rng = np.random.default_rng(seed)
    for _, leaf in cfg.var_leaves():
        if leaf.adapt:
            leaf.histogram = rng.gamma(0.5, 1.0, leaf.nhist) + 1e-3
            leaf.train()
    return cfg


def _mixed(cfg, f=lambda x, c: 1.0, block=2, nevalperblock=3000, **kw):
    spec = Spec(cfg, "cpu")
    it = VegasMixedIteration(spec, f, block=block, nevalperblock=nevalperblock, **kw)
    return spec, it, it.layout, it.layout.tables(spec.device_params())


def test_route_choice_and_plan():
    """Specs of Continuous pools of one ninc keep the uniform route; the
    others take the mixed one, with the reference's chunk shaping and
    stratified leaves."""
    pi = Spec(mt.Configuration(var=C(0.0, 1.0), dof=[[2]]), "cpu")
    assert type(make_vegas_iteration(pi, lambda x, c: x[0], nevalperblock=2 ** 12)) \
        is VegasIteration
    with pytest.raises(ValueError, match="mixed route"):
        VegasIteration(Spec(mt.Configuration(var=D(1, 3), dof=[[1]]), "cpu"), lambda x, c: 1.0)
    spec = Spec(mt.Configuration(var=(C(0.0, 1.0, ninc=1024), C(0.0, 1.0, ninc=512),
                                      C(0.0, 1.0, ninc=1000), D(1, 4)), dof=[[1, 1, 1, 1]]), "cpu")
    assert mixed_plan(spec, 2 ** 26) == (131072, 512, [0, 1])
    assert type(make_vegas_iteration(spec, lambda x, c: 1.0, nevalperblock=2 ** 12)) \
        is VegasMixedIteration
    # all Discrete: c = min(nevalperblock, 131072), as the reference
    disc = Spec(mt.Configuration(var=D([(1, 3), (1, 4)]), dof=[[1]]), "cpu")
    assert mixed_plan(disc, 10 ** 6) == (131072, 8, [])
    assert mixed_plan(disc, 5000) == (5000, 1, [])
    # below the largest ninc the chunk is not reshaped: 64 and 32 stratify, 1000 does not
    mix = Spec(mt.Configuration(var=(C(0.0, 1.0, ninc=64), C(0.0, 1.0, ninc=32),
                                     C(0.0, 1.0, ninc=1000)), dof=[[1, 1, 1]]), "cpu")
    assert mixed_plan(mix, 960) == (960, 1, [0, 1])


def test_sample_plain_follows_the_reference_law():
    """Per-sample slots through the JAX package's sample_discrete and
    sample_continuous on the same uniforms; stratified slots by their rows'
    permuted strata; the values of a Discrete slot as int32 bits."""
    cfg = _train(mt.Configuration(var=(C(0.0, 2.0, ninc=100), C(-1.0, 1.0, ninc=9),
                                       D(-3, 40), D(1, 4, adapt=False)),
                                  dof=[[2, 1, 1, 2]], seed=9))
    spec, it, lay, tab = _mixed(cfg, nevalperblock=700)
    assert lay.slots[:, 0].tolist() == [vk.KIND_STRAT] * 2 + [vk.KIND_MAP, vk.KIND_DISC] + \
        [vk.KIND_DISC] * 2
    kd = it.seeds(_kd(4, 2))
    t0, T = 0, 1
    x, gidx = vk.vegas_sample_mixed_plain(lay, tab, kd, t0, T)
    k1, k2 = chunk_keys((kd.long() & MASK32)[:, None, :], torch.arange(t0, t0 + T)[None, :])
    q = torch.arange(lay.chunk)
    for k, (lidx, s) in enumerate([(0, 0), (0, 1), (1, 0), (2, 0), (3, 0), (3, 1)]):
        leaf = cfg.var[lidx]
        bits = draw(k1[..., None], k2[..., None], q, 3 * k + 3)
        u = ((bits & 0xFFFFFF).to(torch.float32) + 0.5) * 2.0 ** -24
        un = u.numpy()
        if isinstance(leaf, mt.Discrete):
            g, _ = jgrid.sample_discrete(jnp.asarray(un), jnp.asarray(leaf.accumulation, jnp.float32),
                                         jnp.asarray(leaf.distribution, jnp.float32))
            assert np.array_equal(gidx[k].numpy(), np.asarray(g))
            assert np.array_equal(x[k].view(torch.int32).numpy(), np.asarray(g) + leaf.lower)
        elif lay.slots[k, 0] == vk.KIND_MAP:
            xs, g, _ = jgrid.sample_continuous(jnp.asarray(un), jnp.asarray(leaf.grid, jnp.float32),
                                               jnp.asarray(np.diff(leaf.grid), jnp.float32))
            assert np.array_equal(gidx[k].numpy(), np.asarray(g))
            np.testing.assert_allclose(x[k].numpy(), np.asarray(xs), rtol=2e-7, atol=0)
        else:
            nb, m = leaf.ninc, lay.chunk // leaf.ninc
            sh = draw(k1, k2, torch.zeros_like(k1), 3 * k + 1).numpy() & 0x7FFFFFFF
            j = draw(k1, k2, torch.zeros_like(k1), 3 * k + 2).numpy() & 0x7FFFFFFF
            a = lay.atab[k].numpy()[j % vk.N_MULT].astype(np.int64)
            pk = (a[..., None] * (np.arange(lay.chunk) // m) + (sh % nb)[..., None]) % nb
            assert np.array_equal(gidx[k].numpy(), pk)
            g32, inc32 = leaf.grid[:-1].astype(np.float32), np.diff(leaf.grid).astype(np.float32)
            assert np.array_equal(x[k].numpy(), g32[pk] + un * inc32[pk])
            # every stratum gets m samples of each chunk
            assert np.all(np.bincount(pk[0, 0], minlength=nb) == m)


def test_uniform_spec_through_both_routes():
    """A spec the uniform route serves, at its chunk shape through the
    mixed route's plain versions: x bit for bit, obs and the histograms
    within rel 1e-12."""
    var = C([(0.0, 1.0), (0.0, 2.0)], ninc=64)
    cfg = _train(mt.Configuration(var=var, dof=[[1], [2]], seed=3))
    spec = Spec(cfg, "cpu")
    f = lambda x, c: (x[0][0] * x[1][0], torch.where(x[0][0] ** 2 + x[1][1] ** 2 < 1.0, 1.0, 0.0))
    uni = VegasIteration(spec, f, block=2, nevalperblock=64 * 40)
    inputs = uni.kernel_inputs(spec.device_params(), _kd(6, 2))
    atabs = {lidx: uni.atab[[k for k, (l, _) in enumerate(uni.slot_map) if l == lidx]].numpy()
             for lidx in uni.dleaf}
    lay = vk.MixedLayout.build(spec, uni.chunk, atabs)
    tab = lay.tables(spec.device_params())
    kd32 = torch.as_tensor(_kd(6, 2).view(np.int32))
    T = uni.nchunks
    x, invp, perm = vk.vegas_sample_plain(t0=0, T=T, m=uni.m_tile, **inputs)
    xm, gm = vk.vegas_sample_mixed_plain(lay, tab, kd32, 0, T)
    S, B = x.shape[:2]
    assert torch.equal(xm.view(torch.int32), x.reshape(S, B, T, -1).view(torch.int32))
    assert torch.equal(gm, perm.repeat_interleave(uni.m_tile, dim=-1))
    w = uni.evaluate(uni.leaf_values(x))
    obs, hrow = vk.vegas_reduce_plain(w, invp, perm, uni.pad, uni.pair_slots, uni.used)
    obs_m, hist_m = vk.vegas_reduce_mixed_plain(lay, tab, w.reshape(w.shape[0], B, T, -1).contiguous(),
                                                gm)
    torch.testing.assert_close(obs_m, obs, rtol=1e-12, atol=0)
    torch.testing.assert_close(hist_m, hrow.sum(dim=(1, 2)), rtol=1e-12, atol=0)
    relw = vk.vegas_relw_plain(w, invp, uni.pad, uni.pair_slots)
    relw_m = vk.vegas_relw_mixed_plain(lay, tab, w.reshape(w.shape[0], B, T, -1), gm)
    assert torch.equal(relw_m.view(torch.int32), relw.reshape(relw_m.shape).view(torch.int32))


def test_reduce_plain_histogram_by_hand():
    """Two integrands with padding, a CompositeVar of a Continuous and a
    Discrete pool, a pool drawn per sample and a non-adaptive one: each
    slot's histogram is the one-hot sum of min(|w_i| jac, 1e17)^2 over the
    integrands that use it, jac the float32 product of the slots'
    1/probabilities; the non-adaptive slot's is zero."""
    var = (mt.CompositeVar(C(0.0, 1.0, ninc=50), D(0, 6)), C(0.0, 3.0, ninc=33),
           D(1, 4, adapt=False))
    cfg = _train(mt.Configuration(var=var, dof=[[2, 1, 1], [1, 1, 1]], seed=2))
    f = lambda x, c: (x[0][0][0] * x[0][1][1] + x[1][0], x[0][0][0] * 1e20 * x[2][0])
    spec, it, lay, tab = _mixed(cfg, f, nevalperblock=500)
    kd = it.seeds(_kd(8, 2))
    x, gidx = vk.vegas_sample_mixed_plain(lay, tab, kd, 0, 1)
    w = it.evaluate(lay.leaf_values(x))
    _, hist = vk.vegas_reduce_mixed_plain(lay, tab, w, gidx)
    tn, g = tab.numpy(), gidx.numpy()
    jac = None
    for k in range(lay.S):
        kind, nb, off = lay.slots[k, :3]
        if kind == vk.KIND_DISC:
            inv = np.float32(1.0) / tn[off + nb + 1:off + 2 * nb + 1][g[k]]
        else:
            inv = np.float32(nb) * tn[off + nb:off + 2 * nb][g[k]]
        jac = inv if jac is None else jac * inv
    a = np.minimum(np.abs(w.numpy()) * jac, np.float32(1e17))
    sq = (a * a).astype(np.float64)
    assert np.any(a == np.float32(1e17))                      # the clip is reached
    for k in range(lay.S):
        want = np.zeros(lay.nbmax)
        for i in range(spec.N):
            if lay.used[k, i]:
                np.add.at(want, g[k].ravel(), sq[i].ravel())
        np.testing.assert_allclose(hist[k].numpy(), want, rtol=1e-12, atol=0)
    assert lay.used[-1].sum() == 0 and not hist[-1].any()     # the non-adaptive pool


def _run_discrete(pkg):
    f = (lambda x, c: x[0].to(torch.float32)) if pkg is mt else (lambda x, c: x[0].astype(jnp.float32))
    return dict(var=(pkg.Discrete(1, 3),), dof=[[1]]), f, [6.0], {}


def _run_discrete2(pkg):
    return dict(var=(pkg.Discrete([(1, 3), (1, 4)]),), dof=[[1]]), (lambda x, c: 1.0), [12.0], {}


def _t_times_d(pkg):
    """Integrand 0 uses one Discrete slot (padded), integrand 1 two; the
    Discrete pool's first slot is pinned (offset)."""
    def f(x, c):
        t, d = x
        if pkg is mt:
            d1, d2 = d[1].to(torch.float32), d[2].to(torch.float32)
        else:
            d1, d2 = d[1].astype(jnp.float32), d[2].astype(jnp.float32)
        return t[0] * d1, t[0] * d1 * d2
    var = (pkg.Continuous(0.0, 1.0, ninc=64), pkg.Discrete(1, 5, offset=1))
    return dict(var=var, dof=[[1, 1], [1, 2]]), f, [7.5, 112.5], {}


def _mixed_ninc(pkg):
    lib = torch if pkg is mt else jnp
    var = (pkg.Continuous(0.0, 1.0, ninc=64), pkg.Continuous(0.0, 1.0, ninc=32),
           pkg.Continuous(0.0, 1.0, ninc=1000))
    f = lambda x, c: lib.sqrt(x[0][0]) * x[1][0] ** 2 * lib.exp(x[2][0])
    return dict(var=var, dof=[[1, 1, 1]]), f, [2.0 / 9.0 * (np.e - 1.0)], {"nevalperblock": 960}


def _complex_disc(pkg):
    def f(x, c):
        t, d = x
        dd = d[0].to(torch.float32) if pkg is mt else d[0].astype(jnp.float32)
        return t[0] + 1j * dd
    return (dict(var=(pkg.Continuous(0.0, 1.0, ninc=64), pkg.Discrete(1, 3)), dof=[[1, 1]],
                 type=complex), f, [1.5 + 6j], {})


def _measurefreq(pkg):
    cfg, f, exact, _ = _t_times_d(pkg)
    return cfg, f, exact, {"measurefreq": 3}


CASES = {"run_discrete": _run_discrete, "run_discrete2": _run_discrete2, "t*d": _t_times_d,
         "mixed-ninc": _mixed_ninc, "complex": _complex_disc, "measurefreq": _measurefreq}


def _estimate(m):
    err = (m.real.std(axis=0, ddof=1) + 1j * m.imag.std(axis=0, ddof=1)) / np.sqrt(len(m))
    return m.mean(axis=0), err


def _within(a, b, err, k=7.0):
    a, b, err = np.asarray(a), np.asarray(b), np.asarray(err) + 1e-12 * (1 + 1j)
    return (np.all(np.abs(a.real - b.real) < k * err.real)
            and np.all(np.abs(a.imag - b.imag) < k * err.imag))


@pytest.mark.parametrize("case", list(CASES))
def test_matches_jax_xla_route(case):
    tkw, tf, exact, kw = CASES[case](mt)
    jkw, jf, _, _ = CASES[case](mj)
    kw = {"nevalperblock": 2 ** 13, **kw}
    tspec = Spec(mt.Configuration(seed=5, **tkw), "cpu")
    tit = make_vegas_iteration(tspec, tf, block=BLOCK, **kw)
    assert type(tit) is VegasMixedIteration and tit.backend_reason == ""
    jspec = JSpec(mj.Configuration(seed=5, **jkw))
    cplx = tkw.get("type") is complex
    jit = JVegasIteration(jspec, jf, block=BLOCK, backend="xla",
                          weight_dtype=jnp.complex64 if cplx else jnp.float32, **kw)
    assert tit.nevalperblock == jit.nevalperblock and tit.chunk == jit.chunk
    vk.reset_launch_counts()
    st = tit.run(tspec.device_params(), _kd(3))
    assert sum(vk.launch_counts.values()) == 0                 # the plain versions
    import jax
    sj = jit.run(jspec.device_params(), jax.random.key(3))
    assert np.array_equal(st["norm_blocks"], np.asarray(sj["norm_blocks"], np.float64))
    ob = st["obs_blocks"]
    mt_, et = _estimate(ob / st["norm_blocks"][:, None])
    mj_, ej = _estimate(np.asarray(sj["obs_blocks"]) / np.asarray(sj["norm_blocks"])[:, None])
    comb = np.hypot(et.real, ej.real) + 1j * np.hypot(et.imag, ej.imag)
    assert _within(mt_, mj_, comb), (mt_, mj_, et, ej)
    assert _within(mt_, exact, et), (mt_, exact, et)
    # the histograms feed the adaptive leaves only, at their bins
    for (li, h) in zip(tspec.leaves, st["hists"]):
        assert h.shape == (li.nhist,) and np.all(h >= 0)
        assert h.any() == bool(li.leaf.adapt)


@pytest.mark.parametrize("case", list(CASES))
def test_integrate_matches_jax(case):
    """``integrate`` over four iterations (the maps trained in between) in
    both packages, :vegas on the CPU (the JAX package's XLA route), within
    7 combined sigma of each other and 7 sigma of the exact values."""
    tkw, tf, exact, kw = CASES[case](mt)
    jkw, jf, _, _ = CASES[case](mj)
    run = dict(neval=BLOCK * kw.pop("nevalperblock", 2 ** 13), niter=4, block=BLOCK,
               solver="vegas", seed=7, verbose=-2, **kw)
    rt = mt.integrate(tf, device="cpu", **run, **tkw)
    rj = mj.integrate(jf, **run, **jkw)
    assert rt.backend == "torch" and rt.neval == rj.neval
    for i, e in enumerate(exact):
        mt_, et = complex(np.asarray(rt.mean[i])), complex(np.asarray(rt.stdev[i]))
        mj_, ej = complex(np.asarray(rj.mean[i])), complex(np.asarray(rj.stdev[i]))
        comb = np.hypot(et.real, ej.real) + 1j * np.hypot(et.imag, ej.imag)
        assert _within(mt_, mj_, comb), (i, mt_, mj_, et, ej)
        assert _within(mt_, e, et), (i, mt_, e, et)


# ---- the Lindhard bubble (tests/test_bubble.py:80-128) ----
QSIZE, RS, BETA, SPIN, ME = 4, 1.0, 25.0, 2, 0.5
KF = (9 * np.pi / (2 * SPIN)) ** (1 / 3) / RS
BETA_PHYS = BETA / (KF ** 2 / (2 * ME))
EXTQ = np.array([[q, 0.0, 0.0] for q in np.linspace(0.0 * KF, 1.5 * KF, QSIZE)])


def lindhard(q):
    density = ME * KF / (2 * np.pi ** 2)
    q = max(q, 1e-6)
    x = q / 2 / KF
    p = 1 + (1 - x ** 2) * np.log1p(4 * x / ((1 - x) ** 2)) / 4 / x if abs(q - 2 * KF) > 1e-6 else 1.0
    return -p * density * SPIN / 2


def _green(tau, omega, beta):
    pos = tau >= 0.0
    gp = torch.where(omega > 0.0, torch.exp(-omega * tau) / (1 + torch.exp(-omega * beta)),
                     torch.exp(omega * (beta - tau)) / (1 + torch.exp(omega * beta)))
    gn = torch.where(omega > 0.0, -torch.exp(-omega * (tau + beta)) / (1 + torch.exp(-omega * beta)),
                     -torch.exp(-omega * tau) / (1 + torch.exp(omega * beta)))
    return torch.where(pos, gp, gn)


_EXTQ = torch.as_tensor(EXTQ, dtype=torch.float32)


def _bubble(v, c):
    R, Th, Ph, T, Ext = v
    r = R[0] / (1 - R[0])
    th, ph = Th[0], Ph[0]
    k = torch.stack([r * torch.sin(th) * torch.cos(ph), r * torch.sin(th) * torch.sin(ph),
                     r * torch.cos(th)])
    factor = r ** 2 / (1 - R[0]) ** 2 * torch.sin(th) / (2 * np.pi) ** 3
    kq = k + _EXTQ[Ext[0] - 1].movedim(-1, 0)
    w1 = ((k * k).sum(0) - KF ** 2) / (2 * ME)
    w2 = ((kq * kq).sum(0) - KF ** 2) / (2 * ME)
    return _green(T[0], w1, BETA_PHYS) * _green(-T[0], w2, BETA_PHYS) * SPIN * factor


def _bubble_measure(v, relw, c):
    return [mt.onehot(v[-1][0], 1, QSIZE, relw.dtype, like=relw[0]) * relw[0]]


def test_bubble_on_vegas():
    """``tests/test_bubble.py``'s run on :vegas (10 iterations of 1e5
    evaluations in 8 blocks, then one warm-started iteration of 1e6 in 64),
    every bin within 20 sigma of the Lindhard function."""
    var = (C(0.0, 1.0, alpha=3.0), C(0.0, np.pi, alpha=3.0), C(0.0, 2 * np.pi, alpha=3.0),
           C(0.0, BETA_PHYS, alpha=3.0), D(1, QSIZE, adapt=False))
    kw = dict(measure=_bubble_measure, var=var, dof=[[1, 1, 1, 1, 1]],
              obs=[np.zeros(QSIZE)], solver="vegas", device="cpu", verbose=-2)
    res = mt.integrate(_bubble, neval=100_000, block=8, seed=101, **kw)
    assert res.backend == "torch" and res.backend_reason == ""
    res = mt.integrate(_bubble, neval=1_000_000, block=64, niter=1, config=res.config, seed=103,
                       **kw)
    avg, std = np.asarray(res.mean[0]), np.asarray(res.stdev[0])
    for i in range(QSIZE):
        exact = lindhard(EXTQ[i][0])
        assert abs(avg[i] - exact) < 20.0 * max(std[i], 1e-10), (i, avg[i], std[i], exact)
