"""PyTorch port: the float64 mode, ``integrate(..., dtype=torch.float64)``.

- The plain versions of the kernels at float64 against an independent
  numpy form of the JAX package's float64 law: ``x``, ``invp``, ``relw``
  and the sums on seeded inputs, for ``vegas_sample``/``vegas_reduce``/
  ``vegas_relw``, the mixed route's three kernels and ``vplus_sample``/
  ``vplus_reduce``/``vplus_relw``.  The uniforms stay float32; the maps,
  ``x``, the densities and real weights are float64; a complex weight stays
  complex64 and is scaled by its factor rounded to float32.
- From the same seeds a float64 launch draws the float32 launch's strata
  permutations, and its bins wherever the random bits alone decide them.
- The slice against the JAX package's float64 XLA route (run inside
  ``jax.enable_x64(True)`` only, so no other test sees x64), within 7
  combined sigma: e^{100x} on both stratified solvers (whose integral
  float32 cannot hold), a Continuous + Discrete spec on the mixed route, a
  complex run and a custom measure with ``measurefreq=2``.
- ``params_from_jax`` of a float64 spec carries the JAX package's float64
  tables bit for bit; ``save_state``/``load_state`` round-trip a float64
  run.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mcintegration_tpu as mj
from mcintegration_tpu.solvers.engine import Spec as JSpec

import mcintegration_tpu_torch as mt
from mcintegration_tpu_torch.checkpoint import params_from_jax
from mcintegration_tpu_torch.ops import vegas_kernels as vk, vplus_kernels as vp
from mcintegration_tpu_torch.ops.rng import block_keys
from mcintegration_tpu_torch.solvers.engine import Spec
from mcintegration_tpu_torch.solvers.vegas import VegasIteration, VegasMixedIteration
from mcintegration_tpu_torch.solvers.vegasplus import VegasPlusIteration

torch.set_num_threads(1)

F64 = torch.float64
E100 = (np.exp(100.0) - 1.0) / 100.0        # 2.688e41, above float32's 3.4e38
M32 = 0xFFFFFFFF


# ---- the counter hash of ops/rng.py in numpy (uint64, masked to 32 bits)
def _mix(x):
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & M32
    return x ^ (x >> 16)


def _draw(kd, t, idx, salt):
    """The ``salt``-th draw at flat index ``idx`` of chunk ``t`` of a block
    with seeds ``kd`` (two uint32)."""
    k1 = _mix(np.uint64(kd[0]) ^ np.uint64((t * 0x9E3779B9) & M32))
    k2 = _mix(np.uint64((int(kd[1]) + t) & M32))
    idx = np.asarray(idx, np.uint64)
    return _mix((_mix(idx ^ k1) + k2 + np.uint64((salt * 0x85EBCA6B) & M32)) & M32)


def _u24(bits):
    """((bits & 0xFFFFFF) + 0.5) * 2^-24 in float32."""
    return ((bits & 0xFFFFFF).astype(np.float32) + np.float32(0.5)) * np.float32(2.0 ** -24)


def _trained(cfg, seed=1):
    """``cfg`` with every adaptive map trained once from a random histogram."""
    rng = np.random.default_rng(seed)
    for _, leaf in cfg.var_leaves():
        if leaf.adapt:
            leaf.histogram = rng.gamma(0.5, 1.0, leaf.nhist) + 1e-3
            leaf.train()
    return cfg


def _equal_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        np.array_equal(a.view(np.uint8), b.view(np.uint8))


def _factors(invp, pad, pair_slots):
    """jac and each integrand's factor from invp [S, ...] in numpy float64,
    the order of the law: jac = prod invp_k, factor_i = jac * prod over the
    padded pairs of prod over the pair's slots of 1/invp_k."""
    jac = invp[0].copy()
    for k in range(1, invp.shape[0]):
        jac = jac * invp[k]
    gp = []
    for members in pair_slots:
        g = None
        for k in members:
            if k < 0:
                break
            q = 1.0 / invp[k]
            g = q if g is None else g * q
        gp.append(g)
    return jac, [jac if not row.any() else _prod(jac, [gp[g] for g, on in enumerate(row) if on])
                 for row in pad]


def _prod(a, bs):
    for b in bs:
        a = a * b
    return a


def _scale(w, f):
    """The law's relw: a real weight times f; a complex64 one's parts each
    times float32(f)."""
    if np.iscomplexobj(w):
        f32 = np.asarray(f, np.float64).astype(np.float32)
        return (w.real * f32 + 1j * (w.imag * f32)).astype(np.complex64)
    return w * f


def _absw(w):
    """|w| as the kernels form it: sqrt(re*re + im*im) in float32, rounded once."""
    if np.iscomplexobj(w):
        s = (w.real * w.real + w.imag * w.imag).astype(np.float32)
        return np.sqrt(s.astype(np.float64)).astype(np.float32)
    return np.abs(w)


# ---------------------------------------------------------------------------
# the uniform route
# ---------------------------------------------------------------------------

def _uniform_iteration(real, cplx=False):
    cfg = _trained(mt.Configuration(var=mt.Continuous([(0.0, 1.0), (0.0, 2.0)], ninc=12),
                                    dof=[[1], [2]], seed=5, type=complex if cplx else float))
    f = (lambda x, c: (x[0][0] + 0.5j * x[1][0], x[1][0] * x[1][1] + 0j)) if cplx else \
        (lambda x, c: (x[0][0], x[1][0] * x[1][1]))
    return VegasIteration(Spec(cfg, "cpu", real), f, block=2, nevalperblock=12 * 8)


def test_vegas_sample_law():
    """x = grid[pk] + float64(dy) * inc[pk] and invp = nb * inc[pk] in
    float64, dy the float32 24-bit uniform, pk = (a*p + s) mod nb."""
    it = _uniform_iteration(F64)
    kd = block_keys(5, 0, 0, it.block)
    inputs = it.kernel_inputs(it.spec.device_params(), kd)
    t0, T, m, nb = 1, 2, it.m_tile, it.nb
    x, invp, perm = vk.vegas_sample_plain(t0=t0, T=T, m=m, **inputs)
    assert x.dtype == invp.dtype == F64
    grid, inc = inputs["grid"].numpy(), inputs["inc"].numpy()
    atab, sl = inputs["atab"].numpy(), inputs["slot_leaf"].numpy()
    p = np.arange(nb)
    for k in range(atab.shape[0]):
        for b in range(it.block):
            for ti in range(T):
                t = t0 + ti
                s = int(_draw(kd[b], t, 0, 3 * k + 1) & 0x7FFFFFFF) % nb
                a = int(atab[k][int(_draw(kd[b], t, 0, 3 * k + 2) & 0x7FFFFFFF) % vk.N_MULT])
                pk = (a * p + s) % nb
                dy = _u24(_draw(kd[b], t, p[:, None] * m + np.arange(m), 3 * k + 3))
                g, dx = grid[sl[k]][pk], inc[sl[k]][pk]
                assert np.array_equal(perm[k, b, ti].numpy(), pk)
                assert _equal_bits(x[k, b, ti].numpy(), g[:, None] + dy.astype(np.float64) * dx[:, None])
                assert _equal_bits(invp[k, b, ti].numpy(), dx * nb)


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_vegas_reduce_and_relw_law(cplx):
    """relw = w * factor in float64 (complex64 w: each part times
    float32(factor)) bit for bit; the observable sums and the histogram
    (min(|w| jac, 1e17)^2 in float64, scattered at perm) within 1e-12; the
    gate of measurefreq 3 sums only the samples whose index it divides."""
    it = _uniform_iteration(F64, cplx)
    kd = block_keys(5, 1, 0, it.block)
    inputs = it.kernel_inputs(it.spec.device_params(), kd)
    x, invp, perm = vk.vegas_sample_plain(t0=0, T=2, m=it.m_tile, **inputs)
    w = it.evaluate(it.leaf_values(x))
    assert w.dtype == (torch.complex64 if cplx else F64)
    pad, pair, used = (a.numpy() for a in (it.pad, it.pair_slots, it.used))
    jac, factors = _factors(invp.numpy(), pad, pair)
    wn = w.numpy()
    relw = vk.vegas_relw_plain(w, invp, it.pad, it.pair_slots).numpy()
    want = np.stack([_scale(wn[i], f[..., None]) for i, f in enumerate(factors)])
    assert _equal_bits(relw, want)
    for mf in (1, 3):
        obs, hrow = vk.vegas_reduce_plain(w, invp, perm, it.pad, it.pair_slots, it.used, None, mf, 0)
        B, T, nb, m = wn.shape[1:]
        e = np.arange(T * nb * m).reshape(T, nb, m) + 1
        gate = (e % mf == 0)
        parts = [p for r in want for p in ((r.real, r.imag) if cplx else (r,))]
        np.testing.assert_allclose(obs.numpy(), np.stack(
            [np.where(gate, q.astype(np.float64), 0.0).sum(axis=(-2, -1)) for q in parts], -1),
            rtol=1e-12, atol=0)
        sq = [np.minimum(_absw(wn[i]).astype(np.float64) * jac[..., None], 1e17) ** 2
              for i in range(wn.shape[0])]
        for k in range(invp.shape[0]):
            h = sum(sq[i].sum(-1) for i in range(len(sq)) if used[k][i])
            want_h = np.zeros_like(hrow[k].numpy())
            np.put_along_axis(want_h, perm[k].numpy().astype(np.int64), h, -1)
            np.testing.assert_allclose(hrow[k].numpy(), want_h, rtol=1e-12, atol=0)


def test_vegas_perm_identity_with_float32():
    """From one kd the float64 launch draws float32's perm, and its x lies
    within the map arithmetic's float32 rounding of float32's."""
    kd = block_keys(5, 2, 0, 2)
    got = []
    for real in (torch.float32, F64):
        it = _uniform_iteration(real)
        got.append(vk.vegas_sample_plain(t0=0, T=3, m=it.m_tile,
                                         **it.kernel_inputs(it.spec.device_params(), kd)))
    (x32, _, p32), (x64, _, p64) = got
    assert torch.equal(p32, p64) and x64.dtype == F64
    assert float((x64 - x32.double()).abs().max()) < 2.0 ** -20


# ---------------------------------------------------------------------------
# the mixed route
# ---------------------------------------------------------------------------

def _mixed_iteration(real, cplx=False):
    cfg = _trained(mt.Configuration(var=(mt.Continuous(0.0, 1.0, ninc=8), mt.Discrete(-2, 5),
                                         mt.Continuous(0.0, 2.0, ninc=6)),
                                    dof=[[1, 1, 1], [1, 0, 1]], seed=7,
                                    type=complex if cplx else float))
    f = (lambda v, c: (v[0][0] * v[1][0] + 1j * v[2][0], v[0][0] * v[2][0] + 0j)) if cplx else \
        (lambda v, c: (v[0][0] * v[1][0] + v[2][0], v[0][0] * v[2][0]))
    # chunk 40: the ninc-8 pool stratified (m_k 5), ninc 6 drawn per sample
    return VegasMixedIteration(Spec(cfg, "cpu", real), f, block=2, nevalperblock=40)


def test_mixed_sample_law():
    """The mixed route's draw at float64: a stratified slot as the uniform
    route's; a per-sample Continuous slot at iy = int(u*nb) in float32, x =
    grid[iy] + float64(u*nb - iy) * inc[iy]; a Discrete slot's bin the
    count of float64 CDF values at or below float64(u), its value stored
    as int64 bits and read back as int32."""
    it = _mixed_iteration(F64)
    lay = it.layout
    assert list(lay.slots[:, 0]) == [vk.KIND_STRAT, vk.KIND_DISC, vk.KIND_MAP]
    kd = block_keys(7, 0, 0, it.block)
    tab = lay.tables(it.spec.device_params())
    assert tab.dtype == F64
    kdt = it.seeds(kd)
    x, gidx = vk.vegas_sample_mixed_plain(lay, tab, kdt, 1, 2)
    tabn, c = tab.numpy(), lay.chunk
    q = np.arange(c)
    for k in range(lay.S):
        kind, nb, off, _, lower, m_k, _ = (int(v) for v in lay.slots[k])
        for b in range(it.block):
            for ti in range(2):
                t = 1 + ti
                u = _u24(_draw(kd[b], t, q, 3 * k + 3))
                if kind == vk.KIND_STRAT:
                    s = int(_draw(kd[b], t, 0, 3 * k + 1) & 0x7FFFFFFF) % nb
                    a = int(lay.atab[k].numpy()[int(_draw(kd[b], t, 0, 3 * k + 2) & 0x7FFFFFFF)
                                                 % vk.N_MULT])
                    g = (a * (q // m_k) + s) % nb
                    xw = tabn[off + g] + u.astype(np.float64) * tabn[off + nb + g]
                elif kind == vk.KIND_MAP:
                    tt = u * np.float32(nb)
                    g = np.clip(tt.astype(np.int32), 0, nb - 1)
                    dy = tt - g.astype(np.float32)
                    xw = tabn[off + g] + dy.astype(np.float64) * tabn[off + nb + g]
                else:
                    cdf = tabn[off + 1:off + nb + 1]
                    g = np.minimum((u.astype(np.float64)[:, None] >= cdf[None, :]).sum(-1), nb - 1)
                    xw = (g + lower).astype(np.int64).view(np.float64)
                assert np.array_equal(gidx[k, b, ti].numpy(), g)
                assert _equal_bits(x[k, b, ti].numpy(), xw)
    vals = lay.leaf_values(x)
    assert vals[1].dtype == torch.int32 and int(vals[1].min()) >= -2 and int(vals[1].max()) <= 5


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_mixed_relw_and_reduce_law(cplx):
    """invp = nb * inc[g] or 1/dist[g] in float64; relw bit for bit, the
    observable sums and the per-slot histograms within 1e-12."""
    it = _mixed_iteration(F64, cplx)
    lay = it.layout
    tab = lay.tables(it.spec.device_params())
    x, gidx = vk.vegas_sample_mixed_plain(lay, tab, it.seeds(block_keys(7, 1, 0, 2)), 0, 2)
    w = it.evaluate(lay.leaf_values(x))
    tabn, g = tab.numpy(), gidx.numpy().astype(np.int64)
    invp = []
    for k in range(lay.S):
        kind, nb, off = (int(v) for v in lay.slots[k, :3])
        invp.append(1.0 / tabn[off + nb + 1 + g[k]] if kind == vk.KIND_DISC
                    else tabn[off + nb + g[k]] * nb)
    jac, factors = _factors(np.stack(invp), lay.pad, lay.pair_slots)
    wn = w.numpy()
    want = np.stack([_scale(wn[i], f) for i, f in enumerate(factors)])
    assert _equal_bits(vk.vegas_relw_mixed_plain(lay, tab, w, gidx).numpy(), want)
    obs, hist = vk.vegas_reduce_mixed_plain(lay, tab, w, gidx, None, 2, 0)
    gate = (np.arange(2 * lay.chunk).reshape(2, lay.chunk) + 1) % 2 == 0
    parts = [p for r in want for p in ((r.real, r.imag) if cplx else (r,))]
    np.testing.assert_allclose(obs.numpy(), np.stack(
        [np.where(gate, p.astype(np.float64), 0.0).sum(-1) for p in parts], -1), rtol=1e-12)
    sq = [np.minimum(_absw(wn[i]).astype(np.float64) * jac, 1e17) ** 2 for i in range(len(wn))]
    for k in range(lay.S):
        nb = int(lay.slots[k, 1])
        h = np.zeros(nb)
        feeds = [i for i in range(len(wn)) if lay.used[k, i]]
        if int(lay.slots[k, 6]) < 0 or not feeds:
            continue
        np.add.at(h, g[k].reshape(-1), sum(sq[i] for i in feeds).reshape(-1))
        np.testing.assert_allclose(hist[k, :nb].numpy(), h, rtol=1e-12, atol=0)


def test_mixed_gidx_identity_with_float32():
    """The stratified and per-sample Continuous slots draw float32's bins;
    a Discrete slot's bin comes from its CDF's values and may differ."""
    out = []
    for real in (torch.float32, F64):
        it = _mixed_iteration(real)
        kd = it.seeds(block_keys(7, 2, 0, 2))
        out.append(vk.vegas_sample_mixed_plain(it.layout, it.layout.tables(
            it.spec.device_params()), kd, 0, 3))
    (x32, g32), (x64, g64) = out
    assert torch.equal(g32[0], g64[0]) and torch.equal(g32[2], g64[2])
    assert float((x64[0] - x32[0].double()).abs().max()) < 2.0 ** -20


# ---------------------------------------------------------------------------
# :vegasplus
# ---------------------------------------------------------------------------

def _vplus_iteration(real, cplx=False):
    cfg = _trained(mt.Configuration(var=(mt.Continuous(0.0, 1.0, ninc=10), mt.Discrete(1, 4)),
                                    dof=[[2, 1], [1, 0]], seed=9, type=complex if cplx else float))
    f = (lambda v, c: (v[0][0] * v[0][1] * v[1][0] + 1j * v[0][0], v[0][0] + 0j)) if cplx else \
        (lambda v, c: (v[0][0] * v[0][1] * v[1][0], v[0][0]))
    return VegasPlusIteration(Spec(cfg, "cpu", real), f, block=2, nevalperblock=64,
                              max_cubes=9)


def test_vplus_sample_law():
    """y = (coord + u)/nstrat and y*ninc in float32, x = grid[iy] +
    float64(y*ninc - iy) * inc[iy]; a Discrete passenger's bin from its
    float64 CDF, its value as int64 bits."""
    it = _vplus_iteration(F64)
    lay = it.layout
    kd = block_keys(9, 0, 0, 2)
    tab = lay.tables(it.spec.device_params())
    cube, _ = it.cube_tables()
    x, gidx = vp.vplus_sample_plain(lay, tab, it.seeds(kd), 0, 2, cube)
    tabn, c, ns = tab.numpy(), cube.shape[0], it.nstrat
    for k in range(lay.S):
        kind, nb, off, _, lower, stride, _, salt = (int(v) for v in lay.slots[k])
        for b in range(2):
            for t in range(2):
                u = ((_draw(kd[b], t, np.arange(c), salt) >> 8).astype(np.float32)
                     + np.float32(0.5)) * np.float32(2.0 ** -24)
                if kind == 1:
                    cdf = tabn[off + 1:off + nb + 1]
                    g = np.minimum((u.astype(np.float64)[:, None] >= cdf[None, :]).sum(-1), nb - 1)
                    xw = (g + lower).astype(np.int64).view(np.float64)
                else:
                    coord = (cube.numpy() // stride) % ns
                    y = (coord.astype(np.float32) + u) / np.float32(ns)
                    tt = y * np.float32(nb)
                    g = np.clip(tt.astype(np.int32), 0, nb - 1)
                    dy = tt - g.astype(np.float32)
                    xw = tabn[off + g] + dy.astype(np.float64) * tabn[off + nb + g]
                assert np.array_equal(gidx[k, b, t].numpy(), g)
                assert _equal_bits(x[k, b, t].numpy(), xw)


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_vplus_reduce_and_relw_law(cplx):
    """dens = float64(cfac[cube]) * prod rho (float32 cfac, as the
    reference's), jac = 1/dens, relw = w * (jac * pad_i) bit for bit
    (complex: float32(jac * pad_i)); the sums, the second moments
    (min(sum |w| pad / denom, 1e17)^2 in float64) and the histograms
    (min(|relw|, 1e17)^2: float32 for a complex relw) within 1e-12."""
    it = _vplus_iteration(F64, cplx)
    lay = it.layout
    tab = lay.tables(it.spec.device_params())
    cube, cfac = it.cube_tables()
    assert cfac.dtype == torch.float32
    x, gidx = vp.vplus_sample_plain(lay, tab, it.seeds(block_keys(9, 1, 0, 2)), 0, 2, cube)
    w = it.evaluate(lay.leaf_values(x))
    tabn, g = tab.numpy(), gidx.numpy().astype(np.int64)
    rho = []
    for k in range(lay.S):
        kind, nb, off = (int(v) for v in lay.slots[k, :3])
        rho.append(tabn[off + nb + 1 + g[k]] if kind == 1 else tabn[off + 2 * nb + g[k]])
    cont = [k for k in range(lay.S) if lay.slots[k, 0] == 0]
    disc = [k for k in range(lay.S) if lay.slots[k, 0] == 1]
    prob = _prod(rho[cont[0]], [rho[k] for k in cont[1:]])
    pp = _prod(rho[disc[0]], [rho[k] for k in disc[1:]])
    denom, jac = prob * pp, 1.0 / (cfac.numpy()[cube.numpy()].astype(np.float64) * prob * pp)
    gp = [_prod(rho[m[0]], [rho[k] for k in m[1:] if k >= 0]) for m in lay.pair_slots]
    pads = [_prod(np.float64(1.0), [gp[q] for q, on in enumerate(row) if on]) for row in lay.pad]
    wn = w.numpy()
    want = np.stack([_scale(wn[i], jac * pads[i]) for i in range(len(wn))])
    assert _equal_bits(vp.vplus_relw_plain(lay, tab, w, gidx, cube, cfac).numpy(), want)
    obs, sig, hist = vp.vplus_reduce_plain(lay, tab, w, gidx, cube, cfac)
    parts = [p for r in want for p in ((r.real, r.imag) if cplx else (r,))]
    np.testing.assert_allclose(obs.numpy(), np.stack(
        [p.astype(np.float64).sum(-1) for p in parts], -1), rtol=1e-12)
    score = sum(_absw(wn[i]).astype(np.float64) * pads[i] for i in range(len(wn)))
    wj = np.minimum(score / denom, 1e17)
    want_sig = np.zeros(it.ncubes)
    np.add.at(want_sig, np.broadcast_to(cube.numpy(), wj.shape).reshape(-1), (wj * wj).reshape(-1))
    np.testing.assert_allclose(sig.numpy(), want_sig, rtol=1e-12)
    # a complex relw's |relw| and its square are float32, as the reference's
    sq = [(np.minimum(_absw(r), np.float32(1e17)) ** 2).astype(np.float64) if cplx else
          np.minimum(np.abs(r), 1e17) ** 2 for r in want]
    want_h = np.zeros(max(lay.nhist, 1))
    for k in range(lay.S):
        off = int(lay.slots[k, 6])
        feeds = [i for i in range(len(wn)) if lay.used[k, i]]
        if off >= 0 and feeds:
            np.add.at(want_h, (g[k] + off).reshape(-1), sum(sq[i] for i in feeds).reshape(-1))
    np.testing.assert_allclose(hist.numpy(), want_h, rtol=1e-12, atol=0)


def test_vplus_gidx_identity_with_float32():
    """A Continuous slot of :vegasplus draws float32's bin from the same seeds."""
    out = []
    for real in (torch.float32, F64):
        it = _vplus_iteration(real)
        cube, _ = it.cube_tables()
        out.append(vp.vplus_sample_plain(it.layout, it.layout.tables(it.spec.device_params()),
                                         it.seeds(block_keys(9, 2, 0, 2)), 0, 3, cube))
    (x32, g32), (x64, g64) = out
    cont = torch.as_tensor(it.layout.slots[:, 0] == 0)
    assert torch.equal(g32[cont], g64[cont])
    assert float((x64[cont] - x32[cont].double()).abs().max()) < 2.0 ** -20


# ---------------------------------------------------------------------------
# the slice against the JAX package's float64 XLA route
# ---------------------------------------------------------------------------

def _e100(pkg):
    return lambda x, c: pkg.exp(100.0 * x[0])


def _mixed(pkg):
    f = (lambda x, c: x[0][0] * x[1][0].astype(jnp.float64)) if pkg is jnp else \
        (lambda x, c: x[0][0] * x[1][0].to(torch.float64))
    return f, lambda m: dict(var=(m.Continuous(0.0, 1.0), m.Discrete(1, 6)), dof=[[1, 1]]), 10.5


def _cexp(pkg):
    return lambda x, c: pkg.exp(1j * (x[0] + x[1]))


CEXP = (np.sin(1.0) + 1j * (1.0 - np.cos(1.0))) ** 2


def _measure(pkg):
    def measure(x, relw, c):
        r = relw[0]
        return [pkg.stack([r, r * (x[0] < 0.5)])]
    return measure


# name: (solver, integrand of pkg, keywords of m, exact, extra keywords of pkg)
SLICE = {
    "e100-vegas": ("vegas", _e100, lambda m: dict(var=m.Continuous(0.0, 1.0), dof=[[1]]),
                   E100, lambda pkg: {}),
    "e100-vegasplus": ("vegasplus", _e100, lambda m: dict(var=m.Continuous(0.0, 1.0), dof=[[1]]),
                       E100, lambda pkg: {}),
    "mixed": ("vegas", lambda pkg: _mixed(pkg)[0], lambda m: _mixed(jnp)[1](m), 10.5,
              lambda pkg: {}),
    "complex": ("vegasplus", _cexp, lambda m: dict(var=m.Continuous(0.0, 1.0), dof=[[2]],
                                                   type=complex), CEXP, lambda pkg: {}),
    "measure-mf2": ("vegas", lambda pkg: (lambda x, c: x[0] * x[1]),
                    lambda m: dict(var=m.Continuous(0.0, 1.0), dof=[[2]], obs=[np.zeros(2)],
                                   measurefreq=2),
                    np.array([0.25, 0.0625]), lambda pkg: {"measure": _measure(pkg)}),
}


@pytest.mark.parametrize("case", list(SLICE))
def test_slice_against_jax_float64(case):
    solver, f, kw, exact, extra = SLICE[case]
    common = dict(neval=2 ** 13, niter=4, solver=solver, verbose=-2, seed=3)
    res = mt.integrate(f(torch), device="cpu", dtype=torch.float64, **common, **kw(mt),
                       **extra(torch))
    with jax.enable_x64(True):
        ref = mj.integrate(f(jnp), dtype=jnp.float64, **common, **kw(mj), **extra(jnp))
    assert res.backend == "torch" and ref.backend == "xla"
    a, sa = np.asarray(res.mean[0]), np.asarray(res.stdev[0])
    b, sb = np.asarray(ref.mean[0]), np.asarray(ref.stdev[0])
    assert np.all(np.isfinite(a)) and np.all(sa.real > 0)
    for part in (np.real, np.imag):
        tol = 7 * np.sqrt(part(sa) ** 2 + part(sb) ** 2) + 1e-300
        assert np.all(np.abs(part(a) - part(b)) < tol), (case, a, sa, b, sb)
        assert np.all(np.abs(part(a) - part(np.asarray(exact))) < 7 * part(sa) + 1e-300), \
            (case, a, sa, exact)


def test_e100_float32_cannot_hold_it():
    """The reason for float64: at float32 the same run cannot reach
    (e^100 - 1)/100, which the float64 run finds within 5 sigma."""
    kw = dict(var=mt.Continuous(0.0, 1.0), dof=[[1]], neval=2 ** 13, niter=4, solver="vegas",
              device="cpu", verbose=-2, seed=4)
    r64 = mt.integrate(_e100(torch), dtype=torch.float64, **kw)
    r32 = mt.integrate(_e100(torch), **kw)
    assert abs(float(r64.mean[0]) - E100) < 5 * float(r64.stdev[0])
    assert not abs(float(r32.mean[0]) - E100) < 5 * float(r64.stdev[0])


# ---------------------------------------------------------------------------
# state across the packages and across runs
# ---------------------------------------------------------------------------

def test_params_from_jax_float64_bit_for_bit():
    var = (mt.Continuous(0.0, 1.0, ninc=16), mt.Discrete(0, 6))
    jvar = (mj.Continuous(0.0, 1.0, ninc=16), mj.Discrete(0, 6))
    rng = np.random.default_rng(3)
    for a, b in zip(var, jvar):
        h = rng.gamma(0.5, 1.0, a.nhist) + 1e-3
        a.histogram, b.histogram = h.copy(), h.copy()
        a.train()
        b.train()
    cfg, jcfg = mt.Configuration(var=var, dof=[[1, 1]]), mj.Configuration(var=jvar, dof=[[1, 1]])
    with jax.enable_x64(True):
        jparams = jax.tree_util.tree_map(np.asarray,
                                         JSpec(jcfg, dtype=jnp.float64).device_params())
    spec = Spec(cfg, "cpu", F64)
    got = params_from_jax(jparams, spec)
    own = spec.device_params()
    for (ga, gb), (oa, ob) in zip(got["leaf"], own["leaf"]):
        assert ga.dtype == gb.dtype == F64
        assert torch.equal(ga.view(torch.int64), oa.view(torch.int64))
        assert torch.equal(gb.view(torch.int64), ob.view(torch.int64))
    assert got["reweight"].dtype == F64


def test_state_round_trips_a_float64_run(tmp_path):
    def f(x, c):
        return torch.exp(3.0 * x[0]) * x[1]

    kw = dict(dof=[[2]], neval=2 ** 12, niter=2, solver="vegas", device="cpu", verbose=-2,
              seed=6, dtype=torch.float64, cache=False)
    first = mt.integrate(f, var=mt.Continuous(0.0, 1.0), **kw)
    mt.save_state(first.config, tmp_path / "f64.npz")
    back = mt.load_state(mt.Configuration(var=mt.Continuous(0.0, 1.0), dof=[[2]], seed=6),
                         tmp_path / "f64.npz")
    assert np.array_equal(back.var[0].grid, first.config.var[0].grid)
    a = mt.integrate(f, config=first.config, **{k: v for k, v in kw.items() if k != "dof"})
    b = mt.integrate(f, config=back, **{k: v for k, v in kw.items() if k != "dof"})
    assert np.array_equal(a.mean, b.mean) and np.array_equal(a.stdev, b.stdev)
