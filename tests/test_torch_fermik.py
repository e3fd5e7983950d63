"""PyTorch port: the FermiK momentum shell against the JAX package.

- ``fermik_density`` against JAX ``FermiK.dev_density`` on the same float32
  values, rel 1e-6 (both are float32; the port pins its own operation order).
- ``fermik_draw`` on given uniforms against the formulas of K3
  (``pallas_mcmc.py:732-751``) in float64, abs 1e-6 of kF; on the port's
  draws the port's density and JAX's equal the draw's prob (rel 1e-5: the
  density recomputes sin(theta) from the components).
- The shift's three branches, their shares, and its Hastings factor.
- ``sincos_turns`` within 2.5e-7 of numpy's sine and cosine.
- ``params_from_jax`` and the checkpoint round trip for a FermiK leaf.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mcintegration_tpu as mj
from mcintegration_tpu.solvers.engine import Spec as JSpec

import mcintegration_tpu_torch as mt
from mcintegration_tpu_torch.checkpoint import params_from_jax
from mcintegration_tpu_torch.ops import fermik
from mcintegration_tpu_torch.ops.mcmc_kernels import McmcLayout
from mcintegration_tpu_torch.solvers.engine import Spec

torch.set_num_threads(1)

KF, DK = 1.3, 0.25


def _momenta(rng, dim, n=4096):
    """Momenta near the shell, inside and outside, away from its edges."""
    kamp = KF + rng.uniform(-1.6, 1.6, n) * DK
    kamp = kamp[np.abs(np.abs(kamp - KF) - DK) > 1e-4]
    dirs = rng.normal(size=(len(kamp), dim))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return (kamp[:, None] * dirs).astype(np.float32)        # [n, D]


@pytest.mark.parametrize("dim", [3, 2])
def test_density_matches_jax(dim):
    v = _momenta(np.random.default_rng(dim), dim)
    jleaf = mj.FermiK(dim, KF, DK, 10.0)
    want = np.asarray(jleaf.dev_density(jleaf.device_params(), jnp.asarray(v), None))
    got = fermik.fermik_density(torch.as_tensor(v.T.copy()), fermik.constants(KF, DK, dim), dim)
    assert (want > 0).sum() > len(v) // 3 and (want == 0).sum() > len(v) // 10
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("dim", [3, 2])
def test_draw_matches_k3_and_its_density(dim):
    u = np.random.default_rng(10 + dim).uniform(0.0, 1.0, (3, 8192)).astype(np.float32)
    const = fermik.constants(KF, DK, dim)
    value, prob = fermik.fermik_draw(*torch.as_tensor(u), const, dim)
    u64 = u.astype(np.float64)
    kamp = KF + (u64[0] - 0.5) * 2 * DK                     # pallas_mcmc.py:737-748
    phi = 2 * np.pi * u64[1]
    if dim == 3:
        theta = np.pi * u64[2]
        want = kamp * np.stack([np.cos(phi) * np.sin(theta), np.sin(phi) * np.sin(theta),
                                np.cos(theta)])
        jac = 4 * np.pi ** 2 * DK * np.sin(theta) * kamp ** 2
    else:
        want = kamp * np.stack([np.cos(phi), np.sin(phi)])
        jac = 4 * np.pi * DK * kamp
    np.testing.assert_allclose(value.numpy(), want, rtol=0, atol=1e-6 * KF)
    np.testing.assert_allclose(prob.numpy(), 1.0 / jac, rtol=1e-5)
    # the density of a draw is its prob, in the port and in the JAX package
    ok = (np.abs(kamp - KF) < DK * (1 - 1e-4))
    if dim == 3:
        ok &= np.sin(np.pi * u64[2]) > 1e-3
    dens = fermik.fermik_density(value, const, dim).numpy()
    np.testing.assert_allclose(dens[ok], prob.numpy()[ok], rtol=1e-5)
    jleaf = mj.FermiK(dim, KF, DK, 10.0)
    jd = np.asarray(jleaf.dev_density(jleaf.device_params(), jnp.asarray(value.numpy().T), None))
    np.testing.assert_allclose(jd[ok], prob.numpy()[ok], rtol=1e-5)


@pytest.mark.parametrize("dim", [3, 2])
def test_shift_branches_and_hastings_factor(dim):
    rng = np.random.default_rng(20 + dim)
    n = 30000
    v = torch.as_tensor(_momenta(rng, dim, n).T.copy())
    u = torch.as_tensor(rng.uniform(0.0, 1.0, (3 + dim, v.shape[1])).astype(np.float32))
    const = fermik.constants(KF, DK, dim)
    new, prop = fermik.fermik_shift(v, u[0], u[1], u[2], u[3:], const, dim)
    sel = u[0]
    scale, rot = sel < fermik.THIRD, (sel >= fermik.THIRD) & (sel < fermik.TWO_THIRDS)
    jit = ~scale & ~rot
    for share in (scale, rot, jit):
        assert abs(float(share.float().mean()) - 1 / 3) < 0.01
    ratio = u[1] * fermik.LAMBDA_SPAN + fermik.INV_LAMBDA
    assert torch.equal(new[:, scale], (v * ratio)[:, scale])
    assert float(ratio.min()) >= 1 / 1.5 - 1e-6 and float(ratio.max()) <= 1.5 + 1e-6
    # the Hastings factor: the scale ratio in 3-D (sampler.jl:206), else 1
    want = torch.where(scale, ratio, 1.0) if dim == 3 else torch.ones_like(ratio)
    assert torch.equal(prop, want)
    norm = lambda x: torch.linalg.vector_norm(x.double(), dim=0)
    np.testing.assert_allclose(norm(new[:, rot]), norm(v[:, rot]), rtol=1e-6)
    assert float((new[:, jit] - v[:, jit]).abs().max()) <= DK / 2 * (1 + 1e-6)


def test_sincos_turns_accuracy():
    t = torch.as_tensor(np.random.default_rng(3).uniform(0, 1, 100000).astype(np.float32))
    t = torch.cat([t, torch.tensor([0.0, 0.125, 0.25, 0.5, 0.75, 1.0])])
    s, c = fermik.sincos_turns(t)
    x = 2 * np.pi * t.double().numpy()
    assert np.abs(s.double().numpy() - np.sin(x)).max() < 2.5e-7
    assert np.abs(c.double().numpy() - np.cos(x)).max() < 2.5e-7


def _vars(pkg):
    return (pkg.Continuous(0.0, 2.0, ninc=64), pkg.FermiK(3, KF, DK, 10.0),
            pkg.FermiK(2, 0.7, 0.1, 5.0))


def test_params_from_jax_fermik():
    dof = [[1, 1, 2]]
    jspec = JSpec(mj.Configuration(var=_vars(mj), dof=dof, seed=1))
    tspec = Spec(mt.Configuration(var=_vars(mt), dof=dof, seed=1), "cpu")
    jp = {"leaf": [{k: np.asarray(v) for k, v in p.items()} for p in jspec.device_params()["leaf"]],
          "reweight": np.asarray(jspec.device_params()["reweight"])}
    lay = McmcLayout.build(tspec, 1, 4, 1, False)
    got = lay.tables(params_from_jax(jp, tspec)).numpy()
    want = lay.tables(tspec.device_params()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-7)
    # the FermiK leaves' float32 constants, as K3 folds them
    d = lay.fields(1)
    np.testing.assert_array_equal(want[d["tab_off"]:d["tab_off"] + fermik.FK_FIELDS],
                                  fermik.constants(KF, DK, 3))


def test_checkpoint_round_trip_fermik(tmp_path):
    jc = mj.Configuration(var=_vars(mj), dof=[[1, 1, 1]], seed=3, reweight=[1.0, 3.0])
    jc.var[0].histogram = np.random.default_rng(0).gamma(0.5, 1.0, 64) + 1e-3
    jc.var[0].train()
    mj.save_state(jc, tmp_path / "jax.npz")
    tc = mt.Configuration(var=_vars(mt), dof=[[1, 1, 1]], seed=3)
    mt.load_state(tc, tmp_path / "jax.npz")
    assert np.array_equal(tc.reweight, jc.reweight)
    assert np.array_equal(tc.var[0].grid, jc.var[0].grid)
    for (_, a), (_, b) in zip(tc.var_leaves(), jc.var_leaves()):
        assert np.array_equal(a.histogram, b.histogram)
    mt.save_state(tc, tmp_path / "torch.npz")
    jc2 = mj.Configuration(var=_vars(mj), dof=[[1, 1, 1]], seed=3)
    mj.load_state(jc2, tmp_path / "torch.npz")
    assert np.array_equal(jc2.var[0].grid, jc.var[0].grid)
    with np.load(tmp_path / "torch.npz") as t, np.load(tmp_path / "jax.npz") as j:
        assert sorted(t.files) == sorted(j.files)


def test_fermik_leaf_state():
    a, b = mt.FermiK(3, KF, DK, 10.0, offset=1), mj.FermiK(3, KF, DK, 10.0, offset=1)
    assert (a.dim, a.value_width, a.kF, a.delta_k, a.maxK, a.adapt, a.nhist) == \
        (b.dim, b.value_width, b.kF, b.delta_k, b.maxK, b.adapt, b.nhist)
    np.testing.assert_array_equal(a.fixed_values(), b.fixed_values())
    a.train()
    assert np.array_equal(a.histogram, b.histogram)
    with pytest.raises(AssertionError):
        mt.FermiK(4, KF, DK, 10.0)
