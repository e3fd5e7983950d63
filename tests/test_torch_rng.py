"""PyTorch port: the sampler's counter-hash stream against the JAX kernel's.

``ops/rng.py`` holds uint32 arithmetic in int64 tensors; it must reproduce
``pallas_vegas._mix32`` and the interpret-mode ``_make_rng`` bit for bit
(exact equality), since the CUDA kernel and the K1 parity tests rely on it.
"""

import numpy as np
import torch

import jax.numpy as jnp

from mcintegration_tpu.ops.pallas_vegas import _make_rng, _mix32

from mcintegration_tpu_torch.ops import rng

torch.set_num_threads(1)


def _u32(n, seed):
    x = np.random.default_rng(seed).integers(0, 2 ** 32, n, dtype=np.uint32)
    return np.concatenate([x, np.array([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1], np.uint32)])


def test_mix32_matches_jax():
    x = _u32(10000, 0)
    want = np.asarray(_mix32(jnp.asarray(x)))
    got = rng.mix32(torch.as_tensor(x.astype(np.int64))).numpy()
    assert np.array_equal(got.astype(np.uint32), want)
    assert got.min() >= 0 and got.max() < 2 ** 32


def test_mul32_wraps_like_uint32():
    x = _u32(10000, 1)
    for c in (0x7FEB352D, 0x846CA68B, 0x9E3779B9, 0xFFFFFFFF):
        got = rng.mul32(torch.as_tensor(x.astype(np.int64)), c).numpy()
        assert np.array_equal(got.astype(np.uint32), x * np.uint32(c))


def test_counter_hash_matches_interpret_rng():
    """Draws c = 1, 2, 3 of block b, chunk t: two (1, 1) draws and one
    (NP, m) draw, as build_run_all makes them for kernel slot 0."""
    kd = np.random.default_rng(2).integers(0, 2 ** 32, (3, 2), dtype=np.uint32)
    for b, t in ((0, 0), (2, 5), (1, 2 ** 20 + 3)):
        rand_bits = _make_rng(jnp.asarray(kd), jnp.int32(b), jnp.int32(t), True)
        want = [np.asarray(rand_bits((1, 1))), np.asarray(rand_bits((1, 1))),
                np.asarray(rand_bits((32, 24)))]
        k1, k2 = rng.chunk_keys(torch.as_tensor(kd[b].astype(np.int64)),
                                torch.tensor(t))
        idx = torch.arange(32 * 24).reshape(32, 24)
        got = [rng.draw(k1, k2, torch.zeros((1, 1), dtype=torch.int64), 1),
               rng.draw(k1, k2, torch.zeros((1, 1), dtype=torch.int64), 2),
               rng.draw(k1, k2, idx, 3)]
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy().astype(np.uint32), w.view(np.uint32))


def test_block_keys_seeded():
    a = rng.block_keys(7, 3, 0, 16)
    assert a.shape == (16, 2) and a.dtype == np.uint32
    assert np.array_equal(a, rng.block_keys(7, 3, 0, 16))
    assert not np.array_equal(a, rng.block_keys(7, 4, 0, 16))
    assert not np.array_equal(a, rng.block_keys(7, 3, 1, 16))
