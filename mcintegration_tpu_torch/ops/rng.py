"""The sampler's counter-hash random stream, in torch.

Counterpart of the interpret-mode generator of
``mcintegration_tpu/ops/pallas_vegas.py:_make_rng`` (lines 79-91); the CUDA
kernel ``csrc/vegas_sample.cu`` computes the same bits.  All arithmetic is
uint32 and wraps.  Tensors hold the uint32 values in int64 and every step
masks with ``0xFFFFFFFF``; products are split into 16-bit halves so that no
int64 product can overflow.

For block ``b`` and chunk ``t``:

- ``k1 = mix32(kd[b,0] ^ (t·0x9E3779B9))``, ``k2 = mix32(kd[b,1] + t)``;
- the c-th draw at flat index ``idx`` is
  ``mix32(mix32(idx ^ k1) + k2 + c·0x85EBCA6B)``.

The :mcmc solver's schedule (:func:`schedule`, :func:`schedule_np`) draws
each block's active sector and swap flag per step from the same hash, with
the step as the chunk, flat index 0 and the salts ``SALT_SCHED`` and
``SALT_SCHED + 1``.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
SALT_SCHED = 0x40000000     # above every per-walker salt of ops/mcmc_kernels.py


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for uint32 values ``x`` held in int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 avalanche mixer (pallas_vegas.py:_mix32)."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def chunk_keys(kd: torch.Tensor, t: torch.Tensor):
    """Per-(block, chunk) keys ``(k1, k2)``, broadcasting ``kd[..., 0/1]``
    against the chunk indices ``t``."""
    t = t & MASK32
    k1 = mix32(kd[..., 0] ^ mul32(t, 0x9E3779B9))
    k2 = mix32((kd[..., 1] + t) & MASK32)
    return k1, k2


def draw(k1: torch.Tensor, k2: torch.Tensor, idx: torch.Tensor, c: int):
    """The ``c``-th draw at flat index ``idx`` (uint32 values in int64)."""
    inner = mix32(idx ^ k1)
    return mix32((inner + k2 + ((c * 0x85EBCA6B) & MASK32)) & MASK32)


def block_keys(seed: int, iteration: int, sub: int, nblock: int) -> np.ndarray:
    """Per-block seeds ``kd [nblock, 2]`` uint32 for one (sub-)iteration."""
    return np.random.default_rng([seed, iteration, sub]).integers(
        0, 2 ** 32, (nblock, 2), dtype=np.uint32)


def schedule(kd: torch.Tensor, ntot: int, n: int, c: int, any_swap: bool) -> torch.Tensor:
    """The :mcmc schedule ``[ntot, B]`` int32: ``2 * j + swap`` for block
    ``b`` at step ``t``, with the active sector ``j = bits % n`` and the swap
    flag ``bits' % c == 0`` (``pallas_mcmc.py:938-940``; always 0 unless
    some group holds two slots).  ``kd [B, 2]`` holds the uint32 seeds in
    int64 (or their int32 bits)."""
    kd = kd.to(torch.int64) & MASK32
    t = torch.arange(ntot, dtype=torch.int64, device=kd.device)[:, None]
    k1, k2 = chunk_keys(kd[None], t)
    zero = torch.zeros_like(k1)
    j = draw(k1, k2, zero, SALT_SCHED) % n
    sw = draw(k1, k2, zero, SALT_SCHED + 1) % c == 0
    return (2 * j + (sw & any_swap)).to(torch.int32)


def _mix32_np(x: np.ndarray) -> np.ndarray:
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & MASK32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & MASK32
    return x ^ (x >> 16)


def schedule_np(kd: np.ndarray, ntot: int, n: int, c: int, any_swap: bool) -> np.ndarray:
    """:func:`schedule` in numpy (uint64 arithmetic masked to 32 bits)."""
    kd = np.asarray(kd).astype(np.uint64) & MASK32
    t = np.arange(ntot, dtype=np.uint64)[:, None]
    k1 = _mix32_np(kd[None, :, 0] ^ ((t * 0x9E3779B9) & MASK32))
    k2 = _mix32_np((kd[None, :, 1] + t) & MASK32)
    inner = _mix32_np(k1)                                  # mix32(0 ^ k1)

    def bits(salt):
        return _mix32_np((inner + k2 + ((salt * 0x85EBCA6B) & MASK32)) & MASK32)

    j = bits(SALT_SCHED) % n
    sw = (bits(SALT_SCHED + 1) % c == 0) & bool(any_swap)
    return (2 * j + sw).astype(np.int32)
