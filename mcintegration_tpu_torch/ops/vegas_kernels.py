"""Wrappers of the two CUDA kernels of the :vegas solver, with their plain
PyTorch versions.

Together they replace ``mcintegration_tpu/ops/pallas_vegas.py:build_run_all``
(kernel K1) as a split path: ``vegas_sample`` draws the samples, the user
integrand runs as torch ops on them, and ``vegas_reduce`` forms the
observable sums and the training histogram.

Each wrapper takes its plain version only for tensors on the CPU.  For CUDA
tensors it launches its kernel (``csrc/*.cu``, built by ``ops/_build.py``)
or raises; there is no fallback.  ``launch_counts`` counts the kernel
launches of each wrapper, so a run can show that it went through them.

Shapes (``S`` = slots, ``B`` = blocks, ``T`` = chunks of this launch,
``nb`` = strata, ``m`` = samples per stratum, ``N`` = integrands):

- ``vegas_sample(kd [B,2] i64, t0, T, atab [S,64] i32, grid/inc [L,nb] f32,
  slot_leaf [S] i32, m) -> x [S,B,T,nb,m] f32, invp [S,B,T,nb] f32,
  perm [S,B,T,nb] i32``;
- ``vegas_reduce(w [N,B,T,nb,m] f32, invp, perm, pad [N,P] i32,
  pair_slots [P,M] i32, used [S,N] i32) -> obs [B,T,N] f64,
  hrow [S,B,T,nb] f64``.

``kd`` holds uint32 seeds in int64.  ``pad[i, g]`` says whether the
(group, slot) pair ``g`` enters integrand ``i``'s padding factor;
``pair_slots[g]`` lists the kernel slots of the pair's leaves (``-1``
padded); ``used[k, i]`` says whether integrand ``i``'s weight feeds slot
``k``'s histogram.
"""

from __future__ import annotations

import torch

from . import _build
from ._build import check_tensor as _check
from .rng import chunk_keys, draw

N_MULT = 64          # multiplier-table width (solvers/vegas.py)
HIST_CLIP = 1e17     # histogram weight clip (pallas_vegas.py:507)
MAX_INTEGRANDS = 2048  # shared-memory bound of vegas_reduce
MAX_STRATA = 32768     # int32 guard of (a*p + s) mod nb

launch_counts = {"vegas_sample": 0, "vegas_reduce": 0}


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# vegas_sample
# ---------------------------------------------------------------------------

def vegas_sample_plain(kd, t0: int, T: int, atab, grid, inc, slot_leaf, m: int):
    """Plain torch version of ``csrc/vegas_sample.cu`` (same bits)."""
    dev = kd.device
    nslots, B, nb = atab.shape[0], kd.shape[0], grid.shape[1]
    t = torch.arange(t0, t0 + T, dtype=torch.int64, device=dev)
    k1, k2 = chunk_keys(kd[:, None, :], t[None, :])                # [B,T]
    p = torch.arange(nb, dtype=torch.int64, device=dev)
    idx = p[:, None] * m + torch.arange(m, dtype=torch.int64, device=dev)
    zero = torch.zeros_like(k1)
    x = torch.empty((nslots, B, T, nb, m), dtype=torch.float32, device=dev)
    invp = torch.empty((nslots, B, T, nb), dtype=torch.float32, device=dev)
    perm = torch.empty((nslots, B, T, nb), dtype=torch.int32, device=dev)
    for k in range(nslots):
        s = (draw(k1, k2, zero, 3 * k + 1) & 0x7FFFFFFF) % nb
        j = (draw(k1, k2, zero, 3 * k + 2) & 0x7FFFFFFF) % N_MULT
        a = atab[k].long()[j]
        pk = (a[..., None] * p + s[..., None]) % nb                  # [B,T,nb]
        leaf = int(slot_leaf[k])
        g, dx = grid[leaf][pk], inc[leaf][pk]
        u = draw(k1[..., None, None], k2[..., None, None], idx, 3 * k + 3)
        dy = ((u & 0xFFFFFF).to(torch.float32) + 0.5) * 2.0 ** -24
        x[k] = g[..., None] + dy * dx[..., None]
        invp[k] = dx * nb
        perm[k] = pk.to(torch.int32)
    return x, invp, perm


def vegas_sample(kd, t0: int, T: int, atab, grid, inc, slot_leaf, m: int):
    """Stratified draw through the Vegas maps (see module docstring)."""
    nb = grid.shape[-1]
    if not 1 <= nb <= MAX_STRATA:
        raise ValueError(f"vegas_sample: {nb} strata outside [1, {MAX_STRATA}] "
                         "(int32 guard of (a*p + s) mod nb)")
    if kd.device.type == "cpu":
        return vegas_sample_plain(kd, t0, T, atab, grid, inc, slot_leaf, m)
    if kd.device.type != "cuda":
        raise ValueError(f"vegas_sample: unsupported device {kd.device}")
    dev = kd.device
    nslots, B = atab.shape[0], kd.shape[0]
    nleaf, nb = grid.shape
    _check(kd, "kd", torch.int64, (B, 2), dev)
    _check(atab, "atab", torch.int32, (nslots, N_MULT), dev)
    _check(grid, "grid", torch.float32, (nleaf, nb), dev)
    _check(inc, "inc", torch.float32, (nleaf, nb), dev)
    _check(slot_leaf, "slot_leaf", torch.int32, (nslots,), dev)
    if nb * m >= 2 ** 32 or t0 + T >= 2 ** 31:
        raise ValueError("vegas_sample: chunk or chunk index too large")
    kd32 = torch.where(kd >= 2 ** 31, kd - 2 ** 32, kd).to(torch.int32)
    x = torch.empty((nslots, B, T, nb, m), dtype=torch.float32, device=dev)
    invp = torch.empty((nslots, B, T, nb), dtype=torch.float32, device=dev)
    perm = torch.empty((nslots, B, T, nb), dtype=torch.int32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mci_vegas_sample(
            kd32.data_ptr(), t0, B, T, nb, m, nslots, atab.data_ptr(),
            grid.data_ptr(), inc.data_ptr(), slot_leaf.data_ptr(),
            x.data_ptr(), invp.data_ptr(), perm.data_ptr(), stream)
    _build.check(lib, err, "vegas_sample")
    launch_counts["vegas_sample"] += 1
    return x, invp, perm


# ---------------------------------------------------------------------------
# vegas_reduce
# ---------------------------------------------------------------------------

def vegas_reduce_plain(w, invp, perm, pad, pair_slots, used):
    """Plain torch version of ``csrc/vegas_reduce.cu``: the same float32
    products, summed in float64 in another order."""
    N, nslots = w.shape[0], invp.shape[0]
    pad, pair_slots, used = pad.tolist(), pair_slots.tolist(), used.tolist()
    jac = invp[0]
    for k in range(1, nslots):
        jac = jac * invp[k]                                          # [B,T,nb]
    gprob = []
    for members in pair_slots:
        gp = None
        for k in members:
            if k < 0:
                break
            q = 1.0 / invp[k]
            gp = q if gp is None else gp * q
        gprob.append(gp)
    obs, whsum = [], []
    for i in range(N):
        f = jac
        for g, on in enumerate(pad[i]):
            if on:
                f = f * gprob[g]
        obs.append((w[i] * f[..., None]).double().sum(dim=(-2, -1)))
        a = torch.clamp(torch.abs(w[i]) * jac[..., None], max=HIST_CLIP)
        whsum.append((a * a).double().sum(dim=-1))
    hrow = torch.empty(invp.shape, dtype=torch.float64, device=w.device)
    for k in range(nslots):
        h = torch.zeros(invp.shape[1:], dtype=torch.float64, device=w.device)
        for i in range(N):
            if used[k][i]:
                h = h + whsum[i]
        hrow[k].scatter_(-1, perm[k].long(), h)
    return torch.stack(obs, dim=-1), hrow


def vegas_reduce(w, invp, perm, pad, pair_slots, used):
    """Observable sums and training histogram (see module docstring)."""
    if w.device.type == "cpu":
        return vegas_reduce_plain(w, invp, perm, pad, pair_slots, used)
    if w.device.type != "cuda":
        raise ValueError(f"vegas_reduce: unsupported device {w.device}")
    dev = w.device
    N, B, T, nb, m = w.shape
    nslots = invp.shape[0]
    npair, maxmem = pair_slots.shape
    _check(w, "w", torch.float32, (N, B, T, nb, m), dev)
    _check(invp, "invp", torch.float32, (nslots, B, T, nb), dev)
    _check(perm, "perm", torch.int32, (nslots, B, T, nb), dev)
    _check(pad, "pad", torch.int32, (N, npair), dev)
    _check(pair_slots, "pair_slots", torch.int32, (npair, maxmem), dev)
    _check(used, "used", torch.int32, (nslots, N), dev)
    if N > MAX_INTEGRANDS:
        raise ValueError(f"vegas_reduce: {N} integrands > {MAX_INTEGRANDS}")
    R = B * T * nb
    obs_rows = torch.empty((B, T, nb, N), dtype=torch.float64, device=dev)
    hrow = torch.empty((nslots, B, T, nb), dtype=torch.float64, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mci_vegas_reduce(
            w.data_ptr(), invp.data_ptr(), perm.data_ptr(), pad.data_ptr(),
            pair_slots.data_ptr(), used.data_ptr(), N, nslots, npair, maxmem,
            R, nb, m, obs_rows.data_ptr(), hrow.data_ptr(), stream)
    _build.check(lib, err, "vegas_reduce")
    launch_counts["vegas_reduce"] += 1
    # the kernel writes one partial per stratum row; this sum over the rows
    # is the first step of the fixed-order float64 reduction
    return obs_rows.sum(dim=2), hrow
