"""Wrappers of the two CUDA kernels of the :vegas solver, with their plain
PyTorch versions.

Together they replace ``mcintegration_tpu/ops/pallas_vegas.py:build_run_all``
(kernel K1) as a split path: ``vegas_sample`` draws the samples, the user
integrand runs as torch ops on them, and ``vegas_reduce`` forms the
observable sums and the training histogram.  With a custom measure (K1's
branch, ``pallas_vegas.py:488-503``), ``vegas_relw`` (the second entry
point of ``csrc/vegas_reduce.cu``) forms the relative weights between the
integrand and the measure, and ``vegas_reduce`` sums the measure's output
``m`` in place of the weighted integrands.  The reference's XLA route
(``mcintegration_tpu/solvers/vegas.py:201-357``) also serves complex
weights and ``measurefreq > 1``, which K1 never does: ``vegas_reduce`` and
``vegas_relw`` take complex64 ``w`` (the ``_complex`` entry points of
``csrc/vegas_reduce.cu``), and ``vegas_reduce`` a measurement gate.

Each wrapper takes its plain version only for tensors on the CPU.  For CUDA
tensors it launches its kernel (``csrc/*.cu``, built by ``ops/_build.py``)
or raises; there is no fallback.  ``launch_counts`` counts the kernel
launches of each wrapper, so a run can show that it went through them.

Shapes (``S`` = slots, ``B`` = blocks, ``T`` = chunks of this launch,
``nb`` = strata, ``m`` = samples per stratum, ``N`` = integrands):

- ``vegas_sample(kd [B,2] i64, t0, T, atab [S,64] i32, grid/inc [L,nb] f32,
  slot_leaf [S] i32, m) -> x [S,B,T,nb,m] f32, invp [S,B,T,nb] f32,
  perm [S,B,T,nb] i32``;
- ``vegas_relw(w [N,B,T,nb,m] f32 or c64, invp, pad, pair_slots) -> relw
  [N,B,T,nb,m]`` of ``w``'s dtype;
- ``vegas_reduce(w [N,B,T,nb,m] f32 or c64, invp, perm, pad [N,P] i32,
  pair_slots [P,M] i32, used [S,N] i32, m=None, mf=1, t0=0) -> obs
  [B,T,ncomp] f64, hrow [S,B,T,nb] f64``: ``ncomp = N``, or ``2N`` for
  complex ``w`` (Re and Im of integrand ``i`` in components ``2i``,
  ``2i+1``); given ``m [ncomp,B,T,nb,m] f32``, the sums of ``m``.

With ``mf > 1`` (``measurefreq``) sample ``j`` of stratum row ``p`` of
chunk ``t`` (``t0`` plus its index in the launch) counts in ``obs`` only if
``(t*nb*m + p*m + j + 1) % mf == 0``, the reference's gate
(``solvers/vegas.py:327-335``, ``montecarlo.jl:148``); every sample feeds
the histogram.

``kd`` holds uint32 seeds in int64.  ``pad[i, g]`` says whether the
(group, slot) pair ``g`` enters integrand ``i``'s padding factor;
``pair_slots[g]`` lists the kernel slots of the pair's leaves (``-1``
padded); ``used[k, i]`` says whether integrand ``i``'s weight feeds slot
``k``'s histogram.
"""

from __future__ import annotations

import torch

from ..common import weight_abs, weight_parts, weight_scale
from . import _build
from ._build import check_tensor as _check
from .rng import chunk_keys, draw

N_MULT = 64          # multiplier-table width (solvers/vegas.py)
HIST_CLIP = 1e17     # histogram weight clip (pallas_vegas.py:507)
MAX_INTEGRANDS = 2048  # shared-memory bound of vegas_reduce
MAX_STRATA = 32768     # int32 guard of (a*p + s) mod nb, which stays below 2^30

# "vegas_reduce_measure" counts the launches of vegas_reduce given m, the
# "_complex" keys those of the complex instantiations (given m or not)
launch_counts = {"vegas_sample": 0, "vegas_reduce": 0, "vegas_relw": 0,
                 "vegas_reduce_measure": 0, "vegas_reduce_complex": 0,
                 "vegas_relw_complex": 0}


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
    # the kernel's flat indices: a quad's below 2^30 (m % 4 == 0), else a
    # draw's below 2^31, and the (slot, block, chunk) group's below 2^31
    if (nb * m >= 2 ** (32 if m % 4 == 0 else 31) or t0 + T >= 2 ** 31
            or nslots * B * T >= 2 ** 31):
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

def _row_factors(invp, pad, pair_slots):
    """``(jac [B,T,nb], [factor_i [B,T,nb]])``: the jacobian and each
    integrand's padding-weighted factor, in the kernels' float32 order."""
    nslots = invp.shape[0]
    jac = invp[0]
    for k in range(1, nslots):
        jac = jac * invp[k]
    gprob = []
    for members in pair_slots.tolist():
        gp = None
        for k in members:
            if k < 0:
                break
            q = 1.0 / invp[k]
            gp = q if gp is None else gp * q
        gprob.append(gp)
    factors = []
    for row in pad.tolist():
        f = jac
        for g, on in enumerate(row):
            if on:
                f = f * gprob[g]
        factors.append(f)
    return jac, factors


def vegas_relw_plain(w, invp, pad, pair_slots):
    """Plain torch version of ``vegas_relw`` (``csrc/vegas_reduce.cu``): the
    same float32 products, each part of a complex weight scaled alone."""
    _, factors = _row_factors(invp, pad, pair_slots)
    return torch.stack([weight_scale(w[i], f[..., None]) for i, f in enumerate(factors)])


def vegas_relw(w, invp, pad, pair_slots):
    """Per-sample relative weights ``relw_i = w_i * factor_i`` (see module
    docstring)."""
    if w.device.type == "cpu":
        return vegas_relw_plain(w, invp, pad, pair_slots)
    if w.device.type != "cuda":
        raise ValueError(f"vegas_relw: unsupported device {w.device}")
    dev = w.device
    N, B, T, nb, m = w.shape
    nslots = invp.shape[0]
    npair, maxmem = pair_slots.shape
    cplx = w.dtype == torch.complex64
    _check(w, "w", torch.complex64 if cplx else torch.float32, (N, B, T, nb, m), dev)
    _check(invp, "invp", torch.float32, (nslots, B, T, nb), dev)
    _check(pad, "pad", torch.int32, (N, npair), dev)
    _check(pair_slots, "pair_slots", torch.int32, (npair, maxmem), dev)
    if N > MAX_INTEGRANDS:
        raise ValueError(f"vegas_relw: {N} integrands > {MAX_INTEGRANDS}")
    relw = torch.empty_like(w)
    name = "vegas_relw_complex" if cplx else "vegas_relw"
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, "mci_" + name)(w.data_ptr(), invp.data_ptr(), pad.data_ptr(),
                                          pair_slots.data_ptr(), N, nslots, npair, maxmem,
                                          B * T * nb, m, relw.data_ptr(), stream)
    _build.check(lib, err, name)
    launch_counts[name] += 1
    return relw


def measured_mask(T: int, nb: int, m: int, mf: int, t0: int, device):
    """``[T, nb, m]`` bool: which samples of chunks ``t0..t0+T-1`` the gate
    of ``measurefreq = mf`` measures, by their index ``t*nb*m + p*m + j + 1``
    in the block (see module docstring)."""
    e = torch.arange(t0 * nb * m + 1, (t0 + T) * nb * m + 1, dtype=torch.int64, device=device)
    return (e % mf == 0).reshape(T, nb, m)


def vegas_reduce_plain(w, invp, perm, pad, pair_slots, used, m=None, mf=1, t0=0):
    """Plain torch version of ``csrc/vegas_reduce.cu``: the same float32
    products, summed in float64 in another order (a sample the gate shuts
    adds a zero)."""
    N, nslots = w.shape[0], invp.shape[0]
    used = used.tolist()
    jac, factors = _row_factors(invp, pad, pair_slots)
    gate = None
    if mf > 1:
        _, _, T, nb, ms = w.shape
        gate = measured_mask(T, nb, ms, mf, t0, w.device)

    def sums(v):
        v = v.double()
        if gate is not None:
            v = torch.where(gate, v, torch.zeros((), dtype=v.dtype, device=v.device))
        return v.sum(dim=(-2, -1))

    whsum = []
    for i in range(N):
        a = torch.clamp(weight_abs(w[i]) * jac[..., None], max=HIST_CLIP)
        whsum.append((a * a).double().sum(dim=-1))
    if m is not None:
        obs = [sums(mk) for mk in m]
    else:                            # complex: Re and Im of integrand i in 2i, 2i+1
        obs = [sums(p) for i, f in enumerate(factors)
               for p in weight_parts(weight_scale(w[i], f[..., None]))]
    hrow = torch.empty(invp.shape, dtype=torch.float64, device=w.device)
    for k in range(nslots):
        h = torch.zeros(invp.shape[1:], dtype=torch.float64, device=w.device)
        for i in range(N):
            if used[k][i]:
                h = h + whsum[i]
        hrow[k].scatter_(-1, perm[k].long(), h)
    return torch.stack(obs, dim=-1), hrow


def vegas_reduce(w, invp, perm, pad, pair_slots, used, m=None, mf=1, t0=0):
    """Observable sums and training histogram (see module docstring)."""
    if mf < 1 or t0 < 0:
        raise ValueError(f"vegas_reduce: measurefreq {mf} < 1 or first chunk {t0} < 0")
    if w.device.type == "cpu":
        return vegas_reduce_plain(w, invp, perm, pad, pair_slots, used, m, mf, t0)
    if w.device.type != "cuda":
        raise ValueError(f"vegas_reduce: unsupported device {w.device}")
    dev = w.device
    N, B, T, nb, ms = w.shape
    nslots = invp.shape[0]
    npair, maxmem = pair_slots.shape
    cplx = w.dtype == torch.complex64
    _check(w, "w", torch.complex64 if cplx else torch.float32, (N, B, T, nb, ms), dev)
    _check(invp, "invp", torch.float32, (nslots, B, T, nb), dev)
    _check(perm, "perm", torch.int32, (nslots, B, T, nb), dev)
    _check(pad, "pad", torch.int32, (N, npair), dev)
    _check(pair_slots, "pair_slots", torch.int32, (npair, maxmem), dev)
    _check(used, "used", torch.int32, (nslots, N), dev)
    if N > MAX_INTEGRANDS:
        raise ValueError(f"vegas_reduce: {N} integrands > {MAX_INTEGRANDS}")
    if t0 + T >= 2 ** 31:
        raise ValueError("vegas_reduce: chunk index too large")
    ncomp = 2 * N if cplx else N
    if m is not None:
        ncomp = m.shape[0]
        _check(m, "m", torch.float32, (ncomp, B, T, nb, ms), dev)
        if ncomp < 1:
            raise ValueError("vegas_reduce: a measure with no components")
    R = B * T * nb
    obs_rows = torch.empty((B, T, nb, ncomp), dtype=torch.float64, device=dev)
    hrow = torch.empty((nslots, B, T, nb), dtype=torch.float64, device=dev)
    lib = _build.load()
    entry = lib.mci_vegas_reduce_complex if cplx else lib.mci_vegas_reduce
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = entry(
            w.data_ptr(), invp.data_ptr(), perm.data_ptr(), pad.data_ptr(),
            pair_slots.data_ptr(), used.data_ptr(), N, nslots, npair, maxmem,
            R, nb, ms, None if m is None else m.data_ptr(), ncomp, mf, t0, T,
            obs_rows.data_ptr(), hrow.data_ptr(), stream)
    _build.check(lib, err, "vegas_reduce")
    key = "vegas_reduce_complex" if cplx else "vegas_reduce" if m is None else \
        "vegas_reduce_measure"
    launch_counts[key] += 1
    # the kernel writes one partial per stratum row; this sum over the rows
    # is the first step of the fixed-order float64 reduction
    return _build.sum_obs(obs_rows, 2, cplx and m is None), hrow
