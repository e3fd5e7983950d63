"""Smoke test of the PyTorch port (mcintegration_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --burnin-scan     # the bubble's bins against its burn-in

Builds the hand-written CUDA kernels from ``mcintegration_tpu_torch/csrc``
with nvcc and drives every ported path on the card.

- :vegas (phases 3-7): ``vegas_sample`` and ``vegas_reduce`` against their
  plain PyTorch versions (also at their edge shapes, ``VEGAS_EDGES`` and
  ``REDUCE_EDGES``), ``integrate(solver="vegas", device="cuda")`` on the
  2-D pi problem at 2^30 evals per iteration, adaptive and multi-integrand
  runs against their exact values, kernel times beside the plain versions,
  and a ``torch.profiler`` trace of three iterations.
- :vegasmc, the default solver (phases 3b-7b): ``chain_propose`` and
  ``chain_accept`` against their plain versions from one state (also with
  every walker in one histogram bin, and ``chain_propose`` at
  ``PROPOSE_EDGES``) and over a whole iteration, ``integrate(solver="vegasmc", device="cuda")`` on the 2-D
  pi problem at 2^28 evals per iteration with 2^20 walkers, adaptive,
  Discrete and reweighted runs against their exact values, time per chain
  step, and a profile of three iterations.
- :mcmc with FermiK pools and a custom measure (phases 3c-7c):
  ``mcmc_propose``, ``mcmc_accept`` and ``mcmc_measure`` against their plain
  versions from one state at 2^20 walkers and over a whole iteration (one
  ``mcmc_measure`` launch per measured step for both integrands, and two
  launches, bit-equal, over ``MAX_SECTORS + 1`` sectors),
  ``integrate(solver="mcmc", device="cuda")`` on the Lindhard bubble at 2^28
  evals per iteration with 2^18 walkers against the Lindhard function, pi,
  the unit balls, a Discrete pool and the FermiK shells against their exact
  values, time per step (``mcmc_accept`` on measured and unmeasured steps;
  ``mcmc_measure`` with L2 warm and flushed, its bytes in whole 32-byte
  sectors, and at phase 3c's two integrands), the bounds from each step's
  bytes and operations, and a profile of one iteration with each kernel's
  device time per launch.

- custom measures on :vegas and :vegasmc (phases 3e, 4e, 6e): ``chain_accept``
  writing the relative weights and ``chain_measure`` at 2^20 walkers with 10
  and 64 components, ``vegas_relw`` and ``vegas_reduce`` given the measure's
  output at one launch of phase 4's shape, against their plain versions; the
  identity measure against the default one over a run of each solver; the
  quickstart's 10-bin histogram through ``integrate`` on :vegas at 2^30 evals
  per iteration and on :vegasmc at 2^28 with 2^20 walkers, every bin against
  its exact value, with the rates beside phases 4 and 4b; kernel times and
  the peak memory of a launch.
- complex weights on :vegasmc and :mcmc (phases 3f, 4f, 6f):
  ``chain_accept_complex`` and ``mcmc_accept_complex`` (the complex
  instantiations of ``chain_accept.cu`` and ``mcmc_accept.cu``) against
  their plain versions from one state at 2^20 walkers, with the default
  measure on measured and unmeasured steps and with complex custom
  measures; ``f + 0j`` against ``f`` over a run of each solver;
  ``integrate(type=complex, device="cuda")`` on ``e^{i(x+y)}`` and on a
  complex one-hot histogram over ``Discrete(1, 3)`` at phases 4b's and 4c's
  sizes, the real and imaginary part of every mean against its exact value,
  with the rates beside phases 4b and 4c; what complex weights cost a run
  (the quarter disc ``f`` against ``f + 0j`` at those sizes, in turns); the
  complex kernels' times and bounds at phases 6b's and 6c's shapes.
- :vegasplus (phases 3d-7d): ``vplus_sample`` and ``vplus_reduce`` against
  their plain versions after one reallocation of the hypercube counts, at
  the main path's shape and on a spec that takes every branch (also with
  every sample of a span in one histogram bin, and with more than 4,096
  histogram bins at 3 seeds), and over a whole iteration; ``integrate(solver="vegasplus", device="cuda")`` on the
  non-separable ``singular_3d`` integrand at 2^30 evals per iteration against
  its exact value, with its error bar beside :vegas' on the same budget; pi,
  ``log(x)/sqrt(x)``, the 4-D Gaussians, padding and a Discrete passenger
  against their exact values; kernel times; and a profile of two iterations.

- the measurement side of :vegas and :vegasplus (phases 3g, 4g, 6g): the
  complex instantiations of ``vegas_reduce`` and ``vegas_relw``, and of
  ``vplus_reduce``, ``vplus_relw`` (relative weights for a custom measure)
  and ``vplus_reduce`` given the measure's output, each with and without the
  gate of ``measurefreq``, against their plain versions at one launch of
  phases 4's and 4d's shapes (and ``vegas_reduce`` at ``REDUCE_EDGES``);
  ``f + 0j`` against ``f`` over an iteration of each solver;
  ``integrate(type=complex)`` on the quarter disc times ``e^{i(x+y)}`` on
  both solvers, the quickstart's histogram on :vegasplus, a complex
  histogram of ``e^{i(x+y)}`` on :vegas and pi with ``measurefreq=4`` on
  both, at 2^30 evals per iteration, against their exact values, with the
  rates beside phases 4 and 4d; the new entry points' times and bounds.
- :vegas on Discrete pools and pools of different ninc, the mixed route
  (phases 3h, 4h, 6h): ``vegas_sample_mixed``, ``vegas_relw_mixed`` and
  every instantiation of ``vegas_reduce_mixed`` against their plain
  versions on ``MIXED_SPECS`` (the bubble's, a Discrete CDF in device memory,
  strata of m_k % 4 != 0, all Discrete, more than 4,096 histogram bins),
  and a spec of the uniform route through both routes;
  ``integrate(solver="vegas", device="cuda")`` at 2^30 evals per iteration
  on the Lindhard bubble (its four bins against the Lindhard function at
  20 sigma and against the bubble's exact value at its temperature at 5
  sigma, also with ``type=complex`` and ``measurefreq=4``), an adaptive
  Discrete, ``Discrete([(1, 3), (1, 4)])`` and mixed ninc, against their
  exact values, each with its rate beside phase 4's and its idle share; the
  three kernels' times, bounds and ptxas registers at the bubble's launch.

Each path's launch counts are set to 0 just before its main path runs and
read just after.  Any failed phase raises, so the exit code is non-zero.

Prints the card's name and power limit, one JSON line describing each
kernel (with its bound: the larger of its bytes over 3.35 TB/s and its
operations, float32 ones over 67 TFLOP/s and integer ones over 16.7 TOP/s
INT32, the SM's 64 INT32 lanes at 1.98 GHz: ``PEAK_INT_OPS``), and as the last line
``{"ok": true, "device": {...}}``.  Exits
non-zero without a result when no CUDA device is available.  Imports no JAX.
"""

import json
import subprocess
import sys
import time

import numpy as np

SEED = 20260817
REL_TOL_REDUCE = 1e-9   # same float32 products, float64 sums in another order
REL_TOL_HIST = 1e-9     # chain histograms: float64 atomics in another order
REL_TOL_VPLUS = 1e-12   # vplus_reduce: the same float32 terms, float64 sums in another order


def _pi(x, c):
    import torch
    return torch.where(x[0] ** 2 + x[1] ** 2 < 1, 1.0, 0.0)


def _singular(x, c):
    import torch
    return -torch.log(x[0]) / torch.sqrt(x[0]) / 4.0


def _two(x, c):
    import torch
    return (x[0], torch.where(x[0] ** 2 + x[1] ** 2 < 1, 1.0, 0.0))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bits(t):
    """The int32 bits of a float32 tensor, and of both parts of a complex64
    one; other tensors as they are."""
    import torch
    if t.dtype == torch.complex64:
        t = torch.view_as_real(t)
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def hists_of(it, hrow):
    """Per-leaf histograms from hrow [S, B, T, nb], summed as run() does."""
    h = hrow.sum(dim=(1, 2)).cpu().numpy()
    out, k = [], 0
    for li in it.spec.leaves:
        out.append(h[k:k + li.ndraw].sum(axis=0))
        k += li.ndraw
    return out


def launch_vs_plain(vk, it, inputs, t0):
    """One launch of both kernels at chunks [t0, t0+T) against their plain
    versions on the same inputs; raises on any disagreement.  Returns the
    max abs error of each kernel."""
    import torch

    T = min(it.chunks_per_launch, it.nchunks - t0)
    got = vk.vegas_sample(t0=t0, T=T, m=it.m_tile, **inputs)
    want = vk.vegas_sample_plain(t0=t0, T=T, m=it.m_tile, **inputs)
    for name, a, b in zip(("x", "invp", "perm"), got, want):
        if not torch.equal(bits(a), bits(b)):
            raise AssertionError(f"vegas_sample {name} differs from the plain "
                                 f"version at t0={t0}, T={T}")
    err_sample = max(float((a - b).abs().max()) for a, b in zip(got, want))
    del want
    x, invp, perm = got
    w = it.evaluate(it.leaf_values(x))
    masks = (it.pad, it.pair_slots, it.used)
    obs, hrow = vk.vegas_reduce(w, invp, perm, *masks)
    obsr, hrowr = vk.vegas_reduce_plain(w, invp, perm, *masks)
    rel = max(rel_err(obs.cpu(), obsr.cpu()), rel_err(hrow.cpu(), hrowr.cpu()))
    if rel > REL_TOL_REDUCE:
        raise AssertionError(f"vegas_reduce vs plain at t0={t0}, T={T}: "
                             f"rel {rel:.3g} > {REL_TOL_REDUCE}")
    err_reduce = float(max((obs - obsr).abs().max(), (hrow - hrowr).abs().max()))
    return err_sample, err_reduce, rel


# (m, N, ncomp, B, T, nb) of phase 3's edge shapes of vegas_reduce: short
# rows (scalar loads, several columns a warp), several integrands, more than
# 256 (fewer rows a tile) and MAX_INTEGRANDS (one row a tile)
REDUCE_EDGES = ((3, 1, 10, 2, 3, 37), (100, 3, 64, 2, 3, 37), (1024, 300, 10, 2, 3, 37),
                (5, 2048, 3, 1, 2, 5))


def reduce_inputs(m, N, ncomp, B=2, T=3, nb=37, seed=0, device="cuda", cplx=False):
    """Random inputs of vegas_reduce (three slots, four (group, slot) pairs
    of up to two slots, random pads and uses, one histogram weight above the
    clip; complex64 weights with ``cplx``) and a measure's output of
    ``ncomp`` components, on ``device``."""
    import torch
    rng = np.random.default_rng(seed)
    S, P, M = 3, 4, 2
    w = rng.normal(size=(N, B, T, nb, m)).astype(np.float32)
    w[0, 0, 0, 0, 0] = 3e9
    if cplx:
        w = w + 1j * rng.normal(size=w.shape).astype(np.float32)
    invp = rng.uniform(0.2, 3.0, size=(S, B, T, nb)).astype(np.float32)
    perm = np.stack([[[rng.permutation(nb) for _ in range(T)] for _ in range(B)]
                     for _ in range(S)])
    pair_slots = np.full((P, M), -1)
    for g in range(P):
        k = rng.integers(1, M + 1)
        pair_slots[g, :k] = rng.choice(S, size=k, replace=False)
    pad = rng.integers(0, 2, size=(N, P))
    used = rng.integers(0, 2, size=(S, N))
    used[0] = 0
    mobs = rng.normal(size=(ncomp, B, T, nb, m)).astype(np.float32)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    i32 = lambda a: torch.as_tensor(a, dtype=torch.int32, device=device)
    wt = torch.as_tensor(w.astype(np.complex64), device=device) if cplx else f32(w)
    return (wt, f32(invp), i32(perm), i32(pad), i32(pair_slots), i32(used)), f32(mobs)


def relw_components(relw):
    """The default measure's components of relative weights ``relw [N,
    ...]``: relw itself, or for complex64 ones Re and Im of integrand i in
    components 2i and 2i+1, ``[2N, ...]`` float32."""
    import torch
    if not relw.is_complex():
        return relw
    z = torch.view_as_real(relw).movedim(-1, 1)
    return z.reshape((-1,) + tuple(relw.shape[1:])).contiguous()


def reduce_edges(vk):
    """vegas_reduce at REDUCE_EDGES in both modes against its plain version
    (REL_TOL_REDUCE), and given the identity measure m = relw bit-equal to
    the default sums; raises on any disagreement."""
    for m, N, ncomp, B, T, nb in REDUCE_EDGES:
        args, mobs = reduce_inputs(m, N, ncomp, B, T, nb)
        w, invp, _, pad, pair_slots, _ = args
        rel = 0.0
        for given in (None, mobs):
            got, want = vk.vegas_reduce(*args, given), vk.vegas_reduce_plain(*args, given)
            rel = max(rel, *(rel_err(a.cpu(), b.cpu()) for a, b in zip(got, want)))
        if rel > REL_TOL_REDUCE:
            raise AssertionError(f"vegas_reduce at m={m}, N={N}, {ncomp} components: rel "
                                 f"{rel:.3g} > {REL_TOL_REDUCE}")
        default = vk.vegas_reduce(*args)
        ident = vk.vegas_reduce(*args, vk.vegas_relw(w, invp, pad, pair_slots))
        if not all(torch_equal_bits(a, b) for a, b in zip(default, ident)):
            raise AssertionError(f"vegas_reduce at m={m}, N={N}: given m = relw, the sums "
                                 "differ from the default ones")
        print(f"phase 3: vegas_reduce at m={m}, N={N}, {ncomp} components, "
              f"{invp[0].numel()} rows: both modes rel {rel:.3g}, given m = relw bit-equal to "
              f"the default sums")


# name, strata nb, dof, samples per stratum m, first chunk t0, chunks T of
# phase 3's edge shapes of vegas_sample, on two trained pools of nb bins
# (dof [[1], [2]]: four slots, two on each leaf): one stratum, strata that
# are and are not a power of two up to MAX_STRATA, m with scalar draws (not a
# multiple of 4) and with quads, the main path's m, t0 > 0 and T > 1
VEGAS_EDGES = (("nb 1, m 1", 1, [[1]], 1, 0, 1),
               ("nb 7, m 3, t0 5, T 3", 7, [[1], [2]], 3, 5, 3),
               ("nb 7, m 129, t0 1, T 2", 7, [[1], [2]], 129, 1, 2),
               ("nb 32768, m 4, t0 2, T 2", 32768, [[1], [2]], 4, 2, 2),
               ("nb 32768, m 3", 32768, [[1]], 3, 0, 1),
               ("nb 1024, m 1024, t0 1, T 2", 1024, [[1], [2]], 1024, 1, 2))


def _edge_f(x, c):
    return (x[0][0], x[1][0] * x[1][1])


def vegas_sample_edge(mt, vk, edge, device="cuda"):
    """vegas_sample at one of VEGAS_EDGES (2 blocks), bit for bit against its
    plain version, and two calls bit-equal; raises on any difference."""
    import torch
    from mcintegration_tpu_torch.ops.rng import block_keys
    from mcintegration_tpu_torch.solvers.engine import Spec
    from mcintegration_tpu_torch.solvers.vegas import VegasIteration

    name, nb, dof, m, t0, T = edge
    var = mt.Continuous([(0.0, 1.0), (0.0, 2.0)], ninc=nb)
    for k, leaf in enumerate(var):
        leaf.histogram = np.random.default_rng(nb + k).gamma(0.5, 1.0, nb) + 1e-3
        leaf.train()
    spec = Spec(mt.Configuration(var=var, dof=dof, seed=SEED), device)
    it = VegasIteration(spec, _edge_f if len(dof) == 2 else _first, block=2,
                        nevalperblock=nb * 4)
    inputs = it.kernel_inputs(spec.device_params(), block_keys(SEED, 2, 0, it.block))
    got = vk.vegas_sample(t0=t0, T=T, m=m, **inputs)
    again = vk.vegas_sample(t0=t0, T=T, m=m, **inputs)
    want = vk.vegas_sample_plain(t0=t0, T=T, m=m, **inputs)
    torch.cuda.synchronize()
    for what, a, b, c in zip(("x", "invp", "perm"), got, want, again):
        if not (torch.equal(bits(a), bits(b)) and torch.equal(bits(a), bits(c))):
            raise AssertionError(f"vegas_sample {what} differs from the plain version ({name})")
    return len(it.slot_map)


def vegas_sample_edges(mt, vk):
    """Phase 3: vegas_sample at VEGAS_EDGES."""
    for edge in VEGAS_EDGES:
        S = vegas_sample_edge(mt, vk, edge)
        print(f"phase 3: vegas_sample, {edge[0]}, {S} slots: x, invp and perm bit-equal, "
              f"repeat bit-identical")


def trained_config(mt):
    """The pi problem's configuration on a non-uniform map (one training
    from a synthetic histogram)."""
    cfg = mt.Configuration(var=mt.Continuous(0.0, 1.0), dof=[[2]], seed=SEED)
    leaf = cfg.var[0]
    leaf.histogram = np.random.default_rng(1).gamma(0.5, 1.0, leaf.ninc) + 1e-3
    leaf.train()
    return cfg


def kernel_vs_plain(mt, vk, card):
    """Phase 3: ninc=1024, non-uniform grid.  A whole iteration at B=16,
    nevalperblock=2^20 against the plain path, twice; then launches at the
    main path's shape (nevalperblock=2^26), first, second and last."""
    import torch
    from mcintegration_tpu_torch.ops.rng import block_keys
    from mcintegration_tpu_torch.solvers.engine import Spec
    from mcintegration_tpu_torch.solvers.vegas import VegasIteration

    spec = Spec(trained_config(mt), "cuda")
    it = VegasIteration(spec, _pi, block=16, nevalperblock=2 ** 20)
    assert it.nchunks == it.chunks_per_launch == 1, (it.nchunks, it.chunks_per_launch)
    params = spec.device_params()
    kd = block_keys(SEED, 0, 0, it.block)
    inputs = it.kernel_inputs(params, kd)

    x, invp, perm = vk.vegas_sample(t0=0, T=1, m=it.m_tile, **inputs)
    xr, invpr, permr = vk.vegas_sample_plain(t0=0, T=1, m=it.m_tile, **inputs)
    for name, a, b in (("x", x, xr), ("invp", invp, invpr), ("perm", perm, permr)):
        if not torch.equal(bits(a), bits(b)):
            raise AssertionError(f"vegas_sample {name} differs from the plain version")
    w = it.evaluate(it.leaf_values(x))
    obsr, hrowr = vk.vegas_reduce_plain(w, invp, perm, it.pad, it.pair_slots, it.used)
    ref_obs = obsr.sum(dim=1).cpu().numpy()
    ref_hists = hists_of(it, hrowr)
    ref_norm = np.full(it.block, float(it.nb * it.m_tile * it.nchunks))

    runs = [it.run(params, kd) for _ in range(2)]    # kernels, twice
    for st in runs:
        assert np.array_equal(st["norm_blocks"], ref_norm)
        e_obs = rel_err(st["obs_blocks"], ref_obs)
        e_hist = max(rel_err(h, r) for h, r in zip(st["hists"], ref_hists))
        if max(e_obs, e_hist) > REL_TOL_REDUCE:
            raise AssertionError(f"vegas_reduce vs plain: obs rel {e_obs:.3g}, "
                                 f"hist rel {e_hist:.3g} > {REL_TOL_REDUCE}")
    a, b = runs
    if not (np.array_equal(a["obs_blocks"], b["obs_blocks"])
            and all(np.array_equal(p, q) for p, q in zip(a["hists"], b["hists"]))):
        raise AssertionError("the same kd did not reproduce the iteration bit for bit")
    x2, invp2, perm2 = vk.vegas_sample(t0=0, T=1, m=it.m_tile, **inputs)
    assert torch.equal(bits(x2), bits(x)) and torch.equal(perm2, perm)
    print(f"phase 3: kernels vs plain at B=16, nevalperblock=2^20, ninc=1024: "
          f"x/invp/perm bit-equal, obs rel {e_obs:.3g}, hist rel {e_hist:.3g}, "
          f"norm exact, repeat bit-identical")

    big = VegasIteration(spec, _pi, block=16, nevalperblock=2 ** 26)
    T = big.chunks_per_launch
    assert big.nchunks > 2 * T, (big.nchunks, T)
    inputs = big.kernel_inputs(params, block_keys(SEED, 1, 0, big.block))
    for t0 in (0, T, big.nchunks - T):
        _, _, rel = launch_vs_plain(vk, big, inputs, t0)
        print(f"phase 3: main-path launch t0={t0}, T={T} of {big.nchunks} chunks "
              f"(x [{len(big.slot_map)},{big.block},{T},{big.nb},{big.m_tile}]): "
              f"x/invp/perm bit-equal, reduce rel {rel:.3g}")
    reduce_edges(vk)
    vegas_sample_edges(mt, vk)


def main_path(mt, vk, card):
    """Phase 4: integrate() at 2^30 evals per iteration through the kernels."""
    from mcintegration_tpu_torch.solvers.engine import Spec
    from mcintegration_tpu_torch.solvers.vegas import VegasIteration

    niter, block, neval = 10, 16, 2 ** 30
    shape = VegasIteration(
        Spec(mt.Configuration(var=mt.Continuous(0.0, 1.0), dof=[[2]], seed=SEED), "cuda"),
        _pi, block=block, nevalperblock=neval // block)
    expected = niter * shape.launches_per_run
    vk.reset_launch_counts()
    res = mt.integrate(_pi, var=mt.Continuous(0.0, 1.0), dof=[[2]], neval=neval,
                       niter=niter, block=block, solver="vegas", device="cuda",
                       seed=SEED, verbose=-2)
    counts = {k: vk.launch_counts[k] for k in ("vegas_sample", "vegas_reduce")}
    mean, err = float(res.mean[0]), float(res.stdev[0])
    assert res.backend == "cuda", res.backend
    assert expected > 0 and all(n == expected for n in counts.values()), (counts, expected)
    assert vk.launch_counts["vegas_relw"] == vk.launch_counts["vegas_reduce_measure"] == 0
    assert abs(mean - np.pi / 4) < 5 * err, (mean, err)
    evals = [h[2].neval for h in res.iterations]
    steady = sum(evals[1:]) / sum(res.iteration_times[1:])
    print(f"phase 4: pi/4 = {mean!r} +- {err!r} ({(mean - np.pi / 4) / err:+.2f} sigma), "
          f"{niter} iterations of {evals[0]} evals, launches {counts} "
          f"(expected {expected} each), backend {res.backend}")
    print(f"phase 6: steady-state {steady!r} evals/s (iterations 2-{niter}, "
          f"first excluded; per-iteration s {res.iteration_times}) [{card}]")
    return counts, shape, steady


def adaptive_checks(mt):
    """Phase 5: grid training and padding factors on the card, within 7 sigma."""
    runs = [("singular -log(x)/sqrt(x)/4", _singular, [[1]], [1.0]),
            ("two integrands, padding", _two, [[1], [2]], [0.5, np.pi / 4])]
    for name, f, dof, exact in runs:
        res = mt.integrate(f, var=mt.Continuous(0.0, 1.0), dof=dof, neval=2 ** 26,
                           niter=10, block=16, solver="vegas", device="cuda",
                           seed=SEED, verbose=-2)
        for i, e in enumerate(exact):
            m, s = float(res.mean[i]), float(res.stdev[i])
            assert abs(m - e) < 7 * s, (name, i, m, s, e)
            print(f"phase 5: {name}, integral {i}: {m!r} +- {s!r} vs {e!r} "
                  f"({(m - e) / s:+.2f} sigma)")


def time_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps, queue_s=0.2):
    """Device time per call of ``fn``: the calls are queued behind a sleep
    kernel of about ``queue_s`` seconds, so the card runs them back to back
    however slowly the host issues them (time_ms would time the host).  If
    the queue drains before the last call is issued (the host shares its
    cores), the measurement is taken again behind a sleep twice as long."""
    import torch
    tries = 3
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(queue_s * 2e9))        # cycles: ~queue_s at <= 2 GHz
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        drained = end.query()
        torch.cuda.synchronize()
        if not drained:
            return start.elapsed_time(end) / reps
        queue_s *= 2
    raise AssertionError("device_ms: the queue drained before the host issued every call "
                         f"{tries} times (a call waits for the device, or the host is slow)")


def timings(mt, vk, shape, card):
    """Phase 6: per-launch times at the main path's launch shape, the
    kernels in turns with their plain versions (plain, kernel, kernel, plain)."""
    import torch
    from mcintegration_tpu_torch.ops.rng import block_keys

    it = shape
    T = it.chunks_per_launch
    inputs = it.kernel_inputs(it.spec.device_params(), block_keys(SEED, 0, 0, it.block))
    args = (it.pad, it.pair_slots, it.used)

    def sample():
        return vk.vegas_sample(t0=0, T=T, m=it.m_tile, **inputs)

    def sample_plain():
        return vk.vegas_sample_plain(t0=0, T=T, m=it.m_tile, **inputs)

    err_sample, err_reduce, _ = launch_vs_plain(vk, it, inputs, 0)
    x, invp, perm = sample()
    w = it.evaluate(it.leaf_values(x))

    ms = {"sample": [], "sample_plain": [], "reduce": [], "reduce_plain": []}
    for order in (("plain", "kernel"), ("kernel", "plain")):
        for kind in order:
            if kind == "kernel":
                ms["sample"].append(device_ms(sample, 10))
                # the main path's call: the rows, summed once an iteration
                ms["reduce"].append(device_ms(
                    lambda: vk.vegas_reduce(w, invp, perm, *args, rows=True), 10))
            else:
                ms["sample_plain"].append(time_ms(sample_plain, 3))
                ms["reduce_plain"].append(
                    time_ms(lambda: vk.vegas_reduce_plain(w, invp, perm, *args), 3))
    ms = {k: float(np.mean(v)) for k, v in ms.items()}
    ms_integrand = time_ms(lambda: it.evaluate(it.leaf_values(x)), 10)
    n = it.block * T * it.chunk
    nslots = len(it.slot_map)
    obs, hrow = vk.vegas_reduce(w, invp, perm, *args, rows=True)
    sample_bytes = sum(t.numel() * t.element_size() for t in (*inputs.values(), x, invp, perm)
                       if isinstance(t, torch.Tensor))
    reduce_bytes = sum(t.numel() * t.element_size() for t in (w, invp, perm, *args, obs, hrow))
    # per drawn value, the integer work the law fixes: two lowbias32 rounds
    # and the mixing of the draw's index (i ^ k1, + k2 + salt, & 0xFFFFFF)
    # and 5 float32 operations (convert, add and multiply of the uniform, the
    # map's multiply and add); a row's stratum and permutation, and a
    # group's keys, come once per m or nb*m values.  8 float32 operations
    # per sample and integrand in the reduction
    b_sample = bound(sample_bytes, 5 * n * nslots, VEGAS_DRAW_INT * n * nslots)
    b_reduce = bound(reduce_bytes, 8 * n * (w.shape[0] + nslots))
    print(f"phase 6: one launch = {it.block} blocks x {T} chunks x {it.chunk} "
          f"samples ({n} evals, {len(it.slot_map)} slots); kernels' device time per call, "
          f"calls queued behind a sleep kernel [{card}]")
    print(f"phase 6: vegas_sample {ms['sample']!r} ms/launch, plain torch "
          f"{ms['sample_plain']!r} ms [{card}]")
    print(f"phase 6: integrand (torch) {ms_integrand!r} ms/launch [{card}]")
    print(f"phase 6: vegas_reduce {ms['reduce']!r} ms/launch, plain torch "
          f"{ms['reduce_plain']!r} ms [{card}]")
    print(f"phase 6: vegas_sample bound {b_sample[0]!r} ms ({sample_bytes} bytes, by "
          f"{b_sample[1]}; {VEGAS_DRAW_INT} integer operations a value take "
          f"{VEGAS_DRAW_INT * n * nslots / PEAK_INT_OPS * 1e3!r} ms); vegas_reduce bound "
          f"{b_reduce[0]!r} ms ({reduce_bytes} bytes, by {b_reduce[1]})")
    print(f"phase 6: peak device memory {torch.cuda.max_memory_allocated()} bytes")
    return {"vegas_sample": (err_sample, ms["sample"], ms["sample_plain"], *b_sample),
            "vegas_reduce": (err_reduce, ms["reduce"], ms["reduce_plain"], *b_reduce)}


def profile_main_path(card, phase, run, per_launch=(), top=15):
    """Phase 7/7b/7c: torch.profiler over ``run()``, iterations of
    integrate() at a main path's size (phase 4, 4b or 4c ran it already, so
    nothing is built or touched first here); the device time per launch of
    each kernel whose name holds one of ``per_launch``; returns its Result."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name, launches = [], {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end
                                                          - e.time_range.start)
            launches[e.name] = launches.get(e.name, 0) + 1
    if not spans:
        raise AssertionError("torch.profiler recorded no device time")
    busy, reach = 0.0, -np.inf          # union of the device intervals, in us
    for a, b in sorted(spans):
        if b > reach:
            busy += b - max(a, reach)
            reach = b
    busy_s = busy * 1e-6
    assert res.backend == "cuda", res.backend
    print(f"phase {phase}: profile of {len(res.iterations)} iterations of "
          f"{res.iterations[0][2].neval} "
          f"evals: wall {wall!r} s, device busy {busy_s!r} s, idle share "
          f"{1 - busy_s / wall!r} [{card}]")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"phase {phase}: {us * 1e-3!r} ms on the device in {name[:90]}")
    for key in per_launch:
        names = [name for name in by_name if key in name]
        n, us = sum(launches[x] for x in names), sum(by_name[x] for x in names)
        assert n, f"phase {phase}: no launch of {key} in the profile"
        print(f"phase {phase}: {key}: {n} launches, {us * 1e-3 / n!r} ms per launch on the "
              f"device [{card}]")
    return res


# ---------------------------------------------------------------------------
# :vegasmc, the default solver
# ---------------------------------------------------------------------------

def _chain_two(x, c):
    """Two integrands over a (Continuous, Discrete) CompositeVar slot pair;
    integrand 1 pads integrand 0's single slot."""
    import torch
    a, b = x
    return (a[0] * b[0].to(torch.float32) / 50.5,
            torch.where(a[0] ** 2 + a[1] ** 2 < 1.0, 1.0, 0.0) * (b[1] <= 50))


def chain_config(mt, **kw):
    """Phase 3b's configuration: a trained ninc=1024 Continuous map and a
    trained Discrete(1, 100) in one CompositeVar, dof=[[1], [2]]; ``kw``
    goes to the Configuration (``type=complex``)."""
    rng = np.random.default_rng(2)
    c = mt.Continuous(0.0, 1.0)
    c.histogram = rng.gamma(0.5, 1.0, c.ninc) + 1e-3
    c.train()
    d = mt.Discrete(1, 100)
    d.histogram = rng.gamma(0.5, 1.0, d.nbin) + 1e-3
    d.train()
    return mt.Configuration(var=mt.CompositeVar(c, d), dof=[[1], [2]], seed=SEED, **kw)


def state_bits_equal(a, b, what, hist_rel=REL_TOL_HIST):
    """Every field of two ChainStates (or McmcStates) bit-equal but the
    histogram, which must agree to ``hist_rel`` (the :mcmc kernels add exact
    1.0s: 0); returns the max abs error over the float fields (slot values
    excepted: a Discrete slot holds int32 bits)."""
    import dataclasses
    err = 0.0
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "hist" and hist_rel > 0:
            rel = rel_err(x.cpu(), y.cpu())
            if rel > hist_rel:
                raise AssertionError(f"{what}: hist rel {rel:.3g} > {hist_rel}")
        elif not torch_equal_bits(x, y):
            raise AssertionError(f"{what}: {f.name} differs from the plain version")
        if (x.is_floating_point() or x.is_complex()) and x.numel() \
                and not f.name.endswith("_val"):
            err = max(err, float((x - y).abs().max()))
    return err


def one_bin(st):
    """Every slot of every walker, in both copies, in bin 0 of its leaf:
    after chain_accept every walker adds into one histogram bin per leaf,
    the worst case for the merge of a warp's lanes."""
    st.cur_gidx.zero_()
    st.prp_gidx.zero_()


def one_bin_span(gidx):
    """A copy of vplus_sample's gidx with every sample of the first span of
    every chunk in bin 0 of each slot: one histogram bin per slot takes the
    span's samples, the worst case for the merge of a warp's lanes."""
    from mcintegration_tpu_torch.ops.vplus_kernels import SPAN
    g = gidx.clone()
    g[..., :SPAN] = 0
    return g


def torch_equal_bits(x, y):
    import torch
    if x.dtype == torch.float64:
        return torch.equal(x.view(torch.int64), y.view(torch.int64))
    return torch.equal(bits(x), bits(y))


class plain_versions:
    """Within the block, the named wrappers of ``module`` are their plain
    torch versions, so a solver runs them on the card (the wrappers would
    launch the kernels)."""

    def __init__(self, module, *names):
        self.module, self.names = module, names

    def __enter__(self):
        self.saved = [getattr(self.module, n) for n in self.names]
        for n in self.names:
            setattr(self.module, n, getattr(self.module, n + "_plain"))

    def __exit__(self, *exc):
        for n, f in zip(self.names, self.saved):
            setattr(self.module, n, f)


def _edge_disc(x, c):
    import torch
    a, b = x
    return (a[0] * b[0].to(torch.float32), torch.where(a[1] < 0.5, 1.0, 0.0) * (b[1] <= 20))


def _edge_groups(x, c):
    import torch
    a, b, e, _ = x
    return (a[0] * a[1], b[0].to(torch.float32) * e[0] * e[1])


def _edge_disc_var(mt, upper, ninc):
    rng = np.random.default_rng(upper)
    c, d = mt.Continuous(0.0, 1.0, ninc=ninc), mt.Discrete(-3 if upper > 1024 else 1, upper)
    for leaf in (c, d):
        leaf.histogram = rng.gamma(0.5, 1.0, leaf.nhist) + 1e-3
        leaf.train()
    return mt.CompositeVar(c, d)


# name, var, dof, integrand, blocks, walkers of phase 3b's edge shapes of
# chain_propose: a Discrete CDF staged in shared memory (<= 1024 bins) and
# one searched in device memory, groups of different maxdof with a pool never
# drawn (fewer eligible groups than pools), and Monte Carlo blocks and walker
# counts that are not a multiple of the kernel's 256-walker thread blocks
PROPOSE_EDGES = (
    ("staged CDF of 40 bins, 2 blocks of 600 walkers", lambda mt: _edge_disc_var(mt, 40, 100),
     [[1], [2]], _edge_disc, 2, 1200),
    ("CDF of 2004 bins in device memory, 2 blocks of 500", lambda mt: _edge_disc_var(mt, 2000, 64),
     [[1], [2]], _edge_disc, 2, 1000),
    ("maxdof 2, 1, 2 and an undrawn pool, 3 blocks of 333",
     lambda mt: (mt.Continuous(0.0, 1.0, ninc=50), mt.Discrete(1, 7),
                 mt.Continuous(0.0, 2.0, ninc=30), mt.Continuous(0.0, 1.0, ninc=10)),
     [[2, 0, 0, 0], [0, 1, 2, 0]], _edge_groups, 3, 999),
    ("the main path's spec, 4 blocks of 1536", lambda mt: mt.Continuous(0.0, 1.0), [[2]], _pi, 4,
     6144))


def chain_propose_edge(mt, ck, edge, device="cuda"):
    """chain_propose at one of PROPOSE_EDGES, bit for bit against its plain
    version: the first draw (init = 1) into zeroed slots, and a proposal
    from the state after two steps; raises on any difference."""
    import torch
    from mcintegration_tpu_torch.ops.rng import block_keys
    from mcintegration_tpu_torch.solvers.engine import Spec
    from mcintegration_tpu_torch.solvers.vegasmc import VegasMCIteration

    name, var, dof, f, block, W = edge
    spec = Spec(mt.Configuration(var=var(mt), dof=dof, seed=SEED), device)
    it = VegasMCIteration(spec, f, block=block, nevalperblock=8 * W // block, nwalkers=W)
    lay = it.layout
    kd = it.seeds(block_keys(SEED, 3, 0, block))
    tab, rw, st = it.start(spec.device_params(), kd)
    a, b = st.clone(), st.clone()
    for x in (a, b):
        for field in ("cur_val", "cur_gidx", "cur_prob", "prp_val", "prp_gidx", "prp_prob"):
            getattr(x, field).zero_()
    ck.chain_propose(lay, tab, kd, 0, a, init=True)
    ck.chain_propose_plain(lay, tab, kd, 0, b, init=True)
    torch.cuda.synchronize()
    state_bits_equal(a, b, f"chain_propose init = 1 ({name})")
    for t in range(2):
        it.step(tab, rw, kd, st, t)
    ref = st.clone()
    ck.chain_propose(lay, tab, kd, 2, st)
    ck.chain_propose_plain(lay, tab, kd, 2, ref)
    torch.cuda.synchronize()
    state_bits_equal(st, ref, f"chain_propose ({name})")
    return lay


def chain_propose_edges(mt, ck):
    """Phase 3b: chain_propose at PROPOSE_EDGES."""
    for edge in PROPOSE_EDGES:
        lay = chain_propose_edge(mt, ck, edge)
        print(f"phase 3b: chain_propose, {edge[0]} (W={lay.W}, wb={lay.wb}, {len(lay.dleaf)} "
              f"leaves, {len(lay.elig)} of {lay.spec.nvar} groups eligible, "
              f"{lay.smem_floats} CDF floats staged): init and a step bit-equal")


def chain_vs_plain(mt, ck, card):
    """Phase 3b: one chain_propose and one chain_accept from the same state,
    bit for bit, at 2^20 walkers; then a whole iteration through the kernels
    against one through the plain versions."""
    import torch
    from mcintegration_tpu_torch.ops.rng import block_keys
    from mcintegration_tpu_torch.solvers.engine import Spec
    from mcintegration_tpu_torch.solvers.vegasmc import VegasMCIteration

    spec = Spec(chain_config(mt), "cuda")
    it = VegasMCIteration(spec, _chain_two, block=16, nevalperblock=2 ** 24,
                          nwalkers=2 ** 20)
    lay, params = it.layout, spec.device_params()
    kd = it.seeds(block_keys(SEED, 0, 0, it.block))
    tab, rw, st = it.start(params, kd)
    for t in range(4):
        it.step(tab, rw, kd, st, t)
    ref = st.clone()
    ck.chain_propose(lay, tab, kd, 4, st)
    ck.chain_propose_plain(lay, tab, kd, 4, ref)
    torch.cuda.synchronize()
    err_propose = state_bits_equal(st, ref, "chain_propose")
    nw = it.weights(st)
    ck.chain_accept(lay, rw, kd, 4, st, nw, measure=True)
    ck.chain_accept_plain(lay, rw, kd, 4, ref, nw, measure=True)
    torch.cuda.synchronize()
    err_accept = state_bits_equal(st, ref, "chain_accept")
    moved = int(st.ac.sum())
    print(f"phase 3b: one step from the same state at W={lay.W} ({lay.S} slots, "
          f"Discrete(1, 100) + ninc=1024, dof=[[1],[2]]): state, prop, weights, "
          f"pads, p, tallies and float64 accumulators bit-equal; hist max abs err "
          f"{err_accept!r}; {moved} accepted moves so far")
    pi_it = VegasMCIteration(Spec(mt.Configuration(var=mt.Continuous(0.0, 1.0), dof=[[2]],
                                                   seed=SEED), "cuda"),
                             _pi, block=16, nevalperblock=2 ** 24, nwalkers=2 ** 20)
    for what, hot_it in (("phase 3b's spec", it), ("the main path's spec", pi_it)):
        tab_h, rw_h, kd_h, st = chain_measured_state(hot_it)
        one_bin(st)
        ref = st.clone()
        nw = hot_it.weights(st)
        ck.chain_accept(hot_it.layout, rw_h, kd_h, 4, st, nw, measure=True)
        ck.chain_accept_plain(hot_it.layout, rw_h, kd_h, 4, ref, nw, measure=True)
        torch.cuda.synchronize()
        err_accept = max(err_accept, state_bits_equal(st, ref, f"chain_accept, one bin, {what}"))
        print(f"phase 3b: one step of {what} ({hot_it.layout.nhist} bins) with every "
              f"walker's slots in bin 0: bit-equal but the histogram, hist rel "
              f"{rel_err(st.hist.cpu(), ref.hist.cpu()):.3g}")
        del st, ref, nw

    it = VegasMCIteration(spec, _chain_two, block=16, nevalperblock=2 ** 20,
                          nwalkers=2 ** 18)
    kd = block_keys(SEED, 1, 0, it.block)
    got = it.run(params, kd)
    with plain_versions(ck, "chain_propose", "chain_accept"):
        want = it.run(params, kd)
    for key in ("obs_blocks", "norm_blocks", "visited", "propose", "accept"):
        if not np.array_equal(got[key], want[key]):
            raise AssertionError(f"whole iteration: {key} differs from the plain "
                                 f"versions (rel {rel_err(got[key], want[key]):.3g})")
    e_hist = max(rel_err(h, r) for h, r in zip(got["hists"], want["hists"]))
    if e_hist > REL_TOL_HIST:
        raise AssertionError(f"whole iteration: hist rel {e_hist:.3g} > {REL_TOL_HIST}")
    print(f"phase 3b: whole iteration (W={it.nwalkers}, {it.nsteps} steps): obs, norm, "
          f"visited and tallies equal (rel 0), hist rel {e_hist:.3g}")
    chain_propose_edges(mt, ck)
    return err_propose, err_accept


def chain_main_path(mt, ck, card):
    """Phase 4b: integrate(solver="vegasmc") at 2^28 evals per iteration with
    2^20 walkers through the chain kernels."""
    niter, block, neval, W = 10, 16, 2 ** 28, 2 ** 20
    nsteps = neval // W
    expected = niter * (nsteps + 1)          # nsteps steps and one init launch
    ck.reset_launch_counts()
    res = mt.integrate(_pi, var=mt.Continuous(0.0, 1.0), dof=[[2]], neval=neval,
                       niter=niter, block=block, solver="vegasmc", nwalkers=W,
                       device="cuda", seed=SEED, verbose=-2)
    counts = {k: ck.launch_counts[k] for k in ("chain_propose", "chain_accept")}
    mean, err = float(res.mean[0]), float(res.stdev[0])
    assert res.backend == "cuda", res.backend
    assert all(n == expected for n in counts.values()), (counts, expected)
    assert ck.launch_counts["chain_measure"] == ck.launch_counts["chain_accept_complex"] == 0
    assert abs(mean - np.pi / 4) < 5 * err, (mean, err)
    evals = [h[2].neval for h in res.iterations]
    steady = sum(evals[1:]) / sum(res.iteration_times[1:])
    print(f"phase 4b: pi/4 = {mean!r} +- {err!r} ({(mean - np.pi / 4) / err:+.2f} sigma), "
          f"{niter} iterations of {evals[0]} evals ({W} walkers x {nsteps} steps), "
          f"launches {counts} (expected {expected} each), backend {res.backend}")
    print(f"phase 4b: steady-state {steady!r} evals/s (iterations 2-{niter}; "
          f"per-iteration s {res.iteration_times}) [{card}]")
    return counts, steady


def chain_checks(mt):
    """Phase 5b: adaptive, Discrete and reweighted :vegasmc runs within 7 sigma."""
    import torch

    def singular(x, c):
        return torch.log(x[0]) / torch.sqrt(x[0])

    def disc(x, c):
        return x[0].to(torch.float32)

    def td(x, c):
        t, d = x
        return t[0] * d[0].to(torch.float32)

    def balls(x, c):
        r2 = x[0] ** 2 + x[1] ** 2
        return (torch.where(r2 < 1.0, 1.0, 0.0), torch.where(r2 + x[2] ** 2 < 1.0, 1.0, 0.0))

    # the unit balls run with warmup=0.1: at 256 steps per walker the
    # reference's 1% burn-in leaves a -5 sigma start-up transient on this
    # case, in the JAX package's XLA route as in the port (PERF.md)
    runs = [("singular log(x)/sqrt(x)", singular, mt.Continuous(0.0, 1.0), [[1]], [-4.0], 0.01),
            ("Discrete(1, 3), f = x", disc, mt.Discrete(1, 3), [[1]], [6.0], 0.01),
            ("(Continuous, Discrete(1, 4)), f = t*d", td,
             (mt.Continuous(0.0, 1.0), mt.Discrete(1, 4)), [[1, 1]], [5.0], 0.01),
            ("unit balls, dof=[[2],[3]], warmup=0.1", balls, mt.Continuous(0.0, 1.0),
             [[2], [3]], [np.pi / 4, np.pi / 6], 0.1)]
    for name, f, var, dof, exact, warmup in runs:
        res = mt.integrate(f, var=var, dof=dof, neval=2 ** 24, niter=10, block=16,
                           solver="vegasmc", warmup=warmup, device="cuda", seed=SEED,
                           verbose=-2)
        for i, e in enumerate(exact):
            m, s = float(res.mean[i]), float(res.stdev[i])
            assert abs(m - e) < 7 * s, (name, i, m, s, e)
            print(f"phase 5b: {name}, integral {i}: {m!r} +- {s!r} vs {e!r} "
                  f"({(m - e) / s:+.2f} sigma)")
        print(f"phase 5b: {name}: reweight {res.config.reweight.tolist()}, "
              f"acceptance {res.config.accept[1, 0, 0] / res.config.propose[1, 0, 0]!r}")


def chain_timings(mt, ck, card):
    """Phase 6b: time per chain step at the main path's shape, each kernel in
    turns with its plain version (plain, kernel, kernel, plain); then evals/s
    at the default walker count."""
    import torch
    from mcintegration_tpu_torch.ops.rng import block_keys
    from mcintegration_tpu_torch.solvers.engine import Spec
    from mcintegration_tpu_torch.solvers.vegasmc import VegasMCIteration, choose_walkers

    spec = Spec(mt.Configuration(var=mt.Continuous(0.0, 1.0), dof=[[2]], seed=SEED), "cuda")
    it = VegasMCIteration(spec, _pi, block=16, nevalperblock=2 ** 24, nwalkers=2 ** 20)
    lay = it.layout
    kd = it.seeds(block_keys(SEED, 0, 0, it.block))
    tab, rw, st = it.start(spec.device_params(), kd)
    for t in range(4):
        it.step(tab, rw, kd, st, t)
    ref = st.clone()
    ck.chain_propose(lay, tab, kd, 4, st)
    ck.chain_propose_plain(lay, tab, kd, 4, ref)
    err_propose = state_bits_equal(st, ref, "chain_propose at the main path's shape")
    nw = it.weights(st)
    ck.chain_accept(lay, rw, kd, 4, st, nw, measure=True)
    ck.chain_accept_plain(lay, rw, kd, 4, ref, nw, measure=True)
    err_accept = state_bits_equal(st, ref, "chain_accept at the main path's shape")

    ms = {"propose": [], "propose_plain": [], "accept": [], "accept_plain": []}
    for order in (("plain", "kernel"), ("kernel", "plain")):
        for kind in order:
            sfx = "" if kind == "kernel" else "_plain"
            reps = 20 if kind == "kernel" else 5
            prop = getattr(ck, "chain_propose" + sfx)
            acc = getattr(ck, "chain_accept" + sfx)
            ms["propose" + sfx].append(device_ms(lambda: prop(lay, tab, kd, 5, st), reps))
            ms["accept" + sfx].append(
                device_ms(lambda: acc(lay, rw, kd, 5, st, nw, measure=True), reps))
    ms = {k: float(np.mean(v)) for k, v in ms.items()}
    ms_integrand = device_ms(lambda: it.weights(st), 20)
    ms_step_dev = device_ms(lambda: it.step(tab, rw, kd, st, 6), 20)
    ms_step = time_ms(lambda: it.step(tab, rw, kd, st, 6), 20)
    print(f"phase 6b: one step = {lay.W} walkers x {lay.S} slots; device time per "
          f"call, calls queued behind a sleep kernel [{card}]")
    print(f"phase 6b: chain_propose {ms['propose']!r} ms/step, plain torch "
          f"{ms['propose_plain']!r} ms [{card}]")
    print(f"phase 6b: integrand (torch) {ms_integrand!r} ms/step [{card}]")
    print(f"phase 6b: chain_accept {ms['accept']!r} ms/step, plain torch "
          f"{ms['accept_plain']!r} ms [{card}]")
    print(f"phase 6b: whole step on the device {ms_step_dev!r} ms; as the host issues "
          f"it {ms_step!r} ms, {lay.W / ms_step * 1e3!r} evals/s [{card}]")
    # bytes per walker and step: propose reads the old prob of the chosen slot
    # and writes the proposed slot, prop and move; accept reads the proposed
    # probs, nw, prop, move and p, copies the changed slot, updates the
    # tallies, reads the state for the histogram weight and, on a measured
    # step, reads and writes the float64 accumulators
    S, n, nd = lay.S, lay.spec.N, lay.spec.N + 1
    pi_, pf_ = propose_ops(lay)
    b_prop = bound(lay.W * (4 + 12 + 4 + 8), pf_, pi_)
    b_acc = bound(lay.W * (4 * S + 4 * n + 16 + 36 + 16 + 8 * S + 4 * n + 4 * nd
                           + 16 * n + 16 * nd + 16), ACCEPT_OPS[1] * lay.W,
                  ACCEPT_OPS[0] * lay.W)
    print(f"phase 6b: chain_propose bound {b_prop[0]!r} ms (by {b_prop[1]}; {pi_ / lay.W!r} "
          f"integer and {pf_ / lay.W!r} float32 operations a walker take "
          f"{pi_ / PEAK_INT_OPS * 1e3!r} and {pf_ / PEAK_OPS * 1e3!r} ms), chain_accept bound "
          f"{b_acc[0]!r} ms (by {b_acc[1]}); chain_accept takes "
          f"{ms['accept'] / b_acc[0]!r} times its bound [{card}]")

    neval, block = 2 ** 28, 16
    W, nsteps = choose_walkers(neval, block, None, 256)
    res = mt.integrate(_pi, var=mt.Continuous(0.0, 1.0), dof=[[2]], neval=neval,
                       niter=3, block=block, solver="vegasmc", device="cuda", seed=SEED,
                       verbose=-2)
    assert abs(float(res.mean[0]) - np.pi / 4) < 5 * float(res.stdev[0])
    evals = [h[2].neval for h in res.iterations]
    steady = sum(evals[1:]) / sum(res.iteration_times[1:])
    print(f"phase 6b: default walker count ({W} walkers x {nsteps} steps at 2^28 evals): "
          f"{steady!r} evals/s steady state (iterations 2-3, per-iteration s "
          f"{res.iteration_times}) [{card}]")
    print(f"phase 6b: peak device memory {torch.cuda.max_memory_allocated()} bytes")
    return {"chain_propose": (err_propose, ms["propose"], ms["propose_plain"], *b_prop),
            "chain_accept": (err_accept, ms["accept"], ms["accept_plain"], *b_acc)}


# ---------------------------------------------------------------------------
# :mcmc, with FermiK pools and custom measures
# ---------------------------------------------------------------------------

QSIZE = 4                                   # the Lindhard bubble (examples/bubble.py)
RS, BETA, SPIN, ME = 1.0, 25.0, 2, 0.5
KF = (9 * np.pi / (2 * SPIN)) ** (1 / 3) / RS
BETA_PHYS = BETA / (KF ** 2 / (2 * ME))
EXTQ = np.array([[q, 0.0, 0.0] for q in np.linspace(0.0, 1.5 * KF, QSIZE)])


def lindhard(q):
    density = ME * KF / (2 * np.pi ** 2)
    q = max(q, 1e-6)
    x = q / 2 / KF
    p = 1 + (1 - x ** 2) * np.log1p(4 * x / ((1 - x) ** 2)) / 4 / x if abs(q - 2 * KF) > 1e-6 else 1.0
    return -p * density * SPIN / 2


def bubble_exact(q, beta=BETA_PHYS):
    """The bubble integral as posed, at inverse temperature ``beta``:
    ``-SPIN ME / (2 pi^2 q) int_0^inf k f(e_k) ln|(2k + q) / (2k - q)| dk``
    (the angles done in closed form; ``-SPIN ME / (2 pi^2) int f dk`` at q =
    0) with ``f`` the Fermi function and ``e_k = (k^2 - KF^2) / (2 ME)``.
    ``lindhard(q)`` is its zero-temperature limit; at BETA = 25 (T / E_F =
    0.04) the integral lies above it by 6.6e-4 to 2.0e-3 of it for the four
    q of EXTQ."""
    from scipy.integrate import quad
    fermi = lambda k: 0.5 * (1.0 - np.tanh(0.5 * beta * (k * k - KF ** 2) / (2 * ME)))
    if q == 0:
        f, cut, scale = fermi, [0.0, KF, 4 * KF], -SPIN * ME / (2 * np.pi ** 2)
    else:
        f = lambda k: k * fermi(k) * np.log(abs((2 * k + q) / (2 * k - q)))
        cut = sorted({0.0, q / 2, KF, 4 * KF})
        scale = -SPIN * ME / (2 * np.pi ** 2 * q)
    return scale * sum(quad(f, a, b, epsabs=0.0, epsrel=1e-13, limit=500)[0]
                       for a, b in zip(cut[:-1], cut[1:]))


def _green(tau, omega, beta):
    import torch
    pos = tau >= 0.0
    gp = torch.where(omega > 0.0, torch.exp(-omega * tau) / (1 + torch.exp(-omega * beta)),
                     torch.exp(omega * (beta - tau)) / (1 + torch.exp(omega * beta)))
    gn = torch.where(omega > 0.0, -torch.exp(-omega * (tau + beta)) / (1 + torch.exp(-omega * beta)),
                     -torch.exp(-omega * tau) / (1 + torch.exp(omega * beta)))
    return torch.where(pos, gp, gn)


def make_bubble(device):
    """The polarisation bubble, batched (``k[0]`` is ``[3, *batch]``), with
    its q table on ``device`` once: a copy from the host in every call
    would wait for the device and stall the step loop."""
    import torch
    extq = torch.as_tensor(EXTQ, dtype=torch.float32, device=device)

    def bubble(idx, vars, c):
        t, k, ext = vars
        kvec = k[0]
        kq = kvec + extq[ext[0] - 1].movedim(-1, 0)
        w1 = ((kvec * kvec).sum(0) - KF ** 2) / (2 * ME)
        w2 = ((kq * kq).sum(0) - KF ** 2) / (2 * ME)
        return _green(t[0], w1, BETA_PHYS) * _green(-t[0], w2, BETA_PHYS) * SPIN / (2 * np.pi) ** 3

    return bubble


def _bubble_measure(idx, vars, relw, c):
    from mcintegration_tpu_torch import onehot
    return [onehot(vars[-1][0], 1, QSIZE, relw.dtype, like=relw) * relw]


# Burn-in of the main path: as many steps as it measures.  At the JAX test's
# thermal_ratio=0.3 (307 steps before 1024 measured ones) the walkers, which
# start from fresh shell draws, have not yet filled the regions where |k+q|
# is near kF, and the q > 0 bins come out 10-16 sigma above the Lindhard
# function at 2^28 evals per iteration; a longer burn-in removes it
# (``--burnin-scan``, PERF.md, ROADMAP.md section 3).
BUBBLE_THERMAL = 1.0


def bubble_kw(mt, thermal_ratio=BUBBLE_THERMAL):
    """integrate() keywords of the bubble (tests/test_bubble_fermik.py:81-97)."""
    var = (mt.Continuous(0.0, BETA_PHYS, alpha=3.0), mt.FermiK(3, KF, 0.2 * KF, 10.0 * KF),
           mt.Discrete(1, QSIZE, adapt=False))
    return dict(measure=_bubble_measure, var=var, dof=[[1, 1, 1]], obs=[np.zeros(QSIZE)],
                solver="mcmc", block=16, thermal_ratio=thermal_ratio)


def bubble_z(res):
    """Each q bin's distance from the Lindhard function, in its sigma."""
    avg, std = np.asarray(res.mean[0]), np.asarray(res.stdev[0])
    return [(avg[i] - lindhard(EXTQ[i][0])) / std[i] for i in range(QSIZE)]


def burnin_scan(mt, card, niter=6):
    """The bubble's q bins against the Lindhard function as the burn-in
    grows: 2^18 walkers x 1024 measured steps with 307, 1024 and 3072
    burn-in steps, and 2^16 walkers x 4096 steps with 1228."""
    for W, nsteps, thermal in ((2 ** 18, 1024, 0.3), (2 ** 18, 1024, 1.0),
                               (2 ** 18, 1024, 3.0), (2 ** 16, 4096, 0.3)):
        t0 = time.perf_counter()
        res = mt.integrate(make_bubble("cuda"), neval=W * nsteps, niter=niter, nwalkers=W,
                           device="cuda", seed=SEED, verbose=-2, **bubble_kw(mt, thermal))
        print(f"burn-in scan: {W} walkers x {nsteps} steps, thermal_ratio {thermal} "
              f"({int(nsteps * thermal)} burn-in steps), {niter} iterations: sigma from "
              f"Lindhard {[round(z, 2) for z in bubble_z(res)]}, stdev "
              f"{np.asarray(res.stdev[0]).tolist()} ({time.perf_counter() - t0:.1f} s) [{card}]")


def mcmc_allbranch(mt, W, cplx=False, phase=True, custom=True):
    """Phase 3c's spec: a trained ninc=1024 map and Discrete(-3, 2000) (a CDF
    searched in device memory) in one CompositeVar, FermiK pools in 3-D and
    2-D, two integrands of different dof with groups of two slots (swap),
    and a custom measure of two components per integrand (or, without
    ``custom``, the default measure).  With ``cplx`` the weights are
    complex, the integrands times a phase (or, without ``phase``, plus 0j)
    and the observables complex."""
    import torch
    from mcintegration_tpu_torch.solvers.engine import Spec
    from mcintegration_tpu_torch.solvers.mcmc import MCMCIteration

    rng = np.random.default_rng(3)
    c, d = mt.Continuous(0.0, 1.0), mt.Discrete(-3, 2000)
    for leaf in (c, d):
        leaf.histogram = rng.gamma(0.5, 1.0, leaf.nhist) + 1e-3
        leaf.train()
    var = (mt.CompositeVar(c, d), mt.FermiK(3, 1.0, 0.3, 10.0), mt.FermiK(2, 1.0, 0.3, 10.0))
    obs = [np.zeros(2, complex if cplx else float)] * 2

    def f(i, x, cc):
        (a, dd), k3, k2 = x
        w = a[0] * (1.0 + dd[0].to(torch.float32).abs() / 2000.0)
        if i == 0:
            w = w * torch.exp(-(k3[0] * k3[0]).sum(0))
        else:
            w = w * torch.exp(-(k2[0] * k2[0]).sum(0) - (k3[1] * k3[1]).sum(0))
        if cplx:
            w = w * torch.exp(1j * (4.0 * a[0] + k3[0][0])) if phase else w + 0j
        return w

    def meas(i, x, relw, cc):
        out = [torch.zeros((2,) + relw.shape, device=relw.device)] * 2
        out[i] = torch.stack([relw, relw * x[0][0][0]])
        return out

    spec = Spec(mt.Configuration(var=var, dof=[[2, 1, 0], [1, 2, 1]], seed=SEED, obs=obs,
                                 type=complex if cplx else float), "cuda")
    kw = dict(measure=meas, obs_proto=obs) if custom else {}
    return MCMCIteration(spec, f, block=16, nevalperblock=W * 64 // 16, nwalkers=W,
                         thermal_ratio=0.1, **kw)


def mcmc_one_step(it, mk, st, tab, rw, kd, sched, group, t, what, measure=True):
    """One step of each :mcmc kernel from ``st`` against its plain version
    on a copy: (max abs err of propose, accept, measure; the last 0.0 on an
    unmeasured step).  ``st`` advances."""
    import torch
    lay = it.layout
    ref = st.clone()
    mk.mcmc_propose(lay, tab, kd, sched, t, st)
    mk.mcmc_propose_plain(lay, tab, kd, sched, t, ref)
    torch.cuda.synchronize()
    e_prop = state_bits_equal(st, ref, f"mcmc_propose {what}", hist_rel=0.0)
    nw = it.weights(st, group)
    mk.mcmc_accept(lay, tab, rw, kd, sched, t, st, nw, measure=measure)
    mk.mcmc_accept_plain(lay, tab, rw, kd, sched, t, ref, nw, measure=measure)
    torch.cuda.synchronize()
    e_acc = state_bits_equal(st, ref, f"mcmc_accept {what}", hist_rel=0.0)
    if not measure or it.measure is None:
        return e_prop, e_acc, 0.0
    vals = lay.leaf_values(st.cur_val)
    ms = [m(vals, st.relw).contiguous() for m in it.measure]
    mk.mcmc_measure(lay, ms, st)
    mk.mcmc_measure_plain(lay, ms, ref)
    torch.cuda.synchronize()
    e_meas = state_bits_equal(st, ref, f"mcmc_measure {what}", hist_rel=0.0)
    return e_prop, e_acc, e_meas


def mcmc_vs_plain(mt, mk, card):
    """Phase 3c: one step of each :mcmc kernel from the same state, bit for
    bit, at 2^20 walkers of a spec with every branch; then a whole iteration
    at 2^18 walkers x 64 steps through the kernels against one through the
    plain versions."""
    from mcintegration_tpu_torch.ops.rng import block_keys

    it = mcmc_allbranch(mt, 2 ** 20)
    lay = it.layout
    assert it.backend_reason == "", it.backend_reason
    kd_np = block_keys(SEED, 0, 0, it.block)
    sched, groups = it.schedule(kd_np)
    kd = it.seeds(kd_np)
    tab, rw, st = it.start(it.spec.device_params(), kd, sched)
    for t in range(5):
        it.step(tab, rw, kd, sched, groups[t], st, t)
    errs = mcmc_one_step(it, mk, st, tab, rw, kd, sched, groups[5], 5, "(phase 3c)")
    roles = np.bincount(st.move[0].cpu().numpy(), minlength=5).tolist()
    print(f"phase 3c: one step from the same state at W={lay.W} ({lay.S} slots, "
          f"{lay.V} value rows: ninc=1024 + Discrete(-3, 2000) in device memory, FermiK 3-D "
          f"and 2-D, dof=[[2,1,0],[1,2,1]], custom measure): every field bit-equal; roles "
          f"none/CV/swap/CI/NJ {roles}; {int(st.tally[1].sum())} accepted moves so far")

    it = mcmc_allbranch(mt, 2 ** 18)
    kd = block_keys(SEED, 1, 0, it.block)
    before = mk.launch_counts["mcmc_measure"]
    got = it.run(it.spec.device_params(), kd)
    n_measure = mk.launch_counts["mcmc_measure"] - before
    assert n_measure == it.nsteps, (n_measure, it.nsteps)
    with plain_versions(mk, "mcmc_propose", "mcmc_accept", "mcmc_measure"):
        want = it.run(it.spec.device_params(), kd)
    for key in ("obs_blocks", "norm_blocks", "visited", "propose", "accept"):
        a, b = got[key], want[key]
        same = (all(np.array_equal(x, y) for x, y in zip(a, b)) if isinstance(a, list)
                else np.array_equal(a, b))
        if not same:
            raise AssertionError(f"whole :mcmc iteration: {key} differs from the plain versions")
    if not all(np.array_equal(h, r) for h, r in zip(got["hists"], want["hists"])):
        raise AssertionError("whole :mcmc iteration: hists differ from the plain versions")
    print(f"phase 3c: whole iteration (W={it.nwalkers}, {it.nsteps} + {it.nburnin} steps): "
          f"obs, norm, visited, tallies and histograms equal (rel 0); {n_measure} mcmc_measure "
          f"launches for its {it.nsteps} measured steps of {it.spec.N} sectors")
    err_many, launches = measure_many_sectors(mt, mk)
    print(f"phase 3c: mcmc_measure over {mk.MAX_SECTORS + 1} sectors: {launches} launches, "
          f"every field bit-equal to the plain version")
    return errs[0], errs[1], max(errs[2], err_many)


def measure_many_sectors(mt, mk, W=2 ** 16, device="cuda"):
    """mcmc_measure over MAX_SECTORS + 1 sectors (two launches) against its
    plain version, from random sectors (the normalization sector included),
    outputs and accumulators: (max abs err, launches)."""
    import torch
    from mcintegration_tpu_torch.solvers.engine import Spec

    N, ncomp = mk.MAX_SECTORS + 1, 3
    spec = Spec(mt.Configuration(var=mt.Continuous(0.0, 1.0), dof=[[1]] * N, seed=SEED), device)
    lay = mk.McmcLayout.build(spec, 16, W // 16, ncomp, True)
    rng = np.random.default_rng(SEED)
    st = mk.McmcState.zeros(lay)
    st.curr.copy_(torch.as_tensor(rng.integers(0, N + 1, W).astype(np.int32)))
    st.obs.copy_(torch.as_tensor(rng.normal(size=(ncomp, W))))
    ms = [torch.as_tensor(rng.normal(size=(ncomp, W)).astype(np.float32), device=device)
          for _ in range(N)]
    ref = st.clone()
    before = mk.launch_counts["mcmc_measure"]
    mk.mcmc_measure(lay, ms, st)
    launches = mk.launch_counts["mcmc_measure"] - before
    mk.mcmc_measure_plain(lay, ms, ref)
    if device != "cpu":
        torch.cuda.synchronize()
    return state_bits_equal(st, ref, f"mcmc_measure over {N} sectors", hist_rel=0.0), launches


def mcmc_main_path(mt, mk, card, niter=10):
    """Phase 4c: the bubble through integrate(solver="mcmc") at 2^28 evals
    per iteration with 2^18 walkers, against the Lindhard function."""
    from mcintegration_tpu_torch.ops.mcmc_kernels import NRETRY
    neval, W = 2 ** 28, 2 ** 18
    nsteps = neval // W
    nburnin = int(nsteps * BUBBLE_THERMAL)
    mk.reset_launch_counts()
    res = mt.integrate(make_bubble("cuda"), neval=neval, niter=niter, nwalkers=W, device="cuda",
                       seed=SEED, verbose=-2, **bubble_kw(mt))
    counts = dict(mk.launch_counts)
    expected = {"mcmc_propose": niter * (nsteps + nburnin + NRETRY + 1),
                "mcmc_accept": niter * (nsteps + nburnin + NRETRY + 1),
                "mcmc_measure": niter * nsteps, "mcmc_accept_complex": 0}
    assert res.backend == "cuda" and res.backend_reason == "", (res.backend, res.backend_reason)
    assert counts == expected, (counts, expected)
    avg, std = np.asarray(res.mean[0]), np.asarray(res.stdev[0])
    evals = [h[2].neval for h in res.iterations]
    steady = sum(evals[1:]) / sum(res.iteration_times[1:])
    print(f"phase 4c: bubble, {niter} iterations of {evals[0]} evals ({W} walkers x "
          f"{nsteps} + {nburnin} steps), launches {counts} (expected {expected}), "
          f"backend {res.backend}")
    bad = []
    for i, z in enumerate(bubble_z(res)):
        print(f"phase 4c: q/kF = {EXTQ[i][0] / KF:.3f}: {float(avg[i])!r} +- {float(std[i])!r} "
              f"vs Lindhard {lindhard(EXTQ[i][0])!r} ({z:+.2f} sigma), chi2 "
              f"{float(np.asarray(res.chi2[0])[i])!r}")
        if not abs(z) < 7:
            bad.append(i)
    print(f"phase 4c: steady-state {steady!r} evals/s (iterations 2-{niter}; per-iteration s "
          f"{res.iteration_times}) [{card}]")
    assert not bad, f"bins {bad} outside 7 sigma of the Lindhard function"
    return counts, steady


def mcmc_checks(mt):
    """Phase 5c: pi, the unit balls with reweighting, t*d with a Discrete
    pool and the FermiK shell integrals on :mcmc, each within 7 sigma."""
    import torch

    def pi(i, x, c):
        return torch.where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0)

    def balls(i, x, c):
        r2 = x[0] ** 2 + x[1] ** 2 + (x[2] ** 2 if i == 1 else 0.0)
        return torch.where(r2 < 1.0, 1.0, 0.0)

    def td(i, x, c):
        return x[0][0] * x[1][0].to(torch.float32)

    def shell3(i, x, c):
        k2 = (x[0][0] * x[0][0]).sum(0)
        k = torch.sqrt(k2)
        return torch.where((k > 0.8) & (k < 1.2), k2 * torch.exp(-x[1][0]), 0.0)

    def shell2(i, x, c):
        k2 = (x[0] * x[0]).sum(0)
        k = torch.sqrt(k2)
        return torch.where((k > 0.7) & (k < 1.3), k2, 0.0)

    runs = [("pi", pi, mt.Continuous(0.0, 1.0), [[2]], [np.pi / 4]),
            ("unit balls, dof=[[2],[3]]", balls, mt.Continuous(0.0, 1.0), [[2], [3]],
             [np.pi / 4, np.pi / 6]),
            ("(Continuous, Discrete(1, 4)), f = t*d", td,
             (mt.Continuous(0.0, 1.0), mt.Discrete(1, 4)), [[1, 1]], [5.0]),
            ("FermiK 3-D shell k^2 exp(-t)", shell3,
             (mt.FermiK(3, 1.0, 0.2, 10.0), mt.Continuous(0.0, 1.0)), [[1, 1]],
             [4 * np.pi / 5 * (1.2 ** 5 - 0.8 ** 5) * (1 - np.exp(-1.0))]),
            ("FermiK 2-D shell k^2", shell2, mt.FermiK(2, 1.0, 0.3, 10.0), [[1]],
             [np.pi / 2 * (1.3 ** 4 - 0.7 ** 4)])]
    for name, f, var, dof, exact in runs:
        res = mt.integrate(f, var=var, dof=dof, neval=2 ** 24, niter=10, block=16,
                           solver="mcmc", device="cuda", seed=SEED, verbose=-2)
        assert res.backend == "cuda" and res.backend_reason == "", (name, res.backend_reason)
        for i, e in enumerate(exact):
            m, s = float(res.mean[i]), float(res.stdev[i])
            assert abs(m - e) < 7 * s, (name, i, m, s, e)
            print(f"phase 5c: {name}, integral {i}: {m!r} +- {s!r} vs {e!r} "
                  f"({(m - e) / s:+.2f} sigma)")
        print(f"phase 5c: {name}: reweight {res.config.reweight.tolist()}")


# ---------------------------------------------------------------------------
# :vegasplus, hypercube stratification
# ---------------------------------------------------------------------------

SING3_EXACT = 1.3932039296856768     # benchmarks/report.py:594, the published battery


PI_HI = float(np.float32(np.pi))     # pi = PI_HI + PI_LO to float32's double precision
PI_LO = np.pi - PI_HI


def _sing3(x, c):
    """``singular_3d`` of the published battery: 1/(1 - cos a cos b cos c)/pi^3
    on [0, pi)^3, free of cancellation in float32 at all four singular corners.

    The battery writes 1 - cos a cos b cos c as s2a + ca*s2b + ca*cb*s2c with
    s2 = 2 sin^2(./2), which is a sum of non-negative terms near the origin
    only.  The denominator also vanishes at (pi, pi, 0), (pi, 0, pi) and
    (0, pi, pi), where that sum cancels (2 - 2 + small) and is wrong by a
    factor of 85 at distance 1e-2 and of 4.5e6 at 1e-3 in float32.  At 2^30
    evaluations per iteration the stratified sampler resolves those corners
    and trains on the rounding noise, and the estimate diverges (PERF.md).
    So each angle is folded to its distance u from the nearer of 0 and pi,
    |cos| = cos u, and the battery's sum runs on the folded angles (every cos
    non-negative); an odd number of angles beyond pi/2 flips the product's
    sign, and the denominator is then 2 minus that sum."""
    import torch
    u = [torch.minimum(t, (PI_HI - t) + PI_LO) for t in x]
    ca, cb = torch.cos(u[0]), torch.cos(u[1])
    s2a = 2 * torch.sin(u[0] / 2) ** 2
    s2b = 2 * torch.sin(u[1] / 2) ** 2
    s2c = 2 * torch.sin(u[2] / 2) ** 2
    below = s2a + ca * s2b + ca * cb * s2c               # 1 - |cos a cos b cos c|
    odd = (x[0] > np.pi / 2) ^ (x[1] > np.pi / 2) ^ (x[2] > np.pi / 2)
    return 1.0 / torch.where(odd, 2.0 - below, below) / np.pi ** 3


SING3_KW = dict(dof=[[3]], solver="vegasplus", neval=2 ** 30, block=16, device="cuda",
                seed=SEED, verbose=-2)


def _vplus_allbranch_f(x, c):
    import torch
    (t, d), u, v = x
    return (t[0] * (1.0 + u[0]) + 0.1,
            (t[0] + t[1]) * d[1].to(torch.float32) * torch.exp(-u[0] * v[0]) + 0.2)


def _vplus_allbranch_cf(x, c):
    """Phase 3d's two integrands times a phase each."""
    import torch
    (t, _), u, _ = x
    w0, w1 = _vplus_allbranch_f(x, c)
    return w0 * torch.exp(2j * u[0]), w1 * torch.exp(-3j * t[0])


def vplus_allbranch(mt, nevalperblock, ninc=1000, device="cuda", cplx=False, **kw):
    """Phase 3d's spec: trained maps of ``ninc`` (1000; 5000 puts its
    histogram beyond SMEM_HIST_BINS) and 64 bins, a trained Discrete(1, 7)
    passenger bundled with the first, a non-adaptive pool, and two
    integrands of which the first leaves a slot of two groups unused; with
    ``cplx``, complex weights (the integrands times a phase each)."""
    from mcintegration_tpu_torch.solvers.engine import Spec
    from mcintegration_tpu_torch.solvers.vegasplus import VegasPlusIteration

    rng = np.random.default_rng(4)
    a, b = mt.Continuous(0.0, 1.0, ninc=ninc), mt.Continuous(0.0, 2.0, ninc=64)
    d, e = mt.Discrete(1, 7), mt.Continuous(-1.0, 1.0, ninc=48, adapt=False)
    for leaf in (a, b, d):
        leaf.histogram = rng.gamma(0.5, 1.0, leaf.nhist) + 1e-3
        leaf.train()
    cfg = mt.Configuration(var=(mt.CompositeVar(a, d), b, e), dof=[[1, 1, 0], [2, 1, 1]],
                           seed=SEED, type=complex if cplx else float)
    return VegasPlusIteration(Spec(cfg, device), _vplus_allbranch_cf if cplx else
                              _vplus_allbranch_f, block=16, nevalperblock=nevalperblock, **kw)


def _first(x, c):
    return x[0][0]


# name, var, dof, nstrat, nevalperblock of phase 3d's edge shapes of
# vplus_sample: 1 to 6 slots, chunks that are and are not a multiple of 4
# (16-byte or scalar stores), a Discrete passenger, nstrat from 1 to 5000
VPLUS_EDGES = (("1 slot, nstrat 5000, chunk 10002", lambda mt: mt.Continuous(0.0, 1.0), [[1]],
                5000, 10002),
               ("2 slots, nstrat 25, chunk 16384", lambda mt: mt.Continuous(0.0, 1.0), [[2]],
                25, 2 ** 14),
               ("3 slots, nstrat 25, chunk 40001", lambda mt: mt.Continuous(0.0, 1.0), [[3]],
                25, 40001),
               ("4 slots with a passenger, nstrat 1, chunk 2002",
                lambda mt: (mt.Continuous(0.0, 1.0), mt.Discrete(1, 9)), [[3, 1]], 1, 2002),
               ("6 slots, nstrat 3, chunk 2001", lambda mt: mt.Continuous(0.0, 1.0), [[6]], 3,
                2001))


def vplus_sample_edges(mt, vp):
    """vplus_sample at VPLUS_EDGES after one reallocation, bit for bit
    against its plain version; raises on any difference."""
    import torch
    from mcintegration_tpu_torch.ops.rng import block_keys
    from mcintegration_tpu_torch.solvers.engine import Spec
    from mcintegration_tpu_torch.solvers.vegasplus import VegasPlusIteration

    for name, var, dof, nstrat, npb in VPLUS_EDGES:
        cfg = mt.Configuration(var=var(mt), dof=dof, seed=SEED)
        it = VegasPlusIteration(Spec(cfg, "cuda"), _first, block=16, nevalperblock=npb,
                                nstrat=nstrat)
        params = it.spec.device_params()
        it.reallocate(it.run(params, block_keys(SEED, 0, 0, it.block))["sig"])
        lay = it.layout
        tab, kd = lay.tables(params), it.seeds(block_keys(SEED, 1, 0, it.block))
        cube, _ = it.cube_tables()
        x, gidx = vp.vplus_sample(lay, tab, kd, 1, 2, cube)
        xp, gidxp = vp.vplus_sample_plain(lay, tab, kd, 1, 2, cube)
        torch.cuda.synchronize()
        if not (torch.equal(bits(x), bits(xp)) and torch.equal(gidx, gidxp)):
            raise AssertionError(f"vplus_sample differs from the plain version ({name})")
        print(f"phase 3d: vplus_sample, {name}: x and gidx bit-equal")


def vplus_launch_vs_plain(vp, it, tab, kd, cube, cfac, t0, T, what, hot=False):
    """One launch of both :vegasplus kernels at chunks [t0, t0+T) against
    their plain versions on the same inputs (with ``hot``, the reduce's
    gidx has every sample of the first span in bin 0: one_bin_span); raises
    on any disagreement.  Returns (max abs err of the sample, of the reduce,
    the reduce's rel err)."""
    import torch
    lay = it.layout
    x, gidx = vp.vplus_sample(lay, tab, kd, t0, T, cube)
    xp, gidxp = vp.vplus_sample_plain(lay, tab, kd, t0, T, cube)
    torch.cuda.synchronize()
    if not (torch.equal(bits(x), bits(xp)) and torch.equal(gidx, gidxp)):
        raise AssertionError(f"vplus_sample differs from the plain version ({what})")
    err_sample = float((x - xp).abs().max())
    del xp, gidxp
    w = it.evaluate(lay.leaf_values(x)).contiguous()
    del x
    if hot:
        gidx = one_bin_span(gidx)
    got = vp.vplus_reduce(lay, tab, w, gidx, cube, cfac)
    want = vp.vplus_reduce_plain(lay, tab, w, gidx, cube, cfac)
    torch.cuda.synchronize()
    rels = [rel_err(a.cpu(), b.cpu()) for a, b in zip(got, want)]
    if max(rels) > REL_TOL_VPLUS:
        raise AssertionError(f"vplus_reduce vs plain ({what}): obs/sig/hist rel {rels} "
                             f"> {REL_TOL_VPLUS}")
    err_reduce = max(float((a - b).abs().max()) for a, b in zip(got, want))
    return err_sample, err_reduce, max(rels)


def vplus_reduce_windows(mt, vp):
    """Phase 3d's all-branch spec with ninc=5000, whose histogram (5071
    bins) vplus_reduce adds in windows of SMEM_HIST_BINS bins, against the
    plain version at 3 seeds (the reallocation's and the launch's), to
    REL_TOL_VPLUS; raises on any disagreement."""
    from mcintegration_tpu_torch.ops.rng import block_keys

    for seed in range(3):
        it = vplus_allbranch(mt, 2 ** 20, ninc=5000)
        lay, params = it.layout, it.spec.device_params()
        assert lay.nhist > vp.SMEM_HIST_BINS, lay.nhist
        it.reallocate(it.run(params, block_keys(SEED + seed, 0, 0, it.block))["sig"])
        tab, kd = lay.tables(params), it.seeds(block_keys(SEED + seed, 1, 0, it.block))
        cube, cfac = it.cube_tables()
        what = f"all-branch spec, {lay.nhist} bins, seed {seed}"
        _, _, rel = vplus_launch_vs_plain(vp, it, tab, kd, cube, cfac, 0, it.chunks_per_launch,
                                          what)
        _, _, rel_hot = vplus_launch_vs_plain(vp, it, tab, kd, cube, cfac, 0,
                                              it.chunks_per_launch, f"{what}, one bin a span",
                                              hot=True)
        print(f"phase 3d: {what} (windows of {vp.SMEM_HIST_BINS} bins in shared memory): "
              f"x and gidx bit-equal, obs/sig/hist rel {rel:.3g}; with every sample of the "
              f"first span in bin 0, rel {rel_hot:.3g}")


def vplus_vs_plain(mt, vp, card):
    """Phase 3d: both kernels against their plain versions after one
    reallocation, at the main path's shape and on the all-branch spec;
    vplus_sample at its edge shapes; then a whole iteration through the
    kernels against one through the plain versions."""
    from mcintegration_tpu_torch.ops.rng import block_keys
    from mcintegration_tpu_torch.solvers.engine import Spec
    from mcintegration_tpu_torch.solvers.vegasplus import VegasPlusIteration

    cfg = mt.Configuration(var=mt.Continuous(0.0, np.pi), dof=[[3]], seed=SEED)
    leaf = cfg.var[0]
    leaf.histogram = np.random.default_rng(1).gamma(0.5, 1.0, leaf.ninc) + 1e-3
    leaf.train()
    main = VegasPlusIteration(Spec(cfg, "cuda"), _sing3, block=16, nevalperblock=2 ** 26)
    for name, it in (("main path's shape", main), ("all-branch spec", vplus_allbranch(mt, 2 ** 20))):
        lay, params = it.layout, it.spec.device_params()
        it.reallocate(it.run(params, block_keys(SEED, 0, 0, it.block))["sig"])
        tab, kd = lay.tables(params), it.seeds(block_keys(SEED, 1, 0, it.block))
        cube, cfac = it.cube_tables()
        T = it.chunks_per_launch
        for t0 in (0, it.nchunks - T):
            _, _, rel = vplus_launch_vs_plain(vp, it, tab, kd, cube, cfac, t0, T, name)
        _, _, rel_hot = vplus_launch_vs_plain(vp, it, tab, kd, cube, cfac, 0, T,
                                              f"{name}, one bin a span", hot=True)
        print(f"phase 3d: {name}: {lay.S} slots ({lay.D} stratified), nstrat {it.nstrat}, "
              f"{it.ncubes} cubes, chunk {it.chunk}, counts {int(it.counts.min())}.."
              f"{int(it.counts.max())}, launch [{it.block},{T},{it.chunk}], {lay.nhist} bins "
              f"({'whole' if lay.nhist <= vp.SMEM_HIST_BINS else 'windows'} in shared memory): "
              f"x and gidx bit-equal, obs/sig/hist rel {rel:.3g}; with every sample of the first "
              f"span in bin 0, rel {rel_hot:.3g}")

    vplus_reduce_windows(mt, vp)
    vplus_sample_edges(mt, vp)

    it = vplus_allbranch(mt, 2 ** 20)
    params = it.spec.device_params()
    it.reallocate(it.run(params, block_keys(SEED, 0, 0, it.block))["sig"])
    counts, kd = it.counts.copy(), block_keys(SEED, 2, 0, it.block)
    got = it.run(params, kd)
    it.reallocate(got["sig"])
    got_counts, got_sig = it.counts.copy(), it.last_sig
    it.counts = counts.copy()
    with plain_versions(vp, "vplus_sample", "vplus_reduce"):
        want = it.run(params, kd)
    it.reallocate(want["sig"])
    moved = int(np.abs(got_counts - it.counts).sum())
    rels = [rel_err(got["obs_blocks"], want["obs_blocks"]), rel_err(got_sig, it.last_sig),
            max(rel_err(h, r) for h, r in zip(got["hists"], want["hists"]) if r.any())]
    # a count may differ where the rounding of sig tips a floor()
    if max(rels) > REL_TOL_VPLUS or moved > 4 or np.array_equal(got_counts, counts):
        raise AssertionError(f"whole :vegasplus iteration vs plain: obs/sig/hist rel {rels}, "
                             f"{moved} samples allocated otherwise")
    print(f"phase 3d: whole iteration ({it.nchunks} chunks of {it.chunk}, {it.launches_per_run} "
          f"launches): obs rel {rels[0]:.3g}, sig rel {rels[1]:.3g}, hist rel {rels[2]:.3g}, "
          f"{moved} samples allocated otherwise by the next counts")


def vplus_main_path(mt, vp, card, niter=10):
    """Phase 4d: singular_3d through integrate(solver="vegasplus") at 2^30
    evals per iteration, against its exact value; then :vegas on the same
    problem and budget, for the ratio of the error bars."""
    from mcintegration_tpu_torch.solvers.engine import Spec
    from mcintegration_tpu_torch.solvers.vegasplus import VegasPlusIteration

    var = lambda: mt.Continuous(0.0, np.pi)
    shape = VegasPlusIteration(Spec(mt.Configuration(var=var(), dof=[[3]], seed=SEED), "cuda"),
                               _sing3, block=16, nevalperblock=2 ** 26)
    expected = niter * shape.launches_per_run
    vp.reset_launch_counts()
    res = mt.integrate(_sing3, var=var(), niter=niter, **SING3_KW)
    counts = {k: vp.launch_counts[k] for k in ("vplus_sample", "vplus_reduce")}
    mean, err = float(res.mean[0]), float(res.stdev[0])
    assert res.backend == "cuda" and res.backend_reason == "", (res.backend, res.backend_reason)
    assert expected > 0 and all(n == expected for n in counts.values()), (counts, expected)
    assert sum(vp.launch_counts.values()) == sum(counts.values()), vp.launch_counts
    evals = [h[2].neval for h in res.iterations]
    steady = sum(evals[1:]) / sum(res.iteration_times[1:])
    print(f"phase 4d: singular_3d = {mean!r} +- {err!r} vs {SING3_EXACT!r} "
          f"({(mean - SING3_EXACT) / err:+.2f} sigma), chi2 {float(res.chi2[0])!r}, {niter} "
          f"iterations of {evals[0]} evals ({shape.ncubes} cubes, {shape.nchunks} chunks of "
          f"{shape.chunk} per block), launches {counts} (expected {expected} each), backend "
          f"{res.backend}")
    print(f"phase 4d: per-iteration estimates "
          f"{[(float(h[0][0]), float(h[1][0])) for h in res.iterations]}")
    print(f"phase 4d: steady-state {steady!r} evals/s (iterations 2-{niter}; per-iteration s "
          f"{res.iteration_times}) [{card}]")
    assert abs(mean - SING3_EXACT) < 5 * err, (mean, err)
    ref = mt.integrate(_sing3, var=var(), niter=niter, **{**SING3_KW, "solver": "vegas"})
    rmean, rerr = float(ref.mean[0]), float(ref.stdev[0])
    rsteady = sum(evals[1:]) / sum(ref.iteration_times[1:])
    print(f"phase 4d: :vegas on the same problem and budget: {rmean!r} +- {rerr!r} "
          f"({(rmean - SING3_EXACT) / rerr:+.2f} sigma), {rsteady!r} evals/s; error bar "
          f":vegas / :vegasplus = {rerr / err!r} [{card}]")
    return counts, shape, steady


def vplus_checks(mt):
    """Phase 5d: the published battery's other anchors, padding and a
    Discrete passenger on :vegasplus, each within 7 sigma."""
    import torch

    def logsing(x, c):
        return torch.log(x[0]) / torch.sqrt(x[0])

    def gauss4d(x, c):
        return torch.exp(-100.0 * sum((x[k] - 0.5) ** 2 for k in range(4))) * 1013.2118364296088

    def moments(x, c):
        g = torch.exp(-200.0 * sum((x[k] - 0.5) ** 2 for k in range(4))) * 1000.0
        return g, g * x[0], g * x[0] ** 2

    def passenger(x, c):
        t, d = x
        return t[0] * t[1] * d[0].to(torch.float32)

    def passenger_pad(x, c):
        t, d = x
        return t[0], t[0] * t[1] * d[0].to(torch.float32)

    i0 = 1000.0 * (np.pi / 200.0) ** 2
    cont, td = mt.Continuous(0.0, 1.0), (mt.Continuous(0.0, 1.0), mt.Discrete(1, 4))
    runs = [("pi", _pi, cont, [[2]], [np.pi / 4]),
            ("log(x)/sqrt(x)", logsing, cont, [[1]], [-4.0]),
            ("gauss4d", gauss4d, cont, [[4]], [1.0]),
            ("gauss_moments", moments, cont, [[4], [4], [4]], [i0, i0 / 2, i0 * 0.2525]),
            ("padded pair, dof=[[1],[2]]", _two, cont, [[1], [2]], [0.5, np.pi / 4]),
            ("Discrete(1, 4) passenger", passenger, td, [[2, 1]], [2.5]),
            ("Discrete(1, 4) passenger with padding", passenger_pad, td, [[1, 0], [2, 1]],
             [0.5, 2.5])]
    for name, f, var, dof, exact in runs:
        res = mt.integrate(f, var=var, dof=dof, neval=2 ** 24, niter=10, block=16,
                           solver="vegasplus", device="cuda", seed=SEED, verbose=-2)
        assert res.backend == "cuda" and res.backend_reason == "", (name, res.backend_reason)
        for i, e in enumerate(exact):
            m, s = float(res.mean[i]), float(res.stdev[i])
            print(f"phase 5d: {name}, integral {i}: {m!r} +- {s!r} vs {e!r} "
                  f"({(m - e) / s:+.2f} sigma)")
            assert abs(m - e) < 7 * s, (name, i, m, s, e)


def vplus_timings(mt, vp, shape, card):
    """Phase 6d: device time per launch of each :vegasplus kernel and of the
    integrand at the main path's launch shape, after one reallocation, the
    kernels in turns with their plain versions (plain, kernel, kernel, plain)."""
    import torch
    from mcintegration_tpu_torch.ops.rng import block_keys

    it, lay = shape, shape.layout
    params = it.spec.device_params()
    it.reallocate(it.run(params, block_keys(SEED, 0, 0, it.block))["sig"])
    tab, kd = lay.tables(params), it.seeds(block_keys(SEED, 1, 0, it.block))
    cube, cfac = it.cube_tables()
    T = it.chunks_per_launch
    err_sample, err_reduce, _ = vplus_launch_vs_plain(vp, it, tab, kd, cube, cfac, 0, T,
                                                      "phase 6d")
    x, gidx = vp.vplus_sample(lay, tab, kd, 0, T, cube)
    w = it.evaluate(lay.leaf_values(x)).contiguous()
    ms = {"sample": [], "sample_plain": [], "reduce": [], "reduce_plain": []}
    for order in (("plain", "kernel"), ("kernel", "plain")):
        for kind in order:
            sfx, timer, reps = ("", device_ms, 10) if kind == "kernel" else ("_plain", time_ms, 2)
            samp, red = getattr(vp, "vplus_sample" + sfx), getattr(vp, "vplus_reduce" + sfx)
            ms["sample" + sfx].append(timer(lambda: samp(lay, tab, kd, 0, T, cube), reps))
            ms["reduce" + sfx].append(timer(lambda: red(lay, tab, w, gidx, cube, cfac), reps))
    ms = {k: float(np.mean(v)) for k, v in ms.items()}
    ms_integrand = device_ms(lambda: it.evaluate(lay.leaf_values(x)), 5)
    n, S, N = it.block * T * it.chunk, lay.S, it.spec.N
    nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    obs, sig, hist = vp.vplus_reduce(lay, tab, w, gidx, cube, cfac)
    sample_bytes = nbytes(kd, cube, lay.meta, tab, x, gidx)
    reduce_bytes = nbytes(w, gidx, cube, cfac, tab, lay.meta, obs, sig, hist)
    # per drawn value 12 float32 operations (the uniform's convert, add and
    # multiply, y's convert, add and division, the map's six) and the
    # integer work of its uniform and of its cube's coordinate (a multiply
    # and shift, a multiply and subtract), with the sample's keyed hash
    # once per sample; 40 float32 operations per sample, slot and integrand
    # in the reduction
    b_sample = bound(sample_bytes, 12 * n * S, (UNIFORM[0] + 4) * n * S + (MIX32 + 2) * n)
    b_reduce = bound(reduce_bytes, 40 * n * (S + N))
    print(f"phase 6d: one launch = {it.block} blocks x {T} chunks x {it.chunk} samples "
          f"({n} evals, {S} slots, counts {int(it.counts.min())}..{int(it.counts.max())}); "
          f"device time per call, calls queued behind a sleep kernel [{card}]")
    print(f"phase 6d: vplus_sample {ms['sample']!r} ms/launch, plain torch "
          f"{ms['sample_plain']!r} ms (host clock) [{card}]")
    print(f"phase 6d: integrand (torch) {ms_integrand!r} ms/launch [{card}]")
    print(f"phase 6d: vplus_reduce {ms['reduce']!r} ms/launch, plain torch "
          f"{ms['reduce_plain']!r} ms (host clock) [{card}]")
    print(f"phase 6d: vplus_sample bound {b_sample[0]!r} ms ({sample_bytes} bytes, by "
          f"{b_sample[1]}); vplus_reduce bound {b_reduce[0]!r} ms ({reduce_bytes} bytes, by "
          f"{b_reduce[1]}); vplus_reduce takes {ms['reduce'] / b_reduce[0]!r} times its bound "
          f"[{card}]")
    print(f"phase 6d: peak device memory {torch.cuda.max_memory_allocated()} bytes")
    return {"vplus_sample": (err_sample, ms["sample"], ms["sample_plain"], *b_sample),
            "vplus_reduce": (err_reduce, ms["reduce"], ms["reduce_plain"], *b_reduce)}


# ---------------------------------------------------------------------------
# custom measures on :vegas and :vegasmc
# ---------------------------------------------------------------------------

NBIN = 10                                   # the quickstart's histogram
VEGAS_NEVAL, CHAIN_NEVAL, CHAIN_W = 2 ** 30, 2 ** 28, 2 ** 20   # phases 4 and 4b


def _qs_f(v, c):
    x, y = v
    return x[0] ** 2 + y[0] ** 2


def hist_measure(nbin):
    """The quickstart's histogram of x over ``nbin`` bins
    (examples/quickstart.py:75-85) in torch, written to broadcast, so that
    one call serves a whole batch: a sample in bin b adds relw[0] * nbin to
    component b."""
    def measure(v, relw, c):
        import torch
        x, _ = v
        b = torch.clamp((x[0] * nbin).to(torch.int32), 0, nbin - 1)
        bins = torch.arange(nbin, device=b.device).reshape((nbin,) + (1,) * b.ndim)
        return [(bins == b).to(relw.dtype) * relw[0] * nbin]
    return measure


def identity_measure(v, relw, c):
    return [relw[0]]


def qs_config(mt, nbin=NBIN):
    return mt.Configuration(var=(mt.Continuous(0.0, 1.0), mt.Continuous(0.0, 1.0)),
                            dof=[[1, 1]], obs=[np.zeros(nbin)], seed=SEED)


def qs_exact(nbin=NBIN):
    """Each bin's exact value, the mean of x^2 + 1/3 over [a, a+h), h = 1/nbin."""
    h = 1.0 / nbin
    a = np.arange(nbin) * h
    return a * a + a * h + h * h / 3 + 1.0 / 3


def qs_iterations(mt, nbin=NBIN):
    """The :vegas and :vegasmc iterations of phase 4e's shape, with the
    ``nbin``-bin histogram measure."""
    from mcintegration_tpu_torch.solvers.engine import Spec
    from mcintegration_tpu_torch.solvers.vegas import VegasIteration
    from mcintegration_tpu_torch.solvers.vegasmc import VegasMCIteration

    spec = Spec(qs_config(mt, nbin), "cuda")
    kw = dict(measure=hist_measure(nbin), obs_proto=spec.cfg.observable, block=16)
    vit = VegasIteration(spec, _qs_f, nevalperblock=VEGAS_NEVAL // 16, **kw)
    cit = VegasMCIteration(spec, _qs_f, nevalperblock=CHAIN_NEVAL // 16, nwalkers=CHAIN_W, **kw)
    for it in (vit, cit):
        assert it.backend_reason == "", it.backend_reason
    return vit, cit


def chain_measured_state(it):
    """(tab, rw, kd, st): the walkers of ``it`` after their start and four
    steps, then step 4's proposal."""
    from mcintegration_tpu_torch.ops import chain_kernels as ck
    from mcintegration_tpu_torch.ops.rng import block_keys

    kd = it.seeds(block_keys(SEED, 0, 0, it.block))
    tab, rw, st = it.start(it.spec.device_params(), kd)
    for t in range(4):
        it.step(tab, rw, kd, st, t)
    ck.chain_propose(it.layout, tab, kd, 4, st)
    return tab, rw, kd, st


def vegas_measured_launch(vk, it):
    """(inputs, T, x, invp, perm, w, relw): the first launch of ``it``,
    through vegas_relw."""
    from mcintegration_tpu_torch.ops.rng import block_keys

    inputs = it.kernel_inputs(it.spec.device_params(), block_keys(SEED, 0, 0, it.block))
    T = it.chunks_per_launch
    x, invp, perm = vk.vegas_sample(t0=0, T=T, m=it.m_tile, **inputs)
    w = it.evaluate(it.leaf_values(x)).contiguous()
    relw = vk.vegas_relw(w, invp, it.pad, it.pair_slots)
    return inputs, T, x, invp, perm, w, relw


def measure_vs_plain(mt, vk, ck, card):
    """Phase 3e: the custom-measure kernels against their plain versions from
    one state, at the main paths' shapes: chain_accept's relw output and
    chain_measure at 2^20 walkers with 10 and 64 components, bit for bit;
    vegas_relw (bit for bit) at one launch of phase 4's shape with 10
    components, and vegas_reduce given m (REL_TOL_REDUCE) there and at the
    launch of phase 4e's shape with 64 components; then the identity
    measure [relw[0]] against the default measure, bit for bit, in one
    launch of vegas_reduce and over one run of each solver from the same
    params and kd."""
    import torch
    from mcintegration_tpu_torch.ops.rng import block_keys
    from mcintegration_tpu_torch.solvers.engine import Spec
    from mcintegration_tpu_torch.solvers.vegas import VegasIteration
    from mcintegration_tpu_torch.solvers.vegasmc import VegasMCIteration

    errs = {"chain_accept_relw": 0.0, "chain_measure": 0.0}
    for nbin in (NBIN, 64):
        _, it = qs_iterations(mt, nbin)
        lay = it.layout
        tab, rw, kd, st = chain_measured_state(it)
        ref = st.clone()
        nw = it.weights(st)
        ck.chain_accept(lay, rw, kd, 4, st, nw, measure=True)
        ck.chain_accept_plain(lay, rw, kd, 4, ref, nw, measure=True)
        torch.cuda.synchronize()
        e = state_bits_equal(st, ref, f"chain_accept with relw, {nbin} components")
        errs["chain_accept_relw"] = max(errs["chain_accept_relw"], e)
        m = it.measure(it.leaf_values(st.cur_val), st.relw).contiguous()
        ck.chain_measure(lay, m, st)
        ck.chain_measure_plain(lay, m, ref)
        torch.cuda.synchronize()
        if not torch_equal_bits(st.obs, ref.obs):
            raise AssertionError(f"chain_measure, {nbin} components: obs differs from "
                                 "the plain version")
        errs["chain_measure"] = max(errs["chain_measure"], float((st.obs - ref.obs).abs().max()))
        print(f"phase 3e: one measured step at W={lay.W}, {nbin} components: chain_accept "
              f"(relw written) and chain_measure bit-equal to their plain versions, relw in "
              f"[{float(st.relw.min())!r}, {float(st.relw.max())!r}], hist max abs err {e!r}")
        del st, ref, m

    errs["vegas_reduce_measure"] = 0.0
    for nbin in (NBIN, 64):
        it, _ = qs_iterations(mt, nbin)
        masks = (it.pad, it.pair_slots, it.used)
        _, T, x, invp, perm, w, relw = vegas_measured_launch(vk, it)
        if nbin == NBIN:
            relw_p = vk.vegas_relw_plain(w, invp, it.pad, it.pair_slots)
            torch.cuda.synchronize()
            if not torch.equal(bits(relw), bits(relw_p)):
                raise AssertionError("vegas_relw differs from the plain version")
            errs["vegas_relw"] = float((relw - relw_p).abs().max())
            del relw_p
        m = it.measure(it.leaf_values(x), relw).contiguous()
        obs, hrow = vk.vegas_reduce(w, invp, perm, *masks, m)
        obs_p, hrow_p = vk.vegas_reduce_plain(w, invp, perm, *masks, m)
        rel = max(rel_err(obs.cpu(), obs_p.cpu()), rel_err(hrow.cpu(), hrow_p.cpu()))
        if rel > REL_TOL_REDUCE:
            raise AssertionError(f"vegas_reduce given m, {nbin} components, vs plain: rel "
                                 f"{rel:.3g} > {REL_TOL_REDUCE}")
        errs["vegas_reduce_measure"] = max(errs["vegas_reduce_measure"], float(max(
            (obs - obs_p).abs().max(), (hrow - hrow_p).abs().max())))
        del m, obs_p, hrow_p
        obs_i, hrow_i = vk.vegas_reduce(w, invp, perm, *masks, relw[:1].contiguous())
        obs_d, hrow_d = vk.vegas_reduce(w, invp, perm, *masks)
        if not (torch_equal_bits(obs_i, obs_d) and torch_equal_bits(hrow_i, hrow_d)):
            raise AssertionError("vegas_reduce given m = relw[:1] differs from the default sums")
        print(f"phase 3e: one launch of {it.block} blocks x {T} chunks x {it.chunk} samples, "
              f"{nbin} components: {'vegas_relw bit-equal, ' if nbin == NBIN else ''}"
              f"vegas_reduce given m rel {rel:.3g}; given m = relw[:1], bit-equal to the "
              f"default sums")
        del x, invp, perm, w, relw

    pi_spec = Spec(mt.Configuration(var=mt.Continuous(0.0, 1.0), dof=[[2]], seed=SEED), "cuda")
    params = pi_spec.device_params()
    kd = block_keys(SEED, 2, 0, 16)
    for cls, kw in ((VegasIteration, dict(nevalperblock=VEGAS_NEVAL // 16)),
                    (VegasMCIteration, dict(nevalperblock=CHAIN_NEVAL // 16, nwalkers=CHAIN_W))):
        a = cls(pi_spec, _pi, block=16, **kw).run(params, kd)
        b = cls(pi_spec, _pi, measure=identity_measure, obs_proto=pi_spec.cfg.observable,
                block=16, **kw).run(params, kd)
        if not np.array_equal(a["obs_blocks"][:, 0], b["obs_blocks"][0]):
            raise AssertionError(f"{cls.__name__}: the identity measure's obs differ from the "
                                 "default measure's")
        same = [k for k in a if k not in ("obs_blocks", "hists", "neval")]
        for k in same:
            assert np.array_equal(a[k], b[k]), (cls.__name__, k)
        e_hist = max(rel_err(h, r) for h, r in zip(a["hists"], b["hists"]))
        assert e_hist <= REL_TOL_HIST, (cls.__name__, e_hist)
        print(f"phase 3e: {cls.__name__}, one run of {a['neval']} evals on pi: the identity "
              f"measure's obs bit-equal to the default measure's, {same} equal, hist rel "
              f"{e_hist:.3g}")
    return errs


def measure_main_path(mt, vk, ck, card, rates):
    """Phase 4e: the quickstart's 10-bin histogram through integrate() on
    :vegas at phase 4's size and on :vegasmc at phase 4b's, every bin within
    7 sigma of its exact value; the launches of each path's kernels, and its
    steady-state rate beside phases 4 and 4b."""
    vit, cit = qs_iterations(mt)
    niter = 10
    n_measured = sum(1 for t in range(cit.nsteps) if t >= cit.warmup)
    runs = (("vegas", dict(neval=VEGAS_NEVAL), vk,
             {**dict.fromkeys(vk.launch_counts, 0), "vegas_sample": niter * vit.launches_per_run,
              "vegas_relw": niter * vit.launches_per_run,
              "vegas_reduce_measure": niter * vit.launches_per_run}, rates["4"]),
            ("vegasmc", dict(neval=CHAIN_NEVAL, nwalkers=CHAIN_W), ck,
             {"chain_propose": niter * (cit.nsteps + 1), "chain_accept": niter * (cit.nsteps + 1),
              "chain_measure": niter * n_measured, "chain_accept_complex": 0}, rates["4b"]))
    exact = qs_exact()
    counts = {}
    for solver, kw, mod, expected, rate0 in runs:
        mod.reset_launch_counts()
        res = mt.integrate(_qs_f, config=qs_config(mt), measure=hist_measure(NBIN),
                           solver=solver, niter=niter, block=16, device="cuda", verbose=-2, **kw)
        got = dict(mod.launch_counts)
        assert res.backend == "cuda" and res.backend_reason == "", res.backend_reason
        assert got == expected, (solver, got, expected)
        mean, std = np.asarray(res.mean[0]), np.asarray(res.stdev[0])
        z = (mean - exact) / std
        assert mean.shape == (NBIN,) and np.all(np.isfinite(mean)) and np.all(std > 0)
        assert np.all(np.abs(z) < 7), (solver, z.tolist())
        evals = [h[2].neval for h in res.iterations]
        steady = sum(evals[1:]) / sum(res.iteration_times[1:])
        print(f"phase 4e: {solver}, {NBIN}-bin histogram, {niter} iterations of {evals[0]} "
              f"evals: bins {mean.tolist()} +- {std.tolist()}, sigma {np.round(z, 2).tolist()}; "
              f"launches {got}")
        print(f"phase 4e: {solver} steady-state {steady!r} evals/s with the measure, "
              f"{rate0!r} without (phase {'4' if solver == 'vegas' else '4b'}), ratio "
              f"{steady / rate0!r} (per-iteration s {res.iteration_times}) [{card}]")
        counts.update({k: v for k, v in got.items() if k in ("vegas_relw", "vegas_reduce_measure",
                                                             "chain_measure")})
    return counts


def measure_timings(mt, vk, ck, card):
    """Phase 6e: device ms of the custom-measure kernels at phase 4e's
    shapes, in turns with their plain versions, beside their bounds from the
    bytes each must move; the measure's torch ops; peak device memory of a
    :vegas launch with 10 and with 64 components."""
    import torch

    vit, cit = qs_iterations(mt)
    masks = (vit.pad, vit.pair_slots, vit.used)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, T, x, invp, perm, w, relw = vegas_measured_launch(vk, vit)
    vals = vit.leaf_values(x)
    m = vit.measure(vals, relw).contiguous()
    obs, hrow = vk.vegas_reduce(w, invp, perm, *masks, m)
    torch.cuda.synchronize()
    peak10 = torch.cuda.max_memory_allocated()
    vms = {k: [] for k in ("relw", "relw_plain", "reduce_m", "reduce_m_plain")}
    for order in (("plain", "kernel"), ("kernel", "plain")):
        for kind in order:
            if kind == "kernel":
                vms["relw"].append(device_ms(
                    lambda: vk.vegas_relw(w, invp, vit.pad, vit.pair_slots), 10))
                vms["reduce_m"].append(device_ms(
                    lambda: vk.vegas_reduce(w, invp, perm, *masks, m), 10))
            else:
                vms["relw_plain"].append(time_ms(
                    lambda: vk.vegas_relw_plain(w, invp, vit.pad, vit.pair_slots), 3))
                vms["reduce_m_plain"].append(time_ms(
                    lambda: vk.vegas_reduce_plain(w, invp, perm, *masks, m), 3))
    vms = {k: float(np.mean(v)) for k, v in vms.items()}
    ms_measure = time_ms(lambda: vit.measure(vals, relw), 10)
    n, N, ncomp, nslots = w[0].numel(), w.shape[0], m.shape[0], invp.shape[0]
    R = invp[0].numel()
    nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    relw_bytes = nbytes(w, invp, vit.pad, vit.pair_slots, relw)
    reduce_bytes = nbytes(w, invp, perm, *masks, m, hrow) + 8 * R * ncomp   # obs per row
    b_relw = bound(relw_bytes, n * N)
    b_reduce = bound(reduce_bytes, 8 * n * (N + nslots) + 2 * n * ncomp)
    print(f"phase 6e: one :vegas launch = {vit.block} blocks x {T} chunks x {vit.chunk} "
          f"samples ({n} evals), {ncomp} components; kernels' device time per call, calls "
          f"queued behind a sleep kernel [{card}]")
    print(f"phase 6e: vegas_relw {vms['relw']!r} ms/launch, plain torch "
          f"{vms['relw_plain']!r} ms, bound {b_relw[0]!r} ms ({relw_bytes} bytes, "
          f"by {b_relw[1]}) [{card}]")
    print(f"phase 6e: measure (torch) {ms_measure!r} ms/launch [{card}]")
    print(f"phase 6e: vegas_reduce given m {vms['reduce_m']!r} ms/launch, plain "
          f"torch {vms['reduce_m_plain']!r} ms, bound {b_reduce[0]!r} ms "
          f"({reduce_bytes} bytes, by {b_reduce[1]}) [{card}]")
    del x, invp, perm, w, relw, vals, m, obs, hrow
    from mcintegration_tpu_torch.solvers.vegas import MEASURE_LAUNCH_BYTES

    vit64, _ = qs_iterations(mt, 64)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    inputs = vit64.kernel_inputs(vit64.spec.device_params(), np.zeros((16, 2), np.uint32))
    vit64.launch(inputs, 0, vit64.chunks_per_launch)
    torch.cuda.synchronize()
    peak64 = torch.cuda.max_memory_allocated()
    print(f"phase 6e: peak device memory of a launch: {peak10} bytes with {NBIN} components "
          f"({vit.chunks_per_launch} chunks of {vit.chunk} a block), {peak64} bytes with 64 "
          f"({vit64.chunks_per_launch} chunk of {vit64.chunk} a block: x, w, relw and m "
          f"within {MEASURE_LAUNCH_BYTES} bytes) [{card}]")
    del vit64, inputs

    lay = cit.layout
    tab, rw, kd, st = chain_measured_state(cit)
    nw = cit.weights(st)
    ck.chain_accept(lay, rw, kd, 4, st, nw, measure=True)
    cvals = cit.leaf_values(st.cur_val)
    m = cit.measure(cvals, st.relw).contiguous()
    cms = {k: [] for k in ("accept", "accept_plain", "measure", "measure_plain")}
    for order in (("plain", "kernel"), ("kernel", "plain")):
        for kind in order:
            sfx = "" if kind == "kernel" else "_plain"
            reps = 20 if kind == "kernel" else 5
            acc = getattr(ck, "chain_accept" + sfx)
            meas = getattr(ck, "chain_measure" + sfx)
            cms["accept" + sfx].append(
                device_ms(lambda: acc(lay, rw, kd, 5, st, nw, measure=True), reps))
            cms["measure" + sfx].append(device_ms(lambda: meas(lay, m, st), reps))
    cms = {k: float(np.mean(v)) for k, v in cms.items()}
    ms_fn = device_ms(lambda: cit.measure(cvals, st.relw), 20)
    S, N, nd, W, ncomp = lay.S, lay.spec.N, lay.spec.N + 1, lay.W, lay.ncomp
    # phase 6b's bytes of a measured chain_accept, with relw written (4 bytes
    # per integrand) in place of the float64 obs read and written (16)
    b_acc = bound(W * (4 * S + 4 * N + 16 + 36 + 16 + 8 * S + 4 * N + 4 * nd
                       + 4 * N + 16 * nd + 16), ACCEPT_OPS[1] * W, ACCEPT_OPS[0] * W)
    b_meas = bound(20 * ncomp * W, 2 * ncomp * W)
    print(f"phase 6e: one :vegasmc step = {W} walkers, {ncomp} components; device time per "
          f"call, calls queued behind a sleep kernel [{card}]")
    print(f"phase 6e: chain_accept writing relw {cms['accept']!r} ms/measured step, plain "
          f"torch {cms['accept_plain']!r} ms, bound {b_acc[0]!r} ms (by {b_acc[1]}), "
          f"{cms['accept'] / b_acc[0]!r} times its bound [{card}]")
    print(f"phase 6e: measure (torch) {ms_fn!r} ms/measured step [{card}]")
    print(f"phase 6e: chain_measure {cms['measure']!r} ms/measured step, plain torch "
          f"{cms['measure_plain']!r} ms, bound {b_meas[0]!r} ms ({20 * ncomp * W} bytes, by "
          f"{b_meas[1]}) [{card}]")
    # (ms, plain_ms, bound_ms, bound_by) of each kernel in the kernels line
    return {"vegas_relw": (vms["relw"], vms["relw_plain"], *b_relw),
            "vegas_reduce_measure": (vms["reduce_m"], vms["reduce_m_plain"], *b_reduce),
            "chain_measure": (cms["measure"], cms["measure_plain"], *b_meas)}


# ---------------------------------------------------------------------------
# complex weights (type=complex) on :vegasmc and :mcmc
# ---------------------------------------------------------------------------

PHASE_EXACT = np.sin(1.0) + 1j * (1.0 - np.cos(1.0))     # int_0^1 e^{it} dt
CPLX_EXACT = PHASE_EXACT ** 2                            # e^{i(x+y)} over [0, 1)^2
QBIN = 3                                                 # the complex one-hot measure's bins
MCMC_NEVAL, MCMC_W = 2 ** 28, 2 ** 18                    # phase 4c's measured evals, walkers


def _cexp(x, c):
    import torch
    return torch.exp(1j * (x[0] + x[1]))


def _cexp_idx(i, x, c):
    return _cexp(x, c)


def _phase_t(x, c):
    import torch
    return torch.exp(1j * x[0][0])


def _phase_t_idx(i, x, c):
    return _phase_t(x, c)


def _onehot_chain(v, relw, c):
    """The complex one-hot measure of benchmarks/report.py:356-383: relw
    into the bin of the Discrete(1, 3) value."""
    from mcintegration_tpu_torch import onehot
    return [onehot(v[1][0], 1, QBIN, relw.dtype) * relw[0]]


def _onehot_mcmc(i, x, w, c):
    from mcintegration_tpu_torch import onehot
    return [onehot(x[1][0], 1, QBIN, w.dtype) * w]


def _chain_two_complex(x, c):
    """Phase 3b's two integrands times a phase each."""
    import torch
    a, _ = x
    w0, w1 = _chain_two(x, c)
    return w0 * torch.exp(3j * a[0]), w1 * torch.exp(-2j * a[1])


def _qdisc(x, c):
    """The quarter disc times e^{i(x+y)} (tests/test_pallas.py:385-420)."""
    return _pi(x, c) * _cexp(x, c)


def onehot_config(mt):
    return mt.Configuration(var=(mt.Continuous(0.0, 1.0), mt.Discrete(1, QBIN)),
                            dof=[[1, 1]], obs=[np.zeros(QBIN, np.complex64)], type=complex,
                            seed=SEED)


def make_bubble_matsubara(device):
    """The bubble at the first bosonic Matsubara frequency: its integrand
    times e^{i 2 pi tau / beta}, complex."""
    import torch
    bubble = make_bubble(device)

    def f(idx, vars, c):
        return bubble(idx, vars, c) * torch.exp((2j * np.pi / BETA_PHYS) * vars[0][0])

    return f


def complex_vs_plain(mt, ck, mk, card):
    """Phase 3f: the complex kernels against their plain versions from one
    state, bit for bit (the chain histogram to REL_TOL_HIST):
    chain_accept_complex at 2^20 walkers on phase 3b's spec with a phase
    (measured and unmeasured) and with the complex one-hot measure (with
    chain_measure); mcmc_accept_complex at phase 3c's 2^20 walkers on its
    spec with a phase, measured and unmeasured with the default measure and
    measured with a complex custom one.  Then f + 0j against f over a run of
    each solver from the same seeds: obs real parts, norm, visited, tallies
    and histograms equal (:vegasmc obs bit for bit, hist to REL_TOL_HIST;
    :mcmc obs to rel 1e-6, everything else bit for bit) and imaginary parts
    0.  Returns the max abs error of each complex kernel."""
    import torch
    from mcintegration_tpu_torch.ops.rng import block_keys
    from mcintegration_tpu_torch.solvers.engine import Spec
    from mcintegration_tpu_torch.solvers.vegasmc import VegasMCIteration

    errs = {"chain_accept_complex": 0.0, "mcmc_accept_complex": 0.0}
    W = 2 ** 20
    it = VegasMCIteration(Spec(chain_config(mt, type=complex), "cuda"), _chain_two_complex,
                          block=16, nevalperblock=2 ** 24, nwalkers=W)
    ospec = Spec(onehot_config(mt), "cuda")
    oit = VegasMCIteration(ospec, _phase_t, measure=_onehot_chain, obs_proto=ospec.cfg.observable,
                           block=16, nevalperblock=2 ** 24, nwalkers=W)
    for what, cit, measure in (("phase 3b's spec with a phase, measured", it, True),
                               ("phase 3b's spec with a phase, unmeasured", it, False),
                               (f"{QBIN}-bin complex one-hot measure", oit, True)):
        lay = cit.layout
        assert lay.spec.cplx and cit.backend_reason == "", cit.backend_reason
        tab, rw, kd, st = chain_measured_state(cit)
        ref = st.clone()
        nw = cit.weights(st)
        assert nw.dtype == torch.complex64
        n0 = dict(ck.launch_counts)
        ck.chain_accept(lay, rw, kd, 4, st, nw, measure=measure)
        ck.chain_accept_plain(lay, rw, kd, 4, ref, nw, measure=measure)
        torch.cuda.synchronize()
        assert ck.launch_counts["chain_accept_complex"] == n0["chain_accept_complex"] + 1
        assert ck.launch_counts["chain_accept"] == n0["chain_accept"]
        e = state_bits_equal(st, ref, f"chain_accept_complex, {what}")
        errs["chain_accept_complex"] = max(errs["chain_accept_complex"], e)
        extra = ""
        if measure and cit.measure is not None:
            m = cit.measure(cit.leaf_values(st.cur_val), st.relw).contiguous()
            ck.chain_measure(lay, m, st)
            ck.chain_measure_plain(lay, m, ref)
            torch.cuda.synchronize()
            if not torch_equal_bits(st.obs, ref.obs):
                raise AssertionError(f"chain_measure after chain_accept_complex, {what}: obs "
                                     "differs from the plain version")
            extra = f"; relw complex64 |relw| <= {float(st.relw.abs().max())!r}, chain_measure too"
        print(f"phase 3f: chain_accept_complex, one step at W={lay.W}, {what} ({lay.ncomp} "
              f"components): every field bit-equal to the plain version, hist max abs err "
              f"{e!r}{extra}")
        del st, ref, nw

    for what, custom, measure in (("default measure, measured", False, True),
                                  ("default measure, unmeasured", False, False),
                                  ("complex custom measure, measured", True, True)):
        mit = mcmc_allbranch(mt, W, cplx=True, custom=custom)
        lay = mit.layout
        assert lay.spec.cplx and mit.backend_reason == "", mit.backend_reason
        kd_np = block_keys(SEED, 0, 0, mit.block)
        sched, groups = mit.schedule(kd_np)
        kd = mit.seeds(kd_np)
        tab, rw, st = mit.start(mit.spec.device_params(), kd, sched)
        for t in range(5):
            mit.step(tab, rw, kd, sched, groups[t], st, t)
        n0 = dict(mk.launch_counts)
        e = mcmc_one_step(mit, mk, st, tab, rw, kd, sched, groups[5], 5,
                          f"(phase 3f, {what})", measure=measure)
        assert mk.launch_counts["mcmc_accept_complex"] == n0["mcmc_accept_complex"] + 1
        assert mk.launch_counts["mcmc_accept"] == n0["mcmc_accept"]
        errs["mcmc_accept_complex"] = max(errs["mcmc_accept_complex"], e[1])
        roles = np.bincount(st.move[0].cpu().numpy(), minlength=5).tolist()
        print(f"phase 3f: mcmc_accept_complex, one step at W={lay.W} on phase 3c's spec with a "
              f"phase, {what} ({lay.ncomp} components): every field bit-equal to the plain "
              f"version; roles none/CV/swap/CI/NJ {roles}")
        del mit, st

    # f + 0j against f over one run of each solver, from the same seeds
    kd = block_keys(SEED, 3, 0, 16)
    spec_r, spec_c = Spec(chain_config(mt), "cuda"), Spec(chain_config(mt, type=complex), "cuda")
    kw = dict(block=16, nevalperblock=2 ** 20, nwalkers=2 ** 18)
    a = VegasMCIteration(spec_r, _chain_two, **kw).run(spec_r.device_params(), kd)
    b = VegasMCIteration(spec_c, lambda x, c: tuple(w + 0j for w in _chain_two(x, c)),
                         **kw).run(spec_c.device_params(), kd)
    if not (np.array_equal(b["obs_blocks"].real, a["obs_blocks"])
            and np.all(b["obs_blocks"].imag == 0.0)):
        raise AssertionError(":vegasmc f + 0j: obs differ from the real run's")
    for k in ("norm_blocks", "visited", "propose", "accept"):
        if not np.array_equal(a[k], b[k]):
            raise AssertionError(f":vegasmc f + 0j: {k} differs from the real run's")
    e_hist = max(rel_err(h, r) for h, r in zip(b["hists"], a["hists"]))
    if e_hist > REL_TOL_HIST:
        raise AssertionError(f":vegasmc f + 0j: hist rel {e_hist:.3g} > {REL_TOL_HIST}")
    print(f"phase 3f: :vegasmc f + 0j, one run of {a['neval']} evals (phase 3b's spec): obs "
          f"real parts, norm, visited and tallies bit-equal to the real run, imaginary parts 0, "
          f"hist rel {e_hist:.3g}")
    runs = []
    for cplx in (False, True):
        mit = mcmc_allbranch(mt, 2 ** 18, cplx=cplx, phase=False, custom=False)
        runs.append(mit.run(mit.spec.device_params(), kd))
    a, b = runs
    rel = rel_err(b["obs_blocks"].real, a["obs_blocks"])
    if not (rel <= 1e-6 and np.all(b["obs_blocks"].imag == 0.0)):
        raise AssertionError(f":mcmc f + 0j: obs rel {rel:.3g} > 1e-6 from the real run's")
    for k in ("norm_blocks", "visited", "propose", "accept"):
        if not np.array_equal(a[k], b[k]):
            raise AssertionError(f":mcmc f + 0j: {k} differs from the real run's")
    if not all(np.array_equal(h, r) for h, r in zip(a["hists"], b["hists"])):
        raise AssertionError(":mcmc f + 0j: hists differ from the real run's")
    print(f"phase 3f: :mcmc f + 0j, one run of {a['neval']} evals (phase 3c's spec, default "
          f"measure): norm, visited, tallies and histograms bit-equal to the real run, obs real "
          f"parts rel {rel:.3g}, imaginary parts 0")
    return errs


def complex_main_path(mt, ck, mk, card, rates):
    """Phase 4f: complex weights through integrate(type=complex,
    device="cuda"), the complex job of benchmarks/report.py:330-383:
    e^{i(x+y)} on [0, 1)^2 and the complex one-hot measure over
    Discrete(1, 3), each on :vegasmc at phase 4b's size and on :mcmc at
    phase 4c's, 16 blocks, 10 iterations, the reference's defaults; the real
    and imaginary part of every mean within 7 sigma of its exact value; the
    launches of the complex kernels; the rates beside phases 4b and 4c."""
    from mcintegration_tpu_torch.ops.mcmc_kernels import NRETRY
    niter = 10
    csteps = CHAIN_NEVAL // CHAIN_W
    n_measured = sum(1 for t in range(csteps) if t >= int(csteps * 0.01))
    msteps = MCMC_NEVAL // MCMC_W
    nburnin = int(msteps * 0.1)
    mstep_all = msteps + nburnin + NRETRY + 1
    cexp = dict(var=mt.Continuous(0.0, 1.0), dof=[[2]])
    oh = dict(var=(mt.Continuous(0.0, 1.0), mt.Discrete(1, QBIN)), dof=[[1, 1]],
              obs=[np.zeros(QBIN, np.complex64)])
    runs = (("vegasmc", "e^{i(x+y)}", _cexp, None, cexp, CPLX_EXACT,
             dict(neval=CHAIN_NEVAL, nwalkers=CHAIN_W), ck, "chain_accept_complex",
             {"chain_propose": niter * (csteps + 1), "chain_accept": 0, "chain_measure": 0,
              "chain_accept_complex": niter * (csteps + 1)}, rates["4b"], "4b"),
            ("vegasmc", f"{QBIN}-bin one-hot", _phase_t, _onehot_chain, oh,
             np.full(QBIN, PHASE_EXACT), dict(neval=CHAIN_NEVAL, nwalkers=CHAIN_W), ck, None,
             {"chain_propose": niter * (csteps + 1), "chain_accept": 0,
              "chain_measure": niter * n_measured, "chain_accept_complex": niter * (csteps + 1)},
             rates["4b"], "4b"),
            ("mcmc", "e^{i(x+y)}", _cexp_idx, None, cexp, CPLX_EXACT,
             dict(neval=MCMC_NEVAL, nwalkers=MCMC_W), mk, "mcmc_accept_complex",
             {"mcmc_propose": niter * mstep_all, "mcmc_accept": 0, "mcmc_measure": 0,
              "mcmc_accept_complex": niter * mstep_all}, rates["4c"], "4c"),
            ("mcmc", f"{QBIN}-bin one-hot", _phase_t_idx, _onehot_mcmc, oh,
             np.full(QBIN, PHASE_EXACT), dict(neval=MCMC_NEVAL, nwalkers=MCMC_W), mk, None,
             {"mcmc_propose": niter * mstep_all, "mcmc_accept": 0, "mcmc_measure": niter * msteps,
              "mcmc_accept_complex": niter * mstep_all}, rates["4c"], "4c"))
    counts, bad = {}, []
    for solver, name, f, meas, var_kw, exact, kw, mod, key, expected, rate0, ph in runs:
        mod.reset_launch_counts()
        res = mt.integrate(f, measure=meas, type=complex, solver=solver, niter=niter, block=16,
                           device="cuda", seed=SEED, verbose=-2, **var_kw, **kw)
        got = dict(mod.launch_counts)
        assert res.backend == "cuda" and res.backend_reason == "", res.backend_reason
        assert got == expected, (solver, name, got, expected)
        if key:
            counts[key] = got[key]
        mean, std = np.asarray(res.mean[0]), np.asarray(res.stdev[0])
        assert np.iscomplexobj(mean) and mean.shape == np.shape(exact), (mean, exact)
        assert np.all(np.isfinite(mean)) and np.all(std.real > 0) and np.all(std.imag > 0)
        z = (mean.real - exact.real) / std.real + 1j * (mean.imag - exact.imag) / std.imag
        if not (np.all(np.abs(z.real) < 7) and np.all(np.abs(z.imag) < 7)):
            bad.append((solver, name, z.tolist()))
        evals = [h[2].neval for h in res.iterations]
        steady = sum(evals[1:]) / sum(res.iteration_times[1:])
        print(f"phase 4f: {solver}, {name}, {niter} iterations of {evals[0]} evals: "
              f"{mean.tolist()} +- {std.tolist()} vs {np.asarray(exact).tolist()}, sigma "
              f"(re, im) {[(round(v.real, 2), round(v.imag, 2)) for v in np.ravel(z)]}; "
              f"launches {got}")
        print(f"phase 4f: {solver}, {name}: steady-state {steady!r} evals/s, {rate0!r} for the "
              f"real main path (phase {ph}), ratio {steady / rate0!r} (per-iteration s "
              f"{res.iteration_times}) [{card}]")
    assert not bad, f"complex means outside 7 sigma: {bad}"
    return counts


def complex_cost(mt, card):
    """Phase 4f: what complex weights cost a Markov run.  The quarter disc
    f against f + 0j through integrate, on :vegasmc at phase 4b's evals
    and walkers and on :mcmc at phase 4c's (the default burn-in), in turns
    f, f + 0j, f + 0j, f; returns the ratio of the mean steady-state rates
    (iterations 2-5), complex over real, of each solver."""
    niter = 5

    def cplx(x, c):
        return _pi(x, c) + 0j

    cases = (("vegasmc", dict(neval=CHAIN_NEVAL, nwalkers=CHAIN_W), _pi, cplx),
             ("mcmc", dict(neval=MCMC_NEVAL, nwalkers=MCMC_W),
              lambda i, x, c: _pi(x, c), lambda i, x, c: cplx(x, c)))
    ratios = {}
    for solver, kw, f, g in cases:
        rates = {float: [], complex: []}
        for typ in (float, complex, complex, float):
            res = mt.integrate(f if typ is float else g, var=mt.Continuous(0.0, 1.0),
                               dof=[[2]], type=typ, solver=solver, niter=niter, block=16,
                               device="cuda", seed=SEED, verbose=-2, **kw)
            mean, std = complex(res.mean[0]), complex(res.stdev[0])
            assert res.backend == "cuda" and res.backend_reason == "", res.backend_reason
            assert abs(mean.real - np.pi / 4) < 7 * std.real and mean.imag == 0.0, (mean, std)
            evals = [h[2].neval for h in res.iterations]
            rates[typ].append(sum(evals[1:]) / sum(res.iteration_times[1:]))
        ratios[solver] = float(np.mean(rates[complex]) / np.mean(rates[float]))
        print(f"phase 4f: {solver}, quarter disc f against f + 0j at {kw}, {niter} iterations "
              f"each, in turns f, f + 0j, f + 0j, f: steady-state evals/s real "
              f"{rates[float]}, complex {rates[complex]}, complex/real {ratios[solver]!r} "
              f"[{card}]")
    return ratios


def complex_timings(mt, ck, mk, card):
    """Phase 6f: device ms of chain_accept_complex at phase 6b's shape (2^20
    walkers, the quarter disc times e^{i(x+y)}, a measured step) and of
    mcmc_accept_complex at phase 6c's (the bubble at the first bosonic
    Matsubara frequency, 2^18 walkers, measured and unmeasured steps), each
    in turns with its plain version; their bounds with 8-byte weights."""
    import torch
    from mcintegration_tpu_torch.ops.mcmc_kernels import NRETRY
    from mcintegration_tpu_torch.ops.rng import block_keys
    from mcintegration_tpu_torch.solvers.engine import Spec
    from mcintegration_tpu_torch.solvers.mcmc import MCMCIteration
    from mcintegration_tpu_torch.solvers.vegasmc import VegasMCIteration

    spec = Spec(mt.Configuration(var=mt.Continuous(0.0, 1.0), dof=[[2]], seed=SEED,
                                 type=complex), "cuda")
    it = VegasMCIteration(spec, _qdisc, block=16, nevalperblock=2 ** 24, nwalkers=2 ** 20)
    lay = it.layout
    tab, rw, kd, st = chain_measured_state(it)
    nw = it.weights(st)
    ref = st.clone()
    ck.chain_accept(lay, rw, kd, 4, st, nw, measure=True)
    ck.chain_accept_plain(lay, rw, kd, 4, ref, nw, measure=True)
    err_c = state_bits_equal(st, ref, "chain_accept_complex at phase 6b's shape")
    del ref
    ms = {"accept": [], "accept_plain": []}
    for order in (("plain", "kernel"), ("kernel", "plain")):
        for kind in order:
            sfx = "" if kind == "kernel" else "_plain"
            acc = getattr(ck, "chain_accept" + sfx)
            ms["accept" + sfx].append(device_ms(
                lambda: acc(lay, rw, kd, 5, st, nw, measure=True), 20 if not sfx else 5))
    ms = {k: float(np.mean(v)) for k, v in ms.items()}
    # phase 6b's bytes with 8-byte weights: nw read and w written 8 bytes per
    # integrand, and the float64 obs of two components (re, im) each
    S, n, nd = lay.S, lay.spec.N, lay.spec.N + 1
    b_c = bound(lay.W * (4 * S + 8 * n + 16 + 36 + 16 + 8 * S + 8 * n + 4 * nd
                         + 32 * n + 16 * nd + 16), (ACCEPT_OPS[1] + 10 * n) * lay.W,
                ACCEPT_OPS[0] * lay.W)
    print(f"phase 6f: one :vegasmc step = {lay.W} walkers x {S} slots, complex weights: "
          f"chain_accept_complex {ms['accept']!r} ms/measured step, plain torch "
          f"{ms['accept_plain']!r} ms, bound {b_c[0]!r} ms (by {b_c[1]}), "
          f"{ms['accept'] / b_c[0]!r} times its bound [{card}]")
    del st, nw

    kw = bubble_kw(mt)
    obs = [np.zeros(QSIZE, np.complex64)]
    cfg = mt.Configuration(var=kw["var"], dof=kw["dof"], obs=obs, seed=SEED, type=complex)
    mit = MCMCIteration(Spec(cfg, "cuda"), make_bubble_matsubara("cuda"), measure=_bubble_measure,
                        obs_proto=obs, block=16, nevalperblock=2 ** 28 // 16, nwalkers=2 ** 18,
                        thermal_ratio=BUBBLE_THERMAL)
    lay = mit.layout
    assert lay.spec.cplx and mit.backend_reason == "", mit.backend_reason
    kd_np = block_keys(SEED, 0, 0, mit.block)
    sched, groups = mit.schedule(kd_np)
    kd = mit.seeds(kd_np)
    tab, rw, st = mit.start(mit.spec.device_params(), kd, sched)
    for t in range(400):
        mit.step(tab, rw, kd, sched, groups[t], st, t)
    errs = mcmc_one_step(mit, mk, st, tab, rw, kd, sched, groups[400], 400,
                         "complex, at the main path's shape")
    errs_u = mcmc_one_step(mit, mk, st, tab, rw, kd, sched, groups[401], 401,
                           "complex, at the main path's shape, unmeasured", measure=False)
    T = 402
    nw = mit.weights(st, groups[T])
    mk.mcmc_propose(lay, tab, kd, sched, T, st)
    after = st.clone()
    mk.mcmc_accept(lay, tab, rw, kd, sched, T, after, nw, measure=True)
    nbytes = mcmc_bytes(mit, st, after)
    ops = mcmc_ops(mit, mk, kd, sched, T, st, after)
    del after
    mm = {k: [] for k in ("accept", "accept_u", "accept_plain", "accept_u_plain")}
    for order in (("plain", "kernel"), ("kernel", "plain")):
        for kind in order:
            sfx, timer, reps = ("", device_ms, 20) if kind == "kernel" else ("_plain", time_ms, 5)
            acc = getattr(mk, "mcmc_accept" + sfx)
            mm["accept" + sfx].append(timer(
                lambda: acc(lay, tab, rw, kd, sched, T, st, nw, measure=True), reps))
            mm["accept_u" + sfx].append(timer(
                lambda: acc(lay, tab, rw, kd, sched, T, st, nw, measure=False), reps))
    mm = {k: float(np.mean(v)) for k, v in mm.items()}
    n_m, n_u = mit.nsteps, mit.nburnin + NRETRY + 1
    mean = lambda a, b: (n_m * a + n_u * b) / (n_m + n_u)
    b_m, b_u = bound(nbytes[1], ops[1][1], ops[1][0]), bound(nbytes[2], ops[2][1], ops[2][0])
    print(f"phase 6f: one :mcmc step = {lay.W} walkers, the bubble at the first bosonic "
          f"Matsubara frequency: mcmc_accept_complex {mm['accept']!r} ms/measured step, "
          f"{mm['accept_u']!r} ms/unmeasured step, {mean(mm['accept'], mm['accept_u'])!r} ms "
          f"weighted by the {n_m} measured and {n_u} unmeasured launches of an iteration; "
          f"plain torch {mm['accept_plain']!r} and {mm['accept_u_plain']!r} ms (host clock) "
          f"[{card}]")
    print(f"phase 6f: mcmc_accept_complex bound {b_m[0]!r} ms measured ({nbytes[1]:.0f} bytes), "
          f"{b_u[0]!r} ms unmeasured ({nbytes[2]:.0f} bytes), {mean(b_m[0], b_u[0])!r} weighted "
          f"(by {b_m[1]})")
    return {"chain_accept_complex": (err_c, ms["accept"], ms["accept_plain"], *b_c),
            "mcmc_accept_complex": (max(errs[1], errs_u[1]), mean(mm["accept"], mm["accept_u"]),
                                    mean(mm["accept_plain"], mm["accept_u_plain"]),
                                    mean(b_m[0], b_u[0]), b_m[1])}


# ---------------------------------------------------------------------------
# the measurement side of :vegas and :vegasplus: complex weights, custom
# measures on :vegasplus, measurefreq > 1
# ---------------------------------------------------------------------------

MF = 4                                                    # phases 3g and 4g's measurefreq


def qdisc_exact():
    """The integral of e^{i(x+y)} over the quarter disc: over x = sin t,
    t in [0, pi/2), of e^{ix} (e^{i sqrt(1 - x^2)} - 1) / i dx, a smooth
    integrand in t, by 64-point Gauss-Legendre (0.4930146509292773 +
    0.5621624711036073i).  tests/test_pallas.py:398's 0.4930385477642199 +
    0.5622057316603964i is off by 2.4e-5 and 4.3e-5, 80 and 90 of
    :vegasplus' error bars at 2^30 evals an iteration."""
    u, wt = np.polynomial.legendre.leggauss(64)
    t, wt = (u + 1) * np.pi / 4, wt * np.pi / 4
    f = np.exp(1j * np.sin(t)) * (np.exp(1j * np.cos(t)) - 1) / 1j * np.cos(t)
    return complex((wt * f).sum())


def _qs_cexp(v, c):
    """e^{i(x+y)} on the quickstart's two pools."""
    import torch
    x, y = v
    return torch.exp(1j * (x[0] + y[0]))


def cexp_hist_exact(nbin=NBIN):
    """Each bin of the complex histogram of e^{i(x+y)} over x, times nbin:
    nbin (e^{i(a+h)} - e^{ia}) / i * (sin 1 + i(1 - cos 1)), h = 1/nbin."""
    h = 1.0 / nbin
    a = np.arange(nbin) * h
    return nbin * (np.exp(1j * (a + h)) - np.exp(1j * a)) / 1j * PHASE_EXACT


def _sing3_phase(x, c):
    """singular_3d times e^{i x}: phase 4d's problem with complex weights."""
    import torch
    return _sing3(x, c) * torch.exp(1j * x[0])


def _sing3_hist(v, relw, c):
    """A 10-bin histogram of the first angle over [0, pi), relw's dtype."""
    import torch
    b = torch.clamp((v[0] * (NBIN / np.pi)).to(torch.int32), 0, NBIN - 1)
    bins = torch.arange(NBIN, device=b.device).reshape((NBIN,) + (1,) * b.ndim)
    return [(bins == b).to(relw.dtype) * relw[0] * NBIN]


def _check_rel(what, got, want, tol):
    """Raise unless every output is within rel ``tol`` of the plain
    version's; returns (max abs err, max rel err)."""
    import torch
    torch.cuda.synchronize()
    rel = max(rel_err(a.cpu(), b.cpu()) for a, b in zip(got, want))
    if rel > tol:
        raise AssertionError(f"{what} vs plain: rel {rel:.3g} > {tol}")
    return max(float((a - b).abs().max()) for a, b in zip(got, want)), rel


def _check_bits(what, got, want):
    import torch
    torch.cuda.synchronize()
    if not torch.equal(bits(got), bits(want)):
        raise AssertionError(f"{what} differs from the plain version")
    return float((got - want).abs().max())


def vegas_branch_launch(mt, cfg, f, measure=None, obs=None):
    """(it, x, invp, perm, w, T): the second launch (t0 = T) of a :vegas
    iteration at phase 4's shape (2^26 evals a block, 16 blocks)."""
    from mcintegration_tpu_torch.ops import vegas_kernels as vk
    from mcintegration_tpu_torch.ops.rng import block_keys
    from mcintegration_tpu_torch.solvers.engine import Spec
    from mcintegration_tpu_torch.solvers.vegas import VegasIteration

    it = VegasIteration(Spec(cfg, "cuda"), f, measure=measure, obs_proto=obs, block=16,
                        nevalperblock=VEGAS_NEVAL // 16)
    assert it.backend_reason == "", it.backend_reason
    T = it.chunks_per_launch
    assert it.nchunks >= 2 * T, (it.nchunks, T)
    inputs = it.kernel_inputs(it.spec.device_params(), block_keys(SEED, 4, 0, it.block))
    x, invp, perm = vk.vegas_sample(t0=T, T=T, m=it.m_tile, **inputs)
    w = it.evaluate(it.leaf_values(x)).contiguous()
    return it, x, invp, perm, w, T


def vplus_branch_launch(mt, vp, cfg, f, nevalperblock, measure=None, obs=None):
    """(it, lay, tab, cube, cfac, x, gidx, w, t0, T): a launch of a
    :vegasplus iteration after one reallocation, at chunks [T, 2T)."""
    from mcintegration_tpu_torch.ops.rng import block_keys
    from mcintegration_tpu_torch.solvers.engine import Spec
    from mcintegration_tpu_torch.solvers.vegasplus import VegasPlusIteration

    it = VegasPlusIteration(Spec(cfg, "cuda"), f, measure=measure, obs_proto=obs, block=16,
                            nevalperblock=nevalperblock)
    assert it.backend_reason == "", it.backend_reason
    lay, params = it.layout, it.spec.device_params()
    it.reallocate(it.run(params, block_keys(SEED, 0, 0, it.block))["sig"])
    tab, kd = lay.tables(params), it.seeds(block_keys(SEED, 1, 0, it.block))
    cube, cfac = it.cube_tables()
    T = it.chunks_per_launch
    t0 = T if it.nchunks >= 2 * T else 0
    x, gidx = vp.vplus_sample(lay, tab, kd, t0, T, cube)
    w = it.evaluate(lay.leaf_values(x)).contiguous()
    return it, lay, tab, cube, cfac, x, gidx, w, t0, T


def measurement_vs_plain(mt, vk, vp, card):
    """Phase 3g: the new branches of vegas_reduce.cu and vplus_reduce.cu
    against their plain versions.  At one launch of phase 4's shape: the
    complex instantiations of vegas_reduce (default measure and given the
    complex 10-bin histogram's output) and vegas_relw_complex, with and
    without the gate of measurefreq MF, and the real kernel with it; the
    same at REDUCE_EDGES (MF = 3).  At one launch of phase 4d's shape (after
    one reallocation, with complex weights singular_3d e^{ix}): vplus_relw,
    real and complex, and vplus_reduce complex, given a 10-bin histogram's
    output (real and complex) and with the gate.  Given m = relw's
    components, the default sums bit for bit.  Then f + 0j against f over
    one iteration of each solver.  Bit-equal, or within REL_TOL_REDUCE and
    REL_TOL_VPLUS where only the float64 sum order differs.  Returns the
    max abs error of each new entry point."""
    import torch
    from mcintegration_tpu_torch.ops.rng import block_keys
    from mcintegration_tpu_torch.solvers.engine import Spec
    from mcintegration_tpu_torch.solvers.vegas import VegasIteration
    from mcintegration_tpu_torch.solvers.vegasplus import VegasPlusIteration

    errs = dict.fromkeys(("vegas_reduce_complex", "vegas_relw_complex", "vplus_reduce_complex",
                          "vplus_relw", "vplus_reduce_measure"), 0.0)

    def keep(name, err):
        errs[name] = max(errs[name], err)

    # :vegas, the complex histogram of e^{i(x+y)} at phase 4's launch shape
    cobs = [np.zeros(NBIN, np.complex64)]
    cfg = mt.Configuration(var=(mt.Continuous(0.0, 1.0), mt.Continuous(0.0, 1.0)), dof=[[1, 1]],
                           obs=cobs, type=complex, seed=SEED)
    it, x, invp, perm, w, T = vegas_branch_launch(mt, cfg, _qs_cexp, hist_measure(NBIN), cobs)
    masks = (it.pad, it.pair_slots, it.used)
    relw = vk.vegas_relw(w, invp, it.pad, it.pair_slots)
    keep("vegas_relw_complex", _check_bits("vegas_relw_complex", relw,
                                           vk.vegas_relw_plain(w, invp, it.pad, it.pair_slots)))
    m = it.measure(it.leaf_values(x), relw).contiguous()
    rels = []
    for mf in (1, MF):
        for given in (None, m):
            what = f"vegas_reduce_complex, {'m' if given is not None else 'default'}, mf {mf}"
            e, rel = _check_rel(what, vk.vegas_reduce(w, invp, perm, *masks, given, mf, T),
                                vk.vegas_reduce_plain(w, invp, perm, *masks, given, mf, T),
                                REL_TOL_REDUCE)
            keep("vegas_reduce_complex", e)
            rels.append(rel)
        ident = vk.vegas_reduce(w, invp, perm, *masks, relw_components(relw), mf, T)
        default = vk.vegas_reduce(w, invp, perm, *masks, None, mf, T)
        if not (torch_equal_bits(ident[1], default[1])
                and rel_err(ident[0].cpu(), default[0].cpu()) <= REL_TOL_REDUCE):
            raise AssertionError(f"vegas_reduce_complex given m = relw, mf {mf}: the sums "
                                 "differ from the default ones")
    print(f"phase 3g: :vegas launch of {it.block} blocks x {T} chunks x {it.chunk} samples at "
          f"t0={T}, complex e^{{i(x+y)}}: vegas_relw_complex bit-equal; vegas_reduce_complex "
          f"(default, given the complex {NBIN}-bin histogram's {m.shape[0]} components; mf 1 and "
          f"{MF}) rel <= {max(rels):.3g}; given m = relw, the default sums (histogram "
          f"bit-equal; obs, whose real and imaginary parts the wrapper sums apart, within "
          f"{REL_TOL_REDUCE})")
    del x, invp, perm, w, relw, m, ident, default

    it, x, invp, perm, w, T = vegas_branch_launch(
        mt, mt.Configuration(var=mt.Continuous(0.0, 1.0), dof=[[2]], seed=SEED), _pi)
    _, rel = _check_rel(f"vegas_reduce, mf {MF}",
                        vk.vegas_reduce(w, invp, perm, it.pad, it.pair_slots, it.used, None, MF, T),
                        vk.vegas_reduce_plain(w, invp, perm, it.pad, it.pair_slots, it.used, None,
                                              MF, T), REL_TOL_REDUCE)
    print(f"phase 3g: :vegas launch at t0={T}, pi, real weights: vegas_reduce with the gate of "
          f"measurefreq {MF} rel {rel:.3g}")
    del x, invp, perm, w
    for mm, N, ncomp, B, T, nb in REDUCE_EDGES:
        args, mobs = reduce_inputs(mm, N, ncomp, B, T, nb, cplx=True)
        rel = 0.0
        for given in (None, mobs):
            for a in (args, (args[0].real.contiguous(), *args[1:])):
                e, r = _check_rel(f"vegas_reduce at m={mm}, N={N}", vk.vegas_reduce(*a, given, 3, 2),
                                  vk.vegas_reduce_plain(*a, given, 3, 2), REL_TOL_REDUCE)
                rel = max(rel, r)
                if a is args:
                    keep("vegas_reduce_complex", e)
        print(f"phase 3g: vegas_reduce at m={mm}, N={N}, {ncomp} components, complex and real "
              f"weights, both modes, mf 3, t0 2: rel {rel:.3g}")

    # :vegasplus, phase 4d's launch shape with complex weights
    sing = mt.Configuration(var=mt.Continuous(0.0, np.pi), dof=[[3]], seed=SEED, type=complex,
                            obs=[np.zeros(NBIN, np.complex64)])
    leaf = sing.var[0]
    leaf.histogram = np.random.default_rng(1).gamma(0.5, 1.0, leaf.ninc) + 1e-3
    leaf.train()
    it, lay, tab, cube, cfac, x, gidx, w, t0, T = vplus_branch_launch(
        mt, vp, sing, _sing3_phase, 2 ** 26, _sing3_hist, sing.observable)
    args = (lay, tab, w, gidx, cube, cfac)
    relw = vp.vplus_relw(*args)
    keep("vplus_relw", _check_bits("vplus_relw, complex", relw, vp.vplus_relw_plain(*args)))
    rargs = (lay, tab, w.real.contiguous(), gidx, cube, cfac)
    rrelw = vp.vplus_relw(*rargs)
    keep("vplus_relw", _check_bits("vplus_relw, real", rrelw, vp.vplus_relw_plain(*rargs)))
    cm = it.measure(lay.leaf_values(x), relw).contiguous()
    rm = _sing3_hist(lay.leaf_values(x)[0], rrelw, None)[0].contiguous()
    rels = []
    for mf in (1, MF):
        shift = vp.gate_shifts(it.seeds(block_keys(SEED, 1, 0, it.block)), t0, T, it.chunk) \
            if mf > 1 else None
        # given m at 20, 10, 1 and 3 components (a warp forms the sums of four
        # chunks at a time, whatever their count)
        for name, a, given in (("vplus_reduce_complex", args, None),
                               ("vplus_reduce_complex", args, cm),
                               ("vplus_reduce_measure", rargs, rm),
                               ("vplus_reduce_measure", rargs, rm[:1].contiguous()),
                               ("vplus_reduce_measure", rargs, rm[:3].contiguous()),
                               ("vplus_reduce", rargs, None)):
            e, rel = _check_rel(f"{name}, mf {mf}", vp.vplus_reduce(*a, given, mf, t0, shift),
                                vp.vplus_reduce_plain(*a, given, mf, t0, shift), REL_TOL_VPLUS)
            if name in errs:
                keep(name, e)
            rels.append(rel)
        for a, r in ((args, relw), (rargs, rrelw)):
            ident = vp.vplus_reduce(*a, relw_components(r), mf, t0, shift)
            default = vp.vplus_reduce(*a, None, mf, t0, shift)
            same = torch_equal_bits(ident[0], default[0]) if not r.is_complex() else \
                rel_err(ident[0].cpu(), default[0].cpu()) <= REL_TOL_VPLUS
            if not same:
                raise AssertionError(f"vplus_reduce given m = relw, mf {mf}: obs differ from the "
                                     "default sums")
    print(f"phase 3g: :vegasplus launch of {it.block} blocks x {T} chunks x {it.chunk} samples at "
          f"t0={t0} ({lay.S} slots, counts {int(it.counts.min())}..{int(it.counts.max())}), "
          f"singular_3d e^{{ix}}: vplus_relw (complex and real) bit-equal; vplus_reduce complex "
          f"(default, given the complex {NBIN}-bin histogram's {cm.shape[0]} components), given "
          f"the real one's {rm.shape[0]}, its first 1 and its first 3, and real, each at mf 1 and "
          f"{MF} (the gate's positions "
          f"shifted at random per chunk): rel <= {max(rels):.3g}; "
          f"given m = relw, obs bit-equal to the default sums (real weights; complex within "
          f"{REL_TOL_VPLUS})")
    del x, gidx, w, relw, rrelw, cm, rm, ident, default, args, rargs

    # f + 0j against f over one iteration of each solver, from the same seeds
    kd = block_keys(SEED, 5, 0, 16)
    for cls, var, f, npb in ((VegasIteration, lambda: mt.Continuous(0.0, 1.0), _pi, 2 ** 22),
                             (VegasPlusIteration, lambda: mt.Continuous(0.0, np.pi), _sing3,
                              2 ** 22)):
        dof = [[2]] if f is _pi else [[3]]
        runs = []
        for typ, g in ((float, f), (complex, lambda x, c, f=f: f(x, c) + 0j)):
            spec = Spec(mt.Configuration(var=var(), dof=dof, seed=SEED, type=typ), "cuda")
            it = cls(spec, g, block=16, nevalperblock=npb)
            st = it.run(spec.device_params(), kd)
            runs.append((st, st.get("sig")))
        (a, sa), (b, sb) = runs
        if not (np.array_equal(b["obs_blocks"].real, a["obs_blocks"])
                and np.all(b["obs_blocks"].imag == 0.0)
                and np.array_equal(a["norm_blocks"], b["norm_blocks"])):
            raise AssertionError(f"{cls.__name__} f + 0j: obs differ from the real run's")
        tol = 0.0 if sa is None else REL_TOL_VPLUS
        e_hist = max(rel_err(h, r) for h, r in zip(b["hists"], a["hists"]) if r.any())
        e_sig = 0.0 if sa is None else rel_err(sb, sa)
        if max(e_hist, e_sig) > tol:
            raise AssertionError(f"{cls.__name__} f + 0j: hist rel {e_hist:.3g}, sig rel "
                                 f"{e_sig:.3g} > {tol}")
        print(f"phase 3g: {cls.__name__} f + 0j, one run of {a['neval']} evals: obs real parts "
              f"bit-equal to the real run, imaginary parts 0, hist rel {e_hist:.3g}"
              + ("" if sa is None else f", sig rel {e_sig:.3g}"))
    return errs


def measurement_main_path(mt, vk, vp, card, rates):
    """Phase 4g: the new routes through integrate(device="cuda") at 2^30
    evals an iteration, 16 blocks, 10 iterations: the quarter disc times
    e^{i(x+y)} with type=complex on :vegas and :vegasplus (both parts within
    5 sigma); the quickstart's 10-bin histogram on :vegasplus (every bin
    within 7 sigma); the complex histogram of e^{i(x+y)} over x on :vegas
    (every part within 7 sigma); phase 4's pi problem with measurefreq MF
    on both (within 5 sigma, normalization 10 * 16 * (nevalperblock // MF)).
    Each run's launches counted from 0, its rate beside phase 4's or 4d's.
    Returns the new entry points' launches summed over the runs."""
    from mcintegration_tpu_torch.solvers.engine import Spec
    from mcintegration_tpu_torch.solvers.vegas import VegasIteration
    from mcintegration_tpu_torch.solvers.vegasplus import VegasPlusIteration

    niter = 10
    cobs = [np.zeros(NBIN, np.complex64)]
    pi = lambda **kw: dict(var=mt.Continuous(0.0, 1.0), dof=[[2]], **kw)
    qs = lambda **kw: dict(var=(mt.Continuous(0.0, 1.0), mt.Continuous(0.0, 1.0)), dof=[[1, 1]],
                           **kw)
    # solver, problem, integrand, measure, its keywords (fresh pools each
    # call), exact value, sigmas, the reduce's and the relw's launch keys
    runs = (("vegas", "quarter disc e^{i(x+y)}", _qdisc, None, lambda: pi(type=complex),
             qdisc_exact(), 5, "vegas_reduce_complex", None),
            ("vegasplus", "quarter disc e^{i(x+y)}", _qdisc, None, lambda: pi(type=complex),
             qdisc_exact(), 5, "vplus_reduce_complex", None),
            ("vegasplus", f"{NBIN}-bin histogram", _qs_f, hist_measure(NBIN),
             lambda: qs(obs=[np.zeros(NBIN)]), qs_exact(), 7, "vplus_reduce_measure",
             "vplus_relw"),
            ("vegas", f"complex {NBIN}-bin histogram of e^{{i(x+y)}}", _qs_cexp,
             hist_measure(NBIN), lambda: qs(obs=cobs, type=complex), cexp_hist_exact(), 7,
             "vegas_reduce_complex", "vegas_relw_complex"),
            ("vegas", f"pi, measurefreq {MF}", _pi, None, lambda: pi(measurefreq=MF), np.pi / 4,
             5, "vegas_reduce", None),
            ("vegasplus", f"pi, measurefreq {MF}", _pi, None, lambda: pi(measurefreq=MF),
             np.pi / 4, 5, "vplus_reduce", None))
    new = ("vegas_reduce_complex", "vegas_relw_complex", "vplus_reduce_complex", "vplus_relw",
           "vplus_reduce_measure")
    counts = dict.fromkeys(new, 0)
    for solver, name, f, meas, kw_of, exact, k, key, relw_key in runs:
        cls, mod = (VegasIteration, vk) if solver == "vegas" else (VegasPlusIteration, vp)
        kw = kw_of()
        mf = kw.pop("measurefreq", 1)
        spec = Spec(mt.Configuration(seed=SEED, **kw), "cuda")
        shape = cls(spec, f, measure=meas, obs_proto=spec.cfg.observable, measurefreq=mf,
                    block=16, nevalperblock=VEGAS_NEVAL // 16)
        L = niter * shape.launches_per_run
        sample = "vegas_sample" if solver == "vegas" else "vplus_sample"
        expected = {**dict.fromkeys(mod.launch_counts, 0), sample: L, key: L,
                    **({relw_key: L} if relw_key else {})}
        kw = kw_of()                # fresh pools: integrate trains their maps
        kw.pop("measurefreq", None)
        mod.reset_launch_counts()
        res = mt.integrate(f, measure=meas, measurefreq=mf, solver=solver, neval=VEGAS_NEVAL,
                           niter=niter, block=16, device="cuda", seed=SEED, verbose=-2, **kw)
        got = dict(mod.launch_counts)
        assert res.backend == "cuda" and res.backend_reason == "", res.backend_reason
        assert got == expected, (solver, name, got, expected)
        for q in new:
            counts[q] += got.get(q, 0)
        mean, std = np.asarray(res.mean[0]), np.asarray(res.stdev[0])
        exact = np.asarray(exact)
        assert mean.shape == exact.shape and np.all(np.isfinite(mean)), (mean, exact)
        z = (mean.real - exact.real) / std.real
        if np.iscomplexobj(mean):
            z = z + 1j * (mean.imag - exact.imag) / std.imag
        if not (np.all(np.abs(z.real) < k) and np.all(np.abs(z.imag) < k)):
            raise AssertionError(f"phase 4g: {solver}, {name}: {mean.tolist()} +- "
                                 f"{std.tolist()}, outside {k} sigma: {z.tolist()}")
        if mf > 1:
            norm = niter * 16 * (shape.nevalperblock // mf)
            assert res.config.normalization == norm, (res.config.normalization, norm)
        evals = [h[2].neval for h in res.iterations]
        steady = sum(evals[1:]) / sum(res.iteration_times[1:])
        ph = "4" if solver == "vegas" else "4d"
        print(f"phase 4g: {solver}, {name}, {niter} iterations of {evals[0]} evals: "
              f"{mean.tolist()} +- {std.tolist()}, sigma {np.round(z, 2).tolist()}; launches {got}"
              + (f"; normalization {res.config.normalization!r}" if mf > 1 else ""))
        print(f"phase 4g: {solver}, {name}: steady-state {steady!r} evals/s, {rates[ph]!r} for "
              f"the real main path (phase {ph}), ratio {steady / rates[ph]!r} (per-iteration s "
              f"{res.iteration_times}) [{card}]")
    return counts


def measurement_timings(mt, vk, vp, card):
    """Phase 6g: device ms of the new entry points at phase 4g's launch
    shapes, in turns with their plain versions (plain, kernel, kernel,
    plain), beside their bounds from the bytes each must move:
    vegas_reduce_complex and vegas_relw_complex on the quarter disc times
    e^{i(x+y)} (2^26 samples a launch), vplus_reduce_complex on it on
    :vegasplus, vplus_relw and vplus_reduce given the 10-bin histogram's
    output on the quickstart's problem on :vegasplus, there also in its
    other instantiations (complex weights, the gate) beside the parent's
    times (PARENT_6G), with ptxas -v's registers.  Returns each one's
    (max abs err, ms, plain_ms, bound_ms, bound_by)."""
    import torch
    from mcintegration_tpu_torch.ops.rng import block_keys

    nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)

    def turns(kernel, plain, reps=10):
        k, p = [], []
        for order in ((plain, kernel), (kernel, plain)):
            for fn in order:
                if fn is kernel:
                    k.append(device_ms(kernel, reps))
                else:
                    p.append(time_ms(plain, 2))
        return float(np.mean(k)), float(np.mean(p))

    out = {}
    pi_c = mt.Configuration(var=mt.Continuous(0.0, 1.0), dof=[[2]], seed=SEED, type=complex)
    it, x, invp, perm, w, T = vegas_branch_launch(mt, pi_c, _qdisc)
    masks = (it.pad, it.pair_slots, it.used)
    n, N, nslots, R = w[0].numel(), w.shape[0], invp.shape[0], invp[0].numel()
    got = vk.vegas_reduce(w, invp, perm, *masks)
    e, _ = _check_rel("vegas_reduce_complex at 6g", got,
                      vk.vegas_reduce_plain(w, invp, perm, *masks), REL_TOL_REDUCE)
    ms, pms = turns(lambda: vk.vegas_reduce(w, invp, perm, *masks),
                    lambda: vk.vegas_reduce_plain(w, invp, perm, *masks))
    b = bound(nbytes(w, invp, perm, *masks, got[1]) + 8 * R * 2 * N,
              12 * n * N + 8 * n * nslots)
    out["vegas_reduce_complex"] = (e, ms, pms, *b)
    relw = vk.vegas_relw(w, invp, it.pad, it.pair_slots)
    e = _check_bits("vegas_relw_complex at 6g", relw,
                    vk.vegas_relw_plain(w, invp, it.pad, it.pair_slots))
    ms, pms = turns(lambda: vk.vegas_relw(w, invp, it.pad, it.pair_slots),
                    lambda: vk.vegas_relw_plain(w, invp, it.pad, it.pair_slots))
    b = bound(nbytes(w, invp, it.pad, it.pair_slots, relw), 2 * n * N)
    out["vegas_relw_complex"] = (e, ms, pms, *b)
    print(f"phase 6g: one :vegas launch = {it.block} blocks x {T} chunks x {it.chunk} samples "
          f"({n} evals), complex weights: vegas_reduce_complex "
          f"{out['vegas_reduce_complex'][1]!r} ms, plain torch {out['vegas_reduce_complex'][2]!r}"
          f" ms, bound {out['vegas_reduce_complex'][3]!r} ms; vegas_relw_complex "
          f"{out['vegas_relw_complex'][1]!r} ms, plain torch {out['vegas_relw_complex'][2]!r} ms, "
          f"bound {out['vegas_relw_complex'][3]!r} ms [{card}]")
    del x, invp, perm, w, relw, got

    it, lay, tab, cube, cfac, x, gidx, w, t0, T = vplus_branch_launch(
        mt, vp, pi_c, _qdisc, VEGAS_NEVAL // 16)
    args = (lay, tab, w, gidx, cube, cfac)
    n, S, N = w[0].numel(), lay.S, w.shape[0]
    got = vp.vplus_reduce(*args)
    e, _ = _check_rel("vplus_reduce_complex at 6g", got, vp.vplus_reduce_plain(*args),
                      REL_TOL_VPLUS)
    ms, pms = turns(lambda: vp.vplus_reduce(*args), lambda: vp.vplus_reduce_plain(*args))
    obs_rows = 8 * 2 * N * it.block * T * -(-it.chunk // vp.SPAN) * vp.WARPS
    b = bound(nbytes(w, gidx, cube, cfac, tab, lay.meta, got[1], got[2]) + obs_rows,
              40 * n * (S + N) + 10 * n * N)
    print(f"phase 6g: one :vegasplus launch = {it.block} blocks x {T} chunks x {it.chunk} samples "
          f"({n} evals, {S} slots), complex weights: vplus_reduce_complex {ms!r} ms, plain torch "
          f"{pms!r} ms (host clock), bound {b[0]!r} ms [{card}]")
    # the complex default and its gated form, beside the parent's times below
    shift = vp.gate_shifts(it.seeds(block_keys(SEED, 1, 0, it.block)), t0, T, it.chunk)
    e2, _ = _check_rel(f"vplus_reduce_complex, mf {MF}, at 6g",
                       vp.vplus_reduce(*args, None, MF, t0, shift),
                       vp.vplus_reduce_plain(*args, None, MF, t0, shift), REL_TOL_VPLUS)
    out["vplus_reduce_complex"] = (max(e, e2), ms, pms, *b)
    times = {"complex, default, mf 1": ms,
             f"complex, default, mf {MF}": device_ms(
                 lambda: vp.vplus_reduce(*args, None, MF, t0, shift), 10)}
    del x, gidx, w, got, args

    qs = mt.Configuration(var=(mt.Continuous(0.0, 1.0), mt.Continuous(0.0, 1.0)), dof=[[1, 1]],
                          obs=[np.zeros(NBIN)], seed=SEED)
    it, lay, tab, cube, cfac, x, gidx, w, t0, T = vplus_branch_launch(
        mt, vp, qs, _qs_f, VEGAS_NEVAL // 16, hist_measure(NBIN), qs.observable)
    args = (lay, tab, w, gidx, cube, cfac)
    n, S, N = w[0].numel(), lay.S, w.shape[0]
    relw = vp.vplus_relw(*args)
    e = _check_bits("vplus_relw at 6g", relw, vp.vplus_relw_plain(*args))
    ms, pms = turns(lambda: vp.vplus_relw(*args), lambda: vp.vplus_relw_plain(*args))
    b = bound(nbytes(w, gidx, cube, cfac, tab, lay.meta, relw), 30 * n * (S + N))
    # vplus_relw_complex, w + 0.5iw: its own line (the kernels' line keeps
    # one vplus_relw entry, whose launches count both)
    wc = torch.complex(w, w * 0.5).contiguous()
    cargs = (lay, tab, wc, gidx, cube, cfac)
    crelw = vp.vplus_relw(*cargs)
    e2 = _check_bits("vplus_relw_complex at 6g", crelw, vp.vplus_relw_plain(*cargs))
    out["vplus_relw"] = (max(e, e2), ms, pms, *b)
    cms, cpms = turns(lambda: vp.vplus_relw(*cargs), lambda: vp.vplus_relw_plain(*cargs))
    cb_ = bound(nbytes(wc, gidx, cube, cfac, tab, lay.meta, crelw), 30 * n * (S + 2 * N))
    print(f"phase 6g: vplus_relw_complex at the same launch: {cms!r} ms, plain torch {cpms!r} "
          f"ms, bound {cb_[0]!r} ms (by {cb_[1]}), {cms / cb_[0]!r} times it [{card}]")
    times["real, relw"] = ms
    times["complex, relw"] = cms
    del cargs, crelw
    m = it.measure(lay.leaf_values(x), relw).contiguous()
    got = vp.vplus_reduce(*args, m)
    e, _ = _check_rel("vplus_reduce given m at 6g", got, vp.vplus_reduce_plain(*args, m),
                      REL_TOL_VPLUS)
    ms2, pms2 = turns(lambda: vp.vplus_reduce(*args, m), lambda: vp.vplus_reduce_plain(*args, m))
    obs_rows = 8 * m.shape[0] * it.block * T * -(-it.chunk // vp.SPAN) * vp.WARPS
    b2 = bound(nbytes(w, gidx, cube, cfac, tab, lay.meta, m, got[1], got[2]) + obs_rows,
               40 * n * (S + N) + 2 * n * m.shape[0])
    out["vplus_reduce_measure"] = (e, ms2, pms2, *b2)
    print(f"phase 6g: one :vegasplus launch = {it.block} blocks x {T} chunks x {it.chunk} samples "
          f"({n} evals, {S} slots), the {NBIN}-bin histogram: vplus_relw {ms!r} ms, plain torch "
          f"{pms!r} ms, bound {b[0]!r} ms; vplus_reduce given {m.shape[0]} components {ms2!r} ms, "
          f"plain torch {pms2!r} ms (host clock), bound {b2[0]!r} ms [{card}]")
    for name, (err, t, pt, bd, by) in out.items():
        print(f"phase 6g: {name} takes {t / bd!r} times its bound (by {by}) [{card}]")
    # vplus_reduce given m in every instantiation (real and complex weights,
    # with and without the gate), beside the parent's times, as are the
    # complex default and vplus_relw's above
    shift = vp.gate_shifts(it.seeds(block_keys(SEED, 1, 0, it.block)), t0, T, it.chunk)
    for kind, ww in (("real", w), ("complex", wc)):
        for mf, sh in ((1, None), (MF, shift)):
            times[f"{kind}, given m, mf {mf}"] = device_ms(
                lambda: vp.vplus_reduce(lay, tab, ww, gidx, cube, cfac, m, mf, t0, sh), 10)
    for what, t in times.items():
        print(f"phase 6g: vplus_reduce.cu, {what}: {t!r} ms, the parent's {PARENT_6G[what]!r} "
              f"ms, ratio {t / PARENT_6G[what]!r} [{card}]")
    for key in ("vplus_reduce_kernel", "vplus_reduce_complex_kernel", "vplus_relw_kernel"):
        for line in ptxas_lines(key):
            print(f"phase 6g: ptxas -v {line}")
    return out


# ---------------------------------------------------------------------------
# :vegas on Discrete pools and pools of different ninc (the mixed route)
# ---------------------------------------------------------------------------

def make_vegas_bubble(device):
    """The polarisation bubble in spherical coordinates (tests/test_bubble.py:
    52-71), batched, with its q table on ``device`` once."""
    import torch
    extq = torch.as_tensor(EXTQ, dtype=torch.float32, device=device)

    def bubble(v, c):
        R, Th, Ph, T, Ext = v
        r = R[0] / (1 - R[0])
        th, ph = Th[0], Ph[0]
        k = torch.stack([r * torch.sin(th) * torch.cos(ph), r * torch.sin(th) * torch.sin(ph),
                         r * torch.cos(th)])
        factor = r ** 2 / (1 - R[0]) ** 2 * torch.sin(th) / (2 * np.pi) ** 3
        kq = k + extq[Ext[0] - 1].movedim(-1, 0)
        w1 = ((k * k).sum(0) - KF ** 2) / (2 * ME)
        w2 = ((kq * kq).sum(0) - KF ** 2) / (2 * ME)
        return _green(T[0], w1, BETA_PHYS) * _green(-T[0], w2, BETA_PHYS) * SPIN * factor

    return bubble


def _vbubble_measure(v, relw, c):
    """The one-hot measure of tests/test_bubble.py:74-77: relw[0] into the bin
    of the external momentum."""
    from mcintegration_tpu_torch import onehot
    return [onehot(v[-1][0], 1, QSIZE, relw.dtype, like=relw[0]) * relw[0]]


def vegas_bubble_kw(mt, cplx=False):
    """integrate() keywords of tests/test_bubble.py:80-90 on :vegas: (r, theta,
    phi, tau, Discrete(1, 4, adapt=False)), alpha=3 on the maps."""
    C = mt.Continuous
    var = (C(0.0, 1.0, alpha=3.0), C(0.0, np.pi, alpha=3.0), C(0.0, 2 * np.pi, alpha=3.0),
           C(0.0, BETA_PHYS, alpha=3.0), mt.Discrete(1, QSIZE, adapt=False))
    obs = [np.zeros(QSIZE, np.complex64 if cplx else np.float64)]
    return dict(var=var, dof=[[1, 1, 1, 1, 1]], obs=obs, measure=_vbubble_measure,
                **({"type": complex} if cplx else {}))


def _td2(v, c):
    return v[0][0] * v[1][0].float() ** 2


def _one(v, c):
    import torch
    return torch.ones(v[0][0].shape, device=v[0][0].device)


def _logxyz(v, c):
    import torch
    x, y, z = v[0][0], v[1][0], v[2][0]
    return torch.log(x) / torch.sqrt(x) * y ** 2 * torch.exp(z)


def _prod2(v, c):
    return (v[0][0] * v[1][0]).float()


def _mixed3(v, c):
    return v[0][0] * v[1][0] + v[2][0]


# name, var of mt, dof, integrand (or None: the bubble), nevalperblock, blocks,
# chunks a launch of phase 3h's specs of the mixed route: the bubble at phase
# 4h's launch shape (fewer chunks), a Discrete CDF in device memory (2,004
# bins) beside one in shared memory, mixed ninc with strata of m_k % 4 != 0
# and a chunk of c % 4 != 0 (scalar loads and stores, one pool drawn per
# sample), an all-Discrete spec, more than 4,096 histogram bins in one slot,
# and strata of m_k = 2 at c % 4 == 0 (the four samples of a reduce thread
# in two bins; 16-byte loads)
MIXED_SPECS = (
    ("bubble", lambda mt: vegas_bubble_kw(mt)["var"], [[1, 1, 1, 1, 1]], None, 2 ** 26, 16, 4),
    ("Discrete(-3, 2000) and Discrete(1, 7)",
     lambda mt: (mt.Discrete(-3, 2000), mt.Discrete(1, 7)), [[1, 1]], _prod2, 2 ** 16, 4, 2),
    ("ninc 1001, 7 and 10 (m_k 3 and 429, c 3003)",
     lambda mt: (mt.Continuous(0.0, 1.0, ninc=1001), mt.Continuous(0.0, 1.0, ninc=7),
                 mt.Continuous(0.0, 1.0, ninc=10)), [[1, 1, 1]], _mixed3, 3003, 4, 3),
    ("all Discrete", lambda mt: (mt.Discrete([(1, 3), (1, 4)]),), [[1]], _prod2, 2 ** 16, 4, 2),
    ("ninc 6000 and Discrete(0, 4999): 11,000 bins",
     lambda mt: (mt.Continuous(0.0, 1.0, ninc=6000), mt.Discrete(0, 4999)), [[1, 1]], _prod2,
     2 ** 16, 4, 2),
    ("ninc 4096 and 1024 (m_k 2 and 8, c 8192)",
     lambda mt: (mt.Continuous(0.0, 1.0, ninc=4096), mt.Continuous(0.0, 1.0, ninc=1024)),
     [[1, 1]], _prod2, 8192, 4, 2),
)


def misaligned(t):
    """A contiguous copy of ``t`` whose data lies one element (4 or 8
    bytes) past a 16-byte boundary: the kernels' 16-byte loads do not apply
    to it."""
    import torch
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    off = 1 if buf.data_ptr() % 16 == 0 else 0
    out = buf[off:off + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 != 0
    return out


def mixed_launch(mt, var, dof, f, npb, block, T, seed=SEED, cplx=False, measure=None,
                 obs=None):
    """(it, lay, tab, kd, t0, T, x, gidx, w) of a launch of the mixed route
    at chunks [T, 2T) (or [0, T) with fewer chunks; ``T`` None: the
    iteration's own launch), on maps trained at random; with ``cplx`` the
    integrand times a phase, complex64."""
    import torch
    from mcintegration_tpu_torch.ops import vegas_kernels as vk
    from mcintegration_tpu_torch.ops.rng import block_keys
    from mcintegration_tpu_torch.solvers.engine import Spec
    from mcintegration_tpu_torch.solvers.vegas import VegasMixedIteration

    cfg = mt.Configuration(var=var, dof=dof, seed=seed, type=complex if cplx else float)
    rng = np.random.default_rng(seed)
    for _, leaf in cfg.var_leaves():
        if leaf.adapt:
            leaf.histogram = rng.gamma(0.5, 1.0, leaf.nhist) + 1e-3
            leaf.train()
    spec = Spec(cfg, "cuda")
    it = VegasMixedIteration(spec, f or make_vegas_bubble("cuda"), measure=measure,
                             obs_proto=obs, block=block, nevalperblock=npb)
    lay = it.layout
    tab, kd = lay.tables(spec.device_params()), it.seeds(block_keys(seed, 1, 0, block))
    T = min(T or it.chunks_per_launch, it.nchunks)
    t0 = T if it.nchunks >= 2 * T else 0
    x, gidx = vk.vegas_sample_mixed(lay, tab, kd, t0, T)
    w = it.evaluate(lay.leaf_values(x)).contiguous()
    if cplx:
        w = (w * torch.exp(1j * x[0].view(torch.int32).float() * 1e-3)).to(torch.complex64)
    return it, lay, tab, kd, t0, T, x, gidx, w.contiguous()


def _measure_of(relw):
    """A measure's output from relw: its real components, then twice them."""
    import torch
    comps = relw_components(relw)
    return torch.cat([comps, comps * 2.0]).contiguous()


def mixed_vs_plain(mt, vk, card):
    """Phase 3h: the mixed route's kernels against their plain versions on
    every spec of MIXED_SPECS: vegas_sample_mixed and vegas_relw_mixed (real
    and complex) bit for bit; vegas_reduce_mixed in every instantiation (real
    and complex weights; the default observables, given a measure's output;
    ungated and gated by measurefreq MF) with obs within REL_TOL_REDUCE and
    the histograms within REL_TOL_VPLUS (float64 adds in another order);
    then a spec of the uniform route through both routes at the uniform
    route's launch: x bit-equal, obs and histograms within REL_TOL_VPLUS.
    Returns the max abs error of each new entry point."""
    import torch
    from mcintegration_tpu_torch.ops.rng import block_keys
    from mcintegration_tpu_torch.solvers.engine import Spec
    from mcintegration_tpu_torch.solvers.vegas import VegasIteration

    errs = dict.fromkeys(("vegas_sample_mixed", "vegas_relw_mixed", "vegas_reduce_mixed"), 0.0)
    for name, var, dof, f, npb, block, T in MIXED_SPECS:
        rels = [0.0, 0.0]
        for cplx in (False, True):
            it, lay, tab, kd, t0, T, x, gidx, w = mixed_launch(mt, var(mt), dof, f, npb, block, T,
                                                               cplx=cplx)
            want = vk.vegas_sample_mixed_plain(lay, tab, kd, t0, T)
            errs["vegas_sample_mixed"] = max(errs["vegas_sample_mixed"], _check_bits(
                f"vegas_sample_mixed x, {name}", x, want[0]))
            _check_bits(f"vegas_sample_mixed gidx, {name}", gidx, want[1])
            del want
            relw = vk.vegas_relw_mixed(lay, tab, w, gidx)
            errs["vegas_relw_mixed"] = max(errs["vegas_relw_mixed"], _check_bits(
                f"vegas_relw_mixed, {name}, complex {cplx}", relw,
                vk.vegas_relw_mixed_plain(lay, tab, w, gidx)))
            m = _measure_of(relw)
            del relw
            for mf in (1, MF):
                for given in (None, m):
                    got = vk.vegas_reduce_mixed(lay, tab, w, gidx, given, mf, t0)
                    ref = vk.vegas_reduce_mixed_plain(lay, tab, w, gidx, given, mf, t0)
                    what = (f"vegas_reduce_mixed, {name}, complex {cplx}, "
                            f"{'m' if given is not None else 'default'}, mf {mf}")
                    e0, r0 = _check_rel(what + ", obs", got[:1], ref[:1], REL_TOL_REDUCE)
                    e1, r1 = _check_rel(what + ", hist", got[1:], ref[1:], REL_TOL_VPLUS)
                    errs["vegas_reduce_mixed"] = max(errs["vegas_reduce_mixed"], e0, e1)
                    rels = [max(rels[0], r0), max(rels[1], r1)]
            del x, gidx, w, m, got, ref
        print(f"phase 3h: {name}: {lay.S} slots (kinds {lay.slots[:, 0].tolist()}, m_k "
              f"{lay.slots[:, 5].tolist()}), {it.block} blocks x {T} chunks x {lay.chunk} "
              f"samples at t0={t0}, {lay.nhist} histogram bins: vegas_sample_mixed and "
              f"vegas_relw_mixed (real, complex) bit-equal; vegas_reduce_mixed (real, complex; "
              f"default, given m; mf 1 and {MF}) obs rel {rels[0]:.3g}, hist rel {rels[1]:.3g}")

    # the scalar path at c % 4 == 0: w and m one element off 16-byte alignment
    name, var, dof, f, npb, block, T = MIXED_SPECS[1]
    rels = [0.0, 0.0]
    for cplx in (False, True):
        it, lay, tab, kd, t0, T, x, gidx, w = mixed_launch(mt, var(mt), dof, f, npb, block, T,
                                                           cplx=cplx)
        wu = misaligned(w)
        relw = vk.vegas_relw_mixed(lay, tab, wu, gidx)
        errs["vegas_relw_mixed"] = max(errs["vegas_relw_mixed"], _check_bits(
            f"vegas_relw_mixed, {name}, misaligned w, complex {cplx}", relw,
            vk.vegas_relw_mixed_plain(lay, tab, w, gidx)))
        m = _measure_of(relw)
        for mf in (1, MF):
            for given in (None, misaligned(m)):
                what = (f"vegas_reduce_mixed, {name}, misaligned w and m, complex {cplx}, "
                        f"{'m' if given is not None else 'default'}, mf {mf}")
                got = vk.vegas_reduce_mixed(lay, tab, wu, gidx, given, mf, t0)
                ref = vk.vegas_reduce_mixed_plain(lay, tab, w, gidx, given, mf, t0)
                e0, r0 = _check_rel(what + ", obs", got[:1], ref[:1], REL_TOL_REDUCE)
                e1, r1 = _check_rel(what + ", hist", got[1:], ref[1:], REL_TOL_VPLUS)
                errs["vegas_reduce_mixed"] = max(errs["vegas_reduce_mixed"], e0, e1)
                rels = [max(rels[0], r0), max(rels[1], r1)]
        del x, gidx, w, wu, relw, m, got, ref
    print(f"phase 3h: {name}, w and m one element off 16-byte alignment (scalar loads at c % 4 == "
          f"0): vegas_relw_mixed (real, complex) bit-equal; vegas_reduce_mixed (real, complex; "
          f"default, given m; mf 1 and {MF}) obs rel {rels[0]:.3g}, hist rel {rels[1]:.3g}")

    # a spec of the uniform route through both routes, at the uniform route's launch
    spec = Spec(mt.Configuration(var=mt.Continuous(0.0, 1.0), dof=[[2]], seed=SEED), "cuda")
    uni = VegasIteration(spec, _pi, block=16, nevalperblock=2 ** 22)
    kd = block_keys(SEED, 2, 0, uni.block)
    inputs = uni.kernel_inputs(spec.device_params(), kd)
    T = min(uni.chunks_per_launch, uni.nchunks)
    x, invp, perm = vk.vegas_sample(t0=0, T=T, m=uni.m_tile, **inputs)
    lay = vk.MixedLayout.build(spec, uni.chunk, {0: uni.atab.cpu().numpy()})
    tab = lay.tables(spec.device_params())
    xm, gm = vk.vegas_sample_mixed(lay, tab, torch.as_tensor(kd.view(np.int32), device="cuda"), 0, T)
    S, B = x.shape[:2]
    _check_bits("the uniform route's x through vegas_sample_mixed", xm, x.reshape(S, B, T, -1))
    _check_bits("the uniform route's strata through vegas_sample_mixed", gm,
                perm.repeat_interleave(uni.m_tile, dim=-1))
    w = uni.evaluate(uni.leaf_values(x))
    obs, hrow = vk.vegas_reduce(w, invp, perm, uni.pad, uni.pair_slots, uni.used)
    obs_m, hist_m = vk.vegas_reduce_mixed(lay, tab, w.reshape(w.shape[0], B, T, -1), gm)
    _, rel = _check_rel("the uniform route's launch through vegas_reduce_mixed", (obs_m, hist_m),
                        (obs, hrow.sum(dim=(1, 2))), REL_TOL_VPLUS)
    print(f"phase 3h: the uniform route's pi launch ({B} blocks x {T} chunks x {uni.chunk} "
          f"samples, {S} slots) through both routes: x and strata bit-equal, obs and histograms "
          f"rel {rel:.3g}")
    return errs


def _z(mean, std, exact):
    """Distance from the exact value in sigma, real parts (and imaginary ones).
    Sigma is at least the exact value times float32's epsilon 2^-23: a
    sample's weight is a float32 product of float32 table entries, so a mean
    cannot be resolved more finely than that, and an integrand whose
    estimator barely varies (1 over a Discrete pool: sigma 4e-11 on 12) would
    otherwise be judged by the rounding of the maps' float32 CDFs and
    masses (3.5e-8 of 12), the reference's law too."""
    mean, std, exact = np.asarray(mean), np.asarray(std), np.asarray(exact)
    std = np.maximum(std.real, np.abs(exact) * 2.0 ** -23) + 1j * std.imag
    z = (mean.real - exact.real) / std.real
    if np.iscomplexobj(mean) and np.any(std.imag > 0):
        z = z + 1j * (mean.imag - exact.imag) / std.imag
    return z


def mixed_main_path(mt, vk, card, rate4):
    """Phase 4h: the mixed route through integrate(solver="vegas",
    device="cuda") at 2^30 evals an iteration, 16 blocks, 10 iterations: the
    Lindhard bubble (its four bins within 20 sigma of lindhard(q),
    tests/test_bubble.py:117, and within 5 sigma of bubble_exact(q), the
    integral at its temperature), the same with type=complex (f + 0j) and
    with measurefreq MF, an adaptive Discrete (t d^2 over
    Discrete(1, 100)), Discrete([(1, 3), (1, 4)]) and mixed ninc (1024 and
    512 stratified, 1000 drawn per sample), each within 5 sigma.  Each run's
    launches counted from 0; its rate beside phase 4's, and its idle share
    from a profile of two iterations.  The complex bubble's real parts
    against the real run's, bit for bit: over one iteration from one state
    (obs; the histograms within REL_TOL_VPLUS, float64 atomics in another
    order, or within 1e-30 where a term underflows in the complex |w|) and
    over the whole runs (means and error bars; the maps train on
    those histograms in float64 and reach the kernels as float32 tables, so
    the atomics' rounding would have to cross a float32 rounding boundary of
    a node to change a sample).  Returns the new kernels' launches summed
    over the runs."""
    import torch
    from mcintegration_tpu_torch.ops.rng import block_keys
    from mcintegration_tpu_torch.solvers.engine import Spec
    from mcintegration_tpu_torch.solvers.vegas import VegasMixedIteration

    niter = 10
    bubble = make_vegas_bubble("cuda")
    bubble_c = lambda v, c: bubble(v, c) + 0j
    lind = [lindhard(q[0]) for q in EXTQ]
    # the bubble's exact value at its temperature; its zero-temperature limit
    # must give lindhard(q), which holds the quadrature
    law = [bubble_exact(q[0]) for q in EXTQ]
    cold = [bubble_exact(q[0], 1e4 * BETA_PHYS) for q in EXTQ]
    if not np.allclose(cold, lind, rtol=1e-10, atol=0.0):
        raise AssertionError(f"phase 4h: bubble_exact's zero-temperature limit {cold} is not "
                             f"lindhard(q) {lind}")
    C = mt.Continuous
    # the bubble: within 20 sigma of lindhard(q), as tests/test_bubble.py:117,
    # and within 5 sigma of its exact value at BETA
    gates = (("lindhard(q)", lind, 20), ("the value at BETA", law, 5))
    # name, integrand, integrate() keywords (fresh pools each call), and per
    # gate: what, exact value, sigmas
    runs = (("bubble", bubble, lambda: vegas_bubble_kw(mt), gates),
            ("bubble, type=complex", bubble_c, lambda: vegas_bubble_kw(mt, True), gates),
            (f"bubble, measurefreq {MF}", bubble,
             lambda: dict(vegas_bubble_kw(mt), measurefreq=MF), gates),
            ("t d^2 over Continuous(0, 1) x Discrete(1, 100)", _td2,
             lambda: dict(var=(C(0.0, 1.0), mt.Discrete(1, 100)), dof=[[1, 1]]),
             (("exact", 338350 / 2, 5),)),
            ("1 over Discrete([(1, 3), (1, 4)])", _one,
             lambda: dict(var=mt.Discrete([(1, 3), (1, 4)]), dof=[[1]]), (("exact", 12.0, 5),)),
            ("log(x)/sqrt(x) y^2 e^z, ninc 1024, 512 and 1000", _logxyz,
             lambda: dict(var=(C(0.0, 1.0, ninc=1024), C(0.0, 1.0, ninc=512),
                               C(0.0, 1.0, ninc=1000)), dof=[[1, 1, 1]]),
             (("exact", -4.0 / 3.0 * (np.e - 1.0), 5),)))
    new = ("vegas_sample_mixed", "vegas_relw_mixed", "vegas_reduce_mixed")
    counts = dict.fromkeys(new, 0)
    results = {}
    for name, f, kw_of, checks in runs:
        kw = kw_of()
        mf = kw.pop("measurefreq", 1)
        fresh = lambda: {a: b for a, b in kw_of().items() if a != "measurefreq"}
        spec = Spec(mt.Configuration(seed=SEED, **{a: b for a, b in kw.items() if a != "measure"}),
                    "cuda")
        shape = VegasMixedIteration(spec, f, measure=kw.get("measure"),
                                    obs_proto=spec.cfg.observable, measurefreq=mf, block=16,
                                    nevalperblock=VEGAS_NEVAL // 16)
        L = niter * shape.launches_per_run
        expected = {**dict.fromkeys(vk.launch_counts, 0), "vegas_sample_mixed": L,
                    "vegas_reduce_mixed": L, "vegas_relw_mixed": L if "measure" in kw else 0}
        vk.reset_launch_counts()
        res = mt.integrate(f, measurefreq=mf, solver="vegas", neval=VEGAS_NEVAL, niter=niter,
                           block=16, device="cuda", seed=SEED, verbose=-2, **fresh())
        got = dict(vk.launch_counts)
        assert res.backend == "cuda" and res.backend_reason == "", res.backend_reason
        assert got == expected, (name, got, expected)
        for q in new:
            counts[q] += got[q]
        mean, std = np.asarray(res.mean[0]), np.asarray(res.stdev[0])
        zs = []
        for what, exact, k in checks:
            assert np.all(np.isfinite(mean)) and mean.shape == np.shape(exact), (mean, exact)
            z = _z(mean, std, exact)
            if not (np.all(np.abs(z.real) < k) and np.all(np.abs(z.imag) < k)):
                raise AssertionError(f"phase 4h: {name}: {mean.tolist()} +- {std.tolist()}, "
                                     f"outside {k} sigma of {what} "
                                     f"{np.asarray(exact).tolist()}: {z.tolist()}")
            zs.append(f"{np.round(z, 2).tolist()} from {what} (gate {k})")
        if mf > 1:
            norm = niter * 16 * (shape.nevalperblock // mf)
            assert res.config.normalization == norm, (res.config.normalization, norm)
        results[name] = res
        evals = [h[2].neval for h in res.iterations]
        steady = sum(evals[1:]) / sum(res.iteration_times[1:])
        print(f"phase 4h: {name}, {niter} iterations of {evals[0]} evals (chunk {shape.chunk}, "
              f"{shape.launches_per_run} launches an iteration, slots of kinds "
              f"{shape.layout.slots[:, 0].tolist()}): {mean.tolist()} +- {std.tolist()}, sigma "
              f"{', '.join(zs)}; launches {dict((q, got[q]) for q in new)}")
        print(f"phase 4h: {name}: steady-state {steady!r} evals/s, {rate4!r} for the uniform "
              f"route's pi (phase 4), ratio {steady / rate4!r} (per-iteration s "
              f"{res.iteration_times}) [{card}]")
        profile_main_path(card, "4h", lambda: mt.integrate(
            f, measurefreq=mf, solver="vegas", neval=VEGAS_NEVAL, niter=2, block=16,
            device="cuda", seed=SEED, verbose=-2, **fresh()),
            ("vegas_sample_mixed", "vegas_reduce_mixed"), top=4)

    # f + 0j against f: one iteration from one state, then the whole runs
    real, cpx = results["bubble"], results["bubble, type=complex"]
    runs1 = []
    for cplx, f in ((False, bubble), (True, bubble_c)):
        kw = vegas_bubble_kw(mt, cplx)
        spec = Spec(mt.Configuration(seed=SEED, **{a: b for a, b in kw.items() if a != "measure"}),
                    "cuda")
        it = VegasMixedIteration(spec, f, measure=kw["measure"], obs_proto=spec.cfg.observable,
                                 block=16, nevalperblock=VEGAS_NEVAL // 16)
        runs1.append(it.run(spec.device_params(), block_keys(SEED, 0, 0, 16)))
    a, b = (r["obs_blocks"][0] for r in runs1)
    if not (np.array_equal(b.real, a) and np.all(b.imag == 0.0)):
        raise AssertionError("phase 4h: the complex bubble's obs differ from the real run's")
    # |w| = sqrt(re*re + im*im) in float32: below |w| ~ 2^-75 the squares
    # underflow, so the bubble's smallest terms, (|w| jac)^2 of about 1e-39,
    # may reach a bin in one run and not in the other
    e_hist = 0.0
    for h1, h2 in zip(runs1[0]["hists"], runs1[1]["hists"]):
        if not np.all(np.abs(h2 - h1) <= REL_TOL_VPLUS * np.abs(h1) + 1e-30):
            raise AssertionError("phase 4h: the complex bubble's histograms differ from the "
                                 "real run's")
        big = np.abs(h1) > 1e-30
        if big.any():
            e_hist = max(e_hist, rel_err(h2[big], h1[big]))
    ma, mb = np.asarray(real.mean[0]), np.asarray(cpx.mean[0])
    sa, sb = np.asarray(real.stdev[0]), np.asarray(cpx.stdev[0])
    if not (np.array_equal(mb.real, ma) and np.array_equal(sb.real, sa) and np.all(mb.imag == 0)):
        raise AssertionError(f"phase 4h: the complex bubble's means {mb.tolist()} +- "
                             f"{sb.tolist()} differ from the real run's {ma.tolist()} +- "
                             f"{sa.tolist()}")
    print(f"phase 4h: the bubble, f + 0j against f: one iteration from one state, obs real parts "
          f"bit-equal and imaginary parts 0, histograms rel {e_hist:.3g} (bins above 1e-30); "
          f"the 10-iteration runs' "
          f"means and error bars bit-equal in their real parts, imaginary means 0")
    return counts


def ptxas_lines(key):
    """ptxas -v's register and spill lines of each kernel whose mangled name
    holds ``key``, from the verbose build of phase 2, each under the
    kernel's name and template arguments (``vplus_reduce_kernel<0,1,0>``:
    real, given m, ungated)."""
    import re
    from mcintegration_tpu_torch.ops import _build
    out, name = [], None
    for line in _build.build_log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
        elif name and key in name and ("registers" in line or "spill" in line):
            args = re.findall(r"L[ib](\d+)E", name)
            label = key + (f"<{','.join(args)}>" if args else "")
            out.append(f"{label}: {line.split(':', 1)[-1].strip()}")
    return out


def mixed_timings(mt, vk, card):
    """Phase 6h: device ms of the mixed route's kernels at phase 4h's bubble
    launch (16 blocks x 32 chunks x 131072 samples, 5 slots), in turns with
    their plain versions (plain, kernel, kernel, plain), beside their bounds
    from the bytes each must move and their ptxas registers; then every
    instantiation of vegas_reduce_mixed and vegas_relw_mixed (real and
    complex weights; default, given m; mf 1 and MF) beside the parent's
    times (PARENT_6H).  Returns each one's (max abs err, ms, plain_ms,
    bound_ms, bound_by)."""
    import torch

    nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)

    def turns(kernel, plain, reps=10):
        k, p = [], []
        for order in ((plain, kernel), (kernel, plain)):
            for fn in order:
                if fn is kernel:
                    k.append(device_ms(kernel, reps))
                else:
                    p.append(time_ms(plain, 2))
        return float(np.mean(k)), float(np.mean(p))

    kw = vegas_bubble_kw(mt)
    it, lay, tab, kd, t0, T, x, gidx, w = mixed_launch(
        mt, kw["var"], kw["dof"], None, VEGAS_NEVAL // 16, 16, None, measure=kw["measure"],
        obs=kw["obs"])
    n, S, N = w[0].numel(), lay.S, w.shape[0]
    out = {}
    e = _check_bits("vegas_sample_mixed at 6h", x, vk.vegas_sample_mixed_plain(lay, tab, kd, t0, T)[0])
    ms, pms = turns(lambda: vk.vegas_sample_mixed(lay, tab, kd, t0, T),
                    lambda: vk.vegas_sample_mixed_plain(lay, tab, kd, t0, T))
    # per sample the hash of its index, per value a lowbias32 round and the
    # mixing (salt, mask), 5 float32 operations (the uniform, the map)
    b = bound(nbytes(x, gidx, tab, lay.meta, lay.atab, kd), 5 * n * S,
              n * (MIX32 + 2) + n * S * (MIX32 + 2))
    out["vegas_sample_mixed"] = (e, ms, pms, *b)
    relw = vk.vegas_relw_mixed(lay, tab, w, gidx)
    e = _check_bits("vegas_relw_mixed at 6h", relw, vk.vegas_relw_mixed_plain(lay, tab, w, gidx))
    ms, pms = turns(lambda: vk.vegas_relw_mixed(lay, tab, w, gidx),
                    lambda: vk.vegas_relw_mixed_plain(lay, tab, w, gidx))
    b = bound(nbytes(w, gidx, tab, lay.meta, relw), n * (S + 2 * N))
    out["vegas_relw_mixed"] = (e, ms, pms, *b)
    m = it.measure(lay.leaf_values(x), relw).contiguous()
    del x, relw
    got = vk.vegas_reduce_mixed(lay, tab, w, gidx, m, 1, t0)
    e0, _ = _check_rel("vegas_reduce_mixed at 6h, obs", got[:1],
                       vk.vegas_reduce_mixed_plain(lay, tab, w, gidx, m, 1, t0)[:1], REL_TOL_REDUCE)
    ms, pms = turns(lambda: vk.vegas_reduce_mixed(lay, tab, w, gidx, m, 1, t0),
                    lambda: vk.vegas_reduce_mixed_plain(lay, tab, w, gidx, m, 1, t0))
    obs_rows = 8 * m.shape[0] * it.block * T * -(-lay.chunk // vk.SPAN) * vk.WARPS
    b = bound(nbytes(w, gidx, m, tab, lay.meta) + obs_rows + 8 * lay.nhist,
              n * (S + 8 * N) + n * m.shape[0])
    out["vegas_reduce_mixed"] = (e0, ms, pms, *b)
    print(f"phase 6h: one launch of the bubble = {it.block} blocks x {T} chunks x {lay.chunk} "
          f"samples ({n} evals, {S} slots, {m.shape[0]} measure components) [{card}]")
    for name, (err, t, pt, bd, by) in out.items():
        print(f"phase 6h: {name} {t!r} ms, plain torch {pt!r} ms, bound {bd!r} ms (by {by}), "
              f"{t / bd!r} times its bound [{card}]")
    # every instantiation of vegas_mixed.cu's reduce at this launch, real and
    # complex weights, beside the parent's times
    times = {}
    for cplx in (False, True):
        if cplx:
            del w, gidx, m
            kw = vegas_bubble_kw(mt, True)
            it, lay, tab, kd, t0, T, x, gidx, w = mixed_launch(
                mt, kw["var"], kw["dof"], None, VEGAS_NEVAL // 16, 16, None, cplx=True,
                measure=kw["measure"], obs=kw["obs"])
            m = it.measure(lay.leaf_values(x), vk.vegas_relw_mixed(lay, tab, w, gidx)).contiguous()
            del x
        kind = "complex" if cplx else "real"
        for mf in (1, MF):
            for given in (None, m):
                times[f"{kind}, {'given m' if given is not None else 'default'}, mf {mf}"] = \
                    device_ms(lambda: vk.vegas_reduce_mixed(lay, tab, w, gidx, given, mf, t0), 10)
        times[f"{kind}, relw"] = device_ms(lambda: vk.vegas_relw_mixed(lay, tab, w, gidx), 10)
    for what, t in times.items():
        print(f"phase 6h: {'vegas_relw_mixed' if what.endswith('relw') else 'vegas_reduce_mixed'} "
              f"{what}: {t!r} ms, the parent's {PARENT_6H[what]!r} ms, ratio "
              f"{t / PARENT_6H[what]!r} [{card}]")
    for key in ("vegas_sample_mixed_kernel", "vegas_reduce_mixed_kernel"):
        for line in ptxas_lines(key):
            print(f"phase 6h: ptxas -v {line}")
    return out


# The parent's device ms per launch of each instantiation that phases 6h and
# 6g time: for 6h, the kernels before vegas_reduce_mixed took four samples a
# thread; for 6g, before the complex default took four chunks at once and
# vplus_relw was a kernel of its own (the mean of the baseline's two runs of
# tools/accept_reduce_variants.py --baseline, run beside the change in one
# call; NVIDIA H100 80GB HBM3, 700.00 W)
PARENT_6H = {"real, default, mf 1": 2.282, "real, given m, mf 1": 2.855,
             "real, default, mf 4": 2.406, "real, given m, mf 4": 2.996, "real, relw": 1.024,
             "complex, default, mf 1": 2.415, "complex, given m, mf 1": 3.579,
             "complex, default, mf 4": 2.533, "complex, given m, mf 4": 3.722,
             "complex, relw": 1.129}
PARENT_6G = {"complex, default, mf 1": 1.862, "complex, default, mf 4": 2.114,
             "real, relw": 0.8198, "complex, relw": 0.8998,
             "real, given m, mf 1": 1.905, "real, given m, mf 4": 2.059,
             "complex, given m, mf 1": 1.969, "complex, given m, mf 4": 2.118}

PEAK_BYTES = 3.35e12    # NVIDIA H100 SXM device memory, bytes/s
# float32 outside the tensor cores, operations/s: the data sheet's, a fused
# multiply-add counted as two (the :mcmc kernels, built with --fmad=false,
# issue none, so for them it is twice their single-issue rate)
PEAK_OPS = 67e12
# INT32, one operation per lane and clock: 132 SMs x 64 lanes x 1.98 GHz
PEAK_INT_OPS = 16.7e12


def bound(nbytes, ops, int_ops=0):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    the operations' time, float32 operations over the float32 rate or
    integer ones over the INT32 rate, whichever is longer (the two pipes
    issue side by side), at the H100 SXM's peaks."""
    tb = float(nbytes) / PEAK_BYTES * 1e3
    to = max(float(ops) / PEAK_OPS, float(int_ops) / PEAK_INT_OPS) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def mcmc_bytes(it, st, after):
    """Bytes each :mcmc kernel must move on step ``st``'s walkers (after
    ``mcmc_propose``; ``after``: the state after ``mcmc_accept``), from the
    roles they drew, the moves accepted and the sectors they sit in: each
    field read once and written once where the kernel touches it.  Returns
    (propose, accept on a measured step, accept on an unmeasured one, the
    measure over every sector's walkers outside the normalization sector)."""
    lay = it.layout
    W, nvar, norm = lay.W, lay.spec.nvar, lay.nd - 1
    role = np.bincount(st.move[0].cpu().numpy(), minlength=5)
    n_role = int(role[1:].sum())
    acc = (after.tally[1] - st.tally[1]).cpu().numpy()   # [CI and NJ, CV, swap, nd, ncol]
    n_acc, n_jump = int(acc.sum()), int(acc[0].sum())
    curr = after.curr.cpu().numpy()
    n_norm = int((curr == norm).sum())
    fields = [lay.fields(d) for d in range(len(lay.dleaf))]
    slot = [4 * f["width"] + 8 for f in fields]       # value rows, gidx and prob
    grp = np.mean([sum(slot[lo:hi]) for lo, hi, _ in lay.groups if hi > lo])
    moved = role[1] + 2 * role[2]                     # slots a CV or a swap touches
    # propose: curr, picv and dof[vi] in, prop and move out; the touched
    # slots in and out (a CI or a jump reads or writes every slot)
    propose = W * 32 + moved * 2 * grp + (role[3] + role[4]) * sum(slot)
    # accept: every walker's role and curr in; a walker with a role also
    # the other move rows, prop, nw, prob, rcur and degc in, and its touched
    # slots copied; an accepted move writes weight and prob, a jump also
    # curr, rcur, degc, picv and its dof row.  A weight (nw, weight, relw)
    # is 4 bytes, 8 when complex
    wsz = 8 if lay.spec.cplx else 4
    accept = (W * 8 + n_role * (28 + wsz) + moved * 2 * grp + role[3] * sum(slot)
              + n_acc * (4 + wsz) + n_jump * (16 + 4 * nvar))
    # a measured step: relw out, with weight (where no move was taken) and
    # prob (walkers without a role) in; or weight and rcur in and obs
    # (float64; two components when complex) in and out outside the
    # normalization sector; there nrm (float64) in and out, elsewhere each
    # adaptive leaf's dof and its used slots' gidx in
    if lay.custom:
        measured = W * wsz + (W - n_acc) * wsz + (W - n_role) * 4
    else:
        measured = (W - n_norm) * (wsz + 4 + 16 * (2 if lay.spec.cplx else 1))
    outside = curr != norm
    for f in fields:
        if f["hist_off"] >= 0:
            used = np.minimum(after.dof[f["group"]].cpu().numpy(), f["ndraw"])
            measured += 4 * int(outside.sum()) + 4 * int(used[outside].sum())
    measured += n_norm * 16
    return propose, accept + measured, accept, measure_bytes(curr, norm, lay.ncomp)


def measure_bytes(curr, N, ncomp):
    """Bytes mcmc_measure must move: curr in; a walker outside the
    normalization sector (``curr < N``) its own sector's m in and obs
    (float64) in and out.  At N = 1 these are the walkers of sector 0."""
    return curr.size * 4 + int((curr < N).sum()) * ncomp * 20


def measure_sector_bytes(curr, N, ncomp):
    """What mcmc_measure moves in whole 32-byte sectors: all of curr; of
    sector i's output, the sectors of its ncomp rows that hold a walker at
    ``curr == i`` (8 walkers a sector); of obs, read and written, the
    sectors that hold a walker outside the normalization sector (4 walkers a
    sector).  Rows start on 32-byte boundaries (W a multiple of 8)."""
    nbytes = curr.size * 4
    for i in range(N):
        nbytes += ncomp * 32 * np.unique(np.flatnonzero(curr == i) // 8).size
    return nbytes + 2 * ncomp * 32 * np.unique(np.flatnonzero(curr < N) // 4).size


L2_FLUSH_BYTES = 2 ** 28    # written between calls: five times the H100's 50 MB L2


def flushed_ms(fn, reps=50, tries=5):
    """(device ms per call of ``fn`` with the L2 cache flushed before each
    call, ms of a flush alone): ``reps`` pairs (zero a buffer of
    ``L2_FLUSH_BYTES``, call) queued behind a sleep kernel, less ``reps``
    flushes alone; medians of ``tries`` turns of the two."""
    import torch
    buf = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")

    def alone():
        for _ in range(reps):
            buf.zero_()

    def both():
        for _ in range(reps):
            buf.zero_()
            fn()

    t_alone, t_both = [], []
    for _ in range(tries):
        t_alone.append(device_ms(alone, 1))
        t_both.append(device_ms(both, 1))
    flush = float(np.median(t_alone)) / reps
    return float(np.median(t_both)) / reps - flush, flush


# Operations, (integer, float32), one per source-level operation of
# csrc/mcmc_*.cu[h]; index arithmetic and table reads are not counted.
MIX32 = 8                   # lowbias32: three shifts, three xors, two multiplies
UNIFORM = (MIX32 + 2, 3)    # counter add, shift; convert, add, multiply
BASE = 3 * MIX32 + 5        # k1 = mix32(kd ^ t*phi), k2 = mix32(kd + t), mix32(j ^ k1) + k2
SINCOS = 23                 # quarter-turn reduction and two cephes polynomials
COUNT = 4                   # a warp-aggregated count: match, first lane, popc, add
RANK = 6                    # a place in the tile sort: match, first lane, add, shuffle, popc
# vegas_sample's draw: i ^ k1, lowbias32, + (k2 + salt), lowbias32, & 0xFFFFFF
VEGAS_DRAW_INT = 2 * MIX32 + 3
# chain_accept per walker: its keys and base (BASE) and the accept uniform,
# integer; about 41 float32 operations (the pair products, the joint
# density, the decision, the histogram weight)
ACCEPT_OPS = (BASE + UNIFORM[0], 41)


def _draw_ops(f):
    """(integer, float32) operations of drawn leaf f's fresh draw."""
    if f["kind"] == 2:                                   # FermiK: shell draw
        n = 3 if f["nb"] == 3 else 2
        return n * UNIFORM[0], n * UNIFORM[1] + 3 + (2 * SINCOS + 12 if n == 3 else SINCOS + 6)
    if f["kind"] == 1:                                   # Discrete: binary search
        levels = int(np.ceil(np.log2(f["nb"] + 1)))
        return UNIFORM[0] + 3 * levels, UNIFORM[1] + levels
    return UNIFORM[0] + 1, UNIFORM[1] + 6                # Continuous: one gather


def propose_ops(lay):
    """(integer, float32) operations of one chain_propose step over the
    layout's walkers: each walker's base mix32(j ^ k1) + k2 (the keys k1, k2
    are the same for every walker of a Monte Carlo block at a step, so the
    least work forms them once a block: not counted), the uniforms of its
    group and slot and their selects, and the draw of each leaf of its
    group (a group drawn with probability 1/nelig), with the old
    probability's division and the product."""
    ints, flts = [], []
    for g in lay.elig:
        lo, hi, _ = (int(v) for v in lay.groups[g])
        ops = [_draw_ops({"kind": int(lay.leaf[d, 0]), "nb": int(lay.leaf[d, 1])})
               for d in range(lo, hi)]
        ints.append(sum(o[0] for o in ops))
        flts.append(sum(o[1] + 2 for o in ops))
    per_int = MIX32 + 2 + 2 * UNIFORM[0] + float(np.mean(ints))
    per_flt = 2 * UNIFORM[1] + 4 + float(np.mean(flts))
    return per_int * lay.W, per_flt * lay.W


def mcmc_ops(it, mk, kd, sched, t, st, after):
    """(integer, float32) operations each :mcmc kernel does on step ``t``'s
    walkers, from the roles, var groups, FermiK shift branches and slot
    counts this step's data takes (``st`` after ``mcmc_propose``, ``after``
    after ``mcmc_accept``): (propose, accept on a measured step, accept on
    an unmeasured one)."""
    lay = it.layout
    W, nvar, norm, fermi = lay.W, lay.spec.nvar, lay.nd - 1, 2
    role, vi = st.move[0].cpu().numpy(), st.move[1].cpu().numpy()
    jt = mk._walker_sched(lay, sched, t)[0].long()
    dof = st.dof.cpu().numpy()
    dof_j = lay.dof_t[jt].T.cpu().numpy()                # [nvar, W]
    base = mk._walker_base(lay, kd, t)
    n_u = 2 + (nvar > 1) + int(lay.any_swap)             # role, (vi), slot 1, (slot 2)
    n_role = int((role > 0).sum())
    pi = W * (BASE + n_u * UNIFORM[0]) + n_role * RANK
    pf = W * (n_u * UNIFORM[1] + 8)
    for d in range(len(lay.dleaf)):
        f = lay.fields(d)
        g, md, dim = f["group"], int(lay.groups[f["group"], 2]), f["nb"]
        cv = (role == 1) & (vi == g)
        di, df = _draw_ops(f)
        if f["kind"] == fermi:                           # three-way shift
            sel = mk._uniforms(base, [mk.SALT_SHIFT + 8 * d])[0].cpu().numpy()
            nu = 3 + f["width"]
            pi += cv.sum() * nu * UNIFORM[0]
            pf += cv.sum() * (nu * UNIFORM[1] + 3)
            rot = 2 * dim + SINCOS + (13 if dim == 3 else 2)
            pf += np.where(sel < 1 / 3, dim, np.where(sel < 2 / 3, rot, 3 * dim))[cv].sum()
        else:
            pi += cv.sum() * di
            pf += cv.sum() * (df + 2)
        dens = (19 if dim == 3 else 9) if f["kind"] == fermi else 0
        dc, dj = dof[g], np.minimum(dof_j[g], md)
        created = np.where(role == 3, np.maximum(dj - dc, 0), 0)
        removed = np.where(role == 3, np.maximum(dc - dj, 0), np.where(role == 4, dc, 0))
        pi += (created * di).sum()
        pf += (created * (df + 3)).sum() + (removed * (dens + 1)).sum()
    # accept: every walker's visit count; a walker with a role: its base,
    # the accept uniform, its place in the sort, |nw|, two products, its
    # role's test and the propose tally's count; an accepted move its count
    acc = (after.tally[1].sum() - st.tally[1].sum()).item()
    ai = W * COUNT + n_role * (BASE + UNIFORM[0] + RANK + COUNT) + acc * COUNT
    # a complex |nw| is two products, a sum and a square root, not one fabs
    af = n_role * (UNIFORM[1] + (6 if lay.spec.cplx else 3)) + (np.array([0, 4, 2, 6, 5])[role]).sum()
    af += 2 * int(((role >= 3) & (after.curr != st.curr).cpu().numpy()).sum())
    in_norm = (after.curr == norm).cpu().numpy()
    hist_slots = sum(np.minimum(after.dof[f["group"]].cpu().numpy(), f["ndraw"])
                     for f in map(lay.fields, range(len(lay.dleaf))) if f["hist_off"] >= 0)
    mi = int(np.where(in_norm, 0, hist_slots).sum())
    # the measurement: relw = w/prob (a complex w: one more product), or
    # sign(w)/rcur (a complex w: |w|, 1/|w| and four products)
    per = (4 if lay.custom else 11) if lay.spec.cplx else (3 if lay.custom else 5)
    mf = int((~in_norm).sum()) * per + 2 * int(in_norm.sum())
    return (pi, pf), (ai + mi, af + mf), (ai, af)


def mcmc_timings(mt, mk, card):
    """Phase 6c: device time per call of each :mcmc kernel at the main path's
    shape (the bubble, 2^18 walkers), in turns with its plain version;
    ``mcmc_accept`` on a measured and on an unmeasured step, and their mean
    weighted by the launches of an iteration; the integrand and the measure;
    the whole step on the device and as the host issues it; the bounds from
    this step's bytes and operations."""
    import torch
    from mcintegration_tpu_torch.ops.mcmc_kernels import NRETRY
    from mcintegration_tpu_torch.ops.rng import block_keys
    from mcintegration_tpu_torch.solvers.engine import Spec
    from mcintegration_tpu_torch.solvers.mcmc import MCMCIteration

    kw = bubble_kw(mt)
    cfg = mt.Configuration(var=kw["var"], dof=kw["dof"], obs=kw["obs"], seed=SEED)
    it = MCMCIteration(Spec(cfg, "cuda"), make_bubble("cuda"), measure=_bubble_measure,
                       obs_proto=kw["obs"], block=16, nevalperblock=2 ** 28 // 16,
                       nwalkers=2 ** 18, thermal_ratio=BUBBLE_THERMAL)
    lay = it.layout
    assert (lay.hist_smem, lay.cnt_smem) == (True, True)
    kd_np = block_keys(SEED, 0, 0, it.block)
    sched, groups = it.schedule(kd_np)
    kd = it.seeds(kd_np)
    tab, rw, st = it.start(it.spec.device_params(), kd, sched)
    for t in range(400):                     # past the start, so every role occurs
        it.step(tab, rw, kd, sched, groups[t], st, t)
    errs = mcmc_one_step(it, mk, st, tab, rw, kd, sched, groups[400], 400,
                         "at the main path's shape")
    errs_u = mcmc_one_step(it, mk, st, tab, rw, kd, sched, groups[401], 401,
                           "at the main path's shape, unmeasured", measure=False)
    T = 402
    nw = it.weights(st, groups[T])
    vals = lay.leaf_values(st.cur_val)
    m = it.measure[0](vals, st.relw).contiguous()
    mk.mcmc_propose(lay, tab, kd, sched, T, st)
    after = st.clone()
    mk.mcmc_accept(lay, tab, rw, kd, sched, T, after, nw, measure=True)
    nbytes = mcmc_bytes(it, st, after)
    ops = mcmc_ops(it, mk, kd, sched, T, st, after)
    del after

    # the plain versions wait for the device (their role guards read masks on
    # the host), so they are timed on the host's clock, the kernels on the
    # device's with the calls queued behind a sleep kernel
    keys = ("propose", "accept", "accept_u", "measure")
    ms = {k + sfx: [] for k in keys for sfx in ("", "_plain")}
    for order in (("plain", "kernel"), ("kernel", "plain")):
        for kind in order:
            sfx, timer, reps = ("", device_ms, 20) if kind == "kernel" else ("_plain", time_ms, 5)
            prop = getattr(mk, "mcmc_propose" + sfx)
            acc = getattr(mk, "mcmc_accept" + sfx)
            meas = getattr(mk, "mcmc_measure" + sfx)
            ms["propose" + sfx].append(timer(lambda: prop(lay, tab, kd, sched, T, st), reps))
            ms["accept" + sfx].append(timer(
                lambda: acc(lay, tab, rw, kd, sched, T, st, nw, measure=True), reps))
            ms["accept_u" + sfx].append(timer(
                lambda: acc(lay, tab, rw, kd, sched, T, st, nw, measure=False), reps))
            ms["measure" + sfx].append(timer(lambda: meas(lay, [m], st), reps))
    ms = {k: float(np.mean(v)) for k, v in ms.items()}
    ms_flushed, ms_flush = flushed_ms(lambda: mk.mcmc_measure(lay, [m], st))
    sector_bytes = measure_sector_bytes(st.curr.cpu().numpy(), lay.spec.N, lay.ncomp)
    # few calls at a time behind the sleep kernel: a step issues about 60
    # launches, and the host blocks once about a thousand are pending
    ms_integrand = device_ms(lambda: it.weights(st, groups[T + 1]), 5)
    ms_measure_fn = device_ms(lambda: it.measure[0](vals, st.relw), 10)
    ms_step_dev = device_ms(lambda: it.step(tab, rw, kd, sched, groups[T + 1], st, T + 1), 5)
    ms_step = time_ms(lambda: it.step(tab, rw, kd, sched, groups[T + 1], st, T + 1), 20)
    # launches of an iteration: measured steps, and unmeasured ones (burn-in
    # and the start's draw and retries)
    n_m, n_u = it.nsteps, it.nburnin + NRETRY + 1
    mean = lambda a, b: (n_m * a + n_u * b) / (n_m + n_u)
    print(f"phase 6c: one step = {lay.W} walkers x {lay.S} slots ({lay.V} value rows); device "
          f"time per call, calls queued behind a sleep kernel [{card}]")
    print(f"phase 6c: mcmc_propose {ms['propose']!r} ms/step, plain torch "
          f"{ms['propose_plain']!r} ms (host clock) [{card}]")
    print(f"phase 6c: mcmc_accept {ms['accept']!r} ms/measured step, {ms['accept_u']!r} "
          f"ms/unmeasured step, {mean(ms['accept'], ms['accept_u'])!r} ms weighted by the "
          f"{n_m} measured and {n_u} unmeasured launches of an iteration; plain torch "
          f"{ms['accept_plain']!r} and {ms['accept_u_plain']!r} ms (host clock) [{card}]")
    print(f"phase 6c: mcmc_measure {ms['measure']!r} ms/step with L2 warm (the same inputs "
          f"back to back), {ms_flushed!r} ms with L2 flushed before each call (less the "
          f"flush's own {ms_flush!r} ms); plain torch {ms['measure_plain']!r} ms (host "
          f"clock) [{card}]")
    print(f"phase 6c: mcmc_measure moves {sector_bytes} bytes in whole 32-byte sectors, "
          f"{sector_bytes / PEAK_BYTES * 1e3!r} ms at 3.35 TB/s")
    print(f"phase 6c: integrand (torch) {ms_integrand!r} ms/step, custom measure (torch) "
          f"{ms_measure_fn!r} ms/measured step [{card}]")
    print(f"phase 6c: whole measured step on the device {ms_step_dev!r} ms; as the host "
          f"issues it {ms_step!r} ms, {lay.W / ms_step * 1e3!r} evals/s [{card}]")
    bounds = {}
    for name, nb_, (oi, of) in (("mcmc_propose", nbytes[0], ops[0]),
                                ("mcmc_accept measured", nbytes[1], ops[1]),
                                ("mcmc_accept unmeasured", nbytes[2], ops[2]),
                                ("mcmc_measure", nbytes[3], (0, 2 * lay.W * lay.ncomp))):
        bounds[name] = bound(nb_, of, oi)
        print(f"phase 6c: {name} bound {bounds[name][0]!r} ms ({nb_:.0f} bytes, {oi:.0f} "
              f"integer and {of:.0f} float32 operations; by {bounds[name][1]})")
    b_acc = mean(bounds["mcmc_accept measured"][0], bounds["mcmc_accept unmeasured"][0])
    print(f"phase 6c: mcmc_accept bound weighted by launches {b_acc!r} ms")
    measure_two_sectors(mt, mk, card)
    return {"mcmc_propose": (errs[0], ms["propose"], ms["propose_plain"],
                             *bounds["mcmc_propose"]),
            "mcmc_accept": (max(errs[1], errs_u[1]), mean(ms["accept"], ms["accept_u"]),
                            mean(ms["accept_plain"], ms["accept_u_plain"]), b_acc,
                            bounds["mcmc_accept measured"][1]),
            "mcmc_measure": (errs[2], ms["measure"], ms["measure_plain"],
                             *bounds["mcmc_measure"])}


def allbranch_measure_inputs(mt, W=2 ** 20, steps=64):
    """Phase 3c's spec at ``W`` walkers after ``steps`` steps: (iteration,
    state, the custom measure's output of each sector on that state)."""
    from mcintegration_tpu_torch.ops.rng import block_keys

    it = mcmc_allbranch(mt, W)
    kd_np = block_keys(SEED, 0, 0, it.block)
    sched, groups = it.schedule(kd_np)
    kd = it.seeds(kd_np)
    tab, rw, st = it.start(it.spec.device_params(), kd, sched)
    for t in range(steps):
        it.step(tab, rw, kd, sched, groups[t], st, t)
    vals = it.layout.leaf_values(st.cur_val)
    return it, st, [m(vals, st.relw).contiguous() for m in it.measure]


def measure_two_sectors(mt, mk, card):
    """Phase 6c: mcmc_measure at phase 3c's spec (N = 2, 2^20 walkers, two
    components an integrand), one launch for both sectors after 64 steps,
    with L2 warm and flushed, beside its bound and its bytes in whole
    sectors."""
    import torch

    it, st, ms = allbranch_measure_inputs(mt)
    lay = it.layout
    ref = st.clone()
    before = mk.launch_counts["mcmc_measure"]
    mk.mcmc_measure(lay, ms, st)
    assert mk.launch_counts["mcmc_measure"] == before + 1
    mk.mcmc_measure_plain(lay, ms, ref)
    torch.cuda.synchronize()
    state_bits_equal(st, ref, "mcmc_measure at phase 3c's spec", hist_rel=0.0)
    warm = float(np.median([device_ms(lambda: mk.mcmc_measure(lay, ms, st), 20)
                            for _ in range(3)]))
    flushed, _ = flushed_ms(lambda: mk.mcmc_measure(lay, ms, st))
    curr = st.curr.cpu().numpy()
    nbytes = measure_bytes(curr, lay.spec.N, lay.ncomp)
    sector_bytes = measure_sector_bytes(curr, lay.spec.N, lay.ncomp)
    shares = (np.bincount(curr, minlength=lay.nd) / curr.size).round(4).tolist()
    print(f"phase 6c: mcmc_measure at phase 3c's spec ({lay.W} walkers, {lay.spec.N} sectors, "
          f"{lay.ncomp} components; sector shares {shares}, the last the normalization's), "
          f"one launch, bit-equal: {warm!r} ms with L2 warm, {flushed!r} ms flushed; bound "
          f"{bound(nbytes, 0)[0]!r} ms ({nbytes} bytes), {sector_bytes} bytes in whole "
          f"32-byte sectors, {sector_bytes / PEAK_BYTES * 1e3!r} ms at 3.35 TB/s [{card}]")


# ---------------------------------------------------------------------------
# debug=True, the iteration cache and ranks (phase 8)
# ---------------------------------------------------------------------------

def _pi_idx(i, x, c):
    return _pi(x, c)


def _pi_inf(x, c):
    """pi's integrand with inf on every sample of x > 0.5."""
    import torch
    return torch.where(x[0] > 0.5, torch.inf, _pi(x, c))


def _inf_measure(x, relw, c):
    """relw[0], inf on every sample of x > 0.5."""
    import torch
    return [torch.where(x[0] > 0.5, torch.inf, 1.0) * relw[0]]


def _run_numbers(res) -> list:
    """A run's means and error bars, of every iteration and in all."""
    out = [np.asarray(x) for m, s, _ in res.iterations for x in (m, s)]
    return out + [np.asarray(res.mean), np.asarray(res.stdev)]


def _run_diff(a, b) -> float:
    return max(float(np.max(np.abs(x - y))) for x, y in zip(_run_numbers(a), _run_numbers(b)))


def _agrees(phase, name, ref, ref2, got, what, card):
    """``got`` against ``ref`` at the agreement of two runs of ``ref``'s
    call: at most 4 times their largest difference (float64 atomics on the
    card make a run's histograms, and so its training, vary in the last
    bits), and bit for bit where the two runs are."""
    tol, d = _run_diff(ref, ref2), _run_diff(ref, got)
    print(f"phase {phase}: {name}: two runs of one seed agree to {tol!r}; {what} differs "
          f"from the first by {d!r} [{card}]")
    assert d <= 4 * tol, (name, what, d, tol)


def debug_checks(mt, card):
    """Phase 8a: debug=True on the card leaves each solver's result as two
    debug=False runs of its seed agree; the probe's TypeError; an integrand
    with inf at known samples warns (its values zeroed by the guard), a
    measure with inf there writes the non-finite line."""
    import contextlib
    import io
    import warnings

    def run(f, solver, **kw):
        return mt.integrate(f, var=mt.Continuous(0.0, 1.0), dof=kw.pop("dof", [[2]]),
                            neval=2 ** 24, niter=3, block=16, solver=solver, device="cuda",
                            seed=SEED, verbose=-2, cache=False, **kw)

    for solver in ("vegas", "vegasmc", "mcmc", "vegasplus"):
        f = _pi_idx if solver == "mcmc" else _pi
        a, b = run(f, solver), run(f, solver)
        c = run(f, solver, debug=True)
        assert abs(float(c.mean[0]) - np.pi / 4) < 5 * float(c.stdev[0])
        _agrees("8a", solver, a, b, c, "debug=True", card)
    try:
        run(lambda x, c: (x[0], x[1]), "vegas", debug=True)
        raise AssertionError("a wrong-count integrand ran under debug=True")
    except TypeError as e:
        assert "wrong number of weights (expected 1)" in str(e), e
        print(f"phase 8a: wrong count: TypeError: {e}")
    with warnings.catch_warnings(record=True) as ws:
        warnings.simplefilter("always")
        res = run(_pi_inf, "vegas", debug=True)
    msgs = [str(w.message) for w in ws if "non-finite weights" in str(w.message)]
    exact = float(np.sqrt(3) / 8 + np.pi / 12)          # the quarter disc at x <= 0.5
    assert msgs and abs(float(res.mean[0]) - exact) < 5 * float(res.stdev[0]), (msgs, res.mean)
    print(f"phase 8a: inf at x > 0.5: the probe warns ({msgs[0]!r}); the guard zeroes "
          f"them: {float(res.mean[0])!r} +- {float(res.stdev[0])!r} (exact {exact!r})")
    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        run(lambda x, c: x[0], "vegas", dof=[[1]], obs=[0.0], measure=_inf_measure,
            debug=True)
    lines = [ln for ln in buf.getvalue().splitlines() if "non-finite" in ln]
    assert len(lines) == 3 and "iteration 0: non-finite observable statistics" in lines[0], \
        buf.getvalue()
    print(f"phase 8a: a measure with inf at x > 0.5 writes {lines[0]!r}")


def cache_timings(mt, card):
    """Phase 8b: at the main paths' widths (phases 4-4d, one iteration), a
    fresh build's, a hit's and cache=False's seconds: the call's set-up (up
    to its first iteration's seeds), the build within it and the whole call;
    a hit's result against a fresh build's."""
    import torch
    import mcintegration_tpu_torch.main as tmain

    marks = {}
    build, keys = tmain._build_iteration, tmain.block_keys

    def timed_build(*args, **kw):
        t = time.perf_counter()
        it = build(*args, **kw)
        marks["build"] = time.perf_counter() - t
        return it

    def first_keys(*args):
        marks.setdefault("setup", time.perf_counter() - marks["start"])
        return keys(*args)

    bubble = make_bubble("cuda")
    cases = {
        "vegas": lambda **kw: mt.integrate(
            _pi, var=mt.Continuous(0.0, 1.0), dof=[[2]], neval=2 ** 30, block=16,
            solver="vegas", **kw),
        "vegasmc": lambda **kw: mt.integrate(
            _pi, var=mt.Continuous(0.0, 1.0), dof=[[2]], neval=2 ** 28, block=16,
            solver="vegasmc", nwalkers=2 ** 20, **kw),
        "mcmc": lambda **kw: mt.integrate(bubble, neval=2 ** 28, nwalkers=2 ** 18,
                                          **bubble_kw(mt), **kw),
        "vegasplus": lambda **kw: mt.integrate(
            _sing3, var=mt.Continuous(0.0, np.pi),
            **{**SING3_KW, "device": "cuda", "seed": SEED, "verbose": -2}, **kw),
    }
    tmain._build_iteration, tmain.block_keys = timed_build, first_keys
    try:
        for name, call in cases.items():
            mt.clear_kernel_cache()
            out, res = {}, {}
            for label, kw in (("fresh", {}), ("hit", {}), ("cache=False", {"cache": False})):
                marks.clear()
                torch.cuda.synchronize()
                marks["start"] = time.perf_counter()
                res[label] = call(niter=1, device="cuda", seed=SEED, verbose=-2, **kw) \
                    if name != "vegasplus" else call(niter=1, **kw)
                torch.cuda.synchronize()
                out[label] = (marks["setup"], marks.get("build", 0.0),
                              time.perf_counter() - marks["start"])
            assert len(tmain._KERNEL_CACHE) == 1
            _agrees("8b", name, res["fresh"], res["cache=False"], res["hit"], "a hit", card)
            print(f"phase 8b: {name}: set-up / build / call seconds: " + "; ".join(
                f"{k} {v[0]!r} / {v[1]!r} / {v[2]!r}" for k, v in out.items()) + f" [{card}]")
    finally:
        tmain._build_iteration, tmain.block_keys = build, keys
        mt.clear_kernel_cache()


RANKS_KW = dict(dof=[[2]], neval=2 ** 30, niter=3, block=16, solver="vegas", device="cuda",
                seed=SEED, verbose=-2, debug=True)


def _ranks_run(mt, **kw):
    """:vegas on pi at RANKS_KW, with iteration 0's statistics after the
    reduce (seen by debug's check)."""
    import mcintegration_tpu_torch.main as tmain
    seen, check = [], tmain.check_iteration_stats
    tmain.check_iteration_stats = lambda stats, it: (seen.append(stats), check(stats, it))[1]
    try:
        res = mt.integrate(_pi, var=mt.Continuous(0.0, 1.0), **RANKS_KW, **kw)
    finally:
        tmain.check_iteration_stats = check
    return res, np.asarray(seen[0]["obs_blocks"]), np.asarray(seen[0]["norm_blocks"])


def rank_worker(rank: int, world: int, port: int, out: str):
    """One rank of phase 8c, in a process of its own."""
    import pickle
    import torch
    import mcintegration_tpu_torch as mt
    from mcintegration_tpu_torch.main import _resolve_device
    mt.init_distributed(f"127.0.0.1:{port}", world, rank)
    res, obs0, norm0 = _ranks_run(mt)
    with open(out, "wb") as fh:
        pickle.dump({"numbers": _run_numbers(res), "obs0": obs0, "norm0": norm0,
                     "mean": float(res.mean[0]), "stdev": float(res.stdev[0]),
                     "device": str(_resolve_device("cuda", mt.default_mesh())),
                     "world": world}, fh)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def ranks_on_card(mt, card):
    """Phase 8c: two processes on cuda:0, a gloo group for the statistics,
    each running 8 of :vegas' 16 blocks on pi at 2^30 an iteration; one rank
    in a process group where the card takes one process."""
    import os
    import pickle
    import socket
    import tempfile
    from pathlib import Path

    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    world = 2 if mode == "Default" else 1
    print(f"phase 8c: compute mode {mode}: {world} rank(s) on cuda:0")
    (one, obs_a, norm_a), (_, obs_b, norm_b) = _ranks_run(mt), _ranks_run(mt, cache=False)
    agree = float(np.max(np.abs(obs_a - obs_b)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, "-c", f"import chip_smoke as c; c.rank_worker({r}, {world}, "
                                   f"{port}, {str(Path(tmp) / f'rank{r}.pkl')!r})"],
            cwd=root, env={**os.environ, "LOCAL_RANK": str(r)}, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
        try:
            logs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = [f"rank {r} exited with {p.returncode}:\n{log}"
                  for r, (p, log) in enumerate(zip(procs, logs)) if p.returncode != 0]
        assert not failed, "\n".join(failed)
        ranks = []
        for r in range(world):
            with open(Path(tmp) / f"rank{r}.pkl", "rb") as fh:
                ranks.append(pickle.load(fh))
    for r, got in enumerate(ranks):
        assert all(np.array_equal(x, y) for x, y in zip(got["numbers"], ranks[0]["numbers"])), \
            f"rank {r}'s Result differs from rank 0's"
        assert got["device"] in ("cuda:0", "cuda"), got["device"]    # "cuda": one rank
    got = ranks[0]
    d = float(np.max(np.abs(got["obs0"] - obs_a)))
    assert got["obs0"].shape == obs_a.shape == (16, 1)
    assert d <= 4 * agree and np.array_equal(got["norm0"], norm_a), (d, agree)
    assert abs(got["mean"] - np.pi / 4) < 5 * got["stdev"], got
    print(f"phase 8c: {world} rank(s) on {got['device']} return the same Result bit for bit: "
          f"{got['mean']!r} +- {got['stdev']!r} (one rank {float(one.mean[0])!r} +- "
          f"{float(one.stdev[0])!r}); iteration 0's per-block observables differ from the "
          f"one-rank run's by {d!r}, two one-rank runs by {agree!r} [{card}]")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    card = card_line()                                        # phase 1
    print(f"phase 1: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    import mcintegration_tpu_torch as mt
    from mcintegration_tpu_torch.ops import (_build, chain_kernels as ck, mcmc_kernels as mk,
                                             vegas_kernels as vk, vplus_kernels as vp)

    t0 = time.perf_counter()                                  # phase 2
    _build.load(verbose=True)
    print(f"phase 2: kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds} s, one process per source) from "
          f"{_build.library_path().name}")

    if "--burnin-scan" in sys.argv[1:]:
        burnin_scan(mt, card)
        return 0

    def timed(phase, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"phase {phase}: {time.perf_counter() - t:.1f} s")
        return out

    timed("3", kernel_vs_plain, mt, vk, card)
    timed("3b", chain_vs_plain, mt, ck, card)
    mcmc_errs = timed("3c", mcmc_vs_plain, mt, mk, card)
    timed("3d", vplus_vs_plain, mt, vp, card)
    measure_errs = timed("3e", measure_vs_plain, mt, vk, ck, card)
    complex_errs = timed("3f", complex_vs_plain, mt, ck, mk, card)
    measurement_errs = timed("3g", measurement_vs_plain, mt, vk, vp, card)
    mixed_errs = timed("3h", mixed_vs_plain, mt, vk, card)
    counts, shape, rate4 = timed("4", main_path, mt, vk, card)
    chain_counts, rate4b = timed("4b", chain_main_path, mt, ck, card)
    counts.update(chain_counts)
    mcmc_counts, rate4c = timed("4c", mcmc_main_path, mt, mk, card)
    counts.update(mcmc_counts)
    vcounts, vshape, rate4d = timed("4d", vplus_main_path, mt, vp, card)
    counts.update(vcounts)
    counts.update(timed("4e", measure_main_path, mt, vk, ck, card, {"4": rate4, "4b": rate4b}))
    counts.update(timed("4f", complex_main_path, mt, ck, mk, card,
                        {"4b": rate4b, "4c": rate4c}))
    timed("4f", complex_cost, mt, card)
    counts.update(timed("4g", measurement_main_path, mt, vk, vp, card,
                        {"4": rate4, "4d": rate4d}))
    counts.update(timed("4h", mixed_main_path, mt, vk, card, rate4))
    timed("5", adaptive_checks, mt)
    timed("5b", chain_checks, mt)
    timed("5c", mcmc_checks, mt)
    timed("5d", vplus_checks, mt)
    measured = timed("6", timings, mt, vk, shape, card)
    measured.update(timed("6b", chain_timings, mt, ck, card))
    mcmc_errs = dict(zip(("mcmc_propose", "mcmc_accept", "mcmc_measure"), mcmc_errs))
    for name, (err, *times) in timed("6c", mcmc_timings, mt, mk, card).items():
        measured[name] = (max(err, mcmc_errs[name]), *times)
    measured.update(timed("6d", vplus_timings, mt, vp, vshape, card))
    for name, times in timed("6e", measure_timings, mt, vk, ck, card).items():
        measured[name] = (measure_errs[name], *times)
    for name, (err, *times) in timed("6f", complex_timings, mt, ck, mk, card).items():
        measured[name] = (max(err, complex_errs[name]), *times)
    for name, (err, *times) in timed("6g", measurement_timings, mt, vk, vp, card).items():
        measured[name] = (max(err, measurement_errs[name]), *times)
    for name, (err, *times) in timed("6h", mixed_timings, mt, vk, card).items():
        measured[name] = (max(err, mixed_errs[name]), *times)
    common = dict(dof=[[2]], block=16, device="cuda", seed=SEED, verbose=-2, niter=3)
    for phase, kw in (("7", dict(neval=2 ** 30, solver="vegas", **common)),
                      ("7b", dict(neval=2 ** 28, solver="vegasmc", nwalkers=2 ** 20, **common))):
        res = timed(phase, profile_main_path, card, phase, lambda: mt.integrate(
            _pi, var=mt.Continuous(0.0, 1.0), **kw))
        assert abs(float(res.mean[0]) - np.pi / 4) < 5 * float(res.stdev[0])
    # one iteration, not three: its 2059 steps issue about 130,000 launches,
    # and the profiler took 206 s to parse three iterations' events
    timed("7c", profile_main_path, card, "7c", lambda: mt.integrate(
        make_bubble("cuda"), neval=2 ** 28, nwalkers=2 ** 18, niter=1, device="cuda", seed=SEED,
        verbose=-2, **bubble_kw(mt)),
          ("mcmc_propose_kernel", "mcmc_accept_kernel", "mcmc_measure_kernel"))

    res = timed("7d", profile_main_path, card, "7d", lambda: mt.integrate(
        _sing3, var=mt.Continuous(0.0, np.pi), niter=2, **SING3_KW))
    assert abs(float(res.mean[0]) - SING3_EXACT) < 5 * float(res.stdev[0])
    timed("8a", debug_checks, mt, card)
    timed("8b", cache_timings, mt, card)
    timed("8c", ranks_on_card, mt, card)

    replaces = {"vegas_sample": "mcintegration_tpu/ops/pallas_vegas.py:343",
                "vegas_reduce": "mcintegration_tpu/ops/pallas_vegas.py:343",
                "chain_propose": "mcintegration_tpu/ops/pallas_chain.py:410",
                "chain_accept": "mcintegration_tpu/ops/pallas_chain.py:410",
                "mcmc_propose": "mcintegration_tpu/ops/pallas_mcmc.py:476",
                "mcmc_accept": "mcintegration_tpu/ops/pallas_mcmc.py:476",
                "mcmc_measure": "mcintegration_tpu/ops/pallas_mcmc.py:476",
                "vplus_sample": "mcintegration_tpu/ops/pallas_vplus.py:156",
                "vplus_reduce": "mcintegration_tpu/ops/pallas_vplus.py:156",
                "chain_measure": "mcintegration_tpu/ops/pallas_chain.py:410",
                "vegas_relw": "mcintegration_tpu/ops/pallas_vegas.py:343",
                "vegas_reduce_measure": "mcintegration_tpu/ops/pallas_vegas.py:343",
                "chain_accept_complex": "mcintegration_tpu/ops/pallas_chain.py:410",
                "mcmc_accept_complex": "mcintegration_tpu/ops/pallas_mcmc.py:476",
                "vegas_reduce_complex": "mcintegration_tpu/ops/pallas_vegas.py:343",
                "vegas_relw_complex": "mcintegration_tpu/ops/pallas_vegas.py:343",
                "vplus_reduce_complex": "mcintegration_tpu/ops/pallas_vplus.py:156",
                "vplus_relw": "mcintegration_tpu/ops/pallas_vplus.py:156",
                "vplus_reduce_measure": "mcintegration_tpu/ops/pallas_vplus.py:156",
                "vegas_sample_mixed": "mcintegration_tpu/ops/pallas_vegas.py:343",
                "vegas_reduce_mixed": "mcintegration_tpu/ops/pallas_vegas.py:343",
                "vegas_relw_mixed": "mcintegration_tpu/ops/pallas_vegas.py:343"}
    # vegas_relw and vegas_reduce's measure mode are entry points of vegas_reduce.cu,
    # the complex accept kernels instantiations of chain_accept.cu and mcmc_accept.cu;
    # the complex, relw and measure entries of the stratified solvers are those of
    # vegas_reduce.cu and vplus_reduce.cu (the XLA routes of the reference, which the
    # TPU kernels K1 and K4 never serve); the mixed route's three entry points
    # (Discrete pools and pools of different ninc on :vegas, the reference's XLA
    # route again) are those of vegas_mixed.cu
    sources = {"vegas_relw": "vegas_reduce", "vegas_reduce_measure": "vegas_reduce",
               "chain_accept_complex": "chain_accept", "mcmc_accept_complex": "mcmc_accept",
               "vegas_reduce_complex": "vegas_reduce", "vegas_relw_complex": "vegas_reduce",
               "vplus_reduce_complex": "vplus_reduce", "vplus_relw": "vplus_reduce",
               "vplus_reduce_measure": "vplus_reduce", "vegas_sample_mixed": "vegas_mixed",
               "vegas_reduce_mixed": "vegas_mixed", "vegas_relw_mixed": "vegas_mixed"}
    kernels = []
    for name, where in replaces.items():
        err, ms, plain_ms, bound_ms, bound_by = measured[name]
        # no single PyTorch call computes any of these functions: library_ms null
        kernels.append({"name": name, "route": "cuda",
                        "source": f"mcintegration_tpu_torch/csrc/{sources.get(name, name)}.cu",
                        "replaces": where, "launches": counts[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
