"""Smoke test of the PyTorch port (mcintegration_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``mcintegration_tpu_torch/csrc``
with nvcc and drives both ported paths on the card.

- :vegas (phases 3-7): ``vegas_sample`` and ``vegas_reduce`` against their
  plain PyTorch versions, ``integrate(solver="vegas", device="cuda")`` on the
  2-D pi problem at 2^30 evals per iteration, adaptive and multi-integrand
  runs against their exact values, kernel times beside the plain versions,
  and a ``torch.profiler`` trace of three iterations.
- :vegasmc, the default solver (phases 3b-7b): ``chain_propose`` and
  ``chain_accept`` against their plain versions from one state and over a
  whole iteration, ``integrate(solver="vegasmc", device="cuda")`` on the 2-D
  pi problem at 2^28 evals per iteration with 2^20 walkers, adaptive,
  Discrete and reweighted runs against their exact values, time per chain
  step, and a profile of three iterations.

Each path's launch counts are set to 0 just before its main path runs and
read just after.  Any failed phase raises, so the exit code is non-zero.

Prints the card's name and power limit, one JSON line describing each
kernel, and as the last line ``{"ok": true, "device": {...}}``.  Exits
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
    import torch
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
    counts = dict(vk.launch_counts)
    mean, err = float(res.mean[0]), float(res.stdev[0])
    assert res.backend == "cuda", res.backend
    assert expected > 0 and all(n == expected for n in counts.values()), (counts, expected)
    assert abs(mean - np.pi / 4) < 5 * err, (mean, err)
    evals = [h[2].neval for h in res.iterations]
    steady = sum(evals[1:]) / sum(res.iteration_times[1:])
    print(f"phase 4: pi/4 = {mean!r} +- {err!r} ({(mean - np.pi / 4) / err:+.2f} sigma), "
          f"{niter} iterations of {evals[0]} evals, launches {counts} "
          f"(expected {expected} each), backend {res.backend}")
    print(f"phase 6: steady-state {steady!r} evals/s (iterations 2-{niter}, "
          f"first excluded; per-iteration s {res.iteration_times}) [{card}]")
    return counts, shape


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
    however slowly the host issues them (time_ms would time the host)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(queue_s * 2e9))        # cycles: ~queue_s at <= 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    if end.query():
        raise AssertionError("device_ms: the queue drained before the host issued "
                             "every call (a call waits for the device, or queue_s "
                             "is too short)")
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
                ms["sample"].append(time_ms(sample, 10))
                ms["reduce"].append(time_ms(lambda: vk.vegas_reduce(w, invp, perm, *args), 10))
            else:
                ms["sample_plain"].append(time_ms(sample_plain, 3))
                ms["reduce_plain"].append(
                    time_ms(lambda: vk.vegas_reduce_plain(w, invp, perm, *args), 3))
    ms = {k: float(np.mean(v)) for k, v in ms.items()}
    ms_integrand = time_ms(lambda: it.evaluate(it.leaf_values(x)), 10)
    n = it.block * T * it.chunk
    print(f"phase 6: one launch = {it.block} blocks x {T} chunks x {it.chunk} "
          f"samples ({n} evals, {len(it.slot_map)} slots) [{card}]")
    print(f"phase 6: vegas_sample {ms['sample']!r} ms/launch, plain torch "
          f"{ms['sample_plain']!r} ms [{card}]")
    print(f"phase 6: integrand (torch) {ms_integrand!r} ms/launch [{card}]")
    print(f"phase 6: vegas_reduce {ms['reduce']!r} ms/launch, plain torch "
          f"{ms['reduce_plain']!r} ms [{card}]")
    print(f"phase 6: peak device memory {torch.cuda.max_memory_allocated()} bytes")
    return {"vegas_sample": (err_sample, ms["sample"], ms["sample_plain"]),
            "vegas_reduce": (err_reduce, ms["reduce"], ms["reduce_plain"])}


def profile_main_path(mt, card, phase, kw, niter=3):
    """Phase 7/7b: torch.profiler over integrate() at a main path's size
    (phase 4 or 4b ran it already, so nothing is built or touched first here)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = mt.integrate(_pi, var=mt.Continuous(0.0, 1.0), niter=niter, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end
                                                          - e.time_range.start)
    if not spans:
        raise AssertionError("torch.profiler recorded no device time")
    busy, reach = 0.0, -np.inf          # union of the device intervals, in us
    for a, b in sorted(spans):
        if b > reach:
            busy += b - max(a, reach)
            reach = b
    busy_s = busy * 1e-6
    mean, err = float(res.mean[0]), float(res.stdev[0])
    assert res.backend == "cuda" and abs(mean - np.pi / 4) < 5 * err, (mean, err)
    print(f"phase {phase}: profile of {niter} iterations of {res.iterations[0][2].neval} "
          f"evals: wall {wall!r} s, device busy {busy_s!r} s, idle share "
          f"{1 - busy_s / wall!r} [{card}]")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"phase {phase}: {us * 1e-3!r} ms on the device in {name[:90]}")


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


def chain_config(mt):
    """Phase 3b's configuration: a trained ninc=1024 Continuous map and a
    trained Discrete(1, 100) in one CompositeVar, dof=[[1], [2]]."""
    rng = np.random.default_rng(2)
    c = mt.Continuous(0.0, 1.0)
    c.histogram = rng.gamma(0.5, 1.0, c.ninc) + 1e-3
    c.train()
    d = mt.Discrete(1, 100)
    d.histogram = rng.gamma(0.5, 1.0, d.nbin) + 1e-3
    d.train()
    return mt.Configuration(var=mt.CompositeVar(c, d), dof=[[1], [2]], seed=SEED)


def state_bits_equal(a, b, what):
    """Every field of two ChainStates bit-equal but the histogram, which
    must agree to REL_TOL_HIST; returns the max abs error over the float
    fields (slot values excepted: a Discrete slot holds int32 bits)."""
    import dataclasses
    err = 0.0
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "hist":
            rel = rel_err(x.cpu(), y.cpu())
            if rel > REL_TOL_HIST:
                raise AssertionError(f"{what}: hist rel {rel:.3g} > {REL_TOL_HIST}")
        elif not torch_equal_bits(x, y):
            raise AssertionError(f"{what}: {f.name} differs from the plain version")
        if x.is_floating_point() and not f.name.endswith("_val"):
            err = max(err, float((x - y).abs().max()))
    return err


def torch_equal_bits(x, y):
    import torch
    if x.dtype == torch.float64:
        return torch.equal(x.view(torch.int64), y.view(torch.int64))
    return torch.equal(bits(x), bits(y))


class plain_chain:
    """Within the block, VegasMCIteration runs the chain kernels' plain
    torch versions on the card (the wrappers would launch the kernels)."""

    def __init__(self, ck):
        self.ck = ck

    def __enter__(self):
        ck = self.ck
        self.saved = ck.chain_propose, ck.chain_accept
        ck.chain_propose, ck.chain_accept = ck.chain_propose_plain, ck.chain_accept_plain

    def __exit__(self, *exc):
        self.ck.chain_propose, self.ck.chain_accept = self.saved


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

    it = VegasMCIteration(spec, _chain_two, block=16, nevalperblock=2 ** 20,
                          nwalkers=2 ** 18)
    kd = block_keys(SEED, 1, 0, it.block)
    got = it.run(params, kd)
    with plain_chain(ck):
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
    counts = dict(ck.launch_counts)
    mean, err = float(res.mean[0]), float(res.stdev[0])
    assert res.backend == "cuda", res.backend
    assert all(n == expected for n in counts.values()), (counts, expected)
    assert abs(mean - np.pi / 4) < 5 * err, (mean, err)
    evals = [h[2].neval for h in res.iterations]
    steady = sum(evals[1:]) / sum(res.iteration_times[1:])
    print(f"phase 4b: pi/4 = {mean!r} +- {err!r} ({(mean - np.pi / 4) / err:+.2f} sigma), "
          f"{niter} iterations of {evals[0]} evals ({W} walkers x {nsteps} steps), "
          f"launches {counts} (expected {expected} each), backend {res.backend}")
    print(f"phase 4b: steady-state {steady!r} evals/s (iterations 2-{niter}; "
          f"per-iteration s {res.iteration_times}) [{card}]")
    return counts


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
    return {"chain_propose": (err_propose, ms["propose"], ms["propose_plain"]),
            "chain_accept": (err_accept, ms["accept"], ms["accept_plain"])}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    card = card_line()                                        # phase 1
    print(f"phase 1: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    import mcintegration_tpu_torch as mt
    from mcintegration_tpu_torch.ops import _build, chain_kernels as ck, vegas_kernels as vk

    t0 = time.perf_counter()                                  # phase 2
    _build.load(verbose=True)
    print(f"phase 2: kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds} s, one process per source) from "
          f"{_build.library_path().name}")

    kernel_vs_plain(mt, vk, card)                             # phase 3
    chain_vs_plain(mt, ck, card)                              # phase 3b
    counts, shape = main_path(mt, vk, card)                   # phase 4
    counts.update(chain_main_path(mt, ck, card))              # phase 4b
    adaptive_checks(mt)                                       # phase 5
    chain_checks(mt)                                          # phase 5b
    measured = timings(mt, vk, shape, card)                   # phase 6
    measured.update(chain_timings(mt, ck, card))              # phase 6b
    common = dict(dof=[[2]], block=16, device="cuda", seed=SEED, verbose=-2)
    profile_main_path(mt, card, "7", dict(neval=2 ** 30, solver="vegas", **common))
    profile_main_path(mt, card, "7b", dict(neval=2 ** 28, solver="vegasmc",
                                           nwalkers=2 ** 20, **common))

    replaces = {"vegas_sample": "mcintegration_tpu/ops/pallas_vegas.py:343",
                "vegas_reduce": "mcintegration_tpu/ops/pallas_vegas.py:343",
                "chain_propose": "mcintegration_tpu/ops/pallas_chain.py:410",
                "chain_accept": "mcintegration_tpu/ops/pallas_chain.py:410"}
    kernels = []
    for name, where in replaces.items():
        err, ms, plain_ms = measured[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": f"mcintegration_tpu_torch/csrc/{name}.cu",
                        "replaces": where, "launches": counts[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
