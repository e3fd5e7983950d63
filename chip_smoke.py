"""Smoke test of the PyTorch port (mcintegration_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``mcintegration_tpu_torch/csrc``
with nvcc, holds each against its plain PyTorch version on the card, drives
``integrate(solver="vegas", device="cuda")`` on the 2-D pi problem at 2^30
evals per iteration, checks adaptive and multi-integrand runs against their
exact values, and times the kernels beside their plain versions.  Any
failed phase raises, so the exit code is non-zero.

Last, it traces three iterations of the main path with ``torch.profiler``:
wall time, device busy time, the device's idle share and device time per
kernel name.

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


def profile_main_path(mt, card, niter=3):
    """Phase 7: torch.profiler over integrate() at the main path's size
    (phase 4 ran it already, so nothing is built or touched first here)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    kw = dict(dof=[[2]], neval=2 ** 30, block=16, solver="vegas", device="cuda",
              seed=SEED, verbose=-2)
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
    print(f"phase 7: profile of {niter} iterations of {res.iterations[0][2].neval} "
          f"evals: wall {wall!r} s, device busy {busy_s!r} s, idle share "
          f"{1 - busy_s / wall!r} [{card}]")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"phase 7: {us * 1e-3!r} ms on the device in {name[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    card = card_line()                                        # phase 1
    print(f"phase 1: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    import mcintegration_tpu_torch as mt
    from mcintegration_tpu_torch.ops import _build, vegas_kernels as vk

    t0 = time.perf_counter()                                  # phase 2
    _build.load(verbose=True)
    print(f"phase 2: kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds} s) from {_build.library_path().name}")

    kernel_vs_plain(mt, vk, card)                             # phase 3
    counts, shape = main_path(mt, vk, card)                   # phase 4
    adaptive_checks(mt)                                       # phase 5
    measured = timings(mt, vk, shape, card)                   # phase 6
    profile_main_path(mt, card)                               # phase 7

    kernels = []
    for name in ("vegas_sample", "vegas_reduce"):
        err, ms, plain_ms = measured[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": f"mcintegration_tpu_torch/csrc/{name}.cu",
                        "replaces": "mcintegration_tpu/ops/pallas_vegas.py:343",
                        "launches": counts[name], "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
