"""Steady-state rates of the device-bound main paths of one checkout.

    python3 tools/main_path_rates.py [DIR] [--mcmc | --measurement | --f64]   # on a CUDA card

Runs ``chip_smoke.py``'s phases 4 (``:vegas`` on the 2-D pi problem at 2^30
evaluations per iteration), 4b (``:vegasmc`` on it at 2^28 with 2^20
walkers), 4d (``:vegasplus`` on ``singular_3d`` at 2^30, then ``:vegas`` on
the same budget) and 4e (the quickstart's 10-bin histogram on ``:vegas`` at
2^30 and on ``:vegasmc`` at 2^28) through
``integrate``, with the ``chip_smoke.py`` and ``mcintegration_tpu_torch`` of
the checkout at ``DIR`` (default: this one), whose kernels it builds first.
Each phase checks its result as ``chip_smoke.py`` does and prints its
steady-state rate (iterations 2-10).  With ``--mcmc`` it runs phase 4c
alone (``:mcmc`` on the Lindhard bubble at 2^28 evaluations per iteration
with 2^18 walkers, every q bin within 7 sigma), a host-bound path whose
rate swings by a third from run to run, and then times the host's side of
one ``mcmc_measure`` call at that shape (the checkout's wrapper, whichever
of its two signatures it has).  With ``--measurement`` it runs phases 4 and
4d and then the measurement side's 4g (complex weights, the histogram
measure on ``:vegasplus``, ``measurefreq``) and the mixed route's 4h (the
Lindhard bubble on ``:vegas``, real, complex and gated, and the Discrete
and mixed-``ninc`` runs), each checked and timed as ``chip_smoke.py`` does.
With ``--f64`` it runs phase 4i alone: the float64 runs
(``integrate(dtype=torch.float64)`` at 2^30 evaluations per iteration:
pi, ``singular_3d``, the bubble three ways, e^{100x} on both stratified
solvers, the complex quarter disc, the histogram at ``measurefreq=4``),
each checked, with its steady-state rate and idle share.
To compare two checkouts on one card,
run it for each in one call, in turns (parent, change, change, parent):
each run is a process of its own and imports its own package.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np


def measure_host_us(mt, mk, cs, card, calls=2000, reps=5):
    """Print the host microseconds per call of the checkout's
    ``mcmc_measure`` wrapper at phase 4c's shape (the bubble, one sector,
    2^18 walkers, the state after the start): the median of ``reps`` runs of
    ``calls`` calls issued back to back, the clock read before the device is
    drained (a launch takes a few microseconds on the card, less than a call
    takes on the host, so the queue never fills)."""
    import inspect
    import time

    import torch
    from mcintegration_tpu_torch.ops.rng import block_keys
    from mcintegration_tpu_torch.solvers.engine import Spec
    from mcintegration_tpu_torch.solvers.mcmc import MCMCIteration

    kw = cs.bubble_kw(mt)
    cfg = mt.Configuration(var=kw["var"], dof=kw["dof"], obs=kw["obs"], seed=cs.SEED)
    it = MCMCIteration(Spec(cfg, "cuda"), cs.make_bubble("cuda"), measure=cs._bubble_measure,
                       obs_proto=kw["obs"], block=16, nevalperblock=2 ** 28 // 16,
                       nwalkers=2 ** 18, thermal_ratio=cs.BUBBLE_THERMAL)
    kd = block_keys(cs.SEED, 0, 0, it.block)
    sched, _ = it.schedule(kd)
    _, _, st = it.start(it.spec.device_params(), it.seeds(kd), sched)
    lay = it.layout
    ms = [m(lay.leaf_values(st.cur_val), st.relw).contiguous() for m in it.measure]
    assert len(ms) == 1
    if "ms" in inspect.signature(mk.mcmc_measure).parameters:
        def call():
            mk.mcmc_measure(lay, ms, st)
    else:                       # a checkout whose wrapper takes one sector a call
        def call():
            mk.mcmc_measure(lay, 0, ms[0], st)
    for _ in range(100):
        call()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        runs.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    print(f"phase 4c host: mcmc_measure {float(np.median(runs))!r} us a call on the host "
          f"(median of {reps} x {calls} calls: {runs}) [{card}]", flush=True)


def main() -> int:
    dirs = [a for a in sys.argv[1:] if not a.startswith("--")]
    root = Path(dirs[0] if dirs else Path(__file__).parents[1]).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("main_path_rates: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import mcintegration_tpu_torch as mt
    from mcintegration_tpu_torch.ops import (_build, chain_kernels as ck, mcmc_kernels as mk,
                                             vegas_kernels as vk, vplus_kernels as vp)

    if root not in Path(mt.__file__).resolve().parents:
        raise RuntimeError(f"main_path_rates: imported {mt.__file__}, not the package in {root}")
    card = cs.card_line()
    _build.load()
    print(f"main_path_rates: {root} ({_build.library_path().name}) [{card}]", flush=True)
    if "--mcmc" in sys.argv[1:]:
        cs.mcmc_main_path(mt, mk, card)
        measure_host_us(mt, mk, cs, card)
        return 0
    if "--f64" in sys.argv[1:]:
        cs.f64_main_path(mt, vk, vp, card)
        return 0
    _, _, rate4 = cs.main_path(mt, vk, card)
    if "--measurement" in sys.argv[1:]:
        _, _, rate4d = cs.vplus_main_path(mt, vp, card)
        cs.measurement_main_path(mt, vk, vp, card, {"4": rate4, "4d": rate4d})
        cs.mixed_main_path(mt, vk, card, rate4)
        return 0
    _, rate4b = cs.chain_main_path(mt, ck, card)
    cs.vplus_main_path(mt, vp, card)
    cs.measure_main_path(mt, vk, ck, card, {"4": rate4, "4b": rate4b})
    return 0


if __name__ == "__main__":
    sys.exit(main())
