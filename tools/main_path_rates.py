"""Steady-state rates of the device-bound main paths of one checkout.

    python3 tools/main_path_rates.py [DIR]      # on a CUDA card

Runs ``chip_smoke.py``'s phases 4 (``:vegas`` on the 2-D pi problem at 2^30
evaluations per iteration), 4b (``:vegasmc`` on it at 2^28 with 2^20
walkers), 4d (``:vegasplus`` on ``singular_3d`` at 2^30, then ``:vegas`` on
the same budget) and 4e (the quickstart's 10-bin histogram on ``:vegas`` at
2^30 and on ``:vegasmc`` at 2^28) through
``integrate``, with the ``chip_smoke.py`` and ``mcintegration_tpu_torch`` of
the checkout at ``DIR`` (default: this one), whose kernels it builds first.
Each phase checks its result as ``chip_smoke.py`` does and prints its
steady-state rate (iterations 2-10).  To compare two checkouts on one card,
run it for each in one call, in turns (parent, change, change, parent):
each run is a process of its own and imports its own package.
"""

from __future__ import annotations

import sys
from pathlib import Path


def main() -> int:
    root = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).parents[1]).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("main_path_rates: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import mcintegration_tpu_torch as mt
    from mcintegration_tpu_torch.ops import (_build, chain_kernels as ck, vegas_kernels as vk,
                                             vplus_kernels as vp)

    if root not in Path(mt.__file__).resolve().parents:
        raise RuntimeError(f"main_path_rates: imported {mt.__file__}, not the package in {root}")
    card = cs.card_line()
    _build.load()
    print(f"main_path_rates: {root} ({_build.library_path().name}) [{card}]", flush=True)
    _, _, rate4 = cs.main_path(mt, vk, card)
    _, rate4b = cs.chain_main_path(mt, ck, card)
    cs.vplus_main_path(mt, vp, card)
    cs.measure_main_path(mt, vk, ck, card, {"4": rate4, "4b": rate4b})
    return 0


if __name__ == "__main__":
    sys.exit(main())
