"""Variants of the :mcmc step kernels, timed on the card beside the kept ones.

Builds the kernel library of ``mcintegration_tpu_torch/csrc`` as it stands,
then one library per variant: a copy of the sources with a few lines of
``mcmc_propose.cu``, ``mcmc_accept.cu`` or ``mcmc_common.cuh`` rewritten
(the tile shape, the grid, the warp aggregation of the counts, the sort by
branch class, tables staged in shared memory).  Two more variants keep the
library and move ``mcmc_accept``'s histogram or counters to device memory.

Each variant takes one step of ``mcmc_propose`` and ``mcmc_accept`` at
``chip_smoke.py`` phase 6c's shape (the Lindhard bubble, 2^18 walkers, from
the state after 400 steps), is held bit for bit against the plain versions,
and is timed on the device with the calls queued behind a sleep kernel:
propose, accept on a measured and on an unmeasured step, each the median
of three runs of 20 calls.  The kept library runs first and last.  Last
comes a probe of divergence: ``mcmc_propose`` on three specs of one var
group each (the bubble's leaves alone) at the same walker count.

    python3 tools/mcmc_variants.py          # on a machine with a CUDA card

It prints one line per variant and exits non-zero if a variant fails to
build or differs from the plain versions.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (the bubble, the timers and the checks)

PROPOSE, ACCEPT, COMMON = "mcmc_propose.cu", "mcmc_accept.cu", "mcmc_common.cuh"
TILE = ("constexpr int kThreads = 512;", "constexpr int kWalkersPerThread = 2;",
        "constexpr int kBlocksPerSm = 2;")


def tile(f, threads, per_thread):
    """File ``f`` with tiles of ``threads`` x ``per_thread`` walkers and
    1024 threads on each SM."""
    return [(f, TILE[0], f"constexpr int kThreads = {threads};"),
            (f, TILE[1], f"constexpr int kWalkersPerThread = {per_thread};"),
            (f, TILE[2], f"constexpr int kBlocksPerSm = {1024 // threads};")]


def staged(lay):
    """Both kernels with the meta table, and propose with the float tables
    (grids, CDFs, deg, FermiK constants), accept with deg and rw, copied to
    shared memory by every block before its first walker."""
    nmeta, nd, ntab = lay.meta.numel(), lay.nd, lay.tab_size
    propose = (PROPOSE, "mcmc_propose_kernel(\n    const ProposeArgs a) {",
               "mcmc_propose_kernel(\n    const ProposeArgs a0) {\n"
               f"  __shared__ int smeta[{nmeta}];\n"
               f"  __shared__ float stab[{ntab}];\n"
               f"  for (int q = threadIdx.x; q < {nmeta}; q += blockDim.x) smeta[q] = a0.meta[q];\n"
               f"  for (int q = threadIdx.x; q < {ntab}; q += blockDim.x) stab[q] = a0.tab[q];\n"
               "  __syncthreads();\n"
               "  ProposeArgs a = a0;\n"
               "  a.meta = smeta;\n"
               "  a.tab = stab;")
    accept = (ACCEPT, "mcmc_accept_kernel(\n    const AcceptArgs a) {",
              "mcmc_accept_kernel(\n    const AcceptArgs a0) {\n"
              f"  __shared__ int smeta[{nmeta}];\n"
              f"  __shared__ float sdeg[{nd}], srw[{nd}];\n"
              f"  for (int q = threadIdx.x; q < {nmeta}; q += blockDim.x) smeta[q] = a0.meta[q];\n"
              f"  for (int q = threadIdx.x; q < {nd}; q += blockDim.x) {{\n"
              "    sdeg[q] = a0.deg[q];\n"
              "    srw[q] = a0.rw[q];\n"
              "  }\n"
              "  __syncthreads();\n"
              "  AcceptArgs a = a0;\n"
              "  a.meta = smeta;\n"
              "  a.deg = sdeg;\n"
              "  a.rw = srw;")
    return [propose], [accept]


def variants(lay):
    """(name, source edits, SMEM_HIST_BINS, SMEM_COUNTERS) of each variant."""
    from mcintegration_tpu_torch.ops import mcmc_kernels as mk
    hist, cnt = mk.SMEM_HIST_BINS, mk.SMEM_COUNTERS
    out = [(f"propose tiles {t} x {q}", tile(PROPOSE, t, q), hist, cnt)
           for t, q in ((512, 1), (256, 1), (256, 2), (256, 4), (128, 4))]
    out += [(f"accept tiles {t} x {q}", tile(ACCEPT, t, q), hist, cnt)
            for t, q in ((512, 1), (512, 4), (256, 1), (256, 2), (256, 4))]
    cap = "  if (blocks > cap) blocks = cap;\n"
    stage_p, stage_a = staged(lay)
    out += [
        ("one tile per block (no persistent grid)", [(PROPOSE, cap, ""), (ACCEPT, cap, "")],
         hist, cnt),
        ("accept counts without warp aggregation",
         [(ACCEPT, "const unsigned peers = __match_any_sync(0xffffffffu, key);",
           "const unsigned peers = 1u << (threadIdx.x & 31);")], hist, cnt),
        ("sort's class counts without warp aggregation",
         [(COMMON, "const unsigned peers = __match_any_sync(0xffffffffu, key[q]);",
           "const unsigned peers = 1u << lane;")], hist, cnt),
        ("one branch class (walkers with a role compacted, not sorted)",
         [(COMMON, "return role == kRoleCv ? vi : role == kRoleSw ? nvar + vi\n"
                   "       : role == kRoleCi ? 2 * nvar : 2 * nvar + 1;", "return 0;")],
         hist, cnt),
        ("propose with its tables in shared memory", stage_p, hist, cnt),
        ("accept with its tables in shared memory", stage_a, hist, cnt),
        ("accept's histogram in device memory (float64 atomics)", [], 0, cnt),
        ("accept's counters in device memory (64-bit atomics)", [], hist, 0),
    ]
    return out


def compile_all(jobs):
    """Run the nvcc commands of ``jobs`` [(cmd, what)], a few at a time."""
    width = max(1, os.cpu_count() or 1)
    for i in range(0, len(jobs), width):
        procs = [(what, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
                 for cmd, what in jobs[i:i + width]]
        for what, cmd, proc in procs:
            log = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"{what}: nvcc failed\n{' '.join(cmd)}\n{log}")


def build(vs):
    """One library per variant with source edits, under build/torch_kernels/
    variants/: the kept objects for the files a variant leaves alone."""
    from mcintegration_tpu_torch.ops import _build
    nvcc, flags = _build._nvcc(), _build.NVCC_FLAGS
    top = _build.BUILD_DIR / "variants"
    shutil.rmtree(top, ignore_errors=True)
    srcs = sorted(_build.CSRC.glob("*.cu"))
    base = top / "kept"
    base.mkdir(parents=True)
    jobs = [([nvcc, *flags, "-c", "-o", str(base / f"{s.stem}.o"), str(s)], f"kept {s.name}")
            for s in srcs]
    plans = []
    for k, (name, edits, _, _) in enumerate(vs):
        if not edits:
            plans.append(None)
            continue
        d = top / f"v{k}"
        shutil.copytree(_build.CSRC, d / "src")
        touched = set()
        for f, old, new in edits:
            p = d / "src" / f
            text = p.read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} not found once in {f}")
            p.write_text(text.replace(old, new))
            touched.add(f)
        rebuilt = {s.name for s in srcs if s.name in touched
                   or any(f'#include "{f}"' in s.read_text() for f in touched)}
        objs = []
        for s in srcs:
            if s.name in rebuilt:
                obj = d / f"{s.stem}.o"
                jobs.append(([nvcc, *flags, "-c", "-o", str(obj), str(d / "src" / s.name)],
                             f"{name}: {s.name}"))
            else:
                obj = base / f"{s.stem}.o"
            objs.append(str(obj))
        plans.append((d / "libvariant.so", objs))
    compile_all(jobs)
    libs = [None] * len(vs)
    for k, plan in enumerate(plans):
        if plan is None:
            continue
        out, objs = plan
        proc = subprocess.run([nvcc, *_build.ARCH_FLAGS, "-shared", "-o", str(out), *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{vs[k][0]}: link failed\n{proc.stdout}{proc.stderr}")
        libs[k] = _build.bind(out)
    return libs


def bubble_state(mt, mk):
    """The bubble's iteration at phase 6c's shape and its state after 400
    steps of the kept kernels."""
    from mcintegration_tpu_torch.ops.rng import block_keys
    from mcintegration_tpu_torch.solvers.engine import Spec
    from mcintegration_tpu_torch.solvers.mcmc import MCMCIteration

    kw = cs.bubble_kw(mt)
    cfg = mt.Configuration(var=kw["var"], dof=kw["dof"], obs=kw["obs"], seed=cs.SEED)
    it = MCMCIteration(Spec(cfg, "cuda"), cs.make_bubble("cuda"), measure=cs._bubble_measure,
                       obs_proto=kw["obs"], block=16, nevalperblock=2 ** 28 // 16,
                       nwalkers=2 ** 18, thermal_ratio=cs.BUBBLE_THERMAL)
    kd_np = block_keys(cs.SEED, 0, 0, it.block)
    sched, groups = it.schedule(kd_np)
    kd = it.seeds(kd_np)
    tab, rw, st = it.start(it.spec.device_params(), kd, sched)
    for t in range(400):
        it.step(tab, rw, kd, sched, groups[t], st, t)
    return it, (tab, rw, kd, sched, groups), st


def run_one(it, mk, args, st0):
    """(propose, accept measured, accept unmeasured) ms of the library in
    use, and the largest difference from the plain versions on one step."""
    tab, rw, kd, sched, groups = args
    lay = it.layout
    st = st0.clone()
    errs = cs.mcmc_one_step(it, mk, st, tab, rw, kd, sched, groups[400], 400, "variant")
    T = 401
    nw = it.weights(st, groups[T])
    med = lambda fn: float(np.median([cs.device_ms(fn, 20) for _ in range(3)]))
    prop = med(lambda: mk.mcmc_propose(lay, tab, kd, sched, T, st))
    acc = med(lambda: mk.mcmc_accept(lay, tab, rw, kd, sched, T, st, nw, measure=True))
    acc_u = med(lambda: mk.mcmc_accept(lay, tab, rw, kd, sched, T, st, nw, measure=False))
    return prop, acc, acc_u, max(errs)


def probe(mt, mk, card):
    """mcmc_propose on specs of one var group each, the bubble's leaves
    alone, at the same walker count."""
    import torch
    from mcintegration_tpu_torch.ops.rng import block_keys
    from mcintegration_tpu_torch.solvers.engine import Spec
    from mcintegration_tpu_torch.solvers.mcmc import MCMCIteration

    for name, var, f in (
            ("FermiK 3-D", mt.FermiK(3, cs.KF, 0.2 * cs.KF, 10.0 * cs.KF),
             lambda i, x, c: torch.exp(-(x[0] * x[0]).sum(0))),
            ("Continuous, 1024 bins", mt.Continuous(0.0, cs.BETA_PHYS, alpha=3.0),
             lambda i, x, c: torch.exp(-x[0])),
            ("Discrete(1, 4)", mt.Discrete(1, cs.QSIZE, adapt=False),
             lambda i, x, c: x[0].to(torch.float32))):
        cfg = mt.Configuration(var=var, dof=[[1]], seed=cs.SEED)
        it = MCMCIteration(Spec(cfg, "cuda"), f, block=16, nevalperblock=2 ** 28 // 16,
                           nwalkers=2 ** 18, thermal_ratio=cs.BUBBLE_THERMAL)
        lay = it.layout
        kd_np = block_keys(cs.SEED, 0, 0, it.block)
        sched, groups = it.schedule(kd_np)
        kd = it.seeds(kd_np)
        tab, rw, st = it.start(it.spec.device_params(), kd, sched)
        for t in range(100):
            it.step(tab, rw, kd, sched, groups[t], st, t)
        mk.mcmc_propose(lay, tab, kd, sched, 100, st)
        roles = np.bincount(st.move[0].cpu().numpy(), minlength=5).tolist()
        ms = float(np.median([cs.device_ms(
            lambda: mk.mcmc_propose(lay, tab, kd, sched, 100, st), 20) for _ in range(3)]))
        print(f"divergence probe, {name} alone: mcmc_propose {ms!r} ms/step "
              f"(roles none/CV/swap/CI/NJ {roles}) [{card}]", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mcmc_variants: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    import mcintegration_tpu_torch as mt
    from mcintegration_tpu_torch.ops import _build, mcmc_kernels as mk

    card = cs.card_line()
    kept = _build.load()
    it, args, st0 = bubble_state(mt, mk)
    vs = variants(it.layout)
    libs = build(vs)
    hist, cnt = mk.SMEM_HIST_BINS, mk.SMEM_COUNTERS
    roles = np.bincount(st0.move[0].cpu().numpy(), minlength=5).tolist()
    print(f"the bubble at 2^18 walkers after 400 steps (roles none/CV/swap/CI/NJ of the "
          f"last step {roles}); device ms per call, median of 3 x 20 [{card}]", flush=True)
    bad = []
    runs = [("kept", kept, hist, cnt)]
    runs += [(name, lib or kept, h, c) for (name, _, h, c), lib in zip(vs, libs)]
    runs += [("kept, again", kept, hist, cnt)]
    for name, lib, h, c in runs:
        _build._lib, mk.SMEM_HIST_BINS, mk.SMEM_COUNTERS = lib, h, c
        try:
            prop, acc, acc_u, err = run_one(it, mk, args, st0)
        except AssertionError as e:          # not bit-equal: reported, not timed
            print(f"{name}: {e}", flush=True)
            bad.append(name)
            continue
        print(f"{name}: propose {prop!r}, accept measured {acc!r}, unmeasured {acc_u!r} ms; "
              f"max abs difference from the plain versions {err!r}", flush=True)
        if err != 0.0:
            bad.append(name)
    _build._lib, mk.SMEM_HIST_BINS, mk.SMEM_COUNTERS = kept, hist, cnt
    probe(mt, mk, card)
    if bad:
        print(f"mcmc_variants: differ from the plain versions: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
