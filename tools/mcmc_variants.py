"""Variants of the :mcmc kernels, timed on the card beside the kept ones.

Builds the kernel library of ``mcintegration_tpu_torch/csrc`` as it stands,
then one library per variant: a copy of the sources with a few lines of
``mcmc_propose.cu``, ``mcmc_accept.cu``, ``mcmc_common.cuh`` (the tile
shape, the grid, the warp aggregation of the counts, the sort by branch
class, tables staged in shared memory) or ``mcmc_measure.cu`` (components
in flight, threads a block, streaming loads and stores; or a kernel held
here, ``GROUPS``, launched in place of the kept one: several adjacent
walkers a thread with vector accesses, m and obs loaded before curr
arrives) rewritten.  Two
more variants keep the library and move ``mcmc_accept``'s histogram or
counters to device memory.  Ablations take a part of ``mcmc_measure`` out
(the loads of obs, of m, of curr); they are timed, not checked.

A variant runs the cases of the kernels it changes.  The step kernels: one
step of ``mcmc_propose`` and ``mcmc_accept`` at ``chip_smoke.py`` phase 6c's
shape (the Lindhard bubble, 2^18 walkers, from the state after 400 steps),
held bit for bit against the plain versions and timed on the device with
the calls queued behind a sleep kernel: propose, accept on a measured and
on an unmeasured step, each the median of three runs of 20 calls.
``mcmc_measure``: the bubble's output on that state (one sector, four
components) and phase 3c's spec after 64 steps (two sectors, 2^20
walkers), each held bit for bit against the plain version and timed with
L2 warm (median of 3 x 20 calls) and flushed before each call
(``chip_smoke.flushed_ms``); then 100 measured steps of the bubble (the
real iteration's order of launches) are profiled and each :mcmc kernel's
device time per launch printed.  The kept library, and the baseline's, run
first and last.  Last comes a probe of divergence: ``mcmc_propose`` on
three specs of one var group each (the bubble's leaves alone) at the same
walker count.

    python3 tools/mcmc_variants.py [--baseline DIR]    # on a CUDA card

``--baseline DIR`` builds the kernels of another checkout at ``DIR`` (its
``csrc``; an ``mcmc_measure`` of one sector a launch is called once per
sector) and runs them first and last, in turns with the kept ones.  It
prints one line per variant and case and exits non-zero if a variant fails
to build or a checked one differs from the plain versions.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (the bubble, the timers and the checks)

PROPOSE, ACCEPT, COMMON = "mcmc_propose.cu", "mcmc_accept.cu", "mcmc_common.cuh"
MEASURE = "mcmc_measure.cu"
CURR = "  const int s = a.curr[w] - a.lo;\n"
M_PTR = "  const float* m = a.m[s];\n"
BOUNDS = "__global__ void __launch_bounds__(kThreads)\n"
COMPONENT_LOOP = "#pragma unroll 1\n  for (int k0 = 0; k0 < a.ncomp; k0 += kComps) {\n"
LOADS = ("        x[j] = m[q];\n        y[j] = a.obs[q];\n      }\n    }\n")
M_LOAD = "        x[j] = m[q];\n"
OBS_LOAD = "        y[j] = a.obs[q];\n"
OBS_STORE = "      if (k0 + j < a.ncomp) a.obs[(k0 + j) * a.W + w] = y[j] + (double)x[j];\n"
LAUNCH = ("  mcmc_measure_kernel<<<(W + kThreads - 1) / kThreads, kThreads, 0, "
          "(cudaStream_t)stream>>>(a);\n")
NAMESPACE_END = "}  // namespace\n"
# A kernel of kWalkers adjacent walkers a thread, with int2/int4, float2/float4
# and double2 accesses where the launcher finds the pointers 16-byte aligned
# and W a multiple of kWalkers (else one walker a thread); with one sector a
# launch, m's loads are issued before curr arrives.  The variants insert it
# into mcmc_measure.cu and launch it in place of the kept kernel.
GROUPS = r"""
constexpr int kWalkers = 1;       // adjacent walkers a thread

template <int V>
__device__ __forceinline__ void load_ints(const int* p, int (&v)[V]) {
  if constexpr (V == 4) {
    const int4 q = *reinterpret_cast<const int4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else if constexpr (V == 2) {
    const int2 q = *reinterpret_cast<const int2*>(p);
    v[0] = q.x, v[1] = q.y;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void load_floats(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else if constexpr (V == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x, v[1] = q.y;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void load_doubles(const double* p, double (&v)[V]) {
  if constexpr (V >= 2) {
#pragma unroll
    for (int h = 0; h < V / 2; ++h) {
      const double2 q = reinterpret_cast<const double2*>(p)[h];
      v[2 * h] = q.x, v[2 * h + 1] = q.y;
    }
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store_doubles(double* p, const double (&v)[V]) {
  if constexpr (V >= 2) {
#pragma unroll
    for (int h = 0; h < V / 2; ++h)
      reinterpret_cast<double2*>(p)[h] = make_double2(v[2 * h], v[2 * h + 1]);
  } else {
    p[0] = v[0];
  }
}

template <int V, bool kOne>
__global__ void __launch_bounds__(kThreads)
    mcmc_measure_kernel_groups(const __grid_constant__ MeasureArgs a) {
  const int w0 = (int)(blockIdx.x * kThreads + threadIdx.x) * V;
  if (w0 >= a.W) return;
  int s[V];
  load_ints<V>(a.curr + w0, s);
  bool in[V], any = false;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    s[v] -= a.lo;
    in[v] = (unsigned)s[v] < (unsigned)a.n;
    any |= in[v];
  }
  for (int k0 = 0; k0 < a.ncomp; k0 += kComps) {
    float x[kComps][V];
    double y[kComps][V];
    if constexpr (kOne) {
#pragma unroll
      for (int j = 0; j < kComps; ++j)
        if (k0 + j < a.ncomp) load_floats<V>(a.m[0] + (k0 + j) * a.W + w0, x[j]);
    }
    if (!any) continue;  // obs only for a group where some walker adds
#pragma unroll
    for (int j = 0; j < kComps; ++j) {
      if (k0 + j < a.ncomp) {
        const int q = (k0 + j) * a.W + w0;
        load_doubles<V>(a.obs + q, y[j]);
        if constexpr (!kOne) {
#pragma unroll
          for (int v = 0; v < V; ++v) x[j][v] = in[v] ? a.m[s[v]][q + v] : 0.0f;
        }
      }
    }
    // add each walker's own output; store the group's sums
#pragma unroll
    for (int j = 0; j < kComps; ++j) {
      if (k0 + j < a.ncomp) {
#pragma unroll
        for (int v = 0; v < V; ++v)
          if (in[v]) y[j][v] += (double)x[j][v];
        store_doubles<V>(a.obs + (k0 + j) * a.W + w0, y[j]);
      }
    }
  }
}

template <int V>
void launch_walkers(const MeasureArgs& a, cudaStream_t stream) {
  const int blocks = (a.W / V + kThreads - 1) / kThreads;
  if (a.n == 1)
    mcmc_measure_kernel_groups<V, true><<<blocks, kThreads, 0, stream>>>(a);
  else
    mcmc_measure_kernel_groups<V, false><<<blocks, kThreads, 0, stream>>>(a);
}

bool aligned16(const void* p) { return ((unsigned long long)p & 15) == 0; }

void launch_groups(const MeasureArgs& a, cudaStream_t stream) {
  bool vec = a.W % kWalkers == 0 && aligned16(a.curr) && aligned16(a.obs);
  for (int s = 0; s < a.n; ++s) vec = vec && aligned16(a.m[s]);
  if (vec)
    launch_walkers<kWalkers>(a, stream);
  else
    launch_walkers<1>(a, stream);
}

"""
OBS_GATE = "    if (!any) continue;  // obs only for a group where some walker adds\n"
ADD = "    // add each walker's own output; store the group's sums\n"
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
    out += [(name, edits, hist, cnt) for name, edits in measure_variants()]
    return out


def measure_constants():
    """The kept mcmc_measure.cu's kThreads and kComps."""
    from mcintegration_tpu_torch.ops import _build
    text = (_build.CSRC / MEASURE).read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
            for name in ("kThreads", "kComps")}


def groups(v):
    """Source edits that launch ``GROUPS`` at ``v`` adjacent walkers a
    thread in place of the kept kernel."""
    body = GROUPS.replace("constexpr int kWalkers = 1;", f"constexpr int kWalkers = {v};")
    return [(MEASURE, NAMESPACE_END, body + NAMESPACE_END),
            (MEASURE, LAUNCH, "  launch_groups(a, (cudaStream_t)stream);\n")]


def measure_variants():
    """(name, source edits) of the checked variants of mcmc_measure: the
    other components in flight (1, 2, 4, 8) and threads a block (128, 256,
    512) than the kept ones; registers capped at 32, the component loop
    unrolled, every load of m before those of obs; m's pointer a launch
    operand at N = 1, or selected from the table without an indexed read; 1,
    2 and 4 walkers a thread with m loaded before
    curr arrives at one sector a launch (``GROUPS``), and at one walker a
    thread obs loaded before curr arrives too; streaming hints."""
    kept = measure_constants()

    def const(name, new):
        return [(MEASURE, f"constexpr int {name} = {kept[name]};",
                 f"constexpr int {name} = {new};")]

    early_obs = [(MEASURE, OBS_GATE, ""), (MEASURE, ADD, "    if (!any) continue;\n" + ADD)]
    out = [(f"measure, {c} component{'s' * (c > 1)} in flight", const("kComps", c))
           for c in (1, 2, 4, 8) if c != kept["kComps"]]
    out += [(f"measure, {t} threads a block", const("kThreads", t))
            for t in (128, 256, 512) if t != kept["kThreads"]]
    return out + [
        ("measure, 32 registers at most (every thread slot of an SM resident)",
         [(MEASURE, BOUNDS, "__global__ void __launch_bounds__(kThreads, 2048 / kThreads)\n")]),
        ("measure, the component loop unrolled by the compiler",
         [(MEASURE, COMPONENT_LOOP, COMPONENT_LOOP.replace("#pragma unroll 1\n", ""))]),
        ("measure, every load of m issued before the first of obs",
         [(MEASURE, LOADS, "        x[j] = m[q];\n      }\n    }\n#pragma unroll\n"
                           "    for (int j = 0; j < kComps; ++j) {\n"
                           "      if (k0 + j < a.ncomp) {\n"
                           "        const int q = (k0 + j) * a.W + w;\n"
                           "        y[j] = a.obs[q];\n      }\n    }\n")]),
        ("measure, m's pointer a launch operand at N = 1 (a kernel for one sector)",
         [(MEASURE, BOUNDS, "template <bool kOne>\n" + BOUNDS),
          (MEASURE, M_PTR, "  const float* m = kOne ? a.m[0] : a.m[s];\n"),
          (MEASURE, LAUNCH, "  const int blocks = (W + kThreads - 1) / kThreads;\n"
                            "  if (n == 1)\n"
                            "    mcmc_measure_kernel<true><<<blocks, kThreads, 0, "
                            "(cudaStream_t)stream>>>(a);\n"
                            "  else\n"
                            "    mcmc_measure_kernel<false><<<blocks, kThreads, 0, "
                            "(cudaStream_t)stream>>>(a);\n")]),
        ("measure, m's pointer selected without an indexed read",
         [(MEASURE, M_PTR, "  const float* m = a.m[0];\n#pragma unroll\n"
                           "  for (int i = 1; i < kMaxSectors; ++i)\n"
                           "    if (i < a.n && s == i) m = a.m[i];\n")]),
        ("measure, m loaded before curr arrives", groups(1)),
        ("measure, 2 walkers a thread (vector accesses)", groups(2)),
        ("measure, 4 walkers a thread (vector accesses)", groups(4)),
        ("measure, m and obs loaded before curr arrives", groups(1) + early_obs),
        ("measure, streaming loads of m",
         [(MEASURE, M_LOAD, "        x[j] = __ldcs(m + q);\n")]),
        ("measure, streaming loads and stores of obs",
         [(MEASURE, OBS_LOAD, "        y[j] = __ldcs(a.obs + q);\n"),
          (MEASURE, OBS_STORE, "      if (k0 + j < a.ncomp)\n"
                               "        __stcs(a.obs + (k0 + j) * a.W + w, y[j] + (double)x[j]);\n")]),
    ]


def ablations():
    """(name, source edits) of mcmc_measure with a part taken out: wrong
    sums, timed and not checked."""
    return [
        ("measure ablation, every thread returns at once",
         [(MEASURE, "  if (w >= a.W) return;", "  return;")]),
        ("measure ablation, no stores (one only where a sum is -1)",
         [(MEASURE, OBS_STORE, OBS_STORE.replace("k0 + j < a.ncomp", "k0 + j < a.ncomp && "
                                                                    "y[j] == -1.0"))]),
        ("measure ablation, obs not loaded", [(MEASURE, OBS_LOAD, "        y[j] = 0.0;\n")]),
        ("measure ablation, m not loaded", [(MEASURE, M_LOAD, "        x[j] = 1.0f;\n")]),
        ("measure ablation, curr not loaded (every walker in the first sector)",
         [(MEASURE, CURR, "  const int s = 0;\n")]),
    ]


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


def measure_cases(mt, it, st0):
    """(name, layout, outputs, state) of mcmc_measure's cases: phase 6c's
    bubble on the state after 400 steps, and phase 3c's spec."""
    vals = it.layout.leaf_values(st0.cur_val)
    bubble = [m(vals, st0.relw).contiguous() for m in it.measure]
    it3, st3, ms3 = cs.allbranch_measure_inputs(mt)
    return [("6c", it.layout, bubble, st0), ("3c spec", it3.layout, ms3, st3)]


def measure_run(mk, case, check=True):
    """(warm ms, flushed ms, max abs err) of mcmc_measure on one case;
    unchecked: err 0."""
    import torch
    _, lay, ms, st0 = case
    st = st0.clone()
    err = 0.0
    if check:
        ref = st0.clone()
        mk.mcmc_measure(lay, ms, st)
        mk.mcmc_measure_plain(lay, ms, ref)
        torch.cuda.synchronize()
        err = cs.state_bits_equal(st, ref, "mcmc_measure", hist_rel=0.0)
    warm = float(np.median([cs.device_ms(lambda: mk.mcmc_measure(lay, ms, st), 20)
                            for _ in range(3)]))
    return warm, cs.flushed_ms(lambda: mk.mcmc_measure(lay, ms, st))[0], err


def step_profile(it, mk, args, st0, nsteps=100):
    """Device ms per launch of each :mcmc kernel over ``nsteps`` measured
    steps of the bubble from ``st0``, in the order an iteration launches them
    (propose, the integrand, accept, the measure, mcmc_measure)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tab, rw, kd, sched, groups = args
    lay, st = it.layout, st0.clone()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for t in range(400, 400 + nsteps):
            mk.mcmc_propose(lay, tab, kd, sched, t, st)
            mk.mcmc_accept(lay, tab, rw, kd, sched, t, st, it.weights(st, groups[t]),
                           measure=True)
            vals = lay.leaf_values(st.cur_val)
            mk.mcmc_measure(lay, [m(vals, st.relw).contiguous() for m in it.measure], st)
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        for key in ("mcmc_propose", "mcmc_accept", "mcmc_measure"):
            if e.device_type == DeviceType.CUDA and f"{key}_kernel" in e.name:
                n, us = out.get(key, (0, 0.0))
                out[key] = (n + 1, us + e.time_range.end - e.time_range.start)
    return {key: us * 1e-3 / n for key, (n, us) in out.items()}


class baseline_measure:
    """Within the block, ``mk.mcmc_measure`` launches the baseline library's
    kernel, one sector a launch where its entry point takes one
    (``mci_mcmc_measure(i, ncomp, W, m, curr, obs, stream)``)."""

    def __init__(self, mk, lib, one_sector):
        self.mk, self.lib, self.one_sector = mk, lib, one_sector

    def __enter__(self):
        import torch
        from mcintegration_tpu_torch.ops import _build
        self.saved, lib = self.mk.mcmc_measure, self.lib
        if not self.one_sector:
            return
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.mci_mcmc_measure.argtypes = [I, I, I, P, P, P, P]

        def measure(lay, ms, st):
            stream = torch.cuda.current_stream().cuda_stream
            for i, m in enumerate(ms):
                err = lib.mci_mcmc_measure(i, lay.ncomp, lay.W, m.data_ptr(),
                                           st.curr.data_ptr(), st.obs.data_ptr(), stream)
                _build.check(lib, err, "mcmc_measure (baseline)")
        self.mk.mcmc_measure = measure

    def __exit__(self, *exc):
        self.mk.mcmc_measure = self.saved


def baseline(root):
    """(library, whether its mcmc_measure takes one sector a launch) of the
    checkout at ``root``; its step kernels take the kept ones' arguments."""
    from accept_reduce_variants import build_from
    from mcintegration_tpu_torch.ops import _build
    csrc = Path(root) / "mcintegration_tpu_torch" / "csrc"
    lib = _build.bind(build_from(csrc, "baseline"))
    return lib, "const void* const* m" not in (csrc / MEASURE).read_text()


def ptxas_lines():
    """ptxas -v's registers and spills of the kept mcmc_measure kernels."""
    from mcintegration_tpu_torch.ops import _build
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                           str(_build.BUILD_DIR / "ptxas.o"), str(_build.CSRC / MEASURE)],
                          capture_output=True, text=True)
    return [ln for ln in (proc.stdout + proc.stderr).splitlines()
            if "Compiling entry" in ln or "registers" in ln or "spill" in ln]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mcmc_variants: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    import mcintegration_tpu_torch as mt
    from mcintegration_tpu_torch.ops import _build, mcmc_kernels as mk

    card = cs.card_line()
    root = sys.argv[sys.argv.index("--baseline") + 1] if "--baseline" in sys.argv else None
    kept = _build.load()
    print("\n".join(ptxas_lines()), flush=True)
    it, args, st0 = bubble_state(mt, mk)
    mcases = measure_cases(mt, it, st0)
    vs = variants(it.layout)
    abl = [(name, edits, mk.SMEM_HIST_BINS, mk.SMEM_COUNTERS) for name, edits in ablations()]
    libs = build(vs + abl)
    hist, cnt = mk.SMEM_HIST_BINS, mk.SMEM_COUNTERS
    roles = np.bincount(st0.move[0].cpu().numpy(), minlength=5).tolist()
    print(f"the bubble at 2^18 walkers after 400 steps (roles none/CV/swap/CI/NJ of the "
          f"last step {roles}); phase 3c's spec at 2^20 walkers after 64 steps; device ms "
          f"per call, warm: median of 3 x 20, flushed: chip_smoke.flushed_ms [{card}]",
          flush=True)
    both = {"step", "measure"}
    ends = [("kept", kept, hist, cnt, both, False)]
    if root:
        lib, one_sector = baseline(root)
        ends.insert(0, ("baseline", lib, hist, cnt, both, one_sector))
    unchecked = {name for name, _, _, _ in abl}
    runs = list(ends)
    for (name, edits, h, c), lib in zip(vs + abl, libs):
        files = {f for f, _, _ in edits}
        kinds = ({"measure"} if MEASURE in files else set()) | (
            {"step"} if files - {MEASURE} or not edits else set())
        runs.append((name, lib or kept, h, c, kinds, False))
    runs += [(name + ", again", *rest) for name, *rest in ends[::-1]]
    bad = []
    for name, lib, h, c, kinds, one_sector in runs:
        _build._lib, mk.SMEM_HIST_BINS, mk.SMEM_COUNTERS = lib, h, c
        cells = []
        try:
            with baseline_measure(mk, lib, one_sector):
                if "step" in kinds:
                    prop, acc, acc_u, err = run_one(it, mk, args, st0)
                    cells.append(f"propose {prop!r}, accept measured {acc!r}, unmeasured "
                                 f"{acc_u!r} ms (err {err:.3g})")
                    if err != 0.0:
                        bad.append(name)
                for case in mcases if "measure" in kinds else ():
                    warm, flushed, err = measure_run(mk, case, name not in unchecked)
                    cells.append(f"measure {case[0]} {warm!r} warm, {flushed!r} flushed "
                                 f"(err {err:.3g})")
                if "measure" in kinds:
                    per = step_profile(it, mk, args, st0)
                    cells.append("per launch in 100 measured steps: " + ", ".join(
                        f"{k} {v!r}" for k, v in per.items()))
        except (AssertionError, RuntimeError) as e:
            cells.append(f"FAILED: {e}")
            bad.append(name)
        print(f"{name}: " + "; ".join(cells), flush=True)
    _build._lib, mk.SMEM_HIST_BINS, mk.SMEM_COUNTERS = kept, hist, cnt
    probe(mt, mk, card)
    if bad:
        print(f"mcmc_variants: failed or differ from the plain versions: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
