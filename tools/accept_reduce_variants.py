"""Variants of ``chain_accept``, ``vplus_reduce``, ``chain_propose`` and ``vegas_reduce_mixed``, timed on the card beside the kept kernels.

Builds the kernel library of ``mcintegration_tpu_torch/csrc`` as it stands,
then one library per variant: a copy of the sources with a few lines of
``chain_accept.cu``, ``vplus_reduce.cu``, ``chain_propose.cu`` or
``vegas_mixed.cu`` rewritten
(threads per block and blocks per SM, the register cache of pair products
and pads, the grid's waves, the merge of a warp's lanes before a histogram
add, a large histogram's adds into device memory; threads per block, an
integer division by wb, the layout read from device memory; the complex
default's blocks per SM and chunks taken at once, vplus_relw's blocks per
SM, scalar accesses and layout staged in shared memory).  Other variants
keep the library and move a histogram between shared memory and device
memory or windows of shared memory (``SMEM_HIST_BINS``).  Ablations take a
part of a kept kernel out (results wrong, so unchecked) to price it.  With
``--baseline DIR``, the kernels of another checkout at ``DIR`` (its
``csrc``, its ``SMEM_HIST_BINS`` and its ``vplus_relw`` block) run first
and last, in turns with the
kept ones; the baseline is held to the tolerances without failing the run.

Cases, at ``chip_smoke.py``'s shapes: ``chain_accept`` on a measured step of
2^20 walkers of phase 6b (the quarter disc), of phase 6e (writing relw for
the 10-bin histogram) and of phase 6f (complex weights), and phase 6b's
state with every walker in one histogram bin; ``vplus_reduce`` on one
launch of phase 6d (``singular_3d``, 2^26 samples), the same launch with
every sample of the first span in one bin, phase 3d's all-branch spec, and
that spec with ninc = 5000 (more than SMEM_HIST_BINS bins), and given the
10-bin histogram's output at phase 6g's launch (the quickstart's problem,
2^26 samples, 10 components; real and complex weights, with and without
the gate of measurefreq 4; also at 1 and 3 components), ``vplus_relw`` on
that launch (real and complex weights, bit for bit) and the complex
default observables on phase 6g's quarter disc times e^{i(x+y)} (with and
without the gate);
``chain_propose`` on a step of 2^20 walkers of phase 6b and of phase 3b's
spec (a staged Discrete CDF); ``vegas_reduce_mixed`` (and
``vegas_relw_mixed``) at phase 6h's bubble launch (2^26 samples, 5 slots,
4 measure components) in every instantiation (real and complex weights;
the default observables and given m, each with and without the gate of
measurefreq 4; relw), and the default observables of phase 4h's
mixed-``ninc`` launch.  A variant runs the cases
of the kernels it changes (the kept and the baseline kernels all; with
``--only FILES``, a comma-separated list of the sources above, only the
variants and cases of those).  Each is held against its
plain version (bit for bit but the histograms and ``sig``: rel 1e-9 and
1e-12; the mixed reduce's obs to REL_TOL_REDUCE) and timed on the device
with the calls queued behind a sleep kernel, the median of three runs of
20 calls (10 for ``vplus_reduce`` and the mixed route).
Before the runs it prints each library's count of
64-bit compare-and-swap loops (``ATOMS.CAST.SPIN.64`` in ``cuobjdump
-sass``) and of instructions per kernel, and what ``ptxas -v`` says of the
kept kernels' registers and spills.

    python3 tools/accept_reduce_variants.py [--baseline DIR] [--only FILES] [--ablations]

on a CUDA card (``--ablations``: the ablations alone, no variants).

It prints one line per variant and case and exits non-zero if a variant
fails to build or differs from the plain versions.
"""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402  (the configurations, timers and checks)
import mcmc_variants as mv  # noqa: E402  (the variant builder)

ACCEPT, REDUCE, PROPOSE = "chain_accept.cu", "vplus_reduce.cu", "chain_propose.cu"
MIXED = "vegas_mixed.cu"
SOURCES = (ACCEPT, REDUCE, PROPOSE, MIXED)
KERNELS = ("chain_accept_kernel", "vplus_reduce_kernel", "vplus_reduce_complex_kernel",
           "vplus_relw_kernel", "chain_propose_kernel", "vegas_reduce_mixed_kernel")
# vplus_reduce's histogram adds, and the same with a warp's lanes merged per bin
REDUCE_ADD = ("        const int bin = cb >= 0 ? off + gidx[k * plane + at] - hlo : -1;\n"
              "        if (bin < 0 || bin >= HW) continue;\n"
              "        atomicAdd(hist_s + bin, sq);\n")
# a histogram beyond SMEM_HIST_BINS added into device memory (no windows),
# a warp's lanes merged per bin first (the complex default's lanes not)
DEVICE_MERGED = [
    (REDUCE, REDUCE_ADD,
     "        const int bin = cb >= 0 ? off + gidx[k * plane + at] : -1;\n"
     "        double v = sq;\n"
     "        if (hist_smem) {\n"
     "          if (bin >= 0) atomicAdd(hist_s + bin, sq);\n"
     "        } else if (merge_by_key(kFull, bin, v) && bin >= 0) {\n"
     "          atomicAdd(hist + bin, v);\n"
     "        }\n"),
    (REDUCE, "of hist; window 0 also writes obs and sig\n  const int HW = hist_smem ? H : kWindow;",
     "of hist; window 0 also writes obs and sig\n  const int HW = hist_smem ? H : 0;"),
    (REDUCE, "  const int nwin = hist_smem ? 1 : (H + kWindow - 1) / kWindow;\n"
             "  *smem = (size_t)(hist_smem ? H : kWindow) * sizeof(double);",
     "  const int nwin = 1;\n  *smem = (size_t)(hist_smem ? H : 0) * sizeof(double);"),
    # the complex default's adds, as they were, into device memory beyond it
    (REDUCE, "const long long plane = BT * c;\n  const int HW = hist_smem ? H : kWindow;",
     "const long long plane = BT * c;\n  const int HW = hist_smem ? H : 0;"),
    (REDUCE, "          if (bin >= 0 && bin < HW) atomicAdd(hist_s + bin, (double)sq[u]);",
     "          if (bin >= 0 && !hist_smem) atomicAdd(hist + bin, (double)sq[u]);\n"
     "          else if (bin >= 0 && bin < HW) atomicAdd(hist_s + bin, (double)sq[u]);")]


def variants():
    """(name, source edits, {constant of ops/chain_kernels.py or
    ops/vplus_kernels.py: value}) of each variant."""
    return [
        ("accept 512 threads x 2 blocks per SM",
         [(ACCEPT, "constexpr int kThreads = 256;", "constexpr int kThreads = 512;"),
          (ACCEPT, "constexpr int kBlocksPerSm = 4;", "constexpr int kBlocksPerSm = 2;")], {}),
        ("accept cache of 4", [(ACCEPT, "constexpr int kCache = 2;",
                                "constexpr int kCache = 4;")], {}),
        ("accept without prefetches",
         [(ACCEPT, "    if (!init) {\n      const int qm = tb.gbase[move[w]]",
           "    if (false) {\n      const int qm = tb.gbase[move[w]]"),
          (ACCEPT, "if (w + stride < W) {", "if (false) {")], {}),
        ("accept histogram in device memory", [], {"chain SMEM_HIST_BINS": 0}),
        ("accept adding through a generic pointer",
         [(ACCEPT, "            if (hist_smem)   // two adds, each to an address space the compiler "
                   "knows\n              atomicAdd(hs + bin, v);\n            else\n"
                   "              atomicAdd(hist + bin, v);",
           "            atomicAdd((hist_smem ? hs : hist) + bin, v);")], {}),
        ("accept, lanes not merged",
         [(ACCEPT, "if (merge_by_key(__activemask(), bin, v)) {", "{")], {}),
        ("reduce warps on consecutive samples",
         [(REDUCE, "const int s = (warp * gridDim.x + blockIdx.x) * 32 + lane;",
           "const int s = blockIdx.x * kSpan + threadIdx.x;")], {}),
        ("reduce, windows of SMEM_HIST_BINS bins for every histogram", [],
         {"vplus SMEM_HIST_BINS": 0}),
        ("reduce, device-memory adds beyond SMEM_HIST_BINS, lanes merged", DEVICE_MERGED, {}),
        ("reduce, device-memory adds for every histogram, lanes merged", DEVICE_MERGED,
         {"vplus SMEM_HIST_BINS": 0}),
        ("reduce, lanes merged",
         [(REDUCE, REDUCE_ADD,
           "        const int bin = cb >= 0 ? off + gidx[k * plane + at] - hlo : -1;\n"
           "        double v = sq;\n"
           "        if (!merge_by_key(kFull, bin, v) || bin < 0 || bin >= HW) continue;\n"
           "        atomicAdd(hist_s + bin, v);\n")], {}),
        ("reduce prefetching the next chunk into L2",
         [(REDUCE, "    const long long at = bt * c + s;\n",
           "    const long long at = bt * c + s;\n"
           "    for (int k = 0; k < S && cb >= 0 && bt + gridDim.y < BT; ++k)\n"
           "      prefetch_l2(gidx + k * plane + at + gridDim.y * (long long)c);\n"
           "    for (int i = 0; i < N && cb >= 0 && bt + gridDim.y < BT; ++i)\n"
           "      prefetch_l2(w + i * plane + at + gridDim.y * (long long)c);\n")], {}),
        ("reduce grid of 4 waves", [(REDUCE, "constexpr int kWaves = 8;",
                                     "constexpr int kWaves = 4;")], {}),
        ("reduce given m, one component's loads at a time",
         [(REDUCE, "constexpr int kBatch = 4; ", "constexpr int kBatch = 1; ")], {}),
        ("reduce given m, each chunk's sums alone",
         [(REDUCE, "constexpr int kChunks = 4; ", "constexpr int kChunks = 1; "),
          (REDUCE, "  static_assert(kChunks * 8 == 32, \"8 lanes a chunk, 4 terms a lane\");\n",
           "")], {}),
        ("reduce given m at 4 blocks an SM",
         [(REDUCE, "constexpr int kMeasureBlocks = 6; ", "constexpr int kMeasureBlocks = 4; ")],
         {}),
        ("reduce given m at 8 blocks an SM",
         [(REDUCE, "constexpr int kMeasureBlocks = 6; ", "constexpr int kMeasureBlocks = 8; ")],
         {}),
        ("reduce given m, 8 components' loads in flight",
         [(REDUCE, "constexpr int kBatch = 4; ", "constexpr int kBatch = 8; ")], {}),
        ("reduce given m, streaming loads of m",
         [(REDUCE, "t[b][r] = q0 + b < ncomp && in[r] ? m[8 * r] : 0.0f;",
           "t[b][r] = q0 + b < ncomp && in[r] ? __ldcs(m + 8 * r) : 0.0f;")], {}),
        ("reduce complex at 4 blocks an SM",
         [(REDUCE, "constexpr int kCplxBlocks = 8; ", "constexpr int kCplxBlocks = 4; ")], {}),
        ("reduce complex at 6 blocks an SM",
         [(REDUCE, "constexpr int kCplxBlocks = 8; ", "constexpr int kCplxBlocks = 6; ")], {}),
        ("reduce complex, 2 chunks at once",
         [(REDUCE, "constexpr int kCplxChunks = 4; ", "constexpr int kCplxChunks = 2; ")], {}),
        ("reduce complex, 1 chunk at once",
         [(REDUCE, "constexpr int kCplxChunks = 4; ", "constexpr int kCplxChunks = 1; ")], {}),
        ("relw at 6 blocks an SM",
         [(REDUCE, "constexpr int kRelwBlocks = 8; ", "constexpr int kRelwBlocks = 6; ")], {}),
        ("relw, scalar accesses",
         [(REDUCE, "const bool full = vec && s0 + kQuad <= c;", "const bool full = false;")], {}),
        ("relw, layout staged in shared memory",
         [(REDUCE, "  const long long bt = blockIdx.x / nspan;\n",
           "  extern __shared__ int lay[];\n"
           "  for (int q = threadIdx.x; q < kSlotFields * S + N * P + P * M; q += blockDim.x)\n"
           "    lay[q] = meta[q];\n  __syncthreads();\n"
           "  slots = lay, pad = slots + kSlotFields * S, pair_slots = pad + N * P;\n"
           "  const long long bt = blockIdx.x / nspan;\n"),
          (REDUCE, "<<<(unsigned)(BT * nspan), kRelwThreads, 0,",
           "<<<(unsigned)(BT * nspan), kRelwThreads, (kSlotFields * S + N * P + P * M) * 4,")],
         {}),
        ("reduce complex, the gate in 64-bit remainders",
         [(REDUCE, "        if (gate_open(t0 + tb, s, shift ? shift[bt] : 0, c, mf)) on |= 1u << u;",
           "        if (((t0 + bt % T) * (long long)c + ((long long)s + (shift ? shift[bt] : 0)) % c"
           " + 1) % mf == 0) on |= 1u << u;")], {}),
        ("reduce complex at 5 blocks an SM",
         [(REDUCE, "constexpr int kCplxBlocks = 8; ", "constexpr int kCplxBlocks = 5; ")], {}),
        ("reduce complex at 7 blocks an SM",
         [(REDUCE, "constexpr int kCplxBlocks = 8; ", "constexpr int kCplxBlocks = 7; ")], {}),
        ("mixed, bins read again from device memory",
         [(MIXED, "constexpr int kStash = 8; ", "constexpr int kStash = 0; ")], {}),
        ("propose 128 threads a block", [(PROPOSE, "constexpr int kThreads = 256;",
                                          "constexpr int kThreads = 128;")], {}),
        ("propose 512 threads a block", [(PROPOSE, "constexpr int kThreads = 256;",
                                          "constexpr int kThreads = 512;")], {}),
        ("propose 8 blocks per SM", [(PROPOSE, "constexpr int kBlocksPerSm = 4;",
                                      "constexpr int kBlocksPerSm = 8;")], {}),
        ("propose, integer division by wb",
         [(PROPOSE, "const int b = (int)divide((uint32_t)w, mulwb, shwb);",
           "const int b = w / wb;")], {}),
        ("propose, layout read from device memory",
         [(PROPOSE, "  int* leaf = reinterpret_cast<int*>(smem + smem_floats);   // [L, 8]",
           "  const int* leaf = meta;   // [L, 8]"),
          (PROPOSE, "  for (int q = threadIdx.x; q < nint; q += blockDim.x) leaf[q] = meta[q];\n",
           "")], {}),
    ]


def ablations():
    """(name, source edits) of each ablation: a part of a kept kernel taken
    out, to time what it costs; the results are wrong, so they are not
    checked."""
    return [
        ("accept without histogram adds",
         [(ACCEPT, "if (merge_by_key(__activemask(), bin, v)) {", "if (v == -1.0) {")]),
        ("accept without the slot copy",
         [(ACCEPT, "for (int n = tb.pstart[qm]; n < tb.pstart[qm + 1]; ++n) {\n      const "
                   "long long i = (long long)tb.prow[n] * W + w;\n      float pb;",
           "for (int n = tb.pstart[qm]; n < tb.pstart[qm]; ++n) {\n      const "
           "long long i = (long long)tb.prow[n] * W + w;\n      float pb;")]),
        ("reduce without histogram adds",
         [(REDUCE, "        if (bin < 0 || bin >= HW) continue;",
           "        if (sq != -1.0) continue;")]),
        ("reduce without the density loop",
         [(REDUCE, "    if (cb >= 0) {\n      float prob = 1.0f, pass = 1.0f;",
           "    if (cb < -1) {\n      float prob = 1.0f, pass = 1.0f;")]),
        ("reduce without the integrand loop",
         [(REDUCE, "    for (int i = 0; i < N; ++i) {\n      double so = 0.0, sq = 0.0;",
           "    for (int i = 0; i < 0; ++i) {\n      double so = 0.0, sq = 0.0;")]),
        ("reduce without the density's gathers",
         [(REDUCE, "const float rho = slot_rho(f, tab, gidx[k * plane + at]);",
           "const float rho = slot_rho(f, tab, 0);")]),
        ("reduce without the padding loop",
         [(REDUCE, "        for (int g = 0; g < P; ++g) {\n          if (!pad[i * P + g]) continue;",
           "        for (int g = 0; g < 0; ++g) {\n          if (!pad[i * P + g]) continue;")]),
        ("reduce complex without the square roots",
         [(REDUCE, "__fmul_rn(wi.abs(), pad_i[u])", "__fmul_rn(wi.re, pad_i[u])"),
          (REDUCE, "float r = relw.abs();", "float r = relw.re;")]),
        ("reduce complex without the observables' sums",
         [(REDUCE, "      const double part = tree_sums(t);", "      const double part = t[0];")]),
        ("reduce complex without sig's segmented sum",
         [(REDUCE, "flush, as vplus_reduce_kernel's\n  const int lane = threadIdx.x & 31;\n"
                   "  for (int o = 1; o < 32; o <<= 1) {",
           "flush, as vplus_reduce_kernel's\n  const int lane = threadIdx.x & 31;\n"
           "  for (int o = 32; o < 32; o <<= 1) {")]),
        ("reduce complex without the density's gathers",
         [(REDUCE, "const float rho = slot_rho(f, tab, gidx[k * plane + at0 + u * cstep]);",
           "const float rho = slot_rho(f, tab, 0);")]),
        ("reduce complex without the padding loop",
         [(REDUCE, "      for (int g = 0; g < P; ++g) {\n        if (!pad[i * P + g]) continue;",
           "      for (int g = 0; g < 0; ++g) {\n        if (!pad[i * P + g]) continue;")]),
        ("reduce complex without histogram adds",
         [(REDUCE, "if (bin >= 0 && bin < HW) atomicAdd(hist_s + bin, (double)sq[u]);",
           "if (bin == -2) atomicAdd(hist_s + bin, (double)sq[u]);")]),
        ("relw without the density's gathers",
         [(REDUCE, "const float rho = slot_rho(f, tab, g[v]);", "const float rho = slot_rho(f, tab, 0);")]),
        ("relw without the padding loop",
         [(REDUCE, "    for (int g = 0; g < P; ++g) {\n      if (!pad[i * P + g]) continue;",
           "    for (int g = 0; g < 0; ++g) {\n      if (!pad[i * P + g]) continue;")]),
        ("relw without the density",
         [(REDUCE, "  for (int k = 0; k < S; ++k) {\n    const int* f = slots + kSlotFields * k;\n"
                   "    const bool disc = f[kKind] == kDisc;\n    any_pass |= disc;\n    int g[kQuad];",
           "  for (int k = 0; k < 0; ++k) {\n    const int* f = slots + kSlotFields * k;\n"
           "    const bool disc = f[kKind] == kDisc;\n    any_pass |= disc;\n    int g[kQuad];")]),
        ("reduce given m without the component sums",
         [(REDUCE, "  for (int q0 = 0; q0 < ncomp; q0 += kBatch) {",
           "  for (int q0 = 0; q0 < 0; q0 += kBatch) {")]),
        ("mixed without the component sums",
         [(MIXED, "      for (int q = 0; q < ncomp; ++q) {\n        float m[kPerThread];",
           "      for (int q = 0; q < 0; ++q) {\n        float m[kPerThread];")]),
        ("mixed without histogram adds",
         [(MIXED, "          hist_add_runs(hist_s, key, sq);",
           "          if (key[0] == -2) hist_s[0] = sq[0];")]),
        ("mixed without the padding loop",
         [(MIXED, "      for (int pp = 0; pp < P; ++pp) {",
           "      for (int pp = 0; pp < 0; ++pp) {")]),
        ("mixed, jac from a single slot",
         [(MIXED, "        jac[v] = k == 0 ? ip : __fmul_rn(jac[v], ip);",
           "        jac[v] = k == 0 ? ip : jac[v];")]),
        ("propose, every slot stored in the row of slot 0",
         [(PROPOSE, "const long long i = (long long)(f[5] + s) * W + w;",
           "const long long i = (long long)f[5] * W + w;")]),
        ("propose without the slot's stores",
         [(PROPOSE, "\n    prp_val[i] = val;\n    prp_gidx[i] = gidx;\n    prp_prob[i] = prob;\n",
           "\n")]),
        ("propose without the old probability's load",
         [(PROPOSE, "prop = __fmul_rn(prop, __fdiv_rn(cur_prob[i], prob));",
           "prop = __fmul_rn(prop, __fdiv_rn(1.0f, prob));")]),
    ]


def kernel_name(mangled):
    """The short name of a kernel instantiation in the SASS, with its
    template arguments (``vplus_reduce_kernel<0,1,0>``: real, given m,
    ungated), or None."""
    base = next((k for k in KERNELS if k in mangled), None)
    if base is None:
        return None
    args = re.findall(r"L[ib](\d+)E", mangled)
    return base + (f"<{','.join(args)}>" if args else "")


def sass_counts(lib_path):
    """{kernel instantiation: (count of ATOMS.CAST.SPIN.64, of
    instructions)} in the SASS of a library."""
    from mcintegration_tpu_torch.ops import _build
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = kernel_name(m.group(1))
            if name:
                counts.setdefault(name, [0, 0])
        elif name and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            counts[name][1] += 1
            counts[name][0] += "ATOMS.CAST.SPIN.64" in line
    return {k: tuple(v) for k, v in counts.items()}


def ptxas_report(csrc):
    """ptxas -v's lines on the kernels of chain_accept.cu, vplus_reduce.cu,
    chain_propose.cu and vegas_mixed.cu."""
    from mcintegration_tpu_torch.ops import _build
    out = []
    for src in SOURCES:
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                               "-o", str(_build.BUILD_DIR / "ptxas.o"), str(Path(csrc) / src)],
                              capture_output=True, text=True)
        out += [ln for ln in (proc.stdout + proc.stderr).splitlines()
                if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
    return out


def build_from(csrc, name):
    """The library of the sources in directory ``csrc``."""
    from mcintegration_tpu_torch.ops import _build
    nvcc, flags = _build._nvcc(), _build.NVCC_FLAGS
    out = _build.BUILD_DIR / name
    out.mkdir(parents=True, exist_ok=True)
    srcs = sorted(Path(csrc).glob("*.cu"))
    objs = [out / f"{s.stem}.o" for s in srcs]
    mv.compile_all([([nvcc, *flags, "-c", "-o", str(o), str(s)], f"{name}: {s.name}")
                    for s, o in zip(srcs, objs)])
    lib = out / "lib.so"
    subprocess.run([nvcc, *_build.ARCH_FLAGS, "-shared", "-o", str(lib), *map(str, objs)],
                   check=True, capture_output=True)
    return lib


def chain_cases(mt):
    """(name, layout, tab, rw, kd, state, nw, measure) of chain_accept's cases."""
    from mcintegration_tpu_torch.solvers.engine import Spec
    from mcintegration_tpu_torch.solvers.vegasmc import VegasMCIteration

    kw = dict(block=16, nevalperblock=2 ** 24, nwalkers=2 ** 20)
    pi = VegasMCIteration(Spec(mt.Configuration(var=mt.Continuous(0.0, 1.0), dof=[[2]],
                                                seed=cs.SEED), "cuda"), cs._pi, **kw)
    cplx = VegasMCIteration(Spec(mt.Configuration(var=mt.Continuous(0.0, 1.0), dof=[[2]],
                                                  seed=cs.SEED, type=complex), "cuda"),
                            cs._qdisc, **kw)
    _, qs = cs.qs_iterations(mt)
    out = []
    for name, it in (("6b", pi), ("6b unmeasured", pi), ("6b init", pi), ("6e relw", qs),
                     ("6f complex", cplx), ("6b hot bin", pi)):
        tab, rw, kd, st = cs.chain_measured_state(it)
        if name.endswith("hot bin"):
            cs.one_bin(st)
        mode = "init" if "init" in name else "unmeasured" not in name
        out.append((name, it.layout, tab, rw, kd, st, it.weights(st), mode))
    return out


def chain_run(ck, case, check=True):
    """(ms, max abs err) of chain_accept on one case; unchecked: (ms, 0)."""
    import torch
    name, lay, tab, rw, kd, st0, nw, mode = case
    kw = dict(init=True) if mode == "init" else dict(measure=mode)
    st, ref = st0.clone(), st0.clone()
    err = 0.0
    if check:
        ck.chain_accept(lay, rw, kd, 4, st, nw, **kw)
        ck.chain_accept_plain(lay, rw, kd, 4, ref, nw, **kw)
        torch.cuda.synchronize()
        err = cs.state_bits_equal(st, ref, f"chain_accept, {name}")
    ms = float(np.median([cs.device_ms(
        lambda: ck.chain_accept(lay, rw, kd, 5, st, nw, **kw), 20) for _ in range(3)]))
    return ms, err


def vplus_cases(mt, vp):
    """(name, layout, tab, w, gidx, cube, cfac, m, mf, t0, shift) of
    vplus_reduce's cases (m None: the default observables)."""
    import torch
    from mcintegration_tpu_torch.ops.rng import block_keys
    from mcintegration_tpu_torch.solvers.engine import Spec
    from mcintegration_tpu_torch.solvers.vegasplus import VegasPlusIteration

    cfg = mt.Configuration(var=mt.Continuous(0.0, np.pi), dof=[[3]], seed=cs.SEED)
    main = VegasPlusIteration(Spec(cfg, "cuda"), cs._sing3, block=16, nevalperblock=2 ** 26)
    out = []
    for name, it in (("6d", main), ("3d all-branch", cs.vplus_allbranch(mt, 2 ** 20)),
                     ("3d all-branch, ninc 5000", cs.vplus_allbranch(mt, 2 ** 20, ninc=5000))):
        params = it.spec.device_params()
        it.reallocate(it.run(params, block_keys(cs.SEED, 0, 0, it.block))["sig"])
        lay = it.layout
        tab, kd = lay.tables(params), it.seeds(block_keys(cs.SEED, 1, 0, it.block))
        cube, cfac = it.cube_tables()
        x, gidx = vp.vplus_sample(lay, tab, kd, 0, it.chunks_per_launch, cube)
        w = it.evaluate(lay.leaf_values(x)).contiguous()
        del x
        out.append((name, lay, tab, w, gidx, cube, cfac, None, 1, 0, None))
        if name == "6d":
            out.append(("6d hot span", lay, tab, w, cs.one_bin_span(gidx), cube, cfac, None, 1,
                        0, None))
    # phase 6g: given the 10-bin histogram's output on the quickstart's
    # problem, real and complex weights (w + 0.5iw), with and without the gate
    qs = mt.Configuration(var=(mt.Continuous(0.0, 1.0), mt.Continuous(0.0, 1.0)), dof=[[1, 1]],
                          obs=[np.zeros(cs.NBIN)], seed=cs.SEED)
    it, lay, tab, cube, cfac, x, gidx, w, t0, T = cs.vplus_branch_launch(
        mt, vp, qs, cs._qs_f, cs.VEGAS_NEVAL // 16, cs.hist_measure(cs.NBIN), qs.observable)
    m = it.measure(lay.leaf_values(x), vp.vplus_relw(lay, tab, w, gidx, cube, cfac)).contiguous()
    del x
    shift = vp.gate_shifts(it.seeds(block_keys(cs.SEED, 1, 0, it.block)), t0, T, it.chunk)
    for kind, ww in (("real", w), ("complex", torch.complex(w, w * 0.5).contiguous())):
        for mf, sh in ((1, None), (4, shift)):
            out.append((f"6g {kind}, given m, mf {mf}", lay, tab, ww, gidx, cube, cfac, m, mf, t0,
                        sh))
    for q in (1, 3):
        out.append((f"6g real, given m of {q} components", lay, tab, w, gidx, cube, cfac,
                    m[:q].contiguous(), 1, t0, None))
    # vplus_relw at the same launch, real and complex weights
    for kind, ww in (("real", w), ("complex", torch.complex(w, w * 0.5).contiguous())):
        out.append((f"6g {kind}, relw", lay, tab, ww, gidx, cube, cfac, None, 1, t0, None))
    # the complex default observables on the quarter disc times e^{i(x+y)}
    # (phase 6g's vplus_reduce_complex), with and without the gate
    pi_c = mt.Configuration(var=mt.Continuous(0.0, 1.0), dof=[[2]], seed=cs.SEED, type=complex)
    it, lay, tab, cube, cfac, x, gidx, w, t0, T = cs.vplus_branch_launch(
        mt, vp, pi_c, cs._qdisc, cs.VEGAS_NEVAL // 16)
    del x
    shift = vp.gate_shifts(it.seeds(block_keys(cs.SEED, 1, 0, it.block)), t0, T, it.chunk)
    for mf, sh in ((1, None), (4, shift)):
        out.append((f"6g complex, default, mf {mf}", lay, tab, w, gidx, cube, cfac, None, mf, t0,
                    sh))
    return out


def vplus_run(vp, case, check=True, strict=True):
    """(ms, max rel err) of vplus_reduce (or, for a name ending in "relw",
    vplus_relw) on one case; unchecked: (ms, 0).  Raises beyond REL_TOL_VPLUS
    (relw: unless bit for bit) when ``strict``."""
    import torch
    name, lay, tab, w, gidx, cube, cfac, m, mf, t0, shift = case
    relw = name.endswith("relw")
    if relw:
        fn = lambda: vp.vplus_relw(lay, tab, w, gidx, cube, cfac)
    else:
        fn = lambda: vp.vplus_reduce(lay, tab, w, gidx, cube, cfac, m, mf, t0, shift)
    rel, tol = 0.0, 0.0 if relw else cs.REL_TOL_VPLUS
    if check and relw:
        got, want = fn(), vp.vplus_relw_plain(lay, tab, w, gidx, cube, cfac)
        rel = 0.0 if torch.equal(cs.bits(got), cs.bits(want)) else np.inf
        del got, want
    elif check:
        got = fn()
        want = vp.vplus_reduce_plain(lay, tab, w, gidx, cube, cfac, m, mf, t0, shift)
        torch.cuda.synchronize()
        rel = max(cs.rel_err(a.cpu(), b.cpu()) for a, b in zip(got, want))
    if rel > tol and strict:
        raise AssertionError(f"vplus_reduce, {name}: rel {rel:.3g} > {tol}")
    ms = float(np.median([cs.device_ms(fn, 10) for _ in range(3)]))
    return ms, rel


def mixed_cases(mt, vk):
    """(name, layout, tab, w, gidx, m, mf, t0) of vegas_reduce_mixed's cases
    (m None: the default observables; a name ending in "relw":
    vegas_relw_mixed), with the plain version's output on the host: phase
    6h's bubble launch, real and complex weights, each instantiation; phase
    4h's mixed-ninc launch, the default observables."""
    import torch

    out = []
    for cplx in (False, True):
        kw = cs.vegas_bubble_kw(mt, cplx)
        it, lay, tab, kd, t0, T, x, gidx, w = cs.mixed_launch(
            mt, kw["var"], kw["dof"], None, cs.VEGAS_NEVAL // 16, 16, None, cplx=cplx,
            measure=kw["measure"], obs=kw["obs"])
        relw = vk.vegas_relw_mixed(lay, tab, w, gidx)
        m = it.measure(lay.leaf_values(x), relw).contiguous()
        del x, relw
        kind = "complex" if cplx else "real"
        for mf in (1, 4):
            for given in (None, m):
                out.append((f"6h {kind}, {'given m' if given is not None else 'default'}, mf {mf}",
                            lay, tab, w, gidx, given, mf, t0))
        out.append((f"6h {kind}, relw", lay, tab, w, gidx, None, 1, t0))
    C = mt.Continuous
    _, lay, tab, _, t0, _, x, gidx, w = cs.mixed_launch(
        mt, (C(0.0, 1.0, ninc=1024), C(0.0, 1.0, ninc=512), C(0.0, 1.0, ninc=1000)),
        [[1, 1, 1]], cs._logxyz, cs.VEGAS_NEVAL // 16, 16, None)
    del x
    out.append(("4h mixed ninc, default, mf 1", lay, tab, w, gidx, None, 1, t0))
    cases = []
    for case in out:
        name, lay, tab, w, gidx, m, mf, t0 = case
        want = vk.vegas_relw_mixed_plain(lay, tab, w, gidx) if name.endswith("relw") else \
            vk.vegas_reduce_mixed_plain(lay, tab, w, gidx, m, mf, t0)
        torch.cuda.synchronize()
        cases.append((*case, [t.cpu() for t in ((want,) if torch.is_tensor(want) else want)]))
        del want
    return cases


def mixed_run(vk, case, check=True, strict=True):
    """(ms, max rel err) of vegas_reduce_mixed (or vegas_relw_mixed) on one
    case; unchecked: (ms, 0).  Raises beyond the tolerances when
    ``strict``: relw bit for bit, obs REL_TOL_REDUCE, histograms
    REL_TOL_VPLUS."""
    import torch
    name, lay, tab, w, gidx, m, mf, t0, want = case
    if name.endswith("relw"):
        fn = lambda: vk.vegas_relw_mixed(lay, tab, w, gidx)
        tols = (0.0,)
    else:
        fn = lambda: vk.vegas_reduce_mixed(lay, tab, w, gidx, m, mf, t0)
        tols = (cs.REL_TOL_REDUCE, cs.REL_TOL_VPLUS)
    rel = 0.0
    if check:
        got = fn()
        got = (got,) if torch.is_tensor(got) else got
        torch.cuda.synchronize()
        if name.endswith("relw"):
            rels = [0.0 if torch.equal(cs.bits(got[0]).cpu(), cs.bits(want[0])) else np.inf]
        else:
            rels = [cs.rel_err(a.cpu(), b) for a, b in zip(got, want)]
        rel = max(rels)
        if strict and any(r > t for r, t in zip(rels, tols)):
            raise AssertionError(f"vegas_reduce_mixed, {name}: rel {rels} beyond {tols}")
        del got
    ms = float(np.median([cs.device_ms(fn, 10) for _ in range(3)]))
    return ms, rel


def propose_cases(mt):
    """(name, layout, tab, kd, state) of chain_propose's cases: the state
    after four steps at 2^20 walkers of phase 6b (the quarter disc) and of
    phase 3b's spec (ninc=1024 and a staged Discrete(1, 100) CDF)."""
    from mcintegration_tpu_torch.ops.rng import block_keys
    from mcintegration_tpu_torch.solvers.engine import Spec
    from mcintegration_tpu_torch.solvers.vegasmc import VegasMCIteration

    kw = dict(block=16, nevalperblock=2 ** 24, nwalkers=2 ** 20)
    pi = VegasMCIteration(Spec(mt.Configuration(var=mt.Continuous(0.0, 1.0), dof=[[2]],
                                                seed=cs.SEED), "cuda"), cs._pi, **kw)
    two = VegasMCIteration(Spec(cs.chain_config(mt), "cuda"), cs._chain_two, **kw)
    out = []
    for name, it in (("6b", pi), ("3b spec", two)):
        kd = it.seeds(block_keys(cs.SEED, 0, 0, it.block))
        tab, rw, st = it.start(it.spec.device_params(), kd)
        for t in range(4):
            it.step(tab, rw, kd, st, t)
        out.append((name, it.layout, tab, kd, st))
    return out


def propose_run(ck, case, check=True):
    """(ms, max abs err) of chain_propose on one case; unchecked: (ms, 0)."""
    import torch
    name, lay, tab, kd, st0 = case
    st, ref = st0.clone(), st0.clone()
    err = 0.0
    if check:
        ck.chain_propose(lay, tab, kd, 4, st)
        ck.chain_propose_plain(lay, tab, kd, 4, ref)
        torch.cuda.synchronize()
        err = cs.state_bits_equal(st, ref, f"chain_propose, {name}")
    ms = float(np.median([cs.device_ms(lambda: ck.chain_propose(lay, tab, kd, 5, st), 20)
                          for _ in range(3)]))
    return ms, err


def baseline(root):
    """(library, {constant of the wrappers: its value}) of checkout
    ``root``, whose kernels take the same arguments: the chain and vplus
    SMEM_HIST_BINS, the mixed reduce's SPAN (samples of a chunk a block,
    which sizes its partials) and vplus_relw's block (RELW_SPAN and
    RELW_WARPS, or before vplus_relw had a kernel of its own the reduce's
    SPAN and WARPS, which its entry checks)."""
    from mcintegration_tpu_torch.ops import _build
    ops = Path(root) / "mcintegration_tpu_torch" / "ops"
    consts = {}
    for key, f, c in (("chain SMEM_HIST_BINS", "chain_kernels.py", "SMEM_HIST_BINS"),
                      ("vplus SMEM_HIST_BINS", "vplus_kernels.py", "SMEM_HIST_BINS"),
                      ("vegas SPAN", "vegas_kernels.py", "SPAN"),
                      # vplus_relw's block, where a checkout has its own (else the reduce's)
                      ("vplus RELW_SPAN", "vplus_kernels.py", "RELW_SPAN|SPAN"),
                      ("vplus RELW_WARPS", "vplus_kernels.py", "RELW_WARPS|WARPS")):
        text = (ops / f).read_text()
        for name in c.split("|"):
            found = re.search(rf"^{name} = (\d+)", text, re.M)
            if found:
                consts[key] = int(found.group(1))
                break
    lib = _build.bind(build_from(Path(root) / "mcintegration_tpu_torch" / "csrc", "baseline"))
    return lib, consts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("accept_reduce_variants: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    import mcintegration_tpu_torch as mt
    from mcintegration_tpu_torch.ops import (_build, chain_kernels as ck, vegas_kernels as vk,
                                             vplus_kernels as vp)

    card = cs.card_line()
    root = sys.argv[sys.argv.index("--baseline") + 1] if "--baseline" in sys.argv else None
    only = set(sys.argv[sys.argv.index("--only") + 1].split(",")) if "--only" in sys.argv \
        else set(SOURCES)
    if not only <= set(SOURCES):
        print(f"accept_reduce_variants: --only takes some of {SOURCES}", file=sys.stderr)
        return 2
    kept = _build.load()
    print(f"kept: (64-bit CAS loops, instructions) in the SASS "
          f"{sass_counts(_build.library_path())}", flush=True)
    print("\n".join(ptxas_report(_build.CSRC)), flush=True)
    modules = {"chain": ck, "vplus": vp, "vegas": vk}
    kept_constants = {f"{m} SMEM_HIST_BINS": modules[m].SMEM_HIST_BINS for m in ("chain", "vplus")}
    kept_constants.update({"vegas SPAN": vk.SPAN, "vplus RELW_SPAN": vp.RELW_SPAN,
                           "vplus RELW_WARPS": vp.RELW_WARPS})
    runs = [("kept", kept, {})]
    if root:
        lib, consts = baseline(root)
        runs.insert(0, ("baseline", lib, consts))
        print(f"baseline: (64-bit CAS loops, instructions) in the SASS {sass_counts(lib._name)}",
              flush=True)

    # the kernels a variant changes: the files it edits, and the kernel of a
    # constant it sets
    const_file = {"chain": ACCEPT, "vplus": REDUCE, "vegas": MIXED}
    vs = [(name, edits, consts) for name, edits, consts in
          ([] if "--ablations" in sys.argv else variants())
          + [(name, edits, {}) for name, edits in ablations()]
          if ({f for f, _, _ in edits} | {const_file[k.split()[0]] for k in consts}) & only]
    files = {name: {f for f, _, _ in edits} | {const_file[k.split()[0]] for k in consts}
             for name, edits, consts in vs}
    unchecked = {name for name, _ in ablations()}
    built = mv.build([(name, edits, None, None) for name, edits, _ in vs])
    chains = chain_cases(mt) if ACCEPT in only else []
    reduces = vplus_cases(mt, vp) if REDUCE in only else []
    proposals = propose_cases(mt) if PROPOSE in only else []
    mixed = mixed_cases(mt, vk) if MIXED in only else []
    print(f"device ms per call, median of 3 runs [{card}]", flush=True)
    runs += [(name, lib or kept, consts) for (name, _, consts), lib in zip(vs, built)]
    runs += [(name + ", again", *rest) for name, *rest in runs[:1 + bool(root)][::-1]]
    bad = []
    for name, lib, consts in runs:
        _build._lib = lib
        for key, value in {**kept_constants, **consts}.items():
            m, c = key.split()
            setattr(modules[m], c, value)
        cells = []
        edited = files.get(name, only)    # kept and baseline: all
        strict = not name.startswith("baseline")
        try:
            check = name not in unchecked
            for case in chains if ACCEPT in edited else ():
                ms, err = chain_run(ck, case, check)
                cells.append(f"accept {case[0]} {ms!r} (err {err:.3g})")
            for case in proposals if PROPOSE in edited else ():
                ms, err = propose_run(ck, case, check)
                cells.append(f"propose {case[0]} {ms!r} (err {err:.3g})")
            for case in reduces if REDUCE in edited else ():
                ms, rel = vplus_run(vp, case, check, strict)
                cells.append(f"reduce {case[0]} {ms!r} (rel {rel:.3g})")
            for case in mixed if MIXED in edited else ():
                ms, rel = mixed_run(vk, case, check, strict)
                cells.append(f"mixed {case[0]} {ms!r} (rel {rel:.3g})")
        except (AssertionError, RuntimeError) as e:
            cells.append(f"FAILED: {e}")
            bad.append(name)
        print(f"{name}: " + "; ".join(cells), flush=True)
    _build._lib = kept
    for key, value in kept_constants.items():
        m, c = key.split()
        setattr(modules[m], c, value)
    if bad:
        print(f"accept_reduce_variants: failed: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
