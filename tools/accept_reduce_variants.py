"""Variants of ``chain_accept`` and ``vplus_reduce``, timed on the card beside the kept kernels.

Builds the kernel library of ``mcintegration_tpu_torch/csrc`` as it stands,
then one library per variant: a copy of the sources with a few lines of
``chain_accept.cu`` or ``vplus_reduce.cu`` rewritten (threads per block and
blocks per SM, the register cache of pair products and pads, the grid's
waves, the merge of a warp's lanes before a histogram add).  Other
variants keep the library and move a histogram between the warps' copies
in shared memory and device memory (``SMEM_HIST_BINS``).  With
``--baseline DIR``, the kernels of another checkout at ``DIR`` (its
``csrc`` and its ``SMEM_HIST_BINS``) run first and last, in turns with the
kept ones.

Cases, at ``chip_smoke.py``'s shapes: ``chain_accept`` on a measured step of
2^20 walkers of phase 6b (the quarter disc), of phase 6e (writing relw for
the 10-bin histogram) and of phase 6f (complex weights), and phase 6b's
state with every walker in one histogram bin; ``vplus_reduce`` on one
launch of phase 6d (``singular_3d``, 2^26 samples), the same launch with
every sample of the first span in one bin, and phase 3d's all-branch spec.
Each is held against its plain version (bit for bit but the histograms and
``sig``: rel 1e-9 and 1e-12) and timed on the device with the calls queued
behind a sleep kernel, the median of three runs of 20 calls (10 for
``vplus_reduce``).  Before the runs it prints each library's count of
64-bit compare-and-swap loops (``ATOMS.CAST.SPIN.64`` in ``cuobjdump
-sass``) and of instructions per kernel, and what ``ptxas -v`` says of the
kept kernels' registers and spills.

    python3 tools/accept_reduce_variants.py [--baseline DIR]   # on a CUDA card

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

ACCEPT, REDUCE = "chain_accept.cu", "vplus_reduce.cu"
KERNELS = ("chain_accept_kernel", "vplus_reduce_kernel")


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
        ("reduce histogram in device memory", [], {"vplus SMEM_HIST_BINS": 0}),
        ("reduce adding through a generic pointer",
         [(REDUCE, "        if (hist_smem)   // two adds, each to an address space the compiler "
                   "knows\n          atomicAdd(hist_s + bin, sq);\n        else\n"
                   "          atomicAdd(hist + bin, sq);",
           "        atomicAdd((hist_smem ? hist_s : hist) + bin, sq);")], {}),
        ("reduce, lanes merged",
         [(REDUCE, "        if (bin < 0) continue;\n        if (hist_smem)   // two adds, each to an "
                   "address space the compiler knows\n          atomicAdd(hist_s + bin, sq);\n"
                   "        else\n          atomicAdd(hist + bin, sq);",
           "        double v = sq;\n        if (!merge_by_key(kFull, bin, v) || bin < 0) continue;\n"
           "        if (hist_smem)\n          atomicAdd(hist_s + bin, v);\n        else\n"
           "          atomicAdd(hist + bin, v);")], {}),
        ("reduce prefetching the next chunk into L2",
         [(REDUCE, "    const long long at = bt * c + s;\n",
           "    const long long at = bt * c + s;\n"
           "    for (int k = 0; k < S && cb >= 0 && bt + gridDim.y < BT; ++k)\n"
           "      prefetch_l2(gidx + k * plane + at + gridDim.y * (long long)c);\n"
           "    for (int i = 0; i < N && cb >= 0 && bt + gridDim.y < BT; ++i)\n"
           "      prefetch_l2(w + i * plane + at + gridDim.y * (long long)c);\n")], {}),
        ("reduce grid of 4 waves", [(REDUCE, "constexpr int kWaves = 8;",
                                     "constexpr int kWaves = 4;")], {}),
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
         [(REDUCE, "        if (bin < 0) continue;\n        if (hist_smem)",
           "        if (sq != -1.0) continue;\n        if (hist_smem)")]),
        ("reduce without the density loop",
         [(REDUCE, "    if (cb >= 0) {\n      float prob = 1.0f, pass = 1.0f;",
           "    if (cb < -1) {\n      float prob = 1.0f, pass = 1.0f;")]),
        ("reduce without the integrand loop",
         [(REDUCE, "    for (int i = 0; i < N; ++i) {\n      double so = 0.0, sq = 0.0;",
           "    for (int i = 0; i < 0; ++i) {\n      double so = 0.0, sq = 0.0;")]),
    ]


def sass_counts(lib_path):
    """{kernel: (count of ATOMS.CAST.SPIN.64, of instructions)} in the SASS
    of a library."""
    from mcintegration_tpu_torch.ops import _build
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = next((k + ("<true>" if "ILb1E" in m.group(1) else "")
                         for k in KERNELS if k in m.group(1)), None)
            if name:
                counts.setdefault(name, [0, 0])
        elif name and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            counts[name][1] += 1
            counts[name][0] += "ATOMS.CAST.SPIN.64" in line
    return {k: tuple(v) for k, v in counts.items()}


def ptxas_report(csrc):
    """ptxas -v's lines on the kernels of chain_accept.cu and vplus_reduce.cu."""
    from mcintegration_tpu_torch.ops import _build
    out = []
    for src in (ACCEPT, REDUCE):
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
    """(name, layout, tab, w, gidx, cube, cfac) of vplus_reduce's cases."""
    from mcintegration_tpu_torch.ops.rng import block_keys
    from mcintegration_tpu_torch.solvers.engine import Spec
    from mcintegration_tpu_torch.solvers.vegasplus import VegasPlusIteration

    cfg = mt.Configuration(var=mt.Continuous(0.0, np.pi), dof=[[3]], seed=cs.SEED)
    main = VegasPlusIteration(Spec(cfg, "cuda"), cs._sing3, block=16, nevalperblock=2 ** 26)
    out = []
    for name, it in (("6d", main), ("3d all-branch", cs.vplus_allbranch(mt, 2 ** 20))):
        params = it.spec.device_params()
        it.run(params, block_keys(cs.SEED, 0, 0, it.block))       # reallocates the counts
        lay = it.layout
        tab, kd = lay.tables(params), it.seeds(block_keys(cs.SEED, 1, 0, it.block))
        cube, cfac = it.cube_tables()
        x, gidx = vp.vplus_sample(lay, tab, kd, 0, it.chunks_per_launch, cube)
        w = it.evaluate(lay.leaf_values(x)).contiguous()
        del x
        out.append((name, lay, tab, w, gidx, cube, cfac))
        if name == "6d":
            out.append(("6d hot span", lay, tab, w, cs.one_bin_span(gidx), cube, cfac))
    return out


def vplus_run(vp, case, check=True):
    """(ms, max rel err) of vplus_reduce on one case; unchecked: (ms, 0)."""
    import torch
    name, lay, tab, w, gidx, cube, cfac = case
    rel = 0.0
    if check:
        got = vp.vplus_reduce(lay, tab, w, gidx, cube, cfac)
        want = vp.vplus_reduce_plain(lay, tab, w, gidx, cube, cfac)
        torch.cuda.synchronize()
        rel = max(cs.rel_err(a.cpu(), b.cpu()) for a, b in zip(got, want))
    if rel > cs.REL_TOL_VPLUS:
        raise AssertionError(f"vplus_reduce, {name}: rel {rel:.3g} > {cs.REL_TOL_VPLUS}")
    ms = float(np.median([cs.device_ms(
        lambda: vp.vplus_reduce(lay, tab, w, gidx, cube, cfac), 10) for _ in range(3)]))
    return ms, rel


def baseline(root):
    """(library, chain and vplus SMEM_HIST_BINS) of checkout ``root``, whose
    kernels take the same arguments."""
    from mcintegration_tpu_torch.ops import _build
    ops = Path(root) / "mcintegration_tpu_torch" / "ops"
    bins = [int(re.search(r"^SMEM_HIST_BINS = (\d+)", (ops / f).read_text(), re.M).group(1))
            for f in ("chain_kernels.py", "vplus_kernels.py")]
    lib = _build.bind(build_from(Path(root) / "mcintegration_tpu_torch" / "csrc", "baseline"))
    return (lib, *bins)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("accept_reduce_variants: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    import mcintegration_tpu_torch as mt
    from mcintegration_tpu_torch.ops import _build, chain_kernels as ck, vplus_kernels as vp

    card = cs.card_line()
    root = sys.argv[sys.argv.index("--baseline") + 1] if "--baseline" in sys.argv else None
    kept = _build.load()
    print(f"kept: (64-bit CAS loops, instructions) in the SASS "
          f"{sass_counts(_build.library_path())}", flush=True)
    print("\n".join(ptxas_report(_build.CSRC)), flush=True)
    modules = {"chain": ck, "vplus": vp}
    kept_constants = {f"{m} SMEM_HIST_BINS": modules[m].SMEM_HIST_BINS for m in modules}
    runs = [("kept", kept, {})]
    if root:
        lib, hc, hv = baseline(root)
        runs.insert(0, ("baseline", lib, {"chain SMEM_HIST_BINS": hc,
                                          "vplus SMEM_HIST_BINS": hv}))
        print(f"baseline: (64-bit CAS loops, instructions) in the SASS {sass_counts(lib._name)}",
              flush=True)

    vs = variants() + [(name, edits, {}) for name, edits in ablations()]
    unchecked = {name for name, _ in ablations()}
    built = mv.build([(name, edits, None, None) for name, edits, _ in vs])
    chains = chain_cases(mt)
    reduces = vplus_cases(mt, vp)
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
        try:
            check = name not in unchecked
            for case in chains:
                ms, err = chain_run(ck, case, check)
                cells.append(f"accept {case[0]} {ms!r} (err {err:.3g})")
            for case in reduces:
                ms, rel = vplus_run(vp, case, check)
                cells.append(f"reduce {case[0]} {ms!r} (rel {rel:.3g})")
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
