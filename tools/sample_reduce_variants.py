"""Variants of ``vegas_reduce``, ``vplus_sample`` and ``vegas_sample``, timed on the card beside the kept kernels.

Builds the kernel library of ``mcintegration_tpu_torch/csrc`` as it stands,
then one library per variant: a copy of the sources with a few lines of
``vegas_reduce.cu``, ``vplus_sample.cu`` or ``vegas_sample.cu`` rewritten
(blocks per SM and quads in flight, lanes a column, streaming loads, a
row's bins at N = 1 without shared memory; samples a thread, the hash's
salt term formed once a block, 16-byte stores, the divisor by multiply and
shift; quads a thread, the group's values formed by every thread).
Ablations take a part of a kept kernel out (results wrong, so unchecked)
to price it.  With
``--baseline DIR``, the kernels of another checkout at ``DIR`` (its
``csrc``, whose entry points take the same arguments) run first and last,
in turns with the kept ones.

Cases, at ``chip_smoke.py``'s shapes: ``vegas_reduce`` on one launch of
phase 6 (the quarter disc, 2^26 samples, N = 1), given the measure's output
at phase 6e (the quickstart's histogram, 10 components, 2^26 samples) and
with 64 components (2^24 samples, the launch ``MEASURE_LAUNCH_BYTES``
allows); ``vplus_sample`` on one launch of phase 6d (``singular_3d``, 2^26
samples, 3 slots) and on phase 3d's all-branch spec; ``vegas_sample`` on one
launch of phase 6 (2 slots, 2^26 samples).  A variant runs the cases of the
kernels it edits (the kept and the baseline kernels all).  Each variant is
held against the plain versions (``vegas_reduce`` to ``REL_TOL_REDUCE``,
the two draws bit for bit) and timed on the device with the calls queued
behind a sleep kernel, the median of three runs of 20 calls.  Before the
runs it prints, per kernel instantiation of each library, its SASS
instructions and the instructions that mark a division (``MUFU.RCP``, and
``I2F.U32.RP`` of an integer division by a runtime divisor), and what
``ptxas -v`` says of the kept kernels' registers and spills.  As a
yardstick only (the port never calls it), it times PyTorch's own float64
sum of the measure's output, ``m.view(ncomp, -1, ms).sum(-1,
dtype=torch.float64)``: the bulk of the measure mode's bytes.

    python3 tools/sample_reduce_variants.py [--baseline DIR]   # on a CUDA card

It prints one line per variant and exits non-zero if a variant fails to
build or differs from the plain versions.
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

import accept_reduce_variants as arv  # noqa: E402  (building another checkout's sources)
import chip_smoke as cs  # noqa: E402  (the configurations, timers and checks)
import mcmc_variants as mv  # noqa: E402  (compiles the variants)

REDUCE, SAMPLE, VSAMPLE = "vegas_reduce.cu", "vplus_sample.cu", "vegas_sample.cu"
KERNELS = ("vegas_reduce_kernel", "vplus_sample_kernel", "vegas_sample_kernel")


def variants():
    """(name, source edits) of each variant; each stays right and is checked."""
    return [
        ("reduce 6 blocks per SM", [(REDUCE, "return sizeof(Fp) == 4 ? 4 : 3;",
                                     "return sizeof(Fp) == 4 ? 6 : 3;")]),
        ("reduce 5 blocks per SM", [(REDUCE, "return sizeof(Fp) == 4 ? 4 : 3;",
                                     "return sizeof(Fp) == 4 ? 5 : 3;")]),
        ("reduce 2 quads in flight", [(REDUCE, "constexpr int kUnroll = 4; ",
                                       "constexpr int kUnroll = 2; ")]),
        ("reduce 8 quads in flight", [(REDUCE, "constexpr int kUnroll = 4; ",
                                       "constexpr int kUnroll = 8; ")]),
        ("reduce half the lanes a column", [(REDUCE, "while (g < 32 && 8 * g <= nq)",
                                             "while (g < 32 && 16 * g <= nq)")]),
        ("reduce cached loads",
         [(REDUCE, "if (kVec) return __ldcs(reinterpret_cast<const float4*>(col) + j);",
           "if (kVec) return reinterpret_cast<const float4*>(col)[j];")]),
        ("reduce 3 blocks per SM", [(REDUCE, "return sizeof(Fp) == 4 ? 4 : 3;",
                                     "return sizeof(Fp) == 4 ? 3 : 3;")]),
        ("reduce, bins of a row at N = 1 from its unit's lanes",
         [(REDUCE, "    if (wcol && lg == 0) whsum[row * N + col] = sh;\n",
           "    if (wcol && N == 1) {\n"
           "      const long long p = (p0 + row) % nb;\n"
           "      for (int k = lg; k < nslots; k += G)\n"
           "        hrow[k * R + (r - p) + perm[k * R + r]] = used[k] ? 0.0 + sh : 0.0;\n"
           "    } else if (wcol && lg == 0) {\n"
           "      whsum[row * N + col] = sh;\n"
           "    }\n"),
          (REDUCE, "  __syncthreads();   // each (row, slot) bin from the tile's whsum\n"
                   "  for (int e = threadIdx.x; e < rows * nslots; e += kThreads) {",
           "  if (N > 1) __syncthreads();   // each (row, slot) bin from the tile's whsum\n"
           "  for (int e = threadIdx.x; e < rows * nslots * (N > 1); e += kThreads) {")]),
        ("sample 8 samples a thread", [(SAMPLE, "constexpr int kPerThread = 4; ",
                                        "constexpr int kPerThread = 8; ")]),
        ("sample 6 blocks per SM", [(SAMPLE, "return sizeof(Fp) == 4 ? 4 : 3;",
                                     "return sizeof(Fp) == 4 ? 6 : 3;")]),
        ("sample 3 blocks per SM", [(SAMPLE, "return sizeof(Fp) == 4 ? 4 : 3;",
                                     "return sizeof(Fp) == 4 ? 3 : 3;")]),
        ("sample, salt term formed once a block",
         [(SAMPLE, "(uint32_t)f[kSalt], f[kStride] > 0};",
           "(uint32_t)f[kSalt] * 0x85EBCA6Bu, f[kStride] > 0};"),
          (SAMPLE, "float u = uniform(base[v], f.salt);",
           "float u = __fmul_rn(__fadd_rn((float)(mix32(base[v] + f.salt) >> 8), 0.5f), "
           "5.9604644775390625e-08f);")]),
        ("sample, scalar loads and stores",
         [(SAMPLE, "const int vec = c % 4 == 0 &&", "const int vec = 0 && c % 4 == 0 &&")]),
        ("sample, integer division by nstrat",
         [(SAMPLE, "const uint32_t next = divide(q[v], mul, shift);",
           "const uint32_t next = q[v] / nstrat;")]),
        ("vegas sample 2 quads a thread", [(VSAMPLE, "constexpr int kQuads = 8; ",
                                            "constexpr int kQuads = 2; ")]),
        ("vegas sample 4 quads a thread", [(VSAMPLE, "constexpr int kQuads = 8; ",
                                            "constexpr int kQuads = 4; ")]),
        ("vegas sample 16 quads a thread", [(VSAMPLE, "constexpr int kQuads = 8; ",
                                             "constexpr int kQuads = 16; ")]),
        ("vegas sample, cached stores",
         [(VSAMPLE, "  __stcs(reinterpret_cast<float4*>(xg) + Q, make_float4(",
           "  __stwb(reinterpret_cast<float4*>(xg) + Q, make_float4(")]),
        ("vegas sample 4 blocks per SM", [(VSAMPLE, "return sizeof(R) == 4 ? 8 : 4;",
                                           "return sizeof(R) == 4 ? 4 : 4;")]),
        ("vegas sample, scalar stores",
         [(VSAMPLE, "const bool vec = m % 4 == 0 &&", "const bool vec = false && m % 4 == 0 &&")]),
        ("vegas sample, integer divisions",
         [(VSAMPLE, "        const uint32_t p = divide(Q, mulm, shm);\n"
                    "        const uint32_t r = (uint32_t)G.a * p + (uint32_t)G.s;\n"
                    "        const int pm = (int)(r - divide(r, mulnb, shnb) * (uint32_t)nb);\n"
                    "        const R gv = gr[pm], dx = ic[pm];",
           "        const uint32_t p = Q / qrow;\n"
           "        const int pm = (int)(((uint32_t)G.a * p + (uint32_t)G.s) % (uint32_t)nb);\n"
           "        const R gv = gr[pm], dx = ic[pm];")]),
        ("vegas sample, the group's values formed by every thread",
         [(VSAMPLE, "  __shared__ Group sg;\n", "  Group sg;\n"),
          (VSAMPLE, "  if (threadIdx.x == 0) {\n    const uint32_t bt = g % (B * T);",
           "  {\n    const uint32_t bt = g % (B * T);"),
          (VSAMPLE, "  __syncthreads();\n  const Group G = sg;", "  const Group G = sg;")]),
    ]


def ablations():
    """(name, source edits) of each ablation: a part of a kept kernel taken
    out, to time what it costs; the results are wrong, so they are not
    checked."""
    return [
        ("reduce without float64 adds (bits xor-ed)",
         [(REDUCE, "    so += (double)v;\n    return;",
           "    so = __longlong_as_double(__double_as_longlong(so) ^ __float_as_int(v));\n"
           "    return;"),
          (REDUCE, "if (kTerms == kWeighted) so += (double)mul_rn(v, f);",
           "if (kTerms == kWeighted) so = __longlong_as_double(__double_as_longlong(so) ^ "
           "__float_as_int(mul_rn(v, f)));"),
          (REDUCE, "  sh += (double)mul_rn(a, a);",
           "  sh = __longlong_as_double(__double_as_longlong(sh) ^ __float_as_int(a));")]),
        ("reduce without the factors", [(REDUCE, "if (j0 == lg && wcol) {", "if (j0 < 0) {")]),
        ("reduce without the butterfly", [(REDUCE, "for (int o = G >> 1; o > 0; o >>= 1) {",
                                           "for (int o = 0; o > 0; o >>= 1) {")]),
        ("reduce without the histogram bins",
         [(REDUCE, "  for (int e = threadIdx.x; e < rows * nslots; e += kThreads) {",
           "  for (int e = threadIdx.x; e < rows * nslots * (r0 < 0); e += kThreads) {")]),
        ("reduce without the barriers",
         [(REDUCE, "  __syncthreads();   // each (row, slot) bin from the tile's whsum\n", "\n")]),
        ("sample without the hash",
         [(SAMPLE, "float u = uniform(base[v], f.salt);",
           "float u = __fmul_rn(__fadd_rn((float)((base[v] + f.salt) >> 8), 0.5f), "
           "5.9604644775390625e-08f);")]),
        ("sample without the division for y",
         [(SAMPLE, "u = __fdiv_rn(__fadd_rn((float)coord, u), fns);",
           "u = __fmul_rn(__fadd_rn((float)coord, u), 0.04f);")]),
        ("sample without the map's gathers",
         [(SAMPLE, "val = as_bits(add_rn(t[iy], mul_rn((Fp)dy, t[f.nb + iy])));",
           "val = as_bits((Fp)dy);")]),
        ("sample, every slot stored over slot 0",
         [(SAMPLE, "const size_t row = k * plane + (size_t)bt * c;",
           "const size_t row = (size_t)bt * c;")]),
        ("vegas sample without the hash",
         [(VSAMPLE, "const uint32_t u = mix32(mix32(i ^ G.k1) + G.kc);",
           "const uint32_t u = i ^ G.k1;")]),
        ("vegas sample without the map's gathers",
         [(VSAMPLE, "const R gv = gr[pm], dx = ic[pm];\n        const uint32_t e = 4u * Q;",
           "const R gv = (R)pm, dx = (R)0.5;\n        const uint32_t e = 4u * Q;")]),
        ("vegas sample without invp and perm",
         [(VSAMPLE, "        if (Q == p * qrow) {   // this quad starts row p",
           "        if (Q == p * qrow && G.a < 0) {   // this quad starts row p")]),
    ]


def kernel_name(mangled):
    """The short name of a kernel instantiation in the SASS, or None."""
    base = next((k for k in KERNELS if k in mangled), None)
    if base is None:
        return None
    args = re.findall(r"L[ib](\d+)E", mangled)
    return base + (f"<{','.join(args)}>" if args else "")


def sass_counts(lib_path):
    """{kernel: (instructions, MUFU.RCP, I2F.U32.RP)} in the SASS of a library."""
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
                counts.setdefault(name, [0, 0, 0])
        elif name and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            c = counts[name]
            c[0] += 1
            c[1] += "MUFU.RCP" in line
            c[2] += "I2F.U32.RP" in line
    return {k: tuple(v) for k, v in counts.items()}


def ptxas_report(csrc):
    """ptxas -v's lines on the kernels of vegas_reduce.cu, vplus_sample.cu and
    vegas_sample.cu."""
    from mcintegration_tpu_torch.ops import _build
    out = []
    for src in (REDUCE, SAMPLE, VSAMPLE):
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                               "-o", str(_build.BUILD_DIR / "ptxas.o"), str(Path(csrc) / src)],
                              capture_output=True, text=True)
        out += [ln for ln in (proc.stdout + proc.stderr).splitlines()
                if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
    return out


def reduce_cases(mt, vk):
    """(name, args, m, plain obs, plain hrow) of vegas_reduce's cases."""
    import torch
    from mcintegration_tpu_torch.ops.rng import block_keys
    from mcintegration_tpu_torch.solvers.engine import Spec
    from mcintegration_tpu_torch.solvers.vegas import VegasIteration

    cfg = mt.Configuration(var=mt.Continuous(0.0, 1.0), dof=[[2]], seed=cs.SEED)
    it = VegasIteration(Spec(cfg, "cuda"), cs._pi, block=16, nevalperblock=2 ** 30 // 16)
    inputs = it.kernel_inputs(it.spec.device_params(), block_keys(cs.SEED, 0, 0, it.block))
    x, invp, perm = vk.vegas_sample(t0=0, T=it.chunks_per_launch, m=it.m_tile, **inputs)
    w = it.evaluate(it.leaf_values(x)).contiguous()
    del x
    out = [("6", (w, invp, perm, it.pad, it.pair_slots, it.used), None)]
    for nbin in (cs.NBIN, 64):
        vit, _ = cs.qs_iterations(mt, nbin)
        _, _, x, invp, perm, w, relw = cs.vegas_measured_launch(vk, vit)
        m = vit.measure(vit.leaf_values(x), relw).contiguous()
        del x, relw
        out.append((f"6e, {nbin} components", (w, invp, perm, vit.pad, vit.pair_slots, vit.used),
                    m))
    cases = []
    for name, args, m in out:
        obs, hrow = vk.vegas_reduce_plain(*args, m)
        torch.cuda.synchronize()
        cases.append((name, args, m, obs.cpu(), hrow.cpu()))
    return cases


def reduce_run(vk, case, check=True):
    """(ms, max rel err) of vegas_reduce on one case; unchecked: (ms, 0)."""
    import torch
    name, args, m, obs_p, hrow_p = case
    rel = 0.0
    if check:
        obs, hrow = vk.vegas_reduce(*args, m)
        torch.cuda.synchronize()
        rel = max(cs.rel_err(obs.cpu(), obs_p), cs.rel_err(hrow.cpu(), hrow_p))
        if rel > cs.REL_TOL_REDUCE:
            raise AssertionError(f"vegas_reduce, {name}: rel {rel:.3g} > {cs.REL_TOL_REDUCE}")
    ms = float(np.median([cs.device_ms(lambda: vk.vegas_reduce(*args, m), 20)
                          for _ in range(3)]))
    return ms, rel


def sample_cases(mt, vp):
    """(name, layout, tab, kd, T, cube, plain x, plain gidx) of vplus_sample's cases."""
    import torch
    from mcintegration_tpu_torch.ops.rng import block_keys
    from mcintegration_tpu_torch.solvers.engine import Spec
    from mcintegration_tpu_torch.solvers.vegasplus import VegasPlusIteration

    cfg = mt.Configuration(var=mt.Continuous(0.0, np.pi), dof=[[3]], seed=cs.SEED)
    main = VegasPlusIteration(Spec(cfg, "cuda"), cs._sing3, block=16, nevalperblock=2 ** 26)
    out = []
    for name, it in (("6d", main), ("3d all-branch", cs.vplus_allbranch(mt, 2 ** 20))):
        params = it.spec.device_params()
        it.reallocate(it.run(params, block_keys(cs.SEED, 0, 0, it.block))["sig"])
        lay, T = it.layout, it.chunks_per_launch
        tab, kd = lay.tables(params), it.seeds(block_keys(cs.SEED, 1, 0, it.block))
        cube, _ = it.cube_tables()
        x, gidx = vp.vplus_sample_plain(lay, tab, kd, 0, T, cube)
        torch.cuda.synchronize()
        out.append((name, lay, tab, kd, T, cube, x, gidx))
    return out


def sample_run(vp, case, check=True):
    """(ms, max abs err) of vplus_sample on one case; unchecked: (ms, 0)."""
    import torch
    name, lay, tab, kd, T, cube, xp, gp = case
    err = 0.0
    if check:
        x, gidx = vp.vplus_sample(lay, tab, kd, 0, T, cube)
        torch.cuda.synchronize()
        if not (torch.equal(cs.bits(x), cs.bits(xp)) and torch.equal(gidx, gp)):
            raise AssertionError(f"vplus_sample, {name}: differs from the plain version")
        err = float((x - xp).abs().max())
        del x, gidx
    ms = float(np.median([cs.device_ms(lambda: vp.vplus_sample(lay, tab, kd, 0, T, cube), 20)
                          for _ in range(3)]))
    return ms, err


def vegas_cases(mt):
    """(name, inputs, T, m, plain x, invp, perm) of vegas_sample's case:
    one launch of phase 6 (the quarter disc, 2 slots)."""
    import torch
    from mcintegration_tpu_torch.ops import vegas_kernels as vk
    from mcintegration_tpu_torch.ops.rng import block_keys
    from mcintegration_tpu_torch.solvers.engine import Spec
    from mcintegration_tpu_torch.solvers.vegas import VegasIteration

    cfg = mt.Configuration(var=mt.Continuous(0.0, 1.0), dof=[[2]], seed=cs.SEED)
    it = VegasIteration(Spec(cfg, "cuda"), cs._pi, block=16, nevalperblock=2 ** 30 // 16)
    inputs = it.kernel_inputs(it.spec.device_params(), block_keys(cs.SEED, 0, 0, it.block))
    T = it.chunks_per_launch
    want = vk.vegas_sample_plain(t0=0, T=T, m=it.m_tile, **inputs)
    torch.cuda.synchronize()
    return [("6", inputs, T, it.m_tile, want)]


def vegas_run(vk, case, check=True):
    """(ms, max abs err) of vegas_sample on one case; unchecked: (ms, 0)."""
    import torch
    name, inputs, T, m, want = case
    err = 0.0
    if check:
        got = vk.vegas_sample(t0=0, T=T, m=m, **inputs)
        torch.cuda.synchronize()
        if not all(torch.equal(cs.bits(a), cs.bits(b)) for a, b in zip(got, want)):
            raise AssertionError(f"vegas_sample, {name}: differs from the plain version")
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        del got
    ms = float(np.median([cs.device_ms(lambda: vk.vegas_sample(t0=0, T=T, m=m, **inputs), 20)
                          for _ in range(3)]))
    return ms, err


def yardstick(reduces, card):
    """PyTorch's float64 sum of each measure case's m, device ms."""
    import torch
    for name, args, m, _, _ in reduces:
        if m is None:
            continue
        ncomp, ms = m.shape[0], m.shape[-1]
        t = float(np.median([cs.device_ms(
            lambda: m.view(ncomp, -1, ms).sum(-1, dtype=torch.float64), 20) for _ in range(3)]))
        print(f"yardstick, {name}: m.view(ncomp, -1, ms).sum(-1, dtype=torch.float64) "
              f"{t!r} ms ({m.numel() * 4} bytes of m) [{card}]", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sample_reduce_variants: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    import mcintegration_tpu_torch as mt
    from mcintegration_tpu_torch.ops import _build, vegas_kernels as vk, vplus_kernels as vp

    card = cs.card_line()
    root = sys.argv[sys.argv.index("--baseline") + 1] if "--baseline" in sys.argv else None
    kept = _build.load()
    print(f"kept: (instructions, MUFU.RCP, I2F.U32.RP) in the SASS "
          f"{sass_counts(_build.library_path())}", flush=True)
    print("\n".join(ptxas_report(_build.CSRC)), flush=True)
    runs = [("kept", kept)]
    if root:
        base = _build.bind(arv.build_from(Path(root) / "mcintegration_tpu_torch" / "csrc",
                                          "baseline"))
        runs.insert(0, ("baseline", base))
        print(f"baseline: (instructions, MUFU.RCP, I2F.U32.RP) in the SASS "
              f"{sass_counts(base._name)}", flush=True)
    vs = variants() + ablations()
    unchecked = {name for name, _ in ablations()}
    built = mv.build([(name, edits, None, None) for name, edits in vs])
    reduces = reduce_cases(mt, vk)
    samples = sample_cases(mt, vp)
    draws = vegas_cases(mt)
    yardstick(reduces, card)
    print(f"device ms per call, median of 3 runs of 20 [{card}]", flush=True)
    files = {name: {f for f, _, _ in edits} for name, edits in vs}
    runs += [(name, lib) for (name, _), lib in zip(vs, built)]
    runs += [(name + ", again", lib) for name, lib in runs[:1 + bool(root)][::-1]]
    bad = []
    for name, lib in runs:
        _build._lib = lib
        cells = []
        edited = files.get(name, {REDUCE, SAMPLE, VSAMPLE})    # kept and baseline: all
        try:
            check = name not in unchecked
            for case in reduces if REDUCE in edited else ():
                ms, rel = reduce_run(vk, case, check)
                cells.append(f"reduce {case[0]} {ms!r} (rel {rel:.3g})")
            for case in samples if SAMPLE in edited else ():
                ms, err = sample_run(vp, case, check)
                cells.append(f"sample {case[0]} {ms!r} (err {err:.3g})")
            for case in draws if VSAMPLE in edited else ():
                ms, err = vegas_run(vk, case, check)
                cells.append(f"vegas sample {case[0]} {ms!r} (err {err:.3g})")
        except (AssertionError, RuntimeError) as e:
            cells.append(f"FAILED: {e}")
            bad.append(name)
        print(f"{name}: " + "; ".join(cells), flush=True)
    _build._lib = kept
    if bad:
        print(f"sample_reduce_variants: failed: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
