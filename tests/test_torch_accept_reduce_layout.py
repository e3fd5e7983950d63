"""PyTorch port: how ``chain_accept`` and ``vplus_reduce`` are called, and the
variants of them and of ``chain_propose`` that the tools build.

``chain_accept`` keeps its histogram in shared memory when it fits
(``SMEM_HIST_BINS`` of its module) and in device memory otherwise;
``vplus_reduce`` keeps it in shared memory, whole when it fits and else in
windows of ``SMEM_HIST_BINS`` bins.
The wrappers pass the layouts through bare argument lists to the C entry
points.  This is host logic; the kernels themselves are held to their plain
versions on the card (``tests/test_torch_cuda.py``).
``tools/accept_reduce_variants.py`` times variants of the kernels built
from edited copies of their sources; each edit must still find its line.
"""

import ctypes
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import mcintegration_tpu_torch as mt
from mcintegration_tpu_torch.ops import _build, chain_kernels as ck, vplus_kernels as vp
from mcintegration_tpu_torch.ops.rng import block_keys
from mcintegration_tpu_torch.solvers.engine import Spec

CPU = torch.device("cpu")


def _check_ints(args, name):
    """Each argument a Python int in the position of a C int (and within its
    range) or of a pointer, one per ctypes argtype but the stream."""
    types = _build._SIGNATURES[name]
    assert len(args) == len(types) - 1 and types[-1] is ctypes.c_void_p
    for a, ty in zip(args, types):
        assert isinstance(a, int)
        if ty is ctypes.c_int:
            assert -2 ** 31 <= a < 2 ** 31
        elif ty is ctypes.c_longlong:
            assert -2 ** 63 <= a < 2 ** 63
        else:
            assert ty is ctypes.c_void_p


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_chain_accept_argument_list(cplx):
    """mci_chain_accept and its complex entry take the layout's sizes, the
    histogram's size and whether it fits in shared memory (up to
    SMEM_HIST_BINS bins), and the state's pointers."""
    var = mt.CompositeVar(mt.Continuous(0.0, 1.0, ninc=100), mt.Discrete(1, 40))
    cfg = mt.Configuration(var=var, dof=[[1], [2]], seed=2, type=complex if cplx else float)
    spec = Spec(cfg, CPU)
    lay = ck.ChainLayout.build(spec, 4, 64)
    st = ck.ChainState.zeros(lay)
    kd = torch.as_tensor(block_keys(1, 0, 0, 4).view(np.int32))
    rw = torch.ones(spec.N + 1, dtype=torch.float32)
    nw = torch.ones((spec.N, lay.W), dtype=spec.wdtype)
    args = ck._accept_args(lay, rw, kd, 3, st, nw, False, True)
    assert args[1:12] == (3, 0, 1, 0, lay.W, 64, 2, lay.S, 1, 1, 2)
    assert args[12:16] == (lay.meta.data_ptr(), rw.data_ptr(), lay.nhist, 1)
    assert lay.nhist <= ck.SMEM_HIST_BINS
    assert args[-2:] == (st.hist.data_ptr(), st.relw.data_ptr())
    _check_ints(args, "mci_chain_accept_complex" if cplx else "mci_chain_accept")


@pytest.mark.parametrize("ninc,smem", [(1000, 1), (5000, 0)])
def test_vplus_reduce_argument_list(ninc, smem):
    """mci_vplus_reduce takes the histogram's size and whether it fits in
    shared memory whole (up to SMEM_HIST_BINS bins; else the kernel adds it
    in windows of that many)."""
    cfg = mt.Configuration(var=mt.Continuous(0.0, 1.0, ninc=ninc), dof=[[3]], seed=2)
    lay = vp.VplusLayout.build(Spec(cfg, CPU), 5)
    N, B, T, c = 1, 2, 3, 300
    w = torch.ones((N, B, T, c), dtype=torch.float32)
    gidx = torch.zeros((lay.S, B, T, c), dtype=torch.int32)
    cube = torch.zeros(c, dtype=torch.int32)
    cfac = torch.ones(125, dtype=torch.float32)
    tab = torch.ones(lay.tab_size, dtype=torch.float32)
    obs_rows, sig, hist = vp._reduce_outputs(lay, w, cfac)
    args = vp._reduce_args(lay, tab, w, gidx, cube, cfac, obs_rows, sig, hist)
    assert args[10:17] == (B * T, c, 125, ninc, smem, vp.SPAN, vp.WARPS)
    assert (lay.nhist <= vp.SMEM_HIST_BINS) == bool(smem)
    _check_ints(args, "mci_vplus_reduce")


def _csrc_constant(src, name):
    """The value of ``constexpr int name = ...;`` in csrc/``src``."""
    import re
    text = (Path(_build.CSRC) / src).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


# chunk lengths: multiples of a mixed-reduce block's samples (SPAN = 256
# threads x PER_THREAD), of PER_THREAD only, and neither
CHUNKS = (1, 3, 4, 1000, 1024, 3003, 4096, 6000, 131072)


@pytest.mark.parametrize("c", CHUNKS)
@pytest.mark.parametrize("cplx,given", [(False, False), (True, False), (False, True)],
                         ids=["real", "complex", "given m"])
def test_vegas_reduce_mixed_argument_list(c, cplx, given):
    """mci_vegas_reduce_mixed takes the layout's sizes, the histogram's size
    and whether it fits in shared memory whole, SPAN and WARPS (which the
    kernel checks against its own), the measure's pointer and component
    count; its partials obs_rows are [ncomp, B, T, ceil(c / SPAN) * WARPS],
    one row per warp of the ceil(c / SPAN) blocks a chunk."""
    from mcintegration_tpu_torch.ops import vegas_kernels as vk
    var = (mt.Continuous(0.0, 1.0, ninc=8), mt.Discrete(1, 5))
    cfg = mt.Configuration(var=var, dof=[[1, 1], [1, 0]], seed=2,
                           type=complex if cplx else float)
    lay = vk.MixedLayout.build(Spec(cfg, CPU), c, {})
    N, B, T = 2, 2, 3
    w = torch.ones((N, B, T, c), dtype=torch.complex64 if cplx else torch.float32)
    gidx = torch.zeros((lay.S, B, T, c), dtype=torch.int32)
    tab = torch.ones(lay.tab_size, dtype=torch.float32)
    ncomp = 3 if given else 2 * N if cplx else N
    m = torch.ones((ncomp, B, T, c), dtype=torch.float32) if given else None
    obs_rows, hist = vk._mixed_outputs(lay, w, ncomp)
    assert obs_rows.shape == (ncomp, B, T, -(-c // vk.SPAN) * vk.WARPS)
    assert obs_rows.dtype == hist.dtype == torch.float64
    assert hist.shape == (max(lay.nhist, 1),) and not hist.any()
    args = vk._mixed_args(lay, tab, w, gidx, obs_rows, hist, m, 4, 7)
    P, M = lay.pair_slots.shape
    assert args[:4] == (w.data_ptr(), gidx.data_ptr(), tab.data_ptr(), lay.meta.data_ptr())
    assert args[4:14] == (N, lay.S, P, M, B * T, c, lay.nhist, 1, vk.SPAN, vk.WARPS)
    assert args[14:] == (m.data_ptr() if given else 0, ncomp, 4, 7, T, obs_rows.data_ptr(),
                         hist.data_ptr())
    _check_ints(args, "mci_vegas_reduce_mixed_complex" if cplx else "mci_vegas_reduce_mixed")


def test_mixed_span_matches_the_kernel():
    """The wrapper's SPAN and WARPS are the kernel's: 256 threads a block,
    PER_THREAD consecutive samples a thread."""
    from mcintegration_tpu_torch.ops import vegas_kernels as vk
    threads = _csrc_constant("vegas_mixed.cu", "kThreads")
    assert _csrc_constant("vegas_mixed.cu", "kPerThread") == vk.PER_THREAD
    assert vk.SPAN == threads * vk.PER_THREAD and vk.WARPS == threads // 32
    assert _csrc_constant("vegas_mixed.cu", "kWindow") == vk.SMEM_HIST_BINS


@pytest.mark.parametrize("c", CHUNKS)
def test_mixed_reduce_threads_cover_the_chunk(c):
    """Model of vegas_reduce_mixed's work: lane l of warp j of block b takes
    the PER_THREAD samples from ((j * nspan + b) * 32 + l) * PER_THREAD, and
    the warp writes row b * WARPS + j of the partials; every sample of a
    chunk is taken once, and every row is written once."""
    from mcintegration_tpu_torch.ops import vegas_kernels as vk
    nspan = -(-c // vk.SPAN)
    seen = np.zeros(c, np.int64)
    rows = np.zeros(nspan * vk.WARPS, np.int64)
    for b in range(nspan):
        for j in range(vk.WARPS):
            rows[b * vk.WARPS + j] += 1
            for lane in range(32):
                s0 = ((j * nspan + b) * 32 + lane) * vk.PER_THREAD
                n = max(min(c - s0, vk.PER_THREAD), 0)
                seen[s0:s0 + n] += 1
    assert np.all(seen == 1) and np.all(rows == 1)


def _warp_sum(v):
    """The kernels' warp_sum of 32 float64 values (__shfl_down_sync by 16,
    8, 4, 2, 1): lane 0's result."""
    v = np.array(v, np.float64)
    for o in (16, 8, 4, 2, 1):
        v = v + np.concatenate([v[o:], v[32 - o:]])   # past the warp a lane keeps its own
    return v[0]


def _group_sum_given_m(v):
    """vplus_reduce given m's sum of a chunk's 32 terms of a warp: lane
    j < 8 of the chunk's 8 lanes adds the terms j, j+8, j+16, j+24 in
    registers, then three shuffle levels (by 4, 2, 1) among the 8 lanes."""
    v = np.array(v, np.float64)
    a = (v[0:8] + v[16:24]) + (v[8:16] + v[24:32])
    for o in (4, 2, 1):
        a = a + np.concatenate([a[o:], a[8 - o:]])
    return a[0]


def test_given_m_sums_as_the_default_mode():
    """vplus_reduce given m adds a warp's terms of a chunk in the default
    mode's order: over float32 terms of any magnitude and zeros (samples
    outside the chunk or shut by the gate) the two sums agree bit for bit,
    so given m = relw's components the observables are the default ones."""
    rng = np.random.default_rng(3)
    for _ in range(2000):
        t = (rng.standard_normal(32) * 10.0 ** rng.integers(-30, 30, 32)).astype(np.float32)
        t[rng.random(32) < 0.2] = 0.0
        a, b = _warp_sum(t), _group_sum_given_m(t)
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("c", CHUNKS)
@pytest.mark.parametrize("ncomp", [1, 3, 10])
def test_vplus_given_m_rows(c, ncomp):
    """vplus_reduce given m keeps the default launch's partials [B, T,
    ceil(c / SPAN) * WARPS, ncomp] and grid; a block walks the chunks
    blockIdx.y + k * gridDim.y and forms the measure's sums of CHUNKS of
    them at a time (fewer at the end, 8 lanes a chunk), so each chunk's row
    of each warp is written once."""
    chunks = _csrc_constant("vplus_reduce.cu", "kChunks")
    assert chunks * 8 == 32
    assert _csrc_constant("vplus_reduce.cu", "kThreads") == vp.SPAN    # kSpan = kThreads
    cfg = mt.Configuration(var=mt.Continuous(0.0, 1.0, ninc=10), dof=[[2]], seed=2)
    lay = vp.VplusLayout.build(Spec(cfg, CPU), 3)
    N, B, T = 1, 2, 3
    w = torch.ones((N, B, T, c), dtype=torch.float32)
    obs_rows, _, _ = vp._reduce_outputs(lay, w, torch.ones(9), ncomp)
    assert obs_rows.shape == (B, T, -(-c // vp.SPAN) * vp.WARPS, ncomp)
    for BT, gy in ((B * T, 1), (B * T, 4), (B * T, 6), (37, 5), (1, 1)):
        seen = np.zeros(BT, np.int64)
        for y in range(gy):
            walk = list(range(y, BT, gy))
            batches = [walk[k:k + chunks] for k in range(0, len(walk), chunks)]
            assert all(1 <= len(b) <= chunks for b in batches)
            for b in batches:
                seen[b] += 1
        assert np.all(seen == 1)


def _relw_args_case(c, cplx):
    cfg = mt.Configuration(var=mt.Continuous(0.0, 1.0, ninc=10), dof=[[2]], seed=2,
                           type=complex if cplx else float)
    lay = vp.VplusLayout.build(Spec(cfg, CPU), 3)
    N, B, T = 1, 2, 3
    w = torch.ones((N, B, T, c), dtype=torch.complex64 if cplx else torch.float32)
    gidx = torch.zeros((lay.S, B, T, c), dtype=torch.int32)
    cube = torch.zeros(c, dtype=torch.int32)
    cfac = torch.ones(9, dtype=torch.float32)
    tab = torch.ones(lay.tab_size, dtype=torch.float32)
    return lay, tab, w, gidx, cube, cfac


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_vplus_relw_argument_list(cplx):
    """mci_vplus_relw takes the layout's sizes, B * T and c, and RELW_SPAN
    and RELW_WARPS, which the kernel checks against its own: 256 threads a
    block (kRelwThreads), a quad of kQuad = 4 samples a thread."""
    lay, tab, w, gidx, cube, cfac = _relw_args_case(1000, cplx)
    relw = torch.empty_like(w)
    args = vp._relw_args(lay, tab, w, gidx, cube, cfac, relw)
    P, M = lay.pair_slots.shape
    assert args[6:14] == (1, lay.S, P, M, 6, 1000, vp.RELW_SPAN, vp.RELW_WARPS)
    assert args[-1] == relw.data_ptr() and args[0] == w.data_ptr()
    _check_ints(args, "mci_vplus_relw_complex" if cplx else "mci_vplus_relw")
    threads = _csrc_constant("vplus_reduce.cu", "kRelwThreads")
    assert vp.RELW_SPAN == threads * _csrc_constant("chain_common.cuh", "kQuad")
    assert vp.RELW_WARPS == threads // 32


@pytest.mark.parametrize("c", CHUNKS + (1023, 1025, 2047))
def test_vplus_relw_quads_cover_the_chunk(c):
    """Model of vplus_relw's work: block x of the BT * nspan takes chunk
    x // nspan, its thread t the samples from ((x % nspan) * threads + t) *
    4, n = min(c - s0, 4) of them where s0 < c, with 16-byte accesses only
    where s0 + 4 <= c; every sample of every chunk is taken once, and no
    16-byte access leaves its chunk."""
    threads, quad = vp.RELW_WARPS * 32, vp.RELW_SPAN // (vp.RELW_WARPS * 32)
    nspan = -(-c // vp.RELW_SPAN)
    BT = 3
    seen = np.zeros((BT, c), np.int64)
    for x in range(BT * nspan):
        bt = x // nspan
        for t in range(threads):
            s0 = ((x % nspan) * threads + t) * quad
            if s0 >= c:
                continue
            n = min(c - s0, quad)
            if s0 + quad <= c:
                assert n == quad
            seen[bt, s0:s0 + n] += 1
    assert np.all(seen == 1)


def _tree_sums(t):
    """vplus_reduce_complex's tree_sums over 32 lanes of kV values each (t
    [32, kV]): butterfly levels 16, 8, ... in which a lane keeps the lower
    half of its values (bit o of the lane clear) or the upper half and adds
    its partner's copy, then shuffles down among 32 / kV lanes.  Returns
    [32]: each lane's result."""
    v = [list(np.asarray(row, np.float64)) for row in t]
    n, o = t.shape[1], 16
    while n > 1:
        new = []
        for lane in range(32):
            hi = bool(lane & o)
            partner = v[lane ^ o]
            new.append([(v[lane][q + n // 2] if hi else v[lane][q])
                        + (partner[q + n // 2] if hi else partner[q]) for q in range(n // 2)])
        v, n, o = new, n // 2, o // 2
    a = np.array([row[0] for row in v], np.float64)
    width = 32 // t.shape[1]
    o = width // 2
    while o > 0:
        a = np.array([a[lane] + a[lane + o] if lane % width + o < width else a[lane]
                      for lane in range(32)])
        o //= 2
    return a


@pytest.mark.parametrize("kv", [1, 2, 8])
def test_complex_default_sums_as_warp_sum(kv):
    """vplus_reduce_complex sums the Re and Im parts of four chunks (kV = 8
    values a lane) in warp_sum's tree: lane l % (32 / kV) == 0 ends with
    value l / (32 / kV)'s warp_sum, bit for bit, over float32 terms of any
    magnitude and zeros (samples outside the chunk or shut by the gate); so
    do 1 and 2 values a lane (one chunk's Re and Im, or one chunk)."""
    assert 2 * _csrc_constant("vplus_reduce.cu", "kCplxChunks") == 8
    rng = np.random.default_rng(5)
    width = 32 // kv
    for _ in range(300):
        t = (rng.standard_normal((32, kv)) * 10.0 ** rng.integers(-30, 30, (32, kv)))
        t = t.astype(np.float32)
        t[rng.random((32, kv)) < 0.2] = 0.0
        got = _tree_sums(t)
        for lane in range(0, 32, width):
            want = _warp_sum(t[:, lane // width])
            assert got[lane].tobytes() == want.tobytes()


@pytest.mark.parametrize("kv", [1, 2, 4, 8])
def test_f64_default_sums_as_warp_sum(kv):
    """The float64 default observables (vplus_reduce_chunks_kernel at Fp =
    double) sum float64 terms, kV = 1, 2 or 4 chunks' Re a lane (8: the
    complex body's Re and Im of four) in warp_sum's tree: lane l % (32 /
    kV) == 0 ends with value l / (32 / kV)'s warp_sum, bit for bit, over
    float64 terms that float32 cannot hold, of any magnitude, and zeros
    (samples outside the chunk or shut by the gate)."""
    rng = np.random.default_rng(11)
    width = 32 // kv
    for _ in range(300):
        t = rng.standard_normal((32, kv)) * 10.0 ** rng.integers(-280, 280, (32, kv))
        t *= 1.0 + rng.uniform(-1e-12, 1e-12, t.shape)
        t[rng.random((32, kv)) < 0.2] = 0.0
        got = _tree_sums(t)
        for lane in range(0, 32, width):
            want = _warp_sum(t[:, lane // width])
            assert got[lane].tobytes() == want.tobytes()


def _chunk_rounds(BT, G, kU, kParts, nspan, N):
    """Model of vplus_reduce_chunks_kernel's walk: block row y < G takes
    chunks bt0 + u*G (u < kU, bt < BT) for bt0 = y, y + kU*G, ...; in warp
    j of block x, the lane (32/kV)*q writes value q (part q // kU of chunk
    bt0 + (q % kU)*G; kV = kParts*kU) of integrand i into row ((bt*nspan +
    x)*WARPS + j)*kParts*N + kParts*i + q // kU.  Returns [B*T, nspan *
    WARPS, kParts*N]: the times each partial was written, and the chunk
    whose samples each write summed."""
    kV = kParts * kU
    writes = np.zeros(BT * nspan * vp.WARPS * kParts * N, np.int64)
    summed = np.full(writes.shape, -1, np.int64)
    for y in range(G):
        for bt0 in range(y, BT, kU * G):
            for x in range(nspan):
                for j in range(vp.WARPS):
                    for i in range(N):
                        for lane in range(0, 32, 32 // kV):
                            q = lane // (32 // kV)
                            bt = bt0 + (q % kU) * G
                            if bt >= BT:
                                continue
                            row = ((bt * nspan + x) * vp.WARPS + j) * kParts * N + kParts * i \
                                + q // kU
                            writes[row] += 1
                            summed[row] = bt
    shape = (BT, nspan * vp.WARPS, kParts * N)
    return writes.reshape(shape), summed.reshape(shape)


@pytest.mark.parametrize("kparts", [1, 2], ids=["real", "complex"])
@pytest.mark.parametrize("ku", [1, 2, 4])
def test_f64_default_chunk_rounds(ku, kparts):
    """vplus_reduce_chunks_kernel, kU chunks a thread at once: over launches
    of B*T chunks below, at and not a multiple of kU, and grids of fewer or
    as many block rows as chunks, every chunk's partial of every warp and
    integrand (Re, and Im) is written exactly once, in the row of the
    wrapper's obs_rows [B, T, ceil(c / SPAN) * WARPS, ncomp] that belongs
    to the chunk it summed.  The kernel's own chunk counts are among kU."""
    assert {_csrc_constant("vplus_reduce.cu", k) for k in
            ("kF64Chunks", "kCplxF64Chunks", "kCplxChunks")} <= {1, 2, 4}
    nspan, N = 2, 3
    for BT in (1, ku - 1, ku, 2 * ku, 111, 37):
        for G in {1, 5, 14, BT}:
            if BT < 1 or G < 1 or G > BT:
                continue
            writes, summed = _chunk_rounds(BT, G, ku, kparts, nspan, N)
            assert np.all(writes == 1), (BT, G)
            assert np.all(summed == np.arange(BT)[:, None, None]), (BT, G)


def _gate_open(t, s, sh, c, mf):
    """vplus_reduce_complex's gate_open in uint32 arithmetic (wrapping as
    the card's does)."""
    u32 = np.uint32
    x = u32(s) + u32(sh)
    x = x - u32(c) if x >= u32(c) else x
    if mf < 65536:
        return (((u32(t) % u32(mf)) * (u32(c) % u32(mf)) + x % u32(mf) + u32(1)) % u32(mf)) == 0
    return (int(t) * int(c) + int(x) + 1) % mf == 0


def test_complex_default_gate_as_the_reference_gate():
    """The complex default's gate, (t*c + (s + shift) % c + 1) % mf == 0 in
    32-bit remainders for mf < 2^16 (no product or sum wraps), against the
    exact integers, at the edges of t < 2^31, c and mf."""
    rng = np.random.default_rng(7)
    cases = [(2 ** 31 - 1, 2 ** 31 - 1, 65535), (2 ** 31 - 1, 131072, 65535), (0, 1, 1),
             (5, 3, 70001), (2 ** 31 - 1, 2 ** 30 + 3, 2 ** 31 - 1)]
    cases += [(int(rng.integers(0, 2 ** 31)), int(rng.integers(1, 2 ** 31)),
               int(rng.choice([2, 3, 4, 7, 1000, 65535, 65536, 10 ** 6]))) for _ in range(400)]
    with np.errstate(over="raise"):
        for t, c, mf in cases:
            for s, sh in ((0, 0), (c - 1, c - 1), (int(rng.integers(0, c)), int(rng.integers(0, c)))):
                assert _gate_open(t, s, sh, c, mf) == ((t * c + (s + sh) % c + 1) % mf == 0)


def _variants_module():
    path = Path(__file__).resolve().parents[1] / "tools" / "accept_reduce_variants.py"
    spec = importlib.util.spec_from_file_location("accept_reduce_variants", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_MODULE = _variants_module()
_VARIANTS = _MODULE.variants()
_ABLATIONS = _MODULE.ablations()


@pytest.mark.parametrize("k", range(len(_VARIANTS)), ids=[v[0] for v in _VARIANTS])
def test_kernel_variant_edits_find_their_lines(k):
    """Each variant of tools/accept_reduce_variants.py changes the kept
    kernels: every source edit replaces a line found exactly once in csrc/,
    and a variant without edits sets a constant of the wrappers."""
    name, edits, constants = _VARIANTS[k]
    csrc = Path(_build.CSRC)
    for f, old, new in edits:
        assert (csrc / f).read_text().count(old) == 1, (name, f, old)
    if edits:
        assert any(new != old for _, old, new in edits)
    modules = {"chain": ck, "vplus": vp}
    for key, value in constants.items():
        module, constant = key.split()
        assert getattr(modules[module], constant) != value
    assert edits or constants


@pytest.mark.parametrize("k", range(len(_ABLATIONS)), ids=[a[0] for a in _ABLATIONS])
def test_kernel_ablation_edits_find_their_lines(k):
    """Each ablation of tools/accept_reduce_variants.py (chain_propose's
    among them) takes a part out of a kept kernel: every source edit
    replaces a line found exactly once in csrc/ of chain_accept.cu,
    vplus_reduce.cu, chain_propose.cu or vegas_mixed.cu."""
    name, edits = _ABLATIONS[k]
    csrc = Path(_build.CSRC)
    assert edits, name
    for f, old, new in edits:
        assert f in _MODULE.SOURCES, (name, f)
        assert (csrc / f).read_text().count(old) == 1, (name, f, old)
        assert new != old, (name, old)
