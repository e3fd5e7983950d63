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
