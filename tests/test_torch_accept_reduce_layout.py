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
    vplus_reduce.cu or chain_propose.cu."""
    name, edits = _ABLATIONS[k]
    csrc = Path(_build.CSRC)
    assert edits, name
    for f, old, new in edits:
        assert f in (_MODULE.ACCEPT, _MODULE.REDUCE, _MODULE.PROPOSE), (name, f)
        assert (csrc / f).read_text().count(old) == 1, (name, f, old)
        assert new != old, (name, old)
