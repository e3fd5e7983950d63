"""PyTorch port: how the :mcmc kernels are called.

``mcmc_accept`` keeps its histogram bins and its visited and tally counters
in shared memory when they fit (``McmcLayout.hist_smem``, ``cnt_smem``) and
in device memory otherwise; the wrappers pass these decisions and the
layout through bare argument lists to the C entry points.  This is host
logic; the kernels themselves are held to their plain versions on the card
(``tests/test_torch_cuda.py``).  ``tools/mcmc_variants.py`` times variants
and ablations of the kernels built from edited copies of their sources;
each edit must still find its line.
"""

import ctypes
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import mcintegration_tpu_torch as mt
from mcintegration_tpu_torch.ops import _build, fermik, mcmc_kernels as mk
from mcintegration_tpu_torch.ops.rng import block_keys
from mcintegration_tpu_torch.solvers.engine import Spec

CPU = torch.device("cpu")


def _layout(var, dof, block=4, wb=8, custom=False):
    spec = Spec(mt.Configuration(var=var, dof=dof, seed=1), CPU)
    return mk.McmcLayout.build(spec, block, wb, spec.N, custom)


def _bubble_vars():
    return (mt.Continuous(0.0, 2.0, alpha=3.0), mt.FermiK(3, 1.0, 0.2, 10.0),
            mt.Discrete(1, 4, adapt=False))


def test_bubble_layout():
    """The bubble (N = 1, three var groups): 38 counters and the map's 1024
    histogram bins in shared memory; every table read in device memory
    (sm_off -1), packed after deg and 1/N in leaf order."""
    lay = _layout(_bubble_vars(), [[1, 1, 1]], block=16, custom=True)
    rows = [lay.fields(d) for d in range(len(lay.dleaf))]
    assert [f["sm_off"] for f in rows] == [-1, -1, -1]
    assert [f["tab_off"] for f in rows] == [3, 3 + 2048, 3 + 2048 + fermik.FK_FIELDS]
    assert lay.tab_size == 3 + 2048 + fermik.FK_FIELDS + 9
    assert (lay.nhist, lay.counters, lay.hist_smem, lay.cnt_smem) == (1024, 38, True, True)


@pytest.mark.parametrize("ninc,nbin,N,hist_smem,cnt_smem", [
    (4000, 96, 20, True, False),      # 4096 bins; 21 sectors: 2667 counters
    (4000, 97, 1, False, True),       # 4097 bins; 26 counters
    (1000, 40, 2, True, True),
    (8192, 2000, 20, False, False)])
def test_counters_and_histograms_choose_shared_memory(ninc, nbin, N, hist_smem, cnt_smem):
    """Histograms up to SMEM_HIST_BINS bins and up to SMEM_COUNTERS visited
    and tally counters go to shared memory, larger ones to device memory."""
    var = mt.CompositeVar(mt.Continuous(0.0, 1.0, ninc=ninc), mt.Discrete(1, nbin))
    lay = _layout(var, [[1]] * N)
    assert lay.nhist == ninc + nbin
    assert lay.counters == (N + 1) + 6 * (N + 1) * max(N + 1, 1)
    assert (lay.hist_smem, lay.cnt_smem) == (hist_smem, cnt_smem)
    assert lay.hist_smem == (lay.nhist <= mk.SMEM_HIST_BINS)
    assert lay.cnt_smem == (lay.counters <= mk.SMEM_COUNTERS)


def _state_and_step(lay):
    st = mk.McmcState.zeros(lay)
    tab = lay.tables(lay.spec.device_params())
    kd = torch.as_tensor(block_keys(1, 0, 0, lay.block).view(np.int32))
    sched = torch.zeros((4, lay.block), dtype=torch.int32)
    rw = torch.ones(lay.nd, dtype=torch.float32)
    nw = torch.ones(lay.W, dtype=torch.float32)
    return st, tab, kd, sched, rw, nw


@pytest.mark.parametrize("name", ["mci_mcmc_propose", "mci_mcmc_accept"])
def test_argument_lists_match_the_c_signatures(name):
    """Each argument of the wrappers' lists is a Python int in the position
    of a C ``int`` (and within its range) or of a pointer, one per ctypes
    argtype but the stream; the accept list carries the layout's shared
    memory decisions."""
    lay = _layout(_bubble_vars(), [[1, 1, 1]], block=16, custom=True)
    st, tab, kd, sched, rw, nw = _state_and_step(lay)
    if name == "mci_mcmc_propose":
        args = mk._propose_args(lay, tab, kd, sched, 2, st, False)
        assert args[4:10] == (lay.W, lay.wb, len(lay.dleaf), 3, lay.nd, 0)
    else:
        args = mk._accept_args(lay, tab, rw, kd, sched, 2, st, nw, False, True)
        assert args[16:19] == (lay.nhist, 1, 1)
    types = _build._SIGNATURES[name]
    assert len(args) == len(types) - 1 and types[-1] is ctypes.c_void_p
    for a, ty in zip(args, types):
        assert isinstance(a, int)
        if ty is ctypes.c_int:
            assert -2 ** 31 <= a < 2 ** 31
        else:
            assert ty is ctypes.c_void_p


def _variants_module():
    path = Path(__file__).resolve().parents[1] / "tools" / "mcmc_variants.py"
    spec = importlib.util.spec_from_file_location("mcmc_variants", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_BUBBLE = _layout(_bubble_vars(), [[1, 1, 1]], block=16, custom=True)
_MV = _variants_module()
_VARIANTS = _MV.variants(_BUBBLE)
_ABLATIONS = _MV.ablations()


@pytest.mark.parametrize("k", range(len(_VARIANTS)), ids=[v[0] for v in _VARIANTS])
def test_kernel_variant_edits_find_their_lines(k):
    """Each variant of tools/mcmc_variants.py changes the kept kernels: every
    source edit replaces a line found exactly once in csrc/ as the edits
    before it left the file, and a variant without edits moves a histogram
    or the counters to device memory."""
    name, edits, hist, cnt = _VARIANTS[k]
    csrc = Path(_build.CSRC)
    texts = {}
    for f, old, new in edits:
        text = texts.get(f) or (csrc / f).read_text()
        assert text.count(old) == 1, (name, f, old)
        texts[f] = text.replace(old, new)
    if edits:
        assert any(new != old for _, old, new in edits)
    else:
        assert (hist, cnt) != (mk.SMEM_HIST_BINS, mk.SMEM_COUNTERS)


@pytest.mark.parametrize("k", range(len(_ABLATIONS)), ids=[a[0] for a in _ABLATIONS])
def test_measure_ablation_edits_find_their_lines(k):
    """Each ablation of mcmc_measure in tools/mcmc_variants.py replaces lines
    found exactly once in its source."""
    name, edits = _ABLATIONS[k]
    for f, old, new in edits:
        assert f == _MV.MEASURE and new != old
        assert (Path(_build.CSRC) / f).read_text().count(old) == 1, (name, old)
