"""Build and load the hand-written CUDA kernels of ``csrc/``.

``nvcc`` compiles every ``csrc/*.cu`` file into an object, one process per
file, all started together, and then links the objects into one shared
library with a plain C interface, at first use, into ``build/torch_kernels/``
beside the package; the file name carries a hash of the sources and flags,
so an edited source rebuilds and an unchanged one loads at once.  The
library is loaded with ``ctypes``; every pointer and the stream are
``c_void_p`` arguments (without explicit argtypes ctypes would cut them to
32 bits).

No PyTorch header is included, so a build takes seconds, not minutes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              # no fused multiply-add: every a*b + c must round like the
              # plain torch version (a separate multiply and add)
              "--fmad=false"]

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # kd, t0, B, T, nb, m, nslots, atab, grid, inc, slot_leaf, x, invp, perm, stream
    "mci_vegas_sample": [_P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    # w, invp, perm, pad, pair_slots, used, N, nslots, npair, maxmem, R, nb, m,
    # mobs, ncomp, mf, t0, T, obs_rows, hrow, stream
    "mci_vegas_reduce": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _I, _I,
                         _P, _I, _I, _I, _I, _P, _P, _P],
    # w, invp, pad, pair_slots, N, nslots, npair, maxmem, R, m, relw, stream
    "mci_vegas_relw": [_P, _P, _P, _P, _I, _I, _I, _I, _LL, _I, _P, _P],
    # kd, t, init, W, wb, L, S, nvar, nelig, meta, tab, smem_floats, cur_val,
    # cur_gidx, cur_prob, prp_val, prp_gidx, prp_prob, prop, move, stream
    "mci_chain_propose": [_P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _I,
                          _P, _P, _P, _P, _P, _P, _P, _P, _P],
    # kd, t, init, measure, custom, W, wb, L, S, nvar, nelig, N, meta, rw, H,
    # hist_smem, prp_val, prp_gidx, prp_prob, cur_val, cur_gidx, cur_prob,
    # nw, prop, move, w, pad, p, obs, nrm, vis, pc, ac, hist, relw, stream
    "mci_chain_accept": [_P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                         _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _P, _P, _P, _P, _P, _P, _P, _P, _P],
    # ncomp, W, m, obs, stream
    "mci_chain_measure": [_I, _I, _P, _P, _P],
    # kd, sched, t, init, W, wb, L, nvar, nd, any_swap, meta, tab, cur_val,
    # cur_gidx, cur_prob, prp_val, prp_gidx, prp_prob, curr, prob, picv, dof,
    # prop, move, stream
    "mci_mcmc_propose": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                         _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    # kd, sched, t, init, measure, custom, W, wb, L, nvar, nd, C, meta, tab,
    # rw, nw, H, hist_smem, cnt_smem, cur_val, cur_gidx, cur_prob, prp_val,
    # prp_gidx, prp_prob, curr, weight, prob, rcur, degc, picv, dof, prop,
    # move, relw, obs, nrm, vis, tally, hist, stream
    "mci_mcmc_accept": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                        _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    # lo, n, ncomp, W, m (a host array of n pointers), curr, obs, stream
    "mci_mcmc_measure": [_I, _I, _I, _I, _P, _P, _P, _P],
    # kd, t0, B, T, c, S, nstrat, cube, meta, tab, x, gidx, stream
    "mci_vplus_sample": [_P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    # w, gidx, cube, cfac, tab, meta, N, S, P, M, BT, c, ncubes, H, hist_smem,
    # span, warps, mobs, ncomp, mf, t0, T, shift, obs_rows, sig, hist, stream
    "mci_vplus_reduce": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _I, _I, _I,
                         _I, _I, _I, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    # w, gidx, cube, cfac, tab, meta, N, S, P, M, BT, c, span, warps, relw, stream
    "mci_vplus_relw": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _I, _I, _I, _P, _P],
    # kd, t0, B, T, c, S, meta, atab, tab, smem_floats, x, gidx, stream
    "mci_vegas_sample_mixed": [_P, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P, _P, _P],
    # w, gidx, tab, meta, N, S, P, M, BT, c, H, hist_smem, span, warps, mobs,
    # ncomp, mf, t0, T, obs_rows, hist, stream
    "mci_vegas_reduce_mixed": [_P, _P, _P, _P, _I, _I, _I, _I, _LL, _I, _I, _I, _I, _I, _P,
                               _I, _I, _I, _I, _P, _P, _P],
    # w, gidx, tab, meta, N, S, P, M, BT, c, span, warps, relw, stream
    "mci_vegas_relw_mixed": [_P, _P, _P, _P, _I, _I, _I, _I, _LL, _I, _I, _I, _P, _P],
}

# the complex-weight instantiations take the real ones' arguments
_SIGNATURES["mci_chain_accept_complex"] = _SIGNATURES["mci_chain_accept"]
_SIGNATURES["mci_vegas_reduce_complex"] = _SIGNATURES["mci_vegas_reduce"]
_SIGNATURES["mci_vegas_relw_complex"] = _SIGNATURES["mci_vegas_relw"]
_SIGNATURES["mci_vegas_reduce_mixed_complex"] = _SIGNATURES["mci_vegas_reduce_mixed"]
_SIGNATURES["mci_vegas_relw_mixed_complex"] = _SIGNATURES["mci_vegas_relw_mixed"]
_SIGNATURES["mci_vplus_reduce_complex"] = _SIGNATURES["mci_vplus_reduce"]
_SIGNATURES["mci_vplus_relw_complex"] = _SIGNATURES["mci_vplus_relw"]
_SIGNATURES["mci_mcmc_accept_complex"] = _SIGNATURES["mci_mcmc_accept"]

_lib = None
build_seconds = None   # wall time of this process's build, None if cached
build_log = ""         # nvcc's output of a verbose build, ptxas -v's lines included


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return str(path)


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):          # sources and headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmci_kernels_{h.hexdigest()[:16]}.so"


def load(verbose: bool = False):
    """The loaded kernel library, built first if needed.

    ``verbose`` prints nvcc's output, including ``-Xptxas -v``'s registers
    and spills per kernel, and keeps it in ``build_log``.
    """
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
            nvcc = _nvcc()
            ptxas = ["-Xptxas", "-v"] if verbose else []
            procs, objs = [], []
            for src in sorted(CSRC.glob("*.cu")):
                obj = Path(tmpdir) / f"{src.stem}.o"
                cmd = [nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", str(obj), str(src)]
                procs.append((cmd, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
                objs.append(str(obj))
            logs = [proc.communicate()[0] for _, proc in procs]   # wait for all
            for (cmd, proc), log in zip(procs, logs):
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                                       f"{' '.join(cmd)}\n{log}")
            tmp = Path(tmpdir) / out.name
            cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *objs]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc link failed with code {proc.returncode}:\n"
                                   f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
            if verbose:
                build_log = "".join(logs) + proc.stdout + proc.stderr
                print(build_log)
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        build_seconds = time.perf_counter() - t0
    _lib = bind(out)
    return _lib


def bind(path):
    """The kernel library at ``path``, loaded with its C signatures."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.mci_error_string.argtypes = [ctypes.c_int]
    lib.mci_error_string.restype = ctypes.c_char_p
    return lib


def check(lib, err: int, name: str):
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} "
                           f"({lib.mci_error_string(err).decode()})")


def tree_sum(t, dim: int):
    """``t`` summed over ``dim`` in a fixed pairwise order: element ``k`` of
    the first half plus element ``k`` of the second half, halving until one
    is left (an odd count keeps its last element for the next round).  Each
    round is an elementwise add, so a sum's bits depend only on the values
    summed: not on the sizes of the other axes (how many blocks a rank
    holds), the layout, the number of components or the device.  The real
    parts of a complex run's ``f + 0j`` then sum as the real run's ``f``."""
    n = t.shape[dim]
    if n == 0:
        return t.sum(dim=dim)
    while n > 1:
        h = n // 2
        s = t.narrow(dim, 0, h) + t.narrow(dim, h, h)
        t = torch.cat([s, t.narrow(dim, 2 * h, 1)], dim=dim) if n % 2 else s
        n = t.shape[dim]
    return t.squeeze(dim)


def check_tensor(t, name: str, dtype, shape, device):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what a kernel takes through a bare pointer."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
