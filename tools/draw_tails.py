"""Block-error tails of the Markov solvers, and what the number of ``mix32``
rounds per draw does to them.

A chain step's draws are ``mix32(base + c*0x85EBCA6B)`` for salts ``c`` a
constant apart (one round, ``ops/chain_kernels.py:_uniform`` and
``csrc/chain_common.cuh:uniform``); the tool can put a second ``mix32``
over each draw (two rounds): of the plain versions on the CPU, of the
kernels, built from an edited copy of the sources, on the card.
For each seed it runs ``integrate`` on an integrand of constant modulus
over ``[0, 1)^2``, where the chain's acceptance sees only the map:
``sign(0.8 - x - y)``, ``e^{i(x+y)}``, or ``e^{i x}`` binned by a
``Discrete(1, 3)`` value through the complex one-hot measure of
``chip_smoke.py`` phase 4f.  It collects the z of every iteration after the
first and of the final result against the exact value (real and imaginary
parts, and bins, apart), and prints the rms of the per-iteration z with
its standard error, the largest |z|, the share beyond 3 and 4, and the rms
of the final z.  With 16 blocks z is t-distributed with 15 degrees of
freedom: rms 1.074, share beyond 3 0.009, beyond 4 0.0012.

    python3 tools/draw_tails.py --solver mcmc --seeds 41:441 --procs 6
    python3 tools/draw_tails.py --device cuda --case onehot --neval 268435456 \\
        --nwalkers 1048576 --niter 10 --seeds 1:41      # on a CUDA card

On the CPU each worker is one process with one torch thread.  On the card
the seeds run one after another in one process; two rounds come after
one, since the edited sources then stay loaded.
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PHASE = np.sin(1.0) + 1j * (1.0 - np.cos(1.0))       # int_0^1 e^{it} dt
QBIN = 3


def draws(rounds):
    """``(uniform, uniforms)``: the plain versions' draw of one salt and of
    a list of salts, with ``rounds`` ``mix32`` rounds."""
    import torch

    from mcintegration_tpu_torch.ops.rng import MASK32, mix32

    def bits(x):
        for _ in range(rounds):
            x = mix32(x)
        return ((x >> 8).to(torch.float32) + 0.5) * 2.0 ** -24

    def uniforms(base, salts):
        c = torch.tensor([(s * 0x85EBCA6B) & MASK32 for s in salts], dtype=torch.int64,
                         device=base.device)[:, None]
        return bits((base[None] + c) & MASK32)

    def uniform(base, c):
        return bits((base + ((c * 0x85EBCA6B) & MASK32)) & MASK32)

    return uniform, uniforms


def two_round_kernels():
    """Point ``ops/_build.py`` at a copy of the CUDA sources whose draws
    take a second ``mix32`` round (``chain_common.cuh:uniform``, which the
    chain and the :mcmc kernels share); the next ``load`` builds it."""
    import shutil

    from mcintegration_tpu_torch.ops import _build
    d = _build.BUILD_DIR / "two_rounds_src"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d)
    h = d / "chain_common.cuh"
    old = "const uint32_t bits = mix32(base + c * 0x85EBCA6Bu);"
    src = h.read_text()
    assert src.count(old) == 1, "chain_common.cuh:uniform moved"
    h.write_text(src.replace(old, "const uint32_t bits = mix32(mix32(base + c * 0x85EBCA6Bu));"))
    _build.CSRC, _build._lib = d, None


def _onehot(v, relw, c):
    from mcintegration_tpu_torch import onehot
    return [onehot(v[1][0], 1, QBIN, relw.dtype) * relw[0]]


def _problem(mt, case, solver):
    """``(integrand, measure, integrate keywords, exact)``."""
    import torch
    cont = mt.Continuous(0.0, 1.0)
    if case == "sign":
        f, kw, exact = (lambda x, c: torch.where(x[0] + x[1] < 0.8, 1.0, -1.0)), {}, -0.36
    elif case == "phase":
        f, kw, exact = (lambda x, c: torch.exp(1j * (x[0] + x[1]))), {}, PHASE ** 2
    else:
        f, exact = (lambda x, c: torch.exp(1j * x[0][0])), np.full(QBIN, PHASE)
        kw = dict(var=(cont, mt.Discrete(1, QBIN)), dof=[[1, 1]],
                  obs=[np.zeros(QBIN, np.complex64)], measure=_onehot)
    kw = dict(dict(var=cont, dof=[[2]], type=float if case == "sign" else complex), **kw)
    if solver == "mcmc":
        f = (lambda g: lambda i, x, c: g(x, c))(f)
        if "measure" in kw:
            kw["measure"] = lambda i, x, w, c: _onehot(x, w[None], c)
    return f, kw, exact


def _z(args):
    """(per-iteration z, final z) of one seed."""
    solver, case, rounds, seed, device, neval, nwalkers, niter = args
    import torch

    import mcintegration_tpu_torch as mt
    from mcintegration_tpu_torch.ops import chain_kernels as ck, mcmc_kernels as mk

    if device == "cpu":
        torch.set_num_threads(1)
        uniform, uniforms = draws(rounds)
        ck._uniform, mk._uniform, mk._uniforms = uniform, uniform, uniforms
    f, kw, exact = _problem(mt, case, solver)
    res = mt.integrate(f, neval=neval, nwalkers=nwalkers, niter=niter, verbose=-2, seed=seed,
                       solver=solver, device=device, **kw)

    def z(m, s):
        m, s = np.ravel(m), np.ravel(s)
        e = np.broadcast_to(exact, m.shape)
        if kw["type"] is float:
            return list((m - e) / s)
        return list((m.real - e.real) / s.real) + list((m.imag - e.imag) / s.imag)

    its = [v for m, s, _ in res.iterations[1:] for v in z(m[0], s[0])]
    return its, z(res.mean[0], res.stdev[0])


def stats(its, fin):
    its, fin = np.ravel(its), np.ravel(fin)
    rms = float(np.sqrt(np.mean(its ** 2)))
    se = float(np.std(its ** 2) / (2 * rms * np.sqrt(its.size)))
    return dict(n=int(its.size), rms=rms, rms_se=se, max=float(np.abs(its).max()),
                over3=float(np.mean(np.abs(its) > 3)), over4=float(np.mean(np.abs(its) > 4)),
                final_rms=float(np.sqrt(np.mean(fin ** 2))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--solver", choices=("vegasmc", "mcmc"), default="mcmc")
    ap.add_argument("--case", choices=("sign", "phase", "onehot"), default="sign")
    ap.add_argument("--seeds", default="1:41", help="first:last (exclusive)")
    ap.add_argument("--rounds", default="1,2")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    ap.add_argument("--neval", type=int, default=2 ** 16)
    ap.add_argument("--nwalkers", type=int, default=None)
    ap.add_argument("--niter", type=int, default=5)
    ap.add_argument("--procs", type=int, default=4)
    a = ap.parse_args()
    lo, hi = map(int, a.seeds.split(":"))
    for r in map(int, a.rounds.split(",")):
        jobs = [(a.solver, a.case, r, s, a.device, a.neval, a.nwalkers, a.niter)
                for s in range(lo, hi)]
        if a.device == "cuda":
            if r == 2:
                two_round_kernels()
            out = [_z(j) for j in jobs]
        else:
            with mp.get_context("spawn").Pool(a.procs) as pool:
                out = pool.map(_z, jobs)
        st = stats([o[0] for o in out], [o[1] for o in out])
        print(f"{a.solver} {a.case} on {a.device}, {a.niter} iterations of {a.neval} evals, "
              f"seeds {lo}:{hi}, {r} round(s): per-iteration z rms {st['rms']:.4f} +- "
              f"{st['rms_se']:.4f} (n {st['n']}), max |z| {st['max']:.3f}, share > 3 "
              f"{st['over3']:.4f}, > 4 {st['over4']:.4f}; final z rms {st['final_rms']:.4f} "
              f"(n {np.size([o[1] for o in out])})", flush=True)


if __name__ == "__main__":
    main()
