"""PyTorch port: the Markov solvers' random draws, independent across salts
and steps.

Every draw of a chain step is ``mix32(base + c*0x85EBCA6B)`` for the
walker's ``base`` at step ``t`` and a salt ``c`` per draw
(``ops/chain_kernels.py:_uniform``; the :mcmc plain versions and kernels
use the same hash).  Over the 2^20 walkers of 16 blocks, each salt's
uniforms must be uniform (256 bins) and every pair of salts of one step,
and one salt at steps ``t`` and ``t + 1``, must be independent (16 x 16
joint bins).  The gate is a chi-square above its 1e-9 upper quantile: 414.5
for 255 degrees of freedom.  The data are fixed by their seeds, so the
test is deterministic.

``tools/draw_tails.py`` measures what the draws do to the block-error z of
whole runs (one round against two, on many seeds); the test here also
holds that tool's one-round draw to the port's.
"""

import itertools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mcintegration_tpu_torch as mt
from mcintegration_tpu_torch.ops import chain_kernels as ck, mcmc_kernels as mk
from mcintegration_tpu_torch.ops.rng import block_keys
from mcintegration_tpu_torch.solvers.engine import Spec

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import draw_tails  # noqa: E402

CHI2_GATE = 414.5          # chi2 with 255 degrees of freedom, upper 1e-9 quantile
SALTS = sorted({ck.SALT_GROUP, ck.SALT_SLOT, ck.SALT_ACCEPT, ck.SALT_LEAF, ck.SALT_LEAF + 1,
                mk.SALT_ACCEPT, mk.SALT_CV, mk.SALT_CV + 1, mk.SALT_SHIFT, mk.SALT_SHIFT + 1,
                mk.SALT_CI, ck.SALT_INIT, ck.SALT_INIT + 1})


def _bases(t, block=16, wb=2 ** 16):
    spec = Spec(mt.Configuration(var=mt.Continuous(0.0, 1.0), dof=[[2]], seed=1), "cpu")
    lay = ck.ChainLayout.build(spec, block, wb)
    kd = torch.as_tensor(block_keys(5, 0, 0, block))
    return ck._walker_base(lay, kd, t)


def _chi2(counts):
    counts = counts.double()
    e = counts.sum() / counts.numel()
    return float(((counts - e) ** 2 / e).sum())


def _joint(u, v, nb=16):
    i = (u * nb).long().clamp_(max=nb - 1) * nb + (v * nb).long().clamp_(max=nb - 1)
    return _chi2(torch.bincount(i, minlength=nb * nb))


@pytest.fixture(scope="module")
def draws():
    base = _bases(7)
    return {c: ck._uniform(base, c) for c in SALTS}, _bases(8)


def test_each_salt_uniform(draws):
    u, _ = draws
    for c, x in u.items():
        chi = _chi2(torch.bincount((x * 256).long().clamp_(max=255), minlength=256))
        assert chi < CHI2_GATE, (c, chi)


def test_salts_of_a_step_independent(draws):
    u, _ = draws
    worst = max((_joint(u[a], u[b]), a, b) for a, b in itertools.combinations(SALTS, 2))
    assert worst[0] < CHI2_GATE, worst


def test_steps_independent(draws):
    u, base_next = draws
    for c in (ck.SALT_ACCEPT, ck.SALT_LEAF, mk.SALT_CV):
        chi = _joint(u[c], ck._uniform(base_next, c))
        assert chi < CHI2_GATE, (c, chi)


def test_tool_draws_are_the_ports():
    base = _bases(3, block=2, wb=64)
    uniform, uniforms = draw_tails.draws(1)
    salts = [ck.SALT_ACCEPT, mk.SALT_CV + 2]
    for c in salts:
        assert torch.equal(uniform(base, c), ck._uniform(base, c))
    assert torch.equal(uniforms(base, salts), mk._uniforms(base, salts))
    assert not torch.equal(draw_tails.draws(2)[0](base, 3), ck._uniform(base, 3))
