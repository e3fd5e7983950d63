"""The check comes out false when the timed path is broken underneath: a run
on the CPU, its look for a card skipped, once sound and once with each
fault a cell can have planted in the port (``faults.py``).  The bfloat16
control is ``test_bench_reference.py``'s."""

import pytest

from conftest import make_copy, run_cpu

NEVAL = 2 ** 20      # large enough that a sound run's maps and answers read as sound


def holds(check):
    return check["value"] >= check["limit"] if check.get("at_least") else \
        check["value"] <= check["limit"]


def _args(cell, seed):
    return ["--workload", cell, "--seed", str(seed), "--seconds", "1", "--trace", "0"]


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return make_copy(tmp_path_factory.mktemp("faults") / "checkout", NEVAL)


@pytest.mark.parametrize("cell,fault,number", [
    ("sing3d.vegasplus", "half", "evals_missing"),
    ("sing3d.vegas", "half", "evals_missing"),
    ("bubble.vegas", "half", "evals_missing"),
    ("sing3d.vegasplus", "altered", "z_max"),
    ("sing3d.vegas", "altered", "z_max"),
    ("bubble.vegas", "altered", "z_max"),
    ("sing3d.vegasplus", "untrained", "map_gap"),
    ("sing3d.vegas", "untrained", "map_gap"),
    ("bubble.vegas", "untrained", "map_gap"),
    ("sing3d.vegas", "overstated", "chi2_median"),
    ("bubble.vegas", "chi2", "stats_gap"),
])
def test_a_fault_makes_the_run_incorrect(checkout, cell, fault, number):
    rc, sound, err = run_cpu(checkout, _args(cell, 41))
    assert rc == 0, err
    rc, res, err = run_cpu(checkout, _args(cell, 41), fault=fault)
    assert rc == 0, err
    assert res["correct"] is False
    check = res["checks"][number]
    assert not holds(check), res["checks"]
    # the limits are set for the cells' own sizes, where a sound run's maps
    # and error bars are steadier than in one call at this one: the sound
    # run's reading lies on the right side of the fault's by 3x or more
    # (half the batch: 0 against any other count)
    got = sound["checks"][number]["value"]
    if check.get("at_least"):
        assert got >= 3 * check["value"], (sound["checks"], res["checks"])
    else:
        assert got * 3 <= check["value"], (sound["checks"], res["checks"])
    # the numbers compared come last in the result line and on standard error
    assert list(res)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("perfbench: correct False")
