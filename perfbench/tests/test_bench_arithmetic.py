"""The metric arithmetic on synthetic inputs: a rate over all work and all
time, a p95 over every iteration, the idle union, the roofline share, the
trace's summary and the comparison's numbers."""

import math

import numpy as np
import pytest

import run
from harness import cells, checks, shapes, trace
from harness.peaks import PEAK_BYTES, PEAK_F32, PEAK_INT, bound_s


LIMITS = {"z_max": 3.0, "z_rms": 2.0, "stats_gap": 1e-6, "chi2_median": 0.5, "map_gap": 0.01}
GRID = np.linspace(0.0, 1.0, 5)


def _call(t0, t1, iters, seen, neval=None, mean=(1.0,), stdev=(0.1,), chi2=None, grid=GRID):
    """A call whose two iterations past the first combine to ``mean`` and
    ``stdev`` with the reduced chi2 ``chi2`` (1 by default)."""
    mean, stdev = np.array(mean, np.float64), np.array(stdev, np.float64)
    c = np.ones_like(mean) if chi2 is None else np.array(chi2, np.float64)
    d = np.sqrt(c) * stdev               # two equal error bars s = sqrt(2) stdev, means m -+ d
    s = np.sqrt(2.0) * stdev - 1e-10
    return dict(t0=t0, t1=t1, iter_times=list(iters), seen=seen,
                neval=seen if neval is None else neval, mean=mean, stdev=stdev, chi2=c,
                it_means=[mean + 5.0, mean - d, mean + d], it_stds=[stdev, s, s], ignore=1,
                grids=[np.asarray(grid, np.float64)], profiled=False, seed=0)


REF = {"stdev": np.array([0.05]), "grids": [GRID]}


def test_rate_is_all_work_over_all_time():
    out = {"calls": [_call(10.0, 11.0, [0.4, 0.5], 100), _call(11.5, 13.0, [0.7], 300)],
           "t_ready": 1009.0}
    got = run.end_to_end(out, 1000.0)
    assert got["evals_per_s"] == pytest.approx(400 / 3.0)
    assert got["setup_s"] == pytest.approx(9.0)


@pytest.mark.parametrize("n", [1, 19, 20, 21, 200, 201])
def test_p95_is_the_nearest_rank(n):
    v = list(np.random.default_rng(n).permutation(n) + 1.0)
    got = run.p95(v)
    assert sum(x <= got for x in v) >= 0.95 * n
    assert sum(x < got for x in v) < 0.95 * n


def test_p95_over_every_iteration_of_every_call():
    calls = [_call(0, 1, [0.01] * 100, 1), _call(1, 2, [0.02] * 99 + [5.0], 1)]
    got = run.end_to_end({"calls": calls, "t_ready": 0.0}, 0.0)
    assert got["iter_ms_p95"] == pytest.approx(20.0)


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert trace.union_s(iv) == pytest.approx(3.0)
    assert trace.gaps(iv, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0), (4.0, 5.0)]
    assert trace.gaps(iv, 0.0, 4.0) == [(2.0, 3.0)]


def test_summary_of_a_trace():
    dev = [("void vplus_reduce_kernel<float, (Mode)0, 0>(float const*)", 1.0, 2.0),
           ("void at::native::vectorized_elementwise_kernel<4>(int)", 2.0, 5.0),
           ("Memcpy DtoH (Device -> Pageable)", 6.0, 6.5),
           ("void at::native::vectorized_elementwise_kernel<4>(int)", 9.0, 12.0)]
    host = [(trace.CALL_SPAN, 0.0, 10.0), ("driver.train_continuous", 5.0, 6.2),
            ("aten::copy_", 6.0, 6.5), ("cudaStreamSynchronize", 6.5, 9.0)]
    s = trace.summarize(dev, host)
    assert s["window_s"] == pytest.approx(10.0)
    assert s["busy_s"] == pytest.approx(1.0 + 3.0 + 0.5 + 1.0)
    idle = dict(s["idle_gaps"])
    assert idle["driver.train_continuous"] == pytest.approx(1.0)      # 5.0-6.0
    assert idle["cudaStreamSynchronize"] == pytest.approx(2.5)        # 6.5-9.0
    assert idle["host: python, no profiled op"] == pytest.approx(1.0)  # 0.0-1.0
    assert s["device_ops"][0][0].startswith("void at::native")
    assert s["ops"]["void at::native::vectorized_elementwise_kernel<4>(int)"] == \
        {"launches": 2, "seconds": pytest.approx(4.0)}


def _ctx(ops, busy=10.0, window=12.0, evals=2 ** 27, iters=2, cell="sing3d.vegasplus"):
    c = cells.workload(cell)
    cfg = cells.config(c["config"])
    prof = {"ops": ops, "busy_s": busy, "window_s": window}
    return dict(profile=prof, calls=[], cell=c, shape=shapes.launch_shape(c, cfg),
                kernels=cells.all_kernels(), profiled_evals=evals, profiled_iters=iters)


def test_idle_integrand_and_kernel_counts():
    ops = {"void vplus_sample_kernel<float>(int)": {"launches": 2, "seconds": 1.0},
           "void vplus_reduce_kernel<float, (Mode)0, 0>(int)": {"launches": 2, "seconds": 2.0},
           "void at::native::sin<float>(int)": {"launches": 6, "seconds": 6.0},
           "Memcpy HtoD (Pageable -> Device)": {"launches": 4, "seconds": 1.0}}
    ctx = _ctx(ops)
    read = lambda name: cells.metric_reader(name)[0](ctx, cells.metric_reader(name)[1])
    assert read("idle_pct") == pytest.approx(100 * 2 / 12)
    assert read("integrand_pct") == pytest.approx(60.0)
    assert read("kernels_per_iter") == pytest.approx(5.0)


def test_roofline_share():
    ops = {"void vplus_reduce_chunks_kernel<double, 0, 1>(int)": {"launches": 2,
                                                                 "seconds": 0.004}}
    ctx = _ctx(ops)
    read, arg = cells.metric_reader("roofline_pct.vplus_reduce")
    shape = dict(ctx["shape"], n=2 ** 26)
    nbytes, flops, ints = cells.kernel("vplus_reduce").counts(shape)
    want = 100 * max(nbytes / PEAK_BYTES, flops / PEAK_F32, ints / PEAK_INT) / 0.002
    assert read(ctx, arg) == pytest.approx(want)
    # a kernel that did not run, or that the cell does not list, reads nothing
    assert cells.metric_reader("roofline_pct.vplus_sample")[0](ctx, "vplus_sample") is None
    assert read(_ctx(ops, cell="bubble.vegas"), arg) is None


def test_bound_is_the_slower_pipe():
    assert bound_s(3.35e9) == pytest.approx(1e-3)
    assert bound_s(0, 67e9) == pytest.approx(1e-3)
    assert bound_s(0, 0, 16.7e9) == pytest.approx(1e-3)
    assert bound_s(3.35e9, 134e9) == pytest.approx(2e-3)


def test_comparison_numbers():
    exact = np.array([1.0, 2.0])
    calls = [_call(0, 1, [1], 10, mean=(1.1, 2.0), stdev=(0.1, 0.5)),
             _call(1, 2, [1], 10, neval=12, mean=(0.8, 2.5), stdev=(0.1, 0.25))]
    ok, failed, numbers = checks.judge(calls, exact, LIMITS)
    got = {n: v for n, v, _ in numbers}
    assert [n for n, _, _ in numbers] == ["z_max", "z_rms", "evals_missing", "stats_gap",
                                          "chi2_median"]
    assert got["z_max"] == pytest.approx(2.0)
    assert got["z_rms"] == pytest.approx(math.sqrt((1 + 0 + 4 + 4) / 4))
    assert got["evals_missing"] == 2
    assert got["stats_gap"] < 1e-9 and got["chi2_median"] == pytest.approx(1.0)
    assert not ok and failed == 0
    calls[1]["neval"] = 10
    assert checks.judge(calls, exact, LIMITS)[0]
    assert not checks.judge(calls, exact, dict(LIMITS, z_max=1.9))[0]


def test_a_wrong_combination_of_the_iterations_shows_in_stats_gap():
    exact = np.array([1.0])
    calls = [_call(0, 1, [1], 10), _call(1, 2, [1], 10)]
    assert checks.judge(calls, exact, LIMITS)[0]
    for key, factor, gap in [("chi2", 2.0, 1.0), ("stdev", 1.5, 0.5), ("mean", 1.01, 0.1)]:
        bad = [dict(c) for c in calls]
        bad[1][key] = bad[1][key] * factor
        ok, _, numbers = checks.judge(bad, exact, LIMITS)
        assert not ok and dict((n, v) for n, v, _ in numbers)["stats_gap"] == \
            pytest.approx(gap), key


def test_overstated_error_bars_fall_below_the_chi2_floor():
    exact = np.array([1.0])
    calls = [_call(0, 1, [1], 10, chi2=(c,)) for c in (0.2, 1.0, 1.2)]
    ok, _, numbers = checks.judge(calls, exact, LIMITS)
    assert ok and numbers[-1] == ("chi2_median", pytest.approx(1.0), 0.5)
    calls = [_call(0, 1, [1], 10, chi2=(c,)) for c in (0.05, 0.25, 1.2)]
    ok, _, numbers = checks.judge(calls, exact, LIMITS)
    assert not ok and numbers[-1][1] == pytest.approx(0.25)
    assert "chi2_median 0.25" in checks.line(numbers) and "(at least 0.5)" in checks.line(numbers)


def test_map_gap_and_stdev_ratio_against_the_reference():
    exact = np.array([1.0])
    moved = GRID + np.array([0.0, 0.02, 0.02, 0.02, 0.0])          # a mean gap of 0.012
    calls = [_call(0, 1, [1], 10), _call(1, 2, [1], 10, grid=moved),
             _call(2, 3, [1], 10, stdev=(0.2,), grid=moved)]
    ok, _, numbers = checks.judge(calls, exact, dict(LIMITS, stdev_ratio=2.5), REF)
    got = {n: v for n, v, _ in numbers}
    assert got["map_gap"] == pytest.approx(0.012) and got["stdev_ratio"] == pytest.approx(2.0)
    assert not ok
    assert checks.judge(calls, exact, dict(LIMITS, map_gap=0.02, stdev_ratio=2.5), REF)[0]
    assert not checks.judge(calls, exact, dict(LIMITS, map_gap=0.02, stdev_ratio=1.5), REF)[0]
    # a map of another size is no map of the problem
    calls = [_call(0, 1, [1], 10, grid=np.linspace(0.0, 1.0, 7))]
    assert not checks.judge(calls, exact, dict(LIMITS, map_gap=1.0), REF)[0]


@pytest.mark.parametrize("stdev", [0.0, float("nan")])
def test_an_answer_without_an_error_bar_fails(stdev):
    calls = [_call(0, 1, [1], 10, mean=(1.0,), stdev=(stdev,))]
    ok, failed, _ = checks.judge(calls, np.array([1.0]), LIMITS)
    assert not ok and failed == 1
