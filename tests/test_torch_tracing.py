"""PyTorch port: the spans ``integrate`` records (``mcintegration_tpu_torch.tracing``)
on every route, on the CPU.

- with recording off nothing is recorded, ``span`` hands back one shared
  no-op and no profiler range opens;
- with recording on the results are the bits of a run with it off;
- a call's spans form one tree: one ``mct.call``, an ``mct.iteration`` an
  iteration holding the solver's ``mct.issue``, ``mct.wait`` and
  ``mct.collect``, every
  span inside its parent and all sharing the call's id; an iteration's span
  lasts its ``Result.iteration_times`` entry;
- the ``cache`` attribute counts the iteration cache's hits and misses;
- the ``guard`` attribute says where the weights' non-finite guard runs:
  in the kernels on :vegas and :vegasplus, in torch on the Markov solvers;
- under a ``torch.profiler`` profile the spans are recorded without
  ``enable()`` and appear among the profiler's host events;
- the buffer keeps its last ``MAXLEN`` records, and threads keep their own
  trees;
- over two ranks a recording rank records each iteration's gather, and a
  rank may record while the other does not, by ``enable()`` or under a
  profiler, with no collective that the other lacks.
"""

import os
import pickle
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import mcintegration_tpu_torch as mt
import mcintegration_tpu_torch.main as tmain
from mcintegration_tpu_torch import tracing

ROOT = Path(__file__).resolve().parents[1]
NITER = 3


def _pi(x, c):
    return torch.where(x[0] ** 2 + x[1] ** 2 < 1.0, 1.0, 0.0) * (1.0 + x[1])


def _pi_idx(i, x, c):
    return _pi(x, c)


def _mixed(x, c):
    return x[0] * x[1].to(x[0].dtype)


ROUTES = {
    "vegas": dict(solver="vegas"),
    "vegas-mixed": dict(solver="vegas", f=_mixed, dof=[[1, 1]],
                        var=lambda: (mt.Continuous(0.0, 1.0, ninc=64), mt.Discrete(1, 3))),
    "vegasplus": dict(solver="vegasplus"),
    "vegasmc": dict(solver="vegasmc"),
    "mcmc": dict(solver="mcmc", f=_pi_idx),
}
GUARDS = {"vegas": "kernel", "vegas-mixed": "kernel", "vegasplus": "kernel",
          "vegasmc": "torch", "mcmc": "torch"}
KINDS = {"vegas": "VegasIteration", "vegas-mixed": "VegasMixedIteration",
         "vegasplus": "VegasPlusIteration", "vegasmc": "VegasMCIteration",
         "mcmc": "MCMCIteration"}


def _run(route, seed=7, **kw):
    opts = dict(ROUTES[route])
    f = opts.pop("f", _pi)
    opts["var"] = opts.get("var", lambda: mt.Continuous(0.0, 1.0))()   # fresh pools a call
    opts.setdefault("dof", [[2]])
    return mt.integrate(f, neval=2 ** 12, niter=NITER, block=4, device="cpu", verbose=-2,
                        seed=seed, min_steps_per_walker=16, **opts, **kw)


@pytest.fixture(autouse=True)
def _fresh():
    torch.set_num_threads(1)
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


def _same(a, b) -> bool:
    return (np.array_equal(a.mean, b.mean) and np.array_equal(a.stdev, b.stdev)
            and np.array_equal(a.chi2, b.chi2)
            and all(np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
                    for x, y in zip(a.iterations, b.iterations))
            and all(np.array_equal(u.grid, v.grid) for (_, u), (_, v) in
                    zip(a.config.var_leaves(), b.config.var_leaves()) if hasattr(u, "grid")))


def _children(recs):
    out = {}
    for s in recs:
        out.setdefault(s["parent"], []).append(s)
    return out


@pytest.mark.parametrize("route", ROUTES)
def test_off_records_nothing_and_opens_no_record_function(route, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function opened while recording is off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(tracing, "_profiler_range", refuse)
    assert not tracing.recording()
    assert tracing.span("mct.call") is tracing.span("mct.issue", it=3)
    with tracing.span("mct.build") as s:
        s.set(cache="hit")
    _run(route, cache=False)
    assert tracing.spans() == []


@pytest.mark.parametrize("route", ROUTES)
def test_results_are_the_same_bits_with_recording_on(route):
    off = _run(route, cache=False)
    tracing.enable()
    on = _run(route, cache=False)
    tracing.disable()
    assert tracing.spans()
    assert _same(off, on)


@pytest.mark.parametrize("route", ROUTES)
def test_a_call_is_one_tree(route):
    mt.clear_kernel_cache()
    tracing.enable()
    res = _run(route)
    tracing.disable()
    recs = tracing.spans()
    kids = _children(recs)
    by_id = {s["id"]: s for s in recs}
    calls = [s for s in recs if s["name"] == "mct.call"]
    assert len(calls) == 1
    call = calls[0]
    assert call["parent"] is None and call["call"] == call["id"]
    assert call["attrs"] == {"solver": ROUTES[route]["solver"], "niter": NITER, "cache": "miss",
                             "guard": GUARDS[route]}
    assert all(s["call"] == call["id"] for s in recs)
    assert {s["name"] for s in kids[call["id"]]} == {
        "mct.cache_key", "mct.build", "mct.iteration", "mct.result"}
    its = [s for s in kids[call["id"]] if s["name"] == "mct.iteration"]
    assert [s["attrs"]["it"] for s in its] == list(range(NITER))
    for s, t in zip(its, res.iteration_times):
        names = [k["name"] for k in kids[s["id"]]]
        assert names[:3] == ["mct.issue", "mct.wait", "mct.collect"], names
        assert {"mct.merge", "mct.train", "mct.snapshot"} <= set(names)
        assert ("mct.reallocate" in names) == (route == "vegasplus")
        assert abs(1e-9 * (s["t1_ns"] - s["t0_ns"]) - t) < 5e-4
    for s in recs:
        assert s["t0_ns"] <= s["t1_ns"]
        if s["parent"] is not None:
            up = by_id[s["parent"]]
            assert up["t0_ns"] <= s["t0_ns"] and s["t1_ns"] <= up["t1_ns"], s
    assert type(next(iter(tmain._KERNEL_CACHE.values()))).__name__ == KINDS[route]


@pytest.mark.parametrize("route", ROUTES)
def test_the_cache_attribute_counts_hits_and_misses(route):
    mt.clear_kernel_cache()
    tracing.enable()
    _run(route)
    _run(route)
    _run(route, cache=False)
    _run(route, userdata=2.0)
    tracing.disable()
    got = [s["attrs"]["cache"] for s in tracing.spans() if s["name"] == "mct.call"]
    assert got == ["miss", "hit", "off", "uncacheable"]


@pytest.mark.parametrize("route", ROUTES)
def test_the_guard_attribute_names_where_the_guard_runs(route):
    """``kernel`` where the kernels guard each weight they load (:vegas on
    both routes, :vegasplus), ``torch`` where the solver guards the
    integrand's output (:vegasmc, :mcmc); a cache hit says the same."""
    mt.clear_kernel_cache()
    tracing.enable()
    _run(route)
    _run(route)
    tracing.disable()
    calls = [s["attrs"] for s in tracing.spans() if s["name"] == "mct.call"]
    assert [c["cache"] for c in calls] == ["miss", "hit"]
    assert [c["guard"] for c in calls] == [GUARDS[route]] * 2


def test_a_profiler_turns_recording_on_and_shows_the_spans():
    from torch.profiler import ProfilerActivity, profile

    assert not tracing.recording()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.recording()
        _run("vegas", cache=False)
    assert not tracing.recording()
    recorded = {s["name"] for s in tracing.spans()}
    assert {"mct.call", "mct.iteration", "mct.issue", "mct.collect", "mct.train"} <= recorded
    host = {e.name for e in prof.events()}
    assert recorded <= host


def test_the_buffer_keeps_the_last_maxlen_records():
    tracing.enable()
    for k in range(tracing.MAXLEN + 10):
        with tracing.span("s", k=k):
            pass
    recs = tracing.spans()
    assert len(recs) == tracing.MAXLEN
    assert recs[0]["attrs"]["k"] == 10 and recs[-1]["attrs"]["k"] == tracing.MAXLEN + 9
    tracing.clear()
    assert tracing.spans() == []


def test_threads_record_trees_of_their_own():
    tracing.enable()
    errors = []

    def worker(seed):
        try:
            _run("vegas", seed=seed, cache=False)
        except Exception as e:          # reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(s,)) for s in (11, 12, 13)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors
    recs = tracing.spans()
    by_id = {s["id"]: s for s in recs}
    calls = [s for s in recs if s["name"] == "mct.call"]
    assert len(calls) == 3
    for s in recs:
        if s["parent"] is not None:
            assert by_id[s["parent"]]["call"] == s["call"]
    for c in calls:
        its = [s for s in recs if s["parent"] == c["id"] and s["name"] == "mct.iteration"]
        assert len(its) == NITER


# ---------------------------------------------------------------------------
# two ranks
# ---------------------------------------------------------------------------

RECORDING = {"both": (True, True), "rank0": (True, False), "rank0-profiled": (None, False)}


def _worker(rank: int, world: int, port: int, out: str, how: str):
    """One rank: a :vegas run over the world, recording spans by
    ``enable()`` (True), under a CPU profiler (None) or not at all
    (False), as ``RECORDING[how]`` gives for this rank."""
    from torch.profiler import ProfilerActivity, profile

    torch.set_num_threads(1)
    mt.init_distributed(f"127.0.0.1:{port}", world, rank)
    rec = RECORDING[how][rank]
    if rec:
        tracing.enable()
    if rec is None:
        with profile(activities=[ProfilerActivity.CPU]):
            res = _run("vegas", cache=False)
    else:
        res = _run("vegas", cache=False)
    tracing.disable()
    with open(out, "wb") as fh:
        pickle.dump((tracing.spans(), res.mean), fh)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


@pytest.mark.parametrize("how", RECORDING)
def test_two_ranks_record_the_gather(how, tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    code = ("import sys; sys.path.insert(0, {tests!r}); import test_torch_tracing as t; "
            "t._worker({rank}, 2, {port}, {out!r}, {how!r})")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code.format(tests=str(ROOT / "tests"), rank=r, port=port,
                                           out=str(tmp_path / f"rank{r}.pkl"), how=how)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=180)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log}"
    means = []
    for r in range(2):
        with open(tmp_path / f"rank{r}.pkl", "rb") as fh:
            recs, mean = pickle.load(fh)
        means.append(mean)
        by_id = {s["id"]: s for s in recs}
        got = [s for s in recs if s["name"].startswith("mct.ranks")]
        if RECORDING[how][r] is False:
            assert recs == []
            continue
        assert [s["name"] for s in got] == ["mct.ranks.gather"] * NITER, r
        assert all(by_id[s["parent"]]["name"] == "mct.iteration" for s in got)
    assert np.array_equal(means[0], means[1])
