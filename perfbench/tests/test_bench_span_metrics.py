"""The four readers of the port's spans (``host_ms_per_iter``,
``issue_ms_per_iter``, ``call_self_ms``, ``cache_hit_pct``) against a span
list with known answers, and a tiny cell's traced run on the CPU reporting
all four."""

import pytest

from conftest import run_cpu
from harness import cells
from mcintegration_tpu_torch import tracing

MS = 1_000_000          # nanoseconds


def _span(sid, name, parent, call, t0, t1, **attrs):
    return dict(name=name, id=sid, parent=parent, call=call, t0_ns=t0 * MS, t1_ns=t1 * MS,
                attrs=attrs)


def _call(base, sid, cache, iters):
    """A ``mct.call`` from ``base`` ms holding ``iters`` iterations of
    ``(issue, wait, rest)`` ms each, 1 ms before the first and 2 ms after
    the last."""
    out, t, nxt = [], base + 1, sid + 1
    for issue, wait, rest in iters:
        it = nxt
        out += [_span(it + 1, "mct.issue", it, sid, t, t + issue),
                _span(it + 2, "mct.wait", it, sid, t + issue, t + issue + wait),
                _span(it + 3, "mct.collect", it, sid, t + issue + wait, t + issue + wait + 1),
                _span(it, "mct.iteration", sid, sid, t, t + issue + wait + rest)]
        t, nxt = t + issue + wait + rest, nxt + 4
    return out + [_span(sid, "mct.call", None, sid, base, t + 2, solver="vegas",
                        niter=len(iters), cache=cache)]


# call 100 is not profiled, 200 and 300 are; 400 lies past every call
SPANS = (_call(0, 100, "miss", [(50, 50, 50)])
         + _call(1000, 200, "miss", [(4, 10, 3), (6, 10, 5)])
         + _call(2000, 300, "hit", [(8, 20, 7)])
         + _call(9000, 400, "hit", [(1, 1, 1)]))
CALLS = [dict(t0=0.0, t1=0.5, profiled=False), dict(t0=0.9995, t1=1.1, profiled=True),
         dict(t0=1.9995, t1=2.1, profiled=True)]
EXPECT = {
    "host_ms_per_iter": (3 + 5 + 7) / 3,
    "issue_ms_per_iter": (4 + 6 + 8) / 3,
    "call_self_ms": (1 + 2 + 1 + 2) / 2,
    "cache_hit_pct": 50.0,
}


@pytest.fixture
def planted(monkeypatch):
    monkeypatch.setattr(tracing, "spans", lambda: list(SPANS))


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_readers_against_known_spans(name, planted):
    read, arg = cells.metric_reader(name)
    assert read({"calls": CALLS}, arg) == pytest.approx(EXPECT[name])


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_readers_find_nothing_without_profiled_spans(name, monkeypatch):
    read, arg = cells.metric_reader(name)
    monkeypatch.setattr(tracing, "spans", lambda: [])
    assert read({"calls": CALLS}, arg) is None
    monkeypatch.setattr(tracing, "spans", lambda: list(SPANS))
    assert read({"calls": [dict(c, profiled=False) for c in CALLS]}, arg) is None


def test_cache_hit_pct_leaves_out_calls_that_did_not_look(monkeypatch):
    spans = [dict(s, attrs={**s["attrs"], "cache": "off"}) if s["name"] == "mct.call" else s
             for s in SPANS]
    monkeypatch.setattr(tracing, "spans", lambda: spans)
    read, _ = cells.metric_reader("cache_hit_pct")
    assert read({"calls": CALLS}) is None


def test_a_traced_cpu_run_reports_the_four(tiny):
    rc, res, err = run_cpu(tiny, ["--workload", "bubble.vegas", "--seed", "3000000001",
                                  "--seconds", "0.5", "--trace", "1"])
    assert rc == 0, err
    got = res["metrics"]
    assert set(EXPECT) <= set(got), err
    assert got["cache_hit_pct"]["value"] == 0.0       # the key holds the seed
    assert got["issue_ms_per_iter"]["value"] > 0 and got["host_ms_per_iter"]["value"] > 0
    assert got["call_self_ms"]["value"] > 0
