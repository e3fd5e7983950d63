"""A cell, a traffic mix, a configuration, a kernel count and a per-layer
metric added as files alone, in a copy of the benchmark, are found by the
harness and reported by a run."""

import json
import textwrap

from conftest import run_cpu
from harness import cells


def test_new_files_alone_add_a_cell_and_a_metric(tiny):
    pb = tiny / "perfbench"
    (pb / "configs" / "quarter_disc.py").write_text(textwrap.dedent('''
        """The quarter disc, pi/4: a throwaway configuration."""
        import math
        import numpy as np
        import torch
        SOURCE = "https://example.org/quarter-disc"
        DTYPE = "float32"
        EXACT = np.array([math.pi / 4])
        LABELS = ["pi/4"]
        VARS = [{"kind": "continuous", "lower": 0.0, "upper": 1.0, "ninc": 64,
                 "alpha": 2.0, "draws": 2}]
        EVALS = [0]

        def integrand(x, c=None):
            if x[0].numel() > 8:
                EVALS[0] += x[0].numel()
            return (x[0] ** 2 + x[1] ** 2 < 1).to(x[0].dtype)

        def port_integrand(device):
            return integrand

        def port_kwargs(mt, device):
            return dict(var=mt.Continuous(0.0, 1.0, ninc=64), dof=[[2]])

        def reference_integrand(xs, device):
            return integrand(xs[0]).unsqueeze(0)
        '''))
    (pb / "traffic" / "vegas.64K.json").write_text(json.dumps(
        {"about": "small", "solver": "vegas", "neval": 65536, "block": 8, "niter": 5,
         "dtype": "float32"}))
    (pb / "workloads" / "quarter_disc.vegas.json").write_text(json.dumps(
        {"config": "quarter_disc", "traffic": "vegas.64K", "kernels": ["vegas_sample_twin"],
         "limits": {"z_max": 8.0, "z_rms": 3.0, "stats_gap": 1e-6, "chi2_median": 0.01,
                    "map_gap": 1.0}, "why": "a throwaway cell"}))
    (pb / "kernels" / "vegas_sample_twin.py").write_text(textwrap.dedent('''
        """A second count of vegas_sample, by another name."""
        NAMES = [r"\\bvegas_sample_kernel\\s*<"]

        def counts(s):
            return s["S"] * s["n"] * 4, 0, 0
        '''))
    (pb / "metrics" / "calls_profiled.py").write_text(textwrap.dedent('''
        """The calls a traced run profiled."""

        def read(ctx, arg=None):
            return float(sum(c["profiled"] for c in ctx["calls"]))
        '''))
    bench = json.loads((tiny / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "quarter_disc", "source": "https://example.org/quarter-disc",
                             "file": "perfbench/configs/quarter_disc.py", "reduced": [],
                             "why": "throwaway"})
    bench["workloads"].append({"name": "quarter_disc.vegas", "config": "quarter_disc",
                               "traffic": "vegas.64K", "chips": 1, "why": "a throwaway cell"})
    bench["per_layer"].append({"name": "calls_profiled", "unit": "calls", "better": "lower",
                               "source": "program_counter", "layer": "driver",
                               "moves": "evals_per_s", "workloads": ["quarter_disc.vegas"]})
    bench["per_layer"].append({"name": "roofline_pct.vegas_sample_twin", "unit": "%",
                               "better": "higher", "source": "device_trace", "layer": "kernels",
                               "moves": "evals_per_s", "workloads": ["quarter_disc.vegas"]})
    (tiny / "BENCHMARK.json").write_text(json.dumps(bench))

    rc, res, err = run_cpu(tiny, ["--workload", "quarter_disc.vegas", "--seed", "5",
                                  "--seconds", "0.5", "--trace", "1"])
    assert rc == 0, err
    assert res["correct"], err
    assert res["metrics"]["calls_profiled"]["value"] == 2.0
    assert "call_overhead_ms" in res["metrics"]
    # no device trace on the CPU: the roofline reader finds nothing to read
    assert "roofline_pct.vegas_sample_twin" not in res["metrics"]
    # ... but the harness finds the new kernel's count and its reader by name
    read, arg = cells.metric_reader("roofline_pct.vegas_sample_twin", here=pb)
    assert arg == "vegas_sample_twin"
    assert cells.kernel(arg, here=pb).counts({"S": 2, "n": 10}) == (80, 0, 0)
    assert cells.workload("quarter_disc.vegas", bench, here=pb)["niter"] == 5
    rc, res, err = run_cpu(tiny, ["--workload", "quarter_disc.vegas", "--seed", "5",
                                  "--seconds", "0.5", "--trace", "0"])
    assert rc == 0 and set(res["metrics"]) == {"evals_per_s", "iter_ms_p95", "setup_s"}, err
