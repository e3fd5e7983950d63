"""PyTorch port: the examples (``mcintegration_tpu_torch/examples``) run on
the CPU at a tiny size (too small for the bubble's chains to settle: its
values are checked for shape and finiteness only)."""

import numpy as np
import torch

from mcintegration_tpu_torch.examples import bubble, quickstart

torch.set_num_threads(1)


def test_examples_run_on_cpu(capsys):
    quickstart.main(["32768", "--device", "cpu", "--niter", "2"])
    out = capsys.readouterr().out
    for line in ("log(x)/sqrt(x)", "quarter circle", "polar circle", "discrete sum",
                 "bundle", "histogram obs"):
        assert line in out, out
    res = bubble.main(["4096", "--device", "cpu", "--niter", "2"])
    out = capsys.readouterr().out
    assert len(out.strip().splitlines()) == 2 + bubble.QSIZE
    avg, std = np.asarray(res.mean[0]), np.asarray(res.stdev[0])
    assert avg.shape == std.shape == (bubble.QSIZE,)
    assert np.all(np.isfinite(avg)) and np.all(std > 0)
