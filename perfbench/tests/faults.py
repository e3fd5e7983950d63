"""Faults planted in the port's timed path, for the tests that see the
check come out false.  ``plant(name)`` patches the port in this process:

- ``half``: half of every batch left out of the evaluation, the answer's
  mean taken over the rest (the evaluated half stands in for the other);
- ``altered``: every iteration's estimate altered where it is produced
  (``mean_std``), by a factor 1.5;
- ``untrained``: the maps' training step returns their state unchanged
  (``Continuous.train`` only clears the histogram);
- ``overstated``: every iteration's error bar doubled where it is produced
  (``mean_std``);
- ``chi2``: the reduced chi2 of the iterations doubled where it is
  produced (``statistics.average``);
- ``norealloc``: ``:vegasplus`` keeps its first allocation of samples to
  its hypercubes (the reallocation returns the counts unchanged).
"""


def plant(name):
    if name is None:
        return
    import torch

    import mcintegration_tpu_torch.main as tmain
    from mcintegration_tpu_torch import statistics
    from mcintegration_tpu_torch.models import variable
    from mcintegration_tpu_torch.solvers import engine, vegasplus

    if name == "half":
        make = engine.Spec.make_eval_batched

        def make_half(self, integrand, inplace):
            ev = make(self, integrand, inplace)

            def half(leaf_vals):
                n = leaf_vals[0].shape[-1]
                if n < 2:
                    return ev(leaf_vals)
                w = ev([v[..., : n // 2] for v in leaf_vals])
                return torch.cat([w, w, w[..., : n % 2]], dim=-1)
            return half

        engine.Spec.make_eval_batched = make_half
    elif name in ("altered", "overstated"):
        mean_std = tmain.mean_std
        fm, fs = (1.5, 1.0) if name == "altered" else (1.0, 2.0)

        def faulty(obs_sum, obs_sq, block):
            means, stds = mean_std(obs_sum, obs_sq, block)
            return [m * fm for m in means], [s * fs for s in stds]

        tmain.mean_std = faulty
    elif name == "untrained":
        variable.Continuous.train = lambda self: self.clear_statistics()
    elif name == "chi2":
        average = statistics.average

        def faulty_average(*a, **kw):
            m, e, c = average(*a, **kw)
            return m, e, 2 * c

        statistics.average = faulty_average
    elif name == "norealloc":
        vegasplus.VegasPlusIteration._reallocate = lambda self, sig: None
    else:
        raise ValueError(f"no fault {name!r}")
