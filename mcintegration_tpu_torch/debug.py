"""Debug-mode diagnostics (``integrate(debug=True)``).

Counterpart of ``mcintegration_tpu/debug.py``: the reference's
``@inferred`` checker (src/utility/utility.jl:42-53) becomes an eager probe
of the user integrand and measure on a 4-sample batch, with readable
errors, and its in-loop non-finite warnings (src/vegas/montecarlo.jl:176-178)
become a scan of each iteration's statistics after they are reduced over
the ranks.  The messages are the JAX package's, word for word.

The probe draws its samples from a generator of its own
(:meth:`Spec.probe_leaf_values`), so ``debug=True`` leaves the run's
random stream, and the result's bits, as they are.  It looks at the values
the integrand returns before the non-finite guard of the evaluation zeroes
them (``engine._finite_guard``), and before a complex value is cast to
float32: the JAX package's probe looks after both, so its non-finite
warning and its complex-weights error never fire (ROADMAP.md, known faults
in the reference).
"""

from __future__ import annotations

import sys
import warnings

import numpy as np
import torch

from .solvers.engine import Spec, tree_leaves
from .utils.color import red

PROBE_BATCH = 4


def _check_shape(w, shape):
    if tuple(w.shape) != shape:
        raise ValueError(f"weights of shape {tuple(w.shape)}, expected {shape}")


def _check_values(spec: Spec, ws):
    """The JAX package's checks of the probe's weights, on the values the
    integrand returned: a warning for non-finite ones, a ``TypeError`` for
    complex ones on a real-weight run."""
    ws = [torch.as_tensor(w) for w in ws]
    if not all(bool(torch.isfinite(w).all()) for w in ws):
        warnings.warn(
            "debug probe: integrand returned non-finite weights on a "
            "random probe batch (may be fine for singular integrands)")
    if any(w.is_complex() for w in ws) and not spec.cplx:
        raise TypeError(
            "integrand returned complex weights but type=float; pass "
            "type=complex to integrate()")


def probe_integrand(spec: Spec, integrand, measure, inplace: bool, solver: str,
                    obs_proto=None):
    """Run the user functions on a 4-sample batch and sanity-check them.

    Raises ``TypeError`` with a readable message on a call that fails, the
    wrong number of weights, complex weights without ``type=complex`` or a
    measure that fails; warns on non-finite probe weights (which may be
    legitimate for singular integrands, hence not fatal).  On :mcmc every
    integrand index ``f(idx, x, c)`` is called, and its measure too.
    """
    leaf_vals = spec.probe_leaf_values(np.random.default_rng(0), batch=(PROBE_BATCH,))
    x = spec.view(leaf_vals)
    n = spec.N
    relw = torch.zeros((n, PROBE_BATCH), dtype=spec.wdtype, device=spec.device)

    if solver == "mcmc":
        ws, idx = [], 0
        try:
            for idx, f in enumerate(spec.make_eval_batched_idx(integrand)):
                ws.append(integrand(idx, x, spec.uconfig))
                _check_shape(f(leaf_vals), (PROBE_BATCH,))
        except Exception as e:
            raise TypeError(
                f"debug probe: mcmc integrand(idx, var, config) failed for "
                f"idx={idx}: {e}") from e
        _check_values(spec, ws)
        if measure is not None:
            ms = spec.make_measure_batched_idx(measure, obs_proto)
            try:
                for m in ms:
                    m(leaf_vals, relw[0])
            except NotImplementedError:
                raise
            except Exception as e:
                raise TypeError(
                    "debug probe: measure(idx, var, relative_weights, config) must "
                    f"return the observable-contribution pytree: {e}") from e
        return

    try:
        raw = spec._call(integrand, inplace, leaf_vals)
        _check_shape(spec.make_eval_batched(integrand, inplace)(leaf_vals), (n, PROBE_BATCH))
    except Exception as e:
        sig = "(var, weights, config)" if inplace else "(var, config)"
        raise TypeError(
            f"debug probe: integrand{sig} failed or returned the wrong "
            f"number of weights (expected {n}): {e}") from e
    _check_values(spec, list(raw) if isinstance(raw, (tuple, list)) else [raw])

    if measure is not None:
        m = spec.make_measure_batched(measure, obs_proto)
        try:
            m(leaf_vals, relw)
        except NotImplementedError:
            raise
        except Exception as e:
            raise TypeError(
                "debug probe: measure(var, relative_weights, config) must "
                f"return the observable-contribution pytree: {e}") from e


def check_iteration_stats(stats, it: int) -> bool:
    """Warn on non-finite reduced statistics, mirroring the solvers'
    isfinite warnings (vegas/montecarlo.jl:176-178); False when any is."""
    bad = []
    for leaf in tree_leaves(stats["obs_blocks"]):
        if not np.all(np.isfinite(np.asarray(leaf))):
            bad.append("observable")
            break
    if not np.all(np.isfinite(stats["norm_blocks"])):
        bad.append("normalization")
    for h in stats["hists"]:
        if not np.all(np.isfinite(h)):
            bad.append("histogram")
            break
    if bad:
        sys.stderr.write(red(
            f"iteration {it}: non-finite {', '.join(bad)} statistics — the "
            "integrand likely produced Inf/NaN weights\n"))
    return not bad
