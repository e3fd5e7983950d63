"""Checkpoint / resume of trained integration state.

Counterpart of ``mcintegration_tpu/checkpoint.py`` with the same npz keys
(``reweight``, ``seed``, ``leaf{i}_histogram``, and ``leaf{i}_grid`` for a
Continuous leaf or ``leaf{i}_distribution`` and ``leaf{i}_accumulation``
for a Discrete one; a FermiK leaf keeps only its floor histogram), so a
state saved by either package loads into the other.

The reference has no serialization; its warm-start pattern is passing
``config=result.config`` into a new ``integrate`` call
(docs/src/index.md:129-150).  Here the trained state (grids, CDFs,
reweights) is an explicit plain-array pytree, so checkpointing is a
``np.savez`` away — resume either in-process (warm start) or across runs.
"""

from __future__ import annotations

import numpy as np

from .configuration import Configuration
from .models.variable import Continuous, Discrete, FermiK


def state_dict(config: Configuration) -> dict:
    out = {"reweight": config.reweight.copy(), "seed": np.asarray(config.seed)}
    for i, (_, leaf) in enumerate(config.var_leaves()):
        if isinstance(leaf, Continuous):
            out[f"leaf{i}_grid"] = leaf.grid.copy()
        elif isinstance(leaf, Discrete):
            out[f"leaf{i}_distribution"] = leaf.distribution.copy()
            out[f"leaf{i}_accumulation"] = leaf.accumulation.copy()
        out[f"leaf{i}_histogram"] = leaf.histogram.copy()
    return out


def load_state_dict(config: Configuration, state: dict):
    config.reweight[:] = state["reweight"]
    for i, (_, leaf) in enumerate(config.var_leaves()):
        if isinstance(leaf, Continuous):
            leaf.grid = np.asarray(state[f"leaf{i}_grid"], dtype=np.float64)
        elif isinstance(leaf, Discrete):
            leaf.distribution = np.asarray(state[f"leaf{i}_distribution"], np.float64)
            leaf.accumulation = np.asarray(state[f"leaf{i}_accumulation"], np.float64)
        leaf.histogram = np.asarray(state[f"leaf{i}_histogram"], dtype=np.float64)
    return config


def save_state(config: Configuration, path: str):
    np.savez(path, **state_dict(config))


def load_state(config: Configuration, path: str) -> Configuration:
    with np.load(path) as data:
        return load_state_dict(config, dict(data))


def params_from_jax(jax_params, spec):
    """The port's device params from ``mcintegration_tpu``'s.

    ``jax_params`` is ``Spec.device_params()`` of the JAX package converted
    to numpy.  A Continuous leaf's ``tab`` is the ``[L, L*2]`` table of
    ``(grid, inc)`` rows packed by ``ops/lookup.py:pack_table``; a Discrete
    leaf carries ``cdf [nbin+1]`` and ``dist_tab``, its ``[nbin]`` masses
    packed the same way; a FermiK leaf its float32 ``kF`` and ``dk``.
    Returns the port's ``{"leaf": [(grid, inc), (cdf, dist) or (kF, dk),
    ...], "reweight": ...}`` on the spec's device, of the spec's dtype (a
    float64 spec takes the JAX package's float64 tables as they are), so
    that both packages sample through the identical map.
    """
    import torch

    npdt = np.float64 if spec.dtype == torch.float64 else np.float32

    def real(a):
        return torch.as_tensor(np.array(a, dtype=npdt), device=spec.device)

    leaves = []
    for li, p in zip(spec.leaves, jax_params["leaf"]):
        if isinstance(li.leaf, FermiK):
            leaves.append(tuple(torch.tensor(float(np.float32(p[k])), dtype=torch.float64,
                                             device=spec.device) for k in ("kF", "dk")))
            continue
        if isinstance(li.leaf, Discrete):
            nbin = li.leaf.nbin
            dist = np.asarray(p["dist_tab"], dtype=npdt).reshape(-1)[:nbin]
            leaves.append((real(p["cdf"]), real(dist)))
            continue
        nb = li.leaf.ninc
        tab = np.asarray(p["tab"], dtype=npdt).reshape(-1, 2)[:nb]
        leaves.append((real(tab[:, 0]), real(tab[:, 1])))
    return {"leaf": leaves,
            "reweight": torch.tensor(np.asarray(jax_params["reweight"]),
                                     dtype=spec.dtype, device=spec.device)}
