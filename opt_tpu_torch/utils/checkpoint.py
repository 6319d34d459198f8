"""Checkpoint / resume for solver state.

PyTorch counterpart of ``opt_tpu/utils/checkpoint.py``, npz only: the JAX
package's orbax branch is a JAX library, so ``use_orbax=True`` raises.

* ``save(path, plan)`` writes ``opt_tpu_meta.json`` (problem, kind, dims,
  solver parameters, version) and ``state.npz``, the solver state (the
  unknowns, the trust region, the counters) under the JAX package's keys
  (``jax.tree_util.keystr`` of each leaf's path: ``['X']['X']``,
  ``['prev_cost']``). The two packages' states have the same entries,
  shapes and dtypes, so a checkpoint written by either restores into the
  other.
* ``restore(path, plan, inputs=...)`` loads it into a plan (a fresh one
  too), on the plan's device with the saved dtypes, and ``plan.step()``
  resumes where the saved solve left off.

On a mesh every rank calls both: ``save`` gathers the global unknowns (as
the JAX package's npz branch does) and rank 0 writes them; ``restore``
gives each rank its extended region of them (``ShardingRules.local``), on
a graph its owner blocks (``GraphShardingRules.local``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..solver.params import normalize_solver_params

_META_NAME = "opt_tpu_meta.json"
_STATE_NAME = "state.npz"
_REGION_ENTRIES = ("X", "SSq")  # per-unknown state, the rank's part on a mesh


def _meta(plan) -> Dict[str, Any]:
    return {
        "problem": plan.problem.name,
        "kind": plan.kind,
        "dims": dict(plan.dims),
        "solver_params": dict(plan.solver_params),
        "version": 1,
    }


def _check_meta(meta: Dict[str, Any], plan) -> None:
    if meta["dims"] != plan.dims:
        raise ValueError(f"checkpoint dims {meta['dims']} != plan dims {plan.dims}")
    if meta["kind"].lower() != plan.kind.lower():
        raise ValueError(f"checkpoint kind {meta['kind']} != plan kind {plan.kind}")


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    for k, v in tree.items():
        key = f"{prefix}['{k}']"
        if isinstance(v, dict):
            _flatten(v, key, out)
        else:
            out[key] = v.detach().cpu().numpy()


def save(path: str, plan, use_orbax: Optional[bool] = None) -> str:
    """Write the plan's current solver state (after init()/step()/solve())."""
    if use_orbax:
        raise ValueError("use_orbax=True: orbax is a JAX library; opt_tpu_torch writes the "
                         "npz checkpoint, which the JAX package also reads")
    if plan._state is None:
        raise RuntimeError("nothing to checkpoint: call init() or solve() first")
    state = dict(plan._state)
    rules = plan.rules
    if rules is not None:  # the global arrays, on every rank
        for k in _REGION_ENTRIES:
            state[k] = {n: rules.gather(v, n) for n, v in state[k].items()}
    path = os.path.abspath(path)
    if rules is None or rules.mesh.rank == 0:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, _META_NAME), "w") as f:
            json.dump(_meta(plan), f)
        flat: Dict[str, np.ndarray] = {}
        _flatten(state, "", flat)
        np.savez(os.path.join(path, _STATE_NAME), **flat)
    if rules is not None:  # no rank reads the files before rank 0 wrote them
        rules.mesh.all_true(True)
    return path


def restore(path: str, plan, inputs: Optional[Dict[str, Any]] = None):
    """Load a checkpoint into `plan`, rebinding `inputs` (problem constants)
    if given. Returns the restored state dict."""
    path = os.path.abspath(path)
    with open(os.path.join(path, _META_NAME)) as f:
        meta = json.load(f)
    _check_meta(meta, plan)
    if inputs is not None:
        unknowns, consts, graphs, params = plan._normalize_and_place(inputs)
        plan._validate_fused(unknowns, consts, graphs, params)
        plan._bound = (consts, graphs, params)
    elif plan._bound is None:
        # a fresh plan has no bound constants; stepping would fail deep in
        # the solver: fail here with the remedy
        raise RuntimeError(
            "restore() into a freshly constructed plan requires the problem "
            "inputs: checkpoints persist solver state (unknowns, trust "
            "region, counters) but not the constant images/graphs/params; "
            "pass restore(path, plan, inputs=...) to rebind them"
        )
    state: Dict[str, Any] = {}
    with np.load(os.path.join(path, _STATE_NAME)) as data:
        for key, arr in data.items():
            parts = [p.strip("'\"") for p in key.replace("[", "]").split("]") if p]
            d = state
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = torch.as_tensor(np.array(arr)).to(plan.device)
    if plan.rules is not None:  # each rank's extended region
        for k in _REGION_ENTRIES:
            state[k] = {n: plan.rules.local(v, n).contiguous() for n, v in state[k].items()}
    plan._state = state
    plan.solver_params = normalize_solver_params({**plan.solver_params, **meta["solver_params"]})
    return state
