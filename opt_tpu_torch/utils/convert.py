"""Carry inputs, solver state and fused-CG descriptors across from the JAX
package's numpy form (``jax.device_get`` of its pytrees) to this port's
tensors, and back. Parity tests use these to hand both packages identical
data; nothing here imports JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

# solver state entries (opt_tpu/solver/gauss_newton.py _init_state)
_STATE_DICTS = ("X", "SSq")
_STATE_SCALARS = {
    "prev_cost": None,  # the solve dtype
    "trust_region_radius": None,
    "radius_decrease_factor": None,
    "n_iter": torch.int32,
    "lin_iters": torch.int32,
    "done": torch.bool,
}


def _tensor(v, device, dtype=None):
    t = torch.as_tensor(np.array(v, copy=True))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def inputs_from_numpy(inputs: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """Input dict of numpy arrays / scalars -> tensors on ``device``."""
    return {k: _tensor(v, device) for k, v in inputs.items()}


def state_from_numpy(state: Dict[str, Any], device="cpu", dtype=torch.float32):
    """A JAX solver state (numpy leaves) -> this port's solver state."""
    out = {}
    for k in _STATE_DICTS:
        out[k] = {n: _tensor(v, device, dtype) for n, v in state[k].items()}
    for k, dt in _STATE_SCALARS.items():
        out[k] = _tensor(state[k], device, dt or dtype)
    return out


def state_to_numpy(state: Dict[str, Any]) -> Dict[str, Any]:
    """This port's solver state -> numpy leaves (the JAX state's layout)."""
    out = {}
    for k in _STATE_DICTS:
        out[k] = {n: v.detach().cpu().numpy() for n, v in state[k].items()}
    for k in _STATE_SCALARS:
        out[k] = state[k].detach().cpu().numpy()
    return out


def meta_from_numpy(meta: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """A fused grid CG descriptor of the JAX package (F, triples, offs,
    channels, u_list, ctot) -> this port's descriptor."""
    return {
        "u_list": tuple(meta["u_list"]),
        "offs": {k: int(v) for k, v in meta["offs"].items()},
        "channels": {k: int(v) for k, v in meta["channels"].items()},
        "ctot": int(meta["ctot"]),
        "triples": tuple(
            (tuple(int(o) for o in d), int(i), int(j), int(fid))
            for (d, i, j, fid) in meta["triples"]
        ),
        "F": _tensor(meta["F"], device, torch.float32).contiguous(),
    }
