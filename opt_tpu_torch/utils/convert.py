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


def inputs_from_numpy(inputs: Dict[str, Any], device) -> Dict[str, Any]:
    """Input dict of numpy arrays / scalars -> tensors on ``device``; a
    graph's dict of slots (int32 index arrays and the optional per-edge
    ``valid`` mask) -> a dict of tensors of the same types."""
    return {
        k: ({s: _tensor(i, device) for s, i in v.items()} if isinstance(v, dict)
            else _tensor(v, device))
        for k, v in inputs.items()
    }


def state_from_numpy(state: Dict[str, Any], device, dtype=torch.float32):
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


def _is_bf16(a) -> bool:
    return np.asarray(a).dtype.name == "bfloat16"


def _coeffs(a, device, bf16: bool):
    """Coefficients as float32 numpy (exact from bfloat16) -> a tensor in
    the source's dtype, float32 or bfloat16."""
    t = _tensor(np.asarray(a, np.float32), device, torch.float32)
    return (t.to(torch.bfloat16) if bf16 else t).contiguous()


def meta_from_numpy(meta: Dict[str, Any], device, batch: bool = False) -> Dict[str, Any]:
    """A fused CG descriptor of the JAX package (F, triples, offs, channels,
    u_list, ctot, chan_grid: the per-channel split, whose triples are one
    channel's; for graphs also its [R, L] vertex fold and its one-hot
    remainder tiles) -> this port's descriptor, with F (and the remainder
    blocks) in the descriptor's dtype, float32 or bfloat16, over its 2-D or
    3-D grid. A graph's folded fields unfold onto the grid [1, N], its flat
    offsets d become (0, d), and its remainder tiles become the block CSR,
    rows in vertex order and each row's entries in ascending endpoint
    order. ``batch``: F (and the remainder's blocks) have a leading batch
    axis (the descriptor a ``jax.vmap`` over instances made, as
    ``Plan.solve_batched`` runs it; the tiles' tables are shared); the
    result is a batched meta (``"batch"``: B) with F [B, T, *dom] and the
    remainder's blocks [B, nnz, C, C] over one CSR."""
    bf16 = _is_bf16(meta["F"])
    F = np.asarray(meta["F"], np.float32)
    lead = F.shape[:1] if batch else ()
    triples = [(tuple(int(o) for o in d), int(i), int(j), int(fid))
               for (d, i, j, fid) in meta["triples"]]
    rem = None
    if meta.get("fold") is not None:
        R, L, N = (int(x) for x in meta["fold"])
        T = F.shape[len(lead)]
        F = F.reshape(lead + (T, R * L))[..., :N].reshape(lead + (T, 1, N))
        triples = [((0, d[0]), i, j, fid) for (d, i, j, fid) in triples]
        if meta.get("rem") is not None:
            rem = _rem_from_tiles(meta["rem"], L, N, device)
    out = {
        "u_list": tuple(meta["u_list"]),
        "offs": {k: int(v) for k, v in meta["offs"].items()},
        "channels": {k: int(v) for k, v in meta["channels"].items()},
        "ctot": int(meta["ctot"]),
        "chan_grid": bool(meta.get("chan_grid", False)),
        "triples": tuple(triples),
        "F": _coeffs(F, device, bf16),
        "rem": rem,
    }
    if batch:
        out["batch"] = int(lead[0])
    return out


def pre_blocks_from_numpy(pre_blocks, device) -> torch.Tensor:
    """The JAX package's block-Jacobi operand of its fused kernel
    ([*dom, C, C], rows masked; a graph's over its unfolded vertex axis) ->
    a float32 tensor for ``fused_grid_cg(..., pre_blocks=...)``."""
    return _tensor(np.asarray(pre_blocks, np.float32), device, torch.float32).contiguous()


def _rem_from_tiles(rem, lanes: int, n: int, device):
    """The JAX package's one-hot remainder tiles (table [TT, 2, T] of
    window-local source and destination lanes, -1 padding; rows [TT, 2] of
    destination and source window rows; blocks [TT, C, C, T], or
    [B, TT, C, C, T] for a batch) -> the kernel's CSR {rowptr, col, blk}
    (blk [nnz, C, C], or [B, nnz, C, C])."""
    table = np.asarray(rem["table"])
    rows = np.asarray(rem["rows"]).astype(np.int64)
    bf16 = _is_bf16(rem["blocks"])
    blocks = np.asarray(rem["blocks"], np.float32)
    t_idx, lane = np.nonzero(table[:, 0, :] >= 0)
    v = rows[t_idx, 0] * lanes + table[t_idx, 1, lane]
    u = rows[t_idx, 1] * lanes + table[t_idx, 0, lane]
    order = np.lexsort((u, v))
    v, u = v[order], u[order]
    blk = np.moveaxis(blocks, -1, -3)[..., t_idx[order], lane[order], :, :]  # [(B,) nnz, C, C]
    rowptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(v, minlength=n), out=rowptr[1:])
    return {
        "rowptr": _tensor(rowptr, device, torch.int32),
        "col": _tensor(u, device, torch.int32),
        "blk": _coeffs(blk, device, bf16),
    }
