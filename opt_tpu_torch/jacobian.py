"""Sparse Jacobian export (the reference's dumpJ machinery, o.t:2318-2344,
solverGPUGaussNewton.t:252-304 saveJToCRS).

PyTorch counterpart of ``opt_tpu/jacobian.py``. The per-slot Jacobian
fields of the assembled JᵀJ operator (``assembly._slot_jacobians``) are
exported as COO triplets, never as a dense matrix:

* centered terms: residual instance (t, q, rch) couples to unknown
  (u, q+s, c), where s is the slot's stencil offset, only where q+s stays
  on the grid (zero-padded shift semantics);
* graph terms: residual instance (t, e, rch) couples to (u, idx_k(e), c)
  for each edge-endpoint slot k.

Rows run per term, then element, then residual channel; columns index the
unknown super-vector in ``compiled.unknown_names`` order. The fields are
probed on the plan's device and the result is numpy on the host: this is
a debugging and verification surface, as the reference's is.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .assembly import _slot_jacobians


def _unknown_offsets(compiled) -> Tuple[Dict[str, int], int]:
    offsets, total = {}, 0
    for name in compiled.unknown_names:
        offsets[name] = total
        total += int(np.prod(compiled.unknown_shape(name)))
    return offsets, total


def jacobian_slot_ids(compiled):
    """The unknown slots that some residual term reads."""
    return [sid for sid in compiled.unknown_slot_ids()
            if any(sid in t.slot_ids for t in compiled.terms)]


def graph_term_sizes(graphs):
    """{graph: its edge count}, the element count of its terms."""
    return {g: int(next(iter(slots.values())).shape[0]) for g, slots in graphs.items()}


def stencil_targets(sp, offset):
    """Where a centered slot at stencil ``offset`` reads on a grid of shape
    ``sp``: (valid [*sp], the read stays on the grid; flat [*sp], the read
    point's flat index, clipped to the grid where it leaves it)."""
    grid = np.stack(np.meshgrid(*[np.arange(n) for n in sp], indexing="ij"), -1)
    tgt = grid + np.asarray(offset)
    valid = np.all((tgt >= 0) & (tgt < np.asarray(sp)), axis=-1)
    flat = np.ravel_multi_index(
        tuple(np.clip(tgt[..., d], 0, sp[d] - 1) for d in range(len(sp))), sp)
    return valid, flat


def dump_jacobian(compiled, X, consts, graphs, params):
    """COO export of J at linearization point X: a dict with ``rows``,
    ``cols`` and ``vals`` (numpy; duplicates are summed by whoever builds a
    matrix of them), ``shape`` (n_residuals, n_unknowns) and
    ``row_offsets``, each term's first row."""
    slot_ids = jacobian_slot_ids(compiled)
    D, _mv, _bo, _pr = _slot_jacobians(compiled, X, consts, graphs, params, slot_ids)
    col_off, n_cols = _unknown_offsets(compiled)
    n_edges = graph_term_sizes(graphs)

    rows_l, cols_l, vals_l = [], [], []
    row_base = 0
    row_offsets = []
    for t_idx, term in enumerate(compiled.terms):
        kind, dom = term.domain
        if kind == "centered":
            sp = dom.shape(compiled.dim_sizes)
            n_el = int(np.prod(sp))
        else:
            n_el = n_edges[dom]
        rch = term.channels
        for sid in slot_ids:
            if sid not in term.slot_ids:
                continue
            s = compiled.registry.slots[sid]
            Dv = D[(t_idx, sid)].detach().cpu().numpy()  # [*dom, rch, C]
            C = compiled.unknown_shape(s.image)[-1]
            if kind == "centered":
                valid, flat_sp = stencil_targets(sp, s.offset)
                for r in range(rch):
                    for c in range(C):
                        v = Dv[..., r, c]
                        q = np.nonzero((v != 0) & valid)
                        rows_l.append(row_base + np.ravel_multi_index(q, sp) * rch + r)
                        cols_l.append(col_off[s.image] + flat_sp[q] * C + c)
                        vals_l.append(v[q])
            else:
                idx = graphs[s.graph][s.key[3]].detach().cpu().numpy().astype(np.int64)
                for r in range(rch):
                    for c in range(C):
                        v = Dv[:, r, c]
                        nz = np.nonzero(v != 0)[0]
                        rows_l.append(row_base + nz * rch + r)
                        cols_l.append(col_off[s.image] + idx[nz] * C + c)
                        vals_l.append(v[nz])
        row_offsets.append(row_base)
        row_base += n_el * rch

    rows = np.concatenate(rows_l).astype(np.int64) if rows_l else np.zeros(0, np.int64)
    cols = np.concatenate(cols_l).astype(np.int64) if cols_l else np.zeros(0, np.int64)
    vals = np.concatenate(vals_l) if vals_l else np.zeros(0, np.float64)
    return {"rows": rows, "cols": cols, "vals": vals, "shape": (row_base, n_cols),
            "row_offsets": row_offsets}


def dump_jacobian_dense(compiled, X, consts, graphs, params) -> np.ndarray:
    """Dense J for small problems (duplicate COO entries summed)."""
    coo = dump_jacobian(compiled, X, consts, graphs, params)
    J = np.zeros(coo["shape"])
    np.add.at(J, (coo["rows"], coo["cols"]), coo["vals"])
    return J
