"""Explicit sparse-J path: the reference's optional cusparse branch.

PyTorch counterpart of ``opt_tpu/explicit.py``. The reference can dump J
to CSR and run the PCG inner loop as two sparse matvecs q = J·p, out = Jᵀ·q
instead of the matrix-free apply (solverGPUGaussNewton.t:74-90, 215-218,
835-954; off by default there too). Here the sparsity structure of J and
of Jᵀ is built once on the host for a plan's dims and a graph topology
(``explicit_structure``: each as CSR index arrays and, per entry, the
positions in the concatenated per-slot Jacobian fields whose sum it is);
each nonlinear step only gathers the new values from the fields, which
``assembly._slot_jacobians`` probes on the plan's device; the CG loop
applies JᵀJ·p as two ``torch.sparse`` CSR matvecs.

Enable with ``InitializationParameters(use_explicit_jtj=True)``. A
verification and very-ill-conditioned-problem surface, as the
reference's is; the assembled operator (assembly.py) is the main path.

Row/column layout matches jacobian.dump_jacobian: rows per term, then
element, then residual channel; columns index the unknown super-vector in
``compiled.unknown_names`` order. Entries whose stencil read leaves the
grid are always zero and are left out of the structure.
"""

from __future__ import annotations

import warnings
from typing import Dict

import numpy as np
import torch

from .assembly import _slot_jacobians
from .jacobian import _unknown_offsets, graph_term_sizes, jacobian_slot_ids, stencil_targets


def explicit_structure(compiled, graphs, device) -> Dict:
    """J's and Jᵀ's CSR structure at the compiled dims and the graphs'
    topology, on ``device``: {"shape", "slot_ids", "J": (crow, col, src),
    "JT": (crow, col, src)}, where ``src`` [nnz, K] holds, for each CSR
    entry, the positions in the flattened per-(term, slot) fields (in
    ``_slot_jacobians``' order, each [*dom, rch, C]) of the entries it
    sums, K at most (a graph edge with both endpoints on one vertex), the
    unused ones pointing at one zero past the fields' end."""
    slot_ids = jacobian_slot_ids(compiled)
    col_off, n_cols = _unknown_offsets(compiled)
    n_edges = graph_term_sizes(graphs)
    rows_l, cols_l, keep_l = [], [], []
    row_base = 0
    for term in compiled.terms:
        kind, dom = term.domain
        rch = term.channels
        if kind == "centered":
            sp = dom.shape(compiled.dim_sizes)
            n_el = int(np.prod(sp))
        else:
            n_el = n_edges[dom]
        el = np.arange(n_el, dtype=np.int64)
        rows = (row_base + el[:, None] * rch + np.arange(rch)[None, :])[:, :, None]  # [n_el, rch, 1]
        for sid in slot_ids:
            if sid not in term.slot_ids:
                continue
            s = compiled.registry.slots[sid]
            C = compiled.unknown_shape(s.image)[-1]
            if kind == "centered":
                valid, vert = (a.reshape(-1) for a in stencil_targets(sp, s.offset))
            else:
                vert = graphs[s.graph][s.key[3]].detach().cpu().numpy().astype(np.int64)
                valid = np.ones(n_el, bool)
            cols = col_off[s.image] + vert[:, None, None] * C + np.arange(C)[None, None, :]
            shape = (n_el, rch, C)
            rows_l.append(np.broadcast_to(rows, shape).reshape(-1))
            cols_l.append(np.broadcast_to(cols, shape).reshape(-1))
            keep_l.append(np.broadcast_to(valid[:, None, None], shape).reshape(-1))
        row_base += n_el * rch
    rows = np.concatenate(rows_l) if rows_l else np.zeros(0, np.int64)
    cols = np.concatenate(cols_l) if cols_l else np.zeros(0, np.int64)
    raw_len = rows.shape[0]
    pos = np.flatnonzero(np.concatenate(keep_l)) if keep_l else np.zeros(0, np.int64)
    n_rows = row_base

    # coalesce the (row, col) pairs, row-major: the duplicates of a pair in
    # the fields' order
    key = rows[pos] * n_cols + cols[pos]
    order = np.argsort(key, kind="stable")
    ks, ps = key[order], pos[order]
    new = np.ones(ks.shape[0], bool)
    new[1:] = ks[1:] != ks[:-1]
    grp = np.cumsum(new) - 1
    starts = np.flatnonzero(new)
    k_in = np.arange(ks.shape[0]) - starts[grp] if ks.size else np.zeros(0, np.int64)
    K = int(k_in.max()) + 1 if ks.size else 1
    src = np.full((starts.shape[0], K), raw_len, np.int64)
    src[grp, k_in] = ps
    u_rows, u_cols = ks[starts] // n_cols, ks[starts] % n_cols

    def csr(major, minor, n_major, s):
        crow = np.zeros(n_major + 1, np.int64)
        np.cumsum(np.bincount(major, minlength=n_major), out=crow[1:])
        return tuple(torch.as_tensor(a).to(device) for a in (crow, minor, s))

    t_order = np.argsort(u_cols * n_rows + u_rows, kind="stable")
    return {"shape": (n_rows, n_cols), "slot_ids": slot_ids,
            "J": csr(u_rows, u_cols, n_rows, src),
            "JT": csr(u_cols[t_order], u_rows[t_order], n_cols, src[t_order])}


def build_explicit_j(compiled, X, consts, graphs, params, structure):
    """J and Jᵀ at linearization point X as CSR tensors on X's device: the
    per-slot fields probed once and gathered into ``structure``'s entries
    (:func:`explicit_structure`, of the same dims and topology)."""
    D, _mv, _bo, _pr = _slot_jacobians(compiled, X, consts, graphs, params,
                                       structure["slot_ids"])
    parts = [D[(t_idx, sid)].reshape(-1)
             for t_idx, term in enumerate(compiled.terms)
             for sid in structure["slot_ids"] if sid in term.slot_ids]
    ref = next(iter(X.values()))
    raw = torch.cat(parts + [ref.new_zeros(1)])
    n_rows, n_cols = structure["shape"]
    out = []
    for name, size in (("J", (n_rows, n_cols)), ("JT", (n_cols, n_rows))):
        crow, col, src = structure[name]
        vals = raw[src[:, 0]]
        for k in range(1, src.shape[1]):
            vals = vals + raw[src[:, k]]
        with warnings.catch_warnings():  # "sparse CSR support is in beta state"
            warnings.simplefilter("ignore", UserWarning)
            out.append(torch.sparse_csr_tensor(crow, col, vals, size=size,
                                               check_invariants=False))
    return tuple(out)


def explicit_jtj_apply(compiled, J, JT, row_masks):
    """(JᵀJ)·p as two CSR matvecs over the flattened unknown super-vector,
    the output rows masked like every other operator form's."""

    def apply_fn(p: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        flat = torch.cat([p[u].reshape(-1) for u in compiled.unknown_names])
        out_flat = torch.mv(JT, torch.mv(J, flat))
        out, o = {}, 0
        for u in compiled.unknown_names:
            shape = compiled.unknown_shape(u)
            n = int(np.prod(shape))
            v = out_flat[o : o + n].reshape(shape)
            m = row_masks.get(u)
            out[u] = v if m is None else v * m
            o += n
        return out

    return apply_fn
