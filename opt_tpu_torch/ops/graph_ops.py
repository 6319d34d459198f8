"""Hypergraph gathers and the host-side tables of the graph operator.

PyTorch counterpart of ``opt_tpu/ops/graph_ops.py``. The reference scatters
per-edge contributions into vertex arrays with ``atomicAdd`` (o.t:558-567,
o.t:2092-2126). Here every per-vertex sum is a gather through an incidence
table built once on the host, followed by a sum over the table's columns in
a fixed order: no atomics, so two runs give bitwise-equal results.

The table builders are numpy and are the JAX package's own, so both
packages plan the same operator structure from the same edges.
"""

from __future__ import annotations

import numpy as np
import torch


def edge_gather(img: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-vertex values at edge endpoints: out[e] = img[idx[e]].
    ``img``: [N, C] vertex array; ``idx``: [E] integer tensor."""
    return torch.index_select(img, 0, idx)


def edge_scatter_add(values: torch.Tensor, idx: torch.Tensor, num_vertices: int) -> torch.Tensor:
    """Per-edge values summed into a [num_vertices, C] vertex array, as a
    gather through the incidence table of ``idx`` and a sum over each
    vertex's incidences in edge order (deterministic on every device). The
    table is built on the host: a device-to-host copy of ``idx``."""
    inc = incidence_table(idx.detach().cpu().numpy(), num_vertices)
    ext = torch.cat([values, values.new_zeros((1,) + tuple(values.shape[1:]))])
    table = torch.as_tensor(inc, dtype=torch.int64, device=values.device)
    return ext[table].sum(dim=1)


def bucket_size(n: int, minimum: int = 1) -> int:
    """Next power-of-two bucket >= n (>= minimum)."""
    n = max(int(n), 1)
    return max(int(minimum), 1 << (n - 1).bit_length())


def pad_table_width(table, width: int, sentinel: int):
    """A [N, D] incidence-style table padded to ``width`` columns of
    ``sentinel`` (unchanged when it is as wide already)."""
    table = np.asarray(table)
    n, d = table.shape
    if d >= width:
        return table
    out = np.full((n, width), sentinel, table.dtype)
    out[:, :d] = table
    return out


def slot_groups(gdecl, dim_sizes):
    """Group a graph's endpoint slots by the index space they point into:
    [(group_key, [slot names, sorted], num_vertices)]. Slots of one group
    share vertices, so their accumulation packs into one combined incidence
    gather; slots into other spaces go in separate groups."""
    by_ispace = {}
    for slot in sorted(gdecl.slots):
        isp = gdecl.slots[slot]
        by_ispace.setdefault(isp, []).append(slot)
    out = []
    for isp, names in by_ispace.items():
        n = int(np.prod(isp.shape(dim_sizes)))
        out.append(("__inc__" + "|".join(names), names, n))
    return out


def combined_incidence_table(idx_list, num_vertices: int):
    """Combined transpose of several edge->vertex index lists over ONE vertex
    space: [N, D_total] row ids into the stacked per-slot edge-row matrix
    (slot k's edge e is row k*E + e), padded with the sentinel n_slots*E."""
    E = idx_list[0].shape[0]
    all_idx = np.concatenate([np.asarray(i) for i in idx_list])
    rows = np.concatenate([k * E + np.arange(E, dtype=np.int64) for k in range(len(idx_list))])
    order = np.argsort(all_idx, kind="stable")
    sorted_v = all_idx[order]
    counts = np.bincount(all_idx, minlength=num_vertices)
    d_max = int(counts.max()) if len(all_idx) else 1
    table = np.full((num_vertices, max(1, d_max)), len(idx_list) * E, np.int32)
    starts = np.zeros(num_vertices + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    pos = np.arange(len(all_idx)) - starts[sorted_v]
    table[sorted_v, pos] = rows[order]
    return table


def combined_cross_table(idx_list, num_vertices: int, inc=None):
    """[N, D_tot, m-1] cross-endpoint vertex ids for the combined incidence
    table over m same-space slots: where ``inc[v, d]`` holds slot k's edge
    e, entry ``j`` is ``idx_{(k+1+j) mod m}[e]``, in the rotation order of
    the stacked coupling blocks. Sentinel entries map to ``num_vertices``."""
    m = len(idx_list)
    if inc is None:
        inc = combined_incidence_table(idx_list, num_vertices)
    if m == 1:
        return np.zeros(inc.shape + (0,), np.int32)
    E = idx_list[0].shape[0]
    idx_arr = np.stack([np.asarray(i) for i in idx_list])  # [m, E]
    k = inc // E  # sentinel (m*E) -> m
    e = inc % E
    out = np.empty(inc.shape + (m - 1,), np.int32)
    for j in range(m - 1):
        kk = (k + 1 + j) % m
        out[:, :, j] = np.where(k >= m, num_vertices, idx_arr[kk, e])
    return out


def dia_split(cross, num_vertices: int, max_offsets: int = 16, min_coverage: float = 0.2,
              min_offset_share: float = 0.01):
    """Split the combined cross table into DIA offsets + a gather remainder.

    Cross endpoints that sit at a few fixed vertex-id offsets δ = u − v
    read p by a shift instead of a gather. Offsets are kept while each
    covers at least ``min_offset_share`` of incidences (up to
    ``max_offsets``); the split activates when they jointly cover
    ``min_coverage``. Returns (offsets, masks, rem_pos, rem_cross) or None:

    * offsets: list of int δ;
    * masks: [len(offsets), N, D, m-1] float32, incidence (v, d, j)
      assigned to offset k (each incidence at most once);
    * rem_pos: [N, D_rem] int32 positions into the flattened (d, j) axis
      (sentinel D·(m-1)) of the unassigned incidences;
    * rem_cross: [N, D_rem] int32 cross vertex ids (sentinel N).
    """
    cross = np.asarray(cross)
    n, d_tot, mm1 = cross.shape
    if mm1 == 0 or n == 0:
        return None
    v_ids = np.arange(n, dtype=np.int64)[:, None, None]
    valid = cross < num_vertices
    delta = cross.astype(np.int64) - v_ids
    total = int(valid.sum())
    if total == 0:
        return None
    vals, counts = np.unique(delta[valid], return_counts=True)
    order = np.argsort(-counts)
    offsets, masks = [], []
    covered = np.zeros_like(valid)
    cov_count = 0
    for i in order[:max_offsets]:
        if counts[i] < min_offset_share * total:
            break
        off = int(vals[i])
        m = valid & (delta == off) & ~covered
        covered |= m
        cov_count += int(m.sum())
        offsets.append(off)
        masks.append(m.astype(np.float32))
    if not offsets or cov_count < min_coverage * total:
        return None
    rem = valid & ~covered
    flat = rem.reshape(n, -1)
    d_rem = int(flat.sum(1).max()) if flat.any() else 0
    if d_rem:
        take = np.argsort(~flat, axis=1, kind="stable")[:, :d_rem]
        have = np.take_along_axis(flat, take, axis=1)
        rem_pos = np.where(have, take, d_tot * mm1).astype(np.int32)
        rem_cross = np.where(
            have, np.take_along_axis(cross.reshape(n, -1), take, axis=1), num_vertices
        ).astype(np.int32)
    else:
        rem_pos = np.zeros((n, 0), np.int32)
        rem_cross = np.zeros((n, 0), np.int32)
    return offsets, np.stack(masks), rem_pos, rem_cross


def dedup_reads(pos, cross, num_vertices: int, pos_sentinel: int):
    """Merge duplicate (vertex, cross-endpoint) reads of a remainder table.

    A two-slot mesh graph holds every neighbour u of v twice (once from the
    edge (v, u), once from (u, v)). Merging those reads halves the
    remainder; the coupling blocks of merged entries pre-sum at assembly
    through the returned position table, in k order.

    ``pos``: [N, D] int32 flat positions (sentinel ``pos_sentinel``).
    ``cross``: [N, D] int32 endpoint ids (sentinel ``num_vertices``).
    Returns ``(pos_k [N, Dm, K], cross2 [N, Dm])``, each row's distinct
    endpoints first in ascending order, or ``None`` when no row contains
    duplicates.
    """
    pos = np.asarray(pos)
    cross = np.asarray(cross)
    n, d = cross.shape
    if d == 0 or n == 0:
        return None
    order = np.argsort(cross, axis=1, kind="stable")  # sentinels sort last
    sc = np.take_along_axis(cross, order, 1)
    sp = np.take_along_axis(pos, order, 1)
    valid = sc < num_vertices
    new_grp = np.ones((n, d), bool)
    new_grp[:, 1:] = sc[:, 1:] != sc[:, :-1]
    i_idx = np.broadcast_to(np.arange(d), (n, d))
    run_start = np.maximum.accumulate(np.where(new_grp, i_idx, 0), axis=1)
    k_idx = i_idx - run_start
    if not (valid & (k_idx > 0)).any():
        return None
    grp = np.cumsum(new_grp & valid, axis=1) - 1  # group index within row
    d_m = int((new_grp & valid).sum(1).max())
    k_max = int(k_idx[valid].max()) + 1
    pos_k = np.full((n, d_m, k_max), pos_sentinel, np.int32)
    cross2 = np.full((n, d_m), num_vertices, np.int32)
    rr, cc = np.nonzero(valid)
    pos_k[rr, grp[valid], k_idx[valid]] = sp[valid]
    cross2[rr, grp[valid]] = sc[valid]
    return pos_k, cross2


def incidence_table(idx, num_vertices: int):
    """Transpose of an edge->vertex index list: [N, D_max] table of edge ids
    incident to each vertex, padded with the sentinel E (= len(idx))."""
    idx = np.asarray(idx)
    E = idx.shape[0]
    order = np.argsort(idx, kind="stable")
    sorted_v = idx[order]
    counts = np.bincount(idx, minlength=num_vertices)
    d_max = int(counts.max()) if E else 1
    table = np.full((num_vertices, max(1, d_max)), E, np.int32)
    starts = np.zeros(num_vertices + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    # position of each sorted edge within its vertex's run
    pos = np.arange(E) - starts[sorted_v]
    table[sorted_v, pos] = order
    return table


def ell_tables(idx_by_slot, num_vertices_by_slot, width_bucket=None):
    """Per-slot ELL tables of the couplings between slots of different
    vertex spaces. For each slot k: ``inc[k]`` [N_k, D_k] edge ids incident
    to each vertex (sentinel E); for each ordered slot pair (k_out, k_in),
    k_in != k_out: ``ell[(k_out, k_in)][v, d] = idx_k_in[inc_k_out[v, d]]``
    (sentinel N_k_in), the vertex whose p-value row (v, d) reads.
    ``width_bucket`` (a plan for changing topologies) rounds each incidence
    width up, so that topologies of one edge bucket mostly share shapes;
    its sentinel rows flow through to the vertex sentinel."""
    inc = {k: incidence_table(np.asarray(i), num_vertices_by_slot[k])
           for k, i in idx_by_slot.items()}
    if width_bucket is not None:
        inc = {k: pad_table_width(t, width_bucket(t.shape[1]), np.asarray(idx_by_slot[k]).shape[0])
               for k, t in inc.items()}
    ell = {}
    for ko, tko in inc.items():
        E = np.asarray(idx_by_slot[ko]).shape[0]
        for ki, iki in idx_by_slot.items():
            if ki == ko:
                continue
            idx_ext = np.concatenate([np.asarray(iki), [num_vertices_by_slot[ki]]]).astype(np.int32)
            ell[(ko, ki)] = idx_ext[np.minimum(tko, E)]
    return inc, ell


def ell_to_csr(cross, num_vertices: int):
    """A remainder's ELL table [N, D] (sentinel ``num_vertices``) as a
    destination-sorted CSR: (rowptr [N+1] int32, col [nnz] int32, src
    [nnz] int64 flat positions into the [N·D] ELL entries), each row's
    entries in ELL column order."""
    cross = np.asarray(cross)
    n = cross.shape[0]
    valid = cross < num_vertices
    counts = valid.sum(axis=1)
    rowptr = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=rowptr[1:])
    src = np.flatnonzero(valid.reshape(-1))  # row-major: rows, then columns
    col = cross.reshape(-1)[src]
    return rowptr.astype(np.int32), col.astype(np.int32), src.astype(np.int64)
