"""Matrix-free solver operators derived from a compiled problem.

PyTorch counterpart of ``opt_tpu/functions.py``, the replacement for the
reference's symbolic operator derivation:

* JᵀF from one ``torch.func.vjp`` of the residual function;
* Jᵀ(J·p) from ``torch.func.jvp`` followed by the same vjp;
* the exact Jacobi diagonal Σ(∂r/∂x)² from one one-hot jvp probe per
  (unknown slot, channel) of the pointwise slot-form residual function.

Exclusion follows the reference kernels: excluded unknowns have their rows
masked out of JᵀF, the diagonal and JᵀJ·p, and their residuals out of the
cost, but residual instances centered at excluded pixels still feed the
gradients of active unknowns.

Under a mesh of ranks (``parallel/mesh.py``) a set works on its rank's
extended region and is given the rank's ``ShardingRules`` as its
``window``: the cost sums then take the residual centres in the rank's
tile only, in float64, and add the ranks' sums in one all_reduce. Every
other operator is per point and is read on the tile by the solver.

On a graph mesh (``compiled.graph_rules``) a set works on the rank's owner
blocks and edge block: its cost sums the rank's own residuals the same way.
The per-edge reads of other ranks' vertices are exchanged outside every
``torch.func`` transform (a collective has no transpose rule there): the
residuals are a function of the blocks and of the exchanged per-edge
values, J·p exchanges p's the same way, and Jᵀ sends the per-edge
cotangents back to their owners by the reverse exchange
(``parallel/mesh.py::slot_halo_scatter_add``).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from .compile import CompiledProblem
from .ops.graph_ops import edge_scatter_add
from .ops.shift import shift_adjoint
from .parallel.mesh import slot_halo_scatter_add


def _mask_rows(x: Dict[str, torch.Tensor], row_masks) -> Dict[str, torch.Tensor]:
    # 0/1 float masks: multiplication, as the reference package does
    out = {}
    for k, v in x.items():
        m = row_masks.get(k)
        out[k] = v if m is None else v * m
    return out


def _mask_rows_select(x: Dict[str, torch.Tensor], row_masks) -> Dict[str, torch.Tensor]:
    # select, not multiply: values that are non-finite at excluded rows (the
    # LM damping, where 1/SSq = inf at diag(JᵀJ) = 0) would give inf*0 = NaN
    out = {}
    for k, v in x.items():
        m = row_masks.get(k)
        out[k] = v if m is None else torch.where(m != 0, v, torch.zeros_like(v))
    return out


def tree_dot(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Global dot product over the unknown super-vector."""
    total = None
    for k in a:
        s = torch.sum(a[k] * b[k])
        total = s if total is None else total + s
    return total


class FunctionSet:
    """Per-(problem, bound-constants) operator bundle used by the solver."""

    def __init__(self, compiled: CompiledProblem, consts, graphs, params, window=None):
        self.c = compiled
        self.window = window  # ShardingRules: cost sums over the owned tile
        self.consts = consts
        self.graphs = graphs
        self.params = params
        self.F = compiled.residual_fn(consts, graphs, params)
        self._mask_cache = None

    def masks(self, X):
        """(per-ispace exclusion masks, per-unknown row masks), evaluated
        once at the first X this set sees."""
        if self._mask_cache is None:
            excl = self.c.exclusion_masks(X, self.consts, self.graphs, self.params)
            self._mask_cache = (excl, self.c.unknown_row_masks(excl))
        return self._mask_cache

    @property
    def row_masks(self):
        if self._mask_cache is None:
            raise RuntimeError("call masks(X) first")
        return self._mask_cache[1]

    # -- costs ---------------------------------------------------------------
    def _masked_half_sq_sum(self, terms: List[torch.Tensor], excl) -> torch.Tensor:
        win = self.window
        total = None
        for term, val in zip(self.c.terms, terms):
            sq = val * val
            m = self.c.term_cost_mask(term, excl)
            if m is not None:
                sq = sq * (1.0 - m)  # m: 1.0 = excluded center
            s = torch.sum(sq) if win is None else win.owned_sum(sq)
            total = s if total is None else total + s
        if win is not None:
            total = win.mesh.all_reduce_sum(total).to(self.c.dtype)
        return 0.5 * total

    def cost(self, X) -> torch.Tensor:
        """½ Σ r² over non-excluded centers (reference createcost)."""
        excl, _ = self.masks(X)
        return self._masked_half_sq_sum(self.F(X), excl)

    # -- linearization bundle --------------------------------------------------
    def _mesh_parts(self, X):
        """On a graph mesh: (the residuals as a function of the blocks X and
        the unknowns' exchanged per-edge values, those values at X)."""
        c, rules = self.c, self.c.graph_rules
        ev_c = rules.const_edge_values(c, self.consts, self.graphs)

        def F(Xb, ev_u):
            return c.residual_terms(Xb, self.consts, self.graphs, self.params,
                                    edge_values={**ev_c, **ev_u})

        return F, rules.edge_values(c, X, self.consts, self.graphs, "unknowns")

    def linearize(self, X):
        """Returns (residual terms, J·(), Jᵀ·()) at X."""
        _, row_masks = self.masks(X)
        if self.c.graph_rules is not None:
            F, ev_u = self._mesh_parts(X)
            r_terms, vjp_fn = torch.func.vjp(F, X, ev_u)
            rules = self.c.graph_rules

            def JT(terms):
                g, g_ev = vjp_fn(list(terms))
                g = dict(g)
                for (name, gname, slot), ct in g_ev.items():
                    g[name] = g[name] + slot_halo_scatter_add(
                        rules.mesh, ct, int(g[name].shape[0]),
                        rules.read_tables(self.graphs[gname], gname, slot, name))
                return _mask_rows(g, row_masks)

            return r_terms, self._mesh_jvp(X, F, ev_u), JT
        r_terms, vjp_fn = torch.func.vjp(self.F, X)

        def JT(terms):
            (g,) = vjp_fn(list(terms))
            return _mask_rows(g, row_masks)

        return r_terms, self.jvp_fn(X), JT

    def jvp_fn(self, X):
        """J·() at X. The tangent dict may list the unknowns in any order
        (torch.func compares dict structure with its key order)."""
        if self.c.graph_rules is not None:
            return self._mesh_jvp(X, *self._mesh_parts(X))

        def J(p):
            return torch.func.jvp(self.F, (X,), ({k: p[k] for k in X},))[1]

        return J

    def _mesh_jvp(self, X, F, ev_u):
        """J·() at X on a graph mesh: p's per-edge values exchanged as X's."""
        rules = self.c.graph_rules

        def J(p):
            p = {k: p[k] for k in X}
            ev_p = rules.edge_values(self.c, p, self.consts, self.graphs, "unknowns")
            return torch.func.jvp(F, (X, ev_u), (p, {k: ev_p[k] for k in ev_u}))[1]

        return J

    def model_cost(self, X, r_terms, J, delta) -> torch.Tensor:
        """½‖F + Jδ‖² over non-excluded centers, from the explicit J·δ (the
        LM model cost; the algebraic form drifts in f32)."""
        excl, _ = self.masks(X)
        jd = J(delta)
        return self._masked_half_sq_sum([r + d for r, d in zip(r_terms, jd)], excl)

    def jtf(self, X):
        """JᵀF (positive sign; the solver negates: residuum = -JᵀF)."""
        r_terms, _, JT = self.linearize(X)
        return JT(r_terms)

    # -- exact Jacobi diagonal ---------------------------------------------------
    def jtj_diag(self, X) -> Dict[str, torch.Tensor]:
        """diag(JᵀJ) per unknown channel, rows masked at excluded unknowns:
        for each (unknown slot, channel) a one-hot tangent probes the
        pointwise slot-form residuals; the probe output is the local
        derivative field ∂r[q]/∂x[q+s,c], squared, summed over residual
        channels and scattered back through the slot's shift adjoint (grid
        slots) or summed per vertex over the slot's edges (graph slots).
        As in the reference's per-endpoint scatter, the sum is per slot: a
        self-loop edge's cross term is not included. On a graph mesh the
        per-edge values are the rank's edge block's, and a graph slot's
        channels go back to their owners' rows together, by one reverse
        exchange (``slot_halo_scatter_add``, opt_tpu/functions.py:220-238)."""
        _, row_masks = self.masks(X)
        c = self.c
        rules = c.graph_rules
        slot_vals = c.gather_slot_values(X, self.consts, self.graphs, self.params)
        scales = c.graph_term_scales(self.graphs)

        def f(sv):
            terms = c.local_residual_terms(sv, self.params, self.consts)
            return [t if sc is None else t * sc for t, sc in zip(terms, scales)]

        # made from X: under torch.func.vmap they carry the batch axis
        diag = {name: X[name].new_zeros(c.unknown_shape(name)) for name in c.unknown_names}
        zeros = [torch.zeros_like(v) for v in slot_vals]
        for sid in c.unknown_slot_ids():
            s = c.registry.slots[sid]
            per_ch = []  # a graph slot's channels on a mesh, sent back together
            for ch in range(s.channels):
                tangents = list(zeros)
                t = torch.zeros_like(slot_vals[sid])
                t[..., ch] = 1.0
                tangents[sid] = t
                d_terms = torch.func.jvp(f, (slot_vals,), (tangents,))[1]
                contrib = None
                for term, dt in zip(c.terms, d_terms):
                    if sid in term.slot_ids:
                        sq = torch.sum(dt * dt, dim=-1)
                        contrib = sq if contrib is None else contrib + sq
                if contrib is None:
                    break  # slot feeds no term (channel-independent)
                if rules is not None and s.kind == "gimg":
                    per_ch.append(contrib)
                    continue
                if s.kind == "img":
                    add = shift_adjoint(contrib[..., None], s.offset)[..., 0]
                else:
                    n_rows = c.unknown_shape(s.image)[0]
                    idx = self.graphs[s.graph][s.key[3]]
                    add = edge_scatter_add(contrib[:, None], idx, n_rows)[:, 0]
                diag[s.image][..., ch] += add
            if per_ch:
                diag[s.image] = diag[s.image] + slot_halo_scatter_add(
                    rules.mesh, torch.stack(per_ch, dim=-1), int(diag[s.image].shape[0]),
                    rules.read_tables(self.graphs[s.graph], s.graph, s.key[3], s.image))
        return _mask_rows(diag, row_masks)

    def mask_rows(self, x):
        return _mask_rows(x, self.row_masks)

    def mask_rows_select(self, x):
        """Where-based row masking, safe for non-finite values at excluded
        rows."""
        return _mask_rows_select(x, self.row_masks)

    # -- assembled gather-form JᵀJ (see assembly.py) ---------------------------
    def assemble_stencil(self, X, plan, const_cache=None, coeff_dtype=None, allow_split=True,
                         sharded=False):
        """(apply_fn, diag, jtf_fn, cg_meta) of the assembled operator at X,
        its loop-resident coefficients stored in ``coeff_dtype``;
        ``allow_split`` and ``sharded`` as in :func:`assembly.assemble`."""
        from .assembly import assemble

        _, row_masks = self.masks(X)
        return assemble(
            self.c, plan, X, self.consts, self.graphs, self.params, row_masks,
            const_cache=const_cache, coeff_dtype=coeff_dtype, allow_split=allow_split,
            sharded=sharded,
        )

    def assemble_const(self, X0, plan):
        """Loop-invariant assembly phase (assembly.assemble_const)."""
        from .assembly import assemble_const

        return assemble_const(self.c, plan, X0, self.consts, self.graphs, self.params)
