"""Assembled gather-form JᵀJ operator for grid (centered) and graph domains.

PyTorch counterpart of ``opt_tpu/assembly.py`` — the equivalent of the
reference's symbolic ``createjtjcentered`` and ``createjtjgraph``: instead
of composing Jᵀ(J·p) from the residual linearization in every CG iteration,
the solver assembles, once per nonlinear iteration, coefficient fields

* centered: W[(u_out, u_in, Δ, i, j)][q]
      = Σ_{t, s_out, s_in : s_in - s_out = Δ}
        Σ_rch ∂r_t[q-s_out, rch]/∂u_out[q, i] · ∂r_t[q-s_out, rch]/∂u_in[q+Δ, j]
  applied in the CG loop as weighted shifts
  (JᵀJ p)[u_out][q, i] = Σ W[...][q] · p[u_in][q+Δ, j];

* graph: per-edge coupling blocks P(k_out, k_in)[e] between the edge's
  endpoint slots, stacked per vertex-space group and gathered per vertex
  through the combined incidence table: the same-vertex blocks pre-sum into
  one block S[v] per vertex, cross-vertex blocks at dominant vertex-id
  offsets into per-offset blocks (DIA), and the rest into one block per
  distinct (v, u) read (the remainder). Couplings between slots of
  different vertex spaces (a cluster's rotation read by its vertices' edges)
  go through per-slot ELL tables: per output vertex its incident edges'
  blocks, applied to the other space's p gathered per edge. Every
  per-vertex sum is a gather and a sum in a fixed order, never an atomic
  scatter.

The per-slot Jacobian fields D[t, s] = ∂r_t/∂slot_s come from one-hot jvp
probes (``torch.func``) of the pointwise slot-form residual function, and
the channel-pair sparsity is detected once per plan by probing randomized
inputs on a small grid, exactly as the reference package does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as TF
from torch.fx.experimental.proxy_tensor import make_fx

from .compile import graph_outputs, node_inputs, op_name
from .ops.fused_cg import (
    LOOP_DTYPES,
    SHARDED_LOOP_DTYPES,
    coefficient_dtype,
    plan_fused_graph_cg,
    plan_fused_grid_cg,
)
from .ops.sampling import is_frozen_marker
from .ops.sharded_cg import (
    _block_matvec,
    graph_apply,
    pack_spaces,
    plan_sharded_graph_cg,
    unpack_spaces,
)
from .ops.shift import shift
from .parallel.mesh import halo_gather_parts
from .solver.params import FLOAT_EPSILON

# centered: (u_out, u_in, delta, i, j) -> [(term_idx, sid_out, sid_in), ...]
WKey = Tuple[str, str, Tuple[int, ...], int, int]
# graph: (graph, u_out, key_out, u_in, key_in, i, j) -> contributions
GKey = Tuple[str, str, str, str, str, int, int]

# the reference package's probe seed (opt_tpu/assembly.py:497): identical
# draws make identical structure decisions
PROBE_SEED = 20260816


@dataclasses.dataclass
class AssemblyPlan:
    """Static description of the nonzero JᵀJ coefficient fields."""

    w_spec: Dict[WKey, List[Tuple[int, int, int]]]
    g_spec: Dict[GKey, List[Tuple[int, int, int]]]
    needed_slots: List[int]  # unknown slot ids probed at assembly time
    # (u_out, u_in, delta) / (g, u_out, k_out, u_in, k_in) groups whose
    # diagonal pair fields are channel-independent: one field stands for C
    # identical copies
    scalar_groups: frozenset = frozenset()
    # (term_idx, slot_id) Jacobian fields independent of the unknowns:
    # probed once per solve (assemble_const), not once per step
    const_tsids: frozenset = frozenset()

    def centered_memory_bytes(self, compiled) -> int:
        itemsize = torch.empty((), dtype=compiled.dtype).element_size()
        total = 0
        for (u_out, *_rest) in self.w_spec:
            total += int(np.prod(compiled.unknown_shape(u_out)[:-1])) * itemsize
        return total


# comparison-like primitives whose scalar operand is a gate threshold
_CMP_OPS = frozenset({
    "gt", "lt", "ge", "le", "eq", "ne", "greater", "less", "greater_equal",
    "less_equal", "not_equal", "maximum", "minimum", "clamp", "clamp_min",
    "clamp_max",
})
# piecewise-constant primitives: locally constant in their input
_PW_OPS = frozenset({"sign", "floor", "ceil", "round", "trunc"})


def _literals(node):
    """Python-number operands of a node (the FX analogue of jaxpr Literals)."""
    out = []
    for a in list(node.args) + list(node.kwargs.values()):
        if isinstance(a, bool):
            continue
        if isinstance(a, (int, float)):
            out.append(float(a))
    return out


def _residual_graph(compiled, X, consts, graphs, params):
    sv = compiled.gather_slot_values(X, consts, graphs, params)
    return make_fx(
        lambda *s: tuple(compiled.local_residual_terms(list(s), params, consts))
    )(*sv)


def _comparison_constants(compiled, X, consts, graphs, params) -> List[float]:
    """Scalar constants appearing as comparison operands in the residual
    graph: data-dependent gates like ``greater(D, 2.0)`` flip under the
    probe distribution only if probe values straddle the threshold, so the
    probe value set covers every traced threshold (±0.5 around each)."""
    gm = _residual_graph(compiled, X, consts, graphs, params)
    out = set()
    for node in gm.graph.nodes:
        if node.op == "call_function" and op_name(node) in _CMP_OPS:
            for t in _literals(node):
                if np.isfinite(t):
                    out.add(t)
    vals = set()
    for t in sorted(out):
        vals.update((t, t - 0.5, t + 0.5))
    return sorted(vals)


def _is_int_cast(node) -> bool:
    if op_name(node) not in ("_to_copy", "to", "_convert_element_type"):
        return False
    dt = node.kwargs.get("dtype")
    return dt is not None and not dt.is_floating_point and dt != torch.bool


def _terms_with_traced_gates(compiled, X, consts, graphs, params):
    """Residual-term indices whose computation contains a gate the probes
    cannot certify, so the planner refuses structural pruning, constant
    hoisting and scalar-group collapsing for those terms. Taint propagates
    forward through the graph. A gate is

    * a comparison-like op with NO literal operand (array-vs-array gates:
      the probes have no threshold to straddle);
    * a piecewise-constant op (sign/floor/ceil/round) of a traced value, or
      a float -> int cast: locally constant, so a field built from them can
      look X-independent or identically zero under any finite draw;
    * either of these on a value derived from a ComputedArray slot, EVEN
      WITH a literal operand: a cimg/cgrad slot's value is not drawn, it is
      recomputed from the probe unknowns (gather_slot_values), so the gate
      compares a FUNCTION of the draws against the literal and no
      input-space value set straddles that threshold in general
      (shape_from_shading's ``eq(valid, 1)``, where ``valid`` needs four
      |ΔX| < 0.01 neighbour coincidences that no O(1) draw produces: its
      couplings would probe identically zero and be pruned).

    The sampler's own floor/ceil/casts/clamps (ops/sampling.py) implement a
    smooth interpolant whose derivative comes from the user's dx/dy images,
    not Jacobian gates: values computed only from a ``frozen`` position and
    constants are skipped, as the JAX package does not descend into its
    ``custom_jvp`` sampling rule. validate_assembly stays the backstop."""
    gm = _residual_graph(compiled, X, consts, graphs, params)
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    derived = {
        n for n, s in zip(placeholders, compiled.registry.slots)
        if s.kind in ("cimg", "cgrad")
    }
    sampler, const = set(), set()  # sampler-internal values; trace constants
    taint = set()
    for node in gm.graph.nodes:
        if node.op == "get_attr":
            const.add(node)
            continue
        if node.op != "call_function":
            continue
        ins = node_inputs(node)
        name = op_name(node)
        if is_frozen_marker(name):
            sampler.add(node)
            continue
        if all(a in const for a in ins):
            const.add(node)
        elif all(a in sampler or a in const for a in ins):
            sampler.add(node)  # computed from frozen positions and constants only
            continue
        on_derived = any(a in derived for a in ins)
        if on_derived:
            derived.add(node)
        if name in _CMP_OPS or name in _PW_OPS:
            gate = not _literals(node) or on_derived
        else:
            gate = _is_int_cast(node)
        if gate or any(a in taint for a in ins):
            taint.add(node)
    return frozenset(
        t for t, o in enumerate(graph_outputs(gm.graph)) if o in taint
    )


def _probe_inputs(compiled, rng, probe_edges, extra_vals=()):
    """Randomized inputs exercising both branches of mask-style selects:
    constants mix exact {0, 1, -1} and every traced threshold (±0.5) with
    uniform values; unknowns mix a uniform base with the same threshold
    values; graph slots are uniform random valid indices. Same draws, in
    the same order, as the reference package."""
    base_vals = [0.0, 1.0, -1.0] + [
        v for v in extra_vals if v not in (0.0, 1.0, -1.0)
    ]
    unknowns, consts = {}, {}
    for name, decl in compiled.registry.images.items():
        if decl.alias is not None:
            continue
        shape = decl.ispace.shape(compiled.dim_sizes) + (decl.channels,)
        if decl.kind == "unknown":
            vals = rng.uniform(0.5, 1.5, shape)
            if extra_vals:
                pick = np.asarray(extra_vals)[rng.randint(0, len(extra_vals), shape)]
                vals = np.where(rng.rand(*shape) < 0.25, pick, vals)
            unknowns[name] = torch.as_tensor(vals).to(compiled.dtype)
        else:
            cat = rng.randint(0, len(base_vals) + 1, shape)
            vals = rng.uniform(0.3, 1.7, shape)
            for k, bv in enumerate(base_vals):
                vals = np.where(cat == k, bv, vals)
            consts[name] = torch.as_tensor(vals).to(compiled.dtype)
    graphs = {
        gname: {
            slot: torch.as_tensor(
                rng.randint(0, max(1, int(np.prod(isp.shape(compiled.dim_sizes)))), probe_edges),
                dtype=torch.int64,
            )
            for slot, isp in gdecl.slots.items()
        }
        for gname, gdecl in compiled.registry.graphs.items()
    }
    params = {
        p: torch.tensor(rng.uniform(0.5, 1.5), dtype=compiled.dtype)
        for p in compiled.registry.params
    }
    return unknowns, consts, graphs, params


def _slot_jacobians(compiled, X, consts, graphs, params, slot_ids):
    """D[(term_idx, sid)] = ∂r_t/∂slot_sid as [*dom, r_ch, C_s] via one-hot
    jvp probes of the slot-form residual function, all probes as one
    ``vmap`` over ``jvp``. Also returns the probe tensors per term
    ([*dom, r_ch, n_probes]), each slot's first probe column, and the
    residual terms at X. Per-edge ``valid`` masks scale the slot-form
    residuals as ``residual_terms`` does, so a masked edge's Jacobian
    fields, and every block built from them, are exactly zero."""
    sv = compiled.gather_slot_values(X, consts, graphs, params)
    scales = compiled.graph_term_scales(graphs)

    def f(s):
        terms = compiled.local_residual_terms(s, params, consts)
        return [t if sc is None else t * sc for t, sc in zip(terms, scales)]

    probe_of = [
        (sid, ch)
        for sid in slot_ids
        for ch in range(compiled.registry.slots[sid].channels)
    ]
    n_probes = len(probe_of)
    # one-hot tangents as broadcast selector constants [n_probes, 1.., C_k]
    batched = []
    for k, v in enumerate(sv):
        sel = torch.zeros((n_probes, v.shape[-1]), dtype=v.dtype, device=v.device)
        for pi, (sid, ch) in enumerate(probe_of):
            if sid == k:
                sel[pi, ch] = 1.0
        sel = sel.reshape((n_probes,) + (1,) * (v.dim() - 1) + (v.shape[-1],))
        batched.append(sel.expand((n_probes,) + tuple(v.shape)))

    def probe(*tangents):
        return torch.func.jvp(f, (sv,), (list(tangents),))[1]

    d_all = torch.func.vmap(probe)(*batched)  # per term [n_probes, *dom, r_ch]
    moved = [torch.movedim(d, 0, -1) for d in d_all]  # [*dom, r_ch, n_probes]
    base_of = {}
    for pi, (sid, _ch) in enumerate(probe_of):
        base_of.setdefault(sid, pi)
    D = {}
    for t_idx, term in enumerate(compiled.terms):
        for sid in slot_ids:
            if sid in term.slot_ids:
                base = base_of[sid]
                s = compiled.registry.slots[sid]
                D[(t_idx, sid)] = moved[t_idx][..., base : base + s.channels]
    return D, moved, base_of, f(sv)


def plan_assembly(spec_fn, compiled, *, probe_size: int = 8, probe_edges: int = 32,
                  memory_limit_bytes: int = 1 << 31) -> Optional[AssemblyPlan]:
    """Build the static assembly plan (memoized on the compiled problem), or
    None when it would exceed the centered-field memory budget."""
    cache_key = (probe_size, probe_edges, memory_limit_bytes)
    cache = compiled.__dict__.setdefault("_assembly_plan_cache", {})
    if cache_key not in cache:
        cache[cache_key] = _plan_assembly_uncached(
            spec_fn, compiled, probe_size=probe_size, probe_edges=probe_edges,
            memory_limit_bytes=memory_limit_bytes,
        )
    return cache[cache_key]


def _plan_assembly_uncached(spec_fn, compiled, *, probe_size, probe_edges,
                            memory_limit_bytes) -> Optional[AssemblyPlan]:
    """Channel-pair sparsity by evaluating the per-pair coefficient fields at
    two randomized probe input sets on a small grid: a pair whose field is
    exactly zero at every probe element under both draws is structurally
    zero. The probe compile is float32 on the CPU always, so structure is
    decided as in the reference package whatever the plan's device."""
    from .compile import compile_spec

    probe_dims = {k: min(v, probe_size) for k, v in compiled.dim_sizes.items()}
    probe = compile_spec(spec_fn, probe_dims, torch.float32)

    ps, cs = probe.registry.slots, compiled.registry.slots
    if len(ps) != len(cs) or len(probe.terms) != len(compiled.terms) or any(
        (a.kind, a.image, a.offset, a.graph, a.channels)
        != (b.kind, b.image, b.offset, b.graph, b.channels)
        for a, b in zip(ps, cs)
    ):
        return None
    unknown_sids = probe.unknown_slot_ids()
    if not unknown_sids:
        return None

    rng = np.random.RandomState(PROBE_SEED)
    slots = probe.registry.slots

    def _group_key(so, si):
        s_out, s_in = slots[so], slots[si]
        if s_out.kind == "img":
            delta = tuple(b - a for a, b in zip(s_out.offset, s_in.offset))
            return (s_out.image, s_in.image, delta)
        return (s_out.graph, s_out.image, s_out.key[3], s_in.image, s_in.key[3])

    Xp0, constsp0, graphsp0, paramsp0 = _probe_inputs(probe, rng, probe_edges)
    extra_vals = _comparison_constants(probe, Xp0, constsp0, graphsp0, paramsp0)

    nonzero: Dict[Tuple[int, int, int, int, int], bool] = {}
    probe_fields: List[Dict[Tuple, np.ndarray]] = []
    D = constsp = graphsp = paramsp = None
    for _draw in range(2):
        Xp, constsp, graphsp, paramsp = _probe_inputs(probe, rng, probe_edges, extra_vals)
        D, _mv, _bo, _pr = _slot_jacobians(probe, Xp, constsp, graphsp, paramsp, unknown_sids)
        pf: Dict[Tuple, np.ndarray] = {}
        for t_idx, term in enumerate(probe.terms):
            t_sids = [sid for sid in unknown_sids if sid in term.slot_ids]
            for so in t_sids:
                for si in t_sids:
                    Do = D[(t_idx, so)].numpy()
                    Di = D[(t_idx, si)].numpy()
                    B = np.einsum("...ri,...rj->...ij", Do, Di)
                    nz = ~np.all(B.reshape(-1, B.shape[-2], B.shape[-1]) == 0, axis=0)
                    if slots[so].kind == "img":
                        off = tuple(-o for o in slots[so].offset)
                        Bacc = shift(torch.as_tensor(B), off + (0, 0)).numpy()
                    else:
                        Bacc = B
                    gk = _group_key(so, si)
                    for i in range(nz.shape[0]):
                        for j in range(nz.shape[1]):
                            if nz[i, j]:
                                nonzero[(t_idx, so, si, i, j)] = True
                            prev = pf.get((gk, i, j))
                            pf[(gk, i, j)] = (
                                Bacc[..., i, j] if prev is None else prev + Bacc[..., i, j]
                            )
        probe_fields.append(pf)

    # terms gated array-vs-array: keep every channel pair (no pruning)
    tainted_terms = _terms_with_traced_gates(probe, Xp0, constsp0, graphsp0, paramsp0)
    for t_idx in tainted_terms:
        term = probe.terms[t_idx]
        t_sids = [sid for sid in unknown_sids if sid in term.slot_ids]
        for so in t_sids:
            for si in t_sids:
                for i in range(slots[so].channels):
                    for j in range(slots[si].channels):
                        nonzero[(t_idx, so, si, i, j)] = True

    w_spec: Dict[WKey, List[Tuple[int, int, int]]] = {}
    g_spec: Dict[GKey, List[Tuple[int, int, int]]] = {}
    group_pairs: Dict[Tuple, set] = {}
    group_channels: Dict[Tuple, Tuple[int, int]] = {}
    for (t_idx, so, si, i, j) in sorted(nonzero):
        gk = _group_key(so, si)
        group_pairs.setdefault(gk, set()).add((i, j))
        group_channels[gk] = (slots[so].channels, slots[si].channels)
        spec_d = w_spec if slots[so].kind == "img" else g_spec
        spec_d.setdefault(gk + (i, j), []).append((t_idx, so, si))

    # scalar groups: full diagonal with channel-identical fields at both draws
    scalar = set()
    for gk, pairs in group_pairs.items():
        c_out, c_in = group_channels[gk]
        if c_out != c_in or c_out < 2 or pairs != {(i, i) for i in range(c_out)}:
            continue
        same = True
        for pf in probe_fields:
            f0 = pf.get((gk, 0, 0))
            for i in range(1, c_out):
                fi = pf.get((gk, i, i))
                if f0 is None or fi is None or not np.array_equal(f0, fi):
                    same = False
                    break
            if not same:
                break
        if same:
            scalar.add(gk)
    if tainted_terms:
        scalar -= {
            key[:-2]
            for spec_d in (w_spec, g_spec)
            for key, contribs in spec_d.items()
            if any(t in tainted_terms for (t, _so, _si) in contribs)
        }

    needed = set()
    for contribs in list(w_spec.values()) + list(g_spec.values()):
        for (_t, so, si) in contribs:
            needed.update((so, si))

    # constant-slot detection: a (term, slot) Jacobian field bit-identical
    # under a fresh unknown draw (consts and params fixed) is independent of
    # X; it is probed once per solve instead of once per step. Like the
    # zero pruning it is probabilistic, backed by validate_assembly.
    Xp_alt, _c2, _g2, _p2 = _probe_inputs(probe, rng, probe_edges, extra_vals)
    D_alt, _mv2, _bo2, _pr2 = _slot_jacobians(
        probe, Xp_alt, constsp, graphsp, paramsp, unknown_sids
    )
    const_tsids = set()
    for key in D:
        if key[0] in tainted_terms:
            continue
        a, b = D[key].numpy(), D_alt[key].numpy()
        if np.all(np.isfinite(a)) and np.array_equal(a, b):
            const_tsids.add(key)

    plan = AssemblyPlan(
        w_spec=w_spec,
        g_spec=g_spec,
        needed_slots=sorted(needed),
        scalar_groups=frozenset(scalar),
        const_tsids=frozenset(const_tsids),
    )
    if plan.centered_memory_bytes(compiled) > memory_limit_bytes:
        return None
    return plan


def _used_tsids(compiled, plan) -> List[Tuple[int, int]]:
    return [
        (t_idx, sid)
        for t_idx, term in enumerate(compiled.terms)
        for sid in plan.needed_slots
        if sid in term.slot_ids
    ]


def _pair_block(D, t_idx, so, si):
    """[*dom, C_so, C_si] = Σ_rch D[t,so][..., r, :, None] · D[t,si][..., r, None, :]."""
    Do = D[(t_idx, so)][..., :, :, None]
    Di = D[(t_idx, si)][..., :, None, :]
    return torch.sum(Do * Di, dim=-3)


def assemble_const(compiled, plan: AssemblyPlan, X0, consts, graphs, params):
    """Loop-invariant assembly phase: probe the X-independent (term, slot)
    Jacobian fields once (at the solve's initial unknowns) and pre-multiply
    every coupling block whose both sides are constant. For linear problems
    (poisson) the entire operator hoists and per-step assembly is free."""
    used = _used_tsids(compiled, plan)
    const_ts = [k for k in used if k in plan.const_tsids]
    var_slots = sorted({sid for (t, sid) in used if (t, sid) not in plan.const_tsids})
    if not const_ts:
        return {"D": {}, "moved": None, "base": {}, "B": {}, "var_slots": var_slots}
    cache_slots = sorted({sid for (_t, sid) in const_ts})
    D_all, moved, base_of, _r = _slot_jacobians(
        compiled, X0, consts, graphs, params, cache_slots
    )
    D = {k: D_all[k] for k in const_ts}
    B = {}
    for contribs in list(plan.w_spec.values()) + list(plan.g_spec.values()):
        for key in contribs:
            t_idx, so, si = key
            if key not in B and (t_idx, so) in plan.const_tsids and (
                t_idx, si
            ) in plan.const_tsids:
                B[key] = _pair_block(D, t_idx, so, si)
    return {"D": D, "moved": moved, "base": base_of, "B": B, "var_slots": var_slots}


def _gauss_jordan_inv(B):
    """Batched inverse of small regularized-SPD blocks [..., c, c] by
    pivot-free Gauss-Jordan (c rounds of elementwise row ops over the
    batch), then one Newton refinement X ← X(2I − BX), which squares the
    pivot-free rounding residual. No pivoting is safe: callers regularize
    the diagonal, so every pivot is bounded away from zero. The refinement
    products are broadcast multiplies and sums in the blocks' dtype, so no
    TF32 setting of the matmul backend can touch them."""
    c = B.shape[-1]
    eye = torch.eye(c, dtype=B.dtype, device=B.device).expand(B.shape)
    M = torch.cat([B, eye], dim=-1)  # [..., c, 2c]
    for k in range(c):
        piv = M[..., k, :] / M[..., k, k : k + 1]
        M = M - M[..., :, k : k + 1] * piv[..., None, :]
        M[..., k, :] = piv
    X = M[..., :, c:]

    def mm(a, b):
        return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)

    BX = mm(B, X)
    return mm(X, 2.0 * eye - BX)


def _pad_channels(x, lo, hi):
    return x if lo == 0 and hi == 0 else TF.pad(x, (lo, hi))


def _graph_layouts(compiled, plan, graphs):
    """The graph couplings grouped per (graph, vertex-space group): returns
    (g_couplings {(g, u_out, k_out, u_in, k_in): {(t, so, si)}},
    g_layouts {(g, gk): (slot names, u_list, offs, ct)},
    grp_cks {(g, gk): [coupling keys]} of the couplings within a group,
    pair_cks {(g, gk_out, gk_in, k_out, k_in): [coupling keys]} of those
    between slots of different groups (different vertex spaces), and
    slot_group {(g, slot): gk}). The group packs its unknowns' channels in
    sorted unknown order."""
    g_couplings: Dict[Tuple, set] = {}
    for key, contribs in plan.g_spec.items():
        g_couplings.setdefault(key[:5], set()).update(contribs)
    unknown_channels = {u: compiled.unknown_shape(u)[-1] for u in compiled.unknown_names}
    g_layouts, slot_group = {}, {}
    for g in sorted({ck[0] for ck in g_couplings}):
        for gk, tabs in graphs[g]["__groups__"].items():
            names = tabs["names"]
            us = set()
            for (gg, u_out, k_out, u_in, k_in) in g_couplings:
                if gg == g and k_out in names:
                    us.add(u_out)
                if gg == g and k_in in names:
                    us.add(u_in)
            if not us:
                continue
            offs, o = {}, 0
            for u in sorted(us):
                offs[u] = o
                o += unknown_channels[u]
            g_layouts[(g, gk)] = (names, sorted(us), offs, o)
            for k in names:
                slot_group[(g, k)] = gk
    grp_cks: Dict[Tuple, list] = {}
    pair_cks: Dict[Tuple, list] = {}
    for ck in sorted(g_couplings):
        g, _u_out, k_out, _u_in, k_in = ck
        gk_o, gk_i = slot_group[(g, k_out)], slot_group[(g, k_in)]
        if gk_o == gk_i:
            grp_cks.setdefault((g, gk_o), []).append(ck)
            continue
        ell = graphs[g].get("__ell__")
        if ell is None or (k_out, k_in) not in ell["ell"]:
            raise RuntimeError(f"graph {g!r}: the ELL tables of the coupling {k_out} <- {k_in} "
                               "across vertex spaces are not bound (Plan._augment_incidence)")
        pair_cks.setdefault((g, gk_o, gk_i, k_out, k_in), []).append(ck)
    return g_couplings, g_layouts, grp_cks, pair_cks, slot_group


def assemble(compiled, plan: AssemblyPlan, X, consts, graphs, params, row_masks,
             const_cache=None, coeff_dtype=None, allow_split=True, sharded=False):
    """Assemble the coefficient fields at linearization point X.

    Returns (apply_fn, diag, jtf_fn, cg_meta): the row/column-masked JᵀJ·p
    operator, the row-masked Jacobi diagonal read off the Δ=0 (i, i) fields
    and the same-vertex graph blocks, a JᵀF evaluator over residual term
    tensors (``jtf_fn.r_terms`` holds the residuals at X when a per-step
    probe ran, else None), and the fused CG descriptor (ops/fused_cg.py)
    or None. ``apply_fn.block_pre(extra_diag=None)`` builds the block-Jacobi
    preconditioner. ``coeff_dtype`` (e.g. "bfloat16") narrows the
    coefficient storage the CG loop reads, after the full-precision
    diagonal and block sources are read off. ``allow_split=False`` keeps a
    channel-separable grid operator's fused loop joint (a block
    preconditioner couples the channels). ``sharded``: the descriptor is
    for a grid mesh's sharded loop, which takes float64 too."""
    slots = compiled.registry.slots
    dt = compiled.dtype
    X_ref = next(iter(X.values()))
    X_dev = X_ref.device
    # on a graph mesh: the rank's owner blocks (parallel/mesh.py)
    mesh = None if compiled.graph_rules is None else compiled.graph_rules.mesh

    def _zeros(shape):
        # zeros that the build phase writes into in place: made from X, so
        # that under torch.func.vmap (Plan.solve_batched) they carry the
        # batch axis the written values have
        return X_ref.new_zeros(shape, dtype=dt)

    r_terms_primal = None
    if const_cache is None:
        D, moved, base_of, r_terms_primal = _slot_jacobians(
            compiled, X, consts, graphs, params, plan.needed_slots
        )
        jt_sources = [(moved, base_of)]
        src_of = {k: 0 for k in D}
        B_pre = {}
    else:
        var_slots = const_cache["var_slots"]
        if var_slots:
            D_var, moved_var, base_var, r_terms_primal = _slot_jacobians(
                compiled, X, consts, graphs, params, var_slots
            )
        else:
            D_var, moved_var, base_var = {}, None, {}
        D = dict(D_var)
        D.update(const_cache["D"])  # the cached constant fields win
        jt_sources, vi, ci = [], None, None
        if moved_var is not None:
            vi = len(jt_sources)
            jt_sources.append((moved_var, base_var))
        if const_cache["moved"] is not None:
            ci = len(jt_sources)
            jt_sources.append((const_cache["moved"], const_cache["base"]))
        src_of = {k: (ci if k in const_cache["D"] else vi) for k in D}
        B_pre = const_cache["B"]

    B_all = dict(B_pre)
    for contribs in list(plan.w_spec.values()) + list(plan.g_spec.values()):
        for (t_idx, so, si) in contribs:
            if (t_idx, so, si) not in B_all:
                B_all[(t_idx, so, si)] = _pair_block(D, t_idx, so, si)

    # -- centered fields --------------------------------------------------
    fields: Dict[WKey, torch.Tensor] = {}
    for key, contribs in plan.w_spec.items():
        u_out, u_in, delta, i, j = key
        if key[:3] in plan.scalar_groups and (i, j) != (0, 0):
            continue  # channel-identical: only the (0,0) field is materialized
        acc = None
        for (t_idx, so, si) in contribs:
            B = B_all[(t_idx, so, si)][..., i, j]
            off = tuple(-o for o in slots[so].offset)
            Bs = shift(B[..., None], off)[..., 0]
            acc = Bs if acc is None else acc + Bs
        m_out = row_masks.get(u_out)
        if m_out is not None:
            acc = acc * m_out[..., 0]
        m_in = row_masks.get(u_in)
        if m_in is not None:
            acc = acc * shift(m_in, delta)[..., 0]
        fields[key] = acc

    unknown_channels = {u: compiled.unknown_shape(u)[-1] for u in compiled.unknown_names}

    def _pack_group(pair_fields, c_out, c_in, dom_shape, is_scalar):
        if is_scalar:
            return ("scalar", pair_fields[(0, 0)][..., None])
        if all(i == j for (i, j) in pair_fields):
            cols = [pair_fields.get((i, i)) for i in range(min(c_out, c_in))]
            cols = [
                c if c is not None else torch.zeros(dom_shape, dtype=dt, device=X_dev)
                for c in cols
            ]
            return ("diag", torch.stack(cols, dim=-1))
        block = _zeros(dom_shape + (c_out, c_in))
        for (i, j), f in pair_fields.items():
            block[..., i, j] = f
        return ("block", block)

    w_groups: Dict[Tuple, Dict] = {}
    for (u_out, u_in, delta, i, j), field in fields.items():
        w_groups.setdefault((u_out, u_in, delta), {})[(i, j)] = field

    # pack ACROSS unknowns per (index space, Δ): one shift of the
    # channel-packed p and one block multiply per offset
    isp_of = {u: compiled.registry.images[u].ispace for u in compiled.unknown_names}
    by_isp_delta: Dict[Tuple, list] = {}
    for (u_out, u_in, delta), pf in w_groups.items():
        by_isp_delta.setdefault((isp_of[u_out], delta), []).append((u_out, u_in, pf))

    w_layouts = {}  # ispace -> (u_list, offs, ctot)
    for isp in {k[0] for k in by_isp_delta}:
        u_list = [u for u in compiled.unknown_names if isp_of[u] == isp]
        offs, o = {}, 0
        for u in u_list:
            offs[u] = o
            o += unknown_channels[u]
        w_layouts[isp] = (u_list, offs, o)

    w_packed = []  # (isp, delta, kind, W, oo, oi, co, ci)
    for (isp, delta), groups in by_isp_delta.items():
        u_list, offs, ctot = w_layouts[isp]
        dom = isp.shape(compiled.dim_sizes)
        if len(groups) == 1 and groups[0][0] == groups[0][1]:
            u_out, u_in, pf = groups[0]
            kind, W = _pack_group(
                pf, unknown_channels[u_out], unknown_channels[u_in], dom,
                (u_out, u_in, delta) in plan.scalar_groups,
            )
            w_packed.append((isp, delta, kind, W, offs[u_out], offs[u_in],
                             unknown_channels[u_out], unknown_channels[u_in]))
            continue
        block = _zeros(dom + (ctot, ctot))
        for (u_out, u_in, pf) in groups:
            oo, oi = offs[u_out], offs[u_in]
            if (u_out, u_in, delta) in plan.scalar_groups:
                for ch in range(unknown_channels[u_out]):
                    block[..., oo + ch, oi + ch] += pf[(0, 0)]
            else:
                for (i, j), f in pf.items():
                    block[..., oo + i, oi + j] += f
        w_packed.append((isp, delta, "block", block, 0, 0, ctot, ctot))

    # -- graph couplings ------------------------------------------------------
    # Per (graph, vertex-space group): ONE stacked block row per edge and
    # slot (position 0 the same-slot block P(k, k)[e], positions 1..m-1 the
    # cross blocks in the rotation order of the combined cross table),
    # gathered per vertex through the combined incidence table. Exclusion
    # masks apply in the loop as out = M·A(M·p) (0/1 diagonal M).
    g_couplings, g_layouts, grp_cks, pair_cks, slot_group = _graph_layouts(compiled, plan, graphs)

    def _group_mask(g, gk):
        """Packed [N, ct] 0/1 row mask of a group, or None."""
        _names, u_list, _offs, _ct = g_layouts[(g, gk)]
        if all(row_masks.get(u) is None for u in u_list):
            return None
        parts = []
        for u in u_list:
            m = row_masks.get(u)
            shape = (compiled.unknown_shape(u)[0], unknown_channels[u])
            parts.append(
                torch.ones(shape, dtype=dt, device=X_dev) if m is None else m.expand(shape)
            )
        return torch.cat(parts, dim=-1)

    def _coupling_block(ck):
        """The [E, C_out, C_in] block of a coupling, summed over its
        contributions in a fixed order."""
        blk = None
        for key in sorted(g_couplings[ck]):
            blk = B_all[key] if blk is None else blk + B_all[key]
        return blk

    g_masks = {key: _group_mask(*key) for key in
               set(grp_cks) | {k[:2] for k in pair_cks} | {(k[0], k[2]) for k in pair_cks}}
    grp_exec = {}
    for (g, gk), cks in grp_cks.items():
        names, u_list, offs, ct = g_layouts[(g, gk)]
        tabs = graphs[g]["__groups__"][gk]
        m = len(names)
        E = graphs[g][names[0]].shape[0]

        def _build_P(ko, ki, _offs=offs, _ct=ct, _E=E, _cks=cks):
            parts = [ck for ck in _cks if (ck[2], ck[4]) == (ko, ki)]
            if not parts:
                return None
            acc = _zeros((_E, _ct, _ct))
            for ck in parts:
                _g, u_out, _ko, u_in, _ki = ck
                oo, oi = _offs[u_out], _offs[u_in]
                co, ci = unknown_channels[u_out], unknown_channels[u_in]
                acc[:, oo : oo + co, oi : oi + ci] += _coupling_block(ck)
            return acc

        P = {}
        for a in range(m):
            for b in range(a, m):
                ko, ki = names[a], names[b]
                blk = _build_P(ko, ki)
                if blk is not None:
                    P[(ko, ki)] = blk
                    if a != b:
                        # JᵀJ symmetry: P(ki, ko)[e] = P(ko, ki)[e]ᵀ exactly
                        P[(ki, ko)] = blk.transpose(-1, -2)
                elif a != b:
                    blk_t = _build_P(ki, ko)
                    if blk_t is not None:
                        P[(ki, ko)] = blk_t
                        P[(ko, ki)] = blk_t.transpose(-1, -2)
        has_cross = any(k1 != k2 for (k1, k2) in P)
        n_stack = m if has_cross else 1
        zero = torch.zeros((E, ct, ct), dtype=dt, device=X_dev)
        rows = []
        for a, k in enumerate(names):
            cols = [P.get((k, k), zero)]
            for j in range(n_stack - 1):
                cols.append(P.get((k, names[(a + 1 + j) % m]), zero))
            rows.append(torch.cat([c.reshape(E, ct * ct) for c in cols], dim=-1))
        if mesh is not None:
            # the rank's vertices gather their incident edges' rows from the
            # ranks that assembled them: one exchange through the rank-major
            # stacked rows (opt_tpu/assembly.py:1352-1366)
            G = halo_gather_parts(mesh, rows, tabs["inc_send"], tabs["inc_loc"])
            n_out, d_tot = tabs["inc_loc"].shape
        else:
            rows.append(torch.zeros((1, n_stack * ct * ct), dtype=dt, device=X_dev))
            inc = tabs["inc"]  # [N, D], sentinel m*E reads the zero row
            n_out, d_tot = inc.shape
            G = torch.cat(rows, dim=0)[inc.reshape(-1)].reshape(n_out, d_tot, n_stack * ct * ct)
        ex = {"S": G[:, :, : ct * ct].sum(dim=1), "ct": ct, "dia": [], "C": None,
              "cross": None, "mask": g_masks[(g, gk)], "layout": (u_list, offs, ct),
              "tables": tabs}
        if has_cross:
            Cb = G[:, :, ct * ct :].reshape(n_out, d_tot, m - 1, ct * ct)
            for off, mask in tabs["dia"]:
                ex["dia"].append((off, torch.sum(Cb * mask[..., None], dim=(1, 2))))
            if tabs["rem_pos"] is not None:
                # merged (v, u) reads: their K blocks pre-sum here, in k order
                C_ext = torch.cat(
                    [Cb.reshape(n_out, d_tot * (m - 1), ct * ct),
                     torch.zeros((n_out, 1, ct * ct), dtype=dt, device=X_dev)], dim=1,
                )
                rem_pos = tabs["rem_pos"]
                C_r = None
                for k in range(rem_pos.shape[2]):
                    part = torch.take_along_dim(C_ext, rem_pos[:, :, k, None], dim=1)
                    C_r = part if C_r is None else C_r + part
                ex["C"] = C_r  # [N, Dm, ct*ct]
                ex["cross"] = tabs.get("rem_cross")  # [N, Dm], sentinel N (off a mesh)
        grp_exec[(g, gk)] = ex

    # couplings between slots of different groups: per (graph, out-group,
    # in-group, k_out, k_in) the blocks of k_out's incident edges per output
    # vertex, W [N_out, D, ct_out, ct_in] (the sentinel edge's block zero),
    # and the in-group's vertex each reads, ell [N_out, D] (sentinel N_in)
    pair_exec = {}
    for (g, gk_o, gk_i, k_out, k_in), cks in pair_cks.items():
        _no, _uo, offs_o, ct_o = g_layouts[(g, gk_o)]
        _ni, _ui, offs_i, ct_i = g_layouts[(g, gk_i)]
        E = graphs[g][k_out].shape[0]
        Wb = _zeros((E, ct_o, ct_i))
        for ck in cks:
            _g, u_out, _ko, u_in, _ki = ck
            oo, oi = offs_o[u_out], offs_i[u_in]
            co, ci = unknown_channels[u_out], unknown_channels[u_in]
            Wb[:, oo : oo + co, oi : oi + ci] += _coupling_block(ck)
        tabs = graphs[g]["__ell__"]
        if mesh is not None:
            # the rank's out-vertices gather their incident edges' blocks
            # from the ranks that assembled them; the in-group's p comes
            # through the pair's exchange in the CG loop (Plan._mesh_ell_tables)
            t = tabs["inc"][k_out]
            n_out, d_max = t["loc"].shape
            W = halo_gather_parts(mesh, [Wb.reshape(E, ct_o * ct_i)], t["send"], t["loc"])
        else:
            inc = tabs["inc"][k_out]  # [N_out, D] edge ids, sentinel E
            n_out, d_max = inc.shape
            W_ext = torch.cat([Wb, torch.zeros((1, ct_o, ct_i), dtype=dt, device=X_dev)])
            W = W_ext[inc.reshape(-1)]
        pair_exec[(g, gk_o, gk_i, k_out, k_in)] = {
            "W": W.reshape(n_out, d_max, ct_o, ct_i),
            "ell": tabs["ell"][(k_out, k_in)], "out": (g, gk_o), "in": (g, gk_i),
        }

    def apply_fn(p):
        out = {u: None for u in unknown_channels}
        packed_pc = {
            isp: torch.cat([p[u] for u in u_list], dim=-1) if len(u_list) > 1 else p[u_list[0]]
            for isp, (u_list, _offs, _ct) in w_layouts.items()
        }
        shifted = {}
        acc_c = {isp: None for isp in w_layouts}
        for (isp, delta, kind, W, oo, oi, co, ci) in w_packed:
            ps_full = shifted.get((isp, delta))
            if ps_full is None:
                ps_full = shift(packed_pc[isp], delta)
                shifted[(isp, delta)] = ps_full
            ctot = w_layouts[isp][2]
            ps = ps_full[..., oi : oi + ci] if (oi, ci) != (0, ctot) else ps_full
            if kind == "scalar":
                contrib = W * ps
            elif kind == "diag":
                c = W.shape[-1]
                contrib = _pad_channels(W * ps[..., :c], 0, co - c)
            else:
                contrib = torch.sum(W * ps[..., None, :], dim=-1)
            contrib = _pad_channels(contrib, oo, ctot - oo - co)
            acc_c[isp] = contrib if acc_c[isp] is None else acc_c[isp] + contrib
        for isp, acc in acc_c.items():
            if acc is None:
                continue
            u_list, offs, _ct = w_layouts[isp]
            for u in u_list:
                sl = acc[..., offs[u] : offs[u] + unknown_channels[u]]
                out[u] = sl if out[u] is None else out[u] + sl
        # graph groups: the same-vertex blocks, the DIA offsets as shifted
        # reads, the remainder as one gather of p per distinct (v, u); then
        # the couplings across groups, each a gather of the in-group's p
        # per incident edge, into the out-group's sum before its row mask
        packed = {}

        def packed_p(key):
            pp = packed.get(key)
            if pp is None:
                _names, u_list, _offs, _ct = g_layouts[key]
                pp = torch.cat([p[u] for u in u_list], dim=-1) if len(u_list) > 1 else p[u_list[0]]
                if g_masks[key] is not None:
                    pp = pp * g_masks[key]
                packed[key] = pp
            return pp

        group_acc = {}
        for key, ex in grp_exec.items():
            ct = ex["ct"]
            pp = packed_p(key)
            contrib = _block_matvec(ex["S"], pp, ct)
            for off, W in ex["dia"]:
                contrib = contrib + _block_matvec(W, shift(pp, (off,)), ct)
            if ex["C"] is not None:
                pp_ext = torch.cat([pp, torch.zeros((1, ct), dtype=dt, device=X_dev)])
                pc = pp_ext[ex["cross"]]  # [N, Dm, ct]
                C = ex["C"].reshape(pc.shape[0], pc.shape[1], ct, ct)
                contrib = contrib + torch.sum(C * pc[:, :, None, :], dim=(1, 3))
            group_acc[key] = contrib
        for pe in pair_exec.values():
            pp = packed_p(pe["in"])
            pp_ext = torch.cat([pp, torch.zeros((1, pp.shape[-1]), dtype=dt, device=X_dev)])
            pg = pp_ext[pe["ell"]]  # [N_out, D, ct_in]
            contrib = torch.sum(pe["W"] * pg[:, :, None, :], dim=(1, 3))
            cur = group_acc.get(pe["out"])
            group_acc[pe["out"]] = contrib if cur is None else cur + contrib
        for key, contrib in group_acc.items():
            _names, u_list, offs, _ct = g_layouts[key]
            if g_masks[key] is not None:
                contrib = contrib * g_masks[key]
            for u in u_list:
                sl = contrib[:, offs[u] : offs[u] + unknown_channels[u]]
                out[u] = sl if out[u] is None else out[u] + sl
        for u in out:
            if out[u] is None:
                out[u] = torch.zeros(compiled.unknown_shape(u), dtype=dt, device=X_dev)
        return out

    def jtf_fn(r_terms):
        """JᵀF from the same D fields: Σ_t Σ_s adjoint_s(Σ_rch D[t,s]·r_t),
        one r-contraction per (term, probe source); graph slots sum per
        vertex through the combined incidence gather."""
        out = {u: None for u in unknown_channels}
        jt_all = {}
        for (t_idx, sid) in D:
            si_ = src_of[(t_idx, sid)]
            if (si_, t_idx) not in jt_all:
                mv = jt_sources[si_][0]
                jt_all[(si_, t_idx)] = torch.sum(mv[t_idx] * r_terms[t_idx][..., None], dim=-2)
        edge_parts = {}  # (g, gk, slot) -> {image: [E, C_img]}
        for (t_idx, sid) in D:
            s = slots[sid]
            si_ = src_of[(t_idx, sid)]
            base = jt_sources[si_][1][sid]
            contrib = jt_all[(si_, t_idx)][..., base : base + s.channels]
            if s.kind == "img":
                add = shift(contrib, tuple(-o for o in s.offset))
                out[s.image] = add if out[s.image] is None else out[s.image] + add
                continue
            # every probed graph slot feeds a coupling, so it has a group
            gk = slot_group[(s.graph, s.key[3])]
            per = edge_parts.setdefault((s.graph, gk, s.key[3]), {})
            per[s.image] = contrib if s.image not in per else per[s.image] + contrib
        for (g, gk), (names, u_list, offs, ct) in g_layouts.items():
            if not any((g, gk, k) in edge_parts for k in names):
                continue
            E = graphs[g][names[0]].shape[0]
            blocks = []
            for k in names:
                padded = _zeros((E, ct))
                for img, c in edge_parts.get((g, gk, k), {}).items():
                    padded[:, offs[img] : offs[img] + unknown_channels[img]] = c
                blocks.append(padded)
            tabs = graphs[g]["__groups__"][gk]
            if mesh is not None:  # the same exchange (opt_tpu/assembly.py:1789-1797)
                acc = halo_gather_parts(mesh, blocks, tabs["inc_send"], tabs["inc_loc"]).sum(dim=1)
            else:
                blocks.append(torch.zeros((1, ct), dtype=dt, device=X_dev))
                acc = torch.cat(blocks)[tabs["inc"]].sum(dim=1)
            for u in u_list:
                sl = acc[:, offs[u] : offs[u] + unknown_channels[u]]
                out[u] = sl if out[u] is None else out[u] + sl
        res = {}
        for u in unknown_channels:
            v = out[u]
            if v is None:
                v = torch.zeros(compiled.unknown_shape(u), dtype=dt, device=X_dev)
            m = row_masks.get(u)
            res[u] = v if m is None else v * m
        return res

    # -- free Jacobi diagonal: the Δ=0 (i, i) fields and the same-vertex
    # graph blocks' diagonals -------------------------------------------------
    diag = {}
    for u, c in unknown_channels.items():
        sp = compiled.unknown_shape(u)[:-1]
        zero = tuple([0] * len(sp))
        if (u, u, zero) in plan.scalar_groups:
            diag[u] = fields[(u, u, zero, 0, 0)][..., None].expand(sp + (c,))
            continue
        cols = [fields.get((u, u, zero, i, i)) for i in range(c)]
        diag[u] = torch.stack(
            [f if f is not None else torch.zeros(sp, dtype=dt, device=X_dev) for f in cols],
            dim=-1,
        )
    for ex in grp_exec.values():
        u_list, offs, ct = ex["layout"]
        dcontrib = ex["S"][:, :: ct + 1]  # [N, ct]
        if ex["mask"] is not None:
            dcontrib = dcontrib * ex["mask"]
        for u in u_list:
            diag[u] = diag[u] + dcontrib[:, offs[u] : offs[u] + unknown_channels[u]]

    # -- optional per-point block-Jacobi preconditioner -----------------------
    # The Δ=0 coupling block per packed point (the centred zero-offset
    # fields and the same-vertex graph blocks) inverted once per nonlinear
    # iteration couples the channels scalar Jacobi ignores (Offset × Angle).
    # Its sources are snapshotted here, at full precision, before the
    # coefficient narrowing below replaces the loop-resident containers.
    bp_w_packed = tuple(w_packed)
    bp_S = {key: ex["S"] for key, ex in grp_exec.items()}

    def make_block_pre(extra_diag=None):
        """Build M⁻¹ from the Δ=0 blocks (plus ``extra_diag``, a
        per-unknown diagonal such as LM's damping) and return
        ``r -> M⁻¹·r`` with the row masks applied to the output; the
        function carries ``.inv`` {ispace: [*dom, C, C]}, ``.layouts`` and
        ``.row_masks`` for the fused loop."""
        isp_layouts = dict(w_layouts)  # ispace -> (u_list, offs, ctot)

        def _layout_for(isp):
            got = isp_layouts.get(isp)
            if got is None:
                u_list = [u for u in compiled.unknown_names if isp_of[u] == isp]
                offs, o = {}, 0
                for u in u_list:
                    offs[u] = o
                    o += unknown_channels[u]
                got = (u_list, offs, o)
                isp_layouts[isp] = got
            return got

        blocks = {}

        def _block_for(isp):
            B = blocks.get(isp)
            if B is None:
                ctot = _layout_for(isp)[2]
                B = _zeros(isp.shape(compiled.dim_sizes) + (ctot, ctot))
            return B

        for (isp, delta, kind, W, oo, oi, co, ci) in bp_w_packed:
            if any(d != 0 for d in delta):
                continue
            B = _block_for(isp)
            if kind == "scalar":
                for k in range(co):
                    B[..., oo + k, oi + k] += W[..., 0]
            elif kind == "diag":
                for k in range(W.shape[-1]):
                    B[..., oo + k, oi + k] += W[..., k]
            else:
                B[..., oo : oo + co, oi : oi + ci] += W
            blocks[isp] = B

        # same-vertex graph blocks, from the group layout into the space's,
        # masked on both sides as the operator M·A(M·p) is
        for key, ex in grp_exec.items():
            gu_list, goffs, ctg = ex["layout"]
            isp = isp_of[gu_list[0]]
            B = _block_for(isp)
            woffs = _layout_for(isp)[1]
            S = bp_S[key].reshape(-1, ctg, ctg)
            pm = ex["mask"]
            if pm is not None:
                S = S * pm[:, :, None] * pm[:, None, :]
            for uo in gu_list:
                for ui in gu_list:
                    co, ci = unknown_channels[uo], unknown_channels[ui]
                    B[..., woffs[uo] : woffs[uo] + co, woffs[ui] : woffs[ui] + ci] += S[
                        :, goffs[uo] : goffs[uo] + co, goffs[ui] : goffs[ui] + ci
                    ]
            blocks[isp] = B

        inv = {}
        for isp, B in blocks.items():
            u_list, offs, ctot = isp_layouts[isp]
            if extra_diag is not None:
                for u in u_list:
                    e = extra_diag.get(u)
                    if e is None:
                        continue
                    for k in range(unknown_channels[u]):
                        B[..., offs[u] + k, offs[u] + k] += e[..., k]
            # relative diagonal regularization keeps rank-deficient blocks
            # (excluded rows, unconstrained channels) invertible; the
            # symmetrization keeps M⁻¹ SPD for CG
            dvals = torch.diagonal(B, dim1=-2, dim2=-1)
            reg = 1e-5 * dvals + FLOAT_EPSILON
            Breg = B + reg[..., :, None] * torch.eye(ctot, dtype=dt, device=X_dev)
            Minv = _gauss_jordan_inv(Breg)
            inv[isp] = 0.5 * (Minv + Minv.transpose(-1, -2))

        def pre_apply(r):
            out = {}
            for isp, Minv in inv.items():
                u_list, offs, _ctot = isp_layouts[isp]
                rp = torch.cat([r[u] for u in u_list], dim=-1) if len(u_list) > 1 else r[u_list[0]]
                z = torch.sum(Minv * rp[..., None, :], dim=-1)
                for u in u_list:
                    sl = z[..., offs[u] : offs[u] + unknown_channels[u]]
                    m = row_masks.get(u)
                    out[u] = sl if m is None else sl * m
            for u in unknown_channels:  # unknowns with no Δ=0 block
                if u not in out:
                    out[u] = r[u]
            return out

        pre_apply.inv = inv
        pre_apply.layouts = dict(isp_layouts)
        pre_apply.row_masks = row_masks
        return pre_apply

    apply_fn.block_pre = make_block_pre

    cdt = coefficient_dtype(coeff_dtype)
    if cdt is not None:
        # narrow only the loop-resident coefficient storage; apply_fn reads
        # these containers, and its products with float32 p are float32
        w_packed[:] = [
            (isp, delta, kind, W.to(cdt), oo, oi, co, ci)
            for (isp, delta, kind, W, oo, oi, co, ci) in w_packed
        ]
        for ex in grp_exec.values():
            ex["S"] = ex["S"].to(cdt)
            ex["dia"] = [(off, W.to(cdt)) for off, W in ex["dia"]]
            if ex["C"] is not None:
                ex["C"] = ex["C"].to(cdt)
        for pe in pair_exec.values():
            pe["W"] = pe["W"].to(cdt)

    if mesh is not None:
        cg_meta = plan_sharded_graph_cg(compiled, plan, fields, grp_exec, mesh, pair_exec)

        def mesh_apply(p):
            """apply_fn on the rank's blocks: the sharded loop's apply."""
            return unpack_spaces(cg_meta, graph_apply(cg_meta, pack_spaces(cg_meta, p)))

        mesh_apply.block_pre = make_block_pre
        apply_fn = mesh_apply
    elif grp_exec or pair_exec:
        cg_meta = plan_fused_graph_cg(compiled, plan, fields, grp_exec, coeff_dtype=cdt,
                                      pair_exec=pair_exec)
    else:
        cg_meta = plan_fused_grid_cg(compiled, plan, fields, w_layouts, coeff_dtype=cdt,
                                     allow_split=allow_split,
                                     dtypes=SHARDED_LOOP_DTYPES if sharded else LOOP_DTYPES)
    jtf_fn.r_terms = r_terms_primal
    return apply_fn, diag, jtf_fn, cg_meta
