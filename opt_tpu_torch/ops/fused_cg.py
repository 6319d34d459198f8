"""Whole-loop PCG for 2-D and 3-D grid and graph operators: the counterpart
of ``opt_tpu/ops/pallas_cg.py``.

The JAX package runs the whole PCG inner loop of a grid problem as one
Pallas TPU kernel (``pallas_cg.py::_kernel`` in its 2-D and 3-D grid GN,
mixed-unknown and LM forms, its Chronopoulos–Gear ``cs`` form, its
block-Jacobi ``block_pre`` form and with bfloat16 coefficient fields;
``_hbm_tiled_kernel`` for grids beyond VMEM; its ``flat1d`` DIA form and
its ``rem_pairs`` irregular remainder for graphs). Here the same loop runs
as one persistent cooperative CUDA kernel (``csrc/fused_grid_cg.cuh``: one
template whose instances are GN or LM, standard or Chronopoulos–Gear,
Jacobi or block-Jacobi, float32 or bfloat16 fields, each with and without
the remainder phase, each in a one-system, a multi-system and a batch form)
for CUDA tensors, and as its plain PyTorch twin
(:func:`fused_grid_cg_reference`) for CPU tensors or on request.

The operator is expressed as per-channel-pair triples over the packed
unknown channels: (JᵀJ·p)[q, i] = Σ_t F_t[q] · p[q + Δ_t, j_t] for triples
t = (Δ, i, j, field) derived from the assembled coefficient fields. The
in-bounds mask of each offset is folded into its field (F' = F · M_Δ), so a
read that leaves the grid multiplies zero: the twin reads through a
zero-padded shift, the kernel skips it. A graph's vertex axis is the grid
[1, N]: its same-vertex blocks are Δ = (0, 0) triples and its DIA offsets
(0, d) triples. What no offset covers is the remainder, a destination-
sorted block CSR (rowptr [N+1], col [nnz], blk [nnz, C, C]) added as
(A·p)[i, v] += Σ_k Σ_j blk[k, i, j] · p[j, col[k]] over row v's entries.
A coefficient dtype (bfloat16) narrows F and blk after the masks are
folded; the loop widens them exactly and multiplies in float32.

:func:`_run_cg` holds the loop algebra (the GN and LM bodies of the JAX
package's ``_run_cg``: guarded α/β; GN exits on rᵀz ≤ tol·rᵀz₀ or pᵀAp ≤ 0;
LM adds CtC·p to the apply, resets r = b − A·δ every ``reset_period``
iterations and exits on ζ < q_tol or the rᵀz floor; and its
Chronopoulos–Gear bodies, whose stop test runs before the update and
leaves that iteration uncounted). The preconditioner is elementwise, or
the per-point block apply z[i] = Σ_j M⁻¹[i·C+j]·r[j]. The twin and the
solver's eager loop both run it, and the kernel implements the same steps,
so exits and counted iterations agree by construction.

The per-channel split (the JAX package's ``chan_grid`` form): where every
coupling is channel-diagonal with channel-identical fields, the C channels
are C independent one-channel systems over shared fields. One launch then
holds ``n_sys`` = C systems, solved one after the other inside the kernel,
each with its own dot products, its own exit and its own iteration count
(``iters[s]``); the counts are summed for the solver. The planner splits
when the joint loop's working set exceeds :data:`SPLIT_WORKING_SET_BYTES`
(the card's L2) and one channel's does not, so each system's loop runs out
of L2 where the joint loop would stream from device memory.

The batch axis (the JAX package's ``_kernel`` under ``jax.vmap``, which
``Plan.solve_batched`` reaches): a batched meta has ``"batch": B`` and F
[B, T, *dom], the triples, channels and layout of one instance, and the
vectors carry a leading batch axis. The B systems are independent, each
with its own fields, exit and count (``iters`` [B]); a remainder's CSR is
shared and its blocks are per system (blk [B, nnz, C, C]), as are the
block preconditioner's planes ([B, C·C, *dom]). A small system runs in the
BATCH instances, one block a system, all side by side; a larger one in the
MULTI instances with the fields' and the blocks' per-system strides, one
system after the other (:func:`batched_kernel_form`). Small systems under
the standard GN or LM loop with the Jacobi preconditioner and float32
fields, without the remainder, take the batch kernel instead
(:func:`batch_team_plan`, ``csrc/tiled_batch_cg.cu``: ``gn_batch_tiled``,
``lm_batch_tiled``), a team of lanes of one warp a system, each system's
fields and state in its team's slice of shared memory for the whole loop.

The tiled route: where one system's state fits the card's shared memory at
one tile a block (:func:`tiled_grid_plan`: a 2-D grid, no remainder; the
standard GN or LM loop with float32 fields and the elementwise or the
block preconditioner, or with bfloat16 fields and the elementwise one; or
the Chronopoulos–Gear loop with float32 fields and the elementwise one;
the split and a batch in the multi form, :func:`route_plan`, only under
the standard loop with float32 fields), :func:`fused_grid_cg_kernel`
launches ``csrc/tiled_grid_cg.cu`` (launches ``gn_tiled``, ``lm_tiled``,
``gn_bf16_tiled``, ``lm_bf16_tiled``, ``gn_bj_tiled``, ``lm_bj_tiled``,
and for several systems in turn ``gn_multi_tiled`` and ``lm_multi_tiled``,
the split's one-channel systems or a batch's, and ``gn_bj_multi_tiled``
and ``lm_bj_multi_tiled``, a batch under block-Jacobi) or
``csrc/tiled_grid_cs.cu`` (``gn_cs_tiled``, ``lm_cs_tiled``: one grid
barrier an iteration) instead of the template: each block keeps its
tile's state (and under block-Jacobi its C·C planes) in shared memory for
the whole solve and only r's border (Chronopoulos–Gear: w's) goes through
device memory. Where that state does not fit but r over the tile and p
over its halo do, a one-system standard GN or LM launch with float32
fields, the elementwise preconditioner and up to ``HBM_MAX_CHANNELS``
channels takes the same kernel in its "hbm" layout (``gn_hbm_tiled``,
``lm_hbm_tiled``: δ and Ap in a device frame a block; image_warping
1024²×3, the JAX package's ``_hbm_tiled_kernel`` case). poisson 2048²×4
fits neither layout and keeps the template. A graph meta with the remainder takes the graph kernel
instead (:func:`graph_tile_plan`, ``csrc/tiled_graph_cg.cu``:
``gn_rem_tiled``, ``lm_rem_tiled``, ``gn_rem_multi_tiled``,
``lm_rem_multi_tiled``), one contiguous vertex range a block under a
partition built once per topology; a one-system graph meta without the
remainder (the DIA-only form, arap on a grid mesh) takes it too, in its
"stream" layout, whose fields are read from device memory every
iteration (``gn_dia_tiled``, ``lm_dia_tiled``). A one-system float32 GN
launch on a 3-D grid [N0, N1, N2] (N0 > 1) with the Jacobi or the
block-Jacobi preconditioner takes the 3-D grid kernel
(:func:`tiled_vol_plan`, ``csrc/tiled_vol_cg.cu``: ``gn_vol_tiled``,
``gn_bj_vol_tiled``), one box a block with the box's fields staged in
shared memory once a solve, where they fit (volumetric 32³×6; not 64³).
All are bitwise equal to the template and to the twin, so the route
changes no result.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from typing import Dict, Optional

import numpy as np
import torch

from .shift import in_bounds_mask, shift

# per-kernel capacity of the CUDA sources (csrc/fused_grid_cg.cuh,
# csrc/tiled_grid_cg.cu)
MAX_TRIPLES = 512
MAX_CHANNELS = 64
# the tiled kernel's hbm layout: each thread holds a point's values of every
# channel in registers (csrc/tiled_grid_cg.cu, TG_FRAME_CHUNK)
HBM_MAX_CHANNELS = 4
BLOCK_THREADS = 256
# the tiled kernel's block: one a tile, one tile an SM, so 512 threads leave
# each up to 128 registers
TILED_THREADS = 512
# The H100 SXM's SMs and the shared memory a block may opt in to (bytes):
# the card the kernels are built for (sm_90a), whose numbers decide the
# route for tensors off the card (which the launchers then refuse).
SM90_LIMITS = (132, 232448)
CG_VARIANTS = ("standard", "chronopoulos_gear")


COEFFICIENT_DTYPES = (torch.bfloat16, torch.float32)  # the fields the kernel reads
# The solve dtypes whose operator the planners give the fused loop. The
# kernels take float32; the plain twin computes in its inputs' dtype, so a
# float64 entry here runs the twin in float64 (how the parity tests hold
# the fused loop to the JAX package's float64 solve).
LOOP_DTYPES = (torch.float32,)
# The solve dtypes whose grid operator the planner gives the sharded loop
# (ops/sharded_cg.py): K5 has a float64 instance, and the loop's vector
# algebra runs in its vectors' dtype, so a float64 plan on a mesh keeps
# the assembled operator (a float64 plan off a mesh runs the eager loop).
SHARDED_LOOP_DTYPES = (torch.float32, torch.float64)
# The per-channel split engages when the CG loop's working set (7 state
# planes per channel plus the fields) is beyond this many bytes and one
# channel's is not: the H100's 50 MiB L2. poisson 1024x1024x4 (132 MiB
# joint, 48 MiB a channel) splits; poisson 512x512x4 (33 MiB) does not.
SPLIT_WORKING_SET_BYTES = 50 * 2**20
STATE_PLANES_PER_CHANNEL = 7  # b, pre, delta, r, p, Ap and one more (ctc or z)
# A batched system of at most this many values an iteration
# (batched_kernel_form: its elements, channels x points, plus its remainder
# blocks' and block preconditioner's values) runs in the BATCH instances,
# one block of BLOCK_THREADS threads a system, all systems side by side; a
# larger one in the MULTI instances, in turn. Set
# from chip_smoke.py::form_sweep on an H100 (PERF.md): 4 laplacian systems,
# 50 GN iterations, device ms of the BATCH and the MULTI launch: 0.17 and
# 1.38 at 256 elements a system, 0.45 and 1.38 at 1024, 1.68 and 1.39 at
# 4096, 7.1 and 1.5 at 16384. A block's time grows with its system, the
# MULTI launch's with the number of systems, so a batch of 4, the fewest
# this form is for, sets the switch: below the crossover near 3300. The
# bench's curve fit (2 elements) and 4 x laplacian 16x16 (256) fall under
# it, 4 x poisson 512x512x4 (1 M) over it.
BATCH_BLOCK_ELEMS = 2048
# the batch kernel (csrc/tiled_batch_cg.cu): a block is one warp, a system
# a team of up to BATCH_TEAM_LANES of its lanes; its static shared memory
# holds the triples' offsets (five ints a triple) and the channels' starts
BATCH_TEAM_LANES = 32
BATCH_TEAM_STATIC_SMEM = 4 * (5 * MAX_TRIPLES + MAX_CHANNELS + 1)
# the most elements a lane of the batch kernel walks: the template's block
# a system, whose 256 threads walk fewer, was faster from 1,024 elements a
# system (32 a lane) and the team kernel up to 900 (29 a lane), 4 x
# laplacian GN on the H100 (chip_smoke.py::form_sweep; PERF.md, Findings), so
# systems of more than 31 elements a lane keep the template's "batch" form
BATCH_TEAM_LANE_ELEMS = 31


def coefficient_dtype(coeff_dtype) -> Optional[torch.dtype]:
    """InitializationParameters.coefficient_dtype as a torch dtype: None
    (the solve dtype), or bfloat16 or float32, by name or as a torch dtype."""
    if coeff_dtype is None:
        return None
    dt = getattr(torch, coeff_dtype, None) if isinstance(coeff_dtype, str) else coeff_dtype
    if dt not in COEFFICIENT_DTYPES:
        raise ValueError(
            "coefficient_dtype must be None, 'bfloat16' or 'float32' (or that torch "
            f"dtype), got {coeff_dtype!r}"
        )
    return dt


def _widen(x):
    """A bfloat16 coefficient widened to float32 (exactly); any other dtype
    as it is."""
    return x.float() if x.dtype == torch.bfloat16 else x


def _narrow(F, coeff_dtype):
    dt = coefficient_dtype(coeff_dtype)
    return F.contiguous() if dt is None else F.to(dt).contiguous()


def split_triples(triples, ctot: int):
    """The one-channel triples (Δ, 0, 0, fid) of a channel-separable
    operator, or None: every triple couples a channel with itself, and
    every channel has the same set of (Δ, fid)."""
    if ctot < 2 or any(i != j for (_d, i, j, _f) in triples):
        return None
    by_chan = {}
    for d, i, _j, fid in triples:
        by_chan.setdefault(i, set()).add((d, fid))
    if len(by_chan) != ctot or len({frozenset(v) for v in by_chan.values()}) != 1:
        return None
    return tuple(sorted((d, 0, 0, fid) for (d, fid) in next(iter(by_chan.values()))))


def plan_fused_grid_cg(compiled, plan, fields: Dict, w_layouts: Dict,
                       coeff_dtype=None, allow_split: bool = True,
                       dtypes=LOOP_DTYPES) -> Optional[Dict]:
    """Decide applicability from the assembled operator and build the loop's
    inputs: exactly one 2-D or 3-D index space holding every unknown, of a
    solve dtype in ``dtypes`` (the sharded loop's: SHARDED_LOOP_DTYPES).
    Returns {u_list, offs, channels, ctot, chan_grid, triples,
    F [T, *dom], rem, isp} or None. The in-bounds masks are folded into F,
    which is then stored in ``coeff_dtype`` (None: float32). ``chan_grid``
    says that the channels are solved as independent one-channel systems
    (the module docstring's split; ``triples`` are then one channel's);
    ``allow_split=False`` (a block preconditioner couples the channels)
    keeps the joint loop."""
    if not fields or compiled.dtype not in dtypes or len(w_layouts) != 1:
        return None
    ((isp, (u_list, offs, ctot)),) = w_layouts.items()
    if isp.ndim not in (2, 3) or sorted(compiled.unknown_names) != sorted(u_list):
        return None
    dom = isp.shape(compiled.dim_sizes)
    channels = {u: compiled.unknown_shape(u)[-1] for u in u_list}
    field_list, triples, masks = [], [], {}
    for (u_out, u_in, delta, i, j), f in sorted(fields.items()):
        m = masks.get(delta)
        if m is None:
            m = in_bounds_mask(dom, delta, dtype=f.dtype, device=f.device)[..., 0]
            masks[delta] = m
        fid = len(field_list)
        field_list.append(f * m)
        d = tuple(int(o) for o in delta)
        if (u_out, u_in, delta) in plan.scalar_groups:
            # channel-identical diagonal: one field, C triples
            for c in range(channels[u_out]):
                triples.append((d, offs[u_out] + c, offs[u_in] + c, fid))
        else:
            triples.append((d, offs[u_out] + i, offs[u_in] + j, fid))
    F = _narrow(torch.stack(field_list, dim=0), coeff_dtype)
    chan_grid = False
    plane_bytes = 4 * int(torch.Size(dom).numel())
    f_bytes = F.numel() * F.element_size()
    if allow_split and (STATE_PLANES_PER_CHANNEL * ctot * plane_bytes + f_bytes
                        > SPLIT_WORKING_SET_BYTES):
        one = split_triples(triples, ctot)
        if one is not None and (STATE_PLANES_PER_CHANNEL * plane_bytes + f_bytes
                                <= SPLIT_WORKING_SET_BYTES):
            chan_grid, triples = True, one
    return {
        "u_list": tuple(u_list),
        "offs": dict(offs),
        "channels": channels,
        "ctot": ctot,
        "chan_grid": chan_grid,
        "triples": tuple(triples),
        "F": F,
        "rem": None,
        "isp": isp,
    }


def _centered_triples(compiled, plan) -> int:
    """The triples the centred fields of ``plan`` (fit terms) take."""
    n = 0
    for (u_out, u_in, delta, i, j) in plan.w_spec:
        if (u_out, u_in, delta) not in plan.scalar_groups:
            n += 1
        elif (i, j) == (0, 0):
            n += compiled.unknown_shape(u_out)[-1]
    return n


def graph_dia_offset_cap(compiled, plan) -> int:
    """How many DIA offsets each graph group may take so that the kernel's
    triple table holds the whole operator: every offset and every group's
    same-vertex blocks take ctot² triples, the centred fields theirs, and
    the groups on the unknowns' vertex space share what is left. The reads
    of the offsets beyond it join the remainder (graph_group_tables)."""
    ctot = sum(compiled.unknown_shape(u)[-1] for u in compiled.unknown_names)
    spaces = {compiled.registry.images[u].ispace for u in compiled.unknown_names}
    groups = sum(len(spaces & set(g.slots.values())) for g in compiled.registry.graphs.values())
    if not groups or ctot > MAX_CHANNELS:
        return 0
    free = MAX_TRIPLES - _centered_triples(compiled, plan) - groups * ctot * ctot
    return max(free // (groups * ctot * ctot), 0)


def _merge_remainders(parts, n: int):
    """One destination-sorted CSR from several groups' (rowptr, col, blk,
    row, partitions): each row's entries group by group, in group order. A
    single group's CSR keeps its :class:`GraphPartitions`, which the graph
    route needs; a merged one is built anew every step, has none and keeps
    the template."""
    if len(parts) == 1:
        rowptr, col, blk, _row, partitions = parts[0]
        return {"rowptr": rowptr, "col": col, "blk": blk.contiguous(),
                "partitions": partitions}
    row = torch.cat([p[3] for p in parts])
    order = torch.argsort(row, stable=True)
    rowptr = torch.zeros(n + 1, dtype=torch.int64, device=row.device)
    rowptr[1:] = torch.cumsum(torch.bincount(row, minlength=n), 0)
    return {
        "rowptr": rowptr.to(torch.int32),
        "col": torch.cat([p[1] for p in parts])[order].contiguous(),
        "blk": torch.cat([p[2] for p in parts])[order].contiguous(),
    }


def plan_fused_graph_cg(compiled, plan, fields: Dict, grp_exec: Dict,
                        coeff_dtype=None, pair_exec=None) -> Optional[Dict]:
    """The loop's inputs for a graph problem whose unknowns all live on one
    1-D vertex space, float32: the same-vertex blocks S and the DIA fields
    of every group as triples on the grid [1, N], the centered fields of
    that space (fit terms) likewise, and the groups' remainders merged into
    the kernel's block CSR. A group may cover only some of the unknowns:
    its channels map into the kernel's, its remainder blocks are zero
    outside its rows and columns, and a channel no group covers keeps only
    its centred triples. Each group's row mask is folded into its
    fields and blocks on both sides (M·A·M); then F and the remainder's
    blocks are stored in ``coeff_dtype`` (None: float32). Returns the meta
    or None: the operator couples slots of different vertex spaces
    (``pair_exec``, the assembly's per-pair ELL blocks, which the kernel has
    no form for; the JAX package's planner refuses them too), the unknowns
    span several spaces, or it has more triples or channels than the
    kernel holds. A meta without the remainder carries
    under ``"empty_csr"`` the first group's empty CSR (``graph_group_tables``'s
    entry of that name: rowptr, col and its :class:`GraphPartitions`), by
    which the graph route partitions it; ``"rem"`` stays None."""
    if pair_exec or not grp_exec or compiled.dtype not in LOOP_DTYPES:
        return None
    u_list = list(compiled.unknown_names)
    isps = {compiled.registry.images[u].ispace for u in u_list}
    if len(isps) != 1:
        return None
    (isp,) = isps
    if isp.ndim != 1:
        return None
    (N,) = isp.shape(compiled.dim_sizes)
    channels = {u: compiled.unknown_shape(u)[-1] for u in u_list}
    offs, ctot = {}, 0
    for u in u_list:
        offs[u] = ctot
        ctot += channels[u]
    field_list, triples, bounds = [], [], {}
    device = next(iter(grp_exec.values()))["S"].device

    def _bounds(d):
        if d not in bounds:
            bounds[d] = in_bounds_mask((N,), (d,), dtype=torch.float32, device=device)[..., 0]
        return bounds[d]

    def _emit(col, d, i, j):
        triples.append(((0, int(d)), i, j, len(field_list)))
        field_list.append(col)

    for (u_out, u_in, delta, i, j), f in sorted(fields.items()):
        (d,) = delta
        fm = f * _bounds(d) if d else f
        if (u_out, u_in, delta) in plan.scalar_groups:
            fid = len(field_list)
            field_list.append(fm)
            for c in range(channels[u_out]):
                triples.append(((0, int(d)), offs[u_out] + c, offs[u_in] + c, fid))
        else:
            _emit(fm, d, offs[u_out] + i, offs[u_in] + j)

    rem_parts, empties = [], []
    for key, ex in sorted(grp_exec.items()):
        g_ulist, g_offs, ct = ex["layout"]
        if ex["S"].shape[0] != N:
            return None  # the group is not on the kernel's vertex space
        gmap = [0] * ct  # group channel -> kernel channel
        for u in g_ulist:
            for c in range(channels[u]):
                gmap[g_offs[u] + c] = offs[u] + c
        pm = ex["mask"]
        S = _widen(ex["S"])
        for i in range(ct):
            for j in range(ct):
                col = S[:, i * ct + j]
                if pm is not None:
                    col = col * pm[:, i] * pm[:, j]
                _emit(col, 0, gmap[i], gmap[j])
        for off, W in ex["dia"]:
            pm_s = shift(pm, (off,)) if pm is not None else None
            for i in range(ct):
                for j in range(ct):
                    col = _widen(W[:, i * ct + j]) * _bounds(off)
                    if pm is not None:
                        col = col * pm[:, i] * pm_s[:, j]
                    _emit(col, off, gmap[i], gmap[j])
        if ex["C"] is not None:
            csr = ex["tables"]["csr"]
            blk = _widen(ex["C"]).reshape(-1, ct, ct)[csr["src"]]  # [nnz, ct, ct]
            if pm is not None:
                blk = blk * pm[csr["row"]][:, :, None] * pm[csr["col"].long()][:, None, :]
            if gmap != list(range(ctot)):
                # into the kernel's channels; zero outside the group's
                gm = torch.as_tensor(gmap, device=blk.device)
                full = blk.new_zeros((blk.shape[0], ctot, ctot))
                full[:, gm[:, None], gm[None, :]] = blk
                blk = full
            rem_parts.append((csr["rowptr"], csr["col"], blk, csr["row"], csr["partitions"]))
        else:
            empties.append(ex["tables"]["empty_csr"])
    if not field_list or len(triples) > MAX_TRIPLES or ctot > MAX_CHANNELS:
        return None
    rem = _merge_remainders(rem_parts, N) if rem_parts else None
    if rem is not None:
        rem["blk"] = _narrow(rem["blk"], coeff_dtype)
    F = torch.stack(field_list, dim=0).reshape(len(field_list), 1, N)
    return {
        "u_list": tuple(u_list),
        "offs": offs,
        "channels": channels,
        "ctot": ctot,
        "chan_grid": False,
        "triples": tuple(triples),
        "F": _narrow(F, coeff_dtype),
        "rem": rem,
        "empty_csr": empties[0] if rem is None else None,
        "isp": isp,
    }


def _lin(a, x, y):
    """y + a·x over tensors or dicts of tensors (a: a float or 0-dim tensor)."""
    if isinstance(x, dict):
        return {k: y[k] + a * x[k] for k in y}
    return y + a * x


def _zeros_like(x):
    if isinstance(x, dict):
        return {k: torch.zeros_like(v) for k, v in x.items()}
    return torch.zeros_like(x)


def safe_div(num, den, guard_div: bool):
    """α/β division, guarded to 0 where den <= 0 (guardDivisionByZero,
    solverGPUGaussNewton.t:17, t:457, t:545)."""
    if not guard_div:
        return num / den
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)


def _run_cg(b, apply, prec, dot, lits: int, tol: float, *, guard_div: bool,
            reset_period: Optional[int] = None, q_tol: Optional[float] = None,
            cs: bool = False, trace: Optional[list] = None, dots=None):
    """The shared PCG loop over abstract ``apply``/``prec``/``dot`` (vectors
    are tensors or dicts of tensors). With ``reset_period`` it runs the LM
    body (``apply`` then includes + CtC·p): r = b − A·δ every
    ``reset_period`` iterations, Q1 = ½⟨δ, b + r⟩, ζ = (l+1)(Q1 − Q0)/Q1,
    exit on ζ < ``q_tol`` or the rᵀz floor, and no pᵀAp ≤ 0 exit. ``cs``
    runs the Chronopoulos–Gear bodies instead (:func:`_run_cs`).
    Returns (delta, iterations executed). The host reads one flag per
    iteration to exit, so exits and counts match the on-device loop
    exactly. A ``trace`` list receives (l, rᵀz, floor, ζ or None) after
    each iteration. ``dots`` maps a list of (x, y) pairs to their dots, as
    ``dot`` one by one does by default: the dots taken at one point of an
    iteration (LM's rᵀz and Q; the Chronopoulos–Gear γ, δ and Q) go to it
    together, so a sharded loop reduces them in one all_reduce."""
    lm = reset_period is not None
    if dots is None:
        dots = lambda pairs: [dot(x, y) for x, y in pairs]  # noqa: E731
    if lm and int(reset_period) < 1:
        raise ValueError(f"residual_reset_period must be >= 1, got {reset_period}")
    r = b
    p = prec(r)
    rz = dot(r, p)
    floor = tol * rz
    lits = int(lits)
    if cs:
        return _run_cs(b, apply, prec, dots, lits, floor, rz, guard_div=guard_div,
                       reset_period=reset_period, q_tol=q_tol, trace=trace)
    delta = _zeros_like(b)
    Q0 = torch.zeros_like(rz)
    l = 0
    while l < lits:
        Ap = apply(p)
        den = dot(p, Ap)
        alpha = safe_div(rz, den, guard_div)
        delta = _lin(alpha, p, delta)
        if lm and (l + 1) % reset_period == 0:
            r = _lin(-1.0, apply(delta), b)  # drift cancellation (t:491-534)
        else:
            r = _lin(-alpha, Ap, r)
        z = prec(r)
        if lm:
            rz_new, q = dots([(z, r), (delta, _lin(1.0, r, b))])
        else:
            rz_new = dot(z, r)
        beta = safe_div(rz_new, rz, guard_div)
        p = _lin(beta, p, z)
        rz = rz_new
        l += 1
        zeta = None
        if lm:
            Q1 = 0.5 * q  # t:478-481
            zeta = (l * (Q1 - Q0)) / Q1
            stop = (zeta < q_tol) | (rz_new <= floor)
            Q0 = Q1
        else:
            stop = (rz_new <= floor) | (den <= 0)
        if trace is not None:
            trace.append((l, rz_new, floor, zeta))
        if bool(stop):
            break
    return delta, l


def _run_cs(b, apply, prec, dots, lits: int, floor, rz0, *, guard_div: bool,
            reset_period=None, q_tol=None, trace=None):
    """Chronopoulos–Gear (the JAX package's gn_cs_body / lm_cs_body and
    cs_pipeline): u = M⁻¹r, w = A·u, γ = ⟨r, u⟩ and δ = ⟨u, w⟩ (and under LM
    Q = ½⟨δ, b + r⟩) from the same vectors, so the dots of an iteration are
    independent. β = γ/γ_prev (0 on the first iteration), the step
    denominator δ − β·γ/α_prev (δ on the first), p = u + β·p, s = w + β·s.
    The rᵀz floor (LM: or ζ = l·(Q − Q0)/Q < q_tol) is tested before the
    update, from the second iteration on, and stops the loop with that
    iteration uncounted; a denominator ≤ 0 stops it after the update.
    Under LM, r = b − A·δ after each ``reset_period``-th counted update.
    ``dots`` as in :func:`_run_cg`: an iteration's dots go to it at once."""
    lm = reset_period is not None
    r = b
    delta, p, s = _zeros_like(b), _zeros_like(b), _zeros_like(b)
    gamma = alpha_prev = torch.ones_like(rz0)
    zero = torch.zeros_like(rz0)
    Q0 = zero
    l = 0
    while l < lits:
        u = prec(r)
        w = apply(u)
        pairs = [(r, u), (u, w)] + ([(delta, _lin(1.0, r, b))] if lm else [])
        gamma_new, delta_d, *q = dots(pairs)
        first = l == 0
        zeta = None
        if lm:
            Q = 0.5 * q[0]
            zeta = (l * (Q - Q0)) / Q
            stop = (gamma_new <= floor) | (zeta < q_tol)
        else:
            stop = gamma_new <= floor
        beta = zero if first else safe_div(gamma_new, gamma, guard_div)
        den = delta_d - beta * safe_div(gamma_new, alpha_prev, guard_div)
        used_den = delta_d if first else den
        stop_now, bad_den = torch.stack([stop, used_den <= 0]).tolist()
        stop_now = stop_now and not first
        if trace is not None:
            trace.append((l, gamma_new, floor, zeta))
        if stop_now:
            break
        alpha = safe_div(gamma_new, used_den, guard_div)
        p = _lin(beta, p, u)
        s = _lin(beta, s, w)
        delta = _lin(alpha, p, delta)
        r = _lin(-alpha, s, r)
        l += 1
        gamma, alpha_prev = gamma_new, alpha
        if lm:
            Q0 = Q
        if bad_den:
            break
        if lm and l % reset_period == 0:
            r = _lin(-1.0, apply(delta), b)  # t:491-534
    return delta, l


def _stencil_apply(F, triples, p):
    """(A·p)[i] = Σ_t F[fid_t] · p[j_t] read at offset Δ_t, zero-padded
    (F float32: a narrowed field is widened before the call)."""
    acc = [None] * p.shape[0]
    rolled = {}
    for delta, i, j, fid in triples:
        pk = rolled.get((delta, j))
        if pk is None:
            pk = shift(p[j], delta)
            rolled[(delta, j)] = pk
        t = F[fid] * pk
        acc[i] = t if acc[i] is None else acc[i] + t
    zeros = torch.zeros(p.shape[1:], dtype=p.dtype, device=p.device)
    return torch.stack([a if a is not None else zeros for a in acc])


def _remainder_apply(rem, p, acc):
    """acc + the remainder term on packed [C, *dom] tensors: for each
    vertex v, Σ_k Σ_j blk[k, i, j] · p[j, col[k]] over its CSR entries,
    summed in the kernel's order (entries ascending, then j): step k adds
    entry rowptr[v] + k of every row that has one."""
    C = p.shape[0]
    flat = p.reshape(C, -1)
    out = acc.reshape(C, flat.shape[1])
    start = rem["rowptr"][:-1].long()
    count = rem["rowptr"][1:].long() - start
    col = rem["col"].long()
    blk = _widen(rem["blk"])
    for k in range(int(count.max()) if count.numel() else 0):
        live = k < count
        e = torch.where(live, start + k, 0)
        B = blk[e]  # [N, C, C]
        pu = flat[:, col[e]]  # [C, N]
        for j in range(C):
            out = torch.where(live, out + B[:, :, j].T * pu[j], out)
    return out.reshape(acc.shape)


def _operator_apply(F, triples, rem, p):
    """(A·p): the stencil triples, then the remainder where there is one."""
    acc = _stencil_apply(F, triples, p)
    return acc if rem is None else _remainder_apply(rem, p, acc)


def _dot(x, y):
    """⟨x, y⟩ as the kernel takes it: float32 products summed in float64,
    rounded to float32. LM's ζ = l·(Q1 − Q0)/Q1 is a difference of two such
    sums, so a float32 sum would move it by more than its distance to
    q_tol and change where the loop exits."""
    return torch.sum(x * y, dtype=torch.float64).to(x.dtype)


def _block_prec(pre_blocks):
    """r -> z with z[i] = Σ_j M⁻¹[i·C+j] · r[j] at every point, summed from
    0 over j ascending, as the kernel's block apply (packed [C·C, *dom]
    blocks, [C, *dom] vectors)."""
    def prec(r):
        C = r.shape[0]
        out = []
        for i in range(C):
            a = torch.zeros_like(r[0])
            for j in range(C):
                a = a + pre_blocks[i * C + j] * r[j]
            out.append(a)
        return torch.stack(out)

    return prec


def _systems_reference(F, triples, b, pre, lits, tol, n_sys, counts, *, batched,
                       ctc=None, rem=None, pre_blocks=None, **kw):
    """The twin over ``n_sys`` independent systems, in system order:
    :func:`_run_cg` once per system, each with its own exit. ``batched``:
    system k is instance k of a batch (F [B, T, *dom], b, pre, ctc
    [B, C, *dom], pre_blocks [B, C·C, *dom], the remainder's blocks
    [B, nnz, C, C] over one shared CSR); else the per-channel split, system
    k the k-th [C / n_sys, *dom] slice of b, pre and ctc over the shared F
    (no remainder, no block preconditioner). Returns (delta, the summed
    count); ``counts`` receives each system's."""
    if batched:
        if n_sys != int(b.shape[0]) or n_sys != int(F.shape[0]):
            raise ValueError(f"fused_grid_cg: a batch of {n_sys} systems needs F and b with "
                             f"that leading axis, got {tuple(F.shape)} and {tuple(b.shape)}")

        def one(k):
            rk = None if rem is None else dict(rem, blk=rem["blk"][k])
            return fused_grid_cg_reference(
                F[k], triples, b[k], None if pre is None else pre[k], lits, tol,
                ctc=None if ctc is None else ctc[k],
                rem=rk, pre_blocks=None if pre_blocks is None else pre_blocks[k], **kw)
    else:
        C = int(b.shape[0])
        if n_sys < 1 or C % n_sys:
            raise ValueError(f"fused_grid_cg: {C} channels do not split into {n_sys} systems")
        if rem is not None or pre_blocks is not None:
            raise ValueError("fused_grid_cg: the split form takes no remainder and no block "
                             "preconditioner")
        cs_ = C // n_sys

        def one(k):
            sl = slice(k * cs_, (k + 1) * cs_)
            return fused_grid_cg_reference(F, triples, b[sl], pre[sl], lits, tol,
                                           ctc=None if ctc is None else ctc[sl], **kw)
    deltas, total = [], 0
    for k in range(n_sys):
        d, l = one(k)
        deltas.append(d)
        total += l
        if counts is not None:
            counts.append(l)
    return (torch.stack if batched else torch.cat)(deltas), total


def fused_grid_cg_reference(F, triples, b, pre, lits, tol, *, guard_div=True,
                            ctc=None, reset_period=None, q_tolerance=None, trace=None,
                            rem=None, cs=False, pre_blocks=None, n_sys=1, counts=None,
                            batched=False):
    """Plain PyTorch twin of the CUDA kernel on packed [C, *dom] tensors:
    the same algebra through :func:`_run_cg`, with the kernel's dot
    products (:func:`_dot`); ``rem`` (a meta's ``"rem"``) adds the graph
    remainder to the apply; passing ``ctc`` (with ``reset_period`` and
    ``q_tolerance``) runs the LM loop; ``cs`` the Chronopoulos–Gear loop;
    ``pre_blocks`` (packed [C·C, *dom], :func:`pack_pre_blocks`) the block
    preconditioner in place of the elementwise ``pre``. A bfloat16 F or
    remainder is widened to float32 (exact) and multiplied in float32.
    ``trace`` as in :func:`_run_cg`. ``n_sys`` > 1 solves that many
    independent systems of C / n_sys channels each over the shared F (the
    split form; ``triples`` are one system's), each with its own exit; the
    iterations returned are then the sum, and a ``counts`` list receives
    each system's. ``batched`` takes the n_sys systems from a leading batch
    axis of F and of every vector instead (a batched meta: system k is
    instance k, with its own fields). Returns (delta, iterations)."""
    if n_sys != 1 or batched:
        return _systems_reference(
            F, triples, b, pre, lits, tol, int(n_sys), counts, batched=batched,
            guard_div=guard_div, ctc=ctc, reset_period=reset_period, q_tolerance=q_tolerance,
            trace=trace, rem=rem, cs=cs, pre_blocks=pre_blocks)
    F = _widen(F)
    if ctc is None:
        apply = lambda p: _operator_apply(F, triples, rem, p)  # noqa: E731
        reset_period = q_tolerance = None
    else:
        apply = lambda p: _operator_apply(F, triples, rem, p) + ctc * p  # noqa: E731
        if reset_period is None or q_tolerance is None:
            raise ValueError("the LM loop needs reset_period and q_tolerance")
    prec = _block_prec(pre_blocks) if pre_blocks is not None else (lambda r: pre * r)
    return _run_cg(
        b, apply, prec, _dot, lits, tol, guard_div=guard_div,
        reset_period=reset_period, q_tol=q_tolerance, cs=cs, trace=trace,
    )


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=32)
def _device_triples(triples, ctot: int, device):
    """Triples sorted stably by output channel as int32 [n, 6] rows
    (d0, d1, d2, i, j, fid) on the domain [N0, N1, N2] (a 2-D offset
    (a, b) is (0, a, b)), plus the per-channel row starts [ctot + 1], on
    the device. Cached by value: a plan's triples are the same every GN
    step, and each upload would stall the host on a device copy."""
    rows = [(0,) * (3 - len(d)) + tuple(d) + (i, j, fid)
            for (d, i, j, fid) in sorted(triples, key=lambda t: t[1])]
    starts = [0] * (ctot + 1)
    for row in rows:
        starts[row[3] + 1] += 1
    for c in range(ctot):
        starts[c + 1] += starts[c]
    return (
        torch.tensor(rows, dtype=torch.int32).reshape(-1, 6).to(device),
        torch.tensor(starts, dtype=torch.int32).to(device),
    )


def instance_name(lm: bool, rem: bool, cs: bool = False, block: bool = False,
                  bf16: bool = False, multi: bool = False, batch: bool = False,
                  tiled: bool = False, hbm: bool = False, dia: bool = False,
                  vol: bool = False) -> str:
    """The kernel instance's name: "gn" or "lm", then "_cs" for
    Chronopoulos–Gear, "_bj" for block-Jacobi, "_bf16" for bfloat16 fields,
    "_rem" with the remainder phase, "_multi" for the instances whose
    cooperative launch holds several independent systems in turn (the
    per-channel split, a batch of large systems), "_batch" for those
    whose launch holds them side by side, one block each (a batch of small
    systems), "_dia" for the graph kernel's launches on a remainder-less
    graph (its stream layout: the fields read from device memory), "_hbm"
    for the tiled kernel's hbm layout (δ and Ap in device memory), "_vol"
    for the 3-D grid kernel's (csrc/tiled_vol_cg.cu: the fields staged in
    shared memory, one box a block), and "_tiled" for the tiled kernels'
    (csrc/tiled_grid_cg.cu, csrc/tiled_graph_cg.cu, csrc/tiled_vol_cg.cu)."""
    return (("lm" if lm else "gn") + ("_cs" if cs else "") + ("_bj" if block else "")
            + ("_bf16" if bf16 else "") + ("_rem" if rem else "")
            + ("_multi" if multi else "") + ("_batch" if batch else "")
            + ("_dia" if dia else "") + ("_hbm" if hbm else "") + ("_vol" if vol else "")
            + ("_tiled" if tiled else ""))


# (lm, rem, cs, block, bf16, multi, batch): every combination of the five
# flags in each of the three forms (one system, multi, batch)
INSTANCES = tuple(
    (lm, rem, cs, block, bf16, multi, batch)
    for multi, batch in ((False, False), (True, False), (False, True))
    for lm in (False, True) for cs in (False, True) for block in (False, True)
    for bf16 in (False, True) for rem in (False, True)
)
# the tiled grid kernel's six launch names, as instance_name's flags (tiled
# last): GN and LM with the elementwise preconditioner, with block-Jacobi,
# and with block-Jacobi over a batch's systems in turn (the block-Jacobi
# kernel's launches on a batched meta)
TILED_INSTANCES = tuple((lm, False, False, block, False, multi, False, True)
                        for block, multi in ((False, False), (True, False), (True, True))
                        for lm in (False, True))
# the graph kernel's four (csrc/tiled_graph_cg.cu): GN and LM with the
# remainder, one system and a batch's systems in turn
TILED_INSTANCES += tuple((lm, True, False, False, False, multi, False, True)
                         for multi in (False, True) for lm in (False, True))
# the tiled grid kernel's Chronopoulos–Gear launches (csrc/tiled_grid_cs.cu)
# and its launches on bfloat16 fields, GN and LM, one system each
TILED_INSTANCES += tuple((lm, False, cs, False, not cs, False, False, True)
                         for cs in (True, False) for lm in (False, True))
# the tiled grid kernel's Jacobi launches on several systems in turn: the
# per-channel split's one-channel systems, a batch's systems
TILED_INSTANCES += tuple((lm, False, False, False, False, True, False, True)
                         for lm in (False, True))
# the tiled grid kernel's one-system Jacobi launches in the hbm layout (the
# ninth flag, hbm)
TILED_INSTANCES += tuple((lm, False, False, False, False, False, False, True, True)
                         for lm in (False, True))
# the graph kernel's one-system launches on a remainder-less graph, its
# stream layout (the tenth flag, dia)
TILED_INSTANCES += tuple((lm, False, False, False, False, False, False, True, False, True)
                         for lm in (False, True))
# the 3-D grid kernel's one-system GN launches (csrc/tiled_vol_cg.cu, the
# eleventh flag, vol): with the Jacobi and with the block-Jacobi
# preconditioner
TILED_INSTANCES += tuple((False, False, False, block, False, False, False, True, False, False,
                          True) for block in (False, True))
# the batch kernel's (csrc/tiled_batch_cg.cu): GN and LM over a batch of
# small systems side by side, a team of lanes of one warp a system
TILED_INSTANCES += tuple((lm, False, False, False, False, False, True, True)
                         for lm in (False, True))


def batched_kernel_form(meta, pre_blocks=None) -> str:
    """The kernel form a batched meta's launch takes: "batch" (one block a
    system) for systems of at most :data:`BATCH_BLOCK_ELEMS` values, else
    "multi" (the systems in turn). A system's values are its elements (C ×
    points), plus nnz·C·C under a remainder and C·C × points under a block
    preconditioner: a block reads the remainder's blocks and the C·C
    planes every iteration beside its state, so they lengthen its
    iteration as its elements do, while the multi form spreads them over
    the grid."""
    C = int(meta["ctot"])
    points = int(torch.Size(meta["F"].shape[2:]).numel())
    values = C * points
    if meta.get("rem") is not None:
        values += int(meta["rem"]["col"].shape[0]) * C * C
    if pre_blocks is not None:
        values += C * C * points
    return "batch" if values <= BATCH_BLOCK_ELEMS else "multi"


def _grid_size(lib, device, flags) -> int:
    """Co-resident block count of one cooperative kernel instance on
    ``device`` (flags: lm, rem, cs, block, bf16, multi)."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.fused_grid_cg_max_blocks(*(int(f) for f in flags), BLOCK_THREADS,
                                           ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"fused_grid_cg occupancy query failed: CUDA error {err}")
    return int(out.value)


def _check_operand(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"fused_grid_cg: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"fused_grid_cg: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"fused_grid_cg: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"fused_grid_cg: {name} is not contiguous")


def template_grid_cg_kernel(meta, b, pre, lits, tol, *, guard_div=True, ctc=None,
                            reset_period=None, q_tolerance=None, cs=False, pre_blocks=None):
    """Launch the template kernel on packed [C, *dom] float32 CUDA tensors (dom
    2-D or 3-D): the GN loop, or the LM loop when ``ctc`` is given (with
    ``reset_period`` and ``q_tolerance``); Chronopoulos–Gear under ``cs``;
    the block preconditioner when ``pre_blocks`` ([C·C, *dom]) is given
    (``pre`` is then not read); bfloat16 fields when the meta's F is
    bfloat16; the remainder phase when the meta has one (``meta["rem"]``);
    the per-channel split when the meta says ``chan_grid``: the C channels
    as C one-channel systems over the shared fields, solved in turn inside
    the one launch, each with its own exit and count. A batched meta
    (``meta["batch"]`` = B, F [B, T, *dom]) takes b, pre and ctc as
    [B, C, *dom], pre_blocks as [B, C·C, *dom] and the remainder's blocks as
    [B, nnz, C, C] over one shared CSR, and launches the form
    :func:`batched_kernel_form` names: B systems with their own fields,
    blocks, exits and counts.
    Returns (delta, iters int32[n_sys] on the device: one count per system,
    n_sys = B under a batch, C under the split, else 1). Does not
    synchronise. Each launch adds one to
    ``fused_grid_cg_kernel.launches[instance]`` (:func:`instance_name`)."""
    from ._build import load_library

    F = meta["F"]
    rem = meta.get("rem")
    device = b.device
    lm = ctc is not None
    block = pre_blocks is not None
    cs = bool(cs)
    if F.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_grid_cg_kernel takes float32 or bfloat16 fields, got {F.dtype}")
    bf16 = F.dtype == torch.bfloat16
    batch = int(meta.get("batch") or 0)
    lead = (batch,) if batch else ()  # the batch axis of every operand
    C = int(b.shape[len(lead)])
    dom = tuple(int(s) for s in b.shape[len(lead) + 1:])
    if len(dom) not in (2, 3):
        raise ValueError(f"fused_grid_cg_kernel takes a 2-D or 3-D domain, got {dom}")
    N0, N1, N2 = (1,) * (3 - len(dom)) + dom
    plane = N0 * N1 * N2
    form = None
    if batch:
        # B systems of C channels, each with its own fields (and blocks)
        form = batched_kernel_form(meta, pre_blocks)
        n_sys, c_sys, f_stride = batch, C, int(F.shape[1]) * plane
    else:
        # the split: n_sys systems of c_sys channels each over the shared F
        n_sys = C if meta.get("chan_grid") else 1
        c_sys, f_stride = C // n_sys, 0
        if n_sys > 1 and (block or rem is not None):
            raise ValueError("fused_grid_cg_kernel: the split form takes no remainder and no "
                             "block preconditioner")
    _check_operand("b", b, lead + (C,) + dom, torch.float32, device)
    if block:
        _check_operand("pre_blocks", pre_blocks, lead + (C * C,) + dom, torch.float32, device)
    else:
        _check_operand("pre", pre, lead + (C,) + dom, torch.float32, device)
    _check_operand("F", F, lead + (F.shape[len(lead)],) + dom, F.dtype, device)
    if lm:
        _check_operand("ctc", ctc, lead + (C,) + dom, torch.float32, device)
        if reset_period is None or q_tolerance is None or int(reset_period) < 1:
            raise ValueError(
                "fused_grid_cg_kernel: the LM loop needs reset_period >= 1 and "
                f"q_tolerance, got {reset_period} and {q_tolerance}"
            )
    blk_stride = 0  # a batch system's remainder blocks
    if rem is not None:
        nnz = int(rem["col"].shape[0])
        if N0 != 1 or N1 != 1:
            raise ValueError("fused_grid_cg_kernel: a remainder needs the graph domain [1, N]")
        _check_operand("rowptr", rem["rowptr"], (N2 + 1,), torch.int32, device)
        _check_operand("col", rem["col"], (nnz,), torch.int32, device)
        _check_operand("blk", rem["blk"], lead + (nnz, C, C), F.dtype, device)
        if rem["blk"].numel() >= 2**31:
            raise ValueError("fused_grid_cg_kernel indexes with int32: remainder too large")
        blk_stride = nnz * C * C if batch else 0
    n_triples = len(meta["triples"])
    if not 0 < n_triples <= MAX_TRIPLES or c_sys > MAX_CHANNELS:
        raise ValueError(
            f"fused_grid_cg_kernel takes up to {MAX_TRIPLES} triples and "
            f"{MAX_CHANNELS} channels, got {n_triples} and {c_sys}"
        )
    n_fields = int(F.shape[len(lead)])
    if any(not (0 <= fid < n_fields and 0 <= i < c_sys and 0 <= j < c_sys)
           for (_d, i, j, fid) in meta["triples"]):
        raise ValueError("fused_grid_cg_kernel: triple field id or channel out of range")
    total = b.numel()
    if total >= 2**31 or F.numel() >= 2**31 or (block and C * total >= 2**31):
        raise ValueError("fused_grid_cg_kernel indexes with int32: problem too large")
    if device.type != "cuda":  # after the operand checks, which hold on any device
        raise ValueError(f"fused_grid_cg_kernel needs CUDA tensors, got {device}")
    with_rem = rem is not None
    multi = form == "multi" if batch else n_sys > 1
    flags = (lm, with_rem, cs, block, bf16, multi, form == "batch")
    lib = load_library()
    if form == "batch":
        grid = n_sys  # one block a system
    else:
        grid = min(_grid_size(lib, device, flags[:6]), -(-(c_sys * plane) // BLOCK_THREADS))
    tr, starts = _device_triples(meta["triples"], c_sys, device)
    delta = torch.empty_like(b)
    r = torch.empty_like(b)
    p = torch.empty_like(b)
    Ap = torch.empty_like(b)
    z = torch.empty_like(b) if (cs or block) else None
    s = torch.empty_like(b) if cs else None
    part = torch.empty((3 if lm else 2, n_sys, 1 if form == "batch" else grid),
                       dtype=torch.float64, device=device)
    iters = torch.empty(n_sys, dtype=torch.int32, device=device)
    ptr = lambda t: None if t is None else ctypes.c_void_p(t.data_ptr())  # noqa: E731
    with torch.cuda.device(device):
        err = lib.fused_grid_cg_launch(
            int(lm), int(cs), int(block), int(bf16), int(form == "batch"),
            ptr(F), ptr(b), ptr(pre_blocks if block else pre), ptr(ctc), ptr(tr), ptr(starts),
            ptr(rem["rowptr"]) if with_rem else None, ptr(rem["col"]) if with_rem else None,
            ptr(rem["blk"]) if with_rem else None,
            c_sys, n_sys, f_stride, blk_stride, N0, N1, N2, int(lits),
            ctypes.c_float(float(tol)),
            int(bool(guard_div)),
            int(reset_period) if lm else 0, ctypes.c_float(float(q_tolerance) if lm else 0.0),
            ptr(delta), ptr(r), ptr(p), ptr(Ap), ptr(z), ptr(s),
            ptr(part[0]), ptr(part[1]), ptr(part[2]) if lm else None, ptr(iters),
            grid, BLOCK_THREADS,
            ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream),
        )
    if err != 0:
        raise RuntimeError(f"fused_grid_cg kernel launch failed: CUDA error {err}")
    fused_grid_cg_kernel.launches[instance_name(*flags)] += 1
    return delta, iters


def tiled_smem_bytes(lm: bool, C: int, th: int, tw: int, h: int, n_triples: int,
                     block: bool = False, cs: bool = False, hbm: bool = False) -> int:
    """The tiled kernel's dynamic shared memory a block, in bytes, in its
    layout (csrc/tiled_grid.cuh::tg_smem_bytes): the block-sum records,
    r, δ, p with its halo, Ap (with the halo under LM, where a reset
    iteration builds δ's haloed copy there), under ``block`` the C·C
    preconditioner planes over the tile and its halo, and the triples'
    offsets. Under ``hbm``, the layout whose δ and Ap live in a device
    frame a block: the records, r, p with its halo and the triples'
    offsets, the same under GN and LM. Under ``cs``
    (csrc/tiled_grid_cs.cu): the block-sum records (two sets under LM), r,
    s and u with the halo, p and δ with the halo under LM (over the tile
    under GN), w over the tile, and the triples' offsets. bfloat16 fields
    are not staged: the same bytes."""
    pts, ext = th * tw, (th + 2 * h) * (tw + 2 * h)
    records = 16 * (TILED_THREADS // 32 + 1)
    triples = 4 * (2 * n_triples + C + 1)
    if hbm:
        return records + 4 * C * (pts + ext) + triples
    if cs:
        return records * (2 if lm else 1) + 4 * C * (5 * ext + pts if lm else
                                                     3 * ext + 3 * pts) + triples
    return (records + 4 * C * (2 * pts + ext + (ext if lm else pts))
            + (4 * C * C * ext if block else 0) + triples)


def _ceil_split(dims, h: int, sm_count: int):
    """(counts, widths) of the ceil split of a grid of extents ``dims`` into
    at most ``sm_count`` blocks, each at least max(h, 1) wide on every axis
    (so a halo reaches only the adjacent blocks, whose borders hold it), or
    None. The split whose largest block with its halo holds the fewest
    points wins (its block's work and shared memory), counted up to
    TILED_THREADS (a block walks fewer with idle threads); then the fewest
    blocks (fewer in each barrier); then the widest block along the last
    axis, then the one before (the rows that loads and copies read)."""
    best, key = None, None
    lo = max(h, 1)

    def counts(axis, left):  # every count tuple of the remaining axes
        if axis == len(dims):
            yield ()
            return
        for k in range(1, min(dims[axis], left) + 1):
            for rest in counts(axis + 1, left // k):
                yield (k,) + rest

    for cnt in counts(0, sm_count):
        widths = tuple(-(-n // k) for n, k in zip(dims, cnt))
        if any(n - (k - 1) * w < lo for n, k, w in zip(dims, cnt, widths)):
            continue
        k = (max(int(np.prod([w + 2 * h for w in widths])), TILED_THREADS), int(np.prod(cnt)),
             tuple(-w for w in reversed(widths)))
        if key is None or k < key:
            best, key = (cnt, widths), k
    return best


@functools.lru_cache(maxsize=64)
def _tile_split(N1: int, N2: int, h: int, sm_count: int):
    """(tiles_r, tiles_c, th, tw) of :func:`_ceil_split` of the 2-D grid
    [N1, N2], or None."""
    split = _ceil_split((N1, N2), h, sm_count)
    return None if split is None else split[0] + split[1]


def tiled_grid_plan(meta, C: int, dom, *, lm: bool, cs: bool = False, block: bool = False,
                    sm_count: int, smem_per_block: int) -> Optional[Dict]:
    """Whether a launch on ``meta`` whose systems have C channels each on
    the domain ``dom`` takes the tiled kernel, and how: None, or {tiles:
    (rows, columns of tiles), tile: (th, tw), halo: h, threads,
    smem_bytes, layout}. Taken on a 2-D grid (dom [N1, N2] or [1, N1, N2] with
    N1 > 1: not the graph domain [1, N]), GN or LM (``lm``), in one of
    these forms: the standard loop with float32 fields and the elementwise
    or the block preconditioner (``block``), one system or several in turn
    (a batched meta; or, with the elementwise preconditioner, the
    per-channel split, ``chan_grid``, whose systems have one channel: C is
    then 1); the standard loop with bfloat16 fields and the elementwise
    preconditioner, one system; the Chronopoulos–Gear loop (``cs``) with
    float32 fields and the elementwise preconditioner, one system. No
    remainder, up to the kernel's channels and triples, when the grid
    splits into at most ``sm_count`` tiles (:func:`_tile_split`) whose
    state and halo, and under ``block`` the C·C planes over them, fit
    ``smem_per_block``: the layout "resident". Where that state does not
    fit, the standard loop with float32 fields and the elementwise
    preconditioner, one system of up to ``HBM_MAX_CHANNELS`` channels,
    takes the layout "hbm" if r over the tile and p over its frame fit
    (``tiled_smem_bytes(..., hbm=True)``: δ and Ap then live in a device
    frame a block; image_warping 1024²×3). h is
    the largest |offset| of the triples in either axis.
    Chronopoulos–Gear or bfloat16 with block-Jacobi, the two together, and
    either with the split or a batch keep the template (so does the split
    under block-Jacobi, which the template refuses too)."""
    bf16 = meta["F"].dtype == torch.bfloat16
    if meta["F"].dtype not in (torch.float32, torch.bfloat16):
        return None
    split, multi = bool(meta.get("chan_grid")), bool(meta.get("chan_grid") or meta.get("batch"))
    if (cs or bf16) and (block or multi) or (cs and bf16) or (split and block):
        return None
    if meta.get("rem") is not None:
        return None
    dom = tuple(int(s) for s in dom)
    triples = meta["triples"]
    if len(dom) == 3 and dom[0] == 1:
        if any(len(d) == 3 and d[0] != 0 for (d, _i, _j, _f) in triples):
            return None
        dom = dom[1:]
    if len(dom) != 2 or dom[0] < 2 or not 1 <= C <= MAX_CHANNELS:
        return None
    if not 0 < len(triples) <= MAX_TRIPLES:
        return None
    h = max(abs(int(o)) for (d, _i, _j, _f) in triples for o in d[-2:])
    split = _tile_split(dom[0], dom[1], h, int(sm_count))
    if split is None:
        return None
    tr, tc, th, tw = split
    smem = tiled_smem_bytes(lm, C, th, tw, h, len(triples), block, cs)
    layout = "resident"
    if smem > smem_per_block:
        if cs or block or bf16 or multi or C > HBM_MAX_CHANNELS:
            return None
        smem = tiled_smem_bytes(lm, C, th, tw, h, len(triples), hbm=True)
        if smem > smem_per_block:
            return None
        layout = "hbm"
    return {"tiles": (tr, tc), "tile": (th, tw), "halo": h, "threads": TILED_THREADS,
            "smem_bytes": smem, "layout": layout}


def tile_bounds(plan, N1: int, N2: int) -> list:
    """The tiles of a :func:`tiled_grid_plan` on the grid [N1, N2] in block
    order (block k is tile row k // columns, column k % columns), each as
    ((first row, row past the last), (first column, column past the last)):
    the ceil split of each axis, as the kernel cuts it."""
    return _ceil_bounds(plan["tiles"], plan["tile"], (N1, N2))


def _ceil_bounds(counts, widths, dims) -> list:
    """The blocks of a ceil split in block order (the last axis fastest),
    each as ((first, past the last) on every axis)."""
    return list(itertools.product(*([(i * w, min(n, (i + 1) * w)) for i in range(k)]
                                    for k, w, n in zip(counts, widths, dims))))


def tiled_vol_smem_bytes(block: bool, C: int, T: int, b0: int, b1: int, b2: int, h: int,
                         n_triples: int) -> int:
    """The 3-D grid kernel's dynamic shared memory a block, in bytes, in its
    layout (csrc/tiled_vol_cg.cu::tv_smem_bytes): the block-sum records,
    the triples' field and source offsets (two ints a triple) and the
    channels' first triples, the T fields over the box, r, δ and Ap over
    the box, p over the box and its halo, and the preconditioner over the
    box: C planes, or under ``block`` the C·C planes. Volumetric 32³×6
    (128 fields, 142 triples, boxes of 4×8×8, h = 1): 171,484 B Jacobi,
    202,204 B block-Jacobi."""
    pts, ext = b0 * b1 * b2, (b0 + 2 * h) * (b1 + 2 * h) * (b2 + 2 * h)
    return (16 * (TILED_THREADS // 32 + 1)
            + 4 * (T * pts + 3 * C * pts + C * ext + (C * C if block else C) * pts)
            + 4 * (2 * n_triples + C + 1))


@functools.lru_cache(maxsize=64)
def _box_split(N0: int, N1: int, N2: int, h: int, sm_count: int):
    """(boxes (B0, B1, B2), box (b0, b1, b2)) of :func:`_ceil_split` of the
    3-D grid [N0, N1, N2], or None. 32³ at h = 1 on 132 SMs: 8×4×4 boxes of
    4×8×8."""
    return _ceil_split((N0, N1, N2), h, sm_count)


def tiled_vol_plan(meta, C: int, dom, *, lm: bool, cs: bool = False, block: bool = False,
                   sm_count: int, smem_per_block: int) -> Optional[Dict]:
    """Whether a launch on ``meta`` (C channels on the 3-D grid ``dom`` =
    [N0, N1, N2], N0 > 1) takes the 3-D grid kernel (csrc/tiled_vol_cg.cu),
    and how: None, or {boxes: (B0, B1, B2), box: (b0, b1, b2), halo: h,
    threads, smem_bytes, layout: "vol"}. Taken for the standard GN loop
    (not ``lm``, not ``cs``) on float32 fields, one system (no batch, no
    split), no remainder, with the Jacobi or the block-Jacobi
    preconditioner (``block``), up to the kernel's channels and triples,
    when the grid splits into at most ``sm_count`` boxes (:func:`_box_split`)
    whose fields, state and preconditioner fit ``smem_per_block``
    (:func:`tiled_vol_smem_bytes`). h is the largest |offset| of the
    triples on any axis. Everything else on a 3-D grid keeps the template:
    LM, Chronopoulos–Gear, bfloat16 fields, a batch, the split, and a grid
    whose fields do not fit (volumetric 64³×6: about 1 MB of fields a box)."""
    F = meta["F"]
    if (lm or cs or F.dtype != torch.float32 or meta.get("rem") is not None
            or meta.get("batch") or meta.get("chan_grid")):
        return None
    dom = tuple(int(s) for s in dom)
    triples = meta["triples"]
    if (len(dom) != 3 or dom[0] < 2 or not 1 <= C <= MAX_CHANNELS
            or not 0 < len(triples) <= MAX_TRIPLES
            or any(len(d) != 3 for (d, _i, _j, _f) in triples)):
        return None
    h = max(abs(int(o)) for (d, _i, _j, _f) in triples for o in d)
    split = _box_split(*dom, h, int(sm_count))
    if split is None:
        return None
    plan = box_plan(dom, split[0], h, meta, C, block=block)
    return None if plan["smem_bytes"] > smem_per_block else plan


def box_plan(dom, boxes, h: int, meta=None, C: int = 0, *, block: bool = False) -> Dict:
    """The 3-D grid kernel's plan of the grid ``dom`` = [N0, N1, N2] cut
    into ``boxes`` = (B0, B1, B2) at the halo h: the ceil split of each
    axis (:func:`box_bounds`), every box at least max(h, 1) wide on every
    axis, else ValueError. With ``meta`` (C channels; ``block``: the C·C
    planes), its shared memory a block (:func:`tiled_vol_smem_bytes`),
    else 0. :func:`tiled_vol_plan`'s plan is this at :func:`_box_split`'s
    boxes; other splits are for checks that force them."""
    dom = tuple(int(n) for n in dom)
    boxes = tuple(int(k) for k in boxes)
    box = tuple(-(-n // k) for n, k in zip(dom, boxes))
    if len(dom) != 3 or any(n - (k - 1) * w < max(h, 1) for n, k, w in zip(dom, boxes, box)):
        raise ValueError(f"{boxes} boxes of {dom}: a box narrower than max(h, 1) = {max(h, 1)}")
    smem = 0 if meta is None else tiled_vol_smem_bytes(
        block, C, int(meta["F"].shape[0]), *box, h, len(meta["triples"]))
    return {"boxes": boxes, "box": box, "halo": h, "threads": TILED_THREADS,
            "smem_bytes": smem, "layout": "vol"}


def box_bounds(plan, N0: int, N1: int, N2: int) -> list:
    """The boxes of a :func:`tiled_vol_plan` on the grid [N0, N1, N2] in
    block order (block k is box (k // (B1·B2), k // B2 % B1, k % B2)), each
    as ((first, past the last) along axis 0, along axis 1, along axis 2):
    the ceil split of each axis, as the kernel cuts it."""
    return _ceil_bounds(plan["boxes"], plan["box"], (N0, N1, N2))


class GraphPartitions:
    """The graph route's vertex partitions of one remainder CSR (one
    topology), built on the host at the first launch that asks and kept
    for every later GN step: the partitions by (ranges, fields, dlo, dhi)
    and their tables' copies on each device. A plain object, not a dict,
    so that the solver's vmap hands it through as one leaf."""

    def __init__(self):
        self.partitions = {}
        self.device = {}

    def partition(self, rem, n: int, C: int, T: int, dlo: int, dhi: int) -> Dict:
        """The remainder ``rem``'s :func:`graph_partition` into ``n``
        ranges, a vertex weighing its T fields and its 3·C values of state
        and an entry its C×C block and its column, for DIA offsets in
        [-dlo, dhi]: built at the first call, kept for the later ones."""
        key = (n, T, dlo, dhi)
        if key not in self.partitions:
            self.partitions[key] = graph_partition(
                rem["rowptr"].cpu().numpy(), rem["col"].cpu().numpy(), n,
                vertex_bytes=4 * (T + 3 * C), entry_bytes=4 * (C * C + 1), dlo=dlo, dhi=dhi)
        return self.partitions[key]

    def tables(self, part: Dict, device) -> tuple:
        """The partition ``part``'s blocks, halo, lcol and border on
        ``device``, uploaded at the first launch there."""
        key = (id(part), str(device))
        if key not in self.device:
            self.device[key] = tuple(torch.as_tensor(part[k]).to(device)
                                     for k in ("blocks", "halo", "lcol", "border"))
        return self.device[key]


def graph_partition(rowptr, col, n_blocks: int, *, vertex_bytes: int, entry_bytes: int,
                    dlo: int = 0, dhi: int = 0) -> Dict:
    """Cut the vertices [0, N) of a destination-sorted CSR (rowptr [N+1],
    col [nnz]) into ``n_blocks`` contiguous ranges (fewer where N is
    smaller) of about equal bytes, a vertex weighing ``vertex_bytes`` and
    each of its entries ``entry_bytes``. For each range [v0, v1): its halo,
    the sorted vertices outside it that its entries read or that a DIA
    offset in [-dlo, dhi] reads from it (the window [v0 - dlo, v1 + dhi)
    within [0, N)); its frame, the range and its halo sorted by vertex id
    (the range after the halo's first ``own_at`` vertices). Returns numpy
    arrays: blocks [n, 5] int32 (v0, v1, own_at, halo_off, nh), halo
    [Σ nh] int32 (each block's, in block order), lcol [nnz] int32 (each
    entry's column as a place in its block's frame), border [N] uint8 (1
    where some block's halo holds the vertex: its owner writes r there),
    the largest range, halo, frame and entry span."""
    rowptr = np.asarray(rowptr, dtype=np.int64)
    col = np.asarray(col, dtype=np.int64)
    N = int(rowptr.shape[0]) - 1
    n = max(1, min(int(n_blocks), N))
    cum = np.concatenate([[0], np.cumsum(vertex_bytes + entry_bytes * np.diff(rowptr))])
    cuts = np.searchsorted(cum, cum[-1] * np.arange(1, n) / n, side="left")
    bounds = [0]
    for k, c in enumerate(cuts.tolist()):  # strictly increasing, every range non-empty
        bounds.append(min(max(int(c), bounds[-1] + 1), N - (n - 1 - k)))
    bounds.append(N)
    blocks = np.zeros((n, 5), dtype=np.int32)
    halos, lcol = [], np.zeros(col.shape[0], dtype=np.int32)
    border = np.zeros(N, dtype=np.uint8)
    off = max_frame = max_entries = 0
    for k in range(n):
        v0, v1 = bounds[k], bounds[k + 1]
        e0, e1 = int(rowptr[v0]), int(rowptr[v1])
        c = col[e0:e1]
        reads = np.concatenate([c, np.arange(max(0, v0 - dlo), min(N, v1 + dhi))])
        halo = np.unique(reads[(reads < v0) | (reads >= v1)])
        own_at = int(np.searchsorted(halo, v0))
        pos = np.searchsorted(halo, c)
        lcol[e0:e1] = np.where((c >= v0) & (c < v1), own_at + c - v0,
                               np.where(pos < own_at, pos, pos + v1 - v0))
        border[halo] = 1
        blocks[k] = (v0, v1, own_at, off, halo.shape[0])
        halos.append(halo)
        off += halo.shape[0]
        max_frame = max(max_frame, v1 - v0 + halo.shape[0])
        max_entries = max(max_entries, e1 - e0)
    return {"blocks": blocks, "halo": np.concatenate(halos).astype(np.int32), "lcol": lcol,
            "border": border, "max_range": int((blocks[:, 1] - blocks[:, 0]).max()),
            "max_halo": int(blocks[:, 4].max()), "max_frame": int(max_frame),
            "max_entries": int(max_entries)}


def tiled_graph_smem_bytes(lm: bool, C: int, T: int, nvm: int, nfm: int, nhm: int, nem: int,
                           n_triples: int, stream: bool = False) -> int:
    """The graph kernel's dynamic shared memory a block, in bytes, in its
    layout (csrc/tiled_graph_cg.cu::tgr_smem_bytes): the block-sum records,
    the fields over the largest range ``nvm`` (its stride made odd; not
    under ``stream``, the layout that reads them from device memory), r and
    Ap (under LM also b and ctc) over the range, p, δ and pre over the
    largest frame ``nfm``, the columns' frame places over the largest entry
    span ``nem``, the halo ``nhm``, the row starts, the triples' offsets
    (three ints a triple, four under ``stream``) and the border flags."""
    return (16 * (TILED_THREADS // 32 + 1)
            + 4 * ((0 if stream else T * (nvm | 1)) + (4 if lm else 2) * C * nvm + 3 * C * nfm
                   + nem + nhm + nvm + 1 + (4 if stream else 3) * n_triples + C + 1)
            + ((nvm + 3) & ~3))


def graph_tile_plan(meta, C: int, N: int, *, lm: bool, cs: bool = False, block: bool = False,
                    sm_count: int, smem_per_block: int) -> Optional[Dict]:
    """Whether a launch on the graph ``meta`` (C channels on the domain
    [1, N]) takes the graph kernel (csrc/tiled_graph_cg.cu), and how: None,
    or {blocks, max_range, max_halo, max_frame, max_entries, threads,
    smem_bytes, layout, partition (:func:`graph_partition`)}. Taken for a
    meta with the remainder whose CSR carries its :class:`GraphPartitions`
    (one group's), float32 fields and blocks, under the standard GN or LM
    loop (``lm``, not ``cs``) with the elementwise preconditioner (not
    ``block``), one system or a batch in the form
    :func:`batched_kernel_form` calls "multi", any number of channels up to
    the kernel's (a block row is read two floats a load from its first
    8-byte aligned word, one float at an odd end) and triples, when a
    partition into at most ``sm_count`` ranges fits ``smem_per_block``:
    the layout "resident", the range's fields
    staged in shared memory once a solve. A meta without the remainder
    whose empty CSR (``meta["empty_csr"]``) carries its :class:`GraphPartitions`
    takes it on the same conditions for one system only, in the layout
    "stream": its fields (arap36k: 181 on 36,864 vertices, 203 KB a range
    of 280) do not fit beside the state and are read from device memory
    every iteration. It starts at one range for every TILED_THREADS outputs
    and takes more (up to ``sm_count``) until the largest range's state,
    fields (not under "stream") and frame fit. Built once per topology:
    the partitions stay in the CSR's :class:`GraphPartitions`."""
    rem = meta.get("rem")
    F = meta["F"]
    batch = bool(meta.get("batch"))
    stream = rem is None
    if stream:
        rem = meta.get("empty_csr")
        if rem is None or batch:
            return None
    if not isinstance(rem.get("partitions"), GraphPartitions):
        return None
    if (F.dtype != torch.float32 or (not stream and rem["blk"].dtype != torch.float32) or cs
            or block or meta.get("chan_grid")
            or (batch and batched_kernel_form(meta) != "multi")):
        return None
    lead = 1 if batch else 0
    triples = meta["triples"]
    if (tuple(F.shape[lead + 1:]) != (1, N) or not 2 <= C <= MAX_CHANNELS
            or not 0 < len(triples) <= MAX_TRIPLES
            or any(len(d) != 2 or d[0] != 0 for (d, _i, _j, _f) in triples)):
        return None
    T = int(F.shape[lead])
    offsets = [int(d[1]) for (d, _i, _j, _f) in triples]
    dlo, dhi = max(0, -min(offsets)), max(0, max(offsets))
    cap = max(1, min(int(sm_count), N))
    n = min(cap, max(1, -(-(C * N) // TILED_THREADS)))
    while True:
        part = rem["partitions"].partition(rem, n, C, T, dlo, dhi)
        smem = tiled_graph_smem_bytes(lm, C, T, part["max_range"], part["max_frame"],
                                      part["max_halo"], part["max_entries"], len(triples),
                                      stream)
        if smem <= smem_per_block:
            return {"blocks": int(part["blocks"].shape[0]), "max_range": part["max_range"],
                    "max_halo": part["max_halo"], "max_frame": part["max_frame"],
                    "max_entries": part["max_entries"], "threads": TILED_THREADS,
                    "smem_bytes": smem, "layout": "stream" if stream else "resident",
                    "partition": part}
        if n == cap:
            return None
        n = min(cap, max(n + 1, n * 5 // 4))


def tiled_batch_smem_bytes(lm: bool, C: int, T: int, n_triples: int, plane: int) -> int:
    """One system's slice of the batch kernel's shared memory, in bytes
    (csrc/tiled_batch_cg.cu::tb_system_words): each element's stencil as
    (field value, source place) pairs, plane · n_triples of them; its T
    fields over the domain's ``plane`` points; a word an element for its
    pairs' place; then b, pre, (ctc under LM), δ and p with a zero place
    after each, r and Ap over its C·plane elements; an even count of
    words."""
    n = C * plane
    return 4 * ((2 * plane * n_triples + T * plane + n + (7 if lm else 6) * n + 2 + 1) & ~1)


def batch_team_plan(meta, C: int, dom, *, lm: bool, cs: bool = False, block: bool = False,
                    smem_per_block: int) -> Optional[Dict]:
    """Whether a launch on the batched ``meta`` (systems of C channels on
    the domain ``dom``) takes the batch kernel (csrc/tiled_batch_cg.cu),
    and how: None, or {layout: "batch", lanes, per_block, blocks, threads,
    smem_bytes}. Taken for a batch in the form :func:`batched_kernel_form`
    calls "batch" (which :func:`route_plan` tests), under the standard GN or LM loop
    (not ``cs``) with the elementwise preconditioner (not ``block``),
    float32 fields, no remainder (a graph's empty CSR is no remainder), up
    to the kernel's channels and triples, when one system's slice
    (:func:`tiled_batch_smem_bytes`: its stencil pairs, fields and vectors)
    fits ``smem_per_block`` beside the static table, and when a lane walks
    at most :data:`BATCH_TEAM_LANE_ELEMS` of its elements: the caps. A
    system takes a team of ``lanes`` lanes, one element a lane up to a
    warp (the smallest power of two at least its C·plane elements, at most
    :data:`BATCH_TEAM_LANES`); a block, one warp, holds ``per_block`` =
    32 / lanes systems, fewer where their slices do not fit."""
    F = meta["F"]
    if not meta.get("batch") or meta.get("rem") is not None or cs or block or (
            F.dtype != torch.float32):
        return None
    triples = meta["triples"]
    if not 0 < len(triples) <= MAX_TRIPLES or not 1 <= C <= MAX_CHANNELS:
        return None
    B, T = int(F.shape[0]), int(F.shape[1])
    plane = int(np.prod([int(s) for s in dom]))
    n = C * plane
    if -(-n // BATCH_TEAM_LANES) > BATCH_TEAM_LANE_ELEMS:
        return None
    one = tiled_batch_smem_bytes(lm, C, T, len(triples), plane)
    room = int(smem_per_block) - BATCH_TEAM_STATIC_SMEM
    if one > room or plane * len(triples) >= 2**21:  # a pair's place: 21 bits
        return None
    lanes = min(BATCH_TEAM_LANES, 1 << max(0, n - 1).bit_length())
    per_block = max(1, min(BATCH_TEAM_LANES // lanes, B, room // one))
    return {"layout": "batch", "lanes": lanes, "per_block": per_block,
            "blocks": -(-B // per_block), "threads": BATCH_TEAM_LANES,
            "smem_bytes": per_block * one}


_LIMITS = {}


def device_limits(device) -> tuple:
    """(SMs, shared memory a block may opt in to) of a CUDA device, from the
    CUDA runtime; :data:`SM90_LIMITS` for any other device."""
    device = torch.device(device)
    if device.type != "cuda":
        return SM90_LIMITS
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _LIMITS:
        from ._build import load_library

        sms, smem = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(index):
            err = load_library().tiled_grid_cg_device_limits(ctypes.byref(sms), ctypes.byref(smem))
        if err != 0:
            raise RuntimeError(f"tiled_grid_cg device query failed: CUDA error {err}")
        _LIMITS[index] = (int(sms.value), int(smem.value))
    return _LIMITS[index]


def route_plan(meta, b, *, lm: bool, cs: bool = False, pre_blocks=None) -> Optional[Dict]:
    """:func:`tiled_grid_plan` for a launch on ``meta`` with the packed
    vector ``b`` (and the block preconditioner's planes ``pre_blocks``, or
    None), at the limits of ``b``'s device: the tiled kernel's plan, or
    None where the launch takes the template. A batched meta in the form
    :func:`batched_kernel_form` calls "batch" takes
    :func:`batch_team_plan`'s plan (the batch kernel, layout "batch", a
    team of lanes a system, grid or graph alike) or None; in the form it
    calls "multi" (the systems in turn) the tiled kernels' plans at one
    system's C channels. The per-channel split is planned at one channel,
    its systems'. A graph meta, with the remainder or with
    its empty CSR (``meta["empty_csr"]``), takes :func:`graph_tile_plan`'s plan
    (the graph kernel) or None; a 3-D grid [N0, N1, N2] with N0 > 1
    :func:`tiled_vol_plan`'s (the 3-D grid kernel, layout "vol") or None."""
    block = pre_blocks is not None
    lead = 1 if meta.get("batch") else 0
    if lead and batched_kernel_form(meta, pre_blocks) == "batch":
        return batch_team_plan(meta, int(b.shape[1]), tuple(b.shape[2:]), lm=lm, cs=cs,
                               block=block, smem_per_block=device_limits(b.device)[1])
    if meta.get("rem") is not None or meta.get("empty_csr") is not None:
        sms, smem = device_limits(b.device)
        return graph_tile_plan(meta, int(b.shape[lead]), int(b.shape[-1]), lm=lm, cs=cs,
                               block=block, sm_count=sms, smem_per_block=smem)
    if lead and batched_kernel_form(meta, pre_blocks) != "multi":
        return None
    C = 1 if meta.get("chan_grid") else int(b.shape[lead])
    dom = tuple(int(s) for s in b.shape[lead + 1:])
    sms, smem = device_limits(b.device)
    if len(dom) == 3 and dom[0] > 1:
        return tiled_vol_plan(meta, C, dom, lm=lm, cs=cs, block=block, sm_count=sms,
                              smem_per_block=smem)
    return tiled_grid_plan(meta, C, dom, lm=lm, cs=cs, block=block,
                           sm_count=sms, smem_per_block=smem)


def launch_instance(meta, b, *, lm: bool = False, cs: bool = False, pre_blocks=None) -> str:
    """The name of the instance :func:`fused_grid_cg_kernel` launches for
    these operands."""
    block = pre_blocks is not None
    bf16 = meta["F"].dtype == torch.bfloat16
    plan = route_plan(meta, b, lm=lm, cs=cs, pre_blocks=pre_blocks)
    if plan is not None and plan["layout"] == "batch":
        return instance_name(lm, False, batch=True, tiled=True)
    if plan is not None:
        return instance_name(lm, meta.get("rem") is not None, cs, block, bf16,
                             multi=bool(meta.get("batch") or meta.get("chan_grid")),
                             tiled=True, hbm=plan["layout"] == "hbm",
                             dia=plan["layout"] == "stream", vol=plan["layout"] == "vol")
    form = batched_kernel_form(meta, pre_blocks) if meta.get("batch") else None
    multi = form == "multi" if form else bool(meta.get("chan_grid"))
    return instance_name(lm, meta.get("rem") is not None, cs, block, bf16, multi,
                         form == "batch")


def tiled_grid_cg_kernel(meta, b, pre, lits, tol, plan, *, guard_div=True, ctc=None,
                         reset_period=None, q_tolerance=None, pre_blocks=None, cs=False):
    """Launch the tiled kernel (csrc/tiled_grid_cg.cu; under ``cs``
    csrc/tiled_grid_cs.cu) on packed [C, *dom] float32 CUDA tensors, dom a
    2-D grid [N1, N2] (or [1, N1, N2]), as ``plan`` (:func:`tiled_grid_plan`)
    cuts it: the GN loop, or the LM loop when ``ctc`` is given (with
    ``reset_period`` and ``q_tolerance``); Chronopoulos–Gear under ``cs``;
    bfloat16 fields when the meta's F is bfloat16 (else float32); the block
    preconditioner when ``pre_blocks`` ([C·C, *dom]) is given (``pre`` is
    then not read; not with ``cs`` or bfloat16 fields, nor ``cs`` with
    bfloat16 fields: no tiled instance takes those). Several systems, in
    turn in the one launch, each with its own exit and count (the standard
    loop with float32 fields only): a batched meta (``meta["batch"]`` = B,
    F [B, T, *dom]) takes b, pre, ctc as [B, C, *dom] and pre_blocks as
    [B, C·C, *dom], B systems with their own fields; the per-channel split
    (``meta["chan_grid"]``, the triples one channel's) takes the C channels
    of b, pre and ctc as C one-channel systems over the shared F. Both are
    counted as ``*_multi_tiled`` (``gn_multi_tiled``,
    ``lm_bj_multi_tiled``, ...). A plan in the "hbm" layout (one system,
    the standard loop, float32 fields, the elementwise preconditioner)
    launches ``gn_hbm_tiled`` or ``lm_hbm_tiled`` with δ's and Ap's frames
    in a device scratch allocated here. Returns (delta, iters int32[n_sys]
    on the device, n_sys = B under a batch, C under the split, else 1). Does not
    synchronise. A launch the card refuses (more tiles than co-resident
    blocks, shared memory beyond the block's) raises. Each launch adds one
    to ``fused_grid_cg_kernel.launches[name]`` (:func:`instance_name`:
    ``gn_tiled``, ``lm_cs_tiled``, ``gn_bf16_tiled``, ``lm_bj_tiled``,
    ``gn_multi_tiled``, ...)."""
    from ._build import load_library

    F = meta["F"]
    device = b.device
    lm = ctc is not None
    block = pre_blocks is not None
    cs = bool(cs)
    if F.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"tiled_grid_cg_kernel takes float32 or bfloat16 fields, got {F.dtype}")
    bf16 = F.dtype == torch.bfloat16
    batch = int(meta.get("batch") or 0)
    split = bool(meta.get("chan_grid"))
    hbm = plan.get("layout") == "hbm"
    lead = (batch,) if batch else ()  # the batch axis of every operand
    if ((cs or bf16) and (block or batch or split)) or (cs and bf16) or (split and block):
        raise ValueError("tiled_grid_cg_kernel: no tiled instance takes Chronopoulos–Gear or "
                         "bfloat16 fields with the block preconditioner, several systems or "
                         "each other, or the split with the block preconditioner")
    C = int(b.shape[len(lead)])
    if hbm and (cs or bf16 or block or batch or split or C > HBM_MAX_CHANNELS):
        raise ValueError("tiled_grid_cg_kernel: the hbm layout takes one system of the "
                         "standard loop with float32 fields and the elementwise preconditioner, "
                         f"up to {HBM_MAX_CHANNELS} channels")
    full = tuple(int(s) for s in b.shape[len(lead) + 1:])
    dom = full[1:] if len(full) == 3 and full[0] == 1 else full
    if len(dom) != 2:
        raise ValueError(f"tiled_grid_cg_kernel takes a 2-D grid, got {full}")
    N1, N2 = dom
    _check_operand("b", b, lead + (C,) + full, torch.float32, device)
    if block:
        _check_operand("pre_blocks", pre_blocks, lead + (C * C,) + full, torch.float32, device)
    else:
        _check_operand("pre", pre, lead + (C,) + full, torch.float32, device)
    n_fields = int(F.shape[len(lead)])
    _check_operand("F", F, lead + (n_fields,) + full, F.dtype, device)
    if lm:
        _check_operand("ctc", ctc, lead + (C,) + full, torch.float32, device)
        if reset_period is None or q_tolerance is None or int(reset_period) < 1:
            raise ValueError(
                "tiled_grid_cg_kernel: the LM loop needs reset_period >= 1 and "
                f"q_tolerance, got {reset_period} and {q_tolerance}"
            )
    # n_sys systems of c_sys channels: a batch's, the split's channels
    n_sys, c_sys = (batch, C) if batch else ((C, 1) if split else (1, C))
    triples = meta["triples"]
    if not 0 < len(triples) <= MAX_TRIPLES or not 1 <= c_sys <= MAX_CHANNELS or any(
            not (0 <= fid < n_fields and 0 <= i < c_sys and 0 <= j < c_sys)
            for (_d, i, j, fid) in triples):
        raise ValueError("tiled_grid_cg_kernel: triples, channels or field ids out of range")
    if b.numel() >= 2**31 or F.numel() >= 2**31 or (block and C * b.numel() >= 2**31):
        raise ValueError("tiled_grid_cg_kernel indexes with int32: problem too large")
    (tr, tc), (th, tw), h = plan["tiles"], plan["tile"], plan["halo"]
    if device.type != "cuda":  # after the operand checks, which hold on any device
        raise ValueError(f"tiled_grid_cg_kernel needs CUDA tensors, got {device}")
    lib = load_library()
    tr_rows, starts = _device_triples(triples, c_sys, device)
    delta = torch.empty_like(b)
    r_ring = torch.empty((c_sys,) + full, dtype=torch.float32, device=device)  # one system's
    # Chronopoulos-Gear: w's rings by the iteration's parity, two records a
    # block (LM's three dots) in each parity's partials
    w_ring = torch.empty((2, C) + full, dtype=torch.float32, device=device) if cs else None
    part = torch.empty((2, tr * tc, 4 if cs else 2), dtype=torch.float64, device=device)
    iters = torch.empty(n_sys, dtype=torch.int32, device=device)
    # the hbm layout: δ's frame and Ap's (haloed under LM) a block
    pts, ext = th * tw, (th + 2 * h) * (tw + 2 * h)
    frames = (torch.empty(tr * tc * C * (pts + (ext if lm else pts)), dtype=torch.float32,
                          device=device) if hbm else None)
    ptr = lambda t: None if t is None else ctypes.c_void_p(t.data_ptr())  # noqa: E731
    shape = (ptr(F), ptr(b), ptr(pre_blocks if block else pre), ptr(ctc), ptr(tr_rows),
             ptr(starts), c_sys, len(triples), N1, N2, tr, tc, th, tw, h,
             int(lits), ctypes.c_float(float(tol)), int(bool(guard_div)),
             int(reset_period) if lm else 0, ctypes.c_float(float(q_tolerance) if lm else 0.0))
    launch = (int(plan["threads"]), int(plan["smem_bytes"]),
              ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    with torch.cuda.device(device):
        if cs:
            err = lib.tiled_grid_cs_launch(
                int(lm), *shape, ptr(delta), ptr(r_ring), ptr(w_ring), ptr(part[0]),
                ptr(part[1]), ptr(iters), *launch)
        else:
            err = lib.tiled_grid_cg_launch(
                int(lm), int(block), int(bf16), int(bool(batch or split)), int(hbm), *shape,
                n_sys, n_fields * N1 * N2 if batch else 0, ptr(delta), ptr(r_ring),
                ptr(part[0]), ptr(part[1]), ptr(iters), ptr(frames), *launch)
    if err != 0:
        raise RuntimeError(f"tiled_grid_cg kernel launch failed: CUDA error {err} "
                           f"({tr}x{tc} tiles of {th}x{tw}, {plan['smem_bytes']} bytes of "
                           "shared memory a block)")
    fused_grid_cg_kernel.launches[instance_name(lm, False, cs, block, bf16,
                                                multi=bool(batch or split), tiled=True,
                                                hbm=hbm)] += 1
    return delta, iters


def tiled_graph_cg_kernel(meta, b, pre, lits, tol, plan, *, guard_div=True, ctc=None,
                          reset_period=None, q_tolerance=None):
    """Launch the graph kernel (csrc/tiled_graph_cg.cu) on packed [C, 1, N]
    float32 CUDA tensors, the graph domain [1, N] with the meta's remainder
    (rowptr [N+1], col [nnz] int32, blk [nnz, C, C] float32), as ``plan``
    (:func:`graph_tile_plan`) partitions it: the GN loop, or the LM loop
    when ``ctc`` is given (with ``reset_period`` and ``q_tolerance``), with
    the elementwise preconditioner ``pre``. A batched meta (``meta["batch"]``
    = B, F [B, T, 1, N], blk [B, nnz, C, C]) takes b, pre, ctc as
    [B, C, 1, N] and solves the B systems in turn in the one launch,
    counted as ``*_rem_multi_tiled``. A plan in the "stream" layout takes a
    one-system meta without the remainder: its empty CSR (``meta["empty_csr"]``:
    rowptr [N+1] of zeros, col [0]) and an empty blk [0, C, C] are handed
    over, the fields are read from device memory, and the launch counts as
    ``gn_dia_tiled`` or ``lm_dia_tiled``. Returns (delta, iters
    int32[n_sys] on the device, n_sys = B under a batch, else 1). Does not
    synchronise. A launch the card refuses (more ranges than co-resident
    blocks, shared memory beyond the block's) raises. Each launch adds one
    to ``fused_grid_cg_kernel.launches[name]`` (``gn_rem_tiled``,
    ``lm_rem_multi_tiled``, ``gn_dia_tiled``, ...)."""
    from ._build import load_library

    F = meta["F"]
    device = b.device
    lm = ctc is not None
    if F.dtype != torch.float32:
        raise ValueError(f"tiled_graph_cg_kernel takes float32 fields, got {F.dtype}")
    stream = plan["layout"] == "stream"
    rem = meta.get("empty_csr" if stream else "rem")
    if rem is None or stream and meta.get("rem") is not None:
        raise ValueError("tiled_graph_cg_kernel needs the meta's graph remainder, or in the "
                         "stream layout a meta without it that carries its empty CSR")
    n_sys = int(meta.get("batch") or 0)
    multi = n_sys > 0
    if stream and multi:
        raise ValueError("tiled_graph_cg_kernel: the stream layout takes one system")
    lead = (n_sys,) if multi else ()  # the batch axis of every operand
    C = int(b.shape[len(lead)])
    full = tuple(int(s) for s in b.shape[len(lead) + 1:])
    if len(full) != 2 or full[0] != 1:
        raise ValueError(f"tiled_graph_cg_kernel takes the graph domain [1, N], got {full}")
    N = full[1]
    _check_operand("b", b, lead + (C,) + full, torch.float32, device)
    _check_operand("pre", pre, lead + (C,) + full, torch.float32, device)
    T = int(F.shape[len(lead)])
    _check_operand("F", F, lead + (T,) + full, torch.float32, device)
    if lm:
        _check_operand("ctc", ctc, lead + (C,) + full, torch.float32, device)
        if reset_period is None or q_tolerance is None or int(reset_period) < 1:
            raise ValueError(
                "tiled_graph_cg_kernel: the LM loop needs reset_period >= 1 and "
                f"q_tolerance, got {reset_period} and {q_tolerance}"
            )
    nnz = 0 if stream else int(rem["col"].shape[0])
    # the stream layout's remainder is empty: the kernel never dereferences
    # col, lcol or blk (their data pointers may be null)
    blk = torch.empty((0, C, C), dtype=torch.float32, device=device) if stream else rem["blk"]
    _check_operand("rowptr", rem["rowptr"], (N + 1,), torch.int32, device)
    _check_operand("col", rem["col"], (nnz,), torch.int32, device)
    _check_operand("blk", blk, lead + (nnz, C, C), torch.float32, device)
    triples = meta["triples"]
    if (not 0 < len(triples) <= MAX_TRIPLES or not 2 <= C <= MAX_CHANNELS or any(
            len(d) != 2 or d[0] != 0 or not (0 <= fid < T and 0 <= i < C and 0 <= j < C)
            for (d, i, j, fid) in triples)):
        raise ValueError("tiled_graph_cg_kernel: triples, offsets, channels or "
                         "field ids out of range")
    if b.numel() >= 2**31 or F.numel() >= 2**31 or blk.numel() >= 2**31:
        raise ValueError("tiled_graph_cg_kernel indexes with int32: problem too large")
    if plan["partition"]["lcol"].shape != (nnz,):
        raise ValueError(f"tiled_graph_cg_kernel: the plan's partition has "
                         f"{plan['partition']['lcol'].shape[0]} columns, the CSR {nnz}")
    if device.type != "cuda":  # after the operand checks, which hold on any device
        raise ValueError(f"tiled_graph_cg_kernel needs CUDA tensors, got {device}")
    lib = load_library()
    tr_rows, starts = _device_triples(triples, C, device)
    blocks, halo, lcol, border = rem["partitions"].tables(plan["partition"], device)
    n_blocks = int(plan["blocks"])
    delta = torch.empty_like(b)
    r_ring = torch.empty((N, C), dtype=torch.float32, device=device)  # one system's
    parts = torch.empty((2, n_blocks, 2), dtype=torch.float64, device=device)
    iters = torch.empty(max(n_sys, 1), dtype=torch.int32, device=device)
    ptr = lambda t: None if t is None else ctypes.c_void_p(t.data_ptr())  # noqa: E731
    with torch.cuda.device(device):
        err = lib.tiled_graph_cg_launch(
            int(lm), int(stream), ptr(F), ptr(b), ptr(pre), ptr(ctc), ptr(blk), ptr(tr_rows),
            ptr(starts), ptr(rem["rowptr"]), ptr(lcol), ptr(blocks), ptr(halo), ptr(border),
            C, T, len(triples), N, n_blocks, plan["max_range"], plan["max_frame"],
            plan["max_halo"], plan["max_entries"], int(lits), ctypes.c_float(float(tol)),
            int(bool(guard_div)), int(reset_period) if lm else 0,
            ctypes.c_float(float(q_tolerance) if lm else 0.0), max(n_sys, 1),
            T * N if multi else 0, nnz * C * C if multi else 0,
            ptr(delta), ptr(r_ring), ptr(parts[0]), ptr(parts[1]), ptr(iters),
            int(plan["threads"]), int(plan["smem_bytes"]),
            ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream),
        )
    if err != 0:
        raise RuntimeError(f"tiled_graph_cg kernel launch failed: CUDA error {err} "
                           f"({n_blocks} vertex ranges of up to {plan['max_range']} vertices, "
                           f"frames of up to {plan['max_frame']}, {plan['smem_bytes']} bytes "
                           "of shared memory a block)")
    fused_grid_cg_kernel.launches[instance_name(lm, not stream, multi=multi, tiled=True,
                                                dia=stream)] += 1
    return delta, iters


def tiled_vol_cg_kernel(meta, b, pre, lits, tol, plan, *, guard_div=True, pre_blocks=None):
    """Launch the 3-D grid kernel (csrc/tiled_vol_cg.cu) on packed
    [C, N0, N1, N2] float32 CUDA tensors, as ``plan`` (:func:`tiled_vol_plan`)
    cuts the grid into boxes: the GN loop of one system on float32 fields
    [T, N0, N1, N2], with the elementwise preconditioner ``pre`` or, when
    ``pre_blocks`` ([C·C, N0, N1, N2]) is given, the block one (``pre`` is
    then not read). Returns (delta, iters int32[1] on the device). Does not
    synchronise. The operands are checked first; then a CPU tensor raises,
    and so does a launch the card refuses (more boxes than co-resident
    blocks, shared memory beyond the block's): nothing falls back to the
    template or the twin. Each launch adds one to
    ``fused_grid_cg_kernel.launches[name]`` (``gn_vol_tiled``,
    ``gn_bj_vol_tiled``)."""
    from ._build import load_library

    F = meta["F"]
    device = b.device
    block = pre_blocks is not None
    if F.dtype != torch.float32:
        raise ValueError(f"tiled_vol_cg_kernel takes float32 fields, got {F.dtype}")
    if meta.get("rem") is not None or meta.get("batch") or meta.get("chan_grid"):
        raise ValueError("tiled_vol_cg_kernel takes one system without the remainder")
    C = int(b.shape[0])
    dom = tuple(int(s) for s in b.shape[1:])
    if len(dom) != 3:
        raise ValueError(f"tiled_vol_cg_kernel takes a 3-D grid, got {dom}")
    N0, N1, N2 = dom
    _check_operand("b", b, (C,) + dom, torch.float32, device)
    if block:
        _check_operand("pre_blocks", pre_blocks, (C * C,) + dom, torch.float32, device)
    else:
        _check_operand("pre", pre, (C,) + dom, torch.float32, device)
    T = int(F.shape[0])
    _check_operand("F", F, (T,) + dom, torch.float32, device)
    triples = meta["triples"]
    if (not 0 < len(triples) <= MAX_TRIPLES or not 1 <= C <= MAX_CHANNELS or any(
            len(d) != 3 or not (0 <= fid < T and 0 <= i < C and 0 <= j < C)
            for (d, i, j, fid) in triples)):
        raise ValueError("tiled_vol_cg_kernel: triples, offsets, channels or field ids out "
                         "of range")
    if b.numel() >= 2**31 or F.numel() >= 2**31 or (block and C * b.numel() >= 2**31):
        raise ValueError("tiled_vol_cg_kernel indexes with int32: problem too large")
    (B0, B1, B2), (b0, b1, b2), h = plan["boxes"], plan["box"], plan["halo"]
    if device.type != "cuda":  # after the operand checks, which hold on any device
        raise ValueError(f"tiled_vol_cg_kernel needs CUDA tensors, got {device}")
    lib = load_library()
    tr_rows, starts = _device_triples(triples, C, device)
    n_boxes = B0 * B1 * B2
    delta = torch.empty_like(b)
    z_ring = torch.empty_like(b)  # each block writes only its box's shell of z
    part = torch.empty((2, n_boxes, 2), dtype=torch.float64, device=device)
    iters = torch.empty(1, dtype=torch.int32, device=device)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    with torch.cuda.device(device):
        err = lib.tiled_vol_cg_launch(
            int(block), ptr(F), ptr(b), ptr(pre_blocks if block else pre), ptr(tr_rows),
            ptr(starts), C, T, len(triples), N0, N1, N2, B0, B1, B2, b0, b1, b2, h, int(lits),
            ctypes.c_float(float(tol)), int(bool(guard_div)), ptr(delta), ptr(z_ring),
            ptr(part[0]), ptr(part[1]), ptr(iters), int(plan["threads"]),
            int(plan["smem_bytes"]), ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"tiled_vol_cg kernel launch failed: CUDA error {err} "
                           f"({B0}x{B1}x{B2} boxes of {b0}x{b1}x{b2}, {plan['smem_bytes']} "
                           "bytes of shared memory a block)")
    fused_grid_cg_kernel.launches[instance_name(False, False, block=block, tiled=True,
                                                vol=True)] += 1
    return delta, iters


def tiled_batch_cg_kernel(meta, b, pre, lits, tol, plan, *, guard_div=True, ctc=None,
                          reset_period=None, q_tolerance=None):
    """Launch the batch kernel (csrc/tiled_batch_cg.cu) on a batched meta
    (``meta["batch"]`` = B, F [B, T, *dom] float32, no remainder) and
    packed [B, C, *dom] float32 CUDA tensors b, pre (and ctc), as ``plan``
    (:func:`batch_team_plan`) lays the systems out: the GN loop, or the LM
    loop when ``ctc`` is given (with ``reset_period`` and
    ``q_tolerance``), with the elementwise preconditioner, each system by
    a team of lanes with its own exit and count. Returns (delta [B, C,
    *dom], iters int32[B] on the device). Does not synchronise. The
    operands are checked first; then a CPU tensor raises, and so does a
    launch the card refuses: nothing falls back to the template or the
    twin. Each launch adds one to ``fused_grid_cg_kernel.launches`` under
    ``gn_batch_tiled`` or ``lm_batch_tiled``."""
    from ._build import load_library

    F = meta["F"]
    device = b.device
    lm = ctc is not None
    B = int(meta.get("batch") or 0)
    if not B or meta.get("rem") is not None:
        raise ValueError("tiled_batch_cg_kernel takes a batched meta without the remainder")
    if F.dtype != torch.float32:
        raise ValueError(f"tiled_batch_cg_kernel takes float32 fields, got {F.dtype}")
    C = int(b.shape[1])
    dom = tuple(int(s) for s in b.shape[2:])
    if len(dom) not in (2, 3):
        raise ValueError(f"tiled_batch_cg_kernel takes a 2-D or 3-D domain, got {dom}")
    N0, N1, N2 = (1,) * (3 - len(dom)) + dom
    T = int(F.shape[1])
    _check_operand("b", b, (B, C) + dom, torch.float32, device)
    _check_operand("pre", pre, (B, C) + dom, torch.float32, device)
    _check_operand("F", F, (B, T) + dom, torch.float32, device)
    if lm:
        _check_operand("ctc", ctc, (B, C) + dom, torch.float32, device)
        if reset_period is None or q_tolerance is None or int(reset_period) < 1:
            raise ValueError(
                "tiled_batch_cg_kernel: the LM loop needs reset_period >= 1 and "
                f"q_tolerance, got {reset_period} and {q_tolerance}"
            )
    triples = meta["triples"]
    if (not 0 < len(triples) <= MAX_TRIPLES or not 1 <= C <= MAX_CHANNELS or any(
            not (0 <= fid < T and 0 <= i < C and 0 <= j < C) for (_d, i, j, fid) in triples)):
        raise ValueError("tiled_batch_cg_kernel: triples, channels or field ids out of range")
    if b.numel() >= 2**31 or F.numel() >= 2**31:
        raise ValueError("tiled_batch_cg_kernel indexes with int32: batch too large")
    if device.type != "cuda":  # after the operand checks, which hold on any device
        raise ValueError(f"tiled_batch_cg_kernel needs CUDA tensors, got {device}")
    lib = load_library()
    tr_rows, starts = _device_triples(triples, C, device)
    delta = torch.empty_like(b)
    iters = torch.empty(B, dtype=torch.int32, device=device)
    ptr = lambda t: None if t is None else ctypes.c_void_p(t.data_ptr())  # noqa: E731
    with torch.cuda.device(device):
        err = lib.tiled_batch_cg_launch(
            int(lm), ptr(F), ptr(b), ptr(pre), ptr(ctc), ptr(tr_rows), ptr(starts), C, T,
            len(triples), N0, N1, N2, B, int(plan["lanes"]), int(plan["per_block"]), int(lits),
            ctypes.c_float(float(tol)), int(bool(guard_div)), int(reset_period) if lm else 0,
            ctypes.c_float(float(q_tolerance) if lm else 0.0), ptr(delta), ptr(iters),
            ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"tiled_batch_cg kernel launch failed: CUDA error {err} "
                           f"({plan['blocks']} blocks of {plan['per_block']} systems, "
                           f"{plan['lanes']} lanes a system, {plan['smem_bytes']} bytes of "
                           "shared memory a block)")
    fused_grid_cg_kernel.launches[instance_name(lm, False, batch=True, tiled=True)] += 1
    return delta, iters


def fused_grid_cg_kernel(meta, b, pre, lits, tol, *, guard_div=True, ctc=None,
                         reset_period=None, q_tolerance=None, cs=False, pre_blocks=None):
    """Launch the whole CG loop on CUDA tensors: the tiled kernel
    (:func:`tiled_grid_cg_kernel`, :func:`tiled_graph_cg_kernel` for a
    graph meta, :func:`tiled_vol_cg_kernel` for a 3-D grid,
    :func:`tiled_batch_cg_kernel` for a batch of small systems) where
    :func:`route_plan` gives a plan,
    else the template (:func:`template_grid_cg_kernel`, whose docstring
    gives the operands and forms). Both are bitwise equal to the twin, so
    the route changes no result; a tiled launch that fails raises and is
    not retried. Returns (delta, iters int32[n_sys] on the device). Each
    launch adds one to ``fused_grid_cg_kernel.launches[instance]``
    (:func:`instance_name`)."""
    plan = route_plan(meta, b, lm=ctc is not None, cs=cs, pre_blocks=pre_blocks)
    if plan is None:
        return template_grid_cg_kernel(
            meta, b, pre, lits, tol, guard_div=guard_div, ctc=ctc, reset_period=reset_period,
            q_tolerance=q_tolerance, cs=cs, pre_blocks=pre_blocks)
    if "partition" in plan:
        return tiled_graph_cg_kernel(meta, b, pre, lits, tol, plan, guard_div=guard_div,
                                     ctc=ctc, reset_period=reset_period,
                                     q_tolerance=q_tolerance)
    if plan["layout"] == "batch":
        return tiled_batch_cg_kernel(meta, b, pre, lits, tol, plan, guard_div=guard_div,
                                     ctc=ctc, reset_period=reset_period,
                                     q_tolerance=q_tolerance)
    if plan["layout"] == "vol":  # GN only: the planner refuses ctc and cs
        return tiled_vol_cg_kernel(meta, b, pre, lits, tol, plan, guard_div=guard_div,
                                   pre_blocks=pre_blocks)
    return tiled_grid_cg_kernel(meta, b, pre, lits, tol, plan, guard_div=guard_div, ctc=ctc,
                                reset_period=reset_period, q_tolerance=q_tolerance,
                                pre_blocks=pre_blocks, cs=cs)


def reset_launch_counts():
    """Set the kernels' launch counts, one per instance, to 0."""
    fused_grid_cg_kernel.launches = {instance_name(*f): 0
                                     for f in INSTANCES + TILED_INSTANCES}


reset_launch_counts()


def pack(d, meta):
    """[*dom, C_u] per unknown -> channel-major packed [C, *kernel dom]
    (a graph's vertex axis [N] becomes [1, N]); under a batched meta
    [B, *dom, C_u] -> [B, C, *kernel dom]."""
    u_list = meta["u_list"]
    lead = 1 if meta.get("batch") else 0
    a = torch.cat([d[u] for u in u_list], dim=-1) if len(u_list) > 1 else d[u_list[0]]
    dom = tuple(meta["F"].shape[1 + lead:])
    return torch.movedim(a, -1, lead).reshape(
        tuple(a.shape[:lead]) + (a.shape[-1],) + dom).contiguous()


def pack_pre_blocks(pre_blocks, meta):
    """Per-point inverted blocks [*dom, C, C] over the packed channels ->
    channel-major [C·C, *kernel dom], plane i·C + j holding M⁻¹[i, j]
    (under a batched meta with a leading batch axis on both sides)."""
    lead = 1 if meta.get("batch") else 0
    C = int(pre_blocks.shape[-1])
    flat = pre_blocks.reshape(tuple(pre_blocks.shape[:-2]) + (C * C,))
    return torch.movedim(flat, -1, lead).reshape(
        tuple(flat.shape[:lead]) + (C * C,) + tuple(meta["F"].shape[1 + lead:])).contiguous()


def fused_grid_cg(meta, r0, pre, l_iterations, rz_tolerance, *, guard_div=True,
                  interpret=False, ctc=None, reset_period=None, q_tolerance=None,
                  pre_blocks=None, cg_variant="standard"):
    """Run the whole PCG loop; returns (delta dict, iterations executed as a
    0-dim int32 tensor). Packs [*dom, C] dicts channel-major (:func:`pack`).
    Passing ``ctc`` (a dict like ``pre``, with ``reset_period`` and
    ``q_tolerance``) runs the LM loop; ``pre_blocks`` ([*dom, C, C], the
    inverted per-point blocks over the packed channels, rows masked)
    replaces the elementwise ``pre`` with the block-Jacobi apply;
    ``cg_variant="chronopoulos_gear"`` runs the Chronopoulos–Gear loop. A
    meta with ``chan_grid`` runs its channels as independent one-channel
    systems, and the iterations returned are the sum of theirs. A batched
    meta (``"batch"``: B) takes r0, pre, ctc and pre_blocks with a leading
    batch axis and returns delta with one and the iterations as int32 [B],
    one count per instance.

    CPU tensors, or ``interpret=True``, run the plain twin. CUDA tensors
    launch the kernel. Any other device raises."""
    if cg_variant not in CG_VARIANTS:
        raise ValueError(f"cg_variant must be one of {CG_VARIANTS}, got {cg_variant!r}")
    b = pack(r0, meta)
    if pre_blocks is not None:
        prem, pbm = None, pack_pre_blocks(pre_blocks, meta)
    else:
        prem, pbm = pack(pre, meta), None
    ctcm = pack(ctc, meta) if ctc is not None else None
    kw = dict(ctc=ctcm, reset_period=reset_period, q_tolerance=q_tolerance,
              cs=cg_variant == "chronopoulos_gear", pre_blocks=pbm)
    split = bool(meta.get("chan_grid"))
    batch = int(meta.get("batch") or 0)
    if interpret or b.device.type == "cpu":
        counts = []
        delta, l = fused_grid_cg_reference(
            meta["F"], meta["triples"], b, prem, l_iterations, rz_tolerance,
            guard_div=guard_div, rem=meta.get("rem"), counts=counts, batched=bool(batch),
            n_sys=batch or (int(b.shape[0]) if split else 1), **kw,
        )
        iters = torch.tensor(counts if batch else l, dtype=torch.int32, device=b.device)
    elif b.device.type == "cuda":
        delta, it = fused_grid_cg_kernel(
            meta, b, prem, l_iterations, rz_tolerance, guard_div=guard_div, **kw
        )
        # per-system counts: the solver takes the executed total of a split
        # and each instance's count of a batch
        iters = it if batch else (it.sum(dtype=torch.int32) if split else it[0])
    else:
        raise ValueError(
            f"fused_grid_cg runs on CPU (plain twin) or CUDA (kernel) tensors, "
            f"not {b.device}"
        )
    lead = tuple(delta.shape[:1]) if batch else ()
    spatial = tuple(r0[meta["u_list"][0]].shape[len(lead):-1])
    packed = torch.movedim(delta.reshape(lead + (delta.shape[len(lead)],) + spatial),
                           len(lead), -1)
    out = {}
    for u in meta["u_list"]:
        o = meta["offs"][u]
        out[u] = packed[..., o : o + meta["channels"][u]]
    return out, iters
