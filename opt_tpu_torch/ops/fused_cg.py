"""Whole-loop PCG for 2-D grid and graph operators: the counterpart of
``opt_tpu/ops/pallas_cg.py``.

The JAX package runs the whole PCG inner loop of a 2-D grid problem as one
Pallas TPU kernel (``pallas_cg.py::_kernel`` in its grid GN, mixed-unknown
and LM forms; ``_hbm_tiled_kernel`` for grids beyond VMEM; its ``flat1d``
DIA form and its ``rem_pairs`` irregular remainder for graphs). Here the
same loop runs as one persistent cooperative CUDA kernel
(``csrc/fused_grid_cg.cu``: GN and LM instances, each with and without the
remainder phase) for CUDA tensors, and as its plain PyTorch twin
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

:func:`_run_cg` holds the loop algebra (the GN and LM bodies of the JAX
package's ``_run_cg``: guarded α/β; GN exits on rᵀz ≤ tol·rᵀz₀ or pᵀAp ≤ 0;
LM adds CtC·p to the apply, resets r = b − A·δ every ``reset_period``
iterations and exits on ζ < q_tol or the rᵀz floor). The twin and the
solver's eager loop both run it, and the kernel implements the same steps,
so exits and counted iterations agree by construction.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from .shift import in_bounds_mask, shift

# per-kernel capacity of the CUDA source (csrc/fused_grid_cg.cu)
MAX_TRIPLES = 512
MAX_CHANNELS = 64
BLOCK_THREADS = 256


def plan_fused_grid_cg(compiled, plan, fields: Dict, w_layouts: Dict) -> Optional[Dict]:
    """Decide applicability from the assembled operator and build the loop's
    inputs: exactly one 2-D index space holding every unknown, float32.
    Returns {u_list, offs, channels, ctot, triples, F [T, *dom]} or None.
    The in-bounds masks are folded into F."""
    if not fields or compiled.dtype != torch.float32 or len(w_layouts) != 1:
        return None
    ((isp, (u_list, offs, ctot)),) = w_layouts.items()
    if isp.ndim != 2 or sorted(compiled.unknown_names) != sorted(u_list):
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
    return {
        "u_list": tuple(u_list),
        "offs": dict(offs),
        "channels": channels,
        "ctot": ctot,
        "triples": tuple(triples),
        "F": torch.stack(field_list, dim=0).contiguous(),
        "rem": None,
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
    """One destination-sorted CSR from several groups' (row, col, blk):
    each row's entries group by group, in group order."""
    if len(parts) == 1:
        rowptr, col, blk, _row = parts[0]
        return {"rowptr": rowptr, "col": col, "blk": blk.contiguous()}
    row = torch.cat([p[3] for p in parts])
    order = torch.argsort(row, stable=True)
    rowptr = torch.zeros(n + 1, dtype=torch.int64, device=row.device)
    rowptr[1:] = torch.cumsum(torch.bincount(row, minlength=n), 0)
    return {
        "rowptr": rowptr.to(torch.int32),
        "col": torch.cat([p[1] for p in parts])[order].contiguous(),
        "blk": torch.cat([p[2] for p in parts])[order].contiguous(),
    }


def plan_fused_graph_cg(compiled, plan, fields: Dict, grp_exec: Dict) -> Optional[Dict]:
    """The loop's inputs for a graph problem whose unknowns all live on one
    1-D vertex space, float32: the same-vertex blocks S and the DIA fields
    of every group as triples on the grid [1, N], the centered fields of
    that space (fit terms) likewise, and the groups' remainders merged into
    the kernel's block CSR. Each group's row mask is folded into its
    fields and blocks on both sides (M·A·M). Returns the meta or None (the
    unknowns span several spaces or groups, or more triples or channels
    than the kernel holds)."""
    if compiled.dtype != torch.float32:
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

    rem_parts = []
    for key, ex in sorted(grp_exec.items()):
        g_ulist, g_offs, ct = ex["layout"]
        if sorted(g_ulist) != sorted(u_list) or ct != ctot or ex["S"].shape[0] != N:
            return None  # the group does not span the whole kernel state
        gmap = [0] * ct  # group channel -> kernel channel
        for u in g_ulist:
            for c in range(channels[u]):
                gmap[g_offs[u] + c] = offs[u] + c
        pm = ex["mask"]
        for i in range(ct):
            for j in range(ct):
                col = ex["S"][:, i * ct + j]
                if pm is not None:
                    col = col * pm[:, i] * pm[:, j]
                _emit(col, 0, gmap[i], gmap[j])
        for off, W in ex["dia"]:
            pm_s = shift(pm, (off,)) if pm is not None else None
            for i in range(ct):
                for j in range(ct):
                    col = W[:, i * ct + j] * _bounds(off)
                    if pm is not None:
                        col = col * pm[:, i] * pm_s[:, j]
                    _emit(col, off, gmap[i], gmap[j])
        if ex["C"] is not None:
            csr = ex["tables"]["csr"]
            blk = ex["C"].reshape(-1, ct, ct)[csr["src"]]  # [nnz, ct, ct]
            if pm is not None:
                blk = blk * pm[csr["row"]][:, :, None] * pm[csr["col"].long()][:, None, :]
            inv = [0] * ct
            for gi, a in enumerate(gmap):
                inv[a] = gi
            if inv != list(range(ct)):
                inv_t = torch.as_tensor(inv, device=blk.device)
                blk = blk[:, inv_t][:, :, inv_t]
            rem_parts.append((csr["rowptr"], csr["col"], blk, csr["row"]))
    if not field_list or len(triples) > MAX_TRIPLES or ctot > MAX_CHANNELS:
        return None
    rem = _merge_remainders(rem_parts, N) if rem_parts else None
    return {
        "u_list": tuple(u_list),
        "offs": offs,
        "channels": channels,
        "ctot": ctot,
        "triples": tuple(triples),
        "F": torch.stack(field_list, dim=0).reshape(len(field_list), 1, N).contiguous(),
        "rem": rem,
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
            trace: Optional[list] = None):
    """The shared PCG loop over abstract ``apply``/``prec``/``dot`` (vectors
    are tensors or dicts of tensors). With ``reset_period`` it runs the LM
    body (``apply`` then includes + CtC·p): r = b − A·δ every
    ``reset_period`` iterations, Q1 = ½⟨δ, b + r⟩, ζ = (l+1)(Q1 − Q0)/Q1,
    exit on ζ < ``q_tol`` or the rᵀz floor, and no pᵀAp ≤ 0 exit.
    Returns (delta, iterations executed). The host reads one flag per
    iteration to exit, so exits and counts match the on-device loop
    exactly. A ``trace`` list receives (l, rᵀz, floor, ζ or None) after
    each iteration."""
    lm = reset_period is not None
    if lm and int(reset_period) < 1:
        raise ValueError(f"residual_reset_period must be >= 1, got {reset_period}")
    r = b
    p = prec(r)
    rz = dot(r, p)
    floor = tol * rz
    delta = _zeros_like(b)
    Q0 = torch.zeros_like(rz)
    lits = int(lits)
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
        rz_new = dot(z, r)
        beta = safe_div(rz_new, rz, guard_div)
        p = _lin(beta, p, z)
        rz = rz_new
        l += 1
        zeta = None
        if lm:
            Q1 = 0.5 * dot(delta, _lin(1.0, r, b))  # t:478-481
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


def _stencil_apply(F, triples, p):
    """(A·p)[i] = Σ_t F[fid_t] · p[j_t] read at offset Δ_t, zero-padded."""
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
    for k in range(int(count.max()) if count.numel() else 0):
        live = k < count
        e = torch.where(live, start + k, 0)
        B = rem["blk"][e]  # [N, C, C]
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


def fused_grid_cg_reference(F, triples, b, pre, lits, tol, *, guard_div=True,
                            ctc=None, reset_period=None, q_tolerance=None, trace=None,
                            rem=None):
    """Plain PyTorch twin of the CUDA kernel on packed [C, *dom] tensors:
    the same algebra through :func:`_run_cg`, with the kernel's dot
    products (:func:`_dot`); ``rem`` (a meta's ``"rem"``) adds the graph
    remainder to the apply; passing ``ctc`` (with ``reset_period`` and
    ``q_tolerance``) runs the LM loop; ``trace`` as in :func:`_run_cg`.
    Returns (delta, iterations)."""
    if ctc is None:
        apply = lambda p: _operator_apply(F, triples, rem, p)  # noqa: E731
        reset_period = q_tolerance = None
    else:
        apply = lambda p: _operator_apply(F, triples, rem, p) + ctc * p  # noqa: E731
        if reset_period is None or q_tolerance is None:
            raise ValueError("the LM loop needs reset_period and q_tolerance")
    return _run_cg(
        b, apply, lambda r: pre * r, _dot, lits, tol,
        guard_div=guard_div, reset_period=reset_period, q_tol=q_tolerance, trace=trace,
    )


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=32)
def _device_triples(triples, ctot: int, device):
    """Triples sorted stably by output channel as int32 [n, 5] rows
    (d0, d1, i, j, fid) plus the per-channel row starts [ctot + 1], on the
    device. Cached by value: a plan's triples are the same every GN step,
    and each upload would stall the host on a device copy."""
    rows = [(d[0], d[1], i, j, fid) for (d, i, j, fid) in sorted(triples, key=lambda t: t[1])]
    starts = [0] * (ctot + 1)
    for (_d0, _d1, i, _j, _f) in rows:
        starts[i + 1] += 1
    for c in range(ctot):
        starts[c + 1] += starts[c]
    return (
        torch.tensor(rows, dtype=torch.int32).to(device),
        torch.tensor(starts, dtype=torch.int32).to(device),
    )


def instance_name(lm: bool, rem: bool) -> str:
    """The kernel instance's name: "gn" or "lm", "_rem" with the remainder."""
    return ("lm" if lm else "gn") + ("_rem" if rem else "")


def _grid_size(lib, device, lm: bool, rem: bool) -> int:
    """Co-resident block count of one kernel instance on ``device``."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.fused_grid_cg_max_blocks(int(lm), int(rem), BLOCK_THREADS, ctypes.byref(out))
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


def fused_grid_cg_kernel(meta, b, pre, lits, tol, *, guard_div=True, ctc=None,
                         reset_period=None, q_tolerance=None):
    """Launch the CUDA kernel on packed [C, N0, N1] float32 CUDA tensors:
    the GN instance, or the LM instance when ``ctc`` is given (with
    ``reset_period`` and ``q_tolerance``), each with the remainder phase
    when the meta has a remainder (``meta["rem"]``). Returns (delta, iters
    int32[1] on the device). Does not synchronise. Each launch adds one to
    ``fused_grid_cg_kernel.launches[instance]``, instance "gn", "lm",
    "gn_rem" or "lm_rem"."""
    from ._build import load_library

    F = meta["F"]
    rem = meta.get("rem")
    device = b.device
    if device.type != "cuda":
        raise ValueError(f"fused_grid_cg_kernel needs CUDA tensors, got {device}")
    lm = ctc is not None
    C, N0, N1 = (int(s) for s in b.shape)
    _check_operand("b", b, (C, N0, N1), torch.float32, device)
    _check_operand("pre", pre, (C, N0, N1), torch.float32, device)
    _check_operand("F", F, (F.shape[0], N0, N1), torch.float32, device)
    if lm:
        _check_operand("ctc", ctc, (C, N0, N1), torch.float32, device)
        if reset_period is None or q_tolerance is None or int(reset_period) < 1:
            raise ValueError(
                "fused_grid_cg_kernel: the LM loop needs reset_period >= 1 and "
                f"q_tolerance, got {reset_period} and {q_tolerance}"
            )
    nnz = 0
    if rem is not None:
        nnz = int(rem["col"].shape[0])
        if N0 != 1:
            raise ValueError("fused_grid_cg_kernel: a remainder needs the graph domain [1, N]")
        _check_operand("rowptr", rem["rowptr"], (N1 + 1,), torch.int32, device)
        _check_operand("col", rem["col"], (nnz,), torch.int32, device)
        _check_operand("blk", rem["blk"], (nnz, C, C), torch.float32, device)
        if nnz * C * C >= 2**31:
            raise ValueError("fused_grid_cg_kernel indexes with int32: remainder too large")
    n_triples = len(meta["triples"])
    if not 0 < n_triples <= MAX_TRIPLES or C > MAX_CHANNELS:
        raise ValueError(
            f"fused_grid_cg_kernel takes up to {MAX_TRIPLES} triples and "
            f"{MAX_CHANNELS} channels, got {n_triples} and {C}"
        )
    if any(not 0 <= fid < F.shape[0] for (_d, _i, _j, fid) in meta["triples"]):
        raise ValueError("fused_grid_cg_kernel: triple field id out of range")
    total = C * N0 * N1
    if total >= 2**31 or F.numel() >= 2**31:
        raise ValueError("fused_grid_cg_kernel indexes with int32: problem too large")
    lib = load_library()
    with_rem = rem is not None
    grid = min(_grid_size(lib, device, lm, with_rem), -(-total // BLOCK_THREADS))
    tr, starts = _device_triples(meta["triples"], int(meta["ctot"]), device)
    delta = torch.empty_like(b)
    r = torch.empty_like(b)
    p = torch.empty_like(b)
    Ap = torch.empty_like(b)
    part = torch.empty((3 if lm else 2, grid), dtype=torch.float64, device=device)
    iters = torch.empty(1, dtype=torch.int32, device=device)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    with torch.cuda.device(device):
        err = lib.fused_grid_cg_launch(
            int(lm), ptr(F), ptr(b), ptr(pre), ptr(ctc) if lm else None, ptr(tr), ptr(starts),
            ptr(rem["rowptr"]) if with_rem else None, ptr(rem["col"]) if with_rem else None,
            ptr(rem["blk"]) if with_rem else None,
            C, N0, N1, int(lits), ctypes.c_float(float(tol)), int(bool(guard_div)),
            int(reset_period) if lm else 0, ctypes.c_float(float(q_tolerance) if lm else 0.0),
            ptr(delta), ptr(r), ptr(p), ptr(Ap),
            ptr(part[0]), ptr(part[1]), ptr(part[2]) if lm else None, ptr(iters),
            grid, BLOCK_THREADS,
            ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream),
        )
    if err != 0:
        raise RuntimeError(f"fused_grid_cg kernel launch failed: CUDA error {err}")
    fused_grid_cg_kernel.launches[instance_name(lm, with_rem)] += 1
    return delta, iters


def reset_launch_counts():
    """Set the kernel's launch counts, one per instance, to 0."""
    fused_grid_cg_kernel.launches = {instance_name(lm, rem): 0 for lm in (False, True)
                                     for rem in (False, True)}


reset_launch_counts()


def pack(d, meta):
    """[*dom, C_u] per unknown -> channel-major packed [C, *kernel dom]
    (a graph's vertex axis [N] becomes [1, N])."""
    u_list = meta["u_list"]
    a = torch.cat([d[u] for u in u_list], dim=-1) if len(u_list) > 1 else d[u_list[0]]
    return torch.movedim(a, -1, 0).reshape((a.shape[-1],) + tuple(meta["F"].shape[1:])).contiguous()


def fused_grid_cg(meta, r0, pre, l_iterations, rz_tolerance, *, guard_div=True,
                  interpret=False, ctc=None, reset_period=None, q_tolerance=None):
    """Run the whole PCG loop; returns (delta dict, iterations executed as a
    0-dim int32 tensor). Packs [*dom, C] dicts channel-major (:func:`pack`).
    Passing ``ctc`` (a dict like ``pre``, with ``reset_period`` and
    ``q_tolerance``) runs the LM loop.

    CPU tensors, or ``interpret=True``, run the plain twin. CUDA tensors
    launch the kernel. Any other device raises."""
    b = pack(r0, meta)
    prem = pack(pre, meta)
    ctcm = pack(ctc, meta) if ctc is not None else None
    lm_kw = dict(ctc=ctcm, reset_period=reset_period, q_tolerance=q_tolerance)
    if interpret or b.device.type == "cpu":
        delta, l = fused_grid_cg_reference(
            meta["F"], meta["triples"], b, prem, l_iterations, rz_tolerance,
            guard_div=guard_div, rem=meta.get("rem"), **lm_kw,
        )
        iters = torch.full((), l, dtype=torch.int32, device=b.device)
    elif b.device.type == "cuda":
        delta, it = fused_grid_cg_kernel(
            meta, b, prem, l_iterations, rz_tolerance, guard_div=guard_div, **lm_kw
        )
        iters = it[0]
    else:
        raise ValueError(
            f"fused_grid_cg runs on CPU (plain twin) or CUDA (kernel) tensors, "
            f"not {b.device}"
        )
    spatial = tuple(r0[meta["u_list"][0]].shape[:-1])
    packed = torch.movedim(delta.reshape((delta.shape[0],) + spatial), 0, -1)
    out = {}
    for u in meta["u_list"]:
        o = meta["offs"][u]
        out[u] = packed[..., o : o + meta["channels"][u]]
    return out, iters
