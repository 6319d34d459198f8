"""The PCG loops of an operator sharded over a mesh of ranks: a 2-D grid's
(:func:`sharded_fused_grid_cg`, the counterpart of
``opt_tpu/ops/pallas_cg.py::sharded_fused_grid_cg``) and a graph's over its
owner blocks (:func:`sharded_graph_cg`).

Each rank holds a tile [C, th, tw] of every CG vector and the tile of the
operator's fields. An iteration extends the search direction by the
stencil's halo from the neighbouring tiles (two P2P phases,
``parallel/mesh.py::Mesh.extend``: rows, then columns of the row-extended
tile, so the corners come along), applies the operator to the tile
(:func:`tile_apply`: the CUDA kernel ``csrc/tile_apply.cu`` on the card,
its plain twin :func:`tile_apply_reference` on the CPU), and reduces its
dots over the mesh in one float64 all_reduce per point of the iteration.
The loop algebra is ``fused_cg._run_cg``, the one driver of the
single-device twin, so the exits and the counted iterations are those of
the single-device loop up to the dots' summation order. Unlike the
single-device kernel, the loop is on the host here: one apply launch an
iteration, the vector updates in PyTorch.

The apply's kernel gives a thread one channel of one column over two rows
of the tile, summing each channel's triples in the table's order; the
table (:func:`_launch_table`, host arrays) goes to the kernel as a launch
parameter, so no block waits on a load of it before its own loads.

On a graph mesh the JAX package runs XLA's loop on the assembled operator
(it plans no graph kernel under a mesh, opt_tpu/assembly.py:2070, and its
sharded kernel declines graphs, pallas_cg.py:1233), so the port's graph
loop is plain PyTorch too: each rank holds its owner block of every CG
vector [B, C], and an apply is one exchange of p's rows that the rank's
cross reads need (``parallel/mesh.py::halo_gather``: each DIA offset's
read and the remainder's, through one table) and the block apply of the
same-vertex blocks S, the DIA blocks and the remainder's C, in the JAX
package's order (opt_tpu/assembly.py:1627-1650).
"""

from __future__ import annotations

import ctypes
import functools
import time
from typing import Dict, Optional

import torch

from .fused_cg import (
    CG_VARIANTS,
    MAX_CHANNELS,
    MAX_TRIPLES,
    _block_prec,
    _run_cg,
    pack,
    pack_pre_blocks,
)


def halo_widths(triples):
    """(ah, aw): the largest |offset| of the triples along each axis."""
    ah = max((abs(d[0]) for d, *_ in triples), default=0)
    aw = max((abs(d[1]) for d, *_ in triples), default=0)
    return ah, aw


def tile_apply_reference(F, triples, p_ext, ah: int, aw: int):
    """out[i] = Σ_t F[fid_t] · p_ext[j_t] read at (ah + dx_t, aw + dy_t) of
    the halo-extended tile p_ext [C, th + 2ah, tw + 2aw], by static slices,
    summed in the triples' order for each output channel (a bfloat16 F is
    widened exactly and multiplied in float32). Returns [C, th, tw]: the
    plain twin of the CUDA kernel."""
    th, tw = int(F.shape[1]), int(F.shape[2])
    acc = [None] * int(p_ext.shape[0])
    sliced = {}
    for (dx, dy), i, j, fid in triples:
        pk = sliced.get((dx, dy, j))
        if pk is None:
            pk = p_ext[j, ah + dx:ah + dx + th, aw + dy:aw + dy + tw]
            sliced[(dx, dy, j)] = pk
        t = F[fid].float() * pk
        acc[i] = t if acc[i] is None else acc[i] + t
    zeros = p_ext.new_zeros((th, tw))
    return torch.stack([a if a is not None else zeros for a in acc])


@functools.lru_cache(maxsize=32)
def _launch_table(triples, C: int):
    """The triples sorted stably by output channel as int32 rows (dx, dy, j,
    fid), and the per-channel row starts [C + 1], as host arrays, which the
    launch turns into the kernel's parameter; cached by value (the same
    every CG iteration)."""
    rows = sorted(triples, key=lambda t: t[1])
    starts = [0] * (C + 1)
    for _d, i, _j, _f in rows:
        starts[i + 1] += 1
    for c in range(C):
        starts[c + 1] += starts[c]
    flat = [v for d, _i, j, f in rows for v in (int(d[0]), int(d[1]), int(j), int(f))]
    return (ctypes.c_int * len(flat))(*flat), (ctypes.c_int * len(starts))(*starts)


def tile_apply_kernel(F, triples, p_ext, ah: int, aw: int):
    """Launch the CUDA kernel (``csrc/tile_apply.cu``) on CUDA tensors: F
    [T, th, tw] float32 or bfloat16, p_ext [C, th + 2ah, tw + 2aw] float32.
    Returns out [C, th, tw]; does not synchronise. Each launch adds one to
    ``tile_apply_kernel.launches``. A kernel that does not build or launch
    raises."""
    import torch.distributed as dist

    from ._build import load_library

    if p_ext.device.type != "cuda" or F.device != p_ext.device:
        raise ValueError(f"tile_apply_kernel needs CUDA tensors on one device, got "
                         f"{F.device} and {p_ext.device}")
    if F.dtype not in (torch.float32, torch.bfloat16) or p_ext.dtype != torch.float32:
        raise ValueError(f"tile_apply_kernel takes float32 or bfloat16 fields and a float32 "
                         f"p, got {F.dtype} and {p_ext.dtype}")
    if F.dim() != 3 or p_ext.dim() != 3:
        raise ValueError(f"tile_apply_kernel takes F [T, th, tw] and p_ext [C, rows, cols], "
                         f"got {tuple(F.shape)} and {tuple(p_ext.shape)}")
    C, th, tw = int(p_ext.shape[0]), int(F.shape[1]), int(F.shape[2])
    if tuple(p_ext.shape) != (C, th + 2 * ah, tw + 2 * aw):
        raise ValueError(f"tile_apply_kernel: p_ext {tuple(p_ext.shape)} is not the tile "
                         f"{(th, tw)} of F {tuple(F.shape)} extended by ({ah}, {aw})")
    if not (0 < len(triples) <= MAX_TRIPLES and C <= MAX_CHANNELS):
        raise ValueError(f"tile_apply_kernel takes up to {MAX_TRIPLES} triples and "
                         f"{MAX_CHANNELS} channels, got {len(triples)} and {C}")
    if any(not (0 <= f < F.shape[0] and 0 <= i < C and 0 <= j < C and abs(d[0]) <= ah
                and abs(d[1]) <= aw) for d, i, j, f in triples):
        raise ValueError("tile_apply_kernel: a triple's field, channel or offset is out of range")
    if p_ext.numel() >= 2**31 or F.numel() >= 2**31:
        raise ValueError("tile_apply_kernel indexes with int32: tile too large")
    F, p_ext = F.contiguous(), p_ext.contiguous()
    # the ranks of a world load the library their launcher built
    alone = not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1
    lib = load_library(build=alone)
    table, starts = _launch_table(tuple(triples), C)
    out = torch.empty((C, th, tw), dtype=torch.float32, device=p_ext.device)
    with torch.cuda.device(p_ext.device):
        err = lib.tile_apply_launch(
            int(F.dtype == torch.bfloat16), ctypes.c_void_p(F.data_ptr()),
            ctypes.c_void_p(p_ext.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            ctypes.cast(table, ctypes.c_void_p), ctypes.cast(starts, ctypes.c_void_p),
            len(triples), C, th, tw, int(ah), int(aw),
            ctypes.c_void_p(torch.cuda.current_stream(p_ext.device).cuda_stream),
        )
    if err != 0:
        raise RuntimeError(f"tile_apply kernel launch failed: CUDA error {err}")
    tile_apply_kernel.launches += 1
    return out


tile_apply_kernel.launches = 0


def reset_launch_counts() -> None:
    """Set the tile kernel's launch count to 0."""
    tile_apply_kernel.launches = 0


def tile_apply(F, triples, p_ext, ah: int, aw: int):
    """The per-tile apply: the CUDA kernel on CUDA tensors, the plain twin
    on CPU tensors; any other device raises."""
    if p_ext.device.type == "cuda":
        return tile_apply_kernel(F, triples, p_ext, ah, aw)
    if p_ext.device.type == "cpu":
        return tile_apply_reference(F, triples, p_ext, ah, aw)
    raise ValueError(f"tile_apply runs on CPU (plain twin) or CUDA (kernel) tensors, "
                     f"not {p_ext.device}")


def sharded_fused_grid_cg(meta: Dict, mesh, r0, pre, l_iterations, rz_tolerance, *,
                          guard_div: bool = True, interpret: bool = False, ctc=None,
                          reset_period=None, q_tolerance=None, pre_blocks=None,
                          cg_variant: str = "standard", stats: Optional[list] = None):
    """Run the PCG loop of this rank's tile: ``meta`` is a fused-CG meta of
    a 2-D grid whose F is the tile's fields [T, th, tw]; r0, pre and ctc
    are dicts of [th, tw, C_u] tiles, pre_blocks [th, tw, C, C]; ``mesh``
    the rank's :class:`~opt_tpu_torch.parallel.mesh.Mesh`. The keywords
    are ``fused_cg.fused_grid_cg``'s: ``ctc`` runs the LM loop, whose
    residual reset A·δ goes through the same halo; ``cg_variant`` picks
    Chronopoulos–Gear, ``pre_blocks`` the block preconditioner. The apply
    is :func:`tile_apply` (``interpret``: the twin on every device). Every
    rank of the mesh must call it together. Returns (delta dict of tiles,
    iterations as a 0-dim int32 tensor); a ``stats`` list receives
    {iterations, applies, kernel, all_reduce, p2p_phases} of the call."""
    if cg_variant not in CG_VARIANTS:
        raise ValueError(f"cg_variant must be one of {CG_VARIANTS}, got {cg_variant!r}")
    if meta.get("rem") is not None or meta.get("chan_grid") or meta.get("batch"):
        raise ValueError("sharded_fused_grid_cg takes a joint 2-D grid operator: no graph "
                         "remainder, no per-channel split, no batch")
    F = meta["F"]
    if F.dim() != 3:
        raise ValueError(f"sharded_fused_grid_cg takes 2-D grid fields [T, th, tw], got "
                         f"{tuple(F.shape)}")
    triples = tuple(meta["triples"])
    ah, aw = halo_widths(triples)
    b = pack(r0, meta)
    prec_m = _block_prec(pack_pre_blocks(pre_blocks, meta)) if pre_blocks is not None else None
    prem = pack(pre, meta) if pre_blocks is None else None
    ctcm = pack(ctc, meta) if ctc is not None else None
    kernel = not interpret and b.device.type == "cuda"
    Fa = F if kernel else F.float()
    op = tile_apply_reference if interpret else tile_apply
    applies = [0]
    before = dict(mesh.counts)

    def apply(p):
        pe = mesh.extend(mesh.extend(p, ah, 0), aw, 1)
        out = op(Fa, triples, pe, ah, aw)
        applies[0] += 1
        return out if ctcm is None else out + ctcm * p

    prec = prec_m or (lambda r: prem * r)
    lm = ctc is not None
    if lm and (reset_period is None or q_tolerance is None):
        raise ValueError("the LM loop needs reset_period and q_tolerance")
    delta, l = _run_cg(
        b, apply, prec, mesh.all_reduce_dot, l_iterations, rz_tolerance, guard_div=guard_div,
        reset_period=reset_period if lm else None, q_tol=q_tolerance if lm else None,
        cs=cg_variant == "chronopoulos_gear", dots=mesh.all_reduce_dots,
    )
    if stats is not None:
        stats.append({"iterations": l, "applies": applies[0], "kernel": kernel,
                      **{k: mesh.counts[k] - before[k] for k in before}})
    packed = delta.movedim(0, -1)
    out = {}
    for u in meta["u_list"]:
        o = meta["offs"][u]
        out[u] = packed[..., o:o + meta["channels"][u]]
    return out, torch.tensor(l, dtype=torch.int32, device=b.device)


# ---------------------------------------------------------------------------
# Graphs: the owner blocks' loop
# ---------------------------------------------------------------------------


def plan_sharded_graph_cg(compiled, plan, fields: Dict, grp_exec: Dict, mesh) -> Dict:
    """The meta of :func:`sharded_graph_cg` for a rank of a graph mesh,
    from its assembly (``assembly.assemble``'s centred fields and group
    executors, cut to the rank's owner block): the unknowns packed [B, C]
    in ``u_list`` order on their one vertex space; ``centered``, the
    centred fields (each at its own vertex: the mesh takes no offsets) as
    (out channel, in channel, field [B]) in the order the single-device
    loop's triples take them; ``groups``, each graph group's channel map
    ``gmap`` into the packed channels, its blocks S [B, ct²], the DIA
    blocks [B, ct²] and the remainder's C [B, Dm, ct²] (or None), its row
    mask [B, ct] (or None) and its cross-read exchange (send [ndev, M],
    loc [B, n_dia + Dm], the DIA reads first), None where it reads
    nothing of another vertex."""
    u_list = list(compiled.unknown_names)
    (isp,) = {compiled.registry.images[u].ispace for u in u_list}
    channels = {u: compiled.unknown_shape(u)[-1] for u in u_list}
    offs, ctot = {}, 0
    for u in u_list:
        offs[u] = ctot
        ctot += channels[u]
    centered = []
    for (u_out, u_in, _delta, i, j), f in sorted(fields.items()):
        if (u_out, u_in, _delta) in plan.scalar_groups:
            centered += [(offs[u_out] + c, offs[u_in] + c, f) for c in range(channels[u_out])]
        else:
            centered.append((offs[u_out] + i, offs[u_in] + j, f))
    groups = []
    for _key, ex in sorted(grp_exec.items()):
        g_ulist, g_offs, ct = ex["layout"]
        gmap = [offs[u] + c for u in g_ulist for c in range(channels[u])]
        tabs = ex["tables"]
        groups.append({
            "ct": ct, "gmap": gmap, "S": ex["S"], "dia": [W for _off, W in ex["dia"]],
            "C": ex["C"], "mask": ex["mask"], "send": tabs["x_send"], "loc": tabs["x_loc"],
            "n_dia": tabs["n_dia"], "M": tabs["x_M"],
        })
    return {"graph_mesh": True, "u_list": tuple(u_list), "offs": offs, "channels": channels,
            "ctot": ctot, "isp": isp, "n": int(compiled.unknown_shape(u_list[0])[0]),
            "centered": centered, "groups": groups, "mesh": mesh}


def _block_matvec(W_flat, pv, ct: int):
    """out[:, i] = Σ_j W_flat[:, i·ct + j] · pv[:, j] on flat [N, ct²] blocks
    (the assembled graph operator's apply, on one device or a rank's block)."""
    return torch.sum(W_flat.reshape(-1, ct, ct) * pv[:, None, :], dim=-1)


def graph_apply(meta: Dict, p: torch.Tensor) -> torch.Tensor:
    """A·p on this rank's owner block p [B, C] (the rank's rows of the
    assembled JᵀJ·p): the centred fields, then each group's S·p, its DIA
    blocks and its remainder on p read through the group's exchange (one
    all_to_all of the mesh a group that reads another vertex), each
    group's sum masked on both sides. Every rank calls it together."""
    mesh = meta["mesh"]
    cols = [None] * meta["ctot"]

    def add(i, v):
        cols[i] = v if cols[i] is None else cols[i] + v

    for i, j, f in meta["centered"]:
        add(i, f * p[:, j])
    for grp in meta["groups"]:
        ct, mask = grp["ct"], grp["mask"]
        pp = p[:, grp["gmap"]] if grp["gmap"] != list(range(meta["ctot"])) else p
        if mask is not None:
            pp = pp * mask
        contrib = _block_matvec(grp["S"], pp, ct)
        if grp["loc"] is not None:
            from ..parallel.mesh import halo_gather

            pe = halo_gather(mesh, pp, grp["send"], grp["loc"])  # [B, n_dia + Dm, ct]
            for k, W in enumerate(grp["dia"]):
                contrib = contrib + _block_matvec(W, pe[:, k], ct)
            if grp["C"] is not None:
                pc = pe[:, grp["n_dia"]:]
                C = grp["C"].reshape(pc.shape[0], pc.shape[1], ct, ct)
                contrib = contrib + torch.sum(C * pc[:, :, None, :], dim=(1, 3))
        if mask is not None:
            contrib = contrib * mask
        for c, i in enumerate(grp["gmap"]):
            add(i, contrib[:, c])
    zero = p.new_zeros(p.shape[:1])
    return torch.stack([c if c is not None else zero for c in cols], dim=-1)


def sharded_graph_cg(meta: Dict, mesh, r0, pre, l_iterations, rz_tolerance, *,
                     guard_div: bool = True, ctc=None, reset_period=None, q_tolerance=None,
                     pre_blocks=None, cg_variant: str = "standard",
                     stats: Optional[list] = None):
    """Run the PCG loop of this rank's owner block of a graph operator
    (``meta``: :func:`plan_sharded_graph_cg`); r0, pre and ctc are dicts of
    [B, C_u] blocks, pre_blocks [B, C, C] (the inverted per-vertex blocks,
    which are local). The keywords are ``fused_cg.fused_grid_cg``'s:
    ``ctc`` runs the LM loop, whose residual reset A·δ goes through the same
    exchange; ``cg_variant`` picks Chronopoulos–Gear. The loop algebra is
    ``fused_cg._run_cg``; its dots are float64 sums over the block reduced
    over the mesh (``Mesh.all_reduce_dots``), so every rank takes the same
    exits. Every rank of the mesh must call it together. Returns (delta
    dict of blocks, iterations as a 0-dim int32 tensor); a ``stats`` list
    receives {iterations, applies, kernel (False: no kernel), s (the
    loop's host seconds), all_reduce, all_to_all, all_gather, p2p_phases}
    of the call."""
    if cg_variant not in CG_VARIANTS:
        raise ValueError(f"cg_variant must be one of {CG_VARIANTS}, got {cg_variant!r}")
    if not meta.get("graph_mesh"):
        raise ValueError("sharded_graph_cg takes plan_sharded_graph_cg's meta")
    u_list = meta["u_list"]

    def pack(d):
        return torch.cat([d[u] for u in u_list], dim=-1) if len(u_list) > 1 else d[u_list[0]]

    b = pack(r0)
    if pre_blocks is not None:
        Minv = pre_blocks
        prec = lambda r: torch.sum(Minv * r[:, None, :], dim=-1)  # noqa: E731
    else:
        prem = pack(pre)
        prec = lambda r: prem * r  # noqa: E731
    ctcm = pack(ctc) if ctc is not None else None
    applies = [0]
    before = dict(mesh.counts)

    def apply(p):
        out = graph_apply(meta, p)
        applies[0] += 1
        return out if ctcm is None else out + ctcm * p

    lm = ctc is not None
    if lm and (reset_period is None or q_tolerance is None):
        raise ValueError("the LM loop needs reset_period and q_tolerance")
    t0 = time.perf_counter()
    delta, l = _run_cg(
        b, apply, prec, mesh.all_reduce_dot, l_iterations, rz_tolerance, guard_div=guard_div,
        reset_period=reset_period if lm else None, q_tol=q_tolerance if lm else None,
        cs=cg_variant == "chronopoulos_gear", dots=mesh.all_reduce_dots,
    )
    if stats is not None:
        # s: the loop's host seconds (it reads one exit flag an iteration)
        stats.append({"iterations": l, "applies": applies[0], "kernel": False,
                      "s": time.perf_counter() - t0,
                      **{k: mesh.counts[k] - before[k] for k in before}})
    out, o = {}, 0
    for u in u_list:
        out[u] = delta[:, o:o + meta["channels"][u]]
        o += meta["channels"][u]
    return out, torch.tensor(l, dtype=torch.int32, device=b.device)
