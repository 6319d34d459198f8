"""The PCG loops of an operator sharded over a mesh of ranks: a 2-D or 3-D
grid's (:func:`sharded_fused_grid_cg`, the counterpart of
``opt_tpu/ops/pallas_cg.py::sharded_fused_grid_cg``) and a graph's over its
owner blocks (:func:`sharded_graph_cg`).

A 3-D grid is split along its first two axes and keeps its third whole on
every rank: its tile [C, th, tw, D] takes the same two halo phases, and
its apply (:func:`tile_apply_reference`, plain PyTorch on every device)
reads the third axis's offsets inside the tile. The JAX package's sharded kernel
takes 2-D tiles only (pallas_cg.py:1239-1240) and runs XLA's loop there,
so there is no kernel of a 3-D tile to port.

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
loop is plain PyTorch too: each rank holds its owner blocks of every CG
vector (each vertex space's [B, ct], flattened one after another), and
an apply is one exchange of the p rows that the rank's cross reads need
(``parallel/mesh.py::halo_gather_many``: each group's DIA offsets and
remainder, and each coupling across spaces, through their tables) and
the block apply of the same-vertex blocks S, the DIA blocks, the
remainder's C and the couplings' W, in the JAX package's order
(opt_tpu/assembly.py:1627-1650).
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
from ..utils.timer import phase
from .shift import shift


def halo_widths(triples):
    """(ah, aw): the largest |offset| of the triples along each axis."""
    ah = max((abs(d[0]) for d, *_ in triples), default=0)
    aw = max((abs(d[1]) for d, *_ in triples), default=0)
    return ah, aw


def tile_apply_reference(F, triples, p_ext, ah: int, aw: int):
    """out[i] = Σ_t F[fid_t] · p_ext[j_t] read at (ah + dx_t, aw + dy_t) of
    the halo-extended tile p_ext [C, th + 2ah, tw + 2aw], by static slices,
    summed in the triples' order for each output channel (a bfloat16 F is
    widened exactly and multiplied in float32; float32 and float64 fields
    are taken as they are). Returns [C, th, tw]: the
    plain twin of the CUDA kernel. A 3-D tile (F [T, th, tw, D], p_ext
    [C, th + 2ah, tw + 2aw, D]) keeps its third axis whole, so a triple's
    third offset reads inside the tile, zero past its ends: the apply of a
    3-D tile on every device, as the JAX package's sharded kernel takes 2-D
    tiles only (opt_tpu/ops/pallas_cg.py:1239-1240)."""
    th, tw = int(F.shape[1]), int(F.shape[2])
    acc = [None] * int(p_ext.shape[0])
    sliced = {}
    for d, i, j, fid in triples:
        pk = sliced.get((d, j))
        if pk is None:
            pk = shift(p_ext[j, ah + d[0]:ah + d[0] + th, aw + d[1]:aw + d[1] + tw],
                       (0, 0) + tuple(d[2:]))
            sliced[(d, j)] = pk
        f = F[fid]
        t = (f.float() if f.dtype == torch.bfloat16 else f) * pk
        acc[i] = t if acc[i] is None else acc[i] + t
    zeros = p_ext.new_zeros(tuple(F.shape[1:]))
    return torch.stack([a if a is not None else zeros for a in acc])


# (fields' dtype, p's dtype) -> tile_apply_launch's ftype
_TILE_TYPES = {(torch.float32, torch.float32): 0, (torch.bfloat16, torch.float32): 1,
               (torch.float64, torch.float64): 2}


def tile_instance(F) -> str:
    """The instance of K5 that fields ``F`` launch."""
    return {torch.bfloat16: "tile_apply_kernel<__nv_bfloat16>",
            torch.float64: "tile_apply_kernel<double>"}.get(F.dtype, "tile_apply_kernel<float>")


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
    [T, th, tw] float32 or bfloat16 with p_ext [C, th + 2ah, tw + 2aw]
    float32 (``tile_apply_kernel<float>``, ``<__nv_bfloat16>``), or both
    float64 (``tile_apply_kernel<double>``). Returns out [C, th, tw] in
    p_ext's dtype; does not synchronise. Each launch adds one to
    ``tile_apply_kernel.launches``. A kernel that does not build or launch
    raises."""
    import torch.distributed as dist

    from ._build import load_library

    if p_ext.device.type != "cuda" or F.device != p_ext.device:
        raise ValueError(f"tile_apply_kernel needs CUDA tensors on one device, got "
                         f"{F.device} and {p_ext.device}")
    ftype = _TILE_TYPES.get((F.dtype, p_ext.dtype))
    if ftype is None:
        raise ValueError(f"tile_apply_kernel takes float32 or bfloat16 fields with a float32 "
                         f"p, or float64 fields with a float64 p, got {F.dtype} and "
                         f"{p_ext.dtype}")
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
    out = torch.empty((C, th, tw), dtype=p_ext.dtype, device=p_ext.device)
    with torch.cuda.device(p_ext.device):
        err = lib.tile_apply_launch(
            ftype, ctypes.c_void_p(F.data_ptr()),
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
    a 2-D grid whose F is the tile's fields [T, th, tw], or of a 3-D grid
    split along its first two axes, F [T, th, tw, D]; r0, pre and ctc are
    dicts of [th, tw, (D,) C_u] tiles, pre_blocks [th, tw, (D,) C, C];
    ``mesh`` the rank's :class:`~opt_tpu_torch.parallel.mesh.Mesh`. The
    keywords are ``fused_cg.fused_grid_cg``'s: ``ctc`` runs the LM loop,
    whose residual reset A·δ goes through the same halo; ``cg_variant``
    picks Chronopoulos–Gear, ``pre_blocks`` the block preconditioner. The
    apply of a 2-D tile is :func:`tile_apply` (``interpret``: the twin on
    every device), of a 3-D tile the twin on every device.
    Every rank of the mesh must call it together. Returns (delta dict of
    tiles, iterations as a 0-dim int32 tensor); a ``stats`` list receives
    {iterations, applies, kernel (False on a 3-D tile), loop, s (the loop's
    host seconds), all_reduce, p2p_phases} of the call."""
    if cg_variant not in CG_VARIANTS:
        raise ValueError(f"cg_variant must be one of {CG_VARIANTS}, got {cg_variant!r}")
    if meta.get("rem") is not None or meta.get("chan_grid") or meta.get("batch"):
        raise ValueError("sharded_fused_grid_cg takes a joint grid operator: no graph "
                         "remainder, no per-channel split, no batch")
    F = meta["F"]
    if F.dim() not in (3, 4):
        raise ValueError(f"sharded_fused_grid_cg takes grid fields [T, th, tw] or "
                         f"[T, th, tw, D], got {tuple(F.shape)}")
    vol = F.dim() == 4
    triples = tuple(meta["triples"])
    ah, aw = halo_widths(triples)
    b = pack(r0, meta)
    prec_m = _block_prec(pack_pre_blocks(pre_blocks, meta)) if pre_blocks is not None else None
    prem = pack(pre, meta) if pre_blocks is None else None
    ctcm = pack(ctc, meta) if ctc is not None else None
    kernel = not (interpret or vol) and b.device.type == "cuda"
    Fa = F.float() if F.dtype == torch.bfloat16 and not kernel else F
    op = tile_apply if kernel else tile_apply_reference
    applies = [0]
    before = dict(mesh.counts)

    def apply(p):
        pe = mesh.extend(mesh.extend(p, ah, 0), aw, 1)
        with phase("tileApply"):
            out = op(Fa, triples, pe, ah, aw)
        applies[0] += 1
        return out if ctcm is None else out + ctcm * p

    prec = prec_m or (lambda r: prem * r)
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
        stats.append({"iterations": l, "applies": applies[0], "kernel": kernel,
                      "loop": "sharded 3-D loop" if vol else "sharded loop",
                      "s": time.perf_counter() - t0,
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


def plan_sharded_graph_cg(compiled, plan, fields: Dict, grp_exec: Dict, mesh,
                          pair_exec: Optional[Dict] = None) -> Dict:
    """The meta of :func:`sharded_graph_cg` for a rank of a graph mesh,
    from its assembly (``assembly.assemble``'s centred fields, group
    executors and cross-space couplings, cut to the rank's owner blocks).
    ``spaces``: each vertex space that holds unknowns, in ``u_list`` order
    of their first unknown, {isp, u_list, offs (channel offsets in the
    space's packed [B, ct]), ct, n (the rank's block)}; the CG vectors are
    the spaces' packed blocks flattened one after another (``seg``: each
    space's slice).
    ``centered``: the centred fields (each at its own vertex: the mesh
    takes no offsets) as (space, out channel, in channel, field [B]) in the
    order the single-device loop's triples take them; ``groups``, each
    graph group's space, channel map ``gmap`` into its space's packed
    channels, its blocks S [B, ct²], the DIA blocks [B, ct²] and the
    remainder's C [B, Dm, ct²] (or None), its row mask [B, ct] (or None)
    and its cross-read exchange (send [ndev, M], loc [B, n_dia + Dm], the
    DIA reads first), None where it reads nothing of another vertex;
    ``pairs``, each coupling between slots of different vertex spaces:
    its out and in groups (indices into ``groups``), W [B_out, D, ct_out,
    ct_in] and the exchange of the in-group's p at each incident edge
    (send, loc [B_out, D])."""
    u_list = list(compiled.unknown_names)
    isp_of = {u: compiled.registry.images[u].ispace for u in u_list}
    channels = {u: compiled.unknown_shape(u)[-1] for u in u_list}
    spaces, space_of = [], {}
    for u in u_list:
        if isp_of[u] not in space_of:
            space_of[isp_of[u]] = len(spaces)
            spaces.append({"isp": isp_of[u], "u_list": [], "offs": {}, "ct": 0,
                           "n": int(compiled.unknown_shape(u)[0])})
        sp = spaces[space_of[isp_of[u]]]
        sp["u_list"].append(u)
        sp["offs"][u] = sp["ct"]
        sp["ct"] += channels[u]
    seg, o = [], 0
    for sp in spaces:
        seg.append((o, o + sp["n"] * sp["ct"]))
        o += sp["n"] * sp["ct"]
    centered = []
    for (u_out, u_in, _delta, i, j), f in sorted(fields.items()):
        sp = space_of[isp_of[u_out]]
        offs = spaces[sp]["offs"]
        if (u_out, u_in, _delta) in plan.scalar_groups:
            centered += [(sp, offs[u_out] + c, offs[u_in] + c, f) for c in range(channels[u_out])]
        else:
            centered.append((sp, offs[u_out] + i, offs[u_in] + j, f))
    groups, index = [], {}
    for key, ex in sorted(grp_exec.items()):
        g_ulist, _g_offs, ct = ex["layout"]
        sp = space_of[isp_of[g_ulist[0]]]
        offs = spaces[sp]["offs"]
        tabs = ex["tables"]
        index[key] = len(groups)
        groups.append({
            "space": sp, "ct": ct, "gmap": [offs[u] + c for u in g_ulist
                                            for c in range(channels[u])],
            "S": ex["S"], "dia": [W for _off, W in ex["dia"]], "C": ex["C"], "mask": ex["mask"],
            "send": tabs["x_send"], "loc": tabs["x_loc"], "n_dia": tabs["n_dia"],
            "M": tabs["x_M"],
        })
    # a slot coupled across spaces couples with itself too, so both ends of
    # a pair are groups above
    pairs = [{"out": index[pe["out"]], "in": index[pe["in"]], "W": pe["W"],
              "send": pe["ell"]["send"], "loc": pe["ell"]["loc"], "M": pe["ell"]["M"]}
             for _key, pe in sorted((pair_exec or {}).items())]
    return {"graph_mesh": True, "u_list": tuple(u_list), "channels": channels,
            "spaces": spaces, "seg": seg, "centered": centered, "groups": groups,
            "pairs": pairs, "mesh": mesh}


def _block_matvec(W_flat, pv, ct: int):
    """out[:, i] = Σ_j W_flat[:, i·ct + j] · pv[:, j] on flat [N, ct²] blocks
    (the assembled graph operator's apply, on one device or a rank's block)."""
    return torch.sum(W_flat.reshape(-1, ct, ct) * pv[:, None, :], dim=-1)


def split_spaces(meta: Dict, v: torch.Tensor) -> list:
    """A CG vector of :func:`sharded_graph_cg` (each space's packed block
    flattened, one after another) as each space's [B, ct] block."""
    return [v[a:b].reshape(sp["n"], sp["ct"]) for sp, (a, b) in zip(meta["spaces"], meta["seg"])]


def join_spaces(meta: Dict, blocks) -> torch.Tensor:
    """The inverse of :func:`split_spaces`."""
    return torch.cat([b.reshape(-1) for b in blocks])


def pack_spaces(meta: Dict, d: Dict) -> torch.Tensor:
    """A dict of per-unknown blocks [B_u, C_u] as a CG vector."""
    return join_spaces(meta, [torch.cat([d[u] for u in sp["u_list"]], dim=-1)
                              for sp in meta["spaces"]])


def unpack_spaces(meta: Dict, v: torch.Tensor) -> Dict:
    """A CG vector as a dict of per-unknown blocks [B_u, C_u]."""
    out = {}
    for sp, blk in zip(meta["spaces"], split_spaces(meta, v)):
        for u in sp["u_list"]:
            o = sp["offs"][u]
            out[u] = blk[:, o:o + meta["channels"][u]]
    return out


def graph_apply(meta: Dict, p: torch.Tensor) -> torch.Tensor:
    """A·p on this rank's owner blocks (a CG vector of
    :func:`sharded_graph_cg`: the rank's rows of the assembled JᵀJ·p): the
    centred fields, then each group's S·p, its DIA blocks and its remainder
    on p read from other ranks, then each cross-space coupling's W on the
    in-group's p at the incident edges, into the out-group's sum; each
    group's sum masked on both sides, in the single-device operator's order
    (assembly.py's apply). Every read of another rank's rows, of every
    group and coupling, rides one all_to_all (:func:`halo_gather_many`).
    Every rank calls it together."""
    from ..parallel.mesh import halo_gather_many

    mesh = meta["mesh"]
    ps = split_spaces(meta, p)
    cols = [[None] * sp["ct"] for sp in meta["spaces"]]

    def add(sp, i, v):
        cols[sp][i] = v if cols[sp][i] is None else cols[sp][i] + v

    for sp, i, j, f in meta["centered"]:
        add(sp, i, f * ps[sp][:, j])
    packed = []
    for grp in meta["groups"]:
        p_sp = ps[grp["space"]]
        pp = p_sp[:, grp["gmap"]] if grp["gmap"] != list(range(p_sp.shape[1])) else p_sp
        packed.append(pp if grp["mask"] is None else pp * grp["mask"])
    reqs = [(packed[k], grp["send"], grp["loc"]) for k, grp in enumerate(meta["groups"])
            if grp["loc"] is not None]
    reqs += [(packed[pr["in"]], pr["send"], pr["loc"]) for pr in meta["pairs"]]
    read = iter(halo_gather_many(mesh, reqs))
    acc = []
    for k, grp in enumerate(meta["groups"]):
        ct, pp = grp["ct"], packed[k]
        contrib = _block_matvec(grp["S"], pp, ct)
        if grp["loc"] is not None:
            pe = next(read)  # [B, n_dia + Dm, ct]
            for d, W in enumerate(grp["dia"]):
                contrib = contrib + _block_matvec(W, pe[:, d], ct)
            if grp["C"] is not None:
                pc = pe[:, grp["n_dia"]:]
                C = grp["C"].reshape(pc.shape[0], pc.shape[1], ct, ct)
                contrib = contrib + torch.sum(C * pc[:, :, None, :], dim=(1, 3))
        acc.append(contrib)
    for pr in meta["pairs"]:
        pg = next(read)  # [B_out, D, ct_in]
        contrib = torch.sum(pr["W"] * pg[:, :, None, :], dim=(1, 3))
        acc[pr["out"]] = acc[pr["out"]] + contrib
    for grp, contrib in zip(meta["groups"], acc):
        if grp["mask"] is not None:
            contrib = contrib * grp["mask"]
        for c, i in enumerate(grp["gmap"]):
            add(grp["space"], i, contrib[:, c])
    outs = []
    for blk, col in zip(ps, cols):
        zero = blk.new_zeros(blk.shape[:1])
        outs.append(torch.stack([c if c is not None else zero for c in col], dim=-1))
    return join_spaces(meta, outs)


def sharded_graph_cg(meta: Dict, mesh, r0, pre, l_iterations, rz_tolerance, *,
                     guard_div: bool = True, ctc=None, reset_period=None, q_tolerance=None,
                     pre_blocks=None, cg_variant: str = "standard",
                     stats: Optional[list] = None):
    """Run the PCG loop of this rank's owner blocks of a graph operator
    (``meta``: :func:`plan_sharded_graph_cg`); r0, pre and ctc are dicts of
    [B_u, C_u] blocks; pre_blocks a list of the inverted per-vertex blocks
    [B, ct, ct] (which are local) of each space, in ``meta["spaces"]``
    order. The keywords are ``fused_cg.fused_grid_cg``'s:
    ``ctc`` runs the LM loop, whose residual reset A·δ goes through the same
    exchange; ``cg_variant`` picks Chronopoulos–Gear. The loop algebra is
    ``fused_cg._run_cg``; its dots are float64 sums over the blocks reduced
    over the mesh (``Mesh.all_reduce_dots``), so every rank takes the same
    exits. Every rank of the mesh must call it together. Returns (delta
    dict of blocks, iterations as a 0-dim int32 tensor); a ``stats`` list
    receives {iterations, applies, kernel (False: no kernel), loop, s (the
    loop's host seconds), all_reduce, all_to_all, all_gather, p2p_phases}
    of the call."""
    if cg_variant not in CG_VARIANTS:
        raise ValueError(f"cg_variant must be one of {CG_VARIANTS}, got {cg_variant!r}")
    if not meta.get("graph_mesh"):
        raise ValueError("sharded_graph_cg takes plan_sharded_graph_cg's meta")
    b = pack_spaces(meta, r0)
    if pre_blocks is not None:
        def prec(r):
            return join_spaces(meta, [torch.sum(Minv * rs[:, None, :], dim=-1)
                                      for Minv, rs in zip(pre_blocks, split_spaces(meta, r))])
    else:
        prem = pack_spaces(meta, pre)
        prec = lambda r: prem * r  # noqa: E731
    ctcm = pack_spaces(meta, ctc) if ctc is not None else None
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
                      "loop": "sharded graph loop", "s": time.perf_counter() - t0,
                      **{k: mesh.counts[k] - before[k] for k in before}})
    return unpack_spaces(meta, delta), torch.tensor(l, dtype=torch.int32, device=b.device)


# ---------------------------------------------------------------------------
# The composed operator: any mesh
# ---------------------------------------------------------------------------


def sharded_composed_cg(apply, mesh, r0, pre, l_iterations, rz_tolerance, *,
                        guard_div: bool = True, ctc=None, reset_period=None, q_tolerance=None,
                        cg_variant: str = "standard", stats: Optional[list] = None):
    """Run the PCG loop of the composed operator Jᵀ(J·p) on this rank's
    part of the unknowns (``use_fused_jtj=False`` on a mesh): ``apply``
    maps a dict of the rank's tiles or owner blocks to Jᵀ(J·p) on them
    (exchanging what it reads of other ranks itself); r0, pre and ctc are
    dicts of the same. The JAX package runs XLA's loop on its composed
    operator there; this is the port's: the vectors are the dicts'
    tensors flattened into one, the loop algebra ``fused_cg._run_cg`` and
    its dots float64 sums reduced over the mesh (``Mesh.all_reduce_dots``),
    so every rank takes the same exits. No kernel: ``apply`` is autograd's
    J·p and Jᵀ·r. The keywords are ``fused_cg.fused_grid_cg``'s. Every rank
    of the mesh must call it together. Returns (delta dict, iterations as
    a 0-dim int32 tensor); a ``stats`` list receives {iterations, applies,
    kernel (False), loop "sharded composed loop", s (the loop's host
    seconds), all_reduce, all_to_all, all_gather, p2p_phases} of the call."""
    if cg_variant not in CG_VARIANTS:
        raise ValueError(f"cg_variant must be one of {CG_VARIANTS}, got {cg_variant!r}")
    names = list(r0)
    shapes = [tuple(r0[k].shape) for k in names]
    sizes = [int(r0[k].numel()) for k in names]

    def flat(d):
        return torch.cat([d[k].reshape(-1) for k in names])

    def unflat(v):
        return {k: t.reshape(sh) for k, t, sh in zip(names, torch.split(v, sizes), shapes)}

    b, prem = flat(r0), flat(pre)
    ctcm = flat(ctc) if ctc is not None else None
    applies = [0]
    before = dict(mesh.counts)

    def A(p):
        out = flat(apply(unflat(p)))
        applies[0] += 1
        return out if ctcm is None else out + ctcm * p

    lm = ctc is not None
    if lm and (reset_period is None or q_tolerance is None):
        raise ValueError("the LM loop needs reset_period and q_tolerance")
    t0 = time.perf_counter()
    delta, l = _run_cg(
        b, A, lambda r: prem * r, mesh.all_reduce_dot, l_iterations, rz_tolerance,
        guard_div=guard_div, reset_period=reset_period if lm else None,
        q_tol=q_tolerance if lm else None, cs=cg_variant == "chronopoulos_gear",
        dots=mesh.all_reduce_dots,
    )
    if stats is not None:
        stats.append({"iterations": l, "applies": applies[0], "kernel": False,
                      "loop": "sharded composed loop", "s": time.perf_counter() - t0,
                      **{k: mesh.counts[k] - before[k] for k in before}})
    return unflat(delta), torch.tensor(l, dtype=torch.int32, device=b.device)
