"""The plan report: what a plan's linear solve runs, in place of the JAX
package's compiled-HLO dump.

The JAX package's ``Plan.dump_hlo`` prints the compiled XLA program of a
solve. The port has no such program: its nonlinear loop is Python and its
CG loop one hand-written kernel launch a step. So ``Plan.dump_hlo`` here
writes this report instead. It builds the first step's linear system as
the solve would, launches no CG loop and leaves the plan's state alone, and
says:

* the engaged path: the kernel, its plain twin (CPU tensors), the eager
  loop, the explicit J, the sharded loop (2-D tiles), the sharded 3-D loop
  (3-D tiles, whose apply is plain PyTorch), the sharded graph loop or the
  sharded composed loop (the composed operator on a mesh), and
  ``fused_fallback``;
* the CG instance (``fused_cg.launch_instance``) and its route's plan:
  ``tiled_grid_plan``'s layout, tiles and shared memory a block,
  ``graph_tile_plan``'s vertex ranges and halos, ``tiled_vol_plan``'s boxes
  or ``batch_team_plan``'s teams, or the template;
* the fields, the triples and the graph remainder's entries;
* where the kernel library is built, the instance's registers and spills
  from ptxas (``_build.instance_registers``), and on a mesh those of the
  per-tile apply (``tile_apply_kernel``);
* on a graph mesh, which launches no kernel, the rank's owner blocks and
  edge blocks and the width M (rows a pair of ranks) of each exchange: the
  per-edge reads of each slot (and of a split image read at a slot into
  another space), each group's incidence gather and its CG cross reads,
  and each coupling across vertex spaces' block gather and CG reads.
"""

from __future__ import annotations

import json
from typing import Any, Dict


from ..ops import fused_cg, sharded_cg

HEADER = ("opt_tpu_torch plan report (the port has no HLO: this is the first step's "
          "linear solve as this plan runs it)")


def _plain(v):
    """A plan entry as JSON: tuples as lists; None for objects."""
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    if isinstance(v, (tuple, list)) and all(isinstance(x, (bool, int, float, str)) for x in v):
        return list(v)
    return None


def _registers(path: str, instance: str) -> Dict[str, Any]:
    """The instance's (registers, spill store bytes, spill load bytes) from
    the built library's ptxas log, or None where it is not built here."""
    from ..ops import _build  # only where it is read: importing it builds nothing

    log = _build.built_log()
    if log is None:
        return {"registers": None, "spill_store_bytes": None, "spill_load_bytes": None}
    if path == "sharded loop":
        regs = _build.tile_apply_registers(log).get(instance)
    else:
        regs = {fused_cg.instance_name(*k): v
                for k, v in _build.instance_registers(log).items()}.get(instance)
    regs = regs or (None, None, None)
    return {"registers": regs[0], "spill_store_bytes": regs[1], "spill_load_bytes": regs[2]}


def plan_summary(plan, inputs, sp) -> Dict[str, Any]:
    """The report's content as a JSON-ready dict (see the module's
    docstring), at ``inputs`` and the solver parameters ``sp``. On a mesh
    every rank calls it together (the first step's cost is a sum over the
    ranks)."""
    solver = plan.solver
    unknowns, consts, graphs, params = plan._normalize_and_place(inputs)
    plan._validate_fused(unknowns, consts, graphs, params)
    state = solver.init(unknowns, consts, graphs, params, sp)
    s = solver._system(unknowns, solver._fs(consts, graphs, params), state, sp)
    kw = solver._fused_keywords(s)
    meta = s["meta"]
    fused = (meta is not None and solver._pallas_mode is not None
             and (s["pre_apply"] is None or kw["pre_blocks"] is not None))
    if plan.rules is not None and solver._stencil_plan is None:
        path = "sharded composed loop"
    elif getattr(plan.rules, "kind", None) == "graph":
        path = "sharded graph loop"
    elif plan.rules is not None:
        path = "sharded 3-D loop" if plan.rules.whole else "sharded loop"
    elif solver.ip.use_explicit_jtj:
        path = "explicit J"
    elif fused:
        on_card = plan.device.type == "cuda" and solver._pallas_mode == "auto"
        path = "kernel" if on_card else "plain twin"
    else:
        path = "eager loop"
    fallback = plan.fused_fallback
    if fallback is None and path == "eager loop" and solver.kernel_expected():
        fallback = "no_kernel"
    out = {"problem": plan.problem.name, "kind": plan.kind, "dims": dict(plan.dims),
           "device": str(plan.device), "dtype": str(plan.compiled.dtype).replace("torch.", ""),
           "path": path, "fused_fallback": fallback, "cg_variant": solver.ip.cg_variant,
           "preconditioner": solver.ip.preconditioner, "instance": None, "route": None}
    if path == "sharded graph loop":
        out["route"] = _graph_mesh_route(plan, graphs)
        if meta is not None:
            out.update(channels=sum(int(sp["ct"]) for sp in meta["spaces"]),
                       spaces={repr(sp["isp"]): int(sp["ct"]) for sp in meta["spaces"]},
                       groups=len(meta["groups"]),
                       dia_offsets=[len(g["dia"]) for g in meta["groups"]],
                       remainder_width=[0 if g["C"] is None else int(g["C"].shape[1])
                                        for g in meta["groups"]],
                       couplings=len(meta["pairs"]))
        return out
    if meta is not None:
        lead = 1 if meta.get("batch") else 0
        rem = meta.get("rem")
        out.update(fields=int(meta["F"].shape[lead]),
                   field_dtype=str(meta["F"].dtype).replace("torch.", ""),
                   channels=int(meta["ctot"]), triples=len(meta["triples"]),
                   remainder_nnz=0 if rem is None else int(rem["col"].shape[0]),
                   split=bool(meta.get("chan_grid")))
    if path in ("kernel", "plain twin"):
        b = fused_cg.pack(s["r0"], meta)
        pbm = None if kw["pre_blocks"] is None else fused_cg.pack_pre_blocks(kw["pre_blocks"],
                                                                               meta)
        lm, cs = kw.get("ctc") is not None, kw["cg_variant"] == "chronopoulos_gear"
        out["instance"] = fused_cg.launch_instance(meta, b, lm=lm, cs=cs, pre_blocks=pbm)
        route = fused_cg.route_plan(meta, b, lm=lm, cs=cs, pre_blocks=pbm)
        out["route"] = "template" if route is None else {
            k: _plain(v) for k, v in route.items() if _plain(v) is not None}
    elif path in ("sharded loop", "sharded 3-D loop"):
        # a 3-D tile's apply is plain PyTorch (ops/sharded_cg.py::tile_apply_reference)
        rules = plan.rules
        if path == "sharded loop":
            out["instance"] = sharded_cg.tile_instance(meta["F"])
        out["route"] = {"mesh": list(rules.mesh.shape), "rank": rules.mesh.rank,
                        "tile": [list(t) for t in rules.tile],
                        "region": [list(r) for r in rules.region], "halo": list(rules.halo),
                        "whole": list(rules.whole)}
    if out["instance"] is not None:
        out.update(_registers(path, out["instance"]))
    return out


def _graph_mesh_route(plan, graphs) -> Dict[str, Any]:
    """A graph mesh rank's blocks (vertices of each split space, edges of
    each graph) and the width M of each exchange."""
    rules = plan.rules
    out = {"mesh": list(rules.mesh.shape), "rank": rules.mesh.rank,
           "vertices": {repr(isp): list(rules.block(isp)) for isp in rules.spaces},
           "graphs": {}}
    for g, gd in sorted(graphs.items()):
        out["graphs"][g] = {
            "slot": {s: t["M"] for s, t in sorted(gd["__slot_halo__"].items())},
            "incidence": {gk: t["inc_M"] for gk, t in sorted(gd["__groups__"].items())},
            "cross": {gk: t["x_M"] for gk, t in sorted(gd["__groups__"].items())},
            "edges": list(gd["__edges__"]),
        }
        if gd.get("__split_read__"):
            out["graphs"][g]["split_read"] = {f"{s}@{sp}": t["M"] for (s, sp), t in
                                              sorted(gd["__split_read__"].items())}
        ell = gd.get("__ell__")
        if ell is not None:  # the couplings across vertex spaces
            out["graphs"][g]["coupling_blocks"] = {k: t["M"] for k, t in sorted(ell["inc"].items())}
            out["graphs"][g]["coupling_reads"] = {f"{ko}<-{ki}": t["M"] for (ko, ki), t in
                                                  sorted(ell["ell"].items())}
    return out


def format_report(summary: Dict[str, Any]) -> str:
    """The report's text: the header, then one ``key: value`` line an
    entry (dicts as JSON)."""
    lines = [HEADER]
    for k, v in summary.items():
        lines.append(f"{k}: {json.dumps(v) if isinstance(v, (dict, list)) else v}")
    return "\n".join(lines) + "\n"
