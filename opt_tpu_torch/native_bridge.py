"""Bridge between the C library (native/opttpu_torch.cpp) and opt_tpu_torch.

The reference embeds a LuaJIT/Terra VM inside ``libOpt.a`` and marshals
problem data positionally through ``void**`` (createwrapper.t:124-211;
util.t:664-692 initParameters). Here the C library embeds CPython and calls
the functions below; data pointers arrive as integer addresses, are wrapped
zero-copy with ctypes+numpy, copied, and placed on the plan's device.

Positional binding convention (native/include/OptTpu.h; the reference's
NamedParameters flattening, examples/shared/NamedParameters.h:34-47):

  dims[]:   one uint32 per Dim, in first-use order within the spec.
  params[]: for each image (declaration order): pointer to row-major
            float32 data of shape [*ispace, channels];
            then for each graph: pointer to int32 edge count, then one
            int32* index array per vertex slot;
            then for each scalar Param: pointer to float32.

The buffers are float32 under ``doublePrecision`` too: a float64 plan
computes in float64 and writes its unknowns back rounded to float32.

The plans' device is ``OPT_TPU_TORCH_DEVICE`` (``cpu`` or ``cuda``; unset:
``cuda``), read when the state is made. A plan on the card loads the kernel
library built beforehand (``python -m opt_tpu_torch.ops._build``) and never
compiles it: the embedded interpreter's executable is the C client.

Handles are small integers owned by this module (the reference keeps live
Lua objects in a registry the same way — o.t:836 activePlans).
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import time
from typing import Any, Dict, List

import numpy as np

DEVICE_ENV = "OPT_TPU_TORCH_DEVICE"

_OBJECTS: Dict[int, Any] = {}
_NEXT = [1]


def _register(obj) -> int:
    h = _NEXT[0]
    _NEXT[0] += 1
    _OBJECTS[h] = obj
    return h


def _get(h: int):
    return _OBJECTS[int(h)]


def _release(h: int):
    _OBJECTS.pop(int(h), None)


# -- Opt_NewState ------------------------------------------------------------


def new_state(double_precision: int, verbosity: int, collect_timing: int) -> int:
    from . import api

    return _register(
        api.new_state(bool(double_precision), int(verbosity), bool(collect_timing),
                      device=os.environ.get(DEVICE_ENV) or "cuda")
    )


def release_state(h: int) -> None:
    _release(h)


# -- Opt_ProblemDefine ---------------------------------------------------------


def _load_spec_fn(path: str):
    """Load a spec function from a Python energy file — the analogue of the
    reference loading a .t energy file (o.t:840-853 problemSpecFromFile).
    The file must define a function named ``spec`` or exactly one public
    function taking the spec object ``S``."""
    spec = importlib.util.spec_from_file_location("opt_energy_spec", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if hasattr(mod, "spec"):
        return mod.spec
    fns = [
        v
        for k, v in vars(mod).items()
        if callable(v) and not k.startswith("_") and getattr(v, "__module__", "") == mod.__name__
    ]
    if len(fns) != 1:
        raise ValueError(
            f"{path}: define a function named 'spec' (found {len(fns)} candidates)"
        )
    return fns[0]


def problem_define(state_h: int, path: str, kind: str) -> int:
    from . import api

    return _register(api.problem_define(_get(state_h), _load_spec_fn(path), kind))


def problem_delete(state_h: int, problem_h: int) -> None:
    from . import api

    api.problem_delete(_get(state_h), _get(problem_h))
    _release(problem_h)


# -- Opt_ProblemPlan -------------------------------------------------------------


def problem_plan(state_h: int, problem_h: int, dims_ptr: int, n_dims: int) -> int:
    import torch

    from . import api
    from .compile import compile_spec

    problem = _get(problem_h)
    state = _get(state_h)
    sizes = np.ctypeslib.as_array(
        ctypes.cast(dims_ptr, ctypes.POINTER(ctypes.c_uint32)), shape=(n_dims,)
    )
    # discover Dim names in declaration order with a wildcard probe compile
    probe = compile_spec(problem.spec_fn, {"*": 4}, torch.float32)
    names = probe.registry.dim_order
    if len(names) != n_dims:
        raise ValueError(f"spec declares {len(names)} dims, C passed {n_dims}")
    dims = {name: int(sizes[i]) for i, name in enumerate(names)}
    plan = api.problem_plan(state, problem, dims)
    if plan.device.type == "cuda":
        from .ops._build import load_library

        load_library(build=False)
    return _register(plan)


def plan_free(plan_h: int) -> None:
    from . import api

    api.plan_free(_get(plan_h))
    _release(plan_h)


# -- parameter marshaling ---------------------------------------------------------


def _wrap_float(ptr: int, shape) -> np.ndarray:
    n = int(np.prod(shape))
    arr = np.ctypeslib.as_array(
        ctypes.cast(int(ptr), ctypes.POINTER(ctypes.c_float)), shape=(n,)
    )
    return arr.reshape(shape)


def _wrap_int32(ptr: int, n: int) -> np.ndarray:
    return np.ctypeslib.as_array(
        ctypes.cast(int(ptr), ctypes.POINTER(ctypes.c_int32)), shape=(int(n),)
    )


def _assemble_inputs(plan, ptrs: List[int]) -> Dict[str, Any]:
    reg = plan.compiled.registry
    dims = plan.compiled.dim_sizes
    inputs: Dict[str, Any] = {}
    i = 0
    for name, decl in reg.images.items():
        if decl.alias is not None:
            continue
        shape = decl.ispace.shape(dims) + (decl.channels,)
        inputs[name] = _wrap_float(ptrs[i], shape).copy()
        i += 1
    for gname, g in reg.graphs.items():
        count = int(_wrap_int32(ptrs[i], 1)[0])
        i += 1
        slots = {}
        for sname in g.slots:
            slots[sname] = _wrap_int32(ptrs[i], count).copy()
            i += 1
        inputs[gname] = slots
    for pname in reg.params:
        inputs[pname] = float(_wrap_float(ptrs[i], (1,))[0])
        i += 1
    if i != len(ptrs):
        raise ValueError(f"expected {i} data pointers, got {len(ptrs)}")
    return inputs


def _bind(plan, ptrs: List[int]) -> Dict[str, Any]:
    """Keep the caller's pointers, the inputs read from them, the kernel
    launch counts so far and the time on the plan (for the write-back and
    the log)."""
    from .ops import fused_cg

    plan._native_t0 = time.perf_counter()
    plan._native_ptrs = list(ptrs)
    plan._native_inputs = _assemble_inputs(plan, list(ptrs))
    plan._native_launches = dict(fused_cg.fused_grid_cg_kernel.launches)
    return plan._native_inputs


def problem_init(plan_h: int, ptrs: List[int]) -> None:
    plan = _get(plan_h)
    plan.init(_bind(plan, ptrs))


def problem_step(plan_h: int) -> int:
    plan = _get(plan_h)
    cont = plan.step()
    if not cont:
        _writeback(plan)
        _log_solve(plan)
    return 1 if cont else 0


def problem_solve(plan_h: int, ptrs: List[int]) -> int:
    plan = _get(plan_h)
    plan.solve(_bind(plan, ptrs))
    _writeback(plan)
    _log_solve(plan)
    return 0


def _writeback(plan) -> None:
    """Copy solved unknowns back into the caller's float32 buffers (the
    reference solver updates parameters.X in place on the GPU; C clients
    then read the same buffer). ``.cpu()`` waits for the card."""
    ptrs = getattr(plan, "_native_ptrs", None)
    if ptrs is None or plan._state is None:
        return
    reg = plan.compiled.registry
    dims = plan.compiled.dim_sizes
    unknowns = plan.unknowns
    i = 0
    for name, decl in reg.images.items():
        if decl.alias is not None:
            continue
        if decl.kind == "unknown":
            shape = decl.ispace.shape(dims) + (decl.channels,)
            dst = _wrap_float(ptrs[i], shape)
            dst[...] = unknowns[name].detach().cpu().numpy().astype(np.float32).reshape(shape)
        i += 1


def _log_solve(plan) -> None:
    """At verbosity >= 1, one JSON line on stdout after a solve ends: the
    plan's summary (``utils/plan_report.py``: the engaged path,
    ``fused_fallback``, the CG instance and its route), the kernel launches
    this solve made by instance, the final cost and the seconds from the
    inputs' binding to the end of the write-back."""
    from .ops import fused_cg
    from .utils.logging import log_result, verbosity
    from .utils.plan_report import plan_summary

    if verbosity() < 1:
        return
    wall = time.perf_counter() - plan._native_t0
    before = getattr(plan, "_native_launches", {})
    launches = {k: v - before.get(k, 0) for k, v in fused_cg.fused_grid_cg_kernel.launches.items()
                if v != before.get(k, 0)}
    summary = plan_summary(plan, plan._native_inputs, plan.solver_params)
    log_result(json.dumps({"c_api_solve": {**summary, "launches": launches,
                                           "final_cost": plan.current_cost(),
                                           "wall_s": wall}}))


def current_cost(plan_h: int) -> float:
    return float(_get(plan_h).current_cost())


def set_solver_parameter(plan_h: int, name: str, value: float) -> None:
    _get(plan_h).set_solver_parameter(name, value)
