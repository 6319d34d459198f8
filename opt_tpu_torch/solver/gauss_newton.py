"""Gauss-Newton / Levenberg-Marquardt solver with Jacobi-preconditioned CG.

PyTorch counterpart of ``opt_tpu/solver/gauss_newton.py`` (the reference's
"gaussNewtonGPU" and "LMGPU" plan kinds), with the same numerics:

* PCGInit1: delta=0, r=-JᵀF, p=M⁻¹r with the guarded invert, rᵀz;
* PCGStep1/2/3: α=rᵀz/pᵀAp (guarded), x/r updates, β=rᵀz_new/rᵀz_old,
  exit on the rᵀz floor or pᵀAp ≤ 0 (GN);
* LM: A = JᵀJ + CtC with CtC = diag(JᵀJ)/radius Jacobi-scaled and clamped,
  the preconditioner 1/(CtC + radius·CtC_unclamped), the residual reset
  r = b − A·δ every ``residual_reset_period`` iterations, the Q/ζ exit, and
  the trust-region accept/reject with the function-tolerance and
  min-radius exits;
* the solver variants: ``cg_variant="chronopoulos_gear"`` (the
  single-reduction recurrence of ``_cs_recurrence``),
  ``preconditioner="block_jacobi"`` (per-point inverses of the assembled
  Δ=0 blocks; under LM of the damped blocks B + diag(CtC)) and
  ``coefficient_dtype`` (narrowed storage of the assembled coefficients).

The JAX package runs a whole solve as one XLA program. Here the nonlinear
loop runs on the host with one device→host read per nonlinear step; the CG
loop runs either as one CUDA kernel launch (ops/fused_cg.py; the plain twin
on the CPU) or as the eager loop of ``_run_cg`` on the assembled operator.
A batch of instances (:meth:`GaussNewtonSolver.solve_batched`, the JAX
package's ``_solve_fused_batched``) assembles every instance's system at
once under ``torch.func.vmap`` and solves them by one batched CG launch a
step. Under a mesh of ranks (``sharding_rules``: ``parallel/mesh.py``)
each rank's solver works on its extended region and runs the sharded loop
(ops/sharded_cg.py) on its tile. ``use_explicit_jtj=True`` applies JᵀJ
as two sparse matvecs of an explicit J (explicit.py) in the eager loop.
"""

from __future__ import annotations

import sys
from collections import OrderedDict
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from ..compile import CompiledProblem
from ..functions import FunctionSet, tree_dot
from ..ops import fused_cg
from ..ops.fused_cg import (
    CG_VARIANTS,
    _run_cg,
    coefficient_dtype,
    fused_grid_cg,
)
from ..ops.sharded_cg import sharded_composed_cg, sharded_fused_grid_cg, sharded_graph_cg
from ..utils.timer import active as timing_active
from ..utils.timer import note_cg, phase
from .params import (
    FLOAT_EPSILON,
    GuardedInvertType,
    InitializationParameters,
    JacobiScalingType,
    resolve_auto_policy,
)

_EXPLICIT_STRUCTURES_MAX = 4  # topologies whose explicit J structure is kept


def _f32(v) -> float:
    """A solver parameter as the JAX package traces it: rounded to float32."""
    return float(np.float32(v))


def _vmap(fn, in_dims):
    """``torch.func.vmap`` of ``fn`` whose result may hold non-tensor leaves
    (a fused CG meta's triples and layout, a const cache's slot ids): only
    the tensors leave the transform, batched on axis 0; the other leaves
    are taken as the one trace made them, so they must not depend on the
    instance. Nothing batched is stored on an object from inside ``fn``."""
    static = {}

    def inner(*args):
        leaves, spec = tree_flatten(fn(*args))
        is_t = [isinstance(v, torch.Tensor) for v in leaves]
        static["spec"] = spec
        static["leaves"] = [None if t else v for v, t in zip(leaves, is_t)]
        static["is_t"] = is_t
        return tuple(v for v, t in zip(leaves, is_t) if t)

    def outer(*args):
        tensors = iter(torch.func.vmap(inner, in_dims=in_dims)(*args))
        leaves = [next(tensors) if t else v
                  for v, t in zip(static["leaves"], static["is_t"])]
        return tree_unflatten(leaves, static["spec"])

    return outer


def _tensor_dims(tree):
    """vmap in_dims for a pytree batched on axis 0 in every tensor leaf."""
    return tree_map(lambda v: 0 if isinstance(v, torch.Tensor) else None, tree)


def _instance(tree, k: int):
    """Instance k of a pytree batched on axis 0 in every tensor leaf."""
    return tree_map(lambda v: v[k] if isinstance(v, torch.Tensor) else v, tree)


def _select(cond, new, old):
    """Per instance: ``new`` where ``cond`` [B], else ``old`` (pytrees of
    tensors batched on axis 0)."""
    def pick(a, b):
        c = cond.reshape(cond.shape + (1,) * (a.dim() - 1))
        return torch.where(c, a, b)

    return tree_map(pick, new, old)


class GaussNewtonSolver:
    """One solver instance per compiled problem. Under a mesh,
    ``sharding_rules`` is the rank's ``ShardingRules`` and ``compiled`` the
    problem at the dims of the rank's extended region."""

    def __init__(
        self,
        compiled: CompiledProblem,
        uses_lambda: bool,
        init_params: Optional[InitializationParameters] = None,
        sharding_rules=None,
        plan_on: Optional[CompiledProblem] = None,
    ):
        self.compiled = compiled
        self.uses_lambda = bool(uses_lambda)
        self.rules = sharding_rules
        # the sharded loop's record of each CG call (sharded_fused_grid_cg)
        self.cg_stats = []
        self.ip = resolve_auto_policy(
            init_params or InitializationParameters(),
            sharding_rules.mesh.size if sharding_rules is not None else 1,
            bool(compiled.registry.graphs),
        )
        if self.ip.cg_variant not in CG_VARIANTS:
            raise ValueError(f"cg_variant must be one of {CG_VARIANTS}, got {self.ip.cg_variant!r}")
        if self.ip.preconditioner not in ("jacobi", "block_jacobi"):
            raise ValueError(
                f"preconditioner must be 'jacobi' or 'block_jacobi', got {self.ip.preconditioner!r}"
            )
        self._coeff_dtype = coefficient_dtype(self.ip.coefficient_dtype)
        if self.ip.use_explicit_jtj and sharding_rules is not None:
            raise NotImplementedError(
                "use_explicit_jtj on a mesh is not ported yet: the sharded loop runs the "
                "assembled operator (ROADMAP.md queue 1 item 8e)"
            )
        # the explicit J's structure a topology (explicit.explicit_structure),
        # least recently used first out
        self._explicit_structures = OrderedDict()
        if self.ip.edge_reorder not in (False, None, "owner"):
            raise ValueError(
                f"edge_reorder={self.ip.edge_reorder!r}: the only implemented mode is "
                "\"owner\" (or False to disable)"
            )
        if self.ip.aligned_graph_assembly:
            raise NotImplementedError(
                "aligned_graph_assembly is not to be ported: the reference package's "
                "experimental graph assembly, measured slower there"
            )
        self._stencil_plan = None
        # why a step ran the eager loop where the fused one was asked for
        # (Plan.fused_fallback), or None
        self.fused_fallback = None
        if self.ip.use_fused_jtj and not self.ip.use_explicit_jtj:
            from ..assembly import plan_assembly

            # a graph mesh's rank plans at the global dims (``plan_on``): the
            # structure probes must not depend on the size of its blocks
            self._stencil_plan = plan_assembly(
                compiled.spec_fn, plan_on or compiled,
                memory_limit_bytes=self.ip.fused_jtj_memory_limit_bytes,
            )
        mode = self.ip.use_pallas_cg
        if mode == "interpret":
            self._pallas_mode = "interpret"
        elif mode in (False, "off", None):
            # under a mesh the sharded loop is the only loop: its plain twin
            self._pallas_mode = None if sharding_rules is None else "interpret"
        else:  # "auto", True, "on": kernel for CUDA tensors, twin for CPU
            self._pallas_mode = "auto"

    # -- numerics helpers ------------------------------------------------------
    def _guarded_invert(self, p):
        """solverGPUGaussNewton.t:325-351."""
        t = self.ip.guarded_invert_type
        if t == GuardedInvertType.CERES:
            inv = lambda v: 1.0 / torch.square(1.0 + torch.sqrt(v))  # noqa: E731
        elif t == GuardedInvertType.MODIFIED_CERES:
            inv = lambda v: 1.0 / (1.0 + v)  # noqa: E731
        else:
            inv = lambda v: 1.0 / (FLOAT_EPSILON + v)  # noqa: E731
        return {k: inv(v) for k, v in p.items()}

    def kernel_expected(self) -> bool:
        """Whether a step is meant to run the fused loop: an assembled
        operator of a dtype the loop takes (``fused_cg.LOOP_DTYPES``: float32)
        with the fused loop on. Such a step that runs the
        eager loop notes it (:meth:`_note_no_kernel`)."""
        return (self._pallas_mode is not None and self._stencil_plan is not None
                and self.compiled.dtype in fused_cg.LOOP_DTYPES)

    def _note_no_kernel(self) -> None:
        """A float32 step's assembled operator had no form the fused CG
        loop takes (ops/fused_cg.py's planners returned None), so the step
        runs the eager loop: say so once, on stderr whatever the verbosity,
        and in ``fused_fallback``. float64 plans run the eager loop by
        design (the fused loop is float32) and note nothing."""
        if not self.kernel_expected() or self.fused_fallback is not None:
            return
        self.fused_fallback = "no_kernel"
        print(
            "opt_tpu_torch: the assembled operator has no form the fused CG kernel "
            "takes; this plan runs the eager CG loop",
            file=sys.stderr,
        )

    def _fs(self, consts, graphs, params) -> FunctionSet:
        """The step's operator bundle; under a mesh its cost sums cover the
        rank's tile and reduce over the mesh."""
        return FunctionSet(self.compiled, consts, graphs, params, window=self.rules)

    # -- state -----------------------------------------------------------------
    def _init_state(self, X, consts, graphs, params, sp):
        fs = self._fs(consts, graphs, params)
        dt = self.compiled.dtype
        device = next(iter(X.values())).device
        return {
            "X": X,
            "SSq": {k: torch.ones_like(v) for k, v in X.items()},
            "prev_cost": fs.cost(X).to(dt),
            "trust_region_radius": torch.full(
                (), sp["trust_region_radius"], dtype=dt, device=device
            ),
            "radius_decrease_factor": torch.full(
                (), sp["radius_decrease_factor"], dtype=dt, device=device
            ),
            "n_iter": torch.zeros((), dtype=torch.int32, device=device),
            "lin_iters": torch.zeros((), dtype=torch.int32, device=device),
            "done": torch.zeros((), dtype=torch.bool, device=device),
        }

    def init(self, X, consts, graphs, params, sp):
        return self._init_state(X, consts, graphs, params, sp)

    def step(self, state, consts, graphs, params, sp):
        """One nonlinear iteration, or the state unchanged once done."""
        if bool(state["done"]) or int(state["n_iter"]) >= sp["nIterations"]:
            return state
        return self._step_fn(state, self._fs(consts, graphs, params), sp)

    @property
    def _step_fn(self):
        return self._lm_step if self.uses_lambda else self._gn_step

    def validate_assembly(self, X, consts, graphs, params) -> bool:
        """Random-vector apply comparison of the assembled JᵀJ operator
        against the composed Jᵀ(J·p), through the same const-cache path the
        solver runs, at the real inputs X and at an O(1) perturbation X′
        with the const cache still built at X (catches constant-slot false
        positives). True when both agree."""
        if self._stencil_plan is None:
            return True
        c = self.compiled
        device = next(iter(X.values())).device
        rng = np.random.RandomState(20260817)

        def draw(k):
            return torch.as_tensor(rng.uniform(-1.0, 1.0, c.unknown_shape(k))).to(
                device=device, dtype=c.dtype
            )

        v = {k: draw(k) for k in c.unknown_names}
        dX = {k: draw(k) for k in c.unknown_names}

        def _one(fs, Xp, A, vm):
            _r, J, JT = fs.linearize(Xp)
            ref = JT(J(vm))
            got = A(vm)
            err = torch.zeros((), dtype=c.dtype, device=device)
            scale = torch.zeros((), dtype=c.dtype, device=device)
            for k in ref:
                if not ref[k].numel():  # a rank of a graph mesh that owns none
                    continue
                # compare only where both operators are finite
                ok = torch.isfinite(ref[k]) & torch.isfinite(got[k])
                diff = torch.where(ok, torch.abs(ref[k] - got[k]), 0.0)
                err = torch.maximum(err, torch.max(diff))
                scale = torch.maximum(scale, torch.max(torch.where(ok, torch.abs(ref[k]), 0.0)))
            return err, scale

        fs = FunctionSet(c, consts, graphs, params)
        fs.masks(X)
        cc = fs.assemble_const(X, self._stencil_plan)
        A, _diag, _jtf, _meta = fs.assemble_stencil(X, self._stencil_plan, cc)
        err1, scale1 = _one(fs, X, A, fs.mask_rows(v))
        Xp = {k: X[k] + dX[k] * (0.5 * torch.abs(X[k]) + 0.5) for k in X}
        fs2 = FunctionSet(c, consts, graphs, params)
        fs2.masks(Xp)
        A2, _d2, _j2, _m2 = fs2.assemble_stencil(Xp, self._stencil_plan, cc)
        err2, scale2 = _one(fs2, Xp, A2, fs2.mask_rows(v))
        err = float(torch.maximum(err1, err2))
        scale = float(torch.maximum(scale1, scale2))
        tol = 1e-9 if c.dtype == torch.float64 else 5e-4
        return err <= tol * (1.0 + scale)

    def _asm_cache(self, fs: FunctionSet, X0):
        """Loop-invariant assembly data (constant-slot probes + products),
        computed once per solve before the nonlinear loop."""
        if self._stencil_plan is None:
            return None
        with phase("assembleConst"):
            return fs.assemble_const(X0, self._stencil_plan)

    # ---- shared PCG pieces -------------------------------------------------
    def _linear_system(self, X, fs: FunctionSet, asm_cache=None, batched=False):
        """The undamped system at X, shared by GN and LM: (A = JᵀJ·(),
        the assembled diag(JᵀJ) or None where nothing was assembled, the
        residual terms, r0 = -JᵀF, cg_meta: the fused grid CG descriptor or
        None). ``batched``: one instance of a batch (no per-channel split).
        Timed as the rows assembleFields (with assembleConst where the
        solve has no const cache), explicitJ and PCGInit1 (r0)."""
        if self.ip.use_explicit_jtj:
            # the reference's cusparse branch: J and Jᵀ as CSR, two matvecs
            # a CG iteration (explicit.py), the eager loop
            from ..explicit import build_explicit_j, explicit_jtj_apply

            with phase("PCGInit1"):
                fs.masks(X)
                r_terms, _J, JT = fs.linearize(X)
                r0 = {k: -v for k, v in JT(r_terms).items()}
            with phase("explicitJ"):
                J_csr, JT_csr = build_explicit_j(self.compiled, X, fs.consts, fs.graphs,
                                                 fs.params, self._explicit_structure(fs.graphs, X))
            return (explicit_jtj_apply(self.compiled, J_csr, JT_csr, fs.row_masks), None,
                    r_terms, r0, None)
        if self._stencil_plan is not None:
            with phase("assembleFields"):
                fs.masks(X)
                if asm_cache is None:
                    asm_cache = self._asm_cache(fs, X)
                A, diag, jtf_fn, cg_meta = fs.assemble_stencil(
                    X, self._stencil_plan, asm_cache, coeff_dtype=self._coeff_dtype,
                    # a block preconditioner couples the channels, a batch's
                    # systems are whole instances and a mesh's loop is joint
                    # (as the JAX package's): no per-channel split
                    allow_split=not (batched or self.rules is not None
                                     or (self.ip.preconditioner == "block_jacobi"
                                         and self.compiled.use_preconditioner)),
                    sharded=self.rules is not None,
                )
            with phase("PCGInit1"):
                r_terms = jtf_fn.r_terms
                if r_terms is None:  # every probe hoisted: evaluate residuals
                    r_terms = fs.F(X)
                r0 = {k: -v for k, v in jtf_fn(r_terms).items()}
            return A, diag, r_terms, r0, cg_meta
        with phase("PCGInit1"):
            fs.masks(X)
            r_terms, J, JT = fs.linearize(X)
            r0 = {k: -v for k, v in JT(r_terms).items()}
        return (lambda v: JT(J(v))), None, r_terms, r0, None

    def _explicit_structure(self, graphs, X):
        """The explicit J's structure at these graphs' topology, built on the
        host at its first step and kept (a few topologies, keyed by their
        cached group tables, which the entry holds on to)."""
        from ..explicit import explicit_structure

        tables = tuple(graphs[g].get("__groups__", graphs[g]) for g in sorted(graphs))
        key = tuple(id(t) for t in tables)
        hit = self._explicit_structures.pop(key, None)
        if hit is None:
            device = next(iter(X.values())).device
            hit = (tables, explicit_structure(self.compiled, graphs, device))
        self._explicit_structures[key] = hit
        while len(self._explicit_structures) > _EXPLICIT_STRUCTURES_MAX:
            self._explicit_structures.popitem(last=False)
        return hit[1]

    def gn_system(self, X, fs: FunctionSet, asm_cache=None, batched=False):
        """The linear system of one GN step at X: (A, r0 = -JᵀF, pre, cg_meta)
        with pre the row-masked guarded-inverted Jacobi diagonal (ones when
        the spec disables the preconditioner) and cg_meta the fused grid CG
        descriptor or None."""
        A, diag, _r, r0, cg_meta = self._linear_system(X, fs, asm_cache, batched)
        with phase("PCGInit1", count=False):
            if self.compiled.use_preconditioner:
                pre_raw = diag if diag is not None else fs.jtj_diag(X)
            else:
                pre_raw = {k: torch.ones_like(v) for k, v in r0.items()}
            pre = fs.mask_rows(self._guarded_invert(pre_raw))
        return A, r0, pre, cg_meta

    def _block_pre(self, A, extra_diag=None):
        """The block-Jacobi apply of the assembled operator ``A`` (opt-in,
        and only where the spec uses a preconditioner), or None."""
        if (self.ip.preconditioner == "block_jacobi" and self.compiled.use_preconditioner
                and hasattr(A, "block_pre")):
            with phase("blockInverse"):
                return A.block_pre(extra_diag=extra_diag)
        return None

    def _kernel_pre_blocks(self, cg_meta, pre_apply):
        """A block-Jacobi apply's inverted blocks packed for the fused loop
        ([*dom, C, C] over the meta's channels) with the row masks folded
        into the output rows, as pre_apply masks its output; on a graph
        mesh ([B, C, C] blocks) a list of each vertex space's, in the meta's
        space order; None where the loop cannot host it (several index
        spaces off a mesh, another layout)."""
        if cg_meta is None or self._pallas_mode is None:
            return None
        inv = getattr(pre_apply, "inv", None)
        layouts = getattr(pre_apply, "layouts", None)
        if not inv or layouts is None:
            return None
        spaces = cg_meta.get("spaces")
        if spaces is not None:
            if set(inv) != {sp["isp"] for sp in spaces}:
                return None
            blocks = [self._masked_block_inverse(inv, layouts, pre_apply, sp["isp"],
                                                 sp["u_list"], sp["offs"], sp["ct"])
                      for sp in spaces]
            return None if any(b is None for b in blocks) else blocks
        isp = cg_meta.get("isp")
        if isp is None or set(inv) != {isp}:
            return None
        return self._masked_block_inverse(inv, layouts, pre_apply, isp, cg_meta["u_list"],
                                          cg_meta["offs"], cg_meta["ctot"])

    def _masked_block_inverse(self, inv, layouts, pre_apply, isp, u_list, offs, ctot):
        """inv[isp] with the row masks folded into its output rows, or None
        where its layout is not (u_list, offs, ctot)."""
        lu, lo, lc = layouts[isp]
        if tuple(lu) != tuple(u_list) or lo != offs or lc != ctot:
            return None
        with phase("blockInverse", count=False):
            Minv = inv[isp]  # [*dom, C, C]
            row_masks = getattr(pre_apply, "row_masks", {})
            parts = []
            for u in u_list:
                m = row_masks.get(u)
                cu = self.compiled.unknown_shape(u)[-1]
                if m is None:
                    parts.append(torch.ones(Minv.shape[:-2] + (cu,), dtype=Minv.dtype,
                                            device=Minv.device))
                else:
                    parts.append(m.expand(m.shape[:-1] + (cu,)))
            pm = torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
            return Minv * pm[..., :, None]

    def _system(self, X, fs: FunctionSet, state, sp, asm_cache=None, batched=False):
        """The linear solve of one step at X: {meta, A, r0, pre, pre_apply,
        lm} with ``pre_apply`` the block-Jacobi apply or None and ``lm`` the
        LM loop's keywords {ctc, reset_period, q_tolerance} or None; under
        LM also what ``_lm_finish`` reads (``_lm_parts``). ``batched``: one
        instance of a batch (``_linear_system``)."""
        if not self.uses_lambda:
            A, r0, pre, meta = self.gn_system(X, fs, asm_cache, batched)
            return dict(meta=meta, A=A, r0=r0, pre=pre, pre_apply=self._block_pre(A), lm=None)
        s = self._lm_parts(X, fs, state, sp, asm_cache, batched)
        # block-Jacobi inverts the damped blocks B + diag(CtC): the same ctc
        # the operator applies, so M models A + CtC per point
        return dict(
            s, A=s["A_base"], pre=s["pre_lm"],
            pre_apply=self._block_pre(s["A_base"], extra_diag=s["ctc"]),
            lm=dict(ctc=s["ctc"], reset_period=sp["residual_reset_period"],
                    q_tolerance=_f32(sp["q_tolerance"])),
        )

    def _fused_keywords(self, s):
        """``fused_grid_cg``'s keywords for the system ``s`` (pre_blocks,
        cg_variant and the LM ones); pre_blocks is None where the loop
        cannot host the block preconditioner."""
        pre_apply = s["pre_apply"]
        pre_blocks = self._kernel_pre_blocks(s["meta"], pre_apply) if pre_apply is not None else None
        return dict(s["lm"] or {}, pre_blocks=pre_blocks, cg_variant=self.ip.cg_variant)

    def cg_inputs(self, X, fs: FunctionSet, state, sp):
        """What one step at X hands the fused loop: (cg_meta, r0, pre,
        keywords of ``fused_grid_cg``: pre_blocks, cg_variant and, under
        LM, ctc, reset_period and q_tolerance). cg_meta is None where the
        operator has no kernel form."""
        s = self._system(X, fs, state, sp)
        return s["meta"], s["r0"], s["pre"], self._fused_keywords(s)

    def _cg(self, s, sp, device):
        """One linear solve of the system ``s`` (``_system``): the fused loop
        where the operator has a kernel form (with the block preconditioner
        when there is one), else :meth:`_eager_cg`; under a mesh
        :meth:`_sharded_cg`. Returns (delta, iterations as a 0-dim int32
        tensor). Timed as the row PCGStep1, with the instance it ran (under
        a mesh the loop, its kernel's launches, halo phases, all_reduces and
        all_to_alls being rows of their own)."""
        if self.rules is not None:
            with phase("PCGStep1"):
                out = self._sharded_cg(s, sp)
                note_cg({self.cg_stats[-1]["loop"]: 1})
                return out
        with phase("PCGStep1"):
            kw = self._fused_keywords(s)
            if (s["meta"] is not None and self._pallas_mode is not None
                    and (s["pre_apply"] is None or kw["pre_blocks"] is not None)):
                return self._fused_cg(s, sp, kw)
            note_cg({"eager loop": 1})
            return self._eager_cg(s, sp, device)

    def _fused_cg(self, s, sp, kw):
        """``fused_grid_cg`` on the system ``s``. Under a timed solve the
        instances that launched (the launch counts' growth), or on CPU
        tensors the twin of the instance the card would launch, go to the
        timer."""
        timer = timing_active()
        before = None if timer is None else dict(fused_cg.fused_grid_cg_kernel.launches)
        out = fused_grid_cg(
            s["meta"], s["r0"], s["pre"], sp["lIterations"], sp["cg_rz_tolerance"],
            guard_div=self.ip.guard_division_by_zero,
            interpret=self._pallas_mode == "interpret", **kw,
        )
        if timer is not None:
            grew = {k: v - before.get(k, 0)
                    for k, v in fused_cg.fused_grid_cg_kernel.launches.items()
                    if v != before.get(k, 0)}
            if not grew:  # the plain twin ran
                meta = s["meta"]
                name = fused_cg.launch_instance(
                    meta, fused_cg.pack(s["r0"], meta), lm=kw.get("ctc") is not None,
                    cs=kw["cg_variant"] == "chronopoulos_gear", pre_blocks=kw["pre_blocks"])
                grew = {f"plain twin of {name}": 1}
            timer.note_cg(grew)
        return out

    def _sharded_cg(self, s, sp):
        """The linear solve of a step under a mesh: the system assembled on
        the rank's extended region, read on its tile, solved by the sharded
        loop with every other rank (a 2-D tile's, or a 3-D tile's, whose
        third axis is whole: ``sharded_fused_grid_cg`` takes both); delta
        comes back over the region (the neighbours' in the halo), so X keeps
        its halo. On a graph the system is the rank's owner blocks' (of one
        vertex space or several) and ``sharded_graph_cg`` solves it. A
        system the loop cannot take raises: a mesh never falls back
        quietly. The composed operator (no assembly plan) runs
        :meth:`_sharded_composed_cg`."""
        meta, rules = s["meta"], self.rules
        if self._stencil_plan is None:
            return self._sharded_composed_cg(s, sp)
        kw = self._fused_keywords(s)
        if meta is None or (s["pre_apply"] is not None and kw["pre_blocks"] is None):
            raise RuntimeError("this step's operator has no form the sharded CG loop takes")
        if rules.kind == "graph":
            # the owner blocks' loop: the system is the rank's already
            return sharded_graph_cg(
                meta, rules.mesh, s["r0"], s["pre"], sp["lIterations"], sp["cg_rz_tolerance"],
                guard_div=self.ip.guard_division_by_zero, stats=self.cg_stats, **kw)
        crop = lambda d: {k: rules.crop(v) for k, v in d.items()}  # noqa: E731
        if kw.get("ctc") is not None:
            kw["ctc"] = crop(kw["ctc"])
        if kw["pre_blocks"] is not None:
            kw["pre_blocks"] = rules.crop(kw["pre_blocks"])
        delta, l = sharded_fused_grid_cg(
            dict(meta, F=rules.crop_fields(meta["F"])), rules.mesh, crop(s["r0"]),
            crop(s["pre"]), sp["lIterations"], sp["cg_rz_tolerance"],
            guard_div=self.ip.guard_division_by_zero,
            interpret=self._pallas_mode == "interpret", stats=self.cg_stats, **kw,
        )
        return rules.extend_region(delta), l

    def _sharded_composed_cg(self, s, sp):
        """The linear solve of a step of the composed operator Jᵀ(J·p)
        (``use_fused_jtj=False``) under a mesh, by ``sharded_composed_cg``.
        On a grid the CG vectors are the rank's tiles: an apply extends p
        over the rank's region (one halo exchange a split axis) and reads
        Jᵀ(J·p) of the region on the tile. The region reaches as far from
        the tile as two reads of one residual lie apart (``grid_reach``), so
        every residual that reads a tile point has all its reads inside the
        region, and no residual centred in the halo needs summing back to
        another rank. On a graph the vectors are the owner blocks, and J and
        Jᵀ exchange the per-edge values themselves (``FunctionSet.linearize``).
        Returns (delta over the region or the blocks, iterations)."""
        rules, A, lm = self.rules, s["A"], s["lm"]
        if rules.kind == "graph":
            crop, apply = (lambda d: d), A
        else:
            crop = lambda d: {k: rules.crop(v) for k, v in d.items()}  # noqa: E731
            apply = lambda p: crop(A(rules.extend_region(p)))  # noqa: E731
        lm_kw = {} if lm is None else dict(ctc=crop(lm["ctc"]), reset_period=lm["reset_period"],
                                           q_tolerance=lm["q_tolerance"])
        delta, l = sharded_composed_cg(
            apply, rules.mesh, crop(s["r0"]), crop(s["pre"]), sp["lIterations"],
            sp["cg_rz_tolerance"], guard_div=self.ip.guard_division_by_zero,
            cg_variant=self.ip.cg_variant, stats=self.cg_stats, **lm_kw)
        return (delta if rules.kind == "graph" else rules.extend_region(delta)), l

    def _eager_cg(self, s, sp, device):
        """The eager ``_run_cg`` on the system's operator (``_cg``'s
        fallback)."""
        self._note_no_kernel()
        pre, lm = s["pre"], s["lm"]
        M = s["pre_apply"] or (lambda r: {k: pre[k] * r[k] for k in r})
        A, lm_kw = s["A"], {}
        if lm is not None:
            A_base, ctc = A, lm["ctc"]

            def A(v):  # JᵀJp + CtC·p (o.t:2076-2082)
                base = A_base(v)
                return {k: base[k] + ctc[k] * v[k] for k in v}

            lm_kw = dict(reset_period=lm["reset_period"], q_tol=lm["q_tolerance"])
        delta, l = _run_cg(
            s["r0"], A, M, tree_dot, sp["lIterations"], sp["cg_rz_tolerance"],
            guard_div=self.ip.guard_division_by_zero,
            cs=self.ip.cg_variant == "chronopoulos_gear", **lm_kw,
        )
        return delta, torch.full((), l, dtype=torch.int32, device=device)

    def _gn_step(self, state, fs: FunctionSet, sp, asm_cache=None):
        X = state["X"]
        delta, l_done = self._cg(self._system(X, fs, state, sp, asm_cache), sp,
                                 state["n_iter"].device)
        return self._gn_finish(state, fs, delta, l_done)

    def _gn_finish(self, state, fs: FunctionSet, delta, l_done):
        """The GN update X + δ, its cost and the counts."""
        X = state["X"]
        X_new = {k: X[k] + delta[k] for k in X}
        with phase("computeCost"):
            cost = fs.cost(X_new)
        return {
            **state,
            "X": X_new,
            "prev_cost": cost.to(state["prev_cost"].dtype),
            "n_iter": state["n_iter"] + 1,
            "lin_iters": state["lin_iters"] + l_done,
        }

    def _lm_parts(self, X, fs: FunctionSet, state, sp, asm_cache=None, batched=False):
        """Everything one LM step needs at X: the damped system and what
        ``_lm_finish`` reads (opt_tpu/solver/gauss_newton.py:640-700)."""
        dt = self.compiled.dtype
        radius = state["trust_region_radius"].to(dt)
        A_base, diag, r_terms, r0, cg_meta = self._linear_system(X, fs, asm_cache, batched)
        with phase("PCGInit1", count=False):
            if diag is None:
                diag = fs.jtj_diag(X)
            # diag: the actual diag(JᵀJ), also under UsePreconditioner(false)
            if self.compiled.use_preconditioner:
                pre_raw = diag
            else:
                pre_raw = fs.mask_rows({k: torch.ones_like(v) for k, v in diag.items()})
            pre_guarded = fs.mask_rows(self._guarded_invert(pre_raw))

            # JacobiScaling ONCE_PER_SOLVE: freeze the guarded-inverted
            # diagonal of the first nonlinear iteration (PCGSaveSSq,
            # t:607-613)
            js = self.ip.jacobi_scaling
            if js == JacobiScalingType.ONCE_PER_SOLVE:
                first = state["n_iter"] == 0
                SSq = {k: torch.where(first, pre_guarded[k], state["SSq"][k])
                       for k in pre_guarded}
                invS = {k: 1.0 / v for k, v in SSq.items()}
            elif js == JacobiScalingType.EVERY_ITERATION:
                SSq = state["SSq"]
                invS = {k: 1.0 / v for k, v in pre_guarded.items()}
            else:
                SSq = state["SSq"]
                invS = {k: torch.ones_like(v) for k, v in diag.items()}

        # PCGComputeCtC + PCGFinalizeDiagonal (t:631-664)
        with phase("PCGComputeCtC"):
            min_d, max_d = _f32(sp["min_lm_diagonal"]), _f32(sp["max_lm_diagonal"])
            ctc, pre_lm = {}, {}
            for k in diag:
                ctc_un = diag[k] / radius
                mult = invS[k] / radius
                ctc[k] = torch.clamp(ctc_un, min_d * mult, max_d * mult)
                pre_lm[k] = 1.0 / (ctc[k] + radius * ctc_un)
            # select masking: at excluded rows diag = 0, so SSq = 0, invS =
            # inf and ctc = inf, where multiplicative masking would give NaN
            ctc = fs.mask_rows_select(ctc)
            pre_lm = fs.mask_rows_select(pre_lm)
        return {
            "meta": cg_meta, "r0": r0, "pre_lm": pre_lm, "ctc": ctc,
            "A_base": A_base, "r_terms": r_terms, "SSq": SSq,
        }

    def _lm_step(self, state, fs: FunctionSet, sp, asm_cache=None):
        X = state["X"]
        s = self._system(X, fs, state, sp, asm_cache)
        delta, l_done = self._cg(s, sp, state["n_iter"].device)
        return self._lm_finish(
            state, fs, sp, X, delta, l_done, s["r_terms"], fs.jvp_fn(X), s["SSq"]
        )

    def _lm_finish(self, state, fs, sp, X, delta, l_done, r_terms, J, SSq):
        """Ceres-style trust-region bookkeeping (t:1106-1164), on the device:
        accept/reject, the radius update and the function-tolerance and
        min-radius exits."""
        dt = self.compiled.dtype
        radius = state["trust_region_radius"].to(dt)
        with phase("computeModelCost"):
            model_cost = fs.model_cost(X, r_terms, J, delta)
        prev_cost = state["prev_cost"].to(dt)
        model_cost_change = prev_cost - model_cost

        X_new = {k: X[k] + delta[k] for k in X}
        with phase("computeCost"):
            new_cost = fs.cost(X_new)
        cost_change = prev_cost - new_cost
        relative_decrease = cost_change / model_cost_change

        accept = (cost_change >= 0) & (relative_decrease > _f32(sp["min_relative_decrease"]))
        func_tol = cost_change <= prev_cost * _f32(sp["function_tolerance"])

        # accepted branch; the cube written out, as C's pow(x, 3.0)
        t = 2.0 * relative_decrease - 1.0
        tmp_factor = 1.0 - t * t * t
        radius_acc = radius / torch.clamp(tmp_factor, min=_f32(1.0 / 3.0))
        radius_acc = torch.clamp(radius_acc, max=_f32(sp["max_trust_region_radius"]))
        # on the function-tolerance exit the reference returns before
        # touching prevCost and the radius (t:1127-1132)
        radius_acc = torch.where(func_tol, radius, radius_acc)
        cost_acc = torch.where(func_tol, prev_cost, new_cost)

        # rejected branch (t:1144-1156)
        rdf = state["radius_decrease_factor"].to(dt)
        radius_rej = radius / rdf
        min_radius_hit = radius_rej <= _f32(sp["min_trust_region_radius"])

        return {
            **state,
            "X": {k: torch.where(accept, X_new[k], X[k]) for k in X},
            "SSq": SSq,
            "prev_cost": torch.where(accept, cost_acc, prev_cost).to(state["prev_cost"].dtype),
            "trust_region_radius": torch.where(accept, radius_acc, radius_rej).to(
                state["trust_region_radius"].dtype
            ),
            "radius_decrease_factor": torch.where(accept, torch.full_like(rdf, 2.0), 2.0 * rdf),
            "done": torch.where(accept, func_tol, min_radius_hit),
            "n_iter": state["n_iter"] + 1,
            "lin_iters": state["lin_iters"] + l_done,
        }

    # -- full solve --------------------------------------------------------------
    def solve(self, X, consts, graphs, params, sp: Dict[str, Any]):
        """Full solve: returns (final state, per-iteration cost tensors). The
        nonlinear loop reads one flag per nonlinear step from the device."""
        state = self._init_state(X, consts, graphs, params, sp)
        asm_cache = self._asm_cache(FunctionSet(self.compiled, consts, graphs, params), X)
        costs = []
        for _ in range(int(sp["nIterations"])):
            if bool(state["done"]):
                break
            state = self._step_fn(state, self._fs(consts, graphs, params), sp, asm_cache)
            costs.append(state["prev_cost"])
        return state, costs

    # -- batched solve -----------------------------------------------------------
    def _batched_init(self, X, consts, graphs, params, sp, const_axes, param_axes):
        """The batch's initial state and const cache, each instance's as
        ``_init_state`` and ``_asm_cache`` make it (under vmap), and the
        per-leaf in-dims: (state, cache, args of ``_batched_step``)."""
        comp = self.compiled
        c_dims = {k: const_axes.get(k) for k in consts}
        p_dims = {k: param_axes.get(k) for k in params}
        state = _vmap(lambda x, c, p: self._init_state(x, c, graphs, p, sp),
                      (0, c_dims, p_dims))(X, consts, params)
        cache = None
        if self._stencil_plan is not None:
            plan = self._stencil_plan
            cache = _vmap(lambda x, c, p: FunctionSet(comp, c, graphs, p).assemble_const(x, plan),
                          (0, c_dims, p_dims))(X, consts, params)
        return state, (consts, params, c_dims, p_dims, graphs, sp, cache)

    def solve_batched(self, X, consts, graphs, params, sp, const_axes, param_axes):
        """A batch of independent instances, the counterpart of the JAX
        package's ``_solve_fused_batched`` + ``_solve_core``: X holds every
        unknown with a leading batch axis [B, ...]; each constant image and
        parameter is batched on axis 0 or shared (``const_axes`` /
        ``param_axes``: name -> 0 or None); graphs are shared. Each step
        builds every instance's system at once under ``torch.func.vmap``,
        solves them by one batched ``fused_grid_cg`` call (one kernel
        launch on the card) and applies the GN or LM update under vmap. An
        instance that is done, or at nIterations, keeps its state, counts
        and cost history, as the reference's while_loop batching rule keeps
        them. The host reads one flag a step: is any instance active.
        Returns (state batched on axis 0, costs [B, max(1, nIterations)],
        NaN past each instance's last step)."""
        n_it = int(sp["nIterations"])
        state, args = self._batched_init(X, consts, graphs, params, sp, const_axes, param_axes)
        B = int(state["n_iter"].shape[0])
        costs = torch.full((B, max(1, n_it)), float("nan"), dtype=self.compiled.dtype,
                           device=state["n_iter"].device)
        cols = torch.arange(costs.shape[1], device=costs.device)
        for _ in range(n_it):
            active = ~state["done"] & (state["n_iter"] < n_it)
            if not bool(active.any()):
                break
            new = self._batched_step(state, *args)
            hit = active[:, None] & (cols[None, :] == state["n_iter"][:, None].long())
            costs = torch.where(hit, new["prev_cost"][:, None].to(costs.dtype), costs)
            state = _select(active, new, state)
        return state, costs

    def batched_cg_inputs(self, X, consts, graphs, params, sp, const_axes, param_axes):
        """What the batch's first step hands the batched fused loop: (the
        batched meta, r0, pre, keywords of ``fused_grid_cg``), r0 and pre
        with a leading batch axis; meta None where the batched operator has
        no fused form."""
        state, args = self._batched_init(X, consts, graphs, params, sp, const_axes, param_axes)
        s = self._batched_system(state, *args)
        return (None,) * 4 if s is None else (s["meta"], s["r0"], s["pre"], s["kw"])

    def _batched_system(self, state, consts, params, c_dims, p_dims, graphs, sp, cache):
        """Every instance's linear system of one step, built under vmap:
        {meta (batched: "batch" B, F [B, T, *dom]), r0, pre, kw (the
        keywords of ``fused_grid_cg``), extra (what ``_lm_finish`` reads)},
        or None where the fused loop cannot take it (no fused loop, no
        fused form, a block preconditioner the loop cannot host)."""
        comp = self.compiled
        if (self._stencil_plan is None or self._pallas_mode is None
                or comp.dtype not in fused_cg.LOOP_DTYPES):
            return None  # composed operator, float64, fused CG off

        def system(st, c, p, cc):
            s = self._system(st["X"], FunctionSet(comp, c, graphs, p), st, sp, cc, batched=True)
            out = {"meta": s["meta"], "r0": s["r0"], "pre": s["pre"],
                   "kw": self._fused_keywords(s), "blocks": s["pre_apply"] is not None}
            if self.uses_lambda:
                out.update(r_terms=s["r_terms"], SSq=s["SSq"])
            return out

        s = _vmap(system, (_tensor_dims(state), c_dims, p_dims, _tensor_dims(cache)))(
            state, consts, params, cache)
        meta, kw = s["meta"], s["kw"]
        if meta is None or (s["blocks"] and kw["pre_blocks"] is None):
            return None
        # the meta's structure is instance 0's; a shared remainder CSR left
        # the vmap expanded over the batch
        meta = dict(meta, batch=int(state["n_iter"].shape[0]), F=meta["F"].contiguous())
        if meta["rem"] is not None:
            rem = meta["rem"]
            meta["rem"] = dict(rem, rowptr=rem["rowptr"][0], col=rem["col"][0],
                               blk=rem["blk"].contiguous())
        return {"meta": meta, "r0": s["r0"], "pre": s["pre"], "kw": kw,
                "extra": {k: s[k] for k in ("r_terms", "SSq") if k in s}}

    def _batched_step(self, state, consts, params, c_dims, p_dims, graphs, sp, cache):
        """One step of every instance (:meth:`solve_batched`): the stepped
        state, batched on axis 0."""
        comp = self.compiled
        args = (consts, params, c_dims, p_dims, graphs, sp, cache)
        s = self._batched_system(state, *args)
        if s is None:
            return self._step_each(state, *args)
        delta, l_done = fused_grid_cg(
            s["meta"], s["r0"], s["pre"], sp["lIterations"], sp["cg_rz_tolerance"],
            guard_div=self.ip.guard_division_by_zero,
            interpret=self._pallas_mode == "interpret", **s["kw"],
        )

        def finish(st, c, p, d, l, ex):
            fs = FunctionSet(comp, c, graphs, p)
            if self.uses_lambda:
                X = st["X"]
                return self._lm_finish(st, fs, sp, X, d, l, ex["r_terms"], fs.jvp_fn(X),
                                       ex["SSq"])
            return self._gn_finish(st, fs, d, l)

        extra = s["extra"]
        return _vmap(finish, (_tensor_dims(state), c_dims, p_dims, 0, 0, _tensor_dims(extra)))(
            state, consts, params, delta, l_done, extra)

    def _step_each(self, state, consts, params, c_dims, p_dims, graphs, sp, cache):
        """One step of every instance, one instance after the other (the
        batch's path where the fused loop cannot take the batched system)."""
        B = int(state["n_iter"].shape[0])
        out = []
        for k in range(B):
            c = {n: v[k] if c_dims[n] == 0 else v for n, v in consts.items()}
            p = {n: v[k] if p_dims[n] == 0 else v for n, v in params.items()}
            cc = None if cache is None else _instance(cache, k)
            fs = FunctionSet(self.compiled, c, graphs, p)
            out.append(self._step_fn(_instance(state, k), fs, sp, cc))
        return tree_map(lambda *v: torch.stack(v), *out)
