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
  min-radius exits.

The JAX package runs a whole solve as one XLA program. Here the nonlinear
loop runs on the host with one device→host read per nonlinear step; the CG
loop runs either as one CUDA kernel launch (ops/fused_cg.py; the plain twin
on the CPU) or as the eager loop of ``_run_cg`` on the assembled operator.

Chronopoulos–Gear CG, block-Jacobi and narrowed coefficient storage are
later slices of the port (ROADMAP.md queue 1 item 8) and raise
``NotImplementedError``.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..compile import CompiledProblem
from ..functions import FunctionSet, tree_dot
from ..ops.fused_cg import _run_cg, fused_grid_cg
from .params import (
    FLOAT_EPSILON,
    GuardedInvertType,
    InitializationParameters,
    JacobiScalingType,
    resolve_auto_policy,
)

LATER_SLICE = "not ported yet (ROADMAP.md queue 1 item 8)"


def _f32(v) -> float:
    """A solver parameter as the JAX package traces it: rounded to float32."""
    return float(np.float32(v))


class GaussNewtonSolver:
    """One solver instance per compiled problem."""

    def __init__(
        self,
        compiled: CompiledProblem,
        uses_lambda: bool,
        init_params: Optional[InitializationParameters] = None,
    ):
        self.compiled = compiled
        self.uses_lambda = bool(uses_lambda)
        self.ip = resolve_auto_policy(
            init_params or InitializationParameters(), 1, bool(compiled.registry.graphs)
        )
        if self.ip.cg_variant != "standard":
            raise NotImplementedError(f"cg_variant={self.ip.cg_variant!r} is {LATER_SLICE}")
        if self.ip.preconditioner != "jacobi":
            raise NotImplementedError(
                f"preconditioner={self.ip.preconditioner!r} is {LATER_SLICE}"
            )
        if self.ip.coefficient_dtype is not None:
            raise NotImplementedError(f"coefficient_dtype is {LATER_SLICE}")
        if self.ip.dynamic_topology and compiled.registry.graphs:
            raise NotImplementedError(
                "dynamic_topology is not ported yet (ROADMAP.md queue 1 item 10)"
            )
        if self.ip.use_explicit_jtj:
            raise NotImplementedError(
                "use_explicit_jtj is not ported yet (ROADMAP.md queue 1 item 12)"
            )
        self._stencil_plan = None
        # why a step ran the eager loop where the fused one was asked for
        # (Plan.fused_fallback), or None
        self.fused_fallback = None
        if self.ip.use_fused_jtj:
            from ..assembly import plan_assembly

            self._stencil_plan = plan_assembly(
                compiled.spec_fn, compiled,
                memory_limit_bytes=self.ip.fused_jtj_memory_limit_bytes,
            )
        mode = self.ip.use_pallas_cg
        if mode == "interpret":
            self._pallas_mode = "interpret"
        elif mode in (False, "off", None):
            self._pallas_mode = None
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

    def _note_no_kernel(self) -> None:
        """A float32 step's assembled operator had no form the fused CG
        loop takes (ops/fused_cg.py's planners returned None), so the step
        runs the eager loop: say so once, on stderr whatever the verbosity,
        and in ``fused_fallback``. float64 plans run the eager loop by
        design (the fused loop is float32) and note nothing."""
        if (self._pallas_mode is None or self._stencil_plan is None
                or self.compiled.dtype != torch.float32 or self.fused_fallback is not None):
            return
        self.fused_fallback = "no_kernel"
        print(
            "opt_tpu_torch: the assembled operator has no form the fused CG kernel "
            "takes; this plan runs the eager CG loop",
            file=sys.stderr,
        )

    # -- state -----------------------------------------------------------------
    def _init_state(self, X, consts, graphs, params, sp):
        fs = FunctionSet(self.compiled, consts, graphs, params)
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
        fs = FunctionSet(self.compiled, consts, graphs, params)
        return self._step_fn(state, fs, sp)

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
        return fs.assemble_const(X0, self._stencil_plan)

    # ---- shared PCG pieces -------------------------------------------------
    def _linear_system(self, X, fs: FunctionSet, asm_cache=None):
        """The undamped system at X, shared by GN and LM: (A = JᵀJ·(),
        the assembled diag(JᵀJ) or None where nothing was assembled, the
        residual terms, r0 = -JᵀF, cg_meta: the fused grid CG descriptor or
        None)."""
        fs.masks(X)
        if self._stencil_plan is not None:
            if asm_cache is None:
                asm_cache = self._asm_cache(fs, X)
            A, diag, jtf_fn, cg_meta = fs.assemble_stencil(X, self._stencil_plan, asm_cache)
            r_terms = jtf_fn.r_terms
            if r_terms is None:  # every probe hoisted: evaluate residuals
                r_terms = fs.F(X)
            r0 = {k: -v for k, v in jtf_fn(r_terms).items()}
            return A, diag, r_terms, r0, cg_meta
        r_terms, J, JT = fs.linearize(X)
        r0 = {k: -v for k, v in JT(r_terms).items()}
        return (lambda v: JT(J(v))), None, r_terms, r0, None

    def gn_system(self, X, fs: FunctionSet, asm_cache=None):
        """The linear system of one GN step at X: (A, r0 = -JᵀF, pre, cg_meta)
        with pre the row-masked guarded-inverted Jacobi diagonal (ones when
        the spec disables the preconditioner) and cg_meta the fused grid CG
        descriptor or None."""
        A, diag, _r, r0, cg_meta = self._linear_system(X, fs, asm_cache)
        if self.compiled.use_preconditioner:
            pre_raw = diag if diag is not None else fs.jtj_diag(X)
        else:
            pre_raw = {k: torch.ones_like(v) for k, v in r0.items()}
        pre = fs.mask_rows(self._guarded_invert(pre_raw))
        return A, r0, pre, cg_meta

    def _gn_step(self, state, fs: FunctionSet, sp, asm_cache=None):
        X = state["X"]
        A, r0, pre, cg_meta = self.gn_system(X, fs, asm_cache)
        if cg_meta is not None and self._pallas_mode is not None:
            delta, l_done = fused_grid_cg(
                cg_meta, r0, pre, sp["lIterations"], sp["cg_rz_tolerance"],
                guard_div=self.ip.guard_division_by_zero,
                interpret=self._pallas_mode == "interpret",
            )
        else:
            self._note_no_kernel()
            delta, l = _run_cg(
                r0, A, lambda r: {k: pre[k] * r[k] for k in r}, tree_dot,
                sp["lIterations"], sp["cg_rz_tolerance"],
                guard_div=self.ip.guard_division_by_zero,
            )
            l_done = torch.full((), l, dtype=torch.int32, device=state["n_iter"].device)
        X_new = {k: X[k] + delta[k] for k in X}
        return {
            **state,
            "X": X_new,
            "prev_cost": fs.cost(X_new).to(state["prev_cost"].dtype),
            "n_iter": state["n_iter"] + 1,
            "lin_iters": state["lin_iters"] + l_done,
        }

    def _lm_parts(self, X, fs: FunctionSet, state, sp, asm_cache=None):
        """Everything one LM step needs at X: the damped system and what
        ``_lm_finish`` reads (opt_tpu/solver/gauss_newton.py:640-700)."""
        dt = self.compiled.dtype
        radius = state["trust_region_radius"].to(dt)
        A_base, diag, r_terms, r0, cg_meta = self._linear_system(X, fs, asm_cache)
        if diag is None:
            diag = fs.jtj_diag(X)
        # diag: the actual diag(JᵀJ), also under UsePreconditioner(false)
        if self.compiled.use_preconditioner:
            pre_raw = diag
        else:
            pre_raw = fs.mask_rows({k: torch.ones_like(v) for k, v in diag.items()})
        pre_guarded = fs.mask_rows(self._guarded_invert(pre_raw))

        # JacobiScaling ONCE_PER_SOLVE: freeze the guarded-inverted diagonal
        # of the first nonlinear iteration (PCGSaveSSq, t:607-613)
        js = self.ip.jacobi_scaling
        if js == JacobiScalingType.ONCE_PER_SOLVE:
            first = state["n_iter"] == 0
            SSq = {k: torch.where(first, pre_guarded[k], state["SSq"][k]) for k in pre_guarded}
            invS = {k: 1.0 / v for k, v in SSq.items()}
        elif js == JacobiScalingType.EVERY_ITERATION:
            SSq = state["SSq"]
            invS = {k: 1.0 / v for k, v in pre_guarded.items()}
        else:
            SSq = state["SSq"]
            invS = {k: torch.ones_like(v) for k, v in diag.items()}

        # PCGComputeCtC + PCGFinalizeDiagonal (t:631-664)
        min_d, max_d = _f32(sp["min_lm_diagonal"]), _f32(sp["max_lm_diagonal"])
        ctc, pre_lm = {}, {}
        for k in diag:
            ctc_un = diag[k] / radius
            mult = invS[k] / radius
            ctc[k] = torch.clamp(ctc_un, min_d * mult, max_d * mult)
            pre_lm[k] = 1.0 / (ctc[k] + radius * ctc_un)
        # select masking: at excluded rows diag = 0, so SSq = 0, invS = inf
        # and ctc = inf, where multiplicative masking would give NaN
        ctc = fs.mask_rows_select(ctc)
        pre_lm = fs.mask_rows_select(pre_lm)
        return {
            "meta": cg_meta, "r0": r0, "pre_lm": pre_lm, "ctc": ctc,
            "A_base": A_base, "r_terms": r_terms, "SSq": SSq,
        }

    def lm_system(self, X, fs: FunctionSet, state, sp):
        """The linear system of one LM step at X from ``state``: (cg_meta,
        r0 = -JᵀF, pre_lm, ctc), as the solver hands them to the fused CG
        (cg_meta is None where the operator does not qualify); ``sp``: the
        normalized solver parameters."""
        parts = self._lm_parts(X, fs, state, sp)
        return parts["meta"], parts["r0"], parts["pre_lm"], parts["ctc"]

    def _lm_step(self, state, fs: FunctionSet, sp, asm_cache=None):
        X = state["X"]
        s = self._lm_parts(X, fs, state, sp, asm_cache)
        r0, pre_lm, ctc = s["r0"], s["pre_lm"], s["ctc"]
        q_tol = _f32(sp["q_tolerance"])
        if s["meta"] is not None and self._pallas_mode is not None:
            delta, l_done = fused_grid_cg(
                s["meta"], r0, pre_lm, sp["lIterations"], sp["cg_rz_tolerance"],
                guard_div=self.ip.guard_division_by_zero,
                interpret=self._pallas_mode == "interpret",
                ctc=ctc, reset_period=sp["residual_reset_period"], q_tolerance=q_tol,
            )
        else:
            self._note_no_kernel()
            A_base = s["A_base"]

            def A(v):  # JᵀJp + CtC·p (o.t:2076-2082)
                base = A_base(v)
                return {k: base[k] + ctc[k] * v[k] for k in v}

            delta, l = _run_cg(
                r0, A, lambda r: {k: pre_lm[k] * r[k] for k in r}, tree_dot,
                sp["lIterations"], sp["cg_rz_tolerance"],
                guard_div=self.ip.guard_division_by_zero,
                reset_period=sp["residual_reset_period"], q_tol=q_tol,
            )
            l_done = torch.full((), l, dtype=torch.int32, device=state["n_iter"].device)
        return self._lm_finish(
            state, fs, sp, X, delta, l_done, s["r_terms"], fs.jvp_fn(X), s["SSq"]
        )

    def _lm_finish(self, state, fs, sp, X, delta, l_done, r_terms, J, SSq):
        """Ceres-style trust-region bookkeeping (t:1106-1164), on the device:
        accept/reject, the radius update and the function-tolerance and
        min-radius exits."""
        dt = self.compiled.dtype
        radius = state["trust_region_radius"].to(dt)
        model_cost = fs.model_cost(X, r_terms, J, delta)
        prev_cost = state["prev_cost"].to(dt)
        model_cost_change = prev_cost - model_cost

        X_new = {k: X[k] + delta[k] for k in X}
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
            fs = FunctionSet(self.compiled, consts, graphs, params)
            state = self._step_fn(state, fs, sp, asm_cache)
            costs.append(state["prev_cost"])
        return state, costs
