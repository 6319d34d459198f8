"""The block-Jacobi preconditioner of the port (``preconditioner=
"block_jacobi"``) held to opt_tpu on the CPU: the pivot-free block inverse,
the per-point M⁻¹ (GN, and LM's damped blocks) packed for the fused loop,
the twin's block apply against the Pallas kernel's block_pre form in
interpret mode (GN and LM, grid and graph), and the JAX package's own
block-Jacobi tests through the port. The 3-D case is in
test_torch_volumetric.py; the CUDA instances run on the card in
chip_smoke.py."""

import jax
import numpy as np
import pytest
import torch

from opt_tpu.assembly import _gauss_jordan_inv as j_gauss_jordan_inv
from opt_tpu_torch.assembly import _gauss_jordan_inv as t_gauss_jordan_inv
from opt_tpu_torch.functions import FunctionSet as TFunctionSet
from opt_tpu_torch.utils.convert import inputs_from_numpy
from tests.test_torch_cg_variants import (
    ARAP8_ROWS,
    ARAP_DIMS,
    GRID,
    WARP24,
    assert_twin_matches,
    count_fused,
    jax_cg_call,
    jplan,
    tplan,
)

torch.set_num_threads(2)

f32 = np.float32


def test_gauss_jordan_inverse_matches_jax():
    rng = np.random.RandomState(5)
    A = rng.randn(64, 6, 6).astype(f32)
    B = A @ np.swapaxes(A, -1, -2) + 6 * np.eye(6, dtype=f32)
    want = np.asarray(j_gauss_jordan_inv(jax.numpy.asarray(B)))
    got = t_gauss_jordan_inv(torch.as_tensor(B)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(got @ B, np.broadcast_to(np.eye(6), B.shape), atol=1e-5)


def _block_pre_pair(name, dims, inputs, kind="gaussNewtonGPU"):
    """The block-Jacobi operand of each package's fused loop at the first
    step: (JAX numpy [*dom, C, C], port tensor)."""
    jcall = jax_cg_call(name, dims, inputs, kind, preconditioner="block_jacobi")
    _meta, _r0, _pre, kw = tplan(name, dims, kind, preconditioner="block_jacobi").cg_inputs(
        inputs_from_numpy(inputs, device="cpu"))
    return jcall, kw["pre_blocks"]


@pytest.mark.parametrize("case", ["image_warping", "arap_lm"])
def test_block_pre_matches_jax(case):
    """make_block_pre's M⁻¹, row-masked and packed for the fused loop,
    against opt_tpu's at 1e-5: a grid (Offset × Angle blocks) and a graph
    under LM (the damped blocks B + diag(CtC))."""
    if case == "image_warping":
        jcall, got = _block_pre_pair("image_warping", GRID, WARP24)
    else:
        jcall, got = _block_pre_pair("arap_mesh_deformation", ARAP_DIMS, ARAP8_ROWS, "LMGPU")
    want = np.asarray(jcall[3]["pre_blocks"])
    assert got is not None and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("form", ["grid_gn", "grid_lm", "graph_gn", "graph_lm"])
def test_block_twin_matches_pallas_interpret(form):
    """The twin's block apply against the Pallas kernel's block_pre form,
    GN and LM, on image_warping (grid) and the arap grid mesh (graph), with
    no exit and with the real exits."""
    kind = "LMGPU" if form.endswith("lm") else "gaussNewtonGPU"
    if form.startswith("grid"):
        call = jax_cg_call("image_warping", GRID, WARP24, kind, preconditioner="block_jacobi")
    else:
        call = jax_cg_call("arap_mesh_deformation", ARAP_DIMS, ARAP8_ROWS, kind,
                           preconditioner="block_jacobi")
    assert call[3]["pre_blocks"] is not None
    over = dict(q_tolerance=-np.inf) if kind == "LMGPU" else {}
    assert_twin_matches(call, 25, 0.0, expect=25, **over)
    assert 1 < assert_twin_matches(call, 300, 1e-8, **over) < 300


def test_fused_grid_block_jacobi_matches_eager_and_jax(monkeypatch):
    """tests/test_pallas.py:379 through the port: the fused (twin) and
    eager block-Jacobi loops take equal CG iterations to the same cost,
    and match opt_tpu's fused block-Jacobi solve."""
    n = 24
    ur = np.stack(np.meshgrid(np.arange(n), np.arange(n), indexing="ij"), -1).astype(f32)
    con = -np.ones((n, n, 2), f32)
    con[2, 2] = [3.0, 1.5]
    con[n - 3, n - 3] = [n - 5.0, n - 2.0]
    inputs = {"Offset": ur.copy(), "Angle": np.zeros((n, n), f32), "UrShape": ur,
              "Constraints": con, "Mask": np.zeros((n, n), f32),
              "w_fitSqrt": f32(10.0), "w_regSqrt": f32(0.1)}
    sp = dict(nIterations=1, lIterations=25)
    calls = count_fused(monkeypatch)
    fused = tplan("image_warping", GRID, preconditioner="block_jacobi")
    a = fused.solve(dict(inputs), **sp)
    assert fused.fused_fallback is None and len(calls) == 1
    b = tplan("image_warping", GRID, preconditioner="block_jacobi", use_pallas_cg="off").solve(
        dict(inputs), **sp)
    assert len(calls) == 1
    j = jplan("image_warping", GRID, preconditioner="block_jacobi",
              use_pallas_cg="interpret").solve(dict(inputs), **sp)
    assert a.num_linear_iterations == b.num_linear_iterations == j.num_linear_iterations
    np.testing.assert_allclose(a.final_cost, b.final_cost, rtol=1e-5)
    np.testing.assert_allclose(a.final_cost, j.final_cost, rtol=1e-5)


def test_block_jacobi_lm_damped_blocks():
    """tests/test_block_jacobi.py:175 through the port: LM with the damped
    blocks lands on the scalar-Jacobi cost with fewer CG iterations."""
    sp = dict(nIterations=10, lIterations=200, cg_rz_tolerance=1e-5)
    res_j = tplan("arap_mesh_deformation", ARAP_DIMS, "LMGPU").solve(dict(ARAP8_ROWS), **sp)
    plan_b = tplan("arap_mesh_deformation", ARAP_DIMS, "LMGPU", preconditioner="block_jacobi")
    res_b = plan_b.solve(dict(ARAP8_ROWS), **sp)
    assert plan_b.fused_fallback is None
    np.testing.assert_allclose(res_b.final_cost, res_j.final_cost, rtol=5e-3)
    assert res_b.num_linear_iterations < 0.8 * res_j.num_linear_iterations, (
        res_b.num_linear_iterations, res_j.num_linear_iterations)


def test_block_pre_built_from_full_precision_under_bf16():
    """tests/test_block_jacobi.py:105 through the port: narrowing covers the
    loop's coefficients only, so M⁻¹·r is identical with and without it."""
    rng = np.random.RandomState(3)
    z = {}
    for coeff in (None, "bfloat16"):
        plan = tplan("arap_mesh_deformation", ARAP_DIMS, preconditioner="block_jacobi",
                     coefficient_dtype=coeff)
        u, c, g, p = plan._normalize_and_place(inputs_from_numpy(ARAP8_ROWS, device="cpu"))
        fs = TFunctionSet(plan.compiled, c, g, p)
        fs.masks(u)
        A, _d, _j, meta = fs.assemble_stencil(u, plan.solver._stencil_plan, coeff_dtype=coeff)
        assert meta["F"].dtype == (torch.bfloat16 if coeff else torch.float32)
        if not z:
            r = {k: torch.as_tensor(rng.randn(*plan.compiled.unknown_shape(k)).astype(f32))
                 for k in plan.compiled.unknown_names}
        z[coeff] = A.block_pre()(r)
    for k in z[None]:
        assert torch.equal(z[None][k], z["bfloat16"][k])
