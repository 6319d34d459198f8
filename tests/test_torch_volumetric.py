"""volumetric_mesh_deformation, the 3-D grid form of the fused CG loop, held
to opt_tpu on the CPU: the 3-D grid descriptor against the JAX package's
planner, the twin against the Pallas kernel's 3-D form in interpret mode
(GN and LM, with and without the block-Jacobi preconditioner), the 6³
medium golden, and tests/test_pallas.py:158's solve through both packages.
The CUDA kernel's 3-D instances run on the card in chip_smoke.py."""

import numpy as np
import pytest
import torch

from opt_tpu_torch.ops import fused_cg
from opt_tpu_torch.utils.convert import inputs_from_numpy, meta_from_numpy
from tests.test_golden_costs import GOLDEN, _medium_cases
from tests.test_torch_cg_variants import (
    GOLDEN_RTOL,
    assert_twin_matches,
    count_fused,
    jax_cg_call,
    jplan,
    tplan,
)

torch.set_num_threads(2)

f32 = np.float32
VOL = "volumetric_mesh_deformation"
N = 8
DIMS = {"W": N, "H": N, "D": N}


def vol_inputs(n=N):
    """tests/test_pallas.py::test_fused_pallas_cg_3d_grid's inputs: one
    corner pinned, the opposite one pulled, the rest unconstrained."""
    rng = np.random.RandomState(2)
    ii, jj, kk = np.meshgrid(np.arange(n), np.arange(n), np.arange(n), indexing="ij")
    ur = np.stack([ii, jj, kk], -1).astype(f32)
    con = -1e6 * np.ones((n, n, n, 3), f32)
    con[0, 0, 0] = ur[0, 0, 0]
    con[-1, -1, -1] = ur[-1, -1, -1] + [1.0, 0.5, 0.0]
    return {
        "Offset": ur + rng.rand(n, n, n, 3).astype(f32) * 0.05,
        "Angle": np.zeros((n, n, n, 3), f32), "UrShape": ur, "Constraints": con,
        "w_fitSqrt": np.sqrt(2.0).astype(f32), "w_regSqrt": np.sqrt(1.0).astype(f32),
    }


INPUTS = vol_inputs()


def test_grid_meta_3d_matches_jax():
    """The port's 3-D descriptor equals opt_tpu's: the same 142 triples
    (3-D offsets, Offset × Angle couplings) and the same 128 masked fields
    to 1e-6 of their scale; the same r0 and Jacobi pre."""
    jmeta, jr0, jpre, _kw = jax_cg_call(VOL, DIMS, INPUTS)
    plan = tplan(VOL, DIMS)
    meta, r0, pre, kw = plan.cg_inputs(inputs_from_numpy(INPUTS, device="cpu"))
    assert plan.fused_fallback is None and meta is not None and kw["pre_blocks"] is None
    want = meta_from_numpy(jmeta, device="cpu")
    assert meta["triples"] == want["triples"]
    assert len(meta["triples"]) == 142 and tuple(meta["F"].shape) == (128, N, N, N)
    assert all(len(d) == 3 for (d, _i, _j, _f) in meta["triples"])
    F, Fj = meta["F"].numpy(), want["F"].numpy()
    np.testing.assert_allclose(F, Fj, rtol=0, atol=1e-6 * np.abs(Fj).max())
    for got, exp in ((r0, jr0), (pre, jpre)):
        for k, v in exp.items():
            np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-5, atol=1e-5 * np.abs(v).max())


@pytest.mark.parametrize("kind", ["gaussNewtonGPU", "LMGPU"])
@pytest.mark.parametrize("pre", ["jacobi", "block_jacobi"])
def test_twin_matches_pallas_interpret_3d(kind, pre):
    """The twin against the Pallas kernel's 3-D form on opt_tpu's first
    volumetric system: 15 iterations with no exit (δ within 1e-5 of
    max|δ|), then the real exits (LM: the rᵀz floor) at equal counts."""
    call = jax_cg_call(VOL, DIMS, INPUTS, kind, preconditioner=pre)
    assert (call[3]["pre_blocks"] is not None) == (pre == "block_jacobi")
    over = dict(q_tolerance=-np.inf) if kind == "LMGPU" else {}
    assert_twin_matches(call, 15, 0.0, expect=15, **over)
    assert 15 < assert_twin_matches(call, 400, 1e-8, **over) < 400


def test_block_pre_3d_matches_jax():
    """The 6×6 blocks that couple Offset and Angle, inverted and packed for
    the fused loop, against opt_tpu's at 1e-5."""
    want = np.asarray(jax_cg_call(VOL, DIMS, INPUTS, preconditioner="block_jacobi")[3]["pre_blocks"])
    got = tplan(VOL, DIMS, preconditioner="block_jacobi").cg_inputs(
        inputs_from_numpy(INPUTS, device="cpu"))[3]["pre_blocks"]
    assert tuple(got.shape) == want.shape == (N, N, N, 6, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    packed = fused_cg.pack_pre_blocks(got, {"F": torch.zeros(1, N, N, N)})
    assert torch.equal(packed[1 * 6 + 4], got[..., 1, 4])


def test_volumetric_medium_golden(monkeypatch):
    """tests/test_golden_costs.py's volumetric case (6³, GN 8×40) through
    the fused loop's twin: one fused call a step, the golden cost at the
    golden rtol."""
    kind, nl, li, golden = GOLDEN[VOL]
    dims, inputs = _medium_cases()[VOL]
    calls = count_fused(monkeypatch)
    plan = tplan(VOL, dims, kind)
    res = plan.solve(dict(inputs), nIterations=nl, lIterations=li)
    assert plan.fused_fallback is None and len(calls) == res.num_iterations == nl
    np.testing.assert_allclose(res.final_cost, golden, rtol=GOLDEN_RTOL)


def test_fused_3d_solve_matches_jax(monkeypatch):
    """tests/test_pallas.py:158's solve (GN 2×15) through both packages'
    fused loops (opt_tpu's Pallas kernel in interpret mode, the port's
    twin) and the port's eager loop: equal CG iterations and costs within
    1e-5."""
    jp = jplan(VOL, DIMS, use_pallas_cg="interpret")
    assert jp.solver._pallas_mode == "interpret"
    j = jp.solve(dict(INPUTS), nIterations=2, lIterations=15)
    calls = count_fused(monkeypatch)
    tp = tplan(VOL, DIMS)
    t = tp.solve(dict(INPUTS), nIterations=2, lIterations=15)
    assert tp.fused_fallback is None and len(calls) == t.num_iterations == 2
    e = tplan(VOL, DIMS, use_pallas_cg="off").solve(
        dict(INPUTS), nIterations=2, lIterations=15)
    assert len(calls) == 2
    assert t.num_linear_iterations == j.num_linear_iterations == e.num_linear_iterations
    np.testing.assert_allclose(t.costs, j.costs, rtol=1e-5)
    np.testing.assert_allclose(e.costs, t.costs, rtol=1e-5)


def test_3d_kernel_wrapper_refuses_cpu_tensors():
    meta = meta_from_numpy(jax_cg_call(VOL, DIMS, INPUTS)[0], device="cpu")
    b = torch.zeros((6, N, N, N))
    with pytest.raises(ValueError, match="CUDA"):
        fused_cg.fused_grid_cg_kernel(meta, b, b, 10, 0.0, cs=True)
