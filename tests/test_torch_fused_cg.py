"""The fused grid CG's plain twin held to the JAX package's Pallas kernel
(``fused_grid_cg(..., interpret=True)``), on a meta carried across by
``meta_from_numpy`` — the analogue of tests/test_pallas.py:27 — plus the
loop's edge exits and the kernel wrapper's host-side contract (GN and LM
forms). The CUDA kernel itself runs on the card in chip_smoke.py."""

import jax
import numpy as np
import pytest
import torch

import opt_tpu as ot
from opt_tpu.functions import FunctionSet as JFunctionSet
from opt_tpu.models import specs as jspecs
from opt_tpu.ops.pallas_cg import fused_grid_cg as j_fused
from opt_tpu_torch.ops import fused_cg
from opt_tpu_torch.utils.convert import meta_from_numpy

torch.set_num_threads(2)

N = 32
# f32 CG iterates whose dot products are summed in another order
DELTA_RTOL = 1e-5


def _inputs(name):
    rng = np.random.RandomState(0)
    f32 = np.float32
    if name == "laplacian":
        return {"X": rng.rand(N, N).astype(f32), "A": rng.rand(N, N).astype(f32)}
    mask = np.ones((N, N), f32)
    mask[N // 4 : -N // 4, N // 4 : -N // 4] = 0.0
    return {"X": rng.rand(N, N, 4).astype(f32), "T": rng.rand(N, N, 4).astype(f32), "M": mask}


_SYSTEMS = {}


def _jax_system(name):
    """The JAX package's first GN system: (meta, r0, pre) as numpy."""
    if name not in _SYSTEMS:
        plan = ot.Problem(getattr(jspecs, name)).plan(dims={"W": N, "H": N})
        u, c, g, p = plan._normalize_and_place(_inputs(name))
        sv = plan.solver
        fs = JFunctionSet(plan.compiled, c, g, p)
        fs.masks(u)
        cc = fs.assemble_const(u, sv._stencil_plan)
        _A, diag, jtf_fn, meta = fs.assemble_stencil(u, sv._stencil_plan, cc)
        r_terms = jtf_fn.r_terms if jtf_fn.r_terms is not None else fs.F(u)
        r0 = {k: -v for k, v in jtf_fn(r_terms).items()}
        pre_raw = diag if plan.compiled.use_preconditioner else {
            k: jax.numpy.ones_like(v) for k, v in r0.items()
        }
        pre = fs.mask_rows(sv._guarded_invert(pre_raw))
        _SYSTEMS[name] = jax.device_get((meta, r0, pre))
    return _SYSTEMS[name]


def _pack(d, meta):
    a = np.concatenate([d[u] for u in meta["u_list"]], axis=-1)
    return torch.as_tensor(np.moveaxis(a, -1, 0).copy())


def _run_both(name, lits, tol, guard_div=True, zero_operator=False):
    meta_np, r0, pre = _jax_system(name)
    if zero_operator:
        meta_np = dict(meta_np, F=np.zeros_like(meta_np["F"]))
    jd, ji = j_fused(meta_np, r0, pre, lits, tol, guard_div=guard_div, interpret=True)
    meta = meta_from_numpy(meta_np, device="cpu")
    td, ti = fused_cg.fused_grid_cg_reference(
        meta["F"], meta["triples"], _pack(r0, meta), _pack(pre, meta), lits, tol,
        guard_div=guard_div,
    )
    jd = _pack(jax.device_get(jd), meta).numpy()
    return jd, int(ji), td.numpy(), ti


@pytest.mark.parametrize(
    "name,lits",
    [("poisson_image_editing", 120), ("laplacian", 120), ("poisson_image_editing", 40)],
)
def test_twin_matches_pallas_interpret(name, lits):
    jd, ji, td, ti = _run_both(name, lits, 1e-12)
    assert ti == ji
    assert ji > 10
    np.testing.assert_allclose(td, jd, rtol=0, atol=DELTA_RTOL * np.abs(jd).max())


def test_zero_iterations():
    jd, ji, td, ti = _run_both("poisson_image_editing", 0, 1e-12)
    assert ji == ti == 0
    assert not jd.any() and not td.any()


def test_zero_operator_exits_on_denominator():
    """pᵀAp = 0: one iteration is counted, the guarded α is 0, δ stays 0."""
    jd, ji, td, ti = _run_both("poisson_image_editing", 50, 1e-12, zero_operator=True)
    assert ji == ti == 1
    assert not jd.any() and not td.any()


def test_unguarded_division():
    jd, ji, td, ti = _run_both("laplacian", 30, 0.0, guard_div=False)
    assert ji == ti == 30
    np.testing.assert_allclose(td, jd, rtol=0, atol=DELTA_RTOL * np.abs(jd).max())


def test_wrapper_packs_and_runs_twin_on_cpu():
    meta_np, r0, pre = _jax_system("poisson_image_editing")
    meta = meta_from_numpy(meta_np, device="cpu")
    r0_t = {k: torch.as_tensor(np.array(v)) for k, v in r0.items()}
    pre_t = {k: torch.as_tensor(np.array(v)) for k, v in pre.items()}
    delta, iters = fused_cg.fused_grid_cg(meta, r0_t, pre_t, 60, 1e-12)
    assert iters.dtype == torch.int32 and iters.dim() == 0
    assert delta["X"].shape == (N, N, 4)
    ref, l = fused_cg.fused_grid_cg_reference(
        meta["F"], meta["triples"], _pack(r0, meta), _pack(pre, meta), 60, 1e-12
    )
    assert int(iters) == l
    assert torch.equal(delta["X"], torch.movedim(ref, 0, -1))


def test_device_triples_sorted_by_output_channel():
    triples = (((0, 1), 2, 0, 0), ((0, 0), 0, 0, 1), ((1, 0), 2, 1, 2), ((0, 0), 1, 1, 1))
    rows, starts = fused_cg._device_triples(triples, 3, torch.device("cpu"))
    # rows (d0, d1, d2, i, j, fid) on the domain [1, H, W]
    assert rows.tolist() == [[0, 0, 0, 0, 0, 1], [0, 0, 0, 1, 1, 1], [0, 0, 1, 2, 0, 0],
                             [0, 1, 0, 2, 1, 2]]
    assert starts.tolist() == [0, 1, 2, 4]
    assert rows.dtype == starts.dtype == torch.int32


@pytest.mark.parametrize("form", ["gn", "lm"])
def test_kernel_wrapper_refuses_cpu_tensors(form):
    meta = meta_from_numpy(_jax_system("laplacian")[0], device="cpu")
    b = torch.zeros((1, N, N))
    lm = dict(ctc=b, reset_period=7, q_tolerance=1e-4) if form == "lm" else {}
    with pytest.raises(ValueError, match="CUDA"):
        fused_cg.fused_grid_cg_kernel(meta, b, b, 10, 0.0, **lm)
