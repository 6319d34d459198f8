"""The tiled CG kernel on bfloat16 fields (csrc/tiled_grid_cg.cu's
``tiled_grid_cg_kernel<LM, false, __nv_bfloat16>``: ``gn_bf16_tiled``,
``lm_bf16_tiled``) on the CPU: its plan, route, register line and wrapper.

The kernel runs only on the card (chip_smoke.py holds it bitwise to the
twin and to the template's ``gn_bf16``/``lm_bf16`` there). The fields are a
type, not a loop: the stencil widens each bfloat16 field exactly as it
reads it and multiplies in float32, so the standard emulation is the
kernel's loop on bf16 fields, and tests/test_torch_tiled_cg.py holds it on
bf16 F bitwise to the twin and to the JAX package's Pallas kernel with
``coefficient_dtype`` bfloat16 in interpret mode. Here: ``tiled_grid_plan``
takes bf16 fields under the standard loop with the Jacobi preconditioner at
the float32 plan's tiles and shared memory (the fields are not staged)."""

import pytest
import torch

from opt_tpu_torch.ops import _build, fused_cg
from tests.test_torch_tiled_cg import (
    N,
    RESET,
    SMEM,
    SMS,
    _iw_like_triples,
    _synthetic_meta,
    _system,
)

torch.set_num_threads(2)


def _lm(ctc, q_tol):
    return {} if ctc is None else dict(ctc=ctc, reset_period=RESET, q_tolerance=q_tol)


# -- plan and route --------------------------------------------------------------------


@pytest.mark.parametrize("C,lm", [(4, False), (3, False), (3, True), (4, True)])
def test_plan_takes_bf16_at_the_float32_plan(C, lm):
    """poisson 512²×4 and image_warping 512²×3, GN and LM: bf16 fields take
    the float32 plan's 12×11 tiles of 43×47 and its shared memory (132,740
    B poisson GN, 135,684 B LM, 99,752 B image_warping GN, 101,960 B LM):
    the fields are read from device memory, not staged."""
    triples = _iw_like_triples() if C == 3 else [
        (d, c, c, k) for c in range(C)
        for k, d in enumerate(((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1)))]
    meta = _synthetic_meta((1, 1), triples)
    meta["F"] = torch.empty((31 if C == 3 else 5, 512, 512))  # only its shape is read
    bf = dict(meta, F=meta["F"].to(torch.bfloat16))
    kw = dict(lm=lm, sm_count=SMS, smem_per_block=SMEM)
    plan = fused_cg.tiled_grid_plan(bf, C, (512, 512), **kw)
    assert plan == fused_cg.tiled_grid_plan(meta, C, (512, 512), **kw)
    assert plan["tiles"] == (12, 11) and plan["tile"] == (43, 47)
    assert plan["smem_bytes"] == {(4, False): 132740, (3, False): 99752, (3, True): 101960,
                                  (4, True): 135684}[(C, lm)]


@pytest.mark.parametrize("kind", ["GN", "LM"])
def test_route_names_the_bf16_instance(kind):
    meta, b, _pre, ctc = _system(f"image_warping {kind} bf16")
    lm = ctc is not None
    name = "lm" if lm else "gn"
    assert fused_cg.route_plan(meta, b, lm=lm) is not None
    assert fused_cg.launch_instance(meta, b, lm=lm) == name + "_bf16_tiled"
    # bf16 with block-Jacobi or Chronopoulos-Gear keeps the template
    pb = torch.zeros((9, N, N))
    assert fused_cg.route_plan(meta, b, lm=lm, pre_blocks=pb) is None
    assert fused_cg.launch_instance(meta, b, lm=lm, pre_blocks=pb) == name + "_bj_bf16"
    assert fused_cg.launch_instance(meta, b, lm=lm, cs=True) == name + "_cs_bf16"


def test_bf16_batch_keeps_the_template():
    """A batch of bf16 systems, with block-Jacobi (the multi form) or
    without: refused by the planner, the template's instances named."""
    n, B = 64, 4
    meta = _synthetic_meta((1, 1), _iw_like_triples(), batch=B, ctot=3)
    meta["F"] = torch.zeros((B, 31, n, n), dtype=torch.bfloat16)
    b = torch.zeros((B, 3, n, n))
    pb = torch.zeros((B, 9, n, n))
    for block in (False, True):
        assert fused_cg.tiled_grid_plan(meta, 3, (n, n), lm=True, block=block, sm_count=SMS,
                                        smem_per_block=SMEM) is None
    assert fused_cg.launch_instance(meta, b, lm=True, pre_blocks=pb) == "lm_bj_bf16_multi"
    assert fused_cg.launch_instance(meta, b, lm=True) == "lm_bf16_multi"


def test_plan_refuses_other_field_types():
    meta = _synthetic_meta((64, 64), [((0, 0), 0, 0, 0), ((0, 1), 0, 0, 1)])
    for dtype in (torch.float16, torch.float64):
        assert fused_cg.tiled_grid_plan(dict(meta, F=meta["F"].to(dtype)), 1, (64, 64), lm=False,
                                        sm_count=SMS, smem_per_block=SMEM) is None


def test_build_reads_the_bf16_kernels_registers():
    """tiled_grid_cg_kernel<LM, false, __nv_bfloat16, false, false> stands
    under gn_bf16_tiled and lm_bf16_tiled."""
    lines = []
    for lm in (0, 1):
        lines.append("ptxas info    : Compiling entry function "
                     f"'_Z20tiled_grid_cg_kernelILb{lm}ELb0E13__nv_bfloat16Lb0ELb0EEvPKT1_PKfS5_S5_PKi"
                     "S7_iiiiiiiiifiifiiPfS8_P7double2SA_PiS8_' for 'sm_90a'")
        lines.append(f"ptxas info    : Used {116 + 4 * lm} registers, used 1 barriers")
    regs = _build.instance_registers("\n".join(lines))
    assert regs == {(False, False, False, False, True, False, False, True): (116, 0, 0),
                    (True, False, False, False, True, False, False, True): (120, 0, 0)}
    assert [fused_cg.instance_name(*k) for k in regs] == ["gn_bf16_tiled", "lm_bf16_tiled"]


# -- the wrapper on the CPU ------------------------------------------------------------


@pytest.mark.parametrize("kind", ["GN", "LM"])
def test_bf16_launch_reaches_the_tiled_wrapper(kind):
    """A bf16 launch the route takes reaches the tiled wrapper, which checks
    F as bfloat16 and every other operand as float32, then raises for CPU
    tensors: nothing gives way to the template or to the twin."""
    meta, b, pre, ctc = _system(f"image_warping {kind} bf16")
    lm = _lm(ctc, 1e-4)
    with pytest.raises(ValueError, match="tiled_grid_cg_kernel needs CUDA"):
        fused_cg.fused_grid_cg_kernel(meta, b, pre, 10, 0.0, **lm)
    plan = fused_cg.route_plan(meta, b, lm=ctc is not None)
    with pytest.raises(ValueError, match="pre has dtype"):
        fused_cg.tiled_grid_cg_kernel(meta, b, pre.to(torch.bfloat16), 10, 0.0, plan, **lm)
    with pytest.raises(ValueError, match="F has shape"):
        fused_cg.tiled_grid_cg_kernel(dict(meta, F=meta["F"][:, :-1]), b, pre, 10, 0.0, plan,
                                      **lm)
    with pytest.raises(ValueError, match="float32 or bfloat16 fields"):
        fused_cg.tiled_grid_cg_kernel(dict(meta, F=meta["F"].to(torch.float16)), b, pre, 10, 0.0,
                                      plan, **lm)
