"""opt_tpu_torch.ops.codegen_diff's reading of nvcc's output, on
hand-written ptxas, cuobjdump and PTX text (nvcc itself runs only where the
CUDA toolkit is installed)."""

import re

import pytest

from opt_tpu_torch.ops import codegen_diff, fused_cg

OLD_GN = "_Z20fused_grid_cg_kernelILb0ELb0ELb0ELb0EfLb0EEvPKT3_"  # bool MULTI
NEW_GN = "_Z20fused_grid_cg_kernelILb0ELb0ELb0ELb0EfLi0EEvPKT3_"  # int FORM
NEW_GN_BATCH = "_Z20fused_grid_cg_kernelILb0ELb0ELb0ELb0EfLi2EEvPKT3_"
NEW_LM_BF16 = "_Z20fused_grid_cg_kernelILb1ELb0ELb0ELb0E13__nv_bfloat16Li0EEvPKT3_"


def compiled(name, spill, regs, sass_ops):
    log = [f"ptxas info    : Compiling entry function '{NEW_GN_BATCH}' for 'sm_90a'",
           "ptxas info    : Used 30 registers",
           f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
           f"    {spill} bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads",
           f"ptxas info    : Used {regs} registers, 400 bytes cmem[0]"]
    sass = [f"\t\tFunction : {NEW_GN_BATCH}", "        /*0000*/   STL [R1], R2 ;"]
    sass += [f"\t\tFunction : {name}"]
    sass += [f"        /*{16 * i:04x}*/   {op} ;  /* 0x000 */" for i, op in enumerate(sass_ops)]
    ptx = [f".visible .entry {NEW_GN_BATCH}(", "{", "\tret;", "}",
           f".visible .entry {name}(", "{", "\tmov.u32 %r1, %tid.x;", "\tret;", "}"]
    return {"log": log, "sass": sass, "ptx": ptx}


@pytest.mark.parametrize("name, flags", [
    ("gn", (False, False, False, False, False)),
    ("lm_cs_bf16", (True, False, True, False, True)),
    ("gn_bj_rem", (False, True, False, True, False)),
])
def test_instance_pattern_matches_one_system_instances(name, flags):
    assert fused_cg.instance_name(*flags) == name
    pattern = codegen_diff.instance_pattern(name)
    lm, rem, cs, block, bf16 = ("Lb1E" if f else "Lb0E" for f in flags)
    ft = "13__nv_bfloat16" if flags[4] else "f"
    for last in ("Lb0E", "Li0E"):  # the older bool MULTI and today's int FORM
        assert re.search(pattern, f"_Z20fused_grid_cg_kernelI{lm}{rem}{cs}{block}{ft}{last}Ev")
    for last in ("Li1E", "Li2E", "Lb1E"):  # the multi-system forms
        assert not re.search(pattern, f"_Z20fused_grid_cg_kernelI{lm}{rem}{cs}{block}{ft}{last}Ev")


def test_instance_code_reads_one_instance():
    ops = ["LDC R1, c[0x0][0x28]", "@P0 STL [R1], R4", "@!P1 LDL R4, [R1]", "BAR.SYNC.DEFER_BLOCKING 0x0",
           "STL.64 [R1+0x8], R6", "EXIT"]
    got = codegen_diff.instance_code(compiled(OLD_GN, 8, 32, ops), codegen_diff.instance_pattern("gn"))
    assert got["registers"] == 32
    assert got["spill_store_load_bytes"] == (8, 8)
    assert got["sass_instructions"] == 6
    assert (got["local_stores"], got["local_loads"]) == (2, 1)
    assert got["opcodes"]["BAR"] == 1
    assert got["ptx"][0].startswith(".visible .entry " + OLD_GN) and got["ptx"][-1] == "}"
    assert got["ptx_lines"] == 5


def test_instance_code_tells_instances_apart():
    out = compiled(NEW_LM_BF16, 0, 32, ["EXIT"])
    assert codegen_diff.instance_code(out, codegen_diff.instance_pattern("gn"))["registers"] is None
    got = codegen_diff.instance_code(out, codegen_diff.instance_pattern("lm_bf16"))
    assert got["registers"] == 32 and got["local_stores"] == 0 and got["sass_instructions"] == 1
