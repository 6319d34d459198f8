"""Compare the code nvcc makes for kernel instances from two copies of the
CUDA source: registers and spills (ptxas -v), the SASS's instruction count
and local-memory loads and stores, and the PTX, line for line.

    python -m opt_tpu_torch.ops.codegen_diff OLD.cu NEW.cu [--instances gn,gn_bf16] [--out DIR]

Each source is compiled once with the build's arch and optimisation flags
(``_build.NVCC_FLAGS``): the unit that instantiates the one-system form,
``csrc/fused_grid_cg_one.cu`` (an older tree's single
``csrc/fused_grid_cg.cu``), or the graph kernel's ``csrc/tiled_graph_cg.cu``.
An instance is a one-system instance named as ``fused_cg.instance_name``
names it (``gn``, ``lm_cs``, ``gn_bf16_rem``...; its template's last
argument may be the older ``bool MULTI`` or the ``int FORM`` of today's
source), or a graph kernel's (``gn_rem_tiled``, ``lm_rem_tiled``,
``gn_dia_tiled``...: tiled_graph_cg_kernel<LM> of an older tree,
<LM, STREAM> of today's). Prints one JSON line an instance (with the
count of SASS lines that differ, the function's name left out) and
writes each source's PTX and SASS of it, and the PTX diff, to DIR. Needs
the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import collections
import difflib
import json
import re
import subprocess
import tempfile
from pathlib import Path

from ._build import NVCC_FLAGS, nvcc_path

ARCH = NVCC_FLAGS[:2]  # -gencode arch=compute_90a,code=sm_90a
_OPCODE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def instance_pattern(name: str) -> str:
    """The mangled-name pattern of the one-system instance `name`."""
    parts = name.split("_")
    b = lambda f: "Lb1E" if f else "Lb0E"  # noqa: E731
    if parts[-1] == "tiled":  # the graph kernel's
        stream = "Lb1E" if "dia" in parts else "(?:Lb0E)?"
        return "tiled_graph_cg_kernelI" + b(parts[0] == "lm") + stream + "E"
    return ("fused_grid_cg_kernelI" + b(parts[0] == "lm") + b("rem" in parts) + b("cs" in parts)
            + b("bj" in parts) + ("13__nv_bfloat16" if "bf16" in parts else "f") + "L[bi]0EE")


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def compile_source(src: Path) -> dict:
    """ptxas's -v lines, the cubin's SASS and the PTX of the source."""
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory() as work:
        cubin, ptx = Path(work) / "k.cubin", Path(work) / "k.ptx"
        log = _run([nvcc, *ARCH, "-std=c++17", "-O3", "-Xptxas", "-v", "-cubin",
                    "-o", str(cubin), str(src)])
        _run([nvcc, *ARCH, "-std=c++17", "-O3", "-ptx", "-o", str(ptx), str(src)])
        sass = _run([str(Path(nvcc).with_name("cuobjdump")), "-sass", str(cubin)])
        return {"log": log.splitlines(), "sass": sass.splitlines(),
                "ptx": ptx.read_text().splitlines()}


def instance_code(out: dict, pattern: str) -> dict:
    """One instance's registers, spills, SASS and PTX from compile_source."""
    regs = spill = None
    lines = out["log"]
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and re.search(pattern, line):
            for nxt in lines[i + 1:i + 6]:
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", nxt)
                if m:
                    spill = (int(m.group(1)), int(m.group(2)))
                m = re.search(r"Used (\d+) registers", nxt)
                if m:
                    regs = int(m.group(1))
                    break
            break
    sass, keep = [], False
    for line in out["sass"]:
        if "Function :" in line:
            keep = bool(re.search(pattern, line))
        if keep:
            sass.append(line)
    ptx, keep = [], False
    for line in out["ptx"]:
        if line.startswith((".visible .entry", ".entry")):
            keep = bool(re.search(pattern, line))
        if keep:
            ptx.append(line)
            if line == "}":
                keep = False
    ops = collections.Counter(m.group(1).split(".")[0] for m in map(_OPCODE.search, sass) if m)
    return {"registers": regs, "spill_store_load_bytes": spill,
            "sass_instructions": sum(ops.values()), "local_loads": ops["LDL"],
            "local_stores": ops["STL"], "ptx_lines": len(ptx),
            "sass": sass, "ptx": ptx, "opcodes": ops}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old", type=Path)
    ap.add_argument("new", type=Path)
    ap.add_argument("--instances", default="gn")
    ap.add_argument("--out", type=Path, default=Path("build") / "codegen_diff")
    args = ap.parse_args()
    args.out.mkdir(parents=True, exist_ok=True)
    built = {"old": compile_source(args.old.resolve()), "new": compile_source(args.new.resolve())}
    for name in args.instances.split(","):
        pattern = instance_pattern(name)
        res = {tag: instance_code(out, pattern) for tag, out in built.items()}
        for tag, r in res.items():
            r["sass_text"] = r.pop("sass")
            (args.out / f"{name}.{tag}.sass").write_text("\n".join(r["sass_text"]) + "\n")
            r["ptx_text"] = r.pop("ptx")
            (args.out / f"{name}.{tag}.ptx").write_text("\n".join(r["ptx_text"]) + "\n")
        # the mangled names differ between the template forms: compare the
        # bodies under one name
        norm = lambda body: [re.sub(pattern, "K", s) for s in body]  # noqa: E731
        diff = list(difflib.unified_diff(norm(res["old"].pop("ptx_text")),
                                         norm(res["new"].pop("ptx_text")),
                                         "old.ptx", "new.ptx", lineterm="", n=2))
        (args.out / f"{name}.ptx.diff").write_text("\n".join(diff) + "\n")
        sass_diff = list(difflib.unified_diff(
            [s for s in norm(res["old"]["sass_text"]) if "Function :" not in s],
            [s for s in norm(res["new"]["sass_text"]) if "Function :" not in s], lineterm="",
            n=0))
        for r in res.values():
            r.pop("sass_text")
        old_ops, new_ops = res["old"].pop("opcodes"), res["new"].pop("opcodes")
        print(json.dumps({
            "instance": name, **res,
            "ptx_changed_lines": sum(1 for s in diff if s[:1] in "+-" and s[:3] not in ("+++", "---")),
            "sass_changed_lines": sum(1 for s in sass_diff
                                      if s[:1] in "+-" and s[:3] not in ("+++", "---")),
            "sass_opcode_delta": {op: new_ops[op] - old_ops[op]
                                  for op in sorted(set(old_ops) | set(new_ops))
                                  if new_ops[op] != old_ops[op]},
            "out": str(args.out)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
