"""Build and load the port's CUDA kernels at first use.

``nvcc`` compiles the fused CG kernel (``csrc/fused_grid_cg.cuh``, the
template; ``csrc/fused_grid_cg_one.cu``, ``_multi.cu`` and ``_batch.cu``, its
instances, one form a unit; ``csrc/fused_grid_cg.cu``, their C interface),
``csrc/tiled_grid_cg.cu`` (the standard CG loop of a 2-D grid whose state,
or whose r and haloed p, fit one tile a block) and ``csrc/tiled_grid_cs.cu``
(its Chronopoulos–Gear loop; both include ``csrc/tiled_grid.cuh``),
``csrc/tiled_graph_cg.cu``
(the CG loop of a graph, one vertex range a block: with the remainder, its
fields staged, or without it, its fields read from device memory),
``csrc/tiled_vol_cg.cu`` (the GN loop of a 3-D grid, one box a block, its
fields staged; the four include ``csrc/tiled_cg.cuh``),
``csrc/tiled_batch_cg.cu`` (the CG loop of a batch of small systems, a
team of lanes of one warp a system, its state in shared memory)
and ``csrc/tile_apply.cu`` (the sharded solve's per-tile apply): each unit
by its own ``nvcc`` process, all started together, then one link into one
shared library with a plain C interface, bound with ``ctypes``. The library
goes to ``build/opt_tpu_torch/`` at the repository root, named by a hash of
the sources and flags, so an edited source rebuilds and an unchanged one
loads the cached library. Nothing here runs on ``import opt_tpu_torch``.
The ranks of a sharded solve load a library built beforehand (``python -m
opt_tpu_torch.ops._build``, or any call that builds it) and never start
``nvcc`` themselves.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
# the units nvcc compiles, each by its own process, and every source they read
UNITS = ("fused_grid_cg_one.cu", "fused_grid_cg_multi.cu", "fused_grid_cg_batch.cu",
         "fused_grid_cg.cu", "tiled_grid_cg.cu", "tiled_grid_cs.cu", "tiled_graph_cg.cu",
         "tiled_vol_cg.cu", "tiled_batch_cg.cu", "tile_apply.cu")
SOURCES = UNITS + ("fused_grid_cg.cuh", "tiled_cg.cuh", "tiled_grid.cuh")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "opt_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _run(cmd) -> tuple:
    """(return code, the command and its output, seconds) of one nvcc call."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    return proc.returncode, " ".join(cmd) + "\n" + proc.stdout + proc.stderr, time.perf_counter() - t0


def build_library(build: bool = True) -> dict:
    """Compile the sources if their hash has no library yet: every unit to
    an object at once, one nvcc process each, then one link. Returns {path,
    built, seconds (the whole build's wall time), units_s (each unit's
    nvcc seconds), log (nvcc's output, -Xptxas -v included)}.
    ``build=False`` raises instead of compiling where the library is
    missing."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    digest = _source_hash()
    lib = BUILD_DIR / f"libopt_tpu_torch_{digest}.so"
    log = BUILD_DIR / f"libopt_tpu_torch_{digest}.log"
    if lib.exists():
        return {"path": lib, "built": False, "seconds": 0.0, "units_s": {},
                "log": log.read_text() if log.exists() else ""}
    if not build:
        raise RuntimeError(
            f"the kernel library {lib.name} is not built: build it before starting the "
            "ranks (python -m opt_tpu_torch.ops._build)"
        )
    work = BUILD_DIR / f".tmp_{os.getpid()}_{digest}"
    work.mkdir(exist_ok=True)
    nvcc = nvcc_path()
    objs = [work / (Path(u).stem + ".o") for u in UNITS]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(UNITS)) as pool:
        runs = list(pool.map(_run, ([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / u)]
                                    for u, o in zip(UNITS, objs))))
    tmp = work / lib.name
    if all(rc == 0 for rc, _out, _s in runs):
        runs.append(_run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)]))
    seconds = time.perf_counter() - t0
    out = "".join(o for _rc, o, _s in runs)
    failed = [rc for rc, _o, _s in runs if rc != 0]
    if failed:
        shutil.rmtree(work, ignore_errors=True)
        raise RuntimeError(f"nvcc failed ({failed[0]}):\n{out}")
    log.write_text(out)
    os.replace(tmp, lib)
    shutil.rmtree(work, ignore_errors=True)
    return {"path": lib, "built": True, "seconds": seconds, "log": out,
            "units_s": {u: s for u, (_rc, _o, s) in zip(UNITS + ("link",), runs)}}


def built_log():
    """The ptxas log of the library built from these sources, or None where
    it is not built (nothing is compiled or created)."""
    log = BUILD_DIR / f"libopt_tpu_torch_{_source_hash()}.log"
    return log.read_text() if log.exists() else None


_INSTANCE = re.compile(
    r"fused_grid_cg_kernelILb([01])ELb([01])ELb([01])ELb([01])E(f|13__nv_bfloat16)Li([012])EE"
)
_TILED_INSTANCE = re.compile(
    r"tiled_grid_cg_kernelILb([01])ELb([01])E(f|13__nv_bfloat16)Lb([01])ELb([01])EE")
_TILED_CS_INSTANCE = re.compile(r"tiled_grid_cs_kernelILb([01])EE")
_GRAPH_INSTANCE = re.compile(r"tiled_graph_cg_kernelILb([01])ELb([01])EE")
_VOL_INSTANCE = re.compile(r"tiled_vol_cg_kernelILb([01])EE")
_BATCH_INSTANCE = re.compile(r"tiled_batch_cg_kernelILb([01])EE")


def instance_registers(log: str) -> dict:
    """{(lm, rem, cs, block, bf16, multi, batch): (registers, spill store
    bytes, spill load bytes)} from ptxas's -v output (the kernel's FORM: 0
    one system, 1 multi, 2 batch), the tiled kernel's ten instances
    (tiled_grid_cg_kernel<LM, BLOCK, FT, MULTI, HBM>) under (lm, False,
    False, block, bf16, multi, False, True): a block instance under both
    multi = False and True, the one kernel that solves one system or
    several in turn, the others under their MULTI; an HBM one under (lm,
    False, False, False, False, False, False, True, True);
    its Chronopoulos–Gear kernel's two (tiled_grid_cs_kernel<LM>) under
    (lm, False, True, False, False, False, False, True); and the graph
    kernel's four (tiled_graph_cg_kernel<LM, STREAM>): the resident ones
    under (lm, True, False, False, False, multi, False, True), multi False
    and True, the stream ones under (lm, False, False, False, False, False,
    False, True, False, True); and the 3-D grid kernel's two
    (tiled_vol_cg_kernel<BLOCK>) under (False, False, False, block, False,
    False, False, True, False, False, True); and the batch kernel's two
    (tiled_batch_cg_kernel<LM>) under (lm, False, False, False, False,
    False, True, True)."""
    regs, current, spill = {}, None, (0, 0)
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = _INSTANCE.search(line)
            t = _TILED_INSTANCE.search(line)
            c = _TILED_CS_INSTANCE.search(line)
            g = _GRAPH_INSTANCE.search(line)
            v = _VOL_INSTANCE.search(line)
            tb = _BATCH_INSTANCE.search(line)
            if tb:
                current = [(tb.group(1) == "1",) + (False,) * 5 + (True, True)]
            elif v:
                current = [(False,) * 3 + (v.group(1) == "1",) + (False,) * 3
                           + (True, False, False, True)]
            elif g and g.group(2) == "1":
                current = [(g.group(1) == "1",) + (False,) * 6 + (True, False, True)]
            elif g:
                lm = g.group(1) == "1"
                current = [(lm, True, False, False, False, multi, False, True)
                           for multi in (False, True)]
            elif m:
                lm, rem, cs, block = (g == "1" for g in m.groups()[:4])
                form = int(m.group(6))
                current = [(lm, rem, cs, block, m.group(5) != "f", form == 1, form == 2)]
            elif t and t.group(5) == "1":
                current = [(t.group(1) == "1",) + (False,) * 6 + (True, True)]
            elif t:
                lm, block = (g == "1" for g in t.groups()[:2])
                current = [(lm, False, False, block, t.group(3) != "f", multi, False, True)
                           for multi in ((False, True) if block else (t.group(4) == "1",))]
            elif c:
                current = [(c.group(1) == "1", False, True, False, False, False, False, True)]
            else:
                current = None
            spill = (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and current is not None:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None:
            for key in current:
                regs[key] = (int(m.group(1)),) + spill
            current = None
    return regs


_TILE_APPLY = re.compile(r"tile_apply_kernelI(f|d|13__nv_bfloat16)E")
_TILE_APPLY_TYPES = {"f": "float", "d": "double", "13__nv_bfloat16": "__nv_bfloat16"}


def tile_apply_registers(log: str) -> dict:
    """{instance, "tile_apply_kernel<float>", "<__nv_bfloat16>" or
    "<double>": (registers, spill store bytes, spill load bytes)} of the
    per-tile apply's three instances (csrc/tile_apply.cu) from ptxas's -v
    output."""
    regs, current, spill = {}, None, (0, 0)
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = _TILE_APPLY.search(line)
            current = None if m is None else (
                f"tile_apply_kernel<{_TILE_APPLY_TYPES[m.group(1)]}>")
            spill = (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and current is not None:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None:
            regs[current] = (int(m.group(1)),) + spill
            current = None
    return regs


def load_library(build: bool = True) -> ctypes.CDLL:
    """The kernels' shared library, built if needed (``build=False``: raise
    where it is missing), with its functions' ``argtypes``/``restype``
    declared."""
    lib = _LOADED.get("lib")
    if lib is not None:
        return lib
    info = build_library(build)
    lib = ctypes.CDLL(str(info["path"]))
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # lm, rem, cs, block, bf16, form (0 one system, 1 multi, 2 batch), threads, out
    lib.fused_grid_cg_max_blocks.argtypes = [i32] * 7 + [ctypes.POINTER(i32)]
    lib.fused_grid_cg_max_blocks.restype = i32
    lib.fused_grid_cg_launch.argtypes = [
        i32, i32, i32, i32, i32,  # lm, cs, block, bf16, batch
        vp, vp, vp, vp, vp, vp,  # F, b, pre, ctc, triples, starts
        vp, vp, vp,  # rowptr, col, blk (the remainder; null without)
        i32, i32, i32, i32,  # C (channels of a system), n_sys, f_sys_stride, blk_sys_stride
        i32, i32, i32,  # N0, N1, N2
        i32, f32, i32,  # lits, tol, guard_div
        i32, f32,  # reset_period, q_tol
        vp, vp, vp, vp, vp, vp,  # delta, r, p, Ap, z, s
        vp, vp, vp, vp,  # part0, part1, part2, iters
        i32, i32, vp,  # grid, threads, stream
    ]
    lib.fused_grid_cg_launch.restype = i32
    lib.tiled_grid_cg_device_limits.argtypes = [ctypes.POINTER(i32), ctypes.POINTER(i32)]
    lib.tiled_grid_cg_device_limits.restype = i32
    tiled_shape = [
        vp, vp, vp, vp, vp, vp,  # F, b, pre, ctc, triples, starts
        i32, i32, i32, i32,  # C, n_triples, N1, N2
        i32, i32, i32, i32, i32,  # tiles_r, tiles_c, th, tw, h
        i32, f32, i32, i32, f32,  # lits, tol, guard_div, reset_period, q_tol
    ]
    lib.tiled_grid_cg_launch.argtypes = [
        i32, i32, i32, i32, i32, *tiled_shape,  # lm, block, bf16, multi, hbm
        i32, i32,  # n_sys, f_stride (a system's fields: 0 under the split)
        vp, vp, vp, vp, vp, vp,  # delta, r_ring, partA, partB, iters, frames (hbm)
        i32, i32, vp,  # threads, smem_bytes, stream
    ]
    lib.tiled_grid_cg_launch.restype = i32
    lib.tiled_grid_cs_launch.argtypes = [
        i32, *tiled_shape,  # lm
        vp, vp, vp, vp, vp, vp,  # delta, r_ring, w_ring, partA, partB, iters
        i32, i32, vp,  # threads, smem_bytes, stream
    ]
    lib.tiled_grid_cs_launch.restype = i32
    lib.tiled_graph_cg_launch.argtypes = [
        i32, i32,  # lm, stream
        vp, vp, vp, vp, vp, vp, vp,  # F, b, pre, ctc, blk, triples, starts
        vp, vp, vp, vp, vp,  # rowptr, lcol, blocks, halo, border
        i32, i32, i32, i32, i32,  # C, T, n_triples, N, n_blocks
        i32, i32, i32, i32,  # nvm, nfm, nhm, nem (the largest range, frame, halo, entries)
        i32, f32, i32, i32, f32,  # lits, tol, guard_div, reset_period, q_tol
        i32, i32, i32,  # n_sys, f_stride, blk_stride (a system's fields and blocks)
        vp, vp, vp, vp, vp,  # delta, r_ring, partA, partB, iters
        i32, i32, vp,  # threads, smem_bytes, stream
    ]
    lib.tiled_graph_cg_launch.restype = i32
    lib.tiled_vol_cg_launch.argtypes = [
        i32,  # block
        vp, vp, vp, vp, vp,  # F, b, pre (the C*C planes under block), triples, starts
        i32, i32, i32, i32, i32, i32,  # C, T, n_triples, N0, N1, N2
        i32, i32, i32, i32, i32, i32, i32,  # boxes0, boxes1, boxes2, b0, b1, b2, h
        i32, f32, i32,  # lits, tol, guard_div
        vp, vp, vp, vp, vp,  # delta, z_ring, partA, partB, iters
        i32, i32, vp,  # threads, smem_bytes, stream
    ]
    lib.tiled_vol_cg_launch.restype = i32
    lib.tiled_batch_cg_launch.argtypes = [
        i32,  # lm
        vp, vp, vp, vp, vp, vp,  # F, b, pre, ctc, triples, starts
        i32, i32, i32, i32, i32, i32,  # C, T, n_triples, N0, N1, N2
        i32, i32, i32,  # n_sys, lanes (a system's team), per_block (systems a block)
        i32, f32, i32, i32, f32,  # lits, tol, guard_div, reset_period, q_tol
        vp, vp, vp,  # delta, iters, stream
    ]
    lib.tiled_batch_cg_launch.restype = i32
    lib.tile_apply_launch.argtypes = [
        i32, vp, vp, vp, vp, vp,  # ftype, F, p_ext, out, triples (host), starts (host)
        i32, i32, i32, i32, i32, i32,  # n_triples, C, th, tw, ah, aw
        vp,  # stream
    ]
    lib.tile_apply_launch.restype = i32
    _LOADED["lib"] = lib
    _LOADED["info"] = info
    return lib


if __name__ == "__main__":
    built = build_library()
    print(f"{'built' if built['built'] else 'cached'} {built['path']} in {built['seconds']:.1f} s "
          f"{built['units_s']}")
