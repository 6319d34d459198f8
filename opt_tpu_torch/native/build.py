"""Build the port's C library and its C client at first use.

``build_native()`` compiles ``opttpu_torch.cpp`` (the C API of
``native/include/OptTpu.h`` over an embedded CPython that imports
``opt_tpu_torch.native_bridge``) into ``libopttpu_torch.so`` and
``client.c`` into ``client``, with ``g++`` and ``gcc``, into
``build/opt_tpu_torch/native/`` at the repository root. Each output is built
again when a source it reads is newer, or when the compilers or the flags
differ from those it was built with (``build.json`` beside it: a copy of
the tree on another machine builds anew). The include and link flags are the
running interpreter's (``sysconfig``), not those of whichever
``python3-config`` comes first on ``PATH``: the embedded interpreter must be
the one that has torch.

``client_env()`` gives the environment a client runs in: the embedded
interpreter's ``sys.executable`` is the client binary, so it finds neither
this repository nor the running interpreter's site-packages by itself.
``run_client()`` runs the built client and reads back what it printed and
wrote.

The CUDA kernels are not built here: a client that plans on the card loads
the library that ``python -m opt_tpu_torch.ops._build`` (or any solve on
the card) has built.

    python -m opt_tpu_torch.native.build
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import sysconfig
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[1]
INCLUDE = REPO / "native" / "include"
BUILD_DIR = REPO / "build" / "opt_tpu_torch" / "native"
LIBRARY = "libopttpu_torch.so"
CLIENT = "client"


def python_flags() -> tuple:
    """(compile flags, link flags) that embed the running interpreter."""
    cv = sysconfig.get_config_var
    libdir = cv("LIBDIR")
    cflags = [f"-I{cv('INCLUDEPY')}"]
    ldflags = [f"-L{libdir}", f"-lpython{cv('VERSION')}{cv('ABIFLAGS') or ''}",
               *(cv("LIBS") or "").split(), *(cv("SYSLIBS") or "").split(),
               f"-Wl,-rpath,{libdir}"]
    return cflags, ldflags


def libpython() -> Path:
    """The running interpreter's shared libpython (it may be missing)."""
    return Path(sysconfig.get_config_var("LIBDIR")) / sysconfig.get_config_var("LDLIBRARY")


def _stale(out: Path, sources, same_flags: bool) -> bool:
    return (not same_flags or not out.exists()
            or any(s.stat().st_mtime > out.stat().st_mtime for s in sources))


def _compile(cmd, out: Path) -> None:
    """Run one compiler command that writes ``out`` through a temporary
    file, so that a concurrent reader never sees half an output."""
    tmp = out.with_name(f".{out.name}.{os.getpid()}")
    proc = subprocess.run([*cmd, "-o", str(tmp)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cmd[0]} failed ({proc.returncode}) building {out.name}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


def build_native() -> dict:
    """Build what is stale of the library and the client. Returns {library,
    client (paths), built (names built now), seconds}. A failed build
    raises with the compiler's output."""
    cxx, cc = "g++", "gcc"
    for tool in (cxx, cc):
        if shutil.which(tool) is None:
            raise RuntimeError(f"{tool} not found: the C library builds with g++ and gcc")
    cflags, ldflags = python_flags()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib, client = BUILD_DIR / LIBRARY, BUILD_DIR / CLIENT
    header = INCLUDE / "OptTpu.h"
    stamp = BUILD_DIR / "build.json"
    flags = json.dumps({"cxx": cxx, "cc": cc, "cflags": cflags, "ldflags": ldflags})
    same = stamp.exists() and stamp.read_text() == flags
    built = []
    t0 = time.perf_counter()
    if _stale(lib, (HERE / "opttpu_torch.cpp", header), same):
        _compile([cxx, "-O2", "-fPIC", "-Wall", "-shared", f"-I{INCLUDE}", *cflags,
                  str(HERE / "opttpu_torch.cpp"), *ldflags], lib)
        built.append(lib.name)
    if _stale(client, (HERE / "client.c", header, lib), same):
        _compile([cc, "-O2", f"-I{INCLUDE}", str(HERE / "client.c"), f"-L{BUILD_DIR}",
                  "-lopttpu_torch", "-Wl,-rpath,$ORIGIN", *ldflags], client)
        built.append(client.name)
    if not same:
        stamp.write_text(flags)
    return {"library": lib, "client": client, "built": built,
            "seconds": time.perf_counter() - t0}


def client_env(env=None) -> dict:
    """``env`` (default: this process's) with ``PYTHONPATH`` set to the
    repository and then the running interpreter's ``sys.path``, so that the
    client's embedded interpreter imports opt_tpu_torch and torch from
    where this one does."""
    env = dict(os.environ if env is None else env)
    paths = [str(REPO)] + [p for p in sys.path if p and os.path.exists(p)]
    env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(paths))
    return env


def run_client(W: int, H: int, n_iter: int, l_iter: int, out_path, device=None,
               timeout: float = 600.0) -> dict:
    """Run the built client from the repository root at W x H, GN
    ``n_iter`` x ``l_iter``, writing to ``out_path``, with
    ``OPT_TPU_TORCH_DEVICE`` = ``device`` (None: unset, so the card).
    Returns {rc, stdout, stderr, wall_s, init_cost, final_cost (as
    printed, None where not), solve (the bridge's ``c_api_solve`` line or
    None), A, X ([W, H] float32 read from ``out_path``, or None)}."""
    from ..native_bridge import DEVICE_ENV

    env = client_env()
    env.pop(DEVICE_ENV, None)
    if device is not None:
        env[DEVICE_ENV] = device
    out_path = Path(out_path)
    out_path.unlink(missing_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run([str(BUILD_DIR / CLIENT), str(W), str(H), str(n_iter), str(l_iter),
                           str(out_path)], cwd=str(REPO), env=env, capture_output=True,
                          text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    costs = re.search(r"^init=(\S+) final=(\S+)$", proc.stdout, re.M)
    solve = [json.loads(line)["c_api_solve"] for line in proc.stdout.splitlines()
             if line.startswith('{"c_api_solve"')]
    A = X = None
    if out_path.exists():
        data = np.fromfile(out_path, dtype=np.float32)
        if data.size == 2 * W * H:
            A, X = data[: W * H].reshape(W, H), data[W * H :].reshape(W, H)
    return {"rc": proc.returncode, "stdout": proc.stdout, "stderr": proc.stderr, "wall_s": wall,
            "init_cost": float(costs.group(1)) if costs else None,
            "final_cost": float(costs.group(2)) if costs else None,
            "solve": solve[-1] if solve else None, "A": A, "X": X}


if __name__ == "__main__":
    info = build_native()
    print(f"built {info['built'] or 'nothing (up to date)'} in {info['seconds']:.1f} s: "
          f"{info['library']}, {info['client']}")
