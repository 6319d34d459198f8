"""Shared example-app plumbing: data discovery, the command line, the device.

PyTorch counterpart of ``examples/common.py``. Nothing here is global to
the process: ``--cpu`` makes the apps' plans run on the CPU, ``--double``
makes them float64 plans; without ``--cpu`` they plan on the card and
raise where CUDA is missing.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

# the directory of the reference's example data (cat512, dogdance, the
# meshes, ...), named by OPT_TPU_EXAMPLE_DATA: the port looks nowhere else.
# Every app falls back to synthetic data where it is unset or lacks a
# file, so the apps run anywhere.
REFERENCE_DATA = os.environ.get("OPT_TPU_EXAMPLE_DATA")


def data_path(name: str):
    if not REFERENCE_DATA:
        return None
    p = os.path.join(REFERENCE_DATA, name)
    return p if os.path.exists(p) else None


def example_argparser(description: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--cpu", action="store_true", help="run the plans on the CPU")
    ap.add_argument("--small", action="store_true", help="tiny config for smoke runs")
    ap.add_argument("--perf", action="store_true", help="reference perf-mode iteration counts")
    ap.add_argument(
        "--ceres",
        action="store_true",
        help="also run the independent scipy reference solver (the "
        "reference's USE_CERES comparison; small problems only)",
    )
    ap.add_argument("--results", default="results", help="CSV output directory")
    ap.add_argument(
        "--timing",
        action="store_true",
        help="collectPerKernelTimingInfo: print the per-phase table and "
        "greppable TIMING / Per-iter lines after each solve (util.t:469-508)",
    )
    ap.add_argument(
        "--double",
        action="store_true",
        help="solve in float64 (the reference's OPT_DOUBLE_PRECISION / "
        "doublePrecision init parameter): float64 plans",
    )
    ap.add_argument(
        "--converged",
        action="store_true",
        help="raise Opt iteration counts so final costs are at convergence "
        "(for oracle comparisons: the scipy reference runs to its own "
        "convergence, so agreement is only meaningful when Opt does too)",
    )
    return ap


def setup_backend(args) -> str:
    """The plans' device for these flags: "cpu" under ``--cpu``, else
    "cuda" (a plan on it raises where CUDA is missing)."""
    return "cpu" if args.cpu else "cuda"


def maybe_add_ceres(solver, args, max_nfev: int = 200) -> None:
    """Register the scipy comparison run when --ceres was passed, and apply
    the --cpu / --timing / --converged / --double flags."""
    if getattr(args, "ceres", False):
        solver.add_scipy_reference_solver(max_nfev=max_nfev)
    solver.device = setup_backend(args)
    solver.collect_timing = getattr(args, "timing", False)
    solver.converged_override = getattr(args, "converged", False)
    solver.double_precision = getattr(args, "double", False)


def host(x) -> np.ndarray:
    """An input or a solved unknown as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
