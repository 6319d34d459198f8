"""Dense optical flow with a Gaussian-pyramid schedule
(reference: examples/optical_flow).

Flow between dogdance0/dogdance1 solved coarse-to-fine: the host loop swaps
pyramid levels and upsamples the flow between solves
(optical_flow/src/CombinedSolver.h:22-61); numIter=3 pyramid levels,
nonLinearIter=1, linearIter=50 (main.cpp:42-44).
"""

import time

import numpy as np
import torch

import opt_tpu_torch as ot
from opt_tpu_torch.examples.common import (
    data_path,
    example_argparser,
    host,
    maybe_add_ceres,
)
from opt_tpu_torch.harness import CombinedSolverBase, SolverIteration, SolverRun
from opt_tpu_torch.models.specs import optical_flow
from opt_tpu_torch.utils.io import load_image, save_image


def gaussian_blur(img, sigma=1.0):
    from scipy.ndimage import gaussian_filter

    return gaussian_filter(img, sigma=sigma)


def build_pyramid(img, levels):
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(gaussian_blur(pyr[-1])[::2, ::2])
    return pyr[::-1]  # coarse to fine


def derivative_images(img):
    """Central-difference derivative images, as the reference app computes
    on the host for SampledImage (optical_flow/src/CombinedSolver.h)."""
    dx = np.zeros_like(img)
    dy = np.zeros_like(img)
    dx[1:-1, :] = 0.5 * (img[2:, :] - img[:-2, :])
    dy[:, 1:-1] = 0.5 * (img[:, 2:] - img[:, :-2])
    return dx, dy


class FlowSolver(CombinedSolverBase):
    """The pyramid schedule through ot.PyramidPlan: every level solves on
    the plans' device, the flow prolonged there between levels, the scalar
    results brought back once at the end (the reference drives the levels
    from the host, CombinedSolver.h:22-61)."""

    def __init__(self, im0, im1, params):
        self.levels = int(params.get("numIter", 3))
        self.pyr0 = build_pyramid(im0, self.levels)
        self.pyr1 = build_pyramid(im1, self.levels)
        h, w = self.pyr0[-1].shape
        super().__init__(optical_flow, {"W": h, "H": w}, params)

    def _level_inputs(self, lvl):
        im0, im1 = self.pyr0[lvl], self.pyr1[lvl]
        dx, dy = derivative_images(im1)
        h, w = im0.shape
        return {
            "X": np.zeros((h, w, 2), np.float32),
            "I": im0,
            "I_hat": im1,
            "I_hat_dx": dx,
            "I_hat_dy": dy,
            "w_fit": 10.0,
            "w_reg": 0.1,
        }

    def combined_solve_init(self):
        self.problem_inputs = self._level_inputs(self.levels - 1)

    def _single_solve(self, kind):
        run = SolverRun(name=f"Opt({'GN' if 'gauss' in kind.lower() else 'LM'})")
        level_dims = [
            {"W": p.shape[0], "H": p.shape[1]} for p in self.pyr0
        ]

        def prolong(unknowns, lvl, next_dims):
            return {
                "X": ot.upsample2x_nearest(
                    unknowns["X"], (next_dims["W"], next_dims["H"]), scale=2.0
                )
            }

        pplan = ot.PyramidPlan(
            ot.Problem(self.spec_fn),
            level_dims,
            prolong,
            kind=kind,
            device=self.device,
            double_precision=getattr(self, "double_precision", False),
            nIterations=int(self.solver_params["nonLinearIter"]),
            lIterations=int(self.solver_params["linearIter"]),
        )
        level_inputs = [self._level_inputs(l) for l in range(self.levels)]
        res = pplan.solve(level_inputs)
        self._synchronize()
        # time a second solve: the first builds the plans' tables
        t0 = time.perf_counter()
        res = pplan.solve(level_inputs)
        self._synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        self.problem_inputs["X"] = res.unknowns["X"]
        run.iterations.append(SolverIteration(res.final_cost, ms))
        return run

    def _synchronize(self):
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)


def main(argv=None):
    ap = example_argparser(__doc__)
    args = ap.parse_args(argv)
    p0, p1 = data_path("dogdance0.png"), data_path("dogdance1.png")
    if p0 and p1:
        im0 = load_image(p0).mean(-1).astype(np.float32)
        im1 = load_image(p1).mean(-1).astype(np.float32)
    else:
        rng = np.random.RandomState(0)
        im0 = rng.rand(64, 64).astype(np.float32)
        im1 = np.roll(im0, (1, 2), (0, 1))
    if args.small:
        im0, im1 = im0[:64, :64], im1[:64, :64]
    params = {"numIter": 3, "nonLinearIter": 1, "linearIter": 50}
    solver = FlowSolver(im0, im1, params)
    solver.add_opt_solvers(["gaussNewtonGPU"])
    maybe_add_ceres(solver, args)
    solver.solve_all()
    solver.report_final_costs()
    solver.save_results_csv(args.results)
    # reference output step (main.cpp:50-53 renderFlowVecotors): flow
    # vectors drawn every 5th pixel on the source image, colored by
    # magnitude (depth-colormap over [0, 5])
    flow = host(solver.problem_inputs["X"])
    out = np.repeat(im0[..., None], 3, axis=-1).copy()
    h, w = im0.shape
    skip = 5
    for i in range(1, h - 1, skip):
        for j in range(1, w - 1, skip):
            di, dj = flow[i, j]
            n = max(2, int(2 * max(abs(di), abs(dj))) + 1)
            t = np.linspace(0.0, 1.0, n)
            pi = np.clip(np.rint(i + t * di).astype(int), 0, h - 1)
            pj = np.clip(np.rint(j + t * dj).astype(int), 0, w - 1)
            m = min(1.0, float(np.hypot(di, dj)) / 5.0)
            out[pi, pj] = [2.0 * m, 0.4 * (1.0 - m), 0.2]  # magnitude ramp
    save_image("out.png", np.clip(out, 0, 1))
    print("Saved out.png")
    return solver


if __name__ == "__main__":
    main()
