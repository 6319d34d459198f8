"""Image warping — 2D ARAP (reference: examples/image_warping).

Warps cat512.png so user-picked handles reach their targets while the rest
of the image deforms as-rigidly-as-possible. Reproduces the reference app's
constraint annealing: constraints interpolate from rest to target over the
outer iterations (CombinedSolver.h:150-152, setConstraintImage), with
numIter=19, nonLinearIter=8, linearIter=400 (main.cpp:110-134).
"""

import numpy as np
import torch

from opt_tpu_torch.examples.common import (
    data_path,
    example_argparser,
    host,
    maybe_add_ceres,
)
from opt_tpu_torch.harness import CombinedSolverBase
from opt_tpu_torch.models.specs import image_warping
from opt_tpu_torch.utils.io import load_constraints, load_image, save_image


def load_inputs(small: bool):
    pimg, pmask, pcon = (
        data_path(n) for n in ("cat512.png", "cat512_mask.png", "cat512.constraints")
    )
    if pimg and pmask and pcon:
        img = load_image(pimg)
        mask_img = load_image(pmask)[..., 0]
        cons = load_constraints(pcon)
        h, w = mask_img.shape
        # reference mask: 0 where the cat is (solved), 255 elsewhere (excluded)
        mask = (mask_img > 0.5).astype(np.float32)
    else:
        h = w = 64
        mask = np.zeros((h, w), np.float32)
        cons = np.array([[5, 5, 15, 15], [50, 50, 40, 45]], np.float32)
        img = np.broadcast_to(
            (np.arange(h * w, dtype=np.float32).reshape(h, w) / (h * w))[
                ..., None
            ],
            (h, w, 3),
        ).copy()
    if small:
        scale = h // 64
        mask = mask[::scale, ::scale]
        img = img[::scale, ::scale]
        h, w = mask.shape
        cons = cons / scale
    ur = np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing="ij"), -1).astype(
        np.float32
    )
    return mask, cons, ur, img


def render_warp(offset, mask, color, subsamples: int = 4) -> np.ndarray:
    """Rasterize the deformed grid: each valid quad (all 4 corners solved,
    mask==0) forward-splats bilinearly-interpolated positions and colors
    onto a white canvas — the reference app's triangle rasterization of
    the warped mesh (CombinedSolver.h copyResultToCPU / rasterizeTriangle),
    vectorized as a sub-sampled splat instead of a scanline fill."""
    offset = host(offset).astype(np.float32)
    h, w = mask.shape
    img = np.asarray(color, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    img = img[..., :3] if img.shape[-1] >= 3 else np.repeat(img[..., :1], 3, -1)
    out = np.ones((h, w, 3), np.float32)

    q = (
        (mask[:-1, :-1] == 0) & (mask[1:, :-1] == 0)
        & (mask[:-1, 1:] == 0) & (mask[1:, 1:] == 0)
    )
    p00, p10 = offset[:-1, :-1], offset[1:, :-1]
    p01, p11 = offset[:-1, 1:], offset[1:, 1:]
    c00, c10 = img[:-1, :-1], img[1:, :-1]
    c01, c11 = img[:-1, 1:], img[1:, 1:]
    k = max(1, subsamples)
    for a in np.linspace(0.0, 1.0, k + 1):
        for b in np.linspace(0.0, 1.0, k + 1):
            pos = (
                (1 - a) * (1 - b) * p00 + a * (1 - b) * p10
                + (1 - a) * b * p01 + a * b * p11
            )
            col = (
                (1 - a) * (1 - b) * c00 + a * (1 - b) * c10
                + (1 - a) * b * c01 + a * b * c11
            )
            pi = np.clip(np.rint(pos[..., 0]).astype(np.int64), 0, h - 1)
            pj = np.clip(np.rint(pos[..., 1]).astype(np.int64), 0, w - 1)
            out[pi[q], pj[q]] = col[q]
    return out


class WarpSolver(CombinedSolverBase):
    def __init__(self, mask, cons, ur, params):
        h, w = mask.shape
        super().__init__(image_warping, {"W": h, "H": w}, params)
        self.mask, self.cons, self.ur = mask, cons, ur

    def constraint_image(self, alpha: float) -> np.ndarray:
        """CombinedSolver.h:181-205 setConstraintImage."""
        h, w = self.mask.shape
        con = -np.ones((h, w, 2), np.float32)
        for x, y, tx, ty in self.cons:
            xi, yi = int(x), int(y)
            if 0 <= xi < h and 0 <= yi < w and self.mask[xi, yi] == 0:
                con[xi, yi] = [
                    (1 - alpha) * x + alpha * tx,
                    (1 - alpha) * y + alpha * ty,
                ]
        return con

    def combined_solve_init(self):
        self.problem_inputs = {
            "Offset": self.ur.copy(),
            "Angle": np.zeros(self.mask.shape, np.float32),
            "UrShape": self.ur,
            "Constraints": self.constraint_image(1.0),
            "Mask": self.mask,
            "w_fitSqrt": np.sqrt(100.0),
            "w_regSqrt": np.sqrt(0.01),
        }

    def pre_single_solve(self):
        self.problem_inputs["Offset"] = self.ur.copy()
        self.problem_inputs["Angle"] = np.zeros(self.mask.shape, np.float32)

    def pre_nonlinear_solve(self, i):
        alpha = (i + 1) / self.solver_params["numIter"]
        self.problem_inputs["Constraints"] = self.constraint_image(alpha)

    def make_device_schedule(self, num_iter):
        """Constraint annealing on the plan's device, the whole numIter
        schedule through Plan.solve_scheduled: interpolating the rest and
        target constraint images reproduces setConstraintImage(alpha) —
        invalid entries are -1 in both endpoints, so they stay -1."""
        dev, dt = self.plan.device, self.plan.compiled.dtype
        C0 = torch.as_tensor(self.constraint_image(0.0), device=dev).to(dt)
        C1 = torch.as_tensor(self.constraint_image(1.0), device=dev).to(dt)

        def schedule(consts, i):
            a = (i.to(torch.float32) + 1.0) / num_iter
            out = dict(consts)
            out["Constraints"] = (1.0 - a) * C0 + a * C1
            return out

        return schedule


def main(argv=None):
    ap = example_argparser(__doc__)
    args = ap.parse_args(argv)
    mask, cons, ur, img = load_inputs(args.small)
    if args.small:
        params = {"numIter": 4, "nonLinearIter": 3, "linearIter": 30}
    else:
        params = {"numIter": 19, "nonLinearIter": 8, "linearIter": 400}
    solver = WarpSolver(mask, cons, ur, params)
    # reference default runs GN only; perf mode adds LM (+Ceres)
    # (main.cpp:110-121)
    kinds = ["gaussNewtonGPU"] + (
        ["LMGPU"] if (args.perf or args.converged) else []
    )
    solver.add_opt_solvers(kinds)
    maybe_add_ceres(solver, args)
    solver.solve_all()
    solver.report_final_costs()
    solver.save_results_csv(args.results)
    # reference app output step (main.cpp:140-171): the warped image plus
    # the input with constraint sources marked red
    out = render_warp(solver.problem_inputs["Offset"], mask, img)
    save_image("output.png", out)
    marked = np.array(img if img.ndim == 3 else np.repeat(img[..., None], 3, -1))
    marked = marked[..., :3]
    for x, y, _tx, _ty in cons:
        xi, yi = int(x), int(y)
        if 0 <= xi < mask.shape[0] and 0 <= yi < mask.shape[1] and mask[xi, yi] == 0:
            marked[xi, yi] = [1.0, 0.0, 0.0]
    save_image("inputMark.png", marked)
    print("Saved output.png / inputMark.png")
    return solver


if __name__ == "__main__":
    main()
