"""Intrinsic image decomposition with a robust L_p albedo prior
(reference: examples/intrinsic_image_decomposition).

Splits an image into albedo r and shading s with an IRLS-style L_p
regularizer whose weights are recomputed from the current albedo each
nonlinear iteration (the reference's const-view-of-unknown trick).
"""

import numpy as np

from opt_tpu_torch.examples.common import (
    data_path,
    example_argparser,
    host,
    maybe_add_ceres,
)
from opt_tpu_torch.harness import CombinedSolverBase
from opt_tpu_torch.models.specs import intrinsic_image_decomposition
from opt_tpu_torch.utils.io import load_image, save_image


class IntrinsicSolver(CombinedSolverBase):
    def __init__(self, img, params):
        h, w, _ = img.shape
        super().__init__(intrinsic_image_decomposition, {"W": h, "H": w}, params)
        self.img = img

    def _log_inputs(self):
        """The reference works in log2 space (CombinedSolver.h:70-100):
        i = log2(rgb + eps), initial albedo r = log2(chroma + eps) with
        chroma = rgb / intensity, initial shading s = log2(intensity + eps).
        The additive energy r + s − i then models rgb ≈ albedo · shading."""
        EPS = 0.01
        rgb = self.img
        intensity = rgb.mean(-1, keepdims=True)
        chroma = rgb / np.maximum(intensity, 1e-6)
        return (
            np.log2(chroma + EPS).astype(np.float32),
            np.log2(intensity[..., 0] + EPS).astype(np.float32),
            np.log2(rgb + EPS).astype(np.float32),
        )

    def combined_solve_init(self):
        r0, s0, i_log = self._log_inputs()
        self.problem_inputs = {
            "r": r0.copy(),
            "s": s0.copy(),
            "i": i_log,
            "w_fitSqrt": np.sqrt(500.0),
            "w_regSqrtAlbedo": np.sqrt(1000.0),
            "w_regSqrtShading": np.sqrt(10000.0),
            "pNorm": 0.8,
        }

    def pre_single_solve(self):
        r0, s0, _ = self._log_inputs()
        self.problem_inputs["r"] = r0.copy()
        self.problem_inputs["s"] = s0.copy()


def main(argv=None):
    ap = example_argparser(__doc__)
    args = ap.parse_args(argv)
    p = data_path("cat512.png")
    img = (
        load_image(p)[..., :3]
        if p
        else np.random.RandomState(0).rand(64, 64, 3).astype(np.float32)
    )
    if args.small:
        h, w = img.shape[:2]
        img = img[h // 2 - 32 : h // 2 + 32, w // 2 - 32 : w // 2 + 32]
    params = (
        {"numIter": 1, "nonLinearIter": 3, "linearIter": 10}
        if args.small
        else {"numIter": 1, "nonLinearIter": 7, "linearIter": 10}
    )
    solver = IntrinsicSolver(img.astype(np.float32), params)
    # GN only, like the reference. Converged-oracle mode adds LM for the
    # cross-solver comparison on this robust-norm (IRLS) energy
    # (docs/REGRESSION.md).
    solver.add_opt_solvers(
        ["gaussNewtonGPU"] + (["LMGPU"] if args.converged else [])
    )
    maybe_add_ceres(solver, args)
    solver.solve_all()
    solver.report_final_costs()
    solver.save_results_csv(args.results)
    # reference output step (main.cpp:27-50): albedo = exp2(r)/1.5 and
    # shading = exp2(s), clamped to [0,1] PNGs
    r = host(solver.problem_inputs["r"])
    s = host(solver.problem_inputs["s"])
    if s.ndim == 3:
        s = s[..., 0]
    save_image("outputAlbedo.png", np.clip(np.exp2(r) / 1.5, 0, 1))
    save_image("outputShading.png", np.clip(np.exp2(s), 0, 1))
    print("Saved outputAlbedo.png / outputShading.png")
    return solver


if __name__ == "__main__":
    main()
