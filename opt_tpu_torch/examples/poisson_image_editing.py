"""Poisson image editing (reference: examples/poisson_image_editing).

Seamlessly clones poisson1 into poisson0's masked region by solving the
membrane equation as a linear least-squares problem (single GN iteration,
100 PCG iterations — main.cpp:69-70).
"""

import numpy as np

from opt_tpu_torch.examples.common import (
    data_path,
    example_argparser,
    host,
    maybe_add_ceres,
)
from opt_tpu_torch.harness import CombinedSolverBase
from opt_tpu_torch.models.specs import poisson_image_editing
from opt_tpu_torch.utils.io import load_image, save_image


def load_inputs(small: bool):
    p0, p1, pm = (data_path(n) for n in ("poisson0.png", "poisson1.png", "poisson_mask.png"))
    if p0 and p1 and pm:
        im0 = load_image(p0)[..., :3]
        im1 = load_image(p1)[..., :3]
        mask = load_image(pm)[..., 0]
        h = min(im0.shape[0], im1.shape[0], mask.shape[0])
        w = min(im0.shape[1], im1.shape[1], mask.shape[1])
        im0, im1, mask = im0[:h, :w], im1[:h, :w], mask[:h, :w]
    else:
        rng = np.random.RandomState(0)
        h = w = 64
        im0 = rng.rand(h, w, 3).astype(np.float32)
        im1 = rng.rand(h, w, 3).astype(np.float32)
        mask = np.ones((h, w), np.float32)
        mask[h // 4 : -h // 4, w // 4 : -w // 4] = 0.0
    if small:
        im0, im1, mask = im0[:64, :64], im1[:64, :64], mask[:64, :64]
    pad = np.zeros(im0.shape[:2] + (1,), np.float32)
    to4 = lambda im: np.concatenate([im, pad], axis=-1)  # reference uses float4
    # reference mask semantics: 0 = editable, nonzero = fixed
    return {
        "X": to4(im0) * 255.0,
        "T": to4(im1) * 255.0,
        "M": (mask > 0.5).astype(np.float32),
    }


class PoissonSolver(CombinedSolverBase):
    def __init__(self, inputs, params):
        h, w = inputs["M"].shape
        super().__init__(poisson_image_editing, {"W": h, "H": w}, params)
        self._inputs = inputs

    def combined_solve_init(self):
        self.problem_inputs = dict(self._inputs)

    def pre_single_solve(self):
        self.problem_inputs = dict(self._inputs)  # resetGPU() analogue


def main(argv=None):
    ap = example_argparser(__doc__)
    args = ap.parse_args(argv)
    inputs = load_inputs(args.small)
    params = {"numIter": 1, "nonLinearIter": 1, "linearIter": 100}
    solver = PoissonSolver(inputs, params)
    # GN only, like the reference (main.cpp:70-72 sets useOpt only;
    # useOptLM defaults false). This config is a single linear solve —
    # one LM iteration would solve the trust-region-DAMPED system
    # (radius=1e4) and land far above GN; see docs/REGRESSION.md.
    solver.add_opt_solvers(["gaussNewtonGPU"])
    maybe_add_ceres(solver, args)
    solver.solve_all()
    solver.report_final_costs()
    solver.save_results_csv(args.results)
    out = host(solver.problem_inputs["X"])[..., :3] / 255.0
    save_image("poisson_result.png", out)
    print("wrote poisson_result.png")
    return solver


if __name__ == "__main__":
    main()
