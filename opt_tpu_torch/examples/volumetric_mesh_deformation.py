"""Volumetric (3D grid) ARAP deformation
(reference: examples/volumetric_mesh_deformation).

Deforms a W x H x D lattice with 6-neighbor ARAP stencils; corner handles are
pulled to targets. Exercises 3-D index spaces and 3-D stencil launches.
"""

import numpy as np

from opt_tpu_torch.examples.common import example_argparser, host, maybe_add_ceres
from opt_tpu_torch.harness import CombinedSolverBase
from opt_tpu_torch.models.specs import volumetric_mesh_deformation
from opt_tpu_torch.utils.io import save_mesh


class VolumetricSolver(CombinedSolverBase):
    def __init__(self, dims_whd, params):
        W, H, D = dims_whd
        super().__init__(volumetric_mesh_deformation, {"W": W, "H": H, "D": D}, params)
        self.grid = np.stack(
            np.meshgrid(np.arange(W), np.arange(H), np.arange(D), indexing="ij"), -1
        ).astype(np.float32)

    def constraints(self, alpha):
        con = np.full_like(self.grid, -1e6)  # finite sentinel: see spec.py note on eager Select
        # pull the top face up and twist slightly, like the reference app's
        # handle setup
        tgt = self.grid[:, :, -1] + np.array([0.0, 0.0, 2.0 * alpha], np.float32)
        con[:, :, -1] = tgt
        con[:, :, 0] = self.grid[:, :, 0]  # clamp bottom face
        return con

    def combined_solve_init(self):
        self.problem_inputs = {
            "Offset": self.grid.copy(),
            "Angle": np.zeros_like(self.grid),
            "UrShape": self.grid,
            "Constraints": self.constraints(1.0),
            "w_fitSqrt": np.sqrt(4.0),
            "w_regSqrt": np.sqrt(1.0),
        }

    def pre_nonlinear_solve(self, i):
        alpha = (i + 1) / self.solver_params["numIter"]
        self.problem_inputs["Constraints"] = self.constraints(alpha)


def main(argv=None):
    ap = example_argparser(__doc__)
    args = ap.parse_args(argv)
    dims = (8, 8, 8) if args.small else (32, 32, 32)
    params = (
        {"numIter": 2, "nonLinearIter": 3, "linearIter": 10}
        if args.small
        # reference config (main.cpp:23-24), numIter defaults to 1
        else {"numIter": 1, "nonLinearIter": 20, "linearIter": 60}
    )
    solver = VolumetricSolver(dims, params)
    # GN only, like the reference (no useOptLM in volumetric main.cpp)
    solver.add_opt_solvers(["gaussNewtonGPU"])
    maybe_add_ceres(solver, args)
    solver.solve_all()
    solver.report_final_costs()
    solver.save_results_csv(args.results)
    # reference output step (main.cpp:32 out.ply): the reference trilinearly
    # interpolates an embedded surface mesh through the solved lattice; this
    # app is synthetic-lattice (no embedded mesh), so the deformed lattice
    # nodes are written as a point cloud
    save_mesh("out.ply", host(solver.problem_inputs["Offset"]).reshape(-1, 3))
    print("Saved out.ply")
    return solver


if __name__ == "__main__":
    main()
