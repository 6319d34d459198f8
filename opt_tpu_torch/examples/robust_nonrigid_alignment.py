"""Robust non-rigid alignment with lifted per-vertex confidence weights
(reference: examples/robust_nonrigid_alignment).

ARAP deformation toward point-to-plane constraints, with RobustWeights
unknowns implementing a lifted robust kernel (w·r fitting + (1−w²) penalty).
"""

import numpy as np

from opt_tpu_torch.examples.common import (
    data_path,
    example_argparser,
    host,
    maybe_add_ceres,
)
from opt_tpu_torch.harness import CombinedSolverBase
from opt_tpu_torch.models.specs import robust_nonrigid_alignment
from opt_tpu_torch.utils.io import load_mesh, mesh_edges, save_mesh


class RobustSolver(CombinedSolverBase):
    def __init__(self, verts, edges, targets, normals, params):
        super().__init__(robust_nonrigid_alignment, {"N": len(verts)}, params)
        self.verts, self.edges = verts, edges
        self.targets, self.normals = targets, normals

    def combined_solve_init(self):
        N = len(self.verts)
        self.problem_inputs = {
            "Offset": self.verts.copy(),
            "Angle": np.zeros((N, 3), np.float32),
            "RobustWeights": np.ones((N,), np.float32),
            "UrShape": self.verts,
            "Constraints": self.targets,
            "ConstraintNormals": self.normals,
            "G": {"v0": self.edges[0], "v1": self.edges[1]},
            "w_fitSqrt": np.sqrt(10.0),
            "w_regSqrt": np.sqrt(4.0),
        }

    def pre_single_solve(self):
        self.problem_inputs["Offset"] = self.verts.copy()
        self.problem_inputs["RobustWeights"] = np.ones((len(self.verts),), np.float32)


def main(argv=None):
    ap = example_argparser(__doc__)
    args = ap.parse_args(argv)
    p = data_path("squat_source.obj")
    if p:
        verts, faces = load_mesh(p)
    else:
        n = 10
        g = np.stack(np.meshgrid(np.arange(n), np.arange(n), indexing="ij"), -1)
        verts = np.concatenate(
            [g.reshape(-1, 2), np.zeros((n * n, 1))], -1
        ).astype(np.float32)
        faces = []
        for i in range(n - 1):
            for j in range(n - 1):
                a = i * n + j
                faces += [[a, a + 1, a + n], [a + 1, a + n + 1, a + n]]
        faces = np.array(faces, np.int32)
    rng = np.random.RandomState(1)
    # synthetic scan targets: displaced source + a band of outliers that the
    # robust weights must down-weight
    targets = verts + np.array([0.05, 0.0, 0.02], np.float32)
    outliers = rng.rand(len(verts)) < 0.1
    targets[outliers] += rng.randn(outliers.sum(), 3).astype(np.float32) * 0.5
    invalid = rng.rand(len(verts)) < 0.3
    targets[invalid] = -1e6  # finite sentinel: see spec.py note on eager Select
    normals = np.tile(np.array([0, 0, 1], np.float32), (len(verts), 1))
    v0, v1 = mesh_edges(faces)
    print(f"Vertices: {len(verts)}  Edges: {len(v0)}")
    params = (
        {"numIter": 1, "nonLinearIter": 3, "linearIter": 10}
        if args.small
        # reference config (main.cpp:58-61)
        else {"numIter": 15, "nonLinearIter": 10, "linearIter": 250}
    )
    solver = RobustSolver(
        verts, (v0, v1), targets.astype(np.float32), normals, params
    )
    # LM only, like the reference (main.cpp:62-63: useOpt=false, useOptLM=true)
    solver.add_opt_solvers(["LMGPU"])
    maybe_add_ceres(solver, args)
    solver.solve_all()
    solver.report_final_costs()
    solver.save_results_csv(args.results)
    # reference output step (main.cpp:69): the aligned template mesh
    save_mesh("out.ply", host(solver.problem_inputs["Offset"]), faces)
    print("Saved out.ply")
    return solver


if __name__ == "__main__":
    main()
