"""Embedded mesh deformation with rotation-matrix unknowns
(reference: examples/embedded_mesh_deformation).

Per-vertex 3x3 rotation matrices (float9 unknowns) with 6 orthonormality
residuals each, plus ARAP-style graph regularization over raptor_simplify2k.
"""

import numpy as np

from opt_tpu_torch.examples.common import (
    data_path,
    example_argparser,
    host,
    maybe_add_ceres,
)
from opt_tpu_torch.harness import CombinedSolverBase
from opt_tpu_torch.models.specs import embedded_mesh_deformation
from opt_tpu_torch.utils.io import load_mesh, load_mrk, mesh_edges, save_mesh


class EmbeddedSolver(CombinedSolverBase):
    def __init__(self, verts, edges, cons_idx, cons_tgt, params):
        super().__init__(embedded_mesh_deformation, {"N": len(verts)}, params)
        self.verts, self.edges = verts, edges
        self.cons_idx, self.cons_tgt = cons_idx, cons_tgt

    def constraints(self, alpha):
        con = np.full_like(self.verts, -1e6)  # finite sentinel: see spec.py note on eager Select
        src = self.verts[self.cons_idx]
        con[self.cons_idx] = (1 - alpha) * src + alpha * self.cons_tgt
        return con

    def combined_solve_init(self):
        N = len(self.verts)
        self.problem_inputs = {
            "Offset": self.verts.copy(),
            "RotMatrix": np.tile(np.eye(3, dtype=np.float32).ravel(), (N, 1)),
            "UrShape": self.verts,
            "Constraints": self.constraints(1.0),
            "G": {"v0": self.edges[0], "v1": self.edges[1]},
            "w_fitSqrt": np.sqrt(10.0),
            "w_regSqrt": np.sqrt(1.0),
            "w_rotSqrt": np.sqrt(0.1),
        }

    def pre_nonlinear_solve(self, i):
        alpha = (i + 1) / self.solver_params["numIter"]
        self.problem_inputs["Constraints"] = self.constraints(alpha)


def main(argv=None):
    ap = example_argparser(__doc__)
    args = ap.parse_args(argv)
    p = data_path("raptor_simplify2k.off")
    pk = data_path("raptor_simplify2k.mrk")
    if p:
        verts, faces = load_mesh(p)
        if pk:
            mrk = load_mrk(pk)
            ci = mrk[:, 3].astype(np.int32)
            ct = mrk[:, 0:3].astype(np.float32)
        else:
            ci = np.array([0], np.int32)
            ct = verts[ci] + 0.2
    else:
        rng = np.random.RandomState(0)
        verts = rng.rand(50, 3).astype(np.float32)
        faces = np.array([[i, i + 1, i + 2] for i in range(48)], np.int32)
        ci = np.array([0, 49], np.int32)
        ct = verts[ci] + 0.3
    v0, v1 = mesh_edges(faces)
    print(f"Vertices: {len(verts)}  Edges: {len(v0)}  Markers: {len(ci)}")
    params = (
        {"numIter": 2, "nonLinearIter": 3, "linearIter": 10}
        if args.small
        # reference config (main.cpp:49-53: "LM is good here")
        else {"numIter": 31, "nonLinearIter": 5, "linearIter": 125}
    )
    solver = EmbeddedSolver(verts, (v0, v1), ci, ct, params)
    # LM only, like the reference (main.cpp:49-50: useOpt=false, useOptLM=true)
    solver.add_opt_solvers(["LMGPU"])
    maybe_add_ceres(solver, args)
    solver.solve_all()
    solver.report_final_costs()
    solver.save_results_csv(args.results)
    # deformed mesh output, as the reference app writes (OpenMesh IO)
    save_mesh("embedded_result.ply", host(solver.problem_inputs["Offset"]), faces)
    print("wrote embedded_result.ply")
    return solver


if __name__ == "__main__":
    main()
