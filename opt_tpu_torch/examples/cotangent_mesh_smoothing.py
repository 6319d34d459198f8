"""Cotangent-Laplacian mesh smoothing (reference:
examples/cotangent_mesh_smoothing).

Smooths head.ply with cotan weights computed *from the unknowns* inside the
residual (4-vertex hyperedges: the two opposite vertices of each interior
edge supply the cotangents — Meyer et al. 03).
"""

import numpy as np

from opt_tpu_torch.examples.common import (
    data_path,
    example_argparser,
    host,
    maybe_add_ceres,
)
from opt_tpu_torch.harness import CombinedSolverBase
from opt_tpu_torch.models.specs import cotangent_mesh_smoothing
from opt_tpu_torch.utils.io import load_mesh, save_mesh


def cotan_hyperedges(verts, faces):
    """For each interior edge (v0,v1) with opposite vertices (v2,v3) across
    the two adjacent triangles, emit hyperedge (v0, v1, v2, v3) — the graph
    the reference app builds from the half-edge structure."""
    opp = {}
    for f in faces:
        for a, b, c in ((0, 1, 2), (1, 2, 0), (2, 0, 1)):
            e = (int(f[a]), int(f[b]))
            opp[e] = int(f[c])
    v0, v1, v2, v3 = [], [], [], []
    for (a, b), c in opp.items():
        d = opp.get((b, a))
        if d is not None:
            v0.append(a), v1.append(b), v2.append(c), v3.append(d)
    return (
        np.array(v0, np.int32), np.array(v1, np.int32),
        np.array(v2, np.int32), np.array(v3, np.int32),
    )


class CotangentSolver(CombinedSolverBase):
    def __init__(self, verts, edges, params):
        super().__init__(cotangent_mesh_smoothing, {"N": len(verts)}, params)
        self.verts = verts
        self.edges = edges

    def combined_solve_init(self):
        v0, v1, v2, v3 = self.edges
        self.problem_inputs = {
            "X": self.verts.copy(),
            "A": self.verts,
            "G": {"v0": v0, "v1": v1, "v2": v2, "v3": v3},
            "w_fit": np.sqrt(1.0),
            "w_reg": np.sqrt(8.0),
        }

    def pre_single_solve(self):
        self.problem_inputs["X"] = self.verts.copy()


def main(argv=None):
    ap = example_argparser(__doc__)
    args = ap.parse_args(argv)
    p = data_path("head.ply")
    if p:
        verts, faces = load_mesh(p)
    else:
        rng = np.random.RandomState(0)
        n = 12
        g = np.stack(np.meshgrid(np.arange(n), np.arange(n), indexing="ij"), -1)
        verts = np.concatenate(
            [g.reshape(-1, 2), rng.rand(n * n, 1)], -1
        ).astype(np.float32)
        faces = []
        for i in range(n - 1):
            for j in range(n - 1):
                a = i * n + j
                faces += [[a, a + 1, a + n], [a + 1, a + n + 1, a + n]]
        faces = np.array(faces, np.int32)
    edges = cotan_hyperedges(verts, faces)
    print(f"Vertices: {len(verts)}  Hyperedges: {len(edges[0])}")
    params = (
        {"numIter": 1, "nonLinearIter": 2, "linearIter": 10}
        if args.small
        # reference config: nonLinearIter=5, linearIter=25 (main.cpp:32-33)
        else {"numIter": 1, "nonLinearIter": 5, "linearIter": 25}
    )
    solver = CotangentSolver(verts, edges, params)
    # GN only, like the reference (main.cpp:30-31: useOptLM=false). In
    # converged-oracle mode add LM: the cotan weights depend on the unknowns,
    # and undamped always-accept GN diverges when run past the reference's
    # 5-iteration schedule — LM is the meaningful convergence comparison
    # (docs/REGRESSION.md).
    solver.add_opt_solvers(
        ["gaussNewtonGPU"] + (["LMGPU"] if args.converged else [])
    )
    maybe_add_ceres(solver, args)
    solver.solve_all()
    solver.report_final_costs()
    solver.save_results_csv(args.results)
    # smoothed mesh output, as the reference app writes (OpenMesh IO)
    save_mesh("cotangent_result.ply", host(solver.problem_inputs["X"]), faces)
    print("wrote cotangent_result.ply")
    return solver


if __name__ == "__main__":
    main()
