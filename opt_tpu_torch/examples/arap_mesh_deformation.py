"""ARAP mesh deformation over a hypergraph
(reference: examples/arap_mesh_deformation).

Deforms small_armadillo.ply so marker vertices (.mrk) reach annealed target
positions while one-ring edges stay as-rigid-as-possible. Config from
main.cpp:77-104 (numIter=10, nonLinearIter=20, linearIter=100, weightFit=4,
weightReg=1) with setConstraints annealing (CombinedSolver.h:59-61,77-100).
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
from opt_tpu_torch.models.specs import arap_mesh_deformation
from opt_tpu_torch.utils.io import load_mesh, load_mrk, mesh_edges, save_mesh, sqrt3_subdivide


def load_data(small: bool):
    pm = data_path("small_armadillo.ply")
    pk = data_path("small_armadillo.mrk")
    if pm and pk:
        verts, faces = load_mesh(pm)
        # reference subdivides once before solving; markers index the
        # subdivided mesh (main.cpp:58-72)
        verts, faces = sqrt3_subdivide(verts, faces)
        mrk = load_mrk(pk)
        cons_idx = mrk[:, 3].astype(np.int32)
        cons_tgt = mrk[:, 0:3]
    else:
        n = 16
        g = np.stack(np.meshgrid(np.arange(n), np.arange(n), indexing="ij"), -1)
        verts = np.concatenate([g.reshape(-1, 2), np.zeros((n * n, 1))], -1).astype(
            np.float32
        )
        faces = []
        for i in range(n - 1):
            for j in range(n - 1):
                a = i * n + j
                faces.append([a, a + 1, a + n])
                faces.append([a + 1, a + n + 1, a + n])
        faces = np.array(faces, np.int32)
        cons_idx = np.array([0, n * n - 1], np.int32)
        cons_tgt = verts[cons_idx] + [2.0, 2.0, 3.0]
    # the mesh size is fixed by the data; --small shrinks the iteration
    # counts instead
    v0, v1 = mesh_edges(faces)
    return verts, faces, (v0, v1), cons_idx, cons_tgt.astype(np.float32)


class ARAPSolver(CombinedSolverBase):
    def __init__(self, verts, edges, cons_idx, cons_tgt, params):
        super().__init__(arap_mesh_deformation, {"N": len(verts)}, params)
        self.verts = verts.astype(np.float32)
        self.edges = edges
        self.cons_idx, self.cons_tgt = cons_idx, cons_tgt

    def constraints(self, alpha: float) -> np.ndarray:
        # -inf invalid markers, exactly as the reference app fills them
        # (CombinedSolver.h:83); bind-time sentinel clamping keeps them out
        # of arithmetic (compile.py _sanitize_sentinels)
        con = np.full_like(self.verts, -np.inf)
        src = self.verts[self.cons_idx]
        con[self.cons_idx] = (1 - alpha) * src + alpha * self.cons_tgt
        return con

    def combined_solve_init(self):
        N = len(self.verts)
        self.problem_inputs = {
            "Offset": self.verts.copy(),
            "Angle": np.zeros((N, 3), np.float32),
            "UrShape": self.verts,
            "Constraints": self.constraints(1.0),
            "G": {"v0": self.edges[0], "v1": self.edges[1]},
            "w_fitSqrt": np.sqrt(4.0),
            "w_regSqrt": np.sqrt(1.0),
        }

    def pre_single_solve(self):
        self.problem_inputs["Offset"] = self.verts.copy()
        self.problem_inputs["Angle"] = np.zeros((len(self.verts), 3), np.float32)

    def pre_nonlinear_solve(self, i):
        alpha = (i + 1) / self.solver_params["numIter"]
        self.problem_inputs["Constraints"] = self.constraints(alpha)

    def make_device_schedule(self, num_iter):
        """Marker annealing on the plan's device, the whole numIter schedule
        through Plan.solve_scheduled. The schedule receives the bound
        (sentinel-clamped) constants, so the endpoint images are clamped
        the same way; interpolation keeps the sentinel, which both
        endpoints share."""
        plan = self.plan
        san = plan.compiled._sanitize_sentinels
        dev, dt = plan.device, plan.compiled.dtype
        C0 = san(torch.as_tensor(self.constraints(0.0), device=dev).to(dt))
        C1 = san(torch.as_tensor(self.constraints(1.0), device=dev).to(dt))

        def schedule(consts, i):
            a = (i.to(torch.float32) + 1.0) / num_iter
            out = dict(consts)
            out["Constraints"] = (1.0 - a) * C0 + a * C1
            return out

        return schedule


def main(argv=None):
    ap = example_argparser(__doc__)
    ap.add_argument(
        "--rcm",
        action="store_true",
        help="RCM-renumber vertices first (raises the DIA coverage of the "
        "cross-coupling apply for meshes with low-locality numbering; see "
        "opt_tpu_torch/utils/reorder.py)",
    )
    args = ap.parse_args(argv)
    verts, faces, edges, ci, ct = load_data(args.small)
    if args.rcm:
        from opt_tpu_torch.utils.reorder import (
            dia_coverage,
            inverse_permutation,
            permute_vertices,
            rcm_order,
            remap_edges,
        )

        n = len(verts)
        before = dia_coverage(edges[0], edges[1], n)
        perm = rcm_order(edges[0], edges[1], n)
        inv = inverse_permutation(perm)
        verts = permute_vertices(perm, verts)
        edges = remap_edges(perm, edges[0], edges[1])
        ci = inv[np.asarray(ci)]
        print(
            f"RCM: DIA coverage {before:.2f} -> "
            f"{dia_coverage(edges[0], edges[1], n):.2f}"
        )
    print(f"Vertices: {len(verts)}  Edges: {len(edges[0])}  Markers: {len(ci)}")
    if args.small:
        params = {"numIter": 3, "nonLinearIter": 4, "linearIter": 20}
    elif args.perf:
        # performanceRun (main.cpp:81-89): GN+LM, linearIter=1000
        params = {"numIter": 10, "nonLinearIter": 20, "linearIter": 1000}
    else:
        params = {"numIter": 10, "nonLinearIter": 20, "linearIter": 100}
    solver = ARAPSolver(verts, edges, ci, ct, params)
    # reference default runs GN only; perf mode adds LM (main.cpp:80-89)
    solver.add_opt_solvers(
        ["gaussNewtonGPU"] + (["LMGPU"] if (args.perf or args.converged) else [])
    )
    maybe_add_ceres(solver, args)
    solver.solve_all()
    solver.report_final_costs()
    solver.save_results_csv(args.results)
    # deformed mesh output, as the reference app writes out.ply
    # (main.cpp:108 OpenMesh::IO::write_mesh)
    save_mesh("arap_result.ply", host(solver.problem_inputs["Offset"]), faces)
    print("wrote arap_result.ply")
    return solver


if __name__ == "__main__":
    main()
