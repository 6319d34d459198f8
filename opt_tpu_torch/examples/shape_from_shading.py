"""Shape from shading (reference: examples/shape_from_shading).

Refines a depth map so its spherical-harmonics shading matches the target
intensity image. Loads the reference's binary inputs: .imagedump images and
the 160-byte TerraSolverParameters blob (TerraSolverParameters.h:7-44).
"""

import struct

import numpy as np

from opt_tpu_torch.examples.common import (
    data_path,
    example_argparser,
    host,
    maybe_add_ceres,
)
from opt_tpu_torch.harness import CombinedSolverBase
from opt_tpu_torch.models.specs import shape_from_shading
from opt_tpu_torch.utils.io import load_imagedump, save_image, save_imagedump, save_mesh


def load_sfs_parameters(path: str) -> dict:
    """TerraSolverParameters: 7 weights, fx/fy/ux/uy, 4x4 deltaTransform,
    9 lighting coefficients, 3 uints (TerraSolverParameters.h:7-31)."""
    raw = open(path, "rb").read()
    f = struct.unpack("<36f", raw[: 36 * 4])
    return {
        "weightFitting": f[0], "weightRegularizer": f[1], "weightPrior": f[2],
        "weightShading": f[3], "weightBoundary": f[6],
        "fx": f[7], "fy": f[8], "ux": f[9], "uy": f[10],
        "lighting": list(f[27:36]),
    }


def load_inputs(small: bool):
    prefix = data_path("shape_from_shading/default_initialUnknown.imagedump")
    if prefix:
        base = prefix[: -len("_initialUnknown.imagedump")]
        x0 = load_imagedump(base + "_initialUnknown.imagedump").astype(np.float32)
        depth = load_imagedump(base + "_targetDepth.imagedump").astype(np.float32)
        intensity = load_imagedump(base + "_targetIntensity.imagedump").astype(np.float32)
        masks = load_imagedump(base + "_maskEdgeMap.imagedump")
        h, w = x0.shape
        edgeR = masks[:h].astype(np.float32)
        edgeC = masks[h:].astype(np.float32)
        p = load_sfs_parameters(base + ".SFSSolverParameters")
    else:
        rng = np.random.RandomState(0)
        h = w = 64
        depth = (rng.rand(h, w) + 1).astype(np.float32)
        x0 = depth + 0.01 * rng.randn(h, w).astype(np.float32)
        intensity = rng.rand(h, w).astype(np.float32)
        edgeR = edgeC = np.ones((h, w), np.float32)
        p = {
            "weightFitting": 1.0, "weightRegularizer": 10.0, "weightShading": 1.0,
            "fx": 500.0, "fy": 500.0, "ux": w / 2, "uy": h / 2,
            "lighting": [0.5] + [0.1] * 8,
        }
    if small:
        h, w = x0.shape
        s = (slice(h // 2 - 32, h // 2 + 32), slice(w // 2 - 32, w // 2 + 32))
        x0, depth, intensity, edgeR, edgeC = (
            a[s] for a in (x0, depth, intensity, edgeR, edgeC)
        )
    inputs = {
        "X": x0, "D_i": depth, "Im": intensity,
        "edgeMaskR": edgeR, "edgeMaskC": edgeC,
        "w_p": p["weightFitting"], "w_s": p["weightRegularizer"],
        "w_g": p["weightShading"],
        "f_x": p["fx"], "f_y": p["fy"], "u_x": p["ux"], "u_y": p["uy"],
        **{f"L_{i+1}": p["lighting"][i] for i in range(9)},
    }
    return inputs


class SFSSolver(CombinedSolverBase):
    def __init__(self, inputs, params):
        h, w = np.asarray(inputs["X"]).shape
        super().__init__(shape_from_shading, {"W": h, "H": w}, params)
        self._inputs = inputs

    def combined_solve_init(self):
        self.problem_inputs = dict(self._inputs)

    def pre_single_solve(self):
        self.problem_inputs["X"] = np.asarray(self._inputs["X"]).copy()


def main(argv=None):
    ap = example_argparser(__doc__)
    args = ap.parse_args(argv)
    inputs = load_inputs(args.small)
    params = (
        {"numIter": 1, "nonLinearIter": 3, "linearIter": 10}
        if args.small
        else {"numIter": 1, "nonLinearIter": 60, "linearIter": 10}
    )
    solver = SFSSolver(inputs, params)
    # reference default runs GN only; perf mode adds LM (main.cpp:30-38)
    solver.add_opt_solvers(
        ["gaussNewtonGPU"] + (["LMGPU"] if (args.perf or args.converged) else [])
    )
    maybe_add_ceres(solver, args)
    solver.solve_all()
    solver.report_final_costs()
    solver.save_results_csv(args.results)
    # the reference SFS app is the one ConvergenceAnalysis.h user
    # (CUDAImageSolver.cpp:97): per-nonlinear-iteration cost graphs
    solver.save_convergence_graphs(args.results)
    # reference output step (main.cpp:43-49): refined depth as imagedump,
    # a scaled PNG, and a camera-grid PLY mesh (SimpleBuffer::savePLYMesh:
    # z = depth*1000, invalid pixels parked at 0, faces on valid quads)
    depth = host(solver.problem_inputs["X"])
    if depth.ndim == 3:
        depth = depth[..., 0]
    valid = np.isfinite(depth) & (depth > 0)
    d = np.where(valid, depth, 0.0).astype(np.float32)
    save_imagedump("sfsOutput.imagedump", d[..., None])
    save_image("sfsOutput0.png", d / 150.0, scale=255.0)
    h, w = d.shape
    ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    verts = np.stack([ii.ravel(), jj.ravel(), (d * 1000.0).ravel()], -1)
    vq = valid[:-1, :-1] & valid[1:, :-1] & valid[:-1, 1:] & valid[1:, 1:]
    a = (ii[:-1, :-1] * w + jj[:-1, :-1])[vq]
    faces = np.concatenate(
        [
            np.stack([a, a + 1, a + w], -1),
            np.stack([a + 1, a + w + 1, a + w], -1),
        ]
    ).astype(np.int32)
    save_mesh("sfsOutput.ply", verts.astype(np.float32), faces)
    print("Saved sfsOutput.imagedump / sfsOutput0.png / sfsOutput.ply")
    return solver


if __name__ == "__main__":
    main()
