#!/usr/bin/env python3
"""Drive the PyTorch port (opt_tpu_torch) on one CUDA card, end to end.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernel (96 instances of one template: GN or LM,
standard or Chronopoulos-Gear, Jacobi or block-Jacobi, float32 or bfloat16
fields, each without and with the graph remainder phase, each in three
forms: one system a cooperative launch, several independent systems in
turn in one, or side by side in an ordinary launch, a block each; one unit
a form, each by its own nvcc process, linked into one library) from
opt_tpu_torch/ops/csrc and holds each form
against its plain PyTorch twin at the main paths' shapes: poisson
512x512x4 and 2048x2048x4, laplacian 512x512, image_warping's mixed-unknown
GN system and its first LM system, each at 512x512x3 and 1024x1024x3, the
first GN and LM systems of arap_mesh_deformation on the 192x192 grid mesh
(36,864 vertices, the DIA form) and on the armadillo mesh (31,106
vertices, the remainder), volumetric_mesh_deformation's 3-D systems at
32^3 and 64^3, the variants: Chronopoulos-Gear, block-Jacobi and
bfloat16 fields on poisson, image_warping, volumetric and the two meshes,
shape_from_shading's ComputedArray system at 512x512, optical_flow's at
256x256x2, intrinsic_image_decomposition's at 512x512x4, and poisson
1024x1024x4 split into four one-channel systems, GN and LM, and the batch
forms: 512 curve-fit systems and 4 laplacian 16x16 systems side by side
(GN, LM, Chronopoulos-Gear, bfloat16; GN and LM on the batch kernel,
opt_tpu_torch/ops/csrc/tiled_batch_cg.cu, gn_batch_tiled and
lm_batch_tiled, a team of lanes of one warp a system, with the template's
gn_batch and lm_batch held to the same twin results; Chronopoulos-Gear and
bfloat16 on the template, a block a system), each system also against its
own one-system launch, and 4 poisson 512x512x4 systems in turn with their own
fields (and image_warping 512x512 x4 LM, image_warping 500x301 x3 and a
radius-2 stencil x3 with per-instance fields, GN and LM); the batch forms
with the graph remainder and the block
preconditioner: 64 deformations of a 300-vertex random mesh and 4 of a
40-vertex one a block each (GN, LM, Chronopoulos-Gear, bfloat16,
block-Jacobi), the 512 curve fits under block-Jacobi, and the armadillo x4
(GN, LM, bfloat16, block-Jacobi) and image_warping 512x512 x4 under
block-Jacobi (GN, LM, LM Chronopoulos-Gear) in turn in one launch, each
system also against its own one-system launch.
It then solves, through the public API on the card, the poisson bench
headline (512x512x4, one GN step, up to 2000 CG iterations; also by
Chronopoulos-Gear and with bfloat16 fields), image_warping at 512x512 by GN
and by LM (8x400; LM also by Chronopoulos-Gear, block-Jacobi and bfloat16)
and at 1024x1024 by GN (4x100), the two arap meshes by GN (8x100) and
volumetric 32^3 by GN (8x40, with Jacobi and block-Jacobi),
shape_from_shading 512x512 by GN (8x10), optical_flow through PyramidPlan
(128x128 then 256x256, GN 2x50 a level), intrinsic_image_decomposition
512x512 by GN (6x30), poisson 1024x1024x4 by one GN step of up to 2000 CG
iterations a channel (the split), 512 LM curve fits in one solve_batched
(bench.py's batched case, LM 10x20), 4 poisson 512x512x4 instances in one
solve_batched (GN 1x2000), the armadillo posed to 4 handle targets in one
solve_batched (GN 8x100, one remainder multi-system launch a step),
image_warping 512x512 x4 in one solve_batched, LM 8x400, with the Jacobi
and under block-Jacobi, and a solve_scheduled of 5 outer GN 3x15 solves at 512x512, checks
the costs against the JAX package's and each solve's one
launch of the named kernel instance per nonlinear step, solves the arap
grid mesh once more in float64 against the JAX package's float64 solve,
checks the medium golden costs, times kernels, twins, assembly and solves
with CUDA events, profiles the batched curve fits, and prints one JSON line
per result.
The sharded path: it builds the per-tile apply of a solve sharded over a
2-D mesh of ranks (opt_tpu_torch/ops/csrc/tile_apply.cu, in the same
library; a thread a channel of a column over two rows, the triples a
launch parameter) and holds it bitwise
against its twin on the four tiles of a 2x2 split of poisson 512x512x4,
image_warping 512x512x3 and 500x301 (tiles of 250x151 and 250x150), a
radius-2 stencil and bfloat16 fields. As soon as the library is built it starts four
ranks by the spawn method, one 2x2 mesh under gloo, all four on the one
card, which solve through the public API, beside the checks and solves
above, poisson 512x512x4 (GN 1x2000) and image_warping 512x512 (GN and
LM 8x400, and LM under the mesh's auto policy) as 2x2 tiles, each held to
the single-device solve on the card (and poisson to the JAX package's),
with the tile kernel launched once per apply; then graph specs with each
vertex space in owner blocks over the same ranks (arap36k GN 8x100 with
the standard loop and Jacobi, and under the mesh's auto policy, and
embedded10k LM 8x40: the owner-block loop, plain PyTorch, no kernel, one
all_to_all of p a CG apply), their first steps held to the single-device
solve on the card; then 3-D tiles and several vertex spaces on the same
ranks (volumetric 32x32x32 GN 8x40 split along its first two axes, pinned
and under the mesh's auto policy, its apply plain PyTorch; the cluster
ARAP GN 8x100 with Offset and Angle on two vertex spaces, every read of
another rank's rows one all_to_all a CG apply), held likewise; it times the
tile kernel against its bound, and the sharded solves (four ranks sharing
one card: not a scaling figure).
The tiled route: where one system's state fits the card's shared memory at
one tile a block (fused_cg.tiled_grid_plan: the 2-D GN and LM systems at
512x512 and below, float32 fields with the Jacobi or the block-Jacobi
preconditioner, bfloat16 fields with the Jacobi one, Chronopoulos-Gear on
float32 fields with the Jacobi one; and several float32 systems in turn
under the standard loop: the per-channel split, whose one-channel systems
fit one tile an SM at 1024x1024, and a batch), the launch takes the tiled
kernel (opt_tpu_torch/ops/csrc/tiled_grid_cg.cu, launches gn_tiled,
lm_tiled, gn_bf16_tiled, lm_bf16_tiled, gn_bj_tiled, lm_bj_tiled,
gn_multi_tiled, lm_multi_tiled, gn_bj_multi_tiled and lm_bj_multi_tiled;
its Chronopoulos-Gear loop, one grid barrier an iteration,
opt_tpu_torch/ops/csrc/tiled_grid_cs.cu, gn_cs_tiled and lm_cs_tiled; in
the same library); where a one-system float32 Jacobi GN or LM system's
state does not fit but its r and haloed p do, at up to four channels
(image_warping 1024x1024x3),
the same kernel in its hbm layout, delta and Ap in a device frame a block
(gn_hbm_tiled, lm_hbm_tiled; the tiled_plan lines print the layout, the
timing lines the layout's own floor beside the bound); every check above
of such a system runs it, three more
shapes check it in each form (the radius-2 stencil, image_warping on a
grid its tiles do not divide, and on a grid of one tile; the split forced
at 500x301 and on a three-channel radius-2 stencil; the hbm layout forced
at image_warping 512x512 and 500x301 and on the radius-2 stencil), each
system of a batch launch is held bitwise to its own one-system launch, the template's
gn, lm, gn_cs, lm_cs, gn_bf16, lm_bf16, gn_bj, lm_bj, gn_multi, lm_multi,
gn_bj_multi and lm_bj_multi instances stay checked and timed beside it on
the same systems in turns, and the main paths of those systems launch it
once a step (poisson's and image_warping LM's Chronopoulos-Gear and
bfloat16 solves, the split, the poisson batch and image_warping 1024x1024
GN 4x100, on the hbm layout, also held cost for cost and count for count
to the same solves on the template route).
The graph route: a graph system with the remainder whose vertex partition
fits the card's shared memory (fused_cg.graph_tile_plan: float32, the
standard GN or LM loop, the Jacobi preconditioner, one system or a batch
in turn) takes the graph kernel (opt_tpu_torch/ops/csrc/tiled_graph_cg.cu,
launches gn_rem_tiled, lm_rem_tiled, gn_rem_multi_tiled and
lm_rem_multi_tiled, in the same library); its plan is printed (graph_plan
lines), it is held bitwise to the twin on the armadillo, a 300-vertex
random mesh and a 64x64 grid mesh with DIA offsets and a remainder (no
exit, the real exits, a repeat) and on the armadillo x4 (each system also
to its own one-system launch), with the template's instances held to the
same twin results and timed beside it in turns; the armadillo's two main
paths launch it once a step and are held cost for cost and count for
count to the same solves on the template route. A graph without the
remainder takes the same kernel in its stream layout, the fields read from
device memory (gn_dia_tiled, lm_dia_tiled): held bitwise to the twin and
the template on the 192x192 grid mesh, grid meshes of 64x64, 37x50 and
8x8, and curve_fitting's medium system (one vertex of two channels), the
grid mesh's main path launching it once a step; beside its times, a plain
read of the mesh's fields from the L2 (l2_floor, a Triton launch of
scripts/l2_read_floor.py) gives the floor the fields set an iteration.
The 3-D route: a one-system float32 GN system on a 3-D grid with the
Jacobi or the block-Jacobi preconditioner whose fields, state and
preconditioner fit one box a block (fused_cg.tiled_vol_plan: volumetric
32^3 x 6 in 128 boxes of 4x8x8) takes the 3-D grid kernel
(opt_tpu_torch/ops/csrc/tiled_vol_cg.cu, launches gn_vol_tiled and
gn_bj_vol_tiled, in the same library), its fields staged in shared memory
once a solve; its plan is printed (vol_plan lines), it is held bitwise to
the twin and to the template's gn and gn_bj (no exit, the real exits, a
repeat) at 32^3, on forced splits whose boxes are uneven or one point wide
(volumetric 8^3 and 7x8x9) and on the 6^3 medium golden (one box); the
two volumetric main paths launch it once a step and are held cost for
cost and count for count to the same solves on the template route;
volumetric 64^3 (its fields do not fit a box) and every LM 3-D system keep
the template, by name; its time a CG iteration is read against the
template's in the same call, its bound with the fields read once a launch
and its boxes' shells every iteration, and the floor its two barriers set
at the same block count (tiled_floor_vol).
The rest of the graph domain: bench.py's three other graph benchmarks at
their size and depth (100 x 100 grid meshes, 10,000 vertices):
cotangent_mesh_smoothing by LM 8x40 on the graph kernel at an odd channel
count with the remainder (C = 3, lm_rem_tiled), embedded_mesh_deformation
by LM 8x40 (C = 12, lm_rem_tiled) and robust_nonrigid_alignment by GN 8x50
in the stream layout at C = 7 (gn_dia_tiled), its graph group covering 6
of its 7 channels; their GN and LM systems held bitwise to the twin and
the template, cotangent on a 12 x 12 mesh x3 in the multi form, each main
path once a step of its instance, held cost for cost to the plain version
and the template route and to the JAX package's costs as
JAX_CPU_SPEC_COSTS says (two of the three do not settle), and their medium
goldens; and arap on the 192 x 192 grid mesh through one
dynamic_topology=True plan on three topologies of one edge bucket (all
edges, 5% and 10% of the pairs dropped), gn_rem_tiled once a step, each
solve's first two steps held to the exact-topology plan's and the whole
solve to the plain version, with the host ms of each new topology's
tables and partition.
The rest of the linear operator: ARAP with rotation clusters
(cluster_arap_spec: a 2-D Offset on arap's 192 x 192 grid mesh, one Angle
a cluster of 8 x 8 vertices, 576 clusters, a fit over 1% of the
vertices), whose graph couples unknowns on two vertex spaces, so that its
assembled operator carries per-pair ELL blocks and no CG kernel takes it:
GN 8x100 through the public API with fused_fallback "no_kernel" and no CG
launch, its first two steps held to the JAX package's and to the composed
operator's, one JtJ.p to the composed one, its float64 solve to the JAX
package's; Plan.dump_jacobian on image_warping 512x512 (a masked block)
and arap36k, the COO's Jt(J.p) and Jt.r in float64 on the host held to the
assembled operator's apply and JtF; and use_explicit_jtj=True (J and Jt as
CSR, two sparse matvecs a CG iteration) on poisson 512x512x4 GN 1x2000 and
arap36k GN 2x100, held to the tiled route's solves, its ms per CG
iteration beside gn_tiled's and gn_dia_tiled's.
The tooling: the example harness (opt_tpu_torch/harness.py) runs
image_warping 512x512 by GN and LM, three outer 8x400 solves each with the
constraints annealed from rest to target, a timing table a solve, every
step one gn_tiled or lm_tiled launch and each kind's first outer solve
bitwise equal to a direct Plan.solve; seven main paths (poisson, image_warping
1024x1024, the two arap meshes, volumetric, shape_from_shading and the
cluster solve) are solved once more with collect_per_kernel_timing, each
bitwise equal to its untimed solve, its rows disjoint and never negative,
its instances those that launched, with its plan report's one-line
summary (the sharded ranks print theirs, with the tile kernel's
registers); the card's memory is reported after image_warping
1024x1024's solve; and an image_warping 512x512 LM solve saved after 4 steps
and restored into a fresh plan ends bitwise equal to the uninterrupted one.
The C API: it builds libopttpu_torch.so (native/include/OptTpu.h over an
embedded CPython that imports opt_tpu_torch.native_bridge) and the port's C
client with g++ and gcc (opt_tpu_torch/native/build.py) and runs the client
at 64x64 and 512x512 side by side, laplacian GN 3x30 on the card through
Opt_NewState ... Opt_ProblemStep ... Opt_FreeState: each run exits 0 with
PASS, its plan ran gn_tiled once a step with no fallback, and its final
cost and written-back X are bitwise those of the same solve in this
process through opt_tpu_torch.api, and within 5e-3 of the JAX package's.
The example apps: each of the twelve apps of opt_tpu_torch/examples/ runs
in-process without --small (the synthetic fallback's sizes where
OPT_TPU_EXAMPLE_DATA names no reference data), through main(argv), in a working directory of its
own under build/examples/ with --results inside it, one line an app (dims,
depth, wall s, the Final Costs, the instances launched, the fallbacks):
every cost finite, no fallback, every launch of the instance its first
system routes to (a Hopper instance where the route has one), and its
first solve bitwise equal to a direct Plan.solve of the same spec, kind
and inputs, which ends at or below its initial cost (optical_flow's
coarsest GN level overshoots in both packages and is exempt). The driver
entry (opt_tpu_torch/entry.py): entry()'s one GN step of image_warping
64x64 bitwise a one-step Plan.solve, and dryrun_multichip(4) on 2x2 gloo
ranks on the card, the tile kernel launched at every CG apply of both grid
solves on every rank.
The options a mesh takes since slice 27 (SHARDED_OPTION_CASES), on the same
ranks after the other sharded cases: the two bundled specs no other
sharded case runs, intrinsic_image_decomposition 512x512 GN 6x30 (K5 at
every apply) and robust_nonrigid_alignment on 10,000 vertices GN 8x50
(owner blocks), their first steps held to the single-device solve on the
card; float64 plans, poisson 512x512x4 GN 1x2000 (K5's float64 instance,
tile_apply_kernel<double>, at every apply, held bitwise to its twin on
poisson's 256x256 tile and timed against its bound) and arap36k GN 2x100,
each held to the single-device float64 solve on the card at 1e-9 with
equal CG counts; the composed operator (use_fused_jtj=False) on
shape_from_shading 512x512 GN 8x10 and arap36k GN 2x100, no kernel, their
first steps held to the single-device composed solve with equal CG counts;
and poisson 512x512x4 GN 1x2000 timed (collect_per_kernel_timing): bitwise
the untimed sharded solve, rank 0's table printed, and each rank's ms a
sharded CG iteration split into K5, the halo phases, the all_reduces and
the rest (a sharded_split line).
It exits non-zero, with no result line, when CUDA is not available or any
check fails. It imports neither JAX nor opt_tpu.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import itertools
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

import opt_tpu_torch as ot
from opt_tpu_torch.functions import FunctionSet, tree_dot
from opt_tpu_torch import problem as problem_mod
from opt_tpu_torch.compile import compile_spec
from opt_tpu_torch.models.specs import (
    arap_mesh_deformation,
    cotangent_mesh_smoothing,
    curve_fitting,
    embedded_mesh_deformation,
    image_warping,
    intrinsic_image_decomposition,
    laplacian,
    optical_flow,
    poisson_image_editing,
    robust_nonrigid_alignment,
    shape_from_shading,
    volumetric_mesh_deformation,
)
from opt_tpu_torch.harness import CombinedSolverBase
from opt_tpu_torch.ops import fused_cg, sharded_cg
from opt_tpu_torch.ops._build import build_library, instance_registers, load_library, nvcc_path
from opt_tpu_torch.parallel.mesh import split_bounds
from opt_tpu_torch.pyramid import upsample2x_nearest
from opt_tpu_torch.utils import checkpoint, memory
from opt_tpu_torch.utils.plan_report import plan_summary
from opt_tpu_torch.utils.reorder import grid_embed_order, permute_vertices, remap_edges

MAIN_N = 512  # the bench headline's grid side
BIG_N = 2048  # a grid whose state (64 MB a vector) exceeds the 50 MB L2
# Final cost of the main-path solve (poisson 512x512x4, bench inputs, 1 GN
# step, lIterations=2000, default plan) from the JAX package on the CPU
# (568 CG iterations there), computed with:
#   JAX_PLATFORMS=cpu python -c "import numpy as np, opt_tpu as ot;
#   from opt_tpu.models.specs import poisson_image_editing as s; n=512;
#   r=np.random.RandomState(0); m=np.ones((n,n),'f4'); m[64:-64,64:-64]=0;
#   i={'X':r.rand(n,n,4).astype('f4'),'T':r.rand(n,n,4).astype('f4'),'M':m};
#   print(ot.Problem(s).plan(dims={'W':n,'H':n}).solve(i,nIterations=1,
#   lIterations=2000).final_cost)"
JAX_CPU_POISSON_512_COST = 415.1882629394531
IW_N = 512  # bench.py::bench_image_warping's grid side
IW_BIG_N = 1024  # bench.py's image_warping_1024 case
# Final costs of the image_warping main-path solves (bench.py inputs) from
# the JAX package on the CPU, each computed with
#   JAX_PLATFORMS=cpu python -c "import numpy as np, opt_tpu as ot;
#   from opt_tpu.models.specs import image_warping as s; n=N; r=np.random.RandomState(0);
#   f=np.float32; u=np.stack(np.meshgrid(np.arange(n),np.arange(n),indexing='ij'),-1).astype(f);
#   c=-np.ones((n,n,2),f); [c.__setitem__((i,j),[i+r.randn()*3,j+r.randn()*3])
#   for i,j in (r.randint(0,n,2) for _ in range(16))];
#   i={'Offset':u.copy(),'Angle':np.zeros((n,n),f),'UrShape':u,'Constraints':c,
#   'Mask':np.zeros((n,n),f),'w_fitSqrt':np.sqrt(100.0).astype(f),'w_regSqrt':np.sqrt(0.01).astype(f)};
#   print(ot.Problem(s,kind=KIND).plan(dims={'W':n,'H':n}).solve(i,nIterations=NL,lIterations=LI).final_cost)"
# with (N, KIND, NL, LI) as in the key; the JAX CPU runs took 3200, 2811 and
# 400 CG iterations.
JAX_CPU_IMAGE_WARPING_COSTS = {
    (512, "gaussNewtonGPU", 8, 400): 1.9825738668441772,
    (512, "LMGPU", 8, 400): 1.982566475868225,
    (1024, "gaussNewtonGPU", 4, 100): 2.0774598121643066,
}
# The variants' main-path solves through the JAX package on the CPU, with
# the same inputs and plans as above plus InitializationParameters(**IP)
# (IP: cg_variant="chronopoulos_gear", preconditioner="block_jacobi" or
# coefficient_dtype="bfloat16"): poisson 512x512x4 GN 1x2000 and
# image_warping 512x512 LM 8x400, each computed with the commands above,
# given init_params=ot.InitializationParameters(**IP), printing final_cost
# and num_linear_iterations.
JAX_CPU_VARIANT_COSTS = {
    ("poisson", "chronopoulos_gear"): (415.18829345703125, 568),
    ("poisson", "bfloat16"): (415.1882629394531, 568),
    ("image_warping", "chronopoulos_gear"): (1.982565999031067, 2811),
    ("image_warping", "block_jacobi"): (1.9825645685195923, 2811),
    ("image_warping", "bfloat16"): (1.982566237449646, 2811),
}
POISSON_STANDARD_CG_ITERS = 568  # the standard loop's count, on the JAX CPU and the card
CS_ITER_SLACK = (0.1, 2)  # tests/test_pallas.py:85-88: |CS - reference| <= 10% + 2
VOL_N, VOL_BIG_N = 32, 64  # bench.py::bench_volumetric's grid, and one beyond the L2
VOL_NL, VOL_LI = 8, 40  # bench.py::bench_volumetric's GN 8x40
# volumetric 32^3 GN 8x40 through the JAX package on the CPU (bench.py's
# inputs, volumetric_inputs below): the cost after each step and the CG
# iterations, with the default plan and with
# InitializationParameters(preconditioner="block_jacobi"), computed with
#   JAX_PLATFORMS=cpu python -c "import numpy as np, opt_tpu as ot;
#   from opt_tpu.models.specs import volumetric_mesh_deformation as s;
#   INPUTS  # volumetric_inputs(32) below
#   r=ot.Problem(s).plan(dims={'W':32,'H':32,'D':32},init_params=IP).solve(i,
#   nIterations=8,lIterations=40); print(r.costs, r.num_linear_iterations)"
# Like arap, this GN solve does not settle: the step costs rise and fall,
# and a rounding difference grows from the fifth step on (this port's eager
# loop on the CPU parts from the JAX CPU's at 5e-4 there and ends 1.5e-3
# away). So the first VOL_FIRST_STEPS steps are held to the JAX package's
# at FIRST_STEPS_RTOL and the whole solve through the kernel to the same
# solve through the plain version on the card; the finals are printed.
JAX_CPU_VOLUMETRIC = {
    "jacobi": {"costs": [96824.5390625, 97000.2421875, 97066.578125, 96918.5703125,
                         96871.1015625, 96760.9453125, 97050.15625, 97005.2109375],
               "lin_iters": 275},
    "block_jacobi": {"costs": [96824.5859375, 97000.21875, 97066.375, 96918.3984375,
                               96851.0703125, 96916.0859375, 96833.71875, 96967.890625],
                     "lin_iters": 128},
}
VOL_FIRST_STEPS = 4
# The four paths of the remaining grid specs and of the per-channel split,
# through the JAX package on the CPU with bench.py's inputs (sfs_inputs,
# flow_levels, intrinsic_inputs and bench_poisson_inputs below) and the
# default plan, each computed with
#   JAX_PLATFORMS=cpu python -c "import numpy as np, opt_tpu as ot;
#   from opt_tpu.models.specs import SPEC as s; INPUTS;
#   r=ot.Problem(s).plan(dims={'W':n,'H':n}).solve(i,nIterations=NL,lIterations=LI);
#   print(r.costs, r.num_linear_iterations)"
# shape_from_shading 512x512 GN 8x10: like arap and volumetric this solve
# does not settle in 10 CG iterations a step (the costs rise, then fall),
# and the two packages part from the third step on (6e-6, 6e-5, 1e-4, ...),
# so the first SFS_FIRST_STEPS steps are held at FIRST_STEPS_RTOL and the
# whole solve to the plain version's on the card, cost for cost.
SFS_N, SFS_NL, SFS_LI, SFS_FIRST_STEPS = 512, 8, 10, 4
JAX_CPU_SFS = {"costs": [16540.947265625, 17016.50390625, 17384.029296875, 17348.728515625,
                         17362.873046875, 17243.849609375, 17201.62109375, 17160.55078125],
               "lin_iters": 80}
# optical_flow, bench.py::bench_optical_flow's host-driven level loop (a
# plan a level, GN 2x50 each, X upsampled by upsample2x_nearest(scale=2)
# between): each level's final cost, 100 CG iterations a level
FLOW_N, FLOW_NL, FLOW_LI = 256, 2, 50
JAX_CPU_FLOW_LEVEL_COSTS = [20262.8203125, 69356.03125]
# intrinsic_image_decomposition 512x512 GN 6x30 (180 CG iterations)
INTR_N, INTR_NL, INTR_LI = 512, 6, 30
JAX_CPU_INTRINSIC_512_COST = 622690.125
# poisson 1024x1024x4, 1 GN step, lIterations=2000: the JAX package's split
# solve (its Pallas kernel with chan_grid=True in interpret mode, a plan
# with InitializationParameters(use_pallas_cg="interpret")): the final cost
# and the CG iterations summed over the four channels; its joint XLA loop
# (use_pallas_cg="off") ends at 837.70458984375 after 716
SPLIT_N = 1024
JAX_CPU_POISSON_1024_SPLIT = (837.7045288085938, 2723)
# bench.py::bench_batched_curve_fitting (bench.py:793-819): 512 curve fits
# of N = 256 data points, LM 10x20, in one solve_batched
BATCH_B, BATCH_N, BATCH_NL, BATCH_LI = 512, 256, 10, 20
# The same batched solve through the JAX package on the CPU: every instance
# took 10 steps, the linear counts summed to 10255 (19 to 25 an instance),
# the final costs to 2.8972860891371965e-3 (each at most 1.25e-5), and the
# largest |param - truth| was 6.7166146067165755e-06. Its fitted parameters,
# counts and costs per instance are in BATCH_REF, written by
#   JAX_PLATFORMS=cpu python -c "import numpy as np, opt_tpu as ot;
#   from opt_tpu.models.specs import curve_fitting as s; B, N = 512, 256;
#   r=np.random.RandomState(0); x=np.linspace(0,1,N); t=r.uniform(80,120,(B,2));
#   d=np.stack([np.stack([x,a*np.cos(b*x)+b*np.sin(a*x)],-1) for a,b in t]).astype('f4');
#   i0=(t+r.randn(B,2)*0.05).astype('f4'); G={'d':np.arange(N,dtype='i4'),'p':np.zeros(N,'i4')};
#   res=ot.Problem(s,kind='LMGPU').plan(dims={'N':N,'U':1}).solve_batched(
#     {'funcParams':i0[:,None,:],'data':d,'G':G},nIterations=10,lIterations=20);
#   np.savez_compressed('benchdata/batched_curve_fit_jax_cpu.npz',
#     params=np.asarray(res.unknowns['funcParams'])[:,0,:],
#     lin_iters=np.asarray(res.num_linear_iterations),
#     final_costs=np.asarray(res.final_costs),num_iterations=np.asarray(res.num_iterations))"
BATCH_REF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchdata",
                         "batched_curve_fit_jax_cpu.npz")
JAX_CPU_BATCHED_LIN_ITERS = 10255
BATCH_PARAM_ATOL = 1e-4  # the fitted parameters against the JAX CPU's
BATCH_TRUTH_ATOL = 1e-3  # the largest |param - truth|
BATCH_LIN_RTOL = 0.02  # the summed CG count against the JAX CPU's
BATCH_POISSON_B = 4  # solve_batched over bench_poisson's input and 3 other seeds
LAP_BATCH_B, LAP_BATCH_N = 4, 16  # tests/test_pallas.py:196's batch
# K1 (h) x K4 and K1 (h) x K1 (d), the batch axis of the remainder and
# block-Jacobi forms: the armadillo posed to four handle targets in one
# solve_batched (instance 0 bench_arap_irregular's pull of 0.2 of the
# height, the others ARM_BATCH_PULLS[1:]), GN 8x100; image_warping 512x512
# four times under block-Jacobi (instance 0 the bench's constraints, the
# others moved by a seeded offset), LM 8x400. Each instance's first two step
# costs are held to its own solve on the card at BATCH_STEP_RTOL (the
# batched assembly under vmap rounds apart from the single one).
ARM_BATCH_PULLS = (0.2, 0.10, 0.15, 0.25)
IW_BJ_BATCH_B = 4
BATCH_STEP_RTOL = 1e-4
# random irregular meshes (a ring with chords under a random numbering: the
# remainder form) for the batch form: RANDOM_MESH_B systems of
# RANDOM_MESH_N vertices (1,800 elements), and SMALL_MESH_B of SMALL_MESH_N
# (240 elements), whose one-system launch also takes one block, so that
# each system is also held bitwise to its own launch
RANDOM_MESH_N, RANDOM_MESH_B = 300, 64
SMALL_MESH_N, SMALL_MESH_B = 40, 4
# iterations of the no-exit and the real-exit checks: the twin runs the
# systems one after the other
RANDOM_MESH_LITS, RANDOM_MESH_EXIT_LITS = 10, 20
SMALL_MESH_LITS, SMALL_MESH_EXIT_LITS = 30, 60
# form_sweep: 4 laplacian systems of these sides (256 to 16,384 elements a
# system) through both batch forms, where fused_cg.BATCH_BLOCK_ELEMS (2048)
# is set: 45x45 is the last size under it; and, within the "batch" form,
# the batch kernel against the template's block a system on both sides of
# fused_cg.BATCH_TEAM_LANE_ELEMS (31 elements a lane: 31x31 under, 32x32 over)
SWEEP_B, SWEEP_SIDES = 4, (16, 24, 28, 30, 31, 32, 45, 64, 128)
# solve_scheduled on tests/test_scheduled.py's spec (sched_inputs below),
# held to the host-driven loop on the card
SCHED_N, SCHED_OUTER, SCHED_NL, SCHED_LI = 512, 5, 3, 15
SCHED_RTOL = 1e-5
GOLDEN_RTOL = 5e-3  # tests/test_golden_costs.py
GOLDEN_ATOL = 1e-8  # tests/test_golden_costs.py: near-zero goldens
# (spec, kind, nIterations, lIterations, golden) from tests/test_golden_costs.py
MEDIUM_GOLDENS = {
    "laplacian": (laplacian, "gaussNewtonGPU", 6, 40, 1.6753909587860107),
    "poisson_image_editing": (poisson_image_editing, "gaussNewtonGPU", 2, 120, 258.89776611328125),
    "image_warping": (image_warping, "LMGPU", 10, 60, 3.3203492039168836e-12),
    "curve_fitting": (curve_fitting, "LMGPU", 12, 60, 14.498645782470703),
    "volumetric_mesh_deformation": (volumetric_mesh_deformation, "gaussNewtonGPU", 8, 40,
                                    108.64008331298828),
    "optical_flow": (optical_flow, "gaussNewtonGPU", 4, 40, 7330.97265625),
    "intrinsic_image_decomposition": (intrinsic_image_decomposition, "gaussNewtonGPU", 6, 30,
                                      845.5782470703125),
    "cotangent_mesh_smoothing": (cotangent_mesh_smoothing, "LMGPU", 8, 40, 3.7031397819519043),
    "embedded_mesh_deformation": (embedded_mesh_deformation, "LMGPU", 10, 40,
                                  47.63282775878906),
    "robust_nonrigid_alignment": (robust_nonrigid_alignment, "LMGPU", 8, 40,
                                  33.04822540283203),
}
# the instance each medium golden's solve launches once a step: the tiled
# grid kernel's, the 3-D grid kernel's (6^3: one box of the whole grid),
# for curve_fitting's one vertex the graph kernel's stream layout, and for
# the three 200-vertex ring meshes (a remainder where the ring closes, or
# the four-slot edges' reads) its resident layout
GOLDEN_FORMS = {"laplacian": "gn_tiled", "poisson_image_editing": "gn_tiled",
                "image_warping": "lm_tiled", "curve_fitting": "lm_dia_tiled",
                "volumetric_mesh_deformation": "gn_vol_tiled", "optical_flow": "gn_tiled",
                "intrinsic_image_decomposition": "gn_tiled",
                "cotangent_mesh_smoothing": "lm_rem_tiled",
                "embedded_mesh_deformation": "lm_rem_tiled",
                "robust_nonrigid_alignment": "lm_rem_tiled"}
# arap_mesh_deformation's medium golden is left out: its GN 10x60 solve does
# not settle and ends where float32 rounding takes it (tests/test_torch_graph.py
# holds it step by step from the JAX package's states)
# shape_from_shading's medium golden (LM 8x30 at 32x32, 47.196999) is where
# the JAX package's float32 solve on the CPU ends; the solve does not settle
# either. LM's accept-or-reject decisions of the later steps turn on float32
# rounding: this port ends at 46.298 through the plain fused loop on the CPU,
# at 50.475 through its eager loop, and both packages end at 49.5797 in
# float64 (equal to 1.4e-9 at every step). So the float32 solve on the card is
# held to the JAX package's first SFS_MEDIUM_FIRST_STEPS steps at
# FIRST_STEPS_RTOL and cost for cost to the plain version on the card, and
# the float64 solve on the card to the JAX package's float64 costs at
# F64_RTOL, every step; the final cost is printed beside the golden.
# Computed with (medium_inputs()["shape_from_shading"] below as INPUTS)
#   JAX_PLATFORMS=cpu python -c "import opt_tpu as ot; ot.enable_double_precision();
#   from opt_tpu.models.specs import shape_from_shading as s; INPUTS
#   for dp in (False, True):
#     r=ot.Problem(s,kind='LMGPU').plan(dims={'W':32,'H':32},double_precision=dp).solve(
#       i,nIterations=8,lIterations=30); print(r.costs)"
SFS_MEDIUM = (shape_from_shading, "LMGPU", 8, 30, 47.196999)
SFS_MEDIUM_FIRST_STEPS = 2
JAX_CPU_SFS_MEDIUM = {
    "costs": [80.11676025390625, 60.0125732421875, 56.445960998535156, 50.88523483276367,
              50.61924362182617, 50.085716247558594, 49.311614990234375, 47.196998596191406],
    "lin_iters": 240}
JAX_CPU_SFS_MEDIUM_F64_COSTS = [
    80.11705242317355, 59.99977844238443, 56.44665971059827, 50.89268638366067,
    50.552291661581975, 49.57972773770189, 49.57972773770189, 49.57972773770189,
]
# kernel vs twin after a fixed iteration count: both sum each dot's float32
# products in float64, but in another order, so the float32 iterates may
# part in the last bits
DELTA_RTOL = 1e-4
CG_TOL = 1e-12  # SOLVER_PARAMETER_DEFAULTS["cg_rz_tolerance"]
Q_TOL = 1e-4  # SOLVER_PARAMETER_DEFAULTS["q_tolerance"]
RESET_PERIOD = 10  # SOLVER_PARAMETER_DEFAULTS["residual_reset_period"]
TIMED_ITERS = 100  # iterations of a timed loop
PROFILE_SESSIONS = 3  # kernel_device_ms: profiler sessions before CUDA events
KERNEL_SOURCE = "opt_tpu_torch/ops/csrc/fused_grid_cg.cuh"
TILED_SOURCE = "opt_tpu_torch/ops/csrc/tiled_grid_cg.cu"
TILED_CS_SOURCE = "opt_tpu_torch/ops/csrc/tiled_grid_cs.cu"
GRAPH_SOURCE = "opt_tpu_torch/ops/csrc/tiled_graph_cg.cu"
TILED_VOL_SOURCE = "opt_tpu_torch/ops/csrc/tiled_vol_cg.cu"
TILED_BATCH_SOURCE = "opt_tpu_torch/ops/csrc/tiled_batch_cg.cu"
# the CG kernels' names, as the profiler's entries carry them
CG_KERNELS = ("fused_grid_cg_kernel", "tiled_grid_cg_kernel", "tiled_graph_cg_kernel",
              "tiled_vol_cg_kernel", "tiled_batch_cg_kernel")
# the 3-D grid kernel's forced splits (fused_cg.box_bounds): volumetric on
# these grids (W, H, D) cut into these boxes, each uneven or one point wide
# along some axis (tests/test_torch_tiled_vol.py emulates the same)
VOL_FORCED = (((8, 8, 8), (8, 1, 1)), ((8, 8, 8), (1, 8, 1)), ((8, 8, 8), (1, 1, 8)),
              ((7, 8, 9), (3, 3, 3)), ((7, 8, 9), (3, 2, 2)))
# the graph kernel's DIA-plus-remainder check: dense_grid_mesh_inputs at this
# side (4,096 vertices), 13 DIA offsets and the fourteenth's reads in the CSR
DENSE_SIDE = 64
# the tiled kernel's further checks: image_warping on a grid its ceil split
# leaves ragged in both axes (12 x 11 tiles of 42 x 28, the last 38 and 21),
# and on a grid of one tile
RAGGED_DIMS = {"W": 500, "H": 301}
SINGLE_N = 16
K1 = "opt_tpu/ops/pallas_cg.py:328"
K3 = "opt_tpu/ops/pallas_cg.py:335"  # _kernel's flat1d=True graph form
K4 = "opt_tpu/ops/pallas_cg.py:338"  # _kernel's rem_pairs remainder
K6 = "opt_tpu/ops/pallas_cg.py:1430"
K1C = "opt_tpu/ops/pallas_cg.py:238"  # _kernel's cs=True loop (_run_cg's CS bodies)
K1D = "opt_tpu/ops/pallas_cg.py:367"  # _kernel's block_pre=True apply
K1E = "opt_tpu/ops/pallas_cg.py:561"  # _kernel over a 3-D grid (plan_fused_grid_cg)
K1F = "opt_tpu/ops/pallas_cg.py:586"  # _kernel with coeff_dtype fields
K1G = "opt_tpu/ops/pallas_cg.py:328"  # _kernel over a ComputedArray operator's fields
K2 = "opt_tpu/ops/pallas_cg.py:339"  # _kernel's chan_grid=True form
K1H = "opt_tpu/ops/pallas_cg.py:328"  # _kernel under jax.vmap (gauss_newton.py:983-1004)
K5 = "opt_tpu/ops/pallas_cg.py:1167"  # _tile_apply_kernel, inside sharded_fused_grid_cg
K5_SOURCE = "opt_tpu_torch/ops/csrc/tile_apply.cu"
# the card's published peaks (H100 SXM at 700 W). The bound of a CG call
# is the larger of its bytes (each per-system input read once per iteration,
# the shared triples table once per launch) over the memory rate and its
# operations over the peak rate of their type (cg_bound)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 34e12

ARAP_SIDE = 192  # bench.py::bench_arap_graph: 36,864 vertices
# the graph kernel's stream layout (a graph without the remainder) also on
# arap grid meshes of 64 x 64 (48 ranges, a halo of 128 against ranges of
# 86), 37 x 50 (22 ranges that end inside rows, a halo of 100) and 8 x 8
# (one range): rows x columns
DIA_MESHES = ((64, 64), (37, 50), (8, 8))
ARMADILLO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchdata",
                         "armadillo31k.npz")
GRAPH_NL, GRAPH_LI = 8, 100  # bench.py's GN 8x100 on both meshes
# The arap solves through the JAX package on the CPU (bench.py's inputs,
# GN 8x100, default plan): the cost after each of the first two steps, the
# final cost and the CG iterations, computed with
#   JAX_PLATFORMS=cpu python -c "import numpy as np, opt_tpu as ot;
#   from opt_tpu.models.specs import arap_mesh_deformation as s;
#   INPUTS  # arap_grid_inputs(192) or armadillo_inputs() below (the
#           # armadillo numbered by this port's seeded grid_embed_order)
#   r=ot.Problem(s).plan(dims={'N':N}).solve(i,nIterations=8,lIterations=100);
#   print(r.costs, r.final_cost, r.num_linear_iterations)"
# GN on these meshes with 100 CG iterations a step does not settle: the
# cost rises and falls from step to step, and each step multiplies a
# rounding difference by about 100, in float64 as in float32 (see
# JAX_CPU_ARAP36K_F64_COSTS), so two correct solvers with other summation
# orders end apart (the grid mesh in float32: the JAX package on the CPU
# ends at 61421.2, this port on the CPU at 63428.3, the JAX package on a TPU
# at 65712.6). So the first two steps are held to the JAX package's to
# FIRST_STEPS_RTOL, the whole solve through the kernel to the same solve
# through the plain version on the card, and the float64 solve's first
# F64_STEPS steps to the JAX package's float64 solve; the final costs are
# printed beside the JAX package's.
JAX_CPU_GRAPH_COSTS = {
    "arap36k": {"first_costs": [59055.1015625, 61090.59375], "final": 61421.24609375,
                "lin_iters": 570},
    "armadillo31k": {"first_costs": [300301.96875, 298587.09375], "final": 293362.75,
                     "lin_iters": 753},
}
# the same solves on a TPU (BENCH_LIVE.json arap_final_cost,
# arap_irregular_final_cost): cross-checks only
TPU_GRAPH_FINAL_COSTS = {"arap36k": 65712.609375, "armadillo31k": 286089.125}
# the first two steps' costs in float32 against the JAX package's (the
# readings so far: 1e-7 to 8.8e-6)
FIRST_STEPS_RTOL = 1e-4
# The arap36k solve in float64 through the JAX package on the CPU: the cost
# after each of the 8 steps (512 CG iterations in all), computed with
#   JAX_PLATFORMS=cpu python -c "import opt_tpu as ot; ot.enable_double_precision();
#   from opt_tpu.models.specs import arap_mesh_deformation as s;
#   INPUTS  # arap_grid_inputs(192) below
#   r=ot.Problem(s).plan(dims={'N':N},double_precision=True).solve(i,nIterations=8,
#   lIterations=100); print(r.costs)"
# Float64 does not make the solve settle: this port's float64 solve on the
# CPU (same command through opt_tpu_torch with device="cpu") agrees with it
# to 1.1e-10 after four steps, 1.3e-6 after five and ends 3% away
# (65483.43). So the float64 solve on the card is held to it for the first
# F64_STEPS steps, at F64_RTOL.
JAX_CPU_ARAP36K_F64_COSTS = [
    59055.10381103148, 61090.58214405866, 64672.77617457579, 60311.62834798327,
    62966.05437434709, 61263.52447705914, 66067.29685116408, 63485.283247330124,
]
F64_STEPS, F64_RTOL = 4, 1e-6
# The three other graph specs at bench.py's configurations (GRAPH_SPECS,
# below the inputs: 100 x 100 grid meshes, 10,000 vertices).
SPEC_SIDE = 100
# Their solves through the JAX package on the CPU, float32 and float64:
# each step's cost and the CG iterations, the "solve" lines of package jax
# that `JAX_PLATFORMS=cpu python3 scripts/graph_spec_numerics.py --solves`
# prints (with the port's on the CPU, and the numerics quoted below)
# robust_nonrigid settles: its final cost is held to the JAX package's at
# GOLDEN_RTOL and its first two steps at FIRST_STEPS_RTOL (this port on the
# CPU ends equal to the last digit). The other two do not (ROADMAP.md
# queue 3): embedded's LM accepts or rejects its later steps on float32
# rounding (the JAX package ends at 180134.0, this port on the CPU at
# 184331.6, both packages at 225193 in float64), so its first step is held
# at FIRST_STEPS_RTOL and its float64 solve's first step at F64_RTOL (the
# second parts by 1.0e-6); cotangent's float32 cost is rounding at its
# near-collinear vertex triples (118 discriminants below 1e-6 in float64,
# quantised to 6e-8 in float32: the initial cost is 44838.8 in float64 in
# both packages, 36495.4 in float32 in this port, 3218908.75 in the JAX
# package, whose LM then rejects every step), so only its float64 solve's
# first three steps are held, at F64_RTOL (the fourth parts by 16%). Each
# solve through the kernel is held cost for cost to the same solve
# through the plain version on the card and on the template route.
JAX_CPU_SPEC_COSTS = {
    "cotangent10k": {
        "costs": [3218908.75] * 8, "lin_iters": 320, "first_steps": 0, "settles": False,
        "f64_costs": [24626.88629884662, 14976.64299720012, 14696.639045336718,
                      11605.51532895253, 7830.432063066777, 7159.813700278307,
                      5975.463691507984, 5937.962769094745], "f64_steps": 3},
    "embedded10k": {
        "costs": [909260.9375, 304429.46875, 304429.46875, 304429.46875, 304429.46875,
                  304429.46875, 180134.015625, 180134.015625], "lin_iters": 237,
        "first_steps": 1, "settles": False,
        "f64_costs": [909260.143168007, 312321.24066344334, 312321.24066344334,
                      312321.24066344334, 312321.24066344334, 312321.24066344334,
                      225192.8130665088, 225192.8130665088], "f64_steps": 1},
    "robust10k": {
        "costs": [8.315200805664062, 5.352590560913086, 5.346518516540527, 5.3464837074279785,
                  5.346484661102295, 5.3464837074279785, 5.3464837074279785,
                  5.3464837074279785], "lin_iters": 400, "first_steps": 2, "settles": True,
        "f64_costs": [8.315192013056613, 5.352588633489998, 5.346518243518178,
                      5.346483672505494, 5.346483240158158, 5.346483230385493,
                      5.346483230072323, 5.34648323005976], "f64_steps": 0},
}
# the odd-C graph kernel in the multi form: cotangent on a 12 x 12 grid mesh
# (bench_cotangent's construction, DIA and remainder), 3 instances
ODD_MULTI_SIDE, ODD_MULTI_B = 12, 3
# dynamic_topology: arap36k (146,688 directed edges, the edge bucket of
# 262,144) through one plan on three topologies: all edges, then these
# shares of its edge pairs dropped (seeded; 10% leaves 132,020 edges, still
# above the bucket below, 131,072). GN at GRAPH_NL x GRAPH_LI.
DYN_DROPS = (0.0, 0.05, 0.10)
# ARAP with rotation clusters (cluster_arap_spec): arap36k's grid mesh and
# constraints in 2-D, one rotation a cluster of CLUSTER x CLUSTER vertices
# (24 x 24 = 576 clusters), a fit over H on CLUSTER_FIT_SHARE of the
# vertices and the two corners. GN at GRAPH_NL x GRAPH_LI.
CLUSTER = 8
CLUSTER_FIT_SHARE = 0.01
# Its solve through the JAX package on the CPU, float32 and float64, GN
# GRAPH_NL x GRAPH_LI: each step's cost and the CG count, as
# `JAX_PLATFORMS=cpu python3 scripts/cluster_arap_numerics.py` prints them.
# Like arap36k's it does not settle: float32 and float64 part by 7e-6 at
# the third step, 2e-4 at the fourth, 6.9% at the end (ROADMAP.md queue
# 3). So its first two steps are held at FIRST_STEPS_RTOL, the float64
# solve's first CLUSTER_F64_STEPS at F64_RTOL.
JAX_CPU_CLUSTER_COSTS = {
    "costs": [42130.5703125, 43331.04296875, 41758.2890625, 42405.546875, 47659.0390625,
              44832.83984375, 43131.359375, 34107.10546875], "lin_iters": 800,
    "f64_costs": [42130.574699170895, 43331.0733685287, 41758.5850400699, 42414.299926863045,
                  47682.00389255693, 42304.80144154036, 42557.149492336925, 36444.63939577949]}
CLUSTER_F64_STEPS = 3
CLUSTER_APPLY_RTOL = 1e-5  # one assembled JᵀJ·p against the composed Jᵀ(J·p)
# the exported J's Jᵀ(J·p) and Jᵀr (float64, host) against the assembled
# operator's apply and JᵀF (float32, card), of the largest entry
JACOBIAN_RTOL = 1e-5
# The sharded solves: four ranks, a 2x2 mesh, on the one card under gloo
# (NCCL refuses two ranks on one device). Each case: label, spec, kind,
# grid side, nonlinear x CG iterations, InitializationParameters. The
# single-device references are this run's own solves on the card (and
# poisson's the JAX CPU's too); the mesh's auto policy takes CS and
# block-Jacobi, so the pinned cases name the standard loop and Jacobi.
MESH_SHAPE = (2, 2)
PINNED = {"cg_variant": "standard", "preconditioner": "jacobi"}
CS_BJ = {"cg_variant": "chronopoulos_gear", "preconditioner": "block_jacobi"}
SHARDED_CASES = [
    ("poisson512x4 GN 1x2000", "poisson", "gaussNewtonGPU", MAIN_N, 1, 2000, PINNED),
    ("image_warping512 GN 8x400", "image_warping", "gaussNewtonGPU", IW_N, 8, 400, PINNED),
    ("image_warping512 LM 8x400", "image_warping", "LMGPU", IW_N, 8, 400, PINNED),
    ("image_warping512 LM 8x400 auto", "image_warping", "LMGPU", IW_N, 8, 400, {}),
]
# The graph, 3-D grid and several-space cases the same ranks solve after
# SHARDED_CASES, through the public API (no kernel: the JAX package runs
# XLA's loop for each). The graph cases split each 1-D vertex space into
# owner blocks over the 2x2 mesh (ROADMAP.md queue 1 item 8b); the auto
# case resolves to Chronopoulos-Gear, block-Jacobi and the owner reorder;
# embedded10k at GRAPH_SPECS' depth. Then (item 8c) volumetric 32^3 split
# along its first two axes (tiles of 16x16x32, the third axis whole),
# pinned and under the mesh's auto policy (Chronopoulos-Gear and
# block-Jacobi), and the cluster ARAP (Offset on the 36,864 vertices, an
# Angle on each of the 576 clusters, each space in owner blocks). Each:
# label, name (mesh_case_problem), kind, nonlinear x CG iterations,
# InitializationParameters, and how many first steps are held to the
# single-device solve on the card under the same settings (these float32
# solves do not settle past them, ROADMAP.md queue 3).
PINNED_GRAPH = dict(PINNED, edge_reorder=False)
SHARDED_MESH_CASES = [
    (f"arap36k GN {GRAPH_NL}x{GRAPH_LI}", "arap", "gaussNewtonGPU", GRAPH_NL, GRAPH_LI,
     PINNED_GRAPH, 2),
    (f"arap36k GN {GRAPH_NL}x{GRAPH_LI} auto", "arap", "gaussNewtonGPU", GRAPH_NL, GRAPH_LI, {},
     2),
    ("embedded10k LM 8x40", "embedded", "LMGPU", 8, 40, PINNED_GRAPH, 1),
    (f"volumetric{VOL_N} GN {VOL_NL}x{VOL_LI}", "volumetric", "gaussNewtonGPU", VOL_NL, VOL_LI,
     PINNED_GRAPH, VOL_FIRST_STEPS),
    (f"volumetric{VOL_N} GN {VOL_NL}x{VOL_LI} auto", "volumetric", "gaussNewtonGPU", VOL_NL,
     VOL_LI, {}, VOL_FIRST_STEPS),
    (f"cluster_arap GN {GRAPH_NL}x{GRAPH_LI}", "cluster", "gaussNewtonGPU", GRAPH_NL, GRAPH_LI,
     PINNED_GRAPH, 2),
]
# Then (item 8d's grid half) the grid specs that read Index, a SampledImage
# or a ComputedArray: shape_from_shading 512^2 GN 8x10 (tiles of 256^2, a
# region's halo of 3: its ComputedArrays' reach) and optical_flow's pyramid
# through PyramidPlan (levels 128^2 and 256^2, GN 2x50 a level, the flow
# gathered, prolonged and cut to the next level's regions between levels),
# pinned, with K5 at every CG apply. Each: label, name, grid side (the
# finest level's), nonlinear x CG iterations, InitializationParameters,
# and how many first steps (a level's, for the pyramid) are held at
# FIRST_STEPS_RTOL to the single-device solve on the card under the same
# settings: SFS's 512^2 GN path parts from its third step (ROADMAP.md
# queue 3); a pyramid level's final cost is held at GOLDEN_RTOL besides.
SHARDED_READ_CASES = [
    (f"shape_from_shading{SFS_N} GN {SFS_NL}x{SFS_LI}", "sfs", SFS_N, SFS_NL, SFS_LI, PINNED, 2),
    (f"optical_flow{FLOW_N} pyramid GN {FLOW_NL}x{FLOW_LI}", "flow", FLOW_N, FLOW_NL, FLOW_LI,
     PINNED, 1),
]
SHARDED_ITER_RTOL = 0.01  # a sharded solve's CG count against the single-device one
# The options a mesh takes since slice 27, solved by the same ranks after
# SHARDED_READ_CASES: item 8f's two bundled specs at bench.py's sizes
# (intrinsic 512^2 GN 6x30, bench.py:664, K5 at every apply; robust10k GN
# 8x50, bench.py:588, owner blocks), their first steps within
# FIRST_STEPS_RTOL and CG counts within SHARDED_ITER_RTOL of the
# single-device solve on the card; float64 plans (poisson 512^2x4 GN
# 1x2000 on K5's float64 instance, arap36k GN 2x100 on owner blocks), every
# step's cost within F64_MESH_RTOL of the single-device float64 solve's on
# the card, the CG counts equal; the composed operator (use_fused_jtj=False,
# no kernel: shape_from_shading 512^2 GN 8x10, arap36k GN 2x100), its
# first steps within FIRST_STEPS_RTOL of the single-device composed solve,
# the CG counts equal. Each: label, name (option_case_problem), kind,
# nonlinear x CG iterations, InitializationParameters, float64, the steps
# held, the CG counts' relative tolerance.
F64_MESH_RTOL = 1e-9
COMPOSED = dict(PINNED, use_fused_jtj=False)
SHARDED_OPTION_CASES = [
    (f"intrinsic{INTR_N} GN {INTR_NL}x{INTR_LI}", "intrinsic", "gaussNewtonGPU", INTR_NL,
     INTR_LI, PINNED, False, 2, SHARDED_ITER_RTOL),
    ("robust10k GN 8x50", "robust", "gaussNewtonGPU", 8, 50, PINNED_GRAPH, False, 2,
     SHARDED_ITER_RTOL),
    (f"poisson{MAIN_N}x4 GN 1x2000 float64", "poisson", "gaussNewtonGPU", 1, 2000, PINNED, True,
     1, 0.0),
    (f"arap36k GN 2x{GRAPH_LI} float64", "arap", "gaussNewtonGPU", 2, GRAPH_LI, PINNED_GRAPH,
     True, 2, 0.0),
    (f"shape_from_shading{SFS_N} GN {SFS_NL}x{SFS_LI} composed", "sfs", "gaussNewtonGPU",
     SFS_NL, SFS_LI, COMPOSED, False, 2, 0.0),
    (f"arap36k GN 2x{GRAPH_LI} composed", "arap", "gaussNewtonGPU", 2, GRAPH_LI,
     dict(COMPOSED, edge_reorder=False), False, 2, 0.0),
]
# the sharded case solved once more with collect_per_kernel_timing, whose
# rows split a sharded CG iteration (poisson 512^2x4 GN 1x2000)
TIMED_SHARDED_CASE = 0  # an index into SHARDED_CASES
SHARDED_TIMEOUT_S = 600  # the ranks' whole run
OUT_DIR = os.path.join("build", "profiles")  # git-ignored
# The route profiles (template and tiled) of image_warping 512^2 (GN, LM,
# LM block-Jacobi, x4 block-Jacobi batched) and 1024^2, volumetric 32^3,
# arap36k, the armadillo x4 and the cluster-rotation solve, and the
# profiles of the three graph specs and the last dynamic topology, run
# 1/PROFILE_NL_CUT of their solves' nonlinear steps (8 -> 2, 4 -> 1), not
# the whole solve: a profile's cost is mostly its device launches' events,
# about 1 ms each. Half their steps made room for the graph specs, dynamic
# topology, cross-space, Jacobian and explicit-J paths, a quarter for the
# graph specs on a mesh. Their main paths and solve times still run at
# full depth.
PROFILE_NL_CUT = 4
# the tooling's paths: the harness's outer solves of image_warping 512x512
# (examples/image_warping.py's constraint annealing), where the checkpoint
# path writes (git-ignored), and the steps before its save
HARNESS_OUTER = 3
CKPT_DIR = os.path.join("build", "checkpoints")
CKPT_STEPS = 4
# the timer's rows that make up a step's assembly (utils/timer.py)
ASSEMBLY_ROWS = ("computedBundle", "assembleConst", "assembleFields", "PCGInit1",
                 "PCGComputeCtC", "blockInverse", "explicitJ")
# The C API: the port's C client (opt_tpu_torch/native/client.c) through
# libopttpu_torch.so on the card, laplacian GN C_API_NL x C_API_LI at each
# side, with the energy file the JAX package's C client loads
C_API_SIZES = (64, 512)
C_API_NL, C_API_LI = 3, 30
C_API_SPEC = os.path.join("native", "test", "laplacian_spec.py")
# The JAX package's solve on the CPU of the A each client run draws (srand(42)
# and rand(); the SHA-256 of A's bytes, its first 16 hex digits, says that
# the card's machine drew the same), as `JAX_PLATFORMS=cpu python3
# scripts/c_api_numerics.py` prints it; the card's final cost is held to it
# at C_API_RTOL
JAX_CPU_C_API = {64: {"a_sha256": "0d4fcd4a442aaf88", "final_cost": 6.786226749420166},
                 512: {"a_sha256": "1da5e4ca843e633e", "final_cost": 428.2104797363281}}
C_API_RTOL = 5e-3
# The example apps (opt_tpu_torch/examples/), each in-process at its full
# (non --small) configuration, in a working directory of its own under
# EXAMPLES_DIR (git-ignored) with --results inside it; EXAMPLE_CUTS caps an
# app's (numIter, nonLinearIter), each cut printed on the app's line
EXAMPLE_APPS = ("minimal", "curve_fitting", "poisson_image_editing", "image_warping",
                "intrinsic_image_decomposition", "shape_from_shading", "optical_flow",
                "volumetric_mesh_deformation", "arap_mesh_deformation",
                "cotangent_mesh_smoothing", "embedded_mesh_deformation",
                "robust_nonrigid_alignment")
EXAMPLE_CUTS = {"image_warping": (3, 8), "shape_from_shading": (1, 10),
                "volumetric_mesh_deformation": (1, 8), "arap_mesh_deformation": (3, 20),
                "embedded_mesh_deformation": (4, 5), "robust_nonrigid_alignment": (3, 10)}
# The apps whose first solve is not held to end at or below its initial
# cost, and why: optical_flow's coarsest level (16x16, GN 1x50 from a zero
# flow) rises from 11.44 to 137.8 in both packages (the JAX package's
# float64 solve: 137.84); its undamped GN step overshoots where its CG runs
# past about 15 iterations (ROADMAP.md queue 3)
EXAMPLE_RISES = {"optical_flow": "undamped GN 1x50 on the coarsest level overshoots"}
EXAMPLES_DIR = os.path.join("build", "examples")
ENTRY_RANKS = 4  # dryrun_multichip's gloo ranks, all on the one card


def log(msg):
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bench_poisson_inputs(n, seed=0, m=None):
    """bench.py::bench_poisson's inputs: RandomState(0), a border mask
    (``seed``: another draw of X and T); on an n x m grid where `m` is
    given."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    m = n if m is None else m
    mask = np.ones((n, m), f32)
    mask[n // 8 : -n // 8, m // 8 : -m // 8] = 0.0
    return {"X": rng.rand(n, m, 4).astype(f32), "T": rng.rand(n, m, 4).astype(f32), "M": mask}


def laplacian_inputs(n):
    rng = np.random.RandomState(0)
    return {"X": rng.rand(n, n).astype(np.float32), "A": rng.rand(n, n).astype(np.float32)}


def batched_curve_inputs(B, N):
    """bench.py::bench_batched_curve_fitting's inputs: B truths drawn in
    [80, 120]^2, noise-free data y = a cos(bx) + b sin(ax) on N points of
    [0, 1], starts 0.05 from the truths. Returns (truths [B, 2], inputs)."""
    rng = np.random.RandomState(0)
    x = np.linspace(0, 1, N)
    truths = rng.uniform(80, 120, (B, 2))
    data = np.stack([np.stack([x, a * np.cos(b * x) + b * np.sin(a * x)], -1)
                     for a, b in truths]).astype(np.float32)
    init = (truths + rng.randn(B, 2) * 0.05).astype(np.float32)
    return truths, {"funcParams": init[:, None, :], "data": data,
                    "G": {"d": np.arange(N, dtype=np.int32), "p": np.zeros(N, np.int32)}}


def batched_poisson_inputs(n, B):
    """B instances of bench_poisson's problem: instance k draws X and T from
    RandomState(k) (instance 0 is the bench's input); the border mask is
    shared (unbatched)."""
    ins = [bench_poisson_inputs(n, seed=k) for k in range(B)]
    return {"X": np.stack([i["X"] for i in ins]), "T": np.stack([i["T"] for i in ins]),
            "M": ins[0]["M"]}


def laplacian_batch_inputs(n, B):
    rng = np.random.RandomState(1)
    return {"X": rng.rand(B, n, n).astype(np.float32), "A": rng.rand(B, n, n).astype(np.float32)}


def warp_like_spec(S):
    """tests/test_scheduled.py's spec: a 2-channel unknown pulled to the
    constraint image where it is valid, with a smoothness term."""
    W, H = S.Dim("W"), S.Dim("H")
    X = S.Unknown("X", 2, (W, H))
    C = S.Array("C", 2, (W, H))
    valid = ot.greatereq(C(0, 0), -999999.9)
    S.Energy(ot.Select(valid, 2.0 * (X(0, 0) - C(0, 0)), 0.0))
    S.Energy(X(0, 0) - X(1, 0), X(0, 0) - X(0, 1))


def sched_inputs(n):
    """tests/test_scheduled.py::_data at n x n: a random start and two
    constraint images, three pinned points moved between them."""
    rng = np.random.RandomState(2)
    x0 = rng.rand(n, n, 2).astype(np.float32)
    c0 = np.full((n, n, 2), -1e6, np.float32)
    c1 = np.full((n, n, 2), -1e6, np.float32)
    for (i, j) in [(2, 3), (n - 3, n - 2), (5, 9)]:
        c0[i, j] = x0[i, j]
        c1[i, j] = x0[i, j] + [0.8, -0.4]
    return x0, c0, c1


def bench_image_warping_inputs(n, m=None):
    """bench.py::bench_image_warping's inputs: RandomState(0), 16 fit
    constraints, w_fitSqrt = sqrt(100), w_regSqrt = sqrt(0.01); on an
    n x m grid where `m` is given."""
    rng = np.random.RandomState(0)
    f32 = np.float32
    mm = n if m is None else m
    ur = np.stack(np.meshgrid(np.arange(n), np.arange(mm), indexing="ij"), -1).astype(f32)
    con = -np.ones((n, mm, 2), f32)
    for _ in range(16):
        i, j = rng.randint(0, n, 2) if m is None else (rng.randint(0, n), rng.randint(0, m))
        con[i, j] = [i + rng.randn() * 3, j + rng.randn() * 3]
    return {
        "Offset": ur.copy(), "Angle": np.zeros((n, mm), f32), "UrShape": ur,
        "Constraints": con, "Mask": np.zeros((n, mm), f32),
        "w_fitSqrt": np.sqrt(100.0).astype(f32), "w_regSqrt": np.sqrt(0.01).astype(f32),
    }


def medium_inputs():
    """tests/test_specs.py::_cases draw order at N_GRID=32, N_VERT=200, for
    the specs in MEDIUM_GOLDENS and the three graph specs held beside them:
    name -> (dims, inputs)."""
    rng = np.random.RandomState(0)
    n, N, f32 = 32, 200, np.float32
    pos3 = rng.rand(N, 3).astype(f32)
    lap = {"X": rng.rand(n, n).astype(f32), "A": rng.rand(n, n).astype(f32)}
    v0 = np.arange(N, dtype=np.int32)
    cf = {
        "funcParams": np.array([[99.5, 102.5]], f32),
        "data": np.stack([rng.rand(N) * 0.1, rng.rand(N)], -1).astype(f32),
        "G": {"d": v0, "p": np.zeros(N, np.int32)},
    }
    poi = {
        "X": rng.rand(n, n, 4).astype(f32), "T": rng.rand(n, n, 4).astype(f32),
        "M": (rng.rand(n, n) > 0.5).astype(f32),
    }
    iw = {
        "Offset": rng.rand(n, n, 2).astype(f32), "Angle": np.zeros((n, n), f32),
        "UrShape": rng.rand(n, n, 2).astype(f32),
        "Constraints": -np.ones((n, n, 2), f32), "Mask": np.zeros((n, n), f32),
        "w_fitSqrt": 3.16, "w_regSqrt": 1.0,
    }
    flow = {
        "X": np.zeros((n, n, 2), f32), "I": rng.rand(n, n).astype(f32),
        "I_hat": rng.rand(n, n).astype(f32), "I_hat_dx": rng.rand(n, n).astype(f32) * 0.1,
        "I_hat_dy": rng.rand(n, n).astype(f32) * 0.1, "w_fit": 10.0, "w_reg": 1.0,
    }
    intr = {
        "r": rng.rand(n, n, 3).astype(f32), "i": rng.rand(n, n, 3).astype(f32),
        "s": rng.rand(n, n).astype(f32), "w_fitSqrt": 3.0, "w_regSqrtAlbedo": 1.0,
        "w_regSqrtShading": 1.0, "pNorm": 0.8,
    }
    vol = {
        "Offset": rng.rand(6, 6, 6, 3).astype(f32), "Angle": np.zeros((6, 6, 6, 3), f32),
        "UrShape": rng.rand(6, 6, 6, 3).astype(f32),
        "Constraints": -np.ones((6, 6, 6, 3), f32), "w_fitSqrt": 3.0, "w_regSqrt": 1.0,
    }
    sfs = {
        "X": (rng.rand(n, n) + 1).astype(f32), "D_i": (rng.rand(n, n) + 1).astype(f32),
        "Im": rng.rand(n, n).astype(f32), "edgeMaskR": np.ones((n, n), f32),
        "edgeMaskC": np.ones((n, n), f32), "w_p": 1.0, "w_s": 1.0, "w_g": 1.0, "f_x": 10.0,
        "f_y": 10.0, "u_x": n / 2, "u_y": n / 2, **{f"L_{i}": 0.1 for i in range(1, 10)},
    }
    con3 = -np.ones((N, 3), f32)
    con3[0] = [0.5, 0.5, 0.5]
    ring = {"v0": v0, "v1": (v0 + 1) % N}
    cot = {"X": pos3.copy(), "A": pos3,
           "G": dict(ring, v2=(v0 + 2) % N, v3=(v0 + 3) % N), "w_fit": 1.0, "w_reg": 0.5}
    emb = {"Offset": pos3.copy(), "RotMatrix": np.tile(np.eye(3, dtype=f32).ravel(), (N, 1)),
           "UrShape": pos3, "Constraints": con3, "G": ring, "w_fitSqrt": 3.0,
           "w_regSqrt": 1.0, "w_rotSqrt": 1.0}
    rob = {"Offset": pos3.copy(), "Angle": np.zeros((N, 3), f32),
           "RobustWeights": np.ones((N,), f32), "UrShape": pos3, "Constraints": con3,
           "ConstraintNormals": np.tile(np.array([0, 0, 1], f32), (N, 1)), "G": ring,
           "w_fitSqrt": 3.0, "w_regSqrt": 1.0}
    grid, mesh = {"W": n, "H": n}, {"N": N}
    return {"laplacian": (grid, lap), "poisson_image_editing": (grid, poi),
            "image_warping": (grid, iw), "curve_fitting": ({"N": N, "U": 1}, cf),
            "volumetric_mesh_deformation": ({"W": 6, "H": 6, "D": 6}, vol),
            "optical_flow": (grid, flow), "intrinsic_image_decomposition": (grid, intr),
            "shape_from_shading": (grid, sfs), "cotangent_mesh_smoothing": (mesh, cot),
            "embedded_mesh_deformation": (mesh, emb), "robust_nonrigid_alignment": (mesh, rob)}


def sfs_inputs(n):
    """bench.py::bench_shape_from_shading's inputs: depths 2 to 2.1, a random
    image, 9 spherical-harmonics coefficients."""
    rng = np.random.RandomState(0)
    f32 = np.float32
    depth = 2.0 + rng.rand(n, n).astype(f32) * 0.1
    return {"X": depth.copy(), "D_i": depth, "Im": rng.rand(n, n).astype(f32),
            "edgeMaskR": np.ones((n, n), f32), "edgeMaskC": np.ones((n, n), f32),
            "w_p": 1.0, "w_s": 10.0, "w_g": 1.0, "f_x": 500.0, "f_y": 500.0,
            "u_x": n / 2.0, "u_y": n / 2.0,
            **{f"L_{i}": (0.5 if i == 1 else 0.1) for i in range(1, 10)}}


def flow_levels(n, levels=2):
    """bench.py::bench_optical_flow's inputs, coarse to fine: a smoothed
    random image and itself translated by (2, 1), central differences of
    the second, each level every other pixel of the next."""
    rng = np.random.RandomState(0)
    f32 = np.float32
    base = rng.rand(n + 8, n + 8).astype(f32)
    base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1) + np.roll(base, -1, 0)
            + np.roll(base, -1, 1)) / 5.0
    pyr = [(base[4 : 4 + n, 4 : 4 + n].copy(), base[6 : 6 + n, 5 : 5 + n].copy())]
    for _ in range(levels - 1):
        a, b = pyr[-1]
        pyr.append((a[::2, ::2].copy(), b[::2, ::2].copy()))
    out = []
    for a, b in pyr[::-1]:
        dx, dy = np.zeros_like(b), np.zeros_like(b)
        dx[1:-1, :] = 0.5 * (b[2:, :] - b[:-2, :])
        dy[:, 1:-1] = 0.5 * (b[:, 2:] - b[:, :-2])
        out.append({"X": np.zeros(a.shape + (2,), f32), "I": a, "I_hat": b, "I_hat_dx": dx,
                    "I_hat_dy": dy, "w_fit": 10.0, "w_reg": 0.1})
    return out


def intrinsic_inputs(n):
    """bench.py::bench_intrinsic's inputs: a random image's log, log-space
    albedo and shading guesses, the 0.8-norm."""
    rng = np.random.RandomState(0)
    f32 = np.float32
    im = rng.rand(n, n, 3).astype(f32) * 0.8 + 0.1
    return {"r": np.log(im * 0.5 + 0.25).astype(f32), "i": np.log(im).astype(f32),
            "s": np.log(im.mean(-1) + 0.25).astype(f32), "w_fitSqrt": 3.0,
            "w_regSqrtAlbedo": 1.0, "w_regSqrtShading": 1.0, "pNorm": 0.8}


def _shape3(shape):
    """A 3-D grid's extents: an int is a cube."""
    return (shape,) * 3 if isinstance(shape, int) else tuple(shape)


def volumetric_inputs(shape):
    """bench.py::bench_volumetric's inputs: a grid of `shape` (an int: a
    cube), every point's fit target (-1, -1, -1) but for one corner pinned
    and the opposite one pulled by (4, 0, 2), w_fitSqrt = 2, w_regSqrt = 1."""
    f32 = np.float32
    shape = _shape3(shape)
    pos = np.stack(np.meshgrid(*(np.arange(k) for k in shape), indexing="ij"), -1).astype(f32)
    con = -np.ones(shape + (3,), f32)
    con[0, 0, 0] = pos[0, 0, 0]
    con[-1, -1, -1] = pos[-1, -1, -1] + np.array([4.0, 0, 2.0], f32)
    return {"Offset": pos.copy(), "Angle": np.zeros(shape + (3,), f32), "UrShape": pos,
            "Constraints": con, "w_fitSqrt": np.sqrt(4.0).astype(f32),
            "w_regSqrt": np.sqrt(1.0).astype(f32)}


def _vol(shape):
    return dict(zip("WHD", _shape3(shape)))


def arap_grid_inputs(n_side, cols=None):
    """bench.py::bench_arap_graph's inputs: an n_side^2-vertex grid mesh
    (n_side x cols with `cols`), numbered row-major, both edge directions,
    one corner pinned and the other pulled by (10, 0, 5), w_fitSqrt = 1,
    w_regSqrt = sqrt(0.5)."""
    cols = n_side if cols is None else cols
    N = n_side * cols
    f32 = np.float32
    ii, jj = np.meshgrid(np.arange(n_side), np.arange(cols), indexing="ij")
    pos = np.stack([ii.ravel(), jj.ravel(), np.zeros(N)], -1).astype(f32)
    vid = np.arange(N).reshape(n_side, cols)
    v0 = np.concatenate([vid[:-1].ravel(), vid[:, :-1].ravel()])
    v1 = np.concatenate([vid[1:].ravel(), vid[:, 1:].ravel()])
    con = -np.ones((N, 3), f32)
    con[vid[0, 0]] = pos[vid[0, 0]]
    con[vid[-1, -1]] = pos[vid[-1, -1]] + np.array([10.0, 0, 5.0], f32)
    return {"N": N}, {
        "Offset": pos.copy(), "Angle": np.zeros((N, 3), f32), "UrShape": pos,
        "Constraints": con,
        "G": {"v0": np.concatenate([v0, v1]).astype(np.int32),
              "v1": np.concatenate([v1, v0]).astype(np.int32)},
        "w_fitSqrt": np.sqrt(1.0).astype(f32), "w_regSqrt": np.sqrt(0.5).astype(f32),
    }


def armadillo_inputs():
    """bench.py::bench_arap_irregular's inputs: the armadillo mesh renumbered
    by grid_embed_order, the lowest 1% of vertices by z pinned, the highest
    1% pulled up by a fifth of the height."""
    f32 = np.float32
    d = np.load(ARMADILLO)
    verts, v0, v1 = d["verts"].astype(f32), d["v0"].astype(np.int32), d["v1"].astype(np.int32)
    N = verts.shape[0]
    perm = grid_embed_order(v0, v1, N)
    pos = permute_vertices(perm, verts)
    v0r, v1r = remap_edges(perm, v0, v1)
    con = -np.ones((N, 3), f32)
    z = pos[:, 2]
    lo = z <= np.quantile(z, 0.01)
    hi = z >= np.quantile(z, 0.99)
    con[lo] = pos[lo]
    con[hi] = pos[hi] + np.array([0.0, 0.0, 0.2 * (z.max() - z.min())], f32)
    return {"N": N}, {
        "Offset": pos.copy(), "Angle": np.zeros((N, 3), f32), "UrShape": pos,
        "Constraints": con, "G": {"v0": v0r, "v1": v1r},
        "w_fitSqrt": np.sqrt(1.0).astype(f32), "w_regSqrt": np.sqrt(0.5).astype(f32),
    }


def armadillo_batch_inputs():
    """The armadillo posed to len(ARM_BATCH_PULLS) handle targets: instance
    k pulls the highest 1% of vertices up by ARM_BATCH_PULLS[k] of the
    height (instance 0 is armadillo_inputs'); Offset and Constraints are
    batched, the graph and the rest shared."""
    dims, base = armadillo_inputs()
    pos = base["UrShape"]
    z = pos[:, 2]
    hi = z >= np.quantile(z, 0.99)
    cons = []
    for pull in ARM_BATCH_PULLS:
        con = base["Constraints"].copy()
        con[hi] = pos[hi] + np.array([0.0, 0.0, pull * (z.max() - z.min())], np.float32)
        cons.append(con)
    B = len(ARM_BATCH_PULLS)
    return dims, dict(base, Offset=np.stack([pos] * B), Constraints=np.stack(cons))


def iw_batch_inputs(n, B, m=None):
    """B image_warping instances: instance 0 bench_image_warping_inputs(n, m),
    instance k its constraint targets moved by one offset drawn from
    RandomState(k) (in [-2, 2]^2, kept >= 0 so that every constraint stays
    valid); Constraints batched, the rest shared."""
    base = bench_image_warping_inputs(n, m)
    con0 = base["Constraints"]
    valid = (con0 >= 0).all(-1)
    cons = [con0]
    for k in range(1, B):
        con = con0.copy()
        con[valid] = np.maximum(con0[valid] + np.random.RandomState(k).uniform(-2, 2, 2), 0.0)
        cons.append(con.astype(np.float32))
    return dict(base, Constraints=np.stack(cons))


def random_mesh_inputs(N, B, seed=3):
    """B deformations of one random irregular mesh (tests/test_torch_graph.py's
    random_mesh: a ring with N // 2 random chords, both edge directions,
    under a random numbering, so that no vertex-id offset covers its reads
    and the operator is all remainder; 4 vertices pinned), each with its
    own Offset and Angle, so that each system's blocks are its own."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    ring0 = np.arange(N)
    a = rng.randint(0, N, N // 2)
    b = (a + rng.randint(2, N - 1, N // 2)) % N
    v0 = np.concatenate([ring0, a])
    v1 = np.concatenate([(ring0 + 1) % N, b])
    perm = rng.permutation(N)
    v0, v1 = perm[v0], perm[v1]
    pos = rng.rand(N, 3).astype(f32)
    con = -np.ones((N, 3), f32)
    pinned = rng.choice(N, 4, replace=False)
    con[pinned] = pos[pinned] + rng.rand(4, 3).astype(f32)
    return {"N": N}, {
        "Offset": (pos + 0.05 * rng.rand(B, N, 3)).astype(f32),
        "Angle": (0.2 * rng.randn(B, N, 3)).astype(f32), "UrShape": pos, "Constraints": con,
        "G": {"v0": np.concatenate([v0, v1]).astype(np.int32),
              "v1": np.concatenate([v1, v0]).astype(np.int32)},
        "w_fitSqrt": np.sqrt(1.0).astype(f32), "w_regSqrt": np.sqrt(0.5).astype(f32),
    }


def dense_grid_mesh_inputs(n_side):
    """tests/test_torch_graph.py::dense_grid_mesh at `n_side`: a grid mesh
    numbered row-major with seven edge directions, both ways, whose reads
    sit at fourteen vertex-id offsets (±1, ±2, ±n-1, ±n, ±n+1, ±2n, ±2n+1),
    one more than the kernel's triple table holds at six channels: thirteen
    become DIA offsets and the fourteenth's reads the remainder."""
    f32 = np.float32
    N = n_side * n_side
    ii, jj = np.meshgrid(np.arange(n_side), np.arange(n_side), indexing="ij")
    pos = np.stack([ii.ravel(), jj.ravel(), np.zeros(N)], -1).astype(f32)
    vid = np.arange(N).reshape(n_side, n_side)
    v0, v1 = [], []
    for a, b in ((0, 1), (1, 0), (1, 1), (1, -1), (0, 2), (2, 0), (2, 1)):
        ok = (ii + a < n_side) & (jj + b >= 0) & (jj + b < n_side)
        v0.append(vid[ii[ok], jj[ok]])
        v1.append(vid[ii[ok] + a, jj[ok] + b])
    v0, v1 = np.concatenate(v0), np.concatenate(v1)
    con = -np.ones((N, 3), f32)
    con[0] = pos[0]
    con[-1] = pos[-1] + np.array([3.0, 0.0, 2.0], f32)
    return {"N": N}, {
        "Offset": pos.copy(), "Angle": np.zeros((N, 3), f32), "UrShape": pos,
        "Constraints": con,
        "G": {"v0": np.concatenate([v0, v1]).astype(np.int32),
              "v1": np.concatenate([v1, v0]).astype(np.int32)},
        "w_fitSqrt": np.float32(1.0), "w_regSqrt": np.float32(np.sqrt(0.5)),
    }


def grid_mesh(n_side):
    """bench.py::_grid_mesh: an n_side^2-vertex grid mesh numbered
    row-major, both edge directions: (N, v0, v1, vertex ids [n, n])."""
    N = n_side * n_side
    vid = np.arange(N).reshape(n_side, n_side)
    v0 = np.concatenate([vid[:-1].ravel(), vid[:, :-1].ravel()])
    v1 = np.concatenate([vid[1:].ravel(), vid[:, 1:].ravel()])
    return (N, np.concatenate([v0, v1]).astype(np.int32),
            np.concatenate([v1, v0]).astype(np.int32), vid)


def cotangent_inputs(n_side):
    """bench.py::bench_cotangent's inputs: a rippled grid mesh with seeded
    noise, each edge's opposite vertices its neighbours in the edge list
    (np.roll), w_fit 1, w_reg 0.5."""
    N, v0, v1, _vid = grid_mesh(n_side)
    rng = np.random.RandomState(0)
    ii, jj = np.meshgrid(np.arange(n_side), np.arange(n_side), indexing="ij")
    pos = np.stack([ii.ravel(), jj.ravel(), np.sin(ii.ravel() * 0.2) * 2.0],
                   -1).astype(np.float32)
    pos += rng.randn(N, 3).astype(np.float32) * 0.05
    return {"N": N}, {"X": pos.copy(), "A": pos,
                      "G": {"v0": v0, "v1": v1, "v2": np.roll(v0, 1), "v3": np.roll(v1, 1)},
                      "w_fit": 1.0, "w_reg": 0.5}


def embedded_inputs(n_side):
    """bench.py::bench_embedded's inputs: a flat grid mesh, one corner pinned
    and the other pulled by (6, 0, 3), identity rotations, w_fitSqrt 2,
    w_regSqrt and w_rotSqrt 1."""
    N, v0, v1, vid = grid_mesh(n_side)
    f32 = np.float32
    ii, jj = np.meshgrid(np.arange(n_side), np.arange(n_side), indexing="ij")
    pos = np.stack([ii.ravel(), jj.ravel(), np.zeros(N)], -1).astype(f32)
    con = -np.ones((N, 3), f32)
    con[vid[0, 0]] = pos[vid[0, 0]]
    con[vid[-1, -1]] = pos[vid[-1, -1]] + np.array([6.0, 0, 3.0], f32)
    return {"N": N}, {
        "Offset": pos.copy(), "RotMatrix": np.tile(np.eye(3, dtype=f32).ravel(), (N, 1)),
        "UrShape": pos, "Constraints": con, "G": {"v0": v0, "v1": v1},
        "w_fitSqrt": np.sqrt(4.0).astype(f32), "w_regSqrt": np.sqrt(1.0).astype(f32),
        "w_rotSqrt": np.sqrt(1.0).astype(f32)}


def robust_inputs(n_side):
    """bench.py::bench_robust_nonrigid's inputs: a rippled grid mesh warped
    towards its targets, 30% of them unconstrained, seeded unit normals,
    w_fitSqrt sqrt(10), w_regSqrt 2."""
    N, v0, v1, _vid = grid_mesh(n_side)
    f32 = np.float32
    rng = np.random.RandomState(0)
    ii, jj = np.meshgrid(np.arange(n_side), np.arange(n_side), indexing="ij")
    pos = np.stack([ii.ravel(), jj.ravel(), np.sin(ii.ravel() * 0.1)], -1).astype(f32)
    warp = np.stack([0.4 * np.sin(jj.ravel() * 0.05), 0.2 * np.cos(ii.ravel() * 0.07),
                     0.1 * np.ones(N)], -1).astype(f32)
    targets = pos + warp
    targets[rng.rand(N) > 0.7] = -1e6  # unconstrained vertices
    normals = rng.randn(N, 3).astype(f32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    return {"N": N}, {
        "Offset": pos.copy(), "Angle": np.zeros((N, 3), f32),
        "RobustWeights": np.ones((N,), f32), "UrShape": pos, "Constraints": targets,
        "ConstraintNormals": normals, "G": {"v0": v0, "v1": v1},
        "w_fitSqrt": np.sqrt(10.0).astype(f32), "w_regSqrt": np.sqrt(4.0).astype(f32)}


# bench.py's three other graph benchmarks (bench_cotangent, bench_embedded,
# bench_robust_nonrigid): spec, solver, inputs, nIterations, lIterations,
# the graph kernel's instance their steps launch and its layout (cotangent
# C = 3 and embedded C = 12 with the remainder, the fields staged;
# robust_nonrigid C = 7, its graph group covering 6 of them, DIA only, the
# fields streamed)
GRAPH_SPECS = {
    "cotangent10k": (cotangent_mesh_smoothing, "LMGPU", cotangent_inputs, 8, 40, "lm_rem_tiled",
                     "resident"),
    "embedded10k": (embedded_mesh_deformation, "LMGPU", embedded_inputs, 8, 40, "lm_rem_tiled",
                    "resident"),
    "robust10k": (robust_nonrigid_alignment, "gaussNewtonGPU", robust_inputs, 8, 50,
                  "gn_dia_tiled", "stream"),
}


def cluster_arap_spec(dsl):
    """ARAP with rotation clusters (Jacobson et al., "Fast Automatic
    Skinning Transformations", 2012), written against the DSL module
    ``dsl``: a 2-D Offset on the N vertices, one Angle a cluster on the P
    clusters, the regulariser over G(v0, v1, r) with r the cluster of v0,
    and a fit over H(c), some of the vertices. Its graph G couples unknowns
    on two vertex spaces (Offset on N, Angle on P), so the assembled operator
    carries per-pair ELL blocks and no CG kernel takes it."""
    def cluster_arap(S):
        N, P = S.Dim("N"), S.Dim("P")
        w_fitSqrt = S.Param("w_fitSqrt")
        w_regSqrt = S.Param("w_regSqrt")
        Offset = S.Unknown("Offset", 2, (N,))
        Angle = S.Unknown("Angle", 1, (P,))
        UrShape = S.Array("UrShape", 2, (N,))
        Constraints = S.Array("Constraints", 2, (N,))
        G = S.Graph("G", v0=(N,), v1=(N,), r=(P,))
        H = S.Graph("H", c=(N,))
        S.UsePreconditioner(True)
        e_fit = Offset(H.c) - Constraints(H.c)
        valid = dsl.greatereq(Constraints(H.c)[..., 0:1], -999999.9)
        S.Energy(dsl.Select(valid, w_fitSqrt * e_fit, 0.0))
        arap = (Offset(G.v0) - Offset(G.v1)) - dsl.Rotate2D(
            Angle(G.r), UrShape(G.v0) - UrShape(G.v1))
        S.Energy(w_regSqrt * arap)

    return cluster_arap


def cluster_arap_inputs(n_side, cluster, fit_share=CLUSTER_FIT_SHARE, seed=0):
    """arap_grid_inputs(n_side) in 2-D for cluster_arap_spec: the grid mesh's
    edges as G's (v0, v1), r the cluster of v0 (square clusters of
    cluster x cluster vertices, numbered row-major), the x and y of its
    rest positions and constraints (one corner pinned, the other pulled by
    (10, 0)), zero angles; H's c the two corners and a seeded `fit_share`
    of the vertices."""
    dims, g = arap_grid_inputs(n_side)
    N = dims["N"]
    per = n_side // cluster
    v0 = g["G"]["v0"]
    r = ((v0 // n_side) // cluster) * per + (v0 % n_side) // cluster
    c = np.union1d([0, N - 1], np.random.RandomState(seed).choice(
        N, max(1, int(round(fit_share * N))), replace=False)).astype(np.int32)
    f32 = np.float32
    return {"N": N, "P": per * per}, {
        "Offset": g["Offset"][:, :2].copy(), "Angle": np.zeros((per * per, 1), f32),
        "UrShape": g["UrShape"][:, :2].copy(), "Constraints": g["Constraints"][:, :2].copy(),
        "G": {"v0": v0, "v1": g["G"]["v1"], "r": r.astype(np.int32)}, "H": {"c": c},
        "w_fitSqrt": g["w_fitSqrt"], "w_regSqrt": g["w_regSqrt"]}


def dynamic_topologies(inputs, drops=DYN_DROPS, seed=0):
    """The inputs of a mesh given as both directions of each edge (v0, v1
    then v1, v0: arap_grid_inputs) with each share in `drops` of its edge
    pairs dropped, the pairs chosen by a seeded permutation."""
    g = inputs["G"]
    P = g["v0"].shape[0] // 2
    out = []
    for k, drop in enumerate(drops):
        keep = np.sort(np.random.RandomState(seed + k).permutation(P)[int(round(drop * P)):])
        keep = np.concatenate([keep, keep + P])
        out.append(dict(inputs, G={"v0": g["v0"][keep], "v1": g["v1"][keep]}))
    return out


def instance_inputs(inputs, batched, k):
    """Instance k of a batch's inputs: the `batched` names sliced."""
    return {name: v[k] if name in batched else v for name, v in inputs.items()}


def _grid(n):
    return {"W": n, "H": n}


def system(spec, dims, inputs, kind="gaussNewtonGPU", **ip):
    """The first step's system under InitializationParameters(**ip), as the
    solver hands it to the kernel, with an LM step's real damping: (meta,
    b, pre, LM keywords with the packed ctc or None, variant keywords: cs
    and the packed pre_blocks)."""
    plan = ot.Problem(spec, kind=kind).plan(dims=dims,
                                           init_params=ot.InitializationParameters(**ip))
    meta, r0, pre, kw = plan.cg_inputs(inputs)
    if meta is None or plan.fused_fallback is not None:
        raise RuntimeError(f"{spec.__name__} {dims} {ip}: no fused CG meta ({plan.fused_fallback})")
    lm = None
    if kind == "LMGPU":
        lm = dict(ctc=fused_cg.pack(kw["ctc"], meta), reset_period=kw["reset_period"])
    pb = kw["pre_blocks"]
    variant = dict(cs=kw["cg_variant"] == "chronopoulos_gear",
                   pre_blocks=None if pb is None else fused_cg.pack_pre_blocks(pb, meta))
    return meta, fused_cg.pack(r0, meta), fused_cg.pack(pre, meta), lm, variant


def batched_system(spec, dims, inputs, kind="gaussNewtonGPU", **ip):
    """The first step's systems of a batch (``Plan.batched_cg_inputs``)
    under InitializationParameters(**ip), packed as ``system`` packs one:
    (batched meta, b [B, C, *dom], pre, LM keywords or None, variant
    keywords)."""
    plan = ot.Problem(spec, kind=kind).plan(dims=dims,
                                           init_params=ot.InitializationParameters(**ip))
    meta, r0, pre, kw = plan.batched_cg_inputs(inputs)
    if meta is None or plan.fused_fallback is not None:
        raise RuntimeError(f"{spec.__name__} {dims} {ip}: no batched fused CG meta")
    lm = None
    if kind == "LMGPU":
        lm = dict(ctc=fused_cg.pack(kw["ctc"], meta), reset_period=kw["reset_period"])
    pb = kw["pre_blocks"]
    return (meta, fused_cg.pack(r0, meta), fused_cg.pack(pre, meta), lm,
            dict(cs=kw["cg_variant"] == "chronopoulos_gear",
                 pre_blocks=None if pb is None else fused_cg.pack_pre_blocks(pb, meta)))


def n_systems(meta):
    """The independent systems a launch on this meta holds: its instances
    under a batch, its channels under the per-channel split, else 1."""
    if meta.get("batch"):
        return int(meta["batch"])
    return int(meta["ctot"]) if meta.get("chan_grid") else 1


def twin_kw(meta):
    """The twin's keywords that lay out this meta's systems."""
    return dict(rem=meta["rem"], n_sys=n_systems(meta), batched=bool(meta.get("batch")))


def form_of(meta, b, lm=None, cs=False, pre_blocks=None, template=False):
    """The kernel instance a call with these operands launches (with
    `template`: the template's, which template_grid_cg_kernel launches)."""
    with template_route() if template else contextlib.nullcontext():
        return fused_cg.launch_instance(meta, b, lm=bool(lm), cs=bool(cs), pre_blocks=pre_blocks)


def tiled_line(label, meta, b, lm=None, pre_blocks=None, cs=False):
    """The tiled route's plan of a system (of each system of a batch or a
    split), printed: tiles, halo, threads and shared memory a block, a
    system's channels, the layout ("resident", or "hbm": δ and Ap in device
    memory); raises where the system does not take it."""
    plan = fused_cg.route_plan(meta, b, lm=bool(lm), cs=cs, pre_blocks=pre_blocks)
    if plan is None:
        raise RuntimeError(f"{label}: does not take the tiled kernel")
    lead = 1 if meta.get("batch") else 0
    log(json.dumps({"tiled_plan": label,
                    "form": form_of(meta, b, lm, cs=cs, pre_blocks=pre_blocks),
                    "systems": n_systems(meta), "grid": list(b.shape[lead + 1:]),
                    "channels": 1 if meta.get("chan_grid") else int(b.shape[lead]),
                    "triples": len(meta["triples"]), "tiles": list(plan["tiles"]), "tile": list(plan["tile"]),
                    "halo": plan["halo"], "threads": plan["threads"],
                    "smem_bytes": plan["smem_bytes"], "layout": plan["layout"]}))
    return plan


def graph_plan_line(label, meta, b, lm=None):
    """The graph route's plan of a system (of each system of a batch),
    printed: vertex ranges, the largest range, halo, frame and entry span,
    threads and shared memory a block, the layout ("resident": the fields
    staged; "stream": read from device memory, a graph without the
    remainder); raises where the system does not take it."""
    plan = fused_cg.route_plan(meta, b, lm=bool(lm))
    if plan is None or "partition" not in plan:
        raise RuntimeError(f"{label}: does not take the graph kernel")
    lead = 1 if meta.get("batch") else 0
    rem = meta.get("rem")
    log(json.dumps({"graph_plan": label, "form": form_of(meta, b, lm),
                    "systems": n_systems(meta), "vertices": int(b.shape[-1]),
                    "channels": int(b.shape[lead]), "triples": len(meta["triples"]),
                    "fields": int(meta["F"].shape[lead]),
                    "remainder_entries": 0 if rem is None else int(rem["col"].shape[0]),
                    "ranges": plan["blocks"], "max_range": plan["max_range"],
                    "max_halo": plan["max_halo"], "max_frame": plan["max_frame"],
                    "max_entry_span": plan["max_entries"], "threads": plan["threads"],
                    "smem_bytes": plan["smem_bytes"], "layout": plan["layout"]}))
    return plan


def vol_plan_line(label, meta, b, pre_blocks=None, plan=None):
    """The 3-D grid kernel's plan of a system, printed: boxes, box, halo,
    threads and shared memory a block, channels, fields, the layout
    ("vol"); raises where the system does not take it. ``plan``: a forced
    plan, printed as such."""
    forced = plan is not None
    plan = plan or fused_cg.route_plan(meta, b, lm=False, pre_blocks=pre_blocks)
    if plan is None or plan.get("layout") != "vol":
        raise RuntimeError(f"{label}: does not take the 3-D grid kernel")
    log(json.dumps({"vol_plan": label, "form": form_of(meta, b, pre_blocks=pre_blocks),
                    "grid": list(b.shape[1:]), "channels": int(b.shape[0]),
                    "fields": int(meta["F"].shape[0]), "triples": len(meta["triples"]),
                    "boxes": list(plan["boxes"]), "box": list(plan["box"]),
                    "halo": plan["halo"], "threads": plan["threads"],
                    "smem_bytes": plan["smem_bytes"], "layout": plan["layout"],
                    "forced": forced}))
    return plan


def batch_plan_line(label, system):
    """The batch kernel's plan of a batched system, printed: lanes a
    system, systems a block, blocks, shared memory a block; raises where
    the system does not take it."""
    meta, b, _pre, lm, variant = system
    plan = fused_cg.route_plan(meta, b, lm=bool(lm), **variant)
    if plan is None or plan.get("layout") != "batch":
        raise RuntimeError(f"{label}: does not take the batch kernel ({plan})")
    log(json.dumps({"batch_plan": label, "form": form_of(meta, b, lm, **variant),
                    "systems": n_systems(meta), "elements": int(b[0].numel()),
                    "fields": int(meta["F"].shape[1]), **plan}))
    return plan


def forced_vol_plan(meta, b, boxes, pre_blocks=None):
    """A 3-D grid kernel's plan of this system with the split `boxes`
    (fused_cg.box_plan at the planner's halo, its shared memory counted for
    them)."""
    h = fused_cg.route_plan(meta, b, lm=False, pre_blocks=pre_blocks)["halo"]
    return fused_cg.box_plan(b.shape[1:], boxes, h, meta, int(b.shape[0]),
                             block=pre_blocks is not None)


@contextlib.contextmanager
def forced_route(plan):
    """Send every launch to this plan for the while (fused_cg.route_plan
    replaced): the 3-D grid kernel on a forced split, or with None the
    template (template_route)."""
    saved = fused_cg.route_plan
    fused_cg.route_plan = lambda *a, **k: plan
    try:
        yield
    finally:
        fused_cg.route_plan = saved


def vol_exchange_bytes(plan, dom, C):
    """The bytes the 3-D grid kernel's border exchange moves an iteration:
    each box writes z's shell (its points within h of a face) and reads its
    halo's points inside the grid, C float32 values a point."""
    h, points = plan["halo"], 0
    for bx in fused_cg.box_bounds(plan, *dom):
        ext = [(max(0, lo - h), min(n, hi + h)) for (lo, hi), n in zip(bx, dom)]
        inner = [max(0, hi - lo - 2 * h) for lo, hi in bx]
        size = int(np.prod([hi - lo for lo, hi in bx]))
        points += size - int(np.prod(inner))  # the shell, written
        points += int(np.prod([hi - lo for lo, hi in ext])) - size  # the halo, read
    return 4 * C * points


def template_route():
    """Send every launch to the template for the while, to time a main path
    as it ran before the tiled route."""
    return forced_route(None)


@contextlib.contextmanager
def forced_hbm(meta, b, lm=None):
    """Send a one-system launch on this system to the tiled kernel's hbm
    layout for the while: the card's shared memory a block is seen as just
    the hbm layout's need at the system's tiles, below the resident one's
    (fused_cg.device_limits replaced), so that the layout's instances run
    at shapes whose state would fit (tiles ragged, a halo of 2)."""
    sms, smem = fused_cg.device_limits(b.device)
    C, dom = int(b.shape[0]), tuple(b.shape[1:])
    plan = fused_cg.tiled_grid_plan(meta, C, dom, lm=bool(lm), sm_count=sms,
                                    smem_per_block=smem)
    need = fused_cg.tiled_smem_bytes(bool(lm), C, *plan["tile"], plan["halo"],
                                     len(meta["triples"]), hbm=True)
    saved = fused_cg.device_limits
    fused_cg.device_limits = lambda device: (sms, need)
    try:
        yield
    finally:
        fused_cg.device_limits = saved


def hbm_frame_bytes(shape, iters):
    """What the hbm layout moves beside the inputs in `iters` iterations of
    one system: δ read and written, Ap written and read back, and pre read
    once more (z formed again), 4 bytes each at every point of every
    channel (an LM reset's haloed δ not counted)."""
    return iters * 5 * 4 * shape["C"] * shape["plane"]


def meta_shape(meta):
    """cg_work's shape of one system of a fused CG meta: fields, plane (the
    points of its domain), channels (of one system under the split or a
    batch, whose iterations are counted per system), triples, the
    remainder's entries and the bytes of a coefficient."""
    F, rem = meta["F"], meta.get("rem")
    lead = 1 if meta.get("batch") else 0
    C = int(meta["ctot"]) if lead else int(meta["ctot"]) // n_systems(meta)
    return dict(fields=int(F.shape[lead]), plane=int(np.prod(F.shape[lead + 1:])),
                C=C, triples=len(meta["triples"]),
                nnz=0 if rem is None else int(rem["col"].shape[0]),
                f_bytes=int(F.element_size()))


def cg_work(fields, plane, C, triples, nnz=0, *, lm=False, cs=False, f_bytes=4,
            pre_planes=None, vector=None, dots=None, batch=1, iters=1,
            reset_period=RESET_PERIOD, planes_once=0, inputs_once=0):
    """What one launch of `iters` CG iterations on each of `batch` systems
    of this shape must do: (bytes of the launch: each system's fields,
    preconditioner planes (C, or C*C under block-Jacobi), under LM b (which
    Q reads) and ctc, and remainder CSR, whose blocks are coefficients, read
    once an iteration; under GN b read once a launch, to form r0; and the
    triples table, which the systems share and each block copies to shared
    memory once a launch, read once; float32 operations; float64
    operations). Reads of the stencil that leave the grid count as done;
    the remainder counts its real entries. Defaults are the GN and LM
    forms'; `cs` takes Chronopoulos-Gear's vector updates and dots.
    `planes_once` (a count of systems, 0 by default): the preconditioner's
    planes, which stay the same for the whole solve, read once a launch for
    each of that many systems instead of once an iteration: the least a
    kernel that keeps them on chip must read. `inputs_once` (a count of
    systems, 0 by default): so too the fields and LM's b and ctc, which
    also stay the same for the whole solve; only the remainder CSR is then
    read every iteration (a graph's fields fit on chip beside its state: the
    graph kernel stages them once a solve)."""
    n = C * plane
    pre_planes = C if pre_planes is None else pre_planes
    if vector is None:  # dots, updates, z = M^-1 r
        vector = (16 if lm else 13) if cs else (15 if lm else 12)
    dots = (3 if lm else 2) if dots is None else dots  # their float64 sums
    b_bytes = C * plane * 4
    inputs = fields * plane * f_bytes + (2 * b_bytes if lm else 0)  # F; LM's b, ctc
    planes = pre_planes * plane * 4
    once = (inputs_once * (inputs + planes) + planes_once * planes
            + (0 if lm else batch * b_bytes))  # GN's b, for r0
    it_bytes = (0 if inputs_once else inputs) + (0 if inputs_once or planes_once else planes)
    if nnz:
        it_bytes += (plane + 1) * 4 + nnz * 4 + nnz * C * C * f_bytes
    apply = 2 * triples * plane + 2 * nnz * C * C + (2 * n if lm else 0)
    per_iter = apply + vector * n + 2 * (pre_planes - C) * plane
    resets = iters // reset_period if lm else 0
    return (batch * iters * it_bytes + once + triples * 6 * 4,
            batch * (iters * per_iter + resets * apply), batch * iters * dots * n)


def cg_bound(shape, iters, **knobs):
    """(bound ms of a launch of `iters` iterations, "bytes" or
    "operations"): the larger of its bytes over the memory rate and its
    operations over the peak rate of their type."""
    n_bytes, f32, f64 = cg_work(**shape, iters=iters, **knobs)
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = f32 / F32_FLOPS + f64 / F64_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def kernel_vs_twin(label, meta, b, pre, lits, tol, lm=None, q_tol=Q_TOL, bitwise=False,
                   template=False, early=False, **variant):
    """Kernel and twin on the same system (``variant``: cs, pre_blocks).
    tol = 0 (and q_tol = -inf under LM) runs `lits` iterations with no exit
    and holds δ to the twin's; otherwise the real exits, which must give
    equal iteration counts. A split or batched meta runs its systems in the
    one launch: `lits` and the exits are each system's, the counts are held
    system by system and reported summed. A batch of tiny systems may reach
    an exact zero residual before `lits` even with no exit (the loop then
    stops): its counts are held to the twin's, system by system. With
    `template`, the template's instance is held the same way to the same
    twin result, in a second line (a system the tiled route takes). With
    `early`, a system of two unknowns whose loop reaches an exact zero
    residual before `lits` with no exit: its count is held to the twin's."""
    lm_kw = dict(lm, q_tolerance=q_tol) if lm else {}
    n_sys = n_systems(meta)
    trace, counts = [], []
    dr, ir = fused_cg.fused_grid_cg_reference(meta["F"], meta["triples"], b, pre, lits, tol,
                                              trace=None if n_sys > 1 else trace,
                                              counts=counts, **twin_kw(meta), **lm_kw, **variant)
    errs = []
    for tpl in (False, True) if template else (False,):
        t0 = time.perf_counter()
        launch = fused_cg.template_grid_cg_kernel if tpl else fused_cg.fused_grid_cg_kernel
        dk, ik = launch(meta, b, pre, lits, tol, **lm_kw, **variant)
        torch.cuda.synchronize()
        per_system = ik.tolist()
        ik = sum(per_system)
        err = float((dk - dr).abs().max())
        scale = float(dr.abs().max())
        finite = bool(torch.isfinite(dk).all())
        line = {"check": "kernel_vs_twin", "case": label,
                "form": form_of(meta, b, lm, template=tpl, **variant),
                "lits": lits, "tol": tol, "kernel_iters": ik, "twin_iters": ir,
                "max_abs_err": err, "max_abs_delta": scale, "rel_err": err / max(scale, 1e-30),
                "bitwise_equal": bool(torch.equal(dk, dr)), "s": time.perf_counter() - t0}
        if lm:
            line["q_tol"] = q_tol
        if meta.get("batch"):
            line["systems_bitwise_equal"] = sum(bool(torch.equal(dk[k], dr[k]))
                                                for k in range(n_sys))
            line["systems"] = n_sys
        if n_sys > 1:
            if n_sys <= 16:
                line.update(kernel_iters_per_system=per_system, twin_iters_per_system=counts)
            if per_system != counts:
                log(json.dumps(line))
                raise RuntimeError(f"{label}: per-system counts {per_system}, the twin's {counts}")
        if ik != ir:  # the twin's exit quantities where the two counts stop
            line["twin_at_exits"] = [
                {"iter": l, "rz": float(rz), "rz_floor": float(fl),
                 "zeta": None if z is None else float(z), "q_tol": q_tol if lm else None}
                for (l, rz, fl, z) in trace if l in (ik, ir)
            ]
        log(json.dumps(line))
        if not finite:
            raise RuntimeError(f"{label}: kernel delta not finite")
        if bitwise and not line["bitwise_equal"]:
            raise RuntimeError(f"{label}: kernel and twin not bitwise equal ({err})")
        if ik != ir:
            raise RuntimeError(f"{label}: kernel ran {ik} iterations, the twin {ir}")
        no_exit = tol == 0.0 and (not lm or q_tol == float("-inf"))
        if no_exit:
            # Chronopoulos-Gear keeps one exit even so (a step denominator
            # <= 0); every case here but the block-per-system ones, whose tiny
            # systems reach an exact zero residual (their counts are held to
            # the twin's above), runs `lits` iterations without reaching it
            if (ik != lits * n_sys and not line["form"].endswith(("_batch", "_batch_tiled"))
                    and not early):
                raise RuntimeError(f"{label}: iteration counts {ik}/{ir}, "
                                   f"expected {lits * n_sys}")
            if err > DELTA_RTOL * scale:
                raise RuntimeError(f"{label}: max|dδ| {err} > {DELTA_RTOL}·max|δ| {scale}")
        errs.append(err)
    return errs[0]


def bitwise_repeat(label, meta, b, pre, lits, lm=None, **variant):
    lm_kw = dict(lm, q_tolerance=Q_TOL) if lm else {}
    d1, i1 = fused_cg.fused_grid_cg_kernel(meta, b, pre, lits, CG_TOL, **lm_kw, **variant)
    d2, i2 = fused_cg.fused_grid_cg_kernel(meta, b, pre, lits, CG_TOL, **lm_kw, **variant)
    torch.cuda.synchronize()
    same = bool(torch.equal(d1, d2)) and i1.tolist() == i2.tolist()
    log(json.dumps({"check": "bitwise_repeat", "case": label,
                    "form": form_of(meta, b, lm, **variant), "iters": int(i1.sum()),
                    "equal": same}))
    if not same:
        raise RuntimeError(f"{label}: two launches on the same input differ")


def variant_checks(label, system, lits, exit_lits, bitwise=False, template=False,
                   early=False):
    """A variant system's kernel against its twin: `lits` iterations with
    no exit, the real exits with up to `exit_lits`, and a bitwise repeat
    (with `template`, the template's instance is held to the same twin
    results too; `early`: kernel_vs_twin's). Returns the first check's
    max|Δδ|."""
    meta, b, pre, lm, variant = system
    no_exit = dict(q_tol=float("-inf")) if lm else {}
    err = kernel_vs_twin(label, meta, b, pre, lits, 0.0, lm, bitwise=bitwise, template=template,
                         early=early, **no_exit, **variant)
    kernel_vs_twin(label, meta, b, pre, exit_lits, CG_TOL, lm, bitwise=bitwise,
                   template=template, **variant)
    bitwise_repeat(label, meta, b, pre, exit_lits, lm, **variant)
    return err


def main_path(label, spec, kind, dims, inputs, nl, li, want, shapes, form=None, ip=None):
    """One solve through the public API with no device argument and the
    launch counts set to 0 just before it; returns (result, launches by
    instance, plan). ``want``: the JAX package's final cost, or None where
    the caller holds the costs itself; ``ip``: InitializationParameters'
    keywords; ``form``: the instance that must run each step (by default
    "gn" or "lm", or its tiled instance where that is the one launched)."""
    fused_cg.reset_launch_counts()
    plan = ot.Problem(spec, kind=kind).plan(dims=dims,
                                           init_params=ot.InitializationParameters(**(ip or {})))
    res = plan.solve(dict(inputs), nIterations=nl, lIterations=li)
    torch.cuda.synchronize()
    launches = {k: v for k, v in fused_cg.fused_grid_cg_kernel.launches.items() if v}
    if form is None:
        form = "lm" if kind == "LMGPU" else "gn"
        form += "_tiled" if launches.get(form + "_tiled") else ""
    line = {"check": "main_path", "case": label, "form": form, "final_cost": res.final_cost,
            "costs": res.costs, "nonlinear_iters": res.num_iterations,
            "lin_iters": res.num_linear_iterations, "kernel_launches": launches,
            "fused_fallback": plan.fused_fallback, "solve_s": res.wall_time_s}
    if want is not None:
        line.update(jax_cpu_cost=want, rel_diff=abs(res.final_cost - want) / abs(want))
    log(json.dumps(line))
    others = [k for k, v in launches.items() if k != form and v]
    if (launches.get(form) != res.num_iterations or others or res.num_iterations < 1
            or plan.fused_fallback is not None):
        raise RuntimeError(f"{label}: not one {form} kernel launch per nonlinear step "
                           f"({launches} for {res.num_iterations}, fallback {plan.fused_fallback})")
    for u, X in res.unknowns.items():
        if tuple(X.shape) != shapes[u] or not bool(torch.isfinite(X).all()):
            raise RuntimeError(f"{label}: unknown {u} is not finite of shape {shapes[u]}")
    if want is not None and abs(res.final_cost - want) > GOLDEN_RTOL * abs(want):
        raise RuntimeError(f"{label}: final cost {res.final_cost} vs JAX {want}")
    return res, launches, plan


def route_equal(label, res, launches, solve, form):
    """The same solve (``solve()``, a result) on the template route, launch
    counts from 0: its costs and CG counts must equal ``res``'s to the last
    digit, in as many launches of the template's instance (``form`` without
    "_tiled", and "_hbm" in the hbm layout, "_dia" in the graph kernel's
    stream layout, "_vol" on the 3-D grid kernel) as ``res`` made of
    ``form``."""
    fused_cg.reset_launch_counts()
    with template_route():
        tres = solve()
    torch.cuda.synchronize()
    tl = {k: v for k, v in fused_cg.fused_grid_cg_kernel.launches.items() if v}
    # a batch's costs are NaN past each instance's exit: equal there too
    same = bool(np.array_equal(np.asarray(res.costs), np.asarray(tres.costs), equal_nan=True))
    lin = np.asarray(res.num_linear_iterations).tolist()
    tlin = np.asarray(tres.num_linear_iterations).tolist()
    line = {"check": "route_equal", "case": label, "form": form, "launches": launches,
            "template_launches": tl, "costs_equal": same, "lin_iters": lin,
            "template_lin_iters": tlin}
    log(json.dumps(line))
    template_form = (form.removesuffix("_tiled").removesuffix("_hbm").removesuffix("_dia")
                     .removesuffix("_vol"))
    if not same or lin != tlin or tl != {template_form: launches[form]}:
        raise RuntimeError(f"{label}: the tiled route's solve differs from the template's")


def graph_main_path(label, dims, inputs, form):
    """An arap solve (GN 8x100) through the kernel, held as the
    JAX_CPU_GRAPH_COSTS comment says: the first two steps' costs to the JAX
    package's, the whole trajectory to the same solve through the plain
    version on the card; on the graph kernel (a tiled `form`) also cost for
    cost and count for count to the same solve on the template route.
    Returns (result, launches)."""
    N = dims["N"]
    ref = JAX_CPU_GRAPH_COSTS[label]
    res, launches, _plan = main_path(
        f"{label} GN {GRAPH_NL}x{GRAPH_LI}", arap_mesh_deformation, "gaussNewtonGPU", dims,
        inputs, GRAPH_NL, GRAPH_LI, None, {"Offset": (N, 3), "Angle": (N, 3)}, form=form)
    if form.endswith("_tiled"):
        route_equal(f"{label} GN {GRAPH_NL}x{GRAPH_LI}", res, launches, lambda: ot.Problem(
            arap_mesh_deformation).plan(dims=dims).solve(
                dict(inputs), nIterations=GRAPH_NL, lIterations=GRAPH_LI), form)
    fused_cg.reset_launch_counts()
    twin_plan = ot.Problem(arap_mesh_deformation).plan(
        dims=dims, init_params=ot.InitializationParameters(use_pallas_cg="interpret"))
    twin = twin_plan.solve(dict(inputs), nIterations=GRAPH_NL, lIterations=GRAPH_LI)
    torch.cuda.synchronize()
    twin_launches = sum(fused_cg.fused_grid_cg_kernel.launches.values())
    first = res.costs[: len(ref["first_costs"])]
    first_rel = [abs(a - b) / abs(b) for a, b in zip(first, ref["first_costs"])]
    twin_rel = abs(res.final_cost - twin.final_cost) / abs(twin.final_cost)
    log(json.dumps({
        "check": "graph_costs", "case": label, "first_costs": first,
        "jax_cpu_first_costs": ref["first_costs"], "first_rel_diff": first_rel,
        "final_cost": res.final_cost, "twin_final_cost": twin.final_cost,
        "twin_rel_diff": twin_rel, "costs_equal_to_twin": res.costs == twin.costs,
        "lin_iters": res.num_linear_iterations, "twin_lin_iters": twin.num_linear_iterations,
        "jax_cpu_final_cost": ref["final"], "jax_cpu_lin_iters": ref["lin_iters"],
        "final_rel_diff_to_jax_cpu": abs(res.final_cost - ref["final"]) / ref["final"],
        "tpu_final_cost": TPU_GRAPH_FINAL_COSTS[label], "twin_kernel_launches": twin_launches}))
    if any(r > FIRST_STEPS_RTOL for r in first_rel):
        raise RuntimeError(f"{label}: first steps' costs {first} vs JAX {ref['first_costs']}")
    if twin_rel > GOLDEN_RTOL or twin_launches != 0 or twin_plan.fused_fallback is not None:
        raise RuntimeError(f"{label}: kernel solve {res.final_cost} vs plain version "
                           f"{twin.final_cost} ({twin_launches} kernel launches in the latter)")
    return res, launches


def first_steps_main_path(label, spec, dims, inputs, nl, li, ref, n_first, shapes,
                          form=None, ip=None, kind="gaussNewtonGPU"):
    """A solve that does not settle, through the kernel: the first
    `n_first` steps' costs are held to the JAX package's (``ref``: its costs
    and lin_iters) at FIRST_STEPS_RTOL, and the whole solve cost for cost to
    the same solve through the plain version on the card. Returns (result,
    launches)."""
    ip = ip or {}
    res, launches, _plan = main_path(label, spec, kind, dims, inputs, nl, li, None,
                                     shapes, form=form, ip=ip)
    fused_cg.reset_launch_counts()
    twin_plan = ot.Problem(spec, kind=kind).plan(
        dims=dims, init_params=ot.InitializationParameters(use_pallas_cg="interpret", **ip))
    twin = twin_plan.solve(dict(inputs), nIterations=nl, lIterations=li)
    torch.cuda.synchronize()
    twin_launches = sum(fused_cg.fused_grid_cg_kernel.launches.values())
    first = res.costs[:n_first]
    first_rel = [abs(a - b) / abs(b) for a, b in zip(first, ref["costs"])]
    log(json.dumps({
        "check": "first_steps_costs", "case": label, "first_costs": first,
        "jax_cpu_first_costs": ref["costs"][:n_first], "first_rel_diff": first_rel,
        "costs": res.costs, "twin_costs": twin.costs, "costs_equal_to_twin": res.costs == twin.costs,
        "final_cost": res.final_cost, "jax_cpu_final_cost": ref["costs"][-1],
        "final_rel_diff_to_jax_cpu": abs(res.final_cost - ref["costs"][-1]) / ref["costs"][-1],
        "lin_iters": res.num_linear_iterations, "twin_lin_iters": twin.num_linear_iterations,
        "jax_cpu_lin_iters": ref["lin_iters"], "twin_kernel_launches": twin_launches}))
    if len(first) < n_first or any(r > FIRST_STEPS_RTOL for r in first_rel):
        raise RuntimeError(f"{label}: first steps' costs {first} vs JAX {ref['costs']}")
    if (res.costs != twin.costs or twin_launches != 0 or twin_plan.fused_fallback is not None):
        raise RuntimeError(f"{label}: kernel solve {res.costs} vs plain version "
                           f"{twin.costs} ({twin_launches} kernel launches in the latter)")
    return res, launches


def spec_shapes(spec, dims):
    """The shape of each unknown of ``spec`` at ``dims``, as a solve returns it."""
    c = compile_spec(spec, dims, torch.float32)
    return {u: tuple(c.unknown_shape(u)) for u in c.unknown_names}


def spec_kernel_checks(label, dims, inputs):
    """A GRAPH_SPECS spec's first GN and first LM systems on the graph
    kernel (their plans printed, in the spec's layout), each held bitwise
    to the twin with the template's instance held to the same twin results:
    50 iterations with no exit, the real exits within the main path's
    lIterations, a repeat. Returns (GN system, LM system, {"GN", "LM":
    max|Δδ| of the no-exit check})."""
    spec, _kind, _inputs, _nl, li, _form, layout = GRAPH_SPECS[label]
    gm = system(spec, dims, inputs)
    glm = system(spec, dims, inputs, "LMGPU")
    meta, rem = gm[0], gm[0]["rem"]
    log(json.dumps({"graph_system": label, "vertices": dims["N"], "channels": meta["ctot"],
                    "fields": int(meta["F"].shape[0]), "triples": len(meta["triples"]),
                    "offsets": sorted({d[1] for (d, _i, _j, _f) in meta["triples"]}),
                    "remainder_entries": None if rem is None else int(rem["col"].shape[0])}))
    errs = {}
    for klabel, s_ in (("GN", gm), ("LM", glm)):
        if graph_plan_line(f"{label} {klabel}", *s_[:2], s_[3])["layout"] != layout:
            raise RuntimeError(f"{label} {klabel}: not in the graph kernel's {layout} layout")
        errs[klabel] = variant_checks(f"{label} {klabel}", s_, 50, li, bitwise=True,
                                      template=True)
    return gm, glm, errs


def odd_multi_checks():
    """The graph kernel's multi form at an odd channel count: ODD_MULTI_B
    deformations of cotangent on a ODD_MULTI_SIDE^2 grid mesh (each its own
    X, so its own blocks) in turn in one launch, GN and LM, held bitwise to
    the twin and the template, each system to its own one-system launch."""
    dims, base = cotangent_inputs(ODD_MULTI_SIDE)
    rng = np.random.RandomState(1)
    X = np.stack([base["X"] + 0.05 * k * rng.randn(*base["X"].shape).astype(np.float32)
                  for k in range(ODD_MULTI_B)])
    inputs = dict(base, X=X)
    for kind, klabel in (("gaussNewtonGPU", "GN"), ("LMGPU", "LM")):
        with batch_form("multi"):
            sysb = batched_system(cotangent_mesh_smoothing, dims, inputs, kind)
            label = f"cotangent grid {ODD_MULTI_SIDE}x{ODD_MULTI_SIDE} x{ODD_MULTI_B} {klabel}"
            graph_plan_line(label, *sysb[:2], sysb[3])
            batch_checks(label, sysb, 30, 60, form=f"{klabel.lower()}_rem_multi_tiled",
                         template=True)


def spec_main_path(label, dims, inputs):
    """A GRAPH_SPECS solve through the public API at bench.py's size and
    depth, one launch of its instance a step, held as the
    JAX_CPU_SPEC_COSTS comment says: its first steps to the JAX package's
    float32 costs, the whole solve cost for cost to the plain version on the
    card and, cost for cost and count for count, to the template route; a
    solve that settles by its final cost; the float64 solve's first steps
    to the JAX package's float64 costs. Returns (result, launches)."""
    spec, kind, _inputs, nl, li, form, _layout = GRAPH_SPECS[label]
    ref = JAX_CPU_SPEC_COSTS[label]
    klabel = f"{label} {'LM' if kind == 'LMGPU' else 'GN'} {nl}x{li}"
    res, launches = first_steps_main_path(klabel, spec, dims, inputs, nl, li, ref,
                                          ref["first_steps"], spec_shapes(spec, dims), form=form,
                                          kind=kind)
    route_equal(klabel, res, launches, lambda: ot.Problem(spec, kind=kind).plan(
        dims=dims).solve(dict(inputs), nIterations=nl, lIterations=li), form)
    want = ref["costs"][-1]
    rel = abs(res.final_cost - want) / abs(want)
    log(json.dumps({"check": "spec_final_cost", "case": klabel, "final_cost": res.final_cost,
                    "jax_cpu_cost": want, "rel_diff": rel, "settles": ref["settles"],
                    "jax_cpu_f64_final_cost": ref["f64_costs"][-1]}))
    if ref["settles"] and rel > GOLDEN_RTOL:
        raise RuntimeError(f"{klabel}: final cost {res.final_cost} vs JAX {want}")
    n = ref["f64_steps"]
    if n:
        float64_witness(klabel, spec, kind, dims, inputs, n, li, ref["f64_costs"][:n], n)
    return res, launches


@contextlib.contextmanager
def host_ms_of(module, name, into):
    """Add the host ms of every call of ``module.name`` to ``into`` (a
    list) for the while."""
    saved = getattr(module, name)

    @functools.wraps(saved)
    def timed(*a, **k):
        t0 = time.perf_counter()
        try:
            return saved(*a, **k)
        finally:
            into.append((time.perf_counter() - t0) * 1e3)

    setattr(module, name, timed)
    try:
        yield into
    finally:
        setattr(module, name, saved)


def dynamic_main_path(dims, topologies):
    """arap36k's topologies (dynamic_topologies) through one
    dynamic_topology=True plan, GN GRAPH_NL x GRAPH_LI each: one
    gn_rem_tiled launch a step (the padded graph has no DIA split), no
    fallback; the first two steps' costs within FIRST_STEPS_RTOL of the
    exact-topology plan's (the DIA form, another summation order), the
    whole solve cost for cost to the same dynamic plan through the plain
    version on the card. Prints the host ms a new topology's tables
    (graph_group_tables) and the graph route's partition (graph_partition)
    took within the solve. Returns ({topology: launches}, the first system
    of the last topology as the kernel takes it)."""
    N = dims["N"]
    plan = ot.Problem(arap_mesh_deformation).plan(dims=dims, dynamic_topology=True)
    twin_plan = ot.Problem(arap_mesh_deformation).plan(
        dims=dims, dynamic_topology=True,
        init_params=ot.InitializationParameters(use_pallas_cg="interpret"))
    out = {}
    for k, inputs in enumerate(topologies):
        E = int(inputs["G"]["v0"].shape[0])
        label = f"arap36k dynamic topology {k} ({E} edges) GN {GRAPH_NL}x{GRAPH_LI}"
        fused_cg.reset_launch_counts()
        with host_ms_of(problem_mod, "graph_group_tables", []) as t_tab, \
                host_ms_of(fused_cg, "graph_partition", []) as t_part:
            res = plan.solve(dict(inputs), nIterations=GRAPH_NL, lIterations=GRAPH_LI)
            torch.cuda.synchronize()
        launches = {n: v for n, v in fused_cg.fused_grid_cg_kernel.launches.items() if v}
        g = plan._normalize_and_place(dict(inputs))[2]["G"]
        (tabs,) = g["__groups__"].values()
        exact = ot.Problem(arap_mesh_deformation).plan(dims=dims).solve(
            dict(inputs), nIterations=2, lIterations=GRAPH_LI)
        fused_cg.reset_launch_counts()
        twin = twin_plan.solve(dict(inputs), nIterations=GRAPH_NL, lIterations=GRAPH_LI)
        torch.cuda.synchronize()
        twin_launches = sum(fused_cg.fused_grid_cg_kernel.launches.values())
        first_rel = [abs(a - b) / abs(b) for a, b in zip(res.costs[:2], exact.costs)]
        line = {"check": "main_path", "case": label, "form": "gn_rem_tiled",
                "kernel_launches": launches, "fused_fallback": plan.fused_fallback,
                "edges": E, "padded_edges": int(g["v0"].shape[0]),
                "remainder_entries": int(tabs["csr"]["col"].shape[0]),
                "dia_offsets": len(tabs["dia"]),
                "incidence_width": int(tabs["inc"].shape[1]), "costs": res.costs,
                "lin_iters": res.num_linear_iterations, "exact_first_costs": exact.costs,
                "first_rel_diff_to_exact": first_rel, "twin_costs": twin.costs,
                "costs_equal_to_twin": res.costs == twin.costs,
                "twin_kernel_launches": twin_launches, "table_host_ms": t_tab,
                "partition_host_ms": t_part, "solve_s": res.wall_time_s,
                "cached_topologies": len(plan._inc_cache)}
        log(json.dumps(line))
        finite = all(bool(torch.isfinite(v).all()) and tuple(v.shape) == (N, 3)
                     for v in res.unknowns.values())
        if (launches != {"gn_rem_tiled": res.num_iterations} or res.num_iterations < 1
                or plan.fused_fallback is not None or not finite or tabs["dia"]
                or len(first_rel) < 2 or max(first_rel) > FIRST_STEPS_RTOL
                or res.costs != twin.costs or twin_launches or twin_plan.fused_fallback):
            raise RuntimeError(f"{label} failed: {line}")
        out[k] = launches
    return out, system(arap_mesh_deformation, dims, topologies[-1], dynamic_topology=True)


def _flat_host(d, names):
    """A dict of tensors as one float64 numpy vector in ``names`` order."""
    return np.concatenate([d[k].detach().double().cpu().numpy().reshape(-1) for k in names])


def _rel_err(got, want):
    return float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-30))


def _apply_draw(plan, seed=11):
    """A seeded direction for an operator apply: per unknown, uniform in
    [-1, 1], on the plan's device."""
    rng = np.random.RandomState(seed)
    c = plan.compiled
    return {k: torch.as_tensor(rng.uniform(-1.0, 1.0, c.unknown_shape(k))).to(
        device=plan.device, dtype=c.dtype) for k in c.unknown_names}


def cluster_main_path(dims, inputs):
    """ARAP with rotation clusters (cluster_arap_spec: Offset on the 36,864
    vertices, an Angle on each of 576 clusters), GN GRAPH_NL x GRAPH_LI
    through the public API. Its operator couples two vertex spaces (per-pair
    ELL blocks), which no CG kernel takes: the plan must report
    fused_fallback "no_kernel" and launch no CG instance. Held: its first
    two steps' costs to the JAX package's (JAX_CPU_CLUSTER_COSTS) and to the
    same plan's on the composed operator (use_fused_jtj=False) on the card,
    at FIRST_STEPS_RTOL; one assembled JᵀJ·p to the composed Jᵀ(J·p) at
    CLUSTER_APPLY_RTOL; the float64 solve's first CLUSTER_F64_STEPS costs to
    the JAX package's float64 solve at F64_RTOL. Returns (the result, its
    launches: none)."""
    label = f"cluster_arap{dims['N']}x{dims['P']} GN {GRAPH_NL}x{GRAPH_LI}"
    spec = cluster_arap_spec(ot)
    fused_cg.reset_launch_counts()
    plan = ot.Problem(spec).plan(dims=dims)
    res = plan.solve(dict(inputs), nIterations=GRAPH_NL, lIterations=GRAPH_LI)
    torch.cuda.synchronize()
    launches = {k: v for k, v in fused_cg.fused_grid_cg_kernel.launches.items() if v}
    g = plan._normalize_and_place(dict(inputs))[2]["G"]
    ell = {f"{ko}<-{ki}": list(t.shape) for (ko, ki), t in g["__ell__"]["ell"].items()}
    cplan = ot.Problem(spec).plan(dims=dims, init_params=ot.InitializationParameters(
        use_fused_jtj=False))
    comp = cplan.solve(dict(inputs), nIterations=2, lIterations=GRAPH_LI)
    # one apply of the assembled operator against the composed one
    u, c, gr, p = plan._normalize_and_place(dict(inputs))
    fs = FunctionSet(plan.compiled, c, gr, p)
    fs.masks(u)
    A = fs.assemble_stencil(u, plan.solver._stencil_plan)[0]
    v = fs.mask_rows(_apply_draw(plan))
    _r, J, JT = fs.linearize(u)
    names = list(plan.compiled.unknown_names)
    apply_rel = _rel_err(_flat_host(A(v), names), _flat_host(JT(J(v)), names))
    ref = JAX_CPU_CLUSTER_COSTS
    first = res.costs[:2]
    first_rel = [abs(a - b) / abs(b) for a, b in zip(first, ref["costs"])]
    comp_rel = [abs(a - b) / abs(b) for a, b in zip(first, comp.costs)]
    line = {"check": "main_path", "case": label, "form": "eager loop (no kernel form)",
            "kernel_launches": launches, "fused_fallback": plan.fused_fallback,
            "composed_fused_fallback": cplan.fused_fallback, "ell_tables": ell,
            "costs": res.costs, "final_cost": res.final_cost,
            "lin_iters": res.num_linear_iterations, "nonlinear_iters": res.num_iterations,
            "jax_cpu_costs": ref["costs"], "jax_cpu_lin_iters": ref["lin_iters"],
            "first_rel_diff_to_jax_cpu": first_rel, "composed_first_costs": comp.costs,
            "first_rel_diff_to_composed": comp_rel, "apply_rel_diff_to_composed": apply_rel,
            "final_rel_diff_to_jax_cpu": abs(res.final_cost - ref["costs"][-1]) / ref["costs"][-1],
            "solve_s": res.wall_time_s}
    log(json.dumps(line))
    shapes = {"Offset": (dims["N"], 2), "Angle": (dims["P"], 1)}
    finite = all(tuple(res.unknowns[k].shape) == s and bool(torch.isfinite(res.unknowns[k]).all())
                 for k, s in shapes.items())
    if (launches or plan.fused_fallback != "no_kernel" or res.num_iterations != GRAPH_NL
            or not finite or len(first_rel) < 2 or max(first_rel) > FIRST_STEPS_RTOL
            or len(comp_rel) < 2 or max(comp_rel) > FIRST_STEPS_RTOL
            or apply_rel > CLUSTER_APPLY_RTOL or cplan.fused_fallback is not None):
        raise RuntimeError(f"{label} failed: {line}")
    float64_witness(label, spec, "gaussNewtonGPU", dims, inputs, GRAPH_NL, GRAPH_LI,
                    ref["f64_costs"], CLUSTER_F64_STEPS)
    return res, launches


def jacobian_checks(label, spec, dims, inputs):
    """Plan.dump_jacobian on the card's plan: on the host, Jᵀ(J·p) from the
    COO in float64 against the assembled operator's apply (the masked p,
    the masked rows: M·A·M), and Jᵀr against its JᵀF, each at
    JACOBIAN_RTOL of the largest entry. Prints the nnz and the host ms."""
    from scipy import sparse

    plan = ot.Problem(spec).plan(dims=dims)
    plan.dump_jacobian(dict(inputs))  # the probes' first call, apart
    t0 = time.perf_counter()
    coo = plan.dump_jacobian(dict(inputs))
    host_ms = (time.perf_counter() - t0) * 1e3
    Jh = sparse.csr_matrix((np.asarray(coo["vals"], np.float64), (coo["rows"], coo["cols"])),
                           shape=coo["shape"])
    u, c, g, p = plan._normalize_and_place(dict(inputs))
    fs = FunctionSet(plan.compiled, c, g, p)
    fs.masks(u)
    A, _diag, jtf_fn, _meta = fs.assemble_stencil(u, plan.solver._stencil_plan)
    names = list(plan.compiled.unknown_names)
    rows_mask = _flat_host(fs.mask_rows({k: torch.ones_like(x) for k, x in u.items()}), names)
    v = fs.mask_rows(_apply_draw(plan))
    apply_rel = _rel_err(_flat_host(A(v), names), rows_mask * (Jh.T @ (Jh @ _flat_host(v, names))))
    r_terms = fs.F(u)
    r = np.concatenate([t.detach().double().cpu().numpy().reshape(-1) for t in r_terms])
    jtf_rel = _rel_err(_flat_host(jtf_fn(r_terms), names), rows_mask * (Jh.T @ r))
    line = {"check": "jacobian", "case": label, "shape": list(coo["shape"]),
            "nnz": int(len(coo["vals"])), "host_ms": host_ms,
            "jtjp_rel_diff_to_assembled": apply_rel, "jtr_rel_diff_to_assembled_jtf": jtf_rel,
            "excluded_rows": int((rows_mask == 0).sum())}
    log(json.dumps(line))
    if apply_rel > JACOBIAN_RTOL or jtf_rel > JACOBIAN_RTOL:
        raise RuntimeError(f"{label}: the exported J disagrees with the assembled operator: "
                           f"{line}")
    return line


def explicit_main_paths(res_poisson, res_arap, poisson_in, arap_dims, arap_in):
    """use_explicit_jtj=True through the public API (J and Jᵀ as CSR, two
    sparse matvecs a CG iteration in the eager loop, no kernel): poisson
    512x512x4 GN 1x2000, its final cost within GOLDEN_RTOL of the tiled
    route's solve in this run and of the JAX CPU's; arap36k GN 2xGRAPH_LI,
    its two steps' costs within FIRST_STEPS_RTOL of the tiled route's.
    Returns {case: (plan, inputs)} for the timing."""
    out = {}
    cases = (("poisson", poisson_image_editing, _grid(MAIN_N), poisson_in, 1, 2000),
             ("arap36k", arap_mesh_deformation, arap_dims, arap_in, 2, GRAPH_LI))
    for name, spec, dims, inp, nl, li in cases:
        label = f"{name} explicit J GN {nl}x{li}"
        fused_cg.reset_launch_counts()
        plan = ot.Problem(spec).plan(dims=dims, init_params=ot.InitializationParameters(
            use_explicit_jtj=True))
        u, _c, g, _p = plan._normalize_and_place(dict(inp))
        t0 = time.perf_counter()
        structure = plan.solver._explicit_structure(g, u)  # kept for the solve
        structure_ms = (time.perf_counter() - t0) * 1e3
        res = plan.solve(dict(inp), nIterations=nl, lIterations=li)
        torch.cuda.synchronize()
        launches = sum(fused_cg.fused_grid_cg_kernel.launches.values())
        line = {"check": "main_path", "case": label, "form": "explicit J, eager loop",
                "costs": res.costs, "final_cost": res.final_cost,
                "lin_iters": res.num_linear_iterations, "kernel_launches": launches,
                "fused_fallback": plan.fused_fallback, "solve_s": res.wall_time_s,
                "nnz_J": int(structure["J"][1].shape[0]), "structure_host_ms": structure_ms}
        if name == "poisson":
            rel = [abs(res.final_cost - res_poisson.final_cost) / res_poisson.final_cost,
                   abs(res.final_cost - JAX_CPU_POISSON_512_COST) / JAX_CPU_POISSON_512_COST]
            line.update(tiled_final_cost=res_poisson.final_cost,
                        jax_cpu_final_cost=JAX_CPU_POISSON_512_COST,
                        rel_diff_to_tiled_and_jax_cpu=rel,
                        tiled_lin_iters=res_poisson.num_linear_iterations)
            ok = max(rel) <= GOLDEN_RTOL
        else:
            rel = [abs(a - b) / abs(b) for a, b in zip(res.costs, res_arap.costs[:nl])]
            line.update(tiled_first_costs=res_arap.costs[:nl], first_rel_diff_to_tiled=rel)
            ok = len(rel) == nl and max(rel) <= FIRST_STEPS_RTOL
        log(json.dumps(line))
        if (not ok or launches or plan.fused_fallback is not None
                or plan.solver._stencil_plan is not None):
            raise RuntimeError(f"{label} failed: {line}")
        out[name] = (plan, inp)
    return out


def time_explicit_cg(explicit, t_tiled, gpu):
    """ms per executed CG iteration of the explicit route (the eager loop,
    JᵀJ·p as two CSR matvecs, a host flag an iteration), CUDA events over
    TIMED_ITERS iterations with no exit, beside gn_tiled's (poisson) and
    gn_dia_tiled's (arap36k) in this call; written down, not gated."""
    beside = {"poisson": ("gn", f"poisson{MAIN_N}x4", "gn_tiled"),
              "arap36k": ("gn_dia", "arap36k", "gn_dia_tiled")}
    for name, (plan, inp) in explicit.items():
        sv = plan.solver
        u, c, g, p = plan._normalize_and_place(dict(inp))
        sp = plan.solver_params
        fs = FunctionSet(plan.compiled, c, g, p)
        state = sv.init(u, c, g, p, sp)
        s = sv._system(u, fs, state, sp)
        pre = s["pre"]

        def run():
            return fused_cg._run_cg(s["r0"], s["A"], lambda r: {k: pre[k] * r[k] for k in r},
                                    tree_dot, TIMED_ITERS, 0.0, guard_div=sv.ip.guard_division_by_zero)

        run()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        _d, iters = run()
        end.record()
        torch.cuda.synchronize()
        key, tlabel, form = beside[name]
        kernel_ms = t_tiled[key][0] / TIMED_ITERS_RUN[(tlabel, form)]
        log(json.dumps({"timing": f"{name} explicit J CG iteration", "gpu": gpu,
                        "ms_per_cg_iter": start.elapsed_time(end) / iters, "iters": iters,
                        f"{form}_ms_per_cg_iter": kernel_ms}))


def volumetric_main_path(pre, inputs):
    """volumetric 32^3 GN 8x40 through the kernel with `pre` "jacobi" or
    "block_jacobi", on the 3-D grid kernel (gn_vol_tiled, gn_bj_vol_tiled),
    held as the JAX_CPU_VOLUMETRIC comment says, and cost for cost and count
    for count to the same solve on the template route (gn, gn_bj)."""
    n = VOL_N
    label = f"volumetric{n} GN {VOL_NL}x{VOL_LI} {pre}"
    form = "gn_bj_vol_tiled" if pre == "block_jacobi" else "gn_vol_tiled"
    ip = {"preconditioner": pre}
    res, launches = first_steps_main_path(
        label, volumetric_mesh_deformation, _vol(n), inputs, VOL_NL, VOL_LI,
        JAX_CPU_VOLUMETRIC[pre], VOL_FIRST_STEPS, {"Offset": (n, n, n, 3), "Angle": (n, n, n, 3)},
        form=form, ip=ip)
    route_equal(label, res, launches, lambda: ot.Problem(volumetric_mesh_deformation).plan(
        dims=_vol(n), init_params=ot.InitializationParameters(**ip)).solve(
            dict(inputs), nIterations=VOL_NL, lIterations=VOL_LI), form)
    return res, launches


def split_main_path(inputs, per_system):
    """poisson 1024x1024x4, 1 GN step of up to 2000 CG iterations a channel,
    through the split: one launch of the tiled multi-system instance
    (gn_multi_tiled), the cost and the summed count held to the JAX
    package's split solve, the count equal to the sum of `per_system`, the
    kernel's counts on the same system, and cost and count equal to the
    same solve on the template route (gn_multi)."""
    n = SPLIT_N
    want, want_iters = JAX_CPU_POISSON_1024_SPLIT
    label = f"poisson{n}x4 GN 1x2000 split"
    res, launches, plan = main_path(label, poisson_image_editing, "gaussNewtonGPU", _grid(n),
                                    inputs, 1, 2000, want, {"X": (n, n, 4)},
                                    form="gn_multi_tiled")
    meta = plan.cg_inputs(dict(inputs))[0]
    log(json.dumps({"check": "split", "case": f"poisson{n}x4", "chan_grid": meta["chan_grid"],
                    "iters_per_channel": per_system, "lin_iters": res.num_linear_iterations,
                    "jax_cpu_split_lin_iters": want_iters}))
    if not meta["chan_grid"] or res.num_linear_iterations != sum(per_system):
        raise RuntimeError(f"poisson{n}x4: not split, or {res.num_linear_iterations} CG "
                           f"iterations against the kernel's {per_system}")
    rel, add = CS_ITER_SLACK
    if abs(res.num_linear_iterations - want_iters) > rel * want_iters + add:
        raise RuntimeError(f"poisson{n}x4 split: {res.num_linear_iterations} CG iterations "
                           f"against the JAX CPU's {want_iters}")
    route_equal(label, res, launches, lambda: ot.Problem(poisson_image_editing).plan(
        dims=_grid(n)).solve(dict(inputs), nIterations=1, lIterations=2000), "gn_multi_tiled")
    return res, launches


def variant_main_path(name, variant, inputs):
    """poisson 512x512x4 GN 1x2000 or image_warping 512x512 LM 8x400 under
    one solver variant ("chronopoulos_gear", "block_jacobi" or
    "bfloat16"), held to the JAX package's solve of the same plan
    (JAX_CPU_VARIANT_COSTS); Chronopoulos-Gear also to its CG iteration
    count. Every step takes the variant's tiled instance (gn_cs_tiled,
    gn_bf16_tiled, lm_cs_tiled, lm_bj_tiled, lm_bf16_tiled); the
    Chronopoulos-Gear and bfloat16 solves are also held cost for cost and
    count for count to the same solve on the template route. Returns
    (result, launches)."""
    want, want_iters = JAX_CPU_VARIANT_COSTS[(name, variant)]
    ip = {"chronopoulos_gear": {"cg_variant": "chronopoulos_gear"},
          "block_jacobi": {"preconditioner": "block_jacobi"},
          "bfloat16": {"coefficient_dtype": "bfloat16"}}[variant]
    suffix = {"chronopoulos_gear": "_cs", "block_jacobi": "_bj", "bfloat16": "_bf16"}[variant]
    if name == "poisson":
        n = MAIN_N
        spec, kind, dims, nl, li = poisson_image_editing, "gaussNewtonGPU", _grid(n), 1, 2000
        label = f"poisson{n}x4 GN 1x2000 {variant}"
        shapes = {"X": (n, n, 4)}
    else:
        n = IW_N
        spec, kind, dims, nl, li = image_warping, "LMGPU", _grid(n), 8, 400
        label = f"image_warping{n} LM 8x400 {variant}"
        shapes = {"Offset": (n, n, 2), "Angle": (n, n, 1)}
    form = ("lm" if kind == "LMGPU" else "gn") + suffix + "_tiled"
    res, launches, _p = main_path(label, spec, kind, dims, inputs, nl, li, want, shapes,
                                  form=form, ip=ip)
    if variant != "block_jacobi":
        route_equal(label, res, launches, lambda: ot.Problem(spec, kind=kind).plan(
            dims=dims, init_params=ot.InitializationParameters(**ip)).solve(
                dict(inputs), nIterations=nl, lIterations=li), form)
    line = {"check": "variant_iters", "case": f"{name} {variant}",
            "lin_iters": res.num_linear_iterations, "jax_cpu_lin_iters": want_iters}
    if name == "poisson":
        line["standard_lin_iters"] = POISSON_STANDARD_CG_ITERS
        line["standard_final_cost"] = JAX_CPU_POISSON_512_COST
    log(json.dumps(line))
    rel, add = CS_ITER_SLACK
    if variant == "chronopoulos_gear" and name == "poisson" and (
            abs(res.num_linear_iterations - want_iters) > rel * want_iters + add):
        raise RuntimeError(f"poisson CS: {res.num_linear_iterations} CG iterations against "
                           f"the JAX CPU's {want_iters}")
    return res, launches


def float64_witness(label, spec, kind, dims, inputs, nl, li, ref, n_steps):
    """A solve in float64 through the public API with no device argument
    (the eager loop: the kernel is float32, so no launch), its first
    `n_steps` costs held to ``ref``, the JAX package's float64 solve on the
    CPU, at F64_RTOL."""
    fused_cg.reset_launch_counts()
    plan = ot.Problem(spec, kind=kind).plan(dims=dims, double_precision=True)
    res = plan.solve(dict(inputs), nIterations=nl, lIterations=li)
    torch.cuda.synchronize()
    launches = sum(fused_cg.fused_grid_cg_kernel.launches.values())
    rel = [abs(a - b) / abs(b) for a, b in zip(res.costs, ref)]
    log(json.dumps({"check": "float64_witness", "case": label,
                    "costs": res.costs, "jax_cpu_f64_costs": ref, "rel_diff": rel,
                    "lin_iters": res.num_linear_iterations, "kernel_launches": launches,
                    "fused_fallback": plan.fused_fallback, "solve_s": res.wall_time_s}))
    if (len(res.costs) != len(ref) or any(r > F64_RTOL for r in rel[:n_steps])
            or launches or plan.fused_fallback is not None):
        raise RuntimeError(f"{label} float64: costs {res.costs[:n_steps]} vs JAX "
                           f"{ref[:n_steps]}, {launches} kernel launches")


def instance_system(meta, b, pre, lm, variant, k):
    """System k of a batch as a one-system launch takes it: (meta with its
    fields and remainder blocks, or its empty CSR where the graph has no
    remainder, b, pre, LM keywords, variant keywords with its block
    preconditioner)."""
    one = {key: v for key, v in meta.items() if key != "batch"}
    one["F"] = meta["F"][k].contiguous()
    if meta["rem"] is not None:
        one["rem"] = dict(meta["rem"], blk=meta["rem"]["blk"][k].contiguous())
    if meta.get("empty_csr") is not None:  # the batched meta's is expanded over the batch
        empty = meta["empty_csr"]
        one["empty_csr"] = dict(empty, rowptr=empty["rowptr"][k], col=empty["col"][k])
    lm_k = None if lm is None else dict(lm, ctc=lm["ctc"][k].contiguous())
    pb = variant.get("pre_blocks")
    var_k = dict(variant, pre_blocks=None if pb is None else pb[k].contiguous())
    return one, b[k].contiguous(), pre[k].contiguous(), lm_k, var_k


def batch_vs_single(label, meta, b, pre, lits, lm=None, **variant):
    """Each system of a batched launch against its own one-system launch
    on the batch's route, with the real exits: bitwise equal, count for
    count. The one-system launch partitions the dots as the batched one
    does (one block for the template's block-per-system launch, systems of
    at most BLOCK_THREADS elements; the same grid for the template's
    multi-system form; the same tiles for the tiled one, whose systems then
    take the one-system tiled instance), or, for the batch kernel's teams,
    sums them in another order, whose float64 sums round to the same
    float32 dots: its systems alone take their one-system tiled instance
    (a curve fit the graph kernel's stream layout, laplacian 16x16 the
    tiled grid kernel)."""
    lm_kw = dict(lm, q_tolerance=Q_TOL) if lm else {}
    form = form_of(meta, b, lm, **variant)
    dk, ik = fused_cg.fused_grid_cg_kernel(meta, b, pre, lits, CG_TOL, **lm_kw, **variant)
    single = (fused_cg.fused_grid_cg_kernel if form.endswith("_tiled")
              else fused_cg.template_grid_cg_kernel)
    equal, counts = 0, []
    for k in range(n_systems(meta)):
        m1, b1, p1, lm1, var1 = instance_system(meta, b, pre, lm, variant, k)
        kw1 = dict(lm1, q_tolerance=Q_TOL) if lm1 else {}
        if single is fused_cg.fused_grid_cg_kernel and not form_of(
                m1, b1, lm1, **var1).endswith("_tiled"):
            raise RuntimeError(f"{label}: system {k} alone does not take the tiled kernel")
        d1, i1 = single(m1, b1, p1, lits, CG_TOL, **kw1, **var1)
        equal += bool(torch.equal(d1, dk[k]))
        counts.append(i1)
    torch.cuda.synchronize()
    counts = torch.cat(counts).tolist()
    same_counts = counts == ik.tolist()
    log(json.dumps({"check": "batch_vs_single", "case": label, "form": form,
                    "systems": n_systems(meta), "systems_bitwise_equal": equal,
                    "counts_equal": same_counts, "iters": sum(counts)}))
    if equal != n_systems(meta) or not same_counts:
        raise RuntimeError(f"{label}: {equal} of {n_systems(meta)} systems equal to their own "
                           f"launch, counts equal: {same_counts}")


def batch_checks(label, system, lits, exit_lits, single=True, form=None, template=False):
    """A batch form against its twin as variant_checks holds the others,
    each system also bitwise equal to the twin's (and, with `single`, to
    its own one-system launch: batch_vs_single). ``form``: the instance the
    launch must take; with `template`, the template's instance is held to
    the same twin results too. Returns the no-exit check's max|Δδ|."""
    meta, b, pre, lm, variant = system
    if form is not None and form_of(meta, b, lm, **variant) != form:
        raise RuntimeError(f"{label}: takes {form_of(meta, b, lm, **variant)}, not {form}")
    no_exit = dict(q_tol=float("-inf")) if lm else {}
    err = kernel_vs_twin(label, meta, b, pre, lits, 0.0, lm, bitwise=True, template=template,
                         **no_exit, **variant)
    kernel_vs_twin(label, meta, b, pre, exit_lits, CG_TOL, lm, bitwise=True, template=template,
                   **variant)
    bitwise_repeat(label, meta, b, pre, exit_lits, lm, **variant)
    if single:
        batch_vs_single(label, meta, b, pre, exit_lits, lm, **variant)
    return err


def batched_curve_main_path(truths, inputs):
    """bench.py's batched case through the public API: 512 LM 10x20 curve
    fits in one solve_batched, one launch of the batch kernel's LM
    instance (lm_batch_tiled, a team of two lanes a system) a step; every instance takes 10 steps, its parameters within
    BATCH_PARAM_ATOL of the JAX CPU's, the largest |param - truth| within
    BATCH_TRUTH_ATOL, and the summed CG count within BATCH_LIN_RTOL of the
    JAX CPU's. Returns (result, launches)."""
    ref = np.load(BATCH_REF)
    fused_cg.reset_launch_counts()
    plan = ot.Problem(curve_fitting, kind="LMGPU").plan(dims={"N": BATCH_N, "U": 1})
    res = plan.solve_batched(dict(inputs), nIterations=BATCH_NL, lIterations=BATCH_LI)
    torch.cuda.synchronize()
    launches = {k: v for k, v in fused_cg.fused_grid_cg_kernel.launches.items() if v}
    p = res.unknowns["funcParams"]
    finite = bool(torch.isfinite(p).all()) and tuple(p.shape) == (BATCH_B, 1, 2)
    p = p[:, 0, :].double().cpu().numpy()
    lin = int(res.num_linear_iterations.sum())
    line = {"check": "main_path", "case": f"curve_fitting x{BATCH_B} LM {BATCH_NL}x{BATCH_LI} "
            "batched", "form": "lm_batch_tiled", "kernel_launches": launches,
            "fused_fallback": plan.fused_fallback,
            "nonlinear_iters": sorted(set(res.num_iterations.tolist())),
            "lin_iters": lin, "jax_cpu_lin_iters": JAX_CPU_BATCHED_LIN_ITERS,
            "lin_rel_diff": abs(lin - JAX_CPU_BATCHED_LIN_ITERS) / JAX_CPU_BATCHED_LIN_ITERS,
            "cost_sum": float(res.final_costs.sum()),
            "jax_cpu_cost_sum": float(ref["final_costs"].sum()),
            "max_param_diff_to_jax_cpu": float(np.abs(p - ref["params"]).max()),
            "max_param_err": float(np.abs(p - truths).max()),
            "jax_cpu_max_param_err": float(np.abs(ref["params"] - truths).max()),
            "solve_s": res.wall_time_s}
    log(json.dumps(line))
    if (launches != {"lm_batch_tiled": BATCH_NL} or plan.fused_fallback is not None or not finite
            or set(res.num_iterations.tolist()) != {BATCH_NL}
            or line["max_param_diff_to_jax_cpu"] > BATCH_PARAM_ATOL
            or line["max_param_err"] > BATCH_TRUTH_ATOL or line["lin_rel_diff"] > BATCH_LIN_RTOL):
        raise RuntimeError(f"batched curve fits failed: {line}")
    return res, launches


def batched_poisson_main_path(inputs):
    """4 poisson 512x512x4 instances (GN 1x2000) in one solve_batched: one
    launch of the tiled multi-system instance (gn_multi_tiled), the systems
    in turn; each instance's cost and count equal to its own single solve
    on the card, instance 0 within GOLDEN_RTOL of the JAX CPU's
    bench_poisson cost, costs and counts equal to the same solve on the
    template route (gn_multi). Returns launches."""
    n, B = MAIN_N, BATCH_POISSON_B
    fused_cg.reset_launch_counts()
    plan = ot.Problem(poisson_image_editing).plan(dims=_grid(n))
    res = plan.solve_batched(dict(inputs), nIterations=1, lIterations=2000)
    torch.cuda.synchronize()
    launches = {k: v for k, v in fused_cg.fused_grid_cg_kernel.launches.items() if v}
    singles = []
    for k in range(B):
        r = plan.solve({"X": inputs["X"][k], "T": inputs["T"][k], "M": inputs["M"]},
                       nIterations=1, lIterations=2000)
        singles.append((r.final_cost, r.num_linear_iterations))
    rel = [abs(float(res.final_costs[k]) - c) / abs(c) for k, (c, _l) in enumerate(singles)]
    line = {"check": "main_path", "case": f"poisson{n}x4 x{B} GN 1x2000 batched",
            "form": "gn_multi_tiled", "kernel_launches": launches,
            "fused_fallback": plan.fused_fallback,
            "final_costs": res.final_costs.tolist(), "single_costs": [c for c, _l in singles],
            "rel_diff_to_single": rel, "lin_iters": res.num_linear_iterations.tolist(),
            "single_lin_iters": [l for _c, l in singles],
            "jax_cpu_cost_instance0": JAX_CPU_POISSON_512_COST, "solve_s": res.wall_time_s}
    log(json.dumps(line))
    ok0 = abs(float(res.final_costs[0]) - JAX_CPU_POISSON_512_COST) <= (
        GOLDEN_RTOL * JAX_CPU_POISSON_512_COST)
    if (launches != {"gn_multi_tiled": 1} or plan.fused_fallback is not None or not ok0
            or line["lin_iters"] != line["single_lin_iters"] or max(rel) > 1e-6
            or not bool(torch.isfinite(res.unknowns["X"]).all())):
        raise RuntimeError(f"batched poisson failed: {line}")
    route_equal(line["case"], res, launches, lambda: ot.Problem(poisson_image_editing).plan(
        dims=_grid(n)).solve_batched(dict(inputs), nIterations=1, lIterations=2000),
        "gn_multi_tiled")
    return launches


def batched_graph_main_path(dims, inputs):
    """The armadillo posed to four handle targets (armadillo_batch_inputs),
    GN 8x100 in one solve_batched: one launch of the graph kernel's
    multi-system instance (gn_rem_multi_tiled) a step, no fallback, costs
    and counts equal to the same solve on the template route (gn_rem_multi);
    instance 0's first two step
    costs within FIRST_STEPS_RTOL of the JAX CPU's (the solve does not
    settle: JAX_CPU_GRAPH_COSTS), each instance's first two step costs
    within BATCH_STEP_RTOL of its own solve on the card and its CG count in
    those two steps equal to that solve's. Returns launches."""
    B, N = len(ARM_BATCH_PULLS), dims["N"]
    batched = ("Offset", "Constraints")
    fused_cg.reset_launch_counts()
    plan = ot.Problem(arap_mesh_deformation).plan(dims=dims)
    res = plan.solve_batched(dict(inputs), nIterations=GRAPH_NL, lIterations=GRAPH_LI)
    torch.cuda.synchronize()
    launches = {k: v for k, v in fused_cg.fused_grid_cg_kernel.launches.items() if v}
    two = plan.solve_batched(dict(inputs), nIterations=2, lIterations=GRAPH_LI)
    singles = [plan.solve(instance_inputs(inputs, batched, k), nIterations=2,
                          lIterations=GRAPH_LI) for k in range(B)]
    ref = JAX_CPU_GRAPH_COSTS["armadillo31k"]["first_costs"]
    rel0 = [abs(float(res.costs[0, i]) - c) / abs(c) for i, c in enumerate(ref)]
    rel = [[abs(float(res.costs[k, i]) - c) / abs(c) for i, c in enumerate(s.costs)]
           for k, s in enumerate(singles)]
    finite = all(bool(torch.isfinite(v).all()) and tuple(v.shape) == (B, N, 3)
                 for v in res.unknowns.values())
    line = {"check": "main_path", "case": f"armadillo31k x{B} GN {GRAPH_NL}x{GRAPH_LI} batched",
            "form": "gn_rem_multi_tiled", "kernel_launches": launches,
            "fused_fallback": plan.fused_fallback, "pulls": list(ARM_BATCH_PULLS),
            "costs": res.costs.tolist(), "lin_iters": res.num_linear_iterations.tolist(),
            "jax_cpu_first_costs_instance0": ref, "first_rel_diff_instance0": rel0,
            "single_first_costs": [s.costs for s in singles], "first_rel_diff_to_single": rel,
            "first_two_lin_iters": two.num_linear_iterations.tolist(),
            "single_first_two_lin_iters": [s.num_linear_iterations for s in singles],
            "solve_s": res.wall_time_s}
    log(json.dumps(line))
    if (launches != {"gn_rem_multi_tiled": GRAPH_NL} or plan.fused_fallback is not None
            or not finite or not np.isfinite(res.costs).all() or max(rel0) > FIRST_STEPS_RTOL
            or max(max(r) for r in rel) > BATCH_STEP_RTOL
            or line["first_two_lin_iters"] != line["single_first_two_lin_iters"]):
        raise RuntimeError(f"batched armadillo failed: {line}")
    route_equal(line["case"], res, launches, lambda: ot.Problem(arap_mesh_deformation).plan(
        dims=dims).solve_batched(dict(inputs), nIterations=GRAPH_NL, lIterations=GRAPH_LI),
        "gn_rem_multi_tiled")
    return launches


def bj_batch_plan(pre="block_jacobi"):
    """image_warping 512x512's LM plan under block-Jacobi (or `pre`), as the
    batched image_warping main paths solve it."""
    return ot.Problem(image_warping, kind="LMGPU").plan(
        dims=_grid(IW_N), init_params=ot.InitializationParameters(preconditioner=pre))


def time_batched(label, plan, inputs, nl, li, gpu, reps):
    """Wall ms (host clock, synchronised) of `reps` solve_batched calls of
    a batched main path (`plan`, nl x li), after a warm-up solve."""
    plan.solve_batched(dict(inputs), nIterations=nl, lIterations=li)
    torch.cuda.synchronize()
    solve_ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = plan.solve_batched(dict(inputs), nIterations=nl, lIterations=li)
        torch.cuda.synchronize()
        solve_ms.append((time.perf_counter() - t0) * 1e3)
    log(json.dumps({"timing": label, "gpu": gpu, "solve_ms": solve_ms,
                    "lin_iters": res.num_linear_iterations.tolist()}))


def batched_iw_main_path(inputs, pre="block_jacobi"):
    """image_warping 512x512 four times (iw_batch_inputs), LM 8x400 under
    block-Jacobi (or `pre`, "jacobi") in one solve_batched: one launch of
    the tiled LM multi-system instance (lm_bj_multi_tiled; lm_multi_tiled)
    a step, no fallback; instance 0 within GOLDEN_RTOL of the JAX CPU's
    solve, each instance within GOLDEN_RTOL of its own solve on the card.
    Returns launches."""
    n, B = IW_N, IW_BJ_BATCH_B
    bj = pre == "block_jacobi"
    want = (JAX_CPU_VARIANT_COSTS[("image_warping", "block_jacobi")][0] if bj
            else JAX_CPU_IMAGE_WARPING_COSTS[(IW_N, "LMGPU", 8, 400)])
    form = "lm_bj_multi_tiled" if bj else "lm_multi_tiled"
    fused_cg.reset_launch_counts()
    plan = bj_batch_plan(pre)
    res = plan.solve_batched(dict(inputs), nIterations=8, lIterations=400)
    torch.cuda.synchronize()
    launches = {k: v for k, v in fused_cg.fused_grid_cg_kernel.launches.items() if v}
    singles = [plan.solve(instance_inputs(inputs, ("Constraints",), k), nIterations=8,
                          lIterations=400) for k in range(B)]
    rel = [abs(float(res.final_costs[k]) - s.final_cost) / abs(s.final_cost)
           for k, s in enumerate(singles)]
    finite = all(bool(torch.isfinite(v).all()) and tuple(v.shape[:3]) == (B, n, n)
                 for v in res.unknowns.values())
    line = {"check": "main_path", "case": f"image_warping{n} x{B} LM 8x400 {pre} batched",
            "form": form, "kernel_launches": launches,
            "fused_fallback": plan.fused_fallback, "final_costs": res.final_costs.tolist(),
            "single_costs": [s.final_cost for s in singles], "rel_diff_to_single": rel,
            "lin_iters": res.num_linear_iterations.tolist(),
            "single_lin_iters": [s.num_linear_iterations for s in singles],
            "jax_cpu_cost_instance0": want,
            "rel_diff_instance0": abs(float(res.final_costs[0]) - want) / want,
            "solve_s": res.wall_time_s}
    log(json.dumps(line))
    if (launches != {form: 8} or plan.fused_fallback is not None or not finite
            or line["rel_diff_instance0"] > GOLDEN_RTOL or max(rel) > GOLDEN_RTOL):
        raise RuntimeError(f"batched image_warping {pre} failed: {line}")
    return launches


def batched_step_before_after(dims, inputs, gpu):
    """One GN step of the armadillo batch through solve_batched, host ms
    around it ending in a sync (after a warm-up): the kernel path, one
    gn_rem_multi launch, beside the path such a batch took before the
    batch forms had a remainder: each instance's step in turn through the
    eager CG loop (here a plan with use_pallas_cg="off", which also skips
    the batched assembly the old path built and discarded)."""
    out = {}
    for path, ip in (("kernel", {}), ("eager_instance_by_instance", {"use_pallas_cg": "off"})):
        plan = ot.Problem(arap_mesh_deformation).plan(
            dims=dims, init_params=ot.InitializationParameters(**ip))
        plan.solve_batched(dict(inputs), nIterations=1, lIterations=GRAPH_LI)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = plan.solve_batched(dict(inputs), nIterations=1, lIterations=GRAPH_LI)
        torch.cuda.synchronize()
        out[path] = {"step_ms": (time.perf_counter() - t0) * 1e3,
                     "lin_iters": r.num_linear_iterations.tolist(), "costs": r.costs[:, 0].tolist()}
    log(json.dumps({"timing": f"armadillo31k x{len(ARM_BATCH_PULLS)} GN one batched step",
                    "gpu": gpu, **out}))


def flow_prolong(unknowns, i, next_dims):
    """optical_flow's prolongation between pyramid levels: the flow upsampled
    and doubled (bench.py::bench_optical_flow)."""
    return {"X": upsample2x_nearest(unknowns["X"], (next_dims["W"], next_dims["H"]), scale=2.0)}


def pyramid_flow_main_path(levels):
    """optical_flow through PyramidPlan (a plan a level, the flow upsampled
    and doubled between levels by the prolongation), one launch a step;
    each level's final cost within GOLDEN_RTOL of the JAX package's there.
    Returns (launches, the PyramidPlan, its result)."""
    dims = [{"W": lv["I"].shape[0], "H": lv["I"].shape[1]} for lv in levels]
    fused_cg.reset_launch_counts()
    pplan = ot.PyramidPlan(ot.Problem(optical_flow), dims, flow_prolong, nIterations=FLOW_NL,
                           lIterations=FLOW_LI)
    res = pplan.solve([dict(lv) for lv in levels])
    torch.cuda.synchronize()
    launches = {k: v for k, v in fused_cg.fused_grid_cg_kernel.launches.items() if v}
    rel = [abs(a - b) / abs(b) for a, b in zip(res.costs, JAX_CPU_FLOW_LEVEL_COSTS)]
    X = res.unknowns["X"]
    line = {"check": "main_path", "case": "optical_flow PyramidPlan " + " then ".join(
                f"{d['W']}x{d['H']}" for d in dims) + f" GN {FLOW_NL}x{FLOW_LI} a level",
            "form": "gn_tiled", "kernel_launches": launches, "level_costs": res.costs,
            "jax_cpu_level_costs": JAX_CPU_FLOW_LEVEL_COSTS, "rel_diff": rel,
            "lin_iters": res.num_linear_iterations, "nonlinear_iters": res.num_iterations,
            "fused_fallback": [p.fused_fallback for p in pplan.plans], "solve_s": res.wall_time_s}
    log(json.dumps(line))
    if (launches != {"gn_tiled": len(levels) * FLOW_NL} or any(r > GOLDEN_RTOL for r in rel)
            or any(p.fused_fallback is not None for p in pplan.plans)
            or tuple(X.shape) != (dims[-1]["W"], dims[-1]["H"], 2)
            or not bool(torch.isfinite(X).all())):
        raise RuntimeError(f"PyramidPlan optical_flow failed: {line}")
    return launches, pplan, res


def scheduled_main_path():
    """solve_scheduled on tests/test_scheduled.py's spec at SCHED_N (5
    outer solves of GN 3x15, the constraints moved on the card between
    them), one launch a step, equal at SCHED_RTOL to the host-driven loop on
    the card. Returns launches."""
    n = SCHED_N
    x0, c0, c1 = sched_inputs(n)
    fused_cg.reset_launch_counts()
    plan = ot.Problem(warp_like_spec).plan(dims=_grid(n))
    C0 = torch.as_tensor(c0, device=plan.device)
    C1 = torch.as_tensor(c1, device=plan.device)

    def schedule(consts, i):
        a = (i.to(torch.float32) + 1.0) / SCHED_OUTER
        return {**consts, "C": (1.0 - a) * C0 + a * C1}

    res = plan.solve_scheduled({"X": x0.copy(), "C": c1}, schedule, SCHED_OUTER,
                               nIterations=SCHED_NL, lIterations=SCHED_LI)
    torch.cuda.synchronize()
    launches = {k: v for k, v in fused_cg.fused_grid_cg_kernel.launches.items() if v}
    host = ot.Problem(warp_like_spec).plan(dims=_grid(n), nIterations=SCHED_NL,
                                           lIterations=SCHED_LI)
    inputs, host_costs, host_lin = {"X": x0.copy(), "C": c1}, [], 0
    for i in range(SCHED_OUTER):
        a = np.float32((i + 1.0) / SCHED_OUTER)
        inputs["C"] = (1 - a) * c0 + a * c1
        r = host.solve(dict(inputs))
        inputs["X"] = r.unknowns["X"]
        host_costs.append(r.final_cost)
        host_lin += r.num_linear_iterations
    rel = [abs(a - b) / abs(b) for a, b in zip(res.costs, host_costs)]
    dx = float((res.unknowns["X"] - r.unknowns["X"]).abs().max())
    line = {"check": "main_path", "case": f"solve_scheduled {SCHED_OUTER} x GN "
            f"{SCHED_NL}x{SCHED_LI} at {n}x{n}", "form": "gn_tiled", "kernel_launches": launches,
            "costs": res.costs, "host_loop_costs": host_costs, "rel_diff": rel,
            "max_abs_dX": dx, "lin_iters": res.num_linear_iterations, "host_lin_iters": host_lin,
            "fused_fallback": plan.fused_fallback, "solve_s": res.wall_time_s}
    log(json.dumps(line))
    if (launches != {"gn_tiled": SCHED_OUTER * SCHED_NL} or plan.fused_fallback is not None
            or len(rel) != SCHED_OUTER or max(rel) > SCHED_RTOL
            or not bool(torch.isfinite(res.unknowns["X"]).all())):
        raise RuntimeError(f"solve_scheduled failed: {line}")
    return launches


def time_batched_launches(label, meta, b, pre, lm, gpu):
    """The batched CG launch of one LM step (its lIterations and real
    exits), on its route and on the template's, against the same systems
    as one-system launches, one after the other: the kernels' device ms
    (profiler), the ms between CUDA events around the calls (the wrapper's
    host work included) and the wrapper's host ms a call."""
    lm_kw = dict(lm, q_tolerance=Q_TOL)

    def batched():
        fused_cg.fused_grid_cg_kernel(meta, b, pre, BATCH_LI, CG_TOL, **lm_kw)

    singles = [instance_system(meta, b, pre, lm, {}, k) for k in range(n_systems(meta))]

    def one_by_one():
        for m1, b1, p1, lm1, _v in singles:
            fused_cg.fused_grid_cg_kernel(m1, b1, p1, BATCH_LI, CG_TOL,
                                          **dict(lm1, q_tolerance=Q_TOL))

    dev_batch = kernel_device_ms(batched, 5, 1)
    with template_route():
        dev_template = kernel_device_ms(batched, 5, 1)
    dev_singles = kernel_device_ms(one_by_one, 1, len(singles))
    line = {"timing": label, "gpu": gpu, "systems": len(singles),
            "form": form_of(meta, b, lm), "batched_launch_device_ms": dev_batch,
            "template_form": form_of(meta, b, lm, template=True),
            "template_batched_launch_device_ms": dev_template,
            "single_launches_device_ms": dev_singles,
            "single_launch_device_ms_each": dev_singles / len(singles),
            "batched_launch_event_ms": time_cuda(batched, 5),
            "single_launches_event_ms": time_cuda(one_by_one, 1),
            "batched_wrapper_host_ms": host_ms(batched, 5),
            "single_wrapper_host_ms": host_ms(one_by_one, 1) / len(singles)}
    log(json.dumps(line))
    return line


@contextlib.contextmanager
def batch_form(form):
    """Send every batched meta to one form, "batch" or "multi", whatever
    its size (fused_cg.BATCH_BLOCK_ELEMS moved for the while)."""
    saved = fused_cg.BATCH_BLOCK_ELEMS
    fused_cg.BATCH_BLOCK_ELEMS = 2**62 if form == "batch" else -1
    try:
        yield
    finally:
        fused_cg.BATCH_BLOCK_ELEMS = saved


def form_sweep(curve_lm, gpu):
    """The forms of a batch on the same systems, device ms a launch
    (profiler): the 512 curve fits' LM step (BATCH_LI iterations, the real
    exits), and SWEEP_B laplacian systems of each SWEEP_SIDES side, 50 GN
    iterations with no exit, on both sides of fused_cg.BATCH_BLOCK_ELEMS:
    the "batch" form on the batch kernel (its lane cap,
    fused_cg.BATCH_TEAM_LANE_ELEMS, lifted for the while; null where the
    system's slice exceeds its shared memory) and on the template's block
    a system, and the "multi" form. Every form must run the same counts."""
    meta, b, pre, lm, _v = curve_lm
    cases = [(f"curve_fitting x{BATCH_B} LM step", meta, b, pre,
              dict(lm, q_tolerance=Q_TOL), BATCH_LI, CG_TOL)]
    for side in SWEEP_SIDES:
        m, bb, pp, _lm, _v = batched_system(laplacian, _grid(side),
                                            laplacian_batch_inputs(side, SWEEP_B))
        cases.append((f"laplacian{side} x{SWEEP_B} GN", m, bb, pp, {}, 50, 0.0))
    saved = fused_cg.BATCH_TEAM_LANE_ELEMS
    for label, m, bb, pp, kw, lits, tol in cases:
        line = {"timing": "batch_forms", "case": label, "gpu": gpu,
                "elems_per_system": int(m["ctot"]) * int(np.prod(m["F"].shape[2:])),
                "batch_block_elems": fused_cg.BATCH_BLOCK_ELEMS,
                "team_lane_elems": saved, "chosen": fused_cg.batched_kernel_form(m),
                "chosen_instance": form_of(m, bb, kw or None)}
        counts = {}
        call = functools.partial(fused_cg.fused_grid_cg_kernel, m, bb, pp, lits, tol, **kw)
        for name, form, route in (("team", "batch", contextlib.nullcontext),
                                  ("template_batch", "batch", template_route),
                                  ("multi", "multi", contextlib.nullcontext)):
            with batch_form(form), route():
                fused_cg.BATCH_TEAM_LANE_ELEMS = 2**62
                try:
                    inst = form_of(m, bb, kw or None)
                    if name == "team" and not inst.endswith("_batch_tiled"):
                        line["team_device_ms"] = None  # beyond its shared memory
                        continue
                    counts[name] = call()[1].tolist()
                    line[f"{name}_instance"] = inst
                    line[f"{name}_device_ms"] = kernel_device_ms(call, 3, 1)
                finally:
                    fused_cg.BATCH_TEAM_LANE_ELEMS = saved
        line["iters"] = sum(counts["multi"])
        line["faster"] = min((k for k in ("team", "template_batch", "multi")
                              if line.get(f"{k}_device_ms") is not None),
                             key=lambda k: line[f"{k}_device_ms"])
        log(json.dumps(line))
        if any(c != counts["multi"] for c in counts.values()):
            raise RuntimeError(f"{label}: the forms ran different iteration counts: {counts}")


def dev_us(e):
    """A profiler entry's device time, µs."""
    return float(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)))


def kernel_device_ms(fn, reps, launches, kernel=CG_KERNELS):
    """Device ms of the named kernel (or kernels) a call, mean over `reps` calls of fn
    after a warm-up, from torch.profiler's kernel entries: the kernel's own
    time, which CUDA events around a short launch blur with the wrapper's
    host work: the mean of the launches seen, times the `launches` of a
    call. On the H100 a session misses the last fused_grid_cg_kernel
    launch, and at times all of them: a session that saw none is
    repeated, and after PROFILE_SESSIONS of them the CUDA events time the
    calls instead (the log says so)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for session in range(1, PROFILE_SESSIONS + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        names = (kernel,) if isinstance(kernel, str) else kernel
        ks = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == DeviceType.CUDA
              and any(k in e.key for k in names)]
        n = sum(e.count for e in ks)
        if n:
            if n != reps * launches:
                log(json.dumps({"profiler_launches_seen": n, "made": reps * launches,
                                "kernel": kernel, "session": session}))
            return sum(dev_us(e) for e in ks) / 1e3 / n * launches
        log(json.dumps({"profiler_launches_seen": 0, "made": reps * launches,
                        "kernel": kernel, "session": session}))
    log(json.dumps({"device_ms_by": "cuda_events", "kernel": names,
                    "why": f"the profiler saw no launch in {PROFILE_SESSIONS} sessions"}))
    return time_cuda(fn, reps)


def host_ms(fn, reps):
    """Mean host ms a call of fn (perf_counter, no synchronisation between
    the calls): the wrapper's own cost of its asynchronous launches."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def time_cuda(fn, reps):
    """Mean ms per call over `reps` calls, CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_once(fn):
    """(ms of one call, CUDA events, its result)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


TIMED_ITERS_RUN = {}  # (label, form) -> iterations of time_pair's last timed launches


def time_pair(label, meta, b, pre, gpu, lm=None, reps=3, lits=TIMED_ITERS, device=False,
              twin=True, template=False, **variant):
    """ms of `lits` CG iterations with no exit of the kernel (mean of `reps`
    launches after a warm-up) and of its twin (one call, which also holds
    the count; ``twin=False``: not timed, plain ms None, for forms whose
    counts the checks above held), CUDA events, and the call's bound: (ms,
    plain ms, bound ms, bound by). With `device` the kernel's ms is its
    device time (kernel_device_ms), for a launch too short for the events to
    part it from the wrapper's host work; the events' ms is printed beside
    it. With `template` the template's instance is timed, where the tiled
    route would take the system. With the graph remainder the bound reads
    the fields, b, the preconditioner and ctc once a launch, the CSR every
    iteration; else under block-Jacobi it reads the C*C planes once a
    launch (the bound with them read every iteration is printed beside
    it). A form in the hbm layout also prints its own floor, the bound plus
    the frames' bytes (hbm_frame_bytes). On a 3-D grid that the 3-D grid
    kernel takes (either route's timing) the bound reads the fields, b and
    the preconditioner once a launch, the every-iteration bound beside it,
    and apart from both the bytes the kernel's own design moves between
    its boxes an iteration (their shells of z, vol_exchange_bytes), which
    stay in the L2: a cost of the design, not of the function."""
    lm_kw = dict(lm, q_tolerance=float("-inf")) if lm else {}
    launch = fused_cg.template_grid_cg_kernel if template else fused_cg.fused_grid_cg_kernel
    # with tol = 0 a loop that reaches an exact zero residual still stops
    # (rz <= 0, a denominator <= 0): times and the bound are of the
    # iterations executed, summed over a split's or a batch's systems
    _d, it = launch(meta, b, pre, lits, 0.0, **lm_kw, **variant)
    iters = int(it.sum())

    def call():
        launch(meta, b, pre, lits, 0.0, **lm_kw, **variant)

    ms_k = time_cuda(call, reps)
    extra = {}
    if device:
        extra = {"kernel_event_ms": ms_k, "wrapper_host_ms": host_ms(call, reps)}
        ms_k = kernel_device_ms(call, reps, 1)
    ms_t = None
    if twin:
        ms_t, (_d, twin_iters) = time_once(lambda: fused_cg.fused_grid_cg_reference(
            meta["F"], meta["triples"], b, pre, lits, 0.0, **twin_kw(meta), **lm_kw, **variant))
        if twin_iters != iters:
            raise RuntimeError(f"{label}: timed kernel ran {iters} iterations, the twin "
                               f"{twin_iters}")
    shape = meta_shape(meta)
    pre_planes = shape["C"] ** 2 if variant.get("pre_blocks") is not None else None
    knobs = dict(lm=bool(lm), cs=bool(variant.get("cs")), pre_planes=pre_planes)
    vplan = None if lm or variant.get("cs") else fused_cg.route_plan(
        meta, b, lm=False, pre_blocks=variant.get("pre_blocks"))
    if vplan is not None and vplan.get("layout") == "vol":
        # a 3-D grid the 3-D grid kernel takes: the fields and the
        # preconditioner once a launch; the boxes' shells apart
        ex = vol_exchange_bytes(vplan, tuple(int(n) for n in b.shape[1:]), shape["C"])
        bound_ms, bound_by = cg_bound(shape, iters, inputs_once=1, **knobs)
        every = cg_bound(shape, iters, **knobs)[0]  # and, beside it, once an iteration
        extra.update(exchange_bytes_per_cg_iter=ex, bound_ms_inputs_every_iter=every,
                     bound_ms_inputs_every_iter_per_cg_iter=every / iters,
                     exchange_ms_per_cg_iter_at_memory_rate=ex / HBM_BYTES_PER_S * 1e3)
    elif meta.get("rem") is not None:  # the inputs, the same for the whole solve, once
        bound_ms, bound_by = cg_bound(shape, iters, inputs_once=n_systems(meta), **knobs)
        every = cg_bound(shape, iters, **knobs)[0]  # and, beside it, once an iteration
        extra.update(bound_ms_inputs_every_iter=every,
                     bound_ms_inputs_every_iter_per_cg_iter=every / iters)
    elif pre_planes is None:
        bound_ms, bound_by = cg_bound(shape, iters, **knobs)
    else:  # the C*C planes, the same for the whole solve, read once a launch
        bound_ms, bound_by = cg_bound(shape, iters, planes_once=n_systems(meta), **knobs)
        every = cg_bound(shape, iters, **knobs)[0]  # and, beside it, once an iteration
        extra.update(bound_ms_planes_every_iter=every,
                     bound_ms_planes_every_iter_per_cg_iter=every / iters)
    form = form_of(meta, b, lm, template=template, **variant)
    if form.endswith("_hbm_tiled"):  # the least the layout itself moves
        floor_ms = bound_ms + hbm_frame_bytes(shape, iters) / HBM_BYTES_PER_S * 1e3
        extra.update(layout="hbm", layout_floor_ms=floor_ms,
                     layout_floor_ms_per_cg_iter=floor_ms / iters)
    TIMED_ITERS_RUN[(label, form)] = iters
    log(json.dumps({"timing": label, "form": form, "gpu": gpu, "iters": iters,
                    "kernel_ms_per_cg_iter": ms_k / iters,
                    "twin_ms_per_cg_iter": None if ms_t is None else ms_t / iters,
                    "bound_ms_per_cg_iter": bound_ms / iters,
                    "kernel_ms": ms_k, "twin_ms": ms_t, "bound_ms": bound_ms,
                    "bound_by": bound_by, **extra}))
    return ms_k, ms_t, bound_ms, bound_by


def time_main_path(label, spec, kind, dims, inputs, nl, li, gpu, ip=None, reps=1):
    """Assembly ms per nonlinear step (the step's system, CUDA events) and
    the whole solve's wall time (host clock, synchronised) of `reps` solves,
    after a warm-up solve; ``ip``: InitializationParameters' keywords."""
    plan = ot.Problem(spec, kind=kind).plan(dims=dims,
                                           init_params=ot.InitializationParameters(**(ip or {})))
    u, c, g, prm = plan._normalize_and_place(inputs)
    sv = plan.solver
    sp = plan.solver_params
    state = sv.init(u, c, g, prm, sp)

    def assemble():
        fs = FunctionSet(plan.compiled, c, g, prm)
        fs.masks(u)
        return sv.cg_inputs(u, fs, state, sp)

    ms_assembly = time_cuda(assemble, 2)
    plan.solve(dict(inputs), nIterations=nl, lIterations=li)
    torch.cuda.synchronize()
    solve_ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = plan.solve(dict(inputs), nIterations=nl, lIterations=li)
        torch.cuda.synchronize()
        solve_ms.append((time.perf_counter() - t0) * 1e3)
    log(json.dumps({"timing": label, "gpu": gpu, "assembly_ms_per_step": ms_assembly,
                    "solve_ms": solve_ms, "nonlinear_iters": res.num_iterations,
                    "lin_iters": res.num_linear_iterations}))


def tiled_floor(gpu, tiles=(12, 11), tile=4, cs=False):
    """The tiled kernel's time an iteration with almost no work: laplacian
    on a grid of `tiles` tiles of `tile` x `tile` points, one block each
    (a plan forced past tiled_grid_plan's, which would take fewer tiles
    here), 100 iterations with no exit, CUDA events: the floor its two
    grid barriers and dot reductions set (with `cs`, gn_cs_tiled's one),
    against which the routed shapes' times are read. Returns ms an
    iteration."""
    n1, n2 = tiles[0] * tile, tiles[1] * tile
    rng = np.random.RandomState(0)
    inputs = {"X": rng.rand(n1, n2).astype(np.float32), "A": rng.rand(n1, n2).astype(np.float32)}
    m, b, p, _lm, _v = system(laplacian, {"W": n1, "H": n2}, inputs)
    h = 1
    plan = {"tiles": tiles, "tile": (tile, tile), "halo": h, "threads": fused_cg.TILED_THREADS,
            "smem_bytes": fused_cg.tiled_smem_bytes(False, 1, tile, tile, h, len(m["triples"]),
                                                    cs=cs)}
    ms = time_cuda(lambda: fused_cg.tiled_grid_cg_kernel(m, b, p, TIMED_ITERS, 0.0, plan, cs=cs),
                   5)
    log(json.dumps({"timing": "tiled_floor_cs" if cs else "tiled_floor", "gpu": gpu,
                    "form": "gn_cs_tiled" if cs else "gn_tiled", "grid": [n1, n2],
                    "tiles": list(tiles), "tile": [tile, tile], "iters": TIMED_ITERS,
                    "kernel_ms_per_cg_iter": ms / TIMED_ITERS}))
    return ms / TIMED_ITERS


def vol_floor(gpu, boxes):
    """The 3-D grid kernel's time an iteration with almost no work:
    volumetric on a grid of one point a box, `boxes` boxes (the count of the
    32^3 launch), one block each (a plan forced past tiled_vol_plan's, which
    would take one box here), 100 iterations with no exit, CUDA events: the
    floor its two grid barriers and dot reductions set at that block count.
    Returns ms an iteration."""
    m, b, p, _lm, _v = system(volumetric_mesh_deformation, _vol(boxes),
                              volumetric_inputs(boxes))
    plan = forced_vol_plan(m, b, boxes)
    iters = int(fused_cg.tiled_vol_cg_kernel(m, b, p, TIMED_ITERS, 0.0, plan)[1].item())
    ms = time_cuda(lambda: fused_cg.tiled_vol_cg_kernel(m, b, p, TIMED_ITERS, 0.0, plan), 5)
    log(json.dumps({"timing": "tiled_floor_vol", "gpu": gpu, "form": "gn_vol_tiled",
                    "grid": list(boxes), "boxes": list(boxes), "box": [1, 1, 1],
                    "iters": iters, "kernel_ms_per_cg_iter": ms / iters}))
    return ms / iters


def l2_floor(gpu, label, F, timed):
    """The least time the card takes to read a graph's fields ``F`` once
    from its L2, where the stream layout's fields stay between iterations
    (arap36k's 26.7 MB in the 50 MB L2): one launch of a plain read of them
    repeated 100 times (scripts/l2_read_floor.py, a Triton kernel, loads
    that bypass L1), CUDA events, ms a read; beside it the same bytes at
    the memory rate, and each of ``timed`` (kernel ms an iteration by
    form, from time_pair in this call) over the read. Returns ms a read."""
    import importlib.util

    root = os.path.dirname(os.path.abspath(__file__))
    # Triton's compiled kernels stay in the checkout's git-ignored build/
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(root, "build", "triton"))
    path = os.path.join(root, "scripts", "l2_read_floor.py")
    spec = importlib.util.spec_from_file_location("l2_read_floor", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    ms = mod.l2_read_ms(F)
    n_bytes = F.numel() * F.element_size()
    log(json.dumps({"timing": "l2_read_floor", "case": label, "gpu": gpu, "bytes": n_bytes,
                    "reps": 100, "ms_per_read": ms, "bytes_per_s": n_bytes / ms * 1e3,
                    "memory_rate_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
                    "kernel_ms_per_cg_iter": timed,
                    "kernel_over_read": {k: v / ms for k, v in timed.items()}}))
    return ms


def profile_solve(label, run, gpu):
    """One warm solve (``run()``, called once before to warm up) under
    torch.profiler: device time, the kernel's share, device kernel launches
    and host synchronisations; the 20 longest kernels go to OUT_DIR."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = run()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()

    kernels = [e for e in events if getattr(e, "device_type", None) == DeviceType.CUDA]
    device_ms = sum(dev_us(e) for e in kernels) / 1e3
    cg = [e for e in kernels if any(k in e.key for k in CG_KERNELS)]
    cg_ms = sum(dev_us(e) for e in cg) / 1e3
    syncs = {e.key: e.count for e in events
             if "Synchronize" in e.key or e.key in ("aten::item", "aten::_local_scalar_dense")}
    line = {"profile": label, "gpu": gpu, "wall_ms": wall_ms, "device_ms": device_ms,
            "cg_kernel_ms": cg_ms,
            "cg_kernel_share_of_device": cg_ms / device_ms if device_ms else None,
            "device_busy_share_of_wall": device_ms / wall_ms,
            "device_kernel_launches": sum(e.count for e in kernels),
            "cg_kernel_launches": sum(e.count for e in cg),
            "host_syncs": syncs, "nonlinear_iters": int(np.max(res.num_iterations)),
            "lin_iters": int(np.sum(res.num_linear_iterations))}
    line["cg_kernels"] = sorted({e.key for e in cg})
    log(json.dumps(line))
    os.makedirs(OUT_DIR, exist_ok=True)
    top = sorted(kernels, key=dev_us, reverse=True)[:20]
    with open(os.path.join(OUT_DIR, f"profile_{label}.json"), "w") as f:
        top_kernels = [{"name": e.key, "count": e.count, "device_ms": dev_us(e) / 1e3}
                       for e in top]
        json.dump(dict(line, top_kernels=top_kernels), f, indent=1)


def radius2_spec(S):
    """A second-neighbour stencil (tests/test_sharding.py's radius-2 case):
    a halo of two rows and columns."""
    W, H = S.Dim("W"), S.Dim("H")
    X = S.Unknown("X", 1, (W, H))
    A = S.Array("A", 1, (W, H))
    S.Energy(0.3 * (X(0, 0) - A(0, 0)))
    for dx, dy in ot.Stencil([(2, 0), (-2, 0), (0, 2), (0, -2)]):
        S.Energy(ot.Select(ot.InBounds(dx, dy), X(0, 0) - X(dx, dy), 0.0))


def radius2_inputs(n):
    rng = np.random.RandomState(5)
    return {"X": rng.rand(n, n).astype(np.float32), "A": rng.rand(n, n).astype(np.float32)}


def radius2_rgb_spec(S):
    """radius2_spec over three channels with channel-identical fields: a
    separable operator, which a lowered criterion splits (forced_split)."""
    W, H = S.Dim("W"), S.Dim("H")
    X = S.Unknown("X", 3, (W, H))
    A = S.Array("A", 3, (W, H))
    S.Energy(0.3 * (X(0, 0) - A(0, 0)))
    for dx, dy in ot.Stencil([(2, 0), (-2, 0), (0, 2), (0, -2)]):
        S.Energy(ot.Select(ot.InBounds(dx, dy), X(0, 0) - X(dx, dy), 0.0))


def radius2_rgb_inputs(n):
    rng = np.random.RandomState(6)
    return {"X": rng.rand(n, n, 3).astype(np.float32), "A": rng.rand(n, n, 3).astype(np.float32)}


def radius2w_spec(S):
    """radius2_spec with a fit weight a point, so that a batch's instances
    have their own fields."""
    W, H = S.Dim("W"), S.Dim("H")
    X = S.Unknown("X", 1, (W, H))
    A = S.Array("A", 1, (W, H))
    Wt = S.Array("Wt", 1, (W, H))
    S.Energy(Wt(0, 0) * (X(0, 0) - A(0, 0)))
    for dx, dy in ot.Stencil([(2, 0), (-2, 0), (0, 2), (0, -2)]):
        S.Energy(ot.Select(ot.InBounds(dx, dy), X(0, 0) - X(dx, dy), 0.0))


def radius2w_batch_inputs(n, B):
    rng = np.random.RandomState(8)
    out = {k: rng.rand(B, n, n).astype(np.float32) for k in ("X", "A")}
    out["Wt"] = (0.2 + rng.rand(B, n, n)).astype(np.float32)
    return out


@contextlib.contextmanager
def forced_split(planes, dims):
    """The planner's split criterion (fused_cg.SPLIT_WORKING_SET_BYTES)
    lowered to `planes` float32 planes of the grid `dims` for the while, so
    that a separable operator at a size that does not split by default
    splits: the split's kernels at other shapes than poisson
    1024x1024x4."""
    saved = fused_cg.SPLIT_WORKING_SET_BYTES
    fused_cg.SPLIT_WORKING_SET_BYTES = planes * 4 * int(np.prod(list(dims.values())))
    try:
        yield
    finally:
        fused_cg.SPLIT_WORKING_SET_BYTES = saved


def tiles_of(meta):
    """The tiles ((r0, r1), (c0, c1)) of a 2x2 split of a meta's grid, the
    fields' halo (ah, aw), and a random p over the grid (float64 with
    float64 fields, else float32) with its zero-padded extension."""
    F = meta["F"]
    ah, aw = sharded_cg.halo_widths(meta["triples"])
    H, W = int(F.shape[1]), int(F.shape[2])
    g = torch.Generator(device=F.device).manual_seed(0)
    dt = torch.float64 if F.dtype == torch.float64 else torch.float32
    p = torch.randn((int(meta["ctot"]), H, W), generator=g, device=F.device, dtype=dt)
    pad = torch.nn.functional.pad(p, (aw, aw, ah, ah))
    tiles = [(rb, cb) for rb in split_bounds(H, MESH_SHAPE[0]) for cb in split_bounds(W, MESH_SHAPE[1])]
    return tiles, (ah, aw), p, pad


def tile_operands(meta, tile, halo, pad):
    """(the tile's fields, its halo-extended p) of one tile."""
    (r0, r1), (c0, c1) = tile
    ah, aw = halo
    return (meta["F"][:, r0:r1, c0:c1].contiguous(),
            pad[:, r0:r1 + 2 * ah, c0:c1 + 2 * aw].contiguous())


def tile_checks(label, meta):
    """K5 against its twin on the four tiles of a 2x2 split of a system's
    grid, p random: bitwise, and bitwise against the whole grid's apply
    (the twin's _stencil_apply) cropped to the tile. Returns the largest
    |kernel - twin|."""
    tiles, (ah, aw), p, pad = tiles_of(meta)
    triples = meta["triples"]
    whole = fused_cg._stencil_apply(meta["F"].to(p.dtype), triples, p)
    err = 0.0
    for tile in tiles:
        Ft, pe = tile_operands(meta, tile, (ah, aw), pad)
        k = sharded_cg.tile_apply_kernel(Ft, triples, pe, ah, aw)
        t = sharded_cg.tile_apply_reference(Ft, triples, pe, ah, aw)
        torch.cuda.synchronize()
        (r0, r1), (c0, c1) = tile
        err = max(err, float((k - t).abs().max()))
        if not (torch.equal(k, t) and torch.equal(k, whole[:, r0:r1, c0:c1])):
            raise RuntimeError(f"tile_apply {label} tile {tile}: not bitwise equal to the twin "
                               f"and the whole-grid apply (max |diff| {err})")
    log(json.dumps({"check": "tile_apply", "case": label, "tiles": len(tiles),
                    "instance": sharded_cg.tile_instance(meta["F"]),
                    "tile_shapes": [[r1 - r0, c1 - c0] for (r0, r1), (c0, c1) in tiles],
                    "halo": [ah, aw], "fields": int(meta["F"].shape[0]),
                    "triples": len(triples), "field_dtype": str(meta["F"].dtype),
                    "bitwise_equal": True, "max_abs_err": err}))
    return err


def time_tile_apply(label, meta, gpu, reps=200):
    """K5's device ms per apply on the first tile of a 2x2 split (the
    profiler's kernel time; CUDA events beside it), its twin's ms (events),
    and the apply's bound: the larger of its bytes (the tile's fields, the
    halo-extended p and the output, each once, at their element sizes) over
    the memory rate and its 2 flops a triple a point over the peak of their
    type (float64's for a float64 apply, else float32's). (ms, plain ms,
    bound ms, bound by)."""
    tiles, halo, _p, pad = tiles_of(meta)
    Ft, pe = tile_operands(meta, tiles[0], halo, pad)
    triples = meta["triples"]
    th, tw = int(Ft.shape[1]), int(Ft.shape[2])

    def call():
        sharded_cg.tile_apply_kernel(Ft, triples, pe, *halo)

    event_ms = time_cuda(call, reps)
    ms_k = kernel_device_ms(call, reps, 1, kernel="tile_apply_kernel")
    ms_t = time_cuda(lambda: sharded_cg.tile_apply_reference(Ft, triples, pe, *halo), 20)
    n_bytes = (Ft.numel() * Ft.element_size()
               + (pe.numel() + int(meta["ctot"]) * th * tw) * pe.element_size())
    t_bytes = n_bytes / HBM_BYTES_PER_S
    flops = F64_FLOPS if pe.dtype == torch.float64 else F32_FLOPS
    t_ops = 2 * len(triples) * th * tw / flops
    bound_ms, by = max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")
    log(json.dumps({"timing": f"tile_apply {label}", "gpu": gpu, "tile": [th, tw],
                    "instance": sharded_cg.tile_instance(Ft),
                    "halo": list(halo), "kernel_ms_per_apply": ms_k,
                    "kernel_event_ms_per_apply": event_ms, "twin_ms_per_apply": ms_t,
                    "bound_ms_per_apply": bound_ms, "bound_by": by, "bytes": n_bytes,
                    "library_ms": None}))
    return ms_k, ms_t, bound_ms, by


def mesh_case_problem(name):
    """The spec, dims and inputs of a SHARDED_MESH_CASES name."""
    if name == "arap":
        return (arap_mesh_deformation, *arap_grid_inputs(ARAP_SIDE))
    if name == "embedded":
        return (embedded_mesh_deformation, *embedded_inputs(SPEC_SIDE))
    if name == "volumetric":
        return volumetric_mesh_deformation, _vol(VOL_N), volumetric_inputs(VOL_N)
    return (cluster_arap_spec(ot), *cluster_arap_inputs(ARAP_SIDE, CLUSTER))


def read_case_solve(mesh, device, name, n, nl, li, ip):
    """One rank's solve of a SHARDED_READ_CASES case through the public API:
    shape_from_shading n^2 by ``Plan.solve``, optical_flow's two levels up
    to n^2 by ``PyramidPlan.solve``; the tile kernel's launch count and the
    mesh's counts set to 0 just before the solve and read just after.
    Returns its costs (each level's steps' costs), CG counts, per step CG
    iterations and applies, K5 launches, the mesh's counts, the sharded
    loops' ms, walls, the unknowns' shape, finiteness and digest, and each
    level's plan report."""
    import hashlib

    init = ot.InitializationParameters(**ip)
    if name == "sfs":
        levels = [sfs_inputs(n)]
        plans = [ot.Problem(shape_from_shading).plan(dims=_grid(n), mesh=mesh,
                                                     device=device.type, init_params=init)]

        def run():
            return plans[0].solve(dict(levels[0]), nIterations=nl, lIterations=li)
    else:
        levels = flow_levels(n)
        pplan = ot.PyramidPlan(ot.Problem(optical_flow), [_grid(lv["I"].shape[0]) for lv in levels],
                               flow_prolong, mesh=mesh, device=device.type, init_params=init,
                               nIterations=nl, lIterations=li)
        plans = pplan.plans

        def run():
            return pplan.solve([dict(lv) for lv in levels])
    sharded_cg.reset_launch_counts()
    mesh.reset_counts()
    for plan in plans:
        plan.solver.cg_stats.clear()
    t0 = time.perf_counter()
    res = run()
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches, counts = sharded_cg.tile_apply_kernel.launches, dict(mesh.counts)
    stats = [st for plan in plans for st in plan.solver.cg_stats]
    X = res.unknowns["X"]
    return {
        "cost": res.final_cost, "costs": res.costs, "lin": res.num_linear_iterations,
        "steps": res.num_iterations,
        "level_costs": [res.costs] if name == "sfs" else pplan.level_costs,
        "level_lin": [res.num_linear_iterations] if name == "sfs" else pplan.level_lin_iters,
        "fused_fallback": [plan.fused_fallback for plan in plans],
        "tile_kernel_launches": launches, "cg_calls": len(stats),
        "kernel": all(st["kernel"] for st in stats),
        "loops": sorted({st["loop"] for st in stats}),
        "level_iterations": [[st["iterations"] for st in plan.solver.cg_stats] for plan in plans],
        "applies": [st["applies"] for st in stats],
        **{k: [st[k] for st in stats] for k in ("all_reduce", "p2p_phases")},
        "solve_counts": counts, "cg_ms": sum(st["s"] for st in stats) * 1e3,
        "wall_ms": wall_ms, "solve_ms": res.wall_time_s * 1e3,
        "shape": list(X.shape), "finite": bool(torch.isfinite(X).all()),
        "digest": hashlib.sha256(X.cpu().numpy().tobytes()).hexdigest(),
        # the plan reports, every rank together (a first cost is a sum over
        # the ranks)
        "plans": [plan_summary(plan, lv, plan.solver_params) for plan, lv in zip(plans, levels)],
    }


def option_case_problem(name):
    """The spec, dims and inputs of a SHARDED_OPTION_CASES name."""
    if name == "intrinsic":
        return intrinsic_image_decomposition, _grid(INTR_N), intrinsic_inputs(INTR_N)
    if name == "robust":
        return (robust_nonrigid_alignment, *robust_inputs(SPEC_SIDE))
    if name == "poisson":
        return poisson_image_editing, _grid(MAIN_N), bench_poisson_inputs(MAIN_N)
    if name == "sfs":
        return shape_from_shading, _grid(SFS_N), sfs_inputs(SFS_N)
    return (arap_mesh_deformation, *arap_grid_inputs(ARAP_SIDE))


def _digest(unknowns):
    """SHA-256 of a solve's unknowns, in name order."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(unknowns):
        h.update(unknowns[k].contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def option_case_solve(mesh, device, spec, kind, dims, inputs, nl, li, ip, dbl=False,
                      timed=False):
    """One rank's solve of a sharded case through the public API, in
    float64 where ``dbl``, timed (collect_per_kernel_timing) where
    ``timed``: the kernels' launch counts and the mesh's counts set to 0
    just before the solve and read just after. Returns its costs, CG counts
    (per step too), K5's and the CG kernels' launches, the loops it ran,
    the mesh's counts, ms of the sharded loops, walls, the unknowns'
    finiteness and digest, the plan report and, timed, the timer's rows
    {row: [entries, total ms]} and what the solve printed."""
    import io

    init = ot.InitializationParameters(**ip, collect_per_kernel_timing=timed)
    plan = ot.Problem(spec, kind=kind).plan(dims=dims, mesh=mesh, device=device.type,
                                            double_precision=dbl, init_params=init)
    fused_cg.reset_launch_counts()
    sharded_cg.reset_launch_counts()
    mesh.reset_counts()
    plan.solver.cg_stats.clear()
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        res = plan.solve(dict(inputs), nIterations=nl, lIterations=li)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    stats = plan.solver.cg_stats
    out = {
        "cost": res.final_cost, "costs": res.costs, "lin": res.num_linear_iterations,
        "steps": res.num_iterations, "fused_fallback": res.fused_fallback,
        "tile_kernel_launches": sharded_cg.tile_apply_kernel.launches,
        "cg_kernel_launches": sum(fused_cg.fused_grid_cg_kernel.launches.values()),
        "iterations": [st["iterations"] for st in stats],
        "applies": [st["applies"] for st in stats],
        "loops": sorted({st["loop"] for st in stats}), "kernel": [st["kernel"] for st in stats],
        **{k: [st[k] for st in stats] for k in ("all_to_all", "all_reduce", "p2p_phases")},
        "solve_counts": dict(mesh.counts), "cg_ms": sum(st["s"] for st in stats) * 1e3,
        "wall_ms": wall_ms, "solve_ms": res.wall_time_s * 1e3,
        "dtype": str(plan.compiled.dtype),
        "finite": all(bool(torch.isfinite(v).all()) for v in res.unknowns.values()),
        "digest": _digest(res.unknowns),
        "plan": plan_summary(plan, inputs, plan.solver_params),
    }
    if timed:
        out["rows"] = {k: [v.count, v.total_ms] for k, v in plan._timing_phases.items()}
        out["instances"] = dict(plan._timing_instances)
        out["printed"] = printed.getvalue()
    return out


def sharded_work(world, device, cases, mesh_cases=(), read_cases=(), option_cases=(),
                 timed_case=None):
    """One rank's part of the sharded solves, run by a rank that
    opt_tpu_torch.entry.start_ranks started in a gloo world of ``world``:
    takes its place in the 2x2 mesh on ``device`` and solves every case
    through the public API, its tile-kernel launch count and the mesh's
    counts set to 0 just before each solve and read just after; then the
    grid specs that read Index, a SampledImage or a ComputedArray
    (``read_cases``, SHARDED_READ_CASES' form, :func:`read_case_solve`)
    and the graph, 3-D and several-space cases (``mesh_cases``,
    SHARDED_MESH_CASES' form) likewise, the latter with the fused kernels'
    launch counts; then the options a mesh takes since slice 27
    (``option_cases``, SHARDED_OPTION_CASES' form) and ``timed_case``
    (an index into ``cases``) once more with collect_per_kernel_timing
    (:func:`option_case_solve`). Returns {cases, read_cases, mesh_cases,
    option_cases, timed, all_reduce_us, halo_phase_us}."""
    import torch.distributed as dist

    from opt_tpu_torch.parallel import make_mesh

    dev = torch.device(device)
    mesh = make_mesh(MESH_SHAPE, device=dev)
    out = {"cases": {}}
    for label, name, kind, n, nl, li, ip in cases:
        spec = poisson_image_editing if name == "poisson" else image_warping
        inputs = bench_poisson_inputs(n) if name == "poisson" else bench_image_warping_inputs(n)
        plan = ot.Problem(spec, kind=kind).plan(
            dims=_grid(n), mesh=mesh, device=dev.type,
            init_params=ot.InitializationParameters(**ip))
        sharded_cg.reset_launch_counts()
        mesh.reset_counts()
        plan.solver.cg_stats.clear()
        t0 = time.perf_counter()
        res = plan.solve(dict(inputs), nIterations=nl, lIterations=li)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        stats = plan.solver.cg_stats
        out["cases"][label] = {
            "cost": res.final_cost, "costs": res.costs, "lin": res.num_linear_iterations,
            "steps": res.num_iterations, "fused_fallback": res.fused_fallback,
            "tile_kernel_launches": sharded_cg.tile_apply_kernel.launches,
            "cg_calls": len(stats), "kernel": all(st["kernel"] for st in stats),
            "iterations": [st["iterations"] for st in stats],
            "applies": [st["applies"] for st in stats],
            "all_reduce": mesh.counts["all_reduce"], "p2p_phases": mesh.counts["p2p_phases"],
            "wall_ms": wall_ms, "solve_ms": res.wall_time_s * 1e3,
            "tile": [list(b) for b in plan.rules.tile],
            "variant": [plan.solver.ip.cg_variant, plan.solver.ip.preconditioner],
            "unknowns_ok": all(tuple(v.shape[:2]) == (n, n) and bool(torch.isfinite(v).all())
                               for v in res.unknowns.values()),
            "digest": _digest(res.unknowns),
            # the plan report, every rank together (its first cost is a
            # sum over the ranks)
            "plan": plan_summary(plan, inputs, plan.solver_params),
        }
    out["read_cases"] = {label: read_case_solve(mesh, dev, name, n, nl, li, ip)
                         for label, name, n, nl, li, ip, _first in read_cases}
    out["mesh_cases"] = {}
    for label, name, kind, nl, li, ip, _first in mesh_cases:
        spec, dims, inputs = mesh_case_problem(name)
        plan = ot.Problem(spec, kind=kind).plan(
            dims=dims, mesh=mesh, device=dev.type,
            init_params=ot.InitializationParameters(**ip))
        fused_cg.reset_launch_counts()
        sharded_cg.reset_launch_counts()
        mesh.reset_counts()
        plan.solver.cg_stats.clear()
        t0 = time.perf_counter()
        res = plan.solve(dict(inputs), nIterations=nl, lIterations=li)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        stats = plan.solver.cg_stats
        out["mesh_cases"][label] = {
            "cost": res.final_cost, "costs": res.costs, "lin": res.num_linear_iterations,
            "steps": res.num_iterations, "fused_fallback": res.fused_fallback,
            "kernel_launches": (sum(fused_cg.fused_grid_cg_kernel.launches.values())
                                + sharded_cg.tile_apply_kernel.launches),
            "iterations": [st["iterations"] for st in stats],
            "applies": [st["applies"] for st in stats],
            "loops": sorted({st["loop"] for st in stats}),
            **{k: [st[k] for st in stats] for k in ("all_to_all", "all_reduce", "p2p_phases")},
            "solve_counts": dict(mesh.counts),
            "cg_ms": sum(st["s"] for st in stats) * 1e3,
            "wall_ms": wall_ms, "solve_ms": res.wall_time_s * 1e3,
            "variant": [plan.solver.ip.cg_variant, plan.solver.ip.preconditioner,
                        plan.solver.ip.edge_reorder],
            "unknowns": len(res.unknowns),
            "unknowns_ok": all(tuple(v.shape) == np.shape(inputs[k])
                               and bool(torch.isfinite(v).all())
                               for k, v in res.unknowns.items()),
            "plan": plan_summary(plan, inputs, plan.solver_params),
        }
    out["option_cases"] = {}
    for label, name, kind, nl, li, ip, dbl, _first, _count_rtol in option_cases:
        spec, dims, inputs = option_case_problem(name)
        out["option_cases"][label] = option_case_solve(mesh, dev, spec, kind, dims, inputs, nl,
                                                       li, ip, dbl)
    if timed_case is not None:
        label, name, kind, n, nl, li, ip = cases[timed_case]
        spec = poisson_image_editing if name == "poisson" else image_warping
        inputs = bench_poisson_inputs(n) if name == "poisson" else bench_image_warping_inputs(n)
        out["timed"] = option_case_solve(mesh, dev, spec, kind, _grid(n), inputs, nl, li, ip,
                                         timed=True)
    # what an iteration's communication costs here: one all_reduce of
    # three dots, one halo phase of a 256x256x4 tile (its strips through
    # the host), each the mean of 200
    x = torch.zeros(3, dtype=torch.float64)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(200):
        dist.all_reduce(x)
    out["all_reduce_us"] = (time.perf_counter() - t0) / 200 * 1e6
    tile = torch.zeros((4, 256, 256), device=dev)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(200):
        mesh.extend(tile, 1, 0)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out["halo_phase_us"] = (time.perf_counter() - t0) / 200 * 1e6
    return out


def sharded_main_paths(handle, single, gpu):
    """The sharded solves on 2x2 ranks on the one card (the ranks of
    ``handle``, opt_tpu_torch.entry.start_ranks over :func:`sharded_work`),
    each held to the single-device solve of the same case on the card
    (``single``: label -> (final cost, CG count)), poisson also to the JAX CPU's; every rank agrees, reports no
    fallback, launched the tile kernel once an apply of its sharded loop,
    one apply a CG iteration (LM: plus a reset every RESET_PERIOD), and
    returns finite global unknowns. Returns (the results by rank, the
    tile-kernel launches of each case summed over the ranks)."""
    from opt_tpu_torch import entry

    t0 = time.perf_counter()
    ranks = entry.collect_ranks(handle, SHARDED_TIMEOUT_S)
    log(json.dumps({"sharded_communication": gpu, "all_reduce_us": [r["all_reduce_us"] for r in ranks],
                    "halo_phase_us": [r["halo_phase_us"] for r in ranks]}))
    launches = {}
    for label, name, kind, n, nl, li, ip in SHARDED_CASES:
        cases = [r["cases"][label] for r in ranks]
        first = cases[0]
        want_cost, want_lin = single[label]
        rel = abs(first["cost"] - want_cost) / abs(want_cost)
        line = {"check": "sharded_main_path", "case": label, "mesh": list(MESH_SHAPE),
                "gpu": gpu, "final_cost": first["cost"], "single_device_cost": want_cost,
                "rel_diff": rel, "lin_iters": first["lin"], "single_device_lin_iters": want_lin,
                "variant": first["variant"], "nonlinear_iters": first["steps"],
                "tile_kernel_launches": [c["tile_kernel_launches"] for c in cases],
                "all_reduce": first["all_reduce"], "p2p_phases": first["p2p_phases"],
                "wall_ms": [c["wall_ms"] for c in cases],
                "ms_per_cg_iter": [c["solve_ms"] / max(1, c["lin"]) for c in cases],
                "note": "four ranks on one card under gloo: not a scaling figure"}
        if name == "poisson":
            line.update(jax_cpu_cost=JAX_CPU_POISSON_512_COST,
                        jax_cpu_lin_iters=POISSON_STANDARD_CG_ITERS)
        log(json.dumps(line))
        log(json.dumps({"plan_summary": f"{label} (rank 0 of {MESH_SHAPE[0]}x{MESH_SHAPE[1]})",
                        **first["plan"]}))
        faults = []
        want_k5 = "tile_apply_kernel<float>"
        if (first["plan"]["path"] != "sharded loop" or first["plan"]["instance"] != want_k5
                or first["plan"]["registers"] is None):
            faults.append(f"plan report {first['plan']}, expected the sharded loop on {want_k5} "
                          "with its registers")
        for r, c in zip(ranks, cases):
            applies = sum(c["applies"])
            # the standard loop applies once an iteration, LM also once a reset
            standard = ip.get("cg_variant") == "standard"
            want_applies = sum(it + (it // RESET_PERIOD if kind == "LMGPU" else 0)
                               for it in c["iterations"]) if standard else applies
            if (c["cost"], c["lin"], c["costs"]) != (first["cost"], first["lin"], first["costs"]):
                faults.append(f"rank {r['rank']} parts from rank 0")
            if c["fused_fallback"] is not None or not c["kernel"] or c["cg_calls"] != c["steps"]:
                faults.append(f"rank {r['rank']}: fallback {c['fused_fallback']}, kernel "
                              f"{c['kernel']}, {c['cg_calls']} sharded calls for {c['steps']} steps")
            if c["tile_kernel_launches"] != applies or applies != want_applies:
                faults.append(f"rank {r['rank']}: {c['tile_kernel_launches']} tile launches, "
                              f"{applies} applies, {want_applies} expected")
            if not c["unknowns_ok"]:
                faults.append(f"rank {r['rank']}: unknowns not finite of the global shape")
        if rel > GOLDEN_RTOL:
            faults.append(f"cost {first['cost']} against the single-device {want_cost}")
        if abs(first["lin"] - want_lin) > SHARDED_ITER_RTOL * want_lin:
            faults.append(f"{first['lin']} CG iterations against the single-device {want_lin}")
        if name == "poisson" and (
                abs(first["cost"] - JAX_CPU_POISSON_512_COST) > GOLDEN_RTOL * JAX_CPU_POISSON_512_COST
                or abs(first["lin"] - POISSON_STANDARD_CG_ITERS)
                > SHARDED_ITER_RTOL * POISSON_STANDARD_CG_ITERS):
            faults.append(f"{first['cost']} after {first['lin']} CG iterations against the JAX "
                          f"CPU's {JAX_CPU_POISSON_512_COST} after {POISSON_STANDARD_CG_ITERS}")
        if faults:
            raise RuntimeError(f"sharded {label}: " + "; ".join(faults))
        launches[label] = sum(c["tile_kernel_launches"] for c in cases)
    log(json.dumps({"sharded_wait_s": time.perf_counter() - t0}))
    return ranks, launches


def single_steps(spec, kind, dims, inputs, nl, li, ip, double_precision=False):
    """A single-device solve on the card through the stepwise API: (each
    step's cost, each step's CG count, the final cost)."""
    plan = ot.Problem(spec, kind=kind).plan(dims=dims, double_precision=double_precision,
                                            init_params=ot.InitializationParameters(**ip))
    plan.set_solver_parameters({"nIterations": nl, "lIterations": li})
    plan.init(dict(inputs))
    costs, counts, done = [], [], 0
    while True:
        going = plan.step()
        lin = int(plan._state["lin_iters"])
        counts.append(lin - done)
        costs.append(plan.current_cost())
        done = lin
        if not going:
            break
    return costs, counts, plan.current_cost()


def sharded_mesh_references(main):
    """The single-device solves on the card that SHARDED_MESH_CASES are held
    to: label -> (first steps' costs, their CG counts, final cost, CG
    count). ``main``: name -> (spec, dims, inputs, the main path's result).
    The pinned cases' finals are the main paths' (arap36k GN 8x100,
    embedded10k LM 8x40, volumetric 32^3 GN 8x40 with Jacobi, the cluster
    ARAP GN 8x100), their first steps' from the same solve's first steps
    through the stepwise API; an auto case's one more solve, with
    Chronopoulos-Gear and block-Jacobi."""
    out = {}
    for label, name, kind, nl, li, ip, first in SHARDED_MESH_CASES:
        spec, dims, inputs, res = main[name]
        single_ip = {k: v for k, v in ip.items() if k != "edge_reorder"} if ip else CS_BJ
        costs, counts, final = single_steps(spec, kind, dims, inputs,
                                            first if ip else nl, li, single_ip)
        out[label] = (costs[:first], counts[:first], res.final_cost if ip else final,
                      res.num_linear_iterations if ip else sum(counts))
    return out


def sharded_mesh_main_paths(ranks, single, gpu):
    """The graph, 3-D and several-space cases of the sharded ranks
    (SHARDED_MESH_CASES) held to the single-device solves on the card
    (``single``: sharded_mesh_references): every rank equal to rank 0, no
    fallback and no kernel launched, the plan report's path the sharded 3-D
    loop or the sharded graph loop, per CG apply two halo phases (3-D) or one
    all_to_all (graph: every group's and coupling's reads together), no
    all_gather but the result's, the first steps' costs within
    FIRST_STEPS_RTOL and their CG counts within SHARDED_ITER_RTOL, the global
    unknowns finite. Prints one mesh_exchange line a case (the
    communication per CG iteration, the exchanges' widths, ms per sharded
    CG iteration, the ranks' walls) and the final cost beside the
    single-device one (and the JAX CPU's where the script has it)."""
    jax_finals = {"arap": JAX_CPU_GRAPH_COSTS["arap36k"]["final"],
                  "embedded": JAX_CPU_SPEC_COSTS["embedded10k"]["costs"][-1]}
    for label, name, kind, nl, li, ip, n_first in SHARDED_MESH_CASES:
        cases = [r["mesh_cases"][label] for r in ranks]
        first = cases[0]
        costs, counts, final, lin = single[label]
        rel = [abs(a - b) / abs(b) for a, b in zip(first["costs"][:n_first], costs)]
        route = first["plan"]["route"]
        vol = name == "volumetric"
        iters = max(1, first["lin"])
        if vol:  # a halo strip's values: rows, then columns of the row-extended tile
            (r0, r1), (c0, c1) = route["tile"]
            (ah, aw), whole, ch = route["halo"], route["whole"], first["plan"]["channels"]
            widths = {"halo": [ah, aw], "row_strip": [ah, c1 - c0, *whole, ch],
                      "column_strip": [r1 - r0 + 2 * ah, aw, *whole, ch]}
        else:
            widths = [r["mesh_cases"][label]["plan"]["route"]["graphs"] for r in ranks]
        log(json.dumps({
            "mesh_exchange": label, "gpu": gpu, "mesh": list(MESH_SHAPE),
            "loop": first["plan"]["path"],
            "per_cg_iteration": {k: sum(first[k]) / iters
                                 for k in ("p2p_phases", "all_reduce", "all_to_all")},
            "exchange_widths": widths,
            "ms_per_sharded_cg_iter": [c["cg_ms"] / max(1, c["lin"]) for c in cases],
            "applies_per_cg_call": first["applies"],
            "wall_ms": [c["wall_ms"] for c in cases],
            "note": "four ranks on one card under gloo: not a scaling figure"}))
        log(json.dumps({
            "check": "sharded_mesh_main_path", "case": label, "mesh": list(MESH_SHAPE),
            "gpu": gpu, "variant": first["variant"], "vertices": route.get("vertices"),
            "first_costs": first["costs"][:n_first], "single_device_first_costs": costs,
            "first_rel_diff": rel, "first_cg_counts": first["iterations"][:n_first],
            "single_device_first_cg_counts": counts, "final_cost": first["cost"],
            "single_device_final_cost": final, "jax_cpu_final_cost": jax_finals.get(name),
            "lin_iters": first["lin"], "single_device_lin_iters": lin,
            "nonlinear_iters": first["steps"], "solve_counts": first["solve_counts"]}))
        log(json.dumps({"plan_summary": f"{label} (rank 0 of {MESH_SHAPE[0]}x{MESH_SHAPE[1]})",
                        **first["plan"]}))
        faults = []
        want_path = "sharded 3-D loop" if vol else "sharded graph loop"
        if first["plan"]["path"] != want_path or first["loops"] != [want_path]:
            faults.append(f"plan report path {first['plan']['path']!r}, loops {first['loops']}")
        if name == "cluster" and first["plan"].get("couplings", 0) < 1:
            faults.append("no coupling across vertex spaces in the plan")
        for r, c in zip(ranks, cases):
            if (c["cost"], c["lin"], c["costs"]) != (first["cost"], first["lin"], first["costs"]):
                faults.append(f"rank {r['rank']} parts from rank 0")
            if c["fused_fallback"] is not None or c["kernel_launches"]:
                faults.append(f"rank {r['rank']}: fallback {c['fused_fallback']}, "
                              f"{c['kernel_launches']} kernel launches")
            per_apply = c["p2p_phases"] if vol else c["all_to_all"]
            if (len(c["applies"]) != c["steps"]
                    or per_apply != [(2 if vol else 1) * a for a in c["applies"]]):
                faults.append(f"rank {r['rank']}: {per_apply} exchanges for {c['applies']} "
                              f"applies in {c['steps']} steps")
            if c["solve_counts"]["all_gather"] != c["unknowns"] or not c["unknowns_ok"]:
                faults.append(f"rank {r['rank']}: {c['solve_counts']['all_gather']} "
                              f"all_gathers, unknowns finite of the global shape: "
                              f"{c['unknowns_ok']}")
        if any(x > FIRST_STEPS_RTOL for x in rel) or len(rel) != n_first:
            faults.append(f"first costs {first['costs'][:n_first]} against {costs}")
        if any(abs(a - b) > SHARDED_ITER_RTOL * b
               for a, b in zip(first["iterations"][:n_first], counts)):
            faults.append(f"first CG counts {first['iterations'][:n_first]} against {counts}")
        if faults:
            raise RuntimeError(f"sharded {label}: " + "; ".join(faults))


def sharded_read_main_paths(ranks, single, gpu):
    """The grid specs that read Index, a SampledImage or a ComputedArray
    (SHARDED_READ_CASES), as the sharded ranks solved them, held to the
    single-device solves on the card under the same settings (``single``:
    label -> (each level's first steps' costs, their CG counts or None
    where the solve gives a level's count only, each level's final cost,
    each level's CG count)): each level's first steps' costs within
    FIRST_STEPS_RTOL and their CG counts within SHARDED_ITER_RTOL; a
    pyramid's level CG counts equal and its level final costs within
    GOLDEN_RTOL. Every rank equal to rank 0, its global
    unknowns bitwise among them; no fallback; the plan report's path the
    sharded loop on K5 with its registers; K5 launched once an apply, one
    apply a CG iteration. Prints each case's check, plan_summary (one a
    level) and mesh_exchange lines (ms a sharded CG iteration among
    them)."""
    for label, name, n, nl, li, ip, n_first in SHARDED_READ_CASES:
        cases = [r["read_cases"][label] for r in ranks]
        first = cases[0]
        s_first, s_counts, s_finals, s_lin = single[label]
        got_first = [lc[:n_first] for lc in first["level_costs"]]
        rel = [[abs(a - b) / abs(b) for a, b in zip(g, w)] for g, w in zip(got_first, s_first)]
        got_counts = [its[:n_first] for its in first["level_iterations"]]
        finals = [lc[-1] for lc in first["level_costs"]]
        final_rel = [abs(a - b) / abs(b) for a, b in zip(finals, s_finals)]
        iters = max(1, first["lin"])
        route = first["plans"][-1]["route"]
        (r0, r1), (c0, c1) = route["tile"]
        log(json.dumps({
            "mesh_exchange": label, "gpu": gpu, "mesh": list(MESH_SHAPE),
            "loop": first["plans"][-1]["path"],
            "per_cg_iteration": {k: sum(first[k]) / iters for k in ("p2p_phases", "all_reduce")},
            "tile": [r1 - r0, c1 - c0], "region": route["region"], "region_halo": route["halo"],
            "ms_per_sharded_cg_iter": [c["cg_ms"] / max(1, c["lin"]) for c in cases],
            "applies_per_cg_call": first["applies"], "wall_ms": [c["wall_ms"] for c in cases],
            "note": "four ranks on one card under gloo: not a scaling figure"}))
        log(json.dumps({
            "check": "sharded_main_path", "case": label, "mesh": list(MESH_SHAPE), "gpu": gpu,
            "variant": [first["plans"][-1]["cg_variant"], first["plans"][-1]["preconditioner"]],
            "first_costs": got_first, "single_device_first_costs": s_first,
            "first_rel_diff": rel, "first_cg_counts": got_counts,
            "single_device_first_cg_counts": s_counts, "level_final_costs": finals,
            "single_device_level_final_costs": s_finals, "level_final_rel_diff": final_rel,
            "level_lin_iters": first["level_lin"], "single_device_level_lin_iters": s_lin,
            "nonlinear_iters": first["steps"],
            "tile_kernel_launches": [c["tile_kernel_launches"] for c in cases],
            "solve_counts": first["solve_counts"],
            "ms_per_cg_iter": [c["solve_ms"] / max(1, c["lin"]) for c in cases]}))
        for k, summary in enumerate(first["plans"]):
            log(json.dumps({"plan_summary": f"{label} level {k} (rank 0 of "
                            f"{MESH_SHAPE[0]}x{MESH_SHAPE[1]})", **summary}))
        faults = []
        want_k5 = "tile_apply_kernel<float>"
        for k, summary in enumerate(first["plans"]):
            if (summary["path"] != "sharded loop" or summary["instance"] != want_k5
                    or summary["registers"] is None or summary["fused_fallback"] is not None):
                faults.append(f"level {k}'s plan report {summary}, expected the sharded loop on "
                              f"{want_k5} with its registers")
        for r, c in zip(ranks, cases):
            applies = sum(c["applies"])
            if (c["costs"], c["lin"], c["level_costs"], c["digest"]) != (
                    first["costs"], first["lin"], first["level_costs"], first["digest"]):
                faults.append(f"rank {r['rank']} parts from rank 0")
            if (c["fused_fallback"] != [None] * len(c["fused_fallback"]) or not c["kernel"]
                    or c["cg_calls"] != c["steps"] or c["loops"] != ["sharded loop"]):
                faults.append(f"rank {r['rank']}: fallback {c['fused_fallback']}, kernel "
                              f"{c['kernel']}, {c['cg_calls']} sharded calls for {c['steps']} "
                              f"steps, loops {c['loops']}")
            iterations = sum(map(sum, c["level_iterations"]))
            if c["tile_kernel_launches"] != applies or applies != iterations:
                faults.append(f"rank {r['rank']}: {c['tile_kernel_launches']} tile launches, "
                              f"{applies} applies, {iterations} CG iterations")
            if c["shape"][:2] != [n, n] or not c["finite"]:
                faults.append(f"rank {r['rank']}: unknowns {c['shape']}, finite {c['finite']}")
        if (any(x > FIRST_STEPS_RTOL for lv in rel for x in lv)
                or any(len(lv) != n_first for lv in rel)):
            faults.append(f"first costs {got_first} against {s_first}")
        if s_counts is not None and any(abs(a - b) > SHARDED_ITER_RTOL * b
                                        for g, w in zip(got_counts, s_counts)
                                        for a, b in zip(g, w)):
            faults.append(f"first CG counts {got_counts} against {s_counts}")
        if name == "flow" and (first["level_lin"] != s_lin
                               or any(x > GOLDEN_RTOL for x in final_rel)):
            faults.append(f"level finals {finals} after {first['level_lin']} CG iterations "
                          f"against {s_finals} after {s_lin}")
        if faults:
            raise RuntimeError(f"sharded {label}: " + "; ".join(faults))


def sharded_option_references():
    """The single-device solves on the card that SHARDED_OPTION_CASES are
    held to, under the same settings (edge_reorder aside), through the
    stepwise API: label -> (the held steps' costs, their CG counts). A
    float64 case's every step (the eager loop: no float64 instance of a
    fused CG kernel), a composed case's first steps (the eager loop on the
    composed operator), item 8f's first steps (the fused kernels)."""
    out = {}
    for label, name, kind, nl, li, ip, dbl, n_first, _rtol in SHARDED_OPTION_CASES:
        spec, dims, inputs = option_case_problem(name)
        single_ip = {k: v for k, v in ip.items() if k != "edge_reorder"}
        costs, counts, _final = single_steps(spec, kind, dims, inputs, n_first, li, single_ip,
                                             double_precision=dbl)
        out[label] = (costs[:n_first], counts[:n_first])
    return out


def sharded_option_main_paths(ranks, single, gpu):
    """The options a mesh takes since slice 27 (SHARDED_OPTION_CASES), as
    the sharded ranks solved them, held to the single-device solves on the
    card (``single``: sharded_option_references): the held steps' costs
    within F64_MESH_RTOL (float64) or FIRST_STEPS_RTOL, their CG counts
    within the case's tolerance (0: equal). Every rank equal to rank 0, its
    unknowns bitwise among them and finite; no fallback; the loop and the
    plan report's path and instance the case's: the sharded loop on K5
    (tile_apply_kernel<float> or <double>, launched once an apply, with its
    registers), the sharded graph loop, or the sharded composed loop, these
    with no kernel launched. Prints a check, mesh_exchange and plan_summary
    line a case. Returns the K5 launches of each case, summed over the
    ranks."""
    launches = {}
    for label, name, kind, nl, li, ip, dbl, n_first, count_rtol in SHARDED_OPTION_CASES:
        cases = [r["option_cases"][label] for r in ranks]
        first = cases[0]
        s_costs, s_counts = single[label]
        rel = [abs(a - b) / abs(b) for a, b in zip(first["costs"][:n_first], s_costs)]
        composed = not ip.get("use_fused_jtj", True)
        graph = name in ("robust", "arap")
        want_loop = ("sharded composed loop" if composed else
                     "sharded graph loop" if graph else "sharded loop")
        want_k5 = None if composed or graph else (
            "tile_apply_kernel<double>" if dbl else "tile_apply_kernel<float>")
        iters = max(1, first["lin"])
        log(json.dumps({
            "mesh_exchange": label, "gpu": gpu, "mesh": list(MESH_SHAPE), "loop": want_loop,
            "per_cg_iteration": {k: sum(first[k]) / iters
                                 for k in ("p2p_phases", "all_reduce", "all_to_all")},
            "ms_per_sharded_cg_iter": [c["cg_ms"] / max(1, c["lin"]) for c in cases],
            "applies_per_cg_call": first["applies"], "wall_ms": [c["wall_ms"] for c in cases],
            "note": "four ranks on one card under gloo: not a scaling figure"}))
        log(json.dumps({
            "check": "sharded_option_main_path", "case": label, "mesh": list(MESH_SHAPE),
            "gpu": gpu, "dtype": first["dtype"], "held_costs": first["costs"][:n_first],
            "single_device_held_costs": s_costs, "held_rel_diff": rel,
            "held_cg_counts": first["iterations"][:n_first],
            "single_device_held_cg_counts": s_counts, "final_cost": first["cost"],
            "lin_iters": first["lin"], "nonlinear_iters": first["steps"],
            "tile_kernel_launches": [c["tile_kernel_launches"] for c in cases],
            "solve_counts": first["solve_counts"]}))
        log(json.dumps({"plan_summary": f"{label} (rank 0 of {MESH_SHAPE[0]}x{MESH_SHAPE[1]})",
                        **first["plan"]}))
        faults = []
        plan = first["plan"]
        if (plan["path"] != want_loop or plan["instance"] != want_k5
                or (want_k5 is not None and plan["registers"] is None)
                or plan["fused_fallback"] is not None):
            faults.append(f"plan report {plan}, expected {want_loop} on {want_k5}")
        for r, c in zip(ranks, cases):
            applies = sum(c["applies"])
            if (c["costs"], c["lin"], c["digest"]) != (first["costs"], first["lin"],
                                                       first["digest"]):
                faults.append(f"rank {r['rank']} parts from rank 0")
            if (c["fused_fallback"] is not None or c["loops"] != [want_loop]
                    or len(c["applies"]) != c["steps"] or not c["finite"]
                    or c["dtype"] != ("torch.float64" if dbl else "torch.float32")):
                faults.append(f"rank {r['rank']}: fallback {c['fused_fallback']}, loops "
                              f"{c['loops']}, {len(c['applies'])} sharded calls for "
                              f"{c['steps']} steps, finite {c['finite']}, {c['dtype']}")
            want_launches = applies if want_k5 is not None else 0
            if c["tile_kernel_launches"] != want_launches or c["cg_kernel_launches"]:
                faults.append(f"rank {r['rank']}: {c['tile_kernel_launches']} K5 launches for "
                              f"{applies} applies ({want_launches} expected), "
                              f"{c['cg_kernel_launches']} CG kernel launches")
            if want_k5 is not None and c["kernel"] != [True] * c["steps"]:
                faults.append(f"rank {r['rank']}: a sharded call without K5: {c['kernel']}")
        tol = F64_MESH_RTOL if dbl else FIRST_STEPS_RTOL
        if any(x > tol for x in rel) or len(rel) != n_first:
            faults.append(f"held costs {first['costs'][:n_first]} against {s_costs}")
        if any(abs(a - b) > count_rtol * b for a, b in zip(first["iterations"][:n_first],
                                                           s_counts)):
            faults.append(f"held CG counts {first['iterations'][:n_first]} against {s_counts}")
        if faults:
            raise RuntimeError(f"sharded {label}: " + "; ".join(faults))
        launches[label] = sum(c["tile_kernel_launches"] for c in cases)
    return launches


# the timer's rows of a sharded CG iteration (utils/timer.py): K5, the halo
# phases, the collectives; PCGStep1 is the loop's own work besides them
SPLIT_ROWS = {"k5": "tileApply", "halo_phases": "haloExchange", "all_reduces": "allReduce",
              "all_to_alls": "allToAll"}


def sharded_split(ranks, gpu):
    """The timed sharded solve (TIMED_SHARDED_CASE, collect_per_kernel_timing)
    against its untimed solve in SHARDED_CASES: bitwise (costs, CG count,
    unknowns' digest) on every rank; every rank keeps its rows, rank 0
    printed the reference's table, TIMING and Per-iter lines, the others
    nothing. Prints one sharded_split line: each rank's ms a sharded CG
    iteration split into K5 (tileApply), the halo phases (haloExchange),
    the all_reduces (allReduce) and the rest (PCGStep1: the loop's vector
    updates and local dot sums), with their entries a CG iteration, and
    rank 0's printed table. A row's entries outside the CG loop (the
    region's extension after a solve, the cost's all_reduce) count in it
    too: a few a step against the loop's few a CG iteration."""
    label = SHARDED_CASES[TIMED_SHARDED_CASE][0]
    faults, split = [], []
    for r in ranks:
        t, u = r["timed"], r["cases"][label]
        if (t["costs"], t["lin"], t["digest"]) != (u["costs"], u["lin"], u["digest"]):
            faults.append(f"rank {r['rank']}: timed {t['costs']} / {t['lin']} against the "
                          f"untimed {u['costs']} / {u['lin']}, digests equal "
                          f"{t['digest'] == u['digest']}")
        rows, lin = t["rows"], max(1, t["lin"])
        need = ("PCGStep1", "tileApply", "haloExchange", "allReduce")
        if any(k not in rows for k in need) or any(ms < 0 for _c, ms in rows.values()):
            faults.append(f"rank {r['rank']}: rows {sorted(rows)}")
            continue
        if rows["tileApply"][0] != t["tile_kernel_launches"] or rows["PCGStep1"][0] != t["lin"]:
            faults.append(f"rank {r['rank']}: {rows['tileApply'][0]} tileApply entries for "
                          f"{t['tile_kernel_launches']} K5 launches, PCGStep1 "
                          f"{rows['PCGStep1'][0]} for {t['lin']} CG iterations")
        printed = "TIMING " in t["printed"] and "Per-iter times ms" in t["printed"]
        if printed != (r["rank"] == 0):
            faults.append(f"rank {r['rank']}: printed the table: {printed}")
        part = {k: rows[row][1] / lin for k, row in SPLIT_ROWS.items() if row in rows}
        part["rest"] = rows["PCGStep1"][1] / lin
        split.append({"rank": r["rank"], "ms_per_cg_iter": part,
                      "total_ms_per_cg_iter": sum(part.values()),
                      "entries_per_cg_iter": {k: rows[row][0] / lin for k, row in
                                              SPLIT_ROWS.items() if row in rows},
                      "solve_ms": rows["overall"][1], "lin_iters": t["lin"]})
    log(json.dumps({"sharded_split": label, "gpu": gpu, "mesh": list(MESH_SHAPE),
                    "ranks": split, "timed_by": "CUDA events on each rank's stream",
                    "note": "four ranks on one card under gloo: not a scaling figure"}))
    log("rank 0's timing table of the timed sharded solve:\n"
        + ranks[0].get("timed", {}).get("printed", "").rstrip())
    if faults:
        raise RuntimeError(f"timed sharded {label}: " + "; ".join(faults))
    return split


def iw_targets(inputs):
    """The fit constraints of an image_warping input as (row, column,
    target row, target column): where the Constraints image is not -1."""
    con = inputs["Constraints"]
    rows, cols = np.nonzero((con != -1).any(-1))
    return [(float(i), float(j), float(con[i, j, 0]), float(con[i, j, 1]))
            for i, j in zip(rows, cols)]


def iw_constraint_image(mask, targets, alpha):
    """examples/image_warping.py's WarpSolver.constraint_image (the
    reference's setConstraintImage, CombinedSolver.h:181-205): each
    constraint at (1 - alpha) of its rest position and alpha of its target,
    where the mask leaves its point solved; -1 elsewhere."""
    h, w = mask.shape
    con = -np.ones((h, w, 2), np.float32)
    for x, y, tx, ty in targets:
        xi, yi = int(x), int(y)
        if 0 <= xi < h and 0 <= yi < w and mask[xi, yi] == 0:
            con[xi, yi] = [(1 - alpha) * x + alpha * tx, (1 - alpha) * y + alpha * ty]
    return con


def harness_main_path(inputs, gpu):
    """The example harness (opt_tpu_torch/harness.py) at full width: a
    CombinedSolverBase app of image_warping on ``inputs`` (512x512), GN and
    LM, nonLinearIter 8, linearIter 400, HARNESS_OUTER outer solves with
    examples/image_warping.py's constraint annealing, collect_timing on (a
    TIMING table a solve). Held: every plan without fallback, one gn_tiled
    or lm_tiled launch a step taken and nothing else, and each kind's first
    outer solve bitwise equal (cost and unknowns) to a direct Plan.solve of
    the same inputs in this call. Prints the Final Costs block."""
    n = inputs["Mask"].shape[0]
    targets = iw_targets(inputs)
    mask = inputs["Mask"]
    first, steps, fallbacks = {}, {}, []

    class WarpApp(CombinedSolverBase):
        collect_timing = True

        def combined_solve_init(self):
            self.problem_inputs = dict(inputs)

        def pre_single_solve(self):
            self.problem_inputs["Offset"] = inputs["UrShape"].copy()
            self.problem_inputs["Angle"] = np.zeros(mask.shape, np.float32)

        def pre_nonlinear_solve(self, i):
            alpha = (i + 1) / self.solver_params["numIter"]
            self.problem_inputs["Constraints"] = iw_constraint_image(mask, targets, alpha)

        def post_nonlinear_solve(self, i):
            kind = self.plan.kind
            steps[kind] = steps.get(kind, 0) + int(self.plan._state["n_iter"])
            fallbacks.append(self.plan.fused_fallback)
            if i == 0:
                first[kind] = {k: self.problem_inputs[k].clone() for k in ("Offset", "Angle")}

    app = WarpApp(image_warping, _grid(n),
                  {"numIter": HARNESS_OUTER, "nonLinearIter": 8, "linearIter": 400})
    app.add_opt_solvers(["gaussNewtonGPU", "LMGPU"])
    fused_cg.reset_launch_counts()
    t0 = time.perf_counter()
    runs = app.solve_all()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {k: v for k, v in fused_cg.fused_grid_cg_kernel.launches.items() if v}
    app.report_final_costs()
    direct = {}
    for kind in ("gaussNewtonGPU", "LMGPU"):
        res = ot.Problem(image_warping, kind=kind).plan(dims=_grid(n)).solve(
            dict(inputs, Constraints=iw_constraint_image(mask, targets, 1 / HARNESS_OUTER)),
            nIterations=8, lIterations=400)
        direct[kind] = (res.final_cost, all(torch.equal(res.unknowns[k], first[kind][k])
                                            for k in first[kind]))
    line = {"check": "harness", "case": f"image_warping{n} GN and LM {HARNESS_OUTER} x 8x400",
            "gpu": gpu, "runs": {r.name: [it.cost for it in r.iterations] for r in runs},
            "outer_ms": {r.name: [it.duration_ms for it in r.iterations] for r in runs},
            "kernel_launches": launched, "steps": steps, "fused_fallback": fallbacks,
            "direct_first_costs": {k: v[0] for k, v in direct.items()},
            "first_outer_bitwise_to_direct": {
                k: v[1] and v[0] == runs[i].iterations[0].cost for i, (k, v) in
                enumerate(direct.items())},
            "wall_s": wall}
    log(json.dumps(line))
    if (any(f is not None for f in fallbacks)
            or launched != {"gn_tiled": steps["gaussNewtonGPU"], "lm_tiled": steps["LMGPU"]}
            or not all(line["first_outer_bitwise_to_direct"].values())
            or not all(np.isfinite(it.cost) for r in runs for it in r.iterations)):
        raise RuntimeError(f"the harness's image_warping run failed: {line}")


def timed_main_path(label, spec, dims, inputs, nl, li, untimed, kernel_ms, gpu, ip=None):
    """One more GN solve of a main path with collect_per_kernel_timing
    (its table printed), the launch counts from 0: bitwise the untimed
    solve ``untimed`` of this call; PCGStep1's count its CG iterations; no
    row negative and the rows' sum at most the whole; its instances those
    launched (or the eager loop once a step where none was); its plan
    summary (the plan report, one line) naming the instance that launched.
    ``kernel_ms``: the kernel's ms a CG iteration by time_pair in this call,
    printed beside PCGStep1's average. Returns (the plan, the result)."""
    fused_cg.reset_launch_counts()
    plan = ot.Problem(spec).plan(dims=dims, init_params=ot.InitializationParameters(
        collect_per_kernel_timing=True, **(ip or {})))
    res = plan.solve(dict(inputs), nIterations=nl, lIterations=li)
    torch.cuda.synchronize()
    launched = {k: v for k, v in fused_cg.fused_grid_cg_kernel.launches.items() if v}
    rows, ran = plan._timing_phases, plan._timing_instances
    steps = max(1, res.num_iterations)
    summary = plan_summary(plan, inputs, plan.solver_params)
    kernels = sum(st.total_ms for k, st in rows.items() if k not in ("other", "overall"))
    line = {"timed_main_path": label, "gpu": gpu,
            "clock": "cuda_events" if plan.device.type == "cuda" else "host",
            "rows": {k: {"count": st.count, "total_ms": st.total_ms, "avg_ms": st.average_ms}
                     for k, st in rows.items()},
            "ms_per_step": {k: st.total_ms / steps for k, st in rows.items()
                            if k not in ("PCGStep1", "other", "overall")},
            "assembly_ms_per_step": sum(rows[k].total_ms for k in ASSEMBLY_ROWS if k in rows)
            / steps,
            "pcg_step1_ms_per_cg_iter": rows["PCGStep1"].average_ms,
            "time_pair_kernel_ms_per_cg_iter": kernel_ms, "instances": ran,
            "kernel_launches": launched, "nonlinear_iters": res.num_iterations,
            "lin_iters": res.num_linear_iterations, "solve_ms": res.wall_time_s * 1e3}
    log(json.dumps(line))
    log(json.dumps({"plan_summary": label, **summary}))
    want_ran = launched or {"eager loop": res.num_iterations}
    want_instance = next(iter(launched)) if len(launched) == 1 else None
    faults = []
    if (res.costs != untimed.costs or res.final_cost != untimed.final_cost
            or (res.num_iterations, res.num_linear_iterations)
            != (untimed.num_iterations, untimed.num_linear_iterations)
            or not all(torch.equal(res.unknowns[k], untimed.unknowns[k]) for k in res.unknowns)):
        faults.append("not bitwise the untimed solve")
    if rows["PCGStep1"].count != res.num_linear_iterations:
        faults.append("PCGStep1 does not count the CG iterations")
    if any(st.total_ms < 0 for st in rows.values()) or kernels > rows["overall"].total_ms:
        faults.append("a negative row, or rows beyond the whole")
    if ran != want_ran or summary["instance"] != want_instance:
        faults.append(f"instances {ran}, plan {summary['instance']}, launched {launched}")
    if faults:
        raise RuntimeError(f"timed {label}: " + "; ".join(faults))
    return plan, res


def checkpoint_main_path(inputs, gpu):
    """Checkpoint/resume on the card: image_warping 512x512 LM 8x400 by
    steps, CKPT_STEPS steps, save, restore into a fresh plan, the rest:
    bitwise equal (unknowns, cost, counts) to the uninterrupted 8 steps,
    each step one lm_tiled launch."""
    n = inputs["Mask"].shape[0]

    def mk():
        return ot.Problem(image_warping, kind="LMGPU").plan(dims=_grid(n), nIterations=8,
                                                            lIterations=400)

    def run(plan, k):
        for _ in range(k):
            plan.step()
        return plan

    fused_cg.reset_launch_counts()
    ref = mk()
    ref.init(dict(inputs))
    run(ref, 8)
    half = mk()
    half.init(dict(inputs))
    run(half, CKPT_STEPS)
    path = checkpoint.save(os.path.join(CKPT_DIR, f"image_warping{n}_lm"), half)
    fresh = mk()
    checkpoint.restore(path, fresh, inputs=dict(inputs))
    run(fresh, 8 - CKPT_STEPS)
    torch.cuda.synchronize()
    launched = {k: v for k, v in fused_cg.fused_grid_cg_kernel.launches.items() if v}
    same = (all(torch.equal(fresh.unknowns[k], ref.unknowns[k]) for k in ref.unknowns)
            and fresh.current_cost() == ref.current_cost()
            and all(int(fresh._state[k]) == int(ref._state[k]) for k in ("n_iter", "lin_iters")))
    # a launch a step: the uninterrupted steps, and the interrupted ones
    # before and after the save (the restored count included the former)
    steps = int(ref._state["n_iter"]) + int(fresh._state["n_iter"])
    line = {"check": "checkpoint_resume", "case": f"image_warping{n} LM 8x400, saved after "
            f"{CKPT_STEPS} steps", "gpu": gpu, "bitwise_to_uninterrupted": same,
            "final_cost": fresh.current_cost(), "uninterrupted_cost": ref.current_cost(),
            "lin_iters": int(fresh._state["lin_iters"]), "kernel_launches": launched,
            "files": sorted(os.listdir(path))}
    log(json.dumps(line))
    shutil.rmtree(path)
    if not same or launched != {"lm_tiled": steps}:
        raise RuntimeError(f"checkpoint resume failed: {line}")


def c_api_main_path(gpu):
    """The C API on the card: build libopttpu_torch.so and the port's C
    client (opt_tpu_torch/native/build.py), run the client at each of
    C_API_SIZES, side by side, with OPT_TPU_TORCH_DEVICE unset (so the
    card), and hold each run: exit 0 and PASS; the bridge's line names the
    kernel path, gn_tiled and no fallback, one gn_tiled launch a step; the
    final cost and the written-back X bitwise equal to the same solve in
    this process through opt_tpu_torch.api (init, step until 0) on the A
    the client wrote; A the one JAX_CPU_C_API was computed on, and the
    final cost within C_API_RTOL of the JAX package's. Returns {side: the
    client's launches}."""
    import hashlib

    from opt_tpu_torch import api
    from opt_tpu_torch.native.build import BUILD_DIR, build_native, run_client

    info = build_native()
    log(json.dumps({"c_api_build": {"built": info["built"], "seconds": info["seconds"]}}))
    spec_path = os.path.join(os.path.dirname(os.path.abspath(__file__)), C_API_SPEC)
    runs, faults = {}, []
    # the clients side by side, each a process of its own on the card
    with concurrent.futures.ThreadPoolExecutor(len(C_API_SIZES)) as pool:
        clients = {n: pool.submit(run_client, n, n, C_API_NL, C_API_LI,
                                  BUILD_DIR / f"client_{n}.bin", timeout=300)
                   for n in C_API_SIZES}
        clients = {n: f.result() for n, f in clients.items()}
    for n, run in clients.items():
        if run["rc"] != 0 or "PASS" not in run["stdout"] or run["solve"] is None or run["A"] is None:
            raise RuntimeError(f"C client at {n}x{n}: rc {run['rc']}\n{run['stdout'][-3000:]}"
                               f"\n{run['stderr'][-3000:]}")
        A, solve = run["A"], run["solve"]
        # the same solve in this process, as the client runs it
        fused_cg.reset_launch_counts()
        state = api.new_state()
        plan = api.problem_plan(state, api.problem_define(state, spec_path), {"W": n, "H": n})
        api.set_solver_parameter(plan, "nIterations", C_API_NL)
        api.set_solver_parameter(plan, "lIterations", C_API_LI)
        t0 = time.perf_counter()
        api.problem_init(plan, {"X": A.copy(), "A": A.copy()})
        while api.problem_step(plan):
            api.problem_current_cost(plan)
        X = plan.unknowns["X"].cpu().numpy().reshape(n, n)
        wall = time.perf_counter() - t0
        cost, n_iter = api.problem_current_cost(plan), int(plan._state["n_iter"])
        launched = {k: v for k, v in fused_cg.fused_grid_cg_kernel.launches.items() if v}
        ref = JAX_CPU_C_API[n]
        sha = hashlib.sha256(A.tobytes()).hexdigest()[:16]
        rel = abs(run["final_cost"] - ref["final_cost"]) / ref["final_cost"]
        runs[n] = {"client_wall_s": run["wall_s"], "client_solve_s": solve["wall_s"],
                   "in_process_solve_s": wall, "init_cost": run["init_cost"],
                   "nonlinear_steps": n_iter,
                   "final_cost": run["final_cost"], "in_process_final_cost": cost,
                   "jax_cpu_final_cost": ref["final_cost"], "rel_diff_jax": rel,
                   "path": solve["path"], "instance": solve["instance"],
                   "fused_fallback": solve["fused_fallback"], "device": solve["device"],
                   "client_launches": solve["launches"], "in_process_launches": launched}
        if solve["path"] != "kernel" or solve["instance"] != "gn_tiled" or solve["fused_fallback"]:
            faults.append(f"{n}: the client's plan ran {solve['path']} {solve['instance']} "
                          f"(fallback {solve['fused_fallback']})")
        if solve["launches"] != launched or launched != {"gn_tiled": n_iter}:
            faults.append(f"{n}: launches {solve['launches']} in the client, {launched} here")
        if np.float32(run["final_cost"]) != np.float32(cost) or not np.array_equal(
                run["X"].view(np.uint32), X.astype(np.float32).view(np.uint32)):
            faults.append(f"{n}: not bitwise the in-process solve ({run['final_cost']} vs {cost})")
        if sha != ref["a_sha256"]:
            faults.append(f"{n}: A drawn here is not the A of JAX_CPU_C_API ({sha})")
        elif not rel <= C_API_RTOL:
            faults.append(f"{n}: final cost {run['final_cost']} vs the JAX package's "
                          f"{ref['final_cost']} (rel {rel:.3g})")
    log(json.dumps({"c_api": {"build_s": info["seconds"], "built": info["built"],
                              "runs": runs, "gpu": gpu}}))
    if faults:
        raise RuntimeError("C API: " + "; ".join(faults))
    return {n: r["client_launches"] for n, r in runs.items()}


TILED_NAMES = frozenset(fused_cg.instance_name(*k) for k in fused_cg.TILED_INSTANCES)


def _snapshot(inputs):
    """A copy of a solve's inputs: an app replaces or changes them later."""
    if isinstance(inputs, torch.Tensor):
        return inputs.clone()
    if isinstance(inputs, np.ndarray):
        return inputs.copy()
    if isinstance(inputs, dict):
        return {k: _snapshot(v) for k, v in inputs.items()}
    return inputs


@contextlib.contextmanager
def recorded_solves():
    """Within: every Plan.solve, Plan.solve_scheduled and PyramidPlan.solve
    recorded, in order, on the yielded list: {how, plan, inputs (a copy),
    kw, res, and the schedule, or the pyramid's first level's (cost, CG
    count)}."""
    calls = []
    solve, scheduled, pyramid = ot.Plan.solve, ot.Plan.solve_scheduled, ot.PyramidPlan.solve

    def rec_solve(self, inputs, **kw):
        snap = _snapshot(inputs)
        res = solve(self, inputs, **kw)
        calls.append({"how": "solve", "plan": self, "inputs": snap, "kw": kw, "res": res})
        return res

    def rec_scheduled(self, inputs, schedule, num_outer, **kw):
        snap = _snapshot(inputs)
        res = scheduled(self, inputs, schedule, num_outer, **kw)
        calls.append({"how": "scheduled", "plan": self, "inputs": snap, "kw": kw, "res": res,
                      "schedule": schedule, "num_outer": num_outer})
        return res

    def rec_pyramid(self, level_inputs, **kw):
        snap = _snapshot(level_inputs[0])
        res = pyramid(self, level_inputs, **kw)
        calls.append({"how": "pyramid", "plan": self.plans[0], "plans": self.plans,
                      "inputs": snap, "kw": kw, "res": res,
                      "level0": (self.level_costs[0][-1], self.level_lin_iters[0])})
        return res

    ot.Plan.solve, ot.Plan.solve_scheduled, ot.PyramidPlan.solve = (rec_solve, rec_scheduled,
                                                                    rec_pyramid)
    try:
        yield calls
    finally:
        ot.Plan.solve, ot.Plan.solve_scheduled, ot.PyramidPlan.solve = solve, scheduled, pyramid


@contextlib.contextmanager
def capped_depth(cut):
    """Within: a harness app's (numIter, nonLinearIter) capped at ``cut``
    (None: as the app sets them)."""
    init = CombinedSolverBase.__init__

    def capped(self, spec_fn, dims, params):
        params = dict(params)
        params["numIter"] = min(int(params.get("numIter", 1)), cut[0])
        params["nonLinearIter"] = min(int(params.get("nonLinearIter", 10)), cut[1])
        init(self, spec_fn, dims, params)

    if cut is not None:
        CombinedSolverBase.__init__ = capped
    try:
        yield
    finally:
        CombinedSolverBase.__init__ = init


def first_solve_direct(call):
    """The app's first solve (``call``, :func:`recorded_solves`) run again
    as a direct Plan.solve on a fresh plan of the same spec, kind, dims,
    dtype, init and solver parameters, on the same inputs (a scheduled
    solve's first outer solve: the constants its schedule gives at i = 0; a
    pyramid's: its first level), launch counts from 0. Returns (the app's
    (cost, CG count or None), the direct result, its initial cost, its
    launches, the instance the first step's system routes to)."""
    plan = call["plan"]
    direct = ot.Problem(plan.problem.spec_fn, kind=plan.kind).plan(
        dims=plan.dims, double_precision=plan.compiled.dtype == torch.float64,
        init_params=plan.solver.ip, device=str(plan.device),
        **{**plan.solver_params, **call["kw"]})
    inputs = dict(call["inputs"])
    if call["how"] == "scheduled":
        consts = direct._normalize_and_place(inputs)[1]
        inputs.update(call["schedule"](consts, torch.tensor(0, dtype=torch.int32,
                                                            device=direct.device)))
        app = (call["res"].costs[0], None)
    elif call["how"] == "pyramid":
        app = call["level0"]
    else:
        app = (call["res"].final_cost, call["res"].num_linear_iterations)
    meta, r0, _pre, kw = direct.cg_inputs(inputs)
    pb = kw["pre_blocks"]
    routed = fused_cg.launch_instance(
        meta, fused_cg.pack(r0, meta), lm=plan.kind == "LMGPU",
        cs=kw["cg_variant"] == "chronopoulos_gear",
        pre_blocks=None if pb is None else fused_cg.pack_pre_blocks(pb, meta))
    direct.init(inputs)
    initial = direct.current_cost()
    fused_cg.reset_launch_counts()
    res = direct.solve(inputs)
    torch.cuda.synchronize()
    launches = {k: v for k, v in fused_cg.fused_grid_cg_kernel.launches.items() if v}
    return app, res, initial, launches, routed


def example_main_path(app, gpu):
    """One example app (opt_tpu_torch/examples/<app>.py) in-process without
    --small (the synthetic fallback's sizes unless OPT_TPU_EXAMPLE_DATA
    names the reference's data), through main(argv), in a working directory of its
    own with --results inside it, launch counts from 0. Held: every cost it
    prints finite; no plan with a fallback; every launch of one instance,
    the one its first step's system routes to (a Hopper instance where the
    route has one); its first solve bitwise a direct Plan.solve of the same
    spec, kind and inputs (:func:`first_solve_direct`), which ends at or
    below its initial cost (but for EXAMPLE_RISES). Prints one line;
    returns the app's launches."""
    import importlib
    import io
    import tempfile

    mod = importlib.import_module(f"opt_tpu_torch.examples.{app}")
    os.makedirs(EXAMPLES_DIR, exist_ok=True)
    here = os.getcwd()
    out = io.StringIO()
    with tempfile.TemporaryDirectory(dir=EXAMPLES_DIR) as work:
        os.chdir(work)
        try:
            with recorded_solves() as calls, capped_depth(EXAMPLE_CUTS.get(app)), \
                    contextlib.redirect_stdout(out):
                fused_cg.reset_launch_counts()
                t0 = time.perf_counter()
                mod.main(["--results", os.path.join(work, "results")])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            launched = {k: v for k, v in fused_cg.fused_grid_cg_kernel.launches.items() if v}
            written = sorted(os.listdir(work))
        finally:
            os.chdir(here)
    text = out.getvalue()
    lines = text.splitlines()
    if "**Final Costs**" in lines:
        block = lines[lines.index("**Final Costs**") + 1:]
        costs = {ln.split(": ")[0]: float(ln.split(": ")[1])
                 for ln in itertools.takewhile(lambda ln: ": " in ln, block)}
    else:
        costs = {"final": float(text.split("final cost")[1].strip(": ").split()[0])}
    first = calls[0]
    (app_cost, app_lin), res, initial, direct_launches, routed = first_solve_direct(first)
    bitwise = res.final_cost == app_cost and app_lin in (None, res.num_linear_iterations)
    if first["how"] == "solve":
        bitwise = bitwise and res.costs == first["res"].costs and all(
            torch.equal(res.unknowns[k], first["res"].unknowns[k]) for k in res.unknowns)
    plans = [p for c in calls for p in c.get("plans", [c["plan"]])]
    fallbacks = sorted({str(p.fused_fallback) for p in plans})
    sp = {**first["plan"].solver_params, **first["kw"]}
    outer = sum(c["num_outer"] if c["how"] == "scheduled" else 1 for c in calls)
    line = {"check": "example_app", "app": app, "gpu": gpu, "dims": first["plan"].dims,
            "depth": {"solves": outer, "how": first["how"], "nIterations": sp["nIterations"],
                      "lIterations": sp["lIterations"], "cut": EXAMPLE_CUTS.get(app)},
            "wall_s": wall, "final_costs": costs, "instances": launched,
            "hopper": routed in TILED_NAMES, "routed": routed, "fused_fallback": fallbacks,
            "first_solve": {"app_cost": app_cost, "direct_cost": res.final_cost,
                            "initial_cost": initial, "bitwise": bitwise,
                            "direct_instances": direct_launches,
                            "rise_expected": EXAMPLE_RISES.get(app)},
            "written": written}
    log(json.dumps(line))
    faults = []
    if not costs or not all(np.isfinite(list(costs.values()))):
        faults.append(f"final costs {costs}")
    if fallbacks != ["None"]:
        faults.append(f"fallbacks {fallbacks}")
    if set(launched) != {routed} or set(direct_launches) != {routed}:
        faults.append(f"launched {launched}, the direct solve {direct_launches}, routed {routed}")
    if not bitwise:
        faults.append(f"first solve {app_cost} ({app_lin} CG) against the direct "
                      f"{res.final_cost} ({res.num_linear_iterations})")
    if not (res.final_cost <= initial or app in EXAMPLE_RISES):
        faults.append(f"first solve ends at {res.final_cost}, above its initial {initial}")
    if faults:
        raise RuntimeError(f"example {app}: " + "; ".join(faults))
    return launched


def start_dryrun():
    """dryrun_multichip(ENTRY_RANKS) on the card (opt_tpu_torch/entry.py),
    its ranks started now by the spawn method, from the repository root,
    to run beside the example apps; :func:`entry_main_path` collects them."""
    from opt_tpu_torch import entry

    entry.prepare_device(None)
    return entry.start_ranks(entry.dryrun_rank, ENTRY_RANKS)


def entry_main_path(gpu, dryrun):
    """opt_tpu_torch/entry.py on the card: entry()'s step (fn(*example_args))
    bitwise a one-step Plan.solve of the same inputs (X, cost, CG count) in
    the same single launch of its instance; the ranks of
    dryrun_multichip(ENTRY_RANKS) (``dryrun``, :func:`start_dryrun`) on 2x2
    gloo ranks on the card, each of whose checks passed, every rank
    agreeing, with the tile kernel (K5) launched at every CG apply of both
    grid solves on every rank. Returns {"step": its launches, case: K5's
    launches summed over the ranks}."""
    from opt_tpu_torch import entry

    fn, args = entry.entry()
    fused_cg.reset_launch_counts()
    state = fn(*args)
    torch.cuda.synchronize()
    step_launches = {k: v for k, v in fused_cg.fused_grid_cg_kernel.launches.items() if v}
    fused_cg.reset_launch_counts()
    res = ot.Problem(image_warping).plan(dims=_grid(64)).solve(entry._warp_inputs(64),
                                                               nIterations=1)
    torch.cuda.synchronize()
    solve_launches = {k: v for k, v in fused_cg.fused_grid_cg_kernel.launches.items() if v}
    bitwise = (float(state["prev_cost"]) == res.final_cost
               and int(state["lin_iters"]) == res.num_linear_iterations
               and all(torch.equal(state["X"][k], res.unknowns[k]) for k in res.unknowns))
    t0 = time.perf_counter()
    ranks = entry.collect_ranks(dryrun)
    wall = time.perf_counter() - t0
    cases = ("grid", "grid_cs_bj", "graph")
    line = {"check": "entry", "gpu": gpu, "step_cost": float(state["prev_cost"]),
            "solve_cost": res.final_cost, "step_lin_iters": int(state["lin_iters"]),
            "step_bitwise_to_solve": bitwise, "step_launches": step_launches,
            "solve_launches": solve_launches, "dryrun_wait_s": wall,
            "dryrun": {c: {"costs": [r[c]["cost"] for r in ranks],
                           "lin_iters": [r[c]["lin"] for r in ranks],
                           **({"applies": [r[c]["applies"] for r in ranks],
                               "tile_kernel_launches": [r[c]["tile_kernel_launches"]
                                                        for r in ranks],
                               "variant": ranks[0][c]["variant"],
                               "x_digest": ranks[0][c]["x_digest"]} if c != "graph" else {})}
                       for c in cases}}
    log(json.dumps(line))
    faults = []
    if not bitwise or step_launches != solve_launches or sum(step_launches.values()) != 1:
        faults.append(f"step {line['step_cost']} ({step_launches}) against the one-step solve "
                      f"{res.final_cost} ({solve_launches}), bitwise {bitwise}")
    for c in cases:
        if len({(r[c]["cost"], r[c]["lin"]) for r in ranks}) != 1:
            faults.append(f"{c}: the ranks part")
    for c in ("grid", "grid_cs_bj"):
        if any(r[c]["tile_kernel_launches"] != r[c]["applies"] or r[c]["applies"] < 1
               for r in ranks):
            faults.append(f"{c}: K5 not launched at every CG apply of every rank")
    if faults:
        raise RuntimeError("entry: " + "; ".join(faults))
    return {"step": step_launches,
            **{c: sum(r[c]["tile_kernel_launches"] for r in ranks) for c in cases[:2]}}


def main() -> int:
    t_start = time.perf_counter()
    phases = {}  # seconds of each phase of this run
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_line()
    log(f"gpu: {gpu}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    nv = subprocess.run([nvcc_path(), "--version"], capture_output=True, text=True, check=True)
    log(f"nvcc: {nv.stdout.strip().splitlines()[-1]}")

    # 1. build: every unit by its own nvcc process, all started together from
    # a thread, then one link, while the host makes the first checks' inputs
    # and systems (their assembly launches no CG kernel)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        building = pool.submit(build_library)
        n = MAIN_N
        inputs = bench_poisson_inputs(n)
        meta, b, pre, _, _ = system(poisson_image_editing, _grid(n), inputs)
        lap = system(laplacian, _grid(n), laplacian_inputs(n))
        pbig = system(poisson_image_editing, _grid(BIG_N), bench_poisson_inputs(BIG_N))
        iw_in = bench_image_warping_inputs(IW_N)
        iw_big_in = bench_image_warping_inputs(IW_BIG_N)
        mmeta, mb, mpre, _, _ = system(image_warping, _grid(IW_N), iw_in)
        vmeta, vb, vpre, vlm, _ = system(image_warping, _grid(IW_N), iw_in, "LMGPU")
        gmeta, gb, gpre, _, _ = system(image_warping, _grid(IW_BIG_N), iw_big_in)
        wmeta, wb, wpre, wlm, _ = system(image_warping, _grid(IW_BIG_N), iw_big_in, "LMGPU")
        arap_dims, arap_in = arap_grid_inputs(ARAP_SIDE)
        arm_dims, arm_in = armadillo_inputs()
        spec_in = {label: GRAPH_SPECS[label][2](SPEC_SIDE) for label in GRAPH_SPECS}
        dyn_in = dynamic_topologies(arap_in)
        cl_dims, cl_in = cluster_arap_inputs(ARAP_SIDE, CLUSTER)
        iw_mask_in = bench_image_warping_inputs(IW_N)
        iw_mask_in["Mask"][IW_N // 4 : IW_N // 2, IW_N // 4 : IW_N // 2] = 1.0  # excluded
        prep_s = time.perf_counter() - t0
        info = building.result()
    load_library()
    log(f"build: {'built' if info['built'] else 'cached'} {info['path'].name} in "
        f"{time.perf_counter() - t0:.2f} s ({info['seconds']:.2f} s of nvcc; the first "
        f"inputs and systems made meanwhile in {prep_s:.2f} s)")
    regs = instance_registers(info["log"])
    log(json.dumps({"registers": {fused_cg.instance_name(*k): v[0] for k, v in sorted(regs.items())},
                    "spill_store_bytes": {fused_cg.instance_name(*k): v[1]
                                          for k, v in sorted(regs.items()) if v[1]},
                    "tiled_registers_spill_store_load_bytes": {
                        fused_cg.instance_name(*k): list(regs[k])
                        for k in fused_cg.TILED_INSTANCES if k in regs},
                    "build_s": info["seconds"], "units_s": info["units_s"]}))
    want = len(fused_cg.INSTANCES) + len(fused_cg.TILED_INSTANCES)
    if len(regs) != want:
        raise RuntimeError(f"ptxas reported {len(regs)} instances, expected {want}")
    off_cap = {fused_cg.instance_name(*k): v[0] for k, v in regs.items()
               if len(k) == 7 and v[0] != (40 if k[1] else 32)}
    if off_cap:  # the caps of __launch_bounds__: 8 blocks per SM, the remainder 6
        raise RuntimeError(f"instances off their register cap: {off_cap}")
    # the sharded main paths (3b): 2x2 ranks on the card, the tile kernel
    # (K5), started as soon as the library is built and read after the
    # goldens, beside every check and solve of this process but the timings
    log("sharded solves: 4 ranks started by the spawn method, a 2x2 mesh under gloo, all "
        "four on the one card (NCCL refuses two ranks on one device), beside this process's "
        "checks and solves; their times are of four ranks sharing one card, not a scaling "
        "figure")
    from opt_tpu_torch import entry

    sharded = entry.start_ranks(
        functools.partial(sharded_work, cases=SHARDED_CASES, mesh_cases=SHARDED_MESH_CASES,
                          read_cases=SHARDED_READ_CASES, option_cases=SHARDED_OPTION_CASES,
                          timed_case=TIMED_SHARDED_CASE), 4, "cuda:0")

    phases["start_and_build"] = time.perf_counter() - t_start - sum(phases.values())
    # 2. each kernel form against its twin at the main paths' shapes; the
    # 2-D float32 GN and LM systems at 512x512 take the tiled kernel (their
    # plans printed), at 1024x1024x3 in its hbm layout, poisson 2048x2048x4
    # the template
    tiled_line(f"poisson{n}x4", meta, b)
    tiled_line(f"laplacian{n}", *lap[:2])
    tiled_line(f"image_warping{IW_N}x3 GN", mmeta, mb)
    tiled_line(f"image_warping{IW_N}x3 LM", vmeta, vb, vlm)
    for label, (m_, b_, lm_) in {f"image_warping{IW_BIG_N}x3 GN": (gmeta, gb, None),
                                 f"image_warping{IW_BIG_N}x3 LM": (wmeta, wb, wlm)}.items():
        if tiled_line(label, m_, b_, lm_)["layout"] != "hbm":
            raise RuntimeError(f"{label}: not in the tiled kernel's hbm layout")
    if fused_cg.route_plan(pbig[0], pbig[1], lm=False) is not None:
        raise RuntimeError(f"poisson{BIG_N}x4: takes the tiled kernel, whose tiles it overflows")
    log(f"poisson {n}x{n}x4: {meta['F'].shape[0]} fields, {len(meta['triples'])} triples")
    err_gn = kernel_vs_twin(f"poisson{n}x4", meta, b, pre, 50, 0.0, bitwise=True, template=True)
    kernel_vs_twin(f"poisson{n}x4", meta, b, pre, 2000, CG_TOL, bitwise=True)
    kernel_vs_twin(f"laplacian{n}", *lap[:3], 50, 0.0, bitwise=True)
    kernel_vs_twin(f"laplacian{n}", *lap[:3], 2000, CG_TOL, bitwise=True)
    kernel_vs_twin(f"poisson{BIG_N}x4", *pbig[:3], 50, 0.0)
    kernel_vs_twin(f"poisson{BIG_N}x4", *pbig[:3], 200, CG_TOL)
    del lap, pbig
    bitwise_repeat(f"poisson{n}x4", meta, b, pre, 300)

    cross = sum(1 for (_d, i, j, _f) in mmeta["triples"] if i != j)
    log(f"image_warping {IW_N}x{IW_N}x3: {mmeta['F'].shape[0]} fields, "
        f"{len(mmeta['triples'])} triples, {cross} cross-channel")
    # the tiled instances, and the template's gn and lm on the same twin results
    err_mixed = kernel_vs_twin(f"image_warping{IW_N}x3", mmeta, mb, mpre, 50, 0.0, bitwise=True,
                               template=True)
    kernel_vs_twin(f"image_warping{IW_N}x3", mmeta, mb, mpre, 400, CG_TOL, bitwise=True,
                   template=True)
    bitwise_repeat(f"image_warping{IW_N}x3", mmeta, mb, mpre, 400)
    err_lm = kernel_vs_twin(f"image_warping{IW_N}x3", vmeta, vb, vpre, 50, 0.0, vlm,
                            q_tol=float("-inf"), bitwise=True, template=True)
    kernel_vs_twin(f"image_warping{IW_N}x3", vmeta, vb, vpre, 400, CG_TOL, vlm, bitwise=True,
                   template=True)
    bitwise_repeat(f"image_warping{IW_N}x3", vmeta, vb, vpre, 400, vlm)
    # the tiled kernel on a radius-2 stencil (a halo of 2), on a grid its
    # tiles leave ragged in both axes and on a grid of one tile, GN and LM,
    # with the Jacobi and the block-Jacobi preconditioner (the C*C planes
    # staged over each tile and its halo), by Chronopoulos-Gear and with
    # bfloat16 fields (each of these two with the template's instance held to
    # the same twin results)
    bj = {"preconditioner": "block_jacobi"}
    cs, bf = {"cg_variant": "chronopoulos_gear"}, {"coefficient_dtype": "bfloat16"}
    tiled_forms = (({}, ""), (bj, " block_jacobi"), (cs, " chronopoulos_gear"),
                   (bf, " bfloat16"))
    r2 = system(radius2_spec, _grid(n), radius2_inputs(n))
    for ip, pl in tiled_forms:
        label = f"radius2 {n}x{n}{pl}"
        sys_ = system(radius2_spec, _grid(n), radius2_inputs(n), **ip) if ip else r2
        if tiled_line(label, sys_[0], sys_[1], pre_blocks=sys_[4]["pre_blocks"],
                      cs=sys_[4]["cs"])["halo"] != 2:
            raise RuntimeError("the radius-2 stencil must take a halo of 2")
        variant_checks(label, sys_, 50, 400, bitwise=True, template=ip is cs or ip is bf)
    del sys_
    rag_in = bench_image_warping_inputs(RAGGED_DIMS["W"], RAGGED_DIMS["H"])
    one_in = bench_image_warping_inputs(SINGLE_N)
    for (kind, label), (ip, pl) in itertools.product(
            (("gaussNewtonGPU", "GN"), ("LMGPU", "LM")), tiled_forms):
        new = ip is cs or ip is bf  # this PR's forms, also held on the template
        rag = system(image_warping, RAGGED_DIMS, rag_in, kind, **ip)
        rlabel = f"image_warping {RAGGED_DIMS['W']}x{RAGGED_DIMS['H']} {label}{pl}"
        plan = tiled_line(rlabel, rag[0], rag[1], rag[3], rag[4]["pre_blocks"], rag[4]["cs"])
        (th, tw), (tr, tc) = plan["tile"], plan["tiles"]
        if RAGGED_DIMS["W"] % th == 0 or RAGGED_DIMS["H"] % tw == 0 or tr * tc < 2:
            raise RuntimeError(f"image_warping {RAGGED_DIMS}: tiles {plan} are not ragged")
        variant_checks(rlabel, rag, 50, 400, bitwise=True, template=new)
        one = system(image_warping, _grid(SINGLE_N), one_in, kind, **ip)
        olabel = f"image_warping{SINGLE_N} {label}{pl}"
        if tiled_line(olabel, one[0], one[1], one[3], one[4]["pre_blocks"],
                      one[4]["cs"])["tiles"] != (1, 1):
            raise RuntimeError(f"image_warping{SINGLE_N}: not one tile")
        variant_checks(olabel, one, 50, 400, bitwise=True, template=new)
    del rag, one
    # K6: image_warping 1024x1024x3 on the tiled kernel's hbm layout
    # (gn_hbm_tiled, lm_hbm_tiled), the template's gn and lm held to the same
    # twin results
    err_k6 = kernel_vs_twin(f"image_warping{IW_BIG_N}x3", gmeta, gb, gpre, 50, 0.0,
                            bitwise=True, template=True)
    kernel_vs_twin(f"image_warping{IW_BIG_N}x3", gmeta, gb, gpre, 100, CG_TOL, bitwise=True,
                   template=True)
    bitwise_repeat(f"image_warping{IW_BIG_N}x3", gmeta, gb, gpre, 100)
    kernel_vs_twin(f"image_warping{IW_BIG_N}x3", wmeta, wb, wpre, 50, 0.0, wlm,
                   q_tol=float("-inf"), bitwise=True, template=True)
    kernel_vs_twin(f"image_warping{IW_BIG_N}x3", wmeta, wb, wpre, 100, CG_TOL, wlm,
                   bitwise=True, template=True)
    bitwise_repeat(f"image_warping{IW_BIG_N}x3", wmeta, wb, wpre, 100, wlm)
    # the hbm layout forced where the resident state would fit, so that
    # every tile edge case runs in it: image_warping 512x512x3, on a grid its
    # tiles leave ragged, and the radius-2 stencil (a halo of 2), GN and LM
    for kind, klabel in (("gaussNewtonGPU", "GN"), ("LMGPU", "LM")):
        for label, spec, dims, hin in (
                (f"image_warping{IW_N}x3", image_warping, _grid(IW_N), iw_in),
                (f"image_warping {RAGGED_DIMS['W']}x{RAGGED_DIMS['H']}", image_warping,
                 RAGGED_DIMS, rag_in),
                (f"radius2 {n}x{n}", radius2_spec, _grid(n), radius2_inputs(n))):
            hm, hb, hp, hlm, _v = system(spec, dims, hin, kind)
            flabel = f"{label} {klabel} forced hbm"
            with forced_hbm(hm, hb, hlm):
                if tiled_line(flabel, hm, hb, hlm)["layout"] != "hbm":
                    raise RuntimeError(f"{flabel}: not in the hbm layout")
                kernel_vs_twin(flabel, hm, hb, hp, 50, 0.0, hlm, bitwise=True,
                               **({"q_tol": float("-inf")} if hlm else {}))
                kernel_vs_twin(flabel, hm, hb, hp, 400, CG_TOL, hlm, bitwise=True)
    del hm, hb, hp, hlm

    # the graph forms on the graph kernel, each in the GN and the LM instance,
    # with the template's held bitwise to the same twin results: K3 (DIA,
    # the grid mesh: gn_dia_tiled and lm_dia_tiled, the fields streamed,
    # against gn and lm) and K4 (the remainder, the armadillo: gn_rem_tiled
    # and lm_rem_tiled, the fields staged, against gn_rem and lm_rem)
    graph = {}
    for label, dims, gin, layout in (("arap36k", arap_dims, arap_in, "stream"),
                                     ("armadillo31k", arm_dims, arm_in, "resident")):
        gm = system(arap_mesh_deformation, dims, gin)
        glm = system(arap_mesh_deformation, dims, gin, "LMGPU")
        rem = gm[0]["rem"]
        for klabel, (m_, b_, lm_) in (("GN", gm[:2] + (None,)), ("LM", glm[:2] + glm[3:4])):
            if graph_plan_line(f"{label} {klabel}", m_, b_, lm_)["layout"] != layout:
                raise RuntimeError(f"{label} {klabel}: not in the graph kernel's {layout} layout")
        offsets = sorted({d[1] for (d, _i, _j, _f) in gm[0]["triples"]})
        log(json.dumps({"graph_system": label, "vertices": dims["N"],
                        "fields": int(gm[0]["F"].shape[0]), "triples": len(gm[0]["triples"]),
                        "offsets": offsets,
                        "remainder_entries": None if rem is None else int(rem["col"].shape[0]),
                        "remainder_max_row": None if rem is None
                        else int((rem["rowptr"][1:] - rem["rowptr"][:-1]).max())}))
        held = dict(bitwise=True, template=True)
        err = kernel_vs_twin(label, *gm[:3], 50, 0.0, **held)
        kernel_vs_twin(label, *gm[:3], GRAPH_LI, CG_TOL, **held)
        kernel_vs_twin(label, *glm[:3], 50, 0.0, glm[3], q_tol=float("-inf"), **held)
        kernel_vs_twin(label, *glm[:3], GRAPH_LI, CG_TOL, glm[3], **held)
        bitwise_repeat(label, *gm[:3], GRAPH_LI)
        bitwise_repeat(label, *glm[:3], GRAPH_LI, glm[3])
        graph[label] = (gm, glm, err)
    if graph["arap36k"][0][0]["rem"] is not None or graph["armadillo31k"][0][0]["rem"] is None:
        raise RuntimeError("the grid mesh must take the DIA form and the armadillo the remainder")
    # the stream layout on grid meshes whose halo is larger than a range, one
    # of them ragged, and on one range, GN and LM, each with the template's
    # instance on the same twin results
    for rows, cols in DIA_MESHES:
        ddims, din = arap_grid_inputs(rows, cols)
        for kind, klabel in (("gaussNewtonGPU", "GN"), ("LMGPU", "LM")):
            gs = system(arap_mesh_deformation, ddims, din, kind)
            dlabel = f"arap grid {rows}x{cols} {klabel}"
            if graph_plan_line(dlabel, *gs[:2], gs[3])["layout"] != "stream":
                raise RuntimeError(f"{dlabel}: not in the graph kernel's stream layout")
            variant_checks(dlabel, gs, 50, GRAPH_LI, bitwise=True, template=True)
    # and on one vertex of two channels, offset 0 only (one range, two
    # live lanes): the medium golden's curve_fitting system, GN and LM,
    # whose loop reaches an exact zero residual before 50 iterations even
    # with no exit
    cdims_m, cin_m = medium_inputs()["curve_fitting"]
    for kind, klabel in (("gaussNewtonGPU", "GN"), ("LMGPU", "LM")):
        gs = system(curve_fitting, cdims_m, cin_m, kind)
        dlabel = f"curve_fitting medium {klabel}"
        if graph_plan_line(dlabel, *gs[:2], gs[3])["layout"] != "stream":
            raise RuntimeError(f"{dlabel}: not in the graph kernel's stream layout")
        variant_checks(dlabel, gs, 50, MEDIUM_GOLDENS["curve_fitting"][3], bitwise=True,
                       template=True, early=True)
    del gs, din, cin_m
    # the graph kernel on a 300-vertex random mesh (one system, all
    # remainder) and on the DIA-plus-remainder grid mesh, GN and LM, each
    # with the template's instance on the same twin results
    rdims1, rin1 = random_mesh_inputs(RANDOM_MESH_N, 1)
    rin1 = instance_inputs(rin1, ("Offset", "Angle"), 0)
    ddims, din = dense_grid_mesh_inputs(DENSE_SIDE)
    for label, dims, gin in ((f"random{RANDOM_MESH_N}", rdims1, rin1),
                             (f"dense_grid{DENSE_SIDE}", ddims, din)):
        for kind, klabel in (("gaussNewtonGPU", "GN"), ("LMGPU", "LM")):
            gs = system(arap_mesh_deformation, dims, gin, kind)
            offsets = sorted({d[1] for (d, _i, _j, _f) in gs[0]["triples"]} - {0})
            if gs[0]["rem"] is None or bool(offsets) != label.startswith("dense"):
                raise RuntimeError(f"{label}: not the expected remainder form ({offsets})")
            graph_plan_line(f"{label} {klabel}", *gs[:2], gs[3])
            variant_checks(f"{label} {klabel}", gs, 50, GRAPH_LI, bitwise=True, template=True)
    del rin1, din
    # the three other graph specs at bench size on the graph kernel, GN and
    # LM, with the template's instances on the same twin results: odd
    # channel counts (cotangent C = 3 with the remainder, the fields staged;
    # robust_nonrigid C = 7 streamed, its graph group over 6 of its 7
    # channels) and embedded's C = 12; and the odd-C multi form
    spec_sys = {label: spec_kernel_checks(label, *spec_in[label]) for label in GRAPH_SPECS}
    odd_multi_checks()

    # the 3-D grid form (K1 e) and its block-Jacobi form (K1 d) on the 3-D
    # grid kernel (gn_vol_tiled, gn_bj_vol_tiled), with the template's gn
    # and gn_bj held to the same twin results, and on forced splits whose
    # boxes are uneven or one point wide; 64^3 (its fields do not fit a box)
    # and LM keep the template, by name; and the variants (K1 c, d, f), each
    # held to the twin: 50 iterations with no exit, the real exits, a
    # bitwise repeat
    vol_in = volumetric_inputs(VOL_N)
    vol_big_in = volumetric_inputs(VOL_BIG_N)
    vsys = system(volumetric_mesh_deformation, _vol(VOL_N), vol_in)
    log(f"volumetric {VOL_N}^3 x 6: {vsys[0]['F'].shape[0]} fields, "
        f"{len(vsys[0]['triples'])} triples")
    vol_plan_line(f"volumetric{VOL_N}", *vsys[:2])
    err_3d = variant_checks(f"volumetric{VOL_N}", vsys, 50, 400, bitwise=True, template=True)
    vbj = system(volumetric_mesh_deformation, _vol(VOL_N), vol_in, **bj)
    vol_plan_line(f"volumetric{VOL_N} block_jacobi", *vbj[:2], vbj[4]["pre_blocks"])
    err_bj = variant_checks(f"volumetric{VOL_N} block_jacobi", vbj, 50, 400, bitwise=True,
                            template=True)
    # the medium golden's 6^3 system on the planner's own split, one box of
    # the whole grid (one block, a haloed frame of 8^3 = 512 points, one a
    # thread), Jacobi and block-Jacobi, each with the template's instance on
    # the same twin results; a small system may reach an exact zero early
    vdims_m, vin_m = medium_inputs()["volumetric_mesh_deformation"]
    for pl, ip in (("", {}), (" block_jacobi", bj)):
        ms_ = system(volumetric_mesh_deformation, vdims_m, vin_m, **ip)
        mlabel_ = f"volumetric medium 6^3{pl}"
        if tuple(vol_plan_line(mlabel_, *ms_[:2], ms_[4]["pre_blocks"])["boxes"]) != (1, 1, 1):
            raise RuntimeError(f"{mlabel_}: not one box of the whole grid")
        variant_checks(mlabel_, ms_, 50, MEDIUM_GOLDENS["volumetric_mesh_deformation"][3],
                       bitwise=True, template=True, early=True)
    del ms_, vin_m
    forced = {}  # each grid's systems, made once for its splits
    for shape, boxes in VOL_FORCED:
        for pl, ip in (("", {}), (" block_jacobi", bj)):
            if (shape, pl) not in forced:
                forced[(shape, pl)] = system(volumetric_mesh_deformation, _vol(shape),
                                             volumetric_inputs(shape), **ip)
            fs = forced[(shape, pl)]
            flabel = (f"volumetric {'x'.join(map(str, shape))}{pl} forced "
                      f"{'x'.join(map(str, boxes))}")
            plan = forced_vol_plan(fs[0], fs[1], boxes, fs[4]["pre_blocks"])
            vol_plan_line(flabel, *fs[:2], fs[4]["pre_blocks"], plan=plan)
            with forced_route(plan):  # a small system may reach an exact zero early
                variant_checks(flabel, fs, 50, 400, bitwise=True, early=True)
    del fs, forced
    for kind in ("gaussNewtonGPU", "LMGPU"):
        big = system(volumetric_mesh_deformation, _vol(VOL_BIG_N), vol_big_in, kind)
        name = "lm" if big[3] else "gn"
        if (fused_cg.route_plan(big[0], big[1], lm=bool(big[3])) is not None
                or form_of(big[0], big[1], big[3]) != name):
            raise RuntimeError(f"volumetric{VOL_BIG_N} {name}: not on the template")
        variant_checks(f"volumetric{VOL_BIG_N}", big, 50, 400)
    del big
    # poisson and image_warping by Chronopoulos-Gear and with bfloat16 fields
    # (image_warping also under block-Jacobi), GN and LM: the tiled instances,
    # and the template's on the same twin results
    pcs = system(poisson_image_editing, _grid(n), inputs, **cs)
    tiled_line(f"poisson{n}x4 chronopoulos_gear", pcs[0], pcs[1], cs=True)
    err_cs = variant_checks(f"poisson{n}x4 chronopoulos_gear", pcs, 50, 2000, bitwise=True,
                            template=True)
    pbf = system(poisson_image_editing, _grid(n), inputs, **bf)
    if pbf[0]["F"].dtype != torch.bfloat16:
        raise RuntimeError("coefficient_dtype='bfloat16' did not narrow the fields")
    tiled_line(f"poisson{n}x4 bfloat16", pbf[0], pbf[1])
    err_bf = variant_checks(f"poisson{n}x4 bfloat16", pbf, 50, 2000, bitwise=True, template=True)
    iw_variants, iw_errs = {}, {}
    for kind, label in (("gaussNewtonGPU", "GN"), ("LMGPU", "LM")):
        for ip in (cs, bj, bf):
            (v,) = ip.values()
            sysv = system(image_warping, _grid(IW_N), iw_in, kind, **ip)
            vlabel = f"image_warping{IW_N}x3 {label} {v}"
            tiled_line(vlabel, sysv[0], sysv[1], sysv[3], sysv[4]["pre_blocks"], sysv[4]["cs"])
            iw_errs[(label, v)] = variant_checks(vlabel, sysv, 50, 400, bitwise=True,
                                                 template=True)
            iw_variants[(label, v)] = sysv
    err_lm_bj = iw_errs[("LM", "block_jacobi")]
    for ip in ({"cg_variant": "chronopoulos_gear"}, {"preconditioner": "block_jacobi"},
               {"coefficient_dtype": "bfloat16"}):
        (v,) = ip.values()
        gsys = system(arap_mesh_deformation, arap_dims, arap_in, **ip)
        variant_checks(f"arap36k {v}", gsys, 50, GRAPH_LI)
    arm_bf = system(arap_mesh_deformation, arm_dims, arm_in, coefficient_dtype="bfloat16")
    if arm_bf[0]["rem"] is None or arm_bf[0]["rem"]["blk"].dtype != torch.bfloat16:
        raise RuntimeError("the armadillo's bfloat16 remainder blocks are missing")
    variant_checks("armadillo31k bfloat16", arm_bf, 50, GRAPH_LI)
    del arm_bf

    # the remaining grid specs: K1 (g), the ComputedArray system of
    # shape_from_shading; K1 (a) at optical_flow's and intrinsic's shapes;
    # and K2, poisson 1024x1024x4 split into four one-channel systems
    sfs_in = sfs_inputs(SFS_N)
    ssys = system(shape_from_shading, _grid(SFS_N), sfs_in)
    log(f"shape_from_shading {SFS_N}x{SFS_N}: {ssys[0]['F'].shape[0]} fields, "
        f"{len(ssys[0]['triples'])} triples")
    tiled_line(f"shape_from_shading{SFS_N}", *ssys[:2])
    err_sfs = variant_checks(f"shape_from_shading{SFS_N}", ssys, 50, 400, bitwise=True)
    flow_in = flow_levels(FLOW_N)
    fsys = system(optical_flow, _grid(FLOW_N), flow_in[-1])
    log(f"optical_flow {FLOW_N}x{FLOW_N}x2: {fsys[0]['F'].shape[0]} fields, "
        f"{len(fsys[0]['triples'])} triples")
    tiled_line(f"optical_flow{FLOW_N}x2", *fsys[:2])
    variant_checks(f"optical_flow{FLOW_N}x2", fsys, 50, 400, bitwise=True)
    intr_in = intrinsic_inputs(INTR_N)
    isys = system(intrinsic_image_decomposition, _grid(INTR_N), intr_in)
    log(f"intrinsic {INTR_N}x{INTR_N}x4: {isys[0]['F'].shape[0]} fields, "
        f"{len(isys[0]['triples'])} triples")
    tiled_line(f"intrinsic{INTR_N}x4", *isys[:2])
    variant_checks(f"intrinsic{INTR_N}x4", isys, 50, 400, bitwise=True)
    split_in = bench_poisson_inputs(SPLIT_N)
    psplit = system(poisson_image_editing, _grid(SPLIT_N), split_in)
    if not psplit[0]["chan_grid"] or meta["chan_grid"] or mmeta["chan_grid"]:
        raise RuntimeError(f"the planner must split poisson {SPLIT_N}x{SPLIT_N}x4 and neither "
                           f"poisson {n}x{n}x4 nor image_warping")
    log(f"poisson {SPLIT_N}x{SPLIT_N}x4 split: {n_systems(psplit[0])} systems, "
        f"{psplit[0]['F'].shape[0]} fields, {len(psplit[0]['triples'])} triples a system")
    # the split's one-channel systems in turn on the tiled kernel
    # (gn_multi_tiled, lm_multi_tiled), the template's gn_multi and lm_multi
    # held to the same twin results
    tiled_line(f"poisson{SPLIT_N}x4 split GN", *psplit[:2])
    err_split = variant_checks(f"poisson{SPLIT_N}x4 split", psplit, 50, 2000, bitwise=True,
                               template=True)
    # the first GN step's counts a channel, with the real exits (held to the
    # twin's just above): the main path's count must be their sum
    split_counts = fused_cg.fused_grid_cg_kernel(*psplit[:3], 2000, CG_TOL)[1].tolist()
    psplit_lm = system(poisson_image_editing, _grid(SPLIT_N), split_in, "LMGPU")
    if not psplit_lm[0]["chan_grid"]:
        raise RuntimeError(f"the planner must split poisson {SPLIT_N}x{SPLIT_N}x4 under LM")
    tiled_line(f"poisson{SPLIT_N}x4 split LM", *psplit_lm[:2], psplit_lm[3])
    variant_checks(f"poisson{SPLIT_N}x4 split", psplit_lm, 50, 2000, bitwise=True,
                   template=True)
    del psplit_lm
    # the split forced where it does not engage by default: poisson on a
    # grid its tiles leave ragged, and a three-channel radius-2 stencil (a
    # halo of 2), GN and LM
    for label, spec, dims, sin, planes, exit_lits in (
            (f"poisson {RAGGED_DIMS['W']}x{RAGGED_DIMS['H']}x4 forced split",
             poisson_image_editing, RAGGED_DIMS,
             bench_poisson_inputs(RAGGED_DIMS["W"], m=RAGGED_DIMS["H"]), 30, 2000),
            (f"radius2 {n}x{n}x3 forced split", radius2_rgb_spec, _grid(n),
             radius2_rgb_inputs(n), 20, 400)):
        for kind, klabel in (("gaussNewtonGPU", "GN"), ("LMGPU", "LM")):
            with forced_split(planes, dims):
                fsplit = system(spec, dims, sin, kind)
            if not fsplit[0]["chan_grid"]:
                raise RuntimeError(f"{label}: not split")
            tiled_line(f"{label} {klabel}", *fsplit[:2], fsplit[3])
            variant_checks(f"{label} {klabel}", fsplit, 50, exit_lits, bitwise=True,
                           template=True)
    del fsplit

    # K1 (h), the batch axis: 512 curve-fit systems (2 elements each) and 4
    # laplacian 16x16 systems side by side, GN, LM, Chronopoulos-Gear and
    # bfloat16, each system held to the twin and to its own one-system
    # launch. GN and LM take the batch kernel (gn_batch_tiled,
    # lm_batch_tiled: a team of 2 lanes a curve fit, 16 a warp; a warp a
    # laplacian system), the template's gn_batch and lm_batch held to the
    # same twin results; Chronopoulos-Gear and bfloat16 keep the template's
    # block a system. And 4 poisson 512x512x4 systems with their own
    # fields, in turn
    curve_truths, curve_in = batched_curve_inputs(BATCH_B, BATCH_N)
    cdims = {"N": BATCH_N, "U": 1}
    lap_in = laplacian_batch_inputs(LAP_BATCH_N, LAP_BATCH_B)
    batch_cases = [
        (f"curve_fitting x{BATCH_B}", curve_fitting, cdims, curve_in, BATCH_LI,
         [("GN", "gaussNewtonGPU", {}), ("LM", "LMGPU", {}), ("LM cs", "LMGPU", cs),
          ("LM bf16", "LMGPU", bf)]),
        (f"laplacian{LAP_BATCH_N} x{LAP_BATCH_B}", laplacian, _grid(LAP_BATCH_N), lap_in, 400,
         [("GN", "gaussNewtonGPU", {}), ("LM", "LMGPU", {}), ("GN cs", "gaussNewtonGPU", cs),
          ("GN bf16", "gaussNewtonGPU", bf)]),
    ]
    for label, spec, dims, binp, exit_lits, forms in batch_cases:
        for flabel, kind, ip in forms:
            sysb = batched_system(spec, dims, binp, kind, **ip)
            team = not ip  # the standard loop, Jacobi, float32: the batch kernel
            if team:
                batch_plan_line(f"{label} {flabel}", sysb)
            elif not form_of(sysb[0], sysb[1], sysb[3], **sysb[4]).endswith("_batch"):
                raise RuntimeError(f"{label} {flabel}: not the block-per-system form")
            want = fused_cg.instance_name(kind == "LMGPU", False, batch=True, tiled=True)
            err = batch_checks(f"{label} {flabel}", sysb, 50, exit_lits, template=team,
                               form=want if team else None)
            if spec is curve_fitting and flabel == "LM":
                err_batch, curve_lm = err, sysb
    pbatch_in = batched_poisson_inputs(n, BATCH_POISSON_B)
    pbatch = batched_system(poisson_image_editing, _grid(n), pbatch_in)
    log(f"poisson {n}x{n}x4 x{BATCH_POISSON_B}: {pbatch[0]['F'].shape[1]} fields a system")
    # the systems in turn on the tiled kernel (gn_multi_tiled), each also
    # against its own one-system launch (gn_tiled, the same tiles), the
    # template's gn_multi held to the same twin results
    tiled_line(f"poisson{n}x4 x{BATCH_POISSON_B}", *pbatch[:2])
    err_pbatch = batch_checks(f"poisson{n}x4 x{BATCH_POISSON_B}", pbatch, 50, 2000,
                              form="gn_multi_tiled", template=True)

    # K1 (h) x K4 and K1 (h) x K1 (d): the batch forms with the remainder and
    # with the block preconditioner. The block-per-system form on 64
    # deformations of a 300-vertex random mesh (sent to that form: their
    # remainder blocks count past BATCH_BLOCK_ELEMS) and on 4 of a 40-vertex
    # one (each system also against its own one-block launch), and on the
    # curve fits under block-Jacobi; the multi-system form on the armadillo
    # x4 and on image_warping 512x512 x4 under block-Jacobi, each system
    # also against its own one-system launch (the same grid; image_warping's
    # take the tiled kernel, the systems in turn, each against its own
    # one-system tiled launch, with the template's gn_bj_multi and
    # lm_bj_multi held to the same twin results)
    rdims, rin = random_mesh_inputs(RANDOM_MESH_N, RANDOM_MESH_B)
    sdims, sin = random_mesh_inputs(SMALL_MESH_N, SMALL_MESH_B)
    rlabel = f"random{RANDOM_MESH_N} x{RANDOM_MESH_B}"
    slabel = f"random{SMALL_MESH_N} x{SMALL_MESH_B}"
    gn, lmk = "gaussNewtonGPU", "LMGPU"
    batch_sys = {}
    with batch_form("batch"):
        # (label, dims, inputs, kind, InitializationParameters, lits, exit
        # lits, each system against its own launch, instance); the
        # Chronopoulos-Gear case reuses the GN system (the assembly does not
        # depend on the loop)
        small = (SMALL_MESH_LITS, SMALL_MESH_EXIT_LITS, True)
        for label, dims, binp, kind, ip, lits, exit_lits, single, form in (
                (f"{rlabel} GN", rdims, rin, gn, {}, RANDOM_MESH_LITS, RANDOM_MESH_EXIT_LITS,
                 False, "gn_rem_batch"),
                (f"{rlabel} LM", rdims, rin, lmk, {}, RANDOM_MESH_LITS, RANDOM_MESH_EXIT_LITS,
                 False, "lm_rem_batch"),
                (f"{slabel} GN", sdims, sin, gn, {}, *small, "gn_rem_batch"),
                (f"{slabel} GN cs", sdims, sin, gn, cs, *small, "gn_cs_rem_batch"),
                (f"{slabel} LM", sdims, sin, lmk, {}, *small, "lm_rem_batch"),
                (f"{slabel} LM bf16", sdims, sin, lmk, bf, *small, "lm_bf16_rem_batch"),
                (f"{slabel} GN block_jacobi", sdims, sin, gn, bj, *small, "gn_bj_rem_batch")):
            if ip is cs:
                sysb = sysb[:4] + (dict(sysb[4], cs=True),)
            else:
                sysb = batched_system(arap_mesh_deformation, dims, binp, kind, **ip)
            batch_checks(label, sysb, lits, exit_lits, single=single, form=form)
            if label.startswith(rlabel):
                batch_sys[form] = (label, sysb)
        del sdims, sin
    for flabel, kind, form in (("GN", gn, "gn_bj_batch"), ("LM", lmk, "lm_bj_batch")):
        label = f"curve_fitting x{BATCH_B} {flabel} block_jacobi"
        sysb = batched_system(curve_fitting, cdims, curve_in, kind, **bj)
        batch_checks(label, sysb, 50, BATCH_LI, form=form)
        batch_sys[form] = (label, sysb)
    arm_bdims, arm_bin = armadillo_batch_inputs()
    iw_bin = iw_batch_inputs(IW_N, IW_BJ_BATCH_B)
    alabel = f"armadillo31k x{len(ARM_BATCH_PULLS)}"
    ilabel = f"image_warping{IW_N}x3 x{IW_BJ_BATCH_B}"
    # a batch of 3 on a grid the tiles leave ragged, and of the radius-2
    # stencil (a halo of 2) with its own fields an instance, under the Jacobi
    # preconditioner: the tiled kernel's systems in turn (gn_multi_tiled,
    # lm_multi_tiled)
    rag_bin = iw_batch_inputs(RAGGED_DIMS["W"], 3, RAGGED_DIMS["H"])
    r2w_bin = radius2w_batch_inputs(n, 3)
    rglabel = f"image_warping {RAGGED_DIMS['W']}x{RAGGED_DIMS['H']}x3 x3"
    r2label = f"radius2w {n}x{n} x3"
    multi_sys = {}
    for label, spec, dims, binp, kind, ip, exit_lits, form in (
            (f"{alabel} GN", arap_mesh_deformation, arm_bdims, arm_bin, gn, {}, GRAPH_LI,
             "gn_rem_multi_tiled"),
            (f"{alabel} LM", arap_mesh_deformation, arm_bdims, arm_bin, lmk, {}, GRAPH_LI,
             "lm_rem_multi_tiled"),
            (f"{alabel} GN bf16", arap_mesh_deformation, arm_bdims, arm_bin, gn, bf, GRAPH_LI,
             "gn_bf16_rem_multi"),
            (f"{alabel} GN block_jacobi", arap_mesh_deformation, arm_bdims, arm_bin, gn, bj,
             GRAPH_LI, "gn_bj_rem_multi"),
            (f"{ilabel} GN block_jacobi", image_warping, _grid(IW_N), iw_bin, gn, bj, 400,
             "gn_bj_multi_tiled"),
            (f"{ilabel} LM block_jacobi", image_warping, _grid(IW_N), iw_bin, lmk, bj, 400,
             "lm_bj_multi_tiled"),
            (f"{ilabel} LM cs block_jacobi", image_warping, _grid(IW_N), iw_bin, lmk,
             cs, 400, "lm_cs_bj_multi"),
            (f"{ilabel} LM", image_warping, _grid(IW_N), iw_bin, lmk, {}, 400, "lm_multi_tiled"),
            (f"{rglabel} GN", image_warping, RAGGED_DIMS, rag_bin, gn, {}, 400, "gn_multi_tiled"),
            (f"{rglabel} LM", image_warping, RAGGED_DIMS, rag_bin, lmk, {}, 400,
             "lm_multi_tiled"),
            (f"{r2label} GN", radius2w_spec, _grid(n), r2w_bin, gn, {}, 400, "gn_multi_tiled"),
            (f"{r2label} LM", radius2w_spec, _grid(n), r2w_bin, lmk, {}, 400,
             "lm_multi_tiled")):
        if ip is cs:  # the LM block-Jacobi system, by Chronopoulos-Gear
            sysm = sysm[:4] + (dict(sysm[4], cs=True),)
        else:
            sysm = batched_system(spec, dims, binp, kind, **ip)
        if spec is radius2w_spec and bool((sysm[0]["F"][0] == sysm[0]["F"][1]).all()):
            raise RuntimeError(f"{label}: the instances' fields are the same")
        tiled = form.endswith("_tiled")
        if tiled and sysm[0]["rem"] is not None:
            graph_plan_line(label, *sysm[:2], sysm[3])
        elif tiled:
            tiled_line(label, sysm[0], sysm[1], sysm[3], sysm[4]["pre_blocks"])
        err = batch_checks(label, sysm, 50, exit_lits, form=form, template=tiled)
        multi_sys.setdefault(form, (label, sysm, err))  # a form's first case is timed
    del rag_bin, r2w_bin

    # K5, the sharded solve's per-tile apply (tile_apply_kernel: a thread a
    # channel of a column over two rows, the triples a launch parameter),
    # on the four tiles of a 2x2 split: bitwise
    # against its twin and the whole grid's apply; image_warping 500x301
    # splits into ragged tiles of 250x151 and 250x150
    err_k5 = tile_checks(f"poisson{n}x4", meta)
    tile_checks(f"image_warping{IW_N}x3", mmeta)
    tile_checks(f"radius2 {n}x{n}", r2[0])
    del r2
    tile_checks(f"poisson{n}x4 bfloat16", pbf[0])
    tile_checks(f"image_warping {RAGGED_DIMS['W']}x{RAGGED_DIMS['H']}x3",
                system(image_warping, RAGGED_DIMS, rag_in)[0])
    tile_checks(f"shape_from_shading{SFS_N}", ssys[0])
    tile_checks(f"optical_flow{FLOW_N}x2", fsys[0])
    # K5's float64 instance on poisson's fields in float64 (a float64 plan
    # on a mesh assembles them so; the planner folds the same masks)
    meta64 = dict(meta, F=meta["F"].double())
    err_k5_64 = tile_checks(f"poisson{n}x4 float64", meta64)

    phases["kernel_checks"] = time.perf_counter() - t_start - sum(phases.values())
    # 3. the main paths through the public API, each with the launch counts
    # set to 0 just before it and read just after
    res_poisson, l_poisson, _p = main_path(f"poisson{n}x4 GN 1x2000", poisson_image_editing,
                                           "gaussNewtonGPU", _grid(n), inputs, 1, 2000,
                                           JAX_CPU_POISSON_512_COST, {"X": (n, n, 4)},
                                           form="gn_tiled")
    runs, iw_res = {}, {}
    for (nn, kind, nl, li), want in JAX_CPU_IMAGE_WARPING_COSTS.items():
        label = f"image_warping{nn} {'LM' if kind == 'LMGPU' else 'GN'} {nl}x{li}"
        form = ("lm" if kind == "LMGPU" else "gn") + ("_tiled" if nn == IW_N
                                                      else "_hbm_tiled")
        iw_res[(nn, kind)], runs[(nn, kind)], _p = main_path(
            label, image_warping, kind, _grid(nn), iw_in if nn == IW_N else iw_big_in, nl, li,
            want, {"Offset": (nn, nn, 2), "Angle": (nn, nn, 1)}, form=form)
    # K6's main path, on the hbm layout: the same solve on the template route
    # gives the same costs and counts
    k6_label = f"image_warping{IW_BIG_N} GN 4x100"
    route_equal(k6_label, iw_res[(IW_BIG_N, "gaussNewtonGPU")],
                runs[(IW_BIG_N, "gaussNewtonGPU")], lambda: ot.Problem(image_warping).plan(
                    dims=_grid(IW_BIG_N)).solve(dict(iw_big_in), nIterations=4,
                                                lIterations=100), "gn_hbm_tiled")
    res_arap, l_arap = graph_main_path("arap36k", arap_dims, arap_in, "gn_dia_tiled")
    res_arm, l_arm = graph_main_path("armadillo31k", arm_dims, arm_in, "gn_rem_tiled")
    float64_witness(f"arap36k GN {GRAPH_NL}x{GRAPH_LI}", arap_mesh_deformation, "gaussNewtonGPU",
                    arap_dims, arap_in, GRAPH_NL, GRAPH_LI, JAX_CPU_ARAP36K_F64_COSTS, F64_STEPS)
    spec_res = {label: spec_main_path(label, *spec_in[label]) for label in GRAPH_SPECS}
    l_spec = {label: r[1] for label, r in spec_res.items()}
    l_dyn, dyn_sys = dynamic_main_path(arap_dims, dyn_in)
    # the last topology's first system, as the kernel takes it (the padded
    # graph, all remainder), against the twin and the template
    graph_plan_line("arap36k dynamic topology 2 GN", *dyn_sys[:2])
    err_dyn = variant_checks("arap36k dynamic topology 2 GN", dyn_sys, 50, GRAPH_LI,
                             bitwise=True, template=True)
    # couplings across vertex spaces (the per-pair ELL blocks, no kernel
    # form), the Jacobian export and the explicit J
    res_cluster, l_cluster = cluster_main_path(cl_dims, cl_in)
    jacobian_checks(f"image_warping{IW_N}x3 masked", image_warping, _grid(IW_N), iw_mask_in)
    jacobian_checks("arap36k", arap_mesh_deformation, arap_dims, arap_in)
    explicit = explicit_main_paths(res_poisson, res_arap, inputs, arap_dims, arap_in)
    vol_res, l_vol = volumetric_main_path("jacobi", vol_in)
    vol_bj_res, l_vol_bj = volumetric_main_path("block_jacobi", vol_in)
    log(json.dumps({"check": "block_jacobi_iters", "case": f"volumetric{VOL_N} GN {VOL_NL}x{VOL_LI}",
                    "jacobi_lin_iters": vol_res.num_linear_iterations,
                    "block_jacobi_lin_iters": vol_bj_res.num_linear_iterations}))
    _r, l_pcs = variant_main_path("poisson", "chronopoulos_gear", inputs)
    _r, l_pbf = variant_main_path("poisson", "bfloat16", inputs)
    l_iw_variant = {v: variant_main_path("image_warping", v, iw_in)[1]
                    for v in ("chronopoulos_gear", "block_jacobi", "bfloat16")}

    sfs_shape = {"X": (SFS_N, SFS_N, 1)}
    res_sfs, l_sfs = first_steps_main_path(
        f"shape_from_shading{SFS_N} GN {SFS_NL}x{SFS_LI}", shape_from_shading, _grid(SFS_N),
        sfs_in, SFS_NL, SFS_LI, JAX_CPU_SFS, SFS_FIRST_STEPS, sfs_shape, form="gn_tiled")
    l_flow, flow_pplan, flow_res = pyramid_flow_main_path(flow_in)
    # the single-device solves the sharded shape_from_shading and pyramid
    # are held to: SFS's first steps through the stepwise API (the pinned
    # settings are the single device's defaults), the pyramid's levels
    sfs_costs, sfs_counts, _c = single_steps(shape_from_shading, "gaussNewtonGPU", _grid(SFS_N),
                                             sfs_in, SHARDED_READ_CASES[0][6], SFS_LI, PINNED)
    read_single = {
        SHARDED_READ_CASES[0][0]: ([sfs_costs], [sfs_counts], [res_sfs.final_cost],
                                   [res_sfs.num_linear_iterations]),
        SHARDED_READ_CASES[1][0]: ([lc[:SHARDED_READ_CASES[1][6]] for lc in flow_pplan.level_costs],
                                   None, list(flow_res.costs), flow_pplan.level_lin_iters)}
    _r, l_intr, _p = main_path(
        f"intrinsic{INTR_N} GN {INTR_NL}x{INTR_LI}", intrinsic_image_decomposition,
        "gaussNewtonGPU", _grid(INTR_N), intr_in, INTR_NL, INTR_LI, JAX_CPU_INTRINSIC_512_COST,
        {"r": (INTR_N, INTR_N, 3), "s": (INTR_N, INTR_N, 1)}, form="gn_tiled")
    _r, l_split = split_main_path(split_in, split_counts)
    _r, l_batch = batched_curve_main_path(curve_truths, curve_in)
    l_pbatch = batched_poisson_main_path(pbatch_in)
    l_arm_batch = batched_graph_main_path(arm_bdims, arm_bin)
    l_bj_batch = batched_iw_main_path(iw_bin)
    l_iw_batch = batched_iw_main_path(iw_bin, "jacobi")
    l_sched = scheduled_main_path()
    # the single-device solve the sharded auto-policy case is held to
    res_auto, _l, _p = main_path(
        f"image_warping{IW_N} LM 8x400 chronopoulos_gear block_jacobi", image_warping, "LMGPU",
        _grid(IW_N), iw_in, 8, 400, None, {"Offset": (IW_N, IW_N, 2), "Angle": (IW_N, IW_N, 1)},
        form="lm_cs_bj", ip=CS_BJ)

    # the single-device solves the sharded graph, 3-D and several-space
    # cases are held to
    t_ref = time.perf_counter()
    mesh_single = sharded_mesh_references({
        "arap": (arap_mesh_deformation, arap_dims, arap_in, res_arap),
        "embedded": (embedded_mesh_deformation, *spec_in["embedded10k"],
                     spec_res["embedded10k"][0]),
        "volumetric": (volumetric_mesh_deformation, _vol(VOL_N), vol_in, vol_res),
        "cluster": (cluster_arap_spec(ot), cl_dims, cl_in, res_cluster)})
    log(json.dumps({"sharded_mesh_references_s": time.perf_counter() - t_ref}))
    t_ref = time.perf_counter()
    option_single = sharded_option_references()
    log(json.dumps({"sharded_option_references_s": time.perf_counter() - t_ref}))

    phases["main_paths"] = time.perf_counter() - t_start - sum(phases.values())
    single = {SHARDED_CASES[0][0]: res_poisson, SHARDED_CASES[1][0]: iw_res[(IW_N, "gaussNewtonGPU")],
              SHARDED_CASES[2][0]: iw_res[(IW_N, "LMGPU")], SHARDED_CASES[3][0]: res_auto}
    cases = medium_inputs()
    for name, (spec, kind, nl, li, golden) in MEDIUM_GOLDENS.items():
        fused_cg.reset_launch_counts()
        mdims, minputs = cases[name]
        p = ot.Problem(spec, kind=kind).plan(dims=mdims)
        r = p.solve(dict(minputs), nIterations=nl, lIterations=li)
        used = dict(fused_cg.fused_grid_cg_kernel.launches)
        ok = abs(r.final_cost - golden) <= GOLDEN_ATOL + GOLDEN_RTOL * abs(golden)
        log(json.dumps({"check": "golden", "case": f"{name} {kind} {nl}x{li}",
                        "final_cost": r.final_cost, "golden": golden,
                        "rel_diff": abs(r.final_cost - golden) / golden,
                        "kernel_launches": used, "nonlinear_iters": r.num_iterations}))
        ran = {k: v for k, v in used.items() if v}
        if (not ok or p.fused_fallback is not None
                or ran != {GOLDEN_FORMS[name]: r.num_iterations}):
            raise RuntimeError(f"golden {name} failed ({ran}, expected "
                               f"{GOLDEN_FORMS[name]} once a step)")
    # shape_from_shading's medium case, held as the SFS_MEDIUM comment says
    spec, kind, nl, li, golden = SFS_MEDIUM
    mdims, minputs = cases["shape_from_shading"]
    label = f"shape_from_shading medium {kind} {nl}x{li}"
    r, _l = first_steps_main_path(label, spec, mdims, minputs, nl, li, JAX_CPU_SFS_MEDIUM,
                                  SFS_MEDIUM_FIRST_STEPS, {"X": (mdims["W"], mdims["H"], 1)},
                                  kind=kind)
    log(json.dumps({"check": "golden_beside", "case": label, "final_cost": r.final_cost,
                    "golden": golden, "rel_diff": abs(r.final_cost - golden) / golden}))
    float64_witness(label, spec, kind, mdims, minputs, nl, li, JAX_CPU_SFS_MEDIUM_F64_COSTS, nl)
    phases["goldens"] = time.perf_counter() - t_start - sum(phases.values())
    ranks, l_k5 = sharded_main_paths(
        sharded, {k: (r.final_cost, r.num_linear_iterations) for k, r in single.items()}, gpu)
    sharded_mesh_main_paths(ranks, mesh_single, gpu)
    sharded_read_main_paths(ranks, read_single, gpu)
    l_options = sharded_option_main_paths(ranks, option_single, gpu)
    sharded_split(ranks, gpu)
    phases["sharded_main_paths_after_goldens"] = (time.perf_counter() - t_start
                                                  - sum(phases.values()))
    phase_s = time.perf_counter() - t_start

    # 4. times on the card. The tiled instances and the template's on the
    # same systems in turns (tiled, template, template, tiled): Jacobi,
    # block-Jacobi, Chronopoulos-Gear and bfloat16 fields, one system, and
    # the systems in turn (ms per system-iteration): poisson 1024x1024x4's
    # split, 4 x poisson 512x512x4 and image_warping x4 LM, Jacobi, and
    # image_warping x4 under block-Jacobi; the first of each go into the
    # kernels line
    t_tiled, t_tpl = {}, {}
    iw_bj = {label: iw_variants[(label, "block_jacobi")] for label in ("GN", "LM")}
    mlabel, msys, _err = multi_sys["lm_bj_multi_tiled"]
    jlabel, jsys, _err = multi_sys["lm_multi_tiled"]
    agm, aglm = graph["armadillo31k"][:2]
    dgm, dglm = graph["arap36k"][:2]
    glabel, gsys, _err = multi_sys["gn_rem_multi_tiled"]
    for key, (label, m_, b_, p_, lm_, var_, reps_) in {
            "gn": (f"poisson{n}x4", meta, b, pre, None, {}, 3),
            "gn_iw": (f"image_warping{IW_N}x3", mmeta, mb, mpre, None, {}, 3),
            "lm_iw": (f"image_warping{IW_N}x3", vmeta, vb, vpre, vlm, {}, 3),
            "gn_hbm": (f"image_warping{IW_BIG_N}x3", gmeta, gb, gpre, None, {}, 2),
            "lm_hbm": (f"image_warping{IW_BIG_N}x3", wmeta, wb, wpre, wlm, {}, 2),
            "gn_bj_iw": (f"image_warping{IW_N}x3 GN block_jacobi", *iw_bj["GN"], 3),
            "lm_bj_iw": (f"image_warping{IW_N}x3 LM block_jacobi", *iw_bj["LM"], 3),
            "gn_cs": (f"poisson{n}x4 chronopoulos_gear", *pcs, 3),
            "lm_cs_iw": (f"image_warping{IW_N}x3 LM chronopoulos_gear",
                         *iw_variants[("LM", "chronopoulos_gear")], 3),
            "gn_bf16": (f"poisson{n}x4 bfloat16", *pbf, 3),
            "lm_bf16_iw": (f"image_warping{IW_N}x3 LM bfloat16", *iw_variants[("LM", "bfloat16")],
                           3),
            "lm_bj_multi": (mlabel, *msys, 2),
            "gn_multi_split": (f"poisson{SPLIT_N}x4 split", *psplit, 2),
            "gn_multi_batch": (f"poisson{n}x4 x{BATCH_POISSON_B}", *pbatch, 2),
            "lm_multi_iw": (jlabel, *jsys, 2),
            "gn_rem": ("armadillo31k", *agm, 2),
            "lm_rem": ("armadillo31k", *aglm, 2),
            "gn_dia": ("arap36k", *dgm, 2),
            "lm_dia": ("arap36k", *dglm, 2),
            "gn_vol": (f"volumetric{VOL_N}", *vsys, 3),
            "gn_bj_vol": (f"volumetric{VOL_N} block_jacobi", *vbj, 3),
            "gn_rem_multi": (glabel, *gsys, 2),
            "gn_rem_c3": ("cotangent10k GN", *spec_sys["cotangent10k"][0], 2),
            "lm_rem_c3": ("cotangent10k LM", *spec_sys["cotangent10k"][1], 2),
            "gn_rem_c12": ("embedded10k GN", *spec_sys["embedded10k"][0], 2),
            "lm_rem_c12": ("embedded10k LM", *spec_sys["embedded10k"][1], 2),
            "gn_dia_c7": ("robust10k GN", *spec_sys["robust10k"][0], 2),
            "lm_dia_c7": ("robust10k LM", *spec_sys["robust10k"][1], 2),
            "gn_rem_dyn": ("arap36k dynamic topology 2", *dyn_sys, 2)}.items():
        for template in (False, True, True, False):
            t = time_pair(label, m_, b_, p_, gpu, lm_, reps=reps_,
                          twin=not template and key not in t_tiled, template=template, **var_)
            (t_tpl if template else t_tiled).setdefault(key, t)
    del iw_bj, msys, gsys, jsys, dgm, dglm
    t_gn, t_mixed, t_lm = t_tiled["gn"], t_tiled["gn_iw"], t_tiled["lm_iw"]
    time_explicit_cg(explicit, t_tiled, gpu)
    del explicit
    phases["tiled_vs_template_kernel_turns"] = (time.perf_counter() - t_start
                                                - sum(phases.values()))
    t_k5 = time_tile_apply(f"poisson{n}x4", meta, gpu)
    t_k5_64 = time_tile_apply(f"poisson{n}x4 float64", meta64, gpu)
    time_tile_apply(f"image_warping{IW_N}x3", mmeta, gpu)
    time_tile_apply(f"shape_from_shading{SFS_N}", ssys[0], gpu)
    time_tile_apply(f"optical_flow{FLOW_N}x2", fsys[0], gpu)
    tiled_floor(gpu)
    tiled_floor(gpu, cs=True)
    l2_F = graph["arap36k"][0][0]["F"]
    l2_ms = l2_floor(gpu, "arap36k", l2_F,
                     {f: t_tiled[key][0] / TIMED_ITERS_RUN[("arap36k", f)]
                      for key, f in (("gn_dia", "gn_dia_tiled"), ("lm_dia", "lm_dia_tiled"))})
    del gmeta, gb, gpre, wmeta, wb, wpre, wlm
    # the 3-D kernel's own costs beside its bound, for the kernels line: the
    # shells' exchange an iteration at the L2 read rate just measured, and
    # its barrier floor at the 32^3 launch's box count
    v32 = fused_cg.route_plan(vsys[0], vsys[1], lm=False)
    vol_floor_ms = vol_floor(gpu, v32["boxes"])
    vol_ex_bytes = vol_exchange_bytes(v32, tuple(int(k) for k in vsys[1].shape[1:]),
                                      int(vsys[1].shape[0]))
    vol_ex_ms = vol_ex_bytes / (l2_F.numel() * l2_F.element_size() / l2_ms)
    vol_costs = {key: {"exchange_ms": vol_ex_ms * TIMED_ITERS_RUN[(label_, form_)],
                       "barrier_floor_ms": vol_floor_ms * TIMED_ITERS_RUN[(label_, form_)]}
                 for key, label_, form_ in (
                     ("gn_vol", f"volumetric{VOL_N}", "gn_vol_tiled"),
                     ("gn_bj_vol", f"volumetric{VOL_N} block_jacobi", "gn_bj_vol_tiled"))}
    log(json.dumps({"timing": "vol_exchange_at_l2_rate", "gpu": gpu,
                    "bytes_per_cg_iter": vol_ex_bytes, "ms_per_cg_iter": vol_ex_ms,
                    "barrier_floor_ms_per_cg_iter": vol_floor_ms}))
    del iw_variants  # the LM ones timed above, on both routes
    big = system(volumetric_mesh_deformation, _vol(VOL_BIG_N), vol_big_in)
    time_pair(f"volumetric{VOL_BIG_N}", *big[:3], gpu, big[3], reps=2, **big[4])
    del big
    t_sfs = time_pair(f"shape_from_shading{SFS_N}", *ssys[:3], gpu, ssys[3], **ssys[4])
    time_pair(f"optical_flow{FLOW_N}x2", *fsys[:3], gpu, fsys[3], **fsys[4])
    time_pair(f"intrinsic{INTR_N}x4", *isys[:3], gpu, isys[3], reps=2, **isys[4])
    # the same four channels as one joint system, for the split's worth (the
    # split itself is timed above, on both routes)
    joint = dict(psplit[0], chan_grid=False, triples=tuple(
        (d, c, c, fid) for (d, _i, _j, fid) in psplit[0]["triples"] for c in range(4)))
    time_pair(f"poisson{SPLIT_N}x4 joint", joint, *psplit[1:3], gpu, reps=2)
    del psplit, joint
    # K1 (h): the LM batch of the curve fits over one step's lIterations on
    # the batch kernel (lm_batch_tiled) and the template's lm_batch in turns,
    # the same launch against its 512 systems launched one by one (the
    # strided multi-system forms are timed above, on both routes)
    t_batch_turns = {}
    for template in (False, True, True, False):
        t_batch_turns.setdefault(template, time_pair(
            f"curve_fitting x{BATCH_B} LM batch", *curve_lm[:3], gpu, curve_lm[3],
            lits=BATCH_LI, device=True, twin=not t_batch_turns, template=template))
    t_batch = t_batch_turns[False]
    time_batched_launches(f"curve_fitting x{BATCH_B} LM step launch", *curve_lm[:4], gpu)
    form_sweep(curve_lm, gpu)
    # the batch forms with the remainder and the block preconditioner: ms
    # per system-iteration of each multi-system instance (lm_bj_multi_tiled,
    # gn_rem_multi_tiled, gn_multi_tiled and lm_multi_tiled are timed above,
    # on both routes), ms per launch of each block-per-system one, beside its
    # bound; one batched GN step before and after
    for form, (label, sysm, _err) in multi_sys.items():
        if form not in ("lm_bj_multi_tiled", "gn_rem_multi_tiled", "gn_multi_tiled",
                        "lm_multi_tiled"):
            time_pair(label, *sysm[:3], gpu, sysm[3], reps=2, twin=False, **sysm[4])
    with batch_form("batch"):
        for form, (label, sysb) in batch_sys.items():
            time_pair(label, *sysb[:3], gpu, sysb[3], lits=BATCH_LI, device=True, twin=False,
                      **sysb[4])
    del batch_sys
    batched_step_before_after(arm_bdims, arm_bin, gpu)
    # the main paths the tiled route changed, as they ran on the template
    # before it and on the tiled kernel, one turn a route (each time_main_path
    # a warm-up solve and two timed ones): solve times, then each solve
    # profiled (device time, the CG kernel's share; image_warping LM under
    # block-Jacobi on the tiled route only)
    routed = [(f"poisson{n}x4 GN 1x2000", poisson_image_editing, "gaussNewtonGPU", inputs, 1,
               2000, {})] + [(f"image_warping{IW_N} {label} 8x400", image_warping, kind, iw_in, 8,
                              400, {}) for kind, label in (("gaussNewtonGPU", "GN"),
                                                           ("LMGPU", "LM"))]
    bj_lm = (f"image_warping{IW_N} LM 8x400 block_jacobi", image_warping, "LMGPU", iw_in, 8, 400,
             bj)
    # the Chronopoulos-Gear and bfloat16 solves of poisson and image_warping
    # LM, whose steps the tiled route now takes
    variants = [(f"poisson{n}x4 GN 1x2000 {v}", poisson_image_editing, "gaussNewtonGPU", inputs,
                 1, 2000, ip) for v, ip in (("chronopoulos_gear", cs), ("bfloat16", bf))]
    variants += [(f"image_warping{IW_N} LM 8x400 {v}", image_warping, "LMGPU", iw_in, 8, 400, ip)
                 for v, ip in (("chronopoulos_gear", cs), ("bfloat16", bf))]
    blabel = f"image_warping{IW_N} x{IW_BJ_BATCH_B} LM 8x400 block_jacobi batched"
    # the paths of the systems in turn this PR's route takes: the split, the
    # poisson batch and image_warping x4 LM with the Jacobi preconditioner
    slabel = f"poisson{SPLIT_N}x4 GN 1x2000 split"
    pblabel = f"poisson{n}x4 x{BATCH_POISSON_B} GN 1x2000 batched"
    jblabel = f"image_warping{IW_N} x{IW_BJ_BATCH_B} LM 8x400 jacobi batched"
    arm_label = f"armadillo31k GN {GRAPH_NL}x{GRAPH_LI}"
    arap_label = f"arap36k GN {GRAPH_NL}x{GRAPH_LI}"
    arm_blabel = f"armadillo31k x{len(ARM_BATCH_PULLS)} GN {GRAPH_NL}x{GRAPH_LI} batched"
    for route in ("template", "tiled"):
        with (template_route() if route == "template" else contextlib.nullcontext()):
            for label, spec, kind, inp, nl, li, ip in routed + [bj_lm] + variants:
                time_main_path(f"{label} {route}", spec, kind, _grid(n), inp, nl, li, gpu, ip=ip,
                               reps=2)
            time_batched(f"{blabel} {route}", bj_batch_plan(), iw_bin, 8, 400, gpu, reps=2)
            time_main_path(f"{slabel} {route}", poisson_image_editing, "gaussNewtonGPU",
                           _grid(SPLIT_N), split_in, 1, 2000, gpu, reps=2)
            time_batched(f"{pblabel} {route}", ot.Problem(poisson_image_editing).plan(
                dims=_grid(n)), pbatch_in, 1, 2000, gpu, reps=2)
            time_batched(f"{jblabel} {route}", bj_batch_plan("jacobi"), iw_bin, 8, 400, gpu,
                         reps=2)
            time_main_path(f"{arm_label} {route}", arap_mesh_deformation, "gaussNewtonGPU",
                           arm_dims, arm_in, GRAPH_NL, GRAPH_LI, gpu, reps=2)
            time_main_path(f"{arap_label} {route}", arap_mesh_deformation, "gaussNewtonGPU",
                           arap_dims, arap_in, GRAPH_NL, GRAPH_LI, gpu, reps=2)
            time_batched(f"{arm_blabel} {route}", ot.Problem(arap_mesh_deformation).plan(
                dims=arm_bdims), arm_bin, GRAPH_NL, GRAPH_LI, gpu, reps=2)
            time_main_path(f"{k6_label} {route}", image_warping, "gaussNewtonGPU",
                           _grid(IW_BIG_N), iw_big_in, 4, 100, gpu)
            time_main_path(f"volumetric{VOL_N} GN {VOL_NL}x{VOL_LI} jacobi {route}",
                           volumetric_mesh_deformation, "gaussNewtonGPU", _vol(VOL_N), vol_in,
                           VOL_NL, VOL_LI, gpu)
    phases["route_solve_turns"] = time.perf_counter() - t_start - sum(phases.values())
    def cut(label, nl):  # a profiled solve at PROFILE_NL_CUT of its steps, so labelled
        pl = max(1, nl // PROFILE_NL_CUT)
        return label.replace(f" {nl}x", f" {pl}x"), pl

    for route in ("template", "tiled"):
        with (template_route() if route == "template" else contextlib.nullcontext()):
            for label, spec, kind, inp, nl, li, ip in routed:
                rplan = ot.Problem(spec, kind=kind).plan(dims=_grid(n))
                plabel, pl = cut(label, nl)
                profile_solve(f"{plabel} {route}".replace(" ", "_"), lambda: rplan.solve(
                    dict(inp), nIterations=pl, lIterations=li), gpu)  # run at once
            if route == "tiled":  # image_warping LM under block-Jacobi, beside its Jacobi solve
                label, spec, kind, inp, nl, li, ip = bj_lm
                rplan = ot.Problem(spec, kind=kind).plan(
                    dims=_grid(n), init_params=ot.InitializationParameters(**ip))
                plabel, pl = cut(label, nl)
                profile_solve(f"{plabel} {route}".replace(" ", "_"), lambda: rplan.solve(
                    dict(inp), nIterations=pl, lIterations=li), gpu)  # run at once
            bplan_bj = bj_batch_plan()
            plabel, pl = cut(blabel, 8)
            profile_solve(f"{plabel} {route}".replace(" ", "_"), lambda: bplan_bj.solve_batched(
                dict(iw_bin), nIterations=pl, lIterations=400), gpu)  # run at once
            splan = ot.Problem(poisson_image_editing).plan(dims=_grid(SPLIT_N))
            profile_solve(f"{slabel} {route}".replace(" ", "_"), lambda: splan.solve(
                dict(split_in), nIterations=1, lIterations=2000), gpu)  # run at once
            aplan = ot.Problem(arap_mesh_deformation).plan(dims=arm_bdims)
            plabel, pl = cut(arm_blabel, GRAPH_NL)
            profile_solve(f"{plabel} {route}".replace(" ", "_"), lambda: aplan.solve_batched(
                dict(arm_bin), nIterations=pl, lIterations=GRAPH_LI), gpu)  # run at once
            kplan = ot.Problem(image_warping).plan(dims=_grid(IW_BIG_N))
            plabel, pl = cut(k6_label, 4)
            profile_solve(f"{plabel} {route}".replace(" ", "_"), lambda: kplan.solve(
                dict(iw_big_in), nIterations=pl, lIterations=100), gpu)  # run at once
            gplan = ot.Problem(arap_mesh_deformation).plan(dims=arap_dims)
            plabel, pl = cut(arap_label, GRAPH_NL)
            profile_solve(f"{plabel} {route}".replace(" ", "_"), lambda: gplan.solve(
                dict(arap_in), nIterations=pl, lIterations=GRAPH_LI), gpu)  # run at once
            # volumetric's Jacobi solve only: a profile of its ~25,000 device
            # launches (8 steps) takes about 19 s at full depth
            vplan = ot.Problem(volumetric_mesh_deformation).plan(dims=_vol(VOL_N))
            vl = max(1, VOL_NL // PROFILE_NL_CUT)
            profile_solve(f"volumetric{VOL_N}_GN_{vl}x{VOL_LI}_jacobi_{route}",
                          lambda: vplan.solve(dict(vol_in), nIterations=vl,
                                              lIterations=VOL_LI), gpu)  # run at once
    phases["route_profiles"] = time.perf_counter() - t_start - sum(phases.values())
    time_main_path(f"shape_from_shading{SFS_N} GN {SFS_NL}x{SFS_LI}", shape_from_shading,
                   "gaussNewtonGPU", _grid(SFS_N), sfs_in, SFS_NL, SFS_LI, gpu)
    for li, inp in enumerate(flow_in):  # each level from a zero flow
        w, h = inp["I"].shape
        time_main_path(f"optical_flow level {li} {w}x{h} GN {FLOW_NL}x{FLOW_LI}", optical_flow,
                       "gaussNewtonGPU", {"W": w, "H": h}, inp, FLOW_NL, FLOW_LI, gpu)
    time_main_path(f"intrinsic{INTR_N} GN {INTR_NL}x{INTR_LI}", intrinsic_image_decomposition,
                   "gaussNewtonGPU", _grid(INTR_N), intr_in, INTR_NL, INTR_LI, gpu)
    bplan = ot.Problem(curve_fitting, kind="LMGPU").plan(dims=cdims)
    profile_solve(f"curve_fitting_x{BATCH_B}_batched", lambda: bplan.solve_batched(
        dict(curve_in), nIterations=BATCH_NL, lIterations=BATCH_LI), gpu)
    # the three other graph specs' main paths and the last dynamic topology's,
    # at PROFILE_NL_CUT of their steps
    for label, (spec, kind, _mk, nl, li, _form, _layout) in GRAPH_SPECS.items():
        splan = ot.Problem(spec, kind=kind).plan(dims=spec_in[label][0])
        pl = max(1, nl // PROFILE_NL_CUT)
        profile_solve(f"{label}_{'LM' if kind == 'LMGPU' else 'GN'}_{pl}x{li}",
                      functools.partial(splan.solve, dict(spec_in[label][1]), nIterations=pl,
                                        lIterations=li), gpu)
    dplan = ot.Problem(arap_mesh_deformation).plan(dims=arap_dims, dynamic_topology=True)
    dl = max(1, GRAPH_NL // PROFILE_NL_CUT)
    profile_solve(f"arap36k_dynamic_topology_2_GN_{dl}x{GRAPH_LI}", functools.partial(
        dplan.solve, dict(dyn_in[-1]), nIterations=dl, lIterations=GRAPH_LI), gpu)
    # the cluster solve's eager loop, at PROFILE_NL_CUT of its steps: its 8
    # steps make some 77,500 device launches to profile
    cplan = ot.Problem(cluster_arap_spec(ot)).plan(dims=cl_dims)
    cl_nl = max(1, GRAPH_NL // PROFILE_NL_CUT)
    profile_solve(f"cluster_arap{cl_dims['N']}x{cl_dims['P']}_GN_{cl_nl}x{GRAPH_LI}",
                  functools.partial(cplan.solve, dict(cl_in), nIterations=cl_nl,
                                    lIterations=GRAPH_LI), gpu)
    phases["timings_and_profiles"] = time.perf_counter() - t_start - sum(phases.values())

    # 5. the tooling: the example harness at full width; one more solve of
    # seven main paths with collect_per_kernel_timing (the timer's table and
    # checks, each plan's one-line summary, the memory report after
    # image_warping 1024x1024's); checkpoint/resume on the card
    harness_main_path(iw_in, gpu)

    def per_iter(key, label, form):  # time_pair's kernel ms a CG iteration, this call
        return t_tiled[key][0] / TIMED_ITERS_RUN[(label, form)]

    for label, spec, dims, inp, nl, li, untimed, kernel_ms, ip in (
            (f"poisson{n}x4 GN 1x2000", poisson_image_editing, _grid(n), inputs, 1, 2000,
             res_poisson, per_iter("gn", f"poisson{n}x4", "gn_tiled"), None),
            (k6_label, image_warping, _grid(IW_BIG_N), iw_big_in, 4, 100,
             iw_res[(IW_BIG_N, "gaussNewtonGPU")],
             per_iter("gn_hbm", f"image_warping{IW_BIG_N}x3", "gn_hbm_tiled"), None),
            (arap_label, arap_mesh_deformation, arap_dims, arap_in, GRAPH_NL, GRAPH_LI, res_arap,
             per_iter("gn_dia", "arap36k", "gn_dia_tiled"), None),
            (arm_label, arap_mesh_deformation, arm_dims, arm_in, GRAPH_NL, GRAPH_LI, res_arm,
             per_iter("gn_rem", "armadillo31k", "gn_rem_tiled"), None),
            (f"volumetric{VOL_N} GN {VOL_NL}x{VOL_LI} jacobi", volumetric_mesh_deformation,
             _vol(VOL_N), vol_in, VOL_NL, VOL_LI, vol_res,
             per_iter("gn_vol", f"volumetric{VOL_N}", "gn_vol_tiled"), {"preconditioner": "jacobi"}),
            (f"shape_from_shading{SFS_N} GN {SFS_NL}x{SFS_LI}", shape_from_shading, _grid(SFS_N),
             sfs_in, SFS_NL, SFS_LI, res_sfs,
             t_sfs[0] / TIMED_ITERS_RUN[(f"shape_from_shading{SFS_N}", "gn_tiled")], None),
            (f"cluster_arap{cl_dims['N']}x{cl_dims['P']} GN {GRAPH_NL}x{GRAPH_LI}",
             cluster_arap_spec(ot), cl_dims, cl_in, GRAPH_NL, GRAPH_LI, res_cluster, None, None)):
        tplan, _res = timed_main_path(label, spec, dims, inp, nl, li, untimed, kernel_ms, gpu, ip)
        if label == k6_label:  # the card's memory with image_warping 1024x1024's plan alive
            memory.report(print_fn=log)
        del tplan, _res
    checkpoint_main_path(iw_in, gpu)
    phases["tooling"] = time.perf_counter() - t_start - sum(phases.values())

    # 6. the C API: the port's C client through libopttpu_torch.so on the card
    l_c_api = c_api_main_path(gpu)
    phases["c_api"] = time.perf_counter() - t_start - sum(phases.values())

    # 7. the example apps without --small, and the driver entry:
    # one step against a one-step solve, the multi-rank dry run on the card
    # (the dry run's ranks started first, from the repository root, to run
    # beside the apps; the entry phase waits for what is left of them)
    dryrun = start_dryrun()
    l_examples = {app: example_main_path(app, gpu) for app in EXAMPLE_APPS}
    phases["examples"] = time.perf_counter() - t_start - sum(phases.values())
    l_entry = entry_main_path(gpu, dryrun)
    phases["entry"] = time.perf_counter() - t_start - sum(phases.values())

    def entry(name, replaces, launches, err, timing, source=KERNEL_SOURCE, template=None,
              costs=None):
        ms, plain, bound_ms, bound_by = timing
        e = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain,
             "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
        if template is not None:  # the template's ms on the same system, in this run
            e["template_ms"] = template[0]
        e.update(costs or {})  # a design's own costs beside the bound, in this run
        return e

    # K1 (h)'s bound of one iteration of every system at the bench's batched
    # shape and at 4 x laplacian 16x16
    k1h = {}
    for row, shape, lm, batch in (
            (f"curve_fitting x{BATCH_B} LM", meta_shape(curve_lm[0]), True, BATCH_B),
            (f"laplacian{LAP_BATCH_N} x{LAP_BATCH_B} GN",
             dict(fields=5, plane=LAP_BATCH_N ** 2, C=1, triples=5), False, LAP_BATCH_B)):
        ms, by = cg_bound(shape, 1, lm=lm, batch=batch)
        k1h[row] = {"bound_ms_per_iter_of_all_systems": ms, "bound_by": by}
    log(json.dumps({"bounds_k1h": k1h}))

    # each main-path launch counts in one entry; ms, plain_ms and bound_ms
    # are of TIMED_ITERS iterations; no single PyTorch call runs a CG loop,
    # so library_ms is null. The LM instances on 1024x1024x3 (K6's other
    # case) and on the two meshes, and the variants' other instances, are
    # checked and timed above; image_warping's LM variant solves above are
    # their main paths; optical_flow's and intrinsic's solves are K1
    # variant a's further main paths. K5's ms, plain_ms and bound_ms are of
    # one apply of a tile (no PyTorch call applies a per-point-coefficient
    # stencil: library_ms null), its launches those of the sharded poisson
    # solve; the sharded image_warping solves are its further main paths
    log(json.dumps({"main_path_launches": {"optical_flow": l_flow, "intrinsic": l_intr,
                                           "poisson_batched": l_pbatch, "scheduled": l_sched,
                                           "armadillo_batched": l_arm_batch,
                                           "image_warping_block_jacobi_batched": l_bj_batch,
                                           "image_warping_batched": l_iw_batch,
                                           "sharded_tile_apply": l_k5,
                                           "sharded_options_tile_apply": l_options,
                                           "graph_specs": l_spec,
                                           "dynamic_topology": l_dyn,
                                           "cluster_arap": l_cluster, "c_api": l_c_api,
                                           "examples": l_examples, "entry": l_entry}}))
    log(json.dumps({"command_s": time.perf_counter() - t_start,
                    "checks_and_main_paths_s": phase_s, "phases_s": phases}))
    log(f"gpu: {gpu}")
    log(json.dumps({"kernels": [
        entry(f"tiled_grid_cg GN (K1, grid GN form), poisson {n}x{n}x4, gn_tiled", K1,
              l_poisson["gn_tiled"], err_gn, t_gn, TILED_SOURCE, t_tpl["gn"]),
        entry(f"tiled_grid_cg GN, mixed unknowns (K1 variant a), image_warping {IW_N}x{IW_N}x3, "
              "gn_tiled", K1, runs[(IW_N, "gaussNewtonGPU")]["gn_tiled"], err_mixed, t_mixed,
              TILED_SOURCE, t_tpl["gn_iw"]),
        entry(f"tiled_grid_cg LM (K1 variant b), image_warping {IW_N}x{IW_N}x3, lm_tiled", K1,
              runs[(IW_N, "LMGPU")]["lm_tiled"], err_lm, t_lm, TILED_SOURCE, t_tpl["lm_iw"]),
        entry(f"tiled_grid_cg GN beyond shared memory (K6), image_warping "
              f"{IW_BIG_N}x{IW_BIG_N}x3, gn_hbm_tiled: r and haloed p in shared memory, delta "
              "and Ap in device frames", K6, runs[(IW_BIG_N, "gaussNewtonGPU")]["gn_hbm_tiled"],
              err_k6, t_tiled["gn_hbm"], TILED_SOURCE, t_tpl["gn_hbm"]),
        entry("tiled_graph_cg GN, graph DIA form (K3), arap 36,864-vertex grid mesh, "
              "gn_dia_tiled: the fields read from device memory (the stream layout)", K3,
              l_arap["gn_dia_tiled"], graph["arap36k"][2], t_tiled["gn_dia"], GRAPH_SOURCE,
              t_tpl["gn_dia"]),
        entry("tiled_graph_cg GN with the graph remainder (K4), arap armadillo 31,106 "
              "vertices, gn_rem_tiled", K4, l_arm["gn_rem_tiled"], graph["armadillo31k"][2],
              t_tiled["gn_rem"], GRAPH_SOURCE, t_tpl["gn_rem"]),
        entry("tiled_graph_cg LM with the graph remainder at an odd channel count (K4), "
              "cotangent_mesh_smoothing 10,000 vertices (bench_cotangent), C = 3, lm_rem_tiled",
              K4, l_spec["cotangent10k"]["lm_rem_tiled"], spec_sys["cotangent10k"][2]["LM"],
              t_tiled["lm_rem_c3"], GRAPH_SOURCE, t_tpl["lm_rem_c3"]),
        entry("tiled_graph_cg LM with the graph remainder (K4), embedded_mesh_deformation "
              "10,000 vertices (bench_embedded), C = 12, lm_rem_tiled", K4,
              l_spec["embedded10k"]["lm_rem_tiled"], spec_sys["embedded10k"][2]["LM"],
              t_tiled["lm_rem_c12"], GRAPH_SOURCE, t_tpl["lm_rem_c12"]),
        entry("tiled_graph_cg GN, graph DIA form at an odd channel count (K3), "
              "robust_nonrigid_alignment 10,000 vertices (bench_robust_nonrigid), C = 7, a "
              "graph group over 6 of them, gn_dia_tiled: the fields read from device memory",
              K3, l_spec["robust10k"]["gn_dia_tiled"], spec_sys["robust10k"][2]["GN"],
              t_tiled["gn_dia_c7"], GRAPH_SOURCE, t_tpl["gn_dia_c7"]),
        entry("tiled_graph_cg GN with the graph remainder under dynamic_topology (K4), arap "
              "36,864-vertex grid mesh on three topologies in one edge bucket (all edges, 5% "
              "and 10% of the edge pairs dropped), all remainder, gn_rem_tiled; launches "
              "summed over the three solves", K4,
              sum(v["gn_rem_tiled"] for v in l_dyn.values()), err_dyn, t_tiled["gn_rem_dyn"],
              GRAPH_SOURCE, t_tpl["gn_rem_dyn"]),
        entry(f"tiled_grid_cs GN Chronopoulos-Gear (K1 variant c), poisson {n}x{n}x4, "
              "gn_cs_tiled, one grid barrier an iteration", K1C, l_pcs["gn_cs_tiled"], err_cs,
              t_tiled["gn_cs"], TILED_CS_SOURCE, t_tpl["gn_cs"]),
        entry(f"tiled_grid_cs LM Chronopoulos-Gear (K1 variant c), image_warping "
              f"{IW_N}x{IW_N}x3, lm_cs_tiled, one grid barrier an iteration (two on a reset "
              "iteration)", K1C, l_iw_variant["chronopoulos_gear"]["lm_cs_tiled"],
              iw_errs[("LM", "chronopoulos_gear")], t_tiled["lm_cs_iw"], TILED_CS_SOURCE,
              t_tpl["lm_cs_iw"]),
        entry(f"tiled_vol_cg GN block-Jacobi (K1 variant d), volumetric {VOL_N}^3 x 6, "
              "gn_bj_vol_tiled, the fields and the C*C planes staged in shared memory", K1D,
              l_vol_bj["gn_bj_vol_tiled"], err_bj, t_tiled["gn_bj_vol"], TILED_VOL_SOURCE,
              t_tpl["gn_bj_vol"], vol_costs["gn_bj_vol"]),
        entry(f"tiled_grid_cg LM block-Jacobi (K1 variant d), image_warping "
              f"{IW_N}x{IW_N}x3, lm_bj_tiled, the C*C planes staged in shared memory", K1D,
              l_iw_variant["block_jacobi"]["lm_bj_tiled"], err_lm_bj, t_tiled["lm_bj_iw"],
              TILED_SOURCE, t_tpl["lm_bj_iw"]),
        entry(f"tiled_vol_cg GN on a 3-D grid (K1 variant e), volumetric {VOL_N}^3 x 6, "
              "gn_vol_tiled, the fields staged in shared memory", K1E, l_vol["gn_vol_tiled"],
              err_3d, t_tiled["gn_vol"], TILED_VOL_SOURCE, t_tpl["gn_vol"],
              vol_costs["gn_vol"]),
        entry(f"tiled_grid_cg GN bfloat16 fields (K1 variant f), poisson {n}x{n}x4, "
              "gn_bf16_tiled", K1F, l_pbf["gn_bf16_tiled"], err_bf, t_tiled["gn_bf16"],
              TILED_SOURCE, t_tpl["gn_bf16"]),
        entry(f"tiled_grid_cg LM bfloat16 fields (K1 variant f), image_warping "
              f"{IW_N}x{IW_N}x3, lm_bf16_tiled", K1F, l_iw_variant["bfloat16"]["lm_bf16_tiled"],
              iw_errs[("LM", "bfloat16")], t_tiled["lm_bf16_iw"], TILED_SOURCE,
              t_tpl["lm_bf16_iw"]),
        entry(f"tiled_grid_cg GN over a ComputedArray operator (K1 variant g), "
              f"shape_from_shading {SFS_N}x{SFS_N}, gn_tiled", K1G, l_sfs["gn_tiled"], err_sfs,
              t_sfs, TILED_SOURCE),
        entry(f"tiled_grid_cg GN, four one-channel systems in turn in one launch (K2), "
              f"poisson {SPLIT_N}x{SPLIT_N}x4 split, gn_multi_tiled; ms of 100 iterations of "
              "each system", K2, l_split["gn_multi_tiled"], err_split, t_tiled["gn_multi_split"],
              TILED_SOURCE, t_tpl["gn_multi_split"]),
        entry(f"tiled_grid_cg GN, a batch axis (K1 (h)): poisson {n}x{n}x4 x{BATCH_POISSON_B}, "
              "the systems in turn in one launch, gn_multi_tiled; ms of 100 iterations of each "
              "system", K1H, l_pbatch["gn_multi_tiled"], err_pbatch, t_tiled["gn_multi_batch"],
              TILED_SOURCE, t_tpl["gn_multi_batch"]),
        entry(f"tiled_grid_cg LM, a batch axis (K1 (h)): {jlabel}, the systems in turn in one "
              "launch, lm_multi_tiled; ms of 100 iterations of each system", K1H,
              l_iw_batch["lm_multi_tiled"], multi_sys["lm_multi_tiled"][2],
              t_tiled["lm_multi_iw"], TILED_SOURCE, t_tpl["lm_multi_iw"]),
        entry(f"tiled_batch_cg LM, a batch axis (K1 (h)): {BATCH_B} curve-fit systems side by "
              "side, a team of two lanes of one warp each, the state in shared memory, "
              "lm_batch_tiled; ms of a launch of 20 iterations", K1H, l_batch["lm_batch_tiled"],
              err_batch, t_batch, TILED_BATCH_SOURCE, t_batch_turns[True]),
        entry(f"tiled_graph_cg GN with the graph remainder, a batch axis (K1 (h) x K4): "
              f"{alabel} (the armadillo posed to {len(ARM_BATCH_PULLS)} handle targets), the "
              "systems in turn in one launch, gn_rem_multi_tiled; ms of 100 iterations of each "
              "system", K4, l_arm_batch["gn_rem_multi_tiled"],
              multi_sys["gn_rem_multi_tiled"][2], t_tiled["gn_rem_multi"], GRAPH_SOURCE,
              t_tpl["gn_rem_multi"]),
        entry(f"tiled_grid_cg LM block-Jacobi, a batch axis (K1 (h) x K1 (d)): {ilabel}, the "
              "systems in turn in one launch, lm_bj_multi_tiled; ms of 100 iterations of each "
              "system", K1D, l_bj_batch["lm_bj_multi_tiled"], multi_sys["lm_bj_multi_tiled"][2],
              t_tiled["lm_bj_multi"], TILED_SOURCE, t_tpl["lm_bj_multi"]),
        entry(f"tile_apply, one rank's part of the sharded apply (K5), poisson {n}x{n}x4 on "
              f"{MESH_SHAPE[0]}x{MESH_SHAPE[1]} ranks, a thread a channel of a column over two "
              "rows, the triples a launch parameter; launches summed over the four ranks, ms "
              "of one apply of a 256x256 tile", K5,
              l_k5[SHARDED_CASES[0][0]], err_k5, t_k5, source=K5_SOURCE),
        entry(f"tile_apply<double>, K5's float64 instance, poisson {n}x{n}x4 in float64 on "
              f"{MESH_SHAPE[0]}x{MESH_SHAPE[1]} ranks (a float64 plan on a mesh), the float32 "
              "instance's design over 8-byte fields, p and out; launches summed over the four "
              "ranks, ms of one apply of a 256x256 tile", K5,
              l_options[SHARDED_OPTION_CASES[2][0]], err_k5_64, t_k5_64, source=K5_SOURCE),
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
