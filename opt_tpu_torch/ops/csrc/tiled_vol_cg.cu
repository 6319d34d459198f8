// Whole-loop preconditioned CG for a 3-D grid stencil operator whose
// coefficient fields fit the card's shared memory beside the loop's state:
// one persistent cooperative launch per CG solve, one block a box of the
// grid, for Hopper (sm_90a). Two instances, tiled_vol_cg_kernel<BLOCK>: the
// standard Gauss-Newton loop of fused_grid_cg.cuh (lines 66-78) on float32
// fields, one system, with the Jacobi preconditioner (BLOCK = false) or the
// per-point block-Jacobi one (BLOCK = true). Their launches count, in
// ops/fused_cg.py, as gn_vol_tiled and gn_bj_vol_tiled.
//
// Replaces, in opt_tpu/ops/pallas_cg.py: _kernel (:328), the Pallas TPU
// kernel that runs the whole PCG inner loop of a grid problem in one launch,
// in its 3-D grid form (plan_fused_grid_cg :561: volumetric_mesh_deformation
// on [N0, N1, N2]), GN, with the elementwise preconditioner and with its
// block_pre=True form (prec, :367-381), at the grid sizes whose fields,
// state and preconditioner fit one box a block (ops/fused_cg.py::
// tiled_vol_plan: volumetric 32^3 x 6). LM, Chronopoulos-Gear, bfloat16
// fields, batches, the split and the 3-D shapes beyond shared memory
// (64^3 x 6: about 1 MB of fields a box) run the template of
// fused_grid_cg.cuh.
//
// The arithmetic is the template's (fused_grid_cg.cuh:139-146): float32
// products with explicit round-to-nearest intrinsics and no fused
// multiply-add, each output's stencil sum over the triples of its channel in
// their order from +0 (ops/fused_cg.py::_device_triples sorts them stably by
// output channel), z = M^-1 r as the template's (under BLOCK the sum over j
// ascending from +0 of M^-1[i][j] * r[j]), each dot as float32 products
// summed in double. The kernel is therefore bitwise equal to the template
// and to the plain PyTorch twin (ops/fused_cg.py::fused_grid_cg_reference).
// A read that leaves the grid multiplies the zero-filled frame beyond the
// grid's edge (the template skips it): the planner folded the in-bounds
// masks into the fields, so the two give the same bits.
//
// What bounds it. Volumetric 32^3 x 6 has 128 fields (16.8 MB) and 142
// triples; the template reads every field, the preconditioner and its
// state vectors from device memory each iteration (0.0237 ms an iteration
// on the H100 against 0.0052 for the fields' bytes alone). The fields and
// the preconditioner stay the same for the whole solve. Cut into at most one
// box an SM (32^3: 128 boxes of 4 x 8 x 8 points), a box's fields take
// 128 KB, which fit one block's shared memory beside its state. What is
// left to move each iteration is the exchange of the boxes' borders (about
// 8 KB a block), so its two grid barriers and dot reductions set the time
// (chip_smoke.py::tiled_floor).
//
// What the design does about it:
//   * The grid is cut into at most one box per SM (a ceil split of the
//     three axes, ops/fused_cg.py::_box_split), one block of 512 threads a
//     box: up to 128 registers a thread, 16 warps to hide shared-memory
//     latency.
//   * Staged once a solve, in dynamic shared memory: the box's fields
//     [T][pts], its preconditioner over the box ([C][pts], or under BLOCK
//     the C*C planes [C*C][pts]) and the triples' offsets. Kept for the
//     whole solve: r, delta and Ap over the box ([C][pts] each) and p over
//     the box and a halo of h points on every side, (h the largest |offset|
//     of the triples on any axis), [C][r0+2h][r1+2h][r2+2h], zero beyond
//     the grid's edge. Only the inputs' first reads and the border exchange
//     touch device memory.
//   * The border exchange carries z = M^-1 r, not r: after the update each
//     block writes its box's h-wide shell of z (every point within h of a
//     face of the box) to a grid-sized array, and after the barrier forms
//     p = z + beta*p over its box and its halo, z on the halo read from
//     that array. A box's halo touches up to 26 neighbours (faces, edges and
//     corners); every halo point inside the grid lies on its owner's shell.
//     The halo's p is updated by the owner's arithmetic on the owner's z
//     bits, so it stays bitwise equal to the owner's p; neither p nor the
//     preconditioner is needed beyond the box. (Under BLOCK, rebuilding the
//     halo's z from an r ring, as the 2-D kernel does, would need the C*C
//     planes over the halo too: 251,740 B a block at 32^3 x 6, over the
//     232,448 B a block may have.)
//   * Two grid barriers an iteration: (1) Ap = A p and <p, Ap>; (2) the
//     delta and r update, z = M^-1 r (kept in Ap's space for the p update),
//     <z, r> and z's shell. Under BLOCK, z at a point needs every channel's
//     r there: a barrier of the block between the update and z.
//   * Each thread walks outputs (channel, point), not points: a box of 256
//     points and 6 channels is 1,536 outputs for 512 threads, three each,
//     so no thread idles; a warp's 32 outputs are consecutive points of one
//     channel and run the same triples. The walk's channel and point advance
//     by addition (TvWalk); staging and the shell copy take consecutive
//     points of a box row a warp, so they stay coalesced.
//   * Dot sums: each block sums its threads' doubles in a fixed shuffle
//     tree, one partial record a block, and every block sums the <= 132
//     records in the same fixed order (tiled_cg.cuh), so every block takes
//     the same alpha, beta and exit.
//   * The dynamic shared memory is set (cudaFuncSetAttribute) before the
//     occupancy query and the launch; a launch that needs more blocks than
//     can be co-resident, or whose box does not fit, is refused and the
//     error returned.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "tiled_cg.cuh"

namespace cg = cooperative_groups;

// The dynamic shared memory of a launch, in bytes: the block-sum records,
// the triples' field and source offsets (an int2 a triple) and the
// channels' first triples, then the fields over the box [T][pts], r, delta
// and Ap over the box, p over the haloed box, and the preconditioner over
// the box (C planes, or C*C under block) (ops/fused_cg.py::
// tiled_vol_smem_bytes).
__host__ __device__ __forceinline__ long long tv_smem_bytes(int block, int C, int T, int b0,
                                                           int b1, int b2, int h,
                                                           int n_triples) {
  const long long pts = (long long)b0 * b1 * b2;
  const long long ext = (long long)(b0 + 2 * h) * (b1 + 2 * h) * (b2 + 2 * h);
  return 16LL * (TGCG_WARPS + 1) +
         4LL * (T * pts + 3LL * C * pts + C * ext + (block ? (long long)C * C : C) * pts) +
         4LL * (2 * n_triples + C + 1);
}

// A walk over the points of n frames [R0][R1][R2] at the block's stride:
// output o = ((c*R0 + z)*R1 + y)*R2 + x from threadIdx.x, its channel (or
// field, or plane) c and point (z, y, x) advanced by addition.
struct TvWalk {
  int o, c, z, y, x;
  int dc, dz, dy, dx;  // TGCG_THREADS in the same mixed radix
  __device__ __forceinline__ TvWalk(int R0, int R1, int R2) {
    int t = threadIdx.x;
    x = t % R2;
    t /= R2;
    y = t % R1;
    t /= R1;
    z = t % R0;
    c = t / R0;
    int s = TGCG_THREADS;
    dx = s % R2;
    s /= R2;
    dy = s % R1;
    s /= R1;
    dz = s % R0;
    dc = s / R0;
    o = threadIdx.x;
  }
  __device__ __forceinline__ void next(int R0, int R1, int R2) {
    o += TGCG_THREADS;
    x += dx;
    y += dy;
    z += dz;
    c += dc;
    if (x >= R2) {
      x -= R2;
      ++y;
    }
    if (y >= R1) {
      y -= R1;
      ++z;
    }
    if (z >= R0) {
      z -= R0;
      ++c;
    }
  }
};

// The box's view of the launch: its place in the grid, its frame and its
// shared-memory arrays.
struct TvBox {
  int N0, N1, N2, plane;  // the grid
  int z0, y0, x0;         // the box's first point
  int r0, r1, r2, pts;    // its extents and points
  int e1, e2, ext;        // the haloed frame: [r0+2h][e1][e2]
  int h;
  double2* s_warp;   // TGCG_WARPS block-sum records
  double2* s_bcast;  // one record
  int2* s_fp;  // a triple's field (fid*pts) and source (j*ext + its offset) in the frames
  int* s_start;
  float *s_F, *s_r, *s_d, *s_ap, *s_pe, *s_m;

  // the point (z, y, x) of the box in the grid, and in the haloed frame
  __device__ __forceinline__ int g(int z, int y, int x) const {
    return ((z0 + z) * N1 + y0 + y) * N2 + x0 + x;
  }
  __device__ __forceinline__ int e(int z, int y, int x) const {
    return ((z + h) * e1 + y + h) * e2 + x + h;
  }
  // within h of a face of the box: the points its neighbours' halos read
  __device__ __forceinline__ bool shell(int z, int y, int x) const {
    return z < h || z >= r0 - h || y < h || y >= r1 - h || x < h || x >= r2 - h;
  }
};

// z_i = (M^-1 r)_i at box point q from the staged preconditioner: under
// BLOCK the sum over j ascending from +0 of M^-1[i][j] * r[j], the
// template's block_prec arithmetic (fused_grid_cg.cuh:316-333); else
// pre[i] * r[i].
template <bool BLOCK>
__device__ __forceinline__ float tv_z(const TvBox& bx, int C, int i, int q) {
  if constexpr (BLOCK) {
    const float* m = bx.s_m + i * C * bx.pts + q;
    float a = 0.f;
    for (int j = 0; j < C; ++j)
      a = __fadd_rn(a, __fmul_rn(m[j * bx.pts], bx.s_r[j * bx.pts + q]));
    return a;
  } else {
    return __fmul_rn(bx.s_m[i * bx.pts + q], bx.s_r[i * bx.pts + q]);
  }
}

// p = z + beta*p over the haloed frame's points inside the grid: z from
// s_ap over the box, from z_ring on the halo (with `init`, p = z on the
// halo and the box left as it is, and p = 0 beyond the grid).
__device__ __forceinline__ void tv_p_update(const TvBox& bx, int C, float beta,
                                            const float* z_ring, bool init) {
  const int h = bx.h, E0 = bx.r0 + 2 * h, E1 = bx.e1, E2 = bx.e2;
  for (TvWalk w(E0, E1, E2); w.c < C; w.next(E0, E1, E2)) {
    const int gz = bx.z0 + w.z - h, gy = bx.y0 + w.y - h, gx = bx.x0 + w.x - h;
    const bool in_grid = gz >= 0 && gz < bx.N0 && gy >= 0 && gy < bx.N1 && gx >= 0 &&
                         gx < bx.N2;
    const bool inner = w.z >= h && w.z < h + bx.r0 && w.y >= h && w.y < h + bx.r1 &&
                       w.x >= h && w.x < h + bx.r2;
    float* pp = bx.s_pe + w.o;  // the frame's flat index is the walk's
    if (init) {
      if (!in_grid) *pp = 0.f;
      else if (!inner) *pp = __ldcg(z_ring + w.c * bx.plane + (gz * bx.N1 + gy) * bx.N2 + gx);
      continue;
    }
    if (!in_grid) continue;  // stays 0
    const float zv =
        inner ? bx.s_ap[w.c * bx.pts + ((w.z - h) * bx.r1 + w.y - h) * bx.r2 + w.x - h]
              : __ldcg(z_ring + w.c * bx.plane + (gz * bx.N1 + gy) * bx.N2 + gx);
    *pp = __fadd_rn(zv, __fmul_rn(beta, *pp));
  }
}

// The kernel, block k owning box (k / (boxes1*boxes2), k / boxes2 %
// boxes1, k % boxes2) of the ceil split of the grid [N0, N1, N2] into
// b0 x b1 x b2 boxes with a halo of h. F [T, N0, N1, N2], b, delta and
// z_ring [C, N0, N1, N2], pre [C, ...] or under BLOCK the C*C planes of
// M^-1 [C*C, ...] (plane i*C + j: M^-1[i][j]), all float32. delta receives
// the solution; z_ring is scratch of one system's size, of which each block
// writes only its shell; partA and partB hold one record a block; iters
// one int.
template <bool BLOCK>
__global__ void __launch_bounds__(TGCG_THREADS, 1)
tiled_vol_cg_kernel(const float* __restrict__ F, const float* __restrict__ b,
                    const float* __restrict__ pre, const int* __restrict__ triples,
                    const int* __restrict__ starts, int C, int T, int n_triples, int N0, int N1,
                    int N2, int boxes1, int boxes2, int b0, int b1, int b2, int h, int lits,
                    float tol, int guard_div, float* delta, float* z_ring, double2* partA,
                    double2* partB, int* iters) {
  extern __shared__ double2 smem[];
  const int pts_max = b0 * b1 * b2;
  const int ext_max = (b0 + 2 * h) * (b1 + 2 * h) * (b2 + 2 * h);
  TvBox bx;
  bx.N0 = N0;
  bx.N1 = N1;
  bx.N2 = N2;
  bx.plane = N0 * N1 * N2;
  bx.z0 = (blockIdx.x / (boxes1 * boxes2)) * b0;
  bx.y0 = (blockIdx.x / boxes2 % boxes1) * b1;
  bx.x0 = (blockIdx.x % boxes2) * b2;
  bx.r0 = min(N0, bx.z0 + b0) - bx.z0;
  bx.r1 = min(N1, bx.y0 + b1) - bx.y0;
  bx.r2 = min(N2, bx.x0 + b2) - bx.x0;
  bx.pts = bx.r0 * bx.r1 * bx.r2;
  bx.h = h;
  bx.e1 = bx.r1 + 2 * h;
  bx.e2 = bx.r2 + 2 * h;
  bx.ext = (bx.r0 + 2 * h) * bx.e1 * bx.e2;
  bx.s_warp = smem;
  bx.s_bcast = smem + TGCG_WARPS;
  bx.s_fp = (int2*)(smem + TGCG_WARPS + 1);
  bx.s_start = (int*)(bx.s_fp + n_triples);
  bx.s_F = (float*)(bx.s_start + C + 1);
  bx.s_r = bx.s_F + T * pts_max;
  bx.s_d = bx.s_r + C * pts_max;
  bx.s_ap = bx.s_d + C * pts_max;  // Ap; z for the p update
  bx.s_pe = bx.s_ap + C * pts_max;  // p, haloed
  bx.s_m = bx.s_pe + C * ext_max;   // pre, or the C*C planes
  const int r0 = bx.r0, r1 = bx.r1, r2 = bx.r2, pts = bx.pts, ext = bx.ext;
  const int plane = bx.plane, n_blocks = gridDim.x;
  cg::grid_group grid = cg::this_grid();

  // staged once a solve: the triples' offsets (a triple's field at fid*pts
  // + q, its source at j*ext + e + (d0*e1 + d1)*e2 + d2), the box's fields
  // and preconditioner; r = b and delta = 0 over the box
  for (int k = threadIdx.x; k <= C; k += TGCG_THREADS) bx.s_start[k] = starts[k];
  for (int k = threadIdx.x; k < n_triples; k += TGCG_THREADS) {
    const int* t = triples + TGCG_ROW * k;
    bx.s_fp[k] = make_int2(t[5] * pts, t[4] * ext + (t[0] * bx.e1 + t[1]) * bx.e2 + t[2]);
  }
  for (TvWalk w(r0, r1, r2); w.c < T; w.next(r0, r1, r2))
    bx.s_F[w.o] = F[w.c * plane + bx.g(w.z, w.y, w.x)];
  for (TvWalk w(r0, r1, r2); w.c < (BLOCK ? C * C : C); w.next(r0, r1, r2))
    bx.s_m[w.o] = pre[w.c * plane + bx.g(w.z, w.y, w.x)];
  for (TvWalk w(r0, r1, r2); w.c < C; w.next(r0, r1, r2)) {
    bx.s_r[w.o] = b[w.c * plane + bx.g(w.z, w.y, w.x)];
    bx.s_d[w.o] = 0.f;
  }
  __syncthreads();

  // p = M^-1 b over the box (its shell of z to z_ring) and rz0 = <r, p>;
  // after the barrier p over the halo from the neighbours' shells, 0
  // beyond the grid
  double2 acc = make_double2(0.0, 0.0);
  for (TvWalk w(r0, r1, r2); w.c < C; w.next(r0, r1, r2)) {
    const int q = w.o - w.c * pts;
    const float zv = tv_z<BLOCK>(bx, C, w.c, q);
    bx.s_pe[w.c * ext + bx.e(w.z, w.y, w.x)] = zv;
    acc.x += (double)__fmul_rn(bx.s_r[w.o], zv);
    if (bx.shell(w.z, w.y, w.x)) z_ring[w.c * plane + bx.g(w.z, w.y, w.x)] = zv;
  }
  acc = tg_block_sum(acc, bx.s_warp);
  if (threadIdx.x == 0) partB[blockIdx.x] = acc;
  grid.sync();
  float rz = (float)tg_partials_sum(partB, n_blocks, bx.s_bcast).x;
  const float floor_rz = __fmul_rn(tol, rz);
  tv_p_update(bx, C, 0.f, z_ring, true);
  __syncthreads();

  int l = 0;
  while (l < lits) {
    // phase 1: Ap = A p over the box, the partials of <p, Ap>
    acc = make_double2(0.0, 0.0);
    for (TvWalk w(r0, r1, r2); w.c < C; w.next(r0, r1, r2)) {
      const int q = w.o - w.c * pts;
      const int e = bx.e(w.z, w.y, w.x);
      float a = 0.f;
      for (int k = bx.s_start[w.c]; k < bx.s_start[w.c + 1]; ++k) {
        const int2 fp = bx.s_fp[k];
        a = __fadd_rn(a, __fmul_rn(bx.s_F[fp.x + q], bx.s_pe[fp.y + e]));
      }
      bx.s_ap[w.o] = a;
      acc.x += (double)__fmul_rn(bx.s_pe[w.c * ext + e], a);
    }
    acc = tg_block_sum(acc, bx.s_warp);
    if (threadIdx.x == 0) partA[blockIdx.x] = acc;
    grid.sync();
    const float den = (float)tg_partials_sum(partA, n_blocks, bx.s_bcast).x;
    const float alpha = tg_safe_div(rz, den, guard_div);

    // phase 2: delta += alpha p, r -= alpha Ap; z = M^-1 r into Ap's space,
    // the partials of <z, r>, z's shell to z_ring
    acc = make_double2(0.0, 0.0);
    for (TvWalk w(r0, r1, r2); w.c < C; w.next(r0, r1, r2)) {
      const int e = bx.e(w.z, w.y, w.x);
      bx.s_d[w.o] = __fadd_rn(bx.s_d[w.o], __fmul_rn(alpha, bx.s_pe[w.c * ext + e]));
      const float rv = __fsub_rn(bx.s_r[w.o], __fmul_rn(alpha, bx.s_ap[w.o]));
      bx.s_r[w.o] = rv;
      if constexpr (!BLOCK) {
        const float zv = __fmul_rn(bx.s_m[w.o], rv);
        bx.s_ap[w.o] = zv;
        acc.x += (double)__fmul_rn(zv, rv);
        if (bx.shell(w.z, w.y, w.x)) z_ring[w.c * plane + bx.g(w.z, w.y, w.x)] = zv;
      }
    }
    if constexpr (BLOCK) {
      __syncthreads();  // z at a point reads every channel's r there
      for (TvWalk w(r0, r1, r2); w.c < C; w.next(r0, r1, r2)) {
        const float zv = tv_z<true>(bx, C, w.c, w.o - w.c * pts);
        bx.s_ap[w.o] = zv;
        acc.x += (double)__fmul_rn(zv, bx.s_r[w.o]);
        if (bx.shell(w.z, w.y, w.x)) z_ring[w.c * plane + bx.g(w.z, w.y, w.x)] = zv;
      }
    }
    acc = tg_block_sum(acc, bx.s_warp);
    if (threadIdx.x == 0) partB[blockIdx.x] = acc;
    grid.sync();
    const float rz_new = (float)tg_partials_sum(partB, n_blocks, bx.s_bcast).x;
    const float beta = tg_safe_div(rz_new, rz, guard_div);
    ++l;
    if (rz_new <= floor_rz || den <= 0.f) break;
    rz = rz_new;

    // phase 3: p = z + beta p over the box and its halo
    tv_p_update(bx, C, beta, z_ring, false);
    __syncthreads();
  }

  for (TvWalk w(r0, r1, r2); w.c < C; w.next(r0, r1, r2))
    delta[w.c * plane + bx.g(w.z, w.y, w.x)] = bx.s_d[w.o];
  if (blockIdx.x == 0 && threadIdx.x == 0) *iters = l;
}

extern "C" {

// Launches one solve on `stream`: boxes0 x boxes1 x boxes2 blocks of
// `threads` threads, each with smem_bytes of dynamic shared memory (which
// must be tv_smem_bytes of these arguments), on the operands the kernel
// above describes (pre the C*C planes under `block`); triples [n_triples, 6]
// sorted by output channel with their per-channel starts [C + 1]; partA and
// partB boxes0*boxes1*boxes2 double2 records each. Returns the CUDA error:
// cudaErrorInvalidValue for a refused shape (a box narrower than max(h, 1)
// or past the grid, boxes that do not cover it, shared memory other than
// the layout's), cudaErrorCooperativeLaunchTooLarge where the blocks cannot
// all be co-resident.
int tiled_vol_cg_launch(int block, const float* F, const float* b, const float* pre,
                        const int* triples, const int* starts, int C, int T, int n_triples,
                        int N0, int N1, int N2, int boxes0, int boxes1, int boxes2, int b0,
                        int b1, int b2, int h, int lits, float tol, int guard_div, float* delta,
                        float* z_ring, double2* partA, double2* partB, int* iters, int threads,
                        int smem_bytes, void* stream) {
  const int lo = h > 1 ? h : 1;
  const int n[3] = {N0, N1, N2}, boxes[3] = {boxes0, boxes1, boxes2}, w[3] = {b0, b1, b2};
  if (threads != TGCG_THREADS || C < 1 || C > TGCG_MAX_CHANNELS || T < 1 || n_triples < 1 ||
      n_triples > TGCG_MAX_TRIPLES || h < 0 ||
      (long long)smem_bytes != tv_smem_bytes(block, C, T, b0, b1, b2, h, n_triples))
    return (int)cudaErrorInvalidValue;
  for (int a = 0; a < 3; ++a)
    if (boxes[a] < 1 || w[a] < lo || boxes[a] * w[a] < n[a] || n[a] - (boxes[a] - 1) * w[a] < lo)
      return (int)cudaErrorInvalidValue;
  const void* kernel = block ? (const void*)tiled_vol_cg_kernel<true>
                             : (const void*)tiled_vol_cg_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem_bytes);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const int grid = boxes0 * boxes1 * boxes2;
  if (grid > per_sm * sms) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {(void*)&F,      (void*)&b,      (void*)&pre,       (void*)&triples,
                  (void*)&starts, (void*)&C,      (void*)&T,         (void*)&n_triples,
                  (void*)&N0,     (void*)&N1,     (void*)&N2,        (void*)&boxes1,
                  (void*)&boxes2, (void*)&b0,     (void*)&b1,        (void*)&b2,
                  (void*)&h,      (void*)&lits,   (void*)&tol,       (void*)&guard_div,
                  (void*)&delta,  (void*)&z_ring, (void*)&partA,     (void*)&partB,
                  (void*)&iters};
  e = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(threads), args, (size_t)smem_bytes,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
