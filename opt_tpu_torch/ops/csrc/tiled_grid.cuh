// What the two tiled grid kernels share (tiled_grid_cg.cu, the standard
// loop; tiled_grid_cs.cu, the Chronopoulos-Gear loop): one tile of a 2-D
// grid a block, the walk over a tile's points, the stencil over a haloed
// frame in shared memory, the tile's geometry and the triples' offsets, and
// the dynamic shared memory of a launch in either layout.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tiled_cg.cuh"

namespace cg = cooperative_groups;

// A walk over the points of a [rows][cols] frame at the block's stride:
// point q = y*cols + x from threadIdx.x, advanced by addition.
struct TgWalk {
  int q, y, x, sy, sx;
  __device__ __forceinline__ TgWalk(int cols) {
    q = threadIdx.x;
    y = q / cols;
    x = q - y * cols;
    sy = TGCG_THREADS / cols;
    sx = TGCG_THREADS - sy * cols;
  }
  __device__ __forceinline__ void next(int cols) {
    q += TGCG_THREADS;
    y += sy;
    x += sx;
    if (x >= cols) {
      x -= cols;
      ++y;
    }
  }
};

// A coefficient as float32: bfloat16 widens exactly
__device__ __forceinline__ float tg_widen(float v) { return v; }
__device__ __forceinline__ float tg_widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// sum over the triples k0..k1 of F[field k][g] * src[sp[k] + e], from +0, in
// the triples' order: g is the output point in the grid, e its place in the
// haloed frame of src (sp[k] holds the source channel's frame and the
// offset within it). FT is the fields' storage type, float or bfloat16,
// whose loads stay coalesced: consecutive threads read consecutive points.
template <typename FT>
__device__ __forceinline__ float tg_stencil(const FT* __restrict__ F, const float* src,
                                            const int* s_f, const int* s_p, int k0, int k1,
                                            int g, int e) {
  float a = 0.f;
  for (int k = k0; k < k1; ++k)
    a = __fadd_rn(a, __fmul_rn(tg_widen(F[s_f[k] + g]), src[s_p[k] + e]));
  return a;
}

// The dynamic shared memory of a launch, in bytes, in the kernels' layouts.
// The standard loop (tiled_grid_cg.cu): the block-sum records, r, delta, p
// (haloed), Ap (haloed under LM), under block-Jacobi the C*C preconditioner
// planes over the tile and its halo; in the hbm layout only the records, r
// and p (haloed), delta and Ap living in a device frame a block.
// Chronopoulos-Gear (tiled_grid_cs.cu): the block-sum records (two sets
// under LM, whose three dots take two records), r, s and u haloed, p and
// delta haloed under LM (over the tile under GN), w over the tile. Then the
// triples' field and source offsets and the channels' first triples.
__host__ __device__ __forceinline__ long long tg_smem_bytes(int lm, int block, int cs, int hbm,
                                                           int C, int th, int tw, int h,
                                                           int n_triples) {
  const long long pts = (long long)th * tw;
  const long long ext = (long long)(th + 2 * h) * (tw + 2 * h);
  const long long triples = 4LL * (2 * n_triples + C + 1);
  if (hbm) return 16LL * (TGCG_WARPS + 1) + 4LL * C * (pts + ext) + triples;
  if (cs)
    return 16LL * (TGCG_WARPS + 1) * (lm ? 2 : 1) +
           4LL * C * (lm ? 5 * ext + pts : 3 * ext + 3 * pts) + triples;
  return 16LL * (TGCG_WARPS + 1) + 4LL * C * (2 * pts + ext + (lm ? ext : pts)) +
         (block ? 4LL * C * C * ext : 0LL) + triples;
}

// The tile's view of the launch, the same for every system of it: its
// shared-memory arrays, its place in the grid and the triples' offsets.
// The standard loop keeps r, delta, p and Ap in s_r, s_d, s_pe, s_ap (and
// the C*C planes in s_m; in the hbm layout s_d and s_ap point into the
// block's device frame instead); Chronopoulos-Gear r, delta, p and w in
// s_r, s_d, s_pe, s_ap, and s and u in s_s, s_u.
struct TgTile {
  double2* s_warp;   // TGCG_WARPS block-sum records (two sets under CS LM)
  double2* s_bcast;  // one record (two under CS LM)
  float *s_r, *s_d, *s_pe, *s_ap, *s_m, *s_s, *s_u;
  const int *s_f, *s_p, *s_start;
  int N1, N2, plane, y0, x0, rows, cols, pts, pcols, ext, h, n_blocks;
};

// Block k's tile of the ceil split of the grid [N1, N2] into th x tw tiles
// with a halo of h (tile (k / tiles_c, k % tiles_c)), and the triples'
// field and source offsets and the channels' first triples copied to
// s_f, s_p, s_start (n_triples, n_triples and C + 1 ints). The caller
// synchronises the block before reading them.
__device__ __forceinline__ void tg_tile_setup(TgTile& tt, const int* __restrict__ triples,
                                              const int* __restrict__ starts, int C,
                                              int n_triples, int N1, int N2, int tiles_c,
                                              int th, int tw, int h, int* s_f, int* s_p,
                                              int* s_start) {
  tt.N1 = N1;
  tt.N2 = N2;
  tt.plane = N1 * N2;
  tt.y0 = (blockIdx.x / tiles_c) * th;  // the tile's first row, column
  tt.x0 = (blockIdx.x % tiles_c) * tw;
  tt.rows = min(N1, tt.y0 + th) - tt.y0;
  tt.cols = min(N2, tt.x0 + tw) - tt.x0;
  tt.pts = tt.rows * tt.cols;
  tt.pcols = tt.cols + 2 * h;
  tt.ext = (tt.rows + 2 * h) * tt.pcols;
  tt.h = h;
  tt.n_blocks = gridDim.x;
  for (int k = threadIdx.x; k <= C; k += TGCG_THREADS) s_start[k] = starts[k];
  for (int k = threadIdx.x; k < n_triples; k += TGCG_THREADS) {
    const int* t = triples + TGCG_ROW * k;
    s_f[k] = t[5] * tt.plane;
    s_p[k] = t[4] * tt.ext + t[1] * tt.pcols + t[2];
  }
  tt.s_f = s_f;
  tt.s_p = s_p;
  tt.s_start = s_start;
}

// The checks and the cooperative launch that tiled_grid_cg_launch and
// tiled_grid_cs_launch share (defined in tiled_grid_cg.cu): `kernel` on
// tiles_r x tiles_c blocks of `threads` threads with `args`, its own
// argument list, after checking the tiles against the grid [N1, N2], the
// channel and triple counts, and smem_bytes against `need`, the form's
// tg_smem_bytes. Returns the CUDA error: cudaErrorInvalidValue for a
// refused shape, cudaErrorCooperativeLaunchTooLarge where the blocks
// cannot all be co-resident.
int tg_launch(const void* kernel, void** args, int C, int n_triples, int N1, int N2,
              int tiles_r, int tiles_c, int th, int tw, int h, long long need,
              int threads, int smem_bytes, void* stream);
