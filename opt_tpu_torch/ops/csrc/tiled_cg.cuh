// What the tiled CG kernels share (tiled_grid_cg.cu and tiled_grid_cs.cu,
// one tile of a 2-D grid a block; tiled_vol_cg.cu, one box of a 3-D grid a
// block; tiled_graph_cg.cu, one vertex range of a graph a block):
// the block of 512 threads, one a streaming multiprocessor, the grid
// kernels' limits and triple rows, the guarded division of alpha and beta,
// and the dot products' fixed-order sums, so that every block of a launch
// reads the same alpha, beta and exit.

#pragma once

#include <cuda_runtime.h>

#define TGCG_THREADS 512
#define TGCG_WARPS (TGCG_THREADS / 32)
// the grid kernels' limits (ops/fused_cg.py: MAX_TRIPLES, MAX_CHANNELS)
#define TGCG_MAX_TRIPLES 512
#define TGCG_MAX_CHANNELS 64
#define TGCG_ROW 6  // a triple as the host gives it: d0, d1, d2, i, j, fid

__device__ __forceinline__ float tg_safe_div(float num, float den, int guard) {
  if (!guard) return __fdiv_rn(num, den);
  return den > 0.f ? __fdiv_rn(num, den) : 0.f;
}

// Block sum of v (both components) in a fixed order; valid in thread 0.
__device__ __forceinline__ double2 tg_block_sum(double2 v, double2* s_warp) {
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_down_sync(0xffffffffu, v.x, o);
    v.y += __shfl_down_sync(0xffffffffu, v.y, o);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  double2 s = make_double2(0.0, 0.0);
  if (threadIdx.x == 0) {
    for (int w = 0; w < TGCG_WARPS; ++w) {
      s.x += s_warp[w].x;
      s.y += s_warp[w].y;
    }
  }
  return s;  // the grid barrier that follows orders the next use of s_warp
}

// Sum of the n blocks' partial records, in the same fixed order in every
// block: one warp reads them, lane k the records k, k + 32, ...
__device__ __forceinline__ double2 tg_partials_sum(const double2* part, int n,
                                                   double2* s_bcast) {
  if (threadIdx.x < 32) {
    double2 s = make_double2(0.0, 0.0);
    for (int k = threadIdx.x; k < n; k += 32) {
      const double2 v = __ldcg(part + k);
      s.x += v.x;
      s.y += v.y;
    }
    for (int o = 16; o > 0; o >>= 1) {
      s.x += __shfl_down_sync(0xffffffffu, s.x, o);
      s.y += __shfl_down_sync(0xffffffffu, s.y, o);
    }
    if (threadIdx.x == 0) *s_bcast = s;
  }
  __syncthreads();
  return *s_bcast;  // rewritten only after the next grid barrier
}
