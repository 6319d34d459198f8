// One rank's part of the stencil apply of a grid CG operator sharded over a
// 2-D mesh of ranks, for Hopper (sm_90a):
//   out[i][y][x] = sum over the triples t with output channel i of
//                  F[fid_t][y][x] * p_ext[j_t][ah + dx_t + y][aw + dy_t + x]
// on a tile [C, th, tw], reading the tile's p extended by its halo,
// p_ext [C, th + 2*ah, tw + 2*aw] (ops/sharded_cg.py builds it from the
// neighbours' tiles, zeros beyond the global edge).
//
// Replaces, in opt_tpu/ops/pallas_cg.py: _tile_apply_kernel (:1167), the
// Pallas TPU kernel that sharded_fused_grid_cg (:1204, pallas_call :1309)
// runs once per CG iteration on every device of the mesh, by static slices
// of the halo-extended tile. As there, the apply is the kernel's whole work:
// the halo exchange, the dots (all_reduce), the loop's vector updates and
// LM's ctc*p stay outside.
//
// What bounds it: memory traffic. It reads the T field planes and, for each
// distinct (offset, channel), a shifted window of p_ext (through L1/L2:
// neighbouring threads and offsets reuse the same lines), and writes C
// planes; a few flops per byte. poisson 512x512x4 on 2x2 ranks: a 256x256
// tile, 5 fields, 4 channels, 20 triples, about 3.4 MB an apply.
//
// What the design does about it:
//   * one thread per (output channel i, point (y, x)) of the tile, 256
//     threads along x, so the field and p_ext reads of a warp are
//     coalesced; blockIdx.y is the row, blockIdx.z the channel;
//   * the triples sit as a CSR by output channel in shared memory, each as
//     its flat source offset into p_ext and its field offset, computed
//     once per block;
//   * every read is inside p_ext (the halo holds what a stencil read
//     needs), so no read is bounds-checked: a read beyond the global edge
//     reads the zero halo, and its field is zero there too (the planner
//     folded each offset's in-bounds mask into its field);
//   * acc = __fadd_rn(acc, __fmul_rn(F, p)) in the table's order for each
//     channel, from 0, as fused_grid_cg.cuh's stencil phase sums (no fused
//     multiply-add): bitwise equal to the plain PyTorch version
//     (sharded_cg.py::tile_apply_reference);
//   * F is float32 or bfloat16 (widened exactly with __bfloat162float);
//     p_ext and out are float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define TA_BLOCK 256
#define TA_MAX_TRIPLES 512
#define TA_MAX_CHANNELS 64
#define TA_ROW 4  // a triple as the host gives it: dx, dy, j, fid (sorted by i)

__device__ __forceinline__ float ta_ldf(const float* __restrict__ a, int i) {
  return a[i];
}
__device__ __forceinline__ float ta_ldf(const __nv_bfloat16* __restrict__ a,
                                        int i) {
  return __bfloat162float(a[i]);
}

template <typename FT>
__global__ void __launch_bounds__(TA_BLOCK)
    tile_apply_kernel(const FT* __restrict__ F, const float* __restrict__ p_ext,
                      float* __restrict__ out, const int* __restrict__ triples,
                      const int* __restrict__ starts, int n_triples, int C,
                      int th, int tw, int ah, int aw) {
  __shared__ int s_src[TA_MAX_TRIPLES];  // j*eplane + (ah+dx)*ew + (aw+dy)
  __shared__ int s_fld[TA_MAX_TRIPLES];  // fid*plane
  __shared__ int s_start[TA_MAX_CHANNELS + 1];
  const int ew = tw + 2 * aw;
  const int eplane = (th + 2 * ah) * ew;
  const int plane = th * tw;
  for (int k = threadIdx.x; k < n_triples; k += blockDim.x) {
    const int* t = triples + TA_ROW * k;
    s_src[k] = t[2] * eplane + (ah + t[0]) * ew + (aw + t[1]);
    s_fld[k] = t[3] * plane;
  }
  for (int c = threadIdx.x; c <= C; c += blockDim.x) s_start[c] = starts[c];
  __syncthreads();
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= tw) return;
  const int y = blockIdx.y;
  const int i = blockIdx.z;
  const int q = y * tw + x;
  const int qe = y * ew + x;
  float a = 0.f;
  const int k1 = s_start[i + 1];
  for (int k = s_start[i]; k < k1; ++k)
    a = __fadd_rn(a, __fmul_rn(ta_ldf(F, s_fld[k] + q), p_ext[s_src[k] + qe]));
  out[i * plane + q] = a;
}

extern "C" {

// Launches the apply on `stream`; returns the CUDA error code (0: launched).
int tile_apply_launch(int bf16, const void* F, const float* p_ext, float* out,
                      const int* triples, const int* starts, int n_triples,
                      int C, int th, int tw, int ah, int aw, void* stream) {
  if (n_triples < 1 || n_triples > TA_MAX_TRIPLES || C < 1 ||
      C > TA_MAX_CHANNELS || th < 1 || tw < 1 || th > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((tw + TA_BLOCK - 1) / TA_BLOCK, th, C);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    tile_apply_kernel<__nv_bfloat16><<<grid, TA_BLOCK, 0, s>>>(
        static_cast<const __nv_bfloat16*>(F), p_ext, out, triples, starts,
        n_triples, C, th, tw, ah, aw);
  else
    tile_apply_kernel<float><<<grid, TA_BLOCK, 0, s>>>(
        static_cast<const float*>(F), p_ext, out, triples, starts, n_triples,
        C, th, tw, ah, aw);
  return (int)cudaGetLastError();
}

}  // extern "C"
