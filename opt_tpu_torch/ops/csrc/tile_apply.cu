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
// What bounds it: memory traffic, and at the main path's size the latency
// of the loads. It reads the T field planes and, for each distinct
// (offset, channel), a shifted window of p_ext (through L1/L2: neighbouring
// threads and offsets reuse the same lines), and writes C planes; a few
// flops per byte. poisson 512x512x4 on 2x2 ranks: a 256x256 tile, 5 fields,
// 4 channels, 20 triples, about 3.4 MB an apply, 1.0 us at the HBM rate.
//
// What the design does about it:
//   * one thread per (output channel i, column x, TA_ROWS rows of the
//     tile): TA_BLOCK threads along x, so the field and p_ext reads of a
//     warp are coalesced; blockIdx.y is a band of TA_ROWS rows, blockIdx.z
//     the channel. A thread's rows are apart by one band's height, and each
//     triple's loads for all of them are issued together, so a thread has
//     TA_ROWS loads in flight where it had one;
//   * the triples come as a kernel parameter (TaTable, filled by the launch
//     from host arrays): each as its flat source offset into p_ext, its
//     field and the channels' starts. A block starts its loads at once;
//     there is no copy of the table into shared memory, no barrier, and no
//     load that waits on another;
//   * every read is inside p_ext (the halo holds what a stencil read
//     needs), so no read is bounds-checked: a read beyond the global edge
//     reads the zero halo, and its field is zero there too (the planner
//     folded each offset's in-bounds mask into its field);
//   * acc = __fadd_rn(acc, __fmul_rn(F, p)) in the table's order for each
//     channel, from 0, as fused_grid_cg.cuh's stencil phase sums (no fused
//     multiply-add): bitwise equal to the plain PyTorch version
//     (sharded_cg.py::tile_apply_reference);
//   * F is float32 or bfloat16 (widened exactly with __bfloat162float),
//     p_ext and out float32; or all three float64 (tile_apply_kernel<double>,
//     a float64 plan on a mesh), summed by __dadd_rn(acc, __dmul_rn(F, p))
//     in the same order. A float64 apply moves twice the bytes of a float32
//     one and does its adds and multiplies at the card's float64 rate
//     (34 TFLOP/s against 67), still far below the bytes' time.
// A block that stages p's haloed window and the named field planes in
// shared memory (each value read from device memory once, four points a
// thread, 16-byte field loads and stores) was slower on both main-path
// tiles: its staging, barrier and shared-memory reads cost more than the
// L1/L2 reuse they save at this size (PERF.md, Findings).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define TA_BLOCK 256
#define TA_ROWS 2
#define TA_MAX_TRIPLES 512
#define TA_MAX_CHANNELS 64
#define TA_ROW 4  // a triple as the host gives it: dx, dy, j, fid (sorted by i)

// The triples as the kernel reads them, a kernel parameter (3.2 KB): each
// triple's source place j*eplane + (ah+dx)*ew + (aw+dy) in p_ext and its
// field, in the order of the channels' starts.
struct TaTable {
  int src[TA_MAX_TRIPLES];
  unsigned short fid[TA_MAX_TRIPLES];
  unsigned short start[TA_MAX_CHANNELS + 1];
};

// The type of p_ext, out and the sums for fields of type FT.
template <typename FT>
struct TaVec {
  typedef float T;
};
template <>
struct TaVec<double> {
  typedef double T;
};

__device__ __forceinline__ float ta_ldf(const float* __restrict__ a, int i) {
  return a[i];
}
__device__ __forceinline__ float ta_ldf(const __nv_bfloat16* __restrict__ a,
                                        int i) {
  return __bfloat162float(a[i]);
}
__device__ __forceinline__ double ta_ldf(const double* __restrict__ a, int i) {
  return a[i];
}
__device__ __forceinline__ float ta_madd_rn(float acc, float f, float p) {
  return __fadd_rn(acc, __fmul_rn(f, p));
}
__device__ __forceinline__ double ta_madd_rn(double acc, double f, double p) {
  return __dadd_rn(acc, __dmul_rn(f, p));
}

template <typename FT>
__global__ void __launch_bounds__(TA_BLOCK)
    tile_apply_kernel(const FT* __restrict__ F,
                      const typename TaVec<FT>::T* __restrict__ p_ext,
                      typename TaVec<FT>::T* __restrict__ out,
                      const __grid_constant__ TaTable tab, int th, int tw, int aw) {
  typedef typename TaVec<FT>::T T;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y0 = blockIdx.y * TA_ROWS;
  // y0 < th always; said here, it spares the first row its bound test, and
  // the row loads of a triple then issue together
  if (x >= tw || y0 >= th) return;
  const int ew = tw + 2 * aw;
  const int plane = th * tw;
  const int i = blockIdx.z;
  const int q = y0 * tw + x;
  const int qe = y0 * ew + x;
  T a[TA_ROWS];
#pragma unroll
  for (int r = 0; r < TA_ROWS; ++r) a[r] = T(0);
  const int k1 = tab.start[i + 1];
  for (int k = tab.start[i]; k < k1; ++k) {
    const int f = tab.fid[k] * plane + q;
    const int s = tab.src[k] + qe;
#pragma unroll
    for (int r = 0; r < TA_ROWS; ++r)
      if (y0 + r < th)
        a[r] = ta_madd_rn(a[r], ta_ldf(F, f + r * tw), p_ext[s + r * ew]);
  }
#pragma unroll
  for (int r = 0; r < TA_ROWS; ++r)
    if (y0 + r < th) out[i * plane + q + r * tw] = a[r];
}

extern "C" {

// Launches the apply on `stream`: `ftype` 0 float32 fields, p_ext and out;
// 1 bfloat16 fields, float32 p_ext and out; 2 float64 fields, p_ext and
// out. `triples` (n_triples rows of dx, dy, j, fid, sorted by output
// channel) and `starts` (C + 1 row starts) are host arrays. Returns the
// CUDA error code (0: launched).
int tile_apply_launch(int ftype, const void* F, const void* p_ext, void* out,
                      const int* triples, const int* starts, int n_triples,
                      int C, int th, int tw, int ah, int aw, void* stream) {
  if (n_triples < 1 || n_triples > TA_MAX_TRIPLES || C < 1 ||
      C > TA_MAX_CHANNELS || th < 1 || tw < 1 ||
      (th + TA_ROWS - 1) / TA_ROWS > 65535 || ftype < 0 || ftype > 2)
    return (int)cudaErrorInvalidValue;
  const int ew = tw + 2 * aw;
  const int eplane = (th + 2 * ah) * ew;
  TaTable tab;
  for (int k = 0; k < n_triples; ++k) {
    const int* t = triples + TA_ROW * k;
    if (t[3] < 0 || t[3] > 0xffff) return (int)cudaErrorInvalidValue;
    tab.src[k] = t[2] * eplane + (ah + t[0]) * ew + (aw + t[1]);
    tab.fid[k] = (unsigned short)t[3];
  }
  for (int c = 0; c <= C; ++c) tab.start[c] = (unsigned short)starts[c];
  const dim3 grid((tw + TA_BLOCK - 1) / TA_BLOCK, (th + TA_ROWS - 1) / TA_ROWS, C);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ftype == 2)
    tile_apply_kernel<double><<<grid, TA_BLOCK, 0, s>>>(
        static_cast<const double*>(F), static_cast<const double*>(p_ext),
        static_cast<double*>(out), tab, th, tw, aw);
  else if (ftype == 1)
    tile_apply_kernel<__nv_bfloat16><<<grid, TA_BLOCK, 0, s>>>(
        static_cast<const __nv_bfloat16*>(F), static_cast<const float*>(p_ext),
        static_cast<float*>(out), tab, th, tw, aw);
  else
    tile_apply_kernel<float><<<grid, TA_BLOCK, 0, s>>>(
        static_cast<const float*>(F), static_cast<const float*>(p_ext),
        static_cast<float*>(out), tab, th, tw, aw);
  return (int)cudaGetLastError();
}

}  // extern "C"
