// Whole-loop Jacobi-preconditioned CG for 2-D grid stencil operators and
// graph operators, as one persistent cooperative kernel for Hopper
// (sm_90a), in four instances: Gauss-Newton (LM = false) and
// Levenberg-Marquardt (LM = true), each without and with the graph
// remainder phase (REM).
//
// Replaces, in opt_tpu/ops/pallas_cg.py:
//   * _kernel (:328), the Pallas TPU kernel that runs the whole PCG inner
//     loop of a grid problem in one launch, in its 2-D grid GN form, its
//     mixed-unknown form (several unknowns packed into the channels, with
//     cross-channel couplings i != j: image_warping's Offset(2) + Angle(1))
//     and its lm=True form (_run_cg's lm_body);
//   * _hbm_tiled_kernel (:1430), the TPU kernel that runs the same GN and LM
//     loops for grids whose state does not fit VMEM, by streaming row
//     windows from HBM in three sweeps per iteration. This kernel reads its
//     state from device memory in every phase anyway (through L2), so the
//     same two instances serve those cases; the row-window DMA is not
//     carried over;
//   * _kernel's flat1d=True graph form (:335, apply :386-405): same-vertex
//     blocks and per-offset DIA fields over a vertex axis the TPU folds to
//     [R, 512] and reads by flat rolls. Here the vertex axis is the grid
//     [1, N], a flat offset d is the grid offset (0, d), and the REM=false
//     instances run it unchanged;
//   * _kernel's rem_pairs form (:338, :410-494): the irregular remainder of
//     a graph operator, which the TPU applies by one-hot matmuls on its
//     matrix unit. Here it is the REM=true instances' remainder phase: a
//     destination-sorted block CSR, one C x C block per distinct (v, u)
//     read, out[i][v] += sum_k sum_j blk[k][i][j] * p[j][col[k]].
//
// What it computes, on channel-major [C, N0, N1] float32 state:
//   r = b, p = pre*r, rz = <r, p>, floor = tol*rz, Q0 = 0
//   repeat while l < lits:
//     Ap[i] = sum_t F[fid_t] * p[j_t] read at offset (d0_t, d1_t)
//             (+ the remainder under REM) (+ ctc*p under LM)
//     den = <p, Ap>;  alpha = rz/den (guarded);  delta += alpha*p
//     GN, or LM off a reset iteration:  r -= alpha*Ap
//     LM when (l+1) % reset_period == 0:  r = b - (A*delta + ctc*delta)
//     z = pre*r;  rz_new = <z, r>;  beta = rz_new/rz (guarded);  l += 1
//     GN exit: rz_new <= floor or den <= 0
//     LM exit: zeta < q_tol or rz_new <= floor, with Q1 = 0.5*<delta, b+r>,
//              zeta = (l*(Q1 - Q0))/Q1, Q0 = Q1 (no den <= 0 exit)
//     p = z + beta*p
// and returns delta and the executed iteration count l.
//
// What bounds it: memory traffic. A GN iteration reads the T coefficient
// planes and about 6*C state planes (p at every stencil offset, Ap, r,
// delta, pre) and writes about 4*C. LM adds the ctc plane in the apply, the
// b plane for the third dot <delta, b+r>, and on a reset iteration one more
// stencil sweep over delta. For poisson 512x512x4 that is about 25 MB per
// iteration, which fits the H100's 50 MB L2, so the loop runs mostly out of
// L2; image_warping 1024x1024x3 (26 fields read by 31 triples) moves about
// 170 MB per iteration and every phase streams from HBM. The arithmetic is
// a few flops per byte. A graph's remainder adds its C*C blocks per entry
// (the armadillo mesh, 31k vertices: about 187k entries, 27 MB) and one
// gathered read of p per entry and channel.
//
// What the design does about it:
//   * One launch for the whole loop (no per-iteration launch or host round
//     trip, the TPU kernel's contract): a cooperative grid of co-resident
//     blocks walks the C*N0*N1 elements with grid-stride loops, and three
//     grid-wide barriers per iteration separate the phases that read other
//     blocks' results (apply + <p,Ap>; update + <z,r> (+ <delta,b+r>);
//     p update). An LM reset iteration adds one barrier between the delta
//     update and the stencil sweep that reads neighbours' delta.
//   * Every thread owns the same elements in every phase, so r, delta, Ap
//     and p[e] stay in the thread's own program order; only the stencil
//     reads of p or delta (other blocks' elements) and the reduction
//     partials cross blocks, and those are read through L2 (ld.global.cg).
//   * z is recomputed as pre*r in the p update instead of being stored:
//     two reads in place of a write plus a read.
//   * Reads that leave the grid are skipped, never wrapped: the planner
//     folded each offset's in-bounds mask into its field, so a skipped read
//     is exactly the zero the plain version multiplies in.
//   * The remainder is a gather, not a scatter: the thread that owns
//     output element (i, v) walks row v of the CSR after its stencil sum,
//     in entry order and then j order, reading p through L2. No atomics, so
//     two runs are bitwise equal, and the plain version sums in the same
//     order. It is a template flag, so the grid instances keep their code
//     and registers; the LM reset sweep applies it to delta as well.
//   * Dot products: per-thread float products summed in double, a fixed
//     shuffle tree per block, per-block partials in separate buffers for
//     each dot, and every block sums the partials in the same fixed order.
//     alpha, beta, zeta and the exit test are therefore identical in every
//     block, the loop exits uniformly, and two runs give bitwise-equal
//     results.
//   * Elementwise and scalar arithmetic uses explicit round-to-nearest
//     intrinsics (no fused multiply-add), in the plain PyTorch version's
//     order of operations.
//   * The two instances have their own register counts, so the co-resident
//     block count is queried, and the launch checked, per instance.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define FGCG_BLOCK 256
#define FGCG_MAX_TRIPLES 512
#define FGCG_MAX_CHANNELS 64

// Block sum of v in a fixed order; the result is valid in thread 0.
__device__ __forceinline__ double block_sum(double v, double* s_warp) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0) {
    for (int w = 0; w < FGCG_BLOCK / 32; ++w) s += s_warp[w];
  }
  __syncthreads();
  return s;
}

// Sum of the n per-block partials, in the same fixed order in every block.
__device__ __forceinline__ double partials_sum(const double* part, int n,
                                               double* s_bcast) {
  if (threadIdx.x < 32) {
    double s = 0.0;
    for (int k = threadIdx.x; k < n; k += 32) s += __ldcg(part + k);
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (threadIdx.x == 0) *s_bcast = s;
  }
  __syncthreads();
  const double s = *s_bcast;
  __syncthreads();
  return s;
}

__device__ __forceinline__ float safe_div(float num, float den, int guard) {
  if (!guard) return __fdiv_rn(num, den);
  return den > 0.f ? __fdiv_rn(num, den) : 0.f;
}

// sum over the triples k0..k1 of F[fid][q] * src[j] at (x + d0, y + d1),
// skipping reads that leave the grid; src is read through L2 (other blocks
// wrote it before the last grid barrier). The LM reset sweep applies the
// stencil to delta with it; phase 1 keeps the same loop written out, which
// leaves the GN instance's code (32 registers) as it was before the LM
// instance existed (through the helper it took 48).
__device__ __forceinline__ float stencil_apply(const float* __restrict__ F,
                                               const float* src,
                                               const int* s_tr, int k0, int k1,
                                               int plane, int N0, int N1,
                                               int q, int x, int y) {
  float a = 0.f;
  for (int k = k0; k < k1; ++k) {
    const int* t = s_tr + 5 * k;
    const int xx = x + t[0];
    const int yy = y + t[1];
    if (xx >= 0 && xx < N0 && yy >= 0 && yy < N1) {
      const float pv = __ldcg(src + t[3] * plane + xx * N1 + yy);
      a = __fadd_rn(a, __fmul_rn(F[t[4] * plane + q], pv));
    }
  }
  return a;
}

// a + sum over row v's remainder entries k and over j of
// blk[k][i][j] * src[j][col[k]], in that order; src is read through L2.
__device__ __forceinline__ float remainder_apply(const int* __restrict__ rowptr,
                                                 const int* __restrict__ col,
                                                 const float* __restrict__ blk,
                                                 const float* src, int C,
                                                 int plane, int i, int v,
                                                 float a) {
  const int k1 = rowptr[v + 1];
  for (int k = rowptr[v]; k < k1; ++k) {
    const int u = col[k];
    const float* bk = blk + (k * C + i) * C;
    for (int j = 0; j < C; ++j)
      a = __fadd_rn(a, __fmul_rn(bk[j], __ldcg(src + j * plane + u)));
  }
  return a;
}

template <bool LM, bool REM>
__global__ void __launch_bounds__(FGCG_BLOCK)
fused_grid_cg_kernel(const float* __restrict__ F, const float* __restrict__ b,
                     const float* __restrict__ pre,
                     const float* __restrict__ ctc,
                     const int* __restrict__ triples,
                     const int* __restrict__ starts,
                     const int* __restrict__ rowptr,
                     const int* __restrict__ col,
                     const float* __restrict__ blk, int C, int N0, int N1,
                     int lits, float tol, int guard_div, int reset_period,
                     float q_tol, float* delta, float* r, float* p, float* Ap,
                     double* part_den, double* part_rz, double* part_q,
                     int* iters) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int s_tr[FGCG_MAX_TRIPLES * 5];
  __shared__ int s_start[FGCG_MAX_CHANNELS + 1];
  __shared__ double s_warp[FGCG_BLOCK / 32];
  __shared__ double s_bcast;

  for (int k = threadIdx.x; k <= C; k += blockDim.x) s_start[k] = starts[k];
  __syncthreads();
  const int n_triples = s_start[C];
  for (int k = threadIdx.x; k < 5 * n_triples; k += blockDim.x)
    s_tr[k] = triples[k];
  __syncthreads();

  const int plane = N0 * N1;
  const int total = C * plane;
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int n_blocks = gridDim.x;

  // r = b, p = z = pre*r, delta = 0, rz0 = <r, z>
  double acc = 0.0;
  for (int e = first; e < total; e += stride) {
    const float rv = b[e];
    const float z = __fmul_rn(pre[e], rv);
    r[e] = rv;
    p[e] = z;
    delta[e] = 0.f;
    acc += (double)__fmul_rn(rv, z);
  }
  acc = block_sum(acc, s_warp);
  if (threadIdx.x == 0) part_rz[blockIdx.x] = acc;
  grid.sync();
  float rz = (float)partials_sum(part_rz, n_blocks, &s_bcast);
  const float floor_rz = __fmul_rn(tol, rz);
  float q0 = 0.f;

  int l = 0;
  while (l < lits) {
    // phase 1: Ap = A p (+ ctc p), partials of <p, Ap>
    acc = 0.0;
    for (int e = first; e < total; e += stride) {
      const int c = e / plane;
      const int q = e - c * plane;
      const int x = q / N1;
      const int y = q - x * N1;
      float a = 0.f;
      for (int k = s_start[c]; k < s_start[c + 1]; ++k) {
        const int* t = s_tr + 5 * k;
        const int xx = x + t[0];
        const int yy = y + t[1];
        if (xx >= 0 && xx < N0 && yy >= 0 && yy < N1) {
          const float pv = __ldcg(p + t[3] * plane + xx * N1 + yy);
          a = __fadd_rn(a, __fmul_rn(F[t[4] * plane + q], pv));
        }
      }
      // graph remainder: N0 == 1, so the vertex is q
      if constexpr (REM)
        a = remainder_apply(rowptr, col, blk, p, C, plane, c, q, a);
      if constexpr (LM) a = __fadd_rn(a, __fmul_rn(ctc[e], p[e]));
      Ap[e] = a;
      acc += (double)__fmul_rn(p[e], a);
    }
    acc = block_sum(acc, s_warp);
    if (threadIdx.x == 0) part_den[blockIdx.x] = acc;
    grid.sync();
    const float den = (float)partials_sum(part_den, n_blocks, &s_bcast);
    const float alpha = safe_div(rz, den, guard_div);

    // phase 2: delta += alpha p, r -= alpha Ap (or, on an LM reset
    // iteration, r = b - (A delta + ctc delta)), partials of <z, r> and,
    // under LM, of <delta, b + r>
    acc = 0.0;
    double acc_q = 0.0;
    bool reset = false;
    if constexpr (LM) reset = (l + 1) % reset_period == 0;
    if (reset) {
      for (int e = first; e < total; e += stride)
        delta[e] = __fadd_rn(delta[e], __fmul_rn(alpha, p[e]));
      grid.sync();  // the stencil below reads neighbours' delta
      for (int e = first; e < total; e += stride) {
        const int c = e / plane;
        const int q = e - c * plane;
        const int x = q / N1;
        const int y = q - x * N1;
        const float dv = delta[e];
        float a = stencil_apply(F, delta, s_tr, s_start[c], s_start[c + 1],
                                plane, N0, N1, q, x, y);
        if constexpr (REM)
          a = remainder_apply(rowptr, col, blk, delta, C, plane, c, q, a);
        a = __fadd_rn(a, __fmul_rn(ctc[e], dv));
        const float bv = b[e];
        const float rv = __fsub_rn(bv, a);
        r[e] = rv;
        acc += (double)__fmul_rn(__fmul_rn(pre[e], rv), rv);
        acc_q += (double)__fmul_rn(dv, __fadd_rn(bv, rv));
      }
    } else {
      for (int e = first; e < total; e += stride) {
        const float dv = __fadd_rn(delta[e], __fmul_rn(alpha, p[e]));
        delta[e] = dv;
        const float rv = __fsub_rn(r[e], __fmul_rn(alpha, Ap[e]));
        r[e] = rv;
        acc += (double)__fmul_rn(__fmul_rn(pre[e], rv), rv);
        if constexpr (LM) acc_q += (double)__fmul_rn(dv, __fadd_rn(b[e], rv));
      }
    }
    acc = block_sum(acc, s_warp);
    if (threadIdx.x == 0) part_rz[blockIdx.x] = acc;
    if constexpr (LM) {
      acc_q = block_sum(acc_q, s_warp);
      if (threadIdx.x == 0) part_q[blockIdx.x] = acc_q;
    }
    grid.sync();
    const float rz_new = (float)partials_sum(part_rz, n_blocks, &s_bcast);
    const float beta = safe_div(rz_new, rz, guard_div);
    ++l;
    if constexpr (LM) {
      const float q1 =
          __fmul_rn(0.5f, (float)partials_sum(part_q, n_blocks, &s_bcast));
      const float zeta =
          __fdiv_rn(__fmul_rn((float)l, __fsub_rn(q1, q0)), q1);
      if (zeta < q_tol || rz_new <= floor_rz) break;
      q0 = q1;
    } else {
      if (rz_new <= floor_rz || den <= 0.f) break;
    }
    rz = rz_new;

    // phase 3: p = z + beta p
    for (int e = first; e < total; e += stride) {
      const float z = __fmul_rn(pre[e], r[e]);
      p[e] = __fadd_rn(z, __fmul_rn(beta, p[e]));
    }
    grid.sync();
  }
  if (first == 0) *iters = l;
}

static const void* kernel_instance(int lm, int rem) {
  if (rem)
    return lm ? (const void*)fused_grid_cg_kernel<true, true>
              : (const void*)fused_grid_cg_kernel<false, true>;
  return lm ? (const void*)fused_grid_cg_kernel<true, false>
            : (const void*)fused_grid_cg_kernel<false, false>;
}

extern "C" {

// Co-resident block count of the GN (lm = 0) or LM (lm = 1) instance,
// without (rem = 0) or with (rem = 1) the remainder phase, at `block`
// threads (the cooperative launch limit): blocks per SM times SMs on the
// current device.
int fused_grid_cg_max_blocks(int lm, int rem, int block, int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int coop = 0, sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                    kernel_instance(lm, rem),
                                                    block, 0);
  if (e != cudaSuccess) return (int)e;
  *out = per_sm * sms;
  return 0;
}

// Launches the GN (lm = 0) or LM (lm = 1) instance on `stream`, with the
// remainder phase when rowptr is not null; returns the CUDA error of the
// launch. ctc, reset_period, q_tol and part_q are read by the LM instance
// only; rowptr, col and blk by the remainder instances only, which need
// N0 == 1 (a graph's vertex axis).
int fused_grid_cg_launch(int lm, const float* F, const float* b,
                         const float* pre, const float* ctc,
                         const int* triples, const int* starts,
                         const int* rowptr, const int* col, const float* blk,
                         int C, int N0, int N1, int lits, float tol,
                         int guard_div,
                         int reset_period, float q_tol, float* delta, float* r,
                         float* p, float* Ap, double* part_den,
                         double* part_rz, double* part_q, int* iters, int grid,
                         int block, void* stream) {
  if (block != FGCG_BLOCK || C < 1 || C > FGCG_MAX_CHANNELS)
    return (int)cudaErrorInvalidValue;
  if (lm && (ctc == nullptr || part_q == nullptr || reset_period < 1))
    return (int)cudaErrorInvalidValue;
  const int rem = rowptr != nullptr;
  if (rem && (col == nullptr || blk == nullptr || N0 != 1))
    return (int)cudaErrorInvalidValue;
  int max_blocks = 0;
  int err = fused_grid_cg_max_blocks(lm, rem, block, &max_blocks);
  if (err) return err;
  if (grid < 1 || grid > max_blocks)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {(void*)&F,        (void*)&b,         (void*)&pre,
                  (void*)&ctc,      (void*)&triples,   (void*)&starts,
                  (void*)&rowptr,   (void*)&col,       (void*)&blk,
                  (void*)&C,        (void*)&N0,        (void*)&N1,
                  (void*)&lits,     (void*)&tol,       (void*)&guard_div,
                  (void*)&reset_period, (void*)&q_tol, (void*)&delta,
                  (void*)&r,        (void*)&p,         (void*)&Ap,
                  (void*)&part_den, (void*)&part_rz,   (void*)&part_q,
                  (void*)&iters};
  cudaError_t e = cudaLaunchCooperativeKernel(
      kernel_instance(lm, rem), dim3(grid), dim3(block), args, 0,
      (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
