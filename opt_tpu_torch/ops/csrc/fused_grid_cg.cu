// The C interface of the fused CG kernel (fused_grid_cg.cuh): the
// occupancy query and the launch of any of its 96 instances, which
// fused_grid_cg_one.cu, fused_grid_cg_multi.cu and fused_grid_cg_batch.cu
// instantiate, one form a unit. ops/fused_cg.py calls them through ctypes.

#include "fused_grid_cg.cuh"

extern "C" {
const void* fused_grid_cg_one_instance(const int* flags);
const void* fused_grid_cg_multi_instance(const int* flags);
const void* fused_grid_cg_batch_instance(const int* flags);
}

// the instance for these flags (0 or 1 each) and form
static const void* kernel_instance(int lm, int rem, int cs, int block,
                                   int bf16, int form) {
  const int flags[5] = {lm, rem, cs, block, bf16};
  switch (form) {
    case FGCG_ONE:
      return fused_grid_cg_one_instance(flags);
    case FGCG_MULTI:
      return fused_grid_cg_multi_instance(flags);
    case FGCG_BATCH:
      return fused_grid_cg_batch_instance(flags);
    default:
      return nullptr;
  }
}

extern "C" {

// Co-resident block count of one instance (lm, rem, cs, block, bf16: 0 or 1
// each; form: 0 one system, 1 MULTI, 2 BATCH) at `threads` threads (the
// cooperative launch limit): blocks per SM times SMs on the current device.
int fused_grid_cg_max_blocks(int lm, int rem, int cs, int block, int bf16,
                             int form, int threads, int* out) {
  const void* kernel = kernel_instance(lm, rem, cs, block, bf16, form);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int coop = 0, sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  if (e != cudaSuccess) return (int)e;
  *out = per_sm * sms;
  return 0;
}

// Launches one instance on `stream`, with the remainder phase when rowptr
// is not null; returns the CUDA error of the launch. The state arrays hold
// n_sys systems of C channels each (b, ctc, delta, r, p, Ap, z, s:
// n_sys*C planes; pre: n_sys*C, or n_sys*C*C under block = 1), part0..2
// n_sys*grid partials each and iters n_sys counts; system k reads its
// fields at F + k*f_sys_stride elements (0: shared) and its remainder
// blocks at blk + k*blk_sys_stride (rowptr and col are shared). batch = 1
// launches the BATCH instance, an ordinary launch of grid = n_sys blocks;
// otherwise n_sys > 1 launches the MULTI instance and n_sys = 1 the
// one-system one, each a cooperative launch of `grid` blocks. F and blk are
// float32, or bfloat16 when bf16 = 1. ctc, reset_period, q_tol and part2
// are read by the LM instances only; rowptr, col and blk by the remainder
// instances only, which need N0 == N1 == 1 (a graph's vertex axis); z by
// the CS and block-Jacobi instances, s by the CS ones. Under block = 1, pre
// holds C*C planes a system.
int fused_grid_cg_launch(int lm, int cs, int block, int bf16, int batch,
                         const void* F, const float* b, const float* pre,
                         const float* ctc, const int* triples,
                         const int* starts, const int* rowptr, const int* col,
                         const void* blk, int C, int n_sys, int f_sys_stride,
                         int blk_sys_stride, int N0, int N1, int N2, int lits,
                         float tol, int guard_div, int reset_period,
                         float q_tol, float* delta, float* r, float* p,
                         float* Ap, float* z, float* s, double* part0,
                         double* part1, double* part2, int* iters, int grid,
                         int threads, void* stream) {
  if (threads != FGCG_BLOCK || C < 1 || C > FGCG_MAX_CHANNELS || n_sys < 1 ||
      f_sys_stride < 0 || blk_sys_stride < 0)
    return (int)cudaErrorInvalidValue;
  if (lm && (ctc == nullptr || part2 == nullptr || reset_period < 1))
    return (int)cudaErrorInvalidValue;
  if ((cs || block) && z == nullptr) return (int)cudaErrorInvalidValue;
  if (cs && s == nullptr) return (int)cudaErrorInvalidValue;
  const int rem = rowptr != nullptr;
  if (rem && (col == nullptr || blk == nullptr || N0 != 1 || N1 != 1))
    return (int)cudaErrorInvalidValue;
  const int form = batch ? FGCG_BATCH : (n_sys > 1 ? FGCG_MULTI : FGCG_ONE);
  const void* kernel = kernel_instance(lm, rem, cs, block, bf16, form);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  void* args[] = {(void*)&F,         (void*)&b,         (void*)&pre,
                  (void*)&ctc,       (void*)&triples,   (void*)&starts,
                  (void*)&rowptr,    (void*)&col,       (void*)&blk,
                  (void*)&C,         (void*)&n_sys,     (void*)&f_sys_stride,
                  (void*)&blk_sys_stride,
                  (void*)&N0,        (void*)&N1,        (void*)&N2,
                  (void*)&lits,      (void*)&tol,       (void*)&guard_div,
                  (void*)&reset_period, (void*)&q_tol,
                  (void*)&delta,     (void*)&r,         (void*)&p,
                  (void*)&Ap,        (void*)&z,         (void*)&s,
                  (void*)&part0,     (void*)&part1,     (void*)&part2,
                  (void*)&iters};
  cudaError_t e;
  if (form == FGCG_BATCH) {
    if (grid != n_sys) return (int)cudaErrorInvalidValue;
    e = cudaLaunchKernel(kernel, dim3(grid), dim3(threads), args, 0,
                         (cudaStream_t)stream);
  } else {
    int max_blocks = 0;
    int err = fused_grid_cg_max_blocks(lm, rem, cs, block, bf16, form, threads,
                                       &max_blocks);
    if (err) return err;
    if (grid < 1 || grid > max_blocks)
      return (int)cudaErrorCooperativeLaunchTooLarge;
    e = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(threads), args, 0,
                                    (cudaStream_t)stream);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
