// Whole-loop preconditioned CG for 2-D and 3-D grid stencil operators and
// graph operators, as one persistent kernel for Hopper (sm_90a). One
// template, fused_grid_cg_kernel<LM, REM, CS, BLOCK, FT, FORM>, in 96
// instances: Gauss-Newton or Levenberg-Marquardt (LM), without or with the
// graph remainder phase (REM), the standard loop or Chronopoulos-Gear (CS),
// the elementwise Jacobi or the per-point block-Jacobi preconditioner
// (BLOCK), float32 or bfloat16 coefficient storage (FT), each in three
// forms (FORM): one system a cooperative launch (ONE); n_sys independent
// systems solved in turn inside one cooperative launch (MULTI); n_sys
// independent systems side by side in an ordinary launch, one block each
// (BATCH). Every system has its own dots, exit and count (see the kernel
// below). This header holds the template; fused_grid_cg_one.cu,
// fused_grid_cg_multi.cu and fused_grid_cg_batch.cu instantiate one form
// each, so that three nvcc processes build them side by side, and
// fused_grid_cg.cu launches them.
//
// Replaces, in opt_tpu/ops/pallas_cg.py:
//   * _kernel (:328), the Pallas TPU kernel that runs the whole PCG inner
//     loop of a grid problem in one launch, in its 2-D grid GN form, its
//     mixed-unknown form (several unknowns packed into the channels, with
//     cross-channel couplings i != j: image_warping's Offset(2) + Angle(1)),
//     its lm=True form (_run_cg's lm_body), its 3-D grid form
//     (plan_fused_grid_cg :561), its cs=True form (_run_cg's gn_cs_body and
//     lm_cs_body, :238-317), its block_pre=True form (the per-element C x C
//     M^-1 apply, :367-381) and its bfloat16 coefficient form
//     (coeff_dtype, :586-592, :670-672);
//   * _hbm_tiled_kernel (:1430), the TPU kernel that runs the same GN and LM
//     loops for grids whose state does not fit VMEM, by streaming row
//     windows from HBM in three sweeps per iteration. This kernel reads its
//     state from device memory in every phase anyway (through L2), so the
//     same instances serve those cases; the row-window DMA is not carried
//     over;
//   * _kernel's flat1d=True graph form (:335, apply :386-405): same-vertex
//     blocks and per-offset DIA fields over a vertex axis the TPU folds to
//     [R, 512] and reads by flat rolls. Here the vertex axis is the domain
//     [1, 1, N], a flat offset d is the grid offset (0, 0, d), and the
//     REM=false instances run it unchanged;
//   * _kernel's rem_pairs form (:338, :410-494): the irregular remainder of
//     a graph operator, which the TPU applies by one-hot matmuls on its
//     matrix unit. Here it is the REM=true instances' remainder phase: a
//     destination-sorted block CSR, one C x C block per distinct (v, u)
//     read, out[i][v] += sum_k sum_j blk[k][i][j] * p[j][col[k]];
//   * _kernel's chan_grid=True form (:339, :513-520, launch :1057-1098):
//     the C channels of a channel-separable operator (every triple i == j,
//     every channel the same fields) as a sequential Pallas grid=(C,) of
//     one-channel solves over shared fields, each with its own exit, the
//     counts summed. Here: n_sys = C systems of one channel in one launch,
//     the fields' per-system stride 0;
//   * _kernel under jax.vmap (opt_tpu/solver/gauss_newton.py
//     _solve_fused_batched, Plan.solve_batched), where pallas_call's batching
//     rule turns the batch into a grid axis: B independent solves of one
//     operator shape, each with its own fields, b, pre, ctc, dots, alpha,
//     beta, exit and count. Here: n_sys = B systems, the fields' per-system
//     stride one system's fields; small systems (ops/fused_cg.py's
//     batched_kernel_form: up to BATCH_BLOCK_ELEMS values a system) in the
//     BATCH instances, one block a system, larger ones in the MULTI
//     instances, in turn. Under REM the systems share the remainder's CSR
//     (rowptr, col) and each has its own blocks, at a per-system stride;
//     under BLOCK each has its own C*C preconditioner planes.
//
// The domain is [N0, N1, N2] (a 2-D grid is [1, H, W], a graph [1, 1, N]);
// state is channel-major [C, N0, N1, N2] float32; a triple row is
// (d0, d1, d2, i, j, fid). M^-1 r is pre * r elementwise, or under BLOCK
// z[i] = sum_j pre[i*C + j] * r[j] at each point, j ascending.
//
// The standard loop (CS = false):
//   r = b, p = M^-1 r, rz = <r, p>, floor = tol*rz, Q0 = 0
//   repeat while l < lits:
//     Ap[i] = sum_t F[fid_t] * p[j_t] read at offset (d0_t, d1_t, d2_t)
//             (+ the remainder under REM) (+ ctc*p under LM)
//     den = <p, Ap>;  alpha = rz/den (guarded);  delta += alpha*p
//     GN, or LM off a reset iteration:  r -= alpha*Ap
//     LM when (l+1) % reset_period == 0:  r = b - (A*delta + ctc*delta)
//     z = M^-1 r;  rz_new = <z, r>;  beta = rz_new/rz (guarded);  l += 1
//     GN exit: rz_new <= floor or den <= 0
//     LM exit: zeta < q_tol or rz_new <= floor, with Q1 = 0.5*<delta, b+r>,
//              zeta = (l*(Q1 - Q0))/Q1, Q0 = Q1 (no den <= 0 exit)
//     p = z + beta*p
// Chronopoulos-Gear (CS = true), with p = s = 0, gamma = alpha_prev = 1:
//   repeat while l < lits:
//     u = M^-1 r;  w = A u (+ ctc*u);  gamma_new = <r, u>;  dd = <u, w>
//     LM: Q = 0.5*<delta, b + r>,  zeta = (l*(Q - Q0))/Q
//     stop (not on the first iteration): gamma_new <= floor (LM: or
//       zeta < q_tol): leave the loop, this iteration uncounted
//     beta = first ? 0 : gamma_new/gamma;  den = dd - beta*(gamma_new/alpha_prev)
//     used = first ? dd : den;  alpha = gamma_new/used (all guarded)
//     p = u + beta*p;  s = w + beta*s;  delta += alpha*p;  r -= alpha*s
//     l += 1;  LM when l % reset_period == 0: r = b - (A*delta + ctc*delta)
//     exit when used <= 0
// and returns delta and the executed iteration count l.
//
// What bounds it: memory traffic. A GN iteration reads the T coefficient
// planes and about 6*C state planes (p at every stencil offset, Ap, r,
// delta, pre) and writes about 4*C. LM adds the ctc plane in the apply, the
// b plane for the third dot <delta, b+r>, and on a reset iteration one more
// stencil sweep over delta. Block-Jacobi reads C*C preconditioner planes in
// place of C and stores z; Chronopoulos-Gear carries s, u and w, two more
// vector planes read and written. bf16 halves the coefficient bytes. For
// poisson 512x512x4 an iteration moves about 25 MB, which fits the H100's
// 50 MB L2; image_warping 1024x1024x3 (26 fields read by 31 triples) and
// volumetric 64^3 x 6 (128 fields, 134 MB) stream from HBM. The arithmetic
// is a few flops per byte. A batch of small systems is the exception: 512
// curve fits (2 elements, 4 fields a system) move about 50 KB an iteration,
// so launch latency and the barriers' latency bound the BATCH form, not
// bytes; it runs the systems side by side so that each iteration of all of
// them costs one block's barriers. (Such a batch under the standard loop,
// the Jacobi preconditioner and float32 fields, without the remainder, now
// runs on tiled_batch_cg.cu instead, a team of lanes of one warp a system
// with its state in shared memory: gn_batch_tiled, lm_batch_tiled. The BATCH
// instances here keep the Chronopoulos-Gear, bfloat16, block-Jacobi and
// remainder batches and systems beyond that kernel's shared memory.)
//
// What the design does about it:
//   * One launch for the whole loop (no per-iteration launch or host round
//     trip, the TPU kernel's contract): a cooperative grid of co-resident
//     blocks walks the elements with grid-stride loops (the BATCH form: each
//     block walks its own system with block-stride loops, and every
//     grid-wide barrier below is a block barrier). The standard loop
//     has three grid-wide barriers per iteration (apply + <p,Ap>; update +
//     z + <z,r> (+ <delta,b+r>); p update), Chronopoulos-Gear two (apply +
//     its two or three dots in one reduction; the update, with u = M^-1 r
//     fused into it). An LM reset iteration adds one barrier before the
//     stencil sweep that reads neighbours' delta (CS: and one after it).
//   * A thread owns an element e = c*plane + q. Under BLOCK, z at point q
//     needs r of every channel at q, so the phases that update r (and the
//     initial one) are walked by point instead: a thread owns q with all
//     its channels, computes z there from its own r, and stores z for the
//     p update (C*C reads are not repeated). Reads of a vector written in
//     an earlier phase by another thread go through L2 (ld.global.cg), as
//     the stencil reads of p, u or delta always do.
//   * Reads that leave the grid are skipped, never wrapped: the planner
//     folded each offset's in-bounds mask into its field, so a skipped read
//     is exactly the zero the plain version multiplies in. Each triple's
//     flat source offset and field offset are computed once per block.
//   * The remainder is a gather, not a scatter: the thread that owns
//     output element (i, v) walks row v of the CSR after its stencil sum,
//     in entry order and then j order, reading p through L2. No atomics, so
//     two runs are bitwise equal, and the plain version sums in the same
//     order; the LM reset sweep applies it to delta as well. The systems
//     of a MULTI or BATCH launch share the CSR and read their own blocks.
//   * bfloat16 fields and remainder blocks are widened with
//     __bfloat162float, which is exact; products stay float32, as the plain
//     version multiplies the widened fields.
//   * Dot products: per-thread float products summed in double, a fixed
//     shuffle tree per block, per-block partials in separate buffers for
//     each dot, and every block sums the partials in the same fixed order.
//     alpha, beta, zeta and the exit tests are therefore identical in every
//     block, the loop exits uniformly, and two runs give bitwise-equal
//     results.
//   * Elementwise and scalar arithmetic uses explicit round-to-nearest
//     intrinsics (no fused multiply-add), in the plain PyTorch version's
//     order of operations.
//   * Every instance is held to 32 registers, 8 blocks of 256 threads per
//     SM, the remainder instances to 40, 6 blocks per SM (the
//     __launch_bounds__ below); the co-resident block count is queried, and
//     the launch checked, per instance.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace cg = cooperative_groups;

#define FGCG_BLOCK 256
#define FGCG_MAX_TRIPLES 512
#define FGCG_MAX_CHANNELS 64
#define FGCG_ROW 6   // a triple as the host gives it: d0, d1, d2, i, j, fid
#define FGCG_SROW 5  // in shared memory: d0, d1, d2, source offset, field offset

// Blocks per SM the register allocation must allow: 8 caps an instance at
// 32 registers, 6 at 40. Uncapped, the 3-D index arithmetic took the GN
// instance to 48 registers (5 blocks per SM), and chip_smoke.py timed
// image_warping 1024^2 GN 19% and arap36k GN 12% slower than at 32 (H100 at
// 700 W, PERF.md); the remainder instances, whose CSR walk spills at 32
// registers, are held to 40.
#define FGCG_MIN_BLOCKS 8
#define FGCG_MIN_BLOCKS_REM 6

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

// Sums every thread's v into *part (the block's own slot), in a fixed order.
__device__ __forceinline__ void store_partial(double v, double* part,
                                              double* s_warp) {
  v = block_sum(v, s_warp);
  if (threadIdx.x == 0) *part = v;
}

// Who runs one system, as a compile-time policy of cg_system: its threads,
// its barrier and the slots of its per-block dot partials.
//   GridTeam: every block of a cooperative grid (one system a launch, or the
//     MULTI instances' systems in turn); grid-wide barriers, one partial a
//     block, summed by every block in the same order.
//   BlockTeam: one block (the BATCH instances, block k owning system k);
//     __syncthreads() barriers, one partial.
struct GridTeam {
  cg::grid_group& grid;
  __device__ __forceinline__ int thread() const {
    return blockIdx.x * blockDim.x + threadIdx.x;
  }
  __device__ __forceinline__ int stride() const { return gridDim.x * blockDim.x; }
  __device__ __forceinline__ int parts() const { return gridDim.x; }
  __device__ __forceinline__ int part() const { return blockIdx.x; }
  __device__ __forceinline__ void sync() { grid.sync(); }
};
struct BlockTeam {
  __device__ __forceinline__ int thread() const { return threadIdx.x; }
  __device__ __forceinline__ int stride() const { return blockDim.x; }
  __device__ __forceinline__ int parts() const { return 1; }
  __device__ __forceinline__ int part() const { return 0; }
  __device__ __forceinline__ void sync() { __syncthreads(); }
};

__device__ __forceinline__ float safe_div(float num, float den, int guard) {
  if (!guard) return __fdiv_rn(num, den);
  return den > 0.f ? __fdiv_rn(num, den) : 0.f;
}

// a coefficient, widened to float32 (exact for bfloat16)
__device__ __forceinline__ float ldf(const float* __restrict__ a, int i) {
  return a[i];
}
__device__ __forceinline__ float ldf(const __nv_bfloat16* __restrict__ a,
                                     int i) {
  return __bfloat162float(a[i]);
}

// a state value another thread may have written before the last grid
// barrier (through L2), or one this thread wrote itself
template <bool OTHER>
__device__ __forceinline__ float ldv(const float* a) {
  if constexpr (OTHER) return __ldcg(a);
  return *a;
}

// point q of the domain [N0, N1, N2] as (x, y, z)
__device__ __forceinline__ void coords(int q, int N12, int N2, int& x, int& y,
                                       int& z) {
  x = q / N12;
  const int yz = q - x * N12;
  y = yz / N2;
  z = yz - y * N2;
}

// sum over the triples k0..k1 of F[fid][q] * src[j] at (x, y, z) + (d0, d1,
// d2), skipping reads that leave the domain; qs is point q in the system's
// state (q + the system's first element), qf in its fields; src is read
// through L2 (other blocks wrote it before the last grid barrier). The standard loop's phase 1
// keeps the same loop written out, as the GN instance had it before the
// other sweeps existed.
template <typename FT>
__device__ __forceinline__ float stencil_apply(const FT* __restrict__ F,
                                               const float* src,
                                               const int* s_tr, int k0, int k1,
                                               int N0, int N1, int N2, int qs,
                                               int qf, int x, int y, int z) {
  float a = 0.f;
  for (int k = k0; k < k1; ++k) {
    const int* t = s_tr + FGCG_SROW * k;
    const int xx = x + t[0];
    const int yy = y + t[1];
    const int zz = z + t[2];
    if (xx >= 0 && xx < N0 && yy >= 0 && yy < N1 && zz >= 0 && zz < N2) {
      const float pv = __ldcg(src + (t[3] + qs));
      a = __fadd_rn(a, __fmul_rn(ldf(F, t[4] + qf), pv));
    }
  }
  return a;
}

// a + sum over row v's remainder entries k and over j of
// blk[k][i][j] * src[j][col[k]], in that order; src is read through L2.
template <typename FT>
__device__ __forceinline__ float remainder_apply(const int* __restrict__ rowptr,
                                                 const int* __restrict__ col,
                                                 const FT* __restrict__ blk,
                                                 const float* src, int C,
                                                 int plane, int i, int v,
                                                 float a) {
  const int k1 = rowptr[v + 1];
  for (int k = rowptr[v]; k < k1; ++k) {
    const int u = col[k];
    const int bk = (k * C + i) * C;
    for (int j = 0; j < C; ++j)
      a = __fadd_rn(a, __fmul_rn(ldf(blk, bk + j), __ldcg(src + j * plane + u)));
  }
  return a;
}

// The block-Jacobi apply at point q: out[i][q] = sum_j pre[i*C+j][q] *
// r[j][q], j ascending from 0, for every channel i (r: this thread's own
// writes). qs is q in the system's state, qp in its C*C preconditioner
// planes. Returns sum_i out[i][q] * r[i][q], the point's share of <z, r>.
__device__ __forceinline__ double block_prec(const float* __restrict__ pre,
                                             const float* r, float* out,
                                             int C, int plane, int qs, int qp) {
  double acc = 0.0;
  for (int i = 0; i < C; ++i) {
    float a = 0.f;
    for (int j = 0; j < C; ++j)
      a = __fadd_rn(a, __fmul_rn(pre[(i * C + j) * plane + qp], r[j * plane + qs]));
    out[i * plane + qs] = a;
    acc += (double)__fmul_rn(a, r[i * plane + qs]);
  }
  return acc;
}

// One system's whole loop: C channels over the domain, run by `team`
// (GridTeam or BlockTeam). The pointers are the launch's own (they stay
// kernel parameters, not registers), but for blk, the system's own
// remainder blocks; the system's slices start at element o of the state
// vectors, po of the preconditioner planes, fo of the fields and g of the
// partials. Every block of the team runs it with the same
// arguments and leaves it after the same iteration. Returns the executed
// iteration count.
template <bool LM, bool REM, bool CS, bool BLOCK, typename FT, typename TEAM>
__device__ __forceinline__ int cg_system(
    TEAM& team, const int* s_tr, const int* s_start, double* s_warp,
    double* s_bcast_p, const FT* __restrict__ F, const float* __restrict__ b,
    const float* __restrict__ pre, const float* __restrict__ ctc,
    const int* __restrict__ rowptr, const int* __restrict__ col,
    const FT* __restrict__ blk, int C, int N0, int N1, int N2, int lits,
    float tol, int guard_div, int reset_period, float q_tol, float* delta,
    float* r, float* p, float* Ap, float* z, float* s, double* part0_,
    double* part1_, double* part2_, int o, int po, int fo, int g) {
  const int N12 = N1 * N2;
  const int plane = N0 * N12;
  const int total = o + C * plane;  // one past the system's last element
  const int stride = team.stride();
  const int tid = team.thread();
  const int first = o + tid;  // this thread's first element of the system
  const int n_blocks = team.parts();
  double* part0 = part0_ + g;
  double* part1 = part1_ + g;
  double* part2 = LM ? part2_ + g : part2_;
  const int mine = team.part();  // this block's slot among the partials
  int l = 0;

  if constexpr (!CS) {
    // r = b, p = z = M^-1 r, delta = 0, rz0 = <r, z>
    double acc = 0.0;
    if constexpr (BLOCK) {
      for (int q = tid; q < plane; q += stride) {
        for (int c = 0; c < C; ++c) {
          const int e = o + c * plane + q;
          r[e] = b[e];
          delta[e] = 0.f;
        }
        acc += block_prec(pre, r, p, C, plane, o + q, po + q);
      }
    } else {
      for (int e = first; e < total; e += stride) {
        const float rv = b[e];
        const float zv = __fmul_rn(pre[e], rv);
        r[e] = rv;
        p[e] = zv;
        delta[e] = 0.f;
        acc += (double)__fmul_rn(rv, zv);
      }
    }
    store_partial(acc, part1 + mine, s_warp);
    team.sync();
    float rz = (float)partials_sum(part1, n_blocks, s_bcast_p);
    const float floor_rz = __fmul_rn(tol, rz);
    float q0 = 0.f;

    while (l < lits) {
      // phase 1: Ap = A p (+ ctc p), partials of <p, Ap>
      acc = 0.0;
      for (int e = first; e < total; e += stride) {
        const int c = (e - o) / plane;
        const int q = (e - o) - c * plane;
        int x, y, zc;
        coords(q, N12, N2, x, y, zc);
        float a = 0.f;
        for (int k = s_start[c]; k < s_start[c + 1]; ++k) {
          const int* t = s_tr + FGCG_SROW * k;
          const int xx = x + t[0];
          const int yy = y + t[1];
          const int zz = zc + t[2];
          if (xx >= 0 && xx < N0 && yy >= 0 && yy < N1 && zz >= 0 && zz < N2) {
            const float pv = __ldcg(p + (t[3] + q + o));
            a = __fadd_rn(a, __fmul_rn(ldf(F, t[4] + q + fo), pv));
          }
        }
        // graph remainder: the domain is [1, 1, N], so the vertex is q
        if constexpr (REM)
          a = remainder_apply(rowptr, col, blk, p + o, C, plane, c, q, a);
        const float pe = ldv<BLOCK>(p + e);
        if constexpr (LM) a = __fadd_rn(a, __fmul_rn(ctc[e], pe));
        Ap[e] = a;
        acc += (double)__fmul_rn(pe, a);
      }
      store_partial(acc, part0 + mine, s_warp);
      team.sync();
      const float den = (float)partials_sum(part0, n_blocks, s_bcast_p);
      const float alpha = safe_div(rz, den, guard_div);

      // phase 2: delta += alpha p, r -= alpha Ap (or, on an LM reset
      // iteration, r = b - (A delta + ctc delta)), z = M^-1 r, partials of
      // <z, r> and, under LM, of <delta, b + r>
      acc = 0.0;
      double acc_q = 0.0;
      bool reset = false;
      if constexpr (LM) reset = (l + 1) % reset_period == 0;
      if constexpr (BLOCK) {
        // by point: z at q needs every channel's r at q
        if (reset) {
          for (int q = tid; q < plane; q += stride)
            for (int c = 0; c < C; ++c) {
              const int e = o + c * plane + q;
              delta[e] = __fadd_rn(delta[e], __fmul_rn(alpha, __ldcg(p + e)));
            }
          team.sync();  // the stencil below reads neighbours' delta
          for (int q = tid; q < plane; q += stride) {
            int x, y, zc;
            coords(q, N12, N2, x, y, zc);
            for (int c = 0; c < C; ++c) {
              const int e = o + c * plane + q;
              const float dv = delta[e];
              float a = stencil_apply(F, delta, s_tr, s_start[c], s_start[c + 1],
                                      N0, N1, N2, q + o, q + fo, x, y, zc);
              if constexpr (REM)
                a = remainder_apply(rowptr, col, blk, delta + o, C, plane, c, q, a);
              a = __fadd_rn(a, __fmul_rn(ctc[e], dv));
              const float bv = b[e];
              const float rv = __fsub_rn(bv, a);
              r[e] = rv;
              acc_q += (double)__fmul_rn(dv, __fadd_rn(bv, rv));
            }
            acc += block_prec(pre, r, z, C, plane, o + q, po + q);
          }
        } else {
          for (int q = tid; q < plane; q += stride) {
            for (int c = 0; c < C; ++c) {
              const int e = o + c * plane + q;
              const float dv = __fadd_rn(delta[e], __fmul_rn(alpha, __ldcg(p + e)));
              delta[e] = dv;
              const float rv = __fsub_rn(r[e], __fmul_rn(alpha, __ldcg(Ap + e)));
              r[e] = rv;
              if constexpr (LM) acc_q += (double)__fmul_rn(dv, __fadd_rn(b[e], rv));
            }
            acc += block_prec(pre, r, z, C, plane, o + q, po + q);
          }
        }
      } else if (reset) {
        for (int e = first; e < total; e += stride)
          delta[e] = __fadd_rn(delta[e], __fmul_rn(alpha, p[e]));
        team.sync();  // the stencil below reads neighbours' delta
        for (int e = first; e < total; e += stride) {
          const int c = (e - o) / plane;
          const int q = (e - o) - c * plane;
          int x, y, zc;
          coords(q, N12, N2, x, y, zc);
          const float dv = delta[e];
          float a = stencil_apply(F, delta, s_tr, s_start[c], s_start[c + 1],
                                  N0, N1, N2, q + o, q + fo, x, y, zc);
          if constexpr (REM)
            a = remainder_apply(rowptr, col, blk, delta + o, C, plane, c, q, a);
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
      store_partial(acc, part1 + mine, s_warp);
      if constexpr (LM) store_partial(acc_q, part2 + mine, s_warp);
      team.sync();
      const float rz_new = (float)partials_sum(part1, n_blocks, s_bcast_p);
      const float beta = safe_div(rz_new, rz, guard_div);
      ++l;
      if constexpr (LM) {
        const float q1 =
            __fmul_rn(0.5f, (float)partials_sum(part2, n_blocks, s_bcast_p));
        const float zeta =
            __fdiv_rn(__fmul_rn((float)l, __fsub_rn(q1, q0)), q1);
        if (zeta < q_tol || rz_new <= floor_rz) break;
        q0 = q1;
      } else {
        if (rz_new <= floor_rz || den <= 0.f) break;
      }
      rz = rz_new;

      // phase 3: p = z + beta p (z stored under BLOCK, else pre r)
      for (int e = first; e < total; e += stride) {
        float zv;
        if constexpr (BLOCK) zv = __ldcg(z + e);
        else zv = __fmul_rn(pre[e], r[e]);
        p[e] = __fadd_rn(zv, __fmul_rn(beta, ldv<BLOCK>(p + e)));
      }
      team.sync();
    }
  } else {
    // Chronopoulos-Gear: z holds u = M^-1 r, Ap holds w = A u.
    // r = b, u = M^-1 r, p = s = delta = 0, rz0 = <r, u>
    double acc = 0.0;
    if constexpr (BLOCK) {
      for (int q = tid; q < plane; q += stride) {
        for (int c = 0; c < C; ++c) {
          const int e = o + c * plane + q;
          r[e] = b[e];
          p[e] = 0.f;
          s[e] = 0.f;
          delta[e] = 0.f;
        }
        acc += block_prec(pre, r, z, C, plane, o + q, po + q);
      }
    } else {
      for (int e = first; e < total; e += stride) {
        const float rv = b[e];
        const float uv = __fmul_rn(pre[e], rv);
        r[e] = rv;
        z[e] = uv;
        p[e] = 0.f;
        s[e] = 0.f;
        delta[e] = 0.f;
        acc += (double)__fmul_rn(rv, uv);
      }
    }
    store_partial(acc, part1 + mine, s_warp);
    team.sync();
    const float floor_rz =
        __fmul_rn(tol, (float)partials_sum(part1, n_blocks, s_bcast_p));
    float gamma = 1.f, alpha_prev = 1.f, q0 = 0.f;

    while (l < lits) {
      // phase A: w = A u (+ ctc u), partials of <r, u>, <u, w> and, under
      // LM, <delta, b + r>: one reduction
      double acc_g = 0.0, acc_d = 0.0, acc_q = 0.0;
      for (int e = first; e < total; e += stride) {
        const int c = (e - o) / plane;
        const int q = (e - o) - c * plane;
        int x, y, zc;
        coords(q, N12, N2, x, y, zc);
        float a = stencil_apply(F, z, s_tr, s_start[c], s_start[c + 1], N0, N1,
                                N2, q + o, q + fo, x, y, zc);
        if constexpr (REM)
          a = remainder_apply(rowptr, col, blk, z + o, C, plane, c, q, a);
        const float uv = ldv<BLOCK>(z + e);
        if constexpr (LM) a = __fadd_rn(a, __fmul_rn(ctc[e], uv));
        Ap[e] = a;
        const float rv = ldv<BLOCK>(r + e);
        acc_g += (double)__fmul_rn(rv, uv);
        acc_d += (double)__fmul_rn(uv, a);
        if constexpr (LM)
          acc_q += (double)__fmul_rn(ldv<BLOCK>(delta + e), __fadd_rn(b[e], rv));
      }
      store_partial(acc_g, part0 + mine, s_warp);
      store_partial(acc_d, part1 + mine, s_warp);
      if constexpr (LM) store_partial(acc_q, part2 + mine, s_warp);
      team.sync();
      const float gamma_new = (float)partials_sum(part0, n_blocks, s_bcast_p);
      const float delta_d = (float)partials_sum(part1, n_blocks, s_bcast_p);
      const bool first_it = l == 0;
      bool stop = !first_it && gamma_new <= floor_rz;
      float q_cur = 0.f;
      if constexpr (LM) {
        q_cur = __fmul_rn(0.5f, (float)partials_sum(part2, n_blocks, s_bcast_p));
        if (!first_it) {
          const float zeta =
              __fdiv_rn(__fmul_rn((float)l, __fsub_rn(q_cur, q0)), q_cur);
          stop = stop || zeta < q_tol;
        }
      }
      if (stop) break;  // this iteration is not counted
      const float beta = first_it ? 0.f : safe_div(gamma_new, gamma, guard_div);
      const float den = __fsub_rn(
          delta_d, __fmul_rn(beta, safe_div(gamma_new, alpha_prev, guard_div)));
      const float used_den = first_it ? delta_d : den;
      const float alpha = safe_div(gamma_new, used_den, guard_div);

      // phase B: p = u + beta p, s = w + beta s, delta += alpha p,
      // r -= alpha s, u = M^-1 r
      if constexpr (BLOCK) {
        for (int q = tid; q < plane; q += stride) {
          for (int c = 0; c < C; ++c) {
            const int e = o + c * plane + q;
            const float pv = __fadd_rn(z[e], __fmul_rn(beta, p[e]));
            p[e] = pv;
            const float sv = __fadd_rn(__ldcg(Ap + e), __fmul_rn(beta, s[e]));
            s[e] = sv;
            delta[e] = __fadd_rn(delta[e], __fmul_rn(alpha, pv));
            r[e] = __fsub_rn(r[e], __fmul_rn(alpha, sv));
          }
          block_prec(pre, r, z, C, plane, o + q, po + q);
        }
      } else {
        for (int e = first; e < total; e += stride) {
          const float pv = __fadd_rn(z[e], __fmul_rn(beta, p[e]));
          p[e] = pv;
          const float sv = __fadd_rn(Ap[e], __fmul_rn(beta, s[e]));
          s[e] = sv;
          delta[e] = __fadd_rn(delta[e], __fmul_rn(alpha, pv));
          const float rv = __fsub_rn(r[e], __fmul_rn(alpha, sv));
          r[e] = rv;
          z[e] = __fmul_rn(pre[e], rv);
        }
      }
      ++l;
      gamma = gamma_new;
      alpha_prev = alpha;
      if constexpr (LM) q0 = q_cur;
      if (used_den <= 0.f) break;
      if constexpr (LM) {
        if (l % reset_period == 0) {
          team.sync();  // the stencil below reads neighbours' delta
          if constexpr (BLOCK) {
            for (int q = tid; q < plane; q += stride) {
              int x, y, zc;
              coords(q, N12, N2, x, y, zc);
              for (int c = 0; c < C; ++c) {
                const int e = o + c * plane + q;
                float a = stencil_apply(F, delta, s_tr, s_start[c],
                                        s_start[c + 1], N0, N1, N2, q + o,
                                        q + fo, x, y, zc);
                if constexpr (REM)
                  a = remainder_apply(rowptr, col, blk, delta + o, C, plane, c, q, a);
                a = __fadd_rn(a, __fmul_rn(ctc[e], delta[e]));
                r[e] = __fsub_rn(b[e], a);
              }
              block_prec(pre, r, z, C, plane, o + q, po + q);
            }
          } else {
            for (int e = first; e < total; e += stride) {
              const int c = (e - o) / plane;
              const int q = (e - o) - c * plane;
              int x, y, zc;
              coords(q, N12, N2, x, y, zc);
              float a = stencil_apply(F, delta, s_tr, s_start[c], s_start[c + 1],
                                      N0, N1, N2, q + o, q + fo, x, y, zc);
              if constexpr (REM)
                a = remainder_apply(rowptr, col, blk, delta + o, C, plane, c, q, a);
              a = __fadd_rn(a, __fmul_rn(ctc[e], delta[e]));
              const float rv = __fsub_rn(b[e], a);
              r[e] = rv;
              z[e] = __fmul_rn(pre[e], rv);
            }
          }
        }
      }
      team.sync();
    }
  }
  return l;
}

// The launch's forms (the kernel's FORM parameter).
#define FGCG_ONE 0    // one system, a cooperative grid
#define FGCG_MULTI 1  // n_sys systems in turn, a cooperative grid
#define FGCG_BATCH 2  // n_sys systems side by side, block k owning system k

// The kernel. The MULTI and BATCH instances hold n_sys independent systems
// of C channels each. System k reads b, pre, ctc and writes delta and its
// scratch vectors at k*C planes (pre: k*C*C planes under BLOCK), reads its
// fields at F + k*f_sys_stride (0: the systems share the fields, the
// per-channel split of a channel-separable operator; one system's field
// count times the plane: a batch of independent systems) and its remainder
// blocks at blk + k*blk_sys_stride (one system's nnz*C*C; the CSR's rowptr
// and col are shared), sums its dots in its own partials (part +
// k*gridDim.x under MULTI, part + k under BATCH), leaves its loop at its own
// exit and writes its own count iters[k].
//   MULTI solves the systems one after the other inside one cooperative
//   launch. The exits are uniform across the grid, so every block reaches
//   every barrier of every system. One system's working set is a 1/n_sys
//   share of the joint one: poisson 1024x1024x4 moves 48 MiB an iteration a
//   channel, inside the H100's 50 MiB L2, where the joint loop's 132 MiB
//   stream from device memory.
//   BATCH is an ordinary launch of n_sys blocks: block k runs system k's
//   whole loop with block barriers (BlockTeam), so the systems run side by
//   side, as many at once as the SMs hold, and nothing caps n_sys. It is the
//   form for many small systems (the JAX package's _kernel under jax.vmap,
//   Plan.solve_batched): a curve fit's system is 2 elements, where the
//   cooperative forms would pay three grid barriers per iteration and
//   system, one system after the other. fused_cg.route_plan sends the
//   standard Jacobi float32 batches without the remainder whose systems fit
//   its shared memory (the curve fits, laplacian 16x16 x4) to
//   tiled_batch_cg.cu's gn_batch_tiled and lm_batch_tiled instead; the
//   template's gn_batch and lm_batch stay checked beside them.
// The ONE instances run one system with every offset a compile-time 0:
// carrying the offsets as variables slowed them at their 32-register cap (a
// probe on an H100; PERF.md), hence the separate forms.
template <bool LM, bool REM, bool CS, bool BLOCK, typename FT, int FORM>
__global__ void __launch_bounds__(FGCG_BLOCK, REM ? FGCG_MIN_BLOCKS_REM : FGCG_MIN_BLOCKS)
fused_grid_cg_kernel(const FT* __restrict__ F, const float* __restrict__ b,
                     const float* __restrict__ pre,
                     const float* __restrict__ ctc,
                     const int* __restrict__ triples,
                     const int* __restrict__ starts,
                     const int* __restrict__ rowptr,
                     const int* __restrict__ col,
                     const FT* __restrict__ blk, int C, int n_sys,
                     int f_sys_stride, int blk_sys_stride, int N0, int N1,
                     int N2, int lits, float tol, int guard_div,
                     int reset_period, float q_tol, float* delta, float* r,
                     float* p, float* Ap, float* z, float* s, double* part0,
                     double* part1, double* part2, int* iters) {
  __shared__ int s_tr[FGCG_MAX_TRIPLES * FGCG_SROW];
  __shared__ int s_start[FGCG_MAX_CHANNELS + 1];
  __shared__ double s_warp[FGCG_BLOCK / 32];
  __shared__ double s_bcast;

  const int N12 = N1 * N2;
  const int plane = N0 * N12;
  for (int k = threadIdx.x; k <= C; k += blockDim.x) s_start[k] = starts[k];
  __syncthreads();
  const int n_triples = s_start[C];
  for (int k = threadIdx.x; k < n_triples; k += blockDim.x) {
    const int* h = triples + FGCG_ROW * k;
    int* t = s_tr + FGCG_SROW * k;
    t[0] = h[0];
    t[1] = h[1];
    t[2] = h[2];
    t[3] = h[4] * plane + h[0] * N12 + h[1] * N2 + h[2];
    t[4] = h[5] * plane;
  }
  __syncthreads();

  if constexpr (FORM == FGCG_BATCH) {
    BlockTeam team;
    const int k = blockIdx.x;  // the block's system
    const int o = k * C * plane;
    const int l = cg_system<LM, REM, CS, BLOCK, FT>(
        team, s_tr, s_start, s_warp, &s_bcast, F, b, pre, ctc, rowptr, col,
        REM ? blk + k * blk_sys_stride : blk, C, N0, N1, N2, lits, tol,
        guard_div, reset_period, q_tol, delta, r, p, Ap, z, s, part0, part1,
        part2, o, BLOCK ? C * o : o, k * f_sys_stride, k);
    if (threadIdx.x == 0) iters[k] = l;
  } else {
    cg::grid_group grid = cg::this_grid();
    GridTeam team{grid};
    if constexpr (FORM == FGCG_MULTI) {
      for (int k = 0; k < n_sys; ++k) {
        const int o = k * C * plane;  // the system's first state element
        const int l = cg_system<LM, REM, CS, BLOCK, FT>(
            team, s_tr, s_start, s_warp, &s_bcast, F, b, pre, ctc, rowptr, col,
            REM ? blk + k * blk_sys_stride : blk, C, N0, N1, N2, lits, tol,
            guard_div, reset_period, q_tol, delta, r, p, Ap, z, s, part0,
            part1, part2, o, BLOCK ? C * o : o, k * f_sys_stride,
            k * (int)gridDim.x);
        if (blockIdx.x == 0 && threadIdx.x == 0) iters[k] = l;
      }
    } else {
      const int l = cg_system<LM, REM, CS, BLOCK, FT>(
          team, s_tr, s_start, s_warp, &s_bcast, F, b, pre, ctc, rowptr, col,
          blk, C, N0, N1, N2, lits, tol, guard_div, reset_period, q_tol, delta,
          r, p, Ap, z, s, part0, part1, part2, 0, 0, 0, 0);
      if (blockIdx.x == 0 && threadIdx.x == 0) *iters = l;
    }
  }
}

// fused_grid_cg_kernel<LM, REM, CS, BLOCK, bf16 ? __nv_bfloat16 : float,
// FORM> as an untyped pointer
template <int FORM, bool LM, bool REM, bool CS, bool BLOCK, bool BF16>
static const void* instance_of() {
  typedef typename std::conditional<BF16, __nv_bfloat16, float>::type FT;
  return (const void*)fused_grid_cg_kernel<LM, REM, CS, BLOCK, FT, FORM>;
}

// The instance of form FORM for the runtime flags lm, rem, cs, block, bf16
// (0 or 1 each, in that order): each flag in turn becomes the next
// template bool, so a unit that calls it instantiates all 32 of the form.
template <int FORM, bool... B>
static const void* form_instance(const int* flags) {
  if constexpr (sizeof...(B) == 5)
    return instance_of<FORM, B...>();
  else
    return flags[sizeof...(B)] ? form_instance<FORM, B..., true>(flags)
                               : form_instance<FORM, B..., false>(flags);
}
