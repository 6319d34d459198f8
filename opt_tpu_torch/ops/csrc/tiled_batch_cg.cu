// Whole-loop preconditioned CG for a batch of small independent systems, a
// team of lanes of one warp a system, for Hopper (sm_90a):
// tiled_batch_cg_kernel<LM>, the standard GN (LM = false) or LM loop with
// the elementwise (Jacobi) preconditioner on float32 fields, no graph
// remainder. Launch names gn_batch_tiled and lm_batch_tiled
// (ops/fused_cg.py::batch_team_plan, reached from route_plan).
//
// Replaces, in opt_tpu/ops/pallas_cg.py: _kernel (:328) under jax.vmap
// (opt_tpu/solver/gauss_newton.py:983-1004, Plan.solve_batched), for the
// batches whose systems ops/fused_cg.py::batched_kernel_form puts in the
// "batch" form (up to BATCH_BLOCK_ELEMS values a system): B independent
// solves of one operator shape, each with its own fields, b, pre, ctc, dots,
// exit and count. They ran on fused_grid_cg.cuh's BATCH instances (gn_batch,
// lm_batch), one block of 256 threads a system with its state in device
// memory, which the Chronopoulos-Gear, bfloat16, block-Jacobi and remainder
// batches still take, as do systems beyond this kernel's shared memory and
// systems of more than BATCH_TEAM_LANE_ELEMS (31) elements a lane, where the
// template's 256 threads a system were faster on the H100.
//
// The loop is fused_cg._run_cg's: r = b, p = M^-1 r, rz = <r, p>,
// floor = tol*rz; each iteration Ap = A p (+ ctc p under LM), den = <p, Ap>,
// alpha = rz/den (guarded), delta += alpha p, r -= alpha Ap (LM, every
// reset_period-th iteration: r = b - (A delta + ctc delta)), z = M^-1 r,
// rz_new = <z, r>, beta = rz_new/rz (guarded); GN exits on rz_new <= floor
// or den <= 0, LM on zeta = (l (Q1 - Q0))/Q1 < q_tol or rz_new <= floor
// with Q1 = 0.5 <delta, b + r>; p = z + beta p.
//
// What bounds it: latency. A system is tiny (the bench's batched case: 512
// curve fits of 2 elements and 4 fields, 10 LM steps of up to 20
// iterations; all 512 together move about 50 KB an iteration), so an
// iteration costs the chain of its dependent steps, not bytes. The
// template's BATCH form paid, each iteration, three block barriers and two
// or three block-wide dot reductions through shared memory, and read every
// vector through L2: a chain of L2 round trips, about 4.4 us an iteration.
//
// What the design does about it:
//   * a team of `lanes` lanes of one warp owns a system (a power of two up
//     to 32, one element a lane up to a warp: a curve fit's team is 2 lanes,
//     so a warp holds 16 fits; laplacian 16x16 takes a warp, 8 elements a
//     lane); a block is one warp of 32 / lanes systems (fewer where their
//     shared memory is short), so the grid has ceil(B / per_block) blocks;
//   * the team loads its system once, by cp.async into its slice of shared
//     memory (F [T][plane], b, pre, ctc, all in flight at once beside the
//     triples' table), and keeps delta, r, p and Ap there for the whole
//     loop; delta is written to device memory once, at the end. A lane owns
//     the elements e = lane, lane + lanes, ... of the system (channel-major
//     e = c*plane + q), and only its own elements of r, Ap, b, pre and ctc
//     are ever read by it;
//   * before the loop each lane writes, for each of its elements, the
//     element's stencil as (field value, source place) pairs in its
//     channel's triple order: a read that leaves the domain points at a
//     zero place after the vector (its field is zero there too: the planner
//     folded each offset's in-bounds mask into it), so an iteration's apply
//     is a walk of pairs with no index arithmetic, no bounds test and no
//     division;
//   * the stencil reads neighbours' p (and on an LM reset delta) from the
//     slice after a __syncwarp: no block barrier and no device-memory round
//     trip in the loop;
//   * the warp stays converged: a team that has met its exit (or holds no
//     system) keeps stepping with the others, its work skipped and its
//     count frozen, until every team of the warp has stopped, so every
//     shuffle and __syncwarp is the whole warp's. Teams that met their
//     exits at different iterations would otherwise split the warp, and
//     shuffles and barriers over different teams' lane masks then run
//     for one team after another;
//   * each dot is float32 products summed in float64: a lane sums its own
//     elements in order, then the team sums the lanes' partials by a
//     butterfly of __shfl_xor_sync over distances 1, 2, 4, ..., so every
//     lane holds the same sum, bitwise; alpha, beta, zeta and the exits are
//     uniform within the team and a launch repeats bitwise;
//   * elementwise and scalar arithmetic uses round-to-nearest intrinsics
//     (no fused multiply-add) in the plain PyTorch version's order, and a
//     read beyond the domain multiplies its (zero) field by 0 as the plain
//     version's zero-padded shift does, so the result is bitwise the
//     twin's (fused_cg.fused_grid_cg_reference with batched=True) and the
//     template's BATCH instance's (which skips such a read);
//   * each team keeps its own exit and writes its own count, iters[k].

#include <cuda_runtime.h>

#define TB_THREADS 32  // a block is one warp
#define TB_MAX_TRIPLES 512
#define TB_MAX_CHANNELS 64
#define TB_ROW 6   // a triple as the host gives it: d0, d1, d2, i, j, fid
#define TB_SROW 5  // in shared memory: d0, d1, d2, source offset, field offset

__device__ __forceinline__ void tb_cp4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ float tb_div(float num, float den, int guard) {
  if (!guard) return __fdiv_rn(num, den);
  return den > 0.f ? __fdiv_rn(num, den) : 0.f;
}

// The team's sum of every lane's v: a butterfly over distances 1, 2, 4, ...
// within each team's `lanes` lanes, the whole warp taking part, the same
// value in each lane of a team.
__device__ __forceinline__ double tb_team_sum(double v, int lanes) {
  for (int o = 1; o < lanes; o <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o, lanes);
  return v;
}

// A system's 32-bit words in its team's slice, even (the pairs are 8-byte
// loads): its stencil pairs [plane * n_triples] (value, source place), the
// fields [T][plane], each element's pairs (first pair << 10 | count),
// then b, pre, (ctc), delta with its zero place, r, p with its zero place,
// Ap.
__host__ __device__ __forceinline__ int tb_system_words(int lm, int C, int T,
                                                        int n_triples,
                                                        int plane) {
  const int n = C * plane;
  return (2 * plane * n_triples + T * plane + n + (lm ? 7 : 6) * n + 2 + 1) & ~1;
}

template <bool LM>
__global__ void __launch_bounds__(TB_THREADS)
    tiled_batch_cg_kernel(const float* __restrict__ F,
                          const float* __restrict__ b,
                          const float* __restrict__ pre,
                          const float* __restrict__ ctc,
                          const int* __restrict__ triples,
                          const int* __restrict__ starts, int C, int T,
                          int n_triples, int N0, int N1, int N2, int n_sys,
                          int lanes, int per_block, int lits, float tol,
                          int guard_div, int reset_period, float q_tol,
                          float* __restrict__ delta_out,
                          int* __restrict__ iters) {
  extern __shared__ __align__(16) float tb_smem[];
  __shared__ int s_tr[TB_MAX_TRIPLES * TB_SROW];
  __shared__ int s_start[TB_MAX_CHANNELS + 1];
  const int N12 = N1 * N2;
  const int plane = N0 * N12;
  const int n = C * plane;
  const int team = threadIdx.x / lanes;
  const int lane = threadIdx.x & (lanes - 1);
  const int k = blockIdx.x * per_block + team;  // the team's system
  const bool live = team < per_block && k < n_sys;
  const int nf = T * plane;
  float* slice = tb_smem + team * tb_system_words(LM, C, T, n_triples, plane);
  float2* stab = reinterpret_cast<float2*>(slice);
  float* sF = slice + 2 * plane * n_triples;
  int* smeta = reinterpret_cast<int*>(sF + nf);
  float* sb = sF + nf + n;
  float* spre = sb + n;
  float* sctc = spre + n;  // LM only
  float* sd = LM ? sctc + n : sctc;  // [n + 1]: sd[n] = 0
  float* sr = sd + n + 1;
  float* sp = sr + n;  // [n + 1]: sp[n] = 0
  float* sAp = sp + n + 1;

  // the system's inputs into the slice, all in flight at once, while the
  // whole warp stages the triples' table
  if (live) {
    const float* Fk = F + (size_t)k * nf;
    for (int e = lane; e < nf; e += lanes) tb_cp4(sF + e, Fk + e);
    const size_t o = (size_t)k * n;
    for (int e = lane; e < n; e += lanes) {
      tb_cp4(sb + e, b + o + e);
      tb_cp4(spre + e, pre + o + e);
      if constexpr (LM) tb_cp4(sctc + e, ctc + o + e);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  for (int c = threadIdx.x; c <= C; c += TB_THREADS) s_start[c] = starts[c];
  for (int t = threadIdx.x; t < n_triples; t += TB_THREADS) {
    const int* h = triples + TB_ROW * t;
    int* s = s_tr + TB_SROW * t;
    s[0] = h[0];
    s[1] = h[1];
    s[2] = h[2];
    s[3] = h[4] * plane + h[0] * N12 + h[1] * N2 + h[2];
    s[4] = h[5] * plane;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();  // the table and every lane's copies
  // the warp stays converged: a team that has left its loop (or holds no
  // system) keeps stepping with the others, its work skipped, so every
  // shuffle and __syncwarp is the whole warp's
  const int own = live ? n : 0;  // the elements this lane's team walks

  // each own element's stencil pairs, in its channel's triple order: the
  // field value and the source place (n, the zero place, off the domain);
  // and r = b, p = z = M^-1 r, delta = 0, rz0 = <r, z>
  double acc = 0.0;
  for (int e = lane; e < own; e += lanes) {
    const int c = e / plane;
    const int q = e - c * plane;
    const int x = q / N12;
    const int yz = q - x * N12;
    const int y = yz / N2;
    const int z = yz - y * N2;
    const int k0 = s_start[c], cnt = s_start[c + 1] - k0;
    const int first = k0 * plane + q * cnt;  // channel c's pairs start at k0*plane
    for (int t = 0; t < cnt; ++t) {
      const int* h = s_tr + TB_SROW * (k0 + t);
      const int xx = x + h[0];
      const int yy = y + h[1];
      const int zz = z + h[2];
      const bool in = xx >= 0 && xx < N0 && yy >= 0 && yy < N1 && zz >= 0 && zz < N2;
      stab[first + t] = make_float2(sF[h[4] + q], __int_as_float(in ? h[3] + q : n));
    }
    smeta[e] = first << 10 | cnt;
    const float rv = sb[e];
    const float zv = __fmul_rn(spre[e], rv);
    sr[e] = rv;
    sp[e] = zv;
    sd[e] = 0.f;
    acc += (double)__fmul_rn(rv, zv);
  }
  if (live && lane == 0) {
    sp[n] = 0.f;
    sd[n] = 0.f;
  }
  float rz = (float)tb_team_sum(acc, lanes);
  const float floor_rz = __fmul_rn(tol, rz);
  float q0 = 0.f;
  bool done = !live;
  int l = 0;  // the team's executed iterations: it, while it runs
  __syncwarp();  // the stencil reads the other lanes' p
  for (int it = 0; it < lits && !__all_sync(0xffffffffu, done); ++it) {
    const int walk = done ? 0 : own;
    // Ap = A p (+ ctc p), <p, Ap>
    acc = 0.0;
    for (int e = lane; e < walk; e += lanes) {
      const int m = smeta[e];
      const float2* pr = stab + (m >> 10);
      const int cnt = m & 1023;
      float a = 0.f;
#pragma unroll 4
      for (int t = 0; t < cnt; ++t) {
        const float2 v = pr[t];
        a = __fadd_rn(a, __fmul_rn(v.x, sp[__float_as_int(v.y)]));
      }
      const float pe = sp[e];
      if constexpr (LM) a = __fadd_rn(a, __fmul_rn(sctc[e], pe));
      sAp[e] = a;
      acc += (double)__fmul_rn(pe, a);
    }
    const float den = (float)tb_team_sum(acc, lanes);
    const float alpha = tb_div(rz, den, guard_div);

    // delta += alpha p; r -= alpha Ap, or on an LM reset iteration (the
    // same for every running team: each has run `it` iterations)
    // r = b - (A delta + ctc delta); <z, r> and, under LM, <delta, b + r>
    acc = 0.0;
    double acc_q = 0.0;
    if (LM && (it + 1) % reset_period == 0) {
      for (int e = lane; e < walk; e += lanes)
        sd[e] = __fadd_rn(sd[e], __fmul_rn(alpha, sp[e]));
      __syncwarp();  // the stencil below reads the other lanes' delta
      for (int e = lane; e < walk; e += lanes) {
        const int m = smeta[e];
        const float2* pr = stab + (m >> 10);
        const int cnt = m & 1023;
        const float dv = sd[e];
        float a = 0.f;
        for (int t = 0; t < cnt; ++t) {
          const float2 v = pr[t];
          a = __fadd_rn(a, __fmul_rn(v.x, sd[__float_as_int(v.y)]));
        }
        a = __fadd_rn(a, __fmul_rn(sctc[e], dv));
        const float bv = sb[e];
        const float rv = __fsub_rn(bv, a);
        sr[e] = rv;
        acc += (double)__fmul_rn(__fmul_rn(spre[e], rv), rv);
        acc_q += (double)__fmul_rn(dv, __fadd_rn(bv, rv));
      }
    } else {
      for (int e = lane; e < walk; e += lanes) {
        const float dv = __fadd_rn(sd[e], __fmul_rn(alpha, sp[e]));
        sd[e] = dv;
        const float rv = __fsub_rn(sr[e], __fmul_rn(alpha, sAp[e]));
        sr[e] = rv;
        acc += (double)__fmul_rn(__fmul_rn(spre[e], rv), rv);
        if constexpr (LM) acc_q += (double)__fmul_rn(dv, __fadd_rn(sb[e], rv));
      }
    }
    const float rz_new = (float)tb_team_sum(acc, lanes);
    const float beta = tb_div(rz_new, rz, guard_div);
    bool stop;
    if constexpr (LM) {
      const float q1 = __fmul_rn(0.5f, (float)tb_team_sum(acc_q, lanes));
      const float zeta =
          __fdiv_rn(__fmul_rn((float)(it + 1), __fsub_rn(q1, q0)), q1);
      stop = zeta < q_tol || rz_new <= floor_rz;
      q0 = q1;
    } else {
      stop = rz_new <= floor_rz || den <= 0.f;
    }
    if (!done) {
      l = it + 1;
      done = stop;
    }
    rz = rz_new;

    // p = z + beta p, z = M^-1 r (a team that stops leaves p as it is)
    for (int e = lane; e < (done ? 0 : own); e += lanes)
      sp[e] = __fadd_rn(__fmul_rn(spre[e], sr[e]), __fmul_rn(beta, sp[e]));
    __syncwarp();  // the next apply reads the other lanes' p
  }
  if (!live) return;
  const size_t o = (size_t)k * n;
  for (int e = lane; e < n; e += lanes) delta_out[o + e] = sd[e];
  if (lane == 0) iters[k] = l;
}

extern "C" {

// The dynamic shared memory a block of per_block systems takes, in bytes.
int tiled_batch_cg_smem_bytes(int lm, int C, int T, int n_triples, int plane,
                              int per_block) {
  return 4 * per_block * tb_system_words(lm, C, T, n_triples, plane);
}

// Launches the batch on `stream`: n_sys systems of C channels on the domain
// [N0, N1, N2], T fields each, a team of `lanes` lanes a system and
// per_block systems a one-warp block; returns the CUDA error code (0:
// launched).
int tiled_batch_cg_launch(int lm, const float* F, const float* b,
                          const float* pre, const float* ctc,
                          const int* triples, const int* starts, int C, int T,
                          int n_triples, int N0, int N1, int N2, int n_sys,
                          int lanes, int per_block, int lits, float tol,
                          int guard_div, int reset_period, float q_tol,
                          float* delta, int* iters, void* stream) {
  if (n_triples < 1 || n_triples > TB_MAX_TRIPLES || C < 1 ||
      C > TB_MAX_CHANNELS || T < 1 || n_sys < 1 || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) || per_block < 1 || per_block * lanes > TB_THREADS ||
      (lm && reset_period < 1))
    return (int)cudaErrorInvalidValue;
  const int plane = N0 * N1 * N2;
  if ((long long)plane * n_triples >= (1 << 21))  // a pair's place in 21 bits
    return (int)cudaErrorInvalidValue;
  const int smem =
      tiled_batch_cg_smem_bytes(lm, C, T, n_triples, plane, per_block);
  const int blocks = (n_sys + per_block - 1) / per_block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  // above the default 48 KB a block, the instance must opt in first
  if (lm) {
    if (smem > 48 * 1024)
      err = cudaFuncSetAttribute(tiled_batch_cg_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    tiled_batch_cg_kernel<true><<<blocks, TB_THREADS, smem, s>>>(
        F, b, pre, ctc, triples, starts, C, T, n_triples, N0, N1, N2, n_sys,
        lanes, per_block, lits, tol, guard_div, reset_period, q_tol, delta,
        iters);
  } else {
    if (smem > 48 * 1024)
      err = cudaFuncSetAttribute(tiled_batch_cg_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    tiled_batch_cg_kernel<false><<<blocks, TB_THREADS, smem, s>>>(
        F, b, pre, ctc, triples, starts, C, T, n_triples, N0, N1, N2, n_sys,
        lanes, per_block, lits, tol, guard_div, reset_period, q_tol, delta,
        iters);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
