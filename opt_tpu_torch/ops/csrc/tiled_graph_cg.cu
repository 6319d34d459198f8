// Whole-loop preconditioned CG for a graph operator, with or without an
// irregular remainder: one persistent cooperative launch per CG solve, one
// block a contiguous range of vertices, for Hopper (sm_90a). Four kernels,
// tiled_graph_cg_kernel<LM, STREAM>: the standard Gauss-Newton loop and the
// standard Levenberg-Marquardt loop of fused_grid_cg.cuh (lines 66-78),
// float32 fields and remainder blocks, the Jacobi preconditioner, over the
// graph domain [1, N], any number of channels C from 2; each solves n_sys
// independent systems in turn (1 for one system). STREAM is the layout:
// the resident one (false) stages a range's fields in shared memory, the
// stream one (true) reads them from device memory every iteration. Their
// launches count, in ops/fused_cg.py, as gn_rem_tiled and lm_rem_tiled
// (resident, one system), gn_rem_multi_tiled and lm_rem_multi_tiled
// (resident, a batch of systems over one CSR), and gn_dia_tiled and
// lm_dia_tiled (stream, one system without the remainder: its CSR empty).
//
// Replaces, in opt_tpu/ops/pallas_cg.py: _kernel (:328) in its rem_pairs
// form (:338, apply :383-409 and :410-494), the Pallas TPU kernel that runs
// the whole PCG loop of a graph whose vertex numbering leaves reads no
// vertex-id offset covers, with lm=True (:345, :495), also under jax.vmap
// (opt_tpu/solver/gauss_newton.py:983-1004), where the partition of the
// vertices (ops/fused_cg.py::graph_tile_plan) fits the card's shared
// memory; and the same kernel in its flat1d form (:335, apply :386-399),
// the DIA-only graph, one system (the stream layout). The other remainder
// forms (Chronopoulos-Gear, bfloat16, block-Jacobi, the block-per-system
// batch) and the DIA-only form's batches and variants run the template.
//
// The arithmetic is the template's (fused_grid_cg.cuh:297-314 and
// :396-419): float32 products with explicit round-to-nearest intrinsics and
// no fused multiply-add. Each output (vertex v, channel i) starts at +0, adds
// its channel's triples in their order (a DIA offset d reads v + d; a read
// that leaves [0, N) is skipped, as the template skips it, and its field is
// 0 there), then its CSR row's entries ascending, j ascending inside each,
// then under LM ctc*p. Each dot is float32 products summed in double. The
// kernel is therefore bitwise equal to the template and to the plain
// PyTorch twin (ops/fused_cg.py::fused_grid_cg_reference).
//
// What bounds it: the bytes of the remainder's blocks. An iteration must
// read every C x C block once (the armadillo, 31,106 vertices of 6
// channels: 186,624 blocks of 144 B, 26.9 MB, 80% of the bytes), the fields
// (37 a vertex) and the vectors. The template gave every output its own
// thread in channel-major order, so the threads of a warp read blocks about
// 860 B apart, each 144 B block was read by six threads of six warps, p was
// gathered by 36 scalar L2 reads an entry, and 730 blocks met at three grid
// barriers an iteration.
//
// What the design does about it:
//   * The vertices are cut on the host into at most one contiguous range an
//     SM, balanced by the bytes each reads (ops/fused_cg.py::graph_partition,
//     built once per topology). A block of 512 threads owns a range, and the
//     range's CSR entries are one contiguous span of blk.
//   * The range's state stays in dynamic shared memory for the whole solve,
//     vertex-major ([vertex][C], so that neighbouring threads touch
//     neighbouring words): r and Ap over the range; p, delta and pre over
//     its frame, the range and its halo (the vertices outside it that its
//     CSR entries or DIA offsets read), sorted by vertex id, so that the
//     window [v0 - dlo, v1 + dhi) of the DIA offsets is contiguous in it;
//     under LM b and ctc over the range. The range's fields are staged once
//     a solve, and the remainder's columns, remapped on the host to frame
//     places, once a launch.
//   * The blocks do not fit beside the state (the armadillo's largest span is
//     1,419 blocks, 204 KB) and are streamed from L2 every iteration.
//     Keeping what fits of each span in the shared memory the state leaves
//     over measured no faster on an H100, so the kernel does not.
//   * The apply gives thread t the outputs (v, i) = divmod(t + 512 k, C),
//     vertex-major: the C threads of a vertex read one block's C rows, 8-byte
//     loads through the read-only path, neighbouring vertices' blocks lying
//     next to each other in the span; p comes from shared memory.
//   * Only r's border goes through global memory: after the update each
//     block writes r at its border vertices (those some other block's halo
//     holds) to a vertex-major array; after the barrier each block forms
//     p = pre*r + beta*p over its halo from that array and its staged pre,
//     the owner's own arithmetic, so its halo copy of p stays bitwise the
//     owner's and p itself is never exchanged. Under LM each block keeps
//     delta on its halo the same way (delta += alpha*p, alpha the same in
//     every block), so an LM reset iteration (r = b - (A delta + ctc delta)
//     every reset_period) reads delta's halo copy and takes no extra barrier.
//   * Two grid barriers an iteration: (1) the apply and <p, Ap>; (2) the
//     update, z = pre*r, <z, r> and under LM <delta, b + r> in one record,
//     and r's border. Each block sums its threads' doubles in a fixed
//     shuffle tree, one record a block, and every block sums the <= 132
//     records in the same fixed order, so every block takes the same exit.
//   * The systems of a launch (n_sys, one for a single system) are solved in
//     turn, each with its own fields, b, pre, ctc and blocks (at per-system
//     strides), dots, exit and count; they share the partition. A grid
//     barrier before each system after the first frees the records, the
//     border array and the shared memory for it.
//   * The stream layout (STREAM), for the DIA-only graph: its fields do not
//     fit beside the state (arap on the 192 x 192 grid mesh: 181 fields,
//     203 KB a range of 280 vertices, against 67 KB of state), so they are
//     not staged and the apply reads them from device memory, where they
//     stay in the 50 MB L2 between iterations (26.7 MB). The apply, about
//     31 triples an output, then costs its instructions and each thread's
//     chain of loads, not the fields' bytes (staging the 146 rows that fit
//     measured slower on an H100), so: a warp takes 32 consecutive
//     vertices of one channel (tgr_for_outputs: one 128-byte segment of a
//     field row a load, every lane on the same triple); a triple is one
//     16-byte broadcast load (s_tr: field offset, source offset, offset);
//     a chunk of TGR_FIELD_CHUNK triples' fields and p values is loaded
//     before any is summed (tgr_sum_stream); and the bounds check runs only
//     for vertices that some offset takes outside [0, N), near the graph's
//     two ends. The sums and their order are the resident layout's,
//     so the bits are too; with no remainder the CSR loop is empty (rowptr
//     all zero) and col, lcol and blk are never read. The resident
//     instances' code is unchanged (if constexpr).
//   * The dynamic shared memory is set (cudaFuncSetAttribute) before the
//     occupancy query and the launch; a launch that needs more blocks than
//     can be co-resident is refused and the error returned.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "tiled_cg.cuh"

namespace cg = cooperative_groups;

#define TGR_MAX_TRIPLES 512
#define TGR_MAX_CHANNELS 64
#define TGR_ROW 6    // a triple as the host gives it: d0, d1, d2, i, j, fid
#define TGR_BLOCK 5  // a block's record: v0, v1, own_at, halo_off, nh
#define TGR_FIELD_CHUNK 16  // the stream layout's field loads in flight a thread

// A walk over the (vertex, channel) pairs of a run of vertices, vertex-major
// (o = v*C + c), at the block's stride, advanced by addition.
struct TgrWalk {
  int v, c, sv, sc;
  __device__ __forceinline__ TgrWalk(int C) {
    v = threadIdx.x / C;
    c = threadIdx.x - v * C;
    sv = TGCG_THREADS / C;
    sc = TGCG_THREADS - sv * C;
  }
  __device__ __forceinline__ void next(int C) {
    v += sv;
    c += sc;
    if (c >= C) {
      c -= C;
      ++v;
    }
  }
};

// The fields' stride in shared memory: the largest range, made odd so that
// the fields a warp's channels read fall in different banks.
__host__ __device__ __forceinline__ int tgr_field_stride(int nvm) { return nvm | 1; }

// The dynamic shared memory of a launch, in bytes, in the kernel's layout:
// the block-sum records; the fields [T][nvm | 1] (in the stream layout
// instead the triples [n_triples] as int4: field offset, source offset,
// offset); r and Ap (under LM also b and ctc) [nvm][C]; p, delta and pre
// [nfm][C]; the columns' frame places [nem], the halo [nhm], the row starts
// [nvm + 1], the triples' field and source offsets and offsets
// [3][n_triples] (not in the stream layout), the channels' first triples
// [C + 1]; the border flags [nvm] bytes. nvm, nfm, nhm and nem are the
// largest range, frame, halo and entry span of the launch's blocks.
__host__ __device__ __forceinline__ long long tgr_smem_bytes(int lm, int stream, int C, int T,
                                                            int nvm, int nfm, int nhm, int nem,
                                                            int n_triples) {
  return 16LL * (TGCG_WARPS + 1) +
         4LL * ((stream ? 4LL * n_triples : (long long)T * tgr_field_stride(nvm)) +
                (lm ? 4LL : 2LL) * C * nvm + 3LL * C * nfm + nem + nhm + nvm + 1 +
                (stream ? 0LL : 3LL * n_triples) + C + 1) +
         ((nvm + 3) & ~3);
}

// A block's view of the launch, the same for every system of it: its
// shared-memory arrays and its place in the graph.
struct TgrBlock {
  double2* s_warp;   // TGCG_WARPS block-sum records
  double2* s_bcast;  // one record
  float *s_F, *s_r, *s_ap, *s_b, *s_ctc, *s_p, *s_d, *s_pre;
  const int *s_lcol, *s_halo, *s_row, *s_fo, *s_src, *s_dd, *s_start;
  const int4* s_tr;  // the stream layout's triples
  const unsigned char* s_border;
  int N, v0, nv, own_at, nh, e0, fs, n_blocks;
  int dlo, dhi;  // the stream layout: the triples' largest offsets below and above
};

// One channel's triples [k0, k1) of output vertex v (vl in the range) summed
// into a from +0 in their order, in the stream layout: TGR_FIELD_CHUNK
// triples' fields (fv: the system's F at v, a field's row N apart) and
// source values (sv: src at v's frame place) loaded, with clamped
// indices, before the chunk's sums, so that no sum waits on a load. Under
// CHECK a read that leaves [0, N) loads v's own place and is not summed;
// without it every read must lie inside.
template <bool CHECK>
__device__ __forceinline__ float tgr_sum_stream(const TgrBlock& tb,
                                                const float* __restrict__ fv,
                                                const float* sv, int v, int k0, int k1) {
  float a = 0.f;
  for (; k0 < k1; k0 += TGR_FIELD_CHUNK) {
    float f[TGR_FIELD_CHUNK], x[TGR_FIELD_CHUNK];
    unsigned in = 0;  // CHECK: bit j, triple k0 + j reads inside [0, N)
#pragma unroll
    for (int j = 0; j < TGR_FIELD_CHUNK; ++j) {
      const int4 t = tb.s_tr[min(k0 + j, k1 - 1)];
      bool ok = true;
      if constexpr (CHECK) {
        ok = t.z == 0 || (unsigned)(v + t.z) < (unsigned)tb.N;
        in |= (unsigned)ok << j;
      }
      f[j] = __ldg(fv + t.x);
      x[j] = sv[ok ? t.y : 0];
    }
    const int n = k1 - k0;
#pragma unroll
    for (int j = 0; j < TGR_FIELD_CHUNK; ++j)
      if (j < n && (!CHECK || ((in >> j) & 1u))) a = __fadd_rn(a, __fmul_rn(f[j], x[j]));
  }
  return a;
}

// Output (vl, i) of the block's range applied to src (a frame array
// [nfm][C]): from +0 the triples of channel i in their order, then row v's
// remainder entries ascending, j ascending inside each (the block's row i
// of blk, 8 bytes a load; for an odd C, whose rows start at odd words for
// every other row, one float first where the row's start is not 8-byte
// aligned and one last where a float is left over), src read at the
// entry's column. The
// fields come from shared memory, or under STREAM from fb (the system's F
// at the range's first vertex, through the read-only path) by
// tgr_sum_stream, which checks each read against [0, N) only for a vertex
// that some offset takes outside (near the graph's two ends).
template <bool STREAM>
__device__ __forceinline__ float tgr_apply(const TgrBlock& tb, const float* __restrict__ fb,
                                           const float* __restrict__ blk, const float* src,
                                           int C, int vl, int i) {
  const int v = tb.v0 + vl;
  const int vf = (tb.own_at + vl) * C;
  float a = 0.f;
  const int k1 = tb.s_start[i + 1];
  if constexpr (STREAM) {
    if (v - tb.dlo >= 0 && v + tb.dhi < tb.N)  // every offset reads inside [0, N)
      a = tgr_sum_stream<false>(tb, fb + vl, src + vf, v, tb.s_start[i], k1);
    else
      a = tgr_sum_stream<true>(tb, fb + vl, src + vf, v, tb.s_start[i], k1);
  } else {
    for (int k = tb.s_start[i]; k < k1; ++k) {
      const int d = tb.s_dd[k];
      if (d == 0 || (unsigned)(v + d) < (unsigned)tb.N)
        a = __fadd_rn(a, __fmul_rn(tb.s_F[tb.s_fo[k] + vl], src[vf + tb.s_src[k]]));
    }
  }
  const int e1 = tb.s_row[vl + 1];
  if (C & 1) {
    for (int e = tb.s_row[vl]; e < e1; ++e) {
      const float* su = src + tb.s_lcol[e];
      const float* row = blk + ((tb.e0 + e) * C + i) * C;
      int j = 0;
      if (reinterpret_cast<size_t>(row) & 7) {  // an odd word: one float first
        a = __fadd_rn(a, __fmul_rn(__ldg(row), su[0]));
        j = 1;
      }
      for (; j + 1 < C; j += 2) {
        const float2 w = __ldg(reinterpret_cast<const float2*>(row + j));
        a = __fadd_rn(a, __fmul_rn(w.x, su[j]));
        a = __fadd_rn(a, __fmul_rn(w.y, su[j + 1]));
      }
      if (j < C) a = __fadd_rn(a, __fmul_rn(__ldg(row + j), su[j]));
    }
    return a;
  }
  const int h = C >> 1;
#pragma unroll 4
  for (int e = tb.s_row[vl]; e < e1; ++e) {
    const float* su = src + tb.s_lcol[e];
    const float2* bk = reinterpret_cast<const float2*>(blk + ((tb.e0 + e) * C + i) * C);
    for (int jj = 0; jj < h; ++jj) {
      const float2 w = __ldg(bk + jj);
      a = __fadd_rn(a, __fmul_rn(w.x, su[2 * jj]));
      a = __fadd_rn(a, __fmul_rn(w.y, su[2 * jj + 1]));
    }
  }
  return a;
}

// body(vl, i) for every output of the block's range, in the apply's order:
// vertex-major at the block's stride (TgrWalk), or under STREAM a warp's 32
// lanes on 32 consecutive vertices of one channel, the warps taking the
// (32 vertices, channel) slots at their stride, so that a warp's field
// loads are one segment of a field row and its triples the same.
template <bool STREAM, typename Body>
__device__ __forceinline__ void tgr_for_outputs(int nv, int C, Body&& body) {
  if constexpr (STREAM) {
    const int lane = threadIdx.x & 31;
    const int slots = ((nv + 31) >> 5) * C;
    for (int s = threadIdx.x >> 5; s < slots; s += TGCG_WARPS) {
      const int q = s / C;
      const int vl = (q << 5) + lane;
      if (vl < nv) body(vl, s - q * C);
    }
  } else {
    for (TgrWalk w(C); w.v < nv; w.next(C)) body(w.v, w.c);
  }
}

// The frame place of halo vertex m: the halo sorted by vertex id, the range
// sitting after its first own_at entries.
__device__ __forceinline__ int tgr_halo_place(const TgrBlock& tb, int m) {
  return m < tb.own_at ? m : m + tb.nv;
}

// One CG solve of C channels on the graph [1, N] by every block of the
// launch, each on its range: F [T, N], b, pre, ctc [C, N] and blk
// [nnz, C, C] are the system's own. Writes delta [C, N]. Returns the
// executed iteration count, the same in every block.
template <bool LM, bool STREAM>
__device__ __forceinline__ int tgr_solve(cg::grid_group& grid, const TgrBlock& tb,
                                         const float* __restrict__ F,
                                         const float* __restrict__ b,
                                         const float* __restrict__ pre,
                                         const float* __restrict__ ctc,
                                         const float* __restrict__ blk, int C, int T, int lits,
                                         float tol, int guard_div, int reset_period,
                                         float q_tol, float* delta, float* r_ring,
                                         double2* partA, double2* partB) {
  double2* s_warp = tb.s_warp;
  double2* s_bcast = tb.s_bcast;
  float* s_F = tb.s_F;
  float* s_r = tb.s_r;
  float* s_ap = tb.s_ap;
  float* s_b = tb.s_b;
  float* s_ctc = tb.s_ctc;
  float* s_p = tb.s_p;
  float* s_d = tb.s_d;
  float* s_pre = tb.s_pre;
  const int* s_halo = tb.s_halo;
  const unsigned char* s_border = tb.s_border;
  const int N = tb.N, v0 = tb.v0, nv = tb.nv, own_at = tb.own_at, nh = tb.nh;
  const int fs = tb.fs, nf = nv + nh, n_blocks = tb.n_blocks;

  // the range's fields, once a solve (the stream layout reads them from F)
  if constexpr (!STREAM) {
    for (int k = threadIdx.x; k < T * nv; k += TGCG_THREADS) {
      const int f = k / nv;
      const int vl = k - f * nv;
      s_F[f * fs + vl] = F[f * N + v0 + vl];
    }
  }
  const float* fb = STREAM ? F + v0 : s_F;
  // over the frame: pre, p = pre*b, delta = 0; over the range r = b (and
  // under LM b and ctc); rz0 = <r, p>
  double2 acc = make_double2(0.0, 0.0);
  for (TgrWalk w(C); w.v < nf; w.next(C)) {
    const int m = w.v, i = w.c;
    const int vl = m - own_at;
    const bool own = vl >= 0 && vl < nv;
    const int g = own ? v0 + vl : s_halo[m < own_at ? m : m - nv];
    const float pv = pre[i * N + g];
    const float bv = b[i * N + g];
    const float zv = __fmul_rn(pv, bv);
    const int f = m * C + i;
    s_pre[f] = pv;
    s_p[f] = zv;
    s_d[f] = 0.f;
    if (own) {
      const int t = vl * C + i;
      s_r[t] = bv;
      if constexpr (LM) {
        s_b[t] = bv;
        s_ctc[t] = ctc[i * N + g];
      }
      acc.x += (double)__fmul_rn(bv, zv);
    }
  }
  acc = tg_block_sum(acc, s_warp);
  if (threadIdx.x == 0) partB[blockIdx.x] = acc;
  grid.sync();
  float rz = (float)tg_partials_sum(partB, n_blocks, s_bcast).x;
  const float floor_rz = __fmul_rn(tol, rz);
  float q0 = 0.f;
  int l = 0;

  while (l < lits) {
    // phase 1: Ap = A p (+ ctc p) over the range, the partials of <p, Ap>
    acc = make_double2(0.0, 0.0);
    tgr_for_outputs<STREAM>(nv, C, [&](int vl, int i) {
      const int t = vl * C + i;
      // ctc is read before the apply's chain of sums, so its latency
      // overlaps the chain's
      const float cv = LM ? s_ctc[t] : 0.f;
      float a = tgr_apply<STREAM>(tb, fb, blk, s_p, C, vl, i);
      const float pv = s_p[own_at * C + t];
      if constexpr (LM) a = __fadd_rn(a, __fmul_rn(cv, pv));
      s_ap[t] = a;
      acc.x += (double)__fmul_rn(pv, a);
    });
    acc = tg_block_sum(acc, s_warp);
    if (threadIdx.x == 0) partA[blockIdx.x] = acc;
    grid.sync();
    const float den = (float)tg_partials_sum(partA, n_blocks, s_bcast).x;
    const float alpha = tg_safe_div(rz, den, guard_div);

    // phase 2: delta += alpha p (under LM also on the halo); r -= alpha Ap,
    // or on an LM reset iteration r = b - (A delta + ctc delta); the
    // partials of <z, r> (z = pre r) and, under LM, of <delta, b + r>; r at
    // the border vertices to r_ring
    bool reset = false;
    if constexpr (LM) reset = (l + 1) % reset_period == 0;
    acc = make_double2(0.0, 0.0);
    if (!reset) {
      for (TgrWalk w(C); w.v < nv; w.next(C)) {
        const int t = w.v * C + w.c;
        const int f = own_at * C + t;
        const float dv = __fadd_rn(s_d[f], __fmul_rn(alpha, s_p[f]));
        s_d[f] = dv;
        const float rv = __fsub_rn(s_r[t], __fmul_rn(alpha, s_ap[t]));
        s_r[t] = rv;
        const float zv = __fmul_rn(s_pre[f], rv);
        s_ap[t] = zv;  // for the p update
        acc.x += (double)__fmul_rn(zv, rv);
        if constexpr (LM) acc.y += (double)__fmul_rn(dv, __fadd_rn(s_b[t], rv));
        if (s_border[w.v]) r_ring[(v0 + w.v) * C + w.c] = rv;
      }
      if constexpr (LM) {
        for (TgrWalk w(C); w.v < nh; w.next(C)) {
          const int f = tgr_halo_place(tb, w.v) * C + w.c;
          s_d[f] = __fadd_rn(s_d[f], __fmul_rn(alpha, s_p[f]));
        }
      }
    } else {
      for (TgrWalk w(C); w.v < nf; w.next(C)) {
        const int f = w.v * C + w.c;
        s_d[f] = __fadd_rn(s_d[f], __fmul_rn(alpha, s_p[f]));
      }
      __syncthreads();  // the apply below reads the neighbours' delta
      tgr_for_outputs<STREAM>(nv, C, [&](int vl, int i) {
        const int t = vl * C + i;
        const int f = own_at * C + t;
        const float dv = s_d[f];
        const float cv = s_ctc[t];
        const float bv = s_b[t];
        float a = tgr_apply<STREAM>(tb, fb, blk, s_d, C, vl, i);
        a = __fadd_rn(a, __fmul_rn(cv, dv));
        const float rv = __fsub_rn(bv, a);
        s_r[t] = rv;
        acc.x += (double)__fmul_rn(__fmul_rn(s_pre[f], rv), rv);
        acc.y += (double)__fmul_rn(dv, __fadd_rn(bv, rv));
        if (s_border[vl]) r_ring[(v0 + vl) * C + i] = rv;
      });
    }
    acc = tg_block_sum(acc, s_warp);
    if (threadIdx.x == 0) partB[blockIdx.x] = acc;
    grid.sync();
    const double2 sums = tg_partials_sum(partB, n_blocks, s_bcast);
    const float rz_new = (float)sums.x;
    const float beta = tg_safe_div(rz_new, rz, guard_div);
    ++l;
    if constexpr (LM) {
      const float q1 = __fmul_rn(0.5f, (float)sums.y);
      const float zeta = __fdiv_rn(__fmul_rn((float)l, __fsub_rn(q1, q0)), q1);
      if (zeta < q_tol || rz_new <= floor_rz) break;
      q0 = q1;
    } else {
      if (rz_new <= floor_rz || den <= 0.f) break;
    }
    rz = rz_new;

    // phase 3: p = z + beta p over the range (z kept in Ap's space; pre r
    // after a reset) and over the halo (pre times the owners' r)
    for (TgrWalk w(C); w.v < nv; w.next(C)) {
      const int t = w.v * C + w.c;
      const int f = own_at * C + t;
      const float zv = reset ? __fmul_rn(s_pre[f], s_r[t]) : s_ap[t];
      s_p[f] = __fadd_rn(zv, __fmul_rn(beta, s_p[f]));
    }
    for (TgrWalk w(C); w.v < nh; w.next(C)) {
      const int f = tgr_halo_place(tb, w.v) * C + w.c;
      const float zv = __fmul_rn(s_pre[f], __ldcg(r_ring + s_halo[w.v] * C + w.c));
      s_p[f] = __fadd_rn(zv, __fmul_rn(beta, s_p[f]));
    }
    __syncthreads();
  }

  for (TgrWalk w(C); w.v < nv; w.next(C))
    delta[w.c * N + v0 + w.v] = s_d[(own_at + w.v) * C + w.c];
  return l;
}

// The kernel, block k owning the vertex range of record k of `blocks`
// (v0, v1, own_at, halo_off, nh: its range, the number of its halo
// vertices below v0, and its halo's place and length in `halo`, sorted
// global ids). lcol [nnz] holds each remainder entry's column as a place in
// its block's frame (staged times C, a vertex-major offset); border [N] flags the
// vertices some block's halo holds. delta receives the solutions; r_ring
// [N, C] is scratch of one system, of which each block writes only its
// border vertices; partA and partB hold one record a block. The launch
// holds n_sys independent systems over one CSR, solved in turn: system s
// reads its fields at F + s*f_stride, b, pre and ctc at s*C*N, its blocks
// at blk + s*blk_stride, writes delta at s*C*N and its count to iters[s].
// Under STREAM the fields are read from F (no shared copy), a field's row N
// apart.
template <bool LM, bool STREAM>
__global__ void __launch_bounds__(TGCG_THREADS, 1)
tiled_graph_cg_kernel(const float* __restrict__ F, const float* __restrict__ b,
                      const float* __restrict__ pre, const float* __restrict__ ctc,
                      const float* __restrict__ blk, const int* __restrict__ triples,
                      const int* __restrict__ starts, const int* __restrict__ rowptr,
                      const int* __restrict__ lcol, const int* __restrict__ blocks,
                      const int* __restrict__ halo, const unsigned char* __restrict__ border,
                      int C, int T, int n_triples, int N, int nvm, int nfm, int nhm, int nem,
                      int lits, float tol, int guard_div, int reset_period, float q_tol,
                      int n_sys, int f_stride, int blk_stride, float* delta, float* r_ring,
                      double2* partA, double2* partB, int* iters) {
  extern __shared__ double2 smem[];
  TgrBlock tb;
  tb.fs = STREAM ? N : tgr_field_stride(nvm);
  tb.s_warp = smem;
  tb.s_bcast = smem + TGCG_WARPS;
  float* const s_state = (float*)(smem + TGCG_WARPS + 1);
  tb.s_F = STREAM ? nullptr : s_state;
  int4* s_tr = (int4*)s_state;  // 16-byte aligned after the records
  tb.s_tr = s_tr;
  tb.s_r = s_state + (STREAM ? 4 * n_triples : T * tb.fs);
  tb.s_ap = tb.s_r + C * nvm;
  tb.s_b = tb.s_ap + C * nvm;                 // under LM
  tb.s_ctc = tb.s_b + (LM ? C * nvm : 0);     // under LM
  tb.s_p = tb.s_ctc + (LM ? C * nvm : 0);
  tb.s_d = tb.s_p + C * nfm;
  tb.s_pre = tb.s_d + C * nfm;
  int* s_lcol = (int*)(tb.s_pre + C * nfm);
  int* s_halo = s_lcol + nem;
  int* s_row = s_halo + nhm;
  const int nt = STREAM ? 0 : n_triples;  // the stream layout's triples are s_tr
  int* s_fo = s_row + nvm + 1;
  int* s_src = s_fo + nt;
  int* s_dd = s_src + nt;
  int* s_start = s_dd + nt;
  unsigned char* s_border = (unsigned char*)(s_start + C + 1);
  tb.s_lcol = s_lcol;
  tb.s_halo = s_halo;
  tb.s_row = s_row;
  tb.s_fo = s_fo;
  tb.s_src = s_src;
  tb.s_dd = s_dd;
  tb.s_start = s_start;
  tb.s_border = s_border;

  const int* rec = blocks + TGR_BLOCK * blockIdx.x;
  tb.N = N;
  tb.v0 = rec[0];
  tb.nv = rec[1] - rec[0];
  tb.own_at = rec[2];
  tb.nh = rec[4];
  tb.e0 = rowptr[tb.v0];
  tb.n_blocks = gridDim.x;
  const int hoff = rec[3];
  const int ne = rowptr[rec[1]] - tb.e0;

  // once a launch: the columns' frame places, the halo, the row starts,
  // the border flags and the triples
  for (int k = threadIdx.x; k < ne; k += TGCG_THREADS) s_lcol[k] = lcol[tb.e0 + k] * C;
  for (int k = threadIdx.x; k < tb.nh; k += TGCG_THREADS) s_halo[k] = halo[hoff + k];
  for (int k = threadIdx.x; k <= tb.nv; k += TGCG_THREADS) s_row[k] = rowptr[tb.v0 + k] - tb.e0;
  for (int k = threadIdx.x; k < tb.nv; k += TGCG_THREADS) s_border[k] = border[tb.v0 + k];
  for (int k = threadIdx.x; k <= C; k += TGCG_THREADS) s_start[k] = starts[k];
  for (int k = threadIdx.x; k < n_triples; k += TGCG_THREADS) {
    const int* t = triples + TGR_ROW * k;
    if constexpr (STREAM) {
      s_tr[k] = make_int4(t[5] * tb.fs, t[2] * C + t[4], t[2], 0);
    } else {
      s_fo[k] = t[5] * tb.fs;
      s_src[k] = t[2] * C + t[4];
      s_dd[k] = t[2];
    }
  }
  // the solve's first loop reads them after its own staging: order them
  __syncthreads();
  tb.dlo = tb.dhi = 0;
  if constexpr (STREAM) {
    for (int k = 0; k < n_triples; ++k) {
      tb.dlo = max(tb.dlo, -s_tr[k].z);
      tb.dhi = max(tb.dhi, s_tr[k].z);
    }
  }

  cg::grid_group grid = cg::this_grid();
  const int vec = C * N;  // one system's vector
  for (int s = 0; s < n_sys; ++s) {
    if (s > 0) grid.sync();  // every block is done with the last system
    const int l = tgr_solve<LM, STREAM>(grid, tb, F + s * f_stride, b + s * vec, pre + s * vec,
                                LM ? ctc + s * vec : ctc, blk + s * blk_stride, C, T, lits,
                                tol, guard_div, reset_period, q_tol, delta + s * vec, r_ring,
                                partA, partB);
    if (blockIdx.x == 0 && threadIdx.x == 0) iters[s] = l;
  }
}

extern "C" {

// Launches the solves on `stream`: n_blocks blocks of `threads` threads,
// each with smem_bytes of dynamic shared memory (which must be
// tgr_smem_bytes of these arguments). F [n_sys, T, N], b, pre, ctc (LM only)
// and delta [n_sys, C, N], blk [n_sys, nnz, C, C] float32, C >= 2
// (f_stride = T*N, blk_stride = nnz*C*C); triples [n_triples, 6] ((0, 0, d, i, j, fid))
// sorted by output channel with their per-channel starts [C + 1]; rowptr
// [N + 1]; lcol [nnz], blocks [n_blocks, 5], halo and border as the kernel
// reads them; r_ring [N, C]; partA and partB n_blocks double2 records
// each; iters n_sys ints. stream_layout picks the stream layout (the fields
// read from F every iteration); with nnz = 0 (rowptr all zero) lcol and blk
// are never read and may be null. Returns the CUDA error:
// cudaErrorCooperativeLaunchTooLarge where the blocks cannot all be
// co-resident.
int tiled_graph_cg_launch(int lm, int stream_layout, const float* F, const float* b,
                          const float* pre, const float* ctc, const float* blk,
                          const int* triples, const int* starts, const int* rowptr,
                          const int* lcol,
                          const int* blocks, const int* halo, const unsigned char* border,
                          int C, int T, int n_triples, int N, int n_blocks, int nvm, int nfm,
                          int nhm, int nem, int lits, float tol, int guard_div,
                          int reset_period, float q_tol, int n_sys, int f_stride,
                          int blk_stride, float* delta, float* r_ring, double2* partA,
                          double2* partB, int* iters, int threads, int smem_bytes,
                          void* stream) {
  if (threads != TGCG_THREADS || C < 2 || C > TGR_MAX_CHANNELS || T < 1 ||
      n_triples < 1 || n_triples > TGR_MAX_TRIPLES || N < 1 || n_blocks < 1 || n_blocks > N ||
      nvm < 1 || nfm < nvm || nhm < 0 || nem < 0 || n_sys < 1 || f_stride < 0 ||
      blk_stride < 0)
    return (int)cudaErrorInvalidValue;
  if (lm && (ctc == nullptr || reset_period < 1)) return (int)cudaErrorInvalidValue;
  if ((long long)smem_bytes !=
      tgr_smem_bytes(lm, stream_layout, C, T, nvm, nfm, nhm, nem, n_triples))
    return (int)cudaErrorInvalidValue;
  const void* kernel =
      stream_layout ? (lm ? (const void*)tiled_graph_cg_kernel<true, true>
                          : (const void*)tiled_graph_cg_kernel<false, true>)
                    : (lm ? (const void*)tiled_graph_cg_kernel<true, false>
                          : (const void*)tiled_graph_cg_kernel<false, false>);
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
  if (n_blocks > per_sm * sms) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {(void*)&F,      (void*)&b,          (void*)&pre,      (void*)&ctc,
                  (void*)&blk,    (void*)&triples,    (void*)&starts,   (void*)&rowptr,
                  (void*)&lcol,   (void*)&blocks,     (void*)&halo,     (void*)&border,
                  (void*)&C,      (void*)&T,          (void*)&n_triples, (void*)&N,
                  (void*)&nvm,    (void*)&nfm,        (void*)&nhm,      (void*)&nem,
                  (void*)&lits,   (void*)&tol,        (void*)&guard_div,
                  (void*)&reset_period, (void*)&q_tol, (void*)&n_sys,   (void*)&f_stride,
                  (void*)&blk_stride,   (void*)&delta, (void*)&r_ring,  (void*)&partA,
                  (void*)&partB,  (void*)&iters};
  e = cudaLaunchCooperativeKernel(kernel, dim3(n_blocks), dim3(threads), args,
                                  (size_t)smem_bytes, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
