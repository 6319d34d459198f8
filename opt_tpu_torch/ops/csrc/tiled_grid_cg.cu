// Whole-loop preconditioned CG for a 2-D grid stencil operator whose state
// fits the card's shared memory (or whose r and haloed p do: the hbm
// layout): one persistent cooperative launch per CG solve, one block a tile,
// for Hopper (sm_90a). Ten instances,
// tiled_grid_cg_kernel<LM, BLOCK, FT, MULTI, HBM>: the standard Gauss-Newton
// loop and the standard Levenberg-Marquardt loop of fused_grid_cg.cuh (lines
// 66-78), float32 fields with the Jacobi preconditioner (one system, or,
// under MULTI, several independent systems in turn in one launch, or, under
// HBM, one system whose delta and Ap live in device memory) or
// block-Jacobi (one kernel for one system or several in turn: the same
// loop over n_sys), and bfloat16 fields (FT) with the Jacobi preconditioner
// (one system). Their launches count, in ops/fused_cg.py, as gn_tiled,
// lm_tiled, gn_bf16_tiled, lm_bf16_tiled, gn_bj_tiled, lm_bj_tiled, for
// several systems gn_multi_tiled and lm_multi_tiled (the per-channel split,
// a batch) and gn_bj_multi_tiled and lm_bj_multi_tiled (a batch), and in
// the hbm layout gn_hbm_tiled and lm_hbm_tiled. Its checks and launch,
// tg_launch, also start the Chronopoulos-Gear kernel of tiled_grid_cs.cu
// (gn_cs_tiled, lm_cs_tiled).
//
// Replaces, in opt_tpu/ops/pallas_cg.py: _kernel (:328), the Pallas TPU
// kernel that runs the whole PCG inner loop of a grid problem in one
// launch, in its 2-D grid GN form (also with mixed unknowns packed into the
// channels, and with fields from ComputedArray slots), its lm=True form and
// its block_pre=True form (prec, :367-381), with bfloat16 coefficient fields
// (coeff_dtype, :586-592, :670-672), also under jax.vmap
// (opt_tpu/solver/gauss_newton.py:983-1004) and with chan_grid=True (:339,
// :513, :1057-1128: the channels as one-channel systems over shared
// fields), at the grid sizes whose state fits one tile a block
// (ops/fused_cg.py::tiled_grid_plan); and _hbm_tiled_kernel (:1430), the
// TPU kernel that streams the same GN and LM loop's state from HBM by row
// windows for grids beyond VMEM (image_warping 1024x1024x3), in the hbm
// layout, where a one-system float32 Jacobi launch's r and haloed p fit
// one tile a block but its whole state does not. The other forms, and
// these at larger sizes, run the template of fused_grid_cg.cuh.
//
// The arithmetic is the template's (fused_grid_cg.cuh:139-146): float32
// products with explicit round-to-nearest intrinsics and no fused
// multiply-add, each output's stencil sum over the triples of its channel in
// their order (ops/fused_cg.py::_device_triples sorts them stably by output
// channel), each dot as float32 products summed in double. The kernel is
// therefore bitwise equal to the template and to the plain PyTorch twin
// (ops/fused_cg.py::fused_grid_cg_reference). A read that leaves the grid
// multiplies the zero-filled halo beyond the grid's edge (the template skips
// it): each sum starts at +0 and the planner folded the in-bounds masks into
// the fields, so the two give the same bits.
//
// What bounds it: the bytes of the inputs. An iteration must read the
// coefficient fields at every point (image_warping 512x512x3: 26 fields, 27
// MB; half that in bfloat16, which the stencil widens exactly as it reads
// each field, so products and sums stay the float32 ones), the
// preconditioner and, under LM, the damping ctc. The template
// also moved the state vectors (r, delta, p, Ap) through L2 in three sweeps
// an iteration, read p once per stencil triple, and summed 1056 blocks'
// dot partials in every block, behind three grid barriers.
//
// Under block-Jacobi an iteration also reads the C*C inverse blocks at
// every point (image_warping: 9 planes, 9.4 MB), which stay the same for
// the whole solve. In the hbm layout an iteration also moves delta (read
// and write) and Ap (write and read) through device memory and reads pre
// once more: image_warping 1024x1024x3, 63 MB beside the 122 MB of its
// inputs.
//
// What the design does about it:
//   * The grid is cut into at most one tile per SM (a ceil split of both
//     axes, parallel/mesh.py::split_bounds), one block of 512 threads a tile
//     (one block per SM, so up to 128 registers a thread for the stencil's
//     index arithmetic and sums; 16 warps hide the shared-memory latency).
//   * The tile's state stays in dynamic shared memory for the whole solve:
//     r, delta and Ap as [C][rows][cols], p with a halo of h rows and h
//     columns (h the largest |d1| or |d2| of the triples) as
//     [C][rows + 2h][cols + 2h], zero beyond the grid's edge. Only the
//     inputs are read from global memory, once an iteration, coalesced.
//   * Only r's border goes through global memory: after the update each
//     block writes the h-wide ring of its tile's r to a grid-sized array.
//     After the barrier each block forms p = pre*r + beta*p over its tile
//     and its halo, reading the neighbours' r from that array and pre from
//     the input. Its halo copy of p is updated by the owner's own
//     arithmetic, so it stays bitwise equal to the owner's p; p itself is
//     never exchanged.
//   * Two grid barriers an iteration: (1) the apply Ap = A p (+ ctc p) and
//     <p, Ap>; (2) the delta and r update, z = pre*r (kept in Ap's space for
//     the p update), <z, r> and, under LM, <delta, b + r> in the same
//     record, and r's ring. An LM reset iteration (r = b - (A delta + ctc
//     delta) every reset_period) writes delta's ring to the output array and
//     takes one more barrier before its stencil over delta, which it reads
//     from a haloed copy built in Ap's space.
//   * Dot sums: each block sums its threads' doubles in a fixed shuffle
//     tree, one partial record a block (one or two doubles), and every block
//     sums the <= 132 records in the same fixed order, so every block takes
//     the same exit.
//   * Each thread walks the tile's points at a fixed stride with all C
//     channels at each point; the point's row and column advance by
//     addition (one division a phase).
//   * Under BLOCK the tile's C*C planes over the tile and its halo are
//     staged in shared memory once a solve, beside its state, and read
//     from there after. z at a point is the template's block apply (the sum
//     over j ascending from +0 of M^-1[i][j] * r[j]), formed after every
//     channel's r at the point is updated; on the halo from the
//     neighbours' r ring, which holds all C channels. The staged planes
//     take 4*C*C*(th+2h)*(tw+2h) bytes; a shape whose planes do not fit is
//     refused by the planner and keeps the template.
//   * The MULTI instances (and every block-Jacobi launch) solve the
//     launch's systems one after the other, each with its own dots, exit
//     and count; a grid barrier before each system after the first, and
//     each block reloads its tile's state for it. The per-channel split is
//     C systems of one channel over the same fields (a field stride of 0);
//     a batch, B systems of C channels with their own fields. The Jacobi
//     one-system instances keep no loop: wrapped around their solve it
//     cost them 3-8% an iteration on the H100, with other register counts
//     (PERF.md).
//   * The hbm layout (HBM; the TPU kernel's row windows and DMA
//     semaphores are not carried over): where the resident state does not
//     fit (image_warping 1024x1024x3: 12x11 tiles of 86x94, about 392 KB a
//     block) and C is at most 4 (TG_FRAME_CHUNK, the values of a point
//     each thread holds in registers), r over the tile and p over its
//     frame, which the ring
//     exchange and the stencil read, still do (198,920 B); delta and Ap,
//     which only the owning block reads back, move to a block-private
//     frame of a device scratch, the same walks writing and reading them,
//     so the loads stay coalesced and the loop keeps its two barriers. The
//     fields stream from device memory here (109 MB against the 50 MB
//     L2), so an iteration costs the latency of each thread's chain of
//     loads, and each phase puts more loads in flight a thread: the apply
//     (phase 1) reads a point's fields 16 triples at a time across its
//     channels (tg_apply_frames, tg_sum_triples); the update (phase 2),
//     the p update (phase 3) and an LM reset load four points of the walk
//     (delta, Ap, pre, b, r) before they store any (tg_update_frames,
//     tg_p_frames, tg_reset_frames); z is formed again for the p update
//     instead of being kept in Ap's frame. The arithmetic and its order
//     are the resident loop's, so the bits are the same too; the resident
//     instances' code is unchanged (if constexpr).
//   * The dynamic shared memory is set (cudaFuncSetAttribute) before the
//     occupancy query and the launch; a launch that needs more blocks than
//     can be co-resident is refused and the error returned.

#include "tiled_grid.cuh"

// z_i = (M^-1 r)_i at a point, m the point's first preconditioner plane
// (stride ms between planes) and r its first channel (stride rs), r read
// through L2 (__ldcg) when RING (the neighbours' r ring). Under BLOCK the
// sum over j ascending from +0 of m[(i*C + j)*ms] * r[j*rs], the template's
// block_prec arithmetic (fused_grid_cg.cuh:316-333); else m[i*ms] * r[i*rs].
template <bool BLOCK, bool RING>
__device__ __forceinline__ float tg_z(const float* m, int ms, const float* r, int rs, int C,
                                      int i) {
  auto rj = [&](int j) { return RING ? __ldcg(r + j * rs) : r[j * rs]; };
  if constexpr (BLOCK) {
    const float* mi = m + i * C * ms;
    float a = 0.f;
    for (int j = 0; j < C; ++j) a = __fadd_rn(a, __fmul_rn(mi[j * ms], rj(j)));
    return a;
  } else {
    return __fmul_rn(m[i * ms], rj(i));
  }
}

// x[c] for a channel c < 4 of values held in registers
__device__ __forceinline__ float tg_pick4(const float (&x)[4], int c) {
  return c == 0 ? x[0] : c == 1 ? x[1] : c == 2 ? x[2] : x[3];
}

// At one point g (e in the haloed frame): each channel's sum over its
// triples of F[field][g] * src[source + e], in their order from +0, handed
// to finish(c, sum) when channel c's triples end (also for a channel with
// none), the channels in turn, as tg_stencil sums each. The point's fields
// (with SRC, src's values too: src in device memory) are read K triples at
// a time across the channels' boundaries, with clamped indices, so that a
// chunk's loads are all in flight at once; the resident loop waits for each
// channel's few, and with the fields streamed from device memory (past the
// L2) that wait is what an iteration costs.
template <int K, bool SRC, typename FT, typename Finish>
__device__ __forceinline__ void tg_sum_triples(const FT* __restrict__ F, const float* src,
                                               const TgTile& tt, int C, int g, int e,
                                               Finish&& finish) {
  const int *s_f = tt.s_f, *s_p = tt.s_p, *s_start = tt.s_start;
  const int n_triples = s_start[C];
  int c = 0, end = s_start[1];  // the channel being summed, its triples' end
  float a = 0.f;
  for (int k0 = 0; k0 < n_triples; k0 += K) {
    float f[K], v[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int k = min(k0 + j, n_triples - 1);
      f[j] = tg_widen(F[s_f[k] + g]);
      if constexpr (SRC) v[j] = src[s_p[k] + e];
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int k = k0 + j;
      if (k >= n_triples) break;
      for (; k == end; a = 0.f) {
        finish(c, a);
        if (++c < C) end = s_start[c + 1];
      }
      a = __fadd_rn(a, __fmul_rn(f[j], SRC ? v[j] : src[s_p[k] + e]));
    }
  }
  for (; c < C; ++c, a = 0.f) finish(c, a);
}

// Phase 1 of tg_solve in the hbm layout: Ap = A p (+ ctc p) over the tile
// into ap, the block's frame, and the partials of <p, Ap>, the resident
// loop's arithmetic in its order (each channel's stencil sum, then ctc*p,
// the channels in turn): tg_sum_triples, TG_FIELD_CHUNK fields at a time,
// under LM the channels' ctc read with them (the layout takes up to
// TG_FRAME_CHUNK channels).
#define TG_FIELD_CHUNK 16
template <bool LM, typename FT>
__device__ __forceinline__ double2 tg_apply_frames(const TgTile& tt, const FT* __restrict__ F,
                                                   const float* __restrict__ ctc,
                                                   float* __restrict__ ap, int C) {
  const int N2 = tt.N2, plane = tt.plane, y0 = tt.y0, x0 = tt.x0, cols = tt.cols;
  const int pts = tt.pts, pcols = tt.pcols, ext = tt.ext, h = tt.h;
  double2 acc = make_double2(0.0, 0.0);
  for (TgWalk w(cols); w.q < pts; w.next(cols)) {
    const int gq = (y0 + w.y) * N2 + x0 + w.x;
    const int e = (w.y + h) * pcols + w.x + h;
    float cv[4];
    if constexpr (LM) {
#pragma unroll
      for (int i = 0; i < 4; ++i) cv[i] = ctc[min(i, C - 1) * plane + gq];
    }
    tg_sum_triples<TG_FIELD_CHUNK, false>(F, tt.s_pe, tt, C, gq, e, [&](int c, float a) {
      const float pv = tt.s_pe[c * ext + e];
      if constexpr (LM)
        a = __fadd_rn(a, __fmul_rn(tg_pick4(cv, c), pv));
      ap[c * pts + w.q] = a;
      acc.x += (double)__fmul_rn(pv, a);
    });
  }
  return acc;
}

// Phase 2 of tg_solve in the hbm layout, on an iteration that is no LM
// reset: delta += alpha p and r -= alpha Ap over the tile, the partials of
// <z, r> (z = pre*r) and, under LM, of <delta, b + r>, and r's ring to
// r_ring, the resident loop's arithmetic in its order. delta (d) and Ap
// (ap) lie in the block's device frame. The thread takes TG_FRAME_POINTS
// points of its walk at once and loads their delta, Ap, pre and (LM) b of
// every channel (the layout takes up to TG_FRAME_CHUNK) before it stores
// or sums anything, so that those loads are in flight together (in the
// resident loop's order each point's would wait for the last's); the sums
// then take the points and channels in the walk's order. A load past the
// tile or the channels reads a valid place and is not used. z is not kept:
// phase 3 forms it again from pre and r, which costs a read of pre in
// place of a write and a read of z. TG_FRAME_CHUNK is the layout's most
// channels (fused_cg.HBM_MAX_CHANNELS), a point's values in registers.
#define TG_FRAME_CHUNK 4
#define TG_FRAME_POINTS 4
template <bool LM>
__device__ __forceinline__ double2 tg_update_frames(const TgTile& tt, float* __restrict__ d,
                                                    const float* __restrict__ ap,
                                                    const float* __restrict__ pre,
                                                    const float* __restrict__ b, float alpha,
                                                    int C, float* __restrict__ r_ring) {
  const int N2 = tt.N2, plane = tt.plane, y0 = tt.y0, x0 = tt.x0, rows = tt.rows;
  const int cols = tt.cols, pts = tt.pts, pcols = tt.pcols, ext = tt.ext, h = tt.h;
  double2 acc = make_double2(0.0, 0.0);
  // one point's update of channel c from its loaded delta, Ap, pre and b
  auto update = [&](int q, int y, int x, int c, float dl, float al, float pl, float bl) {
    const int gq = (y0 + y) * N2 + x0 + x;
    const int e = (y + h) * pcols + x + h;
    const int t = c * pts + q;
    const float dv = __fadd_rn(dl, __fmul_rn(alpha, tt.s_pe[c * ext + e]));
    d[t] = dv;
    const float rv = __fsub_rn(tt.s_r[t], __fmul_rn(alpha, al));
    tt.s_r[t] = rv;
    const float zv = __fmul_rn(pl, rv);
    acc.x += (double)__fmul_rn(zv, rv);
    if constexpr (LM) acc.y += (double)__fmul_rn(dv, __fadd_rn(bl, rv));
    if (y < h || y >= rows - h || x < h || x >= cols - h) r_ring[c * plane + gq] = rv;
  };
  for (TgWalk w(cols); w.q < pts; w.next(cols)) {
    int vq[TG_FRAME_POINTS], vy[TG_FRAME_POINTS], vx[TG_FRAME_POINTS];
    float dk[TG_FRAME_POINTS][TG_FRAME_CHUNK], ak[TG_FRAME_POINTS][TG_FRAME_CHUNK];
    float pk[TG_FRAME_POINTS][TG_FRAME_CHUNK], bk[TG_FRAME_POINTS][TG_FRAME_CHUNK];
    TgWalk u = w;
#pragma unroll
    for (int i = 0; i < TG_FRAME_POINTS; ++i) {
      if (i > 0) u.next(cols);
      vq[i] = u.q;
      vy[i] = u.y;
      vx[i] = u.x;
      const bool in = u.q < pts;  // else read the first point's places
      const int q = in ? u.q : w.q;
      const int gq = (y0 + (in ? u.y : w.y)) * N2 + x0 + (in ? u.x : w.x);
#pragma unroll
      for (int k = 0; k < TG_FRAME_CHUNK; ++k) {
        const int c = min(k, C - 1);
        dk[i][k] = d[c * pts + q];
        ak[i][k] = ap[c * pts + q];
        pk[i][k] = pre[c * plane + gq];
        bk[i][k] = LM ? b[c * plane + gq] : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < TG_FRAME_POINTS; ++i) {
      if (vq[i] >= pts) break;
#pragma unroll
      for (int k = 0; k < TG_FRAME_CHUNK; ++k) {
        if (k >= C) break;
        update(vq[i], vy[i], vx[i], k, dk[i][k], ak[i][k], pk[i][k], bk[i][k]);
      }
    }
    w = u;  // the loop's step moves past the last point taken
  }
  return acc;
}

// Phase 2 of tg_solve in the hbm layout on an LM reset iteration:
// delta += alpha p (its ring to the output array), a grid barrier,
// delta's haloed copy in Ap's frame (the neighbours' ring from the output
// array), then r = b - (A delta + ctc delta), the partials of <z, r> and <delta, b + r> and r's ring, the
// resident loop's arithmetic in its order. Each walk loads TG_FRAME_POINTS
// points before it stores any, and the stencil reads its fields and delta
// TG_RESET_CHUNK triples at a time (tg_sum_triples), so that the loads are
// in flight together.
#define TG_RESET_CHUNK 8
template <typename FT>
__device__ __forceinline__ double2 tg_reset_frames(
    cg::grid_group& grid, const TgTile& tt, const FT* __restrict__ F,
    const float* __restrict__ b, const float* __restrict__ pre, const float* __restrict__ ctc,
    float alpha, int C, float* __restrict__ d, float* __restrict__ ap,
    float* __restrict__ delta, float* __restrict__ r_ring) {
  const int N1 = tt.N1, N2 = tt.N2, plane = tt.plane, y0 = tt.y0, x0 = tt.x0;
  const int rows = tt.rows, cols = tt.cols, pts = tt.pts, pcols = tt.pcols, ext = tt.ext;
  const int h = tt.h;
  for (TgWalk w(cols); w.q < pts; w.next(cols)) {
    int vq[TG_FRAME_POINTS], vy[TG_FRAME_POINTS], vx[TG_FRAME_POINTS];
    float dk[TG_FRAME_POINTS][TG_FRAME_CHUNK];
    TgWalk u = w;
#pragma unroll
    for (int i = 0; i < TG_FRAME_POINTS; ++i) {
      if (i > 0) u.next(cols);
      vq[i] = u.q;
      vy[i] = u.y;
      vx[i] = u.x;
      const int q = u.q < pts ? u.q : w.q;  // else read the first point's places
#pragma unroll
      for (int k = 0; k < TG_FRAME_CHUNK; ++k) dk[i][k] = d[min(k, C - 1) * pts + q];
    }
#pragma unroll
    for (int i = 0; i < TG_FRAME_POINTS; ++i) {
      if (vq[i] >= pts) break;
      const int gq = (y0 + vy[i]) * N2 + x0 + vx[i];
      const int e = (vy[i] + h) * pcols + vx[i] + h;
      const bool ring = vy[i] < h || vy[i] >= rows - h || vx[i] < h || vx[i] >= cols - h;
#pragma unroll
      for (int k = 0; k < TG_FRAME_CHUNK; ++k) {
        if (k >= C) break;
        const float dv = __fadd_rn(dk[i][k], __fmul_rn(alpha, tt.s_pe[k * ext + e]));
        d[k * pts + vq[i]] = dv;
        if (ring) delta[k * plane + gq] = dv;
      }
    }
    w = u;
  }
  grid.sync();  // the stencil below reads the neighbours' delta
  for (TgWalk w(pcols); w.q < ext; w.next(pcols)) {
    int vq[TG_FRAME_POINTS];
    float dk[TG_FRAME_POINTS][TG_FRAME_CHUNK];
    TgWalk u = w;
#pragma unroll
    for (int i = 0; i < TG_FRAME_POINTS; ++i) {
      if (i > 0) u.next(pcols);
      vq[i] = u.q;
      const int gy = y0 + u.y - h, gx = x0 + u.x - h;
      const bool in_grid = u.q < ext && gy >= 0 && gy < N1 && gx >= 0 && gx < N2;
      const bool inner = u.y >= h && u.y < h + rows && u.x >= h && u.x < h + cols;
      const int t = (u.y - h) * cols + (u.x - h);
#pragma unroll
      for (int k = 0; k < TG_FRAME_CHUNK; ++k) {
        const int c = min(k, C - 1);
        dk[i][k] = !in_grid ? 0.f
                   : inner  ? d[c * pts + t]
                            : __ldcg(delta + c * plane + gy * N2 + gx);
      }
    }
#pragma unroll
    for (int i = 0; i < TG_FRAME_POINTS; ++i) {
      if (vq[i] >= ext) break;
#pragma unroll
      for (int k = 0; k < TG_FRAME_CHUNK; ++k) {
        if (k >= C) break;
        ap[k * ext + vq[i]] = dk[i][k];
      }
    }
    w = u;
  }
  __syncthreads();
  double2 acc = make_double2(0.0, 0.0);
  for (TgWalk w(cols); w.q < pts; w.next(cols)) {
    const int gq = (y0 + w.y) * N2 + x0 + w.x;
    const int e = (w.y + h) * pcols + w.x + h;
    const bool ring = w.y < h || w.y >= rows - h || w.x < h || w.x >= cols - h;
    float dv[4], cv[4], bv[4], pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = min(i, C - 1);
      dv[i] = d[c * pts + w.q];
      cv[i] = ctc[c * plane + gq];
      bv[i] = b[c * plane + gq];
      pv[i] = pre[c * plane + gq];
    }
    tg_sum_triples<TG_RESET_CHUNK, true>(F, ap, tt, C, gq, e, [&](int c, float a) {
      const float dc = tg_pick4(dv, c), bc = tg_pick4(bv, c);
      a = __fadd_rn(a, __fmul_rn(tg_pick4(cv, c), dc));
      const float rv = __fsub_rn(bc, a);
      tt.s_r[c * pts + w.q] = rv;
      acc.x += (double)__fmul_rn(__fmul_rn(tg_pick4(pv, c), rv), rv);
      acc.y += (double)__fmul_rn(dc, __fadd_rn(bc, rv));
      if (ring) r_ring[c * plane + gq] = rv;
    });
  }
  return acc;
}

// Phase 3 of tg_solve in the hbm layout: p = z + beta p over the tile and
// its halo, z = pre*r from the tile's r or, on the halo, from the
// neighbours' r ring (p stays 0 beyond the grid), the resident loop's
// arithmetic. The thread loads TG_FRAME_POINTS points' pre and r of every
// channel before it updates any, so that those loads are in flight
// together; nothing is summed here, so the order is free. The channels go
// in chunks of TG_FRAME_CHUNK, one chunk for every C the layout takes:
// written without that loop, the GN instance spilled 64 B at its 128
// registers and ran 4-5% slower an iteration on the H100 (PERF.md).
__device__ __forceinline__ void tg_p_frames(const TgTile& tt, const float* __restrict__ pre,
                                            const float* __restrict__ r_ring, float beta,
                                            int C) {
  const int N1 = tt.N1, N2 = tt.N2, plane = tt.plane, y0 = tt.y0, x0 = tt.x0;
  const int rows = tt.rows, cols = tt.cols, pts = tt.pts, pcols = tt.pcols, ext = tt.ext;
  const int h = tt.h;
  for (TgWalk w(pcols); w.q < ext; w.next(pcols)) {
    int vq[TG_FRAME_POINTS], gq[TG_FRAME_POINTS], t[TG_FRAME_POINTS];
    bool live[TG_FRAME_POINTS], inner[TG_FRAME_POINTS];
    TgWalk u = w;
#pragma unroll
    for (int i = 0; i < TG_FRAME_POINTS; ++i) {
      if (i > 0) u.next(pcols);
      const int gy = y0 + u.y - h, gx = x0 + u.x - h;
      vq[i] = u.q;
      live[i] = u.q < ext && gy >= 0 && gy < N1 && gx >= 0 && gx < N2;
      inner[i] = u.y >= h && u.y < h + rows && u.x >= h && u.x < h + cols;
      t[i] = (u.y - h) * cols + (u.x - h);
      gq[i] = live[i] ? gy * N2 + gx : 0;
    }
    for (int c0 = 0; c0 < C; c0 += TG_FRAME_CHUNK) {
      float pk[TG_FRAME_POINTS][TG_FRAME_CHUNK], rk[TG_FRAME_POINTS][TG_FRAME_CHUNK];
#pragma unroll
      for (int i = 0; i < TG_FRAME_POINTS; ++i) {
#pragma unroll
        for (int k = 0; k < TG_FRAME_CHUNK; ++k) {
          const int c = min(c0 + k, C - 1);
          pk[i][k] = pre[c * plane + gq[i]];
          rk[i][k] = !live[i] ? 0.f
                     : inner[i] ? tt.s_r[c * pts + t[i]]
                                : __ldcg(r_ring + c * plane + gq[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < TG_FRAME_POINTS; ++i) {
        if (!live[i]) continue;
#pragma unroll
        for (int k = 0; k < TG_FRAME_CHUNK; ++k) {
          const int c = c0 + k;
          if (c >= C) break;
          float* pp = tt.s_pe + c * ext + vq[i];
          *pp = __fadd_rn(__fmul_rn(pk[i][k], rk[i][k]), __fmul_rn(beta, *pp));
        }
      }
    }
    w = u;
  }
}

// One CG solve of C channels on the grid [N1, N2] by every block of the
// launch, each on its tile: F, b, pre (under BLOCK the C*C planes), ctc and
// delta are the system's own. Returns the executed iteration count, the
// same in every block. Under HBM (the hbm layout) delta and Ap lie in the
// block's device frame: phase 1 is tg_apply_frames, phase 2
// tg_update_frames (on an LM reset tg_reset_frames) and phase 3
// tg_p_frames.
template <bool LM, bool BLOCK, typename FT, bool HBM>
__device__ __forceinline__ int tg_solve(cg::grid_group& grid, const TgTile& tt,
                                        const FT* __restrict__ F,
                                        const float* __restrict__ b,
                                        const float* __restrict__ pre,
                                        const float* __restrict__ ctc, int C, int lits,
                                        float tol, int guard_div, int reset_period,
                                        float q_tol, float* delta, float* r_ring,
                                        double2* partA, double2* partB) {
  double2* s_warp = tt.s_warp;
  double2* s_bcast = tt.s_bcast;
  float* s_r = tt.s_r;
  float* s_d = tt.s_d;
  float* s_pe = tt.s_pe;
  float* s_ap = tt.s_ap;
  float* s_m = tt.s_m;
  const int* s_f = tt.s_f;
  const int* s_p = tt.s_p;
  const int* s_start = tt.s_start;
  const int N1 = tt.N1, N2 = tt.N2, plane = tt.plane, y0 = tt.y0, x0 = tt.x0;
  const int rows = tt.rows, cols = tt.cols, pts = tt.pts, pcols = tt.pcols;
  const int ext = tt.ext, h = tt.h, n_blocks = tt.n_blocks;

  // r = b, delta = 0 on the tile; p = M^-1 b on the tile and its halo (0
  // beyond the grid); rz0 = <r, p>. Under BLOCK the point's C*C planes are
  // staged here, once a solve, and read from shared memory after.
  double2 acc = make_double2(0.0, 0.0);
  for (TgWalk w(pcols); w.q < ext; w.next(pcols)) {
    const int gy = y0 + w.y - h, gx = x0 + w.x - h;
    const bool in_grid = gy >= 0 && gy < N1 && gx >= 0 && gx < N2;
    const bool inner = w.y >= h && w.y < h + rows && w.x >= h && w.x < h + cols;
    const int t = (w.y - h) * cols + (w.x - h);
    const int gq = gy * N2 + gx;
    if constexpr (BLOCK)
      for (int k = 0; k < C * C; ++k)
        s_m[k * ext + w.q] = in_grid ? pre[k * plane + gq] : 0.f;
    for (int c = 0; c < C; ++c) {
      float zv = 0.f;
      if (in_grid) {
        zv = tg_z<BLOCK, false>(BLOCK ? s_m + w.q : pre + gq, BLOCK ? ext : plane, b + gq,
                                plane, C, c);
        if (inner) {
          const float bv = b[c * plane + gq];
          s_r[c * pts + t] = bv;
          s_d[c * pts + t] = 0.f;
          acc.x += (double)__fmul_rn(bv, zv);
        }
      }
      s_pe[c * ext + w.q] = zv;
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
    // phase 1: Ap = A p (+ ctc p) on the tile, the partials of <p, Ap>
    acc = make_double2(0.0, 0.0);
    if constexpr (HBM) {
      acc = tg_apply_frames<LM>(tt, F, ctc, s_ap, C);
    } else {
      for (TgWalk w(cols); w.q < pts; w.next(cols)) {
        const int gq = (y0 + w.y) * N2 + x0 + w.x;
        const int e = (w.y + h) * pcols + w.x + h;
        for (int c = 0; c < C; ++c) {
          // ctc is read before the stencil's chain of sums, so its latency
          // overlaps the chain's
          const float cv = LM ? ctc[c * plane + gq] : 0.f;
          float a = tg_stencil(F, s_pe, s_f, s_p, s_start[c], s_start[c + 1], gq, e);
          const float pv = s_pe[c * ext + e];
          if constexpr (LM) a = __fadd_rn(a, __fmul_rn(cv, pv));
          s_ap[c * pts + w.q] = a;
          acc.x += (double)__fmul_rn(pv, a);
        }
      }
    }
    acc = tg_block_sum(acc, s_warp);
    if (threadIdx.x == 0) partA[blockIdx.x] = acc;
    grid.sync();
    const float den = (float)tg_partials_sum(partA, n_blocks, s_bcast).x;
    const float alpha = tg_safe_div(rz, den, guard_div);

    // phase 2: delta += alpha p; r -= alpha Ap, or on an LM reset iteration
    // r = b - (A delta + ctc delta); the partials of <z, r> (z = M^-1 r) and,
    // under LM, of <delta, b + r>; r's ring to r_ring
    bool reset = false;
    if constexpr (LM) reset = (l + 1) % reset_period == 0;
    acc = make_double2(0.0, 0.0);
    if constexpr (HBM) {
      if (!reset)
        acc = tg_update_frames<LM>(tt, s_d, s_ap, pre, b, alpha, C, r_ring);
      else if constexpr (LM)
        acc = tg_reset_frames(grid, tt, F, b, pre, ctc, alpha, C, s_d, s_ap, delta, r_ring);
    } else if (!reset) {
      for (TgWalk w(cols); w.q < pts; w.next(cols)) {
        const int gq = (y0 + w.y) * N2 + x0 + w.x;
        const int e = (w.y + h) * pcols + w.x + h;
        const bool ring = w.y < h || w.y >= rows - h || w.x < h || w.x >= cols - h;
        for (int c = 0; c < C; ++c) {
          const int t = c * pts + w.q;
          const int g = c * plane + gq;
          const float dv = __fadd_rn(s_d[t], __fmul_rn(alpha, s_pe[c * ext + e]));
          s_d[t] = dv;
          const float rv = __fsub_rn(s_r[t], __fmul_rn(alpha, s_ap[t]));
          s_r[t] = rv;
          if constexpr (!BLOCK) {
            const float zv = __fmul_rn(pre[g], rv);
            s_ap[t] = zv;  // for the p update
            acc.x += (double)__fmul_rn(zv, rv);
          }
          if constexpr (LM) acc.y += (double)__fmul_rn(dv, __fadd_rn(b[g], rv));
          if (ring) r_ring[g] = rv;
        }
        if constexpr (BLOCK) {
          // z at the point needs every channel's r there: after the update
          for (int i = 0; i < C; ++i) {
            const float zv = tg_z<true, false>(s_m + e, ext, s_r + w.q, pts, C, i);
            acc.x += (double)__fmul_rn(zv, s_r[i * pts + w.q]);
            s_ap[i * pts + w.q] = zv;  // for the p update
          }
        }
      }
    } else {
      for (TgWalk w(cols); w.q < pts; w.next(cols)) {
        const int gq = (y0 + w.y) * N2 + x0 + w.x;
        const int e = (w.y + h) * pcols + w.x + h;
        const bool ring = w.y < h || w.y >= rows - h || w.x < h || w.x >= cols - h;
        for (int c = 0; c < C; ++c) {
          const int t = c * pts + w.q;
          const float dv = __fadd_rn(s_d[t], __fmul_rn(alpha, s_pe[c * ext + e]));
          s_d[t] = dv;
          if (ring) delta[c * plane + gq] = dv;
        }
      }
      grid.sync();  // the stencil below reads the neighbours' delta
      for (TgWalk w(pcols); w.q < ext; w.next(pcols)) {
        const int gy = y0 + w.y - h, gx = x0 + w.x - h;
        const bool in_grid = gy >= 0 && gy < N1 && gx >= 0 && gx < N2;
        const bool inner = w.y >= h && w.y < h + rows && w.x >= h && w.x < h + cols;
        const int t = (w.y - h) * cols + (w.x - h);
        for (int c = 0; c < C; ++c) {
          float dv = 0.f;
          if (inner) dv = s_d[c * pts + t];
          else if (in_grid) dv = __ldcg(delta + c * plane + gy * N2 + gx);
          s_ap[c * ext + w.q] = dv;
        }
      }
      __syncthreads();
      for (TgWalk w(cols); w.q < pts; w.next(cols)) {
        const int gq = (y0 + w.y) * N2 + x0 + w.x;
        const int e = (w.y + h) * pcols + w.x + h;
        const bool ring = w.y < h || w.y >= rows - h || w.x < h || w.x >= cols - h;
        for (int c = 0; c < C; ++c) {
          const int t = c * pts + w.q;
          const int g = c * plane + gq;
          const float dv = s_d[t];
          const float cv = ctc[g];
          const float bv = b[g];
          float a = tg_stencil(F, s_ap, s_f, s_p, s_start[c], s_start[c + 1], gq, e);
          a = __fadd_rn(a, __fmul_rn(cv, dv));
          const float rv = __fsub_rn(bv, a);
          s_r[t] = rv;
          if constexpr (!BLOCK) acc.x += (double)__fmul_rn(__fmul_rn(pre[g], rv), rv);
          acc.y += (double)__fmul_rn(dv, __fadd_rn(bv, rv));
          if (ring) r_ring[g] = rv;
        }
        if constexpr (BLOCK) {
          // z is not kept (Ap's space holds delta's haloed copy, which the
          // neighbouring points' stencils still read): phase 3 forms it again
          for (int i = 0; i < C; ++i)
            acc.x += (double)__fmul_rn(
                tg_z<true, false>(s_m + e, ext, s_r + w.q, pts, C, i),
                s_r[i * pts + w.q]);
        }
      }
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

    // phase 3: p = z + beta p on the tile (z kept in Ap's space; M^-1 r
    // after a reset) and on its halo (M^-1 times the neighbours' r ring)
    if constexpr (HBM) {
      tg_p_frames(tt, pre, r_ring, beta, C);
    } else {
      for (TgWalk w(pcols); w.q < ext; w.next(pcols)) {
        const int gy = y0 + w.y - h, gx = x0 + w.x - h;
        if (gy < 0 || gy >= N1 || gx < 0 || gx >= N2) continue;  // stays 0
        const bool inner = w.y >= h && w.y < h + rows && w.x >= h && w.x < h + cols;
        const int t = (w.y - h) * cols + (w.x - h);
        const int gq = gy * N2 + gx;
        const float* m = BLOCK ? s_m + w.q : pre + gq;  // the point's first plane
        const int ms = BLOCK ? ext : plane;
        for (int c = 0; c < C; ++c) {
          float zv;
          if (!inner) zv = tg_z<BLOCK, true>(m, ms, r_ring + gq, plane, C, c);
          else if (reset) zv = tg_z<BLOCK, false>(m, ms, s_r + t, pts, C, c);
          else zv = s_ap[c * pts + t];
          float* pp = s_pe + c * ext + w.q;
          *pp = __fadd_rn(zv, __fmul_rn(beta, *pp));
        }
      }
    }
    __syncthreads();
  }

  for (TgWalk w(cols); w.q < pts; w.next(cols)) {
    const int gq = (y0 + w.y) * N2 + x0 + w.x;
    for (int c = 0; c < C; ++c) delta[c * plane + gq] = s_d[c * pts + w.q];
  }
  return l;
}

// The kernel, block k owning tile (k / tiles_c, k % tiles_c) of the ceil
// split of the grid [N1, N2] into th x tw tiles with a halo of h. delta
// receives the solution (and, on LM reset iterations, delta's rings);
// r_ring is scratch of one system's size, of which each block writes only
// its ring; partA and partB hold one record a block. Under HBM (one
// system, float32 fields, Jacobi) delta and Ap live in frames, scratch of
// C*(th*tw) floats for delta and C*(th*tw) (under LM C*(th+2h)*(tw+2h))
// for Ap a block, block k's frame at k times their sum; only r, p and the
// records stay in shared memory (tg_smem_bytes' hbm layout). Each thread
// reads back from the frames what the walks of tg_solve wrote there; where
// another thread wrote it, a barrier of the block or the grid lies between.
// Under BLOCK pre holds the C*C planes of M^-1 (plane i*C + j: M^-1[i][j]).
// The launch holds
// n_sys independent systems of C channels (1 for one system; 1 under
// bfloat16 fields), solved in turn: system s reads its fields at
// F + s*f_stride, b, ctc and the elementwise pre at s*C planes (the C*C
// planes at s*C*C planes), writes delta at s*C planes and its count to
// iters[s]; a grid barrier before each system after the first frees the
// partial records, r_ring and the tile's shared memory for it. Without
// MULTI n_sys is 1 (BLOCK implies MULTI: one kernel for both).
template <bool LM, bool BLOCK, typename FT, bool MULTI, bool HBM>
__global__ void __launch_bounds__(TGCG_THREADS, 1)
tiled_grid_cg_kernel(const FT* __restrict__ F, const float* __restrict__ b,
                     const float* __restrict__ pre,
                     const float* __restrict__ ctc,
                     const int* __restrict__ triples,
                     const int* __restrict__ starts, int C, int n_triples,
                     int N1, int N2, int tiles_c, int th, int tw, int h,
                     int lits, float tol, int guard_div, int reset_period,
                     float q_tol, int n_sys, int f_stride, float* delta,
                     float* r_ring, double2* partA, double2* partB, int* iters,
                     float* frames) {
  extern __shared__ double2 smem[];
  const int pts_max = th * tw;
  const int ext_max = (th + 2 * h) * (tw + 2 * h);
  TgTile tt;
  tt.s_warp = smem;
  tt.s_bcast = smem + TGCG_WARPS;
  tt.s_r = (float*)(smem + TGCG_WARPS + 1);
  int* s_f;
  if constexpr (HBM) {
    tt.s_pe = tt.s_r + C * pts_max;  // p, haloed
    tt.s_d = frames + (size_t)blockIdx.x * C * (pts_max + (LM ? ext_max : pts_max));
    tt.s_ap = tt.s_d + C * pts_max;  // Ap; under LM also haloed delta
    tt.s_m = nullptr;
    s_f = (int*)(tt.s_pe + C * ext_max);
  } else {
    tt.s_d = tt.s_r + C * pts_max;
    tt.s_pe = tt.s_d + C * pts_max;                     // p, haloed
    tt.s_ap = tt.s_pe + C * ext_max;                    // Ap; z; under LM also haloed delta
    tt.s_m = tt.s_ap + C * (LM ? ext_max : pts_max);    // under BLOCK: the C*C planes
    s_f = (int*)(tt.s_m + (BLOCK ? C * C * ext_max : 0));
  }
  tg_tile_setup(tt, triples, starts, C, n_triples, N1, N2, tiles_c, th, tw, h, s_f,
                s_f + n_triples, s_f + 2 * n_triples);

  cg::grid_group grid = cg::this_grid();
  if constexpr (MULTI) {
    const int vec = C * tt.plane;               // one system's vector
    const int pre_vec = BLOCK ? C * vec : vec;  // and its preconditioner planes
    for (int s = 0; s < n_sys; ++s) {
      if (s > 0) grid.sync();  // every block is done with the last system
      const int l = tg_solve<LM, BLOCK, FT, HBM>(
          grid, tt, F + s * f_stride, b + s * vec, pre + s * pre_vec,
          LM ? ctc + s * vec : ctc, C, lits, tol, guard_div, reset_period, q_tol,
          delta + s * vec, r_ring, partA, partB);
      if (blockIdx.x == 0 && threadIdx.x == 0) iters[s] = l;
    }
  } else {
    const int l = tg_solve<LM, BLOCK, FT, HBM>(grid, tt, F, b, pre, ctc, C, lits, tol,
                                               guard_div, reset_period, q_tol, delta, r_ring,
                                               partA, partB);
    if (blockIdx.x == 0 && threadIdx.x == 0) *iters = l;
  }
}

// The ten instances: GN and LM, each with float32 fields and the
// elementwise preconditioner, one system and several in turn (`multi`),
// one system in the hbm layout, with block-Jacobi (one kernel for both)
// and with bfloat16 fields (one system); null for bf16 with block-Jacobi
// or several systems, and for the hbm layout with any of these, which no
// instance takes.
static const void* tiled_instance(int lm, int block, int bf16, int multi, int hbm) {
  if (hbm)
    return block || bf16 || multi ? nullptr
           : lm ? (const void*)tiled_grid_cg_kernel<true, false, float, false, true>
                : (const void*)tiled_grid_cg_kernel<false, false, float, false, true>;
  if (block)
    return bf16 ? nullptr
           : lm ? (const void*)tiled_grid_cg_kernel<true, true, float, true, false>
                : (const void*)tiled_grid_cg_kernel<false, true, float, true, false>;
  if (bf16)
    return multi ? nullptr
           : lm  ? (const void*)tiled_grid_cg_kernel<true, false, __nv_bfloat16, false, false>
                 : (const void*)tiled_grid_cg_kernel<false, false, __nv_bfloat16, false, false>;
  if (multi)
    return lm ? (const void*)tiled_grid_cg_kernel<true, false, float, true, false>
              : (const void*)tiled_grid_cg_kernel<false, false, float, true, false>;
  return lm ? (const void*)tiled_grid_cg_kernel<true, false, float, false, false>
            : (const void*)tiled_grid_cg_kernel<false, false, float, false, false>;
}

// tiled_grid.cuh describes it
int tg_launch(const void* kernel, void** args, int C, int n_triples, int N1, int N2,
              int tiles_r, int tiles_c, int th, int tw, int h, long long need,
              int threads, int smem_bytes, void* stream) {
  if (kernel == nullptr || threads != TGCG_THREADS || C < 1 || C > TGCG_MAX_CHANNELS ||
      n_triples < 1 || n_triples > TGCG_MAX_TRIPLES || tiles_r < 1 ||
      tiles_c < 1 || h < 0 || th < (h > 1 ? h : 1) || tw < (h > 1 ? h : 1) ||
      (tiles_r - 1) * th >= N1 || (tiles_c - 1) * tw >= N2 ||
      N1 - (tiles_r - 1) * th < h || N2 - (tiles_c - 1) * tw < h ||
      tiles_r * th < N1 || tiles_c * tw < N2 || (long long)smem_bytes != need)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const int grid = tiles_r * tiles_c;
  if (grid > per_sm * sms) return (int)cudaErrorCooperativeLaunchTooLarge;
  e = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(threads), args,
                                  (size_t)smem_bytes, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" {

// The current device's SM count and the shared memory a block may opt in
// to (bytes), for the planner (ops/fused_cg.py::tiled_grid_plan).
int tiled_grid_cg_device_limits(int* sms, int* smem_per_block) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(smem_per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  return (int)e;
}

// Launches one solve on `stream`: tiles_r x tiles_c blocks of `threads`
// threads, each with smem_bytes of dynamic shared memory (which must be
// tg_smem_bytes of these arguments; under `hbm`, the hbm layout's, with
// `frames` the blocks' device frames of delta and Ap, tiles_r*tiles_c*C*
// (th*tw + th*tw, or under LM (th+2h)*(tw+2h)) floats; null otherwise, when
// it is not read). n_sys systems of C channels (n_sys = 1 without `multi`
// or `block`; `multi` is not taken under bf16 or hbm): F
// [T, N1, N2] shared by the systems (f_stride 0: the
// per-channel split, C = 1) or [n_sys, T, N1, N2] (f_stride = T*N1*N2: a
// batch), bfloat16 under bf16, else float32; b, ctc (LM only) and delta
// [n_sys, C, N1, N2] float32, pre [n_sys, C, N1, N2] or under `block`
// [n_sys, C*C, N1, N2]; r_ring [C, N1, N2], one system's; triples
// [n_triples, 6] sorted by output channel with their per-channel starts
// [C + 1]; partA and partB tiles_r*tiles_c double2 records each; iters
// n_sys ints. Returns the CUDA error (tg_launch's; cudaErrorInvalidValue
// too for bf16 with block or multi, hbm with block, bf16 or multi, or hbm
// without frames or with more than TG_FRAME_CHUNK channels, which no
// instance takes).
int tiled_grid_cg_launch(int lm, int block, int bf16, int multi, int hbm, const void* F,
                         const float* b,
                         const float* pre, const float* ctc,
                         const int* triples, const int* starts, int C,
                         int n_triples, int N1, int N2, int tiles_r,
                         int tiles_c, int th, int tw, int h, int lits,
                         float tol, int guard_div, int reset_period,
                         float q_tol, int n_sys, int f_stride, float* delta, float* r_ring,
                         double2* partA, double2* partB, int* iters, float* frames,
                         int threads, int smem_bytes, void* stream) {
  if (lm && (ctc == nullptr || reset_period < 1)) return (int)cudaErrorInvalidValue;
  if (hbm && (frames == nullptr || C > TG_FRAME_CHUNK)) return (int)cudaErrorInvalidValue;
  if (n_sys < 1 || f_stride < 0 || (!multi && !block && n_sys != 1))
    return (int)cudaErrorInvalidValue;
  void* args[] = {(void*)&F,        (void*)&b,       (void*)&pre,
                  (void*)&ctc,      (void*)&triples, (void*)&starts,
                  (void*)&C,        (void*)&n_triples,
                  (void*)&N1,       (void*)&N2,      (void*)&tiles_c,
                  (void*)&th,       (void*)&tw,      (void*)&h,
                  (void*)&lits,     (void*)&tol,     (void*)&guard_div,
                  (void*)&reset_period, (void*)&q_tol,
                  (void*)&n_sys,    (void*)&f_stride,
                  (void*)&delta,    (void*)&r_ring,  (void*)&partA,
                  (void*)&partB,    (void*)&iters,   (void*)&frames};
  return tg_launch(tiled_instance(lm, block, bf16, multi, hbm), args, C, n_triples, N1, N2,
                   tiles_r, tiles_c, th, tw, h,
                   tg_smem_bytes(lm, block, 0, hbm, C, th, tw, h, n_triples), threads,
                   smem_bytes, stream);
}

}  // extern "C"
