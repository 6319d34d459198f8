// Whole-loop Chronopoulos-Gear PCG for a 2-D grid stencil operator whose
// state fits the card's shared memory: one persistent cooperative launch per
// CG solve, one block a tile, one grid barrier an iteration, for Hopper
// (sm_90a). Two instances, tiled_grid_cs_kernel<LM>: the Gauss-Newton and
// the Levenberg-Marquardt loop of fused_grid_cg.cuh (lines 79-91), float32
// fields, the Jacobi preconditioner, one system. Their launches count, in
// ops/fused_cg.py, as gn_cs_tiled and lm_cs_tiled; tiled_grid_cs_launch
// starts them.
//
// Replaces, in opt_tpu/ops/pallas_cg.py: _kernel (:328) in its cs=True form
// (_run_cg's gn_cs_body :260 and lm_cs_body :278), 2-D grids, at the grid
// sizes whose state fits one tile a block (ops/fused_cg.py::tiled_grid_plan).
// The other CS forms (block-Jacobi, bfloat16 fields, a batch, 3-D grids,
// graphs) run the template of fused_grid_cg.cuh.
//
// The loop, with p = s = delta = 0, gamma = alpha_prev = 1:
//   u = M^-1 r;  w = A u (+ ctc*u);  gamma_new = <r, u>;  dd = <u, w>
//   LM: Q = 0.5*<delta, b + r>,  zeta = (l*(Q - Q0))/Q
//   stop (not on the first iteration): gamma_new <= tol*gamma_0 (LM: or
//     zeta < q_tol): leave, this iteration uncounted
//   beta = first ? 0 : gamma_new/gamma;  den = dd - beta*(gamma_new/alpha_prev)
//   used = first ? dd : den;  alpha = gamma_new/used (all guarded)
//   p = u + beta*p;  s = w + beta*s;  delta += alpha*p;  r -= alpha*s
//   l += 1;  exit when used <= 0;  LM when l % reset_period == 0:
//   r = b - (A*delta + ctc*delta)
// The floor's gamma_0 = <b, M^-1 b> is the first iteration's gamma_new.
//
// The arithmetic is the template's and the twin's (ops/fused_cg.py::_run_cs):
// float32 products and sums with explicit round-to-nearest intrinsics and no
// fused multiply-add, each stencil sum from +0 over the output channel's
// triples in their order, each dot as float32 products summed in double. The
// kernel is therefore bitwise equal to the template's gn_cs/lm_cs and to the
// plain PyTorch twin (fused_grid_cg_reference(..., cs=True)).
//
// What bounds it: the bytes of the inputs, as the standard tiled kernel
// (the fields at every point, pre and, under LM, ctc and b an iteration).
// Its floor with almost no work is its grid barriers and dot sums, a third
// of poisson 512x512x4's time an iteration in the standard kernel, which
// takes two barriers an iteration. The point of Chronopoulos-Gear is that an
// iteration's dots are independent, so here an iteration takes one.
//
// What the design does about it:
//   * The tiles, the block of 512 threads and the walks are the standard
//     tiled kernel's (tiled_grid.cuh).
//   * State: each block keeps r, s and u over its tile and its h-halo, p
//     and delta over the tile and, under LM (whose reset applies A to
//     delta), its halo, and w over the tile, all in dynamic shared memory
//     for the whole solve, zero beyond the grid's edge.
//   * Phase A: w = A u (+ ctc u) over the tile from the haloed u, the
//     partials of gamma, dd (and Q) from the tile's own points, and w's
//     h-wide ring to a grid-sized array. Then the one grid barrier.
//   * Phase B: every block sums the partials in the one fixed order, so
//     every block takes the same exit; then it updates s, p, delta and r
//     over its tile and its halo (s = w + beta*s on the halo from the
//     neighbours' w rings) and forms u = M^-1 r there. Every halo value is
//     the owner's arithmetic on bit-equal inputs, so it stays bitwise equal
//     to the owner's; that holds by induction from r = b and p = s = delta =
//     0, which each block forms on its halo from b: the start needs no
//     exchange, and p, s, r and delta are never exchanged.
//   * Races: a fast block writes iteration k+1's w ring and partials while a
//     slow one may still read iteration k's, so two w-ring buffers and two
//     partial buffers alternate by the iteration's parity. A buffer is
//     written again two iterations later, after a barrier that every reader
//     of its old contents has passed.
//   * An LM reset iteration (r = b - (A delta + ctc delta) every
//     reset_period): r over the tile from delta's haloed copy, which needs
//     no barrier; r's ring to r_ring, a second barrier, and the halo's r
//     from the neighbours' rings before u. A reset iteration takes two
//     barriers, the others one.
//   * Dot records: GN's two dots in one double2 a block; LM's three in two
//     (gamma, dd; Q), each summed in the one fixed order of tiled_cg.cuh.

#include "tiled_grid.cuh"

// One Chronopoulos-Gear solve of C channels on the grid [N1, N2] by every
// block of the launch, each on its tile. Returns the executed iteration
// count, the same in every block.
template <bool LM>
__device__ __forceinline__ int tg_solve_cs(cg::grid_group& grid, const TgTile& tt,
                                           const float* __restrict__ F,
                                           const float* __restrict__ b,
                                           const float* __restrict__ pre,
                                           const float* __restrict__ ctc, int C, int lits,
                                           float tol, int guard_div, int reset_period,
                                           float q_tol, float* delta, float* r_ring,
                                           float* w_ring, double2* partA, double2* partB) {
  double2* s_warp = tt.s_warp;
  double2* s_bcast = tt.s_bcast;
  float* s_r = tt.s_r;
  float* s_s = tt.s_s;
  float* s_u = tt.s_u;
  float* s_p = tt.s_pe;
  float* s_d = tt.s_d;
  float* s_w = tt.s_ap;
  const int* s_f = tt.s_f;
  const int* s_p_off = tt.s_p;
  const int* s_start = tt.s_start;
  const int N1 = tt.N1, N2 = tt.N2, plane = tt.plane, y0 = tt.y0, x0 = tt.x0;
  const int rows = tt.rows, cols = tt.cols, pts = tt.pts, pcols = tt.pcols;
  const int ext = tt.ext, h = tt.h, n_blocks = tt.n_blocks;
  const int fs = LM ? ext : pts;  // the frame of p and delta: haloed under LM

  // r = b, u = M^-1 b, s = p = delta = 0 over the tile and its halo, 0
  // beyond the grid
  for (TgWalk w(pcols); w.q < ext; w.next(pcols)) {
    const int gy = y0 + w.y - h, gx = x0 + w.x - h;
    const bool in_grid = gy >= 0 && gy < N1 && gx >= 0 && gx < N2;
    const bool inner = w.y >= h && w.y < h + rows && w.x >= h && w.x < h + cols;
    const int gq = gy * N2 + gx;
    const int pi = LM ? w.q : (w.y - h) * cols + (w.x - h);
    for (int c = 0; c < C; ++c) {
      float rv = 0.f, uv = 0.f;
      if (in_grid) {
        rv = b[c * plane + gq];
        uv = __fmul_rn(pre[c * plane + gq], rv);
      }
      s_r[c * ext + w.q] = rv;
      s_u[c * ext + w.q] = uv;
      s_s[c * ext + w.q] = 0.f;
      if (LM || inner) {
        s_p[c * fs + pi] = 0.f;
        s_d[c * fs + pi] = 0.f;
      }
    }
  }
  __syncthreads();
  float floor_rz = 0.f, gamma = 1.f, alpha_prev = 1.f, q0 = 0.f;
  int l = 0;

  while (l < lits) {
    // this iteration's w ring and partial records, by its parity
    float* wr = w_ring + (l & 1) * C * plane;
    double2* part = (l & 1) ? partB : partA;

    // phase A: w = A u (+ ctc u) on the tile, the partials of <r, u>,
    // <u, w> and, under LM, <delta, b + r>; w's ring to wr
    double2 acc = make_double2(0.0, 0.0), acc_q = make_double2(0.0, 0.0);
    for (TgWalk w(cols); w.q < pts; w.next(cols)) {
      const int gq = (y0 + w.y) * N2 + x0 + w.x;
      const int e = (w.y + h) * pcols + w.x + h;
      const bool ring = w.y < h || w.y >= rows - h || w.x < h || w.x >= cols - h;
      for (int c = 0; c < C; ++c) {
        const int g = c * plane + gq;
        // ctc and b are read before the stencil's chain of sums, so their
        // latency overlaps the chain's
        const float cv = LM ? ctc[g] : 0.f;
        const float bv = LM ? b[g] : 0.f;
        float a = tg_stencil(F, s_u, s_f, s_p_off, s_start[c], s_start[c + 1], gq, e);
        const float uv = s_u[c * ext + e];
        if constexpr (LM) a = __fadd_rn(a, __fmul_rn(cv, uv));
        s_w[c * pts + w.q] = a;
        const float rv = s_r[c * ext + e];
        acc.x += (double)__fmul_rn(rv, uv);
        acc.y += (double)__fmul_rn(uv, a);
        if constexpr (LM) acc_q.x += (double)__fmul_rn(s_d[c * ext + e], __fadd_rn(bv, rv));
        if (ring) wr[g] = a;
      }
    }
    // (gamma, dd) in one record a block, under LM (Q, 0) in a second one
    // with its own block-sum records, partials and broadcast record
    acc = tg_block_sum(acc, s_warp);
    if constexpr (LM) acc_q = tg_block_sum(acc_q, s_warp + TGCG_WARPS);
    if (threadIdx.x == 0) {
      part[blockIdx.x] = acc;
      if constexpr (LM) part[n_blocks + blockIdx.x] = acc_q;
    }
    grid.sync();
    const double2 sums = tg_partials_sum(part, n_blocks, s_bcast);
    const float gamma_new = (float)sums.x, delta_d = (float)sums.y;
    float q_cur = 0.f;
    if constexpr (LM)
      q_cur = __fmul_rn(0.5f, (float)tg_partials_sum(part + n_blocks, n_blocks, s_bcast + 1).x);
    const bool first = l == 0;
    if (first) floor_rz = __fmul_rn(tol, gamma_new);
    bool stop = !first && gamma_new <= floor_rz;
    if constexpr (LM) {
      if (!first) {
        const float zeta = __fdiv_rn(__fmul_rn((float)l, __fsub_rn(q_cur, q0)), q_cur);
        stop = stop || zeta < q_tol;
      }
    }
    if (stop) break;  // this iteration is not counted
    const float beta = first ? 0.f : tg_safe_div(gamma_new, gamma, guard_div);
    const float den = __fsub_rn(
        delta_d, __fmul_rn(beta, tg_safe_div(gamma_new, alpha_prev, guard_div)));
    const float used_den = first ? delta_d : den;
    const float alpha = tg_safe_div(gamma_new, used_den, guard_div);

    // phase B: s = w + beta s (on the halo from the neighbours' w rings),
    // p = u + beta p, delta += alpha p, r -= alpha s and u = M^-1 r on the
    // tile and its halo (p and delta on the tile only under GN)
    for (TgWalk w(pcols); w.q < ext; w.next(pcols)) {
      const int gy = y0 + w.y - h, gx = x0 + w.x - h;
      if (gy < 0 || gy >= N1 || gx < 0 || gx >= N2) continue;  // stays 0
      const bool inner = w.y >= h && w.y < h + rows && w.x >= h && w.x < h + cols;
      const int t = (w.y - h) * cols + (w.x - h);
      const int gq = gy * N2 + gx;
      for (int c = 0; c < C; ++c) {
        const int x = c * ext + w.q;
        const float mv = pre[c * plane + gq];
        const float wv = inner ? s_w[c * pts + t] : __ldcg(wr + c * plane + gq);
        const float sv = __fadd_rn(wv, __fmul_rn(beta, s_s[x]));
        s_s[x] = sv;
        if (LM || inner) {
          const int pi = c * fs + (LM ? w.q : t);
          const float pv = __fadd_rn(s_u[x], __fmul_rn(beta, s_p[pi]));
          s_p[pi] = pv;
          s_d[pi] = __fadd_rn(s_d[pi], __fmul_rn(alpha, pv));
        }
        const float rv = __fsub_rn(s_r[x], __fmul_rn(alpha, sv));
        s_r[x] = rv;
        s_u[x] = __fmul_rn(mv, rv);
      }
    }
    ++l;
    gamma = gamma_new;
    alpha_prev = alpha;
    if constexpr (LM) q0 = q_cur;
    if (used_den <= 0.f) break;
    if constexpr (LM) {
      if (l % reset_period == 0) {
        // r = b - (A delta + ctc delta) on the tile, from delta's haloed
        // copy; r's ring to r_ring
        __syncthreads();  // the stencil reads delta at the neighbouring points
        for (TgWalk w(cols); w.q < pts; w.next(cols)) {
          const int gq = (y0 + w.y) * N2 + x0 + w.x;
          const int e = (w.y + h) * pcols + w.x + h;
          const bool ring = w.y < h || w.y >= rows - h || w.x < h || w.x >= cols - h;
          for (int c = 0; c < C; ++c) {
            const int g = c * plane + gq;
            const float cv = ctc[g];
            const float bv = b[g];
            float a = tg_stencil(F, s_d, s_f, s_p_off, s_start[c], s_start[c + 1], gq, e);
            a = __fadd_rn(a, __fmul_rn(cv, s_d[c * ext + e]));
            const float rv = __fsub_rn(bv, a);
            s_r[c * ext + e] = rv;
            if (ring) r_ring[g] = rv;
          }
        }
        grid.sync();  // the halo's r is the neighbours' ring
        for (TgWalk w(pcols); w.q < ext; w.next(pcols)) {
          const int gy = y0 + w.y - h, gx = x0 + w.x - h;
          if (gy < 0 || gy >= N1 || gx < 0 || gx >= N2) continue;  // stays 0
          const bool inner = w.y >= h && w.y < h + rows && w.x >= h && w.x < h + cols;
          const int gq = gy * N2 + gx;
          for (int c = 0; c < C; ++c) {
            const int x = c * ext + w.q;
            const int g = c * plane + gq;
            float rv;
            if (inner) {
              rv = s_r[x];
            } else {
              rv = __ldcg(r_ring + g);
              s_r[x] = rv;
            }
            s_u[x] = __fmul_rn(pre[g], rv);
          }
        }
      }
    }
    __syncthreads();
  }

  for (TgWalk w(cols); w.q < pts; w.next(cols)) {
    const int gq = (y0 + w.y) * N2 + x0 + w.x;
    const int pi = LM ? (w.y + h) * pcols + w.x + h : w.q;
    for (int c = 0; c < C; ++c) delta[c * plane + gq] = s_d[c * fs + pi];
  }
  return l;
}

// The kernel, block k owning tile (k / tiles_c, k % tiles_c) of the ceil
// split of the grid [N1, N2] into th x tw tiles with a halo of h, with the
// arguments of tiled_grid_cg_kernel's one-system form: delta receives the
// solution; r_ring (one system's size) takes r's rings on an
// LM reset iteration, w_ring (two of that size) w's rings by the
// iteration's parity; partA and partB, the partial dots of the even and
// the odd iterations: one double2 record a block, under LM a second set of
// records after the first (two a block).
template <bool LM>
__global__ void __launch_bounds__(TGCG_THREADS, 1)
tiled_grid_cs_kernel(const float* __restrict__ F, const float* __restrict__ b,
                     const float* __restrict__ pre,
                     const float* __restrict__ ctc,
                     const int* __restrict__ triples,
                     const int* __restrict__ starts, int C, int n_triples,
                     int N1, int N2, int tiles_c, int th, int tw, int h,
                     int lits, float tol, int guard_div, int reset_period,
                     float q_tol, float* delta, float* r_ring, float* w_ring,
                     double2* partA, double2* partB, int* iters) {
  extern __shared__ double2 smem[];
  constexpr int n_rec = LM ? 2 : 1;  // block-sum record sets
  const int pts_max = th * tw;
  const int ext_max = (th + 2 * h) * (tw + 2 * h);
  const int frame_max = LM ? ext_max : pts_max;  // p's and delta's
  TgTile tt;
  tt.s_warp = smem;
  tt.s_bcast = smem + n_rec * TGCG_WARPS;
  tt.s_r = (float*)(smem + n_rec * (TGCG_WARPS + 1));  // haloed
  tt.s_s = tt.s_r + C * ext_max;                       // haloed
  tt.s_u = tt.s_s + C * ext_max;                       // haloed
  tt.s_pe = tt.s_u + C * ext_max;                      // p
  tt.s_d = tt.s_pe + C * frame_max;                    // delta
  tt.s_ap = tt.s_d + C * frame_max;                    // w, over the tile
  tt.s_m = nullptr;
  int* s_f = (int*)(tt.s_ap + C * pts_max);
  tg_tile_setup(tt, triples, starts, C, n_triples, N1, N2, tiles_c, th, tw, h, s_f,
                s_f + n_triples, s_f + 2 * n_triples);

  cg::grid_group grid = cg::this_grid();
  const int l = tg_solve_cs<LM>(grid, tt, F, b, pre, ctc, C, lits, tol, guard_div,
                                reset_period, q_tol, delta, r_ring, w_ring, partA, partB);
  if (blockIdx.x == 0 && threadIdx.x == 0) *iters = l;
}

// Launches one Chronopoulos-Gear solve on `stream`, as tiled_grid_cg_launch
// launches the standard loop's one system (float32 F [T, N1, N2], b, pre,
// ctc (LM only), delta and r_ring [C, N1, N2], the triples and their
// starts), with w_ring [2, C, N1, N2] float32 and partA and partB two
// double2 records a block each; smem_bytes must be tg_smem_bytes of these
// arguments with cs. Returns the CUDA error (tg_launch's).
extern "C" int tiled_grid_cs_launch(int lm, const float* F, const float* b,
                                    const float* pre, const float* ctc,
                                    const int* triples, const int* starts, int C,
                                    int n_triples, int N1, int N2, int tiles_r,
                                    int tiles_c, int th, int tw, int h, int lits,
                                    float tol, int guard_div, int reset_period,
                                    float q_tol, float* delta, float* r_ring,
                                    float* w_ring, double2* partA, double2* partB,
                                    int* iters, int threads, int smem_bytes,
                                    void* stream) {
  if ((lm && (ctc == nullptr || reset_period < 1)) || w_ring == nullptr)
    return (int)cudaErrorInvalidValue;
  void* args[] = {(void*)&F,        (void*)&b,       (void*)&pre,
                  (void*)&ctc,      (void*)&triples, (void*)&starts,
                  (void*)&C,        (void*)&n_triples,
                  (void*)&N1,       (void*)&N2,      (void*)&tiles_c,
                  (void*)&th,       (void*)&tw,      (void*)&h,
                  (void*)&lits,     (void*)&tol,     (void*)&guard_div,
                  (void*)&reset_period, (void*)&q_tol,
                  (void*)&delta,    (void*)&r_ring,  (void*)&w_ring,
                  (void*)&partA,    (void*)&partB,   (void*)&iters};
  const void* kernel = lm ? (const void*)tiled_grid_cs_kernel<true>
                          : (const void*)tiled_grid_cs_kernel<false>;
  return tg_launch(kernel, args, C, n_triples, N1, N2, tiles_r, tiles_c, th, tw, h,
                   tg_smem_bytes(lm, 0, 1, 0, C, th, tw, h, n_triples), threads, smem_bytes,
                   stream);
}
