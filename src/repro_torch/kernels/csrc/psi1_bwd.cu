// Reverse pass of the psi1 statistic for the RBF-ARD kernel, written by hand
// for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/suffstats.py: psi1_bwd_pallas (the Pallas TPU
// kernel _psi1_bwd_kernel; kfu_bwd_pallas is the same kernel at S = 0).
// Equation numbers are those of docs/derivations/suffstats_vjp.md. With
// l2 = l^2, b = 1 / (l2 + S) and the forward's
//
//   psi1_nm = v exp(-1/2 sum_q log1p(S_nq / l2_q) - 1/2 sum_q (mu_nq - z_mq)^2 b_nq)
//
// the branch weight is W1_nm = g_nm psi1_nm (eq. (8) specialized), and
//
//   per datapoint n: s1 = sum_m W1, s1d_q = sum_m W1 (mu_q - z_mq),
//                    s1v_q = sum_m W1 (mu_q - z_mq)^2
//     dmu = -b s1d,  dS = -b s1 / 2 + b^2 s1v / 2      (eq. (10)-(11))
//     dl_q = sum_n (S b / l) s1 + l b^2 s1v            (eq. (14))
//     dv_raw = sum_n s1                                (eq. (13), times v)
//   per inducing point m:
//     dZ_mq = sum_n W1_nm b_nq (mu_nq - z_mq)           (eq. (12))
//
// The caller divides dv_raw by v.
//
// What bounds it on this card: it reads the (N, M) cotangent once (0.4 GB
// in float32, 0.8 GB in double at the paper's shape) against N M
// exponentials and about N M (10 Q + 3) floating-point operations, so memory
// bytes bound it.
//
// What the design does about it:
//   * One wave of persistent blocks (the host sizes the grid from the
//     occupancy query, psi1_bwd_occupancy), each owning an N-split that it
//     walks in runs of R datapoints. A run of the row-major g is one
//     contiguous span of R M elements; a ring of kStages shared-memory
//     stages keeps kStages - 1 runs in flight while one is computed, each
//     copied with cp.async (16-byte chunks past L1, single elements at the
//     span's unaligned ends, so any M and any split start run in one code
//     path). mu and S of the run ride in the same stage. Where one row of g
//     outgrows a stage (very large M), the block walks column tiles of MT
//     inducing points per run, each row of the tile its own span.
//   * Each (n, m) is evaluated once: a group of G threads owns a datapoint,
//     its lanes take the row's columns in turn, evaluate W1 (base-2
//     exponent with log2(e) folded into the staged terms: MUFU.EX2 in float,
//     common.cuh: exp2_neg in double), write it back over g in shared
//     memory and sum s1, s1d and s1v for the point as they go; the G lanes
//     then reduce in a fixed xor order and the group's first lane writes dmu
//     and dS and adds the point's shares of dl and dv to the group's row of
//     shared memory. No per-(tile, point) scratch, no second pass over the
//     points. The host picks G so that a warp's first reads of g hit
//     distinct banks (M = 100 in float: 4 lanes a point, 8 points a warp).
//   * dZ per column: threads own (q, m) columns and sum W1 b (mu - z) down
//     the run in its order, in the input dtype; each run's sum is added to
//     the block's total in double, in the block's own row of a double
//     scratch that no other block touches. A last pass sums the P blocks'
//     rows of dZ and of dl / dv in order, in double.
//   * No atomics anywhere: every sum has one owner and an order fixed by the
//     shapes, so two launches are bitwise equal.
//   * The exponent is the direct (mu - z)^2 b form (no float32 cancellation
//     at large |mu| / l); v multiplies inside the kernel, so v g is never
//     formed. Ragged N and M are masked at the bounds; nothing is padded.
//   * float and double instances compute in the input dtype. The fast path
//     has compile-time instances for Q = 1..4; the general path (any Q, long
//     rows, column tiles) reads Q at run time and sums the moments kQChunk
//     q's per sweep over the staged W1 (each exponential is still evaluated
//     once).
#include "common.cuh"

namespace {

constexpr int kStages = 4;         // ring of staged runs: kStages - 1 in flight
constexpr int kQChunk = 8;         // run-time Q: moments summed per sweep
constexpr int kRegColumns = 32;    // fast path: dZ partials (columns x Q) a lane holds
constexpr int kColumnChunk = 4;    // fast path: columns a lane evaluates without a branch

// the fast path's column slots a lane holds at compile-time Q: kRegColumns / Q
// in whole chunks (kernels/suffstats.py: psi1_bwd_fast_columns)
__host__ __device__ constexpr int fast_columns(int Q) {
  return kRegColumns / Q / kColumnChunk * kColumnChunk;
}

__host__ __device__ inline size_t round16(size_t x) { return (x + 15) / 16 * 16; }

// Shared-memory layout of a block, in bytes from the start (every region
// 16-byte aligned): kStages stages (g, mu, S of a run), exp2_neg's table,
// the groups' dl / dv sums, the per-point sums across column tiles, the
// run's per-point terms, the rows' offsets into the stage.
// kernels/suffstats.py: psi1_bwd_smem mirrors it.
struct Psi1BwdLayout {
  size_t g_room, qs_room;  // elements of g, of mu (and of S) a stage holds
  size_t stage, tab, dl, acc, mu, b, bx, S, lg, off, zt, total;
};

template <typename T>
__host__ __device__ inline Psi1BwdLayout psi1_bwd_layout(int M, int Q, int R, int MT,
                                                         int G) {
  Psi1BwdLayout L{};
  const size_t ts = sizeof(T);
  const bool tiled = MT < M;
  L.g_room = tiled ? static_cast<size_t>(R) * span_room<T>(MT) : span_room<T>(R * M);
  L.qs_room = span_room<T>(R * Q);
  L.stage = (L.g_room + 2 * L.qs_room) * ts;
  size_t o = kStages * L.stage;
  L.tab = o;  o += 32 * sizeof(double);
  L.dl = o;   o += round16(static_cast<size_t>(kThreads / G) * (Q + 1) * sizeof(double));
  L.acc = o;  o += tiled ? round16(static_cast<size_t>(R) * (1 + 2 * Q) * sizeof(double)) : 0;
  L.mu = o;   o += round16(static_cast<size_t>(R) * Q * ts);
  L.b = o;    o += round16(static_cast<size_t>(R) * Q * ts);
  L.bx = o;   o += round16(static_cast<size_t>(R) * Q * ts);
  L.S = o;    o += round16(static_cast<size_t>(R) * Q * ts);
  L.lg = o;   o += round16(static_cast<size_t>(R) * ts);
  L.off = o;  o += round16(static_cast<size_t>(R) * sizeof(int));
  L.total = o;
  return L;
}

// The fast path's layout: the same ring of stages, exp2_neg's table, Z
// transposed (Q, M), the groups' dl / dv sums; at the end the ring holds the
// groups' dZ columns of one q at a time ([R][M] doubles: R groups).
// kernels/suffstats.py: psi1_bwd_fast_smem mirrors it.
template <typename T>
__host__ __device__ inline Psi1BwdLayout psi1_bwd_fast_layout(int M, int Q, int R, int G) {
  Psi1BwdLayout L{};
  const size_t ts = sizeof(T);
  L.g_room = span_room<T>(R * M);
  L.qs_room = span_room<T>(R * Q);
  L.stage = (L.g_room + 2 * L.qs_room) * ts;
  size_t o = kStages * L.stage;
  L.tab = o;  o += 32 * sizeof(double);
  L.zt = o;   o += round16(static_cast<size_t>(M) * Q * ts);
  L.dl = o;   o += round16(static_cast<size_t>(kThreads / G) * (Q + 1) * sizeof(double));
  L.total = o;
  return L;
}

// x summed over the G lanes of its group (G a power of two <= 32, groups
// aligned in the warp), in a fixed xor order; every lane of the warp calls it
template <typename T>
__device__ __forceinline__ T group_sum(T x, int G) {
  for (int o = G / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The general path, for any Q, M and run: grid (P). Zt: Z transposed,
// (Q, M). dz_acc: (P, M, Q) and dl_part: (P, Q + 1) double block totals. R
// datapoints a run, MT inducing points a column tile (MT == M: one tile), G
// lanes a datapoint. The exponent and the first kQChunk q's moments come
// from one sweep over the row; the other q's moments from further sweeps
// over the staged W1.
template <typename T>
__global__ void __launch_bounds__(kThreads)
psi1_bwd_kernel(const T* __restrict__ mu, const T* __restrict__ S,
                const T* __restrict__ Zt, const T* __restrict__ l2,
                const T* __restrict__ ls, const T* __restrict__ variance,
                const T* __restrict__ g, T* __restrict__ dmu, T* __restrict__ dS,
                double* __restrict__ dz_acc, double* __restrict__ dl_part, int N, int M,
                int Q, int P, int R, int MT, int G) {
  constexpr int QB = kQChunk;  // q's one sweep sums
  extern __shared__ __align__(16) unsigned char smem[];
  const Psi1BwdLayout L = psi1_bwd_layout<T>(M, Q, R, MT, G);
  double* s_tab = reinterpret_cast<double*>(smem + L.tab);
  double* s_dl = reinterpret_cast<double*>(smem + L.dl);   // [groups][Q + 1]
  double* s_acc = reinterpret_cast<double*>(smem + L.acc);  // tiled: [R][1 + 2Q]
  T* s_mu = reinterpret_cast<T*>(smem + L.mu);              // [R][Q]
  T* s_b = reinterpret_cast<T*>(smem + L.b);                // [R][Q]: 1 / (l2 + S)
  T* s_bx = reinterpret_cast<T*>(smem + L.bx);              // [R][Q]: b u log2(e) / 2
  T* s_S = reinterpret_cast<T*>(smem + L.S);                // [R][Q]
  T* s_lg = reinterpret_cast<T*>(smem + L.lg);              // [R]: the staged lognorm
  int* s_off = reinterpret_cast<int*>(smem + L.off);        // [R]: row i of g in the stage

  const int tid = threadIdx.x;
  const int p = blockIdx.x;
  int n0, n1;
  split_range(N, P, p, &n0, &n1);
  const int TJ = (M + MT - 1) / MT;  // column tiles
  const bool tiled = TJ > 1;
  const int items = (n1 - n0 + R - 1) / R * TJ;  // (run, column tile), tiles inner
  const int NG = kThreads / G;
  const int gi = tid / G, gl = tid - gi * G;
  const int MQ = M * Q;
  const T v = *variance;
  const T kx = T(0.5 * kLog2e * exp2_units<T>());
  const T kl = T(-0.5 * kLog2e * exp2_units<T>());
  // the block's dZ totals: its own row of dz_acc, which no other block touches
  double* my_acc = dz_acc + static_cast<size_t>(p) * MQ;
  for (int c = tid; c < MQ; c += kThreads) my_acc[c] = 0.0;
  for (int k = tid; k < NG * (Q + 1); k += kThreads) s_dl[k] = 0.0;
  load_exp2_table<T>(s_tab);

  auto stage_of = [&](int k) { return reinterpret_cast<T*>(smem + (k % kStages) * L.stage); };
  auto issue = [&](int k) {
    if (k < items) {
      const int r = k / TJ, j = k - r * TJ;
      const int base = n0 + r * R, cnt = min(R, n1 - base);
      T* sg = stage_of(k);
      copy_span(sg + L.g_room, mu + static_cast<size_t>(base) * Q, cnt * Q);
      copy_span(sg + L.g_room + L.qs_room, S + static_cast<size_t>(base) * Q, cnt * Q);
      if (!tiled) {
        copy_span(sg, g + static_cast<size_t>(base) * M, cnt * M);
      } else {
        const int m0 = j * MT, W = min(MT, M - m0);
        for (int i = 0; i < cnt; ++i)
          copy_span(sg + i * span_room<T>(MT), g + (static_cast<size_t>(base) + i) * M + m0, W);
      }
    }
    cp_async_commit();
  };

  for (int k = 0; k < kStages - 1; ++k) issue(k);
  for (int k = 0; k < items; ++k) {
    issue(k + kStages - 1);  // into the slot item k - 1 used
    cp_async_wait<kStages - 1>();
    __syncthreads();  // item k has landed for every thread
    const int r = k / TJ, j = k - r * TJ;
    const int base = n0 + r * R, cnt = min(R, n1 - base);
    const int m0 = j * MT, W = min(MT, M - m0);
    T* sg = stage_of(k);

    // the run's per-point terms, one thread a datapoint
    if (tid < cnt) {
      const int i = tid;
      const T* smu = sg + L.g_room + span_shift(mu + static_cast<size_t>(base) * Q);
      const T* sS = sg + L.g_room + L.qs_room + span_shift(S + static_cast<size_t>(base) * Q);
      T lg = T(0);
      for (int q = 0; q < Q; ++q) {
        const T s = sS[i * Q + q];
        const T l2q = __ldg(l2 + q);
        const T b = T(1) / (l2q + s);
        s_mu[i * Q + q] = smu[i * Q + q];
        s_S[i * Q + q] = s;
        s_b[i * Q + q] = b;
        s_bx[i * Q + q] = kx * b;
        lg += log1p_t(s / l2q);
      }
      s_lg[i] = kl * lg;
      s_off[i] = tiled ? i * span_room<T>(MT) +
                             span_shift(g + (static_cast<size_t>(base) + i) * M + m0)
                       : span_shift(g + static_cast<size_t>(base) * M) + i * M;
    }
    __syncthreads();

    // ---- per point: W1 over the row (each exponential once), its sums ----
    // the point's group finishes q of point i from its row sums: dmu, dS and
    // the share of dl (one column tile), or adds them to the tiles' sums
    auto finish_q = [&](int i, int q, T s1, T sd, T sv) {
      if (!tiled) {
        const size_t n = static_cast<size_t>(base + i);
        const T b = s_b[i * Q + q], s = s_S[i * Q + q], lq = __ldg(ls + q);
        dmu[n * Q + q] = -b * sd;                               // eq. (10)
        dS[n * Q + q] = T(-0.5) * b * s1 + T(0.5) * b * b * sv;  // eq. (11)
        s_dl[gi * (Q + 1) + q] += static_cast<double>((s * b / lq) * s1 + lq * b * b * sv);  // (14)
      } else {
        double* a = s_acc + i * (1 + 2 * Q);
        a[1 + q] = (j == 0 ? 0.0 : a[1 + q]) + static_cast<double>(sd);
        a[1 + Q + q] = (j == 0 ? 0.0 : a[1 + Q + q]) + static_cast<double>(sv);
      }
    };
    auto finish_s1 = [&](int i, T s1) {  // eq. (13), times v
      if (!tiled) {
        s_dl[gi * (Q + 1) + Q] += static_cast<double>(s1);
      } else {
        double* a = s_acc + i * (1 + 2 * Q);
        a[0] = (j == 0 ? 0.0 : a[0]) + static_cast<double>(s1);
      }
    };
    for (int i0 = 0; i0 < cnt; i0 += NG) {  // warp-uniform: every lane reaches the shuffles
      const int i = i0 + gi;
      const bool live = i < cnt;
      const int off = live ? s_off[i] : 0;
      T s1 = T(0), sd[QB], sv[QB];
#pragma unroll
      for (int qq = 0; qq < QB; ++qq) sd[qq] = sv[qq] = T(0);
      if (live) {
        const T lg = s_lg[i];
        T mu_[QB], bx_[QB];
#pragma unroll
        for (int qq = 0; qq < QB; ++qq) {
          mu_[qq] = qq < Q ? s_mu[i * Q + qq] : T(0);
          bx_[qq] = qq < Q ? s_bx[i * Q + qq] : T(0);
        }
#pragma unroll 2
        for (int m = gl; m < W; m += G) {
          T e = lg, d[QB];
#pragma unroll
          for (int qq = 0; qq < QB; ++qq) {
            d[qq] = T(0);
            if (qq < Q) {
              d[qq] = mu_[qq] - __ldg(Zt + static_cast<size_t>(qq) * M + m0 + m);
              e = fma_t(-(d[qq] * bx_[qq]), d[qq], e);
            }
          }
          for (int q = QB; q < Q; ++q) {  // the exponent's other q's
            const T dq = s_mu[i * Q + q] - __ldg(Zt + static_cast<size_t>(q) * M + m0 + m);
            e = fma_t(-(dq * s_bx[i * Q + q]), dq, e);
          }
          const T w = sg[off + m] * (v * exp2_neg(e, s_tab));  // eq. (8)
          sg[off + m] = w;
          s1 += w;
#pragma unroll
          for (int qq = 0; qq < QB; ++qq) {
            const T wd = w * d[qq];
            sd[qq] += wd;
            sv[qq] = fma_t(wd, d[qq], sv[qq]);
          }
        }
      }
      s1 = group_sum(s1, G);
#pragma unroll
      for (int qq = 0; qq < QB; ++qq) {
        sd[qq] = group_sum(sd[qq], G);
        sv[qq] = group_sum(sv[qq], G);
      }
      if (live && gl == 0) {
        finish_s1(i, s1);
#pragma unroll
        for (int qq = 0; qq < QB; ++qq)
          if (qq < Q) finish_q(i, qq, s1, sd[qq], sv[qq]);
      }
      for (int q0 = QB; q0 < Q; q0 += QB) {  // the moments of the other q's, from the staged W1
#pragma unroll
        for (int qq = 0; qq < QB; ++qq) sd[qq] = sv[qq] = T(0);
        if (live) {
          for (int m = gl; m < W; m += G) {
            const T w = sg[off + m];
#pragma unroll
            for (int qq = 0; qq < QB; ++qq) {
              const int q = q0 + qq;
              if (q < Q) {
                const T d = s_mu[i * Q + q] - __ldg(Zt + static_cast<size_t>(q) * M + m0 + m);
                const T wd = w * d;
                sd[qq] += wd;
                sv[qq] = fma_t(wd, d, sv[qq]);
              }
            }
          }
        }
#pragma unroll
        for (int qq = 0; qq < QB; ++qq) {
          sd[qq] = group_sum(sd[qq], G);
          sv[qq] = group_sum(sv[qq], G);
        }
        if (live && gl == 0) {
#pragma unroll
          for (int qq = 0; qq < QB; ++qq)
            if (q0 + qq < Q) finish_q(i, q0 + qq, s1, sd[qq], sv[qq]);
        }
      }
      // the last column tile of a run: the points' outputs from the tiles' sums
      if (tiled && j == TJ - 1 && live && gl == 0) {
        const size_t n = static_cast<size_t>(base + i);
        const double* a = s_acc + i * (1 + 2 * Q);
        double* dl = s_dl + gi * (Q + 1);
        const T t1 = static_cast<T>(a[0]);
        for (int q = 0; q < Q; ++q) {
          const T b = s_b[i * Q + q], s = s_S[i * Q + q], lq = __ldg(ls + q);
          const T d1 = static_cast<T>(a[1 + q]), v1 = static_cast<T>(a[1 + Q + q]);
          dmu[n * Q + q] = -b * d1;
          dS[n * Q + q] = T(-0.5) * b * t1 + T(0.5) * b * b * v1;
          dl[q] += static_cast<double>((s * b / lq) * t1 + lq * b * b * v1);
        }
        dl[Q] += a[0];
      }
    }
    __syncthreads();  // W1 is staged for the whole run

    // ---- dZ per (q, m) column of the tile: down the run in T, into the
    // block's double total ----
    for (int c = tid; c < W * Q; c += kThreads) {
      const int q = c / W, m = c - q * W;
      const T z = __ldg(Zt + static_cast<size_t>(q) * M + m0 + m);
      T run = T(0);
#pragma unroll 4
      for (int i = 0; i < cnt; ++i)
        run = fma_t(sg[s_off[i] + m] * s_b[i * Q + q], s_mu[i * Q + q] - z, run);  // eq. (12)
      my_acc[(m0 + m) * Q + q] += static_cast<double>(run);
    }
    __syncthreads();  // the slot is free again
  }
  // the groups' dl / dv sums in group order
  for (int k = tid; k <= Q; k += kThreads) {
    double s = 0.0;
    for (int gg = 0; gg < NG; ++gg) s += s_dl[gg * (Q + 1) + k];
    dl_part[static_cast<size_t>(p) * (Q + 1) + k] = s;
  }
}

// The fast path: compile-time Q, one column tile, and ceil(M / G) Q <=
// kRegColumns. Lane gl of a group owns the columns m = gl + k G for the
// whole kernel, so it keeps their dZ partials in registers (summed in T over
// the points it sees, then over the groups and the blocks in double) and its
// column loop unrolls fully: its exponentials are independent, and many are
// in flight at once. Each group of G lanes takes a point of the run, forms
// the point's terms from the staged mu and S itself, and reduces its sums
// in a fixed xor order; there is no W1 write-back and no dZ pass, and a run
// costs two barriers. R = kThreads / G: one point a group.
template <typename T, int QC>
__global__ void __launch_bounds__(kThreads)
psi1_bwd_fast_kernel(const T* __restrict__ mu, const T* __restrict__ S,
                     const T* __restrict__ Zt, const T* __restrict__ l2,
                     const T* __restrict__ ls, const T* __restrict__ variance,
                     const T* __restrict__ g, T* __restrict__ dmu, T* __restrict__ dS,
                     double* __restrict__ dz_acc, double* __restrict__ dl_part, int N, int M,
                     int Q, int P, int R, int MT, int G) {
  constexpr int KC = fast_columns(QC);  // column slots a lane can own
  extern __shared__ __align__(16) unsigned char smem[];
  const Psi1BwdLayout L = psi1_bwd_fast_layout<T>(M, QC, R, G);
  double* s_tab = reinterpret_cast<double*>(smem + L.tab);
  T* s_zt = reinterpret_cast<T*>(smem + L.zt);              // [Q][M]
  double* s_dl = reinterpret_cast<double*>(smem + L.dl);    // [groups][Q + 1]

  const int tid = threadIdx.x;
  const int p = blockIdx.x;
  int n0, n1;
  split_range(N, P, p, &n0, &n1);
  const int items = (n1 - n0 + R - 1) / R;
  const int NG = kThreads / G;
  const int gi = tid / G, gl = tid - gi * G;
  const int KG = (M + G - 1) / G;  // column slots the widest lane walks (warp-uniform)
  const T v = *variance;
  const T kx = T(0.5 * kLog2e * exp2_units<T>());
  const T kl = T(-0.5 * kLog2e * exp2_units<T>());
  load_exp2_table<T>(s_tab);
  for (int k = tid; k < M * QC; k += kThreads) s_zt[k] = Zt[k];
  T l2r[QC], lsr[QC];
#pragma unroll
  for (int q = 0; q < QC; ++q) {
    l2r[q] = __ldg(l2 + q);
    lsr[q] = __ldg(ls + q);
  }
  T dz[KC][QC];
#pragma unroll
  for (int kk = 0; kk < KC; ++kk)
#pragma unroll
    for (int q = 0; q < QC; ++q) dz[kk][q] = T(0);
  double dl[QC], dv = 0.0;
#pragma unroll
  for (int q = 0; q < QC; ++q) dl[q] = 0.0;

  auto stage_of = [&](int k) { return reinterpret_cast<T*>(smem + (k % kStages) * L.stage); };
  auto issue = [&](int k) {
    if (k < items) {
      const int base = n0 + k * R, cnt = min(R, n1 - base);
      T* sg = stage_of(k);
      copy_span(sg + L.g_room, mu + static_cast<size_t>(base) * QC, cnt * QC);
      copy_span(sg + L.g_room + L.qs_room, S + static_cast<size_t>(base) * QC, cnt * QC);
      copy_span(sg, g + static_cast<size_t>(base) * M, cnt * M);
    }
    cp_async_commit();
  };

  for (int k = 0; k < kStages - 1; ++k) issue(k);
  for (int k = 0; k < items; ++k) {
    issue(k + kStages - 1);  // into the slot item k - 1 used
    cp_async_wait<kStages - 1>();
    __syncthreads();  // item k has landed for every thread
    const int base = n0 + k * R, cnt = min(R, n1 - base);
    const T* sg = stage_of(k);
    const T* smu = sg + L.g_room + span_shift(mu + static_cast<size_t>(base) * QC);
    const T* sS = sg + L.g_room + L.qs_room + span_shift(S + static_cast<size_t>(base) * QC);
    const int g0 = span_shift(g + static_cast<size_t>(base) * M);
    for (int i0 = 0; i0 < cnt; i0 += NG) {  // warp-uniform: every lane reaches the shuffles
      const int i = i0 + gi;
      const bool live = i < cnt;
      const int ic = live ? i : 0;  // a group past the run reads a real point, adds nothing
      T m_[QC], b_[QC], bx_[QC], s_[QC], lg = T(0);
#pragma unroll
      for (int q = 0; q < QC; ++q) {
        s_[q] = sS[ic * QC + q];
        m_[q] = smu[ic * QC + q];
        b_[q] = T(1) / (l2r[q] + s_[q]);
        bx_[q] = kx * b_[q];
        lg += log1p_t(s_[q] / l2r[q]);
      }
      lg = kl * lg;
      const T* row = sg + g0 + ic * M;
      T s1 = T(0), sd[QC], sv[QC];
#pragma unroll
      for (int q = 0; q < QC; ++q) sd[q] = sv[q] = T(0);
      // kColumnChunk column slots at a time with no branch inside (a slot
      // past M, or of a group past the run, reads column 0 and weighs 0), so
      // their exponentials overlap; the check between chunks is warp-uniform
#pragma unroll
      for (int k0 = 0; k0 < KC; k0 += kColumnChunk) {
        if (k0 >= KG) break;
#pragma unroll
        for (int j = 0; j < kColumnChunk; ++j) {
          const int kk = k0 + j;
          const int m = gl + kk * G;
          const bool valid = live && m < M;
          const int mc = valid ? m : 0;
          T e = lg, d[QC];
#pragma unroll
          for (int q = 0; q < QC; ++q) {
            d[q] = m_[q] - s_zt[q * M + mc];
            e = fma_t(-(d[q] * bx_[q]), d[q], e);
          }
          T w = row[mc] * (v * exp2_neg(e, s_tab));  // eq. (8)
          w = valid ? w : T(0);
          s1 += w;
#pragma unroll
          for (int q = 0; q < QC; ++q) {
            const T wd = w * d[q];
            sd[q] += wd;
            sv[q] = fma_t(wd, d[q], sv[q]);
            dz[kk][q] = fma_t(wd, b_[q], dz[kk][q]);  // eq. (12)
          }
        }
      }
      s1 = group_sum(s1, G);
#pragma unroll
      for (int q = 0; q < QC; ++q) {
        sd[q] = group_sum(sd[q], G);
        sv[q] = group_sum(sv[q], G);
      }
      if (live && gl == 0) {
        const size_t n = static_cast<size_t>(base + i);
#pragma unroll
        for (int q = 0; q < QC; ++q) {
          const T b = b_[q];
          dmu[n * QC + q] = -b * sd[q];                                     // eq. (10)
          dS[n * QC + q] = T(-0.5) * b * s1 + T(0.5) * b * b * sv[q];       // eq. (11)
          dl[q] += static_cast<double>((s_[q] * b / lsr[q]) * s1
                                       + lsr[q] * b * b * sv[q]);           // eq. (14)
        }
        dv += static_cast<double>(s1);  // eq. (13), times v
      }
    }
    __syncthreads();  // the slot is free again
  }

  // the block's totals: each q's dZ columns over the groups, then dl / dv,
  // in group order (the ring now holds [groups][M] doubles)
  double* buf = reinterpret_cast<double*>(smem);
  const int MQ = M * QC;
#pragma unroll
  for (int q = 0; q < QC; ++q) {
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      const int m = gl + kk * G;
      if (m < M) buf[gi * M + m] = static_cast<double>(dz[kk][q]);
    }
    if (q == 0 && gl == 0) {
#pragma unroll
      for (int qq = 0; qq < QC; ++qq) s_dl[gi * (QC + 1) + qq] = dl[qq];
      s_dl[gi * (QC + 1) + QC] = dv;
    }
    __syncthreads();
    for (int c = tid; c < M; c += kThreads) {
      double t = 0.0;
      for (int gg = 0; gg < NG; ++gg) t += buf[gg * M + c];
      dz_acc[static_cast<size_t>(p) * MQ + c * QC + q] = t;
    }
    __syncthreads();
  }
  for (int k = tid; k <= QC; k += kThreads) {
    double t = 0.0;
    for (int gg = 0; gg < NG; ++gg) t += s_dl[gg * (QC + 1) + k];
    dl_part[static_cast<size_t>(p) * (QC + 1) + k] = t;
  }
}

template <typename T>
using Psi1BwdKernel = void (*)(const T*, const T*, const T*, const T*, const T*, const T*,
                               const T*, T*, T*, double*, double*, int, int, int, int, int,
                               int, int);

// the kernel of a plan: the fast path (fast != 0; compile-time Q only) or
// the general one, and its shared memory
template <typename T>
Psi1BwdKernel<T> psi1_bwd_kernel_for(int Q, int fast) {
  if (fast) {
    switch (Q) {
      case 1: return psi1_bwd_fast_kernel<T, 1>;
      case 2: return psi1_bwd_fast_kernel<T, 2>;
      case 3: return psi1_bwd_fast_kernel<T, 3>;
      default: return psi1_bwd_fast_kernel<T, 4>;
    }
  }
  return psi1_bwd_kernel<T>;
}

template <typename T>
size_t psi1_bwd_smem(int M, int Q, int R, int MT, int G, int fast) {
  return fast ? psi1_bwd_fast_layout<T>(M, Q, R, G).total
              : psi1_bwd_layout<T>(M, Q, R, MT, G).total;
}

template <typename T>
cudaError_t psi1_bwd(const T* mu, const T* S, const T* Zt, const T* l2, const T* ls,
                     const T* variance, const T* g, T* dmu, T* dS, double* dz_acc,
                     double* dl_part, T* dz, T* point_sum, int N, int M, int Q, int P,
                     int R, int MT, int G, int fast, cudaStream_t stream) {
  if (fast && !(Q >= 1 && Q <= 4 && MT == M && (M + G - 1) / G <= fast_columns(Q)))
    return cudaErrorInvalidValue;
  const size_t smem = psi1_bwd_smem<T>(M, Q, R, MT, G, fast);
  const Psi1BwdKernel<T> fn = psi1_bwd_kernel_for<T>(Q, fast);
  cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return err;
  fn<<<P, kThreads, smem, stream>>>(mu, S, Zt, l2, ls, variance, g, dmu, dS, dz_acc, dl_part,
                                    N, M, Q, P, R, MT, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = reduce_double<T>(dz_acc, dz, P, static_cast<size_t>(M) * Q, stream);
  if (err != cudaSuccess) return err;
  return reduce_double<T>(dl_part, point_sum, P, static_cast<size_t>(Q) + 1, stream);
}

}  // namespace

// Plain C interface (bound with ctypes). Pointers are device pointers of
// contiguous row-major arrays: mu, S (N, Q); Zt (Q, M) = Z transposed; l2,
// ls (Q); variance (1); g (N, M); outputs dmu, dS (N, Q), dz (M, Q),
// point_sum (Q + 1) = [dl, dv_raw]; double scratch dz_acc (P, M, Q),
// dl_part (P, Q + 1). R, MT, G, fast: the launch plan
// (kernels/suffstats.py: psi1_bwd_plan). Launches on `stream`, does not
// synchronize, returns the first cudaGetLastError() that is not cudaSuccess
// (0 on success).
#define PSI1_BWD_ENTRY(NAME, T)                                                      \
  extern "C" int NAME(const T* mu, const T* S, const T* Zt, const T* l2, const T* ls, \
                      const T* variance, const T* g, T* dmu, T* dS, double* dz_acc,  \
                      double* dl_part, T* dz, T* point_sum, int N, int M, int Q,     \
                      int P, int R, int MT, int G, int fast, void* stream) {         \
    return static_cast<int>(psi1_bwd<T>(mu, S, Zt, l2, ls, variance, g, dmu, dS,     \
                                        dz_acc, dl_part, dz, point_sum, N, M, Q, P,  \
                                        R, MT, G, fast,                              \
                                        static_cast<cudaStream_t>(stream)));         \
  }

PSI1_BWD_ENTRY(psi1_bwd_f32, float)
PSI1_BWD_ENTRY(psi1_bwd_f64, double)

// out = [resident blocks a multiprocessor, shared-memory bytes a block] of
// the float (f64 == 0) or double instance for this plan, on the current
// device
extern "C" int psi1_bwd_occupancy(int f64, int M, int Q, int R, int MT, int G, int fast,
                                  int* out) {
  cudaError_t err;
  if (f64) {
    const size_t smem = psi1_bwd_smem<double>(M, Q, R, MT, G, fast);
    out[1] = static_cast<int>(smem);
    err = blocks_per_sm(psi1_bwd_kernel_for<double>(Q, fast), smem, &out[0]);
  } else {
    const size_t smem = psi1_bwd_smem<float>(M, Q, R, MT, G, fast);
    out[1] = static_cast<int>(smem);
    err = blocks_per_sm(psi1_bwd_kernel_for<float>(Q, fast), smem, &out[0]);
  }
  return static_cast<int>(err);
}

extern "C" const char* psi1_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
