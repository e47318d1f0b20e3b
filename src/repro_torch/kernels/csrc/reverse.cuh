// The reverse psi-statistics kernels' pair pass and point pass, shared by the
// fused reverse pass (suffstats_bwd.cu, kernel B2) and the psi2-only one
// (psi2_bwd.cu, kernel B4), as the TPU kernels share _psi2_bwd_tile. Equation
// numbers are those of docs/derivations/suffstats_vjp.md; suffstats_bwd.cu's
// header sets out what each pass computes and why it is laid out so.
//
//   pair pass, the forward's packed pair blocks x N-splits over one chunk
//     of the points: evaluates each E_nab once and feeds both
//       the per-pair sums P_ab = sum_n E_nab and A_abq = sum_n E_nab r_nq
//       (mu_nq - zbar_abq), kept in the thread's registers over its points,
//       from which the caller's O(M^2 Q) epilogue forms the psi2 part of dZ;
//       and the per-point sums over the block's pairs, with T = Gw_ab E_nab,
//       t = sum T, sd_q = sum T d_q, sv_q = sum T d_q^2 and
//       tz_q = sum T (z_aq - z_bq)^2 (d = mu - zbar), reduced across the
//       block's threads in a fixed order and written per (pair block,
//       point of the chunk);
//   point pass, one thread per datapoint of the chunk: sums a point's
//     pair-block partials in a fixed order, and forms dmu, dS (and dY with
//     the psi1 branch) and block partials of dl and v dv.
//
// The caller runs the two passes chunk by chunk over N (run_chunks), so the
// per-point scratch holds one chunk's (pair blocks, 1 + 3Q, chunk) sums; with
// chunks of about N / pair blocks points that is about N (1 + 3Q) sums
// whatever M is. The pair sums carry across chunks: each split's running
// totals (and their compensation terms) are kept in double between chunks,
// and a chunk's own two-level total is merged into them in its epilogue
// (carry_total), so the main loop is the single launch's, registers
// included (totals loaded before the loop take the Q = 1 pair kernel to
// 127 / 171 registers, float / double, a resident block a multiprocessor
// fewer). The order of every sum stays fixed by the shapes (bitwise
// repeatable).
//
// Q = 1..4 are compile-time instances; any larger Q that shared memory
// holds runs the run-time-Q ones: the pair pass sums A and the per-point
// moments kQChunkPair q's a pass over its split (evaluating each exponential
// once a pass), the point pass kMaxQ q's a pass over the point's own terms.
#pragma once

#include "common.cuh"

namespace {

// run-time Q: q's whose moments one point pass sums
constexpr int kMaxQ = 16;
// run-time Q: q's whose A sums and moments one pair pass over the split takes
constexpr int kQChunkPair = 8;
// point pass: dY columns accumulated per sweep over m
constexpr int kDChunk = 8;
constexpr int kBlockWarps = kThreads / 32;

// pair pass geometry of the instance for compile-time QC (0: run-time Q):
// pair slots a thread owns, datapoints whose sums a warp reduces together,
// datapoints staged per run
__host__ __device__ constexpr int pair_slots(int QC) { return QC == 0 ? 1 : QC <= 2 ? 4 : 2; }
__host__ __device__ constexpr int pair_group(int QC) { return QC == 0 ? 1 : QC == 1 ? 4 : 2; }
__host__ __device__ constexpr int pair_run(int QC) { return QC == 0 ? 16 : 32; }
__host__ __device__ constexpr int log2_of(int g) { return g <= 1 ? 0 : 1 + log2_of(g / 2); }
constexpr int compile_q(int Q) { return Q <= 4 ? Q : 0; }

// ---------------------------------------------------------------------------
// warp reductions
// ---------------------------------------------------------------------------

// One halving step of warp_reduce_points and the steps after it: lanes with
// bit O send the lower H points of v to lane ^ O and keep the upper H, the
// others the reverse; each adds what it receives to what it keeps.
template <int H, int O, typename T, int G, int C>
__device__ __forceinline__ void halve(T (&v)[G][C], int lane) {
  if constexpr (H >= 1) {
    const bool upper = lane & O;
#pragma unroll
    for (int g = 0; g < H; ++g) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const T send = upper ? v[g][c] : v[g + H][c];
        const T keep = upper ? v[g + H][c] : v[g][c];
        v[g][c] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
    }
    halve<H / 2, O / 2>(v, lane);
  }
}

// Sum v[G][C] (G points x C kinds per lane) over the warp's 32 lanes:
// log2 G halving steps, then 5 - log2 G xor steps. After it v[0][c] of lane
// l is the warp's total of kind c for point l >> (5 - log2 G). A fixed
// order, so bitwise repeatable; G points cost about as many shuffles as one
// point's plain xor tree.
template <typename T, int G, int C>
__device__ __forceinline__ void warp_reduce_points(T (&v)[G][C], int lane) {
  halve<G / 2, 16>(v, lane);
#pragma unroll
  for (int o = 16 / G; o >= 1; o /= 2) {
#pragma unroll
    for (int c = 0; c < C; ++c) v[0][c] += __shfl_xor_sync(0xffffffffu, v[0][c], o);
  }
}

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
#pragma unroll
  for (int o = 16; o >= 1; o /= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// the block's 8 warp totals of each (staged point, kind), summed in warp
// order and written to pt[pb, c, base + i] for the run's cnt real points
template <typename T>
__device__ __forceinline__ void store_point_sums(const T* s_w, T* pt, int pb,
                                                 int C, int R, int N, int base,
                                                 int cnt) {
  __syncthreads();
  for (int j = threadIdx.x; j < cnt * C; j += kThreads) {
    const int c = j / cnt;
    const int i = j - c * cnt;
    T s = s_w[i * C + c];
#pragma unroll
    for (int w = 1; w < kBlockWarps; ++w) s += s_w[(w * R + i) * C + c];
    pt[(static_cast<size_t>(pb) * C + c) * N + base + i] = s;
  }
}

// ---------------------------------------------------------------------------
// pair pass
// ---------------------------------------------------------------------------

// where split p's running pair sums wait between chunks: acc and its
// compensation term, each (P, 1 + Q, npairs), in double
struct Carry {
  double* acc;
  double* err;
  bool in;   // this chunk continues the totals of an earlier one
  bool out;  // a later chunk continues this one's totals
};

__device__ __forceinline__ Carry split_carry(double* carry, int P, int p, int Q,
                                             int npairs, int carry_in, int carry_out) {
  if (carry == nullptr) return Carry{nullptr, nullptr, false, false};  // a lone chunk
  const size_t plane = static_cast<size_t>(P) * (1 + Q) * npairs;
  double* acc = carry + static_cast<size_t>(p) * (1 + Q) * npairs;
  return Carry{acc, acc + plane, carry_in != 0, carry_out != 0};
}

// Entry i of a split's sums after this chunk: the chunk's total (acc, err)
// added to the running total of the earlier chunks, if any, compensated in
// the double instance; then kept in carry for a later chunk (returns
// false), or left in (acc, err) for the caller to write (returns true).
template <typename T>
__device__ __forceinline__ bool carry_total(const Carry& cy, size_t i, double& acc,
                                            double& err) {
  if (cy.in) {
    double s = cy.acc[i], c = cy.err[i];
    add_to_total<T>(s, c, acc);
    acc = s;
    err += c;
  }
  if (cy.out) {
    cy.acc[i] = acc;
    cy.err[i] = err;
    return false;
  }
  return true;
}

// resident blocks a multiprocessor the Q = 1 instances are held to (76 /
// 128 registers, float / double, fit): left free, ptxas gives the carry's
// epilogue a few more registers (170 in double), one block a
// multiprocessor fewer, and the double reverse passes ran 33 % slower at
// the paper's shape
template <typename T, int QC>
constexpr int pair_min_blocks() {
  return QC != 1 ? 1 : sizeof(T) == sizeof(double) ? 2 : 3;
}

// grid (pair blocks, P N-splits) over one chunk of N points. pair_part:
// (P, 1 + Q, M (M + 1) / 2) packed partials of [P, A_1..A_Q], written by
// the last chunk; carry: (2, P, 1 + Q, M (M + 1) / 2) doubles, the running
// totals between chunks (unused for a lone chunk); pt: (pair blocks,
// 1 + 3Q, N) per-point sums [t, sd_1..Q, sv_1..Q, tz_1..Q] of the chunk.
// Compile-time Q: zbar, (z_a - z_b)^2, Gw and the pair sums in registers.
template <typename T, int QC>
__global__ void __launch_bounds__(kThreads, (pair_min_blocks<T, QC>()))
pair_kernel(const T* __restrict__ mu, const T* __restrict__ S,
            const T* __restrict__ Z, const T* __restrict__ l2,
            const T* __restrict__ Gw, T* __restrict__ pair_part,
            double* __restrict__ carry, T* __restrict__ pt, int N, int M, int Q,
            int P, int carry_in, int carry_out) {
  constexpr int K = pair_slots(QC), G = pair_group(QC), R = pair_run(QC);
  constexpr int C = 1 + 3 * QC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* s_tab = reinterpret_cast<double*>(smem_raw);  // [32] (double only)
  T* s_mu = reinterpret_cast<T*>(s_tab + 32);  // [R][QC]
  T* s_r = s_mu + R * QC;                      // [R][QC]
  T* s_lg = s_r + R * QC;                      // [R]
  T* s_w = s_lg + R;                           // [kBlockWarps][R][C]

  const int npairs = M * (M + 1) / 2;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int first = blockIdx.x * K * kThreads;
  const int p = blockIdx.y;
  int n0, n1;
  split_range(N, P, p, &n0, &n1);
  load_exp2_table<T>(s_tab);

  bool live[K];  // warp-uniform: the warp has a real pair in slot k
  const bool all_live = first + K * kThreads <= npairs;  // block-uniform
  T zb[K][QC], zd2[K][QC], gw[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int t = first + k * kThreads + tid;
    live[k] = first + k * kThreads + (tid & ~31) < npairs;
    int a, b;
    pair_of(min(t, npairs - 1), M, &a, &b);
#pragma unroll
    for (int q = 0; q < QC; ++q) {
      const T za = Z[static_cast<size_t>(a) * QC + q];
      const T zz = Z[static_cast<size_t>(b) * QC + q];
      zb[k][q] = T(0.5) * (za + zz);
      zd2[k][q] = (za - zz) * (za - zz);
    }
    // a slot past the last pair adds nothing to the per-point sums
    gw[k] = t < npairs ? Gw[static_cast<size_t>(a) * M + b] : T(0);
  }

  // two-level pair sums: each staged run in T, the total over runs in
  // double, compensated in the double instance. The loss's g2 can be large
  // and cancel across pairs, and dZ then magnifies the rounding of P and A;
  // a plain double total over hundreds of runs rounds the most
  double accP[K], errP[K], accA[K][QC], errA[K][QC];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    accP[k] = errP[k] = 0.0;
#pragma unroll
    for (int q = 0; q < QC; ++q) accA[k][q] = errA[k][q] = 0.0;
  }
  for (int base = n0; base < n1; base += R) {
    const int cnt = min(R, n1 - base);
    stage_psi2_points(s_mu, s_r, s_lg, mu, S, l2, base, cnt, R, QC);
    T runP[K], runA[K][QC];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      runP[k] = T(0);
#pragma unroll
      for (int q = 0; q < QC; ++q) runA[k][q] = T(0);
    }
    // versioned on every slot being live (all pair blocks but the last), so
    // the full blocks test nothing per pair
    auto sweep = [&](auto full) {
      for (int i0 = 0; i0 < cnt; i0 += G) {  // rows past cnt are padding: E = 0
        T v[G][C];
#pragma unroll
        for (int g = 0; g < G; ++g) {
#pragma unroll
          for (int c = 0; c < C; ++c) v[g][c] = T(0);
          T m_[QC], r_[QC];
#pragma unroll
          for (int q = 0; q < QC; ++q) {
            m_[q] = s_mu[(i0 + g) * QC + q];
            r_[q] = s_r[(i0 + g) * QC + q];
          }
          const T lg = s_lg[i0 + g];
#pragma unroll
          for (int k = 0; k < K; ++k) {
            if (decltype(full)::value || live[k]) {
              T e = lg, d[QC], dr[QC];
#pragma unroll
              for (int q = 0; q < QC; ++q) {
                d[q] = m_[q] - zb[k][q];
                dr[q] = d[q] * r_[q];
                e = fma_t(-dr[q], d[q], e);
              }
              const T E = exp2_neg(e, s_tab);
              runP[k] += E;
              const T Tw = gw[k] * E;
              v[g][0] += Tw;
#pragma unroll
              for (int q = 0; q < QC; ++q) {
                runA[k][q] = fma_t(E, dr[q], runA[k][q]);  // A in r' units, rescaled below
                const T Td = Tw * d[q];
                v[g][1 + q] += Td;
                v[g][1 + QC + q] = fma_t(Td, d[q], v[g][1 + QC + q]);
                v[g][1 + 2 * QC + q] = fma_t(Tw, zd2[k][q], v[g][1 + 2 * QC + q]);
              }
            }
          }
        }
        warp_reduce_points(v, lane);
        if ((lane & (32 / G - 1)) == 0) {
          const int i = i0 + (lane >> (5 - log2_of(G)));
#pragma unroll
          for (int c = 0; c < C; ++c) s_w[(warp * R + i) * C + c] = v[0][c];
        }
      }
    };
    if (all_live) {
      sweep(Flag<true>{});
    } else {
      sweep(Flag<false>{});
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      add_to_total<T>(accP[k], errP[k], static_cast<double>(runP[k]));
#pragma unroll
      for (int q = 0; q < QC; ++q)
        add_to_total<T>(accA[k][q], errA[k][q], static_cast<double>(runA[k][q]));
    }
    store_point_sums(s_w, pt, blockIdx.x, C, R, N, base, cnt);
  }

  T* out = pair_part + static_cast<size_t>(p) * (1 + QC) * npairs;
  const Carry cy = split_carry(carry, P, p, QC, npairs, carry_in, carry_out);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int t = first + k * kThreads + tid;
    if (t < npairs) {
      if (carry_total<T>(cy, t, accP[k], errP[k])) out[t] = static_cast<T>(accP[k] + errP[k]);
#pragma unroll
      for (int q = 0; q < QC; ++q) {
        const size_t i = static_cast<size_t>(1 + q) * npairs + t;
        if (carry_total<T>(cy, i, accA[k][q], errA[k][q]))
          out[i] = static_cast<T>((accA[k][q] + errA[k][q]) / staged_r_scale<T>());
      }
    }
  }
}

// the block's 8 warp totals of each (staged point, kind of the pass q0 of
// pair_kernel_rt), summed in warp order and written to pt[pb, c, base + i]
// at the point's full kind c (t only in the pass q0 = 0)
template <typename T>
__device__ __forceinline__ void store_pass_sums(const T* s_w, T* pt, int pb, int Q, int q0,
                                                int R, int N, int base, int cnt) {
  constexpr int QB = kQChunkPair, CB = 1 + 3 * QB;
  __syncthreads();
  for (int j = threadIdx.x; j < cnt * CB; j += kThreads) {
    const int cb = j / cnt;
    const int i = j - cb * cnt;
    int c = 0;  // t, written in the first pass
    if (cb == 0) {
      if (q0 != 0) continue;
    } else {
      const int kind = (cb - 1) / QB;  // sd, sv, tz
      const int q = q0 + (cb - 1) - kind * QB;
      if (q >= Q) continue;
      c = 1 + kind * Q + q;
    }
    T s = s_w[i * CB + cb];
#pragma unroll
    for (int w = 1; w < kBlockWarps; ++w) s += s_w[(w * R + i) * CB + cb];
    pt[(static_cast<size_t>(pb) * (1 + 3 * Q) + c) * N + base + i] = s;
  }
}

// the run-time-Q instance: one slot a thread, zbar of every q in shared
// memory; the pair sums A and the per-point sums t, sd, sv, tz in passes of
// kQChunkPair q's over the split, each pass evaluating the exponentials
// again (P and t in the first), so registers and shared memory hold one
// pass's q's (Q = 5..8 one pass, 9..16 two)
template <typename T>
__global__ void __launch_bounds__(kThreads)
pair_kernel_rt(const T* __restrict__ mu, const T* __restrict__ S,
               const T* __restrict__ Z, const T* __restrict__ l2,
               const T* __restrict__ Gw, T* __restrict__ pair_part,
               double* __restrict__ carry, T* __restrict__ pt, int N, int M, int Q,
               int P, int carry_in, int carry_out) {
  constexpr int R = pair_run(0);
  constexpr int QB = kQChunkPair, CB = 1 + 3 * QB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* s_tab = reinterpret_cast<double*>(smem_raw);  // [32] (double only)
  T* s_zb = reinterpret_cast<T*>(s_tab + 32);           // [Q][kThreads]
  T* s_mu = s_zb + Q * kThreads;                        // [R][Q]
  T* s_r = s_mu + R * Q;                                // [R][Q]
  T* s_lg = s_r + R * Q;                                // [R]
  T* s_w = s_lg + R;                                    // [kBlockWarps][R][CB]

  const int npairs = M * (M + 1) / 2;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int first = blockIdx.x * kThreads;
  const int t = first + tid;
  const bool live = first + (tid & ~31) < npairs;
  const int p = blockIdx.y;
  int n0, n1;
  split_range(N, P, p, &n0, &n1);
  load_exp2_table<T>(s_tab);
  int a, b;
  pair_of(min(t, npairs - 1), M, &a, &b);
  for (int q = 0; q < Q; ++q)
    s_zb[q * kThreads + tid] = T(0.5) * (Z[static_cast<size_t>(a) * Q + q] +
                                         Z[static_cast<size_t>(b) * Q + q]);
  const T gw = t < npairs ? Gw[static_cast<size_t>(a) * M + b] : T(0);
  T* out = pair_part + static_cast<size_t>(p) * (1 + Q) * npairs;

  for (int q0 = 0; q0 < Q; q0 += QB) {
    T zd2[QB];
#pragma unroll
    for (int qq = 0; qq < QB; ++qq) {
      const int q = min(q0 + qq, Q - 1);
      const T za = Z[static_cast<size_t>(a) * Q + q], zz = Z[static_cast<size_t>(b) * Q + q];
      zd2[qq] = (za - zz) * (za - zz);
    }
    double accP = 0.0, errP = 0.0, accA[QB], errA[QB];
#pragma unroll
    for (int qq = 0; qq < QB; ++qq) accA[qq] = errA[qq] = 0.0;
    for (int base = n0; base < n1; base += R) {
      const int cnt = min(R, n1 - base);
      stage_psi2_points(s_mu, s_r, s_lg, mu, S, l2, base, cnt, R, Q);
      T runP = T(0), runA[QB];
#pragma unroll
      for (int qq = 0; qq < QB; ++qq) runA[qq] = T(0);
      for (int i = 0; i < cnt; ++i) {
        const T* m_ = s_mu + i * Q;
        const T* r_ = s_r + i * Q;
        T E = T(0);
        if (live) {
          T e = s_lg[i];
          for (int q = 0; q < Q; ++q) {
            const T d = m_[q] - s_zb[q * kThreads + tid];
            e = fma_t(-(d * r_[q]), d, e);
          }
          E = exp2_neg(e, s_tab);
          runP += E;
#pragma unroll
          for (int qq = 0; qq < QB; ++qq) {
            const int q = q0 + qq;
            if (q < Q) {
              const T d = m_[q] - s_zb[q * kThreads + tid];
              runA[qq] = fma_t(E, d * r_[q], runA[qq]);
            }
          }
        }
        const T Tw = gw * E;
        T* w = s_w + (warp * R + i) * CB;
        const T tsum = warp_sum(Tw);
        if (lane == 0) w[0] = tsum;
#pragma unroll
        for (int qq = 0; qq < QB; ++qq) {
          const int q = q0 + qq;
          if (q < Q) {
            const T d = m_[q] - s_zb[q * kThreads + tid];
            const T Td = Tw * d;
            const T sd = warp_sum(Td);
            const T sv = warp_sum(Td * d);
            const T tz = warp_sum(Tw * zd2[qq]);
            if (lane == 0) {
              w[1 + qq] = sd;
              w[1 + QB + qq] = sv;
              w[1 + 2 * QB + qq] = tz;
            }
          }
        }
      }
      add_to_total<T>(accP, errP, static_cast<double>(runP));
#pragma unroll
      for (int qq = 0; qq < QB; ++qq)
        add_to_total<T>(accA[qq], errA[qq], static_cast<double>(runA[qq]));
      store_pass_sums(s_w, pt, blockIdx.x, Q, q0, R, N, base, cnt);
    }
    const Carry cy = split_carry(carry, P, p, Q, npairs, carry_in, carry_out);
    if (t < npairs) {  // P is summed in every pass but kept from the first
      if (q0 == 0 && carry_total<T>(cy, t, accP, errP)) out[t] = static_cast<T>(accP + errP);
#pragma unroll
      for (int qq = 0; qq < QB; ++qq) {
        const size_t i = static_cast<size_t>(1 + q0 + qq) * npairs + t;
        if (q0 + qq < Q && carry_total<T>(cy, i, accA[qq], errA[qq]))
          out[i] = static_cast<T>((accA[qq] + errA[qq]) / staged_r_scale<T>());
      }
    }
  }
}

template <typename T>
using PairKernel = void (*)(const T*, const T*, const T*, const T*, const T*, T*, double*,
                            T*, int, int, int, int, int, int);

template <typename T>
PairKernel<T> pair_kernel_for(int Q) {
  switch (Q) {
    case 1: return pair_kernel<T, 1>;
    case 2: return pair_kernel<T, 2>;
    case 3: return pair_kernel<T, 3>;
    case 4: return pair_kernel<T, 4>;
    default: return pair_kernel_rt<T>;
  }
}

template <typename T>
size_t pair_smem_bytes(int Q) {
  const int qc = compile_q(Q);
  const size_t R = pair_run(qc);
  if (qc > 0)
    return sizeof(double) * 32 + sizeof(T) * (2 * R * Q + R + kBlockWarps * R * (1 + 3 * Q));
  return sizeof(double) * 32 +
         sizeof(T) * (static_cast<size_t>(Q) * kThreads + 2 * R * Q + R +
                      kBlockWarps * R * (1 + 3 * kQChunkPair));
}

// pair blocks of the pair pass at (M, Q)
inline int pair_blocks(int M, int Q) {
  const int per = pair_slots(compile_q(Q)) * kThreads;
  return (M * (M + 1) / 2 + per - 1) / per;
}

// the pair pass over P N-splits of one chunk of N points (mu, S start at
// the chunk): packed pair partials (P, Q + 1, M (M + 1) / 2) from the last
// chunk, running totals in carry between chunks, and per-point sums
// (pair_blocks(M, Q), 1 + 3Q, N)
template <typename T>
cudaError_t pair_pass(int P, cudaStream_t stream, const T* mu, const T* S,
                      const T* Z, const T* l2, const T* Gw, T* pair_part,
                      double* carry, T* pt, int N, int M, int Q, int carry_in,
                      int carry_out) {
  const PairKernel<T> fn = pair_kernel_for<T>(Q);
  const size_t smem = pair_smem_bytes<T>(Q);
  const cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return err;
  fn<<<dim3(pair_blocks(M, Q), P), kThreads, smem, stream>>>(
      mu, S, Z, l2, Gw, pair_part, carry, pt, N, M, Q, P, carry_in, carry_out);
  return cudaGetLastError();
}

// what the host needs to lay out a pair pass: out = [pairs per block,
// resident blocks per multiprocessor, staged run, points per warp reduction]
template <typename T>
cudaError_t pair_geometry(int Q, int* out) {
  const int qc = compile_q(Q);
  out[0] = pair_slots(qc) * kThreads;
  out[2] = pair_run(qc);
  out[3] = pair_group(qc);
  return blocks_per_sm(pair_kernel_for<T>(Q), pair_smem_bytes<T>(Q), &out[1]);
}

// ---------------------------------------------------------------------------
// point pass: one thread per datapoint
// ---------------------------------------------------------------------------

// the point's term q: from registers (compile-time Q) or from shared memory
// ([Q][kThreads], run-time Q)
template <int QC, typename T, int QB>
__device__ __forceinline__ T point_term(const T (&reg)[QB], const T* sm, int q) {
  if constexpr (QC > 0) {
    return reg[q];
  } else {
    return sm[q * kThreads + threadIdx.x];
  }
}

// kind c of a point's per-point sums (src = pt + n), summed over the NPB
// pair blocks in order, in double
template <typename T>
__device__ __forceinline__ T point_sum(const T* src, int NPB, int C, int N, int c) {
  double acc = 0.0;
  for (int pb = 0; pb < NPB; ++pb)
    acc += static_cast<double>(src[(static_cast<size_t>(pb) * C + c) * N]);
  return static_cast<T>(acc);
}

// a fixed-order tree over the block of each thread's val, to out[k]; k is
// block-uniform
template <typename T>
__device__ __forceinline__ void block_sum(T* s_red, T val, T* out, int k) {
  const int tid = threadIdx.x;
  s_red[tid] = val;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (tid < h) s_red[tid] += s_red[tid + h];
    __syncthreads();
  }
  if (tid == 0) out[k] = s_red[0];
  __syncthreads();
}

// QC > 0: Q is the compile-time QC, the point's terms in registers and
// its moments summed in one pass. QC == 0: Q read at run time, the moments
// summed kMaxQ q's a pass over the point's own terms (the psi1 branch's
// exponentials evaluated again each pass, dY and s1 in the first), the
// point's mu and b for every q in shared memory ([Q][kThreads] each, psi1
// branch only).
// kPsi1: with the psi1/psiY branch (the fused reverse pass); without it
// (the psi2-only reverse pass) Y, gyv and dY are not touched and D is unused.
// pt: the pair pass's (NPB, 1 + 3Q, N) per-point sums of the chunk.
// part: (gridDim.x, Q + 1) block partials of [dl_point (Q), dv_raw].
template <typename T, int QC, bool kPsi1>
__global__ void __launch_bounds__(kThreads)
point_kernel(const T* __restrict__ mu, const T* __restrict__ S,
             const T* __restrict__ Y, const T* __restrict__ Z,
             const T* __restrict__ l2, const T* __restrict__ ls,
             const T* __restrict__ gyv, const T* __restrict__ pt,
             T* __restrict__ dmu, T* __restrict__ dS, T* __restrict__ dY,
             T* __restrict__ part, int N, int M, int Q, int D, int NPB) {
  constexpr int QB = QC > 0 ? QC : kMaxQ;  // q's a pass
  const int Qn = QC > 0 ? QC : Q;
  __shared__ T s_red[kThreads];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_pm = reinterpret_cast<T*>(smem_raw);  // QC == 0 and kPsi1: [Q][kThreads]
  T* s_pb = s_pm + static_cast<size_t>(Qn) * kThreads;
  const int tid = threadIdx.x;
  const int n = blockIdx.x * kThreads + tid;
  const bool live = n < N;
  const size_t nn = static_cast<size_t>(live ? n : N - 1);  // dead threads read a real point
  const T w = live ? T(1) : T(0);

  // compile-time Q: the point's mu, S, b = 1 / (l2 + S), r = 1 / (l2 + 2 S)
  T m_[QB], s_[QB], b_[QB], r_[QB], lg1 = T(0);
#pragma unroll
  for (int q = 0; q < Qn; ++q) {
    const T s = S[nn * Qn + q];
    const T l2q = l2[q];
    if constexpr (QC > 0) {
      m_[q] = mu[nn * Qn + q];
      s_[q] = s;
      b_[q] = T(1) / (l2q + s);
      r_[q] = T(1) / (l2q + T(2) * s);
    } else if constexpr (kPsi1) {
      s_pm[q * kThreads + tid] = mu[nn * Qn + q];
      s_pb[q * kThreads + tid] = T(1) / (l2q + s);
    }
    lg1 += log1p_t(s / l2q);
  }
  lg1 = T(-0.5) * lg1;

  // the pair pass's per-point sums, pair block by pair block, in double.
  // tz is the zterm part of dl (eq. (20)), sum T (z_a - z_b)^2: summed from
  // the point's own terms, not from the pair sums P, because g2 can be large
  // and cancel across pairs, and a point's rounding then stays that point's
  const int C = 1 + 3 * Qn;
  const T* src = pt + nn;
  T* out = part + static_cast<size_t>(blockIdx.x) * (Qn + 1);
  const T t = point_sum(src, NPB, C, N, 0);
  T s1 = T(0);
#pragma unroll
  for (int q0 = 0; q0 < Qn; q0 += QB) {
    // ---------------- psi1 branch (eq. (8), (10)-(12)) ----------------
    T s1d[QB], s1v[QB];
#pragma unroll
    for (int qq = 0; qq < QB; ++qq) s1d[qq] = s1v[qq] = T(0);
    if constexpr (kPsi1) {
      const T* y = Y + nn * D;
      // dY in the first pass, kDChunk columns a sweep over m; later passes
      // sweep once for the moments
      for (int d0 = 0; d0 < (q0 == 0 ? D : 1); d0 += kDChunk) {
        T dy[kDChunk];
#pragma unroll
        for (int j = 0; j < kDChunk; ++j) dy[j] = T(0);
        for (int m = 0; m < M; ++m) {
          const T* zm = Z + static_cast<size_t>(m) * Qn;
          T e = lg1;
#pragma unroll
          for (int q = 0; q < Qn; ++q) {
            const T dq = point_term<QC>(m_, s_pm, q) - __ldg(zm + q);
            e -= T(0.5) * dq * dq * point_term<QC>(b_, s_pb, q);
          }
          const T blk = exp_t(e);
          const T* g = gyv + static_cast<size_t>(m) * D;
          if (d0 == 0) {
            T yg = T(0);
            for (int d = 0; d < D; ++d) yg += y[d] * __ldg(g + d);
            const T w1 = yg * blk;
            if (q0 == 0) s1 += w1;
#pragma unroll
            for (int qq = 0; qq < QB; ++qq) {
              const int q = q0 + qq;
              if (q < Qn) {
                const T dq = point_term<QC>(m_, s_pm, q) - __ldg(zm + q);
                s1d[qq] += w1 * dq;
                s1v[qq] += w1 * dq * dq;
              }
            }
          }
          if (q0 == 0) {
#pragma unroll
            for (int j = 0; j < kDChunk; ++j)
              if (d0 + j < D) dy[j] += blk * __ldg(g + d0 + j);
          }
        }
        if (live && q0 == 0) {
#pragma unroll
          for (int j = 0; j < kDChunk; ++j)
            if (d0 + j < D) dY[nn * D + d0 + j] = dy[j];
        }
      }
    }

    // ---- psi2 branch (eq. (9), (15)-(17)): per-point outputs and dl ----
#pragma unroll
    for (int qq = 0; qq < QB; ++qq) {
      const int q = q0 + qq;
      if (q < Qn) {
        T s, bq, rq;
        if constexpr (QC > 0) {  // q == qq
          s = s_[qq], bq = b_[qq], rq = r_[qq];
        } else {
          s = S[nn * Qn + q];
          bq = T(1) / (l2[q] + s), rq = T(1) / (l2[q] + T(2) * s);
        }
        const T lq = ls[q];
        const T sd = point_sum(src, NPB, C, N, 1 + q);
        const T sv = point_sum(src, NPB, C, N, 1 + Qn + q);
        const T tz = point_sum(src, NPB, C, N, 1 + 2 * Qn + q);
        if (live) {
          dmu[nn * Qn + q] = -bq * s1d[qq] - T(2) * rq * sd;  // eq. (10) + (16)
          dS[nn * Qn + q] = T(-0.5) * bq * s1 + T(0.5) * bq * bq * s1v[qq]
                            - rq * t + T(2) * rq * rq * sv;  // eq. (11) + (17)
        }
        block_sum(s_red, w * ((s * bq / lq) * s1 + lq * bq * bq * s1v[qq]
                              + (T(2) / lq) * s * rq * t + T(2) * lq * rq * rq * sv
                              + T(0.5) * tz / (lq * lq * lq)), out, q);  // eq. (14) + (20)
      }
    }
  }
  block_sum(s_red, w * (s1 + T(2) * t), out, Qn);  // eq. (13) + (19), times v
}

template <typename T, bool kPsi1>
using PointKernel = void (*)(const T*, const T*, const T*, const T*, const T*,
                             const T*, const T*, const T*, T*, T*, T*, T*, int, int,
                             int, int, int);

template <typename T, bool kPsi1>
PointKernel<T, kPsi1> point_kernel_for(int Q) {
  switch (Q) {
    case 1: return point_kernel<T, 1, kPsi1>;
    case 2: return point_kernel<T, 2, kPsi1>;
    case 3: return point_kernel<T, 3, kPsi1>;
    case 4: return point_kernel<T, 4, kPsi1>;
    default: return point_kernel<T, 0, kPsi1>;
  }
}

// dynamic shared memory of a point-pass block: the run-time-Q instance's
// per-point mu and b (psi1 branch only)
template <typename T, bool kPsi1>
size_t point_smem_bytes(int Q) {
  return compile_q(Q) == 0 && kPsi1 ? 2 * sizeof(T) * static_cast<size_t>(Q) * kThreads : 0;
}

// the point pass over NB = ceil(N / kThreads) blocks of one chunk of N
// points (every per-point pointer starts at the chunk), reading the pair
// pass's per-point sums pt
template <typename T, bool kPsi1>
cudaError_t point_pass(int NB, cudaStream_t stream, const T* mu, const T* S,
                       const T* Y, const T* Z, const T* l2, const T* ls,
                       const T* gyv, const T* pt, T* dmu, T* dS, T* dY, T* part,
                       int N, int M, int Q, int D) {
  const PointKernel<T, kPsi1> fn = point_kernel_for<T, kPsi1>(Q);
  const size_t smem = point_smem_bytes<T, kPsi1>(Q);
  const cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return err;
  fn<<<NB, kThreads, smem, stream>>>(mu, S, Y, Z, l2, ls, gyv, pt, dmu, dS, dY, part, N, M,
                                  Q, D, pair_blocks(M, Q));
  return cudaGetLastError();
}

// The pair and point passes over N in chunks of CN points (CN a multiple of
// kThreads, or CN >= N), each chunk's pair pass then its point pass, so pt
// holds (pair blocks, 1 + 3Q, CN) sums. Y, gyv and dY are null without the
// psi1 branch. part: (ceil(N / kThreads), Q + 1), a chunk's blocks at its
// first point's block. The P splits' pair sums carry across chunks in carry
// ((2, P, Q + 1, M (M + 1) / 2) doubles; unused when one chunk covers N).
template <typename T, bool kPsi1>
cudaError_t run_chunks(int P, int CN, cudaStream_t stream, const T* mu, const T* S,
                       const T* Y, const T* Z, const T* l2, const T* ls, const T* Gw,
                       const T* gyv, T* pair_part, double* carry, T* pt, T* dmu, T* dS,
                       T* dY, T* part, int N, int M, int Q, int D) {
  if (CN < 1 || (CN < N && CN % kThreads != 0)) return cudaErrorInvalidValue;
  for (int c0 = 0; c0 < N; c0 += CN) {
    const int n = min(CN, N - c0);
    const size_t rq = static_cast<size_t>(c0) * Q;
    cudaError_t err = pair_pass<T>(P, stream, mu + rq, S + rq, Z, l2, Gw, pair_part, carry,
                                   pt, n, M, Q, c0 > 0, c0 + n < N);
    if (err != cudaSuccess) return err;
    const size_t rd = static_cast<size_t>(c0) * D;
    err = point_pass<T, kPsi1>((n + kThreads - 1) / kThreads, stream, mu + rq, S + rq,
                               kPsi1 ? Y + rd : nullptr, Z, l2, ls, gyv, pt, dmu + rq,
                               dS + rq, kPsi1 ? dY + rd : nullptr,
                               part + static_cast<size_t>(c0 / kThreads) * (Q + 1), n, M,
                               Q, D);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace
