// The reverse psi-statistics kernels' pair pass and point pass, shared by the
// fused reverse pass (suffstats_bwd.cu, kernel B2) and the psi2-only one
// (psi2_bwd.cu, kernel B4), as the TPU kernels share _psi2_bwd_tile. Equation
// numbers are those of docs/derivations/suffstats_vjp.md; suffstats_bwd.cu's
// header sets out what each pass computes and why it is laid out so.
//
//   pair pass, the forward's packed pair blocks x N-splits: evaluates each
//     E_nab once and feeds both
//       the per-pair sums P_ab = sum_n E_nab and A_abq = sum_n E_nab r_nq
//       (mu_nq - zbar_abq), kept in the thread's registers over its points,
//       from which the caller's O(M^2 Q) epilogue forms the psi2 part of dZ;
//       and the per-point sums over the block's pairs, with T = Gw_ab E_nab,
//       t = sum T, sd_q = sum T d_q, sv_q = sum T d_q^2 and
//       tz_q = sum T (z_aq - z_bq)^2 (d = mu - zbar), reduced across the
//       block's threads in a fixed order and written per (pair block,
//       point);
//   point pass, one thread per datapoint: sums a point's pair-block partials
//     in a fixed order, and forms dmu, dS (and dY with the psi1 branch) and
//     block partials of dl and v dv.
#pragma once

#include "common.cuh"

namespace {

constexpr int kMaxQ = 16;
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

// grid (pair blocks, P N-splits). pair_part: (P, 1 + Q, M (M + 1) / 2)
// packed partials of [P, A_1..A_Q]; pt: (pair blocks, 1 + 3Q, N) per-point
// sums [t, sd_1..Q, sv_1..Q, tz_1..Q]. Compile-time Q: zbar, (z_a - z_b)^2,
// Gw and the pair sums in registers.
template <typename T, int QC>
__global__ void __launch_bounds__(kThreads)
pair_kernel(const T* __restrict__ mu, const T* __restrict__ S,
            const T* __restrict__ Z, const T* __restrict__ l2,
            const T* __restrict__ Gw, T* __restrict__ pair_part,
            T* __restrict__ pt, int N, int M, int Q, int P) {
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
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int t = first + k * kThreads + tid;
    if (t < npairs) {
      out[t] = static_cast<T>(accP[k] + errP[k]);
#pragma unroll
      for (int q = 0; q < QC; ++q)
        out[static_cast<size_t>(1 + q) * npairs + t] =
            static_cast<T>((accA[k][q] + errA[k][q]) / staged_r_scale<T>());
    }
  }
}

// the run-time-Q instance (Q <= kMaxQ): one slot a thread, its zbar,
// (z_a - z_b)^2 and A sums in shared memory, each point's 1 + 3Q sums
// reduced by a plain xor tree kind by kind
template <typename T>
__global__ void __launch_bounds__(kThreads)
pair_kernel_rt(const T* __restrict__ mu, const T* __restrict__ S,
               const T* __restrict__ Z, const T* __restrict__ l2,
               const T* __restrict__ Gw, T* __restrict__ pair_part,
               T* __restrict__ pt, int N, int M, int Q, int P) {
  constexpr int R = pair_run(0);
  const int C = 1 + 3 * Q;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* s_tab = reinterpret_cast<double*>(smem_raw);  // [32] (double only)
  double* s_accA = s_tab + 32;                          // [2][Q][kThreads] sum, error
  T* s_zb = reinterpret_cast<T*>(s_accA + 2 * Q * kThreads);  // [Q][kThreads]
  T* s_zd2 = s_zb + Q * kThreads;                       // [Q][kThreads]
  T* s_runA = s_zd2 + Q * kThreads;                     // [Q][kThreads]
  T* s_mu = s_runA + Q * kThreads;                      // [R][Q]
  T* s_r = s_mu + R * Q;                                // [R][Q]
  T* s_lg = s_r + R * Q;                                // [R]
  T* s_w = s_lg + R;                                    // [kBlockWarps][R][C]

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
  for (int q = 0; q < Q; ++q) {
    const T za = Z[static_cast<size_t>(a) * Q + q];
    const T zz = Z[static_cast<size_t>(b) * Q + q];
    s_zb[q * kThreads + tid] = T(0.5) * (za + zz);
    s_zd2[q * kThreads + tid] = (za - zz) * (za - zz);
    s_accA[q * kThreads + tid] = s_accA[(Q + q) * kThreads + tid] = 0.0;
  }
  const T gw = t < npairs ? Gw[static_cast<size_t>(a) * M + b] : T(0);

  double accP = 0.0, errP = 0.0;
  for (int base = n0; base < n1; base += R) {
    const int cnt = min(R, n1 - base);
    stage_psi2_points(s_mu, s_r, s_lg, mu, S, l2, base, cnt, R, Q);
    T runP = T(0);
    for (int q = 0; q < Q; ++q) s_runA[q * kThreads + tid] = T(0);
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
        for (int q = 0; q < Q; ++q) {
          const T d = m_[q] - s_zb[q * kThreads + tid];
          s_runA[q * kThreads + tid] = fma_t(E, d * r_[q], s_runA[q * kThreads + tid]);
        }
      }
      const T Tw = gw * E;
      T* w = s_w + (warp * R + i) * C;
      const T tsum = warp_sum(Tw);
      if (lane == 0) w[0] = tsum;
      for (int q = 0; q < Q; ++q) {
        const T d = m_[q] - s_zb[q * kThreads + tid];
        const T Td = Tw * d;
        const T sd = warp_sum(Td);
        const T sv = warp_sum(Td * d);
        const T tz = warp_sum(Tw * s_zd2[q * kThreads + tid]);
        if (lane == 0) {
          w[1 + q] = sd;
          w[1 + Q + q] = sv;
          w[1 + 2 * Q + q] = tz;
        }
      }
    }
    add_to_total<T>(accP, errP, static_cast<double>(runP));
    for (int q = 0; q < Q; ++q)
      add_to_total<T>(s_accA[q * kThreads + tid], s_accA[(Q + q) * kThreads + tid],
                      static_cast<double>(s_runA[q * kThreads + tid]));
    store_point_sums(s_w, pt, blockIdx.x, C, R, N, base, cnt);
  }

  if (t < npairs) {
    T* out = pair_part + static_cast<size_t>(p) * (1 + Q) * npairs;
    out[t] = static_cast<T>(accP + errP);
    for (int q = 0; q < Q; ++q)
      out[static_cast<size_t>(1 + q) * npairs + t] = static_cast<T>(
          (s_accA[q * kThreads + tid] + s_accA[(Q + q) * kThreads + tid]) /
          staged_r_scale<T>());
  }
}

template <typename T>
using PairKernel = void (*)(const T*, const T*, const T*, const T*, const T*, T*, T*,
                            int, int, int, int);

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
  const size_t run = sizeof(T) * (2 * R * Q + R + kBlockWarps * R * (1 + 3 * Q));
  if (qc > 0) return sizeof(double) * 32 + run;
  return sizeof(double) * (32 + 2 * static_cast<size_t>(Q) * kThreads)
         + sizeof(T) * 3 * Q * kThreads + run;
}

// pair blocks of the pair pass at (M, Q)
inline int pair_blocks(int M, int Q) {
  const int per = pair_slots(compile_q(Q)) * kThreads;
  return (M * (M + 1) / 2 + per - 1) / per;
}

// the pair pass over P N-splits: packed pair partials (P, Q + 1, M (M + 1) / 2)
// and per-point sums (pair_blocks(M, Q), 1 + 3Q, N)
template <typename T>
cudaError_t pair_pass(int P, cudaStream_t stream, const T* mu, const T* S,
                      const T* Z, const T* l2, const T* Gw, T* pair_part, T* pt,
                      int N, int M, int Q) {
  const PairKernel<T> fn = pair_kernel_for<T>(Q);
  const size_t smem = pair_smem_bytes<T>(Q);
  const cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return err;
  fn<<<dim3(pair_blocks(M, Q), P), kThreads, smem, stream>>>(mu, S, Z, l2, Gw, pair_part,
                                                            pt, N, M, Q, P);
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

// QC > 0: Q is the compile-time QC; QC == 0: Q (<= kMaxQ) read at run time.
// kPsi1: with the psi1/psiY branch (the fused reverse pass); without it
// (the psi2-only reverse pass) Y, gyv and dY are not touched and D is unused.
// pt: the pair pass's (NPB, 1 + 3Q, N) per-point sums.
// part: (gridDim.x, Q + 1) block partials of [dl_point (Q), dv_raw].
template <typename T, int QC, bool kPsi1>
__global__ void __launch_bounds__(kThreads)
point_kernel(const T* __restrict__ mu, const T* __restrict__ S,
             const T* __restrict__ Y, const T* __restrict__ Z,
             const T* __restrict__ l2, const T* __restrict__ ls,
             const T* __restrict__ gyv, const T* __restrict__ pt,
             T* __restrict__ dmu, T* __restrict__ dS, T* __restrict__ dY,
             T* __restrict__ part, int N, int M, int Q, int D, int NPB) {
  constexpr int QA = QC > 0 ? QC : kMaxQ;
  const int Qn = QC > 0 ? QC : Q;
  __shared__ T s_red[kThreads];
  const int tid = threadIdx.x;
  const int n = blockIdx.x * kThreads + tid;
  const bool live = n < N;
  const size_t nn = static_cast<size_t>(live ? n : N - 1);  // dead threads read a real point
  const T w = live ? T(1) : T(0);

  T m_[QA], s_[QA], r[QA], b[QA];
  T lg1 = T(0);
#pragma unroll
  for (int q = 0; q < QA; ++q) {
    m_[q] = s_[q] = r[q] = b[q] = T(0);
    if (q < Qn) {
      const T s = S[nn * Qn + q];
      const T l2q = l2[q];
      m_[q] = mu[nn * Qn + q];
      s_[q] = s;
      r[q] = T(1) / (l2q + T(2) * s);
      b[q] = T(1) / (l2q + s);
      lg1 += log1p_t(s / l2q);
    }
  }
  lg1 = T(-0.5) * lg1;

  // ---------------- psi1 branch (eq. (8), (10)-(12)) ----------------
  T s1 = T(0), s1d[QA], s1v[QA];
#pragma unroll
  for (int q = 0; q < QA; ++q) s1d[q] = s1v[q] = T(0);
  if constexpr (kPsi1) {
    const T* y = Y + nn * D;
    for (int d0 = 0; d0 < D; d0 += kDChunk) {
      T dy[kDChunk];
#pragma unroll
      for (int j = 0; j < kDChunk; ++j) dy[j] = T(0);
      for (int m = 0; m < M; ++m) {
        T e = lg1;
        T dq[QA];
#pragma unroll
        for (int q = 0; q < QA; ++q) {
          dq[q] = T(0);
          if (q < Qn) {
            dq[q] = m_[q] - __ldg(Z + static_cast<size_t>(m) * Qn + q);
            e -= T(0.5) * dq[q] * dq[q] * b[q];
          }
        }
        const T blk = exp_t(e);
        const T* g = gyv + static_cast<size_t>(m) * D;
        if (d0 == 0) {
          T yg = T(0);
          for (int d = 0; d < D; ++d) yg += y[d] * __ldg(g + d);
          const T w1 = yg * blk;
          s1 += w1;
#pragma unroll
          for (int q = 0; q < QA; ++q) {
            if (q < Qn) {
              s1d[q] += w1 * dq[q];
              s1v[q] += w1 * dq[q] * dq[q];
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kDChunk; ++j)
          if (d0 + j < D) dy[j] += blk * __ldg(g + d0 + j);
      }
      if (live) {
#pragma unroll
        for (int j = 0; j < kDChunk; ++j)
          if (d0 + j < D) dY[nn * D + d0 + j] = dy[j];
      }
    }
  }

  // ---------------- psi2 branch (eq. (9), (15)-(17)) ----------------
  // the pair pass's per-point sums, pair block by pair block, in double.
  // tz is the zterm part of dl (eq. (20)), sum T (z_a - z_b)^2: summed from
  // the point's own terms, not from the pair sums P, because g2 can be large
  // and cancel across pairs, and a point's rounding then stays that point's
  const int C = 1 + 3 * Qn;
  const T* src = pt + nn;
  // kind c of the point, summed over the pair blocks in order, in double
  auto point_sum = [&](int c) {
    double acc = 0.0;
    for (int pb = 0; pb < NPB; ++pb)
      acc += static_cast<double>(src[(static_cast<size_t>(pb) * C + c) * N]);
    return static_cast<T>(acc);
  };
  const T t = point_sum(0);

  // ---------------- per-point outputs and block partials ----------------
  T dl_pt[QA];
#pragma unroll
  for (int q = 0; q < QA; ++q) {
    dl_pt[q] = T(0);
    if (q < Qn) {
      const T bq = b[q], rq = r[q], lq = ls[q];
      const T sd = point_sum(1 + q), sv = point_sum(1 + Qn + q);
      const T tz = point_sum(1 + 2 * Qn + q);
      if (live) {
        dmu[nn * Qn + q] = -bq * s1d[q] - T(2) * rq * sd;  // eq. (10) + (16)
        dS[nn * Qn + q] = T(-0.5) * bq * s1 + T(0.5) * bq * bq * s1v[q]
                          - rq * t + T(2) * rq * rq * sv;  // eq. (11) + (17)
      }
      dl_pt[q] = w * ((s_[q] * bq / lq) * s1 + lq * bq * bq * s1v[q]
                      + (T(2) / lq) * s_[q] * rq * t + T(2) * lq * rq * rq * sv
                      + T(0.5) * tz / (lq * lq * lq));  // eq. (14) + (20)
    }
  }
  const T dv_pt = w * (s1 + T(2) * t);  // eq. (13) + (19), times v
  // fixed-order tree sums over the block (k is block-uniform)
#pragma unroll
  for (int k = 0; k < QA + 1; ++k) {
    if (k <= Qn) {
      s_red[tid] = k < Qn ? dl_pt[k < QA ? k : 0] : dv_pt;
      __syncthreads();
      for (int h = kThreads / 2; h > 0; h >>= 1) {
        if (tid < h) s_red[tid] += s_red[tid + h];
        __syncthreads();
      }
      if (tid == 0) part[static_cast<size_t>(blockIdx.x) * (Qn + 1) + k] = s_red[0];
      __syncthreads();
    }
  }
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

// the point pass over NB = ceil(N / kThreads) blocks, reading the pair
// pass's per-point sums pt
template <typename T, bool kPsi1>
cudaError_t point_pass(int NB, cudaStream_t stream, const T* mu, const T* S,
                       const T* Y, const T* Z, const T* l2, const T* ls,
                       const T* gyv, const T* pt, T* dmu, T* dS, T* dY, T* part,
                       int N, int M, int Q, int D) {
  const PointKernel<T, kPsi1> fn = point_kernel_for<T, kPsi1>(Q);
  fn<<<NB, kThreads, 0, stream>>>(mu, S, Y, Z, l2, ls, gyv, pt, dmu, dS, dY, part, N, M,
                                  Q, D, pair_blocks(M, Q));
  return cudaGetLastError();
}

}  // namespace
