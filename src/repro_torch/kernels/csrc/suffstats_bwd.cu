// Reverse pass of the fused psi-statistics for the RBF-ARD kernel, written by
// hand for Hopper (sm_90a): every input cotangent of (psi2, psiY) from one
// read of the datapoints per pass.
//
// Replaces: src/repro/kernels/suffstats.py: suffstats_bwd_pallas (the Pallas
// TPU kernel _suffstats_bwd_kernel). Equation numbers are those of
// docs/derivations/suffstats_vjp.md. With l2 = l^2, r = 1 / (l2 + 2 S),
// b = 1 / (l2 + S), zbar_ab = (z_a + z_b) / 2 and the forward's factors
//
//   E_nab = exp(-1/2 sum_q log1p(2 S_nq / l2_q) - sum_q (mu_nq - zbar_abq)^2 r_nq)
//   K_nm  = exp(-1/2 sum_q log1p(S_nq / l2_q) - 1/2 sum_q (mu_nq - z_mq)^2 b_nq)
//
// the caller folds the (m, m')-only prefactor into the psi2 cotangent,
// G2p = g2 v^2 exp(zterm) (eq. (9)), passes Gw = the upper triangle of
// G2p + G2p^T with G2p's diagonal (E is symmetric, so only a <= b is
// visited) and gyv = v gY. The kernels compute
//
//   point pass, per datapoint n (eq. (10)-(11), (16)-(17)):
//     W1_m = (y_n . gyv_m) K_nm                          (eq. (8))
//     s1 = sum_m W1_m, s1d = sum_m W1_m (mu - z_m), s1v = sum_m W1_m (mu - z_m)^2
//     t = sum_{a<=b} Gw_ab E_ab, sd = sum Gw E (mu - zbar), sv = sum Gw E (mu - zbar)^2
//     dmu = -b s1d - 2 r sd
//     dS  = -b s1 / 2 + b^2 s1v / 2 - r t + 2 r^2 sv
//     dY_n = sum_m K_nm gyv_m
//     dl (eq. (14), (20), its zterm part from tz = sum Gw E (z_a - z_b)^2)
//     and dv_raw = s1 + 2 t, summed over the points
//   pair pass, per (a, b) (the global psi2 sums of eq. (18)):
//     P_ab = sum_n E_nab,  A_abq = sum_n E_nab r_nq (mu_nq - zbar_abq)
//   dZ pass, per m (eq. (12)):
//     dz1_mq = sum_n W1_nm b_nq (mu_nq - z_mq)
//
// and the caller's O(M^2 Q) epilogue turns P and A into the psi2 part of dZ
// and divides dv_raw by v (eq. (13), (19)).
//
// What bounds it on this card: the least work is the forward's
// N M (M + 1) / 2 + N M exponentials, each once, and about 11 Q + 3
// floating-point operations per (point, pair) (chip_smoke.py: bwd_bound_ms)
// against O(N (Q + D)) bytes, so the exp units (float) or FP64 issue bound
// it, never memory. This design evaluates every exponential twice.
//
// What the design does about it:
//   * The exponent is the direct (mu - zbar)^2 r form of the forward kernel
//     (suffstats_fwd.cu), not the TPU kernel's expanded MXU form, so the
//     reverse pass differentiates the exponential the forward evaluates;
//     the moments use mu - zbar directly (no mu^2 t - 2 mu u + w2
//     cancellation in float32).
//   * The TPU kernel carries dZ, dv and dl across its sequential grid; here
//     blocks run concurrently, so every global sum is written as per-block
//     partials and a second kernel sums them in an order fixed by the shapes.
//     No atomics: results are bitwise equal from run to run.
//   * Per-point sums need every pair for a point and per-pair sums need
//     every point for a pair, so the two run as separate passes: one thread
//     per datapoint walking the upper-triangular pairs (Gw and Z are read
//     at one address per warp, a broadcast), and a pair-parallel pass laid
//     out like the forward's psi2 (upper-triangular 32 x 32 tiles x
//     N-splits, staged points, register sums). The exponentials are thus
//     evaluated twice; a later version may share them.
//   * The loss's g2 can be large and cancel across pairs (inducing points
//     that crowd, as the facades' init draws them), and a float64 reverse
//     pass is then only as good as its summation (chip_smoke.py checks
//     both reverse passes against an extended-precision one). So sums run in
//     two levels (a point's pairs row by row; the pair pass's points run by
//     run, totals in double), and dl's zterm part is summed point by point
//     rather than contracted from P, where all of N's rounding meets the
//     cancellation at once.
//   * The TPU kernel's (TN, TM, TM) workspace is never formed; nothing larger
//     than a block's staging run lives in shared memory, whatever M is.
//   * Ragged N, M and D are masked at the bounds; nothing is padded.
//   * float and double instances compute in the input dtype; Q = 1..4 is a
//     compile-time constant (registers), larger Q (<= 16) runs a run-time-Q
//     instance.
#include "common.cuh"

namespace {

constexpr int kMaxQ = 16;
// dZ pass: kZTileM inducing points x kZLanes point lanes per block
constexpr int kZTileM = 32;
constexpr int kZLanes = kThreads / kZTileM;
constexpr int kZStage = 64;
// point pass: dY columns accumulated per sweep over m
constexpr int kDChunk = 8;

// ---------------------------------------------------------------------------
// point pass: one thread per datapoint
// ---------------------------------------------------------------------------

// QC > 0: Q is the compile-time QC; QC == 0: Q (<= kMaxQ) read at run time.
// part: (gridDim.x, Q + 1) block partials of [dl_point (Q), dv_raw].
template <typename T, int QC>
__global__ void __launch_bounds__(kThreads)
point_kernel(const T* __restrict__ mu, const T* __restrict__ S,
             const T* __restrict__ Y, const T* __restrict__ Z,
             const T* __restrict__ l2, const T* __restrict__ ls,
             const T* __restrict__ Gw, const T* __restrict__ gyv,
             T* __restrict__ dmu, T* __restrict__ dS, T* __restrict__ dY,
             T* __restrict__ part, int N, int M, int Q, int D) {
  constexpr int QA = QC > 0 ? QC : kMaxQ;
  const int Qn = QC > 0 ? QC : Q;
  __shared__ T s_red[kThreads];
  const int tid = threadIdx.x;
  const int n = blockIdx.x * kThreads + tid;
  const bool live = n < N;
  const size_t nn = static_cast<size_t>(live ? n : N - 1);  // dead threads read a real point
  const T w = live ? T(1) : T(0);

  T m_[QA], s_[QA], r[QA], b[QA];
  T lg1 = T(0), lg2 = T(0);
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
      lg2 += log1p_t(T(2) * s / l2q);
      lg1 += log1p_t(s / l2q);
    }
  }
  lg1 = T(-0.5) * lg1;
  lg2 = T(-0.5) * lg2;

  // ---------------- psi1 branch (eq. (8), (10)-(12)) ----------------
  T s1 = T(0), s1d[QA], s1v[QA];
#pragma unroll
  for (int q = 0; q < QA; ++q) s1d[q] = s1v[q] = T(0);
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

  // ---------------- psi2 branch (eq. (9), (15)-(17)) ----------------
  // two-level sums: each row a's pairs, then the rows. tz is the zterm
  // part of dl (eq. (20)), sum T (z_a - z_b)^2: summed here, point by point,
  // and not from the pair pass's P, because g2 can be large and cancel
  // across pairs, and a point's rounding then stays that point's
  T t = T(0), sd[QA], sv[QA], tz[QA];
#pragma unroll
  for (int q = 0; q < QA; ++q) sd[q] = sv[q] = tz[q] = T(0);
  for (int a = 0; a < M; ++a) {
    T ta = T(0), sda[QA], sva[QA], tza[QA];
#pragma unroll
    for (int q = 0; q < QA; ++q) sda[q] = sva[q] = tza[q] = T(0);
    T za[QA];
#pragma unroll
    for (int q = 0; q < QA; ++q)
      za[q] = q < Qn ? __ldg(Z + static_cast<size_t>(a) * Qn + q) : T(0);
    const T* grow = Gw + static_cast<size_t>(a) * M;
    for (int bb = a; bb < M; ++bb) {
      T e = lg2;
      T dq[QA], zd[QA];
#pragma unroll
      for (int q = 0; q < QA; ++q) {
        dq[q] = zd[q] = T(0);
        if (q < Qn) {
          const T zb = __ldg(Z + static_cast<size_t>(bb) * Qn + q);
          dq[q] = m_[q] - T(0.5) * (za[q] + zb);
          zd[q] = za[q] - zb;
          e -= dq[q] * dq[q] * r[q];
        }
      }
      const T ge = __ldg(grow + bb) * exp_t(e);
      ta += ge;
#pragma unroll
      for (int q = 0; q < QA; ++q) {
        if (q < Qn) {
          sda[q] += ge * dq[q];
          sva[q] += ge * dq[q] * dq[q];
          tza[q] += ge * zd[q] * zd[q];
        }
      }
    }
    t += ta;
#pragma unroll
    for (int q = 0; q < QA; ++q) {
      sd[q] += sda[q];
      sv[q] += sva[q];
      tz[q] += tza[q];
    }
  }

  // ---------------- per-point outputs and block partials ----------------
  T dl_pt[QA];
#pragma unroll
  for (int q = 0; q < QA; ++q) {
    dl_pt[q] = T(0);
    if (q < Qn) {
      const T bq = b[q], rq = r[q], lq = ls[q];
      if (live) {
        dmu[nn * Qn + q] = -bq * s1d[q] - T(2) * rq * sd[q];  // eq. (10) + (16)
        dS[nn * Qn + q] = T(-0.5) * bq * s1 + T(0.5) * bq * bq * s1v[q]
                          - rq * t + T(2) * rq * rq * sv[q];  // eq. (11) + (17)
      }
      dl_pt[q] = w * ((s_[q] * bq / lq) * s1 + lq * bq * bq * s1v[q]
                      + (T(2) / lq) * s_[q] * rq * t + T(2) * lq * rq * rq * sv[q]
                      + T(0.5) * tz[q] / (lq * lq * lq));  // eq. (14) + (20)
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

// ---------------------------------------------------------------------------
// pair pass: P_ab and A_abq over an N-split, upper-triangular tiles
// ---------------------------------------------------------------------------

// part: (P, Q + 1, M, M); slab 0 holds P, slab 1 + q holds A_q. With
// QC > 0 a block sums every slab; with QC == 0 block z sums A_z (and P when
// z == 0).
template <typename T, int QC>
__global__ void __launch_bounds__(kThreads)
pair_partial_kernel(const T* __restrict__ mu, const T* __restrict__ S,
                    const T* __restrict__ Z, const T* __restrict__ l2,
                    T* __restrict__ part, int N, int M, int Q, int P) {
  constexpr int QA = QC > 0 ? QC : 1;
  const int Qn = QC > 0 ? QC : Q;
  const int qsel = blockIdx.z;  // the run-time-Q instance's q
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Psi2Smem<T> sm = psi2_smem<T>(smem_raw, Qn);

  int ti, tj;
  tri_tile(blockIdx.x, (M + kTile - 1) / kTile, &ti, &tj);
  const int p = blockIdx.y;
  int n0, n1;
  split_range(N, P, p, &n0, &n1);
  const int tid = threadIdx.x;
  const int col = tid % kTile;
  const int row0 = tid / kTile;
  const int ma = ti * kTile;
  const int mb = tj * kTile;
  load_psi2_tile(sm, Z, l2, ma, mb, M, Qn);

  const int krows = min(kRows, max(0, (M - ma - row0 + kRowStep - 1) / kRowStep));
  // two-level sums, as the forward's: each staged run in T, the total in double
  double accP[kRows], accA[kRows][QA];
  T runP[kRows], runA[kRows][QA];
  T zb[kRows][QC > 0 ? QC : 1];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    accP[k] = 0.0;
#pragma unroll
    for (int q = 0; q < QA; ++q) accA[k][q] = 0.0;
    if constexpr (QC > 0) {
#pragma unroll
      for (int q = 0; q < QC; ++q)
        zb[k][q] = T(0.5) * (sm.za[(row0 + k * kRowStep) * QC + q] + sm.zb[col * QC + q]);
    }
  }

  for (int base = n0; base < n1; base += kStage) {
    const int cnt = min(kStage, n1 - base);
    stage_psi2_points(sm, mu, S, base, cnt, Qn);
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      runP[k] = T(0);
#pragma unroll
      for (int q = 0; q < QA; ++q) runA[k][q] = T(0);
    }
    if constexpr (QC > 0) {
      for (int i = 0; i < cnt; ++i) {
        T mu_i[QC], r_i[QC];
#pragma unroll
        for (int q = 0; q < QC; ++q) {
          mu_i[q] = sm.mu[i * QC + q];
          r_i[q] = sm.r[i * QC + q];
        }
        const T lg = sm.lg[i];
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          if (k < krows) {
            T e = lg;
            T d[QC];
#pragma unroll
            for (int q = 0; q < QC; ++q) {
              d[q] = mu_i[q] - zb[k][q];
              e -= d[q] * d[q] * r_i[q];
            }
            const T ex = exp_t(e);
            runP[k] += ex;
#pragma unroll
            for (int q = 0; q < QC; ++q) runA[k][q] += ex * r_i[q] * d[q];
          }
        }
      }
    } else {
      for (int i = 0; i < cnt; ++i) {
        const T lg = sm.lg[i];
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          if (k < krows) {
            const int row = row0 + k * kRowStep;
            T e = lg;
            T dsel = T(0);
            for (int q = 0; q < Qn; ++q) {
              const T zbar = T(0.5) * (sm.za[row * Qn + q] + sm.zb[col * Qn + q]);
              const T d = sm.mu[i * Qn + q] - zbar;
              e -= d * d * sm.r[i * Qn + q];
              if (q == qsel) dsel = d;
            }
            const T ex = exp_t(e);
            runP[k] += ex;
            runA[k][0] += ex * sm.r[i * Qn + qsel] * dsel;
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      accP[k] += static_cast<double>(runP[k]);
#pragma unroll
      for (int q = 0; q < QA; ++q) accA[k][q] += static_cast<double>(runA[k][q]);
    }
  }

  if (mb + col < M) {
    const size_t slab = static_cast<size_t>(M) * M;
    T* out = part + static_cast<size_t>(p) * (Qn + 1) * slab;
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if (k < krows) {
        const size_t at = static_cast<size_t>(ma + row0 + k * kRowStep) * M + mb + col;
        if (QC > 0 || qsel == 0) out[at] = static_cast<T>(accP[k]);
        if constexpr (QC > 0) {
#pragma unroll
          for (int q = 0; q < QC; ++q) out[(1 + q) * slab + at] = static_cast<T>(accA[k][q]);
        } else {
          out[(1 + qsel) * slab + at] = static_cast<T>(accA[k][0]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dZ pass: the psi1 branch of dZ (eq. (12)), m-parallel over an N-split
// ---------------------------------------------------------------------------

// part: (P, M, Q)
template <typename T>
__global__ void __launch_bounds__(kThreads)
dz1_partial_kernel(const T* __restrict__ mu, const T* __restrict__ S,
                   const T* __restrict__ Y, const T* __restrict__ Z,
                   const T* __restrict__ l2, const T* __restrict__ gyv,
                   T* __restrict__ part, int N, int M, int Q, int D, int P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_mu = reinterpret_cast<T*>(smem_raw);  // [kZStage][Q]
  T* s_b = s_mu + kZStage * Q;               // [kZStage][Q]
  T* s_lg = s_b + kZStage * Q;               // [kZStage]
  T* s_red = s_lg + kZStage;                 // [kZLanes][kZTileM]

  const int tid = threadIdx.x;
  const int mm = tid % kZTileM;  // lane of a warp -> inducing point
  const int lane = tid / kZTileM;  // warp -> every kZLanes-th staged point
  const int m = blockIdx.x * kZTileM + mm;
  const int mc = min(m, M - 1);  // out-of-range m computes a real row, unwritten
  const int p = blockIdx.y;
  int n0, n1;
  split_range(N, P, p, &n0, &n1);

  T zm[kMaxQ], acc[kMaxQ];
#pragma unroll
  for (int q = 0; q < kMaxQ; ++q) {
    zm[q] = q < Q ? Z[static_cast<size_t>(mc) * Q + q] : T(0);
    acc[q] = T(0);
  }
  const T* g = gyv + static_cast<size_t>(mc) * D;

  for (int base = n0; base < n1; base += kZStage) {
    const int cnt = min(kZStage, n1 - base);
    __syncthreads();  // the previous run is consumed
    if (tid < cnt) {
      const size_t n = static_cast<size_t>(base + tid);
      T lg = T(0);
      for (int q = 0; q < Q; ++q) {
        const T s = S[n * Q + q];
        s_mu[tid * Q + q] = mu[n * Q + q];
        s_b[tid * Q + q] = T(1) / (l2[q] + s);
        lg += log1p_t(s / l2[q]);
      }
      s_lg[tid] = T(-0.5) * lg;
    }
    __syncthreads();
    for (int i = lane; i < cnt; i += kZLanes) {
      T e = s_lg[i];
      T d[kMaxQ];
#pragma unroll
      for (int q = 0; q < kMaxQ; ++q) {
        d[q] = T(0);
        if (q < Q) {
          d[q] = s_mu[i * Q + q] - zm[q];
          e -= T(0.5) * d[q] * d[q] * s_b[i * Q + q];
        }
      }
      const T* y = Y + static_cast<size_t>(base + i) * D;
      T yg = T(0);
      for (int dd = 0; dd < D; ++dd) yg += y[dd] * g[dd];
      const T w1 = yg * exp_t(e);
#pragma unroll
      for (int q = 0; q < kMaxQ; ++q)
        if (q < Q) acc[q] += w1 * s_b[i * Q + q] * d[q];
    }
  }

  // sum the kZLanes lanes of each m in a fixed order
#pragma unroll
  for (int q = 0; q < kMaxQ; ++q) {
    if (q < Q) {
      __syncthreads();
      s_red[lane * kZTileM + mm] = acc[q];
      __syncthreads();
      if (lane == 0 && m < M) {
        T s = T(0);
        for (int l = 0; l < kZLanes; ++l) s += s_red[l * kZTileM + mm];
        part[(static_cast<size_t>(p) * M + m) * Q + q] = s;
      }
    }
  }
}

template <typename T, int QC>
void launch_point(int blocks, cudaStream_t stream, const T* mu, const T* S,
                  const T* Y, const T* Z, const T* l2, const T* ls, const T* Gw,
                  const T* gyv, T* dmu, T* dS, T* dY, T* part, int N, int M,
                  int Q, int D) {
  point_kernel<T, QC><<<blocks, kThreads, 0, stream>>>(mu, S, Y, Z, l2, ls, Gw, gyv, dmu,
                                                       dS, dY, part, N, M, Q, D);
}

template <typename T, int QC>
void launch_pair(dim3 grid, size_t smem, cudaStream_t stream, const T* mu,
                 const T* S, const T* Z, const T* l2, T* part, int N, int M,
                 int Q, int P) {
  pair_partial_kernel<T, QC><<<grid, kThreads, smem, stream>>>(mu, S, Z, l2, part, N, M, Q, P);
}

template <typename T>
cudaError_t suffstats_bwd(const T* mu, const T* S, const T* Y, const T* Z,
                          const T* l2, const T* ls, const T* Gw, const T* gyv,
                          T* dmu, T* dS, T* dY, T* point_part, T* point_sum,
                          T* pair_part, T* pair_sum, T* dz_part, T* dz1, int N,
                          int M, int Q, int D, int P2, int PZ, int NB,
                          cudaStream_t stream) {
  switch (Q) {
    case 1: launch_point<T, 1>(NB, stream, mu, S, Y, Z, l2, ls, Gw, gyv, dmu, dS, dY, point_part, N, M, Q, D); break;
    case 2: launch_point<T, 2>(NB, stream, mu, S, Y, Z, l2, ls, Gw, gyv, dmu, dS, dY, point_part, N, M, Q, D); break;
    case 3: launch_point<T, 3>(NB, stream, mu, S, Y, Z, l2, ls, Gw, gyv, dmu, dS, dY, point_part, N, M, Q, D); break;
    case 4: launch_point<T, 4>(NB, stream, mu, S, Y, Z, l2, ls, Gw, gyv, dmu, dS, dY, point_part, N, M, Q, D); break;
    default: launch_point<T, 0>(NB, stream, mu, S, Y, Z, l2, ls, Gw, gyv, dmu, dS, dY, point_part, N, M, Q, D);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int tiles = (M + kTile - 1) / kTile;
  const size_t smem2 = psi2_smem_bytes<T>(Q);
  const dim3 grid2(tiles * (tiles + 1) / 2, P2, Q <= 4 ? 1 : Q);
  switch (Q) {
    case 1: launch_pair<T, 1>(grid2, smem2, stream, mu, S, Z, l2, pair_part, N, M, Q, P2); break;
    case 2: launch_pair<T, 2>(grid2, smem2, stream, mu, S, Z, l2, pair_part, N, M, Q, P2); break;
    case 3: launch_pair<T, 3>(grid2, smem2, stream, mu, S, Z, l2, pair_part, N, M, Q, P2); break;
    case 4: launch_pair<T, 4>(grid2, smem2, stream, mu, S, Z, l2, pair_part, N, M, Q, P2); break;
    default: launch_pair<T, 0>(grid2, smem2, stream, mu, S, Z, l2, pair_part, N, M, Q, P2);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 gridZ((M + kZTileM - 1) / kZTileM, PZ);
  const size_t smemZ = sizeof(T) * (2 * kZStage * Q + kZStage + kZLanes * kZTileM);
  dz1_partial_kernel<T><<<gridZ, kThreads, smemZ, stream>>>(mu, S, Y, Z, l2, gyv, dz_part,
                                                            N, M, Q, D, PZ);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = reduce_partials<T>(point_part, point_sum, NB, 1, 1, Q + 1, 0, stream);
  if (err != cudaSuccess) return err;
  err = reduce_partials<T>(pair_part, pair_sum, P2, Q + 1, M, M, kTile, stream);
  if (err != cudaSuccess) return err;
  return reduce_partials<T>(dz_part, dz1, PZ, 1, M, Q, 0, stream);
}

}  // namespace

// Plain C interface (bound with ctypes). Pointers are device pointers of
// contiguous row-major arrays: mu, S (N, Q); Y (N, D); Z (M, Q); l2, ls (Q);
// Gw (M, M); gyv (M, D); outputs dmu, dS (N, Q), dY (N, D); scratch
// point_part (NB, Q + 1), pair_part (P2, Q + 1, M, M), dz_part (PZ, M, Q);
// sums point_sum (Q + 1) = [dl_point, dv_raw], pair_sum (Q + 1, M, M) =
// [P, A_1..A_Q], dz1 (M, Q). NB must be ceil(N / 256). Launches on
// `stream`, does not synchronize, returns the first cudaGetLastError() that
// is not cudaSuccess (0 on success).
#define SUFFSTATS_BWD_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const T* mu, const T* S, const T* Y, const T* Z, const T* l2, \
                      const T* ls, const T* Gw, const T* gyv, T* dmu, T* dS, T* dY, \
                      T* point_part, T* point_sum, T* pair_part, T* pair_sum,       \
                      T* dz_part, T* dz1, int N, int M, int Q, int D, int P2,       \
                      int PZ, int NB, void* stream) {                               \
    return static_cast<int>(suffstats_bwd<T>(                                      \
        mu, S, Y, Z, l2, ls, Gw, gyv, dmu, dS, dY, point_part, point_sum,          \
        pair_part, pair_sum, dz_part, dz1, N, M, Q, D, P2, PZ, NB,                 \
        static_cast<cudaStream_t>(stream)));                                       \
  }

SUFFSTATS_BWD_ENTRY(suffstats_bwd_f32, float)
SUFFSTATS_BWD_ENTRY(suffstats_bwd_f64, double)

extern "C" const char* suffstats_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
