// The reverse psi-statistics kernels' point pass and pair pass, shared by the
// fused reverse pass (suffstats_bwd.cu, kernel B2) and the psi2-only one
// (psi2_bwd.cu, kernel B4), as the TPU kernels share _psi2_bwd_tile. Equation
// numbers are those of docs/derivations/suffstats_vjp.md; suffstats_bwd.cu's
// header sets out what each pass computes and why it is laid out so.
//
//   point pass, one thread per datapoint: dmu, dS (and dY with the psi1
//     branch), and block partials of dl and v dv;
//   pair pass, upper-triangular 32 x 32 tiles x N-splits: partials of
//     P_ab = sum_n E_nab and A_abq = sum_n E_nab r_nq (mu_nq - zbar_abq),
//     from which the caller's O(M^2 Q) epilogue forms the psi2 part of dZ.
#pragma once

#include "common.cuh"

namespace {

constexpr int kMaxQ = 16;
// point pass: dY columns accumulated per sweep over m
constexpr int kDChunk = 8;

// ---------------------------------------------------------------------------
// point pass: one thread per datapoint
// ---------------------------------------------------------------------------

// QC > 0: Q is the compile-time QC; QC == 0: Q (<= kMaxQ) read at run time.
// kPsi1: with the psi1/psiY branch (the fused reverse pass); without it
// (the psi2-only reverse pass) Y, gyv and dY are not touched and D is unused.
// part: (gridDim.x, Q + 1) block partials of [dl_point (Q), dv_raw].
template <typename T, int QC, bool kPsi1>
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


template <typename T, int QC, bool kPsi1>
void launch_point(int blocks, cudaStream_t stream, const T* mu, const T* S,
                  const T* Y, const T* Z, const T* l2, const T* ls, const T* Gw,
                  const T* gyv, T* dmu, T* dS, T* dY, T* part, int N, int M,
                  int Q, int D) {
  point_kernel<T, QC, kPsi1><<<blocks, kThreads, 0, stream>>>(mu, S, Y, Z, l2, ls, Gw, gyv, dmu,
                                                       dS, dY, part, N, M, Q, D);
}

template <typename T, int QC>
void launch_pair(dim3 grid, size_t smem, cudaStream_t stream, const T* mu,
                 const T* S, const T* Z, const T* l2, T* part, int N, int M,
                 int Q, int P) {
  pair_partial_kernel<T, QC><<<grid, kThreads, smem, stream>>>(mu, S, Z, l2, part, N, M, Q, P);
}


// the point pass over NB = ceil(N / kThreads) blocks
template <typename T, bool kPsi1>
cudaError_t point_pass(int NB, cudaStream_t stream, const T* mu, const T* S,
                       const T* Y, const T* Z, const T* l2, const T* ls,
                       const T* Gw, const T* gyv, T* dmu, T* dS, T* dY, T* part,
                       int N, int M, int Q, int D) {
  switch (Q) {
    case 1: launch_point<T, 1, kPsi1>(NB, stream, mu, S, Y, Z, l2, ls, Gw, gyv, dmu, dS, dY, part, N, M, Q, D); break;
    case 2: launch_point<T, 2, kPsi1>(NB, stream, mu, S, Y, Z, l2, ls, Gw, gyv, dmu, dS, dY, part, N, M, Q, D); break;
    case 3: launch_point<T, 3, kPsi1>(NB, stream, mu, S, Y, Z, l2, ls, Gw, gyv, dmu, dS, dY, part, N, M, Q, D); break;
    case 4: launch_point<T, 4, kPsi1>(NB, stream, mu, S, Y, Z, l2, ls, Gw, gyv, dmu, dS, dY, part, N, M, Q, D); break;
    default: launch_point<T, 0, kPsi1>(NB, stream, mu, S, Y, Z, l2, ls, Gw, gyv, dmu, dS, dY, part, N, M, Q, D);
  }
  return cudaGetLastError();
}

// the pair pass's partials (P, Q + 1, M, M) over P N-splits
template <typename T>
cudaError_t pair_pass(int P, cudaStream_t stream, const T* mu, const T* S,
                      const T* Z, const T* l2, T* part, int N, int M, int Q) {
  const int tiles = (M + kTile - 1) / kTile;
  const size_t smem = psi2_smem_bytes<T>(Q);
  const dim3 grid(tiles * (tiles + 1) / 2, P, Q <= 4 ? 1 : Q);
  switch (Q) {
    case 1: launch_pair<T, 1>(grid, smem, stream, mu, S, Z, l2, part, N, M, Q, P); break;
    case 2: launch_pair<T, 2>(grid, smem, stream, mu, S, Z, l2, part, N, M, Q, P); break;
    case 3: launch_pair<T, 3>(grid, smem, stream, mu, S, Z, l2, part, N, M, Q, P); break;
    case 4: launch_pair<T, 4>(grid, smem, stream, mu, S, Z, l2, part, N, M, Q, P); break;
    default: launch_pair<T, 0>(grid, smem, stream, mu, S, Z, l2, part, N, M, Q, P);
  }
  return cudaGetLastError();
}

}  // namespace
