// Fused psi-statistics forward pass for the RBF-ARD kernel, written by hand
// for Hopper (sm_90a): psi2 (M, M) and psiY = psi1^T Y (M, D) from one read
// of the datapoints.
//
// Replaces: src/repro/kernels/suffstats.py: suffstats_pallas (the Pallas TPU
// kernel _suffstats_kernel). What it computes, with l2 = l^2:
//
//   acc2[m, m'] = sum_n exp(-1/2 sum_q log1p(2 S_nq / l2_q)
//                            - sum_q (mu_nq - zbar_mm'q)^2 / (l2_q + 2 S_nq)),
//                 zbar = (z_m + z_m') / 2
//   accY[m, d]  = sum_n exp(-1/2 sum_q log1p(S_nq / l2_q)
//                            - 1/2 sum_q (mu_nq - z_mq)^2 / (l2_q + S_nq)) y_nd
//
// The caller applies the O(M^2) prefactors: psi2 = v^2 exp(-|z_m - z_m'|^2 /
// 4 l^2) acc2 and psiY = v accY.
//
// What bounds it on this card: N M^2 exponentials and about N M^2 (3Q + 2)
// floating-point operations against O(N (Q + D)) bytes read, so the
// special-function unit's exp rate and FP32 instruction throughput bound
// it, never memory.
//
// What the design does about it:
//   * The exponent uses the direct difference (mu - zbar)^2 r, not the TPU
//     kernel's expanded form (two MXU products plus a rank-Q cross term):
//     on CUDA cores the two cost the same, and the direct form has no f32
//     cancellation at large |mu| / l.
//   * psi2 is symmetric and zbar is commutative in floating point, so only
//     the upper-triangular 32 x 32 output tiles are computed (half the exps);
//     the reduction mirrors them.
//   * Each block owns one (tile, N-split): it stages a run of datapoints and
//     their per-point terms (r_nq, lognorm2_n) in shared memory and keeps its
//     tile's sums in registers (4 outputs a thread, z-bar in registers when Q
//     is a compile-time 1..4). The TPU kernel carries its sums across a
//     sequential grid; here blocks run concurrently, so each writes a partial
//     to scratch (P, M, M) and a second kernel sums the P partials in a fixed
//     order. No atomics: results are bitwise equal from run to run.
//   * Sums run in two levels: each staged run of points in the input dtype,
//     the running total over runs (and the reduction over partials) in
//     double. A float thread's one long float sum over ~2e4 points was off
//     by ~1e-5 of psi2, enough to leave Kuu + beta psi2 indefinite in float32
//     where the inducing points crowd (about 2e-7 now, as an exactly
//     rounded psi2 would be); a conversion and a double add per output per
//     run cost next to nothing.
//   * The caller picks P so that about 4 x 132 blocks are in flight.
//   * psiY runs in its own blocks per (32-row m tile, 8-column d tile,
//     N-split) with the same fixed-order reduction.
//   * Ragged N, M and D are masked at the bounds; nothing is padded.
//   * float and double instances compute in the input dtype.
#include "common.cuh"

namespace {

// psiY: kYTileM x kYTileD outputs per block, one per thread
constexpr int kYTileM = 32;
constexpr int kYTileD = kThreads / kYTileM;
constexpr int kYStage = 64;

// QC > 0: Q is the compile-time QC (z-bar lives in registers);
// QC == 0: Q is read at run time (z-bar from shared memory).
template <typename T, int QC>
__global__ void __launch_bounds__(kThreads)
psi2_partial_kernel(const T* __restrict__ mu, const T* __restrict__ S,
                    const T* __restrict__ Z, const T* __restrict__ l2,
                    T* __restrict__ part, int N, int M, int Q, int P) {
  const int Qn = QC > 0 ? QC : Q;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Psi2Smem<T> sm = psi2_smem<T>(smem_raw, Qn);

  int ti, tj;
  tri_tile(blockIdx.x, (M + kTile - 1) / kTile, &ti, &tj);
  const int p = blockIdx.y;
  int n0, n1;
  split_range(N, P, p, &n0, &n1);
  const int tid = threadIdx.x;
  const int col = tid % kTile;   // lane -> column m'
  const int row0 = tid / kTile;  // warp -> rows row0 + k * kRowStep
  const int ma = ti * kTile;
  const int mb = tj * kTile;
  load_psi2_tile(sm, Z, l2, ma, mb, M, Qn);

  // rows of this warp inside M form a prefix k < krows (warp-uniform)
  const int krows = min(kRows, max(0, (M - ma - row0 + kRowStep - 1) / kRowStep));
  double acc[kRows];  // the running total, over every staged run
  T run[kRows];       // one staged run's sum
  T zb[kRows][QC > 0 ? QC : 1];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    acc[k] = 0.0;
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
    for (int k = 0; k < kRows; ++k) run[k] = T(0);
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
#pragma unroll
            for (int q = 0; q < QC; ++q) {
              const T d = mu_i[q] - zb[k][q];
              e -= d * d * r_i[q];
            }
            run[k] += exp_t(e);
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
            for (int q = 0; q < Qn; ++q) {
              const T zbar = T(0.5) * (sm.za[row * Qn + q] + sm.zb[col * Qn + q]);
              const T d = sm.mu[i * Qn + q] - zbar;
              e -= d * d * sm.r[i * Qn + q];
            }
            run[k] += exp_t(e);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) acc[k] += static_cast<double>(run[k]);
  }

  if (mb + col < M) {
    T* out = part + static_cast<size_t>(p) * M * M;
#pragma unroll
    for (int k = 0; k < kRows; ++k)
      if (k < krows)
        out[static_cast<size_t>(ma + row0 + k * kRowStep) * M + mb + col] = static_cast<T>(acc[k]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
psiy_partial_kernel(const T* __restrict__ mu, const T* __restrict__ S,
                    const T* __restrict__ Y, const T* __restrict__ Z,
                    const T* __restrict__ l2, T* __restrict__ part, int N,
                    int M, int Q, int D, int P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_mu = reinterpret_cast<T*>(smem_raw);  // [kYStage][Q]
  T* s_b = s_mu + kYStage * Q;               // [kYStage][Q]
  T* s_lg = s_b + kYStage * Q;               // [kYStage]
  T* s_y = s_lg + kYStage;                   // [kYStage][kYTileD]
  T* s_psi = s_y + kYStage * kYTileD;        // [kYStage][kYTileM]
  T* s_z = s_psi + kYStage * kYTileM;        // [kYTileM][Q]
  T* s_l2 = s_z + kYTileM * Q;               // [Q]

  const int m0 = blockIdx.x * kYTileM;
  const int d0 = blockIdx.y * kYTileD;
  const int p = blockIdx.z;
  int n0, n1;
  split_range(N, P, p, &n0, &n1);
  const int tid = threadIdx.x;
  const int mm = tid % kYTileM;
  const int dd = tid / kYTileM;

  for (int i = tid; i < kYTileM * Q; i += kThreads) {
    const int r = i / Q;
    s_z[i] = m0 + r < M ? Z[static_cast<size_t>(m0 + r) * Q + i % Q] : T(0);
  }
  if (tid < Q) s_l2[tid] = l2[tid];
  __syncthreads();

  double acc = 0.0;  // the running total; each staged run is summed in T
  for (int base = n0; base < n1; base += kYStage) {
    const int cnt = min(kYStage, n1 - base);
    __syncthreads();  // the previous run is consumed
    if (tid < cnt) {
      const size_t n = static_cast<size_t>(base + tid);
      T lg = T(0);
      for (int q = 0; q < Q; ++q) {
        const T s = S[n * Q + q];
        s_mu[tid * Q + q] = mu[n * Q + q];
        s_b[tid * Q + q] = T(1) / (s_l2[q] + s);
        lg += log1p_t(s / s_l2[q]);
      }
      s_lg[tid] = T(-0.5) * lg;
    }
    for (int i = tid; i < cnt * kYTileD; i += kThreads) {
      const int pt = i / kYTileD;
      const int d = d0 + i % kYTileD;
      s_y[i] = d < D ? Y[static_cast<size_t>(base + pt) * D + d] : T(0);
    }
    __syncthreads();
    // psi1 / v for the staged points x this block's m tile
    for (int i = tid; i < cnt * kYTileM; i += kThreads) {
      const int pt = i / kYTileM;
      const int r = i % kYTileM;
      T e = s_lg[pt];
      for (int q = 0; q < Q; ++q) {
        const T d = s_mu[pt * Q + q] - s_z[r * Q + q];
        e -= T(0.5) * d * d * s_b[pt * Q + q];
      }
      s_psi[i] = exp_t(e);
    }
    __syncthreads();
    T run = T(0);
    for (int i = 0; i < cnt; ++i) run += s_psi[i * kYTileM + mm] * s_y[i * kYTileD + dd];
    acc += static_cast<double>(run);
  }

  const int m = m0 + mm;
  const int d = d0 + dd;
  if (m < M && d < D) part[(static_cast<size_t>(p) * M + m) * D + d] = static_cast<T>(acc);
}

template <typename T, int QC>
void launch_psi2(dim3 grid, size_t smem, cudaStream_t stream, const T* mu,
                 const T* S, const T* Z, const T* l2, T* part, int N, int M,
                 int Q, int P) {
  psi2_partial_kernel<T, QC><<<grid, kThreads, smem, stream>>>(mu, S, Z, l2, part, N, M, Q, P);
}

template <typename T>
cudaError_t suffstats_fwd(const T* mu, const T* S, const T* Y, const T* Z,
                          const T* l2, T* part2, T* partY, T* acc2, T* accY,
                          int N, int M, int Q, int D, int P2, int PY,
                          cudaStream_t stream) {
  const int tiles = (M + kTile - 1) / kTile;
  const dim3 grid2(tiles * (tiles + 1) / 2, P2);
  const size_t smem2 = psi2_smem_bytes<T>(Q);
  switch (Q) {
    case 1: launch_psi2<T, 1>(grid2, smem2, stream, mu, S, Z, l2, part2, N, M, Q, P2); break;
    case 2: launch_psi2<T, 2>(grid2, smem2, stream, mu, S, Z, l2, part2, N, M, Q, P2); break;
    case 3: launch_psi2<T, 3>(grid2, smem2, stream, mu, S, Z, l2, part2, N, M, Q, P2); break;
    case 4: launch_psi2<T, 4>(grid2, smem2, stream, mu, S, Z, l2, part2, N, M, Q, P2); break;
    default: launch_psi2<T, 0>(grid2, smem2, stream, mu, S, Z, l2, part2, N, M, Q, P2);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 gridY((M + kYTileM - 1) / kYTileM, (D + kYTileD - 1) / kYTileD, PY);
  const size_t smemY = sizeof(T) * (2 * kYStage * Q + kYStage + kYStage * kYTileD +
                                    kYStage * kYTileM + kYTileM * Q + Q);
  psiy_partial_kernel<T><<<gridY, kThreads, smemY, stream>>>(mu, S, Y, Z, l2, partY, N, M, Q, D, PY);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = reduce_partials<T>(part2, acc2, P2, 1, M, M, kTile, stream);
  if (err != cudaSuccess) return err;
  return reduce_partials<T>(partY, accY, PY, 1, M, D, 0, stream);
}

}  // namespace

// Plain C interface (bound with ctypes). Pointers are device pointers of
// contiguous row-major arrays: mu, S (N, Q); Y (N, D); Z (M, Q); l2 (Q);
// scratch part2 (P2, M, M), partY (PY, M, D); outputs acc2 (M, M), accY
// (M, D). Launches on `stream`, does not synchronize, returns the first
// cudaGetLastError() that is not cudaSuccess (0 on success).
extern "C" int suffstats_fwd_f32(const float* mu, const float* S, const float* Y,
                                 const float* Z, const float* l2, float* part2,
                                 float* partY, float* acc2, float* accY, int N,
                                 int M, int Q, int D, int P2, int PY,
                                 void* stream) {
  return static_cast<int>(suffstats_fwd<float>(mu, S, Y, Z, l2, part2, partY, acc2, accY,
                                               N, M, Q, D, P2, PY,
                                               static_cast<cudaStream_t>(stream)));
}

extern "C" int suffstats_fwd_f64(const double* mu, const double* S, const double* Y,
                                 const double* Z, const double* l2, double* part2,
                                 double* partY, double* acc2, double* accY, int N,
                                 int M, int Q, int D, int P2, int PY,
                                 void* stream) {
  return static_cast<int>(suffstats_fwd<double>(mu, S, Y, Z, l2, part2, partY, acc2, accY,
                                                N, M, Q, D, P2, PY,
                                                static_cast<cudaStream_t>(stream)));
}

extern "C" const char* suffstats_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
