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
//   * One pass over g: a block owns a tile of 32 inducing points (one per
//     lane) and an N-split, stages a run of datapoints' mu, 1 / (l2 + S) and
//     log-normaliser in shared memory, and its 8 warps take the run's points
//     in turn; each lane reads g[n, m] for its m (32 neighbouring addresses
//     a warp) and evaluates psi1 once.
//   * Per-point sums over m are a warp's shuffle tree over its 32 lanes (a
//     fixed order), written per (tile, point); a second kernel, one thread
//     per point, sums the M / 32 tiles in a fixed order and forms dmu, dS and
//     the point's share of dl and dv.
//   * dZ stays in the lanes' registers, summed in two levels (each staged
//     run in the input dtype, the total in double), then over the 8 warps
//     in a fixed order. The TPU kernel carries dZ, dv and dl across its
//     sequential grid; here every global sum is a per-block partial summed
//     by a further kernel in an order fixed by the shapes: no atomics,
//     bitwise repeatable.
//   * The exponent is the direct (mu - z)^2 b form (no float32 cancellation
//     at large |mu| / l); v multiplies inside the kernel, so v g is never
//     formed.
//   * Ragged N and M are masked at the bounds; nothing is padded.
//   * float and double instances compute in the input dtype; Q = 1..4 is a
//     compile-time constant, larger Q (<= 16) runs a run-time-Q instance.
#include "common.cuh"

namespace {

constexpr int kMaxQ = 16;
constexpr int kLanes = 32;                  // inducing points per block
constexpr int kWarps = kThreads / kLanes;   // point lanes per block
constexpr int kRun = 64;                    // datapoints staged per step

// grid (ceil(M / kLanes), P). pt: (tiles, N, 1 + 2 Q) per (tile, point)
// sums [s1, s1d_1..Q, s1v_1..Q]; dz: (P, M, Q) partials of dZ.
template <typename T, int QC>
__global__ void __launch_bounds__(kThreads)
psi1_bwd_tile_kernel(const T* __restrict__ mu, const T* __restrict__ S,
                     const T* __restrict__ Z, const T* __restrict__ l2,
                     const T* __restrict__ variance, const T* __restrict__ g,
                     T* __restrict__ pt, T* __restrict__ dz, int N, int M, int Q,
                     int P) {
  constexpr int QA = QC > 0 ? QC : kMaxQ;
  const int Qn = QC > 0 ? QC : Q;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* s_red = reinterpret_cast<double*>(smem_raw);  // [kWarps][kLanes]
  T* s_mu = reinterpret_cast<T*>(s_red + kWarps * kLanes);  // [kRun][Q]
  T* s_b = s_mu + kRun * Qn;                                // [kRun][Q]
  T* s_lg = s_b + kRun * Qn;                                // [kRun]

  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const int warp = tid / kLanes;
  const int tile = blockIdx.x;
  const int m = tile * kLanes + lane;
  const bool live_m = m < M;
  const int mc = live_m ? m : M - 1;  // a dead lane computes a real column, weight 0
  const int p = blockIdx.y;
  int n0, n1;
  split_range(N, P, p, &n0, &n1);
  const int stride = 1 + 2 * Qn;

  T zm[QA];
  double acc[QA];
#pragma unroll
  for (int q = 0; q < QA; ++q) {
    zm[q] = q < Qn ? Z[static_cast<size_t>(mc) * Qn + q] : T(0);
    acc[q] = 0.0;
  }
  const T v = *variance;

  for (int base = n0; base < n1; base += kRun) {
    const int cnt = min(kRun, n1 - base);
    __syncthreads();  // the previous run is consumed
    if (tid < cnt) {
      const size_t n = static_cast<size_t>(base + tid);
      T lg = T(0);
      for (int q = 0; q < Qn; ++q) {
        const T s = S[n * Qn + q];
        const T l2q = l2[q];
        s_mu[tid * Qn + q] = mu[n * Qn + q];
        s_b[tid * Qn + q] = T(1) / (l2q + s);
        lg += log1p_t(s / l2q);
      }
      s_lg[tid] = T(-0.5) * lg;
    }
    __syncthreads();
    T run[QA];
#pragma unroll
    for (int q = 0; q < QA; ++q) run[q] = T(0);
    for (int i = warp; i < cnt; i += kWarps) {  // warp-uniform: every lane takes part
      const size_t n = static_cast<size_t>(base + i);
      T e = s_lg[i];
      T d[QA];
#pragma unroll
      for (int q = 0; q < QA; ++q) {
        d[q] = T(0);
        if (q < Qn) {
          d[q] = s_mu[i * Qn + q] - zm[q];
          e -= T(0.5) * d[q] * d[q] * s_b[i * Qn + q];
        }
      }
      const T w1 = live_m ? g[n * M + m] * v * exp_t(e) : T(0);  // eq. (8)
      T s1 = w1, s1d[QA], s1v[QA];
#pragma unroll
      for (int q = 0; q < QA; ++q) {
        s1d[q] = s1v[q] = T(0);
        if (q < Qn) {
          const T wd = w1 * d[q];
          run[q] += wd * s_b[i * Qn + q];  // eq. (12)
          s1d[q] = wd;
          s1v[q] = wd * d[q];
        }
      }
      // the tile's 32 inducing points, in a fixed tree
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1) {
        s1 += __shfl_down_sync(0xffffffffu, s1, off);
#pragma unroll
        for (int q = 0; q < QA; ++q) {
          if (q < Qn) {
            s1d[q] += __shfl_down_sync(0xffffffffu, s1d[q], off);
            s1v[q] += __shfl_down_sync(0xffffffffu, s1v[q], off);
          }
        }
      }
      if (lane == 0) {
        T* o = pt + (static_cast<size_t>(tile) * N + n) * stride;
        o[0] = s1;
#pragma unroll
        for (int q = 0; q < QA; ++q) {
          if (q < Qn) {
            o[1 + q] = s1d[q];
            o[1 + Qn + q] = s1v[q];
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < QA; ++q) acc[q] += static_cast<double>(run[q]);
  }

  // each inducing point's dZ over the kWarps warps, in a fixed order
#pragma unroll
  for (int q = 0; q < QA; ++q) {
    if (q < Qn) {
      __syncthreads();
      s_red[warp * kLanes + lane] = acc[q];
      __syncthreads();
      if (warp == 0 && live_m) {
        double s = 0.0;
        for (int w = 0; w < kWarps; ++w) s += s_red[w * kLanes + lane];
        dz[(static_cast<size_t>(p) * M + m) * Qn + q] = static_cast<T>(s);
      }
    }
  }
}

// one thread per datapoint: the (tile, point) sums over the tiles, dmu, dS,
// and part: (gridDim.x, Q + 1) block partials of [dl_point (Q), dv_raw]
template <typename T>
__global__ void __launch_bounds__(kThreads)
psi1_bwd_point_kernel(const T* __restrict__ S, const T* __restrict__ l2,
                      const T* __restrict__ ls, const T* __restrict__ pt,
                      T* __restrict__ dmu, T* __restrict__ dS, T* __restrict__ part,
                      int N, int Q, int tiles) {
  __shared__ T s_red[kThreads];
  const int tid = threadIdx.x;
  const int n = blockIdx.x * kThreads + tid;
  const bool live = n < N;
  const size_t nn = static_cast<size_t>(live ? n : N - 1);  // dead threads read a real point
  const T w = live ? T(1) : T(0);
  const int stride = 1 + 2 * Q;
  const size_t per_tile = static_cast<size_t>(N) * stride;
  const T* row = pt + nn * stride;

  double s1d = 0.0;
  for (int t = 0; t < tiles; ++t) s1d += static_cast<double>(row[t * per_tile]);
  const T s1 = static_cast<T>(s1d);
  for (int k = 0; k <= Q; ++k) {
    T val;
    if (k < Q) {
      double sd = 0.0, sv = 0.0;
      for (int t = 0; t < tiles; ++t) {
        sd += static_cast<double>(row[t * per_tile + 1 + k]);
        sv += static_cast<double>(row[t * per_tile + 1 + Q + k]);
      }
      const T s = S[nn * Q + k];
      const T lq = ls[k];
      const T b = T(1) / (l2[k] + s);
      const T d1 = static_cast<T>(sd);
      const T v1 = static_cast<T>(sv);
      if (live) {
        dmu[nn * Q + k] = -b * d1;                                   // eq. (10)
        dS[nn * Q + k] = T(-0.5) * b * s1 + T(0.5) * b * b * v1;      // eq. (11)
      }
      val = w * ((s * b / lq) * s1 + lq * b * b * v1);              // eq. (14)
    } else {
      val = w * s1;  // eq. (13), times v
    }
    // fixed-order tree over the block (k is block-uniform)
    s_red[tid] = val;
    __syncthreads();
    for (int h = kThreads / 2; h > 0; h >>= 1) {
      if (tid < h) s_red[tid] += s_red[tid + h];
      __syncthreads();
    }
    if (tid == 0) part[static_cast<size_t>(blockIdx.x) * (Q + 1) + k] = s_red[0];
    __syncthreads();
  }
}

template <typename T, int QC>
void launch_tile(dim3 grid, size_t smem, cudaStream_t stream, const T* mu, const T* S,
                 const T* Z, const T* l2, const T* variance, const T* g, T* pt,
                 T* dz_part, int N, int M, int Q, int P) {
  psi1_bwd_tile_kernel<T, QC><<<grid, kThreads, smem, stream>>>(mu, S, Z, l2, variance, g,
                                                                pt, dz_part, N, M, Q, P);
}

template <typename T>
cudaError_t psi1_bwd(const T* mu, const T* S, const T* Z, const T* l2, const T* ls,
                     const T* variance, const T* g, T* pt, T* dz_part, T* dz, T* dmu,
                     T* dS, T* point_part, T* point_sum, int N, int M, int Q, int P,
                     int NB, cudaStream_t stream) {
  const int tiles = (M + kLanes - 1) / kLanes;
  const dim3 grid(tiles, P);
  const size_t smem = sizeof(double) * kWarps * kLanes + sizeof(T) * (2 * kRun * Q + kRun);
  switch (Q) {
    case 1: launch_tile<T, 1>(grid, smem, stream, mu, S, Z, l2, variance, g, pt, dz_part, N, M, Q, P); break;
    case 2: launch_tile<T, 2>(grid, smem, stream, mu, S, Z, l2, variance, g, pt, dz_part, N, M, Q, P); break;
    case 3: launch_tile<T, 3>(grid, smem, stream, mu, S, Z, l2, variance, g, pt, dz_part, N, M, Q, P); break;
    case 4: launch_tile<T, 4>(grid, smem, stream, mu, S, Z, l2, variance, g, pt, dz_part, N, M, Q, P); break;
    default: launch_tile<T, 0>(grid, smem, stream, mu, S, Z, l2, variance, g, pt, dz_part, N, M, Q, P);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  psi1_bwd_point_kernel<T><<<NB, kThreads, 0, stream>>>(S, l2, ls, pt, dmu, dS, point_part,
                                                        N, Q, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = reduce_partials<T>(point_part, point_sum, NB, 1, 1, Q + 1, stream);
  if (err != cudaSuccess) return err;
  return reduce_partials<T>(dz_part, dz, P, 1, M, Q, stream);
}

}  // namespace

// Plain C interface (bound with ctypes). Pointers are device pointers of
// contiguous row-major arrays: mu, S (N, Q); Z (M, Q); l2, ls (Q); variance
// (1); g (N, M); scratch pt (ceil(M / 32), N, 1 + 2 Q), dz_part (P, M, Q),
// point_part (NB, Q + 1); outputs dz (M, Q), dmu, dS (N, Q), point_sum
// (Q + 1) = [dl, dv_raw]. NB must be ceil(N / 256). Launches on `stream`,
// does not synchronize, returns the first cudaGetLastError() that is not
// cudaSuccess (0 on success).
#define PSI1_BWD_ENTRY(NAME, T)                                                     \
  extern "C" int NAME(const T* mu, const T* S, const T* Z, const T* l2, const T* ls, \
                      const T* variance, const T* g, T* pt, T* dz_part, T* dz,      \
                      T* dmu, T* dS, T* point_part, T* point_sum, int N, int M,     \
                      int Q, int P, int NB, void* stream) {                         \
    return static_cast<int>(psi1_bwd<T>(mu, S, Z, l2, ls, variance, g, pt, dz_part, \
                                        dz, dmu, dS, point_part, point_sum, N, M,   \
                                        Q, P, NB, static_cast<cudaStream_t>(stream))); \
  }

PSI1_BWD_ENTRY(psi1_bwd_f32, float)
PSI1_BWD_ENTRY(psi1_bwd_f64, double)

extern "C" const char* psi1_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
