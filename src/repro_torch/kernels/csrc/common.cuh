// Shared by the psi-statistics kernels (suffstats_fwd.cu, suffstats_bwd.cu,
// psi2_fwd.cu, psi2_bwd.cu, psi1_fwd.cu, psi1_bwd.cu, kfu_fwd.cu): the psi2
// tile layout, the per-point staging of the psi2 exponent's terms, the psi2
// partial-sum kernel of the two forwards, the (N, M) cross-statistic kernel
// of psi1 and K_fu, and the fixed-order sum of per-block partials that keeps
// every kernel free of atomics and bitwise repeatable.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// psi2 tiles: kTile x kTile pairs per block, kRows per thread (rows
// row0 + k * kRowStep), kStage datapoints staged in shared memory per step
constexpr int kTile = 32;
constexpr int kRowStep = kThreads / kTile;
constexpr int kRows = kTile / kRowStep;
constexpr int kStage = 128;

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }
__device__ __forceinline__ float log1p_t(float x) { return log1pf(x); }
__device__ __forceinline__ double log1p_t(double x) { return log1p(x); }

// [begin, end) of the N axis owned by split p of P (sizes differ by <= 1)
__device__ __forceinline__ void split_range(int N, int P, int p, int* begin,
                                            int* end) {
  *begin = static_cast<int>(static_cast<long long>(N) * p / P);
  *end = static_cast<int>(static_cast<long long>(N) * (p + 1) / P);
}

// linear index over the upper triangle of a T x T tile grid -> (ti <= tj)
__device__ __forceinline__ void tri_tile(int t, int T, int* ti, int* tj) {
  int i = 0;
  int len = T;
  while (t >= len) {
    t -= len;
    ++i;
    --len;
  }
  *ti = i;
  *tj = i + t;
}

// Shared memory of a psi2 tile block, carved from one dynamic allocation of
// psi2_smem_bytes<T>(Q).
template <typename T>
struct Psi2Smem {
  T* mu;  // [kStage][Q]
  T* r;   // [kStage][Q]   1 / (l2 + 2 S)
  T* lg;  // [kStage]      -1/2 sum_q log1p(2 S / l2)
  T* za;  // [kTile][Q]    rows m
  T* zb;  // [kTile][Q]    columns m'
  T* l2;  // [Q]
};

template <typename T>
constexpr size_t psi2_smem_bytes(int Q) {
  return sizeof(T) * (2 * kStage * Q + kStage + 2 * kTile * Q + Q);
}

template <typename T>
__device__ __forceinline__ Psi2Smem<T> psi2_smem(unsigned char* raw, int Q) {
  Psi2Smem<T> s;
  s.mu = reinterpret_cast<T*>(raw);
  s.r = s.mu + kStage * Q;
  s.lg = s.r + kStage * Q;
  s.za = s.lg + kStage;
  s.zb = s.za + kTile * Q;
  s.l2 = s.zb + kTile * Q;
  return s;
}

// the tile's inducing points (rows from ma, columns from mb; zero past M)
// and l^2, then a barrier
template <typename T>
__device__ __forceinline__ void load_psi2_tile(const Psi2Smem<T>& s, const T* Z,
                                               const T* l2, int ma, int mb,
                                               int M, int Q) {
  const int tid = threadIdx.x;
  for (int i = tid; i < kTile * Q; i += kThreads) {
    const int r = i / Q;
    const int q = i % Q;
    s.za[i] = ma + r < M ? Z[static_cast<size_t>(ma + r) * Q + q] : T(0);
    s.zb[i] = mb + r < M ? Z[static_cast<size_t>(mb + r) * Q + q] : T(0);
  }
  if (tid < Q) s.l2[tid] = l2[tid];
  __syncthreads();
}

// stage the cnt datapoints from `base`: mu, r = 1 / (l2 + 2 S) and the
// log-normaliser; barriers before (the previous run is consumed) and after
template <typename T>
__device__ __forceinline__ void stage_psi2_points(const Psi2Smem<T>& s,
                                                  const T* mu, const T* S,
                                                  int base, int cnt, int Q) {
  const int tid = threadIdx.x;
  __syncthreads();
  if (tid < cnt) {
    const size_t n = static_cast<size_t>(base + tid);
    T lg = T(0);
    for (int q = 0; q < Q; ++q) {
      const T sv = S[n * Q + q];
      const T l2q = s.l2[q];
      s.mu[tid * Q + q] = mu[n * Q + q];
      s.r[tid * Q + q] = T(1) / (l2q + T(2) * sv);
      lg += log1p_t(T(2) * sv / l2q);
    }
    s.lg[tid] = T(-0.5) * lg;
  }
  __syncthreads();
}

// out[s, a, b] = sum_{p = 0..P-1} part[p, s, a, b], in that order and in
// double whatever T is. With sym_tile > 0 only the upper-triangular
// sym_tile x sym_tile tiles of each slab were written: entries below them
// read their mirror.
template <typename T>
__global__ void __launch_bounds__(kThreads)
reduce_partials_kernel(const T* __restrict__ part, T* __restrict__ out, int P,
                       int slabs, int rows, int cols, int sym_tile) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const size_t per = static_cast<size_t>(rows) * cols;
  if (idx >= per * slabs) return;
  const size_t s = idx / per;
  const int a = static_cast<int>((idx % per) / cols);
  const int b = static_cast<int>(idx % cols);
  size_t src = s * per + static_cast<size_t>(a) * cols + b;
  if (sym_tile > 0 && a / sym_tile > b / sym_tile)
    src = s * per + static_cast<size_t>(b) * cols + a;
  double acc = 0.0;
  for (int p = 0; p < P; ++p) acc += part[static_cast<size_t>(p) * per * slabs + src];
  out[idx] = static_cast<T>(acc);
}

template <typename T>
cudaError_t reduce_partials(const T* part, T* out, int P, int slabs, int rows,
                            int cols, int sym_tile, cudaStream_t stream) {
  const size_t total = static_cast<size_t>(slabs) * rows * cols;
  reduce_partials_kernel<T><<<static_cast<unsigned>((total + kThreads - 1) / kThreads),
                              kThreads, 0, stream>>>(part, out, P, slabs, rows, cols,
                                                     sym_tile);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// psi2 partial sums: shared by the fused forward (suffstats_fwd.cu) and the
// psi2-only forward (psi2_fwd.cu)
// ---------------------------------------------------------------------------

// part[p, a, b] = sum over split p's datapoints of exp(lognorm2 - sum_q
// (mu_q - zbar_abq)^2 r_q), for the upper-triangular kTile x kTile tiles
// (grid.x) and the N-splits (grid.y); tiles below the diagonal are left
// unwritten, for reduce_partials' sym_tile to mirror.
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

template <typename T, int QC>
void launch_psi2(dim3 grid, size_t smem, cudaStream_t stream, const T* mu,
                 const T* S, const T* Z, const T* l2, T* part, int N, int M,
                 int Q, int P) {
  psi2_partial_kernel<T, QC><<<grid, kThreads, smem, stream>>>(mu, S, Z, l2, part, N, M, Q, P);
}

// the psi2 partials (P, M, M) of every upper-triangular tile and N-split
template <typename T>
cudaError_t psi2_partials(const T* mu, const T* S, const T* Z, const T* l2,
                          T* part, int N, int M, int Q, int P,
                          cudaStream_t stream) {
  const int tiles = (M + kTile - 1) / kTile;
  const dim3 grid(tiles * (tiles + 1) / 2, P);
  const size_t smem = psi2_smem_bytes<T>(Q);
  switch (Q) {
    case 1: launch_psi2<T, 1>(grid, smem, stream, mu, S, Z, l2, part, N, M, Q, P); break;
    case 2: launch_psi2<T, 2>(grid, smem, stream, mu, S, Z, l2, part, N, M, Q, P); break;
    case 3: launch_psi2<T, 3>(grid, smem, stream, mu, S, Z, l2, part, N, M, Q, P); break;
    case 4: launch_psi2<T, 4>(grid, smem, stream, mu, S, Z, l2, part, N, M, Q, P); break;
    default: launch_psi2<T, 0>(grid, smem, stream, mu, S, Z, l2, part, N, M, Q, P);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the (N, M) cross statistics: psi1 (psi1_fwd.cu) and K_fu (kfu_fwd.cu)
// ---------------------------------------------------------------------------

constexpr int kCrossPts = 64;  // datapoints per block

// out[n, m] = v exp(lg_n - 1/2 sum_q (x_nq - z_mq)^2 b_nq) for a run of
// kCrossPts points (grid.x) and a tile of `cols` inducing points (grid.y).
// kS (psi1): b_nq = 1 / (l2_q + S_nq) and lg_n = -1/2 sum_q log1p(S_nq / l2_q),
// staged per point; !kS (K_fu): b_q = 1 / l2_q and lg = 0, S is not read.
// Each block stages its Z tile and points in shared memory, then its threads
// walk the tile's outputs in row-major order, so neighbouring threads store
// neighbouring addresses (with cols == M a block's outputs are one
// contiguous run); v multiplies in the kernel.
template <typename T, bool kS>
__global__ void __launch_bounds__(kThreads)
cross_kernel(const T* __restrict__ x, const T* __restrict__ S,
             const T* __restrict__ Z, const T* __restrict__ l2,
             const T* __restrict__ variance, T* __restrict__ out, int N, int M,
             int Q, int cols) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_z = reinterpret_cast<T*>(smem_raw);        // [cols][Q]
  T* s_x = s_z + static_cast<size_t>(cols) * Q;   // [kCrossPts][Q]
  T* s_b = s_x + kCrossPts * Q;                   // kS: [kCrossPts][Q]; else [Q]
  T* s_lg = s_b + (kS ? kCrossPts * Q : Q);       // kS: [kCrossPts]

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kCrossPts;
  const int m0 = blockIdx.y * cols;
  const int pts = min(kCrossPts, N - n0);
  const int width = min(cols, M - m0);
  for (int i = tid; i < width * Q; i += kThreads)
    s_z[i] = Z[static_cast<size_t>(m0) * Q + i];
  if constexpr (kS) {
    if (tid < pts) {
      const size_t n = static_cast<size_t>(n0 + tid);
      T lg = T(0);
      for (int q = 0; q < Q; ++q) {
        const T s = S[n * Q + q];
        const T l2q = l2[q];
        s_x[tid * Q + q] = x[n * Q + q];
        s_b[tid * Q + q] = T(1) / (l2q + s);
        lg += log1p_t(s / l2q);
      }
      s_lg[tid] = T(-0.5) * lg;
    }
  } else {
    for (int i = tid; i < pts * Q; i += kThreads)
      s_x[i] = x[static_cast<size_t>(n0) * Q + i];
    if (tid < Q) s_b[tid] = T(1) / l2[tid];
  }
  __syncthreads();

  const T v = *variance;
  for (int i = tid; i < pts * width; i += kThreads) {
    const int p = i / width;
    const int c = i - p * width;
    T e = T(0);
    if constexpr (kS) e = s_lg[p];
    for (int q = 0; q < Q; ++q) {
      const T d = s_x[p * Q + q] - s_z[c * Q + q];
      e -= T(0.5) * d * d * s_b[kS ? p * Q + q : q];
    }
    out[static_cast<size_t>(n0 + p) * M + m0 + c] = v * exp_t(e);
  }
}

template <typename T, bool kS>
cudaError_t cross_fwd(const T* x, const T* S, const T* Z, const T* l2,
                      const T* variance, T* out, int N, int M, int Q, int cols,
                      cudaStream_t stream) {
  const dim3 grid((N + kCrossPts - 1) / kCrossPts, (M + cols - 1) / cols);
  const size_t smem = sizeof(T) * (static_cast<size_t>(cols) * Q + kCrossPts * Q
                                   + (kS ? kCrossPts * Q + kCrossPts : Q));
  cross_kernel<T, kS><<<grid, kThreads, smem, stream>>>(x, S, Z, l2, variance, out,
                                                        N, M, Q, cols);
  return cudaGetLastError();
}

}  // namespace
