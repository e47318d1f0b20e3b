// Shared by the forward (suffstats_fwd.cu) and reverse (suffstats_bwd.cu)
// psi-statistics kernels: the psi2 tile layout, the per-point staging of the
// psi2 exponent's terms, and the fixed-order sum of per-block partials that
// keeps both kernels free of atomics and bitwise repeatable.
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

}  // namespace
