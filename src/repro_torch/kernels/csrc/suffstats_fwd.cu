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
// What bounds it on this card: N M (M + 1) / 2 + N M exponentials and about
// N M (M + 1) / 2 (3Q + 2) floating-point operations against O(N (Q + D))
// bytes read, so the special-function unit's exp rate (float) or FP64 issue
// (double) bounds it, never memory.
//
// What the design does about it (common.cuh: psi2_partial_kernel, shared
// with psi2_fwd.cu):
//   * Only real pairs get a slot: the M (M + 1) / 2 pairs a <= b are packed
//     row by row and each thread of a pair block owns 4 of them, zbar in
//     registers when Q is a compile-time 1..4 (shared memory for a run-time
//     Q; above Q = 16 one pair a thread, so that zbar fits). A warp skips a slot that lies wholly past the last pair, so
//     a point costs 32 ceil(M (M + 1) / 64) exponentials: 5,056 for the
//     5,050 pairs at M = 100, none wasted at M = 256.
//   * Base-2 exponentials: log2(e) is folded into the staged per-point terms
//     r' and lg', so a pair's step (Q = 1) is FADD, FMUL, FFMA, MUFU.EX2,
//     FADD in float; in double a table-driven 2^x for x <= 0 (common.cuh:
//     exp2_neg, 32 entries and a degree-6 polynomial; no overflow branch).
//   * The exponent is the direct (mu - zbar)^2 r form, not the TPU kernel's
//     expanded MXU form, which cancels in float32 at large |mu| / l.
//   * Blocks fill the card in one even wave: the host picks the N-splits P
//     from the pair-block count and the resident blocks per multiprocessor
//     (cudaOccupancyMaxActiveBlocksPerMultiprocessor, suffstats_fwd_geometry),
//     never from timing, so the summation order is fixed.
//   * The TPU kernel carries its sums across a sequential grid; here blocks
//     run concurrently, so each writes a packed partial (P, M (M + 1) / 2)
//     and a second kernel sums the P partials in a fixed order in double
//     and mirrors the triangle. No atomics: results are bitwise equal from
//     run to run.
//   * Sums run in two levels: each staged run of 128 points in the input
//     dtype, the running total over runs (and the reduction over partials)
//     in double. A float thread's one long float sum over ~2e4 points was
//     off by ~1e-5 of psi2, enough to leave Kuu + beta psi2 indefinite in
//     float32 where the inducing points crowd.
//   * psiY runs in its own blocks per (32-row m tile, 8-column d tile,
//     N-split) with the same fixed-order reduction and accurate expf.
//   * Ragged N, M and D are masked at the bounds; nothing is padded.
//   * float and double instances compute in the input dtype.
#include "common.cuh"

namespace {

// psiY: kYTileM x kYTileD outputs per block, one per thread
constexpr int kYTileM = 32;
constexpr int kYTileD = kThreads / kYTileM;
constexpr int kYStage = 64;

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

template <typename T>
cudaError_t suffstats_fwd(const T* mu, const T* S, const T* Y, const T* Z,
                          const T* l2, T* part2, T* partY, T* acc2, T* accY,
                          int N, int M, int Q, int D, int P2, int PY,
                          cudaStream_t stream) {
  cudaError_t err = psi2_partials<T>(mu, S, Z, l2, part2, N, M, Q, P2, stream);
  if (err != cudaSuccess) return err;

  const dim3 gridY((M + kYTileM - 1) / kYTileM, (D + kYTileD - 1) / kYTileD, PY);
  const size_t smemY = sizeof(T) * (2 * kYStage * Q + kYStage + kYStage * kYTileD +
                                    kYStage * kYTileM + kYTileM * Q + Q);
  err = allow_smem(psiy_partial_kernel<T>, smemY);
  if (err != cudaSuccess) return err;
  psiy_partial_kernel<T><<<gridY, kThreads, smemY, stream>>>(mu, S, Y, Z, l2, partY, N, M, Q, D, PY);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = reduce_packed<T>(part2, acc2, P2, 1, M, stream);
  if (err != cudaSuccess) return err;
  return reduce_partials<T>(partY, accY, PY, 1, M, D, stream);
}

}  // namespace

// Plain C interface (bound with ctypes). Pointers are device pointers of
// contiguous row-major arrays: mu, S (N, Q); Y (N, D); Z (M, Q); l2 (Q);
// scratch part2 (P2, M (M + 1) / 2), partY (PY, M, D); outputs acc2 (M, M), accY
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

// out = [psi2 pairs per block, resident psi2 blocks per multiprocessor,
// staged run] for the float (f64 == 0) or double instance at Q, on the
// current device
extern "C" int suffstats_fwd_geometry(int f64, int Q, int* out) {
  return static_cast<int>(f64 ? psi2_geometry<double>(Q, out) : psi2_geometry<float>(Q, out));
}

extern "C" const char* suffstats_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
