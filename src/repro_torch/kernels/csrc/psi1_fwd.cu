// Psi1 statistic of the RBF-ARD kernel, written by hand for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/psi1.py: psi1_pallas (the Pallas TPU kernel
// _psi1_kernel). What it computes, with l2 = l^2:
//
//   psi1[n, m] = v exp(-1/2 sum_q log1p(S_nq / l2_q)
//                      - 1/2 sum_q (mu_nq - z_mq)^2 / (l2_q + S_nq))
//
// What bounds it on this card: it writes the (N, M) output once and reads
// O(N Q) inputs, against N M exponentials and about N M (3 Q + 2)
// floating-point operations, so memory bytes bound it (at the paper's shape
// 0.4 GB in float32, 0.8 GB in double).
//
// What the design does about it:
//   * Each block owns a run of kPts datapoints and a tile of `cols` inducing
//     points (all M when M Q is small, as at the paper's shape): it computes
//     each point's log-normaliser and 1 / (l2 + S) once into shared memory
//     beside its Z tile, then its threads walk the tile's outputs in
//     row-major order, so neighbouring threads store neighbouring addresses
//     (with cols == M a block's outputs are one contiguous run).
//   * The variance multiplies inside the kernel: no second pass over the
//     (N, M) output.
//   * The exponent is the direct (mu - z)^2 / (l2 + S) form, not the TPU
//     kernel's expanded c_n - 2 (mu b) Z^T + b (Z^2)^T MXU form, which
//     cancels in float32 when |mu|, |z| >> l.
//   * Ragged N and M are masked at the bounds; nothing is padded.
//   * float and double instances compute in the input dtype.
#include "common.cuh"

namespace {

constexpr int kPts = 64;  // datapoints per block

template <typename T>
__global__ void __launch_bounds__(kThreads)
psi1_kernel(const T* __restrict__ mu, const T* __restrict__ S,
            const T* __restrict__ Z, const T* __restrict__ l2,
            const T* __restrict__ variance, T* __restrict__ out, int N, int M,
            int Q, int cols) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_z = reinterpret_cast<T*>(smem_raw);  // [cols][Q]
  T* s_mu = s_z + static_cast<size_t>(cols) * Q;  // [kPts][Q]
  T* s_b = s_mu + kPts * Q;                  // [kPts][Q]   1 / (l2 + S)
  T* s_lg = s_b + kPts * Q;                  // [kPts]      -1/2 sum log1p(S / l2)

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kPts;
  const int m0 = blockIdx.y * cols;
  const int pts = min(kPts, N - n0);
  const int width = min(cols, M - m0);
  for (int i = tid; i < width * Q; i += kThreads)
    s_z[i] = Z[static_cast<size_t>(m0) * Q + i];
  if (tid < pts) {
    const size_t n = static_cast<size_t>(n0 + tid);
    T lg = T(0);
    for (int q = 0; q < Q; ++q) {
      const T s = S[n * Q + q];
      const T l2q = l2[q];
      s_mu[tid * Q + q] = mu[n * Q + q];
      s_b[tid * Q + q] = T(1) / (l2q + s);
      lg += log1p_t(s / l2q);
    }
    s_lg[tid] = T(-0.5) * lg;
  }
  __syncthreads();

  const T v = *variance;
  for (int i = tid; i < pts * width; i += kThreads) {
    const int p = i / width;
    const int c = i - p * width;
    T e = s_lg[p];
    for (int q = 0; q < Q; ++q) {
      const T d = s_mu[p * Q + q] - s_z[c * Q + q];
      e -= T(0.5) * d * d * s_b[p * Q + q];
    }
    out[static_cast<size_t>(n0 + p) * M + m0 + c] = v * exp_t(e);
  }
}

template <typename T>
cudaError_t psi1_fwd(const T* mu, const T* S, const T* Z, const T* l2,
                     const T* variance, T* out, int N, int M, int Q, int cols,
                     cudaStream_t stream) {
  const dim3 grid((N + kPts - 1) / kPts, (M + cols - 1) / cols);
  const size_t smem = sizeof(T) * (static_cast<size_t>(cols) * Q + 2 * kPts * Q + kPts);
  psi1_kernel<T><<<grid, kThreads, smem, stream>>>(mu, S, Z, l2, variance, out, N, M, Q,
                                                   cols);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface (bound with ctypes). Pointers are device pointers of
// contiguous row-major arrays: mu, S (N, Q); Z (M, Q); l2 (Q); variance (1);
// output out (N, M). `cols` is the inducing-point tile width (cols * Q
// elements of shared memory; the caller keeps it small). Launches on
// `stream`, does not synchronize, returns the first cudaGetLastError() that
// is not cudaSuccess (0 on success).
#define PSI1_FWD_ENTRY(NAME, T)                                                     \
  extern "C" int NAME(const T* mu, const T* S, const T* Z, const T* l2,            \
                      const T* variance, T* out, int N, int M, int Q, int cols,    \
                      void* stream) {                                              \
    return static_cast<int>(psi1_fwd<T>(mu, S, Z, l2, variance, out, N, M, Q, cols, \
                                        static_cast<cudaStream_t>(stream)));       \
  }

PSI1_FWD_ENTRY(psi1_fwd_f32, float)
PSI1_FWD_ENTRY(psi1_fwd_f64, double)

extern "C" const char* psi1_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
