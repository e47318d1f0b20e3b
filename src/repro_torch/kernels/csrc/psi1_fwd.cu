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
//   * Each block owns a run of 64 datapoints and a tile of `cols` inducing
//     points (all M when M Q is small, as at the paper's shape): it computes
//     each point's log-normaliser and 1 / (l2 + S) once into shared memory
//     beside its Z tile, then its threads walk the tile's outputs in
//     row-major order, so neighbouring threads store neighbouring addresses
//     (with cols == M a block's outputs are one contiguous run). The block
//     kernel is common.cuh's cross_kernel, which K_fu (kfu_fwd.cu) shares
//     without S.
//   * The variance multiplies inside the kernel: no second pass over the
//     (N, M) output.
//   * The exponent is the direct (mu - z)^2 / (l2 + S) form, not the TPU
//     kernel's expanded c_n - 2 (mu b) Z^T + b (Z^2)^T MXU form, which
//     cancels in float32 when |mu|, |z| >> l.
//   * Ragged N and M are masked at the bounds; nothing is padded.
//   * float and double instances compute in the input dtype.
#include "common.cuh"

// Plain C interface (bound with ctypes). Pointers are device pointers of
// contiguous row-major arrays: mu, S (N, Q); Z (M, Q); l2 (Q); variance (1);
// output out (N, M). `cols` is the inducing-point tile width (cols * Q
// elements of shared memory; the caller keeps it small). Launches on
// `stream`, does not synchronize, returns the first cudaGetLastError() that
// is not cudaSuccess (0 on success).
#define PSI1_FWD_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const T* mu, const T* S, const T* Z, const T* l2,         \
                      const T* variance, T* out, int N, int M, int Q, int cols, \
                      void* stream) {                                           \
    return static_cast<int>(cross_fwd<T, true>(mu, S, Z, l2, variance, out, N, \
                                               M, Q, cols,                      \
                                               static_cast<cudaStream_t>(stream))); \
  }

PSI1_FWD_ENTRY(psi1_fwd_f32, float)
PSI1_FWD_ENTRY(psi1_fwd_f64, double)

extern "C" const char* psi1_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
