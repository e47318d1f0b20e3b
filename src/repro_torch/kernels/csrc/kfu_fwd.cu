// K_fu, the RBF-ARD cross covariance of the sparse GP regression, written by
// hand for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/kfu.py: kfu_pallas (the Pallas TPU kernel
// _kfu_kernel). What it computes, with l2 = l^2:
//
//   K_fu[n, m] = v exp(-1/2 sum_q (x_nq - z_mq)^2 / l2_q)
//
// What bounds it on this card: it writes the (N, M) output once and reads
// O((N + M) Q) inputs, against N M exponentials and about N M (3 Q + 1)
// floating-point operations, so memory bytes bound it (at the paper's shape
// 0.4 GB in float32, 0.8 GB in double).
//
// What the design does about it:
//   * It is psi1's block kernel without S (common.cuh's cross_kernel with
//     kS = false): a block owns a run of 64 datapoints and a tile of `cols`
//     inducing points (all M at the paper's shape), stages them and 1 / l2 in
//     shared memory, and its threads walk the tile's outputs in row-major
//     order, so a block's stores are one contiguous run. No S is read and no
//     per-point normaliser is computed: at S = 0 psi1 would spend an (N, Q)
//     read and N Q log1p's on zeros.
//   * The variance multiplies inside the kernel: no second pass over the
//     (N, M) output.
//   * The exponent is the direct (x - z)^2 / l2 form, never negative, not the
//     TPU kernel's expanded |x/l|^2 + |z/l|^2 - 2 (x/l)(z/l)^T MXU form, which
//     cancels in float32 when |x|, |z| >> l (and needs its max(d2, 0) clamp).
//   * Ragged N and M are masked at the bounds; nothing is padded.
//   * float and double instances compute in the input dtype.
#include "common.cuh"

// Plain C interface (bound with ctypes). Pointers are device pointers of
// contiguous row-major arrays: X (N, Q); Z (M, Q); l2 (Q); variance (1);
// output out (N, M). `cols` is the inducing-point tile width (cols * Q
// elements of shared memory; the caller keeps it small). Launches on
// `stream`, does not synchronize, returns the first cudaGetLastError() that
// is not cudaSuccess (0 on success).
#define KFU_FWD_ENTRY(NAME, T)                                                     \
  extern "C" int NAME(const T* X, const T* Z, const T* l2, const T* variance,     \
                      T* out, int N, int M, int Q, int cols, void* stream) {      \
    return static_cast<int>(cross_fwd<T, false>(X, nullptr, Z, l2, variance, out, \
                                                N, M, Q, cols,                    \
                                                static_cast<cudaStream_t>(stream))); \
  }

KFU_FWD_ENTRY(kfu_fwd_f32, float)
KFU_FWD_ENTRY(kfu_fwd_f64, double)

extern "C" const char* kfu_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
