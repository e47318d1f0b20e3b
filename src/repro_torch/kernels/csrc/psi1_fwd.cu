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
// What the design does about it (common.cuh: cross_kernel, which K_fu,
// kfu_fwd.cu, shares without S):
//   * One wave of persistent blocks: the host sizes the grid from the
//     occupancy query (psi1_fwd_geometry), each block owns an N-split and a
//     tile of `cols` inducing points (all M when M Q is small, as at the
//     paper's shape) and stages its Z tile once, transposed.
//   * The block walks its split in runs of points: while it computes one
//     run, one thread a point stages the next run's 1 / (l2 + S) and
//     log-normaliser (log2(e) folded in) into a second buffer, so each
//     run costs one barrier. Its threads walk the run's outputs in
//     row-major order with the row and column advanced by adds (no division
//     an output), so neighbouring threads store neighbouring addresses;
//     every output is stored once with a streaming store (st.global.cs).
//   * Base-2 exponentials: MUFU.EX2 in float, common.cuh: exp2_neg (a
//     32-entry table and a degree-6 polynomial) in double, not libdevice's
//     exp. The variance multiplies inside the kernel: no second pass over
//     the (N, M) output.
//   * The exponent is the direct (mu - z)^2 / (l2 + S) form, not the TPU
//     kernel's expanded c_n - 2 (mu b) Z^T + b (Z^2)^T MXU form, which
//     cancels in float32 when |mu|, |z| >> l.
//   * Ragged N and M are masked at the bounds; nothing is padded.
//   * float and double instances compute in the input dtype; Q = 1..4 is a
//     compile-time constant, any larger Q runs a run-time-Q instance.
#include "common.cuh"

// Plain C interface (bound with ctypes). Pointers are device pointers of
// contiguous row-major arrays: mu, S (N, Q); Z (M, Q); l2 (Q); variance (1);
// output out (N, M). `cols` is the inducing-point tile width (cols * Q
// elements of shared memory; the caller keeps it small), P the N-splits.
// Launches on `stream`, does not synchronize, returns the first
// cudaGetLastError() that is not cudaSuccess (0 on success).
#define PSI1_FWD_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const T* mu, const T* S, const T* Z, const T* l2,         \
                      const T* variance, T* out, int N, int M, int Q, int cols, \
                      int P, void* stream) {                                    \
    return static_cast<int>(cross_fwd<T, true>(mu, S, Z, l2, variance, out, N, \
                                               M, Q, cols, P,                   \
                                               static_cast<cudaStream_t>(stream))); \
  }

PSI1_FWD_ENTRY(psi1_fwd_f32, float)
PSI1_FWD_ENTRY(psi1_fwd_f64, double)

// out = [resident blocks a multiprocessor, shared-memory bytes a block] of
// the float (f64 == 0) or double instance at (Q, cols), on the current device
extern "C" int psi1_fwd_geometry(int f64, int Q, int cols, int* out) {
  return static_cast<int>(f64 ? cross_geometry<double, true>(Q, cols, out)
                              : cross_geometry<float, true>(Q, cols, out));
}

extern "C" const char* psi1_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
