// Psi2 statistic of the RBF-ARD kernel alone, written by hand for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/psi2.py: psi2_pallas (the Pallas TPU kernel
// _psi2_kernel). What it computes, with l2 = l^2 and zbar = (z_m + z_m') / 2:
//
//   acc[m, m'] = sum_n exp(-1/2 sum_q log1p(2 S_nq / l2_q)
//                          - sum_q (mu_nq - zbar_mm'q)^2 / (l2_q + 2 S_nq))
//
// The caller applies the O(M^2) prefactor: psi2 = v^2 exp(-|z_m - z_m'|^2 /
// 4 l^2) acc.
//
// What bounds it on this card: N M (M + 1) / 2 exponentials and about
// N M (M + 1) / 2 (3Q + 2) floating-point operations against O(N Q) bytes
// read, so the special-function unit's exp rate (float) or FP64 issue
// (double) bounds it, never memory.
//
// What the design does about it: it is the fused forward's psi2 half
// (suffstats_fwd.cu) without the psiY blocks, sharing its kernel
// (common.cuh: psi2_partial_kernel), as the TPU kernels share _psi2_tile:
//   * only the M (M + 1) / 2 pairs a <= b get a slot (packed row by row,
//     4 a thread; psi2 is symmetric), at most 31 slots a point wasted;
//   * base-2 exponentials, log2(e) folded into the staged per-point terms:
//     MUFU.EX2 in float, a table-driven 2^x for x <= 0 in double;
//   * the direct (mu - zbar)^2 r exponent, not the TPU kernel's expanded
//     MXU form, which cancels in float32 at large |mu| / l;
//   * N-splits chosen from the pair-block count and the resident blocks per
//     multiprocessor (psi2_fwd_geometry), so the grid is one even wave;
//   * each block stages 128 points' terms in shared memory and keeps its
//     sums in registers, in two levels (each staged run in the input dtype,
//     the total in double);
//   * the TPU kernel carries its sums across a sequential grid; here each
//     block writes a packed partial (P, M (M + 1) / 2) and a second kernel
//     sums the P partials in a fixed order, in double, and mirrors the
//     triangle: no atomics, bitwise repeatable;
//   * ragged N and M are masked at the bounds; nothing is padded.
#include "common.cuh"

namespace {

template <typename T>
cudaError_t psi2_fwd(const T* mu, const T* S, const T* Z, const T* l2, T* part,
                     T* acc, int N, int M, int Q, int P, cudaStream_t stream) {
  const cudaError_t err = psi2_partials<T>(mu, S, Z, l2, part, N, M, Q, P, stream);
  if (err != cudaSuccess) return err;
  return reduce_packed<T>(part, acc, P, 1, M, stream);
}

}  // namespace

// Plain C interface (bound with ctypes). Pointers are device pointers of
// contiguous row-major arrays: mu, S (N, Q); Z (M, Q); l2 (Q); scratch part
// (P, M (M + 1) / 2); output acc (M, M). Launches on `stream`, does not synchronize,
// returns the first cudaGetLastError() that is not cudaSuccess (0 on
// success).
#define PSI2_FWD_ENTRY(NAME, T)                                                   \
  extern "C" int NAME(const T* mu, const T* S, const T* Z, const T* l2, T* part,  \
                      T* acc, int N, int M, int Q, int P, void* stream) {         \
    return static_cast<int>(psi2_fwd<T>(mu, S, Z, l2, part, acc, N, M, Q, P,      \
                                        static_cast<cudaStream_t>(stream)));      \
  }

PSI2_FWD_ENTRY(psi2_fwd_f32, float)
PSI2_FWD_ENTRY(psi2_fwd_f64, double)

// out = [pairs per block, resident blocks per multiprocessor, staged run, 1]
// for the float (f64 == 0) or double instance at Q, on the current device
extern "C" int psi2_fwd_geometry(int f64, int Q, int* out) {
  return static_cast<int>(f64 ? psi2_geometry<double>(Q, out) : psi2_geometry<float>(Q, out));
}

extern "C" const char* psi2_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
