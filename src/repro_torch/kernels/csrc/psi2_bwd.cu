// Reverse pass of the psi2 statistic alone for the RBF-ARD kernel, written by
// hand for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/suffstats.py: psi2_bwd_pallas (the Pallas TPU
// kernel _psi2_bwd_kernel), which is the fused reverse kernel with the
// psi1/psiY branch removed. Equation numbers are those of
// docs/derivations/suffstats_vjp.md. With l2 = l^2, r = 1 / (l2 + 2 S),
// zbar_ab = (z_a + z_b) / 2 and the forward's factor
//
//   E_nab = exp(-1/2 sum_q log1p(2 S_nq / l2_q) - sum_q (mu_nq - zbar_abq)^2 r_nq)
//
// the caller folds the (m, m')-only prefactor into the cotangent,
// G2p = g2 v^2 exp(zterm) (eq. (9)), and passes Gw = the upper triangle of
// G2p + G2p^T with G2p's diagonal. The kernels compute
//
//   pair pass, per (a, b) and per datapoint n, from each E_nab once:
//     P_ab = sum_n E_nab,  A_abq = sum_n E_nab r_nq (mu_nq - zbar_abq)
//       (the global sums of eq. (18))
//     t = sum_{a<=b} Gw_ab E_ab, sd = sum Gw E (mu - zbar),
//     sv = sum Gw E (mu - zbar)^2, tz = sum Gw E (z_a - z_b)^2
//       (per point, as partials per pair block, one chunk of N at a time)
//   point pass, per datapoint n (eq. (16)-(17), (19)-(20)):
//     dmu = -2 r sd,  dS = -r t + 2 r^2 sv,
//     dl (eq. (20)) and dv_raw = 2 t, summed over the points
//
// and the caller's O(M^2 Q) epilogue turns P and A into dZ and divides
// dv_raw by v.
//
// What bounds it on this card: the least work is N M (M + 1) / 2
// exponentials, each once, and about 11 Q + 3 floating-point operations per
// (point, pair) (chip_smoke.py: psi2_bwd_bound_ms) against O(N Q) bytes, so
// the exp units (float) or FP64 issue (double) bound it, never memory.
//
// What the design does about it: it runs the fused reverse kernel's pair
// and point passes (reverse.cuh) without the psi1 branch, as the TPU kernel
// is the fused one with that branch removed (suffstats_bwd.cu's header sets
// the design out):
//   * each psi2 exponential once, in the forward's packed pair blocks (only
//     pairs a <= b, at most 31 slots a point wasted); per-pair sums in
//     registers, per-point sums reduced across the block in a fixed order
//     and written per (pair block, point), then summed per point in double;
//     both passes run chunk by chunk over N (reverse.cuh: run_chunks), so
//     the per-point scratch holds one chunk, about N (1 + 3Q) sums in all;
//   * base-2 exponentials: MUFU.EX2 in float, a table-driven 2^x for
//     x <= 0 in double;
//   * the TPU kernel carries dZ, dv and dl across its sequential grid; here
//     every global sum is a per-block partial, summed by a further kernel in
//     an order fixed by the shapes: no atomics, bitwise repeatable;
//   * the direct (mu - zbar) exponent and moments, which do not cancel in
//     float32;
//   * two-level sums, and dl's zterm part summed point by point, where the
//     loss's g2 can be large and cancel across pairs;
//   * ragged N and M are masked at the bounds; nothing is padded.
#include "reverse.cuh"

namespace {

template <typename T>
cudaError_t psi2_bwd(const T* mu, const T* S, const T* Z, const T* l2,
                     const T* ls, const T* Gw, T* dmu, T* dS, T* point_part,
                     T* point_sum, T* pair_part, T* pair_sum, double* carry, T* pt,
                     int N, int M, int Q, int P2, int NB, int CN, cudaStream_t stream) {
  cudaError_t err = run_chunks<T, false>(P2, CN, stream, mu, S, nullptr, Z, l2, ls, Gw,
                                         nullptr, pair_part, carry, pt, dmu, dS, nullptr,
                                         point_part, N, M, Q, 0);
  if (err != cudaSuccess) return err;
  err = reduce_partials<T>(point_part, point_sum, NB, 1, 1, Q + 1, stream);
  if (err != cudaSuccess) return err;
  return reduce_packed<T>(pair_part, pair_sum, P2, Q + 1, M, stream);
}

}  // namespace

// Plain C interface (bound with ctypes). Pointers are device pointers of
// contiguous row-major arrays: mu, S (N, Q); Z (M, Q); l2, ls (Q); Gw
// (M, M); outputs dmu, dS (N, Q); scratch point_part (NB, Q + 1), pair_part
// (P2, Q + 1, M (M + 1) / 2), carry (2, P2, Q + 1, M (M + 1) / 2) doubles
// (null when CN >= N), pt (pair blocks, 1 + 3Q, min(CN, N)); sums point_sum
// (Q + 1) = [dl_point, dv_raw], pair_sum (Q + 1, M, M) = [P, A_1..A_Q]. NB
// must be ceil(N / 256), CN (points a chunk) a multiple of 256 or >= N, and
// the pair-block count ceil(M (M + 1) / 2 / pairs per block) with
// psi2_bwd_geometry's pairs per block. Launches on
// `stream`, does not synchronize, returns the first cudaGetLastError() that
// is not cudaSuccess (0 on success).
#define PSI2_BWD_ENTRY(NAME, T)                                                    \
  extern "C" int NAME(const T* mu, const T* S, const T* Z, const T* l2, const T* ls, \
                      const T* Gw, T* dmu, T* dS, T* point_part, T* point_sum,     \
                      T* pair_part, T* pair_sum, double* carry, T* pt, int N,      \
                      int M, int Q, int P2, int NB, int CN, void* stream) {        \
    return static_cast<int>(psi2_bwd<T>(mu, S, Z, l2, ls, Gw, dmu, dS, point_part, \
                                        point_sum, pair_part, pair_sum, carry, pt, \
                                        N, M, Q, P2, NB, CN,                       \
                                        static_cast<cudaStream_t>(stream)));       \
  }

PSI2_BWD_ENTRY(psi2_bwd_f32, float)
PSI2_BWD_ENTRY(psi2_bwd_f64, double)

// out = [pairs per block, resident pair-pass blocks per multiprocessor,
// staged run, points per warp reduction] for the float (f64 == 0) or double
// instance at Q, on the current device
extern "C" int psi2_bwd_geometry(int f64, int Q, int* out) {
  return static_cast<int>(f64 ? pair_geometry<double>(Q, out) : pair_geometry<float>(Q, out));
}

extern "C" const char* psi2_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
