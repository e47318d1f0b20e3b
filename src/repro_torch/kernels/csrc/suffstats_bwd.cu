// Reverse pass of the fused psi-statistics for the RBF-ARD kernel, written by
// hand for Hopper (sm_90a): every input cotangent of (psi2, psiY) from one
// read of the datapoints per pass.
//
// Replaces: src/repro/kernels/suffstats.py: suffstats_bwd_pallas (the Pallas
// TPU kernel _suffstats_bwd_kernel). Equation numbers are those of
// docs/derivations/suffstats_vjp.md. With l2 = l^2, r = 1 / (l2 + 2 S),
// b = 1 / (l2 + S), zbar_ab = (z_a + z_b) / 2 and the forward's factors
//
//   E_nab = exp(-1/2 sum_q log1p(2 S_nq / l2_q) - sum_q (mu_nq - zbar_abq)^2 r_nq)
//   K_nm  = exp(-1/2 sum_q log1p(S_nq / l2_q) - 1/2 sum_q (mu_nq - z_mq)^2 b_nq)
//
// the caller folds the (m, m')-only prefactor into the psi2 cotangent,
// G2p = g2 v^2 exp(zterm) (eq. (9)), passes Gw = the upper triangle of
// G2p + G2p^T with G2p's diagonal (E is symmetric, so only a <= b is
// visited) and gyv = v gY. The kernels compute
//
//   point pass, per datapoint n (eq. (10)-(11), (16)-(17)):
//     W1_m = (y_n . gyv_m) K_nm                          (eq. (8))
//     s1 = sum_m W1_m, s1d = sum_m W1_m (mu - z_m), s1v = sum_m W1_m (mu - z_m)^2
//     t = sum_{a<=b} Gw_ab E_ab, sd = sum Gw E (mu - zbar), sv = sum Gw E (mu - zbar)^2
//     dmu = -b s1d - 2 r sd
//     dS  = -b s1 / 2 + b^2 s1v / 2 - r t + 2 r^2 sv
//     dY_n = sum_m K_nm gyv_m
//     dl (eq. (14), (20), its zterm part from tz = sum Gw E (z_a - z_b)^2)
//     and dv_raw = s1 + 2 t, summed over the points
//   pair pass, per (a, b) (the global psi2 sums of eq. (18)):
//     P_ab = sum_n E_nab,  A_abq = sum_n E_nab r_nq (mu_nq - zbar_abq)
//   dZ pass, per m (eq. (12)):
//     dz1_mq = sum_n W1_nm b_nq (mu_nq - z_mq)
//
// and the caller's O(M^2 Q) epilogue turns P and A into the psi2 part of dZ
// and divides dv_raw by v (eq. (13), (19)).
//
// What bounds it on this card: the least work is the forward's
// N M (M + 1) / 2 + N M exponentials, each once, and about 11 Q + 3
// floating-point operations per (point, pair) (chip_smoke.py: bwd_bound_ms)
// against O(N (Q + D)) bytes, so the exp units (float) or FP64 issue bound
// it, never memory. This design evaluates every exponential twice.
//
// What the design does about it:
//   * The exponent is the direct (mu - zbar)^2 r form of the forward kernel
//     (suffstats_fwd.cu), not the TPU kernel's expanded MXU form, so the
//     reverse pass differentiates the exponential the forward evaluates;
//     the moments use mu - zbar directly (no mu^2 t - 2 mu u + w2
//     cancellation in float32).
//   * The TPU kernel carries dZ, dv and dl across its sequential grid; here
//     blocks run concurrently, so every global sum is written as per-block
//     partials and a second kernel sums them in an order fixed by the shapes.
//     No atomics: results are bitwise equal from run to run.
//   * Per-point sums need every pair for a point and per-pair sums need
//     every point for a pair, so the two run as separate passes: one thread
//     per datapoint walking the upper-triangular pairs (Gw and Z are read
//     at one address per warp, a broadcast), and a pair-parallel pass laid
//     out like the forward's psi2 (upper-triangular 32 x 32 tiles x
//     N-splits, staged points, register sums). The exponentials are thus
//     evaluated twice; a later version may share them.
//   * The loss's g2 can be large and cancel across pairs (inducing points
//     that crowd, as the facades' init draws them), and a float64 reverse
//     pass is then only as good as its summation (chip_smoke.py checks
//     both reverse passes against an extended-precision one). So sums run in
//     two levels (a point's pairs row by row; the pair pass's points run by
//     run, totals in double), and dl's zterm part is summed point by point
//     rather than contracted from P, where all of N's rounding meets the
//     cancellation at once.
//   * The point and pair passes live in reverse.cuh, shared with the psi2-only
//     reverse pass (psi2_bwd.cu), which runs them without the psi1 branch.
//   * The TPU kernel's (TN, TM, TM) workspace is never formed; nothing larger
//     than a block's staging run lives in shared memory, whatever M is.
//   * Ragged N, M and D are masked at the bounds; nothing is padded.
//   * float and double instances compute in the input dtype; Q = 1..4 is a
//     compile-time constant (registers), larger Q (<= 16) runs a run-time-Q
//     instance.
#include "reverse.cuh"

namespace {

// dZ pass: kZTileM inducing points x kZLanes point lanes per block
constexpr int kZTileM = 32;
constexpr int kZLanes = kThreads / kZTileM;
constexpr int kZStage = 64;

// ---------------------------------------------------------------------------
// dZ pass: the psi1 branch of dZ (eq. (12)), m-parallel over an N-split
// ---------------------------------------------------------------------------

// part: (P, M, Q)
template <typename T>
__global__ void __launch_bounds__(kThreads)
dz1_partial_kernel(const T* __restrict__ mu, const T* __restrict__ S,
                   const T* __restrict__ Y, const T* __restrict__ Z,
                   const T* __restrict__ l2, const T* __restrict__ gyv,
                   T* __restrict__ part, int N, int M, int Q, int D, int P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_mu = reinterpret_cast<T*>(smem_raw);  // [kZStage][Q]
  T* s_b = s_mu + kZStage * Q;               // [kZStage][Q]
  T* s_lg = s_b + kZStage * Q;               // [kZStage]
  T* s_red = s_lg + kZStage;                 // [kZLanes][kZTileM]

  const int tid = threadIdx.x;
  const int mm = tid % kZTileM;  // lane of a warp -> inducing point
  const int lane = tid / kZTileM;  // warp -> every kZLanes-th staged point
  const int m = blockIdx.x * kZTileM + mm;
  const int mc = min(m, M - 1);  // out-of-range m computes a real row, unwritten
  const int p = blockIdx.y;
  int n0, n1;
  split_range(N, P, p, &n0, &n1);

  T zm[kMaxQ], acc[kMaxQ];
#pragma unroll
  for (int q = 0; q < kMaxQ; ++q) {
    zm[q] = q < Q ? Z[static_cast<size_t>(mc) * Q + q] : T(0);
    acc[q] = T(0);
  }
  const T* g = gyv + static_cast<size_t>(mc) * D;

  for (int base = n0; base < n1; base += kZStage) {
    const int cnt = min(kZStage, n1 - base);
    __syncthreads();  // the previous run is consumed
    if (tid < cnt) {
      const size_t n = static_cast<size_t>(base + tid);
      T lg = T(0);
      for (int q = 0; q < Q; ++q) {
        const T s = S[n * Q + q];
        s_mu[tid * Q + q] = mu[n * Q + q];
        s_b[tid * Q + q] = T(1) / (l2[q] + s);
        lg += log1p_t(s / l2[q]);
      }
      s_lg[tid] = T(-0.5) * lg;
    }
    __syncthreads();
    for (int i = lane; i < cnt; i += kZLanes) {
      T e = s_lg[i];
      T d[kMaxQ];
#pragma unroll
      for (int q = 0; q < kMaxQ; ++q) {
        d[q] = T(0);
        if (q < Q) {
          d[q] = s_mu[i * Q + q] - zm[q];
          e -= T(0.5) * d[q] * d[q] * s_b[i * Q + q];
        }
      }
      const T* y = Y + static_cast<size_t>(base + i) * D;
      T yg = T(0);
      for (int dd = 0; dd < D; ++dd) yg += y[dd] * g[dd];
      const T w1 = yg * exp_t(e);
#pragma unroll
      for (int q = 0; q < kMaxQ; ++q)
        if (q < Q) acc[q] += w1 * s_b[i * Q + q] * d[q];
    }
  }

  // sum the kZLanes lanes of each m in a fixed order
#pragma unroll
  for (int q = 0; q < kMaxQ; ++q) {
    if (q < Q) {
      __syncthreads();
      s_red[lane * kZTileM + mm] = acc[q];
      __syncthreads();
      if (lane == 0 && m < M) {
        T s = T(0);
        for (int l = 0; l < kZLanes; ++l) s += s_red[l * kZTileM + mm];
        part[(static_cast<size_t>(p) * M + m) * Q + q] = s;
      }
    }
  }
}

template <typename T>
cudaError_t suffstats_bwd(const T* mu, const T* S, const T* Y, const T* Z,
                          const T* l2, const T* ls, const T* Gw, const T* gyv,
                          T* dmu, T* dS, T* dY, T* point_part, T* point_sum,
                          T* pair_part, T* pair_sum, T* dz_part, T* dz1, int N,
                          int M, int Q, int D, int P2, int PZ, int NB,
                          cudaStream_t stream) {
  cudaError_t err = point_pass<T, true>(NB, stream, mu, S, Y, Z, l2, ls, Gw, gyv,
                                         dmu, dS, dY, point_part, N, M, Q, D);
  if (err != cudaSuccess) return err;
  err = pair_pass<T>(P2, stream, mu, S, Z, l2, pair_part, N, M, Q);
  if (err != cudaSuccess) return err;

  const dim3 gridZ((M + kZTileM - 1) / kZTileM, PZ);
  const size_t smemZ = sizeof(T) * (2 * kZStage * Q + kZStage + kZLanes * kZTileM);
  dz1_partial_kernel<T><<<gridZ, kThreads, smemZ, stream>>>(mu, S, Y, Z, l2, gyv, dz_part,
                                                            N, M, Q, D, PZ);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = reduce_partials<T>(point_part, point_sum, NB, 1, 1, Q + 1, 0, stream);
  if (err != cudaSuccess) return err;
  err = reduce_partials<T>(pair_part, pair_sum, P2, Q + 1, M, M, kTile, stream);
  if (err != cudaSuccess) return err;
  return reduce_partials<T>(dz_part, dz1, PZ, 1, M, Q, 0, stream);
}

}  // namespace

// Plain C interface (bound with ctypes). Pointers are device pointers of
// contiguous row-major arrays: mu, S (N, Q); Y (N, D); Z (M, Q); l2, ls (Q);
// Gw (M, M); gyv (M, D); outputs dmu, dS (N, Q), dY (N, D); scratch
// point_part (NB, Q + 1), pair_part (P2, Q + 1, M, M), dz_part (PZ, M, Q);
// sums point_sum (Q + 1) = [dl_point, dv_raw], pair_sum (Q + 1, M, M) =
// [P, A_1..A_Q], dz1 (M, Q). NB must be ceil(N / 256). Launches on
// `stream`, does not synchronize, returns the first cudaGetLastError() that
// is not cudaSuccess (0 on success).
#define SUFFSTATS_BWD_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const T* mu, const T* S, const T* Y, const T* Z, const T* l2, \
                      const T* ls, const T* Gw, const T* gyv, T* dmu, T* dS, T* dY, \
                      T* point_part, T* point_sum, T* pair_part, T* pair_sum,       \
                      T* dz_part, T* dz1, int N, int M, int Q, int D, int P2,       \
                      int PZ, int NB, void* stream) {                               \
    return static_cast<int>(suffstats_bwd<T>(                                      \
        mu, S, Y, Z, l2, ls, Gw, gyv, dmu, dS, dY, point_part, point_sum,          \
        pair_part, pair_sum, dz_part, dz1, N, M, Q, D, P2, PZ, NB,                 \
        static_cast<cudaStream_t>(stream)));                                       \
  }

SUFFSTATS_BWD_ENTRY(suffstats_bwd_f32, float)
SUFFSTATS_BWD_ENTRY(suffstats_bwd_f64, double)

extern "C" const char* suffstats_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
