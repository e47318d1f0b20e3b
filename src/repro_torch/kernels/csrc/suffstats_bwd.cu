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
//   pair pass, per (a, b) and per datapoint n, from each E_nab once:
//     P_ab = sum_n E_nab,  A_abq = sum_n E_nab r_nq (mu_nq - zbar_abq)
//       (the global psi2 sums of eq. (18))
//     t = sum_{a<=b} Gw_ab E_ab, sd = sum Gw E (mu - zbar),
//     sv = sum Gw E (mu - zbar)^2, tz = sum Gw E (z_a - z_b)^2
//       (per point, as partials per pair block, one chunk of N at a time)
//   point pass, per datapoint n (eq. (10)-(11), (16)-(17)):
//     W1_m = (y_n . gyv_m) K_nm                          (eq. (8))
//     s1 = sum_m W1_m, s1d = sum_m W1_m (mu - z_m), s1v = sum_m W1_m (mu - z_m)^2
//     dmu = -b s1d - 2 r sd
//     dS  = -b s1 / 2 + b^2 s1v / 2 - r t + 2 r^2 sv
//     dY_n = sum_m K_nm gyv_m
//     dl (eq. (14), (20), its zterm part from tz) and dv_raw = s1 + 2 t,
//     summed over the points
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
// it, never memory.
//
// What the design does about it:
//   * Each psi2 exponential is evaluated once. The pair pass runs the
//     forward's packed pair blocks (common.cuh: only the pairs a <= b get a
//     slot, 32 ceil(M (M + 1) / 64) a point) over staged runs of 32 points;
//     from each E a thread feeds its pairs' P and A, kept in registers over
//     all its points, and the point's t, sd, sv and tz.
//   * Those per-point sums are reduced across the block in a fixed order: a
//     thread first sums its own slots, then a warp reduces G points at once
//     (reverse.cuh: warp_reduce_points; log2 G halving steps, then plain
//     xor steps), then shared memory sums the 8 warps, and each block writes
//     one partial per (pair block, point) to scratch (pair blocks, 1 + 3Q,
//     chunk). At Q = 1 (G = 4) that costs a warp 6 shuffles, 6 selects and 6
//     adds a point (cuobjdump -sass), against the 48 instructions of its
//     4 x 32 exponentials and moments: cheaper than evaluating every
//     exponential again in a pass of its own.
//   * The point pass, one thread per datapoint, sums a point's partials in
//     double in pair-block order, runs the psi1 branch (N M exponentials,
//     accurate expf) and forms the per-point cotangents and block partials
//     of dl and v dv.
//   * Base-2 exponentials with log2(e) folded into the staged terms, as the
//     forward: MUFU.EX2 in float, common.cuh: exp2_neg in double. A is summed
//     as sum E r' (mu - zbar) and divided once, in double, by the same
//     rounded constant r' carries, so no rounding of log2(e) biases it.
//   * The exponent is the direct (mu - zbar)^2 r form of the forward kernel
//     (suffstats_fwd.cu), not the TPU kernel's expanded MXU form, so the
//     reverse pass differentiates the exponential the forward evaluates;
//     the moments use mu - zbar directly (no mu^2 t - 2 mu u + w2
//     cancellation in float32).
//   * The TPU kernel carries dZ, dv and dl across its sequential grid; here
//     blocks run concurrently, so every global sum is written as per-block
//     partials and a further kernel sums them in an order fixed by the
//     shapes. No atomics: results are bitwise equal from run to run. The
//     N-splits come from the pair-block count and the resident blocks per
//     multiprocessor (suffstats_bwd_geometry), never from timing.
//   * The loss's g2 can be large and cancel across pairs (inducing points
//     that crowd, as the facades' init draws them), and a float64 reverse
//     pass is then only as good as its summation (chip_smoke.py checks
//     both reverse passes against an extended-precision one). So sums run in
//     two levels (the pair sums run by run, totals over runs and N-splits in
//     double, compensated in the double instance: a plain double total over
//     ~600 runs tripled the float64 dZ's distance from the plain pass at the
//     loss's cotangents; a point's sums over slots, lanes and warps in the
//     input dtype, over pair blocks in double), and dl's zterm part is summed
//     point by point rather than contracted from P, where all of N's
//     rounding meets the cancellation at once.
//   * The pair and point passes run chunk by chunk over N
//     (reverse.cuh: run_chunks), chunks of about N / (pair blocks) points,
//     so the per-point scratch holds about N (1 + 3Q) sums whatever M is
//     (one per (pair block, point) over all of N grew as N times the
//     pair-block count: 2.25 GiB of the dry run's 3.4 GiB peak at
//     N = 2^24, M = 128). Each split's pair sums continue across chunks in
//     double, compensation term included, so chunking costs them no
//     precision and their order stays fixed by the shapes.
//   * The pair and point passes live in reverse.cuh, shared with the
//     psi2-only reverse pass (psi2_bwd.cu), which runs them without the psi1
//     branch.
//   * The TPU kernel's (TN, TM, TM) workspace is never formed; a block's
//     shared memory holds one staged run and its warps' per-point sums.
//   * Ragged N, M and D are masked at the bounds; nothing is padded.
//   * float and double instances compute in the input dtype; Q = 1..4 is a
//     compile-time constant (registers), and any larger Q runs the run-time-Q
//     instances (reverse.cuh), which sum the moments a chunk of q's a pass
//     and so evaluate the exponentials once a pass, as dz1_partial_kernel
//     does at every Q.
#include "reverse.cuh"

namespace {

// dZ pass: kZTileM inducing points x kZLanes point lanes per block
constexpr int kZTileM = 32;
constexpr int kZLanes = kThreads / kZTileM;
constexpr int kZStage = 64;

// ---------------------------------------------------------------------------
// dZ pass: the psi1 branch of dZ (eq. (12)), m-parallel over an N-split
// ---------------------------------------------------------------------------

// part: (P, M, Q). The sums of kMaxQ q's a pass over the split, the pass's
// z in registers. kWide (Q > kMaxQ): a pass for each kMaxQ q's, each
// evaluating the exponentials again (the other q's z read through L1); the
// one-pass instance (q0 = 0) has no other q's. Both held to the resident
// blocks ptxas gave the one-pass kernel on its own (float 3, double 2 a
// multiprocessor): left free, it takes more registers and fewer blocks,
// and runs slower.
template <typename T, bool kWide>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 3 : 2)
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
  const T* g = gyv + static_cast<size_t>(mc) * D;

  for (int q0 = 0; q0 < (kWide ? Q : 1); q0 += kMaxQ) {
    T zm[kMaxQ], acc[kMaxQ];
#pragma unroll
    for (int q = 0; q < kMaxQ; ++q) {
      zm[q] = q0 + q < Q ? Z[static_cast<size_t>(mc) * Q + q0 + q] : T(0);
      acc[q] = T(0);
    }
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
        // the exponent in q order: the pass's q's from registers, the
        // others' z through L1
        T e = s_lg[i];
        auto other = [&](int q) {
          const T dq = s_mu[i * Q + q] - __ldg(Z + static_cast<size_t>(mc) * Q + q);
          e -= T(0.5) * dq * dq * s_b[i * Q + q];
        };
        if constexpr (kWide) {
          for (int q = 0; q < q0; ++q) other(q);
        }
        T d[kMaxQ];
#pragma unroll
        for (int q = 0; q < kMaxQ; ++q) {
          d[q] = T(0);
          if (q0 + q < Q) {
            d[q] = s_mu[i * Q + q0 + q] - zm[q];
            e -= T(0.5) * d[q] * d[q] * s_b[i * Q + q0 + q];
          }
        }
        if constexpr (kWide) {
          for (int q = q0 + kMaxQ; q < Q; ++q) other(q);
        }
        const T* y = Y + static_cast<size_t>(base + i) * D;
        T yg = T(0);
        for (int dd = 0; dd < D; ++dd) yg += y[dd] * g[dd];
        const T w1 = yg * exp_t(e);
#pragma unroll
        for (int q = 0; q < kMaxQ; ++q)
          if (q0 + q < Q) acc[q] += w1 * s_b[i * Q + q0 + q] * d[q];
      }
    }

    // sum the kZLanes lanes of each m in a fixed order
#pragma unroll
    for (int qq = 0; qq < kMaxQ; ++qq) {
      const int q = q0 + qq;
      if (q < Q) {
        __syncthreads();
        s_red[lane * kZTileM + mm] = acc[qq];
        __syncthreads();
        if (lane == 0 && m < M) {
          T s = T(0);
          for (int l = 0; l < kZLanes; ++l) s += s_red[l * kZTileM + mm];
          part[(static_cast<size_t>(p) * M + m) * Q + q] = s;
        }
      }
    }
  }
}

template <typename T>
cudaError_t suffstats_bwd(const T* mu, const T* S, const T* Y, const T* Z,
                          const T* l2, const T* ls, const T* Gw, const T* gyv,
                          T* dmu, T* dS, T* dY, T* point_part, T* point_sum,
                          T* pair_part, T* pair_sum, double* carry, T* pt, T* dz_part,
                          T* dz1, int N, int M, int Q, int D, int P2, int PZ, int NB,
                          int CN, cudaStream_t stream) {
  cudaError_t err = run_chunks<T, true>(P2, CN, stream, mu, S, Y, Z, l2, ls, Gw, gyv,
                                        pair_part, carry, pt, dmu, dS, dY, point_part, N,
                                        M, Q, D);
  if (err != cudaSuccess) return err;

  const dim3 gridZ((M + kZTileM - 1) / kZTileM, PZ);
  const size_t smemZ = sizeof(T) * (2 * kZStage * Q + kZStage + kZLanes * kZTileM);
  const auto dz_fn = Q > kMaxQ ? dz1_partial_kernel<T, true> : dz1_partial_kernel<T, false>;
  err = allow_smem(dz_fn, smemZ);
  if (err != cudaSuccess) return err;
  dz_fn<<<gridZ, kThreads, smemZ, stream>>>(mu, S, Y, Z, l2, gyv, dz_part, N, M, Q, D, PZ);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = reduce_partials<T>(point_part, point_sum, NB, 1, 1, Q + 1, stream);
  if (err != cudaSuccess) return err;
  err = reduce_packed<T>(pair_part, pair_sum, P2, Q + 1, M, stream);
  if (err != cudaSuccess) return err;
  return reduce_partials<T>(dz_part, dz1, PZ, 1, M, Q, stream);
}

}  // namespace

// Plain C interface (bound with ctypes). Pointers are device pointers of
// contiguous row-major arrays: mu, S (N, Q); Y (N, D); Z (M, Q); l2, ls (Q);
// Gw (M, M); gyv (M, D); outputs dmu, dS (N, Q), dY (N, D); scratch
// point_part (NB, Q + 1), pair_part (P2, Q + 1, M (M + 1) / 2), carry
// (2, P2, Q + 1, M (M + 1) / 2) doubles (null when CN >= N), pt (pair
// blocks, 1 + 3Q, min(CN, N)), dz_part (PZ, M, Q); sums point_sum (Q + 1) =
// [dl_point, dv_raw], pair_sum (Q + 1, M, M) = [P, A_1..A_Q], dz1 (M, Q).
// NB must be ceil(N / 256), CN (points a chunk of the pair and point
// passes) a multiple of 256 or >= N, and the pair-block count
// ceil(M (M + 1) / 2 / pairs per block) with suffstats_bwd_geometry's pairs
// per block. Launches
// on `stream`, does not synchronize, returns the first cudaGetLastError()
// that is not cudaSuccess (0 on success).
#define SUFFSTATS_BWD_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const T* mu, const T* S, const T* Y, const T* Z, const T* l2, \
                      const T* ls, const T* Gw, const T* gyv, T* dmu, T* dS, T* dY, \
                      T* point_part, T* point_sum, T* pair_part, T* pair_sum,       \
                      double* carry, T* pt, T* dz_part, T* dz1, int N, int M,       \
                      int Q, int D, int P2, int PZ, int NB, int CN, void* stream) { \
    return static_cast<int>(suffstats_bwd<T>(                                      \
        mu, S, Y, Z, l2, ls, Gw, gyv, dmu, dS, dY, point_part, point_sum,          \
        pair_part, pair_sum, carry, pt, dz_part, dz1, N, M, Q, D, P2, PZ, NB, CN,  \
        static_cast<cudaStream_t>(stream)));                                       \
  }

SUFFSTATS_BWD_ENTRY(suffstats_bwd_f32, float)
SUFFSTATS_BWD_ENTRY(suffstats_bwd_f64, double)

// out = [pairs per block, resident pair-pass blocks per multiprocessor,
// staged run, points per warp reduction] for the float (f64 == 0) or double
// instance at Q, on the current device
extern "C" int suffstats_bwd_geometry(int f64, int Q, int* out) {
  return static_cast<int>(f64 ? pair_geometry<double>(Q, out) : pair_geometry<float>(Q, out));
}

extern "C" const char* suffstats_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
