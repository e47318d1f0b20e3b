// Shared by the psi-statistics kernels (suffstats_fwd.cu, suffstats_bwd.cu,
// psi2_fwd.cu, psi2_bwd.cu, psi1_fwd.cu, psi1_bwd.cu, kfu_fwd.cu): the
// packed pair layout of psi2, the exponentials of the psi2 kernels, the
// per-point staging of the psi2 exponent's terms, the psi2 partial-sum
// kernel of the two forwards, the (N, M) cross-statistic kernel of psi1 and
// K_fu, and the fixed-order sums of per-block partials that keep every
// kernel free of atomics and bitwise repeatable.
//
// The psi2 pair layout. psi2 is symmetric and zbar_ab = (z_a + z_b) / 2 is
// commutative in floating point, so only the M (M + 1) / 2 pairs a <= b are
// evaluated. They are numbered row by row, (0, 0), (0, 1), ..., (0, M - 1),
// (1, 1), ..., and a pair block of kThreads threads owns K consecutive runs
// of kThreads of them: slot k of thread t in pair block j is pair
// j K kThreads + k kThreads + t. A warp whose 32 slots all lie past the last
// pair skips that slot, so at most 31 slots a point are evaluated for
// nothing (none at M = 256; 6 at M = 100). kernels/suffstats.py mirrors this
// layout (pair_of, psi2_splits) and its CPU tests check it.
//
// The exponentials. The psi2 exponent is evaluated in base 2: the staged
// per-point terms carry u log2(e) (r' = u log2(e) / (l2 + 2 S), lg' =
// u log2(e) lognorm2, u = 1 in float and 32 in double), so a pair's step is
// a subtract, a multiply and an FMA per q, then exp2_neg. In float that is
// one ex2.approx.ftz.f32 (MUFU.EX2, relative error below 2^-22). In double
// it is a table-driven 2^(x / 32): the exponent is never positive (lg' <= 0
// and (mu - zbar)^2 r' >= 0), so there is no overflow branch, and below
// 2^-1020 (about e^-707) the result is flushed to 0.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// forward psi2 blocks: pair slots a thread owns, datapoints staged per step
constexpr int kFwdSlots = 4;
constexpr int kStage = 128;
constexpr double kLog2e = 0x1.71547652b82fep+0;
// base-2 exponent of a padding row of a staged run: 2^x is exactly 0
constexpr double kDeadExponent = -16384.0;
// dynamic shared memory above this needs an opt-in per kernel
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }
__device__ __forceinline__ float log1p_t(float x) { return log1pf(x); }
__device__ __forceinline__ double log1p_t(double x) { return log1p(x); }
__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

// Units of the staged base-2 exponents: 2^x in float, 2^(x / 32) in double
// (exp2_neg's split of x into whole 32nds is then one add). Both scalings
// are exact.
template <typename T>
__host__ __device__ constexpr double exp2_units() {
  return sizeof(T) == sizeof(double) ? 32.0 : 1.0;
}

// the factor the staged r' carries, u log2(e) rounded to T as the staging
// rounds it: dividing a sum of r' terms by it gives the sum of r terms
// without a bias from the rounding of log2(e) or ln(2)
template <typename T>
__device__ __forceinline__ double staged_r_scale() {
  return static_cast<double>(static_cast<T>(kLog2e * exp2_units<T>()));
}

// 2^(j / 32), j = 0..31, correctly rounded; exp2_neg's table
__device__ const double kExp2Table[32] = {
    0x1.0000000000000p+0, 0x1.059b0d3158574p+0, 0x1.0b5586cf9890fp+0, 0x1.11301d0125b51p+0,
    0x1.172b83c7d517bp+0, 0x1.1d4873168b9aap+0, 0x1.2387a6e756238p+0, 0x1.29e9df51fdee1p+0,
    0x1.306fe0a31b715p+0, 0x1.371a7373aa9cbp+0, 0x1.3dea64c123422p+0, 0x1.44e086061892dp+0,
    0x1.4bfdad5362a27p+0, 0x1.5342b569d4f82p+0, 0x1.5ab07dd485429p+0, 0x1.6247eb03a5585p+0,
    0x1.6a09e667f3bcdp+0, 0x1.71f75e8ec5f74p+0, 0x1.7a11473eb0187p+0, 0x1.82589994cce13p+0,
    0x1.8ace5422aa0dbp+0, 0x1.93737b0cdc5e5p+0, 0x1.9c49182a3f090p+0, 0x1.a5503b23e255dp+0,
    0x1.ae89f995ad3adp+0, 0x1.b7f76f2fb5e47p+0, 0x1.c199bdd85529cp+0, 0x1.cb720dcef9069p+0,
    0x1.d5818dcfba487p+0, 0x1.dfc97337b9b5fp+0, 0x1.ea4afa2a490dap+0, 0x1.f50765b6e4540p+0,
};
// (ln 2 / 32)^i / i!, i = 6..1: 2^(r / 32) - 1 = sum_i c_i r^i, |r| <= 1/2.
// In constant memory, so each DFMA reads its coefficient as an operand
// rather than rebuilding it in registers at every call.
__constant__ double kExp2Poly[6] = {
    0x1.430912f86c787p-43, 0x1.5d87fe78a6731p-35, 0x1.3b2ab6fba4e77p-27,
    0x1.c6b08d704a0c0p-20, 0x1.ebfbdff82c58fp-13, 0x1.62e42fefa39efp-6,
};

// 2^x for x <= 0 (float): one MUFU.EX2; subnormal results flush to 0
__device__ __forceinline__ float exp2_neg(float x, const double*) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 2^(x / 32) for x <= 0 (double), `tab` = kExp2Table in shared memory:
// x = m + r with m = rint(x) (exact; |r| <= 1/2), 2^(x / 32) =
// 2^(m >> 5) 2^((m & 31) / 32) 2^(r / 32), the last a degree-6 polynomial
// (truncation below 4e-18). 0 below x = -32640 (2^-1020), where 2^(m >> 5)
// would leave the normal range. About 1 ulp: 10 FP64 instructions.
__device__ __forceinline__ double exp2_neg(double x, const double* tab) {
  const double kd = x + 0x1.8p52;  // 1.5 2^52 + m: m in the low word
  const int m = __double2loint(kd);
  const double r = x - (kd - 0x1.8p52);
  const double t = tab[m & 31];
  const double scale = __hiloint2double(__double2hiint(t) + (m >> 5) * (1 << 20),
                                        __double2loint(t));
  double p = kExp2Poly[0];
#pragma unroll
  for (int i = 1; i < 6; ++i) p = fma(p, r, kExp2Poly[i]);
  const double y = fma(scale, p * r, scale);
  // x < -32640 (and any negative x of larger magnitude) has a larger high word
  return static_cast<unsigned>(__double2hiint(x)) > 0xC0DFE000u ? 0.0 : y;
}

// copy exp2_neg's table into shared memory (double instances only); the
// caller's barrier publishes it
template <typename T>
__device__ __forceinline__ void load_exp2_table(double* tab) {
  if (sizeof(T) == sizeof(double) && threadIdx.x < 32) tab[threadIdx.x] = kExp2Table[threadIdx.x];
}

// s + c += x, compensated (Neumaier): c carries what each addition rounds
// away, so a long running total keeps about twice double's precision
__device__ __forceinline__ void compensated_add(double& s, double& c, double x) {
  const double t = s + x;
  c += fabs(s) >= fabs(x) ? (s - t) + x : (x - t) + s;
  s = t;
}

// a running total over staged runs: compensated for double inputs, plain in
// float instances, where the float run sums round far more than a double
// total does (c then stays 0 and costs nothing)
template <typename T>
__device__ __forceinline__ void add_to_total(double& s, double& c, double x) {
  if constexpr (sizeof(T) == sizeof(double)) {
    compensated_add(s, c, x);
  } else {
    s += x;
  }
}

// a compile-time flag for versioning a loop in a generic lambda
template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// ---------------------------------------------------------------------------
// asynchronous copies, global -> shared (cp.async; Ampere and later)
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// one element (4 or 8 bytes), through L1
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src) {
  if constexpr (sizeof(T) == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
  }
}

// 16 aligned bytes, past L1 (streamed data)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// elements of T in 16 bytes
template <typename T>
__host__ __device__ constexpr int vec_elems() {
  return 16 / static_cast<int>(sizeof(T));
}

// where src[0] lands in a staged span: its address's offset within 16
// bytes, in elements, so that 16-byte chunks of global memory land on
// 16-byte boundaries of shared memory
template <typename T>
__device__ __forceinline__ int span_shift(const T* src) {
  return static_cast<int>((reinterpret_cast<unsigned long long>(src) & 15) / sizeof(T));
}

// shared-memory elements a staged span of `count` elements can take:
// count plus the largest shift, in whole 16-byte chunks
template <typename T>
__host__ __device__ constexpr int span_room(int count) {
  return (count + 2 * vec_elems<T>() - 2) / vec_elems<T>() * vec_elems<T>();
}

// Issue the asynchronous copy of src[0, count) to dst[shift, shift + count),
// shift = span_shift(src), dst 16-byte aligned: single elements up to the
// first 16-byte boundary of src, then 16-byte chunks, then single elements.
// Every thread of the block takes part; the caller commits the group.
template <typename T>
__device__ __forceinline__ void copy_span(T* dst, const T* src, int count) {
  constexpr int V = vec_elems<T>();
  const int shift = span_shift(src);
  const int head = shift == 0 ? 0 : min(count, V - shift);
  const int chunks = (count - head) / V;
  const int tail0 = head + chunks * V;
  for (int k = threadIdx.x; k < head; k += kThreads) cp_async_elem(dst + shift + k, src + k);
  for (int c = threadIdx.x; c < chunks; c += kThreads)
    cp_async16(dst + shift + head + c * V, src + head + c * V);
  for (int k = tail0 + threadIdx.x; k < count; k += kThreads) cp_async_elem(dst + shift + k, src + k);
}

// a streaming store (st.global.cs): written once, not read back soon
__device__ __forceinline__ void store_streaming(float* p, float x) { __stcs(p, x); }
__device__ __forceinline__ void store_streaming(double* p, double x) { __stcs(p, x); }

// out[i] = sum_{p = 0..P-1} part[p * total + i] for double partials, in
// that order, rounded once to T
template <typename T>
__global__ void __launch_bounds__(kThreads)
reduce_double_kernel(const double* __restrict__ part, T* __restrict__ out, int P,
                     size_t total) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= total) return;
  double acc = 0.0;
  for (int p = 0; p < P; ++p) acc += part[static_cast<size_t>(p) * total + idx];
  out[idx] = static_cast<T>(acc);
}

template <typename T>
cudaError_t reduce_double(const double* part, T* out, int P, size_t total,
                          cudaStream_t stream) {
  reduce_double_kernel<T><<<static_cast<unsigned>((total + kThreads - 1) / kThreads),
                            kThreads, 0, stream>>>(part, out, P, total);
  return cudaGetLastError();
}

// [begin, end) of the N axis owned by split p of P (sizes differ by <= 1)
__device__ __forceinline__ void split_range(int N, int P, int p, int* begin,
                                            int* end) {
  *begin = static_cast<int>(static_cast<long long>(N) * p / P);
  *end = static_cast<int>(static_cast<long long>(N) * (p + 1) / P);
}

// the pair (a <= b) numbered t in the packed upper triangle of M x M
__device__ __forceinline__ void pair_of(int t, int M, int* a, int* b) {
  int i = 0;
  while (t >= M - i) {
    t -= M - i;
    ++i;
  }
  *a = i;
  *b = i + t;
}

// the number of the pair (a, b), a <= b
__device__ __forceinline__ int pair_index(int a, int b, int M) {
  return a * M - a * (a - 1) / 2 + (b - a);
}

// stage `rows` datapoints from `base` (cnt of them real, the rest padding
// whose exponent makes exp2_neg exactly 0): mu, r' = u log2(e) / (l2 + 2 S)
// and lg' = -u log2(e) / 2 sum_q log1p(2 S / l2), u = exp2_units<T>();
// barriers before (the previous run is consumed) and after
template <typename T>
__device__ __forceinline__ void stage_psi2_points(T* s_mu, T* s_r, T* s_lg,
                                                  const T* mu, const T* S,
                                                  const T* l2, int base, int cnt,
                                                  int rows, int Q) {
  __syncthreads();
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    T lg = T(0);
    for (int q = 0; q < Q; ++q) {
      T m = T(0), r = T(0);
      if (i < cnt) {
        const size_t n = static_cast<size_t>(base + i);
        const T sv = S[n * Q + q];
        const T l2q = __ldg(l2 + q);
        m = mu[n * Q + q];
        r = T(kLog2e * exp2_units<T>()) / (l2q + T(2) * sv);
        lg += log1p_t(T(2) * sv / l2q);
      }
      s_mu[i * Q + q] = m;
      s_r[i * Q + q] = r;
    }
    s_lg[i] = i < cnt ? T(-0.5 * kLog2e * exp2_units<T>()) * lg
                      : T(kDeadExponent * exp2_units<T>());
  }
  __syncthreads();
}

// opt in to `smem` bytes of dynamic shared memory where it exceeds the default
template <typename F>
cudaError_t allow_smem(F fn, size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(fn),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// resident blocks of kThreads a multiprocessor holds of `fn` with `smem`
template <typename F>
cudaError_t blocks_per_sm(F fn, size_t smem, int* out) {
  const cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, fn, kThreads, smem);
}

// out[s, a, b] = sum_{p = 0..P-1} part[p, s, a, b], in that order and in
// double whatever T is
template <typename T>
__global__ void __launch_bounds__(kThreads)
reduce_partials_kernel(const T* __restrict__ part, T* __restrict__ out, int P,
                       size_t total) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= total) return;
  double acc = 0.0;
  for (int p = 0; p < P; ++p) acc += part[static_cast<size_t>(p) * total + idx];
  out[idx] = static_cast<T>(acc);
}

template <typename T>
cudaError_t reduce_partials(const T* part, T* out, int P, int slabs, int rows,
                            int cols, cudaStream_t stream) {
  const size_t total = static_cast<size_t>(slabs) * rows * cols;
  reduce_partials_kernel<T><<<static_cast<unsigned>((total + kThreads - 1) / kThreads),
                              kThreads, 0, stream>>>(part, out, P, total);
  return cudaGetLastError();
}

// out[s, a, b] = sum_{p = 0..P-1} part[p, s, pair_index(min(a, b), max(a, b))]
// in that order, in double and compensated: the full symmetric (slabs, M, M)
// from packed (P, slabs, M (M + 1) / 2) partials
template <typename T>
__global__ void __launch_bounds__(kThreads)
reduce_packed_kernel(const T* __restrict__ part, T* __restrict__ out, int P,
                     int slabs, int M) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const size_t per = static_cast<size_t>(M) * M;
  if (idx >= per * slabs) return;
  const size_t s = idx / per;
  const int a = static_cast<int>((idx % per) / M);
  const int b = static_cast<int>(idx % M);
  const size_t pairs = static_cast<size_t>(M) * (M + 1) / 2;
  const size_t src = s * pairs + pair_index(min(a, b), max(a, b), M);
  double acc = 0.0, err = 0.0;
  for (int p = 0; p < P; ++p)
    compensated_add(acc, err, part[static_cast<size_t>(p) * slabs * pairs + src]);
  out[idx] = static_cast<T>(acc + err);
}

template <typename T>
cudaError_t reduce_packed(const T* part, T* out, int P, int slabs, int M,
                          cudaStream_t stream) {
  const size_t total = static_cast<size_t>(slabs) * M * M;
  reduce_packed_kernel<T><<<static_cast<unsigned>((total + kThreads - 1) / kThreads),
                            kThreads, 0, stream>>>(part, out, P, slabs, M);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// psi2 partial sums: shared by the fused forward (suffstats_fwd.cu) and the
// psi2-only forward (psi2_fwd.cu)
// ---------------------------------------------------------------------------

// pair slots a thread of a forward psi2 block owns: kFwdSlots, or one
// above Q = 16, where the run-time-Q instance's zbar for kFwdSlots slots
// would outgrow shared memory in double
__host__ __device__ constexpr int fwd_slots(int Q) { return Q <= 16 ? kFwdSlots : 1; }

// dynamic shared memory of a forward psi2 block: exp2_neg's table, the
// staged run (mu, r', lg') and, with a run-time Q, the slots' zbar
template <typename T>
constexpr size_t psi2_smem_bytes(int Q, bool zbar_in_smem) {
  return sizeof(double) * 32 +
         sizeof(T) * (2 * kStage * Q + kStage +
                      (zbar_in_smem ? static_cast<size_t>(fwd_slots(Q)) * Q * kThreads : 0));
}

// part[p, t] = sum over split p's datapoints of
// exp2_neg(lg' - sum_q (mu_q - zbar_tq)^2 r'_q) for the pairs t of pair block
// blockIdx.x (grid.x = pair blocks, grid.y = N-splits).
// QC > 0: Q is the compile-time QC (zbar in registers);
// QC == 0: Q is read at run time (zbar in shared memory). K slots a thread.
// Sums run in two levels: each staged run in T, the total in double.
template <typename T, int QC, int K>
__global__ void __launch_bounds__(kThreads)
psi2_partial_kernel(const T* __restrict__ mu, const T* __restrict__ S,
                    const T* __restrict__ Z, const T* __restrict__ l2,
                    T* __restrict__ part, int N, int M, int Q, int P) {
  constexpr int QA = QC > 0 ? QC : 1;
  const int Qn = QC > 0 ? QC : Q;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* s_tab = reinterpret_cast<double*>(smem_raw);  // [32] (double only)
  T* s_mu = reinterpret_cast<T*>(s_tab + 32);  // [kStage][Q]
  T* s_r = s_mu + kStage * Qn;                 // [kStage][Q]
  T* s_lg = s_r + kStage * Qn;                 // [kStage]
  T* s_zb = s_lg + kStage;                     // QC == 0: [K][Q][kThreads]

  const int npairs = M * (M + 1) / 2;
  const int tid = threadIdx.x;
  const int first = blockIdx.x * K * kThreads;
  const int p = blockIdx.y;
  int n0, n1;
  split_range(N, P, p, &n0, &n1);
  load_exp2_table<T>(s_tab);

  bool live[K];  // warp-uniform: the warp has a real pair in slot k
  const bool all_live = first + K * kThreads <= npairs;  // block-uniform
  T zb[K][QA];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int t = first + k * kThreads + tid;
    live[k] = first + k * kThreads + (tid & ~31) < npairs;
    int a, b;
    pair_of(min(t, npairs - 1), M, &a, &b);
    const T* za = Z + static_cast<size_t>(a) * Qn;
    const T* zz = Z + static_cast<size_t>(b) * Qn;
    if constexpr (QC > 0) {
#pragma unroll
      for (int q = 0; q < QC; ++q) zb[k][q] = T(0.5) * (za[q] + zz[q]);
    } else {
      for (int q = 0; q < Qn; ++q) s_zb[(k * Qn + q) * kThreads + tid] = T(0.5) * (za[q] + zz[q]);
    }
  }

  double acc[K];  // the running total, over every staged run
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.0;
  for (int base = n0; base < n1; base += kStage) {
    const int cnt = min(kStage, n1 - base);
    stage_psi2_points(s_mu, s_r, s_lg, mu, S, l2, base, cnt, cnt, Qn);
    T run[K];  // one staged run's sum
#pragma unroll
    for (int k = 0; k < K; ++k) run[k] = T(0);
    // versioned on every slot being live (all pair blocks but the last), so
    // the full blocks test nothing per pair
    auto sweep = [&](auto full) {
      for (int i = 0; i < cnt; ++i) {
        const T lg = s_lg[i];
        if constexpr (QC > 0) {
          T m_[QC], r_[QC];
#pragma unroll
          for (int q = 0; q < QC; ++q) {
            m_[q] = s_mu[i * QC + q];
            r_[q] = s_r[i * QC + q];
          }
#pragma unroll
          for (int k = 0; k < K; ++k) {
            if (decltype(full)::value || live[k]) {
              T e = lg;
#pragma unroll
              for (int q = 0; q < QC; ++q) {
                const T d = m_[q] - zb[k][q];
                e = fma_t(-(d * r_[q]), d, e);
              }
              run[k] += exp2_neg(e, s_tab);
            }
          }
        } else {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            if (decltype(full)::value || live[k]) {
              T e = lg;
              for (int q = 0; q < Qn; ++q) {
                const T d = s_mu[i * Qn + q] - s_zb[(k * Qn + q) * kThreads + tid];
                e = fma_t(-(d * s_r[i * Qn + q]), d, e);
              }
              run[k] += exp2_neg(e, s_tab);
            }
          }
        }
      }
    };
    if (all_live) {
      sweep(Flag<true>{});
    } else {
      sweep(Flag<false>{});
    }
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] += static_cast<double>(run[k]);
  }

  T* out = part + static_cast<size_t>(p) * npairs;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int t = first + k * kThreads + tid;
    if (t < npairs) out[t] = static_cast<T>(acc[k]);
  }
}

template <typename T>
using Psi2Kernel = void (*)(const T*, const T*, const T*, const T*, T*, int, int,
                            int, int);

template <typename T>
Psi2Kernel<T> psi2_kernel(int Q) {
  switch (Q) {
    case 1: return psi2_partial_kernel<T, 1, kFwdSlots>;
    case 2: return psi2_partial_kernel<T, 2, kFwdSlots>;
    case 3: return psi2_partial_kernel<T, 3, kFwdSlots>;
    case 4: return psi2_partial_kernel<T, 4, kFwdSlots>;
    default:
      return fwd_slots(Q) == kFwdSlots ? psi2_partial_kernel<T, 0, kFwdSlots>
                                       : psi2_partial_kernel<T, 0, 1>;
  }
}

// the packed psi2 partials (P, M (M + 1) / 2) of every pair block and N-split
template <typename T>
cudaError_t psi2_partials(const T* mu, const T* S, const T* Z, const T* l2,
                          T* part, int N, int M, int Q, int P,
                          cudaStream_t stream) {
  const int npairs = M * (M + 1) / 2;
  const int per = fwd_slots(Q) * kThreads;
  const dim3 grid((npairs + per - 1) / per, P);
  const size_t smem = psi2_smem_bytes<T>(Q, Q > 4);
  const Psi2Kernel<T> fn = psi2_kernel<T>(Q);
  const cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return err;
  fn<<<grid, kThreads, smem, stream>>>(mu, S, Z, l2, part, N, M, Q, P);
  return cudaGetLastError();
}

// what the host needs to lay out a forward psi2 launch:
// out = [pairs per block, resident blocks per multiprocessor, staged run, 1]
template <typename T>
cudaError_t psi2_geometry(int Q, int* out) {
  out[0] = fwd_slots(Q) * kThreads;
  out[2] = kStage;
  out[3] = 1;
  return blocks_per_sm(psi2_kernel<T>(Q), psi2_smem_bytes<T>(Q, Q > 4), &out[1]);
}

// ---------------------------------------------------------------------------
// the (N, M) cross statistics: psi1 (psi1_fwd.cu) and K_fu (kfu_fwd.cu)
// ---------------------------------------------------------------------------

// datapoints a block stages per run (fewer for a large Q, so that two
// buffers of per-point terms stay small)
__host__ __device__ constexpr int cross_run(int Q) { return Q <= 16 ? 128 : 32; }

// dynamic shared memory of a cross block: exp2_neg's table, the Z tile
// transposed, 1 / l2 (K_fu) and two buffers of a run's per-point terms
template <typename T, bool kS>
__host__ __device__ inline size_t cross_smem_bytes(int Q, int cols) {
  const size_t per_buf = static_cast<size_t>(cross_run(Q)) * (kS ? 2 * Q + 1 : Q);
  return 32 * sizeof(double) + sizeof(T) * (static_cast<size_t>(cols) * Q + Q + 2 * per_buf);
}

// out[n, m] = v exp(lg_n - 1/2 sum_q (x_nq - z_mq)^2 b_nq) for the N-split
// blockIdx.x of P and the tile of `cols` inducing points blockIdx.y.
// kS (psi1): b_nq = 1 / (l2_q + S_nq) and lg_n = -1/2 sum_q log1p(S_nq / l2_q);
// !kS (K_fu): b_q = 1 / l2_q and lg = 0, S is not read. A persistent block
// stages its Z tile once (transposed, so neighbouring threads read
// neighbouring banks), then walks its split in runs of cross_run(Q) points:
// one thread a point stages the next run's terms (base-2: log2(e) folded
// in) into the other buffer while the block computes this run's outputs in
// row-major order, thread t the outputs t, t + kThreads, ... (its row and
// column advanced by adds, no division), each stored once with a streaming
// store; neighbouring threads store neighbouring addresses. One barrier a
// run. QC > 0: Q is the compile-time QC; QC == 0: Q at run time.
template <typename T, bool kS, int QC>
__global__ void __launch_bounds__(kThreads)
cross_kernel(const T* __restrict__ x, const T* __restrict__ S,
             const T* __restrict__ Z, const T* __restrict__ l2,
             const T* __restrict__ variance, T* __restrict__ out, int N, int M,
             int Q, int cols, int P) {
  const int Qn = QC > 0 ? QC : Q;
  const int R = cross_run(Qn);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* s_tab = reinterpret_cast<double*>(smem_raw);    // [32] (double only)
  T* s_zt = reinterpret_cast<T*>(s_tab + 32);             // [Q][W]
  T* s_bq = s_zt + static_cast<size_t>(cols) * Qn;        // !kS: [Q]
  T* s_buf = s_bq + Qn;                                    // 2 x ([R][Q] x; kS: [R][Q] bx, [R] lg)
  const int per_buf = R * (kS ? 2 * Qn + 1 : Qn);

  const int tid = threadIdx.x;
  const int p = blockIdx.x;
  const int m0 = blockIdx.y * cols;
  const int W = min(cols, M - m0);
  int n0, n1;
  split_range(N, P, p, &n0, &n1);
  const T kx = T(0.5 * kLog2e * exp2_units<T>());
  const T kl = T(-0.5 * kLog2e * exp2_units<T>());
  load_exp2_table<T>(s_tab);
  for (int k = tid; k < W * Qn; k += kThreads) {
    const int m = k / Qn, q = k - m * Qn;
    s_zt[q * W + m] = Z[static_cast<size_t>(m0) * Qn + k];
  }
  if constexpr (!kS)
    for (int q = tid; q < Qn; q += kThreads) s_bq[q] = kx / l2[q];

  // the per-point terms of points [base, base + cnt) into buf
  auto prep = [&](int base, int cnt, T* buf) {
    for (int i = tid; i < cnt; i += kThreads) {
      const size_t n = static_cast<size_t>(base + i);
      T lg = T(0);
      for (int q = 0; q < Qn; ++q) {
        buf[i * Qn + q] = x[n * Qn + q];
        if constexpr (kS) {
          const T s = S[n * Qn + q];
          const T l2q = __ldg(l2 + q);
          buf[(R + i) * Qn + q] = kx / (l2q + s);
          lg += log1p_t(s / l2q);
        }
      }
      if constexpr (kS) buf[2 * R * Qn + i] = kl * lg;
    }
  };

  const int runs = (n1 - n0 + R - 1) / R;
  prep(n0, min(R, n1 - n0), s_buf);
  const int i_first = tid / W, m_first = tid - i_first * W;
  const int di = kThreads / W, dm = kThreads - di * W;
  const size_t step = static_cast<size_t>(di) * M + dm;  // offset of the next output
  const T v = *variance;
  for (int k = 0; k < runs; ++k) {
    // buffer k & 1 is staged; buffer (k + 1) & 1 was last read in run k - 1
    __syncthreads();
    const int base = n0 + k * R, cnt = min(R, n1 - base);
    if (k + 1 < runs) prep(base + R, min(R, n1 - base - R), s_buf + ((k + 1) & 1) * per_buf);
    const T* xs = s_buf + (k & 1) * per_buf;
    const T* bxs = xs + R * Qn;
    const T* lgs = xs + 2 * R * Qn;
    T* o = out + static_cast<size_t>(base) * M + m0;
    size_t off = static_cast<size_t>(i_first) * M + m_first;
    for (int i = i_first, m = m_first; i < cnt;) {
      T e = T(0);
      if constexpr (kS) e = lgs[i];
      if constexpr (QC > 0) {
#pragma unroll
        for (int q = 0; q < QC; ++q) {
          const T d = xs[i * QC + q] - s_zt[q * W + m];
          e = fma_t(-(d * (kS ? bxs[i * QC + q] : s_bq[q])), d, e);
        }
      } else {
        for (int q = 0; q < Qn; ++q) {
          const T d = xs[i * Qn + q] - s_zt[q * W + m];
          e = fma_t(-(d * (kS ? bxs[i * Qn + q] : s_bq[q])), d, e);
        }
      }
      store_streaming(o + off, v * exp2_neg(e, s_tab));
      m += dm;
      i += di;
      off += step;
      if (m >= W) {
        m -= W;
        ++i;
        off += M - W;
      }
    }
  }
}

template <typename T>
using CrossKernel = void (*)(const T*, const T*, const T*, const T*, const T*, T*, int,
                             int, int, int, int);

template <typename T, bool kS>
CrossKernel<T> cross_kernel_for(int Q) {
  switch (Q) {
    case 1: return cross_kernel<T, kS, 1>;
    case 2: return cross_kernel<T, kS, 2>;
    case 3: return cross_kernel<T, kS, 3>;
    case 4: return cross_kernel<T, kS, 4>;
    default: return cross_kernel<T, kS, 0>;
  }
}

// grid (P N-splits, ceil(M / cols) tiles)
template <typename T, bool kS>
cudaError_t cross_fwd(const T* x, const T* S, const T* Z, const T* l2,
                      const T* variance, T* out, int N, int M, int Q, int cols, int P,
                      cudaStream_t stream) {
  const dim3 grid(P, (M + cols - 1) / cols);
  const size_t smem = cross_smem_bytes<T, kS>(Q, cols);
  const CrossKernel<T> fn = cross_kernel_for<T, kS>(Q);
  const cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return err;
  fn<<<grid, kThreads, smem, stream>>>(x, S, Z, l2, variance, out, N, M, Q, cols, P);
  return cudaGetLastError();
}

// out = [resident blocks a multiprocessor, shared-memory bytes a block]
template <typename T, bool kS>
cudaError_t cross_geometry(int Q, int cols, int* out) {
  const size_t smem = cross_smem_bytes<T, kS>(Q, cols);
  out[1] = static_cast<int>(smem);
  return blocks_per_sm(cross_kernel_for<T, kS>(Q), smem, &out[0]);
}

}  // namespace
