// Per-row building blocks shared by the kernels of csrc/: the Alg-5
// candidates of one row, the searchsorted-left bin, and the launch helpers.
// The tie and rounding semantics of the candidate map exist only here, as
// candidates_block does in the reference (src/repro/kernels/scd_candidates.py).
//
// Rounding: build without FMA contraction (--fmad=false) and never with
// --use_fast_math. p - lam*b, the divide and every sum round exactly as the
// plain versions' separate operations in kernels/ref.py.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#define KMAX 64
#define SMEM_DEFAULT 49152
#define SMEM_MAX 232448

__device__ __forceinline__ float ninf() { return -CUDART_INF_F; }

// Loop bound over a row's k items for a compile-time bound KC >= k: below
// KMAX the loops run KC times with a `j < k` guard, so `#pragma unroll`
// unrolls them fully and the per-row arrays live in registers; at KMAX they
// run k times. Either way each item sees the same operations.
template <int KC>
__device__ __forceinline__ int kc_loop(int k) { return KC < KMAX ? KC : k; }

// Alg 5 for one row: ap = max(p - lam*b, 0), the Q-th / (Q+1)-th largest
// ap by Q+1 masked-max passes (the lowest index among the maxima is
// knocked out), pbar, and the candidate (v1, v2); invalid -> (-1, 0).
// Needs k <= KC. v1 may be pv and v2 may be bv (in place): item j is read
// before it is written, and no later item reads it.
template <int KC = KMAX>
__device__ __forceinline__ void candidates_row(const float* pv, const float* bv,
                                               const float* lam, int k, int q,
                                               float* v1, float* v2) {
  const int kl = kc_loop<KC>(k);
  float ap[KC];
#pragma unroll
  for (int j = 0; j < kl; ++j)
    if (j < k) ap[j] = fmaxf(__fsub_rn(pv[j], __fmul_rn(lam[j], bv[j])), 0.f);
  float q_th = CUDART_INF_F, q1_th = CUDART_INF_F;
  if (q < k) {
    float work[KC];
#pragma unroll
    for (int j = 0; j < kl; ++j)
      if (j < k) work[j] = ap[j];
    for (int i = 0; i <= q; ++i) {
      float m = ninf();
#pragma unroll
      for (int j = 0; j < kl; ++j)
        if (j < k) m = fmaxf(m, work[j]);
      if (i == q - 1) q_th = m;
      if (i == q) q1_th = m;
      bool hit = false;
#pragma unroll
      for (int j = 0; j < kl; ++j) {
        if (j < k && !hit && work[j] == m) { work[j] = ninf(); hit = true; }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kl; ++j) {
    if (j >= k) continue;
    const float pbar = (q >= k) ? 0.f : (ap[j] >= q_th ? q1_th : q_th);
    const bool valid = (pv[j] > pbar) && (bv[j] > 0.f);
    v1[j] = valid ? __fdiv_rn(__fsub_rn(pv[j], pbar), bv[j]) : -1.f;
    v2[j] = valid ? bv[j] : 0.f;
  }
}

// Greedy top-Q of one row's strictly positive values, ties to the lower
// index (the reference's _topq_mask): Q passes, each picking the largest
// value if it is above zero and knocking it out of `work` (overwritten).
// Returns the picks as a bit mask over the K items. The finalize kernel
// and adjusted_topc both select through it, so their ties cannot drift.
__device__ __forceinline__ unsigned long long topq_row(float* work, int k, int q) {
  unsigned long long x = 0ull;
  for (int it = 0; it < q; ++it) {
    float m = ninf();
    for (int j = 0; j < k; ++j) m = fmaxf(m, work[j]);
    if (!(m > 0.f)) break;
    for (int j = 0; j < k; ++j) {
      if (work[j] == m) { x |= 1ull << j; work[j] = ninf(); break; }
    }
  }
  return x;
}

// Searchsorted-left bin: the count of edges below v.
__device__ __forceinline__ int bin_of(const float* edges, int e, float v) {
  int c = 0;
  for (int t = 0; t < e; ++t) c += (edges[t] < v) ? 1 : 0;
  return c;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > SMEM_MAX) return cudaErrorInvalidValue;
  if (bytes <= SMEM_DEFAULT) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

inline int threads_for(int tile_n) { return (tile_n + 31) / 32 * 32; }

// The ordered fold of per-tile partial records (defined in scd_fused.cu):
// out[i] = init[i] + part[0][i] + part[1][i] + ... for i < n_sum, and the
// running max for the rest. Returns the launch's CUDA error.
cudaError_t launch_fold(const float* part, const float* init, float* out,
                        long long n_tiles, int rec, int n_sum, cudaStream_t s);
