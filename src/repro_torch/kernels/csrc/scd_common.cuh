// Per-row building blocks shared by the kernels of csrc/: the Alg-5
// candidates and the greedy top-Q of one row, the searchsorted-left bin,
// row staging into shared memory, the ordered fold, the last-block ticket
// and the launch helpers.
// The tie and rounding semantics of the candidate map exist only here, as
// candidates_block does in the reference (src/repro/kernels/scd_candidates.py).
//
// Rounding: build without FMA contraction (--fmad=false) and never with
// --use_fast_math. p - lam*b, the divide and every sum round exactly as the
// plain versions' separate operations in kernels/ref.py.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

// KMAX bounds K for every kernel; KWIDE for the two on the MoE router's
// path (scd_fused_hist, adjusted_topc), whose K is an expert count (160 for
// deepseek-v2-236b). The other four stay at KMAX: _wrap.py sizes
// screen_bound's scratch by KMAX * KMAX.
#define KMAX 64
#define KWIDE 256
#define SMEM_DEFAULT 49152
#define SMEM_MAX 232448

__device__ __forceinline__ float ninf() { return -CUDART_INF_F; }

// Loop bound over a row's k items for a compile-time bound KC >= k: below
// KMAX the loops run KC times with a `j < k` guard, so `#pragma unroll`
// unrolls them fully and the per-row arrays live in registers; at KMAX and
// KWIDE they run k times (at KWIDE the per-row arrays live in local memory).
// Either way each item sees the same operations.
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

// The picks of topq_row over KC items: (KC + 63) / 64 words of bits, item
// j at bit j % 64 of word j / 64. At KC <= 64 it is one word.
template <int KC>
struct TopqMask {
  static constexpr int W = (KC + 63) / 64;
  unsigned long long w[W];
  __device__ __forceinline__ void set(int j) {
    if constexpr (W == 1) w[0] |= 1ull << j;
    else w[j >> 6] |= 1ull << (j & 63);
  }
  __device__ __forceinline__ bool operator[](int j) const {
    if constexpr (W == 1) return (w[0] >> j) & 1ull;
    else return (w[j >> 6] >> (j & 63)) & 1ull;
  }
  __device__ __forceinline__ bool any() const {
    unsigned long long a = 0ull;
#pragma unroll
    for (int i = 0; i < W; ++i) a |= w[i];
    return a != 0ull;
  }
};

// Greedy top-Q of one row's strictly positive values, ties to the lower
// index (the reference's _topq_mask): Q passes, each picking the largest
// value if it is above zero and knocking it out of `work` (overwritten).
// Returns the picks as a bit mask over the K items. Needs k <= KC; below
// KMAX the loops unroll and `work` stays in registers (kc_loop). The
// finalize kernel and adjusted_topc both select through it, so their ties
// cannot drift.
template <int KC>
__device__ __forceinline__ TopqMask<KC> topq_row(float* work, int k, int q) {
  const int kl = kc_loop<KC>(k);
  TopqMask<KC> x;
#pragma unroll
  for (int i = 0; i < TopqMask<KC>::W; ++i) x.w[i] = 0ull;
  for (int it = 0; it < q; ++it) {
    float m = ninf();
#pragma unroll
    for (int j = 0; j < kl; ++j)
      if (j < k) m = fmaxf(m, work[j]);
    if (!(m > 0.f)) break;
    bool hit = false;
#pragma unroll
    for (int j = 0; j < kl; ++j) {
      if (j < k && !hit && work[j] == m) { x.set(j); work[j] = ninf(); hit = true; }
    }
  }
  return x;
}

// Searchsorted-left bin of v against e >= 1 ascending (non-decreasing)
// edges: the count of edges below v, NaN giving 0. The edges below v form a
// prefix; binary lifting adds steps of 2^s, largest first, each taken when
// it stays inside the prefix.
__device__ __forceinline__ int bin_lift(const float* edges, int e, float v) {
  int bin = 0;
  for (int step = 1 << (31 - __clz(e)); step > 0; step >>= 1) {
    const int next = bin + step;
    if (next <= e && edges[next - 1] < v) bin = next;
  }
  return bin;
}

// Row staging. cp.async copies global memory into shared memory without
// passing through registers; 16-byte copies need both addresses 16-byte
// aligned, 4-byte ones any float address. `bytes` below the copy size
// zero-fills the rest.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Where a staged tile keeps its 16-byte units: unit u of the rows' range
// at unit phys(u) of the shared buffer. NoSwizzle keeps them in order.
// RowSwizzle is for rows of w = 2^shift units (k = 4w floats, w >= 2): it
// XORs a unit's place with its row's low three bits, which permutes the
// units of each aligned group of eight, so a thread that reads its own row
// a 16-byte unit at a time meets seven other rows on distinct bank groups
// (row-major rows of 8, 16 or 64 floats would put 2, 4 or 8 rows on one).
struct NoSwizzle {
  static constexpr bool identity = true;
  __device__ __forceinline__ int operator()(int u) const { return u; }
};

struct RowSwizzle {
  static constexpr bool identity = false;
  int shift, mask;   // mask 0: no swizzle
  __device__ __forceinline__ int operator()(int u) const {
    return u ^ ((u >> shift) & mask);
  }
};

// Offset of element i of a staged range of PER elements a unit, whose units
// sit at swz(unit).
template <int PER, typename Swz>
__device__ __forceinline__ int staged(const Swz& swz, int i) {
  if constexpr (Swz::identity) return i;
  else return PER * swz(i / PER) + i % PER;
}

// Copies count floats from src into dst (16-byte aligned shared memory), of
// which the first `valid` are read and the rest zero-filled; src may be
// unreadable past `valid` (masked copies read nothing from their address,
// which is src itself). 16-byte copies when src is aligned, else 4-byte.
// Each 16-byte unit lands at swz(unit). The caller waits
// (cp_async_wait_all, then __syncthreads).
template <typename Swz = NoSwizzle>
__device__ __forceinline__ void load_async(float* dst, const float* src, int count,
                                           int valid, Swz swz = {}) {
  if (valid <= 0) {
    for (int i = threadIdx.x; i < count; i += blockDim.x) dst[staged<4>(swz, i)] = 0.f;
  } else if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int i = 4 * threadIdx.x; i < count; i += 4 * blockDim.x) {
      const int v = min(max(valid - i, 0), 4);
      cp_async16(dst + 4 * swz(i >> 2), v ? src + i : src, 4 * v);
    }
  } else {
    for (int i = threadIdx.x; i < count; i += blockDim.x)
      cp_async4(dst + staged<4>(swz, i), i < valid ? src + i : src, i < valid ? 4 : 0);
  }
}

// Stores `count` elements of T from 16-byte aligned shared memory to dst,
// by the block: 16-byte vector stores when dst is aligned (consecutive
// threads on consecutive 16-byte pieces), the tail and unaligned dst one
// element a thread. The 16-byte unit u of dst is read from unit swz(u).
template <typename T, typename Swz = NoSwizzle>
__device__ __forceinline__ void store_tile(T* dst, const T* src, int count, Swz swz = {}) {
  constexpr int per = 16 / sizeof(T);
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int vecs = count / per;
    for (int i = threadIdx.x; i < vecs; i += blockDim.x)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[swz(i)];
    done = vecs * per;
  }
  for (int i = done + threadIdx.x; i < count; i += blockDim.x)
    dst[i] = src[staged<per>(swz, i)];
}

// acc folded with the count values src[0], src[stride], ... in order: added
// when `sum`, else by max. Their L2 loads run in groups of sixteen, each
// group issued before the previous group's adds.
__device__ __forceinline__ float fold_chain(float acc, const float* src, long long stride,
                                            long long count, bool sum) {
  long long t = 0;
  if (count >= 16) {
    float cur[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) cur[u] = __ldcg(src + u * stride);
    for (t = 16; t + 16 <= count; t += 16) {
      float nxt[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) nxt[u] = __ldcg(src + (t + u) * stride);
#pragma unroll
      for (int u = 0; u < 16; ++u) acc = sum ? __fadd_rn(acc, cur[u]) : fmaxf(acc, cur[u]);
#pragma unroll
      for (int u = 0; u < 16; ++u) cur[u] = nxt[u];
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) acc = sum ? __fadd_rn(acc, cur[u]) : fmaxf(acc, cur[u]);
  }
  for (; t < count; ++t) {
    const float v = __ldcg(src + t * stride);
    acc = sum ? __fadd_rn(acc, v) : fmaxf(acc, v);
  }
  return acc;
}

// One ticket per block on counter c (thread 0); true in the block that
// took the last of `total`, which also puts the counter back to zero. The
// fences order the block's earlier global writes before its ticket, and the
// last block's later reads after every ticket.
__device__ __forceinline__ bool last_ticket(int* c, long long total, int* s_flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool last = atomicAdd(c, 1) == total - 1;
    if (last) *c = 0;
    *s_flag = last;
  }
  __syncthreads();
  if (*s_flag) __threadfence();
  return *s_flag;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > SMEM_MAX) return cudaErrorInvalidValue;
  if (bytes <= SMEM_DEFAULT) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

inline int threads_for(int tile_n) { return (tile_n + 31) / 32 * 32; }

// Seeds of the ordered fold, a record cut into up to FOLD_SEGS segments in
// order: segment i has len[i] slots and starts from ptr[i], or from fill[i]
// in every slot where ptr[i] is null.
#define FOLD_SEGS 5
struct FoldSeeds {
  const float* ptr[FOLD_SEGS];
  int len[FOLD_SEGS];
  float fill[FOLD_SEGS];
  int count;
};

// The ordered fold of per-tile partial records (defined in scd_fused.cu),
// rec slots each, `stride` floats apart: out[i] = seed[i] + part[0][i] +
// part[1][i] + ... for i < n_sum, and the running max for the rest; with
// `neg_last`, out[rec] = -out[rec - 1] as well. Returns the launch's CUDA
// error. The second form seeds from one array init, records dense.
cudaError_t launch_fold(const float* part, const FoldSeeds& seeds, float* out,
                        long long n_tiles, int rec, int stride, int n_sum, bool neg_last,
                        cudaStream_t s);
cudaError_t launch_fold(const float* part, const float* init, float* out,
                        long long n_tiles, int rec, int n_sum, cudaStream_t s);
