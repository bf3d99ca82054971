// Hand-written Hopper (sm_90a) kernel: the unfused Alg-5 candidate map.
//
// Replaces the Pallas TPU kernel src/repro/kernels/scd_candidates.py,
// _kernel (wrapper scd_candidates): per row, the adjusted profits
// max(p - lam*b, 0), the Q-th / (Q+1)-th order statistics, pbar and the
// candidates v1 = (p - pbar)/b, v2 = b, invalid -> (-1, 0). The resident
// solve runs it once per SCD pass with reduce="exact", which then sorts the
// (n, K) candidates.
//
// Bound on the card: bytes. It reads p and b and writes v1 and v2, 16 bytes
// per (row, k): 1.6 GB at n = 10^7 and K = 10, about 0.48 ms at 3.35 TB/s.
// The arithmetic (Q+1 max passes over K per row) is far below the float32
// rate.
//
// Design: a staged row-tile map, as adjusted_topc.cu. One block owns
// CAND_ROWS consecutive rows, whose p and b are each one contiguous range of
// CAND_ROWS * K floats:
//   1. cp.async copies both ranges into shared memory, 16 bytes a copy (4
//      bytes where the source is not 16-byte aligned; load_async of
//      scd_common.cuh); the ragged last tile copies only its rows;
//   2. one thread per row loads its row from shared memory into registers
//      and runs candidates_row<KC> (the fused kernel's per-row math, so each
//      output equals the plain version, kernels/ref.py candidates_block, bit
//      for bit on any input), then writes v1 over its p and v2 over its b;
//   3. the block stores both tiles with 16-byte vector stores, consecutive
//      threads on consecutive addresses.
// KC (8, 16 or KMAX) is the compile-time bound on K under which the row's
// arrays stay in registers; the registers are budgeted for CAND_MIN_BLOCKS
// blocks an SM (twice that at KC = 8): 128 a thread at KC = 16, which holds
// the row's p, b, adjusted profits and work copy without a spill. Each block
// is one load, compute and store in turn, and small blocks interleave those
// phases across the SM more finely: on an H100 at K = 10, 64-row blocks ran
// the map in 0.62 ms, 256-row blocks in 0.80 ms, with the same registers a
// thread (a double-buffered persistent loop was no faster). Every tile's
// ranges stay 16-byte aligned (64 * K floats) and hold whole swizzle groups.
//
// Shared-memory banks. Thread r's row starts at float r*K, so at K = 8, 16
// or 64 a warp's rows start on 4, 2 or 1 distinct banks. A thread therefore
// moves its row in the widest piece that K allows (row_io): 16 bytes when
// 4 | K, 8 bytes when 2 | K, else 4 bytes. For 4 bytes (K odd) and 8 bytes
// (K/2 odd) the rows of a warp already fall on distinct banks. For 16 bytes
// the hardware serves eight threads at a time: rows of an odd number of
// units are conflict-free as they stand, and rows of 2, 4, 8 or 16 units (K
// = 8, 16, 32, 64) are staged with RowSwizzle, which XORs each unit's place
// with its row's low three bits. The 16-byte global copies and stores are
// kept; they go through the same swizzle. K = 24, 40, 48 and 56 keep two-
// or four-way conflicts.

#include "scd_common.cuh"

#define CAND_ROWS 64         // rows per block, one thread each
#define CAND_MIN_BLOCKS 8    // blocks per SM the registers are budgeted for (KC > 8)

namespace {

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

inline size_t cand_smem_bytes(int k) {
  return sizeof(float) * (2 * (size_t)round4(CAND_ROWS * k) + k);
}

// The staging swizzle for rows of k floats: RowSwizzle on rows of w = k/4 =
// 2, 4, 8, ... units, else none.
inline RowSwizzle cand_swizzle(int k) {
  const int w = k / 4;
  if (k % 4 != 0 || w < 2 || (w & (w - 1)) != 0) return {0, 0};
  int shift = 0;
  while ((1 << shift) < w) ++shift;
  return {shift, 7};
}

// Thread r's row of the staged tile, into registers v (LOAD) or from them
// back into the tile, in the widest pieces k allows (see the file's note).
template <int KC, bool LOAD>
__device__ __forceinline__ void row_io(float* tile, int r, int k, RowSwizzle swz,
                                       float* v) {
  const int kl = kc_loop<KC>(k);
  if ((k & 3) == 0) {
    float4* t4 = reinterpret_cast<float4*>(tile);
    const int w = k >> 2;
#pragma unroll
    for (int c = 0; c < (kl + 3) / 4; ++c) {
      if (4 * c >= k) continue;
      float4* a = t4 + swz(r * w + c);
      if (LOAD) {
        const float4 x = *a;
        v[4 * c] = x.x; v[4 * c + 1] = x.y; v[4 * c + 2] = x.z; v[4 * c + 3] = x.w;
      } else {
        *a = make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
      }
    }
  } else if ((k & 1) == 0) {
    float2* t2 = reinterpret_cast<float2*>(tile) + r * (k >> 1);
#pragma unroll
    for (int c = 0; c < (kl + 1) / 2; ++c) {
      if (2 * c >= k) continue;
      if (LOAD) {
        const float2 x = t2[c];
        v[2 * c] = x.x; v[2 * c + 1] = x.y;
      } else {
        t2[c] = make_float2(v[2 * c], v[2 * c + 1]);
      }
    }
  } else {
    float* t1 = tile + r * k;
#pragma unroll
    for (int j = 0; j < kl; ++j) {
      if (j >= k) continue;
      if (LOAD) v[j] = t1[j];
      else t1[j] = v[j];
    }
  }
}

template <int KC>
__global__ void __launch_bounds__(CAND_ROWS, KC <= 8 ? 2 * CAND_MIN_BLOCKS : CAND_MIN_BLOCKS)
scd_candidates_tile(const float* __restrict__ p, const float* __restrict__ b,
                    const float* __restrict__ lam, float* __restrict__ v1,
                    float* __restrict__ v2, long long n, int k, int q, RowSwizzle swz) {
  extern __shared__ __align__(16) float smem[];
  const int span = CAND_ROWS * k;
  float* s_p = smem;                      // p, then v1
  float* s_b = s_p + round4(span);        // b, then v2
  float* s_lam = s_b + round4(span);
  const long long row0 = (long long)blockIdx.x * CAND_ROWS;
  const int live = (int)min((long long)CAND_ROWS, n - row0);
  const int count = live * k;
  load_async(s_p, p + row0 * k, count, count, swz);
  load_async(s_b, b + row0 * k, count, count, swz);
  for (int i = threadIdx.x; i < k; i += blockDim.x) s_lam[i] = lam[i];
  cp_async_wait_all();
  __syncthreads();

  const int r = threadIdx.x;
  if (r < live) {
    float pv[KC], bv[KC];
    row_io<KC, true>(s_p, r, k, swz, pv);
    row_io<KC, true>(s_b, r, k, swz, bv);
    candidates_row<KC>(pv, bv, s_lam, k, q, pv, bv);
    row_io<KC, false>(s_p, r, k, swz, pv);
    row_io<KC, false>(s_b, r, k, swz, bv);
  }
  __syncthreads();
  store_tile(v1 + row0 * k, s_p, count, swz);
  store_tile(v2 + row0 * k, s_b, count, swz);
}

template <int KC>
cudaError_t launch_cand(const float* p, const float* b, const float* lam, float* v1,
                        float* v2, long long n, int k, int q, cudaStream_t s) {
  const size_t smem = cand_smem_bytes(k);
  cudaError_t err = allow_smem(scd_candidates_tile<KC>, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (n + CAND_ROWS - 1) / CAND_ROWS;
  scd_candidates_tile<KC><<<(unsigned)blocks, CAND_ROWS, smem, s>>>(
      p, b, lam, v1, v2, n, k, q, cand_swizzle(k));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// v1, v2: (n, K) outputs. Returns the launch's CUDA error (0 on success).
int scd_candidates_launch(const float* p, const float* b, const float* lam,
                          float* v1, float* v2, long long n, int k, int q,
                          void* stream) {
  if (n < 1 || k < 1 || k > KMAX || q < 0 ||
      (n + CAND_ROWS - 1) / CAND_ROWS > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 8) return (int)launch_cand<8>(p, b, lam, v1, v2, n, k, q, s);
  if (k <= 16) return (int)launch_cand<16>(p, b, lam, v1, v2, n, k, q, s);
  return (int)launch_cand<KMAX>(p, b, lam, v1, v2, n, k, q, s);
}

}  // extern "C"
