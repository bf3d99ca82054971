// Hand-written Hopper (sm_90a) kernel: the per-chunk screening certificate.
//
// Replaces the Pallas TPU kernel src/repro/kernels/screen_bound.py, _kernel
// (wrapper screen_bound): the (K,) column max of p / b over the rows with
// b > 0, where a row with b <= 0 (the inert ragged tail included) gives
// -inf. The screened host-fed solve launches it once per chunk, on the
// device buffer the chunk's accumulate reads, in the first epoch that
// streams the chunk (core/prefetch.py, core/screening.py).
//
// Bound on the card: bytes. It reads p and b once, 8 bytes per (row, k):
// 3.1 MB for a 65,536-row chunk at K = 6, about 0.94 us at 3.35 TB/s, so a
// call is bound by its two launches. One divide and one max per (row, k).
//
// Design. The TPU grid carried a (1, K) running max from one grid step to
// the next. Here each block owns a tile of rows, its threads walk the rows
// with a stride of the block size keeping a running max per k, a warp
// shuffle and a pass over the warps reduce the block, and the block writes
// a (K,) partial. The ordered fold of scd_fused.cu, with n_sum = 0, takes
// the running max of the partials onto a -inf seed. Max is exact in any
// order, so the result does not depend on the tiling and equals the plain
// version (kernels/ref.py, screen_bound_plain) bit for bit; still no float
// atomics. The divide is __fdiv_rn (correctly rounded, as the plain
// version's), and the file is built with --fmad=false and never with fast
// math: a certificate one ulp low could retire a chunk it must not. NaN
// inputs are outside the contract (fmaxf drops a NaN, torch.amax keeps it).

#include "scd_common.cuh"

namespace {

constexpr int kThreads = 256;

// One block per tile of tile_n rows. Partial per tile: the (K,) max.
__global__ void screen_bound_tile(const float* __restrict__ p,
                                  const float* __restrict__ b,
                                  float* __restrict__ part,
                                  long long n, int k, int tile_n) {
  __shared__ float s_max[(kThreads / 32) * KMAX];
  const long long lo = (long long)blockIdx.x * tile_n;
  const long long hi = (lo + tile_n < n) ? lo + tile_n : n;
  float m[KMAX];
  for (int j = 0; j < k; ++j) m[j] = ninf();
  for (long long row = lo + threadIdx.x; row < hi; row += blockDim.x) {
    for (int j = 0; j < k; ++j) {
      const float bv = b[row * k + j];
      const float ratio = (bv > 0.f) ? __fdiv_rn(p[row * k + j], bv) : ninf();
      m[j] = fmaxf(m[j], ratio);
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = 0; j < k; ++j) {
    float v = m[j];
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0) s_max[warp * k + j] = v;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    float v = ninf();
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) v = fmaxf(v, s_max[w * k + j]);
    part[(long long)blockIdx.x * k + j] = v;
  }
}

}  // namespace

extern "C" {

// part: (n_tiles, K) scratch; init: (K,) seed of the fold (-inf); out: (K,).
// Returns the first CUDA error (0 on success).
int screen_bound_launch(const float* p, const float* b, const float* init,
                        float* part, float* out, long long n, int k, int tile_n,
                        void* stream) {
  if (n < 1 || k < 1 || k > KMAX || tile_n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_tiles = (n + tile_n - 1) / tile_n;
  screen_bound_tile<<<(unsigned)n_tiles, kThreads, 0, s>>>(p, b, part, n, k, tile_n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_fold(part, init, out, n_tiles, k, 0, s);
}

}  // extern "C"
