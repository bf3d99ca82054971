// Hand-written Hopper (sm_90a) kernel: the unfused §5.2 bucket histogram.
//
// Replaces the Pallas TPU kernel src/repro/kernels/bucket_hist.py, _kernel
// (wrapper bucket_hist): the v2 mass of the candidates per
// searchsorted-left bucket of v1 (bucket j holds edges[j-1] < v1 <=
// edges[j]), a (K, E+1) float32 histogram. The resident dense (Alg 3)
// solve runs it on the (n*P, K) candidates once per SCD pass, unchunked or
// once per chunk seeded with the running histogram.
//
// Bound on the card: bytes. It reads v1 and v2 once, 8 bytes per (row, k):
// 440 MB at n*P = 5.5 M rows and K = 10, about 0.13 ms at 3.35 TB/s. The E
// compares per (row, k) are far below the float32 rate.
//
// Design. The TPU grid carried the histogram across its in-order steps
// (`out += tile`). Here, as in scd_fused.cu, each block owns one tile of
// tile_n rows and writes a partial record whose every bin is a row-order
// sum from 0.0, and the ordered fold of scd_fused.cu adds the records onto
// the optional seed in tile order. No float atomics and no index_add_: the
// result depends only on the data and tile_n, so a chunked accumulation
// (chunk rows a multiple of tile_n) equals one call over all rows bit for
// bit, and the plain version in kernels/ref.py performs the same additions.
// Rows past n read as v1 = -1, v2 = 0, which adds nothing. Simple, not
// fast: strided row loads, one thread per bin walking the tile in shared
// memory.

#include "scd_common.cuh"

namespace {

// One block per tile. Record per tile: hist (K*(E+1)).
__global__ void bucket_hist_tile(const float* __restrict__ v1,
                                 const float* __restrict__ v2,
                                 const float* __restrict__ edges,
                                 float* __restrict__ part,
                                 long long n, int k, int e, int tile_n) {
  extern __shared__ float smem[];
  const int nb = e + 1;
  const int rec = k * nb;
  float* s_edges = smem;                                     // k * e
  float* s_v2 = s_edges + k * e;                             // tile_n * k
  int* s_idx = reinterpret_cast<int*>(s_v2 + tile_n * k);    // tile_n * k
  for (int i = threadIdx.x; i < k * e; i += blockDim.x) s_edges[i] = edges[i];
  __syncthreads();

  const int r = threadIdx.x;
  const long long row = (long long)blockIdx.x * tile_n + r;
  if (r < tile_n) {
    const bool live = row < n;
    for (int j = 0; j < k; ++j) {
      const float v = live ? v1[row * k + j] : -1.f;
      s_idx[r * k + j] = bin_of(s_edges + j * e, e, v);
      s_v2[r * k + j] = live ? v2[row * k + j] : 0.f;
    }
  }
  __syncthreads();

  float* out = part + (long long)blockIdx.x * rec;
  for (int slot = threadIdx.x; slot < rec; slot += blockDim.x) {
    const int j = slot / nb, t = slot - j * nb;
    float acc = 0.f;
    for (int rr = 0; rr < tile_n; ++rr)
      if (s_idx[rr * k + j] == t) acc = __fadd_rn(acc, s_v2[rr * k + j]);
    out[slot] = acc;
  }
}

}  // namespace

extern "C" {

size_t bucket_hist_smem_bytes(int k, int e, int tile_n) {
  return sizeof(float) * ((size_t)k * e + (size_t)tile_n * k * 2);
}

// part: (n_tiles, K*(E+1)); init, out: one record. Launches the tile
// kernel and the fold on `stream`; returns the first CUDA error.
int bucket_hist_launch(const float* v1, const float* v2, const float* edges,
                       const float* init, float* part, float* out, long long n,
                       int k, int e, int tile_n, void* stream) {
  if (n < 1 || k < 1 || k > KMAX || e < 1 || tile_n < 1 || tile_n > 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = bucket_hist_smem_bytes(k, e, tile_n);
  cudaError_t err = allow_smem(bucket_hist_tile, smem);
  if (err != cudaSuccess) return (int)err;
  const long long n_tiles = (n + tile_n - 1) / tile_n;
  bucket_hist_tile<<<(unsigned)n_tiles, threads_for(tile_n), smem, s>>>(
      v1, v2, edges, part, n, k, e, tile_n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rec = k * (e + 1);
  return (int)launch_fold(part, init, out, n_tiles, rec, rec, s);
}

}  // extern "C"
