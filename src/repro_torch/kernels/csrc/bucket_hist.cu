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
// 440 MB at n*P = 5.5 M rows and K = 10, about 0.13 ms at 3.35 TB/s. A
// binary search over E edges and one shared-memory add per (row, k) are far
// below the float32 rate.
//
// Design: the histogram stage of hist_tile.cuh, which scd_fused.cu runs
// behind its candidate map, on the given candidates: one launch per call,
// cp.async loads of a sub-tile's v1 and v2 into shared memory,
// binary-search binning, per-run sums of HIST_RUN rows, and the in-kernel
// ordered fold of sub-tile and tile records onto the optional seed. No
// float atomics and no index_add_: the result depends only on the data and
// tile_n (any size; the map's default is 8,192 rows), so a chunked
// accumulation (chunk rows a multiple of tile_n) equals one call over all
// rows bit for bit, and the plain version in kernels/ref.py performs the
// same additions. Rows past n read as v1 = v2 = 0, which adds nothing.

#include "hist_tile.cuh"

extern "C" {

// One launch on `stream`; returns its CUDA error. hist_init (K*(E+1)) may be
// null (zeros); scratch holds hist_scratch(n, k, e, tile_n, 0) floats;
// tickets n_tiles + 1 zeroed ints, left at zero; out: (K*(E+1)).
int bucket_hist_launch(const float* v1, const float* v2, const float* edges,
                       const float* hist_init, float* scratch, int* tickets,
                       float* out, long long n, int k, int e, int tile_n,
                       void* stream) {
  if (n < 1 || k < 1 || k > KMAX || e < 1 || tile_n < 1)
    return (int)cudaErrorInvalidValue;
  HistArgs A{};
  A.a = v1; A.b = v2; A.edges = edges;
  A.hist_init = hist_init; A.out = out; A.tickets = tickets;
  A.n = n; A.k = k; A.e = e; A.tile_n = tile_n;
  return (int)launch_hist<false>(A, scratch, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
