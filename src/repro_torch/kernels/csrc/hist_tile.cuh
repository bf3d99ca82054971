// The histogram stage that scd_fused.cu (with the Alg-5 candidate map in
// front) and bucket_hist.cu (on given candidates) share: load a sub-tile of
// rows, bin each (row, k) by a binary search, add the masses run by run, and
// fold the records in a fixed order. One launch per call.
//
// The addition order, a fixed function of row position only (the plain
// versions in kernels/ref.py perform the same additions):
//   * a tile is tile_n consecutive rows (any tile_n >= 1); it is cut into
//     sub-tiles of HIST_SUB rows from its start (the last may be short), and
//     a sub-tile into runs of HIST_RUN rows (the last may be short);
//   * run sum: each (k, bin) is a sum of the run's masses in row order, from
//     0.0;
//   * sub-tile record: the run sums added in run order, from 0.0;
//   * tile record: the sub-tile records added in sub-tile order, from 0.0;
//   * result: the tile records added onto the seed (hist_init, or zeros) in
//     tile order; the top slots of the fused record fold by max (exact in any
//     order) from top_init, or -inf.
// So the result depends only on the data and tile_n: a chunked accumulation
// whose chunks are a multiple of tile_n equals one call over all rows bit
// for bit, run after run, on the card and on the CPU. Rows past n read as
// zeros (p = b = 0, or v1 = v2 = 0): their mass is 0.0, and adding +0.0 to a
// sum that starts at +0.0 changes no bit, so ragged tails, padded chunks and
// unlaunched rows are all inert.
//
// One block per sub-tile (at most HIST_SUB rows, one thread per row):
//   1. cp.async copies the sub-tile's rows of both inputs, which are
//      contiguous, into shared memory (16-byte copies when aligned, else
//      4-byte; masked bytes are zero-filled) while the block stages the
//      edges;
//   2. one thread per row computes its candidates (fused) in place and bins
//      each k by binary lifting over the k-th edge row in shared memory
//      (exactly searchsorted-left, like bin_lift), writing the bin over v1; for
//      K <= 16 the row's work arrays are registers (KC, kc_loop in
//      scd_common.cuh), at most 64 a thread so that two blocks share an SM
//      (three, at 42 registers, spilled and ran slower); the fused map's
//      KWIDE instance (K <= 256) keeps them in local memory;
//   3. one thread per (run, k) loads its run's bins and masses eight rows
//      ahead and adds them in row order into that run's histogram in shared
//      memory: O(1) per (row, k);
//   4. one thread per (k, bin) adds the run sums in run order and writes the
//      sub-tile record (with the block's max of v1 per k, fused).
// The last block of a tile to finish (an integer ticket after
// __threadfence, never a float atomic) adds the tile's sub-tile records in
// order into the tile record; the last tile to finish folds all tile records
// onto the seed, each thread a slot with its loads issued sixteen ahead of
// the add chain. The tickets are left at zero for the next call.
#pragma once

#include "scd_common.cuh"

#define HIST_RUN 32          // rows per run
#define HIST_SUB 512         // rows per sub-tile: one block
#define HIST_MIN_BLOCKS 2    // blocks per SM the registers are budgeted for

namespace {

struct HistArgs {
  const float* a;          // fused: p; bucket: v1. (n, K) row-major
  const float* b;          // fused: b; bucket: v2
  const float* lam;        // (K,), fused only
  const float* edges;      // (K, E), ascending per row
  const float* hist_init;  // (K*(E+1),) or null (zeros)
  const float* top_init;   // (K,) or null (-inf), fused only
  float* sub_rec;          // (n_tiles * subs, rec), used when subs > 1
  float* tile_rec;         // (n_tiles, rec)
  float* out;              // (rec,)
  int* tickets;            // (n_tiles + 1,), zero on entry and on exit
  long long n, n_tiles;
  int k, e, q, tile_n, subs;
};

__host__ __device__ inline int hist_sub_rows(int tile_n) {
  return tile_n < HIST_SUB ? tile_n : HIST_SUB;
}

__host__ __device__ inline int hist_round4(int x) { return (x + 3) & ~3; }

// Floats of dynamic shared memory per block: the two row buffers first (so
// that they are 16-byte aligned), then the run histograms, the edges, lam
// and the per-warp maxima.
__host__ __device__ inline size_t hist_smem_floats(int k, int e, int tile_n, bool fused) {
  const int rows = hist_sub_rows(tile_n);
  const int runs = (rows + HIST_RUN - 1) / HIST_RUN;
  const int warps = (rows + 31) / 32;
  return 2 * (size_t)hist_round4(rows * k) + (size_t)runs * k * (e + 1) + (size_t)k * e +
         (fused ? (size_t)k + (size_t)warps * k : 0);
}

// Searchsorted-left bins of one row's k values: bin[j] = the count of
// edges of row j (ascending, non-decreasing) below v[j], as bin_lift counts
// them (NaN gives 0). Binary lifting: the edges below v form a prefix, and
// steps of 2^s, largest first, each taken when it stays inside the prefix,
// add up to its length. The k searches advance together, so their
// shared-memory loads overlap.
template <int KC>
__device__ __forceinline__ void bin_row(const float* edges, int e, int k,
                                        const float* v, int* bin) {
  const int kl = kc_loop<KC>(k);
#pragma unroll
  for (int j = 0; j < kl; ++j) bin[j] = 0;
  for (int step = 1 << (31 - __clz(e)); step > 0; step >>= 1) {
#pragma unroll
    for (int j = 0; j < kl; ++j) {
      const int next = bin[j] + step;
      if (j < k && next <= e && edges[j * e + next - 1] < v[j]) bin[j] = next;
    }
  }
}

template <bool FUSED, int KC>
__global__ void __launch_bounds__(HIST_SUB, HIST_MIN_BLOCKS) hist_kernel(HistArgs A) {
  extern __shared__ __align__(16) float hist_smem[];
  __shared__ int s_flag;
  const int k = A.k, e = A.e, nb = e + 1;
  const int kl = kc_loop<KC>(k);
  const int n_sum = k * nb;
  const int rec = n_sum + (FUSED ? k : 0);
  const int rows_max = hist_sub_rows(A.tile_n);
  const int runs_max = (rows_max + HIST_RUN - 1) / HIST_RUN;
  const long long tile = blockIdx.x / A.subs;
  const int sub = (int)(blockIdx.x - tile * A.subs);
  const int rows = min(HIST_SUB, A.tile_n - sub * HIST_SUB);
  const int runs = (rows + HIST_RUN - 1) / HIST_RUN;
  const long long row0 = tile * A.tile_n + (long long)sub * HIST_SUB;
  const int live = (int)max(0LL, min((long long)rows, A.n - row0));

  float* s_a = hist_smem;                             // rows * k: a, then bins
  float* s_b = s_a + hist_round4(rows_max * k);       // rows * k: b, then masses
  float* s_run = s_b + hist_round4(rows_max * k);     // runs * k * nb
  float* s_edges = s_run + (size_t)runs_max * n_sum;  // k * e
  float* s_lam = s_edges + k * e;                     // k (fused)
  float* s_top = s_lam + k;                           // warps * k (fused)

  load_async(s_a, A.a + row0 * k, rows * k, live * k);
  load_async(s_b, A.b + row0 * k, rows * k, live * k);
  for (int i = threadIdx.x; i < k * e; i += blockDim.x) s_edges[i] = A.edges[i];
  if (FUSED)
    for (int i = threadIdx.x; i < k; i += blockDim.x) s_lam[i] = A.lam[i];
  for (int i = threadIdx.x; i < runs * n_sum; i += blockDim.x) s_run[i] = 0.f;
  cp_async_wait_all();
  __syncthreads();

  // 2. Candidates (fused) and bins, one thread per row, in place: v1 over
  // the row's first input and v2 over its second, then the bins over v1.
  const int r = threadIdx.x;
  if (FUSED) {
    if (r < rows)
      candidates_row<KC>(s_a + r * k, s_b + r * k, s_lam, k, A.q, s_a + r * k, s_b + r * k);
    // Max is exact in any order: a warp shuffle per k, then over the warps.
    // Threads without a row hold an inert one (v1 = -1), at or below every
    // row's v1.
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int j = 0; j < kl; ++j) {
      if (j >= k) continue;
      float m = r < rows ? s_a[r * k + j] : -1.f;
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (lane == 0) s_top[warp * k + j] = m;
    }
  }
  if (r < rows) {
    int bin[KC];
    bin_row<KC>(s_edges, e, k, s_a + r * k, bin);
#pragma unroll
    for (int j = 0; j < kl; ++j)
      if (j < k) s_a[r * k + j] = __int_as_float(bin[j]);
  }
  __syncthreads();

  // 3. Run sums: one thread per (run, k), rows in order, loads eight ahead.
  for (int pr = threadIdx.x; pr < runs * k; pr += blockDim.x) {
    const int run = pr / k, j = pr - run * k;
    float* h = s_run + (size_t)pr * nb;
    const int first = run * HIST_RUN;
    const int cnt = min(HIST_RUN, rows - first);
    for (int i0 = 0; i0 < cnt; i0 += 8) {
      int t[8];
      float m[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (i0 + i < cnt) {
          t[i] = __float_as_int(s_a[(first + i0 + i) * k + j]);
          m[i] = s_b[(first + i0 + i) * k + j];
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (i0 + i < cnt) h[t[i]] = __fadd_rn(h[t[i]], m[i]);
    }
  }
  __syncthreads();

  // 4. The sub-tile record: run sums in run order from 0.0.
  float* dst = A.subs == 1 ? A.tile_rec + tile * rec : A.sub_rec + (long long)blockIdx.x * rec;
  for (int slot = threadIdx.x; slot < n_sum; slot += blockDim.x) {
    float v[HIST_SUB / HIST_RUN];
#pragma unroll
    for (int run = 0; run < HIST_SUB / HIST_RUN; ++run)
      if (run < runs) v[run] = s_run[run * n_sum + slot];
    float acc = 0.f;
#pragma unroll
    for (int run = 0; run < HIST_SUB / HIST_RUN; ++run)
      if (run < runs) acc = __fadd_rn(acc, v[run]);
    dst[slot] = acc;
  }
  if (FUSED) {
    const int warps = blockDim.x >> 5;
    for (int j = threadIdx.x; j < k; j += blockDim.x) {
      float m = ninf();
      for (int w = 0; w < warps; ++w) m = fmaxf(m, s_top[w * k + j]);
      dst[n_sum + j] = m;
    }
  }

  // The tile record: its sub-tile records in order from 0.0 (max for top).
  if (A.subs > 1) {
    if (!last_ticket(A.tickets + tile, A.subs, &s_flag)) return;
    const float* src = A.sub_rec + tile * A.subs * rec;
    for (int slot = threadIdx.x; slot < rec; slot += blockDim.x) {
      const bool sum = slot < n_sum;
      A.tile_rec[tile * rec + slot] = fold_chain(sum ? 0.f : ninf(), src + slot, rec,
                                                 A.subs, sum);
    }
  }

  // The result: tile records onto the seed in tile order.
  if (!last_ticket(A.tickets + A.n_tiles, A.n_tiles, &s_flag)) return;
  for (int slot = threadIdx.x; slot < rec; slot += blockDim.x) {
    const bool sum = slot < n_sum;
    const float seed = sum ? (A.hist_init ? A.hist_init[slot] : 0.f)
                           : (A.top_init ? A.top_init[slot - n_sum] : ninf());
    A.out[slot] = fold_chain(seed, A.tile_rec + slot, rec, A.n_tiles, sum);
  }
}

// Scratch floats of a call: the sub-tile records (only when a tile has more
// than one sub-tile), then the tile records.
inline long long hist_scratch_floats(long long n, int k, int e, int tile_n, bool fused) {
  const long long rec = (long long)k * (e + 1) + (fused ? k : 0);
  const long long n_tiles = (n + tile_n - 1) / tile_n;
  const long long subs = (tile_n + HIST_SUB - 1) / HIST_SUB;
  return (subs > 1 ? n_tiles * subs * rec : 0) + n_tiles * rec;
}

template <bool FUSED, int KC>
cudaError_t launch_hist_kc(const HistArgs& A, size_t smem, int threads, cudaStream_t s) {
  cudaError_t err = allow_smem(hist_kernel<FUSED, KC>, smem);
  if (err != cudaSuccess) return err;
  // As much of the SM's unified memory as L1 can give up goes to shared
  // memory, so HIST_MIN_BLOCKS blocks of 75 KB (K = 10) fit an SM.
  err = cudaFuncSetAttribute(hist_kernel<FUSED, KC>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  hist_kernel<FUSED, KC><<<(unsigned)(A.n_tiles * A.subs), threads, smem, s>>>(A);
  return cudaGetLastError();
}

// Fills in the layout fields of A from n and tile_n, carves the scratch and
// launches the instance for the smallest of K <= 8, 16, KMAX that holds k,
// and for the fused map also KWIDE (the MoE router's expert counts; its
// per-row ap, work and bin arrays live in local memory); returns the
// launch's CUDA error.
template <bool FUSED>
cudaError_t launch_hist(HistArgs A, float* scratch, cudaStream_t s) {
  const int rec = A.k * (A.e + 1) + (FUSED ? A.k : 0);
  A.n_tiles = (A.n + A.tile_n - 1) / A.tile_n;
  A.subs = (A.tile_n + HIST_SUB - 1) / HIST_SUB;
  A.sub_rec = scratch;
  A.tile_rec = scratch + (A.subs > 1 ? A.n_tiles * A.subs * rec : 0);
  if (A.n_tiles * A.subs > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * hist_smem_floats(A.k, A.e, A.tile_n, FUSED);
  const int threads = (hist_sub_rows(A.tile_n) + 31) / 32 * 32;
  if (A.k <= 8) return launch_hist_kc<FUSED, 8>(A, smem, threads, s);
  if (A.k <= 16) return launch_hist_kc<FUSED, 16>(A, smem, threads, s);
  if (A.k <= KMAX) return launch_hist_kc<FUSED, KMAX>(A, smem, threads, s);
  if constexpr (FUSED) {
    if (A.k <= KWIDE) return launch_hist_kc<FUSED, KWIDE>(A, smem, threads, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
