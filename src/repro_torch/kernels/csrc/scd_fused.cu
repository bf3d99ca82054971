// Hand-written Hopper (sm_90a) kernels of the sparse bucketed SCD solve
// (host-fed per chunk; resident over the whole shard or per chunk).
//
// Replaces two Pallas TPU kernels of the JAX reference package:
//   * scd_fused_tile + fold   <- src/repro/kernels/scd_fused.py, _kernel
//                                (wrapper scd_fused_hist): the Alg-5 candidate
//                                map, the §5.2 bucket histogram and the
//                                running max of the candidates, per chunk
//                                and iteration;
//   * scd_finalize_tile + fold <- src/repro/kernels/scd_fused.py,
//                                _finalize_kernel (wrapper scd_finalize_hist):
//                                the greedy top-Q selection at lambda, the
//                                metrics partials and the §5.4 removable
//                                histograms, once per chunk after convergence.
//
// Bound on the card: bytes. Each kernel reads the chunk's p and b once,
// 2 * C * K * 4 bytes (5.2 MB at C = 65,536 and K = 10, about 1.6 us at
// 3.35 TB/s); its outputs are a few KB. The arithmetic (Q+1 masked-max
// passes and E compares per (row, k)) is far below the card's float32 rate.
//
// Design. The TPU grid ran its tiles in order and carried the histogram
// from one grid step to the next (`out += tile`). Blocks on the card run in
// no order, so each block owns one tile of tile_n rows and writes its own
// partial record to a scratch buffer, and a second small kernel folds the
// partials onto the carried seed in tile order (init + part[0] + part[1]
// + ...). Inside a block every histogram bin and scalar is a row-order sum
// from 0.0, and per-row sums over k run left to right. No float atomics:
// the result depends only on the data and tile_n, so a chunked
// accumulation (chunk a multiple of tile_n) equals one call over all rows
// bit for bit, run after run. The plain PyTorch versions in
// kernels/ref.py perform the same additions in the same order.
//
// This first version is simple, not fast: one thread per row reads its K
// values with strided loads, and one thread per bin walks the tile's rows
// out of shared memory. Coalesced loads and warp-level binning are later
// work. Ragged tails are masked loads that return p = b = 0, which is an
// inert row (no candidate, no selection). The per-row candidates, the
// bin and the rounding rules live in scd_common.cuh. This file also holds
// the ordered fold that bucket_hist.cu shares.

#include "scd_common.cuh"

namespace {

// One block per tile. Record per tile: [hist (K*(E+1)) | top (K)].
__global__ void scd_fused_tile(const float* __restrict__ p,
                               const float* __restrict__ b,
                               const float* __restrict__ lam,
                               const float* __restrict__ edges,
                               float* __restrict__ part,
                               long long n, int k, int e, int q, int tile_n) {
  extern __shared__ float smem[];
  const int nb = e + 1;
  const int rec = k * nb + k;
  const int nwarps = blockDim.x >> 5;
  float* s_edges = smem;                                     // k * e
  float* s_lam = s_edges + k * e;                            // k
  float* s_v2 = s_lam + k;                                   // tile_n * k
  int* s_idx = reinterpret_cast<int*>(s_v2 + tile_n * k);    // tile_n * k
  float* s_top = reinterpret_cast<float*>(s_idx + tile_n * k);  // nwarps * k
  for (int i = threadIdx.x; i < k * e; i += blockDim.x) s_edges[i] = edges[i];
  for (int i = threadIdx.x; i < k; i += blockDim.x) s_lam[i] = lam[i];
  __syncthreads();

  const int r = threadIdx.x;
  const long long row = (long long)blockIdx.x * tile_n + r;
  const bool live = (r < tile_n) && (row < n);
  float pv[KMAX], bv[KMAX], v1[KMAX], v2[KMAX];
  for (int j = 0; j < k; ++j) {
    pv[j] = live ? p[row * k + j] : 0.f;
    bv[j] = live ? b[row * k + j] : 0.f;
  }
  candidates_row(pv, bv, s_lam, k, q, v1, v2);
  if (r < tile_n) {
    for (int j = 0; j < k; ++j) {
      s_idx[r * k + j] = bin_of(s_edges + j * e, e, v1[j]);
      s_v2[r * k + j] = v2[j];
    }
  }
  // Max is exact in any order: a warp shuffle per k, then over the warps.
  // Lanes past tile_n hold an inert row (v1 = -1), which every tile has
  // anyway or which sits below a real candidate.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = 0; j < k; ++j) {
    float m = v1[j];
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) s_top[warp * k + j] = m;
  }
  __syncthreads();

  float* out = part + (long long)blockIdx.x * rec;
  for (int slot = threadIdx.x; slot < k * nb; slot += blockDim.x) {
    const int j = slot / nb, t = slot - j * nb;
    float acc = 0.f;
    for (int rr = 0; rr < tile_n; ++rr)
      if (s_idx[rr * k + j] == t) acc = __fadd_rn(acc, s_v2[rr * k + j]);
    out[slot] = acc;
  }
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    float m = ninf();
    for (int w = 0; w < nwarps; ++w) m = fmaxf(m, s_top[w * k + j]);
    out[k * nb + j] = m;
  }
}

// One block per tile. Record per tile:
// [cons_hist (K*(E+1)) | gain_hist (E+1) |] r (K) | primal | dual | hi | -lo
// (the histogram part only with with_hist).
__global__ void scd_finalize_tile(const float* __restrict__ p,
                                  const float* __restrict__ b,
                                  const float* __restrict__ lam,
                                  const float* __restrict__ pedges,
                                  float* __restrict__ part,
                                  long long n, int k, int e, int q,
                                  int tile_n, int with_hist) {
  extern __shared__ float smem[];
  const int nb = e + 1;
  const int n_hist = with_hist ? k * nb + nb : 0;
  const int rec = n_hist + k + 4;
  float* s_pedges = smem;                                    // e
  float* s_lam = s_pedges + e;                               // k
  float* s_cons = s_lam + k;                                 // tile_n * k
  float* s_gain = s_cons + tile_n * k;                       // tile_n
  float* s_pt = s_gain + tile_n;                             // tile_n
  int* s_pidx = reinterpret_cast<int*>(s_pt + tile_n);       // tile_n
  int* s_sel = s_pidx + tile_n;                              // tile_n
  for (int i = threadIdx.x; i < e; i += blockDim.x) s_pedges[i] = pedges[i];
  for (int i = threadIdx.x; i < k; i += blockDim.x) s_lam[i] = lam[i];
  __syncthreads();

  const int r = threadIdx.x;
  const long long row = (long long)blockIdx.x * tile_n + r;
  const bool live = (r < tile_n) && (row < n);
  float pv[KMAX], bv[KMAX], ap[KMAX], work[KMAX];
  for (int j = 0; j < k; ++j) {
    pv[j] = live ? p[row * k + j] : 0.f;
    bv[j] = live ? b[row * k + j] : 0.f;
    ap[j] = __fsub_rn(pv[j], __fmul_rn(s_lam[j], bv[j]));
    work[j] = ap[j];
  }
  const unsigned long long x = topq_row(work, k, q);
  float gain = 0.f, pt = 0.f;
  for (int j = 0; j < k; ++j) {
    const bool xj = (x >> j) & 1ull;
    gain = __fadd_rn(gain, xj ? pv[j] : 0.f);
    pt = __fadd_rn(pt, xj ? ap[j] : 0.f);
    if (r < tile_n) s_cons[r * k + j] = xj ? bv[j] : 0.f;
  }
  if (r < tile_n) {
    s_gain[r] = gain;
    s_pt[r] = pt;
    s_sel[r] = x != 0ull;
    s_pidx[r] = with_hist ? bin_of(s_pedges, e, pt) : 0;
  }
  __syncthreads();

  float* out = part + (long long)blockIdx.x * rec;
  const int n_sum = n_hist + k + 2;
  for (int slot = threadIdx.x; slot < n_sum; slot += blockDim.x) {
    float acc = 0.f;
    if (slot < k * nb) {                       // cons_hist[j, t]
      const int j = slot / nb, t = slot - j * nb;
      for (int rr = 0; rr < tile_n; ++rr)
        if (s_pidx[rr] == t) acc = __fadd_rn(acc, s_cons[rr * k + j]);
    } else if (slot < n_hist) {                // gain_hist[t]
      const int t = slot - k * nb;
      for (int rr = 0; rr < tile_n; ++rr)
        if (s_pidx[rr] == t) acc = __fadd_rn(acc, s_gain[rr]);
    } else if (slot < n_hist + k) {            // r[j]
      const int j = slot - n_hist;
      for (int rr = 0; rr < tile_n; ++rr) acc = __fadd_rn(acc, s_cons[rr * k + j]);
    } else if (slot == n_hist + k) {           // primal
      for (int rr = 0; rr < tile_n; ++rr) acc = __fadd_rn(acc, s_gain[rr]);
    } else {                                   // dual sum
      for (int rr = 0; rr < tile_n; ++rr) acc = __fadd_rn(acc, s_pt[rr]);
    }
    out[slot] = acc;
  }
  if (threadIdx.x == 0) {
    float hi = ninf(), nlo = ninf();
    for (int rr = 0; rr < tile_n; ++rr) {
      if (s_sel[rr]) {
        hi = fmaxf(hi, s_pt[rr]);
        nlo = fmaxf(nlo, -s_pt[rr]);
      }
    }
    out[n_sum] = hi;
    out[n_sum + 1] = nlo;
  }
}

// The ordered fold: out[i] = init[i] + part[0][i] + part[1][i] + ... for
// i < n_sum, and the running max for the rest.
__global__ void fold_partials(const float* __restrict__ part,
                              const float* __restrict__ init,
                              float* __restrict__ out,
                              long long n_tiles, int rec, int n_sum) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rec) return;
  float acc = init[i];
  if (i < n_sum) {
    for (long long t = 0; t < n_tiles; ++t) acc = __fadd_rn(acc, part[t * rec + i]);
  } else {
    for (long long t = 0; t < n_tiles; ++t) acc = fmaxf(acc, part[t * rec + i]);
  }
  out[i] = acc;
}

}  // namespace

cudaError_t launch_fold(const float* part, const float* init, float* out,
                        long long n_tiles, int rec, int n_sum, cudaStream_t s) {
  fold_partials<<<(rec + 255) / 256, 256, 0, s>>>(part, init, out, n_tiles, rec,
                                                  n_sum);
  return cudaGetLastError();
}

extern "C" {

size_t scd_fused_smem_bytes(int k, int e, int tile_n) {
  const int nwarps = threads_for(tile_n) / 32;
  return sizeof(float) * ((size_t)k * e + k + (size_t)tile_n * k * 2 + (size_t)nwarps * k);
}

size_t scd_finalize_smem_bytes(int k, int e, int tile_n) {
  return sizeof(float) * ((size_t)e + k + (size_t)tile_n * k + (size_t)tile_n * 4);
}

// Launches the tile kernel and the fold on `stream`; returns the first
// CUDA error (0 on success). part: (n_tiles, K*(E+1)+K); init, out: one record.
int scd_fused_hist_launch(const float* p, const float* b, const float* lam,
                          const float* edges, const float* init, float* part,
                          float* out, long long n, int k, int e, int q,
                          int tile_n, void* stream) {
  if (n < 1 || k < 1 || k > KMAX || e < 1 || q < 0 || tile_n < 1 || tile_n > 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = scd_fused_smem_bytes(k, e, tile_n);
  cudaError_t err = allow_smem(scd_fused_tile, smem);
  if (err != cudaSuccess) return (int)err;
  const long long n_tiles = (n + tile_n - 1) / tile_n;
  scd_fused_tile<<<(unsigned)n_tiles, threads_for(tile_n), smem, s>>>(
      p, b, lam, edges, part, n, k, e, q, tile_n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_fold(part, init, out, n_tiles, k * (e + 1) + k, k * (e + 1), s);
}

// As above for the finalize; e = 0 and pedges unused without with_hist.
int scd_finalize_hist_launch(const float* p, const float* b, const float* lam,
                             const float* pedges, const float* init, float* part,
                             float* out, long long n, int k, int e, int q,
                             int tile_n, int with_hist, void* stream) {
  if (n < 1 || k < 1 || k > KMAX || e < 0 || q < 0 || tile_n < 1 || tile_n > 1024 ||
      (with_hist && e < 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ee = with_hist ? e : 0;
  const size_t smem = scd_finalize_smem_bytes(k, ee, tile_n);
  cudaError_t err = allow_smem(scd_finalize_tile, smem);
  if (err != cudaSuccess) return (int)err;
  const long long n_tiles = (n + tile_n - 1) / tile_n;
  scd_finalize_tile<<<(unsigned)n_tiles, threads_for(tile_n), smem, s>>>(
      p, b, lam, pedges, part, n, k, ee, q, tile_n, with_hist);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_hist = with_hist ? k * (ee + 1) + ee + 1 : 0;
  return (int)launch_fold(part, init, out, n_tiles, n_hist + k + 4, n_hist + k + 2, s);
}

const char* scd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
