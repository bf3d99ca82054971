// Hand-written Hopper (sm_90a) kernels of the sparse bucketed SCD solve
// (host-fed per chunk; resident over the whole shard or per chunk).
//
// Replaces two Pallas TPU kernels of the JAX reference package:
//   * hist_kernel<true>       <- src/repro/kernels/scd_fused.py, _kernel
//     (hist_tile.cuh)            (wrapper scd_fused_hist): the Alg-5 candidate
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
// 3.35 TB/s; 800 MB at N = 10^7 resident, 0.24 ms); the outputs are a few
// KB. The arithmetic (Q+1 masked-max passes, a divide and a binary search
// over E edges per (row, k)) is far below the card's float32 rate.
//
// scd_fused_hist: the histogram stage of hist_tile.cuh with the candidate
// map in front (one thread per row, candidates_row of scd_common.cuh): one
// launch per call, cp.async row loads into shared memory, binary-search
// binning, per-run sums of HIST_RUN rows and an in-kernel ordered fold of
// the sub-tile and tile records onto the seed. The tile (the unit of the
// addition order) may be any size; the map's default, 8,192 rows, divides
// the host-fed chunk and leaves about 1,221 tile records to fold at
// N = 10^7.
//
// scd_finalize_hist keeps its first design: one block per tile of at most
// 1,024 rows writes a partial record (one thread per row; one thread per bin
// walking the tile's rows in shared memory, each a row-order sum from 0.0),
// and fold_partials adds the records onto the carried seed in tile order
// (init + part[0] + part[1] + ...). screen_bound.cu shares that fold. No
// float atomics anywhere: the results depend only on the data and tile_n,
// and the plain PyTorch versions in kernels/ref.py perform the same
// additions in the same order. Ragged tails are masked loads that return
// p = b = 0, an inert row (no candidate, no selection). The per-row
// candidates, the bin and the rounding rules live in scd_common.cuh.

#include "hist_tile.cuh"
#include "scd_common.cuh"

namespace {

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

size_t hist_smem_bytes(int k, int e, int tile_n, int fused) {
  return sizeof(float) * hist_smem_floats(k, e, tile_n, fused != 0);
}

long long hist_scratch(long long n, int k, int e, int tile_n, int fused) {
  return hist_scratch_floats(n, k, e, tile_n, fused != 0);
}

size_t scd_finalize_smem_bytes(int k, int e, int tile_n) {
  return sizeof(float) * ((size_t)e + k + (size_t)tile_n * k + (size_t)tile_n * 4);
}

// One launch on `stream`; returns its CUDA error (0 on success). hist_init
// (K*(E+1)) and top_init (K) may be null (zeros, -inf); scratch holds
// hist_scratch(n, k, e, tile_n, 1) floats; tickets n_tiles + 1 zeroed ints,
// which the kernel leaves at zero; out: [hist (K*(E+1)) | top (K)].
int scd_fused_hist_launch(const float* p, const float* b, const float* lam,
                          const float* edges, const float* hist_init,
                          const float* top_init, float* scratch, int* tickets,
                          float* out, long long n, int k, int e, int q, int tile_n,
                          void* stream) {
  if (n < 1 || k < 1 || k > KMAX || e < 1 || q < 0 || tile_n < 1)
    return (int)cudaErrorInvalidValue;
  HistArgs A{};
  A.a = p; A.b = b; A.lam = lam; A.edges = edges;
  A.hist_init = hist_init; A.top_init = top_init; A.out = out; A.tickets = tickets;
  A.n = n; A.k = k; A.e = e; A.q = q; A.tile_n = tile_n;
  return (int)launch_hist<true>(A, scratch, static_cast<cudaStream_t>(stream));
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
