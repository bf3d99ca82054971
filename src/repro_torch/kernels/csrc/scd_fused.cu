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
// scd_finalize_hist: one block per tile of at most 1,024 rows (the unit of
// the addition order; ops.pick_tile's ladder is the default) writes the
// tile's record, then fold_partials adds the records onto the carried seeds
// in tile order (seed + part[0] + part[1] + ...). In the block:
//   1. cp.async stages the tile's b and its p (all of it when the shared
//      memory fits, else `sub` rows at a time) with 16-byte copies;
//   2. one thread per row selects with topq_row<KC> in registers, sums the
//      row's gain and pt left to right from 0.0, writes its consumption
//      over its b and bins pt by binary lifting over the edges (bin_lift);
//   3. with the histograms, a stable counting sort of the rows by bin:
//      each bin's rows become bit masks, one 32-bit word per warp of rows
//      (__match_any_sync; the lowest lane of a group writes it and adds
//      its popcount to the bin's count, an integer atomic), a warp scan
//      turns the counts into offsets, and each row takes its place (its
//      bin's offset, its bin's rows in earlier warps, its rank among its
//      peers), so a bin's rows lie together in row order;
//   4. the record's sums are walks: r, primal and dual over the tile's rows
//      in order (warp 0), and a warp per non-empty bin over that bin's run
//      of sorted rows, one lane per histogram slot of the bin (K columns
//      and the gain); so every slot receives exactly the additions, in the
//      order, of a scan over the tile's rows from 0.0, at O(tile rows) per
//      lane, where one thread per slot used to scan every row for every
//      slot. Empty bins' slots are zeros, stored at the start; hi and -lo
//      are warp maxima.
// The fold is a second launch, one thread per slot with its loads issued
// sixteen ahead: at a 65,536-row chunk the records are 2.9 MB (128 tiles of
// 5,655 slots at E = 512), which one SM at the end of the tile kernel would
// read far slower than some 23 blocks do. Its seeds are separate, nullable
// pointers (zeros, or -inf for the maxima), so the wrapper packs nothing;
// screen_bound.cu shares the fold. No float atomics anywhere: the results
// depend only on the data and tile_n, and the plain PyTorch versions in
// kernels/ref.py perform the same additions in the same order. Rows past n
// are not loaded (scd_fused_hist reads them as zeros, an inert row). The
// per-row candidates, the selection, the bin and the rounding rules live in
// scd_common.cuh.

#include <limits>

#include "hist_tile.cuh"
#include "scd_common.cuh"

namespace {

#define FIN_MAX_WARPS 32     // tile_n <= 1024: one thread per row

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// Floats of a tile record: [cons_hist (K*(E+1)) | gain_hist (E+1) |] r (K)
// | primal | dual | hi | -lo (e = 0: no histograms). Records lie
// round4(fin_rec) floats apart, so each starts 16-byte aligned.
__host__ __device__ inline int fin_rec(int k, int e) {
  return (e > 0 ? k * (e + 1) + e + 1 : 0) + k + 4;
}

// Floats of dynamic shared memory of a finalize block: the tile's b (then
// its consumption) and a stage of `sub` rows of p first, both 16-byte
// aligned; then the edges, lam, the rows' gain and pt, the bins' row masks
// (one 32-bit word per bin and warp of rows), the bins' warp masks, the
// rows sorted by bin and the bins' offsets in that order, and the per-warp
// maxima.
__host__ __device__ inline size_t fin_smem_floats(int k, int e, int tile_n, int sub) {
  const int nb = e > 0 ? e + 1 : 0;
  const int warps = (tile_n + 31) / 32;
  return (size_t)round4(tile_n * k) + (size_t)round4(sub * k) + e + k + 3 * (size_t)tile_n +
         (size_t)nb * (warps + 2) + (nb ? 1 : 0) + 2 * FIN_MAX_WARPS;
}

// Rows of p staged at a time: the whole tile when its shared memory fits,
// else the largest multiple of 32 rows (halving) that does; 0 if none.
inline int fin_sub_rows(int k, int e, int tile_n) {
  for (int sub = tile_n;; sub = (sub / 2 + 31) / 32 * 32) {
    if (sizeof(float) * fin_smem_floats(k, e, tile_n, sub) <= SMEM_MAX) return sub;
    if (sub <= 32) return 0;
  }
}

struct FinArgs {
  const float* p;          // (n, K) row-major
  const float* b;
  const float* lam;        // (K,)
  const float* pedges;     // (E,) ascending, with_hist only
  float* part;             // (n_tiles, rec) tile records
  long long n;
  int k, e, q, tile_n, sub, with_hist;
};

// The sum from 0.0 of v[0], v[stride], ..., v[(n - 1) * stride] in that
// order; each group of eight loads is issued before the previous group's
// adds.
__device__ __forceinline__ float row_walk(const float* v, int stride, int n) {
  float acc = 0.f;
  int i = 0;
  if (n >= 8) {
    float cur[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) cur[u] = v[u * stride];
    for (i = 8; i + 8 <= n; i += 8) {
      float nxt[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) nxt[u] = v[(i + u) * stride];
#pragma unroll
      for (int u = 0; u < 8; ++u) acc = __fadd_rn(acc, cur[u]);
#pragma unroll
      for (int u = 0; u < 8; ++u) cur[u] = nxt[u];
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) acc = __fadd_rn(acc, cur[u]);
  }
  for (; i < n; ++i) acc = __fadd_rn(acc, v[i * stride]);
  return acc;
}

// The sum from 0.0 of v[order[i] * stride] for i = lo, ..., hi - 1 in that
// order (nothing is read where !live); the loads run eight ahead of the
// adds.
__device__ __forceinline__ float list_walk(const float* v, int stride, const int* order,
                                           int lo, int hi, bool live) {
  float acc = 0.f;
  int i = lo;
  for (; i + 8 <= hi; i += 8) {
    float x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) x[u] = live ? v[order[i + u] * stride] : 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u) acc = __fadd_rn(acc, x[u]);
  }
  for (; i < hi; ++i) acc = __fadd_rn(acc, live ? v[order[i] * stride] : 0.f);
  return acc;
}

// One block per tile of tile_n rows, one thread per row. Record per tile:
// [cons_hist (K*(E+1)) | gain_hist (E+1) |] r (K) | primal | dual | hi | -lo
// (the histogram part only with with_hist). Every sum runs over the tile's
// rows in row order from 0.0 (rows past n would add only 0.0 and are left
// out); hi and -lo are maxima, exact in any order.
template <int KC>
__global__ void __launch_bounds__(1024, 1) scd_finalize_tile(FinArgs A) {
  extern __shared__ __align__(16) float smem[];
  const int k = A.k, e = A.e, tile_n = A.tile_n, sub = A.sub;
  const int kl = kc_loop<KC>(k);
  const int nb = A.with_hist ? e + 1 : 0;
  const int n_hist = A.with_hist ? k * nb + nb : 0;
  const int rec = fin_rec(k, e);
  const int warps = (tile_n + 31) / 32;
  float* s_cons = smem;                                   // tile_n * k: b, then cons
  float* s_p = s_cons + round4(tile_n * k);               // sub * k
  float* s_edges = s_p + round4(sub * k);                 // e
  float* s_lam = s_edges + e;                             // k
  float* s_gain = s_lam + k;                              // tile_n
  float* s_pt = s_gain + tile_n;                          // tile_n
  unsigned* s_mask = reinterpret_cast<unsigned*>(s_pt + tile_n);  // warps * nb
  unsigned* s_warps = s_mask + nb * warps;                // nb
  int* s_order = reinterpret_cast<int*>(s_warps + nb);    // tile_n: rows sorted by bin
  int* s_start = s_order + tile_n;                        // nb + 1: bin t's rows are
                                                          // s_order[s_start[t] : s_start[t + 1]]
  float* s_max = reinterpret_cast<float*>(s_start + (nb ? nb + 1 : 0));  // 2 per warp

  const long long row0 = (long long)blockIdx.x * tile_n;
  const int rows = (int)min((long long)tile_n, A.n - row0);
  load_async(s_cons, A.b + row0 * k, rows * k, rows * k);
  // The record's histogram slots start as zeros (an empty bin's sum), with
  // 16-byte stores while the rows load; the walks below write the rest.
  float* out = A.part + (long long)blockIdx.x * round4(rec);
  for (int i = threadIdx.x; i < round4(n_hist) / 4; i += blockDim.x)
    reinterpret_cast<float4*>(out)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = threadIdx.x; i < e; i += blockDim.x) s_edges[i] = A.pedges[i];
  for (int i = threadIdx.x; i < k; i += blockDim.x) s_lam[i] = A.lam[i];
  for (int i = threadIdx.x; i < nb * (warps + 1); i += blockDim.x) s_mask[i] = 0u;
  if (nb)
    for (int i = threadIdx.x; i <= nb; i += blockDim.x) s_start[i] = 0;

  // 1. One thread per row: the top-Q selection at lam, the row's gain and
  // pt (left to right over k from 0.0), its consumption over its b, and
  // the bin of pt; p is staged `sub` rows at a time.
  const int r = threadIdx.x;
  float hi = ninf(), nlo = ninf();
  int bin = -1;
  for (int s0 = 0; s0 < rows; s0 += sub) {
    const int cnt = min(sub, rows - s0);
    if (s0) __syncthreads();                               // the last pass read s_p
    load_async(s_p, A.p + (row0 + s0) * k, cnt * k, cnt * k);
    cp_async_wait_all();
    __syncthreads();
    if (r >= s0 && r < s0 + cnt) {
      const float* pr = s_p + (r - s0) * k;
      float* cr = s_cons + r * k;
      float ap[KC], work[KC];
#pragma unroll
      for (int j = 0; j < kl; ++j)
        if (j < k) work[j] = ap[j] = __fsub_rn(pr[j], __fmul_rn(s_lam[j], cr[j]));
      const TopqMask<KC> x = topq_row<KC>(work, k, A.q);
      float gain = 0.f, pt = 0.f;
#pragma unroll
      for (int j = 0; j < kl; ++j) {
        if (j >= k) continue;
        const bool xj = x[j];
        gain = __fadd_rn(gain, xj ? pr[j] : 0.f);
        pt = __fadd_rn(pt, xj ? ap[j] : 0.f);
        if (!xj) cr[j] = 0.f;
      }
      s_gain[r] = gain;
      s_pt[r] = pt;
      if (x.any()) { hi = pt; nlo = -pt; }
      if (nb) bin = bin_lift(s_edges, e, pt);
    }
  }

  // 2. hi and -lo over the rows that selected anything: a warp max, then
  // the warps' (max is exact in any order). With the histograms, the rows
  // of each bin as bit masks: the lanes of a warp that share a bin find
  // each other, and the lowest writes their mask for its warp, marks the
  // warp in the bin's warp mask and adds their count to the bin's (integer
  // atomics: exact in any order).
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    nlo = fmaxf(nlo, __shfl_xor_sync(0xffffffffu, nlo, off));
  }
  if (lane == 0) { s_max[2 * warp] = hi; s_max[2 * warp + 1] = nlo; }
  unsigned peers = 0u;
  if (nb) {
    peers = __match_any_sync(0xffffffffu, bin);
    if (bin >= 0 && (peers & ((1u << lane) - 1u)) == 0) {
      s_mask[warp * nb + bin] = peers;
      atomicOr(s_warps + bin, 1u << warp);
      atomicAdd(s_start + bin + 1, __popc(peers));
    }
  }
  __syncthreads();

  // 3. With the histograms, a stable counting sort of the rows by bin from
  // the masks: a warp scans the bins' counts into offsets; a row's place is
  // its bin's offset, plus its bin's rows in earlier warps, plus its rank
  // among its warp's peers.
  if (nb) {
    if (warp == 0) {
      const int per = (nb + 31) / 32;
      const int lo = 1 + lane * per, hi_i = min(nb + 1, lo + per);
      int run = 0;
      for (int i = lo; i < hi_i; ++i) run += s_start[i];
      int incl = run;
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      int acc = incl - run;
      for (int i = lo; i < hi_i; ++i) { acc += s_start[i]; s_start[i] = acc; }
    }
    __syncthreads();
    if (bin >= 0) {
      int pos = s_start[bin] + __popc(peers & ((1u << lane) - 1u));
      for (unsigned ws = s_warps[bin] & ((1u << warp) - 1u); ws; ws &= ws - 1)
        pos += __popc(s_mask[(__ffs(ws) - 1) * nb + bin]);
      s_order[pos] = r;
    }
    __syncthreads();
  }

  // 4. The rest of the record, each sum a walk over rows in row order from
  // 0.0: r, primal and dual over the tile's rows (one lane each, warp 0),
  // and each non-empty bin's histogram slots over that bin's run of sorted
  // rows (a warp per bin, one lane per slot; bins dealt round-robin to the
  // other warps). Every slot receives exactly the additions, in the order,
  // of a scan over the tile, at O(tile rows) per lane.
  const int n_warps = blockDim.x >> 5;
  for (int c = threadIdx.x; c < k + 2; c += blockDim.x) {
    const float* v = c < k ? s_cons + c : (c == k ? s_gain : s_pt);
    out[n_hist + c] = row_walk(v, c < k ? k : 1, rows);
  }
  if (threadIdx.x == 0) {
    float h = ninf(), l = ninf();
    for (int w = 0; w < n_warps; ++w) {
      h = fmaxf(h, s_max[2 * w]);
      l = fmaxf(l, s_max[2 * w + 1]);
    }
    out[n_hist + k + 2] = h;
    out[n_hist + k + 3] = l;
  }
  const int bin_warps = n_warps > 1 ? n_warps - 1 : 1;
  const int wb = n_warps > 1 ? warp - 1 : 0;
  if (nb && wb >= 0) {
    for (int t0 = wb; t0 < nb; t0 += 32 * bin_warps) {
      // 32 bins a round, t0 + bin_warps * lane, the non-empty ones walked
      // one after another by the whole warp.
      const int tl = t0 + bin_warps * lane;
      const bool full = tl < nb && s_start[tl + 1] > s_start[tl];
      for (unsigned todo = __ballot_sync(0xffffffffu, full); todo; todo &= todo - 1) {
        const int t = t0 + bin_warps * (__ffs(todo) - 1);
        for (int jb = 0; jb <= k; jb += 32) {
          const int j = jb + lane;
          const float acc = list_walk(j < k ? s_cons + j : s_gain, j < k ? k : 1, s_order,
                                      s_start[t], s_start[t + 1], j <= k);
          if (j <= k) out[j * nb + t] = acc;
        }
      }
    }
  }
}

template <int KC>
cudaError_t launch_finalize_kc(const FinArgs& A, size_t smem, long long n_tiles,
                               cudaStream_t s) {
  cudaError_t err = allow_smem(scd_finalize_tile<KC>, smem);
  if (err != cudaSuccess) return err;
  scd_finalize_tile<KC><<<(unsigned)n_tiles, threads_for(A.tile_n), smem, s>>>(A);
  return cudaGetLastError();
}

// The ordered fold: out[i] = seed[i] + part[0][i] + part[1][i] + ... for
// i < n_sum, and the running max for the rest; one thread per slot, its
// loads issued sixteen ahead of the add chain.
__global__ void fold_partials(const float* __restrict__ part, FoldSeeds seeds,
                              float* __restrict__ out, long long n_tiles, int rec,
                              int stride, int n_sum, bool neg_last) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rec) return;
  int seg = 0, off = 0;
  while (seg + 1 < seeds.count && i >= off + seeds.len[seg]) off += seeds.len[seg++];
  const float* sp = seeds.ptr[seg];
  const float seed = sp ? sp[i - off] : seeds.fill[seg];
  const float acc = fold_chain(seed, part + i, stride, n_tiles, i < n_sum);
  out[i] = acc;
  if (neg_last && i == rec - 1) out[rec] = -acc;
}

}  // namespace

cudaError_t launch_fold(const float* part, const FoldSeeds& seeds, float* out,
                        long long n_tiles, int rec, int stride, int n_sum, bool neg_last,
                        cudaStream_t s) {
  fold_partials<<<(rec + 255) / 256, 256, 0, s>>>(part, seeds, out, n_tiles, rec, stride,
                                                  n_sum, neg_last);
  return cudaGetLastError();
}

cudaError_t launch_fold(const float* part, const float* init, float* out,
                        long long n_tiles, int rec, int n_sum, cudaStream_t s) {
  FoldSeeds seeds{};
  seeds.ptr[0] = init;
  seeds.len[0] = rec;
  seeds.count = 1;
  return launch_fold(part, seeds, out, n_tiles, rec, rec, n_sum, false, s);
}

extern "C" {

size_t hist_smem_bytes(int k, int e, int tile_n, int fused) {
  return sizeof(float) * hist_smem_floats(k, e, tile_n, fused != 0);
}

long long hist_scratch(long long n, int k, int e, int tile_n, int fused) {
  return hist_scratch_floats(n, k, e, tile_n, fused != 0);
}

// Floats between two tile records of the finalize (its record, padded to
// 16 bytes).
int scd_finalize_part_stride(int k, int e) { return round4(fin_rec(k, e)); }

// Dynamic shared memory of a finalize block (e = 0 without with_hist);
// above SMEM_MAX where not even a stage of 32 rows of p fits.
size_t scd_finalize_smem_bytes(int k, int e, int tile_n) {
  const int sub = fin_sub_rows(k, e, tile_n);
  return sizeof(float) * fin_smem_floats(k, e, tile_n, sub ? sub : min(32, tile_n));
}

// One launch on `stream`, K <= KWIDE; returns its CUDA error (0 on
// success). hist_init (K*(E+1)) and top_init (K) may be null (zeros,
// -inf); scratch holds hist_scratch(n, k, e, tile_n, 1) floats; tickets
// n_tiles + 1 zeroed ints, which the kernel leaves at zero; out: [hist
// (K*(E+1)) | top (K)].
int scd_fused_hist_launch(const float* p, const float* b, const float* lam,
                          const float* edges, const float* hist_init,
                          const float* top_init, float* scratch, int* tickets,
                          float* out, long long n, int k, int e, int q, int tile_n,
                          void* stream) {
  if (n < 1 || k < 1 || k > KWIDE || e < 1 || q < 0 || tile_n < 1)
    return (int)cudaErrorInvalidValue;
  HistArgs A{};
  A.a = p; A.b = b; A.lam = lam; A.edges = edges;
  A.hist_init = hist_init; A.top_init = top_init; A.out = out; A.tickets = tickets;
  A.n = n; A.k = k; A.e = e; A.q = q; A.tile_n = tile_n;
  return (int)launch_hist<true>(A, scratch, static_cast<cudaStream_t>(stream));
}

// The finalize: the tile kernel, then the ordered fold onto the seeds
// (each may be null: zeros, and -inf for maxs_init = (hi, -lo)); e = 0
// and pedges unused without with_hist; part holds n_tiles records of
// scd_finalize_part_stride(k, e) floats each; out holds the record and
// then lo itself (rec + 1 floats). Returns the first
// CUDA error (0 on success).
int scd_finalize_hist_launch(const float* p, const float* b, const float* lam,
                             const float* pedges, const float* cons_hist_init,
                             const float* gain_hist_init, const float* r_init,
                             const float* sums_init, const float* maxs_init, float* part,
                             float* out, long long n, int k, int e, int q, int tile_n,
                             int with_hist, void* stream) {
  if (n < 1 || k < 1 || k > KMAX || e < 0 || q < 0 || tile_n < 1 || tile_n > 1024 ||
      (with_hist && e < 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FinArgs A{};
  A.p = p; A.b = b; A.lam = lam; A.pedges = pedges; A.part = part;
  A.n = n; A.k = k; A.e = with_hist ? e : 0; A.q = q; A.tile_n = tile_n;
  A.with_hist = with_hist != 0;
  A.sub = fin_sub_rows(k, A.e, tile_n);
  if (A.sub == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * fin_smem_floats(k, A.e, tile_n, A.sub);
  const long long n_tiles = (n + tile_n - 1) / tile_n;
  if (n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = k <= 8    ? launch_finalize_kc<8>(A, smem, n_tiles, s)
                    : k <= 16 ? launch_finalize_kc<16>(A, smem, n_tiles, s)
                              : launch_finalize_kc<KMAX>(A, smem, n_tiles, s);
  if (err != cudaSuccess) return (int)err;
  const int nb = A.e + 1;
  FoldSeeds seeds{};
  int i = 0;
  if (with_hist) {
    seeds.ptr[i] = cons_hist_init; seeds.len[i] = k * nb; seeds.fill[i++] = 0.f;
    seeds.ptr[i] = gain_hist_init; seeds.len[i] = nb; seeds.fill[i++] = 0.f;
  }
  seeds.ptr[i] = r_init; seeds.len[i] = k; seeds.fill[i++] = 0.f;
  seeds.ptr[i] = sums_init; seeds.len[i] = 2; seeds.fill[i++] = 0.f;
  seeds.ptr[i] = maxs_init; seeds.len[i] = 2; seeds.fill[i++] = -std::numeric_limits<float>::infinity();
  seeds.count = i;
  const int rec = fin_rec(k, A.e);
  return (int)launch_fold(part, seeds, out, n_tiles, rec, round4(rec), rec - 2, true, s);
}

const char* scd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
