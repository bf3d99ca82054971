// Hand-written Hopper (sm_90a) kernel: the per-chunk screening certificate.
//
// Replaces the Pallas TPU kernel src/repro/kernels/screen_bound.py, _kernel
// (wrapper screen_bound): the (K,) column max of p / b over the rows with
// b > 0, where a row with b <= 0 (the inert ragged tail included) gives
// -inf. The screened host-fed solve launches it once per chunk, on the
// device buffer the chunk's accumulate reads, in the first epoch that
// streams the chunk (core/prefetch.py, core/screening.py), and it writes the
// certificate straight into that chunk's row of the screen's (C, K) buffer.
//
// Bound on the card: bytes. It reads p and b once, 8 bytes per (row, k):
// 3.1 MB for a 65,536-row chunk at K = 6, about 0.94 us at 3.35 TB/s, far
// below the cost of a launch, so the call is bound by its launches and the
// host's enqueue: one launch a call, nothing allocated, no seed to fill.
//
// Design. The TPU grid carried a (1, K) running max from one grid step to
// the next. Here G blocks of 256 threads walk the chunk as one flat array
// of n*K floats with a grid stride, 16 bytes a step where p and b are both
// aligned (else 4 bytes). The column of flat element f is f % K, and G is a
// multiple of K's odd part, so the grid stride is a multiple of K and each
// of a thread's (up to) four running maxima stays in one column for the
// whole walk: no per-K arrays. The block lays its threads' maxima out in
// shared memory in flat order and reduces each column with a warp (every
// 32nd value a lane, then shuffles), writing a (K,) partial. An integer
// ticket (last_ticket, scd_common.cuh) lets the last block to finish take
// each column's max over the G partials, and the vector walk's tail of
// under four elements, and write the result. Max is exact in any order, so
// the result does not depend on G and equals the plain version
// (kernels/ref.py, screen_bound_plain) bit for bit; still no float atomics.
// The divide is __fdiv_rn (correctly rounded, as the plain version's), and
// the file is built with --fmad=false and never with fast math: a
// certificate one ulp low could retire a chunk it must not. NaN inputs are
// outside the contract (fmaxf drops a NaN, torch.amax keeps it).

#include "scd_common.cuh"

#define SB_THREADS 256
#define SB_BLOCKS_PER_SM 2

namespace {

__device__ __forceinline__ float ratio(float p, float b) {
  return (b > 0.f) ? __fdiv_rn(p, b) : ninf();
}

// res[j] = the max of s[x] over x < len with (x + x0) % k == j, for j < k:
// one warp a column, in turn; each lane folds every 32nd of the column's
// values, then the warp shuffles.
__device__ __forceinline__ void block_colmax(const float* s, int len, int x0, int k,
                                             float* res) {
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x >> 5; j < k; j += blockDim.x >> 5) {
    float m = ninf();
    for (int x = (j - x0 + k) % k + lane * k; x < len; x += 32 * k) m = fmaxf(m, s[x]);
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) res[j] = m;
  }
}

// total = n*K floats; width 4 (p and b 16-byte aligned) or 1; the grid
// stride gridDim.x * SB_THREADS * width is a multiple of k.
__global__ void __launch_bounds__(SB_THREADS)
screen_bound_kernel(const float* __restrict__ p, const float* __restrict__ b,
                    float* __restrict__ part, int* __restrict__ ticket,
                    float* __restrict__ out, long long total, int k, int width) {
  __shared__ float s_win[4 * SB_THREADS];
  __shared__ int s_flag;
  const long long step = (long long)gridDim.x * SB_THREADS;
  const long long t0 = (long long)blockIdx.x * SB_THREADS + threadIdx.x;
  float m0 = ninf(), m1 = ninf(), m2 = ninf(), m3 = ninf();
  if (width == 4) {
    const float4* p4 = reinterpret_cast<const float4*>(p);
    const float4* b4 = reinterpret_cast<const float4*>(b);
    for (long long u = t0; u < total / 4; u += step) {
      const float4 pv = p4[u], bv = b4[u];
      m0 = fmaxf(m0, ratio(pv.x, bv.x));
      m1 = fmaxf(m1, ratio(pv.y, bv.y));
      m2 = fmaxf(m2, ratio(pv.z, bv.z));
      m3 = fmaxf(m3, ratio(pv.w, bv.w));
    }
    float4* w4 = reinterpret_cast<float4*>(s_win);
    w4[threadIdx.x] = make_float4(m0, m1, m2, m3);
  } else {
    for (long long f = t0; f < total; f += step) m0 = fmaxf(m0, ratio(p[f], b[f]));
    s_win[threadIdx.x] = m0;
  }
  __syncthreads();
  const int x0 = (int)((long long)blockIdx.x * SB_THREADS * width % k);
  block_colmax(s_win, width * SB_THREADS, x0, k, part + (long long)blockIdx.x * k);
  if (!last_ticket(ticket, gridDim.x, &s_flag)) return;

  // The last block: thread t folds column t % k over the partials of blocks
  // t / k, t / k + P, ... (P = SB_THREADS / k groups), plus the vector
  // walk's tail; then one more column reduction over the P group maxima.
  const int groups = SB_THREADS / k, t = threadIdx.x;
  const long long blocks = gridDim.x;
  float acc = ninf();
  if (t < groups * k) {
    const int j = t % k, g0 = t / k;
    acc = fold_chain(acc, part + (long long)g0 * k + j, (long long)groups * k,
                     (blocks - g0 + groups - 1) / groups, false);
    if (width == 4 && g0 == 0)
      for (long long f = total / 4 * 4; f < total; ++f)
        if (f % k == j) acc = fmaxf(acc, ratio(p[f], b[f]));
  }
  s_win[t] = acc;     // every read of s_win above came before the ticket
  __syncthreads();
  block_colmax(s_win, groups * k, 0, k, out);
}

}  // namespace

extern "C" {

// part: scratch of part_cap floats for the (G, K) partials; ticket: one
// int32 counter, zero, which the kernel leaves at zero; out: (K,), any
// float-aligned address. sms: the card's SM count. Returns the launch's CUDA
// error (0 on success).
int screen_bound_launch(const float* p, const float* b, float* part, int* ticket,
                        float* out, long long n, int k, int sms, long long part_cap,
                        void* stream) {
  if (n < 1 || k < 1 || k > KMAX || sms < 1) return (int)cudaErrorInvalidValue;
  const long long total = n * k;
  const int width =
      ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(b)) & 15) == 0 ? 4 : 1;
  const long long work = total / width;
  long long g = (work + SB_THREADS - 1) / SB_THREADS;
  g = g < (long long)SB_BLOCKS_PER_SM * sms ? g : (long long)SB_BLOCKS_PER_SM * sms;
  const int odd = k / (k & -k);           // K's odd part: G a multiple of it
  g = g < 1 ? odd : (g + odd - 1) / odd * odd;
  if (g * k > part_cap) return (int)cudaErrorInvalidValue;
  screen_bound_kernel<<<(unsigned)g, SB_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      p, b, part, ticket, out, total, k, width);
  return (int)cudaGetLastError();
}

}  // extern "C"
