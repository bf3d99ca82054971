// Hand-written Hopper (sm_90a) kernel: the sparse greedy primal at lambda.
//
// Replaces the Pallas TPU kernel src/repro/kernels/adjusted_topc.py,
// _kernel (wrapper adjusted_topc): per row, the adjusted profits
// p - lam*b, the top-Q strictly positive ones as a mask x (ties to the
// lower index) and the consumption v = where(x, b, 0). The DD map runs it
// once per iteration (resident and host-fed), and the resident solve's
// final metrics pass once per solve.
//
// Bound on the card: bytes. It reads p and b and writes x (1 byte) and v
// (4 bytes), 13 bytes per (row, k): 1.3 GB at n = 10^7 and K = 10, about
// 0.39 ms at 3.35 TB/s. Q max passes over K per row are far below the
// float32 rate.
//
// Design: a staged row-tile map. One block owns TOPC_ROWS consecutive rows,
// whose p and b are each one contiguous range of TOPC_ROWS * K floats:
//   1. cp.async copies both ranges into shared memory, 16 bytes a copy
//      (load_async of scd_common.cuh; the ragged last tile copies only its
//      rows);
//   2. one thread per row reads its row from shared memory, forms
//      p - lam*b (__fmul_rn then __fsub_rn: no FMA, --fmad=false, as the
//      plain version's separate multiply and subtract) in registers and
//      selects with topq_row<KC> (the finalize kernel's loop, so the two
//      cannot drift apart in their ties), then writes v over its b in place
//      (zero where not selected) and x into a byte tile;
//   3. the block stores both tiles with 16-byte vector stores, consecutive
//      threads on consecutive addresses.
// So every global access is coalesced and 16 bytes wide, where one thread
// per row read and wrote at a stride of K. KC (8, 16, KMAX or KWIDE) is the
// compile-time bound on K under which the row's work array stays in
// registers (in local memory at KWIDE). A block stages ROWS rows: 256 at
// K <= KMAX, which makes each tile's byte ranges a multiple of 16 (256 * K),
// so every tile's copies and stores stay aligned; at K = 10 a block stages
// 20 KB and TOPC_MIN_BLOCKS blocks share an SM, which keeps some 80 KB of
// loads in flight per SM. Above KMAX (the MoE router's expert counts, K <=
// KWIDE) 256 rows need more shared memory than a block may have (369,280
// bytes at K = 160), so a block stages 128 (184,960 bytes at K = 160), or 64
// where 128 do not fit either (K > 201); 128 * K and 64 * K bytes are still
// multiples of 16. The pick mask has (KC + 63) / 64 words (TopqMask). It
// equals the plain version (kernels/ref.py, adjusted_topc_plain) bit for
// bit on any input.

#include "scd_common.cuh"

#define TOPC_ROWS 256        // rows per block at K <= KMAX, one thread each
#define TOPC_ROWS_WIDE 128   // rows per block at KMAX < K <= KWIDE, where they fit
#define TOPC_ROWS_MIN 64     // else
#define TOPC_MIN_BLOCKS 4    // blocks per SM the registers are budgeted for

namespace {

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }
__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

inline size_t topc_smem_bytes(int k, int rows) {
  return sizeof(float) * (2 * (size_t)round4(rows * k) + k) + (size_t)round16(rows * k);
}

template <int KC, int ROWS>
__global__ void __launch_bounds__(ROWS, TOPC_MIN_BLOCKS)
adjusted_topc_tile(const float* __restrict__ p, const float* __restrict__ b,
                   const float* __restrict__ lam, unsigned char* __restrict__ x,
                   float* __restrict__ v, long long n, int k, int q) {
  extern __shared__ __align__(16) float smem[];
  const int kl = kc_loop<KC>(k);
  const int span = ROWS * k;
  float* s_p = smem;                                         // p
  float* s_b = s_p + round4(span);                           // b, then v
  unsigned char* s_x = reinterpret_cast<unsigned char*>(s_b + round4(span));
  float* s_lam = reinterpret_cast<float*>(s_x + round16(span));
  const long long row0 = (long long)blockIdx.x * ROWS;
  const int live = (int)min((long long)ROWS, n - row0);
  const int count = live * k;
  load_async(s_p, p + row0 * k, count, count);
  load_async(s_b, b + row0 * k, count, count);
  for (int i = threadIdx.x; i < k; i += blockDim.x) s_lam[i] = lam[i];
  cp_async_wait_all();
  __syncthreads();

  const int r = threadIdx.x;
  if (r < live) {
    const float* pr = s_p + r * k;
    float* br = s_b + r * k;
    float work[KC];
#pragma unroll
    for (int j = 0; j < kl; ++j)
      if (j < k) work[j] = __fsub_rn(pr[j], __fmul_rn(s_lam[j], br[j]));
    const TopqMask<KC> sel = topq_row<KC>(work, k, q);
#pragma unroll
    for (int j = 0; j < kl; ++j) {
      if (j >= k) continue;
      const bool xj = sel[j];
      s_x[r * k + j] = xj ? 1 : 0;
      if (!xj) br[j] = 0.f;
    }
  }
  __syncthreads();
  store_tile(v + row0 * k, s_b, count);
  store_tile(x + row0 * k, s_x, count);
}

template <int KC, int ROWS = TOPC_ROWS>
cudaError_t launch_topc(const float* p, const float* b, const float* lam, unsigned char* x,
                        float* v, long long n, int k, int q, cudaStream_t s) {
  const size_t smem = topc_smem_bytes(k, ROWS);
  cudaError_t err = allow_smem(adjusted_topc_tile<KC, ROWS>, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (n + ROWS - 1) / ROWS;
  adjusted_topc_tile<KC, ROWS><<<(unsigned)blocks, ROWS, smem, s>>>(p, b, lam, x, v, n, k,
                                                                   q);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (n, K) bool (one byte each); v: (n, K) f32; K <= KWIDE. Returns the
// launch's CUDA error (0 on success).
int adjusted_topc_launch(const float* p, const float* b, const float* lam,
                         unsigned char* x, float* v, long long n, int k, int q,
                         void* stream) {
  if (n < 1 || k < 1 || k > KWIDE || q < 0 ||
      (n + TOPC_ROWS_MIN - 1) / TOPC_ROWS_MIN > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 8) return (int)launch_topc<8>(p, b, lam, x, v, n, k, q, s);
  if (k <= 16) return (int)launch_topc<16>(p, b, lam, x, v, n, k, q, s);
  if (k <= KMAX) return (int)launch_topc<KMAX>(p, b, lam, x, v, n, k, q, s);
  if (topc_smem_bytes(k, TOPC_ROWS_WIDE) <= SMEM_MAX)
    return (int)launch_topc<KWIDE, TOPC_ROWS_WIDE>(p, b, lam, x, v, n, k, q, s);
  return (int)launch_topc<KWIDE, TOPC_ROWS_MIN>(p, b, lam, x, v, n, k, q, s);
}

}  // extern "C"
