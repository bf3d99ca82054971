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
// Design. The map is elementwise over rows, so one thread owns one row and
// the grid covers n rows (the TPU kernel's row tiles and padding are gone:
// threads past n return). The selection is topq_row of scd_common.cuh, the
// loop the finalize kernel runs, so the two cannot drift apart in their
// ties; p - lam*b is __fmul_rn then __fsub_rn (no FMA, --fmad=false), as
// in the plain version (kernels/ref.py, adjusted_topc_plain), which it
// equals bit for bit on any input. Simple, not fast: strided row loads and
// stores, as in scd_candidates.cu.

#include "scd_common.cuh"

namespace {

__global__ void adjusted_topc_rows(const float* __restrict__ p,
                                   const float* __restrict__ b,
                                   const float* __restrict__ lam,
                                   unsigned char* __restrict__ x,
                                   float* __restrict__ v,
                                   long long n, int k, int q) {
  __shared__ float s_lam[KMAX];
  for (int i = threadIdx.x; i < k; i += blockDim.x) s_lam[i] = lam[i];
  __syncthreads();
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  float bv[KMAX], work[KMAX];
  for (int j = 0; j < k; ++j) {
    bv[j] = b[row * k + j];
    work[j] = __fsub_rn(p[row * k + j], __fmul_rn(s_lam[j], bv[j]));
  }
  const unsigned long long sel = topq_row(work, k, q);
  for (int j = 0; j < k; ++j) {
    const bool xj = (sel >> j) & 1ull;
    x[row * k + j] = xj ? 1 : 0;
    v[row * k + j] = xj ? bv[j] : 0.f;
  }
}

}  // namespace

extern "C" {

// x: (n, K) bool (one byte each); v: (n, K) f32. Returns the launch's CUDA
// error (0 on success).
int adjusted_topc_launch(const float* p, const float* b, const float* lam,
                         unsigned char* x, float* v, long long n, int k, int q,
                         void* stream) {
  if (n < 1 || k < 1 || k > KMAX || q < 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  adjusted_topc_rows<<<(unsigned)blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(p, b, lam, x, v, n,
                                                            k, q);
  return (int)cudaGetLastError();
}

}  // extern "C"
