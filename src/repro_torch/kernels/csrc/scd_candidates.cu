// Hand-written Hopper (sm_90a) kernel: the unfused Alg-5 candidate map.
//
// Replaces the Pallas TPU kernel src/repro/kernels/scd_candidates.py,
// _kernel (wrapper scd_candidates): per row, the adjusted profits
// max(p - lam*b, 0), the Q-th / (Q+1)-th order statistics, pbar and the
// candidates v1 = (p - pbar)/b, v2 = b, invalid -> (-1, 0). The resident
// solve runs it once per SCD pass with reduce="exact", which then sorts the
// (n, K) candidates.
//
// Bound on the card: bytes. It reads p and b and writes v1 and v2, 16 bytes
// per (row, k): 1.6 GB at n = 10^7 and K = 10, about 0.48 ms at 3.35 TB/s.
// The arithmetic (Q+1 max passes over K per row) is far below the float32
// rate.
//
// Design. The TPU kernel cut the rows into VMEM tiles; the map is
// elementwise over rows, so here one thread owns one row and there is no
// tile: the grid covers n rows and the threads past n return. The per-row
// math is candidates_row of scd_common.cuh, the one the fused kernel runs,
// so each output equals the plain version (kernels/ref.py,
// candidates_block) bit for bit on any input. Simple, not fast: each
// thread reads and writes its K values with strided accesses.

#include "scd_common.cuh"

namespace {

__global__ void scd_candidates_rows(const float* __restrict__ p,
                                    const float* __restrict__ b,
                                    const float* __restrict__ lam,
                                    float* __restrict__ v1,
                                    float* __restrict__ v2,
                                    long long n, int k, int q) {
  __shared__ float s_lam[KMAX];
  for (int i = threadIdx.x; i < k; i += blockDim.x) s_lam[i] = lam[i];
  __syncthreads();
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  float pv[KMAX], bv[KMAX], o1[KMAX], o2[KMAX];
  for (int j = 0; j < k; ++j) {
    pv[j] = p[row * k + j];
    bv[j] = b[row * k + j];
  }
  candidates_row(pv, bv, s_lam, k, q, o1, o2);
  for (int j = 0; j < k; ++j) {
    v1[row * k + j] = o1[j];
    v2[row * k + j] = o2[j];
  }
}

}  // namespace

extern "C" {

// v1, v2: (n, K) outputs. Returns the launch's CUDA error (0 on success).
int scd_candidates_launch(const float* p, const float* b, const float* lam,
                          float* v1, float* v2, long long n, int k, int q,
                          void* stream) {
  if (n < 1 || k < 1 || k > KMAX || q < 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  scd_candidates_rows<<<(unsigned)blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(p, b, lam, v1, v2,
                                                             n, k, q);
  return (int)cudaGetLastError();
}

}  // extern "C"
