// K6: d(mmat) of the capped per-cell PFN max, the backward of K4/K5, for
// Hopper (sm_90a).
//
// Replaces gndnet_tpu/ops/pallas_affine.py `affine_bwd_dmmat` (body
// `_bwd_dmmat_kernel`) together with the table gather of `_make_scan_gather`'s
// backward.  The TPU kernel walks the whole (N,) stream, selects each row's
// cotangent where the row is its cell's argmax position, and accumulates the
// (C, A) contraction across a sequential grid.  Only one row per (cell,
// channel) carries a cotangent, so here the sum runs over cells instead of
// stream rows:
//   d_mmat[k, ch] = sum over occupied cells c of
//                   round(d_smax[c, ch]) * round(pts[argpos[c, ch], k])
// with round() the working type's rounding (bf16 or none) and the products
// summed in f32, as the TPU kernel does (pallas_affine.py:644-650).  Empty
// cells (count 0 or argpos -1) contribute nothing.
//
// pts (N, A) f32 row-major, A <= 8; argpos (ncells, C) int32 from K4/K5;
// d_smax (ncells, C) f32 or bf16; counts (ncells,) int32; partial
// (ceil(ncells / CELLS), A, C) f32 scratch; out (A, C) f32, the layout of
// the port's mmat (the transpose of the TPU kernel's (C, A) d_mmat_t).
//
// Design: pass 1 gives each block CELLS consecutive cells and one thread per
// channel, so the argpos and d_smax rows are read coalesced; each thread
// gathers its A coordinates and keeps A running sums in registers, then
// writes them to `partial`.  Pass 2 gives each output (k, ch) one block,
// which sums its partials in a fixed order.  No float atomics: the result
// is the same on every run.
//
// Bound at the kitti_sem B=2 shape (about 20 000 cells x 64 channels, A = 4):
// it must read argpos (5.1 MB), bf16 d_smax (2.6 MB) and at most 20 000 x 64
// gathered 16-byte rows (far fewer distinct ones), some 1-8 MB in all, about
// 2-3 us at 3.35 TB/s; its 10 MFLOP are negligible.  Each thread's chain of
// dependent loads (argpos, then the gathered row) over 64 cells makes it
// latency-bound, like K2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CELLS = 64;   // cells per block of pass 1
constexpr int MAX_A = 8;

template <bool BF16>
__device__ __forceinline__ float round_in(float v) {
  if (BF16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

template <bool BF16>
__device__ __forceinline__ float load_d(const void* d, size_t i) {
  if (BF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(d)[i]);
  return static_cast<const float*>(d)[i];
}

template <bool BF16>
__global__ void dmmat_partial(const float* __restrict__ pts, int A,
                              const int* __restrict__ argpos,
                              const void* __restrict__ d_smax,
                              const int* __restrict__ counts, int ncells,
                              int C, float* __restrict__ partial) {
  const int ch = threadIdx.x;
  if (ch >= C) return;
  const int c0 = blockIdx.x * CELLS;
  const int c1 = min(c0 + CELLS, ncells);
  float acc[MAX_A];
#pragma unroll
  for (int k = 0; k < MAX_A; ++k) acc[k] = 0.0f;
  for (int c = c0; c < c1; ++c) {
    const size_t i = static_cast<size_t>(c) * C + ch;
    const int p = argpos[i];
    if (counts[c] <= 0 || p < 0) continue;
    const float d = load_d<BF16>(d_smax, i);
    const float* row = pts + static_cast<size_t>(p) * A;
#pragma unroll
    for (int k = 0; k < MAX_A; ++k)
      if (k < A)
        acc[k] = __fadd_rn(acc[k], __fmul_rn(d, round_in<BF16>(row[k])));
  }
  float* out = partial + static_cast<size_t>(blockIdx.x) * A * C;
#pragma unroll
  for (int k = 0; k < MAX_A; ++k)
    if (k < A) out[k * C + ch] = acc[k];
}

// One block per output (k, ch): thread t sums partials t, t + RED, ... in
// order, then a fixed-order tree in shared memory.
constexpr int RED = 256;

__global__ void dmmat_reduce(const float* __restrict__ partial, int nblocks,
                             int AC, float* __restrict__ out) {
  __shared__ float s[RED];
  const int o = blockIdx.x;
  float v = 0.0f;
  for (int b = threadIdx.x; b < nblocks; b += RED)
    v = __fadd_rn(v, partial[static_cast<size_t>(b) * AC + o]);
  s[threadIdx.x] = v;
  __syncthreads();
  for (int w = RED / 2; w > 0; w /= 2) {
    if (threadIdx.x < w)
      s[threadIdx.x] = __fadd_rn(s[threadIdx.x], s[threadIdx.x + w]);
    __syncthreads();
  }
  if (threadIdx.x == 0) out[o] = s[0];
}

}  // namespace

// d_bf16: d_smax is bf16 and both operands round to bf16 (else f32).
// partial must hold ceil(ncells / 64) * A * C floats.
extern "C" int affine_bwd_dmmat(const void* pts, const void* argpos,
                                const void* d_smax, const void* counts,
                                void* partial, void* out, int ncells, int A,
                                int C, int d_bf16, void* stream) {
  if (A < 1 || A > MAX_A || C < 1 || C > 1024) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nblocks = (ncells + CELLS - 1) / CELLS;
  float* part = static_cast<float*>(partial);
  if (nblocks > 0) {
    const int threads = (C + 31) / 32 * 32;
    const float* p = static_cast<const float*>(pts);
    const int* a = static_cast<const int*>(argpos);
    const int* c = static_cast<const int*>(counts);
    if (d_bf16)
      dmmat_partial<true><<<nblocks, threads, 0, st>>>(p, A, a, d_smax, c,
                                                       ncells, C, part);
    else
      dmmat_partial<false><<<nblocks, threads, 0, st>>>(p, A, a, d_smax, c,
                                                        ncells, C, part);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int ac = A * C;
  dmmat_reduce<<<ac, RED, 0, st>>>(part, nblocks, ac,
                                  static_cast<float*>(out));
  return cudaGetLastError();
}
