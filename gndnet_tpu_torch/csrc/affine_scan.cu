// K2: capped per-cell PFN max and xyz sums over the cell-sorted point
// stream, for Hopper (sm_90a).
//
// Replaces gndnet_tpu/ops/pallas_affine.py `affine_scan_t` in serving mode
// (body `_kernel_t`) together with the forward of `_make_scan_gather`, which
// reads the scan at row start + min(count, cap) - 1 of every cell.  The TPU
// kernel walks the stream in chunks on one core, carrying run state from
// chunk to chunk, and writes the full (N, C) running max.  Here every cell
// is independent, so one block owns one cell and only the per-cell results
// are written: the (N, C) scan is never materialised.
//
// For cell c with run [start, start + count) in the sorted stream, the kept
// rows are the first n = min(count, cap) (all of them when cap < 0).  Thread
// `ch` (one per output channel) computes, for each kept row p in stream
// order,
//   a = round(fma(m[A-1], round(p[A-1]), ... fma(m[1], round(p[1]),
//             m[0] * round(p[0])) ...))
// where round() is the output type's rounding (bf16 or none), and keeps the
// running max of a.  That is the TPU kernel's arithmetic: operands rounded
// to out_dtype, an f32 dot (its A terms accumulated in order with fused
// multiply-adds, as XLA's CPU dot does), the result rounded to out_dtype
// (pallas_affine.py:250-258).  No TF32 anywhere.  Threads 0-2 sum x, y, z
// of the kept rows in f32, in stream order; tot[3] is n.  A cell with no
// points gets tot = 0 and smax = -3e38 (the TPU kernel's _BIG_NEG), which
// the canvas epilogue masks by occupancy.
//
// pts (N, A) f32 row-major, A <= 8 (xyz, extra features, optional
// distance); starts, counts (ncells,) int32 from the cell histogram (every
// row of a run is a valid point); mmat (A, C) f32; tot (ncells, 4) f32;
// smax (ncells, C) f32 or bf16.
//
// Bound at the kitti_sem shape (C = 64, A = 4, cap 100): the function must
// read the kept rows (at most 1.6 MB), starts and counts (80 KB) and write
// tot (160 KB) and bf16 smax (1.28 MB); its ~50 MFLOP are negligible.  The
// bytes take about 1 us at 3.35 TB/s, so with 10 000 short runs it is bound
// by latency: each block's chain of dependent row steps.  The design stages
// each cell's rows through shared memory with one coalesced cooperative load
// (128 rows per pass), so the per-row loop reads shared memory only, and
// keeps enough small blocks (64 threads, 4 KB) resident to hide the loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int ROWS = 128;   // rows staged per pass
constexpr int MAX_A = 8;
constexpr float BIG_NEG = -3.0e38f;

template <bool BF16>
__device__ __forceinline__ float round_out(float v) {
  if (BF16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

template <bool BF16>
__device__ __forceinline__ void store_out(float v, void* smax, size_t i) {
  if (BF16)
    static_cast<__nv_bfloat16*>(smax)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(smax)[i] = v;
}

template <bool BF16>
__global__ void scan_gather(const float* __restrict__ pts, int A,
                            const int* __restrict__ starts,
                            const int* __restrict__ counts,
                            const float* __restrict__ mmat, int C, int cap,
                            float* __restrict__ tot, void* smax) {
  __shared__ float rows[ROWS * MAX_A];
  const int cell = blockIdx.x;
  const int ch = threadIdx.x;
  const int count = counts[cell];
  const int n = (cap >= 0 && count > cap) ? cap : count;
  const size_t start = static_cast<size_t>(starts[cell]);

  float m[MAX_A];
#pragma unroll
  for (int k = 0; k < MAX_A; ++k)
    m[k] = (k < A && ch < C) ? round_out<BF16>(mmat[k * C + ch]) : 0.0f;

  float best = -INFINITY;
  float sum = 0.0f;
  for (int r0 = 0; r0 < n; r0 += ROWS) {
    const int nr = (n - r0) < ROWS ? (n - r0) : ROWS;
    __syncthreads();   // the previous pass has been consumed
    const float* src = pts + (start + r0) * A;
    for (int t = threadIdx.x; t < nr * A; t += blockDim.x) rows[t] = src[t];
    __syncthreads();
    for (int r = 0; r < nr; ++r) {
      const float* p = rows + r * A;
      float acc = __fmul_rn(m[0], round_out<BF16>(p[0]));
#pragma unroll
      for (int k = 1; k < MAX_A; ++k)
        if (k < A) acc = __fmaf_rn(m[k], round_out<BF16>(p[k]), acc);
      best = fmaxf(best, round_out<BF16>(acc));
      if (ch < 3) sum = __fadd_rn(sum, p[ch]);
    }
  }
  if (n == 0) best = BIG_NEG;
  if (ch < C) store_out<BF16>(best, smax, static_cast<size_t>(cell) * C + ch);
  if (ch < 4)
    tot[static_cast<size_t>(cell) * 4 + ch] =
        ch < 3 ? sum : static_cast<float>(n);
}

}  // namespace

// cap < 0: no cap.  out_bf16: smax is bf16 (else f32).
extern "C" int affine_scan_gather(const void* pts, const void* starts,
                                  const void* counts, const void* mmat,
                                  void* tot, void* smax, int ncells, int A,
                                  int C, int cap, int out_bf16, void* stream) {
  if (A < 1 || A > MAX_A || C < 1 || C > 1024) return cudaErrorInvalidValue;
  if (ncells == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = ((C < 4 ? 4 : C) + 31) / 32 * 32;
  const float* p = static_cast<const float*>(pts);
  const int* s = static_cast<const int*>(starts);
  const int* c = static_cast<const int*>(counts);
  const float* m = static_cast<const float*>(mmat);
  float* t = static_cast<float*>(tot);
  if (out_bf16)
    scan_gather<true><<<ncells, threads, 0, st>>>(p, A, s, c, m, C, cap, t, smax);
  else
    scan_gather<false><<<ncells, threads, 0, st>>>(p, A, s, c, m, C, cap, t, smax);
  return cudaGetLastError();
}
