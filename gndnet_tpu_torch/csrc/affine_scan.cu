// K2: capped per-cell PFN max and xyz sums over the cell-sorted point
// stream, for Hopper (sm_90a); with its argmax-tracking training modes K4
// and K5.
//
// Replaces gndnet_tpu/ops/pallas_affine.py `affine_scan_t` in serving mode
// (body `_kernel_t`) together with the forward of `_make_scan_gather`, which
// reads the scan at row start + min(count, cap) - 1 of every cell.  The TPU
// kernel walks the stream in chunks on one core, carrying run state from
// chunk to chunk, and writes the full (N, C) running max.  Here every cell
// is independent, and only the per-cell results are written: the (N, C)
// scan is never materialised.
//
// For cell c with run [start, start + count) in the sorted stream, the kept
// rows are the first n = min(count, cap) (all of them when cap < 0).  For
// each kept row p in stream order and each output channel,
//   a = round(fma(m[A-1], round(p[A-1]), ... fma(m[0], round(p[0]),
//             +0.0) ...))
// where round() is the output type's rounding (bf16 or none), and the
// kernel keeps the running max of a.  That is the TPU kernel's arithmetic:
// operands rounded to out_dtype, an f32 dot (its A terms accumulated in
// order with fused multiply-adds, as XLA's CPU dot does), the result
// rounded to out_dtype (pallas_affine.py:250-258); the accumulator starts
// at +0.0 as XLA's does, so an all-zero product gives +0.0 and never -0.0.
// No TF32.  x, y and z of the kept rows are summed in f32, in stream
// order; tot[3] is n.  A cell with no points gets tot = 0 and smax = -3e38
// (the TPU kernel's _BIG_NEG), which the canvas epilogue masks by
// occupancy.
//
// pts (N, A) f32 row-major, A <= 8 (xyz, extra features, optional
// distance); starts, counts (ncells,) int32 from the cell histogram (every
// row of a run is a valid point); mmat (A, C) f32; tot (ncells, 4) f32;
// smax (ncells, C) f32 or bf16.
//
// K2, serving (`scan_cells`).  Bound at the kitti_sem shape (C = 64, A =
// 4, cap 100): the function must read the kept rows (at most 1.6 MB),
// starts and counts (80 KB) and write tot (160 KB) and bf16 smax (1.28
// MB); its ~50 MFLOP are negligible.  The bytes take about 1 us at 3.35
// TB/s, so with 10 000 short runs, most of them empty, it is bound by
// latency.  The design: a warp owns a cell, and a persistent grid of
// warps strides over the cells, so no block is launched per cell and no
// barrier is taken.  Lane l owns channels (2l, 2l + 1) of a 64-channel
// group (blockIdx.y; one group at C <= 64), their rounded mmat held in
// registers, loaded once per warp; a bf16 smax row is one coalesced
// 128-byte store.  Each lane loads the counts and starts of one of the
// warp's next 32 cells, and the warp takes them by shuffle.  Lane j loads
// kept row r0 + j (32 rows a step, the next step's rows loaded before the
// current step is reduced), and each row is broadcast by shuffle.  An
// empty cell writes its row at once.  The per-channel FMA chain, the
// exact max and the in-order xyz sums (lanes 0-2) are the arithmetic
// above, so the plain version is equal to the bit.
//
// K4 and K5 replace `affine_scan_t(want_argmax=True)` and
// `affine_scan_t(want_argmax=True, packed_argmax=True)` as the forward of
// `_make_scan_gather`'s VJP reads them.  Both return K2's tot and smax and,
// per (cell, channel), `argpos`: the global stream row of the FIRST kept row
// that attains the max (-1 for an empty cell).
//   K4 (`scan_gather`, f32 or no cap; one block of C threads per cell, rows
//     staged through shared memory 128 at a time): a row replaces the best
//     only when its value is strictly greater, so ties keep the earlier
//     row and -0.0 ties +0.0 (the TPU kernel's `am_r >= am` combine,
//     earlier window winning);
//   K5 (`scan_cells<bf16, A, ARGMAX>`, bf16 with cap <= 4096): K2's body,
//     a warp per cell, where each lane keeps one int key per channel in
//     place of the max, max(key, mono16(value) << 12 | (4095 - rank)),
//     mono16 being the total order of bf16 bit patterns, so -0.0 < +0.0
//     and equal values keep the lower rank.  On exit the key decodes to
//     the exact bf16 value and to start + rank, stored as a bf16 pair and
//     an int2 (a 256-byte argpos row a warp).  A block per cell took a
//     block of 64 threads for each of B=2's 20 000 cells, most of them
//     empty, and two barriers per pass of up to 128 rows.
// Positions are int32: the TPU's integer-valued-f32 encoding existed only
// for XLA:TPU's denormal flush.  They add one (ncells, C) int32 write (5 MB
// at B=2) to K2's bytes; the bound stays latency, as for K2.

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

// The total order of bf16 bit patterns as an int in [0, 65535]: negatives
// flipped, positives above them (pallas_affine.py `mono`), of a float that
// holds a bf16 value exactly, so its high half is the pattern: integer
// work only, where a second conversion to bf16 made K5 slower.
__device__ __forceinline__ int mono16(float v) {
  const int s = __float_as_int(v) >> 16;   // the pattern, sign-extended
  return s >= 0 ? s + 32768 : ~s;
}

__device__ __forceinline__ float unmono16(int mono) {
  const int bits = mono >= 32768 ? mono - 32768 : 65535 - mono;
  return __bfloat162float(
      __ushort_as_bfloat16(static_cast<unsigned short>(bits)));
}

template <bool BF16>
__global__ void scan_gather(const float* __restrict__ pts, int A,
                            const int* __restrict__ starts,
                            const int* __restrict__ counts,
                            const float* __restrict__ mmat, int C, int cap,
                            float* __restrict__ tot, void* smax,
                            int* __restrict__ argpos) {
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
  int best_row = -1;   // global row of the first best
  float sum = 0.0f;
  for (int r0 = 0; r0 < n; r0 += ROWS) {
    const int nr = (n - r0) < ROWS ? (n - r0) : ROWS;
    __syncthreads();   // the previous pass has been consumed
    const float* src = pts + (start + r0) * A;
    for (int t = threadIdx.x; t < nr * A; t += blockDim.x) rows[t] = src[t];
    __syncthreads();
    for (int r = 0; r < nr; ++r) {
      const float* p = rows + r * A;
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < MAX_A; ++k)
        if (k < A) acc = __fmaf_rn(m[k], round_out<BF16>(p[k]), acc);
      const float v = round_out<BF16>(acc);
      if (r0 + r == 0 || v > best) {
        best = v;
        best_row = static_cast<int>(start) + r0 + r;
      }
      if (ch < 3) sum = __fadd_rn(sum, p[ch]);
    }
  }
  if (n == 0) {
    best = BIG_NEG;
    best_row = -1;
  }
  if (ch < C) {
    store_out<BF16>(best, smax, static_cast<size_t>(cell) * C + ch);
    argpos[static_cast<size_t>(cell) * C + ch] = best_row;
  }
  if (ch < 4)
    tot[static_cast<size_t>(cell) * 4 + ch] =
        ch < 3 ? sum : static_cast<float>(n);
}

constexpr int WARPS = 8;        // warps per block of scan_cells
constexpr unsigned FULL = 0xffffffffu;

// kept row r of a cell's run into p (zeros from row n on)
template <int A>
__device__ __forceinline__ void load_row(float* p, const float* src, int r,
                                         int n) {
#pragma unroll
  for (int k = 0; k < A; ++k)
    p[k] = r < n ? src[static_cast<size_t>(r) * A + k] : 0.0f;
}

struct Cells {
  const float* pts;
  const int* starts;
  const int* counts;
  const float* mmat;
  float* tot;
  void* smax;
  int* argpos;   // K5 only
  int ncells, C, cap;
};

template <bool BF16, int A, bool ARGMAX>
__global__ void __launch_bounds__(WARPS * 32) scan_cells(Cells a) {
  const float* __restrict__ pts = a.pts;
  const int C = a.C, cap = a.cap, ncells = a.ncells;
  const int lane = threadIdx.x & 31;
  const long long nwarps = static_cast<long long>(gridDim.x) * WARPS;
  const long long warp = static_cast<long long>(blockIdx.x) * WARPS +
                         (threadIdx.x >> 5);
  const int ch0 = blockIdx.y * 64 + 2 * lane, ch1 = ch0 + 1;
  float m0[A], m1[A];
#pragma unroll
  for (int k = 0; k < A; ++k) {
    m0[k] = ch0 < C ? round_out<BF16>(a.mmat[k * C + ch0]) : 0.0f;
    m1[k] = ch1 < C ? round_out<BF16>(a.mmat[k * C + ch1]) : 0.0f;
  }
  // the warp's cells: warp, warp + nwarps, ...; 32 of them a batch
  for (long long base = warp; base < ncells; base += 32 * nwarps) {
    const long long mine = base + lane * nwarps;
    int my_count = 0, my_start = 0;
    if (mine < ncells) {
      my_count = a.counts[mine];
      my_start = a.starts[mine];
    }
    for (int j = 0; j < 32; ++j) {
      const long long cell = base + j * nwarps;
      if (cell >= ncells) break;
      const int count = __shfl_sync(FULL, my_count, j);
      const int n = (cap >= 0 && count > cap) ? cap : count;
      const int start = __shfl_sync(FULL, my_start, j);
      const float* src = pts + static_cast<size_t>(start) * A;
      float best0 = -INFINITY, best1 = -INFINITY, sum = 0.0f;
      int key0 = -1, key1 = -1;   // K5: every kept row's key is >= 0
      float p[A], q[A];
      load_row<A>(p, src, lane, n);
      for (int r0 = 0; r0 < n; r0 += 32) {
        if (r0 + 32 < n) load_row<A>(q, src, r0 + 32 + lane, n);
        const int nr = min(32, n - r0);
#pragma unroll 4
        for (int r = 0; r < nr; ++r) {
          float acc0 = 0.0f, acc1 = 0.0f, xyz[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int k = 0; k < A; ++k) {
            const float pk = __shfl_sync(FULL, p[k], r);
            if (k < 3) xyz[k] = pk;
            const float pr = round_out<BF16>(pk);
            acc0 = __fmaf_rn(m0[k], pr, acc0);
            acc1 = __fmaf_rn(m1[k], pr, acc1);
          }
          const float v0 = round_out<BF16>(acc0);
          const float v1 = round_out<BF16>(acc1);
          if constexpr (ARGMAX) {
            const int rank = 4095 - (r0 + r);
            key0 = max(key0, (mono16(v0) << 12) | rank);
            key1 = max(key1, (mono16(v1) << 12) | rank);
          } else {
            best0 = fmaxf(best0, v0);
            best1 = fmaxf(best1, v1);
          }
          if (lane < 3)
            sum = __fadd_rn(sum, lane == 0 ? xyz[0]
                                 : lane == 1 ? xyz[1] : xyz[2]);
        }
#pragma unroll
        for (int k = 0; k < A; ++k) p[k] = q[k];
      }
      int pos0 = -1, pos1 = -1;
      if constexpr (ARGMAX) {
        best0 = unmono16(key0 >> 12);
        best1 = unmono16(key1 >> 12);
        pos0 = start + 4095 - (key0 & 4095);
        pos1 = start + 4095 - (key1 & 4095);
      }
      if (n == 0) {
        best0 = best1 = BIG_NEG;
        pos0 = pos1 = -1;
      }
      const size_t row = static_cast<size_t>(cell) * C;
      if (C % 2 == 0 && ch1 < C) {
        if (BF16)
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(a.smax) + row + ch0) =
              __floats2bfloat162_rn(best0, best1);
        else
          *reinterpret_cast<float2*>(static_cast<float*>(a.smax) + row +
                                     ch0) = make_float2(best0, best1);
      } else {
        if (ch0 < C) store_out<BF16>(best0, a.smax, row + ch0);
        if (ch1 < C) store_out<BF16>(best1, a.smax, row + ch1);
      }
      if constexpr (ARGMAX) {
        if (C % 2 == 0 && ch1 < C) {
          *reinterpret_cast<int2*>(a.argpos + row + ch0) =
              make_int2(pos0, pos1);
        } else {
          if (ch0 < C) a.argpos[row + ch0] = pos0;
          if (ch1 < C) a.argpos[row + ch1] = pos1;
        }
      }
      if (blockIdx.y == 0 && lane < 4)
        a.tot[static_cast<size_t>(cell) * 4 + lane] =
            lane < 3 ? sum : static_cast<float>(n);
    }
  }
}

// a persistent grid: as many blocks as fill the card, at most one warp a
// cell
template <bool BF16, int A, bool ARGMAX>
cudaError_t launch_cells(const Cells& a, cudaStream_t st) {
  static int resident = 0;   // blocks the card holds at once
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, scan_cells<BF16, A, ARGMAX>, WARPS * 32, 0);
    if (err != cudaSuccess) return err;
    resident = sms * per_sm;
  }
  const long long want = (static_cast<long long>(a.ncells) + WARPS - 1) /
                         WARPS;
  const dim3 grid(static_cast<unsigned>(want < resident ? want : resident),
                  (a.C + 63) / 64);
  scan_cells<BF16, A, ARGMAX><<<grid, WARPS * 32, 0, st>>>(a);
  return cudaGetLastError();
}

template <bool BF16, bool ARGMAX>
cudaError_t launch_cells(const Cells& a, int A, cudaStream_t st) {
  switch (A) {
    case 1: return launch_cells<BF16, 1, ARGMAX>(a, st);
    case 2: return launch_cells<BF16, 2, ARGMAX>(a, st);
    case 3: return launch_cells<BF16, 3, ARGMAX>(a, st);
    case 4: return launch_cells<BF16, 4, ARGMAX>(a, st);
    case 5: return launch_cells<BF16, 5, ARGMAX>(a, st);
    case 6: return launch_cells<BF16, 6, ARGMAX>(a, st);
    case 7: return launch_cells<BF16, 7, ARGMAX>(a, st);
    default: return launch_cells<BF16, 8, ARGMAX>(a, st);
  }
}

}  // namespace

// cap < 0: no cap.  out_bf16: smax is bf16 (else f32).
extern "C" int affine_scan_gather(const void* pts, const void* starts,
                                  const void* counts, const void* mmat,
                                  void* tot, void* smax, int ncells, int A,
                                  int C, int cap, int out_bf16, void* stream) {
  if (A < 1 || A > MAX_A || C < 1 || C > 1024) return cudaErrorInvalidValue;
  if (ncells == 0) return cudaSuccess;
  const Cells a{static_cast<const float*>(pts), static_cast<const int*>(starts),
                static_cast<const int*>(counts),
                static_cast<const float*>(mmat), static_cast<float*>(tot),
                smax, nullptr, ncells, C, cap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16) return launch_cells<true, false>(a, A, st);
  return launch_cells<false, false>(a, A, st);
}

// K4 (packed = 0) and K5 (packed = 1: bf16 only, 0 <= cap <= 4096); argpos
// (ncells, C) int32.
extern "C" int affine_scan_argmax(const void* pts, const void* starts,
                                  const void* counts, const void* mmat,
                                  void* tot, void* smax, void* argpos,
                                  int ncells, int A, int C, int cap,
                                  int out_bf16, int packed, void* stream) {
  if (A < 1 || A > MAX_A || C < 1 || C > 1024) return cudaErrorInvalidValue;
  if (packed && (!out_bf16 || cap < 0 || cap > 4096))
    return cudaErrorInvalidValue;
  if (ncells == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (packed) {
    const Cells a{static_cast<const float*>(pts),
                  static_cast<const int*>(starts),
                  static_cast<const int*>(counts),
                  static_cast<const float*>(mmat), static_cast<float*>(tot),
                  smax, static_cast<int*>(argpos), ncells, C, cap};
    return launch_cells<true, true>(a, A, st);
  }
  const int threads = ((C < 4 ? 4 : C) + 31) / 32 * 32;
  const float* p = static_cast<const float*>(pts);
  const int* s = static_cast<const int*>(starts);
  const int* c = static_cast<const int*>(counts);
  const float* m = static_cast<const float*>(mmat);
  float* t = static_cast<float*>(tot);
  int* a = static_cast<int*>(argpos);
  if (out_bf16)
    scan_gather<true><<<ncells, threads, 0, st>>>(p, A, s, c, m, C, cap, t,
                                                  smax, a);
  else
    scan_gather<false><<<ncells, threads, 0, st>>>(p, A, s, c, m, C, cap, t,
                                                   smax, a);
  return cudaGetLastError();
}
