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
// that attains the max (-1 for an empty cell).  Both are K2's body, a warp
// per cell, in another mode:
//   K4 (`scan_cells<., A, PAIR>`, f32, or bf16 with no cap): each lane
//     keeps a (value, row) pair per channel, and a row replaces it when
//     it is the cell's first kept row or its value is strictly greater,
//     so ties keep the earlier row and -0.0 ties +0.0 (the TPU kernel's
//     `am_r >= am` combine, earlier window winning).  Any cap, or none;
//   K5 (`scan_cells<bf16, A, KEY>`, bf16 with cap <= 4096): each lane
//     keeps one int key per channel in place of the max, max(key,
//     order(value) | (4095 - rank)), order(value) being the bf16 pattern
//     in the high half made an int in the patterns' total order
//     (pallas_affine.py `mono`, less 32768), so -0.0 < +0.0 and equal
//     values keep the lower rank.  On exit the key decodes to the exact
//     bf16 value and to start + rank.
// Either stores the value pair as a bf16 pair or a float2 and the rows as
// an int2 (a 256-byte argpos row a warp).  The earlier K4 was a block of
// 64 threads per cell, rows staged through shared memory 128 at a time
// behind two barriers a pass: 20 000 blocks at B=2, most of them only
// writing an empty row (13 us for 20 000 empty cells, 75 ns a row of a
// long cell; PERF.md).
// Positions are int32: the TPU's integer-valued-f32 encoding existed only
// for XLA:TPU's denormal flush.  They add one (ncells, C) int32 write (5 MB
// at B=2) to K2's bytes; the bound stays latency, as for K2.
//
// What a row costs.  One warp alone on a 4 096-row cell took 85 ns a row,
// and 20 000 cells of 10 rows 14 us over the empty grid's
// (PERF.md): the rows of one warp run in series, so the body keeps each
// row's work short and free of branches.  bf16 values are rounded in pairs
// (one conversion for two), every lane adds the xyz sums (lanes 0-2 store
// theirs), and K5's key is two integer operations.  Every mode loads the
// first 32 kept rows of a warp's next cell before it reduces the current
// one, so a cell's first load overlaps its predecessor's rows instead of
// following the counts' shuffle.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int MAX_A = 8;
constexpr float BIG_NEG = -3.0e38f;
constexpr int WARPS = 8;        // warps per block of scan_cells
constexpr unsigned FULL = 0xffffffffu;

// what a lane keeps per channel: the max (K2), the packed argmax key (K5),
// or the (value, row) pair (K4)
enum Mode { MAX = 0, KEY = 1, PAIR = 2 };

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

// both values rounded to bf16 by one conversion of the pair (or neither),
// each widened back by one integer operation
template <bool BF16>
__device__ __forceinline__ void round_pair(float a, float b, float& ra,
                                           float& rb) {
  if (BF16) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const unsigned u = reinterpret_cast<const unsigned&>(h);
    ra = __uint_as_float(u << 16);
    rb = __uint_as_float(u & 0xffff0000u);
  } else {
    ra = a;
    rb = b;
  }
}

// K5's key of a float that holds a bf16 value exactly: its high half made
// an int in the total order of bf16 bit patterns (negatives' magnitude bits
// flipped, so -0.0 < +0.0; pallas_affine.py `mono` less 32768), the low
// half 0 for the rank.  Two integer operations: a second conversion to
// bf16 made K5 slower.
__device__ __forceinline__ int order_key(float v) {
  const int b = __float_as_int(v);
  return b ^ ((b >> 31) & 0x7fff0000);
}

// the bf16 value of a key's high half
__device__ __forceinline__ float key_value(int key) {
  return __int_as_float(order_key(__int_as_float(key & 0xffff0000)));
}

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
  int* argpos;   // K4 and K5 only
  int ncells, C, cap;
};

template <bool BF16, int A, int MODE>
__global__ void __launch_bounds__(WARPS * 32) scan_cells(Cells a) {
  const float* __restrict__ pts = a.pts;
  const int C = a.C, cap = a.cap, ncells = a.ncells;
  const int lane = threadIdx.x & 31;
  const long long nwarps = static_cast<long long>(gridDim.x) * WARPS;
  const long long warp = static_cast<long long>(blockIdx.x) * WARPS +
                         (threadIdx.x >> 5);
  if (warp >= ncells) return;
  const int ch0 = blockIdx.y * 64 + 2 * lane, ch1 = ch0 + 1;
  float m0[A], m1[A];
#pragma unroll
  for (int k = 0; k < A; ++k) {
    m0[k] = ch0 < C ? round_out<BF16>(a.mmat[k * C + ch0]) : 0.0f;
    m1[k] = ch1 < C ? round_out<BF16>(a.mmat[k * C + ch1]) : 0.0f;
  }
  const auto kept = [cap](int count) {
    return (cap >= 0 && count > cap) ? cap : count;
  };
  // the warp's cells: warp, warp + nwarps, ...; 32 of them a batch, lane j
  // holding the count and start of the batch's j-th cell
  int my_count = 0, my_start = 0;
  if (warp + lane * nwarps < ncells) {
    my_count = a.counts[warp + lane * nwarps];
    my_start = a.starts[warp + lane * nwarps];
  }
  int n = kept(__shfl_sync(FULL, my_count, 0));
  int start = __shfl_sync(FULL, my_start, 0);
  float p[A];   // the current cell's rows r0 + lane
  load_row<A>(p, pts + static_cast<size_t>(start) * A, lane, n);
  for (long long base = warp; base < ncells; base += 32 * nwarps) {
    const long long next_base = base + 32 * nwarps;
    int next_count = 0, next_start = 0;   // the next batch's
    if (next_base + lane * nwarps < ncells) {
      next_count = a.counts[next_base + lane * nwarps];
      next_start = a.starts[next_base + lane * nwarps];
    }
    for (int j = 0; j < 32; ++j) {
      const long long cell = base + j * nwarps;
      if (cell >= ncells) break;
      // the next cell's first rows, loaded before this cell is reduced (a
      // cell past the end has count 0 and loads nothing)
      const int jn = (j + 1) & 31;
      const int n2 = kept(__shfl_sync(FULL, j < 31 ? my_count : next_count,
                                      jn));
      const int start2 = __shfl_sync(FULL, j < 31 ? my_start : next_start,
                                     jn);
      float p2[A];
      load_row<A>(p2, pts + static_cast<size_t>(start2) * A, lane, n2);
      const float* src = pts + static_cast<size_t>(start) * A;
      float best0 = -INFINITY, best1 = -INFINITY, sum = 0.0f;
      int key0 = INT_MIN, key1 = INT_MIN;   // K5
      int row0 = 0, row1 = 0;               // K4: the rank of the first best
      float q[A];
      for (int r0 = 0; r0 < n; r0 += 32) {
        if (r0 + 32 < n) load_row<A>(q, src, r0 + 32 + lane, n);
        const int nr = min(32, n - r0);
#pragma unroll 4
        for (int r = 0; r < nr; ++r) {
          float pk[A], pr[A];
#pragma unroll
          for (int k = 0; k < A; ++k) pk[k] = __shfl_sync(FULL, p[k], r);
#pragma unroll
          for (int k = 0; k + 1 < A; k += 2)
            round_pair<BF16>(pk[k], pk[k + 1], pr[k], pr[k + 1]);
          if (A % 2) pr[A - 1] = round_out<BF16>(pk[A - 1]);
          float acc0 = 0.0f, acc1 = 0.0f;
#pragma unroll
          for (int k = 0; k < A; ++k) {
            acc0 = __fmaf_rn(m0[k], pr[k], acc0);
            acc1 = __fmaf_rn(m1[k], pr[k], acc1);
          }
          float v0, v1;
          round_pair<BF16>(acc0, acc1, v0, v1);
          if constexpr (MODE == KEY) {
            const int rank = 4095 - (r0 + r);
            key0 = max(key0, order_key(v0) | rank);
            key1 = max(key1, order_key(v1) | rank);
          } else if constexpr (MODE == PAIR) {
            const int rank = r0 + r;
            if (rank == 0 || v0 > best0) {
              best0 = v0;
              row0 = rank;
            }
            if (rank == 0 || v1 > best1) {
              best1 = v1;
              row1 = rank;
            }
          } else {
            best0 = fmaxf(best0, v0);
            best1 = fmaxf(best1, v1);
          }
          // x on lane 0, y on 1, z on 2; every lane adds, without a branch,
          // and only lanes 0-2 store their sums
          const float y = A > 1 ? pk[A > 1 ? 1 : 0] : 0.0f;
          const float z = A > 2 ? pk[A > 2 ? 2 : 0] : 0.0f;
          sum = __fadd_rn(sum, lane == 0 ? pk[0] : lane == 1 ? y : z);
        }
#pragma unroll
        for (int k = 0; k < A; ++k) p[k] = q[k];
      }
      int pos0 = -1, pos1 = -1;
      if constexpr (MODE == KEY) {
        best0 = key_value(key0);
        best1 = key_value(key1);
        pos0 = start + 4095 - (key0 & 0xffff);
        pos1 = start + 4095 - (key1 & 0xffff);
      } else if constexpr (MODE == PAIR) {
        pos0 = start + row0;
        pos1 = start + row1;
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
      if constexpr (MODE != MAX) {
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
      n = n2;
      start = start2;
#pragma unroll
      for (int k = 0; k < A; ++k) p[k] = p2[k];
    }
    my_count = next_count;
    my_start = next_start;
  }
}

// a persistent grid: as many blocks as fill the card, at most one warp a
// cell
template <bool BF16, int A, int MODE>
cudaError_t launch_cells(const Cells& a, cudaStream_t st) {
  static int resident = 0;   // blocks the card holds at once
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, scan_cells<BF16, A, MODE>, WARPS * 32, 0);
    if (err != cudaSuccess) return err;
    resident = sms * per_sm;
  }
  const long long want = (static_cast<long long>(a.ncells) + WARPS - 1) /
                         WARPS;
  const dim3 grid(static_cast<unsigned>(want < resident ? want : resident),
                  (a.C + 63) / 64);
  scan_cells<BF16, A, MODE><<<grid, WARPS * 32, 0, st>>>(a);
  return cudaGetLastError();
}

template <bool BF16, int MODE>
cudaError_t launch_cells(const Cells& a, int A, cudaStream_t st) {
  switch (A) {
    case 1: return launch_cells<BF16, 1, MODE>(a, st);
    case 2: return launch_cells<BF16, 2, MODE>(a, st);
    case 3: return launch_cells<BF16, 3, MODE>(a, st);
    case 4: return launch_cells<BF16, 4, MODE>(a, st);
    case 5: return launch_cells<BF16, 5, MODE>(a, st);
    case 6: return launch_cells<BF16, 6, MODE>(a, st);
    case 7: return launch_cells<BF16, 7, MODE>(a, st);
    default: return launch_cells<BF16, 8, MODE>(a, st);
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
  if (out_bf16) return launch_cells<true, MAX>(a, A, st);
  return launch_cells<false, MAX>(a, A, st);
}

// K4 (packed = 0: f32, or bf16 with any cap or none) and K5 (packed = 1:
// bf16 only, 0 <= cap <= 4096); argpos (ncells, C) int32.
extern "C" int affine_scan_argmax(const void* pts, const void* starts,
                                  const void* counts, const void* mmat,
                                  void* tot, void* smax, void* argpos,
                                  int ncells, int A, int C, int cap,
                                  int out_bf16, int packed, void* stream) {
  if (A < 1 || A > MAX_A || C < 1 || C > 1024) return cudaErrorInvalidValue;
  if (packed && (!out_bf16 || cap < 0 || cap > 4096))
    return cudaErrorInvalidValue;
  if (ncells == 0) return cudaSuccess;
  const Cells a{static_cast<const float*>(pts), static_cast<const int*>(starts),
                static_cast<const int*>(counts),
                static_cast<const float*>(mmat), static_cast<float*>(tot),
                smax, static_cast<int*>(argpos), ncells, C, cap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (packed) return launch_cells<true, KEY>(a, A, st);
  if (out_bf16) return launch_cells<true, PAIR>(a, A, st);
  return launch_cells<false, PAIR>(a, A, st);
}
