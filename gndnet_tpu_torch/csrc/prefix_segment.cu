// K8: the row-major fused segmented scan (sums, PFN product, masked max),
// and K9: the segmented prefix-max broadcast along the lanes of a (C, N)
// table, for Hopper (sm_90a).
//
// K8 replaces gndnet_tpu/ops/pallas_affine.py `affine_segment_scan` (body
// `_kernel`).  For a stream whose equal cell ids are contiguous, pts8
// (N, 8) f32 with the caller's kept mask in column 3 and mmat8 (8, C):
//   run_tot[i, :]  = sum  over the rows j <= i of i's run of
//                    pts8[j, :4] * kept[j]                      (N, 4) f32
//   run_max[i, ch] = max  over the same rows of
//                    kept[j] > 0 ? a[j, ch] : -3e38        (N, C) out type
//   a = round(fma(round(m[7, ch]), round(p[7]), ... fma(round(m[0, ch]),
//             round(p[0]), +0.0) ...))
// with round() the output type's rounding: the operands and the f32 dot
// rounded as the TPU kernel rounds its MXU product (pallas_affine.py:67-69),
// the 8 terms accumulated in order with fused multiply-adds as XLA's CPU
// dot does, so the maxima are exact against the JAX package.
//
// K9 replaces `segment_broadcast_t` (body `_broadcast_kernel_t`): for vals
// (C, N) f32, out[ch, i] = max over the rows j <= i of i's run of
// vals[ch, j].  With a payload at each run's first row and a dominated
// value elsewhere, every row receives its run's payload.
//
// Both are the same prefix scan over W columns, a column being summed or
// maxed: K8 has W = 4 + C (4 sums, then C maxima, the product computed as a
// row is read), K9 W = C maxima with each column a contiguous stream.  The
// TPU kernels walk chunks in order on one core and carry the run that spans
// a chunk boundary in scratch; their `chunk` and K8's shortened window
// (`max_prefix`) exist for that walk.  Here blocks run in no order, so the
// carry becomes K7's three passes (csrc/suffix_segment.cu), run forwards:
//   1. tile_scan: one block per tile of T rows.  (slice, column) work items
//      scan L-row slices forwards, one thread per column walks the slice
//      tails forwards to carry each run into the slice after it, and the
//      rows of each slice's first run take that carry.  The block writes
//      its within-tile prefix partials to the outputs, and the full
//      within-tile value of its last run to `tails`.
//   2. tile_carry: one block walks the tile tails forwards, G tiles at a
//      time staged in shared memory, one thread per column, and writes
//      carries[t] = the value of everything before tile t in the run that
//      tile t's first row belongs to.  A run over many tiles chains through
//      all of them.
//   3. tile_fixup: one block per tile after the first; rows whose cell
//      equals the previous tile's last cell take carries[t].
// Every row gets its complete inclusive prefix, which at every row the TPU
// kernel's `max_prefix` contract defines equals its value there.  Sums are
// f32 in a fixed order (forwards within a slice, then the slice and tile
// carries added on the left), no float atomics: the same bits on every run,
// and the plain version (ops/affine_aux.py) repeats that order to the bit.
// The product and the sum are separate roundings (__fmul_rn, __fadd_rn), so
// the compiler cannot contract them.  Max is exact in either type; a bf16
// output is written rounded in pass 1 and re-read in pass 3, which is exact
// because rounding commutes with max.
//
// Bound, each input read once and each output written once: K8 at
// (102 400, 8) x (8, 64) f32 reads 3.7 MB and writes 1.6 MB of sums and
// 26.2 MB of maxima, about 9 us at 3.35 TB/s (its 110 MFLOP are 1.6 us at
// 67 TFLOP/s); K9 at (128, 1 605 632) f32 moves 1.65 GB, about 0.49 ms.
// Pass 1 reads the inputs and writes the outputs once; pass 3 re-touches
// only each tile's first run; pass 2 is a short serial walk (N / T steps)
// that does not scale with the row count of a tile.  K9's (slice, column)
// items read a channel's contiguous rows one thread at a time, so its
// loads are not coalesced across a warp: that is its first cost to cut.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_W = 2048;
constexpr int MAX_T = 1024;
constexpr int STAGE_FLOATS = 8192;   // pass 2: G * W staged tails
constexpr float BIG_NEG = -3.0e38f;  // pallas_affine._BIG_NEG

// a combined with b, a the earlier rows (sum: a + b; max: NaN-propagating,
// as torch.maximum and jnp.maximum are)
__device__ __forceinline__ float combine(bool sum, float a, float b) {
  if (sum) return __fadd_rn(a, b);
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

template <bool BF16>
__device__ __forceinline__ float round_out(float v) {
  if (BF16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// K8's columns: 0-3 sum pts8[:, :4] * kept into `tot`, 4 + ch maxes the
// masked activation of channel ch into `amax`
template <bool BF16>
struct ScanIo {
  const float* pts;   // (N, 8)
  const float* mmat;  // (8, C)
  float* tot;         // (N, 4)
  void* amax;         // (N, C)
  int C;
  struct Col {
    int c;
    float m[8];
  };
  __device__ int width() const { return 4 + C; }
  __device__ bool is_sum(int c) const { return c < 4; }
  __device__ Col column(int c) const {
    Col col;
    col.c = c;
    for (int k = 0; k < 8; ++k)
      col.m[k] = c < 4 ? 0.0f : round_out<BF16>(__ldg(mmat + k * C + c - 4));
    return col;
  }
  __device__ float load(const Col& col, long long r) const {
    const float* p = pts + r * 8;
    const float kept = __ldg(p + 3);
    if (col.c < 4) return __fmul_rn(__ldg(p + col.c), kept);
    if (!(kept > 0.0f)) return BIG_NEG;
    float acc = 0.0f;
    for (int k = 0; k < 8; ++k)
      acc = fmaf(col.m[k], round_out<BF16>(__ldg(p + k)), acc);
    return round_out<BF16>(acc);
  }
  __device__ void store(int c, long long r, float v) const {
    if (c < 4) {
      tot[r * 4 + c] = v;
    } else if (BF16) {
      static_cast<__nv_bfloat16*>(amax)[r * C + c - 4] =
          __float2bfloat16_rn(v);
    } else {
      static_cast<float*>(amax)[r * C + c - 4] = v;
    }
  }
  __device__ float reload(int c, long long r) const {
    if (c < 4) return tot[r * 4 + c];
    if (BF16)
      return __bfloat162float(
          static_cast<const __nv_bfloat16*>(amax)[r * C + c - 4]);
    return static_cast<const float*>(amax)[r * C + c - 4];
  }
};

// K9's columns: channel ch of the (C, N) tables
struct BroadcastIo {
  const float* vals;  // (C, N)
  float* out;         // (C, N)
  long long n;
  int C;
  struct Col {
    int c;
  };
  __device__ int width() const { return C; }
  __device__ bool is_sum(int) const { return false; }
  __device__ Col column(int c) const { return Col{c}; }
  __device__ float load(const Col& col, long long r) const {
    return __ldg(vals + col.c * n + r);
  }
  __device__ void store(int c, long long r, float v) const {
    out[c * n + r] = v;
  }
  __device__ float reload(int c, long long r) const { return out[c * n + r]; }
};

template <class Io>
__global__ void tile_scan(Io io, const int* __restrict__ cell,
                          float* __restrict__ tails, long long n, int T,
                          int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = io.width();
  int* scell = reinterpret_cast<int*>(smem);          // T
  const int S = (T + L - 1) / L;
  float* stail = reinterpret_cast<float*>(scell + T);  // S * W
  float* scarry = stail + S * W;                       // S * W
  const long long t0 = static_cast<long long>(blockIdx.x) * T;
  const int rows = static_cast<int>(min(static_cast<long long>(T), n - t0));
  const int nslices = (rows + L - 1) / L;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) scell[r] = cell[t0 + r];
  __syncthreads();

  // slices, forwards: v is the prefix partial of the row's run in the slice
  for (int item = threadIdx.x; item < nslices * W; item += blockDim.x) {
    const int s = item / W, c = item % W;
    const typename Io::Col col = io.column(c);
    const bool sum = io.is_sum(c);
    const int r0 = s * L, r1 = min(r0 + L, rows);
    float v = 0.0f;
    for (int r = r0; r < r1; ++r) {
      const float x = io.load(col, t0 + r);
      v = (r == r0 || scell[r] != scell[r - 1]) ? x : combine(sum, v, x);
      io.store(c, t0 + r, v);
    }
    stail[s * W + c] = v;
  }
  __syncthreads();

  // slice tails, forwards: carry into slice s = the full in-tile value of
  // slice s-1's last run; the tile's tail is the last slice's full last run
  for (int c = threadIdx.x; c < W; c += blockDim.x) {
    const bool sum = io.is_sum(c);
    float prv = 0.0f;
    for (int s = 0; s < nslices; ++s) {
      const int r0 = s * L, r1 = min(r0 + L, rows);
      const bool cont = s > 0 && scell[r0 - 1] == scell[r0];
      const float tail = stail[s * W + c];
      scarry[s * W + c] = prv;
      prv = (cont && scell[r0] == scell[r1 - 1]) ? combine(sum, prv, tail)
                                                 : tail;
    }
    tails[static_cast<long long>(blockIdx.x) * W + c] = prv;
  }
  __syncthreads();

  // the first run of each slice that continues from the slice before
  for (int item = threadIdx.x; item < rows * W; item += blockDim.x) {
    const int r = item / W, c = item % W;
    const int s = r / L;
    if (s == 0 || scell[r] != scell[s * L - 1]) continue;
    io.store(c, t0 + r,
             combine(io.is_sum(c), scarry[s * W + c], io.reload(c, t0 + r)));
  }
}

template <class Io>
__global__ void tile_carry(Io io, const int* __restrict__ cell,
                           const float* __restrict__ tails,
                           float* __restrict__ carries, long long n, int T,
                           int nt, int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = io.width();
  float* sh = reinterpret_cast<float*>(smem);      // G * W
  float* srun = sh + G * W;                        // W
  int* sfirst = reinterpret_cast<int*>(srun + W);  // G
  int* slast = sfirst + G;                         // G
  int* sprev = slast + G;                          // G
  for (int c = threadIdx.x; c < W; c += blockDim.x) srun[c] = 0.0f;
  for (int g0 = 0; g0 < nt; g0 += G) {
    const int cnt = min(G, nt - g0);
    for (int i = threadIdx.x; i < cnt * W; i += blockDim.x)
      sh[i] = tails[static_cast<long long>(g0) * W + i];
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
      const long long a = static_cast<long long>(g0 + i) * T;
      sfirst[i] = cell[a];
      slast[i] = cell[min(a + T, n) - 1];
      sprev[i] = a > 0 ? cell[a - 1] : 0;
    }
    __syncthreads();
    for (int c = threadIdx.x; c < W; c += blockDim.x) {
      const bool sum = io.is_sum(c);
      float run = srun[c];
      for (int k = 0; k < cnt; ++k) {
        const bool cont = g0 + k > 0 && sprev[k] == sfirst[k];
        const float tail = sh[k * W + c];
        sh[k * W + c] = run;                  // carry into tile g0 + k
        run = (cont && sfirst[k] == slast[k]) ? combine(sum, run, tail) : tail;
      }
      srun[c] = run;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < cnt * W; i += blockDim.x)
      carries[static_cast<long long>(g0) * W + i] = sh[i];
    __syncthreads();
  }
}

template <class Io>
__global__ void tile_fixup(Io io, const int* __restrict__ cell,
                           const float* __restrict__ carries, long long n,
                           int T) {
  const int W = io.width();
  const int t = blockIdx.x + 1;                  // every tile but the first
  const long long a = static_cast<long long>(t) * T;
  const int rows = static_cast<int>(min(static_cast<long long>(T), n - a));
  const int prev = cell[a - 1];
  if (cell[a] != prev) return;
  for (int item = threadIdx.x; item < rows * W; item += blockDim.x) {
    const int r = item / W, c = item % W;
    if (cell[a + r] != prev) continue;
    io.store(c, a + r,
             combine(io.is_sum(c),
                     carries[static_cast<long long>(t) * W + c],
                     io.reload(c, a + r)));
  }
}

template <class Io>
cudaError_t launch(Io io, int W, const int* cell, float* tails,
                   float* carries, long long n, int T, cudaStream_t st) {
  const int nt = static_cast<int>((n + T - 1) / T);
  const int S = max(1, min(THREADS / W, T));
  const int L = (T + S - 1) / S;
  const int slices = (T + L - 1) / L;
  const size_t smem1 = T * sizeof(int) + 2 * slices * W * sizeof(float);
  tile_scan<Io><<<nt, THREADS, smem1, st>>>(io, cell, tails, n, T, L);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nt == 1) return err;
  const int G = max(1, min(min(nt, MAX_T), STAGE_FLOATS / W));
  const size_t smem2 = (G * W + W) * sizeof(float) + 3 * G * sizeof(int);
  tile_carry<Io><<<1, THREADS, smem2, st>>>(io, cell, tails, carries, n, T,
                                            nt, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tile_fixup<Io><<<nt - 1, THREADS, 0, st>>>(io, cell, carries, n, T);
  return cudaGetLastError();
}

}  // namespace

// cell (n,) int32, equal ids contiguous; pts8 (n, 8) f32; mmat8 (8, C) f32;
// tot (n, 4) f32; amax (n, C) f32, or bf16 when out_bf16; tails and
// carries each ceil(n / tile) * (4 + C) floats of scratch.
extern "C" int affine_segment_scan(const void* cell, const void* pts8,
                                   const void* mmat8, void* tot, void* amax,
                                   void* tails, void* carries, long long n,
                                   int C, int tile, int out_bf16,
                                   void* stream) {
  if (n < 1 || C < 1 || C + 4 > MAX_W || tile < 1 || tile > MAX_T)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(cell);
  const float* p = static_cast<const float*>(pts8);
  const float* m = static_cast<const float*>(mmat8);
  float* h = static_cast<float*>(tails);
  float* k = static_cast<float*>(carries);
  float* t = static_cast<float*>(tot);
  if (out_bf16)
    return launch(ScanIo<true>{p, m, t, amax, C}, C + 4, c, h, k, n, tile, st);
  return launch(ScanIo<false>{p, m, t, amax, C}, C + 4, c, h, k, n, tile, st);
}

// cell (n,) int32, equal ids contiguous; vals, out (C, n) f32; tails and
// carries each ceil(n / tile) * C floats of scratch.
extern "C" int segment_broadcast_t(const void* cell, const void* vals,
                                   void* out, void* tails, void* carries,
                                   long long n, int C, int tile,
                                   void* stream) {
  if (n < 1 || C < 1 || C > MAX_W || tile < 1 || tile > MAX_T)
    return cudaErrorInvalidValue;
  return launch(BroadcastIo{static_cast<const float*>(vals),
                            static_cast<float*>(out), n, C},
                C, static_cast<const int*>(cell), static_cast<float*>(tails),
                static_cast<float*>(carries), n, tile,
                static_cast<cudaStream_t>(stream));
}
