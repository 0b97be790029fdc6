// K7: suffix segmented max or sum over a cell-sorted stream, for Hopper
// (sm_90a).
//
// Replaces gndnet_tpu/ops/pallas_segment.py `suffix_segment_reduce` (body
// `_kernel`):
//   out[i, :] = reduce(x[j, :] for j >= i while cell[j] == cell[i])
// for every row i, with reduce max or sum.  `cell` is any non-decreasing
// int32 stream (the sorted frontend also passes a flipped, negated one), so
// no id is reserved as a sentinel.
//
// x (N, C) f32 (max or sum) or bf16 (max), row-major; cell (N,) int32;
// out (N, C) in x's type; heads and carries (ceil(N / T), C) f32 scratch.
//
// The TPU kernel walks the chunks in reverse on one core and carries the
// partial first run of the later chunk in scratch.  Blocks of the card run
// in no order, so the carry becomes two more passes:
//   1. tile_scan: one block per tile of T rows.  (slice, column) work items
//      scan L-row slices backwards, then one thread per column walks the
//      slice heads backwards to carry each run into the slice before it,
//      and the rows of each slice's last run take that carry.  The block
//      writes its within-tile suffix partials to `out`, and the full
//      within-tile reduction of its first run to `heads`.
//   2. tile_carry: one block walks the tile heads backwards, G tiles at a
//      time staged in shared memory, one thread per column, and writes
//      carries[t] = the reduction of everything after tile t in the run
//      that tile t's last row belongs to.  A run over many tiles (the drop
//      segment at the stream's tail) chains through all of them.
//   3. tile_fixup: one block per tile; rows whose cell equals the next
//      tile's first cell take carries[t].
// Sums are f32 in a fixed order (backwards within a slice, then slice and
// tile carries added on the right), no float atomics: the same bits on
// every run, and the plain version (ops/segment.py) repeats that order to
// the bit.  Max is exact in either type; bf16 is compared in f32.
//
// Bound: each input read once and the output written once.  At the sorted
// frontend's shapes (102 400 rows): max over 64 f32 columns moves 52.8 MB,
// about 16 us at 3.35 TB/s; each 4-column sum 3.7 MB, about 1.1 us.  Pass 1
// reads x and writes out once; pass 3 re-touches only the tail runs; pass
// 2 is a short serial walk (N / T steps) that does not scale with C.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_C = 2048;
constexpr int MAX_T = 1024;
constexpr int STAGE_FLOATS = 8192;   // pass 2: G * C staged heads

template <bool BF16>
__device__ __forceinline__ float load(const void* p, long long i) {
  if (BF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

template <bool BF16>
__device__ __forceinline__ void store(void* p, long long i, float v) {
  if (BF16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

// a combined with b, a the earlier rows (sum: a + b in that order; max:
// NaN-propagating, as torch.maximum and jnp.maximum are)
template <bool MAX>
__device__ __forceinline__ float combine(float a, float b) {
  if (MAX) {
    if (a != a) return a;
    if (b != b) return b;
    return fmaxf(a, b);
  }
  return __fadd_rn(a, b);
}

template <bool MAX, bool BF16>
__global__ void tile_scan(const void* __restrict__ x,
                          const int* __restrict__ cell, void* __restrict__ out,
                          float* __restrict__ heads, long long n, int C, int T,
                          int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* scell = reinterpret_cast<int*>(smem);          // T
  const int S = (T + L - 1) / L;
  float* shead = reinterpret_cast<float*>(scell + T);  // S * C
  float* scarry = shead + S * C;                       // S * C
  const long long t0 = static_cast<long long>(blockIdx.x) * T;
  const int rows = static_cast<int>(min(static_cast<long long>(T), n - t0));
  const int nslices = (rows + L - 1) / L;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) scell[r] = cell[t0 + r];
  __syncthreads();

  // slices, backwards: v is the suffix partial of the row's run in the slice
  for (int item = threadIdx.x; item < nslices * C; item += blockDim.x) {
    const int s = item / C, c = item % C;
    const int r0 = s * L, r1 = min(r0 + L, rows);
    float v = 0.0f;
    for (int r = r1 - 1; r >= r0; --r) {
      const long long i = (t0 + r) * C + c;
      const float xv = load<BF16>(x, i);
      v = (r == r1 - 1 || scell[r] != scell[r + 1]) ? xv : combine<MAX>(xv, v);
      store<BF16>(out, i, v);
    }
    shead[s * C + c] = v;
  }
  __syncthreads();

  // slice heads, backwards: carry into slice s = the full in-tile value of
  // slice s+1's first run; the tile's head is slice 0's full first run
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float nxt = 0.0f;
    for (int s = nslices - 1; s >= 0; --s) {
      const int r0 = s * L, r1 = min(r0 + L, rows);
      const bool cont = s + 1 < nslices && scell[r1 - 1] == scell[r1];
      const float head = shead[s * C + c];
      scarry[s * C + c] = nxt;
      nxt = (cont && scell[r0] == scell[r1 - 1]) ? combine<MAX>(head, nxt)
                                                  : head;
    }
    heads[static_cast<long long>(blockIdx.x) * C + c] = nxt;
  }
  __syncthreads();

  // the last run of each slice that continues into the next slice
  for (int item = threadIdx.x; item < rows * C; item += blockDim.x) {
    const int r = item / C, c = item % C;
    const int s = r / L;
    if (s + 1 >= nslices || scell[r] != scell[(s + 1) * L]) continue;
    const long long i = (t0 + r) * C + c;
    store<BF16>(out, i, combine<MAX>(load<BF16>(out, i), scarry[s * C + c]));
  }
}

template <bool MAX>
__global__ void tile_carry(const int* __restrict__ cell,
                           const float* __restrict__ heads,
                           float* __restrict__ carries, long long n, int C,
                           int T, int nt, int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sh = reinterpret_cast<float*>(smem);    // G * C
  float* srun = sh + G * C;                      // C
  int* sfirst = reinterpret_cast<int*>(srun + C);  // G + 1
  int* slast = sfirst + G + 1;                   // G
  for (int c = threadIdx.x; c < C; c += blockDim.x) srun[c] = 0.0f;
  for (int g1 = nt; g1 > 0; g1 -= G) {
    const int g0 = max(0, g1 - G), cnt = g1 - g0;
    for (int i = threadIdx.x; i < cnt * C; i += blockDim.x)
      sh[i] = heads[static_cast<long long>(g0) * C + i];
    for (int i = threadIdx.x; i <= cnt; i += blockDim.x) {
      const int t = g0 + i;
      sfirst[i] = t < nt ? cell[static_cast<long long>(t) * T] : 0;
      if (i < cnt)
        slast[i] = cell[min(static_cast<long long>(t + 1) * T, n) - 1];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      float nxt = srun[c];
      for (int t = g1 - 1; t >= g0; --t) {
        const int k = t - g0;
        const bool cont = t + 1 < nt && slast[k] == sfirst[k + 1];
        const float head = sh[k * C + c];
        sh[k * C + c] = nxt;                  // carry into tile t
        nxt = (cont && sfirst[k] == slast[k]) ? combine<MAX>(head, nxt)
                                              : head;
      }
      srun[c] = nxt;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < cnt * C; i += blockDim.x)
      carries[static_cast<long long>(g0) * C + i] = sh[i];
    __syncthreads();
  }
}

template <bool MAX, bool BF16>
__global__ void tile_fixup(const int* __restrict__ cell,
                           const float* __restrict__ carries,
                           void* __restrict__ out, int C, int T) {
  const int t = blockIdx.x;                      // every tile but the last
  const long long a = static_cast<long long>(t) * T, b = a + T;
  const int next = cell[b];
  if (cell[b - 1] != next) return;
  for (int item = threadIdx.x; item < T * C; item += blockDim.x) {
    const int r = item / C, c = item % C;
    if (cell[a + r] != next) continue;
    const long long i = (a + r) * C + c;
    store<BF16>(out, i, combine<MAX>(load<BF16>(out, i),
                                     carries[static_cast<long long>(t) * C + c]));
  }
}

template <bool MAX, bool BF16>
cudaError_t launch(const void* x, const int* cell, void* out, float* heads,
                   float* carries, long long n, int C, int T,
                   cudaStream_t st) {
  const int nt = static_cast<int>((n + T - 1) / T);
  const int S = max(1, min(THREADS / C, T));
  const int L = (T + S - 1) / S;
  const int slices = (T + L - 1) / L;
  const size_t smem1 = T * sizeof(int) + 2 * slices * C * sizeof(float);
  tile_scan<MAX, BF16><<<nt, THREADS, smem1, st>>>(x, cell, out, heads, n, C,
                                                   T, L);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nt == 1) return err;
  const int G = max(1, min(min(nt, MAX_T), STAGE_FLOATS / C));
  const size_t smem2 = (G * C + C) * sizeof(float) + (2 * G + 1) * sizeof(int);
  tile_carry<MAX><<<1, THREADS, smem2, st>>>(cell, heads, carries, n, C, T,
                                             nt, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tile_fixup<MAX, BF16><<<nt - 1, THREADS, 0, st>>>(cell, carries, out, C, T);
  return cudaGetLastError();
}

}  // namespace

// is_max: 1 max, 0 sum; x_bf16: x and out are bf16 (max only), else f32.
// heads and carries must each hold ceil(n / tile) * C floats.
extern "C" int suffix_segment_reduce(const void* x, const void* cell, void* out,
                                     void* heads, void* carries, long long n,
                                     int C, int tile, int is_max, int x_bf16,
                                     void* stream) {
  if (n < 1 || C < 1 || C > MAX_C || tile < 1 || tile > MAX_T ||
      (x_bf16 && !is_max))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(cell);
  float* h = static_cast<float*>(heads);
  float* k = static_cast<float*>(carries);
  if (!is_max) return launch<false, false>(x, c, out, h, k, n, C, tile, st);
  if (x_bf16) return launch<true, true>(x, c, out, h, k, n, C, tile, st);
  return launch<true, false>(x, c, out, h, k, n, C, tile, st);
}
