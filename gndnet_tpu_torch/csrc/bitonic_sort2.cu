// K10: ascending lexicographic sort of int32 (hi, lo) pairs, for Hopper
// (sm_90a).
//
// Replaces gndnet_tpu/ops/pallas_sort.py `bitonic_sort2_i32` (bodies
// `_sort2_kernel_static` / `_sort2_kernel`), reached through
// `sort2_padded_i32`.  The TPU kernel keeps both words resident in VMEM and
// compares the pair as two words at every stage.  Here each pair becomes
// one order-preserving 64-bit key,
//   key = (uint64(uint32(hi)) << 32) | (uint32(lo) ^ 0x80000000),
// so a signed 64-bit compare orders by hi (signed, the top word) and then
// by lo (signed, biased into unsigned order in the low word): one compare
// per exchange, as K1 does for one word.  The network is K1's
// (csrc/bitonic_sort.cu) over 64-bit keys:
//   * j < TILE: the pairs stay inside one TILE-key tile, and a block runs
//     all such stages of a merge level in shared memory (32 KB of keys);
//   * j >= TILE: one global compare-exchange launch per distance, on a
//     64-bit scratch array.
// The first launch reads the two int32 words and packs them; the last one
// unpacks into the two outputs, so the packed array never round-trips
// through the caller.  Indices at or past n read the pad pair (INT32_MAX,
// INT32_MAX), which is the largest key: a real pair equal to it is
// value-neutral in an exchange, and the outputs hold only the first n.
//
// Bound at the fine_grid shape (102 400 pairs padded to 131 072): the
// function must read the two words and write the two sorted words, 16
// bytes a pair, 1.6 MB, about 0.5 us at 3.35 TB/s.  As for K1 the network's
// 21 dependent launches and the L2-resident global passes bound it, not the
// bytes: every short-distance stage runs in shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 4096;       // keys per shared-memory tile (32 KB)
constexpr int TILE_THREADS = 1024;
constexpr long long PAD_KEY = 0x7FFFFFFFFFFFFFFFLL;  // (INT32_MAX, INT32_MAX)

__device__ __forceinline__ long long pack(int hi, int lo) {
  const unsigned long long u =
      (static_cast<unsigned long long>(static_cast<unsigned int>(hi)) << 32) |
      (static_cast<unsigned int>(lo) ^ 0x80000000u);
  return static_cast<long long>(u);
}

__device__ __forceinline__ int unpack_hi(long long key) {
  return static_cast<int>(
      static_cast<unsigned int>(static_cast<unsigned long long>(key) >> 32));
}

__device__ __forceinline__ int unpack_lo(long long key) {
  return static_cast<int>(static_cast<unsigned int>(key) ^ 0x80000000u);
}

__device__ __forceinline__ int pair_low(int p, int j) {
  // lower index of the p-th pair at distance j (j a power of two)
  return ((p & ~(j - 1)) << 1) | (p & (j - 1));
}

// k_fixed == 0: sort each tile completely (levels 2..tile, direction by the
// global index), reading the pairs (PACK) or the scratch keys.  k_fixed > 0:
// finish merge level k_fixed for distances tile/2 .. 1.  UNPACK writes the
// first n keys to (hi_out, lo_out), else the scratch keys.
template <bool PACK, bool UNPACK>
__global__ void tile_kernel(const int* __restrict__ hi,
                            const int* __restrict__ lo,
                            long long* __restrict__ keys,
                            int* __restrict__ hi_out, int* __restrict__ lo_out,
                            int n, int tile, int k_fixed) {
  __shared__ long long s[TILE];
  const int base = blockIdx.x * tile;
  for (int t = threadIdx.x; t < tile; t += blockDim.x) {
    const int i = base + t;
    if (PACK)
      s[t] = i < n ? pack(hi[i], lo[i]) : PAD_KEY;
    else
      s[t] = keys[i];
  }
  __syncthreads();
  const int k_hi = k_fixed ? k_fixed : tile;
  for (int k = k_fixed ? k_fixed : 2;; k <<= 1) {
    for (int j = k_fixed ? (tile >> 1) : (k >> 1); j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < (tile >> 1); p += blockDim.x) {
        const int i = pair_low(p, j);
        const int l = i + j;
        const bool asc = ((base + i) & k) == 0;
        const long long a = s[i], b = s[l];
        if ((a > b) == asc) {
          s[i] = b;
          s[l] = a;
        }
      }
      __syncthreads();
    }
    if (k >= k_hi) break;  // before the shift: k may be 2^30
  }
  for (int t = threadIdx.x; t < tile; t += blockDim.x) {
    const int i = base + t;
    if (UNPACK) {
      if (i < n) {
        hi_out[i] = unpack_hi(s[t]);
        lo_out[i] = unpack_lo(s[t]);
      }
    } else {
      keys[i] = s[t];
    }
  }
}

__global__ void global_stage(long long* __restrict__ keys, int pairs, int k,
                             int j) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= pairs) return;
  const int i = pair_low(p, j);
  const int l = i + j;
  const bool asc = (i & k) == 0;
  const long long a = keys[i], b = keys[l];
  if ((a > b) == asc) {
    keys[i] = b;
    keys[l] = a;
  }
}

}  // namespace

// hi, lo: n int32 on the device; hi_out, lo_out: n int32; m: the padded
// size, a power of two in [max(n, 2), 2^30]; keys: m int64 of scratch, used
// (and may be null) only when m > 4096.
extern "C" int bitonic_sort2_i32(const void* hi, const void* lo, void* keys,
                                 void* hi_out, void* lo_out, int n, int m,
                                 void* stream) {
  if (n < 1 || m < 2 || m < n || (m & (m - 1)) || (m > TILE && !keys))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* h = static_cast<const int*>(hi);
  const int* l = static_cast<const int*>(lo);
  long long* k = static_cast<long long*>(keys);
  int* ho = static_cast<int*>(hi_out);
  int* lout = static_cast<int*>(lo_out);
  const int tile = m < TILE ? m : TILE;
  const int threads = (tile >> 1) < TILE_THREADS ? (tile >> 1) : TILE_THREADS;
  if (m == tile) {
    tile_kernel<true, true><<<1, threads, 0, st>>>(h, l, k, ho, lout, n, tile,
                                                   0);
    return cudaGetLastError();
  }
  tile_kernel<true, false><<<m / tile, threads, 0, st>>>(h, l, k, ho, lout, n,
                                                         tile, 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int pairs = m >> 1;
  for (long long level = 2LL * tile; level <= m; level <<= 1) {
    for (long long j = level >> 1; j >= tile; j >>= 1) {
      global_stage<<<(pairs + 255) / 256, 256, 0, st>>>(
          k, pairs, static_cast<int>(level), static_cast<int>(j));
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    if (level == m)
      tile_kernel<false, true><<<m / tile, threads, 0, st>>>(
          h, l, k, ho, lout, n, tile, static_cast<int>(level));
    else
      tile_kernel<false, false><<<m / tile, threads, 0, st>>>(
          h, l, k, ho, lout, n, tile, static_cast<int>(level));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}
