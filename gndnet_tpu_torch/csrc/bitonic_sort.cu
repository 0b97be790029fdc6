// K1: ascending bitonic sort of int32 keys, in place, for Hopper (sm_90a).
//
// Replaces gndnet_tpu/ops/pallas_sort.py `bitonic_sort_i32` (bodies
// `_sort_kernel_static` / `_sort_kernel`), reached through
// `sort_padded_i32`.  The TPU kernel keeps all keys resident in VMEM for
// every stage.  131072 keys (512 KB, the kitti_sem packed keys padded to a
// power of two) do not fit in one block's 227 KB of shared memory, so the
// network is split by exchange distance j:
//   * j < TILE: the pairs stay inside one TILE-key tile, and a block runs
//     all such stages of a merge level in shared memory (one launch);
//   * j >= TILE: one global compare-exchange launch per distance, one
//     thread per pair.
// The first launch sorts every tile completely (all levels k <= TILE).
// For m keys that is 1 + sum over levels k = 2*TILE..m of
// (log2(k / TILE) + 1) launches: 21 at m = 131072.
//
// Bound at the kitti_sem shape: the function must read and write 0.5 MB of
// keys, about 0.3 us at 3.35 TB/s; the network's 1.3 M compare-exchanges
// per level are negligible work.  Each global pass re-reads the whole array,
// but it stays in the 50 MB L2, so the kernel is bound by launch latency
// and the serial chain of 21 dependent launches, not by bytes.  The design
// answers that by doing every short-distance stage (most of the 153) inside
// shared memory, so only 15 passes touch global memory.
//
// The caller pads to a power of two with INT32_MAX; equal keys are fine
// (compare-exchange never needs distinct keys).

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 4096;       // keys per shared-memory tile (16 KB)
constexpr int TILE_THREADS = 1024;

__device__ __forceinline__ int pair_low(int p, int j) {
  // lower index of the p-th pair at distance j (j a power of two)
  return ((p & ~(j - 1)) << 1) | (p & (j - 1));
}

// k_fixed == 0: sort each tile completely (levels 2..tile, direction by the
// global index).  k_fixed > 0: finish merge level k_fixed for distances
// tile/2 .. 1.
__global__ void tile_kernel(int* __restrict__ keys, int tile, int k_fixed) {
  __shared__ int s[TILE];
  const int base = blockIdx.x * tile;
  for (int t = threadIdx.x; t < tile; t += blockDim.x) s[t] = keys[base + t];
  __syncthreads();
  const int k_hi = k_fixed ? k_fixed : tile;
  for (int k = k_fixed ? k_fixed : 2;; k <<= 1) {
    for (int j = k_fixed ? (tile >> 1) : (k >> 1); j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < (tile >> 1); p += blockDim.x) {
        const int i = pair_low(p, j);
        const int l = i + j;
        const bool asc = ((base + i) & k) == 0;
        const int a = s[i], b = s[l];
        if ((a > b) == asc) {
          s[i] = b;
          s[l] = a;
        }
      }
      __syncthreads();
    }
    if (k >= k_hi) break;  // before the shift: k may be 2^30
  }
  for (int t = threadIdx.x; t < tile; t += blockDim.x) keys[base + t] = s[t];
}

__global__ void global_stage(int* __restrict__ keys, int pairs, int k, int j) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= pairs) return;
  const int i = pair_low(p, j);
  const int l = i + j;
  const bool asc = (i & k) == 0;
  const int a = keys[i], b = keys[l];
  if ((a > b) == asc) {
    keys[i] = b;
    keys[l] = a;
  }
}

}  // namespace

// keys: m int32 on the device, m a power of two in [2, 2^30].
extern "C" int bitonic_sort_i32(void* keys, int m, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* k = static_cast<int*>(keys);
  const int tile = m < TILE ? m : TILE;
  const int threads = (tile >> 1) < TILE_THREADS ? (tile >> 1) : TILE_THREADS;
  tile_kernel<<<m / tile, threads, 0, st>>>(k, tile, 0);
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
    tile_kernel<<<m / tile, threads, 0, st>>>(k, tile, static_cast<int>(level));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}
