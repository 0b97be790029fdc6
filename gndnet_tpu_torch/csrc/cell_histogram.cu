// K3: per-item point count of every grid cell, and the run ends of a
// cell-sorted id stream, for Hopper (sm_90a).
//
// Replaces gndnet_tpu/ops/pallas_affine.py `histogram_counts_pallas` (body
// `_hist_kernel`) together with what `histogram_ends` does with its
// counts: ends = max(cumsum(counts) - 1, 0) per item.  The TPU kernel
// builds factored (ny | nx, chunk) one-hot tiles in VMEM and accumulates
// their outer product on the MXU across a sequential grid.  A GPU has no
// reason to route a histogram through the tensor cores: integer adds count
// exactly, in any order of the ids, sorted or not.
//
// ids (batch, n) int32; counts (batch, ncells) int32; ends (batch, ncells)
// int32 or null.  Ids outside [0, ncells) -- the drop id ny*nx and padding
// -- are not counted.
//
// Bound at the kitti_sem shape: it must read 0.4 MB of ids and write 80 KB
// of counts and ends, about 0.15 us at 3.35 TB/s; the work is one add per
// id.  So it is bound by launch latency and by contention: the ids are
// cell-sorted on every path that calls it, with runs of hundreds of equal
// ids, so a warp's 32 lanes mostly hit one counter.  The design:
//   * One thread-block cluster of G CTAs per item (grid (G, batch)).  CTA
//     r owns counters [r * slice, (r + 1) * slice) of its item in its
//     shared memory; the cluster's counters cover the item's grid, so the
//     histogram never touches global memory until it is written once.
//   * Each CTA reads a contiguous 1/G of the item's ids, coalesced, a few
//     loads in flight a thread.  A warp groups equal ids with
//     __match_any_sync, and the group's lowest lane adds the group's size
//     to the owning CTA's counter through distributed shared memory
//     (DSMEM): one or two atomics a warp on sorted ids, not 32 serialised.
//   * After a cluster barrier each CTA writes its slice of counts (no
//     memset, no global atomic; deterministic).  For ends it also sums
//     its slice, publishes the total, and after a second barrier adds the
//     totals of the lower ranks, read through DSMEM, to an in-block scan
//     of its slice.  One launch gives both outputs.
// A CTA holds at most CTA_CELLS counters (its 227 KB of shared memory), so
// a cluster of 16 holds 928 768 cells (ops/affine.py HIST_CLUSTER_MAX_CELLS;
// fine_grid needs 62 500).  Above that the wrapper takes, by ncells alone,
// the global route: the same warp-aggregated count into a zeroed output in
// global memory, then the same scan, one CTA per item.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int LOADS = 4;         // ids in flight a thread
constexpr int PER = 4;           // counters a thread scans a round
constexpr int FIXED = 64;        // words before the counters: warp sums,
                                 // the slice total, the rank offset
constexpr int SMEM_BYTES = 232448;   // an H100 block's opt-in shared memory
constexpr int CTA_CELLS = SMEM_BYTES / 4 - FIXED;   // 58 048
constexpr int MAX_CLUSTER = 16;
constexpr int GLOBAL_BLOCKS = 64;    // per item, on the global route
constexpr unsigned FULL = 0xffffffffu;

// Count row[begin, end) (ids in [0, ncells)), one add(cell, k) per group
// of equal ids in a warp's 32 lanes.
template <typename Add>
__device__ __forceinline__ void count_ids(const int* __restrict__ row,
                                          int begin, int end, int ncells,
                                          Add add) {
  const int lane = threadIdx.x & 31;
  for (int i0 = begin + (threadIdx.x & ~31); i0 < end;
       i0 += LOADS * THREADS) {
    int c[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int i = i0 + u * THREADS + lane;
      c[u] = i < end ? __ldg(row + i) : -1;
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const bool ok =
          static_cast<unsigned>(c[u]) < static_cast<unsigned>(ncells);
      const int key = ok ? c[u] : -1;
      const unsigned peers = __match_any_sync(FULL, key);
      if (ok && lane == __ffs(peers) - 1) add(key, __popc(peers));
    }
  }
}

// dst[i] = max(offset + src[0] + ... + src[i] - 1, 0) for i < len: a
// block-wide inclusive scan, PER * THREADS counters a round.  src lies in
// shared or global memory; wsum holds WARPS words of shared memory.
__device__ void write_ends(const int* src, int len, int offset,
                           int* __restrict__ dst, int* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int base = 0; base < len; base += PER * THREADS) {
    const int first = base + threadIdx.x * PER;
    int v[PER], s = 0;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      v[k] = first + k < len ? src[first + k] : 0;
      s += v[k];
    }
    int x = s;   // inclusive scan of the thread sums over the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) wsum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = lane < WARPS ? wsum[lane] : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(FULL, w, d);
        if (lane >= d) w += y;
      }
      if (lane < WARPS) wsum[lane] = w;
    }
    __syncthreads();
    int run = offset + (warp ? wsum[warp - 1] : 0) + x - s;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      run += v[k];
      if (first + k < len) dst[first + k] = run > 0 ? run - 1 : 0;
    }
    offset += wsum[WARPS - 1];
    __syncthreads();   // wsum is rewritten next round
  }
}

__global__ void __launch_bounds__(THREADS)
    hist_cluster(const int* __restrict__ ids, int n, int ncells, int slice,
                 int* __restrict__ counts, int* __restrict__ ends) {
  extern __shared__ int smem[];
  int* wsum = smem;            // [WARPS]
  int* total = smem + 32;      // this CTA's slice total
  int* offset = smem + 33;     // the totals of the lower ranks
  int* h = smem + FIXED;       // [slice] counters
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int g = static_cast<int>(cluster.num_blocks());
  const size_t item = blockIdx.y;
  const int lo = rank * slice;
  const int len = max(0, min(slice, ncells - lo));
  for (int i = threadIdx.x; i < len; i += THREADS) h[i] = 0;
  if (threadIdx.x == 0) *total = 0;
  cluster.sync();   // every CTA runs and every counter is zero

  const int per = (n + g - 1) / g;
  const int begin = min(n, rank * per);
  count_ids(ids + item * n, begin, min(n, begin + per), ncells,
            [&](int c, int k) {
              const int owner = c / slice;
              atomicAdd(cluster.map_shared_rank(h + (c - owner * slice),
                                                owner),
                        k);
            });
  cluster.sync();   // every count is in

  int* out = counts + item * ncells + lo;
  int s = 0;
  for (int i = threadIdx.x; i < len; i += THREADS) {
    const int v = h[i];
    out[i] = v;
    s += v;
  }
  if (ends == nullptr) return;   // no CTA reads another's memory from here
  s = __reduce_add_sync(FULL, s);
  if ((threadIdx.x & 31) == 0 && s) atomicAdd(total, s);
  cluster.sync();   // every slice total is published
  if (threadIdx.x < 32) {
    const int q = threadIdx.x;
    int t = q < rank ? *cluster.map_shared_rank(total, q) : 0;
    t = __reduce_add_sync(FULL, t);
    if (q == 0) *offset = t;
  }
  cluster.sync();   // the totals are read: a CTA may exit after this
  write_ends(h, len, *offset, ends + item * ncells + lo, wsum);
}

__global__ void __launch_bounds__(THREADS)
    hist_global(const int* __restrict__ ids, int n, int ncells,
                int* __restrict__ counts) {
  const size_t item = blockIdx.y;
  int* out = counts + item * ncells;
  const int per = (n + gridDim.x - 1) / gridDim.x;
  const int begin = min(n, static_cast<int>(blockIdx.x) * per);
  count_ids(ids + item * n, begin, min(n, begin + per), ncells,
            [&](int c, int k) { atomicAdd(out + c, k); });
}

__global__ void __launch_bounds__(THREADS)
    ends_global(const int* __restrict__ counts, int ncells,
                int* __restrict__ ends) {
  __shared__ int wsum[WARPS];
  const size_t item = blockIdx.x;
  write_ends(counts + item * ncells, ncells, 0, ends + item * ncells, wsum);
}

// Once: the opt-in shared memory and clusters of 16.
cudaError_t prepare() {
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(
        hist_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        hist_cluster, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }();
  return err;
}

cudaLaunchConfig_t config(int g, int batch, size_t smem, cudaStream_t st,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g, batch, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = g;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool valid_cluster(int g) {
  return g >= 1 && g <= MAX_CLUSTER && (g & (g - 1)) == 0;
}

}  // namespace

// cluster > 0: one cluster of that many CTAs per item (a power of two up to
// 16, ncells <= cluster * CTA_CELLS), one launch.  cluster == 0: the global
// route (a memset, the count, and with ends one scan launch).  ends may be
// null.
extern "C" int cell_histogram_i32(const void* ids, void* counts, void* ends,
                                  int batch, int n, int ncells, int cluster,
                                  void* stream) {
  if (batch < 1 || batch > 65535 || n < 0 || ncells < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* i = static_cast<const int*>(ids);
  int* c = static_cast<int*>(counts);
  int* e = static_cast<int*>(ends);
  if (cluster == 0) {
    cudaError_t err = cudaMemsetAsync(
        c, 0, static_cast<size_t>(batch) * ncells * sizeof(int), st);
    if (err != cudaSuccess) return err;
    int blocks = (n + LOADS * THREADS - 1) / (LOADS * THREADS);
    blocks = blocks < 1 ? 1 : (blocks > GLOBAL_BLOCKS ? GLOBAL_BLOCKS
                                                      : blocks);
    hist_global<<<dim3(blocks, batch), THREADS, 0, st>>>(i, n, ncells, c);
    if (e != nullptr)
      ends_global<<<batch, THREADS, 0, st>>>(c, ncells, e);
    return cudaGetLastError();
  }
  if (!valid_cluster(cluster) ||
      static_cast<long long>(ncells) >
          static_cast<long long>(cluster) * CTA_CELLS)
    return cudaErrorInvalidValue;
  cudaError_t err = prepare();
  if (err != cudaSuccess) return err;
  const int slice = (ncells + cluster - 1) / cluster;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      config(cluster, batch, (FIXED + static_cast<size_t>(slice)) * 4, st,
             &attr);
  err = cudaLaunchKernelEx(&cfg, hist_cluster, i, n, ncells, slice, c, e);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The most cells one cluster launch counts on the current device: the
// largest schedulable cluster (with all of its shared memory) times a
// CTA's counters; 0 when none fits, -cudaError on a failed query.
extern "C" int cell_histogram_capacity() {
  cudaError_t err = prepare();
  if (err != cudaSuccess) return -static_cast<int>(err);
  for (int g = MAX_CLUSTER; g >= 1; g >>= 1) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = config(g, 1, SMEM_BYTES, nullptr, &attr);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, hist_cluster, &cfg);
    if (err != cudaSuccess) return -static_cast<int>(err);
    if (clusters > 0) return g * CTA_CELLS;
  }
  return 0;
}
