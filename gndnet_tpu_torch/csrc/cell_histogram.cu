// K3: per-item point count of every grid cell, for Hopper (sm_90a).
//
// Replaces gndnet_tpu/ops/pallas_affine.py `histogram_counts_pallas` (body
// `_hist_kernel`), reached through `histogram_ends`.  The TPU kernel builds
// factored (ny | nx, chunk) one-hot tiles in VMEM and accumulates their
// outer product on the MXU across a sequential grid.  A GPU has no reason to
// route a histogram through the tensor cores: integer atomics count exactly,
// in any order of the ids, sorted or not.
//
// ids (batch, n) int32; out (batch, ncells) int32 counts.  Ids outside
// [0, ncells) -- the drop id ny*nx and padding -- are skipped.
//
// Bound at the kitti_sem shape: it must read 0.4 MB of ids and write 40 KB
// of counts, about 0.13 us at 3.35 TB/s; the work is one add per id.  So it
// is bound by launch latency and by atomic contention, which sorted ids
// make heavy (a run of up to thousands of equal ids).  The design keeps the
// histogram private to each block in shared memory when ncells * 4 bytes
// fit (kitti_sem: 40 KB), where contended atomics stay on the SM, and
// flushes only non-zero counters to global memory; larger grids count with
// global atomics.  The output is zeroed on the stream first (no allocation).

#include <cuda_runtime.h>

namespace {

constexpr int SHARED_CELLS = 12288;   // 48 KB of int counters
constexpr int THREADS = 512;
constexpr int IDS_PER_BLOCK = 4096;
constexpr int MAX_BLOCKS = 64;        // per item

__global__ void hist_shared(const int* __restrict__ ids, int n, int ncells,
                            int* __restrict__ out) {
  __shared__ int h[SHARED_CELLS];
  for (int c = threadIdx.x; c < ncells; c += blockDim.x) h[c] = 0;
  __syncthreads();
  const int* row = ids + static_cast<size_t>(blockIdx.y) * n;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const int c = row[i];
    if (static_cast<unsigned>(c) < static_cast<unsigned>(ncells))
      atomicAdd(&h[c], 1);
  }
  __syncthreads();
  int* o = out + static_cast<size_t>(blockIdx.y) * ncells;
  for (int c = threadIdx.x; c < ncells; c += blockDim.x)
    if (h[c]) atomicAdd(&o[c], h[c]);
}

__global__ void hist_global(const int* __restrict__ ids, int n, int ncells,
                            int* __restrict__ out) {
  const int* row = ids + static_cast<size_t>(blockIdx.y) * n;
  int* o = out + static_cast<size_t>(blockIdx.y) * ncells;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const int c = row[i];
    if (static_cast<unsigned>(c) < static_cast<unsigned>(ncells))
      atomicAdd(&o[c], 1);
  }
}

}  // namespace

extern "C" int cell_histogram_i32(const void* ids, void* out, int batch,
                                  int n, int ncells, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      out, 0, static_cast<size_t>(batch) * ncells * sizeof(int), st);
  if (err != cudaSuccess) return err;
  int blocks = (n + IDS_PER_BLOCK - 1) / IDS_PER_BLOCK;
  blocks = blocks < 1 ? 1 : (blocks > MAX_BLOCKS ? MAX_BLOCKS : blocks);
  const dim3 grid(blocks, batch);
  const int* i = static_cast<const int*>(ids);
  int* o = static_cast<int*>(out);
  if (ncells <= SHARED_CELLS)
    hist_shared<<<grid, THREADS, 0, st>>>(i, n, ncells, o);
  else
    hist_global<<<grid, THREADS, 0, st>>>(i, n, ncells, o);
  return cudaGetLastError();
}
