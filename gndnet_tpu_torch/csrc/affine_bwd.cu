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
// cells (count 0) and argpos -1 contribute nothing.  argpos may name any
// stream row, not only a row of the cell's own run.
//
// pts (N, A) f32 row-major, A <= 8; argpos (ncells, C) int32 from K4/K5;
// d_smax (ncells, C) f32 or bf16; counts (ncells,) int32; partial (blocks,
// A, C) f32 scratch; ticket one uint32, 0 between calls; out (A, C) f32, the
// layout of the port's mmat (the transpose of the TPU kernel's (C, A)
// d_mmat_t).
//
// Bound at the kitti_sem B=2 shape (20 000 cells x 64 channels, A = 4): the
// function must read the counts (80 KB), the argpos and d_smax rows of the
// occupied cells only (6 bytes a channel in bf16), the distinct gathered
// rows (16 bytes each) and write 1 KB: well under 1-8 MB, a few us at 3.35
// TB/s; its ~10 MFLOP are negligible.  What it costs is the chain of
// dependent loads: a count, then an argpos row, then the gathered rows.
//
// Design, one launch: a persistent grid (at most two blocks of 8 warps per
// SM, in clusters of 8; blockIdx.y a 64-channel group) in which each warp
// takes 16 consecutive cells at a time.  Lane l loads the count of cell
// l % 16 and a ballot gives the occupied cells, which the warp visits in
// ascending order U at a time (4 at A <= 4, else 2), lane l owning
// channels (2l, 2l + 1): an int2 of argpos and a bf16 pair or float2 of
// d_smax per cell (256- and 128-byte rows), then the 2U gathered rows (a
// float4 each at A = 4).  Two sets of argpos and d_smax registers are used
// in turn: the next U cells' are loaded while the current gathers are in
// flight, and the warp's next 16 counts while its cells are summed; an
// empty cell costs its count alone.  Nothing that waits on a load comes
// before the next loads are issued: a warp issues in order, so the bf16
// pairs of d_smax stay packed and the gathered rows are rounded (in pairs)
// only where they are summed.  Each lane keeps 2A f32 sums,
// __fadd_rn(acc, __fmul_rn(d, p)) in cell order.  A block sums its warps
// in a fixed order in shared memory; the cluster's rank-0 block sums the 8
// blocks' sums through distributed shared memory in rank order and writes
// the cluster's (A, C) partial; after a __threadfence() it takes a ticket
// with an integer atomicAdd, and the one that takes the last ticket sums
// the partials in cluster order (32 loads in flight a thread), writes out
// and puts the ticket back to 0.  No float atomics: the grid depends only
// on ncells and the card, so a call gives the same bits every time.  Calls
// that share a ticket must be ordered on one stream, as the training
// step's are: the wrapper keeps one ticket per device.
//
// What the steps cost (PERF.md §6): a warp per 32 cells, 8 cells a step
// with one register set (each step waited on the loads it had just
// issued) and a block per SM took 0.0167 ms at kitti_sem B=2 in bf16;
// 16-cell chunks, two register sets and two blocks per SM 0.0119; the
// clusters (20 partials at B=2, not 157) 0.0115; converting nothing
// before the next loads 0.0087.  Of that, about 4 us is the reduction
// after the cells: the cluster sum 1.6, the fence and ticket 1.4, the
// last sum 0.8.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_A = 8;
constexpr int WARPS = 8;          // warps per block
constexpr int CHUNK = 16;         // consecutive cells a warp takes at once
constexpr int CLUSTER = 8;        // blocks a cluster, whose sums meet in DSMEM
constexpr unsigned FULL = 0xffffffffu;

template <bool BF16>
__device__ __forceinline__ float round_in(float v) {
  if (BF16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// d_smax at a lane's two channels as loaded: a bf16 pair stays packed (x
// in the low half) until it is used, so no load is waited on early
template <bool BF16>
struct DPair {
  float2 v = make_float2(0.0f, 0.0f);
  __device__ float x() const { return v.x; }
  __device__ float y() const { return v.y; }
};

template <>
struct DPair<true> {
  unsigned v = 0;
  __device__ float x() const { return __uint_as_float(v << 16); }
  __device__ float y() const { return __uint_as_float(v & 0xffff0000u); }
};

struct Bwd {
  const float* pts;
  const int* argpos;
  const void* d_smax;
  const int* counts;
  float* partial;
  unsigned* ticket;
  float* out;
  int ncells, C;
  bool vec4;   // A == 4 and pts 16-byte aligned: float4 gathers
};

// row p of pts into g (zeros for p < 0)
template <int A>
__device__ __forceinline__ void gather(float* g, const float* pts, int p,
                                       bool vec4) {
  if constexpr (A == 4) {
    if (vec4) {
      const float4 v = p >= 0 ? *reinterpret_cast<const float4*>(
                                    pts + static_cast<size_t>(p) * 4)
                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      g[0] = v.x;
      g[1] = v.y;
      g[2] = v.z;
      g[3] = v.w;
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < A; ++k)
    g[k] = p >= 0 ? pts[static_cast<size_t>(p) * A + k] : 0.0f;
}

// g rounded to the working type in place, one conversion for two values
template <bool BF16, int A>
__device__ __forceinline__ void round_row(float* g) {
  if constexpr (BF16) {
#pragma unroll
    for (int k = 0; k + 1 < A; k += 2) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(g[k], g[k + 1]);
      const unsigned u = reinterpret_cast<const unsigned&>(h);
      g[k] = __uint_as_float(u << 16);
      g[k + 1] = __uint_as_float(u & 0xffff0000u);
    }
    if (A % 2) g[A - 1] = round_in<BF16>(g[A - 1]);
  }
}

// Pop up to U occupied cells off `occ` (bit b: cell base + b) and load their
// argpos and d_smax at the lane's two channels; a missing cell or channel
// gets argpos -1.
template <bool BF16, int U>
__device__ __forceinline__ void take(unsigned& occ, long long base,
                                     const Bwd& a, int ch0, int2* pos,
                                     DPair<BF16>* d) {
  const int C = a.C;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    pos[u] = make_int2(-1, -1);
    d[u] = DPair<BF16>();
    if (occ) {
      const long long cell = base + __ffs(occ) - 1;
      occ &= occ - 1;
      const size_t i = static_cast<size_t>(cell) * C + ch0;
      if (C % 2 == 0 && ch0 + 1 < C) {
        pos[u] = *reinterpret_cast<const int2*>(a.argpos + i);
        if constexpr (BF16)
          d[u].v = *reinterpret_cast<const unsigned*>(
              static_cast<const unsigned short*>(a.d_smax) + i);
        else
          d[u].v = *reinterpret_cast<const float2*>(
              static_cast<const float*>(a.d_smax) + i);
      } else {
        for (int j = 0; j < 2; ++j) {
          if (ch0 + j >= C) break;
          (j ? pos[u].y : pos[u].x) = a.argpos[i + j];
          if constexpr (BF16)
            d[u].v |= static_cast<unsigned>(
                          static_cast<const unsigned short*>(a.d_smax)[i + j])
                      << (16 * j);
          else
            (j ? d[u].v.y : d[u].v.x) =
                static_cast<const float*>(a.d_smax)[i + j];
        }
      }
    }
  }
}

template <bool BF16, int A>
__global__ void __launch_bounds__(WARPS * 32, 2) dmmat(Bwd a) {
  constexpr int U = A <= 4 ? 4 : 2;   // cells a step
  __shared__ float red[WARPS][A][64];
  __shared__ float part[A][64];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const int C = a.C, ncells = a.ncells;
  const int ch0 = blockIdx.y * 64 + 2 * lane;
  const long long nchunks = (static_cast<long long>(ncells) + CHUNK - 1) /
                            CHUNK;
  const long long nwarps = static_cast<long long>(gridDim.x) * WARPS;
  // lanes l and l + CHUNK load the count of the chunk's cell l
  const auto count_of = [&](long long chunk) {
    const long long c = chunk * CHUNK + (lane % CHUNK);
    return chunk < nchunks && c < ncells ? a.counts[c] : 0;
  };
  float acc0[A], acc1[A];
#pragma unroll
  for (int k = 0; k < A; ++k) acc0[k] = acc1[k] = 0.0f;
  unsigned occ = 0;
  long long base = 0;
  // one step: gather the rows of the U cells in (pos, d), load the next U
  // cells' argpos and d_smax into (next_pos, next_d), then add the
  // products in cell order
  const auto step = [&](const int2* pos, const DPair<BF16>* d,
                        int2* next_pos, DPair<BF16>* next_d) {
    float g0[U][A], g1[U][A];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      gather<A>(g0[u], a.pts, pos[u].x, a.vec4);
      gather<A>(g1[u], a.pts, pos[u].y, a.vec4);
    }
    take<BF16, U>(occ, base, a, ch0, next_pos, next_d);
    // nothing above waits on a gather: the rounding comes after the loads
    // of the next step are issued
#pragma unroll
    for (int u = 0; u < U; ++u) {
      round_row<BF16, A>(g0[u]);
      round_row<BF16, A>(g1[u]);
#pragma unroll
      for (int k = 0; k < A; ++k) {
        if (pos[u].x >= 0)
          acc0[k] = __fadd_rn(acc0[k], __fmul_rn(d[u].x(), g0[u][k]));
        if (pos[u].y >= 0)
          acc1[k] = __fadd_rn(acc1[k], __fmul_rn(d[u].y(), g1[u][k]));
      }
    }
  };

  long long chunk = static_cast<long long>(blockIdx.x) * WARPS + wib;
  int count = count_of(chunk);
  for (; chunk < nchunks; chunk += nwarps) {
    occ = __ballot_sync(FULL, lane < CHUNK && count > 0);
    base = chunk * CHUNK;
    count = count_of(chunk + nwarps);       // the warp's next counts
    int left = __popc(occ);                 // occupied cells not yet summed
    // two sets of argpos and d_smax, used in turn, so that no step waits
    // on the loads it has just issued
    int2 pos_a[U], pos_b[U];
    DPair<BF16> d_a[U], d_b[U];
    take<BF16, U>(occ, base, a, ch0, pos_a, d_a);
    while (left > 0) {
      step(pos_a, d_a, pos_b, d_b);
      left -= U;
      if (left <= 0) break;
      step(pos_b, d_b, pos_a, d_a);
      left -= U;
    }
  }

  // the block's sum: its warps in a fixed order
#pragma unroll
  for (int k = 0; k < A; ++k) {
    red[wib][k][2 * lane] = acc0[k];
    red[wib][k][2 * lane + 1] = acc1[k];
  }
  __syncthreads();
  for (int o = threadIdx.x; o < A * 64; o += blockDim.x) {
    float v = red[0][o / 64][o % 64];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) v = __fadd_rn(v, red[w][o / 64][o % 64]);
    part[o / 64][o % 64] = v;
  }
  // the cluster's sum, by its rank-0 block, the blocks in rank order
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();   // every block's sum is in
  const bool lead = cluster.block_rank() == 0;
  if (lead) {
    for (int o = threadIdx.x; o < A * 64; o += blockDim.x) {
      const int k = o / 64, ch = blockIdx.y * 64 + o % 64;
      float v = part[k][o % 64];
#pragma unroll
      for (int r = 1; r < CLUSTER; ++r)
        v = __fadd_rn(v, *cluster.map_shared_rank(&part[k][o % 64], r));
      if (ch < C)
        a.partial[(static_cast<size_t>(blockIdx.x / CLUSTER) * A + k) * C +
                  ch] = v;
    }
  }
  cluster.sync();   // the sums are read: a block may exit after this
  if (!lead) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(a.ticket, 1u) ==
           gridDim.x / CLUSTER * gridDim.y - 1;
  __syncthreads();
  if (!last) return;

  // the last cluster's lead: every cluster's partial, in cluster order
  __threadfence();
  const int nb = gridDim.x / CLUSTER;
  const size_t ac = static_cast<size_t>(A) * C;
  for (int o = threadIdx.x; o < A * C; o += blockDim.x) {
    const float* src = a.partial + o;
    float v = 0.0f;
    int b = 0;
    for (; b + 32 <= nb; b += 32) {
      float t[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) t[j] = __ldcg(src + (b + j) * ac);
#pragma unroll
      for (int j = 0; j < 32; ++j) v = __fadd_rn(v, t[j]);
    }
    for (; b < nb; ++b) v = __fadd_rn(v, __ldcg(src + b * ac));
    a.out[o] = v;
  }
  if (threadIdx.x == 0) atomicExch(a.ticket, 0u);
}

template <bool BF16, int A>
cudaError_t launch(const Bwd& a, int blocks, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, (a.C + 63) / 64, 1);
  cfg.blockDim = dim3(WARPS * 32, 1, 1);
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CLUSTER;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, dmmat<BF16, A>, a);
}

template <bool BF16>
cudaError_t launch(const Bwd& a, int A, int blocks, cudaStream_t st) {
  switch (A) {
    case 1: return launch<BF16, 1>(a, blocks, st);
    case 2: return launch<BF16, 2>(a, blocks, st);
    case 3: return launch<BF16, 3>(a, blocks, st);
    case 4: return launch<BF16, 4>(a, blocks, st);
    case 5: return launch<BF16, 5>(a, blocks, st);
    case 6: return launch<BF16, 6>(a, blocks, st);
    case 7: return launch<BF16, 7>(a, blocks, st);
    default: return launch<BF16, 8>(a, blocks, st);
  }
}

}  // namespace

// d_bf16: d_smax is bf16 and both operands round to bf16 (else f32).
// blocks: the grid's blocks of 8 warps, a multiple of 8 (the wrapper's
// `dmmat_blocks`); partial holds blocks / 8 * A * C floats; ticket one
// uint32, 0 between calls.
extern "C" int affine_bwd_dmmat(const void* pts, const void* argpos,
                                const void* d_smax, const void* counts,
                                void* partial, void* ticket, void* out,
                                int ncells, int A, int C, int blocks,
                                int d_bf16, void* stream) {
  if (A < 1 || A > MAX_A || C < 1 || C > 1024 || ncells < 0 || blocks < 1 ||
      blocks % CLUSTER != 0)
    return cudaErrorInvalidValue;
  const Bwd a{static_cast<const float*>(pts), static_cast<const int*>(argpos),
              d_smax, static_cast<const int*>(counts),
              static_cast<float*>(partial), static_cast<unsigned*>(ticket),
              static_cast<float*>(out), ncells, C,
              A == 4 && reinterpret_cast<uintptr_t>(pts) % 16 == 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = d_bf16 ? launch<true>(a, A, blocks, st)
                                 : launch<false>(a, A, blocks, st);
  return err != cudaSuccess ? err : cudaGetLastError();
}
