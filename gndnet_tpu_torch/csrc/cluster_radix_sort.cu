// K1 and K10: stable LSD radix sort of int32 keys (K1) or of int32 (hi, lo)
// pairs (K10), run entirely inside one thread-block cluster, in one launch,
// for Hopper (sm_90a).
//
// Replaces gndnet_tpu/ops/pallas_sort.py `bitonic_sort_i32` (K1, entry
// `sort_padded_i32`) and `bitonic_sort2_i32` (K10, entry
// `sort2_padded_i32`).  The TPU kernels run a bitonic network over keys
// resident in VMEM.  On the card that network (csrc/bitonic_sort.cu,
// csrc/bitonic_sort2.cu) needs 21 dependent launches at 102 400 keys padded
// to 131 072, and O(n log^2 n) compare-exchanges.
//
// What bounds the sort is not bytes: at the main path's 102 400 keys the
// function must read and write 0.8 MB (K1) or 1.6 MB (K10), 0.25 / 0.49 us
// at 3.35 TB/s.  It is the chain of dependent steps (launches, passes,
// barriers) and the integer work of ranking.  This design takes one launch
// and a fixed number of passes:
//   * G CTAs of one cluster hold all keys and a ping-pong buffer in their
//     shared memory; they reach each other's through distributed shared
//     memory (DSMEM).  Global memory is read once (CTA r loads its
//     contiguous slice) and written once (each CTA stores its slice of the
//     result).  G is the smallest power of two whose CTAs hold n keys,
//     widened up to 16 while a CTA would hold more than SPREAD keys: a
//     pass costs a CTA time in proportion to its keys, and the card has
//     SMs to spare.
//   * Keys become unsigned keys whose unsigned order is the wanted order:
//     int32 x -> uint32(x) ^ 2^31; a pair -> (uint32(hi) ^ 2^31) << 32 |
//     (uint32(lo) ^ 2^31).  Both words get the flip: a radix sort compares
//     unsigned digits, so a negative hi must not sort last.
//   * 8-bit digits, least significant first: at most 4 passes for int32,
//     8 for pairs.  Each pass: every warp counts its keys' digits; the CTA's
//     histogram goes to shared memory; cluster barrier; every CTA reads all
//     G histograms through DSMEM and forms each bucket's start (the earlier
//     buckets over all CTAs plus the same bucket in lower-ranked CTAs);
//     every key gets its stable position (warps in order, within a warp 32
//     keys a round in key order, ranked with one ballot per digit bit and a
//     per-warp running bucket count) and is stored to that slot in the
//     destination CTA's buffer through DSMEM; cluster barrier; the buffers
//     swap.
//   * A digit where one bucket holds all n keys is skipped.  That is a
//     digit where the AND and the OR of all keys agree: each CTA reduces
//     its slice while it loads, and after one cluster barrier every CTA
//     reads all of them, so all skip the same passes and pass the same
//     barriers.
//   * Keys already in order in their low bits need only a stable sort by
//     the bits above, and the passes start there.  The low bits are lo for
//     pairs (fine_grid's stream iota) and, for int32 keys, the
//     bit_length(n - 1) bits where cell_stream's packed keys hold the
//     stream index.  The load checks each slice and the key before it, and
//     the flags travel with the AND and OR.  So kitti_sem's packed keys
//     take 2 passes (bits 17-24, 25-31) and fine_grid's pairs 2 (hi's two
//     low bytes).
//   * Stability of every pass is what makes LSD correct; equal keys need
//     nothing more.
//
// Capacity: a CTA of 512 threads holds its slice twice (8 bytes a key for
// int32, 16 for pairs) beside 18 496 bytes of counters, within the 232 448
// bytes of shared memory an H100 block may opt into: 26 744 int32 keys or
// 13 372 pairs a CTA, 427 904 and 213 952 for the cluster of 16
// (ops/sort.py RADIX_MAX_I32 / RADIX_MAX_PAIRS).  The C entries return
// cudaErrorInvalidValue above that, and an error when the cluster cannot
// be scheduled on the device (cudaOccupancyMaxActiveClusters); the wrappers
// send longer inputs to the bitonic kernels by a fixed size rule.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int RADIX = 256;
constexpr int MAX_CLUSTER = 16;
constexpr int SPREAD = 4096;
constexpr int SMEM_BYTES = 232448;  // an H100 block's opt-in shared memory
constexpr int RUN_STRIDE = WARPS + 1;  // run[digit][warp], padded
// hist [RADIX], run [RADIX][RUN_STRIDE], wsum [8], bits [8]: 32-bit words
constexpr int FIXED_BYTES = (RADIX + RADIX * RUN_STRIDE + 16) * 4;
constexpr unsigned FULL = 0xffffffffu;

constexpr int cta_keys(int key_bytes) {  // the src and dst buffers
  return (SMEM_BYTES - FIXED_BYTES) / (2 * key_bytes);
}
static_assert(FIXED_BYTES % 16 == 0, "key buffers stay 16-byte aligned");
static_assert(cta_keys(4) == 26744 && cta_keys(8) == 13372,
              "ops/sort.py states these capacities");

// Each key type: its load into an unsigned key, its store back, and the
// word whose low bits may already be in order (`low`, as unsigned order).
struct I32 {
  using Key = uint32_t;
  static __device__ __forceinline__ Key load(const int* a, const int*,
                                             int i) {
    return static_cast<uint32_t>(a[i]) ^ 0x80000000u;
  }
  static __device__ __forceinline__ unsigned low(const int* a, const int*,
                                                 int i) {
    return static_cast<uint32_t>(a[i]) ^ 0x80000000u;
  }
  static __device__ __forceinline__ void store(int* a, int*, int i, Key k) {
    a[i] = static_cast<int>(k ^ 0x80000000u);
  }
};

struct Pair {
  using Key = unsigned long long;
  static __device__ __forceinline__ Key load(const int* hi, const int* lo,
                                             int i) {
    return (static_cast<Key>(static_cast<uint32_t>(hi[i]) ^ 0x80000000u)
            << 32) |
           (static_cast<uint32_t>(lo[i]) ^ 0x80000000u);
  }
  static __device__ __forceinline__ unsigned low(const int*, const int* lo,
                                                 int i) {
    return static_cast<uint32_t>(lo[i]) ^ 0x80000000u;
  }
  static __device__ __forceinline__ void store(int* hi, int* lo, int i,
                                               Key k) {
    hi[i] = static_cast<int>(static_cast<uint32_t>(k >> 32) ^ 0x80000000u);
    lo[i] = static_cast<int>(static_cast<uint32_t>(k) ^ 0x80000000u);
  }
};

template <typename Key>
__device__ __forceinline__ unsigned digit(Key k, int shift) {
  return static_cast<unsigned>(k >> shift) & (RADIX - 1);
}

// The lanes among `valid` whose digit equals this lane's, from one ballot
// per digit bit (__match_any_sync is far slower on this card).
__device__ __forceinline__ unsigned same_digit(unsigned d, unsigned valid) {
  unsigned peers = valid;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const bool bit = (d >> b) & 1u;
    const unsigned set = __ballot_sync(FULL, bit);
    peers &= bit ? set : ~set;
  }
  return peers;
}

// a, b: the input words (b unused for I32); out_a, out_b: the sorted words;
// CTA r of the cluster owns positions [r * per, min(n, (r + 1) * per)).
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    radix_kernel(const int* __restrict__ a, const int* __restrict__ b,
                 int* __restrict__ out_a, int* __restrict__ out_b, int n,
                 unsigned per) {
  using Key = typename T::Key;
  constexpr int KEY_BITS = 8 * sizeof(Key);
  constexpr int HALVES = sizeof(Key) / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* hist = reinterpret_cast<unsigned*>(smem);  // read by the cluster
  unsigned* run = hist + RADIX;
  unsigned* wsum = run + RADIX * RUN_STRIDE;
  // the CTA's AND and OR of its keys' words, and whether the low bits
  // descend anywhere in its slice; read by the cluster
  unsigned* bits = wsum + 8;
  Key* src = reinterpret_cast<Key*>(smem + FIXED_BYTES);
  Key* dst = src + per;

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const unsigned ctas = cluster.num_blocks();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int begin = static_cast<int>(rank * per);
  const int len = max(0, min(n - begin, static_cast<int>(per)));
  // The low bits that may already be in order: lo for pairs (the stream
  // iota), for int32 keys the bit_length(n - 1) bits where cell_stream's
  // packed keys hold the stream index.
  const int low_bits = HALVES == 2 ? 32 : (n > 1 ? 32 - __clz(n - 1) : 0);
  const unsigned low_mask = low_bits >= 32 ? FULL : (1u << low_bits) - 1u;

  // load, with the AND and the OR of this CTA's keys and whether their low
  // bits descend anywhere in the slice (or from the key before it)
  if (tid <= 2 * HALVES)
    bits[tid] = (tid & 1) || tid == 2 * HALVES ? 0u : FULL;
  __syncthreads();
  Key k_and = ~Key(0), k_or = 0;
  bool descends = false;
  for (int i = tid; i < len; i += THREADS) {
    const Key k = T::load(a, b, begin + i);
    src[i] = k;
    k_and &= k;
    k_or |= k;
    if (begin + i > 0)
      descends |= (T::low(a, b, begin + i - 1) & low_mask) >
                  (T::low(a, b, begin + i) & low_mask);
  }
  if (__any_sync(FULL, descends) && lane == 0)
    atomicOr(&bits[2 * HALVES], 1u);
#pragma unroll
  for (int h = 0; h < HALVES; ++h) {
    const unsigned wa =
        __reduce_and_sync(FULL, static_cast<unsigned>(k_and >> (32 * h)));
    const unsigned wo =
        __reduce_or_sync(FULL, static_cast<unsigned>(k_or >> (32 * h)));
    if (lane == 0) {
      atomicAnd(&bits[2 * h], wa);
      atomicOr(&bits[2 * h + 1], wo);
    }
  }
  cluster.sync();
  // Which passes run, the same in every CTA.  A digit is constant over all
  // n keys (one bucket holds them all) exactly where the AND and the OR of
  // the keys agree.  Keys whose low bits are all in order need only a
  // stable sort by the bits above: the passes start there.
  Key vary = 0;
  bool low_in_order;
  {
    const bool mine = lane < ctas;  // lane r reads CTA r's words
    const unsigned* rb = cluster.map_shared_rank(bits, mine ? lane : 0);
#pragma unroll
    for (int h = 0; h < HALVES; ++h) {
      const unsigned wa = __reduce_and_sync(FULL, mine ? rb[2 * h] : FULL);
      const unsigned wo = __reduce_or_sync(FULL, mine ? rb[2 * h + 1] : 0u);
      vary |= static_cast<Key>(wa ^ wo) << (32 * h);
    }
    low_in_order = !__any_sync(FULL, mine && rb[2 * HALVES]);
  }
  const int first_shift = low_in_order ? low_bits : 0;

  // each warp owns a contiguous run of the slice, 32 keys a round, so lane
  // order within a round and round order are key order
  const int wlen = (len + THREADS - 1) / THREADS * 32;
  const int wbeg = warp * wlen;
  const int wend = min(len, wbeg + wlen);
  const int rounds = wlen / 32;
  const unsigned lanes_below = (1u << lane) - 1u;
  // pos / per = umulhi(pos, magic) >> 8 for pos < 2^19 <= 2^40 / per; a
  // lone CTA has per < 2^8 possible, and every pos / per = 0
  const unsigned magic =
      ctas > 1 ? static_cast<unsigned>(((1ull << 40) + per - 1) / per) : 0u;

  for (int shift = first_shift; shift < KEY_BITS; shift += 8) {
    if (digit(vary, shift) == 0) continue;  // a constant digit
    // sweep 1: this warp's digit counts, in its own column of run
    for (int d = lane; d < RADIX; d += 32) run[d * RUN_STRIDE + warp] = 0;
    __syncwarp();
    for (int i = wbeg + lane; i < wend; i += 32)
      atomicAdd(&run[digit(src[i], shift) * RUN_STRIDE + warp], 1u);
    __syncthreads();
    // per digit: the count in the warps below each warp, and the CTA's
    if (tid < RADIX) {
      unsigned* r = run + tid * RUN_STRIDE;
      unsigned s = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const unsigned c = r[w];
        r[w] = s;
        s += c;
      }
      hist[tid] = s;
    }
    cluster.sync();
    // every CTA: the bucket totals over the cluster, the same bucket in the
    // CTAs below this one, and the exclusive scan of the totals
    unsigned total = 0, below = 0, incl = 0;
    if (tid < RADIX) {
      unsigned c[MAX_CLUSTER];  // all G loads in flight at once
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r)
        c[r] = r < ctas ? cluster.map_shared_rank(hist, r)[tid] : 0u;
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r) {
        total += c[r];
        if (r < rank) below += c[r];
      }
      incl = total;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned y = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += y;
      }
      if (lane == 31) wsum[warp] = incl;
    }
    __syncthreads();
    // run[d][w] becomes where warp w's first key of digit d goes
    if (tid < RADIX) {
      unsigned start = incl - total + below;
      for (int w = 0; w < warp; ++w) start += wsum[w];
      unsigned* r = run + tid * RUN_STRIDE;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) r[w] += start;
    }
    __syncthreads();
    // sweep 2: the stable position of every key, and its store to that
    // slot through DSMEM.  Integer issue bounds this loop, so it spends few
    // instructions: the last lane of each digit group moves the warp's
    // counter, and the destination CTA is pos / per by a multiply-high.
    for (int j = 0; j < rounds; ++j) {
      const int first = wbeg + j * 32;
      const int left = wend - first;
      const unsigned valid =
          left >= 32 ? FULL : (left > 0 ? (1u << left) - 1u : 0u);
      const bool in = (valid >> lane) & 1u;
      const Key key = in ? src[first + lane] : Key(0);
      const unsigned d = digit(key, shift);
      const unsigned peers = same_digit(d, valid);
      unsigned* r = &run[d * RUN_STRIDE + warp];
      const unsigned pos = (in ? *r : 0u) + __popc(peers & lanes_below);
      __syncwarp();
      if (in) {
        if ((peers >> lane) == 1u) *r = pos + 1;  // no peer above
        const unsigned to = __umulhi(pos, magic) >> 8;
        cluster.map_shared_rank(dst, to)[pos - to * per] = key;
      }
      __syncwarp();
    }
    cluster.sync();
    Key* t = src;
    src = dst;
    dst = t;
  }
  for (int i = tid; i < len; i += THREADS)
    T::store(out_a, out_b, begin + i, src[i]);
  // other CTAs may still read this CTA's bits (when no pass ran)
  cluster.sync();
}

// Once per kernel: the opt-in shared memory and clusters of 16.
template <typename T>
cudaError_t prepare() {
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(
        radix_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        radix_kernel<T>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }();
  return err;
}

cudaLaunchConfig_t config(int g, size_t smem, cudaStream_t st,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g, 1, 1);
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

// Whether a cluster of g CTAs with all of their shared memory can be
// scheduled on the current device; asked once per cluster size.
template <typename T>
cudaError_t schedulable(int g, bool* ok) {
  static int known[MAX_CLUSTER + 1] = {};  // 0 unknown, 1 yes, 2 no
  if (!known[g]) {
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = config(g, SMEM_BYTES, nullptr, &attr);
    int clusters = 0;
    const cudaError_t e =
        cudaOccupancyMaxActiveClusters(&clusters, radix_kernel<T>, &cfg);
    if (e != cudaSuccess) return e;
    known[g] = clusters > 0 ? 1 : 2;
  }
  *ok = known[g] == 1;
  return cudaSuccess;
}

template <typename T>
int sort_keys(const int* a, const int* b, int* out_a, int* out_b, int n,
              cudaStream_t st) {
  constexpr int cap = cta_keys(sizeof(typename T::Key));
  if (n < 1 || n > MAX_CLUSTER * cap) return cudaErrorInvalidValue;
  // the smallest cluster that holds n keys, widened to 16 CTAs while each
  // would hold more than SPREAD keys: a pass costs a CTA time in
  // proportion to its keys
  int g = 1;
  while (g * cap < n || (g < MAX_CLUSTER && g * SPREAD < n)) g <<= 1;
  cudaError_t err = prepare<T>();
  if (err != cudaSuccess) return err;
  bool ok = false;
  err = schedulable<T>(g, &ok);
  if (err != cudaSuccess) return err;
  if (!ok) return cudaErrorLaunchOutOfResources;
  const unsigned per = static_cast<unsigned>((n + g - 1) / g);
  const size_t smem = FIXED_BYTES + 2 * per * sizeof(typename T::Key);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(g, smem, st, &attr);
  err = cudaLaunchKernelEx(&cfg, radix_kernel<T>, a, b, out_a, out_b, n, per);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
int capacity() {
  constexpr int cap = cta_keys(sizeof(typename T::Key));
  cudaError_t err = prepare<T>();
  if (err != cudaSuccess) return -static_cast<int>(err);
  for (int g = MAX_CLUSTER; g >= 1; g >>= 1) {
    bool ok = false;
    err = schedulable<T>(g, &ok);
    if (err != cudaSuccess) return -static_cast<int>(err);
    if (ok) return g * cap;
  }
  return 0;
}

}  // namespace

// K1: keys, out: n int32 on the device, 1 <= n <= 395 136.
extern "C" int cluster_radix_sort_i32(const void* keys, void* out, int n,
                                      void* stream) {
  return sort_keys<I32>(static_cast<const int*>(keys), nullptr,
                        static_cast<int*>(out), nullptr, n,
                        static_cast<cudaStream_t>(stream));
}

// K10: hi, lo, hi_out, lo_out: n int32 on the device, 1 <= n <= 197 568.
extern "C" int cluster_radix_sort2_i32(const void* hi, const void* lo,
                                       void* hi_out, void* lo_out, int n,
                                       void* stream) {
  return sort_keys<Pair>(static_cast<const int*>(hi),
                         static_cast<const int*>(lo),
                         static_cast<int*>(hi_out),
                         static_cast<int*>(lo_out), n,
                         static_cast<cudaStream_t>(stream));
}

// The most keys (key_bytes 4) or pairs (8) one launch sorts on the current
// device: the largest schedulable cluster times a CTA's capacity; 0 when no
// cluster fits, -cudaError on a failed query.
extern "C" int cluster_radix_sort_capacity(int key_bytes) {
  if (key_bytes == 4) return capacity<I32>();
  if (key_bytes == 8) return capacity<Pair>();
  return -static_cast<int>(cudaErrorInvalidValue);
}
