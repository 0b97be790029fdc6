// K7: suffix segmented max or sum over a cell-sorted stream, for Hopper
// (sm_90a), in one launch.
//
// Replaces gndnet_tpu/ops/pallas_segment.py `suffix_segment_reduce` (body
// `_kernel`):
//   out[i, :] = reduce(x[j, :] for j >= i while cell[j] == cell[i])
// for every row i, with reduce max or sum.  `cell` is any non-decreasing
// int32 stream (the sorted frontend also passes a flipped, negated one), so
// no id is reserved as a sentinel.
//
// x (N, C) f32 (max or sum) or bf16 (max), row-major; cell (N,) int32;
// out (N, C) in x's type; scratch: heads and inclusive values (ceil(N / T),
// C) f32 each, and 1 + chunks * ceil(N / T) int32 flags, zeroed by the
// entry's one cudaMemsetAsync.
//
// The TPU kernel walks the chunks in reverse on one core and carries the
// partial first run of the later chunk in scratch.  Blocks of the card run
// in no order, so each block (one tile of T rows, one chunk of columns)
// takes a ticket from a global counter and works on the tiles in
// DESCENDING order of ticket: a tile waits only on tiles after it, which
// took their tickets earlier and so are running or done (a decoupled
// look-back, run backwards):
//   1. the tile and its cells are staged in shared memory, in x's type,
//      by 16-byte cp.async copies all in flight at once; one (slice,
//      column) item a thread scans its L-row slice backwards, then one
//      thread per column walks the slice heads backwards to carry each
//      run into the slice before it;
//   2. the tile publishes its head, the in-tile reduction of its first
//      run: `final` when that run ends in the tile (or at its end), else
//      `aggregate` (the whole tile is one run that goes on);
//   3. rows outside the tile's last run are written at once; if that run
//      continues into tile t + 1, warp 0 looks over t + 1, t + 2, ... 32
//      flags a step, one lane each, to the first `final` tile or the first
//      whose `inclusive` value (head with its own carry) is out, and the
//      threads fold the heads from the far end: head[t+1] + (head[t+2] +
//      (... + v)).  An inclusive value is that same right fold, so the
//      result has the same bits whichever status the look-back meets;
//   4. a whole-run tile publishes its inclusive value, and the last run's
//      rows are written with the carry added on the right.
// The items add their carries in shared memory, and rows leave by 16-byte
// stores.
// Publishing: values, __threadfence(), barrier, then one st.release.gpu of
// the flag; reading: ld.acquire.gpu of the flags, barrier, and values by
// ld.global.cg (L2), so no stale L1 line is read.  A chain of whole-run
// tiles of any length (the drop run, a one-cell stream) resolves, 32 tiles
// a look-back step.
// Sums are f32 in a fixed order (backwards within a slice, then slice and
// tile carries added on the right), no float atomics: the same bits on
// every run, and the plain version (ops/segment.py) repeats that order to
// the bit.  Max is exact in either type; bf16 is staged as bf16 (a max
// of bf16 values is one of them).
//
// Bound: each input read once and the output written once.  At the sorted
// frontend's shapes (102 400 rows): max over 64 f32 columns moves 52.8 MB,
// about 16 us at 3.35 TB/s; each 4-column sum 3.7 MB, about 1.1 us.  One
// launch reads x and the cells once and writes out once; the look-back
// moves (tiles in the run) x C floats through L2.  The three-pass kernel
// it replaces spent most of its time in one block walking all tile heads
// serially, and in the launches themselves.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_C = 2048;
constexpr int MAX_T = 1024;
constexpr int STAGE_FLOATS = 16384;   // staged tile: T x chunk columns
constexpr int NOT_READY = 0, AGGREGATE = 1, FINAL = 2, INCLUSIVE = 3;
constexpr unsigned FULL = 0xffffffffu;

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

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

template <bool BF16>
struct Elt {
  using T = float;
  __device__ static float get(float v) { return v; }
  __device__ static float put(float v) { return v; }
};

template <>
struct Elt<true> {   // max only: every value is an input value, exact
  using T = __nv_bfloat16;
  __device__ static float get(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 put(float v) {
    return __float2bfloat16_rn(v);
  }
};

struct Layout {
  long long n;
  int C, T, L, cols, chunks, nt;
  bool vec;   // one chunk, rows of 16-byte multiples, x and out aligned
};

template <bool MAX, bool BF16>
__global__ void __launch_bounds__(THREADS)
    suffix_scan(const void* __restrict__ xv, const int* __restrict__ cell,
                void* __restrict__ outv, float* heads, float* incl,
                int* flags, Layout lay) {
  using E = Elt<BF16>;
  using V = typename E::T;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_ticket, s_end, s_status;
  const V* x = static_cast<const V*>(xv);
  V* out = static_cast<V*>(outv);
  const int C = lay.C, T = lay.T, L = lay.L;
  if (threadIdx.x == 0) s_ticket = atomicAdd(flags, 1);
  __syncthreads();
  const int chunk = s_ticket % lay.chunks;
  const int t = lay.nt - 1 - s_ticket / lay.chunks;
  const int c0 = chunk * lay.cols;
  const int cb = min(lay.cols, C - c0);
  int* tflags = flags + 1 + static_cast<long long>(chunk) * lay.nt;
  const long long t0 = static_cast<long long>(t) * T;
  const int rows = static_cast<int>(min(static_cast<long long>(T),
                                        lay.n - t0));
  const int nslices = (rows + L - 1) / L;
  const int S = (T + L - 1) / L;

  V* tile = reinterpret_cast<V*>(smem);                       // T * cb
  float* shead = reinterpret_cast<float*>(
      smem + (T * cb * sizeof(V) + 15) / 16 * 16);            // S * cb
  float* scarry = shead + S * cb;                             // S * cb
  float* s_head = scarry + S * cb;                            // cb
  float* s_carry = s_head + cb;                               // cb
  int* scell = reinterpret_cast<int*>(s_carry + cb);          // T + 1

  // the tile into shared memory: where rows are contiguous and aligned,
  // 16-byte cp.async copies, all in flight at once
  const int per = cb * static_cast<int>(sizeof(V)) / 16;   // 16 B a row
  if (lay.vec) {
    const unsigned sh =
        static_cast<unsigned>(__cvta_generic_to_shared(tile));
    const char* gl = reinterpret_cast<const char*>(x + t0 * C);
    for (int i = threadIdx.x; i < rows * per; i += blockDim.x)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                       sh + 16 * i),
                   "l"(gl + 16 * static_cast<long long>(i))
                   : "memory");
    asm volatile("cp.async.commit_group;" ::: "memory");
  } else {
    for (int e = threadIdx.x; e < rows * cb; e += blockDim.x) {
      const int r = e / cb;
      tile[e] = x[(t0 + r) * C + c0 + (e - r * cb)];
    }
  }
  for (int r = threadIdx.x; r <= rows; r += blockDim.x)
    if (r < rows || t + 1 < lay.nt) scell[r] = cell[t0 + r];
  if (lay.vec) asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
  // tile rows [ra, rb) out, 16 bytes a thread where they can be
  auto write = [&](int ra, int rb) {
    if (lay.vec) {
      const uint4* sh = reinterpret_cast<const uint4*>(tile);
      uint4* gl = reinterpret_cast<uint4*>(out + t0 * C);
#pragma unroll 4
      for (int i = ra * per + threadIdx.x; i < rb * per; i += blockDim.x)
        gl[i] = sh[i];
    } else {
      for (int e = ra * cb + threadIdx.x; e < rb * cb; e += blockDim.x) {
        const int r = e / cb;
        out[(t0 + r) * C + c0 + (e - r * cb)] = tile[e];
      }
    }
  };

  // one (slice, column) item a thread (the entry checks S * cols <=
  // THREADS): its slice backwards, each row the suffix partial of its run
  // in the slice
  const int s = threadIdx.x / cb, c = threadIdx.x - s * cb;
  const bool item = s < nslices;
  const int r0 = s * L, r1 = item ? min(r0 + L, rows) : r0;
  V* col = tile + c;                                          // row r: r * cb
  if (item) {
    float v = 0.0f;
#pragma unroll 4
    for (int r = r1 - 1; r >= r0; --r) {
      const float xr = E::get(col[r * cb]);
      v = (r == r1 - 1 || scell[r] != scell[r + 1]) ? xr
                                                     : combine<MAX>(xr, v);
      col[r * cb] = E::put(v);
    }
    shead[s * cb + c] = v;
  }
  __syncthreads();

  // slice heads, backwards: carry into slice s = the full in-tile value of
  // slice s+1's first run; the tile's head is slice 0's full first run
  const bool whole = scell[0] == scell[rows - 1];
  const bool cont = t + 1 < lay.nt && scell[rows - 1] == scell[rows];
  if (threadIdx.x < cb) {
    float nxt = 0.0f;
    for (int k = nslices - 1; k >= 0; --k) {
      const int a = k * L, b = min(a + L, rows);
      const bool scont = k + 1 < nslices && scell[b - 1] == scell[b];
      const float head = shead[k * cb + threadIdx.x];
      scarry[k * cb + threadIdx.x] = nxt;
      nxt = (scont && scell[a] == scell[b - 1]) ? combine<MAX>(head, nxt)
                                                 : head;
    }
    s_head[threadIdx.x] = nxt;
    heads[static_cast<long long>(t) * C + c0 + threadIdx.x] = nxt;
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    store_release(&tflags[t], whole && cont ? AGGREGATE : FINAL);

  // the slice carry, on the right, onto the slice's last run where it goes
  // on into the next slice
  if (item && s + 1 < nslices && scell[r1 - 1] == scell[r1]) {
    const float carry = scarry[s * cb + c];
    for (int r = r1 - 1; r >= r0 && scell[r] == scell[r1]; --r)
      col[r * cb] = E::put(combine<MAX>(E::get(col[r * cb]), carry));
  }
  // the tile's last run, when it goes on past the tile: rows [tail, rows)
  int tail = rows;
  if (cont) {
    const int last = scell[rows];
    int lo = 0, hi = rows - 1;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (scell[mid] < last) lo = mid + 1; else hi = mid;
    }
    tail = lo;
  }
  __syncthreads();
  write(0, tail);
  if (!cont) return;

  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int waits = 0;
    for (int base = t + 1;;) {
      const int u = base + lane;
      const int f = u < lay.nt ? load_acquire(&tflags[u]) : FINAL;
      const unsigned done = __ballot_sync(FULL, f >= FINAL);
      const unsigned wait = __ballot_sync(FULL, f == NOT_READY);
      const unsigned before = done ? (done & (0u - done)) - 1u : FULL;
      if (wait & before) {              // a tile before the end not out
        // tiles after t run or are done, so a wait of seconds is a fault:
        // end the launch with an error rather than hold the card
        if (++waits > (1 << 24)) __trap();
        __nanosleep(32);
        continue;
      }
      if (done) {
        const int k = __ffs(done) - 1;
        if (lane == k) {
          s_end = u;
          s_status = f;
        }
        break;
      }
      base += 32;                       // 32 aggregates: look further
    }
  }
  __syncthreads();
  // the far end's value, folded with the heads before it from the right
  if (threadIdx.x < cb) {
    const long long k = c0 + threadIdx.x;
    const float* term = s_status == INCLUSIVE ? incl : heads;
    float v = __ldcg(&term[static_cast<long long>(s_end) * C + k]);
    for (int u = s_end - 1; u > t; --u)
      v = combine<MAX>(__ldcg(&heads[static_cast<long long>(u) * C + k]), v);
    s_carry[threadIdx.x] = v;
    if (whole) {
      incl[static_cast<long long>(t) * C + k] =
          combine<MAX>(s_head[threadIdx.x], v);
      __threadfence();
    }
  }
  __syncthreads();
  if (whole && threadIdx.x == 0) store_release(&tflags[t], INCLUSIVE);
  if (item) {
    const float carry = s_carry[c];
    for (int r = max(r0, tail); r < r1; ++r)
      col[r * cb] = E::put(combine<MAX>(E::get(col[r * cb]), carry));
  }
  __syncthreads();
  write(tail, rows);
}

size_t smem_bytes(int T, int L, int cols, bool bf16) {
  const int S = (T + L - 1) / L;
  return (T * cols * (bf16 ? 2 : 4) + 15) / 16 * 16 +
         (2 * S * cols + 2 * cols) * sizeof(float) + (T + 1) * sizeof(int);
}

template <bool MAX, bool BF16>
cudaError_t launch(const void* x, const int* cell, void* out, float* heads,
                   float* incl, int* flags, const Layout& lay,
                   cudaStream_t st) {
  const size_t smem = smem_bytes(lay.T, lay.L, lay.cols, BF16);
  static size_t allowed = 48 * 1024;   // above this only by attribute
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        suffix_scan<MAX, BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  const cudaError_t err = cudaMemsetAsync(
      flags, 0, (1 + static_cast<size_t>(lay.chunks) * lay.nt) * sizeof(int),
      st);
  if (err != cudaSuccess) return err;
  suffix_scan<MAX, BF16><<<lay.chunks * lay.nt, THREADS, smem, st>>>(
      x, cell, out, heads, incl, flags, lay);
  return cudaGetLastError();
}

}  // namespace

// is_max: 1 max, 0 sum; x_bf16: x and out are bf16 (max only), else f32.
// cols: columns a block stages (tile * cols <= 16384; C when it fits).
// scratch: 2 * ceil(n / tile) * C floats, then 1 + ceil(C / cols) *
// ceil(n / tile) ints.
extern "C" int suffix_segment_reduce(const void* x, const void* cell,
                                     void* out, void* scratch, long long n,
                                     int C, int tile, int cols, int is_max,
                                     int x_bf16, void* stream) {
  const int S = max(1, min(THREADS / max(C, 1), tile));
  if (n < 1 || C < 1 || C > MAX_C || tile < 1 || tile > MAX_T || cols < 1 ||
      cols > C || static_cast<long long>(tile) * cols > STAGE_FLOATS ||
      S * cols > THREADS || (x_bf16 && !is_max))
    return cudaErrorInvalidValue;
  Layout lay;
  lay.n = n;
  lay.C = C;
  lay.T = tile;
  lay.L = (tile + S - 1) / S;
  lay.cols = cols;
  lay.chunks = (C + cols - 1) / cols;
  lay.nt = static_cast<int>((n + tile - 1) / tile);
  lay.vec = lay.chunks == 1 && C * (x_bf16 ? 2 : 4) % 16 == 0 &&
            reinterpret_cast<size_t>(x) % 16 == 0 &&
            reinterpret_cast<size_t>(out) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(cell);
  float* heads = static_cast<float*>(scratch);
  float* incl = heads + static_cast<long long>(lay.nt) * C;
  int* flags =
      reinterpret_cast<int*>(incl + static_cast<long long>(lay.nt) * C);
  if (!is_max)
    return launch<false, false>(x, c, out, heads, incl, flags, lay, st);
  if (x_bf16)
    return launch<true, true>(x, c, out, heads, incl, flags, lay, st);
  return launch<true, false>(x, c, out, heads, incl, flags, lay, st);
}
