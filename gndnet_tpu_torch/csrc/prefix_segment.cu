// K8: the row-major fused segmented scan (sums, PFN product, masked max),
// and K9: the segmented prefix-max broadcast along the rows of a (C, N)
// table, for Hopper (sm_90a), each in one kernel launch.
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
// The TPU kernels walk chunks in order on one core and carry the run that
// spans a chunk boundary in scratch; their `chunk` and K8's shortened
// window (`max_prefix`) exist for that walk.  Here blocks run in no order,
// so each block takes a ticket from a global counter and works on the
// tiles in ASCENDING order of ticket: a tile waits only on the tiles before
// it, which took their tickets earlier and so run or are done (K7's
// decoupled look-back, csrc/suffix_segment.cu, run forwards).  A tile
// publishes its aggregate, the in-tile value of its last run: `final` when
// that run starts in the tile, else `aggregate` (the tile is one run that
// goes on from the tile before); a tile whose first run goes on from the
// tile before has warp 0 look over t - 1, t - 2, ... (128 flags a step, 4
// a lane) to the first `final` tile or the first whose `inclusive`
// value (aggregate with its own carry) is out; a whole-run tile then
// publishes its inclusive value.  Publishing: the values, a barrier of
// the threads that wrote them, one st.release.gpu of the flag (the release
// orders every write before the barrier, as CUTLASS's Semaphore::release
// does); reading: ld.acquire.gpu of the flags, the values by ld.global.cg
// (L2).  A chain of whole-run tiles of any
// length (a one-cell stream) resolves.  Each flag holds
// the call's epoch beside its status, so a flag of an earlier call reads
// as not ready, and the block taking the last ticket puts the ticket back
// to 0: no memset, one device operation a call.  Calls on one device share
// the ticket and the flags (ops/affine_aux.py keeps them), so they must be
// ordered on one stream.
//
// K8, one block of 256 threads per (tile of T rows, chunk of 64 channels;
// chunk 0 also takes the 4 sums; one chunk at C = 64): the tile's pts8
// rows and cells are staged in shared memory by 16-byte cp.async, the
// chunk's mmat8 and (bf16) the rows rounded once, a run-start bit a row.
//  - The sums keep the (T, S, L) layout and order of segment.scan_layout,
//    so the plain version (ops/affine_aux.py) is unchanged to the bit: the
//    block's last warp takes one (slice, column) item a lane and runs its
//    L-row slice forwards, 8 rows' terms in registers ahead of the chain;
//    one thread per column walks the slice tails forwards; the carry into
//    a tile is the LEFT fold of the tails before it in the run, ((tail_a +
//    tail_b) + ...), an inclusive value is that same fold, so the look-back
//    gives the same bits whichever status it meets; a row leaves as tcarry
//    + (scarry + v), 16 bytes a row.  f32 in that fixed order, no float
//    atomics, product and sum rounded apart (__fmul_rn, __fadd_rn): the
//    same bits on every run.
//  - The maxima are exact in any order, so the other 7 warps take them at
//    once: a thread owns 4 channels of one segment of T / 14 rows (at C =
//    64) and computes each product as the in-order fma chain (act4).  It
//    first takes the value of its segment's last run from that run's rows
//    alone; 16 threads carry the segments forwards; warp 0 publishes the
//    tile.  Rows past the tile's first run then leave at once, their
//    products computed again (at most two fma passes, against a staged 64
//    KB tile that would hold a block of 256 rows to two a streaming
//    multiprocessor and the profile's 400 tiles to two waves): f32 as
//    float4, bf16 as a lane pair's 8 channels (16 bytes) on alternate rows.
//    Last, the look-back and its fold (maxima
//    by every thread, 16-byte loads; sums from staged windows, in order),
//    and the tile's first run.
//
// K9, one block of 8 warps per (tile of 1024 rows, group of 8 channels),
// a warp per channel: lanes on consecutive rows, a 16-byte streaming load
// of 4 rows a lane, 128 rows a warp step, all 8 steps' loads issued before
// the tile's cells are read.  The block marks the rows that start a run
// (one byte per 4 rows in shared memory, shared by the 8 channels); a step
// is a segmented max over a lane's 4 rows, a 5-step __shfl_up_sync
// segmented max over the lanes, and the run carried in a register from the
// step before.  Max is exact in any order, so each warp folds its
// channel's aggregates 32 at a time.  The first run takes the carry in
// registers and every row leaves once, by 16-byte streaming stores.
//
// Max, in both, is NaN-propagating (max.NaN.f32), as torch.maximum and
// jnp.maximum are.
//
// Bound, each input read once and each output written once: K8 at
// (102 400, 8) x (8, 64) reads 3.7 MB and writes 1.6 MB of sums and 26.2
// MB of f32 maxima (13.1 MB bf16), 9.4 us (5.5 us) at 3.35 TB/s; its 110
// MFLOP are 1.6 us at 67 TFLOP/s.  K9 at (128, 1 605 632) moves 1.65 GB,
// 0.49 ms; reading the cells once per group of 8 channels adds 16 x 4 B a
// row (mostly from L2: a tile's 16 groups take consecutive tickets).  The
// three-pass kernels this replaces spent a third of K8's time in one block
// walking all tile tails in series, and K9's walked a channel's rows one
// thread each, so no load or store of a warp was coalesced (15.2 of 18.2
// ms).  What holds K8 now is latency in series inside a block: all tiles
// run at once, in step, and the stores start only after staging, the two
// chains and the publication (PERF.md, section 6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_W = 2048;
constexpr int MAX_T = 1024;
constexpr int BC_ROWS = 1024;        // K9: rows of a tile
constexpr int BC_WARPS = 8;          // K9: channels of a block, a warp each
constexpr int BC_STEPS = BC_ROWS / 128;
constexpr float BIG_NEG = -3.0e38f;  // pallas_affine._BIG_NEG
constexpr float BIG_NEG_BF16 = -0x1.c4p+127f;   // BIG_NEG rounded to bf16
constexpr unsigned NOT_READY = 0, AGGREGATE = 1, FINAL = 2, INCLUSIVE = 3;
constexpr unsigned FULL = 0xffffffffu;

// the larger of a and b, NaN if either is (as torch.maximum and
// jnp.maximum are); exact, so the order of a max scan does not matter
__device__ __forceinline__ float nanmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

template <bool BF16>
__device__ __forceinline__ float round_out(float v) {
  if (BF16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// the ticket, the flags (one a (chunk, tile), epoch << 2 | status) and
// this call's epoch
struct Sync {
  unsigned* ticket;
  unsigned* flags;
  unsigned epoch;
  unsigned total;   // tickets this launch hands out, one a block
};

// thread 0: the block's ticket; the block taking the last one puts the
// counter back to 0 (every other block has taken its ticket by then)
__device__ __forceinline__ unsigned take_ticket(const Sync& sy) {
  const unsigned k = atomicAdd(sy.ticket, 1u);
  if (k == sy.total - 1) atomicExch(sy.ticket, 0u);
  return k;
}

__device__ __forceinline__ void publish(const Sync& sy, unsigned* flag,
                                        unsigned status) {
  store_release(flag, sy.epoch << 2 | status);
}

// ---------------------------------------------------------------------------
// K8
// ---------------------------------------------------------------------------

constexpr int K8_CHANNELS = 64;   // maxima a block (a chunk), 4 a thread
constexpr int K8_COLS = 4 + K8_CHANNELS;   // scan columns a chunk, at most

struct K8Args {
  const int* cell;    // (n,)
  const float* pts;   // (n, 8)
  const float* mmat;  // (8, C)
  float* tot;         // (n, 4)
  void* amax;         // (n, C) f32 or bf16
  float* agg;         // (nt, W): each tile's aggregate
  float* incl;        // (nt, W): a whole-run tile's inclusive value
  Sync sy;
  long long n;
  int C, W, T, L, chunks, nt;
  bool pts_vec;       // 16-byte loads of pts8
  bool amax_vec;      // run_max's rows on 16-byte boundaries
};

// shared memory of a K8 block: pts8 rows as read and rounded, the sums'
// in-slice prefixes, their slice tails and carries, the
// maxima's segment tails and carries (a float4 a thread), the chunk's
// rounded mmat8, a window of the sums' aggregates, the tile's aggregate
// and carry; then a run-start bit a row, and the cell ids of rows -1..T-1
size_t k8_smem(int T, int L) {
  const int S = (T + L - 1) / L;
  return (20 * static_cast<size_t>(T) + 8 * S + 12 * THREADS +
          8 * K8_CHANNELS + 2 * K8_COLS) * sizeof(float) +
         (T / 32 + 1 + T + 1) * sizeof(int);
}

__device__ __forceinline__ float4 nanmax4(float4 a, float4 b) {
  return make_float4(nanmax(a.x, b.x), nanmax(a.y, b.y), nanmax(a.z, b.z),
                     nanmax(a.w, b.w));
}

// two values rounded to bf16 (one cvt for the pair) and widened back
__device__ __forceinline__ float2 round_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const unsigned u = *reinterpret_cast<const unsigned*>(&h);
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}

// the masked activations of 4 channels of one staged row: the in-order
// fma chain over the row's (rounded) 8 values, rounded to the output type
template <bool BF16>
__device__ __forceinline__ float4 act4(const float* pr, float kept,
                                       const float (&m)[8][4]) {
  const float4 lo = *reinterpret_cast<const float4*>(pr);
  const float4 hi = *reinterpret_cast<const float4*>(pr + 4);
  const float p[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] = fmaf(m[k][j], p[k], acc[j]);
  if (BF16) {
    const float2 a = round_bf16x2(acc[0], acc[1]);
    const float2 b = round_bf16x2(acc[2], acc[3]);
    acc[0] = a.x, acc[1] = a.y, acc[2] = b.x, acc[3] = b.y;
  }
  // the mask value in the output type (max commutes with the rounding)
  const float mask = BF16 ? BIG_NEG_BF16 : BIG_NEG;
  if (!(kept > 0.0f)) return make_float4(mask, mask, mask, mask);
  return make_float4(acc[0], acc[1], acc[2], acc[3]);
}

// 4 consecutive floats (16 bytes where aligned), through L2
__device__ __forceinline__ float4 ldcg4(const float* p, bool vec) {
  if (vec) return __ldcg(reinterpret_cast<const float4*>(p));
  return make_float4(__ldcg(p), __ldcg(p + 1), __ldcg(p + 2), __ldcg(p + 3));
}

// warp: the nearest tile u < t whose value is complete (`final`, or
// `inclusive`), every tile between being out (`aggregate`); its status in
// *status.  4 flags a lane, 128 tiles a step
__device__ int look_back(const Sync& sy, const unsigned* fl, int t,
                         unsigned* status) {
  const int lane = threadIdx.x & 31;
  int waits = 0;
  for (int base = t - 1;;) {
    unsigned f[4], done[4], wait[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int u = base - 32 * j - lane;
      f[j] = FINAL;
      if (u >= 0) {
        const unsigned raw = load_acquire(fl + u);
        f[j] = raw >> 2 == sy.epoch ? (raw & 3u) : NOT_READY;
      }
    }
    bool stall = false, found = false;
    int k = 0, jd = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      done[j] = __ballot_sync(FULL, f[j] >= FINAL);
      wait[j] = __ballot_sync(FULL, f[j] == NOT_READY);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (found) break;
      const unsigned before =
          done[j] ? (done[j] & (0u - done[j])) - 1u : FULL;
      if (wait[j] & before) {
        stall = true;
        break;
      }
      if (done[j]) {
        found = true;
        jd = j;
        k = __ffs(done[j]) - 1;
      }
    }
    if (stall) {
      // tiles before t run or are done, so a wait of seconds is a fault:
      // end the launch with an error rather than hold the card
      if (++waits > (1 << 24)) __trap();
      __nanosleep(32);
      continue;
    }
    if (found) {
      unsigned fj = f[0];
#pragma unroll
      for (int j = 1; j < 4; ++j)
        if (j == jd) fj = f[j];
      *status = __shfl_sync(FULL, fj, k);
      return base - 32 * jd - k;
    }
    base -= 128;                        // 128 aggregates: look further
  }
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS, 4) k8_scan(K8Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned s_ticket, s_status;
  __shared__ int s_end, s_first;
  const int tid = threadIdx.x;
  if (tid == 0) {
    s_ticket = take_ticket(a.sy);
    s_first = a.T;
  }
  __syncthreads();
  const int chunk = s_ticket % a.chunks;
  const int t = s_ticket / a.chunks;
  const int T = a.T, L = a.L, S = (T + L - 1) / L;
  const long long t0 = static_cast<long long>(t) * T;
  const int rows = static_cast<int>(min(static_cast<long long>(T),
                                        a.n - t0));
  const int nslices = (rows + L - 1) / L;
  // the chunk's scan columns: the 4 sums (chunk 0), then its maxima
  const int nsum = chunk == 0 ? 4 : 0;
  const int cm0 = chunk * K8_CHANNELS;                 // first channel
  const int cbm = min(K8_CHANNELS, a.C - cm0);
  const long long colbase = chunk == 0 ? 0 : 4 + cm0;  // in agg's rows
  // the maxima's items: segment g of RS rows, channels 4q .. 4q + 3, on
  // every warp but the last (the sums')
  const int NQ = (cbm + 3) / 4, NG = (THREADS - 32) / NQ;
  const int RS = (T + NG - 1) / NG;
  const int q = tid % NQ, g = tid / NQ;
  const int rs0 = min(g * RS, rows), rs1 = g < NG ? min(rs0 + RS, rows) : rs0;

  float* spts = reinterpret_cast<float*>(smem);        // T * 8
  float* sptsr = spts + 8 * T;                         // T * 8, rounded
  float* ssum = sptsr + 8 * T;                         // T * 4
  float* stail = ssum + 4 * T;                         // S * 4
  float* scarry = stail + 4 * S;                       // S * 4
  float4* mtail = reinterpret_cast<float4*>(scarry + 4 * S);   // THREADS
  float4* mcarry = mtail + THREADS;                    // THREADS
  float* smm = reinterpret_cast<float*>(mcarry + THREADS);  // 8 x 64
  float* swin = smm + 8 * K8_CHANNELS;                 // 4 * THREADS
  float* srun = swin + 4 * THREADS;                    // K8_COLS
  float* stcarry = srun + K8_COLS;                     // K8_COLS
  unsigned* shead = reinterpret_cast<unsigned*>(stcarry + K8_COLS);
  int* scell = reinterpret_cast<int*>(shead + T / 32 + 1) + 1;  // T + 1
  unsigned* flags = a.sy.flags + static_cast<long long>(chunk) * a.nt;

  // pts8's rows by 16-byte cp.async, in flight while the cells and the
  // chunk's mmat8 load
  const float* gp = a.pts + t0 * 8;
  if (a.pts_vec) {
    const unsigned sh =
        static_cast<unsigned>(__cvta_generic_to_shared(spts));
    for (int i = tid; i < rows * 2; i += THREADS)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                       sh + 16 * i),
                   "l"(gp + 4 * i)
                   : "memory");
    asm volatile("cp.async.commit_group;" ::: "memory");
  } else {
    for (int i = tid; i < rows * 8; i += THREADS) spts[i] = gp[i];
  }
  for (int r = tid - 1; r < rows; r += THREADS)
    if (r >= 0 || t > 0) scell[r] = a.cell[t0 + r];
  for (int i = tid; i < 8 * K8_CHANNELS; i += THREADS) {
    const int k = i / K8_CHANNELS, c = i - k * K8_CHANNELS;
    smm[i] = c < cbm ? round_out<BF16>(__ldg(a.mmat + k * a.C + cm0 + c))
                     : 0.0f;
  }
  if (a.pts_vec) asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
  const bool tcont = t > 0 && scell[-1] == scell[0];
  const bool whole = scell[0] == scell[rows - 1];
  const int prev = tcont ? scell[-1] : 0;
  // per row: the run-start bit (row 0 never), the product's rounded
  // operands; the first run start in the tile
  if (tid <= T / 32) shead[tid] = 0;
  __syncthreads();
  for (int r = tid; r < (rows + 31) / 32 * 32; r += THREADS) {
    const bool head = r > 0 && r < rows && scell[r] != scell[r - 1];
    const unsigned bits = __ballot_sync(FULL, head);
    if ((tid & 31) == 0) shead[r / 32] = bits;
    if (bits && (tid & 31) == 0) atomicMin(&s_first, r + __ffs(bits) - 1);
  }
  if (BF16) {
    for (int i = tid; i < rows * 4; i += THREADS) {
      const float2 v = round_bf16x2(spts[2 * i], spts[2 * i + 1]);
      sptsr[2 * i] = v.x;
      sptsr[2 * i + 1] = v.y;
    }
  }
  __syncthreads();
  const float* pa = BF16 ? sptsr : spts;   // the product's operands
  // the tile's first run, which takes the carry from the tiles before:
  // rows [0, first) where it goes on from the tile before
  const int first = tcont ? min(s_first, rows) : 0;
  const float ninf = -__int_as_float(0x7f800000);
  const float4 none = make_float4(ninf, ninf, ninf, ninf);
  // this thread's 4 channels of the rounded mmat8, read where a product
  // loop starts so that they take no registers outside it
  auto load_m = [&](float(&m)[8][4]) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const unsigned sh = static_cast<unsigned>(
          __cvta_generic_to_shared(smm + k * K8_CHANNELS + 4 * q));
      asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                   : "=f"(m[k][0]), "=f"(m[k][1]), "=f"(m[k][2]),
                     "=f"(m[k][3])
                   : "r"(sh));
    }
  };
  auto is_head = [&](int r) { return (shead[r >> 5] >> (r & 31)) & 1u; };

  // the sums, by the last warp while the others take the maxima: one
  // (slice, column) item a lane in the (T, S, L) order, each row the f32
  // prefix of its run in the slice, 8 rows' terms and run-start bits in
  // registers ahead of the chain
  if (tid >= THREADS - 32 && nsum) {
    for (int i = tid - (THREADS - 32); i < 4 * nslices; i += 32) {
      const int s = i / 4, c = i % 4;
      const int r0 = s * L, r1 = min(r0 + L, rows);
      float v = 0.0f;
      for (int rb = r0; rb < r1; rb += 8) {
        float x[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int r = min(rb + k, r1 - 1);
          x[k] = __fmul_rn(spts[r * 8 + c], spts[r * 8 + 3]);
        }
        const unsigned hb = static_cast<unsigned>(
            (static_cast<unsigned long long>(shead[(rb >> 5) + 1]) << 32 |
             shead[rb >> 5]) >> (rb & 31)) | (rb == r0);
        if (rb + 8 <= r1) {             // a whole batch: no test a row
#pragma unroll
          for (int k = 0; k < 8; ++k)
            x[k] = v = (hb >> k & 1) ? x[k] : __fadd_rn(v, x[k]);
#pragma unroll
          for (int k = 0; k < 8; ++k) ssum[(rb + k) * 4 + c] = x[k];
        } else {
          for (int k = 0; rb + k < r1; ++k) {
            v = (hb >> k & 1) ? x[k] : __fadd_rn(v, x[k]);
            ssum[(rb + k) * 4 + c] = v;
          }
        }
      }
      stail[s * 4 + c] = v;
    }
  }
  // the maxima, in any order (max is exact): each segment's value of its
  // last run, from the rows of that run alone
  if (rs0 < rs1) {
    int rl = rs1 - 1;
    while (rl > rs0 && !is_head(rl)) --rl;
    float m[8][4];
    load_m(m);
    float4 v = none;
    for (int r = rl; r < rs1; ++r)
      v = nanmax4(v, act4<BF16>(pa + r * 8, spts[r * 8 + 3], m));
    mtail[tid] = v;
  }
  __syncthreads();

  // carries inside the tile, forwards: the sums' slices (left fold of the
  // tails, as the plain version), the maxima's segments
  if (tid < nsum) {
    float prv = 0.0f;
    for (int k = 0; k < nslices; ++k) {
      const int r0 = k * L, r1 = min(r0 + L, rows);
      const bool cont = k > 0 && !is_head(r0);
      const float tail = stail[k * 4 + tid];
      scarry[k * 4 + tid] = prv;
      prv = (cont && scell[r0] == scell[r1 - 1]) ? __fadd_rn(prv, tail)
                                                 : tail;
    }
    srun[tid] = prv;
  } else if (tid >= 32 && tid < 32 + NQ) {
    const int qq = tid - 32;
    float4 prv = none;
    for (int k = 0; k < NG && k * RS < rows; ++k) {
      const int r0 = k * RS, r1 = min(r0 + RS, rows);
      const bool cont = k > 0 && !is_head(r0);
      const float4 tail = mtail[k * NQ + qq];
      mcarry[k * NQ + qq] = prv;
      prv = (cont && scell[r0] == scell[r1 - 1]) ? nanmax4(prv, tail) : tail;
    }
    *reinterpret_cast<float4*>(srun + nsum + 4 * qq) = prv;
  }
  __syncthreads();
  const int cbw = nsum + cbm;
  if (tid < 32) {
    for (int c = tid; c < cbw; c += 32)
      a.agg[static_cast<long long>(t) * a.W + colbase + c] = srun[c];
    __syncwarp();
    if (tid == 0)
      publish(a.sy, flags + t, tcont && whole ? AGGREGATE : FINAL);
  }

  const int ch0 = cm0 + 4 * q;
  const bool full = 4 * q + 4 <= cbm;
  const bool pair = BF16 && a.amax_vec && NQ % 2 == 0 && cbm % 8 == 0;
  const unsigned pmask = 3u << ((tid & 31) & ~1);
  // rows [ra, rb) of this thread's segment out, v the value before ra
  auto max_out = [&](int ra, int rb, float4 v) {
    float m[8][4];
    load_m(m);
    for (int r = ra; r < rb; ++r) {
      const float4 x = act4<BF16>(pa + r * 8, spts[r * 8 + 3], m);
      v = is_head(r) ? x : nanmax4(v, x);
      const long long o = (t0 + r) * a.C + ch0;
      if (!BF16) {
        float* dst = static_cast<float*>(a.amax) + o;
        if (full && a.amax_vec) {
          *reinterpret_cast<float4*>(dst) = v;
        } else {
          const float pv[4] = {v.x, v.y, v.z, v.w};
          for (int j = 0; j < 4 && 4 * q + j < cbm; ++j) dst[j] = pv[j];
        }
      } else {
        __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(a.amax) + o;
        // bf16 values already: the high halves of their f32 bits
        const unsigned w0 = __byte_perm(__float_as_uint(v.x),
                                        __float_as_uint(v.y), 0x7632);
        const unsigned w1 = __byte_perm(__float_as_uint(v.z),
                                        __float_as_uint(v.w), 0x7632);
        if (pair) {
          // lanes q (even) and q + 1 hold one row's 8 channels: the even
          // lane stores the even rows, the odd lane the odd
          const unsigned o0 = __shfl_xor_sync(pmask, w0, 1);
          const unsigned o1 = __shfl_xor_sync(pmask, w1, 1);
          const bool odd = q & 1;
          if ((r & 1) == static_cast<int>(odd)) {
            const uint4 st = odd ? make_uint4(o0, o1, w0, w1)
                                 : make_uint4(w0, w1, o0, o1);
            *reinterpret_cast<uint4*>(dst - (odd ? 4 : 0)) = st;
          }
        } else {
          const unsigned pv[2] = {w0, w1};
          for (int j = 0; j < 4 && 4 * q + j < cbm; ++j)
            reinterpret_cast<unsigned short*>(dst)[j] =
                static_cast<unsigned short>(pv[j / 2] >> (16 * (j % 2)));
        }
      }
    }
  };
  // the sums of rows [ra, rb) out: tcarry + (scarry + v), 16 bytes a row
  auto sums_out = [&](int ra, int rb) {
    for (int r = ra + tid; r < rb; r += THREADS) {
      const int s = r / L;
      const bool sfix = s > 0 && scell[r] == scell[s * L - 1];
      const bool tfix = r < first;
      float v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        v[c] = ssum[r * 4 + c];
        if (sfix) v[c] = __fadd_rn(scarry[s * 4 + c], v[c]);
        if (tfix) v[c] = __fadd_rn(stcarry[c], v[c]);
      }
      *reinterpret_cast<float4*>(a.tot + (t0 + r) * 4) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  };

  // the rows past the tile's first run need no carry from other tiles:
  // out at once, while the tiles before finish
  if (nsum) sums_out(first, rows);
  const int ra = max(rs0, first);
  if (ra < rs1)
    max_out(ra, rs1, ra > rs0 || !(rs0 > 0 && !is_head(rs0))
                         ? none : mcarry[tid]);
  if (!tcont) return;

  // the carry into the tile: the far end's value with the aggregates
  // after it; maxima in any order, 16 bytes a load, every thread; the sums
  // folded from the left, THREADS aggregates staged at a time
  if (tid < 32) {
    unsigned st;
    const int u = look_back(a.sy, flags, t, &st);
    if (tid == 0) {
      s_end = u;
      s_status = st;
    }
  }
  __syncthreads();
  const int u = s_end;
  const float* term = (s_status == INCLUSIVE ? a.incl : a.agg) +
                      static_cast<long long>(u) * a.W + colbase;
  const float* after = a.agg + static_cast<long long>(u + 1) * a.W + colbase;
  const int na = t - 1 - u;
  const bool vec = a.W % 4 == 0 && (colbase + nsum) % 4 == 0;
  {
    float4 v = none;
    for (int k = g; k < na; k += NG)
      v = nanmax4(v, ldcg4(after + static_cast<long long>(k) * a.W + nsum +
                           4 * q, vec));
    mtail[tid] = v;
  }
  float sum = tid < nsum ? __ldcg(term + tid) : 0.0f;
  for (int b = 0; b < na && nsum; b += THREADS) {
    const int cnt = min(THREADS, na - b);
    for (int i = tid; i < cnt * 4; i += THREADS)
      swin[i] = __ldcg(after + static_cast<long long>(b + i / 4) * a.W +
                       i % 4);
    __syncthreads();
    if (tid < 4)
      for (int k = 0; k < cnt; ++k) sum = __fadd_rn(sum, swin[k * 4 + tid]);
    __syncthreads();
  }
  __syncthreads();
  if (tid < nsum) {
    stcarry[tid] = sum;
    if (whole)
      a.incl[static_cast<long long>(t) * a.W + colbase + tid] =
          __fadd_rn(sum, srun[tid]);
  } else if (tid >= 32 && tid < 32 + NQ) {
    const int qq = tid - 32;
    float4 c = ldcg4(term + nsum + 4 * qq, vec);
    for (int k = 0; k < NG; ++k) c = nanmax4(c, mtail[k * NQ + qq]);
    *reinterpret_cast<float4*>(stcarry + nsum + 4 * qq) = c;
    if (whole) {
      const float4 r = nanmax4(
          c, *reinterpret_cast<const float4*>(srun + nsum + 4 * qq));
      const float pv[4] = {r.x, r.y, r.z, r.w};
      for (int j = 0; j < 4 && 4 * qq + j < cbm; ++j)
        a.incl[static_cast<long long>(t) * a.W + colbase + nsum + 4 * qq +
               j] = pv[j];
    }
  }
  __syncthreads();
  if (whole && tid == 0) publish(a.sy, flags + t, INCLUSIVE);

  // the tile's first run out, from the carries
  if (nsum) sums_out(0, first);
  if (rs0 < min(rs1, first)) {
    float4 v = rs0 > 0 && !is_head(rs0) ? mcarry[tid] : none;
    v = nanmax4(v, *reinterpret_cast<const float4*>(stcarry + nsum + 4 * q));
    max_out(rs0, min(rs1, first), v);
  }
}

template <bool BF16>
cudaError_t k8_launch(const K8Args& a, cudaStream_t st) {
  const size_t smem = k8_smem(a.T, a.L);
  static size_t allowed = 48 * 1024;   // above this only by attribute
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        k8_scan<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  k8_scan<BF16><<<a.chunks * a.nt, THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K9
// ---------------------------------------------------------------------------

struct K9Args {
  const int* cell;    // (n,)
  const float* vals;  // (C, n)
  float* out;         // (C, n)
  float* agg;         // (nt, C)
  float* incl;        // (nt, C)
  Sync sy;
  long long n;
  int C, groups, nt;
  bool vec;           // n % 4 == 0, vals and out 16-byte aligned
};

__device__ __forceinline__ float4 load4(const float* p, int r, int rows,
                                        bool vec) {
  if (vec && r + 4 <= rows)
    return __ldcs(reinterpret_cast<const float4*>(p + r));
  const float ninf = -__int_as_float(0x7f800000);
  float4 v = make_float4(ninf, ninf, ninf, ninf);
  if (r < rows) v.x = __ldcs(p + r);
  if (r + 1 < rows) v.y = __ldcs(p + r + 1);
  if (r + 2 < rows) v.z = __ldcs(p + r + 2);
  if (r + 3 < rows) v.w = __ldcs(p + r + 3);
  return v;
}

__device__ __forceinline__ void store4(float* p, int r, int rows, bool vec,
                                       float4 v) {
  if (vec && r + 4 <= rows) {
    __stcs(reinterpret_cast<float4*>(p + r), v);
    return;
  }
  if (r < rows) __stcs(p + r, v.x);
  if (r + 1 < rows) __stcs(p + r + 1, v.y);
  if (r + 2 < rows) __stcs(p + r + 2, v.z);
  if (r + 3 < rows) __stcs(p + r + 3, v.w);
}

__global__ void __launch_bounds__(BC_WARPS * 32)
    k9_broadcast(K9Args a) {
  __shared__ unsigned char sheads[BC_ROWS / 4];   // bit k: row 4q + k
  __shared__ unsigned s_ticket, s_status;
  __shared__ int s_first, s_end;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    s_ticket = take_ticket(a.sy);
    s_first = BC_ROWS;
  }
  __syncthreads();
  const int g = s_ticket % a.groups;
  const int t = s_ticket / a.groups;
  const int ch = g * BC_WARPS + warp;
  const bool live = ch < a.C;
  const long long t0 = static_cast<long long>(t) * BC_ROWS;
  const int rows = static_cast<int>(min(static_cast<long long>(BC_ROWS),
                                        a.n - t0));
  const float* src = a.vals + static_cast<long long>(live ? ch : 0) * a.n +
                     t0;
  const float ninf = -__int_as_float(0x7f800000);

  // the channel's rows first: 16 bytes a lane, all steps in flight
  float4 x[BC_STEPS];
#pragma unroll
  for (int j = 0; j < BC_STEPS; ++j)
    x[j] = live ? load4(src, j * 128 + 4 * lane, rows, a.vec)
                : make_float4(ninf, ninf, ninf, ninf);

  // the rows that start a run (row 0 of the tile never: the tile's first
  // run starts there, and takes the carry where it goes on from the tile
  // before), one byte per 4 rows, and the first such row
  for (int qd = threadIdx.x; qd < BC_ROWS / 4; qd += blockDim.x) {
    const int r = 4 * qd;
    unsigned bits = 0;
    int first = BC_ROWS;
    if (r < rows) {
      int prv = r > 0 ? a.cell[t0 + r - 1] : 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (r + k < rows) {
          const int c = a.cell[t0 + r + k];
          if (r + k > 0 && c != prv) {
            bits |= 1u << k;
            first = min(first, r + k);
          }
          prv = c;
        }
      }
    }
    sheads[qd] = static_cast<unsigned char>(bits);
    if (first < BC_ROWS) atomicMin(&s_first, first);
  }
  const bool tcont = t > 0 && a.cell[t0 - 1] == a.cell[t0];
  __syncthreads();
  const int first = s_first;
  const bool whole = first == BC_ROWS;

  // the tile's steps in order: in-lane, across the warp, then the run
  // carried from the step before
  float run = ninf;
#pragma unroll
  for (int j = 0; j < BC_STEPS; ++j) {
    const unsigned h = sheads[j * 32 + lane];
    const float4 v = x[j];
    const float y1 = (h & 2) ? v.y : nanmax(v.x, v.y);
    const float y2 = (h & 4) ? v.z : nanmax(y1, v.z);
    const float y3 = (h & 8) ? v.w : nanmax(y2, v.w);
    float agg = y3;
    bool fl = h != 0;                 // the lane's last run starts in it
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float oa = __shfl_up_sync(FULL, agg, d);
      const bool of = __shfl_up_sync(FULL, static_cast<int>(fl), d);
      if (lane >= d && !fl) {
        agg = nanmax(oa, agg);
        fl = of;
      }
    }
    float pin = __shfl_up_sync(FULL, agg, 1);
    const bool pfl = __shfl_up_sync(FULL, static_cast<int>(fl), 1);
    if (lane == 0) pin = run;
    else if (!pfl) pin = nanmax(run, pin);
    float4 z;
    z.x = (h & 1) ? v.x : nanmax(pin, v.x);
    z.y = (h & 2) ? v.y : nanmax(z.x, v.y);
    z.z = (h & 4) ? v.z : nanmax(z.y, v.z);
    z.w = (h & 8) ? v.w : nanmax(z.z, v.w);
    x[j] = z;
    run = __shfl_sync(FULL, z.w, 31);
  }

  // publish the aggregate: rows past the stream are -inf and start no
  // run, so `run` is the value at the tile's last row
  unsigned* flags = a.sy.flags + static_cast<long long>(g) * a.nt;
  if (live && lane == 0) a.agg[static_cast<long long>(t) * a.C + ch] = run;
  __syncthreads();
  if (threadIdx.x == 0)
    publish(a.sy, flags + t, tcont && whole ? AGGREGATE : FINAL);

  if (tcont) {
    if (warp == 0) {
      unsigned st;
      const int u = look_back(a.sy, flags, t, &st);
      if (lane == 0) {
        s_end = u;
        s_status = st;
      }
    }
    __syncthreads();
    float carry = ninf;
    if (live) {
      const int u = s_end;
      if (lane == 0) {
        const float* term = s_status == INCLUSIVE ? a.incl : a.agg;
        carry = __ldcg(term + static_cast<long long>(u) * a.C + ch);
      }
      for (int k = u + 1 + lane; k < t; k += 32)
        carry = nanmax(carry,
                       __ldcg(a.agg + static_cast<long long>(k) * a.C + ch));
#pragma unroll
      for (int d = 16; d > 0; d >>= 1)
        carry = nanmax(carry, __shfl_xor_sync(FULL, carry, d));
      if (whole && lane == 0)
        a.incl[static_cast<long long>(t) * a.C + ch] = nanmax(carry, run);
    }
    __syncthreads();
    if (whole && threadIdx.x == 0) publish(a.sy, flags + t, INCLUSIVE);
    // the tile's first run, rows [0, first), takes the carry
#pragma unroll
    for (int j = 0; j < BC_STEPS; ++j) {
      const int r = j * 128 + 4 * lane;
      if (r < first) {
        float4& z = x[j];
        z.x = nanmax(carry, z.x);
        if (r + 1 < first) z.y = nanmax(carry, z.y);
        if (r + 2 < first) z.z = nanmax(carry, z.z);
        if (r + 3 < first) z.w = nanmax(carry, z.w);
      }
    }
  }
  if (!live) return;
  float* dst = a.out + static_cast<long long>(ch) * a.n + t0;
#pragma unroll
  for (int j = 0; j < BC_STEPS; ++j)
    store4(dst, j * 128 + 4 * lane, rows, a.vec, x[j]);
}

bool aligned16(const void* p) {
  return reinterpret_cast<size_t>(p) % 16 == 0;
}

}  // namespace

// cell (n,) int32, equal ids contiguous; pts8 (n, 8) f32; mmat8 (8, C) f32;
// tot (n, 4) f32 (16-byte aligned); amax (n, C) f32, or bf16 when
// out_bf16; tile from ops/affine_aux.py `k8_layout`; scratch 2 * ceil(n /
// tile) * (4 + C) floats; sync the ticket (0 between calls) then ceil(C /
// 64) * ceil(n / tile) flags; epoch this call's (>= 1, < 2^30, above every
// flag's).
extern "C" int affine_segment_scan(const void* cell, const void* pts8,
                                   const void* mmat8, void* tot, void* amax,
                                   void* scratch, void* sync, long long n,
                                   int C, int tile, int epoch, int out_bf16,
                                   void* stream) {
  const int W = C + 4;
  const int S = max(1, min(THREADS / max(W, 1), tile));
  if (n < 1 || C < 1 || W > MAX_W || tile < 1 || tile > MAX_T ||
      4 * S > THREADS || epoch < 1 || epoch >= (1 << 30) || !aligned16(tot))
    return cudaErrorInvalidValue;
  K8Args a;
  a.cell = static_cast<const int*>(cell);
  a.pts = static_cast<const float*>(pts8);
  a.mmat = static_cast<const float*>(mmat8);
  a.tot = static_cast<float*>(tot);
  a.amax = amax;
  a.n = n;
  a.C = C;
  a.W = W;
  a.T = tile;
  a.L = (tile + S - 1) / S;
  a.chunks = (C + K8_CHANNELS - 1) / K8_CHANNELS;
  a.nt = static_cast<int>((n + tile - 1) / tile);
  a.agg = static_cast<float*>(scratch);
  a.incl = a.agg + static_cast<long long>(a.nt) * W;
  a.sy.ticket = static_cast<unsigned*>(sync);
  a.sy.flags = a.sy.ticket + 1;
  a.sy.epoch = static_cast<unsigned>(epoch);
  a.sy.total = static_cast<unsigned>(a.chunks * a.nt);
  a.pts_vec = aligned16(pts8);
  a.amax_vec = aligned16(amax) && C * (out_bf16 ? 2 : 4) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return out_bf16 ? k8_launch<true>(a, st) : k8_launch<false>(a, st);
}

// cell (n,) int32, equal ids contiguous; vals, out (C, n) f32; scratch
// 2 * ceil(n / 1024) * C floats; sync the ticket (0 between calls) then
// ceil(C / 8) * ceil(n / 1024) flags; epoch as for affine_segment_scan.
extern "C" int segment_broadcast_t(const void* cell, const void* vals,
                                   void* out, void* scratch, void* sync,
                                   long long n, int C, int epoch,
                                   void* stream) {
  if (n < 1 || C < 1 || C > MAX_W || epoch < 1 || epoch >= (1 << 30))
    return cudaErrorInvalidValue;
  K9Args a;
  a.cell = static_cast<const int*>(cell);
  a.vals = static_cast<const float*>(vals);
  a.out = static_cast<float*>(out);
  a.n = n;
  a.C = C;
  a.groups = (C + BC_WARPS - 1) / BC_WARPS;
  a.nt = static_cast<int>((n + BC_ROWS - 1) / BC_ROWS);
  a.agg = static_cast<float*>(scratch);
  a.incl = a.agg + static_cast<long long>(a.nt) * C;
  a.sy.ticket = static_cast<unsigned*>(sync);
  a.sy.flags = a.sy.ticket + 1;
  a.sy.epoch = static_cast<unsigned>(epoch);
  a.sy.total = static_cast<unsigned>(a.groups * a.nt);
  a.vec = n % 4 == 0 && aligned16(vals) && aligned16(out);
  k9_broadcast<<<a.groups * a.nt, BC_WARPS * 32, 0,
                 static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
