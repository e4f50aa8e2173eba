// K1's and K9's pass on the tensor cores, over bf16 rows with the query
// rounded to bf16 (the bf16 serving mirror's distance: csrc/l2_topk.cu's
// round_q entry points, csrc/approx_topk.cu's rounded pool and K14's stage
// 1 on the filter route of tile_filter.cuh), over f32 rows (K1 and K3 on the f32 mirror,
// K8's tile step, K9's pool on the f32 mirror) and over bf16 rows with an
// f32 query (K3 on a bf16 mirror, the calibration oracle's blocks).
//
// d(q, x) = max(|q|^2 - 2 q'.x + x_sq, 0) with f32 sums, |q|^2 from the
// f32 query, x_sq as given (or the rows' norms), or by metric (common.cuh's
// metric_dist: cosine, dot) from the same product. The route (KIND) sets
// q' and how the product is taken:
//  * TC_RQ: q' = bf16(q), one bf16 product (exact in f32): the reference's
//    bf16 compute (ops/distance.py _matmul, q.astype(bf16) x bf16 rows, f32
//    accumulation) inside index/fused.py flat_search_kernel,
//    flat_search_approx_kernel and stage1_select_kernel.
//  * TC_TF32X3 (f32 rows): q' = q at f32 accuracy from three TF32 products.
//    Each operand is split x = big + small, big = tf32(x), small = tf32(x -
//    big) (x - big is exact in f32); big.big + big.small + small.big go to
//    f32 sums, and the dropped small.small and small's rounding are about
//    2^-22 of each product. One TF32 product would keep ~3 digits; TF32
//    stays off everywhere else (utils/device.py).
//  * TC_BF16X3 (bf16 rows, euclidean): q' = q exactly: q = hi + mid + lo,
//    three bf16 parts (each the round of what the ones before leave, the
//    split of csrc/project_rows.cu), three bf16 products exact in f32.
// Rows where the mask is False never enter; results by (distance, row),
// padded with (+inf, -1). What comes out is what l2_tile.cuh's FMA pass
// computes for the same arguments, up to the order of the f32 sums (and,
// for TC_TF32X3, the ~2^-22 above).
//
// What bounds it on the H100: at B = 128 over 1,048,576 x 384 bf16 rows
// the products are 103 GFLOP, 0.104 ms at the tensor cores' 989 TFLOP/s
// (1.54 ms at the 67 TFLOP/s of f32 FMA, where l2_tile.cuh runs them),
// against 805 MB of rows, 0.240 ms at 3.35 TB/s: one read of the rows
// bounds it. f32 rows at B = 1,024 over 131,072 x 384 (K3) take 3 x 103
// GFLOP of TF32 products, 0.62 ms at 495 TFLOP/s, against 201 MB (0.06 ms)
// read once a query tile: the products bound it there.
//
// Design:
//  * A block is two consumer warpgroups and a producer warpgroup, which
//    hands most of its registers to the consumers (setmaxnreg: 232 a
//    consumer thread, not the 168 that 384 threads leave). A tile is 128
//    consecutive rows, a step 128 bytes of each (64 bf16 or 32 f32 dims):
//    one producer lane's TMA copies each step as it lies into a ring of
//    128-byte-swizzled slots (16 KB, up to 8), counted on the slot's "full"
//    barrier; each consumer warp arrives on its "empty" barrier when its
//    products are done with it (TC_TF32X3: once its fragments are in
//    registers).
//  * The rows are the wgmma's M side (a warpgroup takes 64 of the tile),
//    the block's QW queries its N side (QW = 8, 32, 64 or 128, so one
//    query is 8 columns, not 32): each query is prepared once (rounded,
//    or split into its parts) and staged whole (all of D) in shared memory
//    as the B operand, one tile a part. f32 rows are the A operand from
//    registers: each thread reads its fragment of the slot and splits it
//    there, so no second tile of rows is written. Past the LISTS epilogue
//    it reads and splits the next step's while the tensor cores take this
//    step's products (two sets of fragments, which the 232 registers hold:
//    at 168 the compiler serialized the products and the pass ran ~30%
//    slower; with the lists it did so even at 232, so LISTS reads each
//    step before its products).
//  * The tensor cores cut their sums to f32 instead of rounding them, so
//    each step is summed from zero and then added to f32 registers (as
//    csrc/project_rows.cu does with its windows); the split routes sum the
//    small products in accumulators of their own, and TC_TF32X3 takes
//    each k8 product of its big parts from zero (four accumulators a
//    step), so no big product is cut at a partial sum's size.
//  * The epilogue reads each distance from the accumulator fragment, with
//    x_sq and the mask of its row; nothing goes through shared memory but
//    what a list keeps.
//  * A host-side plan (ops/topk.py tile_plan) picks QW, the ring's stages
//    and the shared-memory bytes from (B, k, D, mode, route); the grid is
//    query tiles x row slices (x round ranges) sized to one wave at a block
//    an SM. The tensor map of the rows is encoded once per (pointer, N, D,
//    row type) and kept.
//  * TMA needs 16-byte rows: D % 8 == 0 for bf16 rows, D % 4 == 0 for f32.
//    Other D take l2_tile.cuh's FMA pass, chosen by shape and counted
//    apart; so does D past 8,192 (2,048 for the split routes, whose staged
//    parts take more room), where the staged queries would crowd the ring
//    out.
//
// The four epilogues:
//  * LISTS (K1, k <= 256): a (distance key << 32 | row) list a query in
//    shared memory, sorted, and a bar a query: its list's k-th key once
//    full, lowered to the k-th that any slice's list of the query has
//    published (an atomicMin on bars [B] in global memory, re-read once a
//    tile) and, from k = 32 up, to the largest of the slices' j-th keys,
//    j = ceil(k / S) (each slice publishes its own; the slices' first j
//    hold at least k keys, so the k-th is no larger; a warp re-reads them
//    for one of its queries a tile). A distance enters a staging buffer
//    of 32 a query only under its bar; once 16 are staged (and at the
//    slice's end), one warp merges them into the list in registers
//    (bitonic networks, below), the queries to merge dealt round-robin to
//    the 8 warps. A query whose staging filled offers the rest again after
//    the merge, under the new bar. l2_tile.cuh's l2_topk_merge merges the
//    slices' lists.
//    scripts/bf16_tile_variants.py times the pass without the offers or
//    without the merges and counts a call's merges and their cycles.
//  * DUMP (K1, k > 256): the masked distances (+inf where the mask is
//    False) go to a [B, N] buffer straight from the fragment (a warp
//    writes whole 32-byte sectors), and topk_select.cuh's radix select
//    follows.
//  * BINS (K9, on routes TC_RQ and TC_TF32X3): row r is in bin r mod M. A block owns 128 bins and a range
//    of rounds (round i: rows i M + j0 .., contiguous); a bin's rows only
//    grow from round to round, so a strict < keep its smallest (distance,
//    row), and a thread keeps its bins' running distance and round in
//    registers. At the end one atomicMin a (query, bin) folds the packed
//    key into [B, M].
//  * FILTER (K14's stage 1, K1 on f32 rows at k >= 128): survivors as
//    filtered_select.cuh's keys (distance, row) in a buffer [B, cap] a
//    query. With a bar, a distance at or below its query's bar survives:
//    it is staged in shared memory (64 a query, a shared atomic), and every 4 tiles a query's staged
//    keys go out once 32 are staged (all at the slice's end; a full
//    staging sends a key to a slot of its own) into slots that the block
//    reserved for the query, chunk at a time by one global atomic on its
//    count (the rest of a reservation padded with (+inf, -1)): the counts
//    are B addresses that every block adds to, and an atomic a key (or a
//    flush) queued there and held the pass several times over. A count
//    past cap is an overflow, counted once a query. Without a bar every row taken is a slot: the
//    key (or (+inf, -1) where the mask is False) at the row's place, no
//    atomics. With tstride > 1 the pass takes every tstride-th tile of 128
//    rows only, with the same arithmetic at the same place of the tile and
//    the same query column, so its distances are bit-identical to the
//    whole pass's (tile_filter.cuh's sample).
#pragma once

#include <mutex>

#include "common.cuh"
#include "l2_tile.cuh"
#include "wgmma.cuh"

namespace fvdb {

constexpr int TC_ROWS = 128;                  // rows a tile: 2 warpgroups
constexpr int TC_K = 64;                      // bf16 dims a step: 128 bytes
constexpr int TC_STEP_BYTES = TC_ROWS * TC_K * 2;  // a ring slot: 16 KB
constexpr int TC_CONSUMERS = 256;             // two warpgroups
constexpr int TC_THREADS = TC_CONSUMERS + 128;  // and a producer warpgroup
// registers a thread after setmaxnreg: a sub-partition holds two consumer
// warps and one producer warp of the block, 3 x 168 registers at launch
// (__launch_bounds__ of 384 threads), 2 x 232 + 40 after
constexpr int TC_CONSUMER_REGS = 232;
constexpr int TC_PRODUCER_REGS = 40;
constexpr int TC_CAP = 32;        // staged keys a query at most
constexpr int TC_MERGE_AT = 16;   // staged keys that call for a merge
constexpr int TC_PUB_LOADS = 5;   // the slices' j-th keys a lane reads:
                                  // the bar from them takes S <= 160
constexpr int TC_MAX_STAGES = 8;
constexpr int TC_MAX_K = 256;
constexpr int TC_FCAP = 64;       // FILTER: staged keys a query at most,
constexpr int TC_FLUSH_AT = 32;   // the staged keys that call for a flush,
constexpr int TC_FLUSH_EVERY = 4;  // and the tiles between flush rounds
// dynamic shared memory a launch may take: the static barriers take 1 KB
// (padded to the dynamic array's 1,024-byte alignment)
constexpr int TC_SMEM_LIMIT = 232448 - 1024;
constexpr int SEL_FILTER = 3;     // survivors under a bar (l2_tile.cuh's
                                  // SEL_LISTS, _DUMP and _BINS besides)

// The routes (KIND): bf16 rows with the query rounded; f32 rows by three
// TF32 products; bf16 rows with an f32 query split in three bf16 parts.
constexpr int TC_RQ = 0;
constexpr int TC_TF32X3 = 1;
constexpr int TC_BF16X3 = 2;

// TC_TF32X3 under these epilogues and widths reads each step's fragments
// before its products (one set of registers); under the others it reads
// the next step's while the tensor cores take this step's (two sets). The
// lists, and BINS' running minima at 32 queries a block, leave no room for
// a second set: ptxas serialized the products there (K9 on f32 rows at B
// = 128 over 1M x 384: 4.88 ms with two sets, 2.95 ms with one; at 8
// queries two sets are ~6% faster, scripts/time_tile_routes.py --split
// k9f32 on an H100).
__host__ __device__ constexpr bool tf32_one_set(int mode, int qw) {
  return mode == SEL_LISTS || (mode == SEL_BINS && qw > 8);
}

// Staged query parts of a route, and the dims a step (128 bytes of a row).
__host__ __device__ constexpr int tc_parts(int kind) {
  return kind == TC_RQ ? 1 : kind == TC_TF32X3 ? 2 : 3;
}
__host__ __device__ constexpr int tc_step_dims(int kind) {
  return kind == TC_TF32X3 ? 32 : TC_K;
}

// FILTER's arguments: query b's bar at bar[b * bar_ld] (null: no bar,
// every row taken a slot: surv [B, cap >= rows taken]); survivors surv [B,
// cap] keys counted in cnt [B] (zero on entry), a block reserving chunk
// slots of a query at a time (the unused rest padded); overflow counts the
// queries whose count passed cap; every tstride-th tile.
struct FilterArgs {
  const float* bar = nullptr;
  long long bar_ld = 0;
  unsigned long long* surv = nullptr;
  int* cnt = nullptr;
  int cap = 0;
  int* overflow = nullptr;
  int tstride = 1;
  int chunk = 1;
};

// Dynamic shared-memory bytes of a launch (ops/topk.py tile_plan computes
// the same): alignment slack, the ring, the staged queries (D in steps of
// 128 bytes, 128 bytes a query a step a part), |q|^2, for LISTS the lists,
// the staging, bars, counts and fills, and for FILTER the bars, the
// staging and its counts.
inline long long tc_smem_bytes(int qw, int D, int mode, int k, int stages,
                               int kind = TC_RQ) {
  const long long ks = (D + tc_step_dims(kind) - 1) / tc_step_dims(kind);
  long long b = 1024 + (long long)stages * TC_STEP_BYTES +
                ks * qw * 128 * tc_parts(kind) + qw * 4LL;
  if (mode == SEL_LISTS) b += (long long)qw * (8LL * k + 8 * TC_CAP + 16);
  if (mode == SEL_FILTER) b += (long long)qw * (8 * TC_FCAP + 16);
  return b;
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}
// A barrier of the consumers that also tells each whether any has `pred`.
__device__ __forceinline__ bool consumers_any(bool pred) {
  int out;
  asm volatile(
      "{\n.reg .pred p, q;\n"
      "setp.ne.s32 p, %1, 0;\n"
      "bar.red.or.pred q, 1, 256, p;\n"
      "selp.s32 %0, 1, 0, q;\n}\n"
      : "=r"(out)
      : "r"((int)pred)
      : "memory");
  return out != 0;
}

__device__ __forceinline__ unsigned long long pack_key(float d, int row) {
  return ((unsigned long long)dist_key(d) << 32) | (unsigned)row;
}

// filtered_select.cuh's key of a finite distance: the row's sign bit
// flipped (rows >= 0 order as they are); PAD_KEY is (+inf, -1), which
// orders after every finite key.
__device__ __forceinline__ unsigned long long filter_key(float d, int row) {
  return ((unsigned long long)dist_key(d) << 32) |
         ((unsigned)row ^ 0x80000000u);
}
constexpr unsigned long long PAD_KEY =
    ((unsigned long long)INF_KEY << 32) | 0x7fffffffull;

// Two f32 as a word of two bf16 (round to nearest even).
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// Lower query q's bar (the key a distance has to beat) to key.
__device__ __forceinline__ void lower_bar(unsigned long long* bark, int q,
                                          unsigned long long key) {
  if (key < bark[q]) bark[q] = key;
}

// Ascending bitonic sort of one key a lane across the warp. (Every loop
// of these networks counts up or down by one, so that it unrolls and the
// keys stay in registers.)
__device__ __forceinline__ unsigned long long warp_sort(unsigned long long v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int a = 1; a <= 5; ++a)
#pragma unroll
    for (int b = a - 1; b >= 0; --b) {
      const int size = 1 << a, stride = 1 << b;
      const unsigned long long o = __shfl_xor_sync(FULL, v, stride);
      const bool take_min = ((lane & stride) == 0) == ((lane & size) == 0);
      v = take_min ? (o < v ? o : v) : (o > v ? o : v);
    }
  return v;
}

__device__ __forceinline__ unsigned long long kmin(unsigned long long a,
                                                   unsigned long long b) {
  return a < b ? a : b;
}
__device__ __forceinline__ unsigned long long kmax(unsigned long long a,
                                                   unsigned long long b) {
  return a < b ? b : a;
}

// The compare-exchanges of a bitonic merge at strides 16 .. 1 (inside a
// warp's 32 keys): a bitonic 32 comes out ascending.
__device__ __forceinline__ unsigned long long warp_merge(unsigned long long v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int b = 4; b >= 0; --b) {
    const unsigned long long o = __shfl_xor_sync(FULL, v, 1 << b);
    v = (lane & (1 << b)) == 0 ? kmin(v, o) : kmax(v, o);
  }
  return v;
}

// The sorted list L of n <= k keys and m <= 32 staged keys S merged in
// registers by the whole warp; the first k go back to L. The list is read
// padded with ~0 to 32 P >= k keys (P a power of 2), lane l holding keys
// 32 t + l. The 32 P smallest of list and staged keys are the list's first
// 32 P - 32 and, pairwise, the smaller of its last 32 and the sorted staged
// keys reversed (a bitonic 32, sorted by one warp merge); that 32 reversed
// after the rest is a bitonic 32 P, which a bitonic merge sorts (strides
// of 32 and more between a lane's registers, below by shuffles). Returns
// the merged list's keys at ranks k - 1 and j - 1 (in *jth).
template <int P>
__device__ __forceinline__ unsigned long long merge_keys(
    unsigned long long* L, const unsigned long long* S, int n, int m, int k,
    int j, unsigned long long* jth) {
  constexpr int LP = P == 8 ? 3 : P == 4 ? 2 : P == 2 ? 1 : 0;
  static_assert(1 << LP == P, "P is 1, 2, 4 or 8");
  const int lane = threadIdx.x & 31;
  const unsigned long long s = warp_sort(lane < m ? S[lane] : ~0ull);
  unsigned long long v[P];
#pragma unroll
  for (int t = 0; t < P; ++t) {
    const int e = 32 * t + lane;
    v[t] = e < n ? L[e] : ~0ull;
  }
  v[P - 1] = warp_merge(kmin(v[P - 1], __shfl_sync(FULL, s, 31 - lane)));
  if constexpr (P > 1) {
    v[P - 1] = __shfl_sync(FULL, v[P - 1], 31 - lane);
#pragma unroll
    for (int b = LP - 1; b >= 0; --b)
#pragma unroll
      for (int t = 0; t < P; ++t)
        if ((t & (1 << b)) == 0) {
          const unsigned long long lo = kmin(v[t], v[t + (1 << b)]);
          v[t + (1 << b)] = kmax(v[t], v[t + (1 << b)]);
          v[t] = lo;
        }
#pragma unroll
    for (int t = 0; t < P; ++t) v[t] = warp_merge(v[t]);
  }
  __syncwarp();  // every lane has read the list
#pragma unroll
  for (int t = 0; t < P; ++t) {
    const int e = 32 * t + lane;
    if (e < k) L[e] = v[t];
  }
  __syncwarp();
  *jth = L[j - 1];
  return L[k - 1];
}

// Merge query ql's staged keys (the first min(cnt, TC_CAP) of its buffer)
// into its list (merge_keys). Once the list is full its k-th lowers the
// query's bar and the bar all slices share (bars_q, a reduction: nothing
// waits for it); once it holds j keys its j-th distance key is what this
// slice publishes for the bar from every slice's j-th (pub_q).
__device__ __forceinline__ void merge_staged(
    int ql, int k, int j, unsigned long long* lk, unsigned long long* stg,
    unsigned long long* bark, int* cnt, int* fill,
    unsigned long long* __restrict__ bars_q, unsigned* __restrict__ pub_q) {
  const int lane = threadIdx.x & 31;
  unsigned long long* L = lk + (size_t)ql * k;
  const unsigned long long* S = stg + (size_t)ql * TC_CAP;
  const int n = fill[ql], m = min(cnt[ql], TC_CAP);
  unsigned long long kth, jth;
  if (k <= 32)
    kth = merge_keys<1>(L, S, n, m, k, j, &jth);
  else if (k <= 64)
    kth = merge_keys<2>(L, S, n, m, k, j, &jth);
  else if (k <= 128)
    kth = merge_keys<4>(L, S, n, m, k, j, &jth);
  else
    kth = merge_keys<8>(L, S, n, m, k, j, &jth);
  const int nf = min(n + m, k);
  if (lane == 0) {
    fill[ql] = nf;
    cnt[ql] = 0;
    if (nf == k) {
      lower_bar(bark, ql, kth);
      atomicMin(bars_q, kth);
    }
    if (nf >= j) *pub_q = (unsigned)(jth >> 32);
  }
  __syncwarp();
}

// split: rows a slice (LISTS, DUMP, FILTER; with fa.tstride > 1 a slice
// of the sampled tiles' rows) or rounds a block (BINS); bars (LISTS, all
// bits set on entry): [B] u64, the k-th bound of each query, then [B, S]
// u32, each query's slices' j-th distance keys; part_* [S, B, k] (LISTS);
// dump [B, N] (DUMP); bins M and bin_keys [B, M] (BINS); fa (FILTER).
template <int KIND, int QW, int MODE, int METRIC>
__global__ void __launch_bounds__(TC_THREADS, 1) bf16_tile_pass(
    const __grid_constant__ CUtensorMap tmx, const float* __restrict__ x_sq,
    const uint8_t* __restrict__ mask, long long mask_stride,
    const float* __restrict__ q, int B, int N, int D, int k, int split,
    int stages, unsigned long long* __restrict__ bars,
    float* __restrict__ part_d, int* __restrict__ part_r,
    float* __restrict__ dump, int bins,
    unsigned long long* __restrict__ bin_keys, const FilterArgs fa) {
  constexpr int M = QW / 2;  // accumulators a thread
  constexpr int SD = tc_step_dims(KIND);  // dims a step
  constexpr int PARTS = tc_parts(KIND);   // staged parts of a query
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[TC_MAX_STAGES], empty[TC_MAX_STAGES];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int KS = (D + SD - 1) / SD;  // steps a tile
  unsigned char* ring = smem;
  unsigned char* qs = smem + stages * TC_STEP_BYTES;  // part p, step c at
  // qs + (p KS + c) QW 128
  float* q_sq = reinterpret_cast<float*>(qs + (size_t)PARTS * KS * QW * 128);
  float* qbar = q_sq + QW;  // FILTER: the queries' bars, staged keys
  unsigned long long* sbuf = reinterpret_cast<unsigned long long*>(qbar + QW);
  int* scnt = reinterpret_cast<int*>(sbuf + QW * TC_FCAP);
  int* rbase = scnt + QW;  // the block's reservation a query: next slot,
  int* rleft = rbase + QW;  // slots left
  unsigned long long* lk = reinterpret_cast<unsigned long long*>(q_sq + QW);
  unsigned long long* stg = lk + (size_t)QW * k;
  unsigned long long* bark = stg + QW * TC_CAP;  // the queries' bars
  int* cnt = reinterpret_cast<int*>(bark + QW);
  int* fill = cnt + QW;

  const int t = threadIdx.x;
  const int q0 = blockIdx.x * QW, qn = min(QW, B - q0);
  const int tstride = MODE == SEL_FILTER ? fa.tstride : 1;
  int row_lo = 0, row_hi = 0, j0 = 0, i_lo = 0, n_tiles = 0;
  if constexpr (MODE == SEL_BINS) {
    j0 = blockIdx.y * TC_ROWS;
    i_lo = blockIdx.z * split;
    const int rounds = (N - j0 + bins - 1) / bins;  // rounds with a row here
    n_tiles = max(0, min(rounds, i_lo + split) - i_lo);
  } else {
    // rows of the tiles taken, end to end: N, or 128 a sampled tile
    const int n_rows =
        tstride == 1 ? N
                     : ((N + TC_ROWS - 1) / TC_ROWS + tstride - 1) / tstride *
                           TC_ROWS;
    row_lo = blockIdx.y * split;
    row_hi = min(n_rows, row_lo + split);
    n_tiles = row_hi > row_lo ? (row_hi - row_lo + TC_ROWS - 1) / TC_ROWS : 0;
  }
  auto tile_row0 = [&](int tile) {
    return MODE == SEL_BINS ? (i_lo + tile) * bins + j0
                            : (row_lo + tile * TC_ROWS) * tstride;
  };

  if (t == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, TC_CONSUMERS / 32);
    }
    mbar_fence_init();
  }
  if (t < TC_CONSUMERS) {
    // the queries' parts, zero past D and past B, as 128-byte-swizzled
    // K-major [QW x 128 bytes] tiles, a 16-byte chunk (8 bf16 or 4 f32
    // dims) a thread at a time
    for (int i = t; i < QW * KS * 8; i += TC_CONSUMERS) {
      const int ql = i / (KS * 8), c = (i / 8) % KS, ch = i % 8;
      const int d0 = c * SD + ch * (SD / 8);
      uint4 v[PARTS];
#pragma unroll
      for (int p = 0; p < PARTS; ++p) v[p] = make_uint4(0u, 0u, 0u, 0u);
      if (ql < qn && d0 < D) {
        const float4* src =
            reinterpret_cast<const float4*>(q + (size_t)(q0 + ql) * D + d0);
        if constexpr (KIND == TC_TF32X3) {
          const float4 a = src[0];
          const float f[4] = {a.x, a.y, a.z, a.w};
          uint32_t big[4], sml[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            big[e] = tf32_rna(f[e]);
            sml[e] = tf32_rna(f[e] - __uint_as_float(big[e]));
          }
          v[0] = make_uint4(big[0], big[1], big[2], big[3]);
          v[1] = make_uint4(sml[0], sml[1], sml[2], sml[3]);
        } else {
          const float4 a = src[0], b = src[1];
          float f[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
          for (int p = 0; p < PARTS; ++p) {
            // part p: the round of what the parts before leave (exact)
            unsigned w[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              w[e] = pack_bf16(f[2 * e], f[2 * e + 1]);
              f[2 * e] -= __bfloat162float(__ushort_as_bfloat16(
                  (unsigned short)(w[e] & 0xffffu)));
              f[2 * e + 1] -= __bfloat162float(
                  __ushort_as_bfloat16((unsigned short)(w[e] >> 16)));
            }
            v[p] = make_uint4(w[0], w[1], w[2], w[3]);
          }
        }
      }
#pragma unroll
      for (int p = 0; p < PARTS; ++p)
        *reinterpret_cast<uint4*>(qs + ((size_t)p * KS + c) * QW * 128 +
                                  sw128(ql, ch)) = v[p];
    }
    const int w = t >> 5, lane = t & 31;
    for (int ql = w; ql < QW; ql += TC_CONSUMERS / 32) {
      const float v = ql < qn ? warp_row_sq(q + (size_t)(q0 + ql) * D, D) : 0.f;
      if (lane == 0) q_sq[ql] = v;
    }
    if constexpr (MODE == SEL_LISTS) {
      for (int i = t; i < QW * k; i += TC_CONSUMERS) lk[i] = ~0ull;
      for (int i = t; i < QW; i += TC_CONSUMERS) {
        bark[i] = ~0ull;
        cnt[i] = 0;
        fill[i] = 0;
      }
    }
    if constexpr (MODE == SEL_FILTER)
      for (int i = t; i < QW; i += TC_CONSUMERS) {
        qbar[i] = i < qn && fa.bar != nullptr
                      ? fa.bar[(size_t)(q0 + i) * fa.bar_ld]
                      : INFINITY;
        scnt[i] = 0;
        rbase[i] = 0;
        rleft[i] = 0;
      }
    fence_proxy_async();
  }
  __syncthreads();

  if (t >= TC_CONSUMERS) {  // the producer warpgroup: one lane issues the
    // copies, and the group gives its registers to the consumers
    setmaxnreg_dec<TC_PRODUCER_REGS>();
    if (t == TC_CONSUMERS) {
      const int T = n_tiles * KS;
      for (int g = 0; g < T; ++g) {
        const int slot = g % stages, use = g / stages;
        if (use > 0) mbar_wait(empty + slot, (use - 1) & 1);
        mbar_expect(full + slot, TC_STEP_BYTES);
        tma_load_2d(smem_addr(ring + slot * TC_STEP_BYTES), &tmx,
                    (g % KS) * SD, tile_row0(g / KS), full + slot);
      }
    }
    return;
  }
  setmaxnreg_inc<TC_CONSUMER_REGS>();

  const int wg = t >> 7, w = t >> 5, lane = t & 31;
  const int rloc = wg * 64 + (w & 3) * 16 + (lane >> 2);  // rows rloc, +8
  const bool per_query_mask = mask != nullptr && mask_stride != 0;
  // part: a step's sum from zero (TC_TF32X3: unused); ps: the split
  // routes' small products, summed apart; pb: TC_TF32X3's big products,
  // a k8 product each from zero. The tensor cores align a product's terms
  // to the largest and cut the rest to its precision: a chain of 8 big
  // products a step (or one of their sums from the accumulator) cuts each
  // product at the partial sum's size, which left the f32 rows' distances
  // ~10x the FMA pass's error at |x|^2 ~ 6,000
  constexpr int PB = KIND == TC_TF32X3 ? 4 : 1;
  float acc[M], part[M], ps[KIND == TC_RQ ? 1 : M];
  float pb[PB][KIND == TC_TF32X3 ? M : 1];
  float run[MODE == SEL_BINS ? M : 1];
  int rnd[MODE == SEL_BINS ? M : 1];
  if constexpr (MODE == SEL_BINS) {
#pragma unroll
    for (int i = 0; i < M; ++i) {
      run[i] = INFINITY;
      rnd[i] = 0;
    }
  }
  int g = 0;  // the block's step, as the producer counts them
  for (int tile = 0; tile < n_tiles; ++tile) {
#pragma unroll
    for (int i = 0; i < M; ++i) acc[i] = 0.f;
    if constexpr (KIND == TC_TF32X3) {
      // this thread's A fragments of step gg's 4 sub-steps of 8 dims,
      // split: rows rloc (e even) and rloc + 8, dims 8 j + lane % 4 (+ 4);
      // the rows are in registers then, so the warp frees the slot
      auto load_a = [&](int gg, uint32_t (&ab)[4][4], uint32_t (&as)[4][4]) {
        const int slot = gg % stages;
        mbar_wait(full + slot, (gg / stages) & 1);
        const unsigned char* rows = ring + slot * TC_STEP_BYTES;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = rloc + 8 * (e & 1);
            const int col = 8 * j + (lane & 3) + 4 * (e >> 1);
            const float v = *reinterpret_cast<const float*>(
                rows + sw128(r, col >> 2) + (col & 3) * 4);
            ab[j][e] = tf32_rna(v);
            as[j][e] = tf32_rna(v - __uint_as_float(ab[j][e]));
          }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + slot);
      };
      // step c's products from (ab, as), committed and not waited on
      auto mma = [&](int c, const uint32_t (&ab)[4][4],
                     const uint32_t (&as)[4][4]) {
        const uint64_t db = sw128_desc(smem_addr(qs + (size_t)c * QW * 128));
        const uint64_t db_s =
            sw128_desc(smem_addr(qs + (size_t)(KS + c) * QW * 128));
#pragma unroll
        for (int j = 0; j < 4; ++j) fence_regs(pb[j]);
        fence_regs(ps);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          WgmmaTF32<QW>::mma(ps, as[j], db + 2 * j, j);
          WgmmaTF32<QW>::mma(ps, ab[j], db_s + 2 * j, 1);
          WgmmaTF32<QW>::mma(pb[j], ab[j], db + 2 * j, 0);
        }
        wgmma_commit();
      };
      // the products waited on and the step added to the f32 sums
      auto add = [&]() {
        wgmma_wait<0>();
#pragma unroll
        for (int j = 0; j < 4; ++j) fence_regs(pb[j]);
        fence_regs(ps);
#pragma unroll
        for (int i = 0; i < M; ++i)
          acc[i] += ((pb[0][i] + pb[1][i]) + (pb[2][i] + pb[3][i])) + ps[i];
      };
      uint32_t ab0[4][4], as0[4][4];
      if constexpr (tf32_one_set(MODE, QW)) {
        // the lists leave no room for a second set of fragments (at 232
        // registers the compiler serialized the products): each step is
        // read and split before its products
        for (int c = 0; c < KS; ++c) {
          load_a(g + c, ab0, as0);
          mma(c, ab0, as0);
          add();
        }
      } else {
        // two sets of fragments: the next step's rows are read and split
        // while the tensor cores take this step's products
        uint32_t ab1[4][4], as1[4][4];
        load_a(g, ab0, as0);
        for (int c = 0; c < KS; c += 2) {
          mma(c, ab0, as0);
          if (c + 1 < KS) load_a(g + c + 1, ab1, as1);
          add();
          if (c + 1 < KS) {
            mma(c + 1, ab1, as1);
            if (c + 2 < KS) load_a(g + c + 2, ab0, as0);
            add();
          }
        }
      }
      g += KS;
    } else {
      for (int c = 0; c < KS; ++c, ++g) {  // a step: 128 bytes, from 0
        const int slot = g % stages;
        mbar_wait(full + slot, (g / stages) & 1);
        const unsigned char* rows = ring + slot * TC_STEP_BYTES;
        const uint64_t db =
            sw128_desc(smem_addr(qs + (size_t)c * QW * 128));
        const uint64_t da = sw128_desc(smem_addr(rows + wg * 64 * 128));
        fence_regs(part);
        if constexpr (KIND == TC_BF16X3) fence_regs(ps);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < TC_K / 16; ++j) {
          if constexpr (KIND == TC_BF16X3) {  // hi; mid and lo apart
#pragma unroll
            for (int p = 1; p < PARTS; ++p)
              Wgmma<QW>::mma(
                  ps, da + 2 * j,
                  db + (uint64_t)((p * KS * QW * 128) >> 4) + 2 * j,
                  j + p - 1);
          }
          Wgmma<QW>::mma(part, da + 2 * j, db + 2 * j, j);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(part);
        if constexpr (KIND == TC_BF16X3) {
          fence_regs(ps);
#pragma unroll
          for (int i = 0; i < M; ++i) acc[i] += ps[i];
        }
#pragma unroll
        for (int i = 0; i < M; ++i) acc[i] += part[i];
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + slot);
      }
    }

    // the epilogue: thread lane of warp w holds rows rloc (h = 0) and
    // rloc + 8 (h = 1), columns 8 (i / 4) + 2 (lane % 4) + i % 2
    const int r0 = tile_row0(tile);
    const int v0 = row_lo + tile * TC_ROWS;  // the tile's first row taken
    int row[2];
    bool rv[2], mrow[2];
    float xs[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lr = rloc + 8 * h;
      row[h] = r0 + lr;
      if constexpr (MODE == SEL_BINS)
        rv[h] = j0 + lr < bins && row[h] < N;
      else
        rv[h] = v0 + lr < row_hi && row[h] < N;
      xs[h] = rv[h] ? x_sq[row[h]] : 0.f;
      mrow[h] = rv[h] && (mask == nullptr || per_query_mask || mask[row[h]]);
    }
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const int h = (i >> 1) & 1;
      const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      bool ok = mrow[h] && col < qn;
      if (per_query_mask && ok)
        ok = mask[(long long)(q0 + col) * mask_stride + row[h]] != 0;
      const float dist = metric_dist<METRIC>(q_sq[col], acc[i], xs[h]);
      acc[i] = ok ? dist : INFINITY;
    }
    if constexpr (MODE == SEL_DUMP) {
#pragma unroll
      for (int i = 0; i < M; ++i) {
        const int h = (i >> 1) & 1;
        const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        if (rv[h] && col < qn)
          dump[(size_t)(q0 + col) * N + row[h]] = acc[i];
      }
    } else if constexpr (MODE == SEL_BINS) {
#pragma unroll
      for (int i = 0; i < M; ++i)
        if (acc[i] < run[i]) {  // strict: the earlier round keeps a tie
          run[i] = acc[i];
          rnd[i] = i_lo + tile;
        }
    } else if constexpr (MODE == SEL_FILTER) {
      if (fa.bar == nullptr) {  // a slot a row taken, at its place
#pragma unroll
        for (int i = 0; i < M; ++i) {
          const int h = (i >> 1) & 1;
          const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          const int v = v0 + rloc + 8 * h;
          if (v < row_hi && col < qn)
            fa.surv[(size_t)(q0 + col) * fa.cap + v] =
                acc[i] < INFINITY ? filter_key(acc[i], row[h]) : PAD_KEY;
        }
      } else {
#pragma unroll
        for (int i = 0; i < M; ++i) {
          const int h = (i >> 1) & 1;
          const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          if (!(acc[i] < INFINITY && acc[i] <= qbar[col])) continue;
          const unsigned long long key = filter_key(acc[i], row[h]);
          const int p = atomicAdd(scnt + col, 1);
          if (p < TC_FCAP) {
            sbuf[col * TC_FCAP + p] = key;
          } else {  // the staging is full: a slot of its own
            const int g = atomicAdd(fa.cnt + q0 + col, 1);
            if (g < fa.cap)
              fa.surv[(size_t)(q0 + col) * fa.cap + g] = key;
            else if (g == fa.cap)
              atomicAdd(fa.overflow, 1);
          }
        }
        // every TC_FLUSH_EVERY tiles (and at the slice's end) each warp
        // empties every 8th query's staging that holds TC_FLUSH_AT keys
        // (all of them at the end) into the block's reservation for the
        // query, taking fa.chunk slots at a time (one global atomic); the
        // unused rest of a reservation is padded
        const bool last = tile + 1 == n_tiles;
        if (last || tile % TC_FLUSH_EVERY == TC_FLUSH_EVERY - 1) {
          consumers_sync();
          const int need = last ? 1 : TC_FLUSH_AT;
          for (int ql = w; ql < qn; ql += TC_CONSUMERS / 32) {
            unsigned long long* out = fa.surv + (size_t)(q0 + ql) * fa.cap;
            const int n = min(scnt[ql], TC_FCAP);
            if (n >= need) {  // uniform across the warp
              int base = 0, pad = 0, pad_n = 0;
              if (lane == 0) {
                if (rleft[ql] < n) {
                  pad = rbase[ql];
                  pad_n = rleft[ql];
                  const int want = max(fa.chunk, n);
                  const int r = atomicAdd(fa.cnt + q0 + ql, want);
                  if (r <= fa.cap && fa.cap < r + want)
                    atomicAdd(fa.overflow, 1);
                  rbase[ql] = r;
                  rleft[ql] = want;
                }
                base = rbase[ql];
                rbase[ql] = base + n;
                rleft[ql] -= n;
              }
              base = __shfl_sync(FULL, base, 0);
              pad = __shfl_sync(FULL, pad, 0);
              pad_n = __shfl_sync(FULL, pad_n, 0);
              for (int j = lane; j < n; j += 32)
                if (base + j < fa.cap)
                  out[base + j] = sbuf[ql * TC_FCAP + j];
              for (int j = lane; j < pad_n; j += 32)
                if (pad + j < fa.cap) out[pad + j] = PAD_KEY;
              __syncwarp();  // every lane has read the count
              if (lane == 0) scnt[ql] = 0;
            }
            if (last) {  // the rest of the block's reservation
              __syncwarp();
              const int rb = rbase[ql], rl = rleft[ql];
              for (int j = lane; j < rl; j += 32)
                if (rb + j < fa.cap) out[rb + j] = PAD_KEY;
            }
          }
          consumers_sync();
        }
      }
    } else {
      // the bars all slices share, read now and applied after this tile's
      // merges: the k-th bound of the warp's queries (lane m: query w + 8
      // m), and the slices' j-th keys of one of them in turn (rq)
      const int S = gridDim.y, j = (k + S - 1) / S;
      unsigned* pub = reinterpret_cast<unsigned*>(bars + B);  // [B, S]
      const bool use_pub = k >= 32 && S <= 32 * TC_PUB_LOADS;
      const int qm = w + 8 * lane;
      const bool mine = lane < QW / 8 && qm < qn;
      const unsigned long long gb = mine ? __ldcg(bars + q0 + qm) : ~0ull;
      const int rq = w + 8 * (tile % (QW / 8));
      unsigned long long pend = 0;
#pragma unroll
      for (int i = 0; i < M; ++i)
        if (isfinite(acc[i])) pend |= 1ull << i;
      while (true) {
#pragma unroll
        for (int i = 0; i < M; ++i) {
          if (!((pend >> i) & 1ull)) continue;
          const int h = (i >> 1) & 1;
          const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          const unsigned long long key = pack_key(acc[i], row[h]);
          if (key < bark[col]) {
            const int pos = atomicAdd(cnt + col, 1);
            if (pos >= TC_CAP) continue;  // offered again after the merge
            stg[col * TC_CAP + pos] = key;
          }
          pend &= ~(1ull << i);
        }
        consumers_sync();
        unsigned pv[TC_PUB_LOADS];  // read here, used below the ballots
#pragma unroll
        for (int i = 0; i < TC_PUB_LOADS; ++i) {
          const int sl = lane + 32 * i;
          pv[i] = use_pub && rq < qn && sl < S
                      ? __ldcg(pub + (size_t)(q0 + rq) * S + sl) : 0u;
        }
        // the queries to merge: those with TC_MERGE_AT keys staged (a merge
        // costs about as much for 1 key as for 32), all at the slice's end;
        // every warp lists them and takes every 8th, so the warps share
        // the merges evenly
        const int need = tile + 1 == n_tiles ? 1 : TC_MERGE_AT;
        constexpr int NC = (QW + 31) / 32;  // ballot words, one a lane
        unsigned todo = 0;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int qq = 32 * c + lane;
          const unsigned bal = __ballot_sync(FULL, qq < qn && cnt[qq] >= need);
          if (lane == c) todo = bal;
        }
        if (mine) lower_bar(bark, qm, gb);
        if (use_pub && rq < qn) {  // the largest of the slices' j-th keys
          unsigned mx = 0;
#pragma unroll
          for (int i = 0; i < TC_PUB_LOADS; ++i) mx = max(mx, pv[i]);
          mx = __reduce_max_sync(FULL, mx);
          __syncwarp();
          if (lane == 0)  // the largest row: a bound for every row
            lower_bar(bark, rq, (unsigned long long)mx << 32 | ~0u);
        }
        consumers_sync();  // every warp has read the counts and bars
        int item = 0;
#pragma unroll 1
        for (int c = 0; c < NC; ++c)
          for (unsigned b = __shfl_sync(FULL, todo, c); b; b &= b - 1, ++item) {
            const int ql = 32 * c + __ffs(b) - 1;
            if ((item & 7) == w)
              merge_staged(ql, k, j, lk, stg, bark, cnt, fill,
                           bars + q0 + ql,
                           pub + (size_t)(q0 + ql) * S + blockIdx.y);
          }
        if (!consumers_any(pend != 0)) break;
      }
    }
  }

  if constexpr (MODE == SEL_BINS) {
#pragma unroll
    for (int i = 0; i < M; ++i) {
      if (!(run[i] < INFINITY)) continue;
      const int h = (i >> 1) & 1;
      const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      const int bin = j0 + rloc + 8 * h;
      atomicMin(bin_keys + (size_t)(q0 + col) * bins + bin,
                pack_key(run[i], rnd[i] * bins + bin));
    }
  } else if constexpr (MODE == SEL_LISTS) {
    consumers_sync();  // with no tile, the lists are as initialised
    for (int ql = w; ql < qn; ql += TC_CONSUMERS / 32) {
      const size_t off = ((size_t)blockIdx.y * B + q0 + ql) * k;
      const int n = fill[ql];
      for (int j = lane; j < k; j += 32) {
        const unsigned long long key = lk[(size_t)ql * k + j];
        part_d[off + j] = j < n ? key_dist((unsigned)(key >> 32)) : INFINITY;
        part_r[off + j] = j < n ? (int)(unsigned)(key & 0xffffffffull) : -1;
      }
    }
  }
}

// The tensor map of rows x [N, D] (bf16, or f32 for TC_TF32X3) in boxes
// of TC_ROWS x 128 bytes, kept per (pointer, N, D, row type): a serving
// mirror is the same tensor from call to call, and the map depends on
// nothing else.
inline bool rows_map(const void* x, int N, int D, CUtensorMap* out,
                     int kind = TC_RQ) {
  struct Entry {
    const void* p;
    int n, d;
    bool bf16;
    CUtensorMap m;
  };
  static std::mutex mu;
  static Entry cache[16] = {};
  static int next = 0;
  const bool bf16 = kind != TC_TF32X3;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : cache)
    if (e.p == x && e.n == N && e.d == D && e.bf16 == bf16) {
      *out = e.m;
      return true;
    }
  Entry& e = cache[next];
  next = (next + 1) % 16;
  e.p = nullptr;
  if (!tile_map(&e.m, x, bf16, N, D, D, TC_ROWS, tc_step_dims(kind), true))
    return false;
  e.p = x;
  e.n = N;
  e.d = D;
  e.bf16 = bf16;
  *out = e.m;
  return true;
}

// Checks shared by the launches: D and the pointers as TMA and the staged
// queries read them, the plan's width, stages and bytes. The split routes
// take widths up to 64 (TC_TF32X3 32); TC_BF16X3 takes no BINS.
inline cudaError_t tc_check(const void* x, const float* q, int width, int D,
                            int mode, int k, int stages, int smem,
                            int kind = TC_RQ) {
  const int align = kind == TC_TF32X3 ? 4 : 8;  // 16-byte rows
  if (D < align || D % align != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0 || stages < 2 ||
      stages > TC_MAX_STAGES || smem > TC_SMEM_LIMIT ||
      smem < tc_smem_bytes(width, D, mode, k, stages, kind) ||
      (width != 8 && width != 32 && width != 64 && width != 128) ||
      (mode == SEL_BINS && width > 64) ||
      (kind != TC_RQ && width > 64) ||
      (kind == TC_BF16X3 && mode == SEL_BINS) ||
      (kind == TC_TF32X3 && width > 32) ||
      kind < TC_RQ || kind > TC_BF16X3)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <int KIND, int QW, int MODE, int METRIC>
cudaError_t launch_tc(const CUtensorMap& map, const float* x_sq,
                      const uint8_t* mask, long long mask_stride,
                      const float* q, int B, int N, int D, int k, int split,
                      int stages, int smem, dim3 grid,
                      unsigned long long* bars, float* part_d, int* part_r,
                      float* dump, int bins, unsigned long long* bin_keys,
                      cudaStream_t stream, FilterArgs fa = FilterArgs()) {
  static int cap[64];
  cudaError_t e = raise_smem_cap(
      reinterpret_cast<const void*>(bf16_tile_pass<KIND, QW, MODE, METRIC>),
      smem, cap);
  if (e != cudaSuccess) return e;
  bf16_tile_pass<KIND, QW, MODE, METRIC><<<grid, TC_THREADS, smem, stream>>>(
      map, x_sq, mask, mask_stride, q, B, N, D, k, split, stages, bars,
      part_d, part_r, dump, bins, bin_keys, fa);
  return cudaGetLastError();
}

// launch_tc at a runtime width (TC_BF16X3: up to 64; TC_TF32X3, whose
// big products take four accumulators: up to 32).
template <int MODE, int METRIC, int KIND = TC_RQ, typename... A>
cudaError_t launch_tc_width(int width, A... a) {
  switch (width) {
    case 8: return launch_tc<KIND, 8, MODE, METRIC>(a...);
    case 32: return launch_tc<KIND, 32, MODE, METRIC>(a...);
    case 64:
      if constexpr (KIND != TC_TF32X3)
        return launch_tc<KIND, 64, MODE, METRIC>(a...);
      return cudaErrorInvalidValue;
    case 128:
      if constexpr (MODE != SEL_BINS && KIND == TC_RQ)
        return launch_tc<KIND, 128, MODE, METRIC>(a...);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

// launch_tc at a runtime route and width: TC_BF16X3 takes the euclidean
// metric only (bf16 rows with an f32 query: the link candidates and the
// calibration oracle).
template <int MODE, int METRIC, typename... A>
cudaError_t launch_tc_kind(int kind, int width, A... a) {
  switch (kind) {
    case TC_RQ: return launch_tc_width<MODE, METRIC, TC_RQ>(width, a...);
    case TC_TF32X3:
      return launch_tc_width<MODE, METRIC, TC_TF32X3>(width, a...);
    case TC_BF16X3:
      if constexpr (METRIC == EUCLID)
        return launch_tc_width<MODE, METRIC, TC_BF16X3>(width, a...);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace fvdb
