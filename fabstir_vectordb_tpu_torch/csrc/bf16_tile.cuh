// K1's and K9's pass over bf16 rows with the query rounded to bf16, on the
// tensor cores: the bf16 serving mirror's distance (csrc/l2_topk.cu's
// round_q entry points and csrc/approx_topk.cu's rounded pool).
//
// d(q, x) = max(|q|^2 - 2 bf16(q).x + x_sq, 0) with f32 sums, |q|^2 from the
// f32 query, x_sq as given (the f32 norms of the f32 host rows), or by
// metric (common.cuh's metric_dist: cosine, dot) from the same product:
// the reference's bf16 compute (ops/distance.py _matmul, q.astype(bf16) x
// bf16 rows, f32 accumulation) inside index/fused.py flat_search_kernel and
// flat_search_approx_kernel. Rows where the mask is False never enter;
// results by (distance, row), padded with (+inf, -1). What comes out is
// what l2_tile.cuh's FMA pass computes for the same arguments, up to the
// order of the f32 sums.
//
// What bounds it on the H100: at B = 128 over 1,048,576 x 384 rows the
// products are 103 GFLOP, 0.104 ms at the tensor cores' 989 TFLOP/s (1.54
// ms at the 67 TFLOP/s of f32 FMA, where l2_tile.cuh runs them), against
// 805 MB of rows, 0.240 ms at 3.35 TB/s: one read of the rows bounds it.
//
// Design:
//  * A block is two consumer warpgroups and a producer warp. A tile is 128
//    consecutive rows, a step 64 of its dims: the producer's TMA copies
//    each step, still bf16, into a ring of 128-byte-swizzled slots (16
//    KB, up to 8), counted on the slot's "full" barrier; each consumer
//    warp arrives on its "empty" barrier when its products are done with
//    it.
//  * The rows are the wgmma's M side (a warpgroup takes 64 of the tile),
//    the block's QW queries its N side (QW = 8, 32, 64 or 128, so one
//    query is 8 columns, not 32): each query is rounded to bf16 once and
//    staged whole (all of D) in shared memory as the B operand.
//  * The tensor cores cut their sums to f32 instead of rounding them, so
//    each step (64 dims) is summed from zero and then added to f32
//    registers (as csrc/project_rows.cu does with its windows).
//  * The epilogue reads each distance from the accumulator fragment, with
//    x_sq and the mask of its row; nothing goes through shared memory but
//    what a list keeps.
//  * A host-side plan (ops/topk.py tile_plan) picks QW, the ring's stages
//    and the shared-memory bytes from (B, k, D, mode); the grid is query
//    tiles x row slices (x round ranges) sized to one wave at a block an
//    SM. The tensor map of the rows is encoded once per (pointer, N, D)
//    and kept.
//  * TMA needs 16-byte rows: D % 8 == 0. Other D take l2_tile.cuh's FMA
//    pass, chosen by shape and counted apart; so does D past 8,192, where
//    eight staged queries would crowd the ring out.
//
// The three epilogues:
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
//  * BINS (K9): row r is in bin r mod M. A block owns 128 bins and a range
//    of rounds (round i: rows i M + j0 .., contiguous); a bin's rows only
//    grow from round to round, so a strict < keeps its smallest (distance,
//    row), and a thread keeps its bins' running distance and round in
//    registers. At the end one atomicMin a (query, bin) folds the packed
//    key into [B, M].
#pragma once

#include <mutex>

#include "common.cuh"
#include "l2_tile.cuh"
#include "wgmma.cuh"

namespace fvdb {

constexpr int TC_ROWS = 128;                  // rows a tile: 2 warpgroups
constexpr int TC_K = 64;                      // dims a step: 128 bytes
constexpr int TC_STEP_BYTES = TC_ROWS * TC_K * 2;  // a ring slot: 16 KB
constexpr int TC_CONSUMERS = 256;             // two warpgroups
constexpr int TC_THREADS = TC_CONSUMERS + 32;  // and the producer warp
constexpr int TC_CAP = 32;        // staged keys a query at most
constexpr int TC_MERGE_AT = 16;   // staged keys that call for a merge
constexpr int TC_PUB_LOADS = 5;   // the slices' j-th keys a lane reads:
                                  // the bar from them takes S <= 160
constexpr int TC_MAX_STAGES = 8;
constexpr int TC_MAX_K = 256;
// dynamic shared memory a launch may take: the static barriers take 1 KB
// (padded to the dynamic array's 1,024-byte alignment)
constexpr int TC_SMEM_LIMIT = 232448 - 1024;

// Dynamic shared-memory bytes of a launch (ops/topk.py tile_plan computes
// the same): alignment slack, the ring, the staged queries (D in steps of
// 64, 128 bytes a query a step), |q|^2, and for LISTS the lists, the
// staging, bars, counts and fills.
inline long long tc_smem_bytes(int qw, int D, int mode, int k, int stages) {
  const long long ks = (D + TC_K - 1) / TC_K;
  long long b = 1024 + (long long)stages * TC_STEP_BYTES + ks * qw * 128 +
                qw * 4LL;
  if (mode == SEL_LISTS) b += (long long)qw * (8LL * k + 8 * TC_CAP + 16);
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

// split: rows a slice (LISTS, DUMP) or rounds a block (BINS); bars (LISTS,
// all bits set on entry): [B] u64, the k-th bound of each query, then [B,
// S] u32, each query's slices' j-th distance keys; part_* [S, B, k]
// (LISTS); dump [B, N] (DUMP); bins M and bin_keys [B, M] (BINS).
template <int QW, int MODE, int METRIC>
__global__ void __launch_bounds__(TC_THREADS, 1) bf16_tile_pass(
    const __grid_constant__ CUtensorMap tmx, const float* __restrict__ x_sq,
    const uint8_t* __restrict__ mask, long long mask_stride,
    const float* __restrict__ q, int B, int N, int D, int k, int split,
    int stages, unsigned long long* __restrict__ bars,
    float* __restrict__ part_d, int* __restrict__ part_r,
    float* __restrict__ dump, int bins,
    unsigned long long* __restrict__ bin_keys) {
  constexpr int M = QW / 2;  // accumulators a thread
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[TC_MAX_STAGES], empty[TC_MAX_STAGES];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int KS = (D + TC_K - 1) / TC_K;  // steps a tile
  unsigned char* ring = smem;
  unsigned char* qs = smem + stages * TC_STEP_BYTES;
  float* q_sq = reinterpret_cast<float*>(qs + (size_t)KS * QW * 128);
  unsigned long long* lk = reinterpret_cast<unsigned long long*>(q_sq + QW);
  unsigned long long* stg = lk + (size_t)QW * k;
  unsigned long long* bark = stg + QW * TC_CAP;  // the queries' bars
  int* cnt = reinterpret_cast<int*>(bark + QW);
  int* fill = cnt + QW;

  const int t = threadIdx.x;
  const int q0 = blockIdx.x * QW, qn = min(QW, B - q0);
  int row_lo = 0, row_hi = 0, j0 = 0, i_lo = 0, n_tiles = 0;
  if constexpr (MODE == SEL_BINS) {
    j0 = blockIdx.y * TC_ROWS;
    i_lo = blockIdx.z * split;
    const int rounds = (N - j0 + bins - 1) / bins;  // rounds with a row here
    n_tiles = max(0, min(rounds, i_lo + split) - i_lo);
  } else {
    row_lo = blockIdx.y * split;
    row_hi = min(N, row_lo + split);
    n_tiles = row_hi > row_lo ? (row_hi - row_lo + TC_ROWS - 1) / TC_ROWS : 0;
  }
  auto tile_row0 = [&](int tile) {
    return MODE == SEL_BINS ? (i_lo + tile) * bins + j0
                            : row_lo + tile * TC_ROWS;
  };

  if (t == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, TC_CONSUMERS / 32);
    }
    mbar_fence_init();
  }
  if (t < TC_CONSUMERS) {
    // the queries, rounded to bf16, zero past D and past B, as KS
    // 128-byte-swizzled K-major [QW x 64] tiles
    for (int i = t; i < QW * KS * 8; i += TC_CONSUMERS) {
      const int ql = i / (KS * 8), c = (i / 8) % KS, ch = i % 8;
      const int d0 = c * TC_K + ch * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (ql < qn && d0 < D) {
        const float4* src =
            reinterpret_cast<const float4*>(q + (size_t)(q0 + ql) * D + d0);
        const float4 a = src[0], b = src[1];
        auto pk = [](float lo, float hi) {
          return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
                 ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi))
                  << 16);
        };
        v = make_uint4(pk(a.x, a.y), pk(a.z, a.w), pk(b.x, b.y),
                       pk(b.z, b.w));
      }
      *reinterpret_cast<uint4*>(qs + (size_t)c * QW * 128 + sw128(ql, ch)) =
          v;
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
    fence_proxy_async();
  }
  __syncthreads();

  if (t >= TC_CONSUMERS) {  // the producer warp: one lane issues the copies
    if (t == TC_CONSUMERS) {
      const int T = n_tiles * KS;
      for (int g = 0; g < T; ++g) {
        const int slot = g % stages, use = g / stages;
        if (use > 0) mbar_wait(empty + slot, (use - 1) & 1);
        mbar_expect(full + slot, TC_STEP_BYTES);
        tma_load_2d(smem_addr(ring + slot * TC_STEP_BYTES), &tmx,
                    (g % KS) * TC_K, tile_row0(g / KS), full + slot);
      }
    }
    return;
  }

  const int wg = t >> 7, w = t >> 5, lane = t & 31;
  const int rloc = wg * 64 + (w & 3) * 16 + (lane >> 2);  // rows rloc, +8
  const bool per_query_mask = mask != nullptr && mask_stride != 0;
  float acc[M], part[M];
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
    for (int c = 0; c < KS; ++c, ++g) {  // a step: 64 dims, summed from 0
      const int slot = g % stages;
      mbar_wait(full + slot, (g / stages) & 1);
      const uint64_t da = sw128_desc(
          smem_addr(ring + slot * TC_STEP_BYTES + wg * 64 * 128));
      const uint64_t db = sw128_desc(smem_addr(qs + (size_t)c * QW * 128));
      fence_regs(part);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < TC_K / 16; ++j)
        Wgmma<QW>::mma(part, da + 2 * j, db + 2 * j, j);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(part);
#pragma unroll
      for (int i = 0; i < M; ++i) acc[i] += part[i];
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + slot);
    }

    // the epilogue: thread lane of warp w holds rows rloc (h = 0) and
    // rloc + 8 (h = 1), columns 8 (i / 4) + 2 (lane % 4) + i % 2
    const int r0 = tile_row0(tile);
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
        rv[h] = row[h] < row_hi;
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

// The tensor map of bf16 rows x [N, D] in boxes of TC_ROWS x TC_K, kept
// per (pointer, N, D): a serving mirror is the same tensor from call to
// call, and the map depends on nothing else.
inline bool rows_map(const void* x, int N, int D, CUtensorMap* out) {
  struct Entry {
    const void* p;
    int n, d;
    CUtensorMap m;
  };
  static std::mutex mu;
  static Entry cache[16] = {};
  static int next = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : cache)
    if (e.p == x && e.n == N && e.d == D) {
      *out = e.m;
      return true;
    }
  Entry& e = cache[next];
  next = (next + 1) % 16;
  e.p = nullptr;
  if (!tile_map(&e.m, x, true, N, D, D, TC_ROWS, TC_K, true)) return false;
  e.p = x;
  e.n = N;
  e.d = D;
  *out = e.m;
  return true;
}

// Checks shared by the launches: D and the pointers as TMA and the staged
// queries read them, the plan's width, stages and bytes.
inline cudaError_t tc_check(const void* x, const float* q, int width, int D,
                            int mode, int k, int stages, int smem) {
  if (D < 8 || D % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0 || stages < 2 ||
      stages > TC_MAX_STAGES || smem > TC_SMEM_LIMIT ||
      smem < tc_smem_bytes(width, D, mode, k, stages) ||
      (width != 8 && width != 32 && width != 64 && width != 128) ||
      (mode == SEL_BINS && width > 64))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <int QW, int MODE, int METRIC>
cudaError_t launch_tc(const CUtensorMap& map, const float* x_sq,
                      const uint8_t* mask, long long mask_stride,
                      const float* q, int B, int N, int D, int k, int split,
                      int stages, int smem, dim3 grid,
                      unsigned long long* bars, float* part_d, int* part_r,
                      float* dump, int bins, unsigned long long* bin_keys,
                      cudaStream_t stream) {
  static int cap[64];
  cudaError_t e = raise_smem_cap(
      reinterpret_cast<const void*>(bf16_tile_pass<QW, MODE, METRIC>), smem,
      cap);
  if (e != cudaSuccess) return e;
  bf16_tile_pass<QW, MODE, METRIC><<<grid, TC_THREADS, smem, stream>>>(
      map, x_sq, mask, mask_stride, q, B, N, D, k, split, stages, bars,
      part_d, part_r, dump, bins, bin_keys);
  return cudaGetLastError();
}

// launch_tc at a runtime width.
template <int MODE, int METRIC, typename... A>
cudaError_t launch_tc_width(int width, A... a) {
  switch (width) {
    case 8: return launch_tc<8, MODE, METRIC>(a...);
    case 32: return launch_tc<32, MODE, METRIC>(a...);
    case 64: return launch_tc<64, MODE, METRIC>(a...);
    case 128:
      if constexpr (MODE != SEL_BINS) return launch_tc<128, MODE, METRIC>(a...);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace fvdb
