// K8's merge: two top-k lists of each query into one; chunked_topk's step,
// a chunk's masked top-k merged into a running list; and masked_topk.
//
// Replaces the JAX package's merge_topk (ops/topk.py:61), which the
// reduced-rank calibration oracle (_oracle_step, index/fused.py:206) calls
// once a streamed corpus block to fold the block's top-k into the running
// one. Per query b: the entries of (va[b], ra[b]) and (vb[b], rb[b]) ranked
// by (value, row), ties of both by position (a's first), and the k first
// written out; an entry whose value is not finite comes out as (+inf, -1).
// The inputs need not be sorted. b_base is added to every row >= 0 of the
// second list before it is ranked.
//
// chunked_topk (ops/topk.py:73) is the reference's fori_loop over row
// chunks: dist_fn(start) gives a chunk's [B, chunk] distances and mask, its
// masked top-k (rows offset by start) merges into the running [B, k]. At
// kc = min(k, chunk) <= 256 and k <= 2,048 its step is one launch,
// chunk_topk_kernel below; above, the filtered select below. masked_topk
// (ops/topk.py:20) over a given [B, N] distance matrix is a step with no
// running list: a row of at most SORT_SMEM entries is sorted whole by one
// block, k <= 256 takes chunk_topk_kernel, larger k the filtered select. A
// distance that is not finite never enters.
//
// What bounds it: at the oracle's shape (128 probes, two lists of 11) the
// merge moves 128 * 44 * 8 bytes, a few microseconds of launch; the work is
// (ka + kb)^2 comparisons a query. A step or masked_topk has to read the
// distances and mask once (16 MB at B = 32, chunk = 131,072: ~5 us of HBM;
// 512 MB at [128, 1M]: 0.16 ms).
//
// Design of the merge: one block a query. Each thread ranks its entries by
// counting the entries that order before them (reading both lists through
// the cache); an entry of rank < k writes itself to that slot. No sort, no
// shared state.
//
// Design of the fused chunk step: a grid of (slices, B), so a few queries
// still fill the card. A block reads its slice of the query's distances
// once, the mask ([C] or [B, C] bytes, or none) in place, and drops every
// entry that cannot enter: the bar is the running list's largest (value,
// row), its k-th entry, which any entry that enters must order before (the
// running rows come from earlier chunks, so a tie at the bar goes to the
// running entry, as the merge would rank it). Each warp keeps its
// survivors' best kc in a sorted list in shared memory (common.cuh's
// WarpList); the eight lists merge by rank (a binary search into each of
// the others) into the block's kc best, written to scratch as 64-bit keys
// (dist_key << 32 | the row with its sign bit flipped, so keys order as
// (value, row) with signed rows). The last block of the query to arrive
// (the arrival counter of topk_select.cuh, reset by that block for the next
// launch) sorts the running list, ranks every slice's and the running
// list's entries the same way and writes the k first, padded with (+inf,
// -1). With no running list (a null run_v) the kernel is masked_topk at k
// <= 256.
//
// Design of the filtered select (past the fused kernel's reach): three
// launches, no host sync, nothing allocated a step. The bar is read on the
// card: the running list's k-th key (the list is sorted, as every step
// leaves it), or, while the list is padded or there is none, the upper edge
// of the bin that holds the chunk's kc-th entry in a histogram of the keys'
// top 12 bits (a pass over the chunk whose blocks return at once where the
// running list gives a bar; the last block of a query picks the bin and
// zeroes the counts). The filter pass, a grid of (slices, B), reads the
// distances once more, the mask in place, and appends every entry that
// orders strictly before the bar to the query's survivor buffer
// (warp-aggregated atomics on a count): about k / i entries of chunk i once
// the running list is full, at most kc plus one bin's entries on a first
// chunk. The finishing launch has one block a query: it sorts a query's
// survivors whole in shared memory where they are at most SORT_SMEM, and
// otherwise first takes their kc smallest by topk_select.cuh's radix
// select run inside the block over the buffer (the route is the block's
// own, from the count on the card). It merges the sorted list with the
// sorted running list by binary search: an entry's rank is its position
// plus the other list's entries that order before it (running entries
// first at equal keys), O(k log k) a query; it writes the k first, padded,
// and zeroes the survivor count for the next step.
#include "common.cuh"
#include "filtered_select.cuh"
#include "topk_select.cuh"

namespace fvdb {

__device__ __forceinline__ void entry(const float* va, const int* ra, int ka,
                                      const float* vb, const int* rb,
                                      int b_base, int i, float* v, int* r) {
  const float x = i < ka ? va[i] : vb[i - ka];
  const int rr = i < ka ? ra[i] : rb[i - ka];
  *r = i >= ka && rr >= 0 ? rr + b_base : rr;
  *v = isfinite(x) ? x : INFINITY;
}

__global__ void __launch_bounds__(NT) merge_topk_kernel(
    const float* __restrict__ va, const int* __restrict__ ra, int ka,
    const float* __restrict__ vb, const int* __restrict__ rb, int kb,
    int b_base, int k, float* __restrict__ out_v, int* __restrict__ out_r) {
  const int b = blockIdx.x, n = ka + kb;
  va += (size_t)b * ka;
  ra += (size_t)b * ka;
  vb += (size_t)b * kb;
  rb += (size_t)b * kb;
  out_v += (size_t)b * k;
  out_r += (size_t)b * k;
  for (int j = n + threadIdx.x; j < k; j += NT) {  // fewer entries than k
    out_v[j] = INFINITY;
    out_r[j] = -1;
  }
  for (int i = threadIdx.x; i < n; i += NT) {
    float v;
    int r;
    entry(va, ra, ka, vb, rb, b_base, i, &v, &r);
    int rank = 0;
    for (int j = 0; j < n; ++j) {
      float w;
      int s;
      entry(va, ra, ka, vb, rb, b_base, j, &w, &s);
      rank += w < v || (w == v && (s < r || (s == r && j < i)));
    }
    if (rank < k) {
      const bool ok = v < INFINITY;
      out_v[rank] = ok ? v : INFINITY;
      out_r[rank] = ok ? r : -1;
    }
  }
}

constexpr int CK_MAX = 256;        // kc the fused chunk step takes
constexpr int CK_MAX_RUN = 2048;   // running k it takes
constexpr int CK_UNROLL = 8;       // distances a thread loads at once
constexpr int CK_BLOCKS = 528;     // blocks a step aims for: 4 an SM
constexpr int CK_SLICES = 64;      // slices of a query at most
constexpr int CK_CANDS = 4096;     // slices * kc at most
constexpr int CK_MIN_SLICE = 1024; // distances a slice at least

__device__ __forceinline__ unsigned long long block_max(unsigned long long v,
                                                        unsigned long long* s) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(FULL, v, off);
    v = o > v ? o : v;
  }
  if (lane == 0) s[w] = v;
  __syncthreads();
  v = 0ull;
#pragma unroll
  for (int i = 0; i < NT / 32; ++i) v = s[i] > v ? s[i] : v;
  return v;
}

// Block (s, b): slice s of query b's chunk distances d [B, C] (rows start
// ..), mask [B or 1, C] (mask_stride C or 0; null: every entry), running
// list run_v / run_r [B, k] (null: none); cand [B][S][kc], arrive [B] and
// gbar [B] (zero before the first launch, and left so) scratch; out_v /
// out_r [B, k].
__global__ void __launch_bounds__(NT) chunk_topk_kernel(
    const float* __restrict__ d, const uint8_t* __restrict__ mask,
    long long mask_stride, int C, int start, int kc,
    const float* __restrict__ run_v, const int* __restrict__ run_r, int k,
    int kpad, unsigned long long* __restrict__ cand, int* __restrict__ arrive,
    unsigned long long* __restrict__ gbar, float* __restrict__ out_v,
    int* __restrict__ out_r) {
  extern __shared__ __align__(16) unsigned char ck_smem[];
  __shared__ unsigned long long s_max[NT / 32];
  __shared__ int s_len[CK_SLICES + 1];
  __shared__ int s_last;
  const int sl = blockIdx.x, S = gridDim.x, b = blockIdx.y;
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const float* rv = run_v ? run_v + (size_t)b * k : nullptr;
  const int* rr = run_r ? run_r + (size_t)b * k : nullptr;
  // the bar: the running list's largest key (NO_KEY while it is not full)
  unsigned long long bar = rv ? 0ull : NO_KEY;
  for (int j = t; rv && j < k; j += NT) {
    const unsigned long long e = entry_key(rv[j], rr[j]);
    bar = e > bar ? e : bar;
  }
  bar = block_max(bar, s_max);
  // each warp's best kc of the slice's survivors
  float* ld = reinterpret_cast<float*>(ck_smem);
  int* lr = reinterpret_cast<int*>(ld + (NT / 32) * kc);
  WarpList L{ld + w * kc, lr + w * kc, 0, kc};
  const int len = (C + S - 1) / S, lo = sl * len, hi = min(C, lo + len);
  const float* dd = d + (size_t)b * C;
  const uint8_t* mm = mask ? mask + (size_t)b * mask_stride : nullptr;
  // With kc = k, a list's k-th entry bounds the query's result too (k
  // entries order before it), so each warp publishes its k-th (as the
  // complement, in gbar[b], by atomicMax) and prunes by the best one
  // published: fewer entries reach the lists, whose inserts, not the
  // reads, set the pace when the running list does not prune (the first
  // chunk).
  const bool share = kc == k;
  for (int i0 = lo; i0 < hi; i0 += NT * CK_UNROLL) {
    float v[CK_UNROLL];
    bool ok[CK_UNROLL];
#pragma unroll
    for (int u = 0; u < CK_UNROLL; ++u) {
      const int j = i0 + u * NT + t;
      ok[u] = j < hi && (mm == nullptr || mm[j] != 0);
      v[u] = j < hi ? dd[j] : INFINITY;
    }
#pragma unroll
    for (int u = 0; u < CK_UNROLL; ++u) {
      const int row = start + i0 + u * NT + t;
      const unsigned long long e = ok[u] ? entry_key(v[u], row) : NO_KEY;
      L.offer(e < bar, v[u], row);
    }
    if (share) {  // once a tile: after every offer the atomics cost more
      const unsigned long long kth =
          L.n == kc ? entry_key(L.d[kc - 1], L.r[kc - 1]) : NO_KEY;
      unsigned long long g = 0ull;
      if (lane == 0)
        g = kth != NO_KEY ? atomicMax(gbar + b, ~kth)
                          : *reinterpret_cast<volatile unsigned long long*>(
                                gbar + b);
      g = ~__shfl_sync(FULL, g, 0);  // the best published before this one
      bar = g < bar ? g : bar;
      bar = kth < bar ? kth : bar;
    }
  }
  if (lane == 0) s_len[w] = L.n;
  __syncthreads();
  // the eight lists merged by rank into the block's kc best
  unsigned long long* mine = cand + ((size_t)b * S + sl) * kc;
  int total = 0;
  for (int i = 0; i < NT / 32; ++i) total += s_len[i];
  for (int e = t; e < (NT / 32) * kc; e += NT) {
    const int wl = e / kc, i = e % kc;
    if (i >= s_len[wl]) continue;
    const float v = ld[e];
    const int row = lr[e];
    int rank = i;
    for (int w2 = 0; w2 < NT / 32; ++w2)
      if (w2 != wl)
        rank += count_before(ld + w2 * kc, lr + w2 * kc, s_len[w2], v, row);
    if (rank < kc) mine[rank] = entry_key(v, row);
  }
  for (int j = min(total, kc) + t; j < kc; j += NT) mine[j] = NO_KEY;
  __threadfence();
  __syncthreads();
  if (t == 0) s_last = atomicAdd(arrive + b, 1) == S - 1;
  __syncthreads();
  if (!s_last) return;
  // the last block of the query: every slice's list is in
  __threadfence();
  unsigned long long* sc = reinterpret_cast<unsigned long long*>(ck_smem);
  unsigned long long* sr = sc + (size_t)S * kc;
  const unsigned long long* all = cand + (size_t)b * S * kc;
  for (int j = t; j < S * kc; j += NT) sc[j] = __ldcg(all + j);
  for (int j = t; j < kpad; j += NT)
    sr[j] = rv && j < k ? entry_key(rv[j], rr[j]) : NO_KEY;
  __syncthreads();
  for (int len2 = 2; len2 <= kpad; len2 <<= 1) {  // bitonic: the running list
    for (int j = len2 >> 1; j > 0; j >>= 1) {
      for (int i = t; i < kpad; i += NT) {
        const int p = i ^ j;
        if (p > i) {
          const unsigned long long a = sr[i], c = sr[p];
          if ((a > c) == ((i & len2) == 0)) {
            sr[i] = c;
            sr[p] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  // lists 0 .. S - 1 the slices', list S the running one: valid prefixes
  for (int l = t; l <= S; l += NT)
    s_len[l] = l < S ? count_before(sc + (size_t)l * kc, kc, NO_KEY, false)
                     : count_before(sr, kpad, NO_KEY, false);
  __syncthreads();
  int valid = 0;
  for (int l = 0; l <= S; ++l) valid += s_len[l];
  float* ov = out_v + (size_t)b * k;
  int* orow = out_r + (size_t)b * k;
  for (int e = t; e < S * kc + kpad; e += NT) {
    const int l = e < S * kc ? e / kc : S;
    const int i = e < S * kc ? e % kc : e - S * kc;
    if (i >= s_len[l]) continue;
    const unsigned long long key = l < S ? sc[e] : sr[i];
    int rank = i;
    for (int l2 = 0; l2 <= S && rank < k; ++l2) {
      if (l2 == l) continue;
      const unsigned long long* a = l2 < S ? sc + (size_t)l2 * kc : sr;
      rank += count_before(a, s_len[l2], key, l2 < l);
    }
    if (rank < k) {
      ov[rank] = key_dist((unsigned)(key >> 32));
      orow[rank] = (int)((unsigned)key ^ 0x80000000u);
    }
  }
  for (int j = min(valid, k) + t; j < k; j += NT) {
    ov[j] = INFINITY;
    orow[j] = -1;
  }
  if (t == 0) {  // ready for the next launch
    arrive[b] = 0;
    gbar[b] = 0ull;
  }
}

// Slices of a query the fused chunk step takes, for B queries of C
// distances at kc.
inline int chunk_slices(int B, int C, int kc) {
  const int caps[3] = {(C + CK_MIN_SLICE - 1) / CK_MIN_SLICE, CK_SLICES,
                       CK_CANDS / kc};
  int s = (CK_BLOCKS + B - 1) / B;
  for (int c : caps) s = c < s ? c : s;
  return s > 1 ? s : 1;
}

// The zeroed head of the scratch: arrival counts [B] | published bars [B].
inline size_t chunk_arrive_bytes(int B) { return round_up16((size_t)B * 4); }
inline size_t chunk_head_bytes(int B) {
  return chunk_arrive_bytes(B) + (size_t)B * 8;
}

constexpr int HIST_BITS = 12;              // a key's top bits histogrammed
constexpr int HIST_BINS = 1 << HIST_BITS;  // 4,096 counts: 16 KB
constexpr int SCAN_BLOCKS = 1056;          // hist / filter blocks: 8 an SM
constexpr int SCAN_MIN_SLICE = 2048;       // distances a block at least

// The fused kernel takes the step at kc <= 256 and k <= 2,048.
inline bool fused_route(int kc, int k) {
  return kc <= CK_MAX && k <= CK_MAX_RUN;
}

// Slices of a query the hist and filter passes take.
inline int scan_slices(int B, int C) {
  int s = (SCAN_BLOCKS + B - 1) / B;
  const int cap = (C + SCAN_MIN_SLICE - 1) / SCAN_MIN_SLICE;
  s = cap < s ? cap : s;
  return s > 1 ? s : 1;
}

// The filtered select's scratch: histograms [B][HIST_BINS] | arrival counts
// [B] | survivor counts [B] (the head: zero before the first step, and left
// so) | histogram bars [B] | survivors [B][C] keys | at kc > SORT_SMEM the
// chunk lists [B][pow2(kc)] keys.
struct FilterScratch {
  int* hist;
  int* arrive;
  int* cnt;
  unsigned long long* hbar;
  unsigned long long* surv;
  unsigned long long* lists;
};

// Byte offsets of FilterScratch's parts and its end (the head is [0,
// hbar)).
struct FilterLayout {
  size_t arrive, cnt, hbar, surv, lists, total;
};

inline FilterLayout filter_layout(int B, int C, int kc) {
  const size_t ints = round_up16(B * 4ull);
  FilterLayout l;
  l.arrive = (size_t)B * HIST_BINS * 4;
  l.cnt = l.arrive + ints;
  l.hbar = l.cnt + ints;
  l.surv = l.hbar + round_up16(B * 8ull);
  l.lists = l.surv + round_up16((size_t)B * C * 8);
  l.total = l.lists +
            (kc > SORT_SMEM ? (size_t)B * pow2_at_least(kc) * 8 : 0);
  return l;
}

inline FilterScratch carve_filter(void* base, const FilterLayout& l) {
  unsigned char* p = static_cast<unsigned char*>(base);
  FilterScratch f;
  f.hist = reinterpret_cast<int*>(p);
  f.arrive = reinterpret_cast<int*>(p + l.arrive);
  f.cnt = reinterpret_cast<int*>(p + l.cnt);
  f.hbar = reinterpret_cast<unsigned long long*>(p + l.hbar);
  f.surv = reinterpret_cast<unsigned long long*>(p + l.surv);
  f.lists = reinterpret_cast<unsigned long long*>(p + l.lists);
  return f;
}

// The block's exclusive prefix sum of v, and its total.
__device__ __forceinline__ int block_excl_sum(int v, int* s_warp,
                                             int* total) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) s_warp[w] = x;
  __syncthreads();
  int base = 0, tot = 0;
#pragma unroll
  for (int i = 0; i < NT / 32; ++i) {
    base += i < w ? s_warp[i] : 0;
    tot += s_warp[i];
  }
  *total = tot;
  return base + x - v;
}

// A thread's tile of a slice of a query's distances, from i0 on: with VEC
// (C a multiple of 4, rows and mask 16- and 4-byte aligned) four 16-byte
// loads of distances and four 4-byte loads of mask bytes, 16 entries; else
// CK_UNROLL single loads. Element e's column, and its distance and ok
// (false where masked out or past hi).
template <bool VEC>
struct Tile {
  static constexpr int E = VEC ? 16 : CK_UNROLL;
  static constexpr int STEP = NT * E;  // columns a block's tile covers

  __device__ __forceinline__ static int col(int i0, int e) {
    return VEC ? i0 + ((e >> 2) * NT + (int)threadIdx.x) * 4 + (e & 3)
               : i0 + e * NT + (int)threadIdx.x;
  }

  __device__ __forceinline__ static void load(const float* dd,
                                              const uint8_t* mm, int i0,
                                              int hi, float* v, bool* ok) {
    if constexpr (VEC) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = col(i0, 4 * u);
        float4 x = make_float4(INFINITY, INFINITY, INFINITY, INFINITY);
        unsigned m = 0u;
        if (j < hi) {  // hi is a multiple of 4
          x = *reinterpret_cast<const float4*>(dd + j);
          m = mm ? *reinterpret_cast<const unsigned*>(mm + j) : ~0u;
        }
        v[4 * u] = x.x;
        v[4 * u + 1] = x.y;
        v[4 * u + 2] = x.z;
        v[4 * u + 3] = x.w;
#pragma unroll
        for (int q = 0; q < 4; ++q) ok[4 * u + q] = (m >> (8 * q)) & 255u;
      }
    } else {
#pragma unroll
      for (int u = 0; u < CK_UNROLL; ++u) {
        const int j = col(i0, u);
        ok[u] = j < hi && (mm == nullptr || mm[j] != 0);
        v[u] = j < hi ? dd[j] : INFINITY;
      }
    }
  }
};

// Slice sl of S of a row of C: [lo, hi), its length a multiple of 4 with
// VEC.
template <bool VEC>
__device__ __forceinline__ void slice_bounds(int C, int sl, int S, int* lo,
                                             int* hi) {
  int len = (C + S - 1) / S;
  if (VEC) len = (len + 3) & ~3;
  *lo = min(C, sl * len);
  *hi = min(C, *lo + len);
}

// Block (s, b): where query b has no bar from its running list, count the
// keys' top HIST_BITS bits of slice s of its chunk (d [B, C], mask as in
// chunk_topk_kernel) into hist [B][HIST_BINS]; the query's last block to
// arrive writes hbar[b], the first key past the bin that holds the kc-th
// entry (NO_KEY when fewer than kc are finite), and zeroes the counts.
template <bool VEC>
__global__ void __launch_bounds__(NT) chunk_hist_kernel(
    const float* __restrict__ d, const uint8_t* __restrict__ mask,
    long long mask_stride, int C, int kc, const float* __restrict__ run_v,
    const int* __restrict__ run_r, int k, int* __restrict__ hist,
    int* __restrict__ arrive, unsigned long long* __restrict__ hbar) {
  __shared__ int h[HIST_BINS];
  __shared__ int s_warp[NT / 32];
  __shared__ int s_last;
  const int sl = blockIdx.x, S = gridDim.x, b = blockIdx.y, t = threadIdx.x;
  if (run_bar(run_v, run_r, k, b) != NO_KEY) return;  // the list bounds it
  for (int i = t; i < HIST_BINS; i += NT) h[i] = 0;
  __syncthreads();
  int lo, hi;
  slice_bounds<VEC>(C, sl, S, &lo, &hi);
  const float* dd = d + (size_t)b * C;
  const uint8_t* mm = mask ? mask + (size_t)b * mask_stride : nullptr;
  using TL = Tile<VEC>;
  for (int i0 = lo; i0 < hi; i0 += TL::STEP) {
    float v[TL::E];
    bool ok[TL::E];
    TL::load(dd, mm, i0, hi, v, ok);
#pragma unroll
    for (int e = 0; e < TL::E; ++e) {
      const unsigned dk = dist_key(v[e]);
      if (ok[e] && finite_key(dk)) atomicAdd(&h[dk >> (32 - HIST_BITS)], 1);
    }
  }
  __syncthreads();
  int* hb = hist + (size_t)b * HIST_BINS;
  for (int i = t; i < HIST_BINS; i += NT)
    if (h[i]) atomicAdd(hb + i, h[i]);
  __threadfence();
  __syncthreads();
  if (t == 0) s_last = atomicAdd(arrive + b, 1) == S - 1;
  __syncthreads();
  if (!s_last) return;
  // the last block of the query: every count is in
  __threadfence();
  constexpr int PER = HIST_BINS / NT;
  int c[PER], sum = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    c[j] = __ldcg(hb + t * PER + j);
    sum += c[j];
    hb[t * PER + j] = 0;  // ready for the next launch
  }
  int total;
  const int before = block_excl_sum(sum, s_warp, &total);
  if (before < kc && before + sum >= kc) {
    int cum = before, j = 0;
    while (cum + c[j] < kc) cum += c[j++];
    const int bin = t * PER + j;
    hbar[b] = bin + 1 < HIST_BINS
                  ? (unsigned long long)(bin + 1) << (64 - HIST_BITS)
                  : NO_KEY;
  }
  if (t == 0) {
    if (total < kc) hbar[b] = NO_KEY;
    arrive[b] = 0;
  }
}

// Block (s, b): append the keys of slice s of query b's chunk (rows start
// ..) that order strictly before the bar (the running list's k-th, else
// hbar[b]) to surv [B][C], counted in cnt[b].
template <bool VEC>
__global__ void __launch_bounds__(NT) chunk_filter_kernel(
    const float* __restrict__ d, const uint8_t* __restrict__ mask,
    long long mask_stride, int C, int start, const float* __restrict__ run_v,
    const int* __restrict__ run_r, int k,
    const unsigned long long* __restrict__ hbar, int* __restrict__ cnt,
    unsigned long long* __restrict__ surv) {
  const int sl = blockIdx.x, S = gridDim.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  unsigned long long bar = run_bar(run_v, run_r, k, b);
  if (bar == NO_KEY) bar = hbar[b];
  int lo, hi;
  slice_bounds<VEC>(C, sl, S, &lo, &hi);
  const float* dd = d + (size_t)b * C;
  const uint8_t* mm = mask ? mask + (size_t)b * mask_stride : nullptr;
  unsigned long long* out = surv + (size_t)b * C;
  using TL = Tile<VEC>;
  for (int i0 = lo; i0 < hi; i0 += TL::STEP) {
    float v[TL::E];
    bool ok[TL::E];
    TL::load(dd, mm, i0, hi, v, ok);
    unsigned long long e[TL::E];
    int n = 0;
#pragma unroll
    for (int u = 0; u < TL::E; ++u) {
      e[u] = ok[u] ? entry_key(v[u], start + TL::col(i0, u)) : NO_KEY;
      n += e[u] < bar;
    }
    int x = n;  // the warp's inclusive prefix of survivors
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, x, off);
      if (lane >= off) x += y;
    }
    const int warp_n = __shfl_sync(FULL, x, 31);
    if (warp_n == 0) continue;  // uniform across the warp
    int base = 0;
    if (lane == 31) base = atomicAdd(cnt + b, warp_n);
    base = __shfl_sync(FULL, base, 31) + x - n;
#pragma unroll
    for (int u = 0; u < TL::E; ++u)
      if (e[u] < bar) out[base++] = e[u];
  }
}


// Block b: masked_topk of a row of N <= SORT_SMEM distances, sorted whole
// in shared memory; the k first written, padded with (+inf, -1).
__global__ void __launch_bounds__(NT) row_sort_topk_kernel(
    const float* __restrict__ d, const uint8_t* __restrict__ mask,
    long long mask_stride, int N, int k, float* __restrict__ out_v,
    int* __restrict__ out_r) {
  extern __shared__ __align__(16) unsigned long long fs[];
  const int b = blockIdx.x, t = threadIdx.x, sz = pow2_at_least(N);
  const float* dd = d + (size_t)b * N;
  const uint8_t* mm = mask ? mask + (size_t)b * mask_stride : nullptr;
  for (int i = t; i < sz; i += NT)
    fs[i] = i < N && (mm == nullptr || mm[i] != 0) ? entry_key(dd[i], i)
                                                    : NO_KEY;
  __syncthreads();
  block_sort(fs, sz);
  float* ov = out_v + (size_t)b * k;
  int* orow = out_r + (size_t)b * k;
  for (int j = t; j < k; j += NT) {
    const unsigned long long key = j < sz ? fs[j] : NO_KEY;
    const bool ok = key != NO_KEY;
    ov[j] = ok ? key_dist((unsigned)(key >> 32)) : INFINITY;
    orow[j] = ok ? (int)((unsigned)key ^ 0x80000000u) : -1;
  }
}

// The filtered select of one chunk (rows start ..) into out_v / out_r:
// three launches.
inline cudaError_t launch_filtered(const float* d, const uint8_t* mask,
                                   long long mask_stride, int B, int C,
                                   int kc, int start, const float* run_v,
                                   const int* run_r, int k,
                                   const FilterScratch& f, float* out_v,
                                   int* out_r, cudaStream_t stream) {
  static int cap[64] = {0};
  const int smem =
      (SORT_SMEM + (run_v != nullptr && k <= RUN_SMEM ? k : 0)) * 8;
  cudaError_t e = raise_smem_cap(
      reinterpret_cast<const void*>(chunk_finish_kernel), smem, cap);
  if (e != cudaSuccess) return e;
  const dim3 grid(scan_slices(B, C), B);
  const bool vec = C % 4 == 0 && reinterpret_cast<uintptr_t>(d) % 16 == 0 &&
                   (mask == nullptr ||
                    (reinterpret_cast<uintptr_t>(mask) % 4 == 0 &&
                     mask_stride % 4 == 0));
  if (vec)
    chunk_hist_kernel<true><<<grid, NT, 0, stream>>>(
        d, mask, mask_stride, C, kc, run_v, run_r, k, f.hist, f.arrive,
        f.hbar);
  else
    chunk_hist_kernel<false><<<grid, NT, 0, stream>>>(
        d, mask, mask_stride, C, kc, run_v, run_r, k, f.hist, f.arrive,
        f.hbar);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (vec)
    chunk_filter_kernel<true><<<grid, NT, 0, stream>>>(
        d, mask, mask_stride, C, start, run_v, run_r, k, f.hbar, f.cnt,
        f.surv);
  else
    chunk_filter_kernel<false><<<grid, NT, 0, stream>>>(
        d, mask, mask_stride, C, start, run_v, run_r, k, f.hbar, f.cnt,
        f.surv);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  chunk_finish_kernel<<<B, FIN_NT, smem, stream>>>(
      f.surv, C, f.cnt, kc, f.lists, pow2_at_least(kc), run_v, run_r, k,
      out_v, out_r);
  return cudaGetLastError();
}

// The fused chunk step's launch (its scratch's head zero).
inline cudaError_t launch_fused(const float* d, const uint8_t* mask,
                                long long mask_stride, int B, int C, int kc,
                                int start, const float* run_v,
                                const int* run_r, int k, void* work,
                                float* out_v, int* out_r,
                                cudaStream_t stream) {
  static int cap[64] = {0};
  const int S = chunk_slices(B, C, kc);
  const int kpad = pow2_at_least(k);
  const size_t scan = (size_t)(NT / 32) * kc * 8;
  const size_t merge = ((size_t)S * kc + kpad) * 8;
  const int smem = (int)(scan > merge ? scan : merge);
  cudaError_t e = raise_smem_cap(
      reinterpret_cast<const void*>(chunk_topk_kernel), smem, cap);
  if (e != cudaSuccess) return e;
  unsigned char* p = static_cast<unsigned char*>(work);
  int* arrive = reinterpret_cast<int*>(p);
  unsigned long long* gbar =
      reinterpret_cast<unsigned long long*>(p + chunk_arrive_bytes(B));
  unsigned long long* cand =
      reinterpret_cast<unsigned long long*>(p + chunk_head_bytes(B));
  chunk_topk_kernel<<<dim3(S, B), NT, smem, stream>>>(
      d, mask, mask_stride, C, start, kc, run_v, run_r, k, kpad, cand, arrive,
      gbar, out_v, out_r);
  return cudaGetLastError();
}

// Bytes of a step's scratch, by its route, and of its head (zero before
// the first step).
inline long long step_scratch_bytes(int B, int C, int kc, int k) {
  if (fused_route(kc, k))
    return (long long)(chunk_head_bytes(B) +
                       (size_t)B * chunk_slices(B, C, kc) * kc * 8);
  return (long long)filter_layout(B, C, kc).total;
}

inline long long step_head_bytes(int B, int C, int kc, int k) {
  return (long long)(fused_route(kc, k) ? chunk_head_bytes(B)
                                        : filter_layout(B, C, kc).hbar);
}

// masked_topk's route: a row sort up to SORT_SMEM, the fused kernel at k
// <= 256, else the filtered select.
inline bool row_sort_route(int N) { return N <= SORT_SMEM; }

}  // namespace fvdb

// Bytes of scratch a chunk step of B queries of C distances at kc = min(k,
// C) needs (zero before the first step; each step leaves it so): at kc <=
// 256 and k <= 2,048 (the fused kernel) arrival counts [B] | published bars
// [B] | slice lists [B][S][kc] keys; else the filtered select's
// (FilterScratch), whose survivor buffer holds [B][C] keys.
FVDB_EXPORT long long fvdb_chunk_scratch_bytes(int B, int C, int kc, int k) {
  using namespace fvdb;
  if (B < 1 || C < 1 || kc < 1 || k < kc) return 0;
  return step_scratch_bytes(B, C, kc, k);
}

// The bytes of that scratch's head, which must be zero.
FVDB_EXPORT long long fvdb_chunk_scratch_head(int B, int C, int kc, int k) {
  using namespace fvdb;
  if (B < 1 || C < 1 || kc < 1 || k < kc) return 0;
  return step_head_bytes(B, C, kc, k);
}

// va/ra [B, ka], vb/rb [B, kb] -> out_v/out_r [B, k].
FVDB_EXPORT int fvdb_merge_topk(const float* va, const int* ra, int ka,
                                const float* vb, const int* rb, int kb, int B,
                                int k, float* out_v, int* out_r,
                                cudaStream_t stream) {
  using namespace fvdb;
  if (B < 1 || k < 1 || ka < 0 || kb < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  merge_topk_kernel<<<B, NT, 0, stream>>>(va, ra, ka, vb, rb, kb, 0, k,
                                          out_v, out_r);
  return static_cast<int>(cudaGetLastError());
}

// One chunk of chunked_topk: d [B, C] distances of rows start .. start +
// C - 1, mask [B or 1, C] uint8 (mask_stride C or 0; null: every entry),
// read in place; run_v / run_r [B, k] the running list, sorted by (value,
// row) with its padding last as every step leaves it (null: none), merged
// with the chunk's kc = min(k, C) best into out_v / out_r [B, k] (not the
// running list); work: work_bytes >= fvdb_chunk_scratch_bytes(B, C, kc, k)
// bytes whose head is zero, as the step leaves it.
FVDB_EXPORT int fvdb_chunk_step(const float* d, const uint8_t* mask,
                                long long mask_stride, int B, int C, int kc,
                                int start, const float* run_v,
                                const int* run_r, int k, void* work,
                                long long work_bytes, float* out_v,
                                int* out_r, cudaStream_t stream) {
  using namespace fvdb;
  if (B < 1 || B > 65535 || C < 1 || kc < 1 || kc > C || k < kc ||
      (kc < k && kc < C) || work == nullptr ||
      work_bytes < step_scratch_bytes(B, C, kc, k))
    return static_cast<int>(cudaErrorInvalidValue);
  if (fused_route(kc, k))
    return static_cast<int>(launch_fused(d, mask, mask_stride, B, C, kc,
                                         start, run_v, run_r, k, work, out_v,
                                         out_r, stream));
  return static_cast<int>(launch_filtered(
      d, mask, mask_stride, B, C, kc, start, run_v, run_r, k,
      carve_filter(work, filter_layout(B, C, kc)), out_v, out_r, stream));
}

// Bytes of scratch masked_topk of B rows of N at k needs (0 for the row
// sort); its head need not be zero.
FVDB_EXPORT long long fvdb_masked_topk_scratch_bytes(int B, int N, int k) {
  using namespace fvdb;
  if (B < 1 || N < 1 || k < 1 || row_sort_route(N)) return 0;
  return step_scratch_bytes(B, N, k < N ? k : N, k);
}

// masked_topk: d [B, N], mask [B or 1, N] (mask_stride N or 0; null: every
// entry), read in place; work: fvdb_masked_topk_scratch_bytes(B, N, k)
// bytes; out_d / out_r [B, k], any k >= 1. One launch at N <= SORT_SMEM or
// k <= 256 (after zeroing the fused kernel's head), else the filtered
// select with no running list.
FVDB_EXPORT int fvdb_masked_topk(const float* d, const uint8_t* mask,
                                 long long mask_stride, int B, int N, int k,
                                 void* work, long long work_bytes,
                                 float* out_d, int* out_r,
                                 cudaStream_t stream) {
  using namespace fvdb;
  if (B < 1 || B > 65535 || N < 1 || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (row_sort_route(N)) {
    row_sort_topk_kernel<<<B, NT, pow2_at_least(N) * 8, stream>>>(
        d, mask, mask_stride, N, k, out_d, out_r);
    return static_cast<int>(cudaGetLastError());
  }
  const int kc = k < N ? k : N;
  if (work == nullptr || work_bytes < step_scratch_bytes(B, N, kc, k))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e =
      cudaMemsetAsync(work, 0, step_head_bytes(B, N, kc, k), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (fused_route(kc, k))
    return static_cast<int>(launch_fused(d, mask, mask_stride, B, N, kc, 0,
                                         nullptr, nullptr, k, work, out_d,
                                         out_r, stream));
  return static_cast<int>(launch_filtered(
      d, mask, mask_stride, B, N, kc, 0, nullptr, nullptr, k,
      carve_filter(work, filter_layout(B, N, kc)), out_d, out_r, stream));
}
