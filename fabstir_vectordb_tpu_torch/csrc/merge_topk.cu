// K8's merge: two top-k lists of each query into one; and chunked_topk's
// step, a chunk's masked top-k merged into a running list.
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
// kc = min(k, chunk) <= 256 its step is one launch, chunk_topk_kernel below.
// Above, it is a composition of ported kernels: a pass that writes +inf
// where the mask is False, topk_select.cuh's radix select over the chunk
// (whose keys order negative distances, so any dist_fn may be given) and
// the merge above with b_base = start.
//
// masked_topk (ops/topk.py:20) over a given [B, N] distance matrix is the
// chunk step's first two parts on one chunk of N rows, with no running
// list: the mask pass, then the radix select straight into the [B, k]
// output, which pads with (+inf, -1) where fewer than k entries are valid
// (k > N included). A distance that is not finite never enters.
//
// What bounds it: at the oracle's shape (128 probes, two lists of 11) the
// merge moves 128 * 44 * 8 bytes, a few microseconds of launch; the work is
// (ka + kb)^2 comparisons a query. A chunk step has to read the chunk's
// distances and mask once (16 MB at B = 32, chunk = 131,072: ~5 us of HBM),
// so at that size launches and host time set its pace.
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
#include "common.cuh"
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

// out[b, j] = d[b, j] where mask[b * mask_stride + j], else +inf.
__global__ void __launch_bounds__(NT) mask_chunk_kernel(
    const float* __restrict__ d, const uint8_t* __restrict__ mask,
    long long mask_stride, int B, int C, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * NT + threadIdx.x;
  if (i >= (long long)B * C) return;
  const long long b = i / C, j = i % C;
  out[i] = mask[b * mask_stride + j] ? d[i] : INFINITY;
}

constexpr int CK_MAX = 256;        // kc the fused chunk step takes
constexpr int CK_MAX_RUN = 2048;   // running k it takes
constexpr int CK_UNROLL = 8;       // distances a thread loads at once
constexpr int CK_BLOCKS = 528;     // blocks a step aims for: 4 an SM
constexpr int CK_SLICES = 64;      // slices of a query at most
constexpr int CK_CANDS = 4096;     // slices * kc at most
constexpr int CK_MIN_SLICE = 1024; // distances a slice at least
constexpr unsigned long long NO_KEY = ~0ull;  // an empty slot

// The order key of (v, r): (value, row) with signed rows; NO_KEY when v is
// not finite.
__device__ __forceinline__ unsigned long long entry_key(float v, int r) {
  const unsigned dk = dist_key(v);
  return finite_key(dk) ? ((unsigned long long)dk << 32) |
                              ((unsigned)r ^ 0x80000000u)
                        : NO_KEY;
}

// Entries of the sorted keys a[0 .. n) below `key` (or at most `key`).
__device__ __forceinline__ int count_before(const unsigned long long* a,
                                            int n, unsigned long long key,
                                            bool or_equal) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const bool before = or_equal ? a[mid] <= key : a[mid] < key;
    if (before) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Entries of the sorted list (d, r)[0 .. n) that order before (v, row).
__device__ __forceinline__ int count_before(const float* d, const int* r,
                                            int n, float v, int row) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (lex_less(d[mid], r[mid], v, row)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

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

}  // namespace fvdb

// Bytes of scratch the fused chunk step needs for B queries of C distances
// at kc <= 256: arrival counts [B] | published bars [B] (both zeroed once,
// before the first step) | slice lists [B][S][kc] 64-bit keys.
FVDB_EXPORT long long fvdb_chunk_scratch_bytes(int B, int C, int kc) {
  using namespace fvdb;
  if (B < 1 || C < 1 || kc < 1) return 0;
  return (long long)(chunk_head_bytes(B) +
                     (size_t)B * chunk_slices(B, C, kc) * kc * 8);
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
// C - 1, mask [B or 1, C] uint8 (mask_stride C or 0; null: every entry);
// masked [B, C] scratch (unused without a mask); work:
// fvdb_select_scratch_bytes(B, kc) bytes; cand_v / cand_r [B, kc] scratch;
// run_v / run_r [B, k] the running list, merged with the chunk's kc best
// into out_v / out_r [B, k] (not the running list).
FVDB_EXPORT int fvdb_chunk_step(const float* d, const uint8_t* mask,
                                long long mask_stride, int B, int C, int kc,
                                int start, float* masked, void* work,
                                float* cand_v, int* cand_r,
                                const float* run_v, const int* run_r, int k,
                                float* out_v, int* out_r,
                                cudaStream_t stream) {
  using namespace fvdb;
  if (B < 1 || C < 1 || kc < 1 || kc > C || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* src = d;
  if (mask != nullptr) {
    const long long n = (long long)B * C;
    mask_chunk_kernel<<<(unsigned)((n + NT - 1) / NT), NT, 0, stream>>>(
        d, mask, mask_stride, B, C, masked);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    src = masked;
  }
  cudaError_t e = launch_select_topk(src, nullptr, nullptr, C, B, kc, work,
                                     cand_v, cand_r, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  merge_topk_kernel<<<B, NT, 0, stream>>>(run_v, run_r, k, cand_v, cand_r,
                                          kc, start, k, out_v, out_r);
  return static_cast<int>(cudaGetLastError());
}

// One chunk of chunked_topk at kc = min(k, C) <= 256 and k <= 2,048, one
// launch: d [B, C] distances of rows start .. start + C - 1, mask [B or 1,
// C] uint8 (mask_stride C or 0; null: every entry), read in place; run_v /
// run_r [B, k] the running list (null: none), merged with the chunk's kc
// best into out_v / out_r [B, k] (not the running list); work:
// work_bytes >= fvdb_chunk_scratch_bytes(B, C, kc) bytes whose head (the
// arrival counts and published bars) is zero, as the step leaves it.
FVDB_EXPORT int fvdb_chunk_step_fused(const float* d, const uint8_t* mask,
                                      long long mask_stride, int B, int C,
                                      int kc, int start, const float* run_v,
                                      const int* run_r, int k, void* work,
                                      long long work_bytes, float* out_v,
                                      int* out_r, cudaStream_t stream) {
  using namespace fvdb;
  if (B < 1 || B > 65535 || C < 1 || kc < 1 || kc > CK_MAX || kc > C ||
      k < kc || k > CK_MAX_RUN || work == nullptr ||
      work_bytes < fvdb_chunk_scratch_bytes(B, C, kc))
    return static_cast<int>(cudaErrorInvalidValue);
  static int cap[64] = {0};
  const int S = chunk_slices(B, C, kc);
  const int kpad = pow2_at_least(k);
  const size_t scan = (size_t)(NT / 32) * kc * 8;
  const size_t merge = ((size_t)S * kc + kpad) * 8;
  const int smem = (int)(scan > merge ? scan : merge);
  cudaError_t e = raise_smem_cap(
      reinterpret_cast<const void*>(chunk_topk_kernel), smem, cap);
  if (e != cudaSuccess) return static_cast<int>(e);
  unsigned char* p = static_cast<unsigned char*>(work);
  int* arrive = reinterpret_cast<int*>(p);
  unsigned long long* gbar =
      reinterpret_cast<unsigned long long*>(p + chunk_arrive_bytes(B));
  unsigned long long* cand =
      reinterpret_cast<unsigned long long*>(p + chunk_head_bytes(B));
  chunk_topk_kernel<<<dim3(S, B), NT, smem, stream>>>(
      d, mask, mask_stride, C, start, kc, run_v, run_r, k, kpad, cand, arrive,
      gbar, out_v, out_r);
  return static_cast<int>(cudaGetLastError());
}

// masked_topk: d [B, N], mask [B or 1, N] (mask_stride N or 0; null: every
// entry); masked [B, N] scratch (unused without a mask); work:
// fvdb_select_scratch_bytes(B, k) bytes; out_d / out_r [B, k], any k >= 1.
FVDB_EXPORT int fvdb_masked_topk(const float* d, const uint8_t* mask,
                                 long long mask_stride, int B, int N, int k,
                                 float* masked, void* work, float* out_d,
                                 int* out_r, cudaStream_t stream) {
  using namespace fvdb;
  if (B < 1 || N < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const float* src = d;
  if (mask != nullptr) {
    const long long n = (long long)B * N;
    mask_chunk_kernel<<<(unsigned)((n + NT - 1) / NT), NT, 0, stream>>>(
        d, mask, mask_stride, B, N, masked);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    src = masked;
  }
  return static_cast<int>(launch_select_topk(src, nullptr, nullptr, N, B, k,
                                             work, out_d, out_r, stream));
}
