// The end of a filtered select, shared by csrc/merge_topk.cu (the chunk
// step and masked_topk past k = 256) and tile_filter.cuh (the filter
// route of K14's stage 1 and of K1 on f32 rows): 64-bit order keys of (distance, row), the radix select of a
// query's keys inside one block, and the finishing kernel that sorts a
// query's survivors (the kc smallest, by that select, past SORT_SMEM) and
// merges them with a sorted running list. csrc/merge_topk.cu's header says
// how the survivors are filtered.
#pragma once

#include "common.cuh"
#include "topk_select.cuh"

namespace fvdb {

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

// The running list's k-th key (NO_KEY while it is padded, or with none).
__device__ __forceinline__ unsigned long long run_bar(const float* run_v,
                                                      const int* run_r, int k,
                                                      int b) {
  if (run_v == nullptr) return NO_KEY;
  const size_t i = (size_t)b * k + k - 1;
  return entry_key(run_v[i], run_r[i]);
}

// Entries of the sorted running list (v, r)[0 .. n) whose key orders before
// `key` (or at most `key`).
__device__ __forceinline__ int count_run(const float* v, const int* r, int n,
                                         unsigned long long key,
                                         bool or_equal) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const unsigned long long e = entry_key(v[mid], r[mid]);
    if (or_equal ? e <= key : e < key) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Bitonic sort of a[0 .. sz) ascending by the whole block (sz a power of
// two; a in shared or global memory), one compare-exchange a pair.
__device__ void block_sort(unsigned long long* a, int sz) {
  for (int len = 2; len <= sz; len <<= 1) {
    for (int j = len >> 1; j > 0; j >>= 1) {
      for (int q = threadIdx.x; q < (sz >> 1); q += blockDim.x) {
        const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1)), p = i + j;
        const unsigned long long x = a[i], y = a[p];
        if ((x > y) == ((i & len) == 0)) {
          a[i] = y;
          a[p] = x;
        }
      }
      __syncthreads();
    }
  }
}

// The radix select of topk_select.cuh inside one block: the m = min(k, n)
// smallest of the n keys a[0 .. n) (a key may repeat: K14's stage 1 pads
// with (+inf, -1)), written unsorted to out[0 .. m); returns m. A pass
// histograms one 8-bit digit (from the top) of the keys that share the
// digits resolved so far (one shared atomic per distinct digit of a
// warp), warp 0 picks the digit that holds the m-th key, and the passes
// stop once that digit's keys are taken whole; then every key below the
// prefix is written out, and of the keys at it as many as fill m. h
// [256], s_state [2] and s_cnt are shared.
__device__ int block_select_keys(const unsigned long long* __restrict__ a,
                                 int n, int k, unsigned long long* out,
                                 int* h, unsigned long long* s_state,
                                 int* s_cnt) {
  constexpr int U = 4;  // keys a thread loads at once
  const int t = threadIdx.x, T = blockDim.x, m = min(k, n);
  unsigned long long prefix = 0ull;
  int krem = m, shift = 0;
  for (int pass = 0; pass < SEL_PASSES; ++pass) {
    const int s = 56 - 8 * pass;
    for (int i = t; i < 256; i += T) h[i] = 0;
    __syncthreads();
    for (int i0 = 0; i0 < n; i0 += T * U) {  // the same trip count in a block
      unsigned long long c[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = i0 + u * T + t;
        c[u] = j < n ? a[j] : 0ull;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const bool take = i0 + u * T + t < n &&
                          (pass == 0 || (c[u] >> (s + 8)) == (prefix >> (s + 8)));
        const unsigned bin = (unsigned)(c[u] >> s) & 255u;
        const unsigned mk = __ballot_sync(FULL, take);
        if (take) {
          const unsigned peers = __match_any_sync(mk, bin);
          if ((__ffs(peers) - 1) == (t & 31)) atomicAdd(&h[bin], __popc(peers));
        }
      }
    }
    __syncthreads();
    if (t < 32) {  // warp 0: lane l holds digits 8l .. 8l + 7
      int sum = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) sum += h[t * 8 + q];
      int x = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(FULL, x, off);
        if (t >= off) x += y;
      }
      if (x - sum < krem && x >= krem) {
        int cum = x - sum, dig = t * 8;
        while (cum + h[dig] < krem) cum += h[dig++];
        s_state[0] = prefix | ((unsigned long long)dig << s);
        s_state[1] = (unsigned long long)(unsigned)(krem - cum) |
                     ((unsigned long long)(h[dig] == krem - cum) << 32);
      }
    }
    __syncthreads();
    prefix = s_state[0];
    krem = (int)(unsigned)(s_state[1] & 0xffffffffull);
    const bool done = (s_state[1] >> 32) != 0ull;
    shift = s;
    __syncthreads();  // h and s_state are written again by the next pass
    if (done) break;
  }
  // the keys before the m-th key's bin (m - krem of them) and then as many
  // of the bin's as it takes: keys that repeat (a pad) can fill the bin
  // past m, and must not push a smaller key out
  if (t == 0) {
    *s_cnt = 0;
    h[0] = 0;
  }
  __syncthreads();
  const unsigned long long top = prefix >> shift;
  const int below = m - krem;
  for (int i = t; i < n; i += T) {
    const unsigned long long c = a[i];
    if ((c >> shift) < top) {
      out[atomicAdd(s_cnt, 1)] = c;
    } else if ((c >> shift) == top) {
      const int pos = below + atomicAdd(h, 1);
      if (pos < m) out[pos] = c;
    }
  }
  __syncthreads();
  return m;
}

constexpr int FIN_NT = 1024;     // threads of a finishing block
constexpr int RUN_SMEM = 4096;   // running keys it holds in shared memory

// Block b: query b's chunk list, its cnt[b] survivors (a count past the
// buffer's C, an overflow that the caller reads elsewhere, is cut to C; at
// most SORT_SMEM: all of them; else the kc smallest, by block_select_keys, into shared
// memory or, at kc > SORT_SMEM, lists [B][list_pad]), sorted, merged with
// the sorted running list (null: none; its keys in shared memory up to
// RUN_SMEM) by binary search into out_v / out_r [B, k], padded with (+inf,
// -1); cnt[b] zeroed for the next step.
__global__ void __launch_bounds__(FIN_NT) chunk_finish_kernel(
    const unsigned long long* __restrict__ surv, long long C,
    int* __restrict__ cnt, int kc, unsigned long long* __restrict__ lists,
    int list_pad, const float* __restrict__ run_v,
    const int* __restrict__ run_r, int k, float* __restrict__ out_v,
    int* __restrict__ out_r) {
  extern __shared__ __align__(16) unsigned long long fs[];
  __shared__ int h[256];
  __shared__ unsigned long long s_state[2];
  __shared__ int s_cnt;
  const int b = blockIdx.x, t = threadIdx.x, T = blockDim.x;
  const int n = (int)min((long long)cnt[b], C);
  const unsigned long long* src = surv + (size_t)b * C;
  unsigned long long* list = fs;
  int m = n;
  if (n <= SORT_SMEM) {
    for (int i = t; i < n; i += T) fs[i] = src[i];
  } else {
    if (kc > SORT_SMEM) list = lists + (size_t)b * list_pad;
    m = block_select_keys(src, n, kc, list, h, s_state, &s_cnt);
  }
  const int sz = pow2_at_least(m > 1 ? m : 1);
  for (int i = m + t; i < sz; i += T) list[i] = NO_KEY;
  const float* rv = run_v ? run_v + (size_t)b * k : nullptr;
  const int* rr = run_r ? run_r + (size_t)b * k : nullptr;
  unsigned long long* rk = fs + SORT_SMEM;
  const bool held = rv != nullptr && k <= RUN_SMEM;
  for (int i = t; held && i < k; i += T) rk[i] = entry_key(rv[i], rr[i]);
  __syncthreads();
  block_sort(list, sz);
  const int nr = rv == nullptr ? 0
                 : held       ? count_before(rk, k, NO_KEY, false)
                              : count_run(rv, rr, k, NO_KEY, false);
  float* ov = out_v + (size_t)b * k;
  int* orow = out_r + (size_t)b * k;
  for (int i = t; i < nr; i += T) {  // running entries first at equal keys
    const unsigned long long key = held ? rk[i] : entry_key(rv[i], rr[i]);
    const int rank = i + count_before(list, m, key, false);
    if (rank < k) {
      ov[rank] = rv[i];
      orow[rank] = rr[i];
    }
  }
  const int mk = m < k ? m : k;
  for (int j = t; j < mk; j += T) {
    const unsigned long long key = list[j];
    const int rank = j + (nr == 0 ? 0
                          : held ? count_before(rk, nr, key, true)
                                 : count_run(rv, rr, nr, key, true));
    if (rank < k) {
      ov[rank] = key_dist((unsigned)(key >> 32));
      orow[rank] = (int)((unsigned)key ^ 0x80000000u);
    }
  }
  for (int j = min(nr + m, k) + t; j < k; j += T) {
    ov[j] = INFINITY;
    orow[j] = -1;
  }
  if (t == 0) cnt[b] = 0;  // every thread read it before the syncs above
}

}  // namespace fvdb
