// Exact top-k by (distance, row) over long rows of candidates, for any k:
// K1's path for k > 256 (csrc/l2_topk.cu) and K12's selection
// (csrc/ivf_scan.cu) both end in it.
//
// What bounds it: each pass reads the candidates once (4 bytes a distance,
// and 4 more a row in the passes that resolve rows), so n candidates cost
// 4n bytes a pass and most queries finish after the four passes over the
// distance bits. The sort of the k survivors is k log^2 k compare-exchanges
// inside one block.
//
// Design: a candidate's order is the 64-bit number (distance key << 32 |
// row), with common.cuh's dist_key, whose unsigned order is the float
// order, negative distances included; the row breaks ties toward the lower
// row, as the plain versions' stable sorts do. A radix select resolves that
// number 8 bits a pass until the bin that holds the k-th candidate is taken
// whole; +inf (and any distance that is not finite) never enters. A pass is one launch
// over a grid of (slices, queries), so a few queries still fill the card,
// and a block's slice is its share of its own query's candidates, so short
// rows in a long buffer leave no block idle: each block histograms its
// slice in shared memory (one atomic per distinct bin of a warp, since near
// distances share their high bits), adds it to the query's histogram in
// global memory, and the last block of the query to arrive picks the digit
// and writes the query's state for the next pass.
// Then each block compacts its slice's selected candidates, and one block a
// query bitonic-sorts them (in shared memory up to SORT_SMEM entries, else
// in place in the global buffer) and writes them out, padded with (+inf,
// -1).
#pragma once

#include "common.cuh"

namespace fvdb {

constexpr int SORT_SMEM = 4096;            // entries sorted in shared memory
constexpr int SEL_PASSES = 8;              // 8-bit digits of 64 bits
constexpr int SEL_BLOCKS = 528;            // blocks a pass aims for: 4 an SM

struct SelState {              // a query's selection, across launches
  unsigned long long prefix;   // the digits resolved so far
  int shift;                   // bits below it are unresolved
  int krem;                    // candidates still to take at the prefix
  int k;                       // min(k, finite candidates)
  int done;                    // the threshold is known
  int nfin;                    // finite candidates (pass 0)
  int cnt;                     // compacted so far
};

// The layout of a selection's scratch: states [B] | histograms [B][8][256]
// | arrival counts [B][8] (these three zeroed per call) | buffer [B][k_pad].
struct SelScratch {
  SelState* st;
  int* hist;
  int* arrive;
  unsigned long long* buf;
  size_t zero_bytes;
};

__host__ __device__ inline int pow2_at_least(int k) {
  int p = 1;
  while (p < k) p <<= 1;
  return p;
}

inline size_t round_up16(size_t n) { return (n + 15) / 16 * 16; }

// Sizes of the three zeroed parts, then the total with the buffer.
inline void select_sizes(int B, int k, size_t* st, size_t* hist,
                         size_t* arrive, size_t* total) {
  *st = round_up16((size_t)B * sizeof(SelState));
  *hist = round_up16((size_t)B * SEL_PASSES * 256 * 4);
  *arrive = round_up16((size_t)B * SEL_PASSES * 4);
  *total = *st + *hist + *arrive + (size_t)B * pow2_at_least(k) * 8;
}

inline SelScratch carve_select(void* base, int B, int k) {
  size_t st, hist, arrive, total;
  select_sizes(B, k, &st, &hist, &arrive, &total);
  unsigned char* p = static_cast<unsigned char*>(base);
  SelScratch s;
  s.st = reinterpret_cast<SelState*>(p);
  s.hist = reinterpret_cast<int*>(p + st);
  s.arrive = reinterpret_cast<int*>(p + st + hist);
  s.buf = reinterpret_cast<unsigned long long*>(p + st + hist + arrive);
  s.zero_bytes = st + hist + arrive;
  return s;
}

// The candidates of query b that block x of gridDim.x takes: its share of
// the query's own count, so a short row still spreads over every block.
__device__ __forceinline__ void slice_of(const int* n_per, long long stride,
                                         int b, int* lo, int* hi) {
  const int n = n_per ? n_per[b] : (int)stride;
  const int slice = (n + (int)gridDim.x - 1) / (int)gridDim.x;
  *lo = blockIdx.x * slice;
  *hi = min(n, *lo + slice);
}

// One radix pass over block x's slice of query y's candidates.
__global__ void __launch_bounds__(NT) select_pass_kernel(
    const float* __restrict__ cand_d, const int* __restrict__ cand_r,
    const int* __restrict__ n_per, long long stride, int k, int pass,
    SelState* st, int* hist, int* arrive) {
  const int b = blockIdx.y, t = threadIdx.x;
  SelState* sb = st + b;
  if (sb->done) return;  // the whole query's grid row: an earlier launch
  __shared__ int h[256];
  __shared__ int s_fin, s_last;
  for (int i = t; i < 256; i += NT) h[i] = 0;
  if (t == 0) s_fin = 0;
  __syncthreads();
  const int s = 56 - 8 * pass;
  const unsigned long long prefix = sb->prefix;
  const float* d = cand_d + (size_t)b * stride;
  const int* r = cand_r ? cand_r + (size_t)b * stride : nullptr;
  int lo, hi;
  slice_of(n_per, stride, b, &lo, &hi);
  int fin = 0;
  for (int i0 = lo; i0 < hi; i0 += NT) {  // the same trip count in a block
    const int i = i0 + t;
    bool take = false;
    unsigned bin = 0;
    if (i < hi) {
      const unsigned key = dist_key(d[i]);
      if (finite_key(key)) {
        const int row = s < 32 ? (r ? r[i] : i) : 0;  // rows once needed
        const unsigned long long c =
            ((unsigned long long)key << 32) | (unsigned)row;
        take = pass == 0 || (c >> (s + 8)) == (prefix >> (s + 8));
        bin = (unsigned)(c >> s) & 255u;
      }
    }
    const unsigned m = __ballot_sync(FULL, take);
    if (take) {
      const unsigned peers = __match_any_sync(m, bin);
      if ((__ffs(peers) - 1) == (t & 31)) atomicAdd(&h[bin], __popc(peers));
      ++fin;
    }
  }
  if (pass == 0 && fin) atomicAdd(&s_fin, fin);
  __syncthreads();
  int* hb = hist + ((size_t)b * SEL_PASSES + pass) * 256;
  for (int i = t; i < 256; i += NT)
    if (h[i]) atomicAdd(hb + i, h[i]);
  if (pass == 0 && t == 0 && s_fin) atomicAdd(&sb->nfin, s_fin);
  __threadfence();
  __syncthreads();
  if (t == 0)
    s_last = atomicAdd(arrive + b * SEL_PASSES + pass, 1) ==
             (int)gridDim.x - 1;
  __syncthreads();
  if (!s_last || t != 0) return;
  // the last block of the query: every histogram is in; pick the digit
  __threadfence();
  const int krem = pass == 0 ? min(k, __ldcg(&sb->nfin)) : sb->krem;
  if (pass == 0) sb->k = krem;
  if (krem == 0) {  // no finite candidate at all
    sb->done = 1;
    return;
  }
  int cum = 0, dig = 0, c = __ldcg(hb);
  while (dig < 255 && cum + c < krem) {
    cum += c;
    c = __ldcg(hb + ++dig);
  }
  sb->prefix = prefix | ((unsigned long long)dig << s);
  sb->shift = s;
  sb->krem = krem - cum;
  if (c == krem - cum) sb->done = 1;  // the bin is taken whole
}

// Each block writes its slice's selected candidates to the query's buffer.
__global__ void __launch_bounds__(NT) select_compact_kernel(
    const float* __restrict__ cand_d, const int* __restrict__ cand_r,
    const int* __restrict__ n_per, long long stride, int k_pad, SelState* st,
    unsigned long long* __restrict__ buf) {
  const int b = blockIdx.y, t = threadIdx.x, lane = t & 31;
  SelState* sb = st + b;
  const int kk = sb->k;
  if (kk <= 0) return;  // no candidate, or finished before the passes
  const int shift = sb->shift;
  const unsigned long long top = sb->prefix >> shift;
  const float* d = cand_d + (size_t)b * stride;
  const int* r = cand_r ? cand_r + (size_t)b * stride : nullptr;
  int lo, hi;
  slice_of(n_per, stride, b, &lo, &hi);
  unsigned long long* out = buf + (size_t)b * k_pad;
  for (int i0 = lo; i0 < hi; i0 += NT) {
    const int i = i0 + t;
    bool take = false;
    unsigned long long c = 0ull;
    if (i < hi) {
      const unsigned key = dist_key(d[i]);
      if (finite_key(key)) {
        c = ((unsigned long long)key << 32) | (unsigned)(r ? r[i] : i);
        take = (c >> shift) <= top;
      }
    }
    const unsigned m = __ballot_sync(FULL, take);
    if (m == 0u) continue;  // uniform across the warp
    int base = 0;
    if (lane == 0) base = atomicAdd(&sb->cnt, __popc(m));
    base = __shfl_sync(FULL, base, 0);
    const int pos = base + __popc(m & ((1u << lane) - 1u));
    if (take && pos < kk) out[pos] = c;
  }
}

// One block a query: sort the k' selected candidates, write k, padded.
__global__ void __launch_bounds__(NT) select_sort_kernel(
    const SelState* __restrict__ st, unsigned long long* __restrict__ gbuf,
    int k, int k_pad, float* __restrict__ out_d, int* __restrict__ out_r) {
  extern __shared__ unsigned long long sbuf[];
  const int b = blockIdx.x, t = threadIdx.x;
  const int kk = st[b].k;
  if (kk < 0) return;  // a query finished before the passes
  unsigned long long* g = gbuf + (size_t)b * k_pad;
  unsigned long long* buf = k_pad <= SORT_SMEM ? sbuf : g;
  const int sz = kk > 0 ? pow2_at_least(kk) : 1;
  if (buf == sbuf)
    for (int i = t; i < kk; i += NT) buf[i] = g[i];
  for (int i = kk + t; i < sz; i += NT) buf[i] = ~0ull;
  __syncthreads();
  for (int len = 2; len <= sz; len <<= 1) {
    for (int j = len >> 1; j > 0; j >>= 1) {
      for (int i = t; i < sz; i += NT) {
        const int p = i ^ j;
        if (p > i) {
          const unsigned long long a = buf[i], c = buf[p];
          if ((a > c) == ((i & len) == 0)) {
            buf[i] = c;
            buf[p] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  float* od = out_d + (size_t)b * k;
  int* orow = out_r + (size_t)b * k;
  for (int j = t; j < k; j += NT) {
    if (j < kk) {
      const unsigned long long c = buf[j];
      od[j] = key_dist((unsigned)(c >> 32));
      orow[j] = (int)(unsigned)(c & 0xffffffffull);
    } else {
      od[j] = INFINITY;
      orow[j] = -1;
    }
  }
}

// The grid of a pass: (slices, B), each query's candidates over slices.
inline dim3 select_grid(long long stride, int B, long long per_block) {
  long long slices = (SEL_BLOCKS + B - 1) / B;
  if (per_block > 0 && (stride + per_block - 1) / per_block > slices)
    slices = (stride + per_block - 1) / per_block;
  const long long max_slices = (stride + 2047) / 2048;  // >= 2K a block
  if (slices > max_slices) slices = max_slices;
  if (slices < 1) slices = 1;
  return dim3((unsigned)slices, B);
}

// Zero the selection's state, histograms and arrival counts.
inline cudaError_t select_zero(void* work, int B, int k,
                               cudaStream_t stream) {
  return cudaMemsetAsync(work, 0, carve_select(work, B, k).zero_bytes,
                         stream);
}

// Select the k smallest (distance, row) of each of B rows of candidates:
// the first n_per[b] (without n_per, stride) of row b of cand_d; cand_r ==
// null means a candidate's row is its column. work: fvdb_select_scratch_
// bytes(B, k) bytes. Writes out_* [B, k]. per_block > 0 gives each row at
// least stride / per_block blocks (long rows of many queries: more loads
// in flight than SEL_BLOCKS blocks hold). zeroed: the caller has already
// zeroed the state (select_zero) and may have finished some queries
// (state done = 1, k = -1), which every pass then leaves alone.
inline cudaError_t launch_select_topk(const float* cand_d, const int* cand_r,
                                      const int* n_per, long long stride,
                                      int B, int k, void* work, float* out_d,
                                      int* out_r, cudaStream_t stream,
                                      long long per_block = 0,
                                      bool zeroed = false) {
  if (B < 1 || B > 65535 || k < 1 || stride < 1 || work == nullptr)
    return cudaErrorInvalidValue;
  const SelScratch s = carve_select(work, B, k);
  cudaError_t e = zeroed ? cudaSuccess : select_zero(work, B, k, stream);
  if (e != cudaSuccess) return e;
  const dim3 grid = select_grid(stride, B, per_block);
  for (int pass = 0; pass < SEL_PASSES; ++pass) {
    select_pass_kernel<<<grid, NT, 0, stream>>>(cand_d, cand_r, n_per, stride,
                                                 k, pass, s.st, s.hist,
                                                 s.arrive);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const int k_pad = pow2_at_least(k);
  select_compact_kernel<<<grid, NT, 0, stream>>>(cand_d, cand_r, n_per, stride,
                                                  k_pad, s.st, s.buf);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int smem = k_pad <= SORT_SMEM ? k_pad * 8 : 0;
  select_sort_kernel<<<B, NT, smem, stream>>>(s.st, s.buf, k, k_pad, out_d,
                                               out_r);
  return cudaGetLastError();
}

}  // namespace fvdb

// Bytes of scratch a selection of B rows at k needs.
FVDB_EXPORT long long fvdb_select_scratch_bytes(int B, int k) {
  size_t st, hist, arrive, total;
  fvdb::select_sizes(B, k, &st, &hist, &arrive, &total);
  return (long long)total;
}
