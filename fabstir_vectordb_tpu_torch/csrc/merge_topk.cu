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
// masked top-k (rows offset by start) merges into the running [B, k]. Its
// step here is a composition of ported kernels: a pass that writes +inf
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
// (ka + kb)^2 comparisons a query. A chunk step reads the chunk's distances
// and mask once for the mask pass and ~4 times in the select's passes.
//
// Design: one block a query. Each thread ranks its entries by counting the
// entries that order before them (reading both lists through the cache);
// an entry of rank < k writes itself to that slot. No sort, no shared state.
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

}  // namespace fvdb

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
