// K8's merge: two top-k lists of each query into one.
//
// Replaces the JAX package's merge_topk (ops/topk.py:61), which the
// reduced-rank calibration oracle (_oracle_step, index/fused.py:206) calls
// once a streamed corpus block to fold the block's top-k into the running
// one. Per query b: the entries of (va[b], ra[b]) and (vb[b], rb[b]) ranked
// by (value, row), ties of both by position (a's first), and the k first
// written out; an entry whose value is not finite comes out as (+inf, -1).
// The inputs need not be sorted.
//
// What bounds it: at the oracle's shape (128 probes, two lists of 11) it
// moves 128 * 44 * 8 bytes, a few microseconds of launch; the work is
// (ka + kb)^2 comparisons a query.
//
// Design: one block a query. Each thread ranks its entries by counting the
// entries that order before them (reading both lists through the cache);
// an entry of rank < k writes itself to that slot. No sort, no shared state.
#include "common.cuh"

namespace fvdb {

__device__ __forceinline__ void entry(const float* va, const int* ra, int ka,
                                      const float* vb, const int* rb, int i,
                                      float* v, int* r) {
  const float x = i < ka ? va[i] : vb[i - ka];
  *r = i < ka ? ra[i] : rb[i - ka];
  *v = isfinite(x) ? x : INFINITY;
}

__global__ void __launch_bounds__(NT) merge_topk_kernel(
    const float* __restrict__ va, const int* __restrict__ ra, int ka,
    const float* __restrict__ vb, const int* __restrict__ rb, int kb, int k,
    float* __restrict__ out_v, int* __restrict__ out_r) {
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
    entry(va, ra, ka, vb, rb, i, &v, &r);
    int rank = 0;
    for (int j = 0; j < n; ++j) {
      float w;
      int s;
      entry(va, ra, ka, vb, rb, j, &w, &s);
      rank += w < v || (w == v && (s < r || (s == r && j < i)));
    }
    if (rank < k) {
      const bool ok = v < INFINITY;
      out_v[rank] = ok ? v : INFINITY;
      out_r[rank] = ok ? r : -1;
    }
  }
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
  merge_topk_kernel<<<B, NT, 0, stream>>>(va, ra, ka, vb, rb, kb, k, out_v,
                                          out_r);
  return static_cast<int>(cudaGetLastError());
}
