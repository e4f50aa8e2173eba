// K15's cross-shard step: the shard merge, and the sharded build's set-rows.
//
// Replaces the merge that the JAX package's sharded searches run after their
// all_gather (parallel/sharded.py:89-98 in sharded_flat_search, :254-262 in
// sharded_ivf_search): each shard's partial top-k, rebased to global rows,
// then one top-k over the S * k_s candidates of each query. Per query b the
// inputs are vals / rows [S, B, k_s], shard-major, with shard-local rows;
// shard s turns a local row r >= 0 into base[s] + r (the flat search:
// base[s] = s * n_local) or, with a row map, into row_map[base[s] + r] (the
// IVF search: a shard's packed list position into its global row; base[s] is
// the shard's offset in the concatenated maps). A candidate whose row is < 0
// or whose distance is not finite never enters. The k smallest by (distance,
// global row) come out sorted, padded with (+inf, -1). JAX's lax.top_k breaks
// ties by shard and position instead; the tests compare sorted pairs.
//
// set_rows is the sharded builder's _set_rows_true (parallel/ingest.py:44):
// mask[rows[i]] = 1 for i < n, rows outside [0, N) ignored. It is
// idempotent, so the builder's bucket padding (a repeated row) is harmless.
// The single-device pipelined HNSW build runs the same function as
// _set_member_rows (JAX index/hnsw.py:137), marking a link batch's rows as
// members of the device mask before the next batch's candidate scan.
//
// What bounds it on the H100: the merge reads S * k_s * 8 bytes a query and
// writes k * 8 (128 queries x 4 shards x 200: 0.8 MB, ~0.25 us at 3.35
// TB/s), so a launch's fixed cost dominates; the sort is n log^2 n
// compare-exchanges a query in shared memory. set_rows writes n bytes.
//
// Design: one block a query. Up to MERGE_SMEM candidates (S * k_s <= 2,048:
// every search shape and the builder's 4 x 200) sit in shared memory as
// 64-bit keys (common.cuh's dist_key << 32 | global row, whose unsigned
// order is the (distance, row) order, negative distances included) and are
// bitonic-sorted there. Past that (the projected search's S x 2,048), a pass
// writes the rebased candidates to a [B, S * k_s] buffer and
// topk_select.cuh's radix select takes the k smallest and sorts them.
#include "common.cuh"
#include "topk_select.cuh"

namespace fvdb {

constexpr int MERGE_SMEM = 2048;  // candidates a query sorted in shared memory

// Candidate i (shard i / ks, slot i % ks) of query b as (distance, global
// row), or ok = false.
__device__ __forceinline__ bool shard_cand(
    const float* __restrict__ vals, const int* __restrict__ rows,
    const int* __restrict__ base, const int* __restrict__ row_map, int B,
    int ks, int b, int i, float* d, int* g) {
  const int s = i / ks, j = i - s * ks;
  const size_t at = ((size_t)s * B + b) * ks + j;
  const int r = rows[at];
  *d = vals[at];
  if (r < 0 || !isfinite(*d)) return false;
  *g = row_map ? row_map[base[s] + r] : base[s] + r;
  return *g >= 0;
}

__global__ void __launch_bounds__(NT) merge_small_kernel(
    const float* __restrict__ vals, const int* __restrict__ rows,
    const int* __restrict__ base, const int* __restrict__ row_map, int S,
    int B, int ks, int k, float* __restrict__ out_d,
    int* __restrict__ out_r) {
  __shared__ unsigned long long buf[MERGE_SMEM];
  const int b = blockIdx.x, t = threadIdx.x, n = S * ks;
  const int sz = pow2_at_least(n);
  for (int i = t; i < sz; i += NT) {
    float d;
    int g;
    buf[i] = i < n && shard_cand(vals, rows, base, row_map, B, ks, b, i, &d, &g)
                 ? ((unsigned long long)dist_key(d) << 32) | (unsigned)g
                 : ~0ull;
  }
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
  for (int j = t; j < k; j += NT) {
    const unsigned long long c = j < sz ? buf[j] : ~0ull;
    const bool ok = c != ~0ull;
    out_d[(size_t)b * k + j] = ok ? key_dist((unsigned)(c >> 32)) : INFINITY;
    out_r[(size_t)b * k + j] = ok ? (int)(unsigned)(c & 0xffffffffull) : -1;
  }
}

// The rebased candidates of every query, [B, S * ks], +inf / -1 where a
// candidate does not enter.
__global__ void __launch_bounds__(NT) merge_gather_kernel(
    const float* __restrict__ vals, const int* __restrict__ rows,
    const int* __restrict__ base, const int* __restrict__ row_map, int S,
    int B, int ks, float* __restrict__ cand_d, int* __restrict__ cand_r) {
  const int b = blockIdx.y, n = S * ks;
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= n) return;
  float d;
  int g;
  const bool ok = shard_cand(vals, rows, base, row_map, B, ks, b, i, &d, &g);
  cand_d[(size_t)b * n + i] = ok ? d : INFINITY;
  cand_r[(size_t)b * n + i] = ok ? g : -1;
}

__global__ void set_rows_kernel(uint8_t* __restrict__ mask, long long n_mask,
                                const int* __restrict__ rows, int n) {
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= n) return;
  const int r = rows[i];
  if (r >= 0 && r < n_mask) mask[r] = 1;
}

}  // namespace fvdb

// The most candidates a query the shared-memory path takes; past it the
// call needs cand_* [B, S * ks] and fvdb_select_scratch_bytes(B, k) of work.
FVDB_EXPORT long long fvdb_shard_merge_smem_max() { return fvdb::MERGE_SMEM; }

// vals [S, B, ks] f32, rows [S, B, ks] int32 (shard-local, -1: none), base
// [S] int32, row_map null or int32 (global row of base[s] + r) -> out_d,
// out_r [B, k]. cand_d / cand_r / work may be null when S * ks <=
// MERGE_SMEM.
FVDB_EXPORT int fvdb_shard_merge(const float* vals, const int* rows,
                                 const int* base, const int* row_map, int S,
                                 int B, int ks, int k, float* cand_d,
                                 int* cand_r, void* work, float* out_d,
                                 int* out_r, cudaStream_t stream) {
  using namespace fvdb;
  if (S < 1 || B < 1 || ks < 1 || k < 1 || base == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = (long long)S * ks;
  if (n <= MERGE_SMEM) {
    merge_small_kernel<<<B, NT, 0, stream>>>(vals, rows, base, row_map, S, B,
                                              ks, k, out_d, out_r);
    return static_cast<int>(cudaGetLastError());
  }
  if (cand_d == nullptr || cand_r == nullptr || work == nullptr ||
      B > 65535 || n > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((unsigned)((n + NT - 1) / NT), B);
  merge_gather_kernel<<<grid, NT, 0, stream>>>(vals, rows, base, row_map, S,
                                                B, ks, cand_d, cand_r);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_select_topk(cand_d, cand_r, nullptr, n, B, k,
                                             work, out_d, out_r, stream));
}

// mask [n_mask] uint8: mask[rows[i]] = 1 for i < n (rows outside ignored).
FVDB_EXPORT int fvdb_set_rows(uint8_t* mask, long long n_mask,
                              const int* rows, int n, cudaStream_t stream) {
  using namespace fvdb;
  if (n < 0 || n_mask < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  set_rows_kernel<<<(n + NT - 1) / NT, NT, 0, stream>>>(mask, n_mask, rows, n);
  return static_cast<int>(cudaGetLastError());
}
