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
// writes k * 8 (128 queries x 4 shards x 2,048: 8.4 MB, ~2.5 us at 3.35
// TB/s), so at the search shapes a launch's fixed cost and the wrapper's
// host time dominate; the sort is n log^2 n compare-exchanges a query.
//
// Design: a candidate is the 64-bit key dist_key << 32 | global row
// (common.cuh), whose unsigned order is the (distance, row) order, negative
// distances included; a candidate that does not enter is ~0, which sorts
// last. The keys are bitonic-sorted by candidate count:
// - n = S * k_s <= 64 (the search and IVF shapes, 4 x 10): a warp a query,
//   eight queries a block, each lane holding two keys in registers; the
//   sort's steps are warp shuffles (a step across the two registers is a
//   swap inside the lane), with no shared memory and no __syncthreads.
// - n <= 16,384 (ShardedBuilder's 4 x 200, the projected search's 4 x
//   2,048, 8 x 2,048): a block a query, 128 to 1,024 threads each holding
//   E keys in registers (E = 8 up to 8,192, E = 16 above). Thread t holds
//   the network's elements t E .. t E + E - 1, so a step between elements
//   fewer than E apart is a swap inside a thread, one fewer than 32 E apart
//   a warp shuffle, and only a step across warps goes through shared memory
//   (15 of the 91 steps at 8,192, each two __syncthreads); there the keys
//   lie by register then thread, so a warp's accesses are consecutive. One
//   launch, no global buffer.
// - past that: a pass writes the rebased candidates to a [B, n] buffer and
//   topk_select.cuh's radix select takes the k smallest and sorts them.
// No route assumes the shards' lists are sorted: an entry that does not
// enter may sit anywhere in a list.
#include "common.cuh"
#include "topk_select.cuh"

namespace fvdb {

constexpr int MERGE_WARP = 64;    // candidates a warp sorts in registers
constexpr int MERGE_E = 8;        // keys a thread of the register sort ...
constexpr int MERGE_E8 = 1024 * MERGE_E;  // ... up to 8,192 candidates
constexpr int MERGE_REG = 16384;  // ... then 16 keys a thread, up to here
constexpr unsigned long long NO_KEY = ~0ull;

// Candidate i (shard i / ks, slot i % ks) of query b as its key, or NO_KEY.
__device__ __forceinline__ unsigned long long shard_key(
    const float* __restrict__ vals, const int* __restrict__ rows,
    const int* __restrict__ base, const int* __restrict__ row_map, int B,
    int ks, int b, int i) {
  const int s = i / ks, j = i - s * ks;
  const size_t at = ((size_t)s * B + b) * ks + j;
  const int r = rows[at];
  const float d = vals[at];
  if (r < 0 || !isfinite(d)) return NO_KEY;
  const int g = row_map ? row_map[base[s] + r] : base[s] + r;
  return g >= 0 ? ((unsigned long long)dist_key(d) << 32) | (unsigned)g
                : NO_KEY;
}

__device__ __forceinline__ void write_key(unsigned long long c, float* od,
                                          int* orow) {
  const bool ok = c != NO_KEY;
  *od = ok ? key_dist((unsigned)(c >> 32)) : INFINITY;
  *orow = ok ? (int)(unsigned)(c & 0xffffffffull) : -1;
}

// A warp a query: element i of the 32 E keys is register i / 32 of lane
// i % 32 (E = 1 or 2).
template <int E>
__global__ void __launch_bounds__(NT) merge_warp_kernel(
    const float* __restrict__ vals, const int* __restrict__ rows,
    const int* __restrict__ base, const int* __restrict__ row_map, int S,
    int B, int ks, int k, float* __restrict__ out_d,
    int* __restrict__ out_r) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp
  const int n = S * ks;
  unsigned long long v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = e * 32 + lane;
    v[e] = i < n ? shard_key(vals, rows, base, row_map, B, ks, b, i) : NO_KEY;
  }
#pragma unroll
  for (int len = 2; len <= 32 * E; len <<= 1) {
#pragma unroll
    for (int j = len >> 1; j > 0; j >>= 1) {
      if (E == 2 && j == 32) {  // elements lane and 32 + lane: in-lane
        const unsigned long long a = v[0], c = v[E - 1];
        const bool up = (lane & len) == 0;
        if ((a > c) == up) {
          v[0] = c;
          v[E - 1] = a;
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const unsigned long long o = __shfl_xor_sync(FULL, v[e], j);
          const bool up = ((e * 32 + lane) & len) == 0;
          const bool low = (lane & j) == 0;
          v[e] = (low == up) ? (v[e] < o ? v[e] : o) : (v[e] < o ? o : v[e]);
        }
      }
    }
  }
  float* od = out_d + (size_t)b * k;
  int* orow = out_r + (size_t)b * k;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = e * 32 + lane;
    if (i < k) write_key(v[e], od + i, orow + i);
  }
  for (int j = 32 * E + lane; j < k; j += 32) {
    od[j] = INFINITY;
    orow[j] = -1;
  }
}

// A block of NTB threads a query, NTB * E keys in registers: element t E +
// e of the bitonic network is thread t's v[e], and starts as candidate
// e NTB + t (any placement sorts; this one reads coalesced).
template <int NTB, int E>
__global__ void __launch_bounds__(NTB) merge_reg_kernel(
    const float* __restrict__ vals, const int* __restrict__ rows,
    const int* __restrict__ base, const int* __restrict__ row_map, int S,
    int B, int ks, int k, float* __restrict__ out_d,
    int* __restrict__ out_r) {
  constexpr int SZ = NTB * E;
  extern __shared__ unsigned long long buf[];  // SZ keys: [e][t]
  const int b = blockIdx.x, t = threadIdx.x, n = S * ks;
  unsigned long long v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = e * NTB + t;
    v[e] = i < n ? shard_key(vals, rows, base, row_map, B, ks, b, i) : NO_KEY;
  }
#pragma unroll
  for (int len = 2; len <= SZ; len <<= 1) {
#pragma unroll
    for (int j = len >> 1; j > 0; j >>= 1) {
      if (j < E) {  // inside the thread
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if (e & j) continue;
          const unsigned long long a = v[e], c = v[e | j];
          if ((a > c) == (((t * E + e) & len) == 0)) {
            v[e] = c;
            v[e | j] = a;
          }
        }
      } else {
        const int tj = j / E;  // the partner thread: t ^ tj
        const bool low = (t & tj) == 0;
        if (j >= 32 * E) {  // another warp's: through shared memory
          __syncthreads();  // the last such step's reads are done
#pragma unroll
          for (int e = 0; e < E; ++e) buf[e * NTB + t] = v[e];
          __syncthreads();
        }
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const unsigned long long o =
              j >= 32 * E ? buf[e * NTB + (t ^ tj)]
                          : __shfl_xor_sync(FULL, v[e], tj);
          const bool up = ((t * E + e) & len) == 0;
          v[e] = (low == up) ? (v[e] < o ? v[e] : o) : (v[e] < o ? o : v[e]);
        }
      }
    }
  }
  float* od = out_d + (size_t)b * k;
  int* orow = out_r + (size_t)b * k;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = t * E + e;
    if (i < k) write_key(v[e], od + i, orow + i);
  }
  for (int j = SZ + t; j < k; j += NTB) {
    od[j] = INFINITY;
    orow[j] = -1;
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
  write_key(shard_key(vals, rows, base, row_map, B, ks, b, i),
            cand_d + (size_t)b * n + i, cand_r + (size_t)b * n + i);
}

__global__ void set_rows_kernel(uint8_t* __restrict__ mask, long long n_mask,
                                const int* __restrict__ rows, int n) {
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= n) return;
  const int r = rows[i];
  if (r >= 0 && r < n_mask) mask[r] = 1;
}

// vals [S, B, ks] f32, rows [S, B, ks] int32 (shard-local, -1: none), base
// [S] int32, row_map null or int32 (global row of base[s] + r) -> out_d,
// out_r [B, k]. cand_d / cand_r / work ([B, S * ks] each and
// fvdb_select_scratch_bytes(B, k) bytes) may be null when S * ks <=
// MERGE_REG.
inline int shard_merge(const float* vals, const int* rows, const int* base,
                       const int* row_map, int S, int B, int ks, int k,
                       float* cand_d, int* cand_r, void* work, float* out_d,
                       int* out_r, cudaStream_t stream) {
  if (S < 1 || B < 1 || ks < 1 || k < 1 || base == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = (long long)S * ks;
  if (n <= MERGE_WARP) {
    const int grid = (B + NT / 32 - 1) / (NT / 32);
    if (n <= 32)
      merge_warp_kernel<1><<<grid, NT, 0, stream>>>(vals, rows, base,
                                                     row_map, S, B, ks, k,
                                                     out_d, out_r);
    else
      merge_warp_kernel<2><<<grid, NT, 0, stream>>>(vals, rows, base,
                                                     row_map, S, B, ks, k,
                                                     out_d, out_r);
    return static_cast<int>(cudaGetLastError());
  }
  if (n <= MERGE_E8) {
    const int per = pow2_at_least((int)((n + MERGE_E - 1) / MERGE_E));
    const int nt = per < 128 ? 128 : per;  // threads: 8 keys each
    const int smem = nt * MERGE_E * 8;
    static int cap[64];
    cudaError_t e = cudaSuccess;
    switch (nt) {
      case 128:
        merge_reg_kernel<128, MERGE_E><<<B, 128, smem, stream>>>(
            vals, rows, base, row_map, S, B, ks, k, out_d, out_r);
        break;
      case 256:
        merge_reg_kernel<256, MERGE_E><<<B, 256, smem, stream>>>(
            vals, rows, base, row_map, S, B, ks, k, out_d, out_r);
        break;
      case 512:
        merge_reg_kernel<512, MERGE_E><<<B, 512, smem, stream>>>(
            vals, rows, base, row_map, S, B, ks, k, out_d, out_r);
        break;
      default:  // 1,024 threads, 64 KB
        e = raise_smem_cap(
            reinterpret_cast<const void*>(merge_reg_kernel<1024, MERGE_E>),
            smem, cap);
        if (e != cudaSuccess) return static_cast<int>(e);
        merge_reg_kernel<1024, MERGE_E><<<B, 1024, smem, stream>>>(
            vals, rows, base, row_map, S, B, ks, k, out_d, out_r);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (n <= MERGE_REG) {  // 1,024 threads of 16 keys, 128 KB
    constexpr int smem = MERGE_REG * 8;
    static int cap[64];
    const cudaError_t e = raise_smem_cap(
        reinterpret_cast<const void*>(merge_reg_kernel<1024, 16>), smem, cap);
    if (e != cudaSuccess) return static_cast<int>(e);
    merge_reg_kernel<1024, 16><<<B, 1024, smem, stream>>>(
        vals, rows, base, row_map, S, B, ks, k, out_d, out_r);
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

}  // namespace fvdb

// The merge (fvdb::shard_merge) with its 14 arguments packed in order as
// 64-bit words: one ctypes argument converted instead of 14, a few host
// microseconds less a call, which a merge of a few microseconds on the card
// feels.
FVDB_EXPORT int fvdb_shard_merge_packed(const long long* a) {
  return fvdb::shard_merge(
      reinterpret_cast<const float*>(a[0]), reinterpret_cast<const int*>(a[1]),
      reinterpret_cast<const int*>(a[2]), reinterpret_cast<const int*>(a[3]),
      (int)a[4], (int)a[5], (int)a[6], (int)a[7],
      reinterpret_cast<float*>(a[8]), reinterpret_cast<int*>(a[9]),
      reinterpret_cast<void*>(a[10]), reinterpret_cast<float*>(a[11]),
      reinterpret_cast<int*>(a[12]), reinterpret_cast<cudaStream_t>(a[13]));
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
