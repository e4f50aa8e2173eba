// K10: batched greedy (ef = 1) descent over the HNSW upper layers.
//
// Replaces the JAX package's greedy_descent_kernel (index/hnsw.py:249): from
// (entry, entry_level), each query hops to the closest unmasked neighbour of
// its current node on its current layer (argmin, the first of equal
// distances) while that improves on the current distance, and steps down a
// layer when it does not, until it is at or below stop_layer[b] or has made
// max_hops attempts. Distances are max(|q|^2 - 2 q.x + |x|^2, 0), the
// reference's _gather_dists (index/hnsw.py:239): an f32 query, rows f32 or
// bf16 (a bf16 serving mirror, upcast exactly, as the reference's einsum of
// an f32 query with bf16 rows computes in f32), and the mirror's f32 x_sq.
//
// What bounds it on the H100: a hop reads one adjacency row and up to M = 16
// neighbour rows (16 x 384 x 4 = 24 KB; half that on bf16 rows); hops depend on each other, so at
// B = 1 it is latency-bound (a few dependent global reads a hop) and at
// B = 128 it moves ~3 MB a hop level, far under a microsecond of bandwidth.
//
// Design: one warp a query, eight a block, the query in shared memory. A hop
// scores the M neighbours eight rows at a time, each group's loads (16
// bytes a lane of f32 rows, 8 of bf16) all in flight before its FMAs (common.cuh's warp_dots), and the argmin is
// a shuffle reduction over (distance, lane).
#include "common.cuh"

namespace fvdb {

constexpr int MAXM = 32;   // widest upper-layer list a warp takes
constexpr int GROUP = 8;   // neighbour rows whose loads go out together

template <typename T>
__global__ void __launch_bounds__(NT) greedy_descent_kernel(
    const T* __restrict__ x, const float* __restrict__ x_sq,
    const uint8_t* __restrict__ mask, const int* __restrict__ nbrs_up,
    const int* __restrict__ up_offset, int R, const float* __restrict__ q,
    const int* __restrict__ stop_layer, int B, int D, int M, int entry,
    int entry_level, int max_hops, int* __restrict__ out_cur,
    float* __restrict__ out_d) {
  extern __shared__ float qs_all[];  // [NT / 32][D]
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * (NT / 32) + w;
  if (b >= B) return;  // whole warps leave; no block barrier below
  float* qs = qs_all + (size_t)w * D;
  const float* qb = q + (size_t)b * D;
  for (int d = lane; d < D; d += 32) qs[d] = qb[d];
  __syncwarp();
  const float q_sq = warp_row_sq(qs, D);

  int cur = entry;
  float cur_d;
  {
    const int rows[1] = {max(cur, 0)};
    float dot[1];
    warp_dots<1>(qs, x, rows, D, dot);
    cur_d = mask[rows[0]] ? sq_dist(q_sq, dot[0], x_sq[rows[0]]) : INFINITY;
  }
  int layer = entry_level;
  const int stop = stop_layer ? stop_layer[b] : 0;
  for (int hop = 0; hop < max_hops && layer > stop; ++hop) {
    // clamped into the table, as the reference's gathers clamp
    const int row = min(max(up_offset[max(cur, 0)] + layer - 1, 0), R - 1);
    const int my = lane < M ? nbrs_up[(size_t)row * M + lane] : -1;
    const bool ok = my >= 0 && mask[my];
    float mine = INFINITY;
    for (int j0 = 0; j0 < M; j0 += GROUP) {  // GROUP rows' loads at once
      int ids[GROUP];
#pragma unroll
      for (int g = 0; g < GROUP; ++g)
        ids[g] = __shfl_sync(FULL, ok ? my : -1, (j0 + g) & 31);
#pragma unroll
      for (int g = 0; g < GROUP; ++g)
        if (j0 + g >= M) ids[g] = -1;
      float dots[GROUP];
      warp_dots<GROUP>(qs, x, ids, D, dots);
#pragma unroll
      for (int g = 0; g < GROUP; ++g)
        if (j0 + g == lane && ok) mine = sq_dist(q_sq, dots[g], x_sq[my]);
    }
    // argmin over lanes: the smallest distance, then the lowest lane
    float best_d = mine;
    int best_l = lane;
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      const float od = __shfl_xor_sync(FULL, best_d, off);
      const int ol = __shfl_xor_sync(FULL, best_l, off);
      if (od < best_d || (od == best_d && ol < best_l)) {
        best_d = od;
        best_l = ol;
      }
    }
    const int best_id = __shfl_sync(FULL, my, best_l);
    if (best_d < cur_d) {  // uniform: every lane holds the same pair
      cur = best_id;
      cur_d = best_d;
    } else {
      --layer;
    }
  }
  if (lane == 0) {
    out_cur[b] = cur;
    out_d[b] = cur_d;
  }
}

template <typename T>
cudaError_t greedy_descent(const T* x, const float* x_sq, const uint8_t* mask,
                           const int* nbrs_up, const int* up_offset, int R,
                           const float* q, const int* stop_layer, int B,
                           int D, int M, int entry, int entry_level,
                           int max_hops, int* out_cur, float* out_d,
                           cudaStream_t stream) {
  const int smem = (NT / 32) * D * 4;  // the f32 queries, whatever the rows
  static int cap[64];
  cudaError_t e = raise_smem_cap(
      reinterpret_cast<const void*>(greedy_descent_kernel<T>), smem, cap);
  if (e != cudaSuccess) return e;
  const int per_block = NT / 32;
  greedy_descent_kernel<T><<<(B + per_block - 1) / per_block, NT, smem,
                             stream>>>(
      x, x_sq, mask, nbrs_up, up_offset, R, q, stop_layer, B, D, M, entry,
      entry_level, max_hops, out_cur, out_d);
  return cudaGetLastError();
}

}  // namespace fvdb

// x [N, D] (x_bf16: bf16, else f32), x_sq [N], mask [N] (uint8), nbrs_up
// [R, M], up_offset [N], q [B, D], stop_layer [B] (null: layer 0); out_cur
// [B] int32, out_d [B] f32. M <= 32.
FVDB_EXPORT int fvdb_greedy_descent(const void* x, int x_bf16,
                                    const float* x_sq, const uint8_t* mask,
                                    const int* nbrs_up, const int* up_offset,
                                    int R, const float* q,
                                    const int* stop_layer, int B, int D,
                                    int M, int entry, int entry_level,
                                    int max_hops, int* out_cur, float* out_d,
                                    cudaStream_t stream) {
  using namespace fvdb;
  if (B < 1 || D < 1 || M < 1 || M > MAXM || R < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      x_bf16 ? greedy_descent<__nv_bfloat16>(
                   static_cast<const __nv_bfloat16*>(x), x_sq, mask, nbrs_up,
                   up_offset, R, q, stop_layer, B, D, M, entry, entry_level,
                   max_hops, out_cur, out_d, stream)
             : greedy_descent<float>(
                   static_cast<const float*>(x), x_sq, mask, nbrs_up,
                   up_offset, R, q, stop_layer, B, D, M, entry, entry_level,
                   max_hops, out_cur, out_d, stream));
}
