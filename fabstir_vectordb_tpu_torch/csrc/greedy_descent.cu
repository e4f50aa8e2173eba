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
// neighbour rows (16 x 384 x 4 = 24 KB; half that on bf16 rows), and hops
// depend on each other, so at every B it is bound by latency: the longest
// query's hop attempts times the dependent reads a hop takes. The upper
// layers of the 1M tier (~6,000 nodes, ~9 MB of f32 rows) stay in the 50 MB
// L2, so a read is an L2 round trip once they are warm. Bytes (a few MB at
// B = 128) are far under a microsecond.
//
// Design: one block of 8 warps a query, the query in shared memory; two
// dependent rounds a hop. Round one: every neighbour row of the current
// list at once (warp w scores rows w, w + 8, ...: 2 rows a warp for lists
// of up to 16, 4 up to 32; each lane's 16-byte loads of all of them out
// before any FMA, common.cuh's warp_dots), each row's mask, x_sq and
// up_offset beside them (the mask is applied after the loads, not as a gate
// before them), the up_offset of every neighbour, and the current node's
// list one layer down (its upper-layer rows are contiguous from
// up_offset[cur]). Round two, issued as soon as the rows' loads are out:
// with each neighbour's up_offset in hand, the list every neighbour would
// have on this layer (M x M ids, one a thread up to M = 16), in flight
// while the dots are summed. After one block barrier, every warp takes the
// same argmin from shared memory and moves or steps down with its next list
// already in shared memory (buffers alternate by hop, so one barrier a hop
// suffices). A launch's prologue overlaps the query's loads with the
// entry's up_offset, and the entry's list with its distance.
#include "common.cuh"

namespace fvdb {

constexpr int MAXM = 32;        // widest upper-layer list a block takes
constexpr int WARPS = NT / 32;  // 8

// The table row of node `up` (its up_offset) on `layer`, clamped into the
// table as the reference's gathers clamp.
__device__ __forceinline__ int table_row(int up, int layer, int R) {
  return min(max(up + layer - 1, 0), R - 1);
}

// MC: the lists' width class (M <= MC, 16 or 32): MC / 8 rows a warp and
// MC * MC / 256 adjacency ids a thread, so the registers follow the lists'
// width: at M <= 16, 64 a thread and four blocks (queries) an SM, so a
// link plan's B = 1,024 runs in two waves.
template <typename T, int MC>
__global__ void __launch_bounds__(NT, MC == 16 ? 4 : 2) greedy_descent_kernel(
    const T* __restrict__ x, const float* __restrict__ x_sq,
    const uint8_t* __restrict__ mask, const int* __restrict__ nbrs_up,
    const int* __restrict__ up_offset, int R, const float* __restrict__ q,
    const int* __restrict__ stop_layer, int D, int M, int entry,
    int entry_level, int max_hops, int* __restrict__ out_cur,
    float* __restrict__ out_d) {
  constexpr int RPW = MC / WARPS;               // neighbour rows a warp
  constexpr int APT = (MC * MC + NT - 1) / NT;  // adjacency ids a thread
  extern __shared__ __align__(16) float qs[];   // [D]
  __shared__ float s_d[2][MC];                  // a hop's distances
  __shared__ int s_id[2][MC];                   // its neighbour ids
  __shared__ int s_up[2][MC];                   // their up_offset
  // [j < M]: neighbour j's list on this layer; [MC]: the current node's
  // list a layer down
  __shared__ int s_list[2][MC + 1][MC];
  const int b = blockIdx.x, t = threadIdx.x;
  const int w = t >> 5, lane = t & 31;
  int cur = entry, layer = entry_level;
  const int e = max(cur, 0);
  // the entry's up_offset beside the query's loads (four a thread out at
  // once), then its list, in flight through the entry's distance
  int up_cur = __ldg(up_offset + e);
  const int stop = stop_layer ? stop_layer[b] : 0;
  for (int d0 = 0; d0 < D; d0 += 4 * NT) {
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = d0 + i * NT + t;
      v[i] = d < D ? __ldg(q + (size_t)b * D + d) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (d0 + i * NT + t < D) qs[d0 + i * NT + t] = v[i];
  }
  const int first = t < M ? __ldg(nbrs_up + (size_t)table_row(
                                up_cur, layer, R) * M + t)
                          : -1;
  __syncthreads();
  const float q_sq = warp_row_sq(qs, D);  // the same sum in every warp
  float cur_d;
  {  // the entry's distance, every warp alike
    const int rows[1] = {e};
    float dot[1];
    warp_dots<1>(qs, x, rows, D, dot);
    cur_d = mask[e] ? sq_dist(q_sq, dot[0], __ldg(x_sq + e)) : INFINITY;
  }
  if (t < M) s_list[1][MC][t] = first;
  int lj = MC;  // which list of the last hop's buffer is this hop's
  __syncthreads();
  for (int hop = 0; hop < max_hops && layer > stop; ++hop) {
    const int buf = hop & 1;
    const int* ids = s_list[buf ^ 1][lj];
    // round one: the up_offset of each neighbour whose list this thread
    // fetches, the current node's list a layer down, then the warp's rows
    // and their mask / x_sq / up_offset
    int aj[APT];
#pragma unroll
    for (int p = 0; p < APT; ++p) {
      const int a = t + NT * p;
      const int id = a < M * M ? ids[a / M] : -1;
      aj[p] = id >= 0 ? __ldg(up_offset + id) : -1;
    }
    const int down = t < M ? __ldg(nbrs_up + (size_t)table_row(
                                   up_cur, layer - 1, R) * M + t)
                           : -1;
    int rows[RPW];
    bool mk[RPW];
    float xs[RPW];
    int up[RPW];
#pragma unroll
    for (int g = 0; g < RPW; ++g) {
      const int j = w + WARPS * g;
      rows[g] = j < M ? ids[j] : -1;
      const bool in = rows[g] >= 0;
      mk[g] = in && mask[rows[g]];
      xs[g] = in ? __ldg(x_sq + rows[g]) : 0.f;
      up[g] = in ? __ldg(up_offset + rows[g]) : 0;
    }
    // round two, once the rows' loads are out: each neighbour's list on
    // this layer, in flight while the dots are summed
    int adj[APT];
    float dot[RPW];
    warp_dots<RPW>(qs, x, rows, D, dot, [&] {
#pragma unroll
      for (int p = 0; p < APT; ++p) {
        const int a = t + NT * p;
        adj[p] = aj[p] >= 0 ? __ldg(nbrs_up + (size_t)table_row(
                                  aj[p], layer, R) * M + a % M)
                            : -1;
      }
    });
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < RPW; ++g) {
        const int j = w + WARPS * g;
        if (j >= M) break;
        s_d[buf][j] = mk[g] ? sq_dist(q_sq, dot[g], xs[g]) : INFINITY;
        s_id[buf][j] = rows[g];
        s_up[buf][j] = up[g];
      }
    }
#pragma unroll
    for (int p = 0; p < APT; ++p) {
      const int a = t + NT * p;
      if (a < M * M) s_list[buf][a / M][a % M] = adj[p];
    }
    if (t < M) s_list[buf][MC][t] = down;
    __syncthreads();
    // argmin over the list: the smallest distance, then the lowest index
    float best_d = lane < M ? s_d[buf][lane] : INFINITY;
    int best_j = lane;
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      const float od = __shfl_xor_sync(FULL, best_d, off);
      const int oj = __shfl_xor_sync(FULL, best_j, off);
      if (od < best_d || (od == best_d && oj < best_j)) {
        best_d = od;
        best_j = oj;
      }
    }
    if (best_d < cur_d) {  // uniform: every warp holds the same pair
      cur = s_id[buf][best_j];
      cur_d = best_d;
      up_cur = s_up[buf][best_j];
      lj = best_j;
    } else {
      --layer;
      lj = MC;
    }
  }
  if (t == 0) {
    out_cur[b] = cur;
    out_d[b] = cur_d;
  }
}

template <typename T, int MC>
cudaError_t greedy_descent(const T* x, const float* x_sq, const uint8_t* mask,
                           const int* nbrs_up, const int* up_offset, int R,
                           const float* q, const int* stop_layer, int B,
                           int D, int M, int entry, int entry_level,
                           int max_hops, int* out_cur, float* out_d,
                           cudaStream_t stream) {
  const int smem = D * 4;  // the f32 query, whatever the rows
  static int cap[64];
  cudaError_t e = raise_smem_cap(
      reinterpret_cast<const void*>(greedy_descent_kernel<T, MC>), smem, cap);
  if (e != cudaSuccess) return e;
  greedy_descent_kernel<T, MC><<<B, NT, smem, stream>>>(
      x, x_sq, mask, nbrs_up, up_offset, R, q, stop_layer, D, M, entry,
      entry_level, max_hops, out_cur, out_d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t greedy_descent(const T* x, const float* x_sq, const uint8_t* mask,
                           const int* nbrs_up, const int* up_offset, int R,
                           const float* q, const int* stop_layer, int B,
                           int D, int M, int entry, int entry_level,
                           int max_hops, int* out_cur, float* out_d,
                           cudaStream_t stream) {
  return M <= 16 ? greedy_descent<T, 16>(x, x_sq, mask, nbrs_up, up_offset,
                                         R, q, stop_layer, B, D, M, entry,
                                         entry_level, max_hops, out_cur,
                                         out_d, stream)
                 : greedy_descent<T, MAXM>(x, x_sq, mask, nbrs_up, up_offset,
                                           R, q, stop_layer, B, D, M, entry,
                                           entry_level, max_hops, out_cur,
                                           out_d, stream);
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
