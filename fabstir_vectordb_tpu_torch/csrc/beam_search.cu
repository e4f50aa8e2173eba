// K11: batched beam search at one HNSW layer, with the JAX package's step
// rule.
//
// Replaces the JAX package's _beam_search_jit (index/hnsw.py:312, with
// beam_search_kernel :291 and _dedup_sorted :481). Per query: a pool of at
// most ef (distance, id) entries sorted ascending, with expansion flags.
// Each step takes the W best unexpanded entries (the pool is sorted, so the
// first W unexpanded positions); it stops when there is none (the best
// unexpanded distance is +inf) or the pool is full and that distance is
// above the pool's worst. The chosen entries are flagged, their adjacency
// lists gathered (-1 padded), and a neighbour enters only if it is >= 0, not
// in the pool, not repeated earlier in this step's list, and unmasked. The
// survivors merge into the pool as a stable sort of [pool, new] cut to ef
// would: an equal distance keeps the pool's entry first, and new entries
// keep their list order. With a result mask, the survivors that pass it
// merge the same way into a separate result list, whose repeated ids are
// dropped at the end (keep the first). At most max_iters steps.
//
// Rows are f32 or bf16 (a bf16 serving mirror), upcast exactly, with the
// f32 query and the mirror's f32 x_sq: the reference's _gather_dists
// (index/hnsw.py:239) on a bf16 mirror. At a layer above 0 (up_offset
// given) a node's list is nbrs_up[up_offset[id] + layer - 1]; queries whose
// active flag is 0 keep their start set (the per-layer link plan's queries
// below the layer).
//
// What bounds it on the H100: each step gathers up to W x M0 = 128 rows of
// 384 floats (196 KB; half that on bf16 rows) and depends on the step before, so at B = 1 it is
// latency-bound (one dependent chain of global reads a step, ~ef / W + 32
// steps); at B = 128 it moves ~25 MB a step wave, tens of microseconds of
// bandwidth, and the per-step bookkeeping (membership test, sort, merge)
// sets the pace.
//
// Design: one block a query; the query, the pool and the result list in
// shared memory while they fit (LIST_SMEM bytes; ef <= 1,024 with a result
// list), else in a global scratch row of the same layout, reached through
// the same generic pointers. The stage holds the f32 query and the lists,
// never rows, so its size is the same for both row types. A step: warp 0 picks the first W unexpanded
// positions with ballots; one thread a candidate tests membership against
// the pool and the earlier candidates; the valid ones are compacted in
// order, their distances taken four rows a warp with all loads in flight;
// one thread a survivor ranks it by (distance, list order); the pool takes
// them in place, its entries moving up by the count of survivors below them,
// highest first, so nothing is overwritten before it is read.
#include "common.cuh"

namespace fvdb {

constexpr int CAP = NT;            // candidates a step: W x list width
constexpr int LIST_SMEM = 32768;   // query + lists in shared memory up to

// A query's lists: pool (d, id), results (d, id), pool flags.
struct Lists {
  float* pd;
  int* pid;
  float* rd;
  int* rid;
  uint8_t* pexp;
};

__host__ __device__ inline size_t round16(size_t n) { return (n + 15) / 16 * 16; }
__host__ __device__ inline size_t list_bytes(int ef) {
  return round16((size_t)17 * ef);
}
__device__ inline Lists carve(unsigned char* base, int ef) {
  Lists L;
  L.pd = reinterpret_cast<float*>(base);
  L.pid = reinterpret_cast<int*>(base + 4 * (size_t)ef);
  L.rd = reinterpret_cast<float*>(base + 8 * (size_t)ef);
  L.rid = reinterpret_cast<int*>(base + 12 * (size_t)ef);
  L.pexp = base + 16 * (size_t)ef;
  return L;
}

// Merge nn new entries (nd, nid), sorted by (distance, order), into the
// sorted list (ld, lid[, lexp]) of *n_sh entries and room for ef, as a
// stable sort of [list, new] cut to ef: an equal distance keeps the list's
// entry first. The list's entries at p move to p + (new entries below them),
// the highest chunk first, so no entry is overwritten before it is read.
// Every thread calls it with the same nn.
__device__ void merge_in(float* ld, int* lid, uint8_t* lexp, int* n_sh,
                         int ef, const float* nd, const int* nid, int nn) {
  if (nn == 0) return;
  const int t = threadIdx.x;
  const int n = *n_sh;
  int pos = ef;
  float vd = 0.f;
  int vid = -1;
  if (t < nn) {  // a new entry goes after the list entries <= its distance
    vd = nd[t];
    vid = nid[t];
    int lo = 0, hi = n;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (ld[mid] <= vd) lo = mid + 1; else hi = mid;
    }
    pos = t + lo;
  }
  int first = 0, hi0 = n;  // the first list entry that moves
  const float d0 = nd[0];
  while (first < hi0) {
    const int mid = (first + hi0) >> 1;
    if (ld[mid] <= d0) first = mid + 1; else hi0 = mid;
  }
  __syncthreads();  // every position is known before anything moves
  for (int top = n; top > first; top -= NT) {
    const int base = max(first, top - NT);
    const int p = base + t;
    float ed = 0.f;
    int eid = -1;
    uint8_t ex = 0;
    int dst = ef;
    if (p < top) {
      ed = ld[p];
      eid = lid[p];
      if (lexp) ex = lexp[p];
      int lo = 0, hi = nn;  // new entries strictly below it
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (nd[mid] < ed) lo = mid + 1; else hi = mid;
      }
      dst = p + lo;
    }
    __syncthreads();
    if (dst < ef) {
      ld[dst] = ed;
      lid[dst] = eid;
      if (lexp) lexp[dst] = ex;
    }
    __syncthreads();
  }
  if (pos < ef) {
    ld[pos] = vd;
    lid[pos] = vid;
    if (lexp) lexp[pos] = 0;
  }
  __syncthreads();
  if (t == 0) *n_sh = min(ef, n + nn);
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(NT) beam_search_kernel(
    const T* __restrict__ x, const float* __restrict__ x_sq,
    const uint8_t* __restrict__ mask, const int* __restrict__ adj,
    int adj_rows, int Mw, const int* __restrict__ up_offset, int layer,
    const float* __restrict__ q, int D, const int* __restrict__ start, int S,
    const uint8_t* __restrict__ active,
    const uint8_t* __restrict__ result_mask, int ef, int max_iters, int W,
    unsigned char* __restrict__ scratch, float* __restrict__ out_d,
    int* __restrict__ out_id) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ int c_id[CAP];      // this step's candidates, -1 for none
  __shared__ int v_id[CAP];      // the valid ones, compacted in order
  __shared__ float v_d[CAP];
  __shared__ uint8_t v_el[CAP];  // ... and whether they may be results
  __shared__ float n_d[CAP];     // the valid ones by (distance, order)
  __shared__ int n_id[CAP];
  __shared__ uint8_t n_el[CAP];
  __shared__ float e_d[CAP];     // the result-eligible ones, same order
  __shared__ int e_id[CAP];
  __shared__ int s_sel[CAP];     // pool positions expanded this step
  __shared__ int s_wcnt[NT / 32];
  __shared__ int s_pool_n, s_res_n, s_nsel;
  __shared__ float s_qsq;

  const int b = blockIdx.x;
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const bool has_res = result_mask != nullptr;
  float* qs = reinterpret_cast<float*>(dyn);
  const size_t q_bytes = round16((size_t)D * 4);
  const Lists L = carve(
      scratch ? scratch + (size_t)b * list_bytes(ef) : dyn + q_bytes, ef);

  for (int d = t; d < D; d += NT) qs[d] = q[(size_t)b * D + d];
  __syncthreads();
  if (w == 0) {
    const float s = warp_row_sq(qs, D);
    if (lane == 0) s_qsq = s;
  }
  if (t == 0) {
    s_pool_n = 0;
    s_res_n = 0;
  }
  __syncthreads();
  const float q_sq = s_qsq;

  // Filter c_id[0, nc), take the distances of the survivors and merge them
  // into the pool (and the eligible ones into the results).
  auto process = [&](int nc) {
    const int pool_n = s_pool_n;
    const int id = t < nc ? c_id[t] : -1;
    bool ok = id >= 0;
    for (int p = 0; ok && p < pool_n; ++p) ok = L.pid[p] != id;
    for (int j = 0; ok && j < t; ++j) ok = c_id[j] != id;
    if (ok) ok = mask[id] != 0;
    const bool el = ok && (!has_res || result_mask[id] != 0);
    int nv;
    const int vi = block_rank(ok, s_wcnt, &nv);
    if (ok) {
      v_id[vi] = id;
      v_el[vi] = el;
    }
    __syncthreads();
    for (int i0 = w * 4; i0 < nv; i0 += (NT / 32) * 4) {
      int rows[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) rows[g] = i0 + g < nv ? v_id[i0 + g] : -1;
      float dots[4];
      warp_dots<4>(qs, x, rows, D, dots);
#pragma unroll
      for (int g = 0; g < 4; ++g)
        if (g == lane && rows[g] >= 0)
          v_d[i0 + g] = sq_dist(q_sq, dots[g], x_sq[rows[g]]);
    }
    __syncthreads();
    if (t < nv) {  // rank by (distance, order)
      const float di = v_d[t];
      int rank = 0;
      for (int j = 0; j < nv; ++j) {
        const float dj = v_d[j];
        rank += (dj < di) || (dj == di && j < t);
      }
      n_d[rank] = di;
      n_id[rank] = v_id[t];
      n_el[rank] = v_el[t];
    }
    __syncthreads();
    int ne = 0;
    if (has_res) {
      const bool e = t < nv && n_el[t];
      const int ei = block_rank(e, s_wcnt, &ne);
      if (e) {
        e_d[ei] = n_d[t];
        e_id[ei] = n_id[t];
      }
      __syncthreads();
    }
    merge_in(L.pd, L.pid, L.pexp, &s_pool_n, ef, n_d, n_id, nv);
    if (has_res) merge_in(L.rd, L.rid, nullptr, &s_res_n, ef, e_d, e_id, ne);
  };

  // the start set: its first min(S, ef) ids, CAP at a time
  const int s_eff = min(S, ef);
  for (int s0 = 0; s0 < s_eff; s0 += CAP) {
    const int nc = min(CAP, s_eff - s0);
    c_id[t] = t < nc ? start[(size_t)b * S + s0 + t] : -1;
    __syncthreads();
    process(nc);
  }

  if (active == nullptr || active[b]) {
    for (int it = 0; it < max_iters; ++it) {
      const int pool_n = s_pool_n;
      if (w == 0) {  // the first W unexpanded positions
        int found = 0;
        for (int p0 = 0; p0 < pool_n && found < W; p0 += 32) {
          const int p = p0 + lane;
          unsigned bal = __ballot_sync(FULL, p < pool_n && !L.pexp[p]);
          while (bal && found < W) {
            const int l = __ffs(bal) - 1;
            bal &= bal - 1;
            if (lane == 0) s_sel[found] = p0 + l;
            ++found;
          }
        }
        if (lane == 0) s_nsel = found;
      }
      __syncthreads();
      const int nsel = s_nsel;
      if (nsel == 0) break;  // the best unexpanded distance is +inf
      if (pool_n == ef && L.pd[s_sel[0]] > L.pd[ef - 1]) break;
      int cid = -1;
      if (t < W * Mw && t / Mw < nsel) {
        const int nid = L.pid[s_sel[t / Mw]];
        long long row = nid;
        if (up_offset) row = (long long)up_offset[nid] + layer - 1;
        row = min(max(row, 0ll), (long long)adj_rows - 1);
        cid = adj[row * Mw + t % Mw];
      }
      __syncthreads();
      if (t < nsel) L.pexp[s_sel[t]] = 1;
      c_id[t] = cid;
      __syncthreads();
      process(W * Mw);
    }
  }

  // out: the results (or the pool), repeated ids dropped, (+inf, -1) padded
  __syncthreads();
  const int n = has_res ? s_res_n : s_pool_n;
  const float* ld = has_res ? L.rd : L.pd;
  const int* lid = has_res ? L.rid : L.pid;
  float* od = out_d + (size_t)b * ef;
  int* oi = out_id + (size_t)b * ef;
  int written = 0;
  for (int j0 = 0; j0 < n; j0 += NT) {
    const int j = j0 + t;
    bool keep = j < n;
    float dj = 0.f;
    int ij = -1;
    if (keep) {
      dj = ld[j];
      ij = lid[j];
      // the pool never holds an id twice; the results can
      for (int i = 0; has_res && keep && i < j; ++i) keep = lid[i] != ij;
    }
    int cnt;
    const int r = block_rank(keep, s_wcnt, &cnt);
    if (keep) {
      od[written + r] = dj;
      oi[written + r] = ij;
    }
    written += cnt;
  }
  for (int j = written + t; j < ef; j += NT) {
    od[j] = INFINITY;
    oi[j] = -1;
  }
}

}  // namespace fvdb

// Per query bytes of global scratch the kernel needs (0: its lists fit
// shared memory).
FVDB_EXPORT long long fvdb_beam_scratch_bytes(int D, int ef) {
  using namespace fvdb;
  return round16((size_t)D * 4) + list_bytes(ef) <= (size_t)LIST_SMEM
             ? 0
             : (long long)list_bytes(ef);
}

namespace fvdb {

template <typename T>
cudaError_t beam_search(const T* x, const float* x_sq, const uint8_t* mask,
                        const int* adj, int adj_rows, int Mw,
                        const int* up_offset, int layer, const float* q,
                        int B, int D, const int* start, int S,
                        const uint8_t* active, const uint8_t* result_mask,
                        int ef, int max_iters, int W, unsigned char* scratch,
                        float* out_d, int* out_id, cudaStream_t stream) {
  const bool in_smem = fvdb_beam_scratch_bytes(D, ef) == 0;
  if (!in_smem && scratch == nullptr) return cudaErrorInvalidValue;
  const size_t q_bytes = round16((size_t)D * 4);  // the f32 query
  const int smem = (int)(in_smem ? q_bytes + list_bytes(ef) : q_bytes);
  static int cap[64];
  cudaError_t e = raise_smem_cap(
      reinterpret_cast<const void*>(beam_search_kernel<T>), smem, cap);
  if (e != cudaSuccess) return e;
  beam_search_kernel<T><<<B, NT, smem, stream>>>(
      x, x_sq, mask, adj, adj_rows, Mw, up_offset, layer, q, D, start, S,
      active, result_mask, ef, max_iters, W, in_smem ? nullptr : scratch,
      out_d, out_id);
  return cudaGetLastError();
}

}  // namespace fvdb

// x [N, D] (x_bf16: bf16, else f32), x_sq [N], mask [N] (uint8); adj
// [adj_rows, Mw]: nbrs0 (with up_offset == null) or nbrs_up read at
// up_offset[id] + layer - 1; q [B, D], start [B, S] int32 (-1 padded),
// active [B] uint8 or null, result_mask [N] uint8 or null; scratch [B,
// fvdb_beam_scratch_bytes] or null when that is 0; out_d / out_id [B, ef].
// W x Mw <= 256.
FVDB_EXPORT int fvdb_beam_search(
    const void* x, int x_bf16, const float* x_sq, const uint8_t* mask,
    const int* adj, int adj_rows, int Mw, const int* up_offset, int layer,
    const float* q, int B, int D, const int* start, int S,
    const uint8_t* active, const uint8_t* result_mask, int ef, int max_iters,
    int W, unsigned char* scratch, float* out_d, int* out_id,
    cudaStream_t stream) {
  using namespace fvdb;
  if (B < 1 || D < 1 || ef < 1 || S < 1 || W < 1 || Mw < 1 || adj_rows < 1 ||
      W * Mw > CAP)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      x_bf16 ? beam_search<__nv_bfloat16>(
                   static_cast<const __nv_bfloat16*>(x), x_sq, mask, adj,
                   adj_rows, Mw, up_offset, layer, q, B, D, start, S, active,
                   result_mask, ef, max_iters, W, scratch, out_d, out_id,
                   stream)
             : beam_search<float>(
                   static_cast<const float*>(x), x_sq, mask, adj, adj_rows,
                   Mw, up_offset, layer, q, B, D, start, S, active,
                   result_mask, ef, max_iters, W, scratch, out_d, out_id,
                   stream));
}
