// K12: the probed-list scan of the IVF search, and its top-k, by row type
// and metric.
//
// Replaces the list scan of the JAX package's ivf_search_kernel
// (index/ivf.py:79, ivf_search_kernel(metric) at :104-120): for each query,
// the rows of its n_probe lists (ranked by K1 over the centroids, by the
// same metric) are scored max(|q|^2 - 2 q.x + |x|^2, 0), or by metric
// 1 - q.x / sqrt(max(|q|^2 |x|^2, 1e-30)) (cosine) or -q.x (dot), rows
// that are padding, past the mirror (>= N) or masked out never enter, and
// the k smallest (distance, row) come out sorted, padded with (+inf, -1).
// The rows are f32 or bf16 (a bf16 serving mirror), upcast exactly; the
// query stays f32 and x_sq are the mirror's f32 norms (on a bf16 mirror,
// the f32 host rows'), as the reference's einsum of an f32 query with
// gathered bf16 rows computes in f32. Cosine and dot distances can be
// negative; the radix select's keys (common.cuh) order them.
// A seed list (the HNSW beam's top-k in the pruned regime) may join the
// candidates, which folds the regime's two merge_topk calls into this
// selection: the beam's and the IVF's rows are disjoint.
// K15's sharded IVF search (parallel/sharded.py:206, its scan at :228-252)
// runs the same scan on each shard's lists: the probes are global list ids,
// the shard holds the lists [c_lo, c_lo + c_local) (tiles row probe - c_lo),
// and a probe outside them scans nothing, as a list another shard owns.
//
// What bounds it on the H100: the arithmetic, 2 D flops for each (query,
// probed row), and the probed rows, 4 D bytes each read once. At the 1M
// configuration (256 uneven lists, n_probe 16) a batch of 128 queries scores
// ~37.5M (query, row) pairs, 28.8 GFLOP, ~0.43 ms at 67 TFLOP/s, over the
// union of its probed lists, at most the ~900K IVF rows, 1.4 GB, ~0.41 ms.
//
// Two routes, by batch size (the wrapper picks; both end in the same
// candidate layout and selection):
// - The grouped route (larger batches) reads a list once for each group of
//   up to QT queries that probe it, not once a query. A one-block kernel
//   (ivf_group_kernel) counting-sorts the batch's (query, probe) pairs by
//   the list they own (histogram by atomics, a block-wide exclusive scan,
//   a scatter), computes each pair's candidate-slot offset (the prefix of
//   its query's earlier probes' lengths) and each query's |q|^2 once, puts
//   the seed after each query's lists, and writes the task count on the
//   card: a task is (list, group of <= QT of its queries, chunk of <= RT
//   of its rows), no host sync. The scan (ivf_tasks_kernel) is a
//   persistent grid that takes tasks by an atomic counter: a task streams
//   its rows, gathered by id from the tiles, and its queries through
//   shared memory DK dims at a time, in two stages filled by cp.async (the
//   next slice's copies in flight while this one is scored, no registers
//   held for them); warp w scores queries 4w..4w+3 against rows lane + 32 j
//   (j < 8) in f32 FMA (no TF32), and a warp whose queries are all past
//   the group's end skips the arithmetic. A slice's 32 products are summed
//   apart and then added to the total, which keeps the rounding of a dot
//   product near a tree's. The epilogue applies the metric, x_sq and the
//   masks and writes (distance, raw row) at each query's slots. The tasks
//   of one row chunk are consecutive, so a list's groups read it from L2.
// - The per-query route (small batches, where a list has one query and
//   grouping saves nothing): a block per (list chunk of 256 entries, probe,
//   query), a warp scoring four rows at a time with all loads in flight.
// A candidate row holds at most the P longest lists and the seed, and the
// caller runs the queries in chunks, so the buffer stays bounded at any B.
// The selection: after the grouped scan at k <= BAR_MAX_K, a filter keeps
// the candidates at or below the bar the scan set (the k-th smallest of its
// lanes' minima, an upper bound on the query's k-th) and one block a query
// sorts them; topk_select.cuh's radix passes take any other case, and a
// query whose survivors pass its slots (min(stride, SURV_CAP)).
#include "common.cuh"
#include "topk_select.cuh"

namespace fvdb {

constexpr int CH = 256;  // list entries a block of the per-query route
constexpr int QT = 32;   // queries a task of the grouped route (8 warps x 4)
constexpr int RT = 256;  // list entries a task (32 lanes x 8)
constexpr int DK = 32;   // dims a shared-memory slice
constexpr int XS = RT + 1;  // row stride of the row slice: no bank conflict
constexpr int QS = QT + 4;  // of the query slice (16-byte rows for float4)
constexpr int GROUP_NT = 1024;  // threads of the group kernel
constexpr long long SELECT_PER_BLOCK = 16384;  // candidates a select block
constexpr int BAR_MAX_K = 32;  // k up to which the grouped route sets a bar
constexpr int SURV_CAP = 8192;  // survivors a query sorts in a block

// The row of tiles that holds global list pr, or -1: a probe of -1 (no
// finite centroid distance) or a list outside [c_lo, c_lo + c_local).
__device__ __forceinline__ int owned_list(int pr, int c_lo, int c_local) {
  const int l = pr - c_lo;
  return pr >= 0 && l >= 0 && l < c_local ? l : -1;
}

template <typename T, int METRIC>
__global__ void __launch_bounds__(NT) ivf_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ x_sq,
    const uint8_t* __restrict__ mask, const uint8_t* __restrict__ mask2,
    const int* __restrict__ tiles, int L_pad,
    const int* __restrict__ list_len, const int* __restrict__ probe, int P,
    int c_lo, int c_local, const float* __restrict__ q, int D, int N,
    const float* __restrict__ seed_d, const int* __restrict__ seed_r,
    int seed_stride, int k_seed, long long stride,
    float* __restrict__ cand_d, int* __restrict__ cand_r,
    int* __restrict__ n_per) {
  extern __shared__ float qs[];
  __shared__ int s_off, s_len, s_cl, s_tot;
  __shared__ float s_qsq;
  const int chunk = blockIdx.x, p = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const int* pr = probe + (size_t)b * P;
  if (t == 0) {  // a probe of no list held here is empty
    int off = 0, tot = 0;
    for (int i = 0; i < P; ++i) {
      const int li = owned_list(pr[i], c_lo, c_local);
      const int len = li >= 0 ? list_len[li] : 0;
      off += i < p ? len : 0;
      tot += len;
    }
    s_off = off;
    s_tot = tot;
    s_cl = owned_list(pr[p], c_lo, c_local);
    s_len = s_cl >= 0 ? list_len[s_cl] : 0;
  }
  __syncthreads();
  float* cd = cand_d + (size_t)b * stride;
  int* cr = cand_r + (size_t)b * stride;
  if (p == 0 && chunk == 0) {  // the seed goes after the lists
    for (int i = t; i < k_seed; i += NT) {
      cd[s_tot + i] = seed_d[(size_t)b * seed_stride + i];
      cr[s_tot + i] = seed_r[(size_t)b * seed_stride + i];
    }
    if (t == 0) n_per[b] = s_tot + k_seed;
  }
  const int lo = chunk * CH;
  const int hi = min(s_len, lo + CH);
  if (lo >= hi) return;  // the whole block
  for (int d = t; d < D; d += NT) qs[d] = q[(size_t)b * D + d];
  __syncthreads();
  if (w == 0) {
    const float s = warp_row_sq(qs, D);
    if (lane == 0) s_qsq = s;
  }
  __syncthreads();
  const float q_sq = s_qsq;
  const int* list = tiles + (size_t)s_cl * L_pad;
  const int off = s_off;
  for (int i0 = lo + w * 4; i0 < hi; i0 += (NT / 32) * 4) {
    int raw[4], rows[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int r = i0 + g < hi ? list[i0 + g] : -1;
      const bool ok = r >= 0 && r < N && mask[r] && (!mask2 || mask2[r]);
      raw[g] = r;
      rows[g] = ok ? r : -1;
    }
    float dots[4];
    warp_dots<4>(qs, x, rows, D, dots);
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      if (g == lane && i0 + g < hi) {
        cd[off + i0 + g] =
            rows[g] >= 0 ? metric_dist<METRIC>(q_sq, dots[g], x_sq[rows[g]])
                         : INFINITY;
        cr[off + i0 + g] = raw[g];
      }
    }
  }
}

// The grouped route's scratch, carved from one int buffer: per list its
// pair count, pair start and task start (C + 1 each), per (query, probe)
// pair its rank in its list and its slot offset, the pairs sorted by list
// (query, slot offset), |q|^2 a query, [task count, next task], and for
// the filtered select a query's survivor count, then (8-byte aligned) its
// bar and `cap` survivor slots: min(stride, SURV_CAP) at k <= BAR_MAX_K
// (a query has at most stride candidates), none above, where no bar is set.
struct GroupScratch {
  int* cnt;
  int* lstart;
  int* tstart;
  int* prank;
  int* poff;
  int* pair_b;
  int* pair_off;
  float* q_sq;
  int* ctl;
  int* scnt;
  unsigned long long* bar;
  unsigned long long* surv;
  int cap;  // survivor slots a query
};

__host__ __device__ inline long long group_ints_head(int B, int P, int C) {
  const long long n = (long long)C + 2LL * (C + 1) + 4LL * B * P + B + 2 + B;
  return n + (n & 1);  // the 64-bit words start 8 bytes aligned
}

__host__ __device__ inline int surv_slots(int k, long long stride) {
  return k <= BAR_MAX_K ? (int)(stride < SURV_CAP ? stride : SURV_CAP) : 0;
}

__host__ __device__ inline long long group_scratch_ints(int B, int P, int C,
                                                        int cap) {
  return group_ints_head(B, P, C) + 2LL * B * (1 + (long long)cap);
}

__host__ __device__ inline GroupScratch carve_group(int* base, int B, int P,
                                                    int C, int cap) {
  GroupScratch g;
  g.cnt = base;
  g.lstart = g.cnt + C;
  g.tstart = g.lstart + (C + 1);
  g.prank = g.tstart + (C + 1);
  g.poff = g.prank + (size_t)B * P;
  g.pair_b = g.poff + (size_t)B * P;
  g.pair_off = g.pair_b + (size_t)B * P;
  g.q_sq = reinterpret_cast<float*>(g.pair_off + (size_t)B * P);
  g.ctl = reinterpret_cast<int*>(g.q_sq + B);
  g.scnt = g.ctl + 2;
  g.bar = reinterpret_cast<unsigned long long*>(base +
                                                group_ints_head(B, P, C));
  g.surv = g.bar + B;
  g.cap = cap;
  return g;
}

// The tasks of a list of len entries probed by cnt queries.
__device__ __forceinline__ int list_tasks(int cnt, int len) {
  return cnt > 0 && len > 0 ? ((cnt + QT - 1) / QT) * ((len + RT - 1) / RT)
                            : 0;
}

// Inclusive sums of v over the block's threads in thread order; s holds
// GROUP_NT / 32 ints of shared memory. Every thread calls it.
__device__ __forceinline__ int block_inclusive(int v, int* s) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(FULL, v, off);
    if (lane >= off) v += o;
  }
  if (lane == 31) s[w] = v;
  __syncthreads();
  if (w == 0) {
    int u = lane < GROUP_NT / 32 ? s[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(FULL, u, off);
      if (lane >= off) u += o;
    }
    if (lane < GROUP_NT / 32) s[lane] = u;
  }
  __syncthreads();
  return v + (w > 0 ? s[w - 1] : 0);
}

// Exclusive scans of each list's pair count and task count over [0, C)
// into lstart and tstart, their totals at [C]; each thread sums a run of
// consecutive lists. Every thread of the GROUP_NT block calls it.
__device__ void scan_lists(const int* cnt, const int* len, int C,
                           int* lstart, int* tstart, int* s_a, int* s_b) {
  const int t = threadIdx.x, per = (C + GROUP_NT - 1) / GROUP_NT;
  const int lo = min(C, t * per), hi = min(C, lo + per);
  int sa = 0, sb = 0;
  for (int l = lo; l < hi; ++l) {
    sa += cnt[l];
    sb += list_tasks(cnt[l], len[l]);
  }
  const int ia = block_inclusive(sa, s_a);
  const int ib = block_inclusive(sb, s_b);
  if (t == GROUP_NT - 1) {
    lstart[C] = ia;
    tstart[C] = ib;
  }
  sa = ia - sa;
  sb = ib - sb;
  for (int l = lo; l < hi; ++l) {
    lstart[l] = sa;
    tstart[l] = sb;
    sa += cnt[l];
    sb += list_tasks(cnt[l], len[l]);
  }
}

// One block of GROUP_NT threads: the batch's work list (see the header).
__global__ void __launch_bounds__(GROUP_NT) ivf_group_kernel(
    const int* __restrict__ list_len, const int* __restrict__ probe, int B,
    int P, int c_lo, int C, const float* __restrict__ q, int D,
    const float* __restrict__ seed_d, const int* __restrict__ seed_r,
    int seed_stride, int k_seed, long long stride, float* __restrict__ cand_d,
    int* __restrict__ cand_r, int* __restrict__ n_per, GroupScratch g) {
  __shared__ int s_a[GROUP_NT / 32], s_b[GROUP_NT / 32];
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  for (int l = t; l < C; l += GROUP_NT) g.cnt[l] = 0;
  __syncthreads();
  for (int b = t; b < B; b += GROUP_NT) {  // a query's probes in order
    int off = 0;
    for (int p = 0; p < P; ++p) {
      const int i = b * P + p;
      const int li = owned_list(probe[i], c_lo, C);
      const int len = li >= 0 ? list_len[li] : 0;
      g.poff[i] = off;
      g.prank[i] = len > 0 ? atomicAdd(&g.cnt[li], 1) : -1;
      off += len;
    }
    n_per[b] = off + k_seed;
  }
  for (int b = w; b < B; b += GROUP_NT / 32) {
    const float s = warp_row_sq(q + (size_t)b * D, D);
    if (lane == 0) {
      g.q_sq[b] = s;
      g.bar[b] = ~0ull;
      g.scnt[b] = 0;
    }
  }
  __syncthreads();
  scan_lists(g.cnt, list_len, C, g.lstart, g.tstart, s_a, s_b);
  __syncthreads();
  for (int i = t; i < B * P; i += GROUP_NT) {
    if (g.prank[i] < 0) continue;
    const int li = owned_list(probe[i], c_lo, C);
    const int pos = g.lstart[li] + g.prank[i];
    g.pair_b[pos] = i / P;
    g.pair_off[pos] = g.poff[i];
  }
  for (long long i = t; i < (long long)B * k_seed; i += GROUP_NT) {
    const int b = (int)(i / k_seed), j = (int)(i % k_seed);
    const long long at = (long long)b * stride + n_per[b] - k_seed + j;
    cand_d[at] = seed_d[(size_t)b * seed_stride + j];
    cand_r[at] = seed_r[(size_t)b * seed_stride + j];
  }
  if (t == 0) {
    g.ctl[0] = g.tstart[C];
    g.ctl[1] = 0;
  }
}

// cp.async of one 4-byte word, global to shared, through L1; the bytes
// past src_bytes (0 or 4) are zero-filled, and src is not read at 0.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 4-byte words of a row's DK-dim slice: one f32 element or two bf16 ones
// (element 2p in the low half of word p, as the row lies in memory).
template <typename T>
__host__ __device__ constexpr int slice_words() {
  return DK * (int)sizeof(T) / 4;
}

// Dynamic shared memory of the grouped scan: two stages of the rows'
// slice ([word][row], XS apart) and of the queries' ([dim][query], QS).
template <typename T>
__host__ __device__ constexpr int tasks_smem() {
  return 2 * (slice_words<T>() * XS + DK * QS) * 4;
}

// Queue the DK-dim slice at d0 of the task's rows (s_rows[r] < 0: zeros)
// and of its queries (s_b[i] < 0: zeros) into stage buffers xs, qs. Warp w
// takes rows w + 8 m (m < 32): a f32 row's 32 words a warp instruction;
// bf16 rows two at a time (m and m + 2, whose banks differ by 16), 16
// words each. Every word lands in its own bank.
template <typename T>
__device__ __forceinline__ void queue_slice(
    const T* __restrict__ x, const float* __restrict__ q, int D, int d0,
    const int* s_rows, const int* s_b, unsigned* xs, float* qs) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int WR = slice_words<T>();
  constexpr int PER = 32 / WR;  // rows a warp instruction
#pragma unroll 4
  for (int i = 0; i < 32 / PER; ++i) {
    const int word = lane % WR, h = lane / WR;
    const int m = PER == 1 ? i : (i >> 1) * 4 + (i & 1) + 2 * h;
    const int rr = w + 8 * m;
    const int r = s_rows[rr];
    const int e0 = d0 + word * (4 / (int)sizeof(T));  // first element
    const bool ok = r >= 0 && e0 < D;
    const T* src = ok ? x + (size_t)r * D + e0 : x;
    cp_async4(xs + word * XS + rr, src, ok ? 4 : 0);
  }
#pragma unroll
  for (int i = 0; i < QT / 8; ++i) {
    const int qi = w + 8 * i, b = s_b[qi];
    const bool ok = b >= 0 && d0 + lane < D;
    const float* src = ok ? q + (size_t)b * D + d0 + lane : q;
    cp_async4(qs + lane * QS + qi, src, ok ? 4 : 0);
  }
}

// Fold slice word p of stage xs, qs into acc: warp w's queries 4w..4w+3
// against rows lane + 32 j.
template <typename T>
__device__ __forceinline__ void fma_word(const unsigned* xs, const float* qs,
                                         int p, float (&acc)[4][8]) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned u[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) u[j] = xs[p * XS + lane + 32 * j];
  if constexpr (sizeof(T) == 4) {
    const float4 qv = *reinterpret_cast<const float4*>(qs + p * QS + 4 * w);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float v = __uint_as_float(u[j]);
      acc[0][j] = fmaf(qv.x, v, acc[0][j]);
      acc[1][j] = fmaf(qv.y, v, acc[1][j]);
      acc[2][j] = fmaf(qv.z, v, acc[2][j]);
      acc[3][j] = fmaf(qv.w, v, acc[3][j]);
    }
  } else {
    const float4 q0 =
        *reinterpret_cast<const float4*>(qs + (2 * p) * QS + 4 * w);
    const float4 q1 =
        *reinterpret_cast<const float4*>(qs + (2 * p + 1) * QS + 4 * w);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float lo = __uint_as_float(u[j] << 16);
      const float hi = __uint_as_float(u[j] & 0xffff0000u);
      acc[0][j] = fmaf(q0.x, lo, acc[0][j]);
      acc[1][j] = fmaf(q0.y, lo, acc[1][j]);
      acc[2][j] = fmaf(q0.z, lo, acc[2][j]);
      acc[3][j] = fmaf(q0.w, lo, acc[3][j]);
      acc[0][j] = fmaf(q1.x, hi, acc[0][j]);
      acc[1][j] = fmaf(q1.y, hi, acc[1][j]);
      acc[2][j] = fmaf(q1.z, hi, acc[2][j]);
      acc[3][j] = fmaf(q1.w, hi, acc[3][j]);
    }
  }
}

static_assert(NT == RT, "the grouped scan reads a chunk row a thread");

// The 32 lanes' keys sorted ascending across the warp (a bitonic network
// of shuffles); lane i ends with the i-th smallest.
__device__ __forceinline__ unsigned long long warp_sort(unsigned long long v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int len = 2; len <= 32; len <<= 1)
#pragma unroll
    for (int j = len >> 1; j > 0; j >>= 1) {
      const unsigned long long o = __shfl_xor_sync(FULL, v, j);
      const bool keep_min = ((lane & j) == 0) == ((lane & len) == 0);
      v = keep_min ? (v < o ? v : o) : (v < o ? o : v);
    }
  return v;
}

template <typename T, int METRIC>
__global__ void __launch_bounds__(NT, 2) ivf_tasks_kernel(
    const T* __restrict__ x, const float* __restrict__ x_sq,
    const uint8_t* __restrict__ mask, const uint8_t* __restrict__ mask2,
    const int* __restrict__ tiles, int L_pad,
    const int* __restrict__ list_len, int C, const float* __restrict__ q,
    int D, int N, long long stride, int kbar, float* __restrict__ cand_d,
    int* __restrict__ cand_r, GroupScratch g) {
  extern __shared__ __align__(16) unsigned smem[];
  constexpr int WR = slice_words<T>();
  float* const qs0 = reinterpret_cast<float*>(smem + 2 * WR * XS);
  __shared__ int s_task, s_l, s_q0, s_nq, s_r0;
  __shared__ int s_rows[RT], s_raw[RT], s_b[QT];
  __shared__ long long s_slot[QT];
  __shared__ float s_qsq[QT];
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const int ntask = g.ctl[0];
  for (;;) {
    if (t == 0) {
      const int task = atomicAdd(&g.ctl[1], 1);
      s_task = task;
      if (task < ntask) {  // the list: the last l with tstart[l] <= task
        int lo = 0, hi = C - 1;
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (g.tstart[mid] <= task) lo = mid; else hi = mid - 1;
        }
        const int cnt = g.lstart[lo + 1] - g.lstart[lo];
        const int ngroups = (cnt + QT - 1) / QT;
        const int local = task - g.tstart[lo];
        const int grp = local % ngroups;  // a chunk's groups in a row
        s_l = lo;
        s_q0 = g.lstart[lo] + grp * QT;
        s_nq = min(QT, cnt - grp * QT);
        s_r0 = (local / ngroups) * RT;
      }
    }
    __syncthreads();
    if (s_task >= ntask) return;
    const int nq = s_nq, r0 = s_r0;
    {
      const int len = list_len[s_l];
      const int e = r0 + t;
      const int raw = e < len ? tiles[(size_t)s_l * L_pad + e] : -1;
      s_raw[t] = raw;
      s_rows[t] = raw >= 0 && raw < N && mask[raw] && (!mask2 || mask2[raw])
                      ? raw : -1;
      if (t < QT) {
        const int b = t < nq ? g.pair_b[s_q0 + t] : -1;
        s_b[t] = b;
        s_slot[t] =
            b >= 0 ? (long long)b * stride + g.pair_off[s_q0 + t] : 0;
        s_qsq[t] = b >= 0 ? g.q_sq[b] : 0.f;
      }
    }
    __syncthreads();
    const bool active = 4 * w < nq;
    // a slice's products go to acc, then into tot: 32 terms a running sum
    // before it joins the total, so the rounding stays near a tree's
    float acc[4][8], tot[4][8];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 8; ++j) tot[a][j] = 0.f;
    const int nsl = (D + DK - 1) / DK;
    queue_slice(x, q, D, 0, s_rows, s_b, smem, qs0);
    cp_async_commit();
    for (int sl = 0; sl < nsl; ++sl) {
      const int st = sl & 1;  // this slice's stage; the next one's is 1 - st
      if (sl + 1 < nsl) {
        queue_slice(x, q, D, (sl + 1) * DK, s_rows, s_b,
                    smem + (1 - st) * WR * XS, qs0 + (1 - st) * DK * QS);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (active) {
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[a][j] = 0.f;
#pragma unroll 4
        for (int p = 0; p < WR; ++p)
          fma_word<T>(smem + st * WR * XS, qs0 + st * DK * QS, p, acc);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < 8; ++j) tot[a][j] += acc[a][j];
      }
      __syncthreads();  // the stage is free for slice sl + 2
    }
    if (active) {
      const int len = list_len[s_l];
      // each lane's smallest key a query: the kbar-th smallest of the 32
      // bounds the query's kbar-th candidate (kbar candidates lie at or
      // below it), the bar of the filtered select
      unsigned long long lmin[4] = {~0ull, ~0ull, ~0ull, ~0ull};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int rr = lane + 32 * j;
        if (r0 + rr >= len) continue;
        const int row = s_rows[rr];
        const float xq = row >= 0 ? x_sq[row] : 0.f;
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int qi = 4 * w + a;
          if (qi >= nq) continue;
          const long long at = s_slot[qi] + r0 + rr;
          const float dist =
              row >= 0 ? metric_dist<METRIC>(s_qsq[qi], tot[a][j], xq)
                       : INFINITY;
          cand_d[at] = dist;
          cand_r[at] = s_raw[rr];
          const unsigned key = dist_key(dist);
          if (finite_key(key)) {
            const unsigned long long c =
                ((unsigned long long)key << 32) | (unsigned)row;
            lmin[a] = c < lmin[a] ? c : lmin[a];
          }
        }
      }
      if (kbar > 0) {
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          if (4 * w + a >= nq) break;  // uniform across the warp
          const unsigned long long kth =
              __shfl_sync(FULL, warp_sort(lmin[a]), kbar - 1);
          if (lane == 0 && kth != ~0ull)
            atomicMin(&g.bar[s_b[4 * w + a]], kth);
        }
      }
    }
    __syncthreads();  // the task's shared state is free for the next
  }
}

// The filtered select's first pass: each block takes its slice of query
// b's candidates and keeps those at or below the query's bar (finite, by
// (distance, row)); survivors go to the query's list by warp-aggregated
// atomics, up to its g.cap slots (the count goes past, so an overflow shows,
// and a warp whose atomic finds it past stops reading). A row is read only
// for a candidate whose distance passes.
__global__ void __launch_bounds__(NT) ivf_filter_kernel(
    const float* __restrict__ cand_d, const int* __restrict__ cand_r,
    const int* __restrict__ n_per, long long stride, GroupScratch g) {
  const int b = blockIdx.y, lane = threadIdx.x & 31;
  const unsigned long long bar = g.bar[b];
  const float* d = cand_d + (size_t)b * stride;
  const int* r = cand_r + (size_t)b * stride;
  unsigned long long* out = g.surv + (size_t)b * g.cap;
  int lo, hi;
  slice_of(n_per, stride, b, &lo, &hi);
  for (int i0 = lo; i0 < hi; i0 += NT) {  // the same trip count in a warp
    const int i = i0 + threadIdx.x;
    bool take = false;
    unsigned long long c = 0ull;
    if (i < hi) {
      const unsigned key = dist_key(d[i]);
      if (finite_key(key) && ((unsigned long long)key << 32) <= bar) {
        c = ((unsigned long long)key << 32) | (unsigned)r[i];
        take = c <= bar;
      }
    }
    const unsigned m = __ballot_sync(FULL, take);
    if (m == 0u) continue;  // uniform across the warp
    int base = 0;
    if (lane == 0) base = atomicAdd(&g.scnt[b], __popc(m));
    base = __shfl_sync(FULL, base, 0);
    if (base >= g.cap) break;  // overflowed: the radix passes take it
    const int pos = base + __popc(m & ((1u << lane) - 1u));
    if (take && pos < g.cap) out[pos] = c;
  }
}

// One block a query: sort its survivors in shared memory and write the k
// first, padded with (+inf, -1); mark the query finished for the radix
// passes (done, k = -1). A query with more survivors than its g.cap slots
// is left to them.
__global__ void __launch_bounds__(NT) ivf_survivors_kernel(
    GroupScratch g, int k, SelState* __restrict__ st,
    float* __restrict__ out_d, int* __restrict__ out_r) {
  extern __shared__ unsigned long long buf[];  // pow2_at_least(g.cap) keys
  const int b = blockIdx.x, t = threadIdx.x;
  const int n = g.scnt[b];
  if (n > g.cap) return;
  const int sz = pow2_at_least(n > 0 ? n : 1), half = sz >> 1;
  const unsigned long long* src = g.surv + (size_t)b * g.cap;
  for (int i = t; i < sz; i += NT) buf[i] = i < n ? src[i] : ~0ull;
  __syncthreads();
  for (int len = 2; len <= sz; len <<= 1) {
    for (int j = len >> 1; j > 0; j >>= 1) {
      for (int p = t; p < half; p += NT) {  // pair p: (i, i + j)
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const unsigned long long a = buf[i], c = buf[i + j];
        if ((a > c) == ((i & len) == 0)) {
          buf[i] = c;
          buf[i + j] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int j = t; j < k; j += NT) {
    const unsigned long long c = j < n ? buf[j] : ~0ull;
    const bool ok = c != ~0ull;
    out_d[(size_t)b * k + j] = ok ? key_dist((unsigned)(c >> 32)) : INFINITY;
    out_r[(size_t)b * k + j] = ok ? (int)(unsigned)(c & 0xffffffffull) : -1;
  }
  if (t == 0) {
    st[b].done = 1;
    st[b].k = -1;
  }
}

template <typename T, int METRIC>
cudaError_t ivf_scan(const T* x, const float* x_sq, const uint8_t* mask,
                     const uint8_t* mask2, const int* tiles, int L_pad,
                     const int* list_len, const int* probe, int P,
                     int c_lo, int c_local, const float* q, int B, int D,
                     int N, const float* seed_d, const int* seed_r,
                     int seed_stride, int k_seed, int k, long long stride,
                     float* cand_d, int* cand_r, int* n_per, int* group,
                     void* work, float* out_d, int* out_r,
                     cudaStream_t stream) {
  cudaError_t e = cudaSuccess;
  // the grouped route copies 4-byte words: bf16 rows need an even D
  const bool grouped = group != nullptr && (sizeof(T) == 4 || (D & 1) == 0);
  if (grouped) {
    const GroupScratch g =
        carve_group(group, B, P, c_local, surv_slots(k, stride));
    ivf_group_kernel<<<1, GROUP_NT, 0, stream>>>(
        list_len, probe, B, P, c_lo, c_local, q, D, seed_d, seed_r,
        seed_stride, k_seed, stride, cand_d, cand_r, n_per, g);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    static int grid[64];  // blocks resident at once, by device
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
    constexpr int smem = tasks_smem<T>();
    if (grid[dev] == 0) {
      int sms = 0, per = 0;
      e = cudaFuncSetAttribute(ivf_tasks_kernel<T, METRIC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
      if (e != cudaSuccess) return e;
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (e != cudaSuccess) return e;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per, ivf_tasks_kernel<T, METRIC>, NT, smem);
      if (e != cudaSuccess) return e;
      grid[dev] = sms * (per > 0 ? per : 1);
    }
    ivf_tasks_kernel<T, METRIC><<<grid[dev], NT, smem, stream>>>(
        x, x_sq, mask, mask2, tiles, L_pad, list_len, c_local, q, D, N,
        stride, k <= BAR_MAX_K ? k : 0, cand_d, cand_r, g);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  } else {  // the per-query route
    const int smem = D * 4;
    static int cap[64];
    e = raise_smem_cap(
        reinterpret_cast<const void*>(ivf_scan_kernel<T, METRIC>), smem, cap);
    if (e != cudaSuccess) return e;
    dim3 grid((L_pad + CH - 1) / CH, P, B);
    ivf_scan_kernel<T, METRIC><<<grid, NT, smem, stream>>>(
        x, x_sq, mask, mask2, tiles, L_pad, list_len, probe, P, c_lo,
        c_local, q, D, N, seed_d, seed_r, seed_stride, k_seed, stride, cand_d,
        cand_r, n_per);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  // a batch's candidate rows are long (~300K at the 1M tier): 16K a block
  if (!grouped || k > BAR_MAX_K)
    return launch_select_topk(cand_d, cand_r, n_per, stride, B, k, work,
                              out_d, out_r, stream, SELECT_PER_BLOCK);
  // the filtered select: what passes the scan's bar, sorted a query; the
  // radix passes take only a query whose survivors overflow
  const GroupScratch g =
      carve_group(group, B, P, c_local, surv_slots(k, stride));
  e = select_zero(work, B, k, stream);
  if (e != cudaSuccess) return e;
  ivf_filter_kernel<<<select_grid(stride, B, SELECT_PER_BLOCK), NT, 0,
                      stream>>>(cand_d, cand_r, n_per, stride, g);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // the kernel's cap is raised to the most any call takes, the same in
  // every instance of this template (each holds its own surv_cap)
  static int surv_cap[64];
  const int smem = pow2_at_least(g.cap) * 8;
  e = raise_smem_cap(reinterpret_cast<const void*>(ivf_survivors_kernel),
                     SURV_CAP * 8, surv_cap);
  if (e != cudaSuccess) return e;
  ivf_survivors_kernel<<<B, NT, smem, stream>>>(
      g, k, carve_select(work, B, k).st, out_d, out_r);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_select_topk(cand_d, cand_r, n_per, stride, B, k, work, out_d,
                            out_r, stream, SELECT_PER_BLOCK, true);
}

}  // namespace fvdb

// Ints of the grouped route's scratch for B queries of P probes over C
// lists, selecting k of candidate rows `stride` long.
FVDB_EXPORT long long fvdb_ivf_group_ints(int B, int P, int C, int k,
                                          long long stride) {
  return fvdb::group_scratch_ints(B, P, C, fvdb::surv_slots(k, stride));
}

// x [N, D] (x_bf16: bf16, else f32), x_sq [N], mask / mask2 [N] uint8
// (mask2 may be null), tiles [C, L_pad] int32 (each list packed at the
// front), list_len [C], probe [B, P] (from K1 over the centroids: global
// list ids; tiles row i holds list c_lo + i, for i < C, and any other probe
// scans nothing), q [B, D]; metric 0 euclidean, 1 cosine, 2 dot; seed_*
// [B, seed_stride] with its first k_seed entries joining (k_seed may be
// 0); cand_* [B, stride] scratch with stride >= the lengths of the P
// longest lists + k_seed (the most candidates any query can have), n_per
// [B] scratch; group: null for the per-query route, else
// fvdb_ivf_group_ints(B, P, C, k, stride) ints of scratch for the grouped
// route; work: fvdb_select_scratch_bytes(B, k) bytes; out_* [B, k].
FVDB_EXPORT int fvdb_ivf_scan(
    const void* x, int x_bf16, int metric, const float* x_sq,
    const uint8_t* mask, const uint8_t* mask2, const int* tiles, int L_pad,
    const int* list_len, const int* probe, int P, int c_lo, int C,
    const float* q, int B, int D, int N, const float* seed_d,
    const int* seed_r, int seed_stride, int k_seed, int k, long long stride,
    float* cand_d, int* cand_r, int* n_per, int* group, void* work,
    float* out_d, int* out_r, cudaStream_t stream) {
  using namespace fvdb;
  if (B < 1 || D < 1 || P < 1 || L_pad < 1 || k < 1 || k_seed < 0 || C < 0 ||
      stride < (long long)k_seed + 1 || B > 65535 || P > 65535 ||
      (group != nullptr && (C < 1 || (long long)B * P > 0x7fffffffLL ||
                            stride > 0x7fffffffLL)))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_metric(metric, [&](auto m) {
    constexpr int M = decltype(m)::value;
    return x_bf16
               ? ivf_scan<__nv_bfloat16, M>(
                     static_cast<const __nv_bfloat16*>(x), x_sq, mask, mask2,
                     tiles, L_pad, list_len, probe, P, c_lo, C, q, B, D, N,
                     seed_d, seed_r, seed_stride, k_seed, k, stride, cand_d,
                     cand_r, n_per, group, work, out_d, out_r, stream)
               : ivf_scan<float, M>(
                     static_cast<const float*>(x), x_sq, mask, mask2, tiles,
                     L_pad, list_len, probe, P, c_lo, C, q, B, D, N, seed_d,
                     seed_r, seed_stride, k_seed, k, stride, cand_d, cand_r,
                     n_per, group, work, out_d, out_r, stream);
  }));
}
