// K1's two passes, shared by the f32 search (csrc/l2_topk.cu), its bf16-row
// form (the reduced-rank calibration oracle, also csrc/l2_topk.cu) and the
// reduced-rank stage 1 (csrc/stage1_select.cu).
//
// d(q, x) = max(|q|^2 - 2 q'.x + |x|^2, 0) in f32 with FMA (no TF32), where
// x is read as f32 or bf16 (upcast exactly), q' is q or, with ROUND_Q, q
// rounded to bf16 (round to nearest even) for the product only: |q|^2 always
// comes from the f32 q. METRIC (common.cuh) swaps the epilogue for cosine,
// 1 - q'.x / sqrt(max(|q|^2 |x|^2, 1e-30)), or dot, -q'.x; the product is
// the same. Rows where the mask is False never enter the result; result
// rows are sorted by (distance, row), padded with (+inf, -1).
//
// Design:
//  * Pass 1 splits N into S slices so that (B / 32) * S blocks make one wave
//    at two blocks an SM. A block takes 32 queries and walks its slice in
//    tiles of 256 rows. The corpus is read once per 32 queries, and the
//    blocks of one slice run side by side so the other query tiles find it
//    in L2.
//  * The tile product is FMA-bound, not shared-memory-bound: each thread
//    owns 4 queries x 8 rows, so one 16-byte load of the query chunk and two
//    of the row chunk feed 32 FMAs. Chunks of 16 dims are staged in shared
//    memory twice over: the next chunk's global loads are in flight in
//    registers while the current one is multiplied.
//  * The 32 x 256 distances then go through shared memory (over the stages,
//    which are free by then) to the warp that selects for them: warp w owns
//    queries 4w..4w+3. Each query's list (k <= 256 pairs) lives in shared
//    memory (32 * k * 8 bytes a block); a candidate is tested against the
//    list's last entry (a ballot across the warp), and only the few that
//    pass are inserted, one at a time, by the whole warp.
//  * Pass 2 merges the S sorted lists of each query in one block: each warp
//    folds every 8th list into a list of its own (the first one by a plain
//    copy), then one warp folds the 8 results.
//
// k > 256: the lists would not fit shared memory, so pass 1 (DUMP) runs the
// same tile product but writes each query's masked distances (+inf where
// the mask is False) to a [B, N] buffer, and topk_select.cuh's radix select
// picks the k smallest (distance, row) of each buffer row.
//
// BINS (K9, csrc/approx_topk.cu): row r falls in bin r mod M, and pass 1
// keeps each bin's (distance, row) minimum instead. A block owns 256
// consecutive bins (blockIdx.y) and a range of rounds (blockIdx.z): round i
// is rows i M + j0 .. i M + j0 + 255, consecutive in memory, so the tiles
// stay contiguous. Each thread keeps the minima of one bin for the 32
// queries in shared memory across the rounds; at the end one atomicMin a
// (query, bin) folds them into a [B, M] table of packed 64-bit keys
// (common.cuh's dist_key << 32 | row), which order as (distance, row).
#pragma once

#include "common.cuh"

namespace fvdb {

constexpr int QT = 32;       // queries a block
constexpr int RT = 256;      // rows a tile
constexpr int KC = 16;       // dims a chunk
constexpr int APAD = QT + 4;  // row lengths keep 16-byte alignment and
constexpr int BPAD = RT + 4;  // spread the transposed stores over the banks
constexpr int DPAD = RT + 4;

struct Stage {
  float a[KC][APAD];
  float b[KC][BPAD];
};
union PassSmem {
  Stage st[2];
  float dist[QT][DPAD];  // used between a tile's product and its selection
};
static_assert(sizeof(float) * QT * DPAD <= sizeof(Stage) * 2, "alias");

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Rows of pass 1's slices: a multiple of the tile.
inline int slice_rows(int N, int S) {
  const int split = (N + S - 1) / S;
  return (split + RT - 1) / RT * RT;
}

// What pass 1 does with a tile's distances.
constexpr int SEL_LISTS = 0;  // offer them to per-query lists (k <= 256)
constexpr int SEL_DUMP = 1;   // write them to dump [B, N]
constexpr int SEL_BINS = 2;   // keep each bin's minimum (K9)
static_assert(NT == RT, "BINS: a thread owns one bin of a tile");

// split_rows: rows a slice (LISTS, DUMP) or rounds a block (BINS); bins: M
// and bin_keys [B, M] (BINS only).
template <typename T, bool ROUND_Q, int MODE, int METRIC = EUCLID>
__global__ void __launch_bounds__(NT, 2) l2_topk_partial(
    const T* __restrict__ x, const float* __restrict__ x_sq,
    const uint8_t* __restrict__ mask, long long mask_stride,
    const float* __restrict__ q, int B, int N, int D, int k, int split_rows,
    float* __restrict__ part_d, int* __restrict__ part_r,
    float* __restrict__ dump, int bins,
    unsigned long long* __restrict__ bin_keys) {
  __shared__ __align__(16) PassSmem s;
  __shared__ float q_sq[QT];
  extern __shared__ __align__(16) unsigned char dyn[];
  float* list_d = reinterpret_cast<float*>(dyn);
  int* list_r = reinterpret_cast<int*>(dyn + sizeof(float) * QT * k);
  unsigned long long* bmin = reinterpret_cast<unsigned long long*>(dyn);

  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const int qg = lane >> 2, rg = lane & 3;  // product: queries qg*4+i,
  const int rbase = w * 32 + rg * 8;        // rows rbase + j
  const int q0 = blockIdx.x * QT;
  const int qn = min(QT, B - q0);
  const float* qb = q + (size_t)q0 * D;
  // LISTS / DUMP: tiles of a row slice; BINS: rounds of a bin tile
  int row_lo = 0, row_hi = 0, j0 = 0, bw = 0, i_lo = 0, n_tiles = 0;
  if constexpr (MODE == SEL_BINS) {
    j0 = blockIdx.y * RT;
    bw = min(RT, bins - j0);
    i_lo = blockIdx.z * split_rows;
    const int rounds = (N + bins - 1) / bins;
    n_tiles = max(0, min(rounds, i_lo + split_rows) - i_lo);
#pragma unroll
    for (int ql = 0; ql < QT; ++ql) bmin[ql * RT + t] = ~0ull;
  } else {
    row_lo = blockIdx.y * split_rows;
    row_hi = min(N, row_lo + split_rows);
    n_tiles = row_hi > row_lo ? (row_hi - row_lo + RT - 1) / RT : 0;
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ql = w * 4 + i;
    const float v = ql < qn ? warp_row_sq(qb + (size_t)ql * D, D) : 0.f;
    if (lane == 0) q_sq[ql] = v;
  }
  int fill[4] = {0, 0, 0, 0};  // list fill of the warp's 4 queries

  for (int tile = 0; tile < n_tiles; ++tile) {
    int r0, rn;
    if constexpr (MODE == SEL_BINS) {
      r0 = (i_lo + tile) * bins + j0;
      rn = min(bw, N - r0);
    } else {
      r0 = row_lo + tile * RT;
      rn = min(RT, row_hi - r0);
    }
    if (rn <= 0) break;  // uniform: only the last round can run short
    const T* xb = x + (size_t)r0 * D;
    float pa[QT * KC / NT], pb[RT * KC / NT];
    // global -> registers: consecutive lanes read consecutive dims of a row
    auto load = [&](int k0) {
#pragma unroll
      for (int e = 0; e < QT * KC / NT; ++e) {
        const int idx = t + e * NT, r = idx / KC, d = idx % KC;
        const float v =
            (r < qn && k0 + d < D) ? qb[(size_t)r * D + k0 + d] : 0.f;
        pa[e] = ROUND_Q ? round_bf16(v) : v;
      }
#pragma unroll
      for (int e = 0; e < RT * KC / NT; ++e) {
        const int idx = t + e * NT, r = idx / KC, d = idx % KC;
        pb[e] = (r < rn && k0 + d < D) ? as_f32(xb[(size_t)r * D + k0 + d])
                                       : 0.f;
      }
    };
    auto store = [&](Stage& st) {  // registers -> shared, transposed
#pragma unroll
      for (int e = 0; e < QT * KC / NT; ++e) {
        const int idx = t + e * NT;
        st.a[idx % KC][idx / KC] = pa[e];
      }
#pragma unroll
      for (int e = 0; e < RT * KC / NT; ++e) {
        const int idx = t + e * NT;
        st.b[idx % KC][idx / KC] = pb[e];
      }
    };
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    __syncthreads();  // the previous tile's selection is done with s.dist
    load(0);
    store(s.st[0]);
    __syncthreads();
    const int chunks = (D + KC - 1) / KC;
    for (int c = 0; c < chunks; ++c) {
      if (c + 1 < chunks) load((c + 1) * KC);  // in flight during the FMAs
      const Stage& st = s.st[c & 1];
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&st.a[kk][qg * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&st.b[kk][rbase]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&st.b[kk][rbase + 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      if (c + 1 < chunks) store(s.st[(c + 1) & 1]);
      __syncthreads();
    }

    // distances to shared memory; +inf marks what may not enter a list
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ql = qg * 4 + i;
      const bool q_ok = ql < qn;
      const uint8_t* m =
          mask ? mask + (q_ok ? (long long)(q0 + ql) * mask_stride : 0)
               : nullptr;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int row = r0 + rbase + j;
        float dist = INFINITY;
        if (q_ok && rbase + j < rn && (!m || m[row])) {
          if constexpr (METRIC == EUCLID)
            dist = fmaxf(q_sq[ql] - 2.f * acc[i][j] + x_sq[row], 0.f);
          else
            dist = metric_dist<METRIC>(q_sq[ql], acc[i][j], x_sq[row]);
        }
        s.dist[ql][rbase + j] = dist;
      }
    }
    __syncthreads();
    if constexpr (MODE == SEL_DUMP) {  // coalesced: consecutive rows
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ql = w * 4 + i;
        if (ql >= qn) continue;
        float* o = dump + (size_t)(q0 + ql) * N + r0;
        for (int j = 0; j < RT / 32; ++j) {
          const int rl = lane + 32 * j;
          if (rl < rn) o[rl] = s.dist[ql][rl];
        }
      }
    } else if constexpr (MODE == SEL_BINS) {  // thread t: bin j0 + t
      if (t < rn) {
        const unsigned row = (unsigned)(r0 + t);
        for (int ql = 0; ql < qn; ++ql) {
          const float dist = s.dist[ql][t];
          if (!isfinite(dist)) continue;
          const unsigned long long key =
              ((unsigned long long)dist_key(dist) << 32) | row;
          if (key < bmin[ql * RT + t]) bmin[ql * RT + t] = key;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ql = w * 4 + i;
        if (ql >= qn) continue;  // uniform across the warp
        WarpList list{list_d + ql * k, list_r + ql * k, fill[i], k};
        for (int j = 0; j < RT / 32; ++j) {
          const int rl = lane + 32 * j;
          const float dist = s.dist[ql][rl];
          list.offer(isfinite(dist), dist, r0 + rl);
        }
        fill[i] = list.n;
      }
    }
  }
  if constexpr (MODE == SEL_BINS) {
    if (t < bw) {
      for (int ql = 0; ql < qn; ++ql) {
        const unsigned long long key = bmin[ql * RT + t];
        if (key != ~0ull)
          atomicMin(bin_keys + (size_t)(q0 + ql) * bins + j0 + t, key);
      }
    }
  } else if constexpr (MODE == SEL_LISTS) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ql = w * 4 + i;
      if (ql < qn) {
        const size_t off = ((size_t)blockIdx.y * B + q0 + ql) * k;
        WarpList{list_d + ql * k, list_r + ql * k, fill[i], k}.store(
            part_d + off, part_r + off);
      }
    }
  }
}

// One block per query: each warp folds every 8th of the S partial lists
// into its own list, then warp 0 folds the other 7 into its own and writes
// it out with row_base added to every row.
__global__ void __launch_bounds__(NT) l2_topk_merge(
    const float* __restrict__ part_d, const int* __restrict__ part_r, int B,
    int k, int S, int row_base, float* __restrict__ out_d,
    int* __restrict__ out_r) {
  constexpr int W = NT / 32;
  extern __shared__ unsigned char dyn[];
  __shared__ int fill[W];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qi = blockIdx.x;
  float* ld = reinterpret_cast<float*>(dyn);
  int* lr = reinterpret_cast<int*>(dyn + sizeof(float) * W * k);
  WarpList list{ld + w * k, lr + w * k, 0, k};
  for (int sp = w; sp < S; sp += W) {
    const size_t base = ((size_t)sp * B + qi) * k;
    list.absorb(part_d + base, part_r + base, k);
  }
  if (lane == 0) fill[w] = list.n;
  __syncthreads();
  if (w != 0) return;
  for (int o = 1; o < W; ++o) list.absorb(ld + o * k, lr + o * k, fill[o]);
  float* od = out_d + (size_t)qi * k;
  int* orow = out_r + (size_t)qi * k;
  for (int j = lane; j < k; j += 32) {
    od[j] = j < list.n ? list.d[j] : INFINITY;
    orow[j] = j < list.n ? list.r[j] + row_base : -1;
  }
}

// Squared norms of f32 or bf16 rows in f32, one warp a row.
template <typename T>
__global__ void __launch_bounds__(NT) row_sq_kernel(const T* __restrict__ x,
                                                    int n, int D,
                                                    float* __restrict__ out) {
  const int r = blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
  if (r >= n) return;
  const T* row = x + (size_t)r * D;
  float s = 0.f;
  for (int d = threadIdx.x & 31; d < D; d += 32) {
    const float v = as_f32(row[d]);
    s = fmaf(v, v, s);
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
  if ((threadIdx.x & 31) == 0) out[r] = s;
}

// x_sq when given; else the rows' norms, written to scratch [N] first.
template <typename T>
cudaError_t norms_or_given(const T* x, int N, int D, const float*& x_sq,
                           float* scratch, cudaStream_t stream) {
  if (x_sq != nullptr) return cudaSuccess;
  if (scratch == nullptr || N < 1) return cudaErrorInvalidValue;
  const int per = NT / 32;
  row_sq_kernel<T><<<(N + per - 1) / per, NT, 0, stream>>>(x, N, D, scratch);
  x_sq = scratch;
  return cudaGetLastError();
}

// Both passes at k <= 256: part_* [S, B, k] scratch, out_* [B, k].
template <typename T, bool ROUND_Q, int METRIC = EUCLID>
cudaError_t launch_l2_topk(const T* x, const float* x_sq,
                           const uint8_t* mask, long long mask_stride,
                           const float* q, int B, int N, int D, int k, int S,
                           int row_base, float* part_d, int* part_r,
                           float* out_d, int* out_r, cudaStream_t stream) {
  if (k < 1 || k > 256 || B < 1 || N < 1 || D < 1 || S < 1)
    return cudaErrorInvalidValue;
  const int smem1 = QT * k * 8;
  static int cap1[64];
  cudaError_t e = raise_smem_cap(
      reinterpret_cast<const void*>(
          l2_topk_partial<T, ROUND_Q, SEL_LISTS, METRIC>),
      smem1, cap1);
  if (e != cudaSuccess) return e;
  dim3 grid1((B + QT - 1) / QT, S);
  l2_topk_partial<T, ROUND_Q, SEL_LISTS, METRIC><<<grid1, NT, smem1,
                                                   stream>>>(
      x, x_sq, mask, mask_stride, q, B, N, D, k, slice_rows(N, S), part_d,
      part_r, nullptr, 0, nullptr);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int smem2 = (NT / 32) * k * 8;  // <= 16 KB: under the default cap
  l2_topk_merge<<<B, NT, smem2, stream>>>(part_d, part_r, B, k, S, row_base,
                                           out_d, out_r);
  return cudaGetLastError();
}

// Pass 1 in DUMP mode: the masked distances of B queries to dump [B, N].
template <typename T, bool ROUND_Q, int METRIC = EUCLID>
cudaError_t launch_l2_dump(const T* x, const float* x_sq,
                           const uint8_t* mask, long long mask_stride,
                           const float* q, int B, int N, int D, int S,
                           float* dump, cudaStream_t stream) {
  if (B < 1 || N < 1 || D < 1 || S < 1) return cudaErrorInvalidValue;
  dim3 grid1((B + QT - 1) / QT, S);
  l2_topk_partial<T, ROUND_Q, SEL_DUMP, METRIC><<<grid1, NT, 0, stream>>>(
      x, x_sq, mask, mask_stride, q, B, N, D, 0, slice_rows(N, S), nullptr,
      nullptr, dump, 0, nullptr);
  return cudaGetLastError();
}

}  // namespace fvdb
