// K1: fused masked squared L2 + exact top-k.
//
// Replaces the JAX package's flat_search_kernel (index/fused.py:51 and
// index/flat.py:30: pairwise_distance + ops/topk.py masked_topk) and the
// HNSW link-candidate scans _flat_candidates_kernel / _flat_candidates_chunked
// (index/hnsw.py:81,108). Those materialise the [B, N] distance matrix and
// select from it; this kernel never writes [B, N].
//
// d(q, x) = max(|q|^2 - 2 q.x + |x|^2, 0) in f32 with FMA (no TF32); rows
// where the mask is False never enter the result; result rows are sorted by
// (distance, row), padded with (+inf, -1).
//
// What bounds it on the H100: at the search shapes (B = 1..128, N = 131,072,
// D = 384) the corpus read is 201 MB, 60 us at 3.35 TB/s, while the products
// are 2*B*N*D = 12.9 GFLOP at B = 128, 0.19 ms at the 67 TFLOP/s f32 rate: f32
// arithmetic bounds it from B of about 40 up. At the link-candidate shape
// (B = 1,024, k = 200) the products dominate outright, and the other risk is
// the 200-deep list each query has to keep.
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

__global__ void __launch_bounds__(NT, 2) l2_topk_partial(
    const float* __restrict__ x, const float* __restrict__ x_sq,
    const uint8_t* __restrict__ mask, long long mask_stride,
    const float* __restrict__ q, int B, int N, int D, int k, int split_rows,
    float* __restrict__ part_d, int* __restrict__ part_r) {
  __shared__ __align__(16) PassSmem s;
  __shared__ float q_sq[QT];
  extern __shared__ unsigned char dyn[];
  float* list_d = reinterpret_cast<float*>(dyn);
  int* list_r = reinterpret_cast<int*>(dyn + sizeof(float) * QT * k);

  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const int qg = lane >> 2, rg = lane & 3;  // product: queries qg*4+i,
  const int rbase = w * 32 + rg * 8;        // rows rbase + j
  const int q0 = blockIdx.x * QT;
  const int row_lo = blockIdx.y * split_rows;
  const int row_hi = min(N, row_lo + split_rows);
  const int qn = min(QT, B - q0);
  const float* qb = q + (size_t)q0 * D;

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ql = w * 4 + i;
    const float v = ql < qn ? warp_row_sq(qb + (size_t)ql * D, D) : 0.f;
    if (lane == 0) q_sq[ql] = v;
  }
  int fill[4] = {0, 0, 0, 0};  // list fill of the warp's 4 queries

  for (int r0 = row_lo; r0 < row_hi; r0 += RT) {
    const int rn = min(RT, row_hi - r0);
    const float* xb = x + (size_t)r0 * D;
    float pa[QT * KC / NT], pb[RT * KC / NT];
    // global -> registers: consecutive lanes read consecutive dims of a row
    auto load = [&](int k0) {
#pragma unroll
      for (int e = 0; e < QT * KC / NT; ++e) {
        const int idx = t + e * NT, r = idx / KC, d = idx % KC;
        pa[e] = (r < qn && k0 + d < D) ? qb[(size_t)r * D + k0 + d] : 0.f;
      }
#pragma unroll
      for (int e = 0; e < RT * KC / NT; ++e) {
        const int idx = t + e * NT, r = idx / KC, d = idx % KC;
        pb[e] = (r < rn && k0 + d < D) ? xb[(size_t)r * D + k0 + d] : 0.f;
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
      const uint8_t* m = mask + (q_ok ? (long long)(q0 + ql) * mask_stride : 0);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int row = r0 + rbase + j;
        float dist = INFINITY;
        if (q_ok && row < row_hi && m[row])
          dist = fmaxf(q_sq[ql] - 2.f * acc[i][j] + x_sq[row], 0.f);
        s.dist[ql][rbase + j] = dist;
      }
    }
    __syncthreads();
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

// One block per query: each warp folds every 8th of the S partial lists
// into its own list, then warp 0 folds the other 7 into its own.
__global__ void __launch_bounds__(NT) l2_topk_merge(
    const float* __restrict__ part_d, const int* __restrict__ part_r, int B,
    int k, int S, float* __restrict__ out_d, int* __restrict__ out_r) {
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
  list.store(out_d + (size_t)qi * k, out_r + (size_t)qi * k);
}

}  // namespace fvdb

// x [N, D], x_sq [N], mask [B or 1, N] (mask_stride N or 0), q [B, D];
// part_* [S, B, k] scratch; out_* [B, k].
FVDB_EXPORT int fvdb_l2_topk(const float* x, const float* x_sq,
                             const uint8_t* mask, long long mask_stride,
                             const float* q, int B, int N, int D, int k,
                             int S, float* part_d, int* part_r, float* out_d,
                             int* out_r, cudaStream_t stream) {
  using namespace fvdb;
  if (k < 1 || k > 256 || B < 1 || N < 1 || D < 1 || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int split_rows = (N + S - 1) / S;
  split_rows = (split_rows + RT - 1) / RT * RT;
  const int smem1 = QT * k * 8;
  static int cap1[64];
  cudaError_t e = raise_smem_cap(reinterpret_cast<const void*>(l2_topk_partial),
                                 smem1, cap1);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid1((B + QT - 1) / QT, S);
  l2_topk_partial<<<grid1, NT, smem1, stream>>>(
      x, x_sq, mask, mask_stride, q, B, N, D, k, split_rows, part_d, part_r);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int smem2 = (NT / 32) * k * 8;  // <= 16 KB: under the default cap
  l2_topk_merge<<<B, NT, smem2, stream>>>(part_d, part_r, B, k, S, out_d,
                                           out_r);
  return static_cast<int>(cudaGetLastError());
}
