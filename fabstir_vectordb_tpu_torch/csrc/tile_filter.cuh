// The filter route of bf16_tile.cuh's pass (K14's stage 1 and K1 on f32
// rows by euclidean distance, both launched by csrc/l2_topk.cu's
// fvdb_l2_topk_filter_tc): the exact top-k of each query with no [B, N]
// buffer.
//  1. A bar a query that is exact by construction: the pass in FILTER mode
//     over every tstride-th tile of 128 rows with no bar writes each
//     query's masked distances there as keys, a slot a row (the sample),
//     and filtered_select.cuh's finishing kernel takes their k smallest.
//     The sample's k-th distance is an upper bound on the whole k-th (the
//     sample's k rows are rows of x), and the sample's distances are the
//     whole pass's bit for bit (the same kernel, the same place in the
//     tile, the same query column). A query with fewer than k rows in the
//     sample has no bar (+inf).
//  2. The pass in FILTER mode over every tile: each distance at or below
//     its query's bar, ties included, goes to the query's survivor buffer
//     [B, cap] (staged in shared memory, reserved chunk slots at a time);
//     about tstride * k a query where rows and mask do not follow the tile
//     order. Without a sample (small N / k) there is no bar and every row
//     is a slot.
//  3. The finishing kernel: the survivors sorted whole (at most
//     SORT_SMEM), or their k smallest by the block's radix select and then
//     sorted.
// ops/topk.py filter_plan picks tstride (about sqrt(N / k), so the sample
// and the survivors cost about the same), cap and chunk. A query whose
// survivors pass cap (a loose bar, many ties) is counted in *overflow; the
// wrapper then runs its launch again on another route, counted apart.
#pragma once

#include "bf16_tile.cuh"
#include "filtered_select.cuh"
#include "topk_select.cuh"

namespace fvdb {

// The route's scratch: survivor counts of the sample and of the whole
// pass [B] each | the sample's k smallest (distances, rows) [B, k] | the
// sample's keys [B, cap_s] | the survivors [B, cap] | past SORT_SMEM the
// finishing kernel's lists [B, pow2(k)].
struct TileFilterLayout {
  size_t cnt, s_d, s_r, surv_s, surv, lists, total;
};

inline TileFilterLayout tile_filter_layout(int B, int k, int cap_s,
                                           int cap) {
  TileFilterLayout l;
  l.cnt = round_up16((size_t)B * 4);
  l.s_d = 2 * l.cnt;
  l.s_r = l.s_d + round_up16((size_t)B * k * 4);
  l.surv_s = l.s_r + round_up16((size_t)B * k * 4);
  l.surv = l.surv_s + round_up16((size_t)B * cap_s * 8);
  l.lists = l.surv + round_up16((size_t)B * cap * 8);
  const int kc = k < cap ? k : cap;
  l.total = l.lists + (kc > SORT_SMEM ? (size_t)B * pow2_at_least(kc) * 8 : 0);
  return l;
}

// Bytes of the scratch (0 for arguments out of range).
inline long long tile_filter_bytes(int B, int k, int cap_s, int cap) {
  if (B < 1 || k < 1 || cap_s < 0 || cap < 1) return 0;
  return (long long)tile_filter_layout(B, k, cap_s, cap).total;
}

__global__ void fill_kernel(int* __restrict__ p, int n, int v) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) p[i] = v;
}

// The finishing kernel over survivors [B, cap] counted in cnt: the k
// smallest, sorted, padded with (+inf, -1).
inline cudaError_t tile_filter_finish(const unsigned long long* surv, int cap,
                                      int* cnt, int B, int k,
                                      unsigned long long* lists, float* out_d,
                                      int* out_r, cudaStream_t stream) {
  const int kc = k < cap ? k : cap;
  chunk_finish_kernel<<<B, FIN_NT, SORT_SMEM * 8, stream>>>(
      surv, cap, cnt, kc, lists, pow2_at_least(kc), nullptr, nullptr, k,
      out_d, out_r);
  return cudaGetLastError();
}

// The route over rows x [N, D] of route KIND (TC_RQ: bf16 rows, the query
// rounded; TC_TF32X3: f32 rows) by euclidean distance: x_sq [N], mask [B
// or 1, N] (mask_stride N or 0; null: every row), q [B, D] f32; width,
// stages and smem from ops/topk.py tile_plan(B, 0, D, "filter", route);
// S_s / S row slices of the sample pass and of the whole pass; every
// tstride-th tile in the sample (0: no sample, no bar) holding at most
// cap_s rows a query; cap survivors a query, reserved chunk at a time by a
// block (the plan's cap allows S unused reservations); work:
// tile_filter_bytes(B, k, cap_s, cap) bytes; out_* [B, k]; *overflow: the
// queries whose survivors passed cap (their rows in out_* are then not
// the answer).
template <int KIND>
cudaError_t launch_tile_filter(const void* x, const float* x_sq,
                               const uint8_t* mask, long long mask_stride,
                               const float* q, int B, int N, int D, int k,
                               int width, int stages, int smem, int S_s,
                               int S, int tstride, int cap_s, int cap,
                               int chunk, void* work, float* out_d,
                               int* out_r, int* overflow,
                               cudaStream_t stream) {
  const int tiles = (N + TC_ROWS - 1) / TC_ROWS;
  const long long rows_s =
      tstride > 0 ? (long long)(tiles + tstride - 1) / tstride * TC_ROWS : 0;
  if (k < 1 || B < 1 || N < 1 || S < 1 || S > 65535 || S_s < 0 ||
      S_s > 65535 || tstride < 0 || cap < 1 || chunk < 1 ||
      (tstride > 0 && S_s < 1) || x_sq == nullptr || cap_s < rows_s ||
      (tstride == 0 && cap < N) || work == nullptr || overflow == nullptr)
    return cudaErrorInvalidValue;
  cudaError_t e = tc_check(x, q, width, D, SEL_FILTER, 0, stages, smem, KIND);
  if (e != cudaSuccess) return e;
  CUtensorMap map;
  if (!rows_map(x, N, D, &map, KIND)) return cudaErrorInvalidValue;
  const TileFilterLayout l = tile_filter_layout(B, k, cap_s, cap);
  unsigned char* p = static_cast<unsigned char*>(work);
  int* cnt_s = reinterpret_cast<int*>(p);
  int* cnt = reinterpret_cast<int*>(p + l.cnt);
  float* s_d = reinterpret_cast<float*>(p + l.s_d);
  int* s_r = reinterpret_cast<int*>(p + l.s_r);
  auto* surv_s = reinterpret_cast<unsigned long long*>(p + l.surv_s);
  auto* surv = reinterpret_cast<unsigned long long*>(p + l.surv);
  auto* lists = reinterpret_cast<unsigned long long*>(p + l.lists);
  // the counts: the rows taken where there is no bar (every row a slot),
  // else zero
  const int nb = (B + NT - 1) / NT;
  if (tstride > 0) fill_kernel<<<nb, NT, 0, stream>>>(cnt_s, B, (int)rows_s);
  fill_kernel<<<nb, NT, 0, stream>>>(cnt, B, tstride > 0 ? 0 : N);
  e = cudaGetLastError();
  if (e == cudaSuccess) e = cudaMemsetAsync(overflow, 0, 4, stream);
  if (e != cudaSuccess) return e;
  const int tiles_q = (B + width - 1) / width;
  auto pass = [&](int slices, int rows, FilterArgs fa) {
    const int per = (rows + slices - 1) / slices;  // rows a slice, whole tiles
    return launch_tc_width<SEL_FILTER, EUCLID, KIND>(
        width, map, x_sq, mask, mask_stride, q, B, N, D, 0,
        (per + TC_ROWS - 1) / TC_ROWS * TC_ROWS, stages, smem,
        dim3(tiles_q, slices), (unsigned long long*)nullptr,
        (float*)nullptr, (int*)nullptr, (float*)nullptr, 0,
        (unsigned long long*)nullptr, stream, fa);
  };
  FilterArgs fa;
  fa.overflow = overflow;
  if (tstride > 0) {  // the sample: a slot a row it takes
    fa.surv = surv_s;
    fa.cnt = cnt_s;
    fa.cap = cap_s;
    fa.tstride = tstride;
    e = pass(S_s, (int)rows_s, fa);
    if (e == cudaSuccess)
      e = tile_filter_finish(surv_s, cap_s, cnt_s, B, k, lists, s_d, s_r,
                             stream);
    if (e != cudaSuccess) return e;
    fa.bar = s_d + (k - 1);  // the sample's k-th distance
    fa.bar_ld = k;
  }
  fa.surv = surv;
  fa.cnt = cnt;
  fa.cap = cap;
  fa.tstride = 1;
  fa.chunk = chunk;
  e = pass(S, N, fa);
  if (e != cudaSuccess) return e;
  return tile_filter_finish(surv, cap, cnt, B, k, lists, out_d, out_r,
                            stream);
}

}  // namespace fvdb
