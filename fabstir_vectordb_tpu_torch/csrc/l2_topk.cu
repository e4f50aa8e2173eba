// K1: fused masked distance + exact top-k, by metric.
//
// Replaces the JAX package's flat_search_kernel (index/fused.py:51 and
// index/flat.py:29 flat_search_kernel(metric): pairwise_distance +
// ops/topk.py masked_topk) and the HNSW link-candidate scans
// _flat_candidates_kernel / _flat_candidates_chunked (index/hnsw.py:81,108).
// Those materialise the [B, N] distance matrix and select from it; this
// kernel never writes [B, N] (below k = 257).
//
// d(q, x) = max(|q|^2 - 2 q.x + |x|^2, 0) in f32 with FMA (no TF32), or by
// metric (ops/distance.py:72,87): cosine 1 - q.x / sqrt(max(|q|^2 |x|^2,
// 1e-30)), dot -q.x; rows where the mask is False never enter the result;
// result rows are sorted by (distance, row), padded with (+inf, -1). The
// passes themselves are in l2_tile.cuh. Cosine and dot distances can be
// negative: the k <= 256 lists compare floats, and the radix select orders
// common.cuh's signed keys. They run on f32 rows and on bf16 rows with the
// query rounded (the bf16 mirror's serving distance); bf16 rows with an
// f32 query take the euclidean metric only (the link candidates, the
// calibration oracle).
//
// bf16 rows (fvdb_l2_topk_bf16, fvdb_l2_topk_large_bf16) are upcast exactly.
// With round_q the query is rounded to bf16 for the product only (|q|^2
// from the f32 query, x_sq as given): the bf16 serving mirror's distance,
// the reference's compute_dtype=bfloat16 (ops/distance.py:30-69), with x_sq
// the f32 norms of the f32 host rows. Without it the query stays f32: the
// HNSW link candidates on a bf16 mirror (index/hnsw.py:81, default f32
// compute) and the reduced-rank calibration oracle (_oracle_step,
// index/fused.py:206, bf16 corpus blocks). The tiered exact search
// (_tile_step, index/tiered.py:31) streams f32 host tiles. The streamed
// blocks take the rows' norms in a first small kernel when none are given,
// and add the block's first row to every result row.
//
// What bounds it on the H100: at the search shapes (B = 1..128, N = 131,072,
// D = 384) the corpus read is 201 MB, 60 us at 3.35 TB/s, while the products
// are 2*B*N*D = 12.9 GFLOP at B = 128: 0.19 ms at the 67 TFLOP/s f32 FMA
// rate, 0.08 ms as three TF32 products at 495 TFLOP/s. At the
// link-candidate shape (B = 1,024, k = 200) the products dominate outright
// (0.62 ms as three TF32 products), and the other risk is the 200-deep
// list each query has to keep.
//
// Design: bf16_tile.cuh's tensor-core pass (fvdb_l2_topk_tc,
// fvdb_l2_topk_large_tc) where ops/topk.py tile_route says so: bf16 rows
// with the query rounded (a bf16 serving mirror, any metric), f32 rows by
// three TF32 products (any metric), bf16 rows with an f32 query split in
// three bf16 parts, at the D that TMA takes, with the same two selections.
// Other D (and rows TMA cannot read in place) take l2_tile.cuh's FMA pass
// (a tile product of 32 queries x 256 rows feeding per-query lists in
// shared memory, then a merge of the slices' lists), chosen by shape in
// ops/topk.py and counted apart.
//
// k > 256 (a filtered search asks for 3 k, and k reaches 16,384): the lists
// would not fit shared memory, so pass 1 runs the same tile product but
// writes each query's masked distances (+inf where the mask is False) to a
// [B, N] buffer instead of offering them to lists, and topk_select.cuh's
// radix select picks the k smallest (distance, row) of each buffer row. The
// buffer costs 4 N bytes written and ~4 passes of 4 N bytes read a query,
// against the 4 N D / 32 bytes a query of the product itself; the wrapper
// runs query chunks so it stays within 1 GiB. f32 rows by euclidean
// distance at k >= 128 take neither: the filter route of tile_filter.cuh (a
// bar from a sample of the rows' tiles, the survivors under it, their k
// smallest; fvdb_l2_topk_filter_tc) keeps the lists' merges and the buffer
// out of the pass. K14's stage 1 (index/fused.py) launches the same export
// on bf16 rows with the query rounded.
#include "bf16_tile.cuh"
#include "l2_tile.cuh"
#include "tile_filter.cuh"
#include "topk_select.cuh"

// x [N, D]; x_sq [N] or null (then the rows' norms are written to
// xsq_scratch [N] first); mask [B or 1, N] (mask_stride N or 0; null: every
// row), q [B, D]; metric 0 euclidean, 1 cosine, 2 dot; part_* [S, B, k]
// scratch; out_* [B, k], rows + row_base.
FVDB_EXPORT int fvdb_l2_topk(const float* x, const float* x_sq,
                             const uint8_t* mask, long long mask_stride,
                             const float* q, int B, int N, int D, int k,
                             int S, int row_base, int metric,
                             float* xsq_scratch, float* part_d, int* part_r,
                             float* out_d, int* out_r, cudaStream_t stream) {
  using namespace fvdb;
  cudaError_t e = norms_or_given(x, N, D, x_sq, xsq_scratch, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(with_metric(metric, [&](auto m) {
    return launch_l2_topk<float, false, decltype(m)::value>(
        x, x_sq, mask, mask_stride, q, B, N, D, k, S, row_base, part_d,
        part_r, out_d, out_r, stream);
  }));
}

// bf16 rows x [N, D]; x_sq and the rest as fvdb_l2_topk, k <= 256; round_q
// rounds the query to bf16 in the product; a metric other than euclidean
// takes round_q.
FVDB_EXPORT int fvdb_l2_topk_bf16(const __nv_bfloat16* x, const float* x_sq,
                                  const uint8_t* mask, long long mask_stride,
                                  const float* q, int B, int N, int D, int k,
                                  int S, int row_base, int round_q,
                                  int metric, float* xsq_scratch,
                                  float* part_d, int* part_r, float* out_d,
                                  int* out_r, cudaStream_t stream) {
  using namespace fvdb;
  if (!round_q && metric != EUCLID)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = norms_or_given(x, N, D, x_sq, xsq_scratch, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!round_q)
    return static_cast<int>(launch_l2_topk<__nv_bfloat16, false>(
        x, x_sq, mask, mask_stride, q, B, N, D, k, S, row_base, part_d,
        part_r, out_d, out_r, stream));
  return static_cast<int>(with_metric(metric, [&](auto m) {
    return launch_l2_topk<__nv_bfloat16, true, decltype(m)::value>(
        x, x_sq, mask, mask_stride, q, B, N, D, k, S, row_base, part_d,
        part_r, out_d, out_r, stream);
  }));
}

namespace fvdb {

// Any k: the masked distances to dump [B, N], then the radix select.
template <typename T, bool ROUND_Q, int METRIC>
cudaError_t l2_topk_large(const T* x, const float* x_sq, const uint8_t* mask,
                          long long mask_stride, const float* q, int B, int N,
                          int D, int k, int S, float* xsq_scratch,
                          float* dump, void* work, float* out_d, int* out_r,
                          cudaStream_t stream) {
  if (k < 1 || B < 1 || N < 1 || D < 1 || S < 1) return cudaErrorInvalidValue;
  cudaError_t e = norms_or_given(x, N, D, x_sq, xsq_scratch, stream);
  if (e != cudaSuccess) return e;
  e = launch_l2_dump<T, ROUND_Q, METRIC>(x, x_sq, mask, mask_stride, q, B, N,
                                         D, S, dump, stream);
  if (e != cudaSuccess) return e;
  return launch_select_topk(dump, nullptr, nullptr, N, B, k, work, out_d,
                            out_r, stream);
}

}  // namespace fvdb

// Any k >= 1: dump [B, N] distance scratch; work: fvdb_select_scratch_bytes
// (B, k) bytes of selection scratch; x_sq null and metric as in
// fvdb_l2_topk.
FVDB_EXPORT int fvdb_l2_topk_large(const float* x, const float* x_sq,
                                   const uint8_t* mask, long long mask_stride,
                                   const float* q, int B, int N, int D, int k,
                                   int S, int metric, float* xsq_scratch,
                                   float* dump, void* work, float* out_d,
                                   int* out_r, cudaStream_t stream) {
  using namespace fvdb;
  return static_cast<int>(with_metric(metric, [&](auto m) {
    return l2_topk_large<float, false, decltype(m)::value>(
        x, x_sq, mask, mask_stride, q, B, N, D, k, S, xsq_scratch, dump,
        work, out_d, out_r, stream);
  }));
}

// bf16 rows at any k; round_q and metric as in fvdb_l2_topk_bf16.
FVDB_EXPORT int fvdb_l2_topk_large_bf16(
    const __nv_bfloat16* x, const float* x_sq, const uint8_t* mask,
    long long mask_stride, const float* q, int B, int N, int D, int k, int S,
    int round_q, int metric, float* xsq_scratch, float* dump, void* work,
    float* out_d, int* out_r, cudaStream_t stream) {
  using namespace fvdb;
  if (!round_q && metric != EUCLID)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!round_q)
    return static_cast<int>(l2_topk_large<__nv_bfloat16, false, EUCLID>(
        x, x_sq, mask, mask_stride, q, B, N, D, k, S, xsq_scratch, dump,
        work, out_d, out_r, stream));
  return static_cast<int>(with_metric(metric, [&](auto m) {
    return l2_topk_large<__nv_bfloat16, true, decltype(m)::value>(
        x, x_sq, mask, mask_stride, q, B, N, D, k, S, xsq_scratch, dump,
        work, out_d, out_r, stream);
  }));
}

namespace fvdb {

// Rows of a slice of the tensor-core pass: a multiple of its tile.
inline int tc_slice_rows(int N, int S) {
  const int split = (N + S - 1) / S;
  return (split + TC_ROWS - 1) / TC_ROWS * TC_ROWS;
}

// The tensor-core pass in LISTS or DUMP mode by route (bf16_tile.cuh's
// TC_RQ, TC_TF32X3, TC_BF16X3): x_sq from the scratch when not given, the
// rows' tensor map.
inline cudaError_t tc_pass(int mode, int kind, const void* x,
                           const float*& x_sq, const uint8_t* mask,
                           long long mask_stride, const float* q, int B,
                           int N, int D, int k, int S, int metric, int width,
                           int stages, int smem, float* xsq_scratch,
                           unsigned long long* bars, float* part_d,
                           int* part_r, float* dump, cudaStream_t stream) {
  if (B < 1 || N < 1 || S < 1 || S > 65535 ||
      (mode == SEL_LISTS && (k < 1 || k > TC_MAX_K)) ||
      (kind == TC_BF16X3 && metric != EUCLID))
    return cudaErrorInvalidValue;
  cudaError_t e = tc_check(x, q, width, D, mode, k, stages, smem, kind);
  if (e != cudaSuccess) return e;
  e = kind == TC_TF32X3
          ? norms_or_given(static_cast<const float*>(x), N, D, x_sq,
                           xsq_scratch, stream)
          : norms_or_given(static_cast<const __nv_bfloat16*>(x), N, D, x_sq,
                           xsq_scratch, stream);
  if (e != cudaSuccess) return e;
  CUtensorMap map;
  if (!rows_map(x, N, D, &map, kind)) return cudaErrorInvalidValue;
  if (mode == SEL_LISTS) {
    e = cudaMemsetAsync(bars, 0xff, (size_t)B * (8 + 4 * S), stream);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((B + width - 1) / width, S);
  const int split = tc_slice_rows(N, S);
  return with_metric(metric, [&](auto m) {
    constexpr int MT = decltype(m)::value;
    return mode == SEL_LISTS
               ? launch_tc_kind<SEL_LISTS, MT>(
                     kind, width, map, x_sq, mask, mask_stride, q, B, N, D,
                     k, split, stages, smem, grid, bars, part_d, part_r,
                     (float*)nullptr, 0, (unsigned long long*)nullptr,
                     stream)
               : launch_tc_kind<SEL_DUMP, MT>(
                     kind, width, map, x_sq, mask, mask_stride, q, B, N, D,
                     0, split, stages, smem, grid,
                     (unsigned long long*)nullptr, (float*)nullptr,
                     (int*)nullptr, dump, 0, (unsigned long long*)nullptr,
                     stream);
  });
}

}  // namespace fvdb

// K1 on the tensor cores (bf16_tile.cuh), k <= 256, by route (kind): 0
// bf16 rows with the query rounded (any metric), 1 f32 rows (3xTF32, any
// metric), 2 bf16 rows with an f32 query (euclidean); x [N, D] of that row
// type, D % 8 == 0 (f32 rows: D % 4), x and q 16-byte aligned; width,
// stages and smem from ops/topk.py tile_plan(B, k, D, "lists", route);
// bars: B (8 + 4 S) bytes of scratch; the rest as fvdb_l2_topk.
FVDB_EXPORT int fvdb_l2_topk_tc(
    const void* x, int kind, const float* x_sq, const uint8_t* mask,
    long long mask_stride, const float* q, int B, int N, int D, int k, int S,
    int row_base, int metric, int width, int stages, int smem,
    float* xsq_scratch, unsigned long long* bars, float* part_d, int* part_r,
    float* out_d, int* out_r, cudaStream_t stream) {
  using namespace fvdb;
  cudaError_t e = tc_pass(SEL_LISTS, kind, x, x_sq, mask, mask_stride, q, B,
                          N, D, k, S, metric, width, stages, smem,
                          xsq_scratch, bars, part_d, part_r, nullptr, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int smem2 = (NT / 32) * k * 8;  // <= 16 KB: under the default cap
  l2_topk_merge<<<B, NT, smem2, stream>>>(part_d, part_r, B, k, S, row_base,
                                           out_d, out_r);
  return static_cast<int>(cudaGetLastError());
}

// The same at any k: the masked distances to dump [B, N] on the tensor
// cores (width, stages and smem from tile_plan(B, k, D, "dump", route)),
// then the radix select; work: fvdb_select_scratch_bytes(B, k) bytes.
FVDB_EXPORT int fvdb_l2_topk_large_tc(
    const void* x, int kind, const float* x_sq, const uint8_t* mask,
    long long mask_stride, const float* q, int B, int N, int D, int k, int S,
    int metric, int width, int stages, int smem, float* xsq_scratch,
    float* dump, void* work, float* out_d, int* out_r, cudaStream_t stream) {
  using namespace fvdb;
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = tc_pass(SEL_DUMP, kind, x, x_sq, mask, mask_stride, q, B,
                          N, D, k, S, metric, width, stages, smem,
                          xsq_scratch, nullptr, nullptr, nullptr, dump,
                          stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_select_topk(dump, nullptr, nullptr, N, B, k,
                                             work, out_d, out_r, stream));
}

// Bytes of the filter route's scratch (tile_filter.cuh) for B queries at k
// with the plan's sample and survivor capacities (ops/topk.py
// filter_plan).
FVDB_EXPORT long long fvdb_l2_topk_filter_bytes(int B, int k, int cap_s,
                                                int cap) {
  return fvdb::tile_filter_bytes(B, k, cap_s, cap);
}

// The tensor cores' filter route by euclidean distance at any k (a bar
// from a sample of the rows' tiles, the survivors under it, their k
// smallest), by route (kind): 0 bf16 rows with the query rounded (K14's
// stage 1 over its projected mirror), 1 f32 rows by three TF32 products
// (K3, K1 at k >= 128). x [N, D] of that row type (D % 8 == 0; f32 rows
// D % 4), x and q [B, D] f32 16-byte aligned; x_sq [N] or null (then the
// rows' norms go to xsq_scratch [N] first), mask [B or 1, N] (mask_stride
// N or 0; null: every row); the plan's arguments as launch_tile_filter
// takes them (tile_plan(B, 0, D, "filter", route), filter_plan); out_*
// [B, k] (rows without a base); *overflow: the queries whose survivors
// passed cap.
FVDB_EXPORT int fvdb_l2_topk_filter_tc(
    const void* x, int kind, const float* x_sq, const uint8_t* mask,
    long long mask_stride, const float* q, int B, int N, int D, int k,
    int width, int stages, int smem, int S_s, int S, int tstride, int cap_s,
    int cap, int chunk, float* xsq_scratch, void* work, float* out_d,
    int* out_r, int* overflow, cudaStream_t stream) {
  using namespace fvdb;
  if (kind != TC_RQ && kind != TC_TF32X3)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = kind == TC_TF32X3
                      ? norms_or_given(static_cast<const float*>(x), N, D,
                                       x_sq, xsq_scratch, stream)
                      : norms_or_given(static_cast<const __nv_bfloat16*>(x),
                                       N, D, x_sq, xsq_scratch, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto launch = [&](auto kc) {
    return launch_tile_filter<decltype(kc)::value>(
        x, x_sq, mask, mask_stride, q, B, N, D, k, width, stages, smem, S_s,
        S, tstride, cap_s, cap, chunk, work, out_d, out_r, overflow, stream);
  };
  return static_cast<int>(
      kind == TC_RQ ? launch(std::integral_constant<int, TC_RQ>())
                    : launch(std::integral_constant<int, TC_TF32X3>()));
}
