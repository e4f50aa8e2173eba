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
// are 2*B*N*D = 12.9 GFLOP at B = 128, 0.19 ms at the 67 TFLOP/s f32 rate: f32
// arithmetic bounds it from B of about 40 up. At the link-candidate shape
// (B = 1,024, k = 200) the products dominate outright, and the other risk is
// the 200-deep list each query has to keep.
//
// Design: l2_tile.cuh (a tile product of 32 queries x 256 rows feeding
// per-query lists in shared memory, then a merge of the slices' lists).
// bf16 rows with the query rounded (a bf16 serving mirror) at D % 8 == 0
// (and D <= 8,192) take bf16_tile.cuh's tensor-core pass instead
// (fvdb_l2_topk_bf16_tc, fvdb_l2_topk_large_bf16_tc), with the same three
// metrics and the same two selections; other D stay on l2_tile.cuh's FMA
// pass, chosen by shape in ops/topk.py and counted apart.
//
// k > 256 (a filtered search asks for 3 k, and k reaches 16,384): the lists
// would not fit shared memory, so pass 1 runs the same tile product but
// writes each query's masked distances (+inf where the mask is False) to a
// [B, N] buffer instead of offering them to lists, and topk_select.cuh's
// radix select picks the k smallest (distance, row) of each buffer row. The
// buffer costs 4 N bytes written and ~4 passes of 4 N bytes read a query,
// against the 4 N D / 32 bytes a query of the product itself; the wrapper
// runs query chunks so it stays within 1 GiB.
#include "bf16_tile.cuh"
#include "l2_tile.cuh"
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

// The tensor-core pass in LISTS or DUMP mode over bf16 rows, the query
// rounded: x_sq from the scratch when not given, the rows' tensor map.
inline cudaError_t tc_pass(int mode, const __nv_bfloat16* x,
                           const float*& x_sq, const uint8_t* mask,
                           long long mask_stride, const float* q, int B,
                           int N, int D, int k, int S, int metric, int width,
                           int stages, int smem, float* xsq_scratch,
                           unsigned long long* bars, float* part_d,
                           int* part_r, float* dump, cudaStream_t stream) {
  if (B < 1 || N < 1 || S < 1 || S > 65535 ||
      (mode == SEL_LISTS && (k < 1 || k > TC_MAX_K)))
    return cudaErrorInvalidValue;
  cudaError_t e = tc_check(x, q, width, D, mode, k, stages, smem);
  if (e != cudaSuccess) return e;
  e = norms_or_given(x, N, D, x_sq, xsq_scratch, stream);
  if (e != cudaSuccess) return e;
  CUtensorMap map;
  if (!rows_map(x, N, D, &map)) return cudaErrorInvalidValue;
  if (mode == SEL_LISTS) {
    e = cudaMemsetAsync(bars, 0xff, (size_t)B * (8 + 4 * S), stream);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((B + width - 1) / width, S);
  const int split = tc_slice_rows(N, S);
  return with_metric(metric, [&](auto m) {
    constexpr int MT = decltype(m)::value;
    return mode == SEL_LISTS
               ? launch_tc_width<SEL_LISTS, MT>(
                     width, map, x_sq, mask, mask_stride, q, B, N, D, k,
                     split, stages, smem, grid, bars, part_d, part_r,
                     (float*)nullptr, 0, (unsigned long long*)nullptr,
                     stream)
               : launch_tc_width<SEL_DUMP, MT>(
                     width, map, x_sq, mask, mask_stride, q, B, N, D, 0,
                     split, stages, smem, grid,
                     (unsigned long long*)nullptr, (float*)nullptr,
                     (int*)nullptr, dump, 0, (unsigned long long*)nullptr,
                     stream);
  });
}

}  // namespace fvdb

// bf16 rows x [N, D] with the query rounded, on the tensor cores
// (bf16_tile.cuh), k <= 256: D % 8 == 0, x and q 16-byte aligned; width,
// stages and smem from ops/topk.py tile_plan(B, k, D, "lists"); bars: B (8
// + 4 S) bytes of scratch; the rest as fvdb_l2_topk_bf16.
FVDB_EXPORT int fvdb_l2_topk_bf16_tc(
    const __nv_bfloat16* x, const float* x_sq, const uint8_t* mask,
    long long mask_stride, const float* q, int B, int N, int D, int k, int S,
    int row_base, int metric, int width, int stages, int smem,
    float* xsq_scratch, unsigned long long* bars, float* part_d, int* part_r,
    float* out_d, int* out_r, cudaStream_t stream) {
  using namespace fvdb;
  cudaError_t e = tc_pass(SEL_LISTS, x, x_sq, mask, mask_stride, q, B, N, D,
                          k, S, metric, width, stages, smem, xsq_scratch,
                          bars, part_d, part_r, nullptr, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int smem2 = (NT / 32) * k * 8;  // <= 16 KB: under the default cap
  l2_topk_merge<<<B, NT, smem2, stream>>>(part_d, part_r, B, k, S, row_base,
                                           out_d, out_r);
  return static_cast<int>(cudaGetLastError());
}

// The same at any k: the masked distances to dump [B, N] on the tensor
// cores (width, stages and smem from tile_plan(B, k, D, "dump")), then the
// radix select; work: fvdb_select_scratch_bytes(B, k) bytes.
FVDB_EXPORT int fvdb_l2_topk_large_bf16_tc(
    const __nv_bfloat16* x, const float* x_sq, const uint8_t* mask,
    long long mask_stride, const float* q, int B, int N, int D, int k, int S,
    int metric, int width, int stages, int smem, float* xsq_scratch,
    float* dump, void* work, float* out_d, int* out_r, cudaStream_t stream) {
  using namespace fvdb;
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = tc_pass(SEL_DUMP, x, x_sq, mask, mask_stride, q, B, N, D,
                          k, S, metric, width, stages, smem, xsq_scratch,
                          nullptr, nullptr, nullptr, dump, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_select_topk(dump, nullptr, nullptr, N, B, k,
                                             work, out_d, out_r, stream));
}
