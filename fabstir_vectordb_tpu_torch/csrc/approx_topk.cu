// K9: the approximate flat pool ("turbo" flat selection).
//
// Replaces the JAX package's masked_approx_topk (ops/topk.py:44) as
// flat_search_approx_kernel (index/fused.py:114) runs it: the masked squared
// L2 distances of each query, then lax.approx_min_k(recall_target=0.95) for
// a pool of ov_k rows, which K2 (csrc/rerank_f32.cu) re-scores to k. On the
// TPU, approx_min_k splits each distance row into M bins, keeps every bin's
// minimum and takes the ov_k smallest of those minima. A true top-ov_k row is
// lost only when it shares its bin with a better row, so the expected recall
// is ((M - 1) / M)^(ov_k - 1) and M = ceil(1 / (1 - r^(1 / (ov_k - 1))))
// for r = 0.95, clamped to N (M = N is the exact pool). The wrapper computes
// M; this kernel takes it.
//
// d(q, x) = max(|q|^2 - 2 q'.x + |x|^2, 0) in f32 with FMA, x f32 or bf16
// rows upcast exactly, q' the query or (round_q) the query rounded to bf16
// for the product, |q|^2 from the f32 query, x_sq as given; rows where the
// mask is False never enter. Row r falls in bin r mod M, so a tile of
// consecutive rows touches distinct bins. A bin's minimum is its smallest
// (distance, row); a bin whose rows are all masked is (+inf, -1), and the
// pool pads with (+inf, -1) when fewer than ov_k bins hold a row.
//
// What bounds it on the H100: at the turbo shape (B = 128, N = 1,048,576,
// D = 384, f32 rows) the rows are 1.61 GB, 0.48 ms at 3.35 TB/s, and the
// products 2 B N D = 103 GFLOP, 1.54 ms at the 67 TFLOP/s f32 rate: the
// arithmetic. The pool is [B, M] keys, 2.5 MB at M = 2,477: it stays in L2.
//
// bf16 rows with the query rounded at D % 8 == 0 (and D <= 8,192), and f32
// rows at D % 4 == 0 (and D <= 2,048; three TF32 products, f32 accuracy),
// take bf16_tile.cuh's tensor-core pass in its BINS mode
// (fvdb_approx_pool_tc): a block owns 128 bins and a range of rounds, the
// running minima of its threads' bins stay in registers, and the same
// atomicMin folds them into the [B, M] keys; the unpacking and the radix
// select are as below. f32 rows at B = 128 over 1,048,576 x 384 are then
// 3 x 103 GFLOP of TF32 products, 0.62 ms at 495 TFLOP/s, against the
// rows' 0.48 ms. The other rows (bf16 with an f32 query, other D) take the
// FMA pass:
//
// Design: pass 1 is K1's tile product (l2_tile.cuh) in its BINS mode. A
// block takes 32 queries, 256 consecutive bins and a range of rounds (rows
// i M + j0 .. i M + j0 + 255 for the rounds i it owns, each a contiguous
// tile), keeps the 32 x 256 running minima as packed (distance key << 32 |
// row) keys (common.cuh's dist_key) in shared memory, and folds them into a [B, M] table with one
// atomicMin a (query, bin) at the end. A second kernel unpacks the table into
// distances and rows, and topk_select.cuh's radix select takes the ov_k
// smallest (distance, row) of each query's M minima.
//
// masked_approx_topk over a given [B, N] distance matrix (ops/topk.py:44 as
// an ops entry point) bins the same way without the tile pass: one thread a
// (query, bin) walks rows j, j + M, ... (consecutive threads read
// consecutive rows) and keeps the smallest (distance key << 32 | row),
// skipping masked and non-finite entries; the radix select then takes the
// ov_k smallest minima. It reads the matrix once: B N 4 bytes.
#include <type_traits>

#include "bf16_tile.cuh"
#include "l2_tile.cuh"
#include "topk_select.cuh"

namespace fvdb {

// keys [B, M] -> (distance, row), an empty bin as (+inf, -1).
__global__ void __launch_bounds__(NT) unpack_bins_kernel(
    const unsigned long long* __restrict__ keys, long long n,
    float* __restrict__ cand_d, int* __restrict__ cand_r) {
  const long long i = (long long)blockIdx.x * NT + threadIdx.x;
  if (i >= n) return;
  const unsigned long long key = keys[i];
  const bool empty = key == ~0ull;
  cand_d[i] = empty ? INFINITY : key_dist((unsigned)(key >> 32));
  cand_r[i] = empty ? -1 : (int)(unsigned)(key & 0xffffffffull);
}

// d [B, N] -> each (query, bin)'s minimum as (distance, row), an empty bin
// as (+inf, -1).
__global__ void __launch_bounds__(NT) bin_min_kernel(
    const float* __restrict__ d, const uint8_t* __restrict__ mask,
    long long mask_stride, int B, int N, int M, float* __restrict__ cand_d,
    int* __restrict__ cand_r) {
  const long long cell = (long long)blockIdx.x * NT + threadIdx.x;
  if (cell >= (long long)B * M) return;
  const int b = (int)(cell / M), j = (int)(cell % M);
  const float* db = d + (size_t)b * N;
  const uint8_t* mb = mask ? mask + b * mask_stride : nullptr;
  unsigned long long best = ~0ull;
  for (int r = j; r < N; r += M) {
    if (mb != nullptr && !mb[r]) continue;
    const unsigned key = dist_key(db[r]);
    if (!finite_key(key)) continue;
    const unsigned long long c = ((unsigned long long)key << 32) | (unsigned)r;
    if (c < best) best = c;
  }
  const bool empty = best == ~0ull;
  cand_d[cell] = empty ? INFINITY : key_dist((unsigned)(best >> 32));
  cand_r[cell] = empty ? -1 : (int)(unsigned)(best & 0xffffffffull);
}

template <typename T, bool ROUND_Q>
cudaError_t approx_pool(const T* x, const float* x_sq, const uint8_t* mask,
                        long long mask_stride, const float* q, int B, int N,
                        int D, int M, int ov_k, int Z, int i_per,
                        unsigned long long* keys, float* cand_d, int* cand_r,
                        void* work, float* out_d, int* out_r,
                        cudaStream_t stream) {
  if (B < 1 || N < 1 || D < 1 || M < 1 || M > N || ov_k < 1 || Z < 1 ||
      i_per < 1 || x_sq == nullptr)
    return cudaErrorInvalidValue;
  const int smem = QT * RT * (int)sizeof(unsigned long long);
  static int cap[64];
  cudaError_t e = raise_smem_cap(
      reinterpret_cast<const void*>(l2_topk_partial<T, ROUND_Q, SEL_BINS>),
      smem, cap);
  if (e != cudaSuccess) return e;
  const long long cells = (long long)B * M;
  e = cudaMemsetAsync(keys, 0xff, cells * sizeof(unsigned long long), stream);
  if (e != cudaSuccess) return e;
  const dim3 grid((B + QT - 1) / QT, (M + RT - 1) / RT, Z);
  l2_topk_partial<T, ROUND_Q, SEL_BINS><<<grid, NT, smem, stream>>>(
      x, x_sq, mask, mask_stride, q, B, N, D, 0, i_per, nullptr, nullptr,
      nullptr, M, keys);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  unpack_bins_kernel<<<(unsigned)((cells + NT - 1) / NT), NT, 0, stream>>>(
      keys, cells, cand_d, cand_r);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_select_topk(cand_d, cand_r, nullptr, M, B, ov_k, work, out_d,
                            out_r, stream);
}

}  // namespace fvdb

// x [N, D] (x_bf16: bf16, else f32), x_sq [N], mask [B or 1, N] (mask_stride
// N or 0; null: every row), q [B, D] f32; M bins (<= N), the pool ov_k; a
// grid of Z round ranges of i_per rounds each; keys [B, M], cand_d / cand_r
// [B, M] scratch; work: fvdb_select_scratch_bytes(B, ov_k) bytes; out_*
// [B, ov_k]. round_q takes bf16 rows.
FVDB_EXPORT int fvdb_approx_pool(const void* x, int x_bf16, int round_q,
                                 const float* x_sq, const uint8_t* mask,
                                 long long mask_stride, const float* q, int B,
                                 int N, int D, int M, int ov_k, int Z,
                                 int i_per, unsigned long long* keys,
                                 float* cand_d, int* cand_r, void* work,
                                 float* out_d, int* out_r,
                                 cudaStream_t stream) {
  using namespace fvdb;
  cudaError_t e;
  if (!x_bf16) {
    if (round_q) return static_cast<int>(cudaErrorInvalidValue);
    e = approx_pool<float, false>(static_cast<const float*>(x), x_sq, mask,
                                  mask_stride, q, B, N, D, M, ov_k, Z, i_per,
                                  keys, cand_d, cand_r, work, out_d, out_r,
                                  stream);
  } else {
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    e = round_q ? approx_pool<__nv_bfloat16, true>(
                      xb, x_sq, mask, mask_stride, q, B, N, D, M, ov_k, Z,
                      i_per, keys, cand_d, cand_r, work, out_d, out_r, stream)
                : approx_pool<__nv_bfloat16, false>(
                      xb, x_sq, mask, mask_stride, q, B, N, D, M, ov_k, Z,
                      i_per, keys, cand_d, cand_r, work, out_d, out_r,
                      stream);
  }
  return static_cast<int>(e);
}

// On the tensor cores, by route kind (bf16_tile.cuh): TC_RQ, bf16 rows x
// [N, D] with the query rounded, D % 8 == 0; TC_TF32X3, f32 rows by three
// TF32 products, D % 4 == 0; x and q 16-byte aligned; width, stages and
// smem from ops/topk.py tile_plan(B, ov_k, D, "bins", route); a grid of Z
// round ranges of i_per rounds each; the rest as fvdb_approx_pool.
FVDB_EXPORT int fvdb_approx_pool_tc(
    const void* x, int kind, const float* x_sq, const uint8_t* mask,
    long long mask_stride, const float* q, int B, int N, int D, int M,
    int ov_k, int Z, int i_per, int width, int stages, int smem,
    unsigned long long* keys, float* cand_d, int* cand_r, void* work,
    float* out_d, int* out_r, cudaStream_t stream) {
  using namespace fvdb;
  if (B < 1 || N < 1 || M < 1 || M > N || ov_k < 1 || Z < 1 || Z > 65535 ||
      i_per < 1 || x_sq == nullptr || (M + TC_ROWS - 1) / TC_ROWS > 65535 ||
      (kind != TC_RQ && kind != TC_TF32X3))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = tc_check(x, q, width, D, SEL_BINS, 0, stages, smem, kind);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap map;
  if (!rows_map(x, N, D, &map, kind))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long cells = (long long)B * M;
  e = cudaMemsetAsync(keys, 0xff, cells * sizeof(unsigned long long), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((B + width - 1) / width, (M + TC_ROWS - 1) / TC_ROWS, Z);
  const auto launch = [&](auto route) {
    return launch_tc_width<SEL_BINS, EUCLID, decltype(route)::value>(
        width, map, x_sq, mask, mask_stride, q, B, N, D, 0, i_per, stages,
        smem, grid, (unsigned long long*)nullptr, (float*)nullptr,
        (int*)nullptr, (float*)nullptr, M, keys, stream);
  };
  e = kind == TC_RQ ? launch(std::integral_constant<int, TC_RQ>())
                    : launch(std::integral_constant<int, TC_TF32X3>());
  if (e != cudaSuccess) return static_cast<int>(e);
  unpack_bins_kernel<<<(unsigned)((cells + NT - 1) / NT), NT, 0, stream>>>(
      keys, cells, cand_d, cand_r);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_select_topk(cand_d, cand_r, nullptr, M, B,
                                             ov_k, work, out_d, out_r,
                                             stream));
}

// masked_approx_topk over a given matrix: d [B, N] f32, mask [B or 1, N]
// (mask_stride N or 0; null: every entry), M bins (< N); cand_d / cand_r
// [B, M] scratch; work: fvdb_select_scratch_bytes(B, k) bytes; out_*
// [B, k].
FVDB_EXPORT int fvdb_approx_select(const float* d, const uint8_t* mask,
                                   long long mask_stride, int B, int N, int M,
                                   int k, float* cand_d, int* cand_r,
                                   void* work, float* out_d, int* out_r,
                                   cudaStream_t stream) {
  using namespace fvdb;
  if (B < 1 || N < 1 || M < 1 || M > N || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long cells = (long long)B * M;
  bin_min_kernel<<<(unsigned)((cells + NT - 1) / NT), NT, 0, stream>>>(
      d, mask, mask_stride, B, N, M, cand_d, cand_r);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_select_topk(cand_d, cand_r, nullptr, M, B, k,
                                             work, out_d, out_r, stream));
}
