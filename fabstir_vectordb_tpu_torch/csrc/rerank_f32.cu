// K2: re-score candidate rows in f32 and keep the best m.
//
// Replaces the JAX package's rerank_f32_kernel (index/fused.py:83) and the
// re-score half of flat_search_rerank_kernel / flat_search_approx_kernel
// (index/fused.py:106,114): gather the candidate rows rows[b, :] of a bf16
// mirror x [N, D] (the reduced-rank rerank mirror, the bf16 serving mirror)
// or an f32 one (the approximate flat pool over the f32 serving mirror),
// upcast bf16 rows (exactly) to f32, and score them in the difference form
// sum_d (x[d] - q[d])^2, which does not cancel the way the norm expansion
// does. A candidate row of -1 scores +inf. The m smallest (distance, row)
// come out sorted, padded with (+inf, -1).
//
// What bounds it on the H100: at the serving shape (B = 128, OV <= 1,024,
// D = 384) it reads B * OV rows of 768 bytes (up to 101 MB, 30 us) for
// 3 B OV D flops (0.15 GFLOP): bytes. The rows are scattered, so each is a
// separate 768-byte read.
//
// Design: one block a query scores its pool into a [B, OV] distance buffer:
// the query sits in shared memory, and each warp scores every 8th candidate
// (lanes over dims, then a shuffle tree). topk_select.cuh's radix select
// then picks the m first of each buffer row by (distance, row), for any OV
// (a filtered search at k = 100 asks stage 1 for tens of thousands of rows).
#include "common.cuh"
#include "topk_select.cuh"

namespace fvdb {

template <typename T>
__global__ void __launch_bounds__(NT) rerank_dist_kernel(
    const T* __restrict__ x, int N, int D,
    const float* __restrict__ q, const int* __restrict__ rows, int OV,
    float* __restrict__ dist) {
  extern __shared__ __align__(16) unsigned char dyn[];
  float* qs = reinterpret_cast<float*>(dyn);
  const int b = blockIdx.x;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int d = threadIdx.x; d < D; d += NT) qs[d] = q[(size_t)b * D + d];
  __syncthreads();
  const int* rb = rows + (size_t)b * OV;
  float* db = dist + (size_t)b * OV;
  for (int j = w; j < OV; j += NT / 32) {
    const int row = rb[j];
    float s = INFINITY;
    if (row >= 0 && row < N) {
      const T* xr = x + (size_t)row * D;
      s = 0.f;
      for (int d = lane; d < D; d += 32) {
        const float diff = as_f32(xr[d]) - qs[d];
        s = fmaf(diff, diff, s);
      }
#pragma unroll
      for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
    }
    if (lane == 0) db[j] = s;
  }
}

template <typename T>
cudaError_t rerank(const T* x, int N, int D, const float* q, const int* rows,
                   int B, int OV, int m, float* dist, void* work,
                   float* out_d, int* out_r, cudaStream_t stream) {
  if (B < 1 || OV < 1 || m < 1 || D < 1) return cudaErrorInvalidValue;
  const int smem = D * 4;
  static int cap[64];
  cudaError_t e = raise_smem_cap(
      reinterpret_cast<const void*>(rerank_dist_kernel<T>), smem, cap);
  if (e != cudaSuccess) return e;
  rerank_dist_kernel<T><<<B, NT, smem, stream>>>(x, N, D, q, rows, OV, dist);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_select_topk(dist, rows, nullptr, OV, B, m, work, out_d, out_r,
                            stream);
}

}  // namespace fvdb

// x [N, D] bf16, q [B, D] f32, rows [B, OV] int32 -> out_* [B, m];
// dist [B, OV] scratch; work: fvdb_select_scratch_bytes(B, m) bytes.
FVDB_EXPORT int fvdb_rerank_f32(const __nv_bfloat16* x, int N, int D,
                                const float* q, const int* rows, int B, int OV,
                                int m, float* dist, void* work, float* out_d,
                                int* out_r, cudaStream_t stream) {
  return static_cast<int>(fvdb::rerank(x, N, D, q, rows, B, OV, m, dist, work,
                                       out_d, out_r, stream));
}

// The same over f32 rows x [N, D].
FVDB_EXPORT int fvdb_rerank_f32_rows(const float* x, int N, int D,
                                     const float* q, const int* rows, int B,
                                     int OV, int m, float* dist, void* work,
                                     float* out_d, int* out_r,
                                     cudaStream_t stream) {
  return static_cast<int>(fvdb::rerank(x, N, D, q, rows, B, OV, m, dist, work,
                                       out_d, out_r, stream));
}
