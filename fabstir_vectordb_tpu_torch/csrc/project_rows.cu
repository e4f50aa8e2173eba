// K14's projection: rows into the reduced-rank space, (x - mu) . P.
//
// Replaces the JAX package's mirror-build programs _project_chunk
// (index/fused.py:197: bf16(((f32 x) - mu) @ P)), _xp_write (:221: the
// projected block written in place into the [N, r] mirror at row lo) and
// _bf16_row_norms (:229: f32 squared norms of the bf16 mirror rows), fused
// into one launch a block: each row is centered in f32, multiplied in f32
// (FMA, no TF32), rounded once to bf16 (nearest even), written at row
// lo + i of the mirror, and its f32 norm is summed from the rounded values.
// The same kernel with f32 input and f32 output projects query rows (the
// reference's (q - mu) @ p at index/fused.py:741 and :628).
//
// What bounds it on the H100: a block of n rows is n * D * 2 bytes in and
// n * r * 2 + 4 n out, against 2 n D r flops: at D = 384 and r <= 192 that
// is ~200 flops a byte, so f32 arithmetic bounds it (2.3 ms for 1,048,576
// rows at r = 192 and 67 TFLOP/s). It runs once a mirror build.
//
// Design: a block takes 32 rows; thread t owns column c0 + t of each group
// of 256 columns (any r). For a group, the rows are centered 128 dims at a
// time into shared memory as [128 dims][32 rows] floats (any D); for each dim
// the thread reads P[d][c] once from global memory (P is small and stays in
// L2) and the 32 row values as 8 broadcast 16-byte shared loads, 32 FMAs.
// Each thread sums the squares of its rounded columns over the groups; a
// row's norm is then a shuffle tree over the lanes and a sum over the 8
// warps in a fixed order.
#include <cuda_bf16.h>

#include "common.cuh"

namespace fvdb {

constexpr int PR = 32;        // rows a block
constexpr int DC = 128;       // dims a staged chunk
constexpr int XPAD = PR + 4;  // keeps rows 16-byte aligned, spreads stores

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// MIRROR: round to bf16, write out_bf16 [.., R] at row out_row0 + i, and
// out_sq; else write f32 out_f32 [n, R].
template <typename Tin, bool MIRROR>
__global__ void __launch_bounds__(NT) project_kernel(
    const Tin* __restrict__ src, int n, int D, const float* __restrict__ mu,
    const float* __restrict__ p, int R, long long out_row0,
    __nv_bfloat16* __restrict__ out_bf16, float* __restrict__ out_sq,
    float* __restrict__ out_f32) {
  __shared__ __align__(16) float xs[DC][XPAD];
  __shared__ float red[NT / 32][PR];
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const int r0 = blockIdx.x * PR;
  const int rn = min(PR, n - r0);
  float sq[PR];
#pragma unroll
  for (int r = 0; r < PR; ++r) sq[r] = 0.f;
  for (int c0 = 0; c0 < R; c0 += NT) {
    const int c = c0 + t;
    float acc[PR];
#pragma unroll
    for (int r = 0; r < PR; ++r) acc[r] = 0.f;
    for (int d0 = 0; d0 < D; d0 += DC) {
      __syncthreads();  // the previous chunk's products are done with xs
#pragma unroll
      for (int e = 0; e < PR * DC / NT; ++e) {  // all loads in flight at once
        const int idx = t + e * NT, r = idx / DC, d = idx % DC;
        xs[d][r] = (r < rn && d0 + d < D)
                       ? load_f32(src + (size_t)(r0 + r) * D + d0 + d) -
                             mu[d0 + d]
                       : 0.f;
      }
      __syncthreads();
      const int dn = min(DC, D - d0);
      for (int d = 0; d < dn; ++d) {
        const float pv = c < R ? __ldg(p + (size_t)(d0 + d) * R + c) : 0.f;
        const float4* xr = reinterpret_cast<const float4*>(xs[d]);
#pragma unroll
        for (int r4 = 0; r4 < PR / 4; ++r4) {
          const float4 v = xr[r4];
          acc[4 * r4 + 0] = fmaf(v.x, pv, acc[4 * r4 + 0]);
          acc[4 * r4 + 1] = fmaf(v.y, pv, acc[4 * r4 + 1]);
          acc[4 * r4 + 2] = fmaf(v.z, pv, acc[4 * r4 + 2]);
          acc[4 * r4 + 3] = fmaf(v.w, pv, acc[4 * r4 + 3]);
        }
      }
    }
    if (c >= R) continue;  // only writes below: no barrier is skipped
#pragma unroll
    for (int r = 0; r < PR; ++r) {
      if (r >= rn) continue;
      if constexpr (MIRROR) {
        const __nv_bfloat16 v = __float2bfloat16_rn(acc[r]);
        out_bf16[(size_t)(out_row0 + r0 + r) * R + c] = v;
        const float f = __bfloat162float(v);
        sq[r] = fmaf(f, f, sq[r]);
      } else {
        out_f32[(size_t)(r0 + r) * R + c] = acc[r];
      }
    }
  }
  if constexpr (MIRROR) {
#pragma unroll
    for (int r = 0; r < PR; ++r) {
      float s = sq[r];
#pragma unroll
      for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
      if (lane == 0) red[w][r] = s;
    }
    __syncthreads();
    if (t < rn) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < NT / 32; ++i) s += red[i][t];
      out_sq[out_row0 + r0 + t] = s;
    }
  }
}

}  // namespace fvdb

// src [n, D] bf16, mu [D], p [D, R] f32 -> out [.., R] bf16 rows
// out_row0 .. out_row0 + n - 1 and their f32 norms out_sq.
FVDB_EXPORT int fvdb_project_rows(const __nv_bfloat16* src, int n, int D,
                                  const float* mu, const float* p, int R,
                                  long long out_row0, __nv_bfloat16* out,
                                  float* out_sq, cudaStream_t stream) {
  using namespace fvdb;
  if (n < 1 || D < 1 || R < 1) return static_cast<int>(cudaErrorInvalidValue);
  project_kernel<__nv_bfloat16, true><<<(n + PR - 1) / PR, NT, 0, stream>>>(
      src, n, D, mu, p, R, out_row0, out, out_sq, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// q [n, D] f32 -> out [n, R] f32.
FVDB_EXPORT int fvdb_project_queries(const float* q, int n, int D,
                                     const float* mu, const float* p, int R,
                                     float* out, cudaStream_t stream) {
  using namespace fvdb;
  if (n < 1 || D < 1 || R < 1) return static_cast<int>(cudaErrorInvalidValue);
  project_kernel<float, false><<<(n + PR - 1) / PR, NT, 0, stream>>>(
      q, n, D, mu, p, R, 0, nullptr, nullptr, out);
  return static_cast<int>(cudaGetLastError());
}
