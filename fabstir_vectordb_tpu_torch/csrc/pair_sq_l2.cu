// K5: squared L2 between row pairs of the resident corpus.
//
// Replaces the JAX package's _pair_dists_kernel (index/hnsw.py:222), which
// the HNSW reverse-link prune calls: out[p] = max(x_sq[t_p] - 2 x[t_p].x[c_p]
// + x_sq[c_p], 0), over an f32 mirror or a bf16 one (both rows upcast
// exactly; x_sq is the mirror's, on a bf16 mirror the f32 norms of the f32
// host rows, as in the reference).
//
// What bounds it on the H100: the two gathered rows, 2 * D * 4 bytes a pair
// (201 MB for P = 65,536 at D = 384), 60 us at 3.35 TB/s; the arithmetic is
// 2 * D flops a pair and does not matter.
//
// Design: one warp per pair. Lanes read consecutive floats of both rows, so
// each 128-byte line of a row is one coalesced load, and a shuffle tree sums
// the dot product. Rows are random, so nothing is reused and nothing is
// staged.
#include "common.cuh"

namespace fvdb {

template <typename T>
__global__ void __launch_bounds__(NT) pair_sq_l2_kernel(
    const T* __restrict__ x, const float* __restrict__ x_sq,
    const int* __restrict__ t_ids, const int* __restrict__ c_ids, int P,
    int D, float* __restrict__ out) {
  const int p = blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
  if (p >= P) return;  // whole warps leave
  const int lane = threadIdx.x & 31;
  const long long ti = t_ids[p], ci = c_ids[p];
  const T* a = x + ti * D;
  const T* c = x + ci * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s = fmaf(as_f32(a[d]), as_f32(c[d]), s);
#pragma unroll
  for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
  if (lane == 0) out[p] = fmaxf(x_sq[ti] - 2.f * s + x_sq[ci], 0.f);
}

template <typename T>
cudaError_t pair_sq_l2(const T* x, const float* x_sq, const int* t_ids,
                       const int* c_ids, int P, int D, float* out,
                       cudaStream_t stream) {
  if (P < 1 || D < 1) return cudaErrorInvalidValue;
  const int per_block = NT / 32;
  pair_sq_l2_kernel<T><<<(P + per_block - 1) / per_block, NT, 0, stream>>>(
      x, x_sq, t_ids, c_ids, P, D, out);
  return cudaGetLastError();
}

}  // namespace fvdb

// x [N, D], x_sq [N], t_ids / c_ids [P] (int32, in range), out [P].
FVDB_EXPORT int fvdb_pair_sq_l2(const float* x, const float* x_sq,
                                const int* t_ids, const int* c_ids, int P,
                                int D, float* out, cudaStream_t stream) {
  return static_cast<int>(
      fvdb::pair_sq_l2(x, x_sq, t_ids, c_ids, P, D, out, stream));
}

// The same over bf16 rows x [N, D].
FVDB_EXPORT int fvdb_pair_sq_l2_bf16(const __nv_bfloat16* x,
                                     const float* x_sq, const int* t_ids,
                                     const int* c_ids, int P, int D,
                                     float* out, cudaStream_t stream) {
  return static_cast<int>(
      fvdb::pair_sq_l2(x, x_sq, t_ids, c_ids, P, D, out, stream));
}
