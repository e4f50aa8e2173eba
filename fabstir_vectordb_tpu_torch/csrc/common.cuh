// Shared pieces of the port's kernels: the C error hook, the shared-memory
// cap, the (distance, row) order, a warp's row norm and a warp-held sorted
// top-k list.
//
// Every exported function returns the cudaError_t of its launches as an int;
// the Python wrapper raises on anything but 0.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define FVDB_EXPORT extern "C" __attribute__((visibility("default")))

FVDB_EXPORT const char* fvdb_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

namespace fvdb {

constexpr unsigned FULL = 0xffffffffu;
constexpr int NT = 256;  // threads of a block: 8 warps

// Raise a kernel's dynamic shared-memory cap to `bytes`, once per device
// (cap[] remembers what each device was given), not on every call.
inline cudaError_t raise_smem_cap(const void* fn, int bytes, int* cap) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (cap[dev] >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess) cap[dev] = bytes;
  return e;
}

// Results are ordered by (distance, row): equal distances go to the lower
// row, so the kernels and their plain versions agree on ties.
__device__ __forceinline__ bool lex_less(float da, int ra, float db, int rb) {
  return da < db || (da == db && ra < rb);
}

// Squared norm of one row of D floats, taken by a whole warp.
__device__ __forceinline__ float warp_row_sq(const float* __restrict__ row,
                                             int D) {
  float s = 0.f;
  for (int d = threadIdx.x & 31; d < D; d += 32) s = fmaf(row[d], row[d], s);
#pragma unroll
  for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
  return s;
}

// A sorted list of at most k (distance, row) pairs in shared memory, owned
// by one warp; n (the fill) is kept uniform across the warp.
struct WarpList {
  float* d;
  int* r;
  int n;
  int k;

  // Would (dist, row) enter the list now?
  __device__ __forceinline__ bool admits(float dist, int row) const {
    return n < k || lex_less(dist, row, d[k - 1], r[k - 1]);
  }

  // Insert (dist, row), dropping the last entry when full. The caller has
  // checked admits(). Every lane of the warp calls it with the same pair.
  __device__ __forceinline__ void insert(float dist, int row) {
    const int lane = threadIdx.x & 31;
    int c = 0;
    for (int j = lane; j < n; j += 32) c += lex_less(d[j], r[j], dist, row);
#pragma unroll
    for (int off = 16; off; off >>= 1) c += __shfl_xor_sync(FULL, c, off);
    const int pos = c;
    // entries [pos, top) move up one slot, highest 32 first
    for (int hi = min(n, k - 1); hi > pos; hi -= 32) {
      const int j = max(pos, hi - 32) + lane;
      const bool act = j < hi;
      float vd = 0.f;
      int vr = 0;
      if (act) { vd = d[j]; vr = r[j]; }
      __syncwarp();
      if (act) { d[j + 1] = vd; r[j + 1] = vr; }
      __syncwarp();
    }
    if (lane == 0) { d[pos] = dist; r[pos] = row; }
    __syncwarp();
    n = min(n + 1, k);
  }

  // Offer each lane's (dist, row) where `ok`; lanes hold rows in increasing
  // order, but the result does not depend on the order of the offers.
  __device__ __forceinline__ void offer(bool ok, float dist, int row) {
    unsigned bits = __ballot_sync(FULL, ok && admits(dist, row));
    while (bits) {
      const int src = __ffs(bits) - 1;
      bits &= bits - 1;
      const float cd = __shfl_sync(FULL, dist, src);
      const int cr = __shfl_sync(FULL, row, src);
      if (admits(cd, cr)) insert(cd, cr);  // the list may have tightened
    }
  }

  // Fold in a sorted list (ascending, its valid entries a prefix of at most
  // len, padded with row -1). An empty list takes it by a straight copy
  // instead of one insertion per entry.
  __device__ __forceinline__ void absorb(const float* __restrict__ src_d,
                                         const int* __restrict__ src_r,
                                         int len) {
    const int lane = threadIdx.x & 31;
    if (n == 0) {
      const int lim = min(len, k);
      int m = 0;
      for (int j0 = 0; j0 < lim; j0 += 32) {
        const int j = j0 + lane;
        const bool ok = j < lim && src_r[j] >= 0;
        if (ok) { d[j] = src_d[j]; r[j] = src_r[j]; }
        m += __popc(__ballot_sync(FULL, ok));
      }
      __syncwarp();
      n = m;
      return;
    }
    for (int j0 = 0; j0 < len; j0 += 32) {
      const int j = j0 + lane;
      const bool in = j < len;
      const float dist = in ? src_d[j] : INFINITY;
      const int row = in ? src_r[j] : -1;
      offer(row >= 0, dist, row);
    }
  }

  // Write the list out as k entries, padded with (+inf, -1).
  __device__ __forceinline__ void store(float* __restrict__ out_d,
                                        int* __restrict__ out_r) const {
    for (int j = threadIdx.x & 31; j < k; j += 32) {
      out_d[j] = j < n ? d[j] : INFINITY;
      out_r[j] = j < n ? r[j] : -1;
    }
  }
};

}  // namespace fvdb
