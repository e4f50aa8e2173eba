// Shared pieces of the port's kernels: the C error hook, the shared-memory
// cap, reads of f32 or bf16 rows as f32, the (distance, row) order and its
// unsigned keys, the distance of each metric, a warp's row norm and dot
// products, a block-wide rank of a predicate and a warp-held sorted top-k
// list.
//
// Every exported function returns the cudaError_t of its launches as an int;
// the Python wrapper raises on anything but 0.
#pragma once

#include <cuda_bf16.h>
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

// A row element as f32: bf16 rows are upcast exactly.
__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Raw 16 bits of a bf16 as the f32 of the same value (exact).
__device__ __forceinline__ float bf16_bits_f32(unsigned short u) {
  return __uint_as_float((unsigned)u << 16);
}

// One row element as f32, read through the read-only cache.
__device__ __forceinline__ float ld1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
  return bf16_bits_f32(__ldg(reinterpret_cast<const unsigned short*>(p)));
}

// Four consecutive row elements as f32: one 16-byte load of f32 rows, one
// 8-byte load of bf16 rows (p aligned to the load).
__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// Results are ordered by (distance, row): equal distances go to the lower
// row, so the kernels and their plain versions agree on ties.
__device__ __forceinline__ bool lex_less(float da, int ra, float db, int rb) {
  return da < db || (da == db && ra < rb);
}

// The order key of a distance: unsigned keys order as the floats do, signs
// included. A negative float has every bit flipped, a non-negative one its
// sign bit set; -0 maps as +0. Every selection that packs distances into
// integers (the radix select, K9's bin minima) orders by these keys, so
// negative distances (dot, cosine, a caller's dist_fn) rank before positive
// ones. Non-negative distances keep their relative order, so euclidean
// results are the same as with raw bits.
__host__ __device__ constexpr unsigned key_of_bits(unsigned u) {
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
constexpr unsigned INF_KEY = key_of_bits(0x7f800000u);      // +inf
constexpr unsigned NEG_INF_KEY = key_of_bits(0xff800000u);  // -inf

__device__ __forceinline__ unsigned dist_key(float d) {
  return key_of_bits(d == 0.f ? 0u : __float_as_uint(d));
}

// A finite distance's key: strictly between -inf's and +inf's (NaNs fall
// outside: positive ones above +inf, negative ones below -inf).
__device__ __forceinline__ bool finite_key(unsigned key) {
  return key > NEG_INF_KEY && key < INF_KEY;
}

// The distance whose key this is.
__device__ __forceinline__ float key_dist(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// Metrics (the reference's ops/distance.py): squared euclidean, cosine
// distance 1 - cos, negative inner product. Smaller is better in all three.
constexpr int EUCLID = 0;
constexpr int COSINE = 1;
constexpr int DOT = 2;

// Squared norm of one row of D floats, taken by a whole warp.
__device__ __forceinline__ float warp_row_sq(const float* __restrict__ row,
                                             int D) {
  float s = 0.f;
  for (int d = threadIdx.x & 31; d < D; d += 32) s = fmaf(row[d], row[d], s);
#pragma unroll
  for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
  return s;
}

// max(|q|^2 - 2 q.x + |x|^2, 0), the JAX package's _gather_dists form; a
// cancellation to -0 comes out as +0.
__device__ __forceinline__ float sq_dist(float q_sq, float dot, float x_sq) {
  const float v = q_sq - 2.f * dot + x_sq;
  return v > 0.f ? v : 0.f;
}

// The distance of METRIC from a dot product and the two squared norms:
// euclidean as sq_dist; cosine 1 - q.x / sqrt(max(|q|^2 |x|^2, 1e-30)),
// not clamped (a zero-norm row is at 1); dot -q.x.
template <int METRIC>
__device__ __forceinline__ float metric_dist(float q_sq, float dot,
                                             float x_sq) {
  if constexpr (METRIC == COSINE) {
    return 1.f - dot / sqrtf(fmaxf(q_sq * x_sq, 1e-30f));
  } else if constexpr (METRIC == DOT) {
    return -dot;
  } else {
    return sq_dist(q_sq, dot, x_sq);
  }
}

// Run f with METRIC as a compile-time constant: f(std::integral_constant
// <int, METRIC>-like tag); an unknown metric is an invalid value.
template <int M>
struct MetricTag {
  static constexpr int value = M;
};
template <typename F>
inline cudaError_t with_metric(int metric, F&& f) {
  switch (metric) {
    case EUCLID: return f(MetricTag<EUCLID>{});
    case COSINE: return f(MetricTag<COSINE>{});
    case DOT: return f(MetricTag<DOT>{});
    default: return cudaErrorInvalidValue;
  }
}

struct NoOp {
  __device__ __forceinline__ void operator()() const {}
};

// Dot products of one query (D floats in shared memory) with G rows of x
// (f32, or bf16 upcast exactly), taken by a whole warp; every lane ends
// with the G sums. A row < 0 is skipped and gives 0. When D is a multiple
// of 128 (aligned rows), lane l takes dims 4l..4l+3 of each 128-dim chunk
// (one 16-byte load of f32 rows, one 8-byte load of bf16 rows), and every
// row's loads of three chunks are issued before any FMA, so a 384-dim
// group costs one memory round trip instead of one a dim step; else lane l
// sums dims l, l+32, .... Then a shuffle tree. The sums are the same for
// both row types: the same products in the same order. after_loads() runs
// once the first chunk's loads are out (before any FMA on them; at the
// start on the scalar path): a caller's other loads can go out then.
template <int G, typename T, typename F = NoOp>
__device__ __forceinline__ void warp_dots(const float* qs,
                                          const T* __restrict__ x,
                                          const int (&rows)[G], int D,
                                          float (&acc)[G],
                                          F&& after_loads = F{}) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;
  if ((D & 127) == 0) {
    for (int c0 = 0; c0 < D; c0 += 3 * 128) {
      float4 v[3][G];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int d = c0 + c * 128 + 4 * lane;
#pragma unroll
        for (int g = 0; g < G; ++g)
          v[c][g] = rows[g] >= 0 && d < D
                        ? ld4(x + (size_t)rows[g] * D + d)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      if (c0 == 0) after_loads();
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int d = c0 + c * 128 + 4 * lane;
        if (d >= D) break;  // uniform: D is a multiple of 128
        const float4 qv = *reinterpret_cast<const float4*>(qs + d);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          acc[g] = fmaf(qv.x, v[c][g].x, acc[g]);
          acc[g] = fmaf(qv.y, v[c][g].y, acc[g]);
          acc[g] = fmaf(qv.z, v[c][g].z, acc[g]);
          acc[g] = fmaf(qv.w, v[c][g].w, acc[g]);
        }
      }
    }
  } else {
    after_loads();
    for (int d = lane; d < D; d += 32) {
      const float qv = qs[d];
#pragma unroll
      for (int g = 0; g < G; ++g)
        if (rows[g] >= 0)
          acc[g] = fmaf(qv, ld1(x + (size_t)rows[g] * D + d), acc[g]);
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int off = 16; off; off >>= 1)
      acc[g] += __shfl_xor_sync(FULL, acc[g], off);
}

// This thread's index among the block's threads whose `pred` holds (in
// thread order), and their count in *total. Every thread of the block calls
// it; s_wcnt holds NT / 32 ints of shared memory.
__device__ __forceinline__ int block_rank(bool pred, int* s_wcnt, int* total) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned bal = __ballot_sync(FULL, pred);
  __syncthreads();  // s_wcnt is free from its last use
  if (lane == 0) s_wcnt[w] = __popc(bal);
  __syncthreads();
  int off = 0, tot = 0;
#pragma unroll
  for (int i = 0; i < NT / 32; ++i) {
    const int c = s_wcnt[i];
    off += i < w ? c : 0;
    tot += c;
  }
  *total = tot;
  return off + __popc(bal & ((1u << lane) - 1u));
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
