// K17: rows of the procedural clustered-Gaussian corpus.
//
// Replaces the JAX package's SyntheticCorpusSource block program and its
// centers (utils/synth.py:76-81 `block`, jitted in `_gen_fn`, and :86-92
// `_centers`): threefry2x32 draws from jax.random's partitionable streams,
// z = sqrt(2) * erfinv(u), and for a block row scale * z + centers[assign].
// The plain version (fabstir_vectordb_tpu_torch/utils/synth.py) holds the
// same arithmetic in torch ops; each step here rounds as it does there:
//  * threefry2x32, 20 rounds, on the element's flat index r * D + j (the
//    counter's high word is index >> 32), key kz; bits = y0 ^ y1;
//  * u = max(lo, (float(bits >> 9 | 0x3f800000) - 1) * 2 + lo), lo the f32
//    after -1 toward 0;
//  * erfinv(u) by XLA's single-precision Giles polynomial, its steps fused
//    multiply-adds as XLA's compiler contracts them;
//  * a block row: fmaf(erfinv(u), f32(sqrt2 * scale), centers[assign][j]),
//    the constant folded and the add fused as XLA does; assign is
//    randint's modular form over two draws (keys kh, kl) at counter r;
//  * the centers (no centers given): f32(sqrt2) * erfinv(u).
// Products and sums are written with __fmul_rn / __fadd_rn / fmaf so nvcc
// cannot contract them otherwise than the plain version computes them.
//
// What bounds it on the H100: integer operations. An element costs ~80
// int32 operations (threefry's 2 + 20 x 3 + 5 x 3, the xor, shift and or of
// the uniform) and ~25 f32 ones, and writes 2 or 4 bytes: a 1,048,576 x 384
// bf16 block is 32.2 G int32 operations (1.9 ms at the 16.7 T/s of 132 SMs
// x 64 int32 lanes x 1.98 GHz) against 0.8 GB written (0.24 ms). The design
// keeps everything in registers: one block of 128 threads a row at a time,
// lanes on consecutive columns (coalesced center reads and output writes),
// the row's center index from a first small kernel (one thread a row).
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

__device__ __forceinline__ void threefry2x32(unsigned k0, unsigned k1,
                                             unsigned& x0, unsigned& x1) {
  const unsigned k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  const unsigned ks[3] = {k0, k1, k2};
  x0 += k0;
  x1 += k1;
#define FVDB_ROUND(r)                 \
  x0 += x1;                           \
  x1 = __funnelshift_l(x1, x1, (r));  \
  x1 ^= x0;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    if ((i & 1) == 0) {
      FVDB_ROUND(13) FVDB_ROUND(15) FVDB_ROUND(26) FVDB_ROUND(6)
    } else {
      FVDB_ROUND(17) FVDB_ROUND(29) FVDB_ROUND(16) FVDB_ROUND(24)
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (unsigned)(i + 1);
  }
#undef FVDB_ROUND
}

__device__ __forceinline__ unsigned random_bits(unsigned k0, unsigned k1,
                                                unsigned long long c) {
  unsigned x0 = (unsigned)(c >> 32), x1 = (unsigned)c;
  threefry2x32(k0, k1, x0, x1);
  return x0 ^ x1;
}

__device__ __forceinline__ float erfinv_giles(float x) {
  float w = -log1pf(-__fmul_rn(x, x));
  const bool lt = w < 5.f;
  w = lt ? __fadd_rn(w, -2.5f) : __fadd_rn(sqrtf(w), -3.f);
  float p;
  if (lt) {
    p = 2.81022636e-08f;
    p = fmaf(p, w, 3.43273939e-07f);
    p = fmaf(p, w, -3.5233877e-06f);
    p = fmaf(p, w, -4.39150654e-06f);
    p = fmaf(p, w, 0.00021858087f);
    p = fmaf(p, w, -0.00125372503f);
    p = fmaf(p, w, -0.00417768164f);
    p = fmaf(p, w, 0.246640727f);
    p = fmaf(p, w, 1.50140941f);
  } else {
    p = -0.000200214257f;
    p = fmaf(p, w, 0.000100950558f);
    p = fmaf(p, w, 0.00134934322f);
    p = fmaf(p, w, -0.00367342844f);
    p = fmaf(p, w, 0.00573950773f);
    p = fmaf(p, w, -0.0076224613f);
    p = fmaf(p, w, 0.00943887047f);
    p = fmaf(p, w, 1.00167406f);
    p = fmaf(p, w, 2.83297682f);
  }
  const float out = __fmul_rn(p, x);
  return fabsf(x) == 1.f ? __fmul_rn(x, INFINITY) : out;
}

__device__ __forceinline__ float uniform_from_bits(unsigned bits) {
  const float lo = -0.99999994f;  // nextafter(-1, 0)
  const float f = __fadd_rn(__uint_as_float((bits >> 9) | 0x3f800000u), -1.f);
  return fmaxf(lo, __fadd_rn(__fmul_rn(f, 2.f), lo));
}

// The block offset of output row i.
__device__ __forceinline__ long long row_at(const int* rows, long long lo,
                                            int i) {
  return rows ? (long long)rows[i] : lo + i;
}

// One thread a row: randint(0, C) from the two draws at the row's counter.
__global__ void __launch_bounds__(fvdb::NT) synth_assign_kernel(
    unsigned h0, unsigned h1, unsigned l0, unsigned l1,
    const int* __restrict__ rows, long long row_lo, int n, unsigned span,
    int* __restrict__ assign) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned long long r = (unsigned long long)row_at(rows, row_lo, i);
  const unsigned hi = random_bits(h0, h1, r), lo = random_bits(l0, l1, r);
  unsigned mult = 65536u % span;
  mult = (mult * mult) % span;  // wraps at 2^32 as the reference's uint32
  const unsigned off = (hi % span) * mult + lo % span;
  assign[i] = (int)(off % span);
}

// One block of 128 threads a row (grid-stride over rows), lanes over
// columns. centers null: sqrt(2) * erfinv(u). T: float or __nv_bfloat16.
template <typename T>
__global__ void __launch_bounds__(128) synth_rows_kernel(
    unsigned z0, unsigned z1, const int* __restrict__ rows, long long row_lo,
    int n, int D, float k_scale, const float* __restrict__ centers,
    const int* __restrict__ assign, T* __restrict__ out) {
  for (int i = blockIdx.x; i < n; i += gridDim.x) {
    const unsigned long long base =
        (unsigned long long)row_at(rows, row_lo, i) * (unsigned long long)D;
    const float* c = centers ? centers + (size_t)assign[i] * D : nullptr;
    T* o = out + (size_t)i * D;
    for (int j = threadIdx.x; j < D; j += blockDim.x) {
      const float e =
          erfinv_giles(uniform_from_bits(random_bits(z0, z1, base + j)));
      const float v = c ? fmaf(e, k_scale, c[j])
                        : __fmul_rn(1.41421354f, e);  // f32(sqrt(2))
      if constexpr (sizeof(T) == 2)
        o[j] = __float2bfloat16_rn(v);
      else
        o[j] = v;
    }
  }
}

}  // namespace

// Rows of one block (or the centers): rows [n] block offsets, or null for
// row_lo .. row_lo + n - 1. kz (z0, z1) keys the normal draws, kh / kl the
// two randint draws (unused without centers). centers [n_centers, D] f32 or
// null; assign [n] int32 out (null without centers); k_scale =
// f32(f32(sqrt2) * scale); out [n, D] f32 (out_bf16 0) or bf16 (1).
FVDB_EXPORT int fvdb_synth_rows(unsigned z0, unsigned z1, unsigned h0,
                                unsigned h1, unsigned l0, unsigned l1,
                                const int* rows, long long row_lo, int n,
                                int D, int n_centers, float k_scale,
                                const float* centers, int* assign, void* out,
                                int out_bf16, cudaStream_t stream) {
  using namespace fvdb;
  if (n < 1 || D < 1 || row_lo < 0 || (centers && (n_centers < 1 || !assign)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (centers) {
    synth_assign_kernel<<<(n + NT - 1) / NT, NT, 0, stream>>>(
        h0, h1, l0, l1, rows, row_lo, n, (unsigned)n_centers, assign);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = n < 132 * 64 ? n : 132 * 64;
  if (out_bf16)
    synth_rows_kernel<__nv_bfloat16><<<grid, 128, 0, stream>>>(
        z0, z1, rows, row_lo, n, D, k_scale, centers, assign,
        static_cast<__nv_bfloat16*>(out));
  else
    synth_rows_kernel<float><<<grid, 128, 0, stream>>>(
        z0, z1, rows, row_lo, n, D, k_scale, centers, assign,
        static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
