// K16, u8 scalar quantization: per-row (min, scale) codes and their decode.
//
// Replaces the JAX package's quantize_u8 (ops/quantization.py:27) and
// dequantize_u8 (:39). Per row of x [N, D] f32: min and max; scale =
// (max - min) / 255 where max > min, else 1; code = clip(round((x - min) /
// scale), 0, 255) as u8, rounded half to even as jnp.round does (rintf).
// Decode: code * scale + min. Every operation is rounded on its own (the
// _rn intrinsics: IEEE division, no fused multiply-add), so the codes and
// the decoded values equal the plain PyTorch version's bit for bit.
//
// What bounds it on the H100: bytes. Quantize reads N x D f32 and writes N
// x D u8 + 8 bytes a row (1,000,000 x 384: 1.93 GB, 0.57 ms at 3.35 TB/s);
// dequantize the reverse. Arithmetic is a few operations an element.
//
// Design: one warp a row, eight rows a block. Each lane reads four
// consecutive elements with one 16-byte load where D is a multiple of four
// (rows then stay 16-byte aligned), else one element at a time. Quantize
// reads its row twice: the second read (min and max known) comes from L1.
// A shuffle tree takes the min and the max.
#include "common.cuh"

namespace fvdb {

constexpr int QROWS = NT / 32;  // rows a block, one a warp

__global__ void __launch_bounds__(NT) quantize_kernel(
    const float* __restrict__ x, int N, int D, uint8_t* __restrict__ codes,
    float* __restrict__ mins, float* __restrict__ scales) {
  const int lane = threadIdx.x & 31;
  const long long n = (long long)blockIdx.x * QROWS + (threadIdx.x >> 5);
  if (n >= N) return;  // a whole warp leaves together
  const float* row = x + n * D;
  uint8_t* out = codes + n * D;
  const bool vec = (D & 3) == 0;
  float mn = INFINITY, mx = -INFINITY;
  if (vec) {
    for (int d = 4 * lane; d < D; d += 128) {
      const float4 v = ld4(row + d);
      mn = fminf(fminf(mn, v.x), fminf(v.y, fminf(v.z, v.w)));
      mx = fmaxf(fmaxf(mx, v.x), fmaxf(v.y, fmaxf(v.z, v.w)));
    }
  } else {
    for (int d = lane; d < D; d += 32) {
      const float v = ld1(row + d);
      mn = fminf(mn, v);
      mx = fmaxf(mx, v);
    }
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    mn = fminf(mn, __shfl_xor_sync(FULL, mn, off));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
  }
  const float scale = mx > mn ? __fdiv_rn(__fsub_rn(mx, mn), 255.f) : 1.f;
  auto code = [&](float v) -> uint8_t {
    const float q = rintf(__fdiv_rn(__fsub_rn(v, mn), scale));
    return static_cast<uint8_t>(fminf(fmaxf(q, 0.f), 255.f));
  };
  if (vec) {
    for (int d = 4 * lane; d < D; d += 128) {
      const float4 v = ld4(row + d);
      uchar4 c;
      c.x = code(v.x);
      c.y = code(v.y);
      c.z = code(v.z);
      c.w = code(v.w);
      *reinterpret_cast<uchar4*>(out + d) = c;
    }
  } else {
    for (int d = lane; d < D; d += 32) out[d] = code(ld1(row + d));
  }
  if (lane == 0) {
    mins[n] = mn;
    scales[n] = scale;
  }
}

__global__ void __launch_bounds__(NT) dequantize_kernel(
    const uint8_t* __restrict__ codes, const float* __restrict__ mins,
    const float* __restrict__ scales, int N, int D, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long n = (long long)blockIdx.x * QROWS + (threadIdx.x >> 5);
  if (n >= N) return;
  const float mn = mins[n], s = scales[n];
  const uint8_t* row = codes + n * D;
  float* o = out + n * D;
  auto val = [&](uint8_t c) {
    return __fadd_rn(__fmul_rn(static_cast<float>(c), s), mn);
  };
  if ((D & 3) == 0) {
    for (int d = 4 * lane; d < D; d += 128) {
      const uchar4 c = __ldg(reinterpret_cast<const uchar4*>(row + d));
      *reinterpret_cast<float4*>(o + d) =
          make_float4(val(c.x), val(c.y), val(c.z), val(c.w));
    }
  } else {
    for (int d = lane; d < D; d += 32) o[d] = val(__ldg(row + d));
  }
}

inline unsigned qblocks(int N) { return (unsigned)((N + QROWS - 1) / QROWS); }

}  // namespace fvdb

// x [N, D] f32 -> codes [N, D] u8, mins [N], scales [N].
FVDB_EXPORT int fvdb_quantize_u8(const float* x, int N, int D,
                                 uint8_t* codes, float* mins, float* scales,
                                 cudaStream_t stream) {
  using namespace fvdb;
  if (N < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  quantize_kernel<<<qblocks(N), NT, 0, stream>>>(x, N, D, codes, mins,
                                                  scales);
  return static_cast<int>(cudaGetLastError());
}

// codes [N, D] u8, mins [N], scales [N] -> out [N, D] f32.
FVDB_EXPORT int fvdb_dequantize_u8(const uint8_t* codes, const float* mins,
                                   const float* scales, int N, int D,
                                   float* out, cudaStream_t stream) {
  using namespace fvdb;
  if (N < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  dequantize_kernel<<<qblocks(N), NT, 0, stream>>>(codes, mins, scales, N, D,
                                                    out);
  return static_cast<int>(cudaGetLastError());
}
