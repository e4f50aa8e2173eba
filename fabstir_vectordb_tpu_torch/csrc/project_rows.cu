// K14's projection: rows into the reduced-rank space, (x - mu) . P.
//
// Replaces the JAX package's mirror-build programs _project_chunk
// (index/fused.py:197: bf16(((f32 x) - mu) @ P)), _xp_write (:221: the
// projected block written in place into the [N, r] mirror at row lo) and
// _bf16_row_norms (:229: f32 squared norms of the bf16 mirror rows), fused
// into one launch a block after a small prepare launch; and the queries'
// (q - mu) @ p in f32 (index/fused.py:741 and :628).
//
// Mirror rows, on the tensor cores. The rows x are bf16 already; the
// prepare kernel splits P once a call into three bf16 matrices, P = P_hi +
// P_mid + P_lo (each the round-to-nearest of what the ones before leave,
// together P's 24-bit mantissa), and takes mu . P in f32, one partial sum a
// 64-dim window. A product of two bf16 values is exact in f32, so
//   y = x . P_hi + x . P_mid + x . P_lo - mu . P
// summed in f32 is the f32 product up to the order of the sums. The
// products run as wgmma (m64 x N x k16, bf16 in, f32 sums) with both
// operands K-major in shared memory. The tensor cores cut their running
// sums to f32 instead of rounding them, a loss that grows with every
// product added at the sum's scale (0.5% of bf16 elements off at D =
// 3,072 when one sum ran over all of D); so each 64-dim window sums from
// 0, P_lo's and P_mid's products before P_hi's, and is then added to f32
// registers (rounded) less the window's share of mu . P: the sums stay at
// the scale of the centered row, and an off-center block does not cancel
// at the end. The epilogue rounds each sum once to bf16 (nearest even),
// writes row lo + i of the mirror, and sums the row's f32 norm from the
// rounded values in a fixed order (in registers, then a shuffle over the
// four lanes of a row), so norms are the same bit for bit from run to run.
//
// What bounds it on the H100: a block of n rows is n * D * 2 bytes in and
// n * (2 r + 4) out, against 3 * 2 n D r bf16 tensor-core flops: at n =
// 524,288, D = 384 and r = 192 that is 0.235 ms of flops at 989 TFLOP/s and
// 0.181 ms of bytes, so the three products bound it.
//
// Design: a block takes 256 rows (four warpgroups of 64) and a column tile
// of NTILE = 32, 64 or 96 columns (the narrowest that takes r in the
// fewest tiles; the split is padded with zero columns and the writes past
// r are masked). A 32-dim step is the rows' [256 x 32] tile and the three
// splits' [NTILE x 32] tiles (64-byte swizzled), and a window's first step
// also its row of mu . P, copied by TMA into a ring of as many slots as
// shared memory takes (6 at NTILE = 96, 35 KB each); each slot's arrival
// is a "full" barrier, and the last of the 16 warps to be done with a
// slot refills it, so no warp waits to issue a copy. A window is two
// steps. What sets the pace is neither the bytes (the split, 3 x 442 KB
// at D = 384, r = 192, is read from L2 by every block) nor the tensor
// cores' own work, but the work between the products, which the tensor
// cores sit out: the wait for a window's products, their promotion and
// the epilogue (scripts/k14_variants.py times copies of this kernel
// without each part). So the promotion is once a window, not once a step,
// with mu . P read from shared memory; four warpgroups of <= 128
// registers (acc and part, 48 floats each at NTILE = 96) share an SM
// instead of two of 255, so that one promotes while the others' products
// run; and the epilogue transposes each row's values across the four
// lanes that hold them, so a lane writes 16 contiguous bytes and a quad
// 64. Rows whose length is not a multiple of 8 (TMA takes 16-byte rows)
// arrive zero-padded by the wrapper.
//
// Queries, in f32 on the CUDA cores (an f32 query has no exact bf16
// split): a block takes QB = 4 query rows and 32 columns, so B = 128 and r
// = 192 give 192 blocks. The centered rows sit in shared memory; the 8
// warps each sum an eighth of the dims, every lane one column read
// coalesced from P, and the eight partial sums are added in a fixed order.
#include <cuda.h>
#include <cuda_bf16.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace fvdb {

constexpr int PM = 256;         // rows a block: four warpgroups of 64
constexpr int PT = 512;         // threads a block
constexpr int PK = 32;          // dims a step: one 64-byte swizzled row
constexpr int PW = 2;           // steps a window, whose sums promote once
constexpr int PA_BYTES = PM * PK * 2;  // the rows' tile of a step
constexpr int PN_MAX = 96;      // the widest column tile
constexpr int PSMEM = 232448 - 1024 - 256;  // less alignment and barriers

// A step's slot: the rows' tile | the three splits' tiles.
__host__ __device__ constexpr int stage_bytes(int ntile) {
  return (PA_BYTES + 3 * ntile * PK * 2 + ntile * 4 + 511) / 512 * 512;
}
// Where a slot keeps its window's row of mu . P (in a window's first step).
__host__ __device__ constexpr int mup_offset(int ntile) {
  return PA_BYTES + 3 * ntile * PK * 2;
}
// Steps in the ring: as many as fit (6 at NTILE = 96), at most 8.
__host__ __device__ constexpr int stages(int ntile) {
  return PSMEM / stage_bytes(ntile) < 8 ? PSMEM / stage_bytes(ntile) : 8;
}

// D rounded up to whole windows: the split's zero-padded depth.
inline int padded_dims(int D) {
  return (D + PW * PK - 1) / (PW * PK) * PW * PK;
}

// The column tile of a launch (a multiple of 32 up to PN_MAX, the
// narrowest that takes r in the fewest tiles), and the tiles for r columns.
inline int pick_ntile(int R, int* tiles) {
  const int t = (R + PN_MAX - 1) / PN_MAX;
  const int w = ((R + t - 1) / t + 31) / 32 * 32;
  *tiles = (R + w - 1) / w;
  return w;
}

// ps [3][Rp][Dp] bf16: split s of P^T, zero past R and D; mup [KW][Rp] f32:
// mup[w][c] = sum of mu[d] P[d][c] over the dims d of window w (64 dims),
// in order.
__global__ void __launch_bounds__(NT) split_kernel(
    const float* __restrict__ p, const float* __restrict__ mu, int D, int R,
    int Dp, int Rp, __nv_bfloat16* __restrict__ ps, float* __restrict__ mup) {
  const long long tot = (long long)Rp * Dp;
  const long long step = (long long)gridDim.x * NT;
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < tot;
       i += step) {
    const int c = (int)(i / Dp), d = (int)(i % Dp);
    const float v = c < R && d < D ? p[(size_t)d * R + c] : 0.f;
    const __nv_bfloat16 hi = __float2bfloat16_rn(v);
    const float r1 = v - __bfloat162float(hi);  // exact
    const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
    const float r2 = r1 - __bfloat162float(mid);  // exact
    ps[i] = hi;
    ps[tot + i] = mid;
    ps[2 * tot + i] = __float2bfloat16_rn(r2);
  }
  const int wins = Dp / (PW * PK);
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x;
       i < (long long)wins * Rp; i += step) {
    const int w = (int)(i / Rp), c = (int)(i % Rp);
    float s = 0.f;
    if (c < R)
      for (int d = w * PW * PK; d < min(D, (w + 1) * PW * PK); ++d)
        s = fmaf(mu[d], p[(size_t)d * R + c], s);
    mup[i] = s;
  }
}

// Step g of a block (column tile g / kbs, dims (g % kbs) * 32 ..) into
// ring slot g % S: the rows' tile, the three splits' tiles and, for a
// window's first step, the window's row of mu . P, counted on the slot's
// full barrier.
template <int NTILE>
__device__ __forceinline__ void issue_step(unsigned char* smem, uint64_t* full,
                                           const CUtensorMap* tmx,
                                           const CUtensorMap* tmp,
                                           const CUtensorMap* tmu, int g,
                                           int kbs, int r0, int Rp) {
  constexpr int SB = stage_bytes(NTILE), S = stages(NTILE);
  const int slot = g % S, ct = g / kbs, kb = g % kbs, d0 = kb * PK;
  const bool first = kb % PW == 0;  // the window's first step
  const uint32_t dst = smem_addr(smem + slot * SB);
  mbar_expect(full + slot, mup_offset(NTILE) + (first ? NTILE * 4 : 0));
  tma_load_2d(dst, tmx, d0, r0, full + slot);
#pragma unroll
  for (int s = 0; s < 3; ++s)
    tma_load_2d(dst + PA_BYTES + s * NTILE * PK * 2, tmp, d0,
                s * Rp + ct * NTILE, full + slot);
  if (first)
    tma_load_2d(dst + mup_offset(NTILE), tmu, ct * NTILE, kb / PW,
                full + slot);
}

// Rows r0 .. r0 + 255 of x (tensor map tmx: [n, ld] bf16, boxes of 256 x
// 32) times the split (tmp: [3 Rp, Dp] bf16, boxes of NTILE x 32), less mu
// . P (tmu: [Dp / 64, Rp] f32, boxes of NTILE), in column tiles of NTILE;
// writes out rows out_row0 + r0 + i and their norms.
template <int NTILE>
__global__ void __launch_bounds__(PT, 1) project_mma_kernel(
    const __grid_constant__ CUtensorMap tmx,
    const __grid_constant__ CUtensorMap tmp,
    const __grid_constant__ CUtensorMap tmu, int n, int R, int Rp, int kbs,
    int tiles,
    long long out_row0, __nv_bfloat16* __restrict__ out,
    float* __restrict__ out_sq) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[8];
  __shared__ int released[8];  // warps done with a slot's current step
  // the swizzle needs 512-byte aligned tiles
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  constexpr int S = stages(NTILE);
  static_assert(S > PW, "a window and a step ahead fit the ring");
  constexpr int M = NTILE / 2;  // accumulators a thread
  const int t = threadIdx.x, wg = t >> 7, wt = t & 127;
  const int lane = t & 31, wrow = (wt >> 5) * 16 + (lane >> 2);
  const int r0 = blockIdx.x * PM, rn = min(PM, n - r0);
  const int T = tiles * kbs;  // the block's steps
  if (t == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full + i, 1);
      released[i] = 0;
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (t == 0)
    for (int g = 0; g < S && g < T; ++g)
      issue_step<NTILE>(smem, full, &tmx, &tmp, &tmu, g, kbs, r0, Rp);
  float sq[2] = {0.f, 0.f};  // rows wrow and wrow + 8 of this warpgroup
  float acc[M], part[M];
  for (int g = 0; g < T; g += PW) {
    const int ct = g / kbs, kb = g % kbs, col0 = ct * NTILE;
    if (kb == 0) {
#pragma unroll
      for (int i = 0; i < M; ++i) acc[i] = 0.f;
    }
    uint64_t da[PW], db[PW];
#pragma unroll
    for (int i = 0; i < PW; ++i) {
      const int gi = g + i;
      mbar_wait(full + gi % S, (gi / S) & 1);
      const uint32_t st = smem_addr(smem + (gi % S) * stage_bytes(NTILE));
      da[i] = sw64_desc(st + wg * 64 * PK * 2);
      db[i] = sw64_desc(st + PA_BYTES);
    }
    // the window's sums start from 0 in `part`, the small parts of the
    // split first: the tensor cores' sums cut (not round) to f32, and that
    // loss grows with each product added at the scale of the sum
    fence_regs(part);
    wgmma_fence();
#pragma unroll
    for (int s = 2; s >= 0; --s)
#pragma unroll
      for (int i = 0; i < PW; ++i)
#pragma unroll
        for (int k16 = 0; k16 < PK / 16; ++k16)
          Wgmma<NTILE>::mma(part, da[i] + 2 * k16,
                            db[i] + (uint64_t)((s * NTILE * PK * 2) >> 4) +
                                2 * k16,
                            s < 2 || i > 0 || k16 > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(part);
    // into the f32 sums (rounded), less the window's share of mu . P (in
    // its first step's slot)
    const float* mk =
        reinterpret_cast<const float*>(smem + (g % S) * stage_bytes(NTILE) +
                                       mup_offset(NTILE)) +
        2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < M / 4; ++j) {
      const float2 m = *reinterpret_cast<const float2*>(mk + 8 * j);
      acc[4 * j] += part[4 * j] - m.x;
      acc[4 * j + 1] += part[4 * j + 1] - m.y;
      acc[4 * j + 2] += part[4 * j + 2] - m.x;
      acc[4 * j + 3] += part[4 * j + 3] - m.y;
    }
    // This warp is done with the window's slots; the last of the 16 warps
    // to be done refills each with the step S on, so no warp waits to
    // issue a copy.
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      for (int i = 0; i < PW; ++i) {
        const int slot = (g + i) % S;
        if (atomicAdd(released + slot, 1) == PT / 32 - 1) {
          atomicExch(released + slot, 0);
          __threadfence_block();
          if (g + i + S < T)
            issue_step<NTILE>(smem, full, &tmx, &tmp, &tmu, g + i + S, kbs,
                              r0, Rp);
        }
      }
    }
    if (kb + PW < kbs) continue;
    // the tile's epilogue: round, sum the rounded squares, write
    const int q = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wg * 64 + wrow + 8 * h;
      const bool live = row < rn;
      __nv_bfloat16* orow = out + (size_t)(out_row0 + r0 + row) * R;
      uint32_t pk[M / 4];  // columns 8 j + 2 q and + 1 of the row, packed
#pragma unroll
      for (int j = 0; j < M / 4; ++j) {
        const int c = col0 + 8 * j + 2 * q;
        const __nv_bfloat16 v0 = __float2bfloat16_rn(acc[4 * j + 2 * h]);
        const __nv_bfloat16 v1 = __float2bfloat16_rn(acc[4 * j + 2 * h + 1]);
        const float f0 = __bfloat162float(v0), f1 = __bfloat162float(v1);
        if (c < R) sq[h] = fmaf(f0, f0, sq[h]);
        if (c + 1 < R) sq[h] = fmaf(f1, f1, sq[h]);
        pk[j] = (uint32_t)__bfloat16_as_ushort(v0) |
                ((uint32_t)__bfloat16_as_ushort(v1) << 16);
      }
      if ((R & 7) == 0) {
        // a 4 x 4 transpose in each quad: lane q then holds columns 32 m
        // + 8 q .. + 7, 16 bytes, and the quad 64 contiguous bytes
#pragma unroll
        for (int m = 0; m < M / 16; ++m) {
          const uint32_t a0 = pk[4 * m], a1 = pk[4 * m + 1];
          const uint32_t a2 = pk[4 * m + 2], a3 = pk[4 * m + 3];
          uint32_t b0 = q == 0 ? a0 : 0u, b1 = q == 1 ? a1 : 0u;
          uint32_t b2 = q == 2 ? a2 : 0u, b3 = q == 3 ? a3 : 0u;
#pragma unroll
          for (int x = 1; x < 4; ++x) {
            const int p = q ^ x;  // the partner: it takes my a[p]
            const uint32_t send = p == 0 ? a0 : p == 1 ? a1 : p == 2 ? a2 : a3;
            const uint32_t got = __shfl_xor_sync(FULL, send, x);
            b0 = p == 0 ? got : b0;
            b1 = p == 1 ? got : b1;
            b2 = p == 2 ? got : b2;
            b3 = p == 3 ? got : b3;
          }
          const int c = col0 + 32 * m + 8 * q;
          if (live && c < R)
            *reinterpret_cast<uint4*>(orow + c) = make_uint4(b0, b1, b2, b3);
        }
        continue;
      }
#pragma unroll
      for (int j = 0; j < M / 4; ++j) {  // rows of any length: a pair each
        const int c = col0 + 8 * j + 2 * q;
        if (!live || c >= R) continue;
        orow[c] = __ushort_as_bfloat16((unsigned short)(pk[j] & 0xffffu));
        if (c + 1 < R)
          orow[c + 1] = __ushort_as_bfloat16((unsigned short)(pk[j] >> 16));
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float s = sq[h];
    s += __shfl_xor_sync(FULL, s, 1);
    s += __shfl_xor_sync(FULL, s, 2);
    const int row = wg * 64 + wrow + 8 * h;
    if ((lane & 3) == 0 && row < rn) out_sq[out_row0 + r0 + row] = s;
  }
}

constexpr int QB = 4;   // query rows a block
constexpr int QC = 32;  // columns a block: one a lane
constexpr int QDC = 512;  // dims staged at once

__global__ void __launch_bounds__(NT) project_queries_kernel(
    const float* __restrict__ q, int n, int D, const float* __restrict__ mu,
    const float* __restrict__ p, int R, float* __restrict__ out) {
  __shared__ __align__(16) float qs[QB][QDC];
  __shared__ float part[NT / 32][QB][QC];
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const int q0 = blockIdx.x * QB, qn = min(QB, n - q0);
  const int c = blockIdx.y * QC + lane;
  float acc[QB];
#pragma unroll
  for (int i = 0; i < QB; ++i) acc[i] = 0.f;
  for (int d0 = 0; d0 < D; d0 += QDC) {
    const int dn = min(QDC, D - d0);
    __syncthreads();
    for (int i = t; i < QB * QDC; i += NT) {
      const int r = i / QDC, d = i % QDC;
      qs[r][d] = r < qn && d < dn
                     ? q[(size_t)(q0 + r) * D + d0 + d] - mu[d0 + d]
                     : 0.f;
    }
    __syncthreads();
    if (c < R) {
      // warp w sums dims w, w + 8, ... of the staged chunk
      const float* pc = p + (size_t)d0 * R + c;
#pragma unroll 4
      for (int d = w; d < dn; d += NT / 32) {
        const float pv = __ldg(pc + (size_t)d * R);
#pragma unroll
        for (int i = 0; i < QB; ++i) acc[i] = fmaf(qs[i][d], pv, acc[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < QB; ++i) part[w][i][lane] = acc[i];
  __syncthreads();
  if (t < QB * QC) {
    const int i = t / QC, cc = blockIdx.y * QC + t % QC;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NT / 32; ++j) s += part[j][i][t % QC];
    if (i < qn && cc < R) out[(size_t)(q0 + i) * R + cc] = s;
  }
}

// libcuda's cuTensorMapEncodeTiled, found through the runtime's entry
// point query (no link against libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// A row-major [rows, cols] matrix (row stride ld elements; ld * its
// element size a multiple of 16 bytes) read in boxes of box_rows x
// box_cols: bf16 64-byte swizzled (box_cols 32), or f32 as it lies.
inline bool tile_map(CUtensorMap* m, const void* base, bool bf16,
                     long long rows, long long cols, long long ld,
                     int box_rows, int box_cols) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * (bf16 ? 2 : 4)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(m,
             bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                  : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
             2, const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             bf16 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NTILE>
cudaError_t launch_mma(const __nv_bfloat16* src, int n, int ld, int R,
                       const __nv_bfloat16* ps, const float* mup, int Rp,
                       int Dp, int tiles, long long out_row0,
                       __nv_bfloat16* out, float* out_sq,
                       cudaStream_t stream) {
  static int cap[64] = {0};
  CUtensorMap tmx, tmp, tmu;
  if (!tile_map(&tmx, src, true, n, ld, ld, PM, PK) ||
      !tile_map(&tmp, ps, true, 3LL * Rp, Dp, Dp, NTILE, PK) ||
      !tile_map(&tmu, mup, false, Dp / (PW * PK), Rp, Rp, 1, NTILE))
    return cudaErrorInvalidValue;
  const int smem = stages(NTILE) * stage_bytes(NTILE) + 1024;  // + align
  cudaError_t e = raise_smem_cap(
      reinterpret_cast<const void*>(project_mma_kernel<NTILE>), smem, cap);
  if (e != cudaSuccess) return e;
  project_mma_kernel<NTILE><<<(n + PM - 1) / PM, PT, smem, stream>>>(
      tmx, tmp, tmu, n, R, Rp, Dp / PK, tiles, out_row0, out, out_sq);
  return cudaGetLastError();
}

}  // namespace fvdb

// Bytes of scratch fvdb_project_rows needs at D and R: the split [3][Rp][Dp]
// bf16 and mu . P by 32-dim step [Dp / 32][Rp] f32.
FVDB_EXPORT long long fvdb_project_scratch_bytes(int D, int R) {
  using namespace fvdb;
  int tiles;
  const int w = pick_ntile(R, &tiles);
  const long long Rp = (long long)w * tiles, Dp = padded_dims(D);
  return 3 * Rp * Dp * 2 + Dp / (PW * PK) * Rp * 4;
}

// src [n, ld] bf16 (its first D columns the rows; ld a multiple of 8 and
// src 16-byte aligned, as TMA reads it), mu [D], p [D, R] f32 -> out [..,
// R] bf16 rows out_row0 .. out_row0 + n - 1 and their f32 norms out_sq;
// work: fvdb_project_scratch_bytes(D, R) bytes (16-byte aligned).
FVDB_EXPORT int fvdb_project_rows(const __nv_bfloat16* src, int n, int D,
                                  int ld, const float* mu, const float* p,
                                  int R, long long out_row0,
                                  __nv_bfloat16* out, float* out_sq,
                                  void* work, cudaStream_t stream) {
  using namespace fvdb;
  if (n < 1 || D < 1 || R < 1 || ld < D || ld % 8 != 0 ||
      reinterpret_cast<uintptr_t>(src) % 16 != 0 || work == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  int tiles;
  const int w = pick_ntile(R, &tiles);
  const int Rp = w * tiles, Dp = padded_dims(D);
  __nv_bfloat16* ps = static_cast<__nv_bfloat16*>(work);
  float* mup = reinterpret_cast<float*>(ps + 3 * (size_t)Rp * Dp);
  const long long tot = (long long)Rp * Dp;
  const int blocks = tot > 1024LL * NT ? 1024 : (int)((tot + NT - 1) / NT);
  split_kernel<<<blocks, NT, 0, stream>>>(p, mu, D, R, Dp, Rp, ps, mup);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
#define FVDB_PROJECT_TILE(W)                                              \
  case W:                                                                 \
    e = launch_mma<W>(src, n, ld, R, ps, mup, Rp, Dp, tiles, out_row0, out, \
                      out_sq, stream);                                    \
    break;
  switch (w) {
    FVDB_PROJECT_TILE(32)
    FVDB_PROJECT_TILE(64)
    FVDB_PROJECT_TILE(96)
    default: e = cudaErrorInvalidValue;
  }
#undef FVDB_PROJECT_TILE
  return static_cast<int>(e);
}

// q [n, D] f32 -> out [n, R] f32.
FVDB_EXPORT int fvdb_project_queries(const float* q, int n, int D,
                                     const float* mu, const float* p, int R,
                                     float* out, cudaStream_t stream) {
  using namespace fvdb;
  if (n < 1 || D < 1 || R < 1 || (R + QC - 1) / QC > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + QB - 1) / QB, (R + QC - 1) / QC);
  project_queries_kernel<<<grid, NT, 0, stream>>>(q, n, D, mu, p, R, out);
  return static_cast<int>(cudaGetLastError());
}
