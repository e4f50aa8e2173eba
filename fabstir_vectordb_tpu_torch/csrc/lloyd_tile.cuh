// K6's tile pass on the tensor cores: rows of x against 128 centroids a
// pass by TMA and three TF32 products a k8 step (csrc/lloyd.cu's head
// comment has the design), shared by K6 (the assignment, Lloyd), K7
// (kmeans||'s table update and the candidates' counts, csrc/kmeans_seed.cu)
// and K16's encode (csrc/pq.cu, over the mainloop's pieces below: a stage's
// load, wait and release, its A fragments, a k8 step's three products).
// One mainloop; assign_tc_kernel's epilogue (EPI) is a template parameter:
//  * TC_ASSIGN: assign [N] (-1 outside the mask) and d2 [N] (0 there);
//  * TC_LLOYD: each masked-in row added into its cluster's sums and count,
//    its distance and 1 into stats;
//  * TC_TABLE: d2 [N] lowered in place by a 32-bit atomicMin on its bits
//    (distances are clamped at +0, so their bits order as they do) to the
//    distance of the block's nearest centroid, taken again in f32 FMA from
//    the f32 rows (cents [C, D]) in the |c|^2 - 2 c.x + |x|^2 order (the
//    tensor cores' sums are cut: a row next to its centroid would keep
//    their error, ~2e-6 of |x|^2 at 384 dims);
//  * TC_NEAREST: best [N] lowered to the block's least (distance,
//    centroid), packed as (distance bits << 32 | centroid), by a 64-bit
//    atomicMin, in the |x|^2 - 2 x.c + |c|^2 order.
// TABLE and NEAREST take masked-in rows only, and may split the centroid
// passes over gridDim.y (the merges are atomic), so a few row tiles still
// fill the card; ASSIGN and LLOYD keep every pass in one block.
#pragma once

#include "common.cuh"
#include "wgmma.cuh"

namespace fvdb {

constexpr int TC_ASSIGN = 0;
constexpr int TC_LLOYD = 1;
constexpr int TC_TABLE = 2;
constexpr int TC_NEAREST = 3;

// A warp's error and row count (summed across its lanes) into stats[0]
// and stats[1]: one atomic each a warp, not one a row.
__device__ __forceinline__ void add_stats(float err, float rows,
                                          float* __restrict__ stats) {
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    err += __shfl_xor_sync(FULL, err, off);
    rows += __shfl_xor_sync(FULL, rows, off);
  }
  if ((threadIdx.x & 31) == 0 && rows > 0.f) {
    atomicAdd(&stats[0], err);
    atomicAdd(&stats[1], rows);
  }
}

// One thread's |a|^2 and, with DOT, a.b over two rows of D floats (D % 4 ==
// 0, 16-byte aligned): a.b one FMA after another over the dims, as an f32
// matrix product and the FMA tile sum it; |a|^2 in eight parts (16-byte
// group g into part g % 8, one FMA after another) added pairwise. Eight
// groups' loads go out together. The table's gather takes a candidate's
// |c|^2 by the same call, so a row is at distance exactly 0 from itself.
template <bool DOT>
__device__ __forceinline__ void row_dot_sq(const float* __restrict__ a,
                                           const float* __restrict__ b,
                                           int D, float& dot, float& sq) {
  float p[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  dot = 0.f;
  const int G = D >> 2;
  for (int g0 = 0; g0 < G; g0 += 8) {
    float4 va[8], vb[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const bool in = g0 + k < G;
      va[k] = in ? ld4(a + 4 * (g0 + k)) : make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (DOT)
        vb[k] = in ? ld4(b + 4 * (g0 + k)) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (g0 + k >= G) break;
      if constexpr (DOT) {
        dot = fmaf(va[k].x, vb[k].x, dot);
        dot = fmaf(va[k].y, vb[k].y, dot);
        dot = fmaf(va[k].z, vb[k].z, dot);
        dot = fmaf(va[k].w, vb[k].w, dot);
      }
      p[k] = fmaf(va[k].x, va[k].x, p[k]);
      p[k] = fmaf(va[k].y, va[k].y, p[k]);
      p[k] = fmaf(va[k].z, va[k].z, p[k]);
      p[k] = fmaf(va[k].w, va[k].w, p[k]);
    }
  }
  sq = ((p[0] + p[1]) + (p[2] + p[3])) + ((p[4] + p[5]) + (p[6] + p[7]));
}

constexpr int LT_ROWS = 128;                  // rows of x a block
constexpr int LT_CENTS = 128;                 // centroids a pass
constexpr int LT_K = 32;                      // f32 dims a stage
constexpr int LT_TILE = 128 * LT_K * 4;       // a 128 x 32 f32 tile: 16 KB
constexpr int LT_STAGE = 3 * LT_TILE;         // rows, big, small parts
constexpr int LT_STAGES = 4;
constexpr int LT_CONSUMERS = 256;             // two warpgroups
constexpr int LT_THREADS = LT_CONSUMERS + 32;  // and a producer warp
constexpr int LT_SMEM = LT_STAGES * LT_STAGE + 1024;  // + the alignment

// The centroids' TF32 parts: big = tf32(c), small = tf32(c - big), each
// [n] (n = C * D) in its half of parts [2, n].
__global__ void split_tf32_kernel(const float* __restrict__ c, long long n,
                                  float* __restrict__ parts) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float v = c[i];
    const uint32_t big = tf32_rna(v);
    parts[i] = __uint_as_float(big);
    parts[n + i] = __uint_as_float(tf32_rna(v - __uint_as_float(big)));
  }
}

// The mainloop's pieces, shared by assign_tc_kernel and K16's encode
// (csrc/pq.cu): a ring of LT_STAGES stages, each a 128 x 32 f32 box of x
// and the same box of the centroids' two parts (big, small), filled by the
// producer warp's one lane by TMA and emptied by the two consumer
// warpgroups, each k8 step three TF32 products.

// Stage g of the block's sequence into its slot: the x box at (column k0,
// row n0) and the parts' boxes at (k0, centroid c0), once the consumers
// are done with the slot's last use. extra: bytes the caller copies into
// its own slot on the same barrier (K16's |c|^2).
__device__ __forceinline__ void tc_load_stage(
    const CUtensorMap* tmx, const CUtensorMap* tmb, const CUtensorMap* tms,
    unsigned char* ring, uint64_t* full, uint64_t* empty, int g, int k0,
    int n0, int c0, int extra = 0) {
  const int slot = g % LT_STAGES, use = g / LT_STAGES;
  if (use > 0) mbar_wait(empty + slot, (use - 1) & 1);
  mbar_expect(full + slot, LT_STAGE + extra);
  const uint32_t dst = smem_addr(ring + slot * LT_STAGE);
  tma_load_2d(dst, tmx, k0, n0, full + slot);
  tma_load_2d(dst + LT_TILE, tmb, k0, c0, full + slot);
  tma_load_2d(dst + 2 * LT_TILE, tms, k0, c0, full + slot);
}

// A consumer's wait for stage g; the stage's base.
__device__ __forceinline__ const unsigned char* tc_wait_stage(
    unsigned char* ring, uint64_t* full, int g) {
  const int slot = g % LT_STAGES;
  mbar_wait(full + slot, (g / LT_STAGES) & 1);
  return ring + slot * LT_STAGE;
}

// The stage's slot handed back to the producer (each warp once).
__device__ __forceinline__ void tc_release_stage(uint64_t* empty, int g) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(empty + g % LT_STAGES);
}

// This thread's A values of k8 step j of the stage: v[e] is row rloc (e
// even) or rloc + 8 (e odd), dim 8 j + lane % 4 + 4 (e / 2) of the box.
__device__ __forceinline__ void tc_fragments_k8(const unsigned char* st,
                                                int rloc, int lane, int j,
                                                float (&v)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = rloc + 8 * (e & 1);
    const int col = 8 * j + (lane & 3) + 4 * (e >> 1);
    v[e] = *reinterpret_cast<const float*>(st + sw128(r, col >> 2) +
                                           (col & 3) * 4);
  }
}

// The same for the stage's 4 k8 steps: v[j] as tc_fragments_k8's.
__device__ __forceinline__ void tc_fragments(const unsigned char* st,
                                             int rloc, int lane,
                                             float (&v)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) tc_fragments_k8(st, rloc, lane, j, v[j]);
}

// A k8 step's A values split into TF32 big and small parts.
__device__ __forceinline__ void tc_split(const float (&v)[4],
                                         uint32_t (&ab)[4],
                                         uint32_t (&as)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    ab[e] = tf32_rna(v[e]);
    as[e] = tf32_rna(v[e] - __uint_as_float(ab[e]));
  }
}

// k8 step j of the stage at st: pb = big.big + small.big + big.small of the
// warpgroup's 64 rows against the stage's 128 centroids (pb overwritten;
// the tensor cores cut a chain's sums at its partial sum's size, so K6
// adds pb to its f32 sums). accum: the products added onto pb on the
// tensor cores, each add cut at the running total (~2^-23 of it: K16's
// encode, which takes its near-ties again by f32 FMA).
__device__ __forceinline__ void tc_k8(float (&pb)[64],
                                      const uint32_t (&ab)[4],
                                      const uint32_t (&as)[4],
                                      const unsigned char* st, int j,
                                      int accum = 0) {
  const uint64_t db = sw128_desc(smem_addr(st + LT_TILE)) + 2 * j;
  const uint64_t ds = sw128_desc(smem_addr(st + 2 * LT_TILE)) + 2 * j;
  fence_regs(pb);
  wgmma_fence();
  WgmmaTF32<128>::mma(pb, ab, db, accum);
  WgmmaTF32<128>::mma(pb, as, db, 1);
  WgmmaTF32<128>::mma(pb, ab, ds, 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(pb);
}

// The tile pass with epilogue EPI (above): tmx maps x [N, D], tmb / tms the
// centroids' big / small parts [C, D], each in 128 x 32 boxes, 128-byte
// swizzled. Block (bx, by) takes rows 128 bx.. and its share of the
// centroid passes: all of them when gridDim.y is 1.
template <int EPI>
__global__ void __launch_bounds__(LT_THREADS, 1) assign_tc_kernel(
    const __grid_constant__ CUtensorMap tmx,
    const __grid_constant__ CUtensorMap tmb,
    const __grid_constant__ CUtensorMap tms, const float* __restrict__ x,
    const uint8_t* __restrict__ mask, const float* __restrict__ cents,
    const float* __restrict__ c_sq, int N, int C, int D,
    int* __restrict__ assign, float* __restrict__ d2,
    float* __restrict__ sums, float* __restrict__ counts,
    float* __restrict__ stats, unsigned long long* __restrict__ best) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[LT_STAGES], empty[LT_STAGES];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int t = threadIdx.x;
  const int n0 = blockIdx.x * LT_ROWS;
  const int KS = (D + LT_K - 1) / LT_K, CT = (C + LT_CENTS - 1) / LT_CENTS;
  const int per = (CT + gridDim.y - 1) / gridDim.y;
  const int ct0 = blockIdx.y * per, ct1 = min(CT, ct0 + per);
  if (ct0 >= ct1) return;  // uniform: a split past the passes
  if (t == 0) {
    for (int s = 0; s < LT_STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, LT_CONSUMERS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (t >= LT_CONSUMERS) {  // the producer warp: one lane issues the copies
    if (t == LT_CONSUMERS) {
      for (int g = 0; g < (ct1 - ct0) * KS; ++g)
        tc_load_stage(&tmx, &tmb, &tms, ring, full, empty, g,
                      (g % KS) * LT_K, n0, (ct0 + g / KS) * LT_CENTS);
    }
    return;
  }

  const int wg = t >> 7, w = t >> 5, lane = t & 31;
  const int rloc = wg * 64 + (w & 3) * 16 + (lane >> 2);  // rows rloc, +8
  // |x|^2 of the two rows, from the fragments of the block's first pass
  // (the four lanes of a quad hold a stage's 32 dims of them), summed by
  // the quad
  float xs[2] = {0.f, 0.f}, best_d[2];
  int best_c[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    best_d[h] = INFINITY;
    best_c[h] = 0x7fffffff;
  }
  int g = 0;  // the block's stage, as the producer counts them
  for (int ct = ct0; ct < ct1; ++ct) {
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int kc = 0; kc < KS; ++kc, ++g) {
      const unsigned char* st = tc_wait_stage(ring, full, g);
      float v[4][4];
      tc_fragments(st, rloc, lane, v);
      uint32_t ab[4][4], as[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (ct == ct0)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            xs[e & 1] = fmaf(v[j][e], v[j][e], xs[e & 1]);
        tc_split(v[j], ab[j], as[j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float pb[64];
        tc_k8(pb, ab[j], as[j], st, j);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += pb[i];
      }
      tc_release_stage(empty, g);
    }
    if (ct == ct0)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        xs[h] += __shfl_xor_sync(FULL, xs[h], 1);
        xs[h] += __shfl_xor_sync(FULL, xs[h], 2);
      }
    // thread lane of warp w holds rows rloc (h = 0) and rloc + 8 (h = 1),
    // centroids c0 + 8 (i / 4) + 2 (lane % 4) + i % 2
    const int c0 = ct * LT_CENTS;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int h = (i >> 1) & 1;
      const int c = c0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      if (c < C) {
        const float cs = __ldg(c_sq + c);
        // TABLE / NEAREST clamp -0 to +0, so the distance's bits order
        const float d = EPI == TC_TABLE    ? sq_dist(cs, acc[i], xs[h])
                        : EPI == TC_NEAREST ? sq_dist(xs[h], acc[i], cs)
                                            : fmaxf(xs[h] - 2.f * acc[i] + cs,
                                                    0.f);
        if (lex_less(d, c, best_d[h], best_c[h])) {
          best_d[h] = d;
          best_c[h] = c;
        }
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float od = __shfl_xor_sync(FULL, best_d[h], off);
      const int oc = __shfl_xor_sync(FULL, best_c[h], off);
      if (lex_less(od, oc, best_d[h], best_c[h])) {
        best_d[h] = od;
        best_c[h] = oc;
      }
    }
  if constexpr (EPI == TC_NEAREST) {
    if ((lane & 3) == 0)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = n0 + rloc + 8 * h;
        if (n >= N || (mask != nullptr && !mask[n])) continue;
        atomicMin(best + n,
                  (static_cast<unsigned long long>(
                       __float_as_uint(best_d[h])) << 32) |
                      static_cast<unsigned>(best_c[h]));
      }
    return;
  }
  if constexpr (EPI == TC_ASSIGN) {
    if ((lane & 3) == 0)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = n0 + rloc + 8 * h;
        if (n >= N) continue;
        const bool ok = mask == nullptr || mask[n];
        assign[n] = ok ? best_c[h] : -1;
        d2[n] = ok ? best_d[h] : 0.f;
      }
    return;
  }
  if constexpr (EPI == TC_TABLE) {
    // the distance to the block's nearest centroid again by f32 FMA
    // (row_dot_sq: c.x summed as an f32 matrix product sums it, so the rows
    // next to a centroid keep the plain version's rounding, not the tensor
    // cores' ~2e-6 of |x|^2), lanes 0-15 of a warp a row each
    const int rbase = n0 + wg * 64 + (w & 3) * 16;
    const int qd = lane & 7, hh = (lane >> 3) & 1;
    const int c0 = __shfl_sync(FULL, best_c[0], 4 * qd);
    const int c1 = __shfl_sync(FULL, best_c[1], 4 * qd);
    const float b0 = __shfl_sync(FULL, best_d[0], 4 * qd);
    const float b1 = __shfl_sync(FULL, best_d[1], 4 * qd);
    const float s0 = __shfl_sync(FULL, xs[0], 4 * qd);
    const float s1 = __shfl_sync(FULL, xs[1], 4 * qd);
    const int n = rbase + qd + 8 * hh, c = hh ? c1 : c0;
    if (lane >= 16 || n >= N || (mask != nullptr && !mask[n])) return;
    // a distance above the row's d2 by more than the tensor cores' error
    // (~2e-6 of |x|^2 + |c|^2; 1e-5 kept) cannot lower it: no recompute.
    // Other blocks lower d2 meanwhile; a stale value only skips less.
    const float cs = __ldg(c_sq + c);
    if ((hh ? b1 : b0) - 1e-5f * ((hh ? s1 : s0) + cs) > __ldcg(d2 + n))
      return;
    float dot, xx;
    row_dot_sq<true>(x + (size_t)n * D, cents + (size_t)c * D, D, dot, xx);
    atomicMin(reinterpret_cast<unsigned*>(d2) + n,
              __float_as_uint(sq_dist(cs, dot, xx)));
    return;
  }
  // TC_LLOYD: the warp's 16 rows one at a time: the whole warp adds the row
  // into its cluster's sums, four dims a lane per 128 (one 16-byte atomic
  // where the sums are 16-byte aligned). The error takes the row's distance
  // to its centroid again with the dot product by f32 FMA: the tensor
  // cores' sums are cut, not rounded, and their bias (~2^-23 of |x|.|c| a
  // k8 product) would not average out over the rows as the FMA tile's
  // rounding does (the mean error of rows at |x|^2 ~ 6,000 and d2 ~ 1 moved
  // ~1e-3).
  const int rbase = n0 + wg * 64 + (w & 3) * 16;
  const bool vec = (reinterpret_cast<uintptr_t>(sums) & 15) == 0;
  float err = 0.f, rows = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h)
    for (int qd = 0; qd < 8; ++qd) {
      const int c = __shfl_sync(FULL, best_c[h], 4 * qd);
      const float xq = __shfl_sync(FULL, xs[h], 4 * qd);
      const int n = rbase + qd + 8 * h;
      if (n >= N || (mask != nullptr && !mask[n])) continue;  // uniform
      const float* xr = x + (size_t)n * D;
      const float* cr = cents + (size_t)c * D;
      float* sr = sums + (size_t)c * D;
      float dot = 0.f;
      for (int d = 4 * lane; d < D; d += 128) {
        const float4 v = ld4(xr + d);
        const float4 cv = ld4(cr + d);
        dot = fmaf(v.x, cv.x, dot);
        dot = fmaf(v.y, cv.y, dot);
        dot = fmaf(v.z, cv.z, dot);
        dot = fmaf(v.w, cv.w, dot);
        if (vec) {
          atomicAdd(reinterpret_cast<float4*>(sr + d), v);
        } else {
          atomicAdd(sr + d, v.x);
          atomicAdd(sr + d + 1, v.y);
          atomicAdd(sr + d + 2, v.z);
          atomicAdd(sr + d + 3, v.w);
        }
      }
#pragma unroll
      for (int off = 16; off; off >>= 1) dot += __shfl_xor_sync(FULL, dot, off);
      if (lane == 0) {
        atomicAdd(&counts[c], 1.f);
        err += fmaxf(xq - 2.f * dot + __ldg(c_sq + c), 0.f);
        rows += 1.f;
      }
    }
  add_stats(err, rows, stats);
}

// The tensor maps of a call: x [N, D] and the centroids' two parts [C, D]
// in 128 x 32 boxes, 128-byte swizzled.
struct LloydMaps {
  CUtensorMap x, big, small;
};

inline cudaError_t lloyd_maps(const float* x, int N, const float* parts,
                              int C, int D, LloydMaps* m) {
  if (D % 4 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(parts) % 16 != 0)
    return cudaErrorInvalidValue;
  if ((N > 0 && !tile_map(&m->x, x, false, N, D, D, LT_ROWS, LT_K, true)) ||
      !tile_map(&m->big, parts, false, C, D, D, LT_CENTS, LT_K, true) ||
      !tile_map(&m->small, parts + (size_t)C * D, false, C, D, D, LT_CENTS,
                LT_K, true))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// The tile pass with epilogue EPI over x [N, D] against the C centroids
// whose split parts maps holds (c_sq their norms; cents the f32 rows, read
// by TC_LLOYD and TC_TABLE), the centroid passes split over `splits`
// blocks.
template <int EPI>
inline cudaError_t launch_tc(const LloydMaps& maps, const float* x,
                             const uint8_t* mask, const float* cents,
                             const float* c_sq, int N, int C, int D,
                             int splits, int* assign, float* d2, float* sums,
                             float* counts, float* stats,
                             unsigned long long* best, cudaStream_t stream) {
  static int cap[64];
  cudaError_t e = raise_smem_cap(
      reinterpret_cast<const void*>(assign_tc_kernel<EPI>), LT_SMEM, cap);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + LT_ROWS - 1) / LT_ROWS, splits);
  assign_tc_kernel<EPI><<<grid, LT_THREADS, LT_SMEM, stream>>>(
      maps.x, maps.big, maps.small, x, mask, cents, c_sq, N, C, D, assign,
      d2, sums, counts, stats, best);
  return cudaGetLastError();
}

}  // namespace fvdb
