// K7: kmeans|| seeding of the IVF quantizer, on the card.
//
// Replaces the JAX package's three seeding programs (ops/kmeans.py):
// _scalable_first (:130, the first pick and the initial min-distance
// table), _scalable_round (:150, a Gumbel-top-l weighted pick and the table
// update) and _scalable_weights (:140, each candidate's attracted
// population). The weighted k-means++ over the candidates stays on the host,
// as there.
//
//  * pick: the l rows of least key E_n / w_n, where E_n = -log(u_n) for a
//    uniform u_n from the caller's generator (clamped to [1e-20, 1 - 1e-7]),
//    w_n = max(d2_n, 1e-30) (or 1 for the first, unweighted pick), and rows
//    outside the mask or with d2 = 0 never enter. This is the exponential
//    race, the same draw as the reference's top-l of log w + Gumbel noise
//    (-log E is a Gumbel variable). The keys go through topk_select.cuh's
//    radix select; fewer eligible rows than l leave -1 at the end. With
//    unweighted_if_empty (k-means++, ops/kmeans.py:33), a weighted pick
//    that finds no row with mask and d2 > 0 takes the unweighted key E_n
//    over the mask instead (the reference's any_pos fallback, :54-56): the
//    key kernel raises a device flag where a row is eligible, and a second
//    pass rewrites the keys only where the flag stayed 0, so the host never
//    reads it. Without the flag the launches are those of kmeans||.
//  * min-update: d2_n = mask_n ? min(d2_n, min_j |c_j - x_n|^2) : 0 over the
//    candidate rows c_j = x[rows_j] (a row < 0 is skipped), the distance as
//    the reference computes it: max(|c|^2 - 2 c.x + |x|^2, 0).
//  * counts: each masked row's nearest candidate (the first of least
//    max(|x|^2 - 2 x.c + |c|^2, 0)) and an atomic histogram of them.
//
// What bounds it on the H100: a round at 256 lists is l = 409 candidates x
// 10,000 rows x 768 flops (3.1 GFLOP, 47 us at 67 TFLOP/s) over 15 MB of
// rows; the counts are 2,046 candidates (0.23 ms): f32 arithmetic. A
// k-means++ step is one pick and a min-update with one candidate: the N x D
// rows read once (30 us at N = 65,536, D = 384), so bytes bound it; the
// min-update's 32 x 128 tile then does 128 times the products it needs.
//
// Design: both distance kernels are a 32 x 128 tile product (4 x 4 results
// a thread, the candidate side gathered through its row indices into
// shared memory a 32-dim chunk at a time); a block owns 32 rows and walks
// every candidate tile, keeping each row's running minimum (or (distance,
// index) argmin) in registers, then a shuffle tree finishes the row. The
// norms of the block's rows and of each candidate tile are taken by warps
// into shared memory first.
#include "common.cuh"
#include "topk_select.cuh"

namespace fvdb {

constexpr int SQ = 32;   // rows a block
constexpr int SC = 128;  // candidates a tile
constexpr int SK = 32;   // dims a chunk

struct SeedSmem {
  float a[SK][SQ + 1];
  float b[SK][SC + 1];
  float a_sq[SQ];
  float b_sq[SC];
  int b_row[SC];
};

// E = -log(u), u clamped as above.
__device__ __forceinline__ float seed_exp(float u) {
  return -logf(fminf(fmaxf(u, 1e-20f), 1.f - 1e-7f));
}

// any (when not null) becomes 1 where a row is eligible.
__global__ void __launch_bounds__(NT) seed_key_kernel(
    const float* __restrict__ d2, const uint8_t* __restrict__ mask,
    const float* __restrict__ u, int N, int weighted,
    float* __restrict__ key, int* __restrict__ any) {
  const int i = blockIdx.x * NT + threadIdx.x;
  bool ok = false;
  if (i < N) {
    float k = INFINITY;
    ok = mask[i] && (!weighted || d2[i] > 0.f);
    if (ok) {
      const float e = seed_exp(u[i]);
      k = weighted ? e / fmaxf(d2[i], 1e-30f) : e;
    }
    key[i] = k;
  }
  if (any != nullptr && __any_sync(FULL, ok) && (threadIdx.x & 31) == 0)
    *any = 1;
}

// The unweighted keys over the mask, unless *any says a row was eligible.
__global__ void __launch_bounds__(NT) seed_fallback_kernel(
    const uint8_t* __restrict__ mask, const float* __restrict__ u, int N,
    const int* __restrict__ any, float* __restrict__ key) {
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= N || *any) return;
  key[i] = mask[i] ? seed_exp(u[i]) : INFINITY;
}

// acc[i][j] = x[n0 + ty*4 + i] . x[s.b_row[tx + 32 j]]; s.b_row holds the
// tile's candidate rows (-1: none). All NT threads call it.
__device__ __forceinline__ void seed_tile(const float* __restrict__ x,
                                          int n0, int an, int D, SeedSmem& s,
                                          float acc[4][4]) {
  const int t = threadIdx.x, tx = t & 31, ty = t >> 5;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < D; k0 += SK) {
    __syncthreads();
#pragma unroll
    for (int e = 0; e < SQ * SK / NT; ++e) {
      const int idx = t + e * NT, r = idx / SK, d = idx % SK;
      s.a[d][r] =
          (r < an && k0 + d < D) ? x[(size_t)(n0 + r) * D + k0 + d] : 0.f;
    }
#pragma unroll
    for (int e = 0; e < SC * SK / NT; ++e) {
      const int idx = t + e * NT, r = idx / SK, d = idx % SK;
      const int row = s.b_row[r];
      s.b[d][r] = (row >= 0 && k0 + d < D) ? x[(size_t)row * D + k0 + d] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < SK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = s.a[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = s.b[kk][tx + 32 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// The block's row norms (once) or a candidate tile's rows and norms.
__device__ __forceinline__ void seed_norms(const float* __restrict__ x,
                                           const int* rows, int n, int D,
                                           int first, float* out_sq,
                                           int* out_row) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = w; i < n; i += NT / 32) {
    const int row = rows ? rows[i] : first + i;
    const float v = row >= 0 ? warp_row_sq(x + (size_t)row * D, D) : 0.f;
    if (lane == 0) {
      out_sq[i] = v;
      if (out_row) out_row[i] = row;
    }
  }
}

// COUNT = false: d2 update; true: nearest candidate + histogram.
template <bool COUNT>
__global__ void __launch_bounds__(NT) seed_dist_kernel(
    const float* __restrict__ x, const uint8_t* __restrict__ mask,
    const int* __restrict__ cand, int C, int N, int D,
    const float* __restrict__ d2_in, float* __restrict__ d2_out,
    int* __restrict__ counts) {
  __shared__ SeedSmem s;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int n0 = blockIdx.x * SQ;
  const int an = min(SQ, N - n0);
  seed_norms(x, nullptr, an, D, n0, s.a_sq, nullptr);
  float best_d[4];
  int best_c[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    best_d[i] = INFINITY;
    best_c[i] = 0x7fffffff;
  }
  for (int c0 = 0; c0 < C; c0 += SC) {
    const int cn = min(SC, C - c0);
    __syncthreads();  // the last tile's b_row / b_sq are read
    for (int j = threadIdx.x; j < SC; j += NT)
      if (j >= cn) { s.b_row[j] = -1; s.b_sq[j] = 0.f; }
    seed_norms(x, cand + c0, cn, D, 0, s.b_sq, s.b_row);
    __syncthreads();
    float acc[4][4];
    seed_tile(x, n0, an, D, s, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float xs = s.a_sq[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = tx + 32 * j;
        if (s.b_row[cl] < 0) continue;
        const float cs = s.b_sq[cl];
        // the reference's operand order: |c|^2 - 2 c.x + |x|^2 for the
        // table, |x|^2 - 2 x.c + |c|^2 for the assignment
        const float d = COUNT ? sq_dist(xs, acc[i][j], cs)
                              : sq_dist(cs, acc[i][j], xs);
        if (lex_less(d, c0 + cl, best_d[i], best_c[i])) {
          best_d[i] = d;
          best_c[i] = c0 + cl;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      const float od = __shfl_xor_sync(FULL, best_d[i], off);
      const int oc = __shfl_xor_sync(FULL, best_c[i], off);
      if (lex_less(od, oc, best_d[i], best_c[i])) {
        best_d[i] = od;
        best_c[i] = oc;
      }
    }
    const int n = n0 + ty * 4 + i;
    if (n >= N || tx != 0) continue;
    const bool ok = mask[n] != 0;
    if constexpr (COUNT) {
      if (ok && best_c[i] < C) atomicAdd(&counts[best_c[i]], 1);
    } else {
      d2_out[n] = ok ? fminf(d2_in[n], best_d[i]) : 0.f;
    }
  }
}

inline int seed_blocks(int N) { return (N + SQ - 1) / SQ; }

}  // namespace fvdb

// The l rows of least key (see above) -> out_r [l] (-1 past the eligible
// rows). d2 [N] (ignored unless weighted), mask [N], u [N]; key [N] and
// out_d [l] scratch; work: fvdb_select_scratch_bytes(1, l) bytes. With
// unweighted_if_empty (weighted picks only), any is one int of scratch.
FVDB_EXPORT int fvdb_seed_pick(const float* d2, const uint8_t* mask,
                               const float* u, int N, int l, int weighted,
                               int unweighted_if_empty, int* any, float* key,
                               void* work, float* out_d, int* out_r,
                               cudaStream_t stream) {
  using namespace fvdb;
  if (N < 1 || l < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool fallback = weighted && unweighted_if_empty;
  if (fallback && any == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (N + NT - 1) / NT;
  cudaError_t e = cudaSuccess;
  if (fallback) e = cudaMemsetAsync(any, 0, sizeof(int), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  seed_key_kernel<<<blocks, NT, 0, stream>>>(d2, mask, u, N, weighted, key,
                                             fallback ? any : nullptr);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (fallback) {
    seed_fallback_kernel<<<blocks, NT, 0, stream>>>(mask, u, N, any, key);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(launch_select_topk(key, nullptr, nullptr, N, 1, l,
                                             work, out_d, out_r, stream));
}

// x [N, D], mask [N], cand [C] rows of x, d2_in [N] -> d2_out [N].
FVDB_EXPORT int fvdb_seed_min_update(const float* x, const uint8_t* mask,
                                     const int* cand, int C, int N, int D,
                                     const float* d2_in, float* d2_out,
                                     cudaStream_t stream) {
  using namespace fvdb;
  if (N < 1 || D < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  seed_dist_kernel<false><<<seed_blocks(N), NT, 0, stream>>>(
      x, mask, cand, C, N, D, d2_in, d2_out, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// x [N, D], mask [N], cand [C] rows of x -> counts [C] (zeroed here).
FVDB_EXPORT int fvdb_seed_counts(const float* x, const uint8_t* mask,
                                 const int* cand, int C, int N, int D,
                                 int* counts, cudaStream_t stream) {
  using namespace fvdb;
  if (N < 1 || D < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaMemsetAsync(counts, 0, sizeof(int) * C, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  seed_dist_kernel<true><<<seed_blocks(N), NT, 0, stream>>>(
      x, mask, cand, C, N, D, nullptr, nullptr, counts);
  return static_cast<int>(cudaGetLastError());
}
