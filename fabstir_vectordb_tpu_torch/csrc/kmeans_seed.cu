// K7: k-means++ and kmeans|| seeding, on the card.
//
// Replaces the JAX package's seeding programs (ops/kmeans.py):
// kmeans_pp_init (:33, a lax.scan of C picks; pq_train vmaps it over the
// subspaces, ops/quantization.py:59), and kmeans||'s _scalable_first (:130,
// the first pick and the initial min-distance table), _scalable_round (:150,
// a Gumbel-top-l weighted pick and the table update) and _scalable_weights
// (:140, each candidate's attracted population). kmeans||'s weighted
// k-means++ over the candidates stays on the host, as there.
//
//  * The draw is the exponential race: of the rows eligible, the one (or
//    the l) of least key E_n / w_n, where E_n = -log(u_n) for a uniform
//    u_n (clamped to [1e-20, 1 - 1e-7]), w_n = max(d2_n, 1e-30) (or 1 for
//    an unweighted pick); rows outside the mask or with d2 = 0 never enter
//    a weighted pick. It is the same draw as the reference's categorical /
//    top-l of log w + Gumbel noise (-log E is a Gumbel variable). Ties go
//    to the lower row.
//  * The table update: d2_n = mask_n ? min(d2_n, min_j |c_j - x_n|^2) : 0,
//    the distance as the reference computes it, max(|c|^2 - 2 c.x + |x|^2,
//    0).
//
// k-means++ (fvdb_kmeans_pp): C picks in one cooperative launch, for M
// subspaces of x [N, M Ds] at once (kmeans_pp_init is M = 1; pq_train's
// seeding is every subspace in one launch). Its uniforms come from
// Philox4x32-10 keyed by a 64-bit seed, counter (row / 4, step, subspace,
// 0), word row % 4, so a draw depends on (seed, subspace, step, row) alone;
// ops/kmeans.py's plain version computes the same integers. The first pick
// is unweighted over the mask; each later one is weighted by d2 over rows
// with d2 > 0, or unweighted over the mask where there is none (the
// reference's any_pos fallback). Bound on the H100: each of the C - 1
// updates reads the N x M Ds rows once (7.7 ms at N = 65,536, 384 dims and
// C = 256, at 3.35 TB/s), and C grid barriers follow one another.
//  * One block an SM of up to 1,024 threads, each owning rows_pb rows (a
//    multiple of 4); their d2 [rows_pb, M] sit in shared memory where they
//    fit, else in global scratch. Everything a step needs stays on the
//    card: no host call between the picks.
//  * A step: (A) the picked rows' subspace parts c (one row each) and
//    |c|^2 are in shared memory; teams of L lanes (L the largest power of
//    two <= 32 that divides a subspace's 16-byte vectors) stream the
//    block's (row, subspace) units with 16-byte loads (4-byte loads where
//    Ds % 4 != 0), four units a team in flight, fold c.x and |x|^2 over
//    the team by shuffles, and lower d2 (a unit whose d2 is already 0 is
//    not read: it stays 0). |c|^2 is summed by a team in the same order as
//    |x|^2, so a picked row (or a copy of it) is at distance exactly 0.
//    (B) The keys, four rows a Philox call: the weighted key over mask and
//    d2 > 0, the unweighted key E over the mask, each packed as (key bits
//    << 32 | row) (non-negative floats order as their bits), folded to the
//    block's least per subspace in shared memory and then into global
//    minima by 64-bit atomicMin.
//    (C) A grid barrier; every block reads the minima and takes the
//    weighted pick, or the unweighted one where no row was eligible, and
//    block 0 writes it. The minima are three buffers deep: block 0 resets
//    the one the next step uses, which no block reads any more.
//  * There is no update after the last pick.
//
// kmeans|| (the pick, fvdb_seed_pick; the table update, fvdb_seed_min_update;
// the counts, fvdb_seed_counts):
//  * pick: the l rows of least key through topk_select.cuh's radix select;
//    fewer eligible rows than l leave -1 at the end.
//  * The table update over the candidate rows c_j = x[cand_j] (cand_j < 0
//    skipped) and the counts (how many masked rows have each candidate as
//    their nearest, the first of least max(|x|^2 - 2 x.c + |c|^2, 0)) run
//    on K6's tensor-core tile pass (lloyd_tile.cuh, three TF32 products)
//    where ops/kmeans.py's lloyd_route sends C candidates of D dims (D % 4
//    == 0, C >= 64, x 16-byte aligned): the candidates are gathered into
//    scratch [C, D] and split into TF32 parts once (a skipped one is zeros
//    with |c|^2 = +inf, so it is never the least); the pass's TABLE
//    epilogue lowers d2_out (set to mask ? d2_in : 0 by the gather) by a
//    32-bit atomicMin a row to the distance of the block's nearest
//    candidate taken again by f32 FMA from the gathered f32 rows (the
//    tensor cores' error, ~2e-6 of |x|^2, would stay in rows next to a
//    candidate), its NEAREST epilogue lowers each row's packed
//    (distance, candidate) by a 64-bit atomicMin, and a last kernel adds
//    the rows' winners into the histogram. The candidate passes (128
//    candidates each) are split over blocks, one a block, so 10,000 rows
//    (79 row tiles) still fill the card. Bound at N = 10,000, D = 384: l =
//    409 candidates are 3.1 GFLOP and 2,046 are 15.7 GFLOP, 0.019 / 0.095
//    ms as three TF32 products at 495 TFLOP/s.
//  * Other shapes (D % 4 != 0; C < 64, such as kmeans||'s first
//    one-candidate update and the flat tier's 3 lists) keep the FMA route:
//    a 32 x 128 tile product (4 x 4 results a thread, the candidate side
//    gathered through its row indices into shared memory a 32-dim chunk at
//    a time); a block owns 32 rows and walks every candidate tile, keeping
//    each row's running minimum (or (distance, index) argmin) in
//    registers, then a shuffle tree finishes the row.
#include "common.cuh"
#include "grid_barrier.cuh"
#include "lloyd_tile.cuh"
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

__global__ void __launch_bounds__(NT) seed_key_kernel(
    const float* __restrict__ d2, const uint8_t* __restrict__ mask,
    const float* __restrict__ u, int N, int weighted,
    float* __restrict__ key) {
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= N) return;
  float k = INFINITY;
  if (mask[i] && (!weighted || d2[i] > 0.f)) {
    const float e = seed_exp(u[i]);
    k = weighted ? e / fmaxf(d2[i], 1e-30f) : e;
  }
  key[i] = k;
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

// ---- k-means++ in one launch

// Philox4x32-10 (Salmon et al., SC'11) of counter c under key (k0, k1).
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, unsigned k0,
                                               unsigned k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

// A 32-bit word as a uniform in (0, 1): (2 (w >> 9) + 1) / 2^24, exact in
// f32 (no rounding, so the plain version's integers give the same float).
__device__ __forceinline__ float pp_uniform(unsigned w) {
  return __uint2float_rn(((w >> 9) << 1) | 1u) * 0x1p-24f;
}

__device__ __forceinline__ unsigned pick_word(const uint4& r, int j) {
  return j == 0 ? r.x : j == 1 ? r.y : j == 2 ? r.z : r.w;
}

// (key bits << 32 | row): a non-negative key's bits order as the key.
__device__ __forceinline__ unsigned long long pp_pack(float key, int row) {
  return (static_cast<unsigned long long>(__float_as_uint(key)) << 32) |
         static_cast<unsigned>(row);
}

constexpr int PP_THREADS = 1024;  // threads a block, at most
constexpr int PP_UNITS = 4;       // units a team has in flight
constexpr unsigned long long PP_NONE = ~0ull;
constexpr unsigned INF_BITS = 0x7f800000u;

struct PPArgs {
  const float* x;        // [N, D], D = M * Ds
  const uint8_t* mask;   // [N]
  int N, D, M, Ds, C;
  unsigned k0, k1;       // the Philox key
  int rows_pb;           // rows a block (a multiple of 4)
  int lanes;             // L: lanes of a team
  int warp_fold;         // every key of thread t is of subspace t % M, M | 32
  int d2_smem;           // the block's d2 in shared memory
  float* d2g;            // else [N, M] in global memory
  unsigned long long* keys;  // [3][M][2] (weighted, unweighted) minima
  unsigned* bar;         // the grid barrier's two words
  int* rows;             // [M, C] out
};

// Shared memory: the block's minima bk [M][2], the picked rows' parts cvec
// [D], their norms cs [M], the picks [M], then d2 [rows_pb, M] if it fits.
inline size_t pp_smem_fixed(int D, int M) {
  return (size_t)M * 16 + (size_t)D * 4 + (size_t)M * 8;
}

template <int VW>
__device__ __forceinline__ void pp_load(const float* p, float (&v)[VW]) {
  if constexpr (VW == 4) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  } else {
    v[0] = __ldg(p);
  }
}

// VW: floats a load (4 where Ds % 4 == 0 and x is 16-byte aligned, else 1).
template <int VW>
__global__ void __launch_bounds__(PP_THREADS, 1)
    kmeans_pp_kernel(const PPArgs a) {
  extern __shared__ __align__(16) unsigned char pp_smem[];
  unsigned long long* bk = reinterpret_cast<unsigned long long*>(pp_smem);
  float* cvec = reinterpret_cast<float*>(bk + 2 * a.M);
  float* cs = cvec + a.D;
  int* pick = reinterpret_cast<int*>(cs + a.M);
  const int T = blockDim.x, t = threadIdx.x, lane = t & 31;
  const int r0 = blockIdx.x * a.rows_pb;
  const int nrows = min(a.N, r0 + a.rows_pb) - r0;
  const int units = nrows * a.M;
  float* d2 = a.d2_smem ? reinterpret_cast<float*>(pick + a.M)
                        : a.d2g + (size_t)r0 * a.M;
  for (int u = t; u < units; u += T) d2[u] = INFINITY;
  for (int i = t; i < 2 * a.M; i += T) bk[i] = PP_NONE;
  const float* xb = a.x + (size_t)r0 * a.D;  // unit u at xb + u * Ds
  const int L = a.lanes, TB = T / L, tau = t / L, lt = t % L;
  const int V = a.Ds / (VW * L);  // loads a lane a unit
  __syncthreads();

  for (int step = 0; step < a.C; ++step) {
    if (step > 0) {  // (A) d2 against the last picks
      for (int base = 0; base < units; base += PP_UNITS * TB) {
        float dot[PP_UNITS], sq[PP_UNITS];
        bool live[PP_UNITS];
#pragma unroll
        for (int q = 0; q < PP_UNITS; ++q) {
          const int u = base + tau + q * TB;
          live[q] = u < units && d2[u] != 0.f;
          dot[q] = sq[q] = 0.f;
        }
        for (int k = 0; k < V; ++k) {
          const int off = VW * (k * L + lt);
          float v[PP_UNITS][VW];
#pragma unroll
          for (int q = 0; q < PP_UNITS; ++q) {
            const int u = base + tau + q * TB;
            if (live[q]) {
              pp_load<VW>(xb + (size_t)u * a.Ds + off, v[q]);
            } else {
#pragma unroll
              for (int e = 0; e < VW; ++e) v[q][e] = 0.f;
            }
          }
#pragma unroll
          for (int q = 0; q < PP_UNITS; ++q) {
            const int u = base + tau + q * TB;
            const float* c = cvec + (live[q] ? (u % a.M) * a.Ds : 0) + off;
#pragma unroll
            for (int e = 0; e < VW; ++e) {
              dot[q] = fmaf(v[q][e], c[e], dot[q]);
              sq[q] = fmaf(v[q][e], v[q][e], sq[q]);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < PP_UNITS; ++q)
          for (int o = L >> 1; o > 0; o >>= 1) {
            dot[q] += __shfl_xor_sync(FULL, dot[q], o);
            sq[q] += __shfl_xor_sync(FULL, sq[q], o);
          }
        if (lt == 0)
#pragma unroll
          for (int q = 0; q < PP_UNITS; ++q) {
            if (!live[q]) continue;
            const int u = base + tau + q * TB;
            const float dist = sq_dist(cs[u % a.M], dot[q], sq[q]);
            d2[u] = a.mask[r0 + u / a.M] ? fminf(d2[u], dist) : 0.f;
          }
      }
      __syncthreads();
    }

    // (B) the keys, four rows a Philox call
    unsigned long long wb = PP_NONE, ub = PP_NONE;
    int cur = -1;
    const int items = ((nrows + 3) >> 2) * a.M;
    for (int w = t; w < items; w += T) {
      const int m = w % a.M, q = w / a.M;
      if (m != cur) {
        if (cur >= 0) {
          atomicMin(bk + 2 * cur, wb);
          atomicMin(bk + 2 * cur + 1, ub);
        }
        cur = m;
        wb = ub = PP_NONE;
      }
      const uint4 r = philox4x32_10(
          make_uint4(static_cast<unsigned>((r0 >> 2) + q),
                     static_cast<unsigned>(step), static_cast<unsigned>(m),
                     0u),
          a.k0, a.k1);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int lr = 4 * q + j, n = r0 + lr;
        if (lr >= nrows || !a.mask[n]) continue;
        const float e = seed_exp(pp_uniform(pick_word(r, j)));
        ub = min(ub, pp_pack(e, n));
        if (step > 0) {
          const float dv = d2[lr * a.M + m];
          if (dv > 0.f) wb = min(wb, pp_pack(e / fmaxf(dv, 1e-30f), n));
        }
      }
    }
    if (a.warp_fold) {
      for (int o = 16; o >= a.M; o >>= 1) {
        wb = min(wb, __shfl_xor_sync(FULL, wb, o));
        ub = min(ub, __shfl_xor_sync(FULL, ub, o));
      }
      if (lane < a.M) {
        atomicMin(bk + 2 * lane, wb);
        atomicMin(bk + 2 * lane + 1, ub);
      }
    } else if (cur >= 0) {
      atomicMin(bk + 2 * cur, wb);
      atomicMin(bk + 2 * cur + 1, ub);
    }
    __syncthreads();
    unsigned long long* gk = a.keys + (size_t)(step % 3) * 2 * a.M;
    for (int i = t; i < 2 * a.M; i += T) {
      if (bk[i] != PP_NONE) atomicMin(gk + i, bk[i]);
      bk[i] = PP_NONE;
    }
    if (blockIdx.x == 0) {  // the buffer of step + 1, last read at step - 2
      unsigned long long* nk = a.keys + (size_t)((step + 1) % 3) * 2 * a.M;
      for (int i = t; i < 2 * a.M; i += T) nk[i] = PP_NONE;
    }

    // (C) the barrier, then every block takes the picks
    grid_barrier(a.bar, gridDim.x);
    for (int m = t; m < a.M; m += T) {
      const unsigned long long wk = __ldcg(gk + 2 * m);
      const unsigned long long k =
          (wk >> 32) < INF_BITS ? wk : __ldcg(gk + 2 * m + 1);
      const int p = (k >> 32) < INF_BITS ? static_cast<int>(k & 0xffffffffu)
                                         : -1;
      pick[m] = p;
      if (blockIdx.x == 0) a.rows[(size_t)m * a.C + step] = p;
    }
    if (step + 1 == a.C) break;
    __syncthreads();
    for (int d = t; d < a.D; d += T) {
      const int p = pick[d / a.Ds];
      cvec[d] = p >= 0 ? __ldg(a.x + (size_t)p * a.D + d) : 0.f;
    }
    __syncthreads();
    // |c|^2 by the teams, in the order (A) sums |x|^2 in, so a row's
    // distance to itself (or to a copy) is exactly 0 and stays out of the
    // weighted draw
    for (int mb = 0; mb < a.M; mb += TB) {
      const int m = mb + tau;
      float s = 0.f;
      for (int k = 0; k < V && m < a.M; ++k) {
        const float* c = cvec + m * a.Ds + VW * (k * L + lt);
#pragma unroll
        for (int e = 0; e < VW; ++e) s = fmaf(c[e], c[e], s);
      }
      for (int o = L >> 1; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
      if (lt == 0 && m < a.M) cs[m] = s;
    }
    __syncthreads();
  }
}

// The uniforms of (subspace, step) for rows 0..N-1 by the Philox routine
// and counter layout kmeans_pp_kernel draws through, for the checks against
// the plain version's (the fused kernel's own draws are covered by its
// picks).
__global__ void pp_uniform_kernel(unsigned k0, unsigned k1, int sub,
                                  int step, int N, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const uint4 r = philox4x32_10(
      make_uint4(static_cast<unsigned>(i >> 2), static_cast<unsigned>(step),
                 static_cast<unsigned>(sub), 0u),
      k0, k1);
  out[i] = pp_uniform(pick_word(r, i & 3));
}

inline size_t pp_scratch_bytes(int N, int M) {
  return 8 + (size_t)M * 48 + (size_t)N * M * 4;
}

// ---- kmeans||'s table update and counts on the tile pass

// The candidates x[cand_j] gathered into rows [C, D] and split into TF32
// parts [2, C, D], their norms c_sq [C] (+inf for a skipped one, whose
// rows are zeros); with d2_out, d2_out = mask ? d2_in : 0 too.
__global__ void seed_gather_kernel(const float* __restrict__ x,
                                   const int* __restrict__ cand, int C,
                                   int D, float* __restrict__ parts,
                                   float* __restrict__ rows,
                                   float* __restrict__ c_sq,
                                   const uint8_t* __restrict__ mask,
                                   const float* __restrict__ d2_in,
                                   float* __restrict__ d2_out, int N) {
  const int lane = threadIdx.x & 31;
  const int gt = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const size_t cd = (size_t)C * D;
  for (int j = gt >> 5; j < C; j += stride >> 5) {
    const int row = cand[j];
    for (int d = lane; d < D; d += 32) {
      const float v = row >= 0 ? x[(size_t)row * D + d] : 0.f;
      rows[(size_t)j * D + d] = v;
      const uint32_t big = tf32_rna(v);
      parts[(size_t)j * D + d] = __uint_as_float(big);
      parts[cd + (size_t)j * D + d] =
          __uint_as_float(tf32_rna(v - __uint_as_float(big)));
    }
  }
  // |c|^2 by teams of 8 lanes, to the bit as the TABLE epilogue's
  // row_dot_sq takes |x|^2 (so a candidate is at distance exactly 0 from
  // its own row): lane k sums the 16-byte groups g = k mod 8, the shuffles
  // add the parts pairwise
  const int tl = lane & 7, teams = stride >> 3, G = D >> 2;
  for (int jb = 0; jb < C; jb += teams) {
    const int j = jb + (gt >> 3);
    const int row = j < C ? cand[j] : -1;
    float p = 0.f;
    if (row >= 0)
      for (int g = tl; g < G; g += 8) {
        const float4 v = ld4(x + (size_t)row * D + 4 * g);
        p = fmaf(v.x, v.x, p);
        p = fmaf(v.y, v.y, p);
        p = fmaf(v.z, v.z, p);
        p = fmaf(v.w, v.w, p);
      }
    p += __shfl_xor_sync(FULL, p, 1);
    p += __shfl_xor_sync(FULL, p, 2);
    p += __shfl_xor_sync(FULL, p, 4);
    if (tl == 0 && j < C) c_sq[j] = row >= 0 ? p : INFINITY;
  }
  if (d2_out != nullptr)
    for (int i = gt; i < N; i += stride) d2_out[i] = mask[i] ? d2_in[i] : 0.f;
}

// Each masked row's winner (distance bits << 32 | candidate) into counts.
__global__ void seed_hist_kernel(const unsigned long long* __restrict__ best,
                                 const uint8_t* __restrict__ mask, int N,
                                 int* __restrict__ counts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N || !mask[i]) return;
  const unsigned long long b = best[i];
  if ((b >> 32) < INF_BITS) atomicAdd(counts + (b & 0xffffffffu), 1);
}

// The tile pass's scratch (the wrapper's one f32 buffer): the candidates'
// TF32 parts [2, C, D], their f32 rows [C, D], their norms [C].
inline float* seed_rows(float* parts, int C, int D) {
  return parts + 2 * (size_t)C * D;
}
inline float* seed_c_sq(float* parts, int C, int D) {
  return parts + 3 * (size_t)C * D;
}

// Gather and split the candidates, and map x and the parts: the tile
// pass's set-up. d2_out as seed_gather_kernel's.
inline cudaError_t seed_tc_setup(const float* x, const uint8_t* mask,
                                 const int* cand, int C, int N, int D,
                                 const float* d2_in, float* d2_out,
                                 float* parts, LloydMaps* maps,
                                 cudaStream_t stream) {
  if (parts == nullptr || D % 4 != 0) return cudaErrorInvalidValue;
  const int cb = (C + 7) / 8, rb = d2_out ? (N + NT - 1) / NT : 1;
  const int want = cb > rb ? cb : rb;
  seed_gather_kernel<<<want < 1024 ? want : 1024, NT, 0, stream>>>(
      x, cand, C, D, parts, seed_rows(parts, C, D), seed_c_sq(parts, C, D),
      mask, d2_in, d2_out, N);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return lloyd_maps(x, N, parts, C, D, maps);
}

inline int seed_splits(int C) { return (C + LT_CENTS - 1) / LT_CENTS; }

}  // namespace fvdb

// The l rows of least key (see above) -> out_r [l] (-1 past the eligible
// rows). d2 [N] (ignored unless weighted), mask [N], u [N]; key [N] and
// out_d [l] scratch; work: fvdb_select_scratch_bytes(1, l) bytes.
FVDB_EXPORT int fvdb_seed_pick(const float* d2, const uint8_t* mask,
                               const float* u, int N, int l, int weighted,
                               float* key, void* work, float* out_d,
                               int* out_r, cudaStream_t stream) {
  using namespace fvdb;
  if (N < 1 || l < 1) return static_cast<int>(cudaErrorInvalidValue);
  seed_key_kernel<<<(N + NT - 1) / NT, NT, 0, stream>>>(d2, mask, u, N,
                                                         weighted, key);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_select_topk(key, nullptr, nullptr, N, 1, l,
                                             work, out_d, out_r, stream));
}

// x [N, D], mask [N], cand [C] rows of x, d2_in [N] -> d2_out [N]. tc:
// the tile pass (scratch: 3 C D + C floats, 16-byte aligned), else the FMA
// route.
FVDB_EXPORT int fvdb_seed_min_update(const float* x, const uint8_t* mask,
                                     const int* cand, int C, int N, int D,
                                     const float* d2_in, float* d2_out,
                                     int tc, float* scratch,
                                     cudaStream_t stream) {
  using namespace fvdb;
  if (N < 1 || D < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (!tc) {
    seed_dist_kernel<false><<<seed_blocks(N), NT, 0, stream>>>(
        x, mask, cand, C, N, D, d2_in, d2_out, nullptr);
    return static_cast<int>(cudaGetLastError());
  }
  LloydMaps maps;
  cudaError_t e = seed_tc_setup(x, mask, cand, C, N, D, d2_in, d2_out,
                                scratch, &maps, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_tc<TC_TABLE>(
      maps, x, mask, seed_rows(scratch, C, D), seed_c_sq(scratch, C, D), N,
      C, D, seed_splits(C), nullptr, d2_out, nullptr, nullptr, nullptr,
      nullptr, stream));
}

// x [N, D], mask [N], cand [C] rows of x -> counts [C] (zeroed here). tc:
// the tile pass (scratch: 3 C D + C floats, 16-byte aligned; best [N]),
// else the FMA route.
FVDB_EXPORT int fvdb_seed_counts(const float* x, const uint8_t* mask,
                                 const int* cand, int C, int N, int D,
                                 int* counts, int tc, float* scratch,
                                 unsigned long long* best,
                                 cudaStream_t stream) {
  using namespace fvdb;
  if (N < 1 || D < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaMemsetAsync(counts, 0, sizeof(int) * C, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!tc) {
    seed_dist_kernel<true><<<seed_blocks(N), NT, 0, stream>>>(
        x, mask, cand, C, N, D, nullptr, nullptr, counts);
    return static_cast<int>(cudaGetLastError());
  }
  if (best == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  e = cudaMemsetAsync(best, 0xff, sizeof(unsigned long long) * N, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  LloydMaps maps;
  e = seed_tc_setup(x, mask, cand, C, N, D, nullptr, nullptr, scratch,
                    &maps, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = launch_tc<TC_NEAREST>(maps, x, mask, nullptr, seed_c_sq(scratch, C, D),
                            N, C, D, seed_splits(C), nullptr, nullptr,
                            nullptr, nullptr, nullptr, best, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  seed_hist_kernel<<<(N + NT - 1) / NT, NT, 0, stream>>>(best, mask, N,
                                                          counts);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of fvdb_kmeans_pp's scratch for N rows and M subspaces.
FVDB_EXPORT long long fvdb_kmeans_pp_scratch_bytes(int N, int M) {
  return static_cast<long long>(fvdb::pp_scratch_bytes(N, M));
}

// k-means++ over each of the M subspaces of x [N, D] (D = M Ds), rows in
// mask [N]: rows [M, C] int32, the C picks of each, in one cooperative
// launch (the head comment's design). (k0, k1): the Philox key. scratch:
// fvdb_kmeans_pp_scratch_bytes(N, M) bytes, 8-byte aligned. The mask must
// hold a row.
FVDB_EXPORT int fvdb_kmeans_pp(const float* x, const uint8_t* mask, int N,
                               int D, int M, int C, unsigned k0, unsigned k1,
                               void* scratch, int* rows,
                               cudaStream_t stream) {
  using namespace fvdb;
  if (N < 1 || D < 1 || M < 1 || C < 1 || D % M != 0 || D > 16384)
    return static_cast<int>(cudaErrorInvalidValue);
  PPArgs a;
  a.x = x;
  a.mask = mask;
  a.N = N;
  a.D = D;
  a.M = M;
  a.Ds = D / M;
  a.C = C;
  a.k0 = k0;
  a.k1 = k1;
  const bool vec = a.Ds % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vecs = a.Ds / (vec ? 4 : 1);  // loads a unit
  int L = 1;
  while (L < 32 && vecs % (2 * L) == 0) L *= 2;
  a.lanes = L;
  // threads: a multiple of lcm(32, L M) where it fits, so a team's units
  // and a thread's keys keep one subspace a step
  int lm = L * M, g = 32;
  for (int b = lm; b;) {  // gcd(32, L M)
    const int r = g % b;
    g = b;
    b = r;
  }
  const long long lcm = 32LL * lm / g;
  const int T = lcm <= PP_THREADS ? static_cast<int>(PP_THREADS / lcm * lcm)
                                  : PP_THREADS;
  a.warp_fold = T % M == 0 && 32 % M == 0;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  a.rows_pb = ((N + sms - 1) / sms + 3) & ~3;
  const int grid = (N + a.rows_pb - 1) / a.rows_pb;
  const size_t fixed = pp_smem_fixed(D, M);
  const size_t d2_bytes = (size_t)a.rows_pb * M * 4;
  a.d2_smem = fixed + d2_bytes <= 200 * 1024;
  const size_t smem = fixed + (a.d2_smem ? d2_bytes : 0);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  a.bar = reinterpret_cast<unsigned*>(sc);
  a.keys = reinterpret_cast<unsigned long long*>(sc + 8);
  a.d2g = reinterpret_cast<float*>(sc + 8 + (size_t)M * 48);
  a.rows = rows;
  const void* fn = vec ? reinterpret_cast<const void*>(kmeans_pp_kernel<4>)
                       : reinterpret_cast<const void*>(kmeans_pp_kernel<1>);
  static int cap4[64], cap1[64];
  e = raise_smem_cap(fn, static_cast<int>(smem), vec ? cap4 : cap1);
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, T, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1 || grid > per_sm * sms)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  e = cudaMemsetAsync(sc, 0, 8, stream);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(a.keys, 0xff, (size_t)M * 48, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&a};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      fn, dim3(grid), dim3(T), args, smem, stream));
}

// The uniforms k-means++ draws for (subspace sub, step) at rows 0..N-1 ->
// out [N], for the checks.
FVDB_EXPORT int fvdb_pp_uniforms(unsigned k0, unsigned k1, int sub, int step,
                                 int N, float* out, cudaStream_t stream) {
  using namespace fvdb;
  if (N < 1) return static_cast<int>(cudaErrorInvalidValue);
  pp_uniform_kernel<<<(N + NT - 1) / NT, NT, 0, stream>>>(k0, k1, sub, step,
                                                           N, out);
  return static_cast<int>(cudaGetLastError());
}
