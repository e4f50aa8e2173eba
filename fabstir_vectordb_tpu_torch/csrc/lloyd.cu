// K6: Lloyd iterations of k-means, and the nearest-centroid assignment.
//
// Replaces the JAX package's _lloyd_block (ops/kmeans.py:112), which stacks
// `steps` iterations of lloyd_step (:84), and assign_clusters (:70). K15's
// sharded Lloyd step (parallel/sharded.py:280) runs an iteration in two
// halves, fvdb_lloyd_partial on each shard's rows and fvdb_lloyd_finish on
// the sums, counts and stats summed across the shards; fvdb_lloyd_step is
// the two back to back, the ops entry point lloyd_step. One
// iteration: d[n][c] = max(|x_n|^2 - 2 x_n.c + |c|^2, 0); assign n to the
// first c of least d; sums and counts of the rows of each cluster; a cluster
// with rows moves to their mean and an empty one keeps its centroid; the
// error is sum(d[n][assign n]) over the rows in the mask / max(#rows, 1).
//
// What bounds it on the H100: the distances are 2 * N * C * D flops an
// iteration (12.9 GFLOP at N = 65,536, C = 256, D = 384: 0.19 ms at 67
// TFLOP/s of f32 FMA; at N = 1,048,576, 206 GFLOP, three TF32 products
// 1.25 ms at 495 TFLOP/s), against 101 MB (1.6 GB) of rows read: the
// products bound it. The sums are N * D adds into C * D places.
//
// Two routes for the distances, chosen by the wrapper (ops/kmeans.py
// lloyd_route); the argmin, the sums and the finish are the same:
//
// The tensor-core route (the exports' tc = 1): D % 4 == 0 (16-byte rows,
// as TMA copies them), C >= 64, x and the centroids 16-byte aligned.
//  * The centroids are split once a call (a Lloyd step) into TF32 parts,
//    big = tf32(c) and small = tf32(c - big) (x - big is exact in f32), by
//    wgmma.cuh's tf32_rna, into a scratch [2, C, D], with their norms.
//  * A block takes 128 rows of x, two consumer warpgroups of 64 rows (the
//    wgmma's M side), against the centroids 128 at a time (the N side: C
//    = 256 is two passes). A producer warp's one lane copies each stage,
//    32 dims of the block's rows and of the pass's centroids' two parts
//    (three 16 KB tiles, 128-byte swizzled), by TMA into a ring of four
//    stages, from HBM or L2; the consumers arrive on the slot's "empty"
//    barrier once their products are done with it.
//  * Each thread reads its A fragments of the rows from the slot and
//    splits them in registers; each k8 step is three m64n128k8 TF32
//    products (big.big from zero, small.big and big.small chained onto
//    it), added to f32 sums in registers: the tensor cores cut a chain's
//    sums at the partial sum's size, so no big product is summed onto the
//    running total there (bf16_tile.cuh's route tf32x3 does the same).
//    The dropped small.small and the small parts' rounding are ~2^-22 of
//    each product.
//  * The epilogue is in registers: the same f32 distance max(|x|^2 -
//    2 x.c + |c|^2, 0) of each (row, centroid) a thread holds, the best
//    by (distance, centroid) over the passes, four lanes a row by
//    shuffles; |x|^2 is summed from the first pass's fragments (no pass
//    of its own over x).
//  * Lloyd's sums take one 16-byte atomic a lane a 128-dim piece of a
//    row (scripts/time_tile_routes.py --split k6 times them apart), and
//    the error takes each row's distance to its centroid again with an
//    f32 FMA dot product (the x and centroid rows are read for the sums
//    anyway): the tensor cores' sums carry a bias that the mean of the
//    rows' distances would keep.
//
// The FMA route (tc = 0; other D and C, such as the flat tier's 3 lists)
// is a 32 x 128 tile product (4 x 4 results a thread, one shared-memory
// chunk at a time) with the rows as the 32-row side and the centroids as
// the 128-row side; each thread keeps the best (distance, centroid) of its
// 4 rows over its centroids in registers across the centroid tiles, and a
// shuffle tree finishes the argmin per row.
//
// Both then add each masked-in row into its cluster's sums and count with
// atomics (the adds land in L2; their order varies from run to run, so the
// sums are equal to the plain version's up to rounding); a warp sums its
// rows' errors and count before one atomic each. A second small kernel
// divides, keeps empty clusters, and writes the error. Each iteration's
// centroids are written to their slot of the [steps, C, D] output, and the
// next iteration reads them from there.
#include "lloyd_tile.cuh"

namespace fvdb {

constexpr int TQ = 32;   // rows of x a block (4 per warp)
constexpr int TR = 128;  // centroids a tile (4 per lane, stride 32)
constexpr int TK = 32;   // depth of one shared-memory chunk

struct TileSmem {
  float a[TK][TQ + 1];  // +1: the transposed stores hit 32 distinct banks
  float b[TK][TR + 1];
};

// acc[i][j] = dot(A[ty*4 + i], B[tx + 32*j]) over all D dims, where
// ty = warp, tx = lane. A holds a_n rows and B holds b_n rows of D floats
// (row-major, row stride D); rows past them read as zero. All NT threads of
// the block must call it.
__device__ __forceinline__ void tile_product(
    const float* __restrict__ A, int a_n, const float* __restrict__ B,
    int b_n, int D, TileSmem& s, float acc[4][4]) {
  const int t = threadIdx.x, tx = t & 31, ty = t >> 5;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < D; k0 += TK) {
    __syncthreads();  // the previous chunk has been read by every thread
    // a warp reads 32 consecutive floats of one row: one 128-byte line
#pragma unroll
    for (int e = 0; e < TQ * TK / NT; ++e) {
      int idx = t + e * NT, r = idx / TK, d = idx % TK;
      s.a[d][r] = (r < a_n && k0 + d < D) ? A[(size_t)r * D + k0 + d] : 0.f;
    }
#pragma unroll
    for (int e = 0; e < TR * TK / NT; ++e) {
      int idx = t + e * NT, r = idx / TK, d = idx % TK;
      s.b[d][r] = (r < b_n && k0 + d < D) ? B[(size_t)r * D + k0 + d] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < TK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = s.a[kk][ty * 4 + i];  // broadcast
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = s.b[kk][tx + 32 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

__global__ void __launch_bounds__(NT) row_sq_kernel(const float* __restrict__ a,
                                                    int n, int D,
                                                    float* __restrict__ out) {
  const int r = blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
  if (r >= n) return;
  const float s = warp_row_sq(a + (size_t)r * D, D);
  if ((threadIdx.x & 31) == 0) out[r] = s;
}

// accumulate = 1: add each masked-in row to sums/counts/stats (Lloyd);
// accumulate = 0: write assign (-1 where masked out) and d2 (0 there).
__global__ void __launch_bounds__(NT) assign_kernel(
    const float* __restrict__ x, const float* __restrict__ x_sq,
    const uint8_t* __restrict__ mask, const float* __restrict__ cents,
    const float* __restrict__ c_sq, int N, int C, int D, int accumulate,
    int* __restrict__ assign, float* __restrict__ d2,
    float* __restrict__ sums, float* __restrict__ counts,
    float* __restrict__ stats) {
  __shared__ TileSmem s;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int n0 = blockIdx.x * TQ;
  const int xn = min(TQ, N - n0);
  float best_d[4];
  int best_c[4];
  float err = 0.f, rows = 0.f;  // lane 0's masked-in rows: error, count
#pragma unroll
  for (int i = 0; i < 4; ++i) { best_d[i] = INFINITY; best_c[i] = 0x7fffffff; }

  for (int c0 = 0; c0 < C; c0 += TR) {
    float acc[4][4];
    tile_product(x + (size_t)n0 * D, xn, cents + (size_t)c0 * D,
                 min(TR, C - c0), D, s, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = n0 + ty * 4 + i;
      const float xs = n < N ? x_sq[n] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx + 32 * j;
        if (c < C) {
          const float d = fmaxf(xs - 2.f * acc[i][j] + c_sq[c], 0.f);
          if (lex_less(d, c, best_d[i], best_c[i])) { best_d[i] = d; best_c[i] = c; }
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
      if (lex_less(od, oc, best_d[i], best_c[i])) { best_d[i] = od; best_c[i] = oc; }
    }
    const int n = n0 + ty * 4 + i;
    if (n >= N) continue;  // uniform across the warp
    const bool ok = mask == nullptr || mask[n];
    if (!accumulate) {
      if (tx == 0) {
        assign[n] = ok ? best_c[i] : -1;
        d2[n] = ok ? best_d[i] : 0.f;
      }
    } else if (ok) {
      const int c = best_c[i];
      for (int d = tx; d < D; d += 32)
        atomicAdd(&sums[(size_t)c * D + d], x[(size_t)n * D + d]);
      if (tx == 0) {
        atomicAdd(&counts[c], 1.f);
        err += best_d[i];
        rows += 1.f;
      }
    }
  }
  if (accumulate) add_stats(err, rows, stats);
}

__global__ void update_kernel(const float* __restrict__ sums,
                              const float* __restrict__ counts,
                              const float* __restrict__ stats,
                              const float* __restrict__ old_c,
                              float* __restrict__ new_c, int C, int D,
                              float* __restrict__ err) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx == 0) *err = stats[0] / fmaxf(stats[1], 1.f);
  if (idx >= (size_t)C * D) return;
  const float cnt = counts[idx / D];
  new_c[idx] = cnt > 0.f ? sums[idx] / fmaxf(cnt, 1.f) : old_c[idx];
}

inline int blocks_for(long long n, int per) { return (int)((n + per - 1) / per); }

// The assignment of x's rows against cents (c_sq taken) on a route: the
// tensor cores when maps is given (the centroids' parts split into the
// buffer it maps), else the FMA tile. accumulate as assign_kernel's.
inline cudaError_t assign_rows(const LloydMaps* maps, const float* x,
                               const float* x_sq, const uint8_t* mask,
                               const float* cents, const float* c_sq,
                               float* parts, int N, int C, int D,
                               int accumulate, int* assign, float* d2,
                               float* sums, float* counts, float* stats,
                               cudaStream_t stream) {
  if (maps == nullptr) {
    assign_kernel<<<blocks_for(N, TQ), NT, 0, stream>>>(
        x, x_sq, mask, cents, c_sq, N, C, D, accumulate, assign, d2, sums,
        counts, stats);
    return cudaSuccess;
  }
  const long long cd = (long long)C * D;
  const int nb = blocks_for(cd, 256);
  split_tf32_kernel<<<nb < 1024 ? nb : 1024, 256, 0, stream>>>(cents, cd,
                                                                parts);
  return accumulate
             ? launch_tc<TC_LLOYD>(*maps, x, mask, cents, c_sq, N, C, D, 1,
                                   assign, d2, sums, counts, stats, nullptr,
                                   stream)
             : launch_tc<TC_ASSIGN>(*maps, x, mask, cents, c_sq, N, C, D, 1,
                                    assign, d2, sums, counts, stats, nullptr,
                                    stream);
}

// One iteration's partial over the rows of x (x_sq already taken): zero the
// sums, counts and stats, take the centroids' norms, and add each masked-in
// row into its cluster's sums and count, its distance into stats[0] and 1
// into stats[1].
inline cudaError_t lloyd_partial_step(const LloydMaps* maps, const float* x,
                                      const float* x_sq, const uint8_t* mask,
                                      const float* cents, int N, int C, int D,
                                      float* c_sq, float* parts, float* sums,
                                      float* counts, float* stats,
                                      cudaStream_t stream) {
  cudaMemsetAsync(sums, 0, sizeof(float) * (size_t)C * D, stream);
  cudaMemsetAsync(counts, 0, sizeof(float) * C, stream);
  cudaMemsetAsync(stats, 0, sizeof(float) * 2, stream);
  if (N < 1) return cudaSuccess;  // a shard without rows adds nothing
  row_sq_kernel<<<blocks_for(C, NT / 32), NT, 0, stream>>>(cents, C, D, c_sq);
  return assign_rows(maps, x, x_sq, mask, cents, c_sq, parts, N, C, D, 1,
                     nullptr, nullptr, sums, counts, stats, stream);
}

// The iteration's end from the (all-reduced) sums, counts and stats.
inline void lloyd_finish_step(const float* sums, const float* counts,
                              const float* stats, const float* old_c,
                              float* new_c, int C, int D, float* err,
                              cudaStream_t stream) {
  update_kernel<<<blocks_for((long long)C * D, 256), 256, 0, stream>>>(
      sums, counts, stats, old_c, new_c, C, D, err);
}

}  // namespace fvdb

// Every export below takes tc (1: the tensor-core route, 0: the FMA tile)
// and, for tc = 1, parts: scratch [2, C, D] for the centroids' TF32 parts.

namespace fvdb {

// The maps of a call on the tensor-core route (null on the FMA route).
inline cudaError_t route_maps(int tc, const float* x, int N,
                              const float* parts, int C, int D, LloydMaps* m,
                              const LloydMaps** out) {
  *out = nullptr;
  if (!tc) return cudaSuccess;
  if (parts == nullptr || C < 1) return cudaErrorInvalidValue;
  cudaError_t e = lloyd_maps(x, N, parts, C, D, m);
  if (e == cudaSuccess) *out = m;
  return e;
}

}  // namespace fvdb

// x [N, D], mask [N] (0/1), cents [C, D] -> all_c [steps, C, D], errs
// [steps]. Scratch: x_sq [N], c_sq [C], sums [C, D], counts [C], stats [2].
// Each step is a partial and a finish, as fvdb_lloyd_partial and
// fvdb_lloyd_finish run them one at a time.
FVDB_EXPORT int fvdb_lloyd_block(const float* x, const uint8_t* mask,
                                 const float* cents, int N, int C, int D,
                                 int steps, int tc, float* x_sq, float* c_sq,
                                 float* parts, float* sums, float* counts,
                                 float* stats, float* all_c, float* errs,
                                 cudaStream_t stream) {
  using namespace fvdb;
  if (N < 1 || C < 1 || D < 1 || steps < 1 || mask == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  LloydMaps m;
  const LloydMaps* maps;
  cudaError_t e = route_maps(tc, x, N, parts, C, D, &m, &maps);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (maps == nullptr)  // the tensor cores take |x|^2 from their fragments
    row_sq_kernel<<<blocks_for(N, NT / 32), NT, 0, stream>>>(x, N, D, x_sq);
  const float* prev = cents;
  for (int st = 0; st < steps; ++st) {
    e = lloyd_partial_step(maps, x, x_sq, mask, prev, N, C, D, c_sq, parts,
                           sums, counts, stats, stream);
    if (e != cudaSuccess) return static_cast<int>(e);
    float* out = all_c + (size_t)st * C * D;
    lloyd_finish_step(sums, counts, stats, prev, out, C, D, errs + st,
                      stream);
    prev = out;
  }
  return static_cast<int>(cudaGetLastError());
}

// K15's sharded Lloyd step, first half (JAX parallel/sharded.py:286-304):
// a shard's x [N, D] (N may be 0), mask [N], the replicated cents [C, D] ->
// sums [C, D], counts [C], stats [2] = (sum of d2, rows in the mask), to be
// summed across the shards. Scratch: x_sq [N], c_sq [C].
FVDB_EXPORT int fvdb_lloyd_partial(const float* x, const uint8_t* mask,
                                   const float* cents, int N, int C, int D,
                                   int tc, float* x_sq, float* c_sq,
                                   float* parts, float* sums, float* counts,
                                   float* stats, cudaStream_t stream) {
  using namespace fvdb;
  if (N < 0 || C < 1 || D < 1 || (N > 0 && mask == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  LloydMaps m;
  const LloydMaps* maps;
  cudaError_t e = route_maps(tc && N > 0, x, N, parts, C, D, &m, &maps);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (N > 0 && maps == nullptr)
    row_sq_kernel<<<blocks_for(N, NT / 32), NT, 0, stream>>>(x, N, D, x_sq);
  e = lloyd_partial_step(maps, x, x_sq, mask, cents, N, C, D, c_sq, parts,
                         sums, counts, stats, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The second half (:305-310): from the summed sums, counts and stats, the
// new centroids [C, D] (an empty cluster keeps old_c's) and the error
// sum(d2) / max(rows, 1) into err [1].
FVDB_EXPORT int fvdb_lloyd_finish(const float* sums, const float* counts,
                                  const float* stats, const float* old_c,
                                  int C, int D, float* new_c, float* err,
                                  cudaStream_t stream) {
  using namespace fvdb;
  if (C < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  lloyd_finish_step(sums, counts, stats, old_c, new_c, C, D, err, stream);
  return static_cast<int>(cudaGetLastError());
}

// x [N, D], mask [N] or null, cents [C, D] -> assign [N] int32, d2 [N].
// Scratch: x_sq [N], c_sq [C].
FVDB_EXPORT int fvdb_assign(const float* x, const uint8_t* mask,
                            const float* cents, int N, int C, int D, int tc,
                            float* x_sq, float* c_sq, float* parts,
                            int* assign, float* d2, cudaStream_t stream) {
  using namespace fvdb;
  if (N < 1 || C < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  LloydMaps m;
  const LloydMaps* maps;
  cudaError_t e = route_maps(tc, x, N, parts, C, D, &m, &maps);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (maps == nullptr)
    row_sq_kernel<<<blocks_for(N, NT / 32), NT, 0, stream>>>(x, N, D, x_sq);
  row_sq_kernel<<<blocks_for(C, NT / 32), NT, 0, stream>>>(cents, C, D, c_sq);
  e = assign_rows(maps, x, x_sq, mask, cents, c_sq, parts, N, C, D, 0,
                  assign, d2, nullptr, nullptr, nullptr, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// lloyd_step (:84), one Lloyd iteration, as K6's partial and finish back to
// back: x [N, D], mask [N] or null (every row), cents [C, D] -> new_c
// [C, D] (an empty cluster keeps its centroid) and err [1] = sum(d2) /
// max(rows in the mask, 1). Scratch: x_sq [N], c_sq [C], sums [C, D],
// counts [C], stats [2].
FVDB_EXPORT int fvdb_lloyd_step(const float* x, const uint8_t* mask,
                                const float* cents, int N, int C, int D,
                                int tc, float* x_sq, float* c_sq,
                                float* parts, float* sums, float* counts,
                                float* stats, float* new_c, float* err,
                                cudaStream_t stream) {
  using namespace fvdb;
  if (N < 1 || C < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  LloydMaps m;
  const LloydMaps* maps;
  cudaError_t e = route_maps(tc, x, N, parts, C, D, &m, &maps);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (maps == nullptr)
    row_sq_kernel<<<blocks_for(N, NT / 32), NT, 0, stream>>>(x, N, D, x_sq);
  e = lloyd_partial_step(maps, x, x_sq, mask, cents, N, C, D, c_sq, parts,
                         sums, counts, stats, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  lloyd_finish_step(sums, counts, stats, cents, new_c, C, D, err, stream);
  return static_cast<int>(cudaGetLastError());
}
