// K4: the HNSW neighbour-selection heuristic.
//
// Replaces the JAX package's heuristic_kept_kernel (index/hnsw.py:160). Per
// query b: gather its C candidate rows (a -1 id gathers row 0, as the
// reference does) of an f32 or a bf16 mirror (bf16 rows upcast exactly, so
// the norms are those of the upcast rows, as the reference's are), form their pairwise squared distances in the reference's
// norm-expansion form pd[i][j] = (sq_i - 2 g_ij) + sq_j, then scan the
// candidates in order (they arrive sorted by distance to the query): keep
// candidate i when its id is valid, its distance is finite, fewer than m are
// kept, and d_i < min over kept j of pd[i][j] (strict).
//
// What bounds it on the H100: the gather is C * D * 4 bytes a query (196,608
// at C = 128, D = 384; 201 MB for B = 1,024), 60 us at 3.35 TB/s; the Gram
// products are 2 * C^2 * D = 12.6 MFLOP a query, 0.19 ms for B = 1,024 at
// 67 TFLOP/s: arithmetic bounds it.
//
// Design: one block per query. The C x D candidate rows (196 KB) and the
// C x C table (64 KB) do not both fit a block's 227 KB, so the Gram matrix is
// built in D-chunks: each 32-dim chunk of the C rows is staged in shared
// memory and every thread accumulates an 8 x 8 block of g in registers.
// Only the finished C x C table of pd goes to shared memory. The sequential
// keep scan then reads one flag per step, because each keep updates a
// running dmin of every later candidate in parallel (one column of pd), so
// the block synchronises only on keeps (at most m of them).
#include "common.cuh"

namespace fvdb {

constexpr int CMAX = 128;  // candidates a query
constexpr int TK = 32;     // dims a shared-memory chunk

template <typename T>
__global__ void __launch_bounds__(NT) heuristic_kept_kernel(
    const T* __restrict__ x, const int* __restrict__ cand_ids,
    const float* __restrict__ cand_d, int C, int D, int m,
    uint8_t* __restrict__ kept) {
  __shared__ float chunk[TK][CMAX + 1];
  __shared__ long long rows[CMAX];
  __shared__ float sq[CMAX], dmin[CMAX], dist[CMAX];
  __shared__ uint8_t valid[CMAX], keep[CMAX];
  extern __shared__ float pd[];  // [C][C]

  const int t = threadIdx.x, b = blockIdx.x;
  const int ti = t >> 4, tj = t & 15;  // rows ti + 16a, columns tj + 16c
  if (t < C) {
    const int id = cand_ids[(size_t)b * C + t];
    const float d = cand_d[(size_t)b * C + t];
    rows[t] = (long long)max(id, 0);
    dist[t] = d;
    valid[t] = id >= 0 && isfinite(d);
    keep[t] = 0;
    dmin[t] = INFINITY;
  }

  float g[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int c = 0; c < 8; ++c) g[a][c] = 0.f;
  for (int k0 = 0; k0 < D; k0 += TK) {
    __syncthreads();
    for (int idx = t; idx < CMAX * TK; idx += NT) {
      const int r = idx / TK, d = idx % TK;
      chunk[d][r] =
          (r < C && k0 + d < D) ? as_f32(x[rows[r] * D + k0 + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < TK; ++kk) {
      float av[8], cv[8];
#pragma unroll
      for (int a = 0; a < 8; ++a) av[a] = chunk[kk][ti + 16 * a];
#pragma unroll
      for (int c = 0; c < 8; ++c) cv[c] = chunk[kk][tj + 16 * c];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int c = 0; c < 8; ++c) g[a][c] = fmaf(av[a], cv[c], g[a][c]);
    }
  }
  if (ti == tj) {  // the diagonal of g holds the squared norms
#pragma unroll
    for (int a = 0; a < 8; ++a)
      if (ti + 16 * a < C) sq[ti + 16 * a] = g[a][a];
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int i = ti + 16 * a;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = tj + 16 * c;
      if (i < C && j < C) pd[i * C + j] = sq[i] - 2.f * g[a][c] + sq[j];
    }
  }
  __syncthreads();

  // every thread walks the scan with the same values, so the branch on a
  // keep is uniform and only keeps need a barrier
  int cnt = 0;
  for (int i = 0; i < C && cnt < m; ++i) {
    if (valid[i] && dist[i] < dmin[i]) {
      ++cnt;
      if (t == 0) keep[i] = 1;
      for (int r = i + 1 + t; r < C; r += NT) dmin[r] = fminf(dmin[r], pd[r * C + i]);
      __syncthreads();
    }
  }
  __syncthreads();
  if (t < C) kept[(size_t)b * C + t] = keep[t];
}

template <typename T>
cudaError_t heuristic_kept(const T* x, const int* cand_ids,
                           const float* cand_d, int B, int C, int D, int m,
                           uint8_t* kept, cudaStream_t stream) {
  if (B < 1 || C < 1 || C > CMAX || D < 1) return cudaErrorInvalidValue;
  const int smem = C * C * (int)sizeof(float);
  static int cap[64];
  cudaError_t e = raise_smem_cap(
      reinterpret_cast<const void*>(heuristic_kept_kernel<T>), smem, cap);
  if (e != cudaSuccess) return e;
  heuristic_kept_kernel<T><<<B, NT, smem, stream>>>(x, cand_ids, cand_d, C, D,
                                                    m, kept);
  return cudaGetLastError();
}

}  // namespace fvdb

// x [N, D]; cand_ids, cand_d [B, C] (C <= 128); kept [B, C] (0/1 bytes).
FVDB_EXPORT int fvdb_heuristic_kept(const float* x, const int* cand_ids,
                                    const float* cand_d, int B, int C, int D,
                                    int m, uint8_t* kept,
                                    cudaStream_t stream) {
  return static_cast<int>(fvdb::heuristic_kept(x, cand_ids, cand_d, B, C, D,
                                               m, kept, stream));
}

// The same over bf16 rows x [N, D].
FVDB_EXPORT int fvdb_heuristic_kept_bf16(const __nv_bfloat16* x,
                                         const int* cand_ids,
                                         const float* cand_d, int B, int C,
                                         int D, int m, uint8_t* kept,
                                         cudaStream_t stream) {
  return static_cast<int>(fvdb::heuristic_kept(x, cand_ids, cand_d, B, C, D,
                                               m, kept, stream));
}
