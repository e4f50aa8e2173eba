// K2: re-score candidate rows in f32 and keep the best m.
//
// Replaces the JAX package's rerank_f32_kernel (index/fused.py:83) and the
// re-score half of flat_search_rerank_kernel / flat_search_approx_kernel
// (index/fused.py:106,114): gather the candidate rows rows[b, :] of a bf16
// mirror x [N, D] (the reduced-rank rerank mirror, the bf16 serving mirror)
// or an f32 one (the approximate flat pool over the f32 serving mirror),
// upcast bf16 rows (exactly) to f32, and score them in the difference form
// sum_d (x[d] - q[d])^2, which does not cancel the way the norm expansion
// does. A candidate row of -1 (or off the mirror) scores +inf. The m
// smallest (distance, row) come out sorted, padded with (+inf, -1).
//
// What bounds it on the H100. At B = 128 (OV <= 2,048, D = 384) it reads
// up to B * OV scattered rows of 768 bytes (bf16; 1,536 f32), 30-60 us of
// HBM at 3.35 TB/s against 3 B OV D flops (0.3 GFLOP, 5 us of f32 FMA):
// bytes, provided enough rows are in flight to cover the gather's latency.
// At B = 1 the bytes are a few hundred KB (under 0.3 us), so it is bound by
// latency: the pool's row ids, then their rows, are two dependent reads,
// and the selection adds a round through L2 and a few block barriers.
//
// Design. A grid of (slices, queries) that fills the card at every B: a
// query's pool is cut into slices of whole rounds (below), ~528 blocks a
// launch (4 an SM), so B = 1 spreads a pool of 1,024 over 32 blocks and
// B = 128 takes 5 slices a query. In a block, each half-warp scores rows:
// its 16 lanes take the row's 16-byte chunks, and the loads of a round (1
// f32 row or 2 bf16 rows a half-warp, 6 loads a lane at D = 384) all go out
// before any FMA; then a shuffle tree over the half-warp. Rows off the
// 16-byte layout (D % 4 != 0 on f32 rows, D % 8 != 0 on bf16 rows, or an
// unaligned mirror) take 4 scalar loads a lane a round instead.
// The selection is fused up to FUSED_OV candidates a query (the keys of a
// pool fit in shared memory): each block writes its rows' 64-bit (distance,
// row) keys (filtered_select.cuh's entry_key) to shared memory and, when the
// pool spans blocks, to a global scratch; the last block of the query to
// arrive (a __threadfence, then an atomicInc that wraps the count back to 0
// for the next launch) reads the others' keys from L2 and runs
// filtered_select.cuh's radix select inside the block, then sorts the m
// survivors. Past FUSED_OV (a filtered k = 100 search asks for tens of
// thousands) the blocks write a [B, OV] distance buffer and
// topk_select.cuh's radix select takes it (the "radix" route).
#include "common.cuh"
#include "filtered_select.cuh"
#include "topk_select.cuh"

namespace fvdb {

constexpr int FUSED_OV = SORT_SMEM;  // a pool whose keys one block selects
constexpr int RR_BLOCKS = 528;       // blocks a launch aims for: 4 an SM

// One round of a half-warp: R rows at once, U 16-byte loads a lane a row.
template <typename T>
struct Round {
  static constexpr int VEC = 16 / sizeof(T);        // elements a load
  static constexpr int R = sizeof(T) == 4 ? 1 : 2;  // rows at once
  static constexpr int U = sizeof(T) == 4 ? 6 : 3;  // loads a lane a row
  static constexpr int ROWS = 16 * R;               // rows a block a round
};

// s + the squared differences of one 16-byte chunk u of a row (4 f32 or 8
// bf16 elements) and the query's matching elements qv (16-byte aligned).
template <typename T>
__device__ __forceinline__ float add_sq16(uint4 u, const float* qv, float s) {
  float xe[16 / sizeof(T)];
  if constexpr (sizeof(T) == 4) {
    xe[0] = __uint_as_float(u.x);
    xe[1] = __uint_as_float(u.y);
    xe[2] = __uint_as_float(u.z);
    xe[3] = __uint_as_float(u.w);
  } else {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      xe[2 * i] = __uint_as_float(w[i] << 16);
      xe[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); i += 4) {
    const float4 q4 = *reinterpret_cast<const float4*>(qv + i);
    float d = xe[i] - q4.x;
    s = fmaf(d, d, s);
    d = xe[i + 1] - q4.y;
    s = fmaf(d, d, s);
    d = xe[i + 2] - q4.z;
    s = fmaf(d, d, s);
    d = xe[i + 3] - q4.w;
    s = fmaf(d, d, s);
  }
  return s;
}

// The difference-form distances of a half-warp's R rows (row < 0: none;
// its sum is left as garbage), summed over the half-warp: every lane ends
// with them. V16: 16-byte chunks (D % VEC == 0, aligned rows).
template <typename T, bool V16>
__device__ __forceinline__ void half_warp_dists(const T* __restrict__ x,
                                                int D, const float* qs,
                                                const int (&row)[Round<T>::R],
                                                float (&s)[Round<T>::R]) {
  using RD = Round<T>;
  const int hl = threadIdx.x & 15;
#pragma unroll
  for (int r = 0; r < RD::R; ++r) s[r] = 0.f;
  if constexpr (V16) {
    const int C = D / RD::VEC;  // chunks of a row
    for (int c0 = 0; c0 < C; c0 += 16 * RD::U) {
      uint4 v[RD::R][RD::U];
#pragma unroll
      for (int r = 0; r < RD::R; ++r)
#pragma unroll
        for (int u = 0; u < RD::U; ++u) {
          const int c = c0 + 16 * u + hl;
          v[r][u] = row[r] >= 0 && c < C
                        ? __ldg(reinterpret_cast<const uint4*>(
                              x + (size_t)row[r] * D) + c)
                        : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
      for (int r = 0; r < RD::R; ++r)
#pragma unroll
        for (int u = 0; u < RD::U; ++u) {
          const int c = c0 + 16 * u + hl;
          if (c < C) s[r] = add_sq16<T>(v[r][u], qs + c * RD::VEC, s[r]);
        }
    }
  } else {
    constexpr int SU = 4;  // scalar loads a lane a row a round
    for (int d0 = 0; d0 < D; d0 += 16 * SU) {
      float v[RD::R][SU];
#pragma unroll
      for (int r = 0; r < RD::R; ++r)
#pragma unroll
        for (int u = 0; u < SU; ++u) {
          const int d = d0 + 16 * u + hl;
          v[r][u] = row[r] >= 0 && d < D ? ld1(x + (size_t)row[r] * D + d)
                                         : 0.f;
        }
#pragma unroll
      for (int r = 0; r < RD::R; ++r)
#pragma unroll
        for (int u = 0; u < SU; ++u) {
          const int d = d0 + 16 * u + hl;
          if (d < D) {
            const float diff = v[r][u] - qs[d];
            s[r] = fmaf(diff, diff, s[r]);
          }
        }
    }
  }
#pragma unroll
  for (int r = 0; r < RD::R; ++r)
#pragma unroll
    for (int off = 8; off; off >>= 1)
      s[r] += __shfl_xor_sync(FULL, s[r], off);
}

// Block (x, y) scores entries [x * per, min(OV, (x + 1) * per)) of query
// y's pool. dist != null (the radix route): each distance to dist [B, OV]
// (+inf for a row off the mirror), nothing more. Else the fused route:
// each entry's key to shared memory (and to keys_g [B, OV] when the pool
// spans blocks); the query's last block selects its m first into out_*.
template <typename T, bool V16>
__global__ void __launch_bounds__(NT) rerank_kernel(
    const T* __restrict__ x, int N, int D, const float* __restrict__ q,
    const int* __restrict__ rows, int OV, int m, int per,
    unsigned long long* __restrict__ keys_g, unsigned* __restrict__ arrive,
    float* __restrict__ dist, float* __restrict__ out_d,
    int* __restrict__ out_r) {
  using RD = Round<T>;
  extern __shared__ __align__(16) unsigned char dyn[];
  const int qpad = (D + 3) & ~3;  // the query's floats, 16-byte rounded
  float* qs = reinterpret_cast<float*>(dyn);
  // keys [pow2(OV)] (sorted in place when m >= OV), then cand [pow2(m)]
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(qs + qpad);
  unsigned long long* cand = keys + pow2_at_least(OV);
  __shared__ int h[256];
  __shared__ unsigned long long s_state[2];
  __shared__ int s_cnt, s_last;
  const int b = blockIdx.y, t = threadIdx.x;
  const int S = gridDim.x, lo = blockIdx.x * per, hi = min(OV, lo + per);
  for (int d = t; d < D; d += NT) qs[d] = q[(size_t)b * D + d];
  __syncthreads();
  const int* rb = rows + (size_t)b * OV;
  const int hw = t >> 4, hl = t & 15;
  for (int j0 = lo; j0 < hi; j0 += RD::ROWS) {  // the same trip count a block
    int row[RD::R];
#pragma unroll
    for (int r = 0; r < RD::R; ++r) {
      const int j = j0 + hw * RD::R + r;
      const int v = j < hi ? __ldg(rb + j) : -1;
      row[r] = v < N ? v : -1;
    }
    float s[RD::R];
    half_warp_dists<T, V16>(x, D, qs, row, s);
    if (hl == 0) {
#pragma unroll
      for (int r = 0; r < RD::R; ++r) {
        const int j = j0 + hw * RD::R + r;
        if (j >= hi) continue;
        if (dist != nullptr) {
          dist[(size_t)b * OV + j] = row[r] >= 0 ? s[r] : INFINITY;
        } else {
          const unsigned long long key =
              row[r] >= 0 ? entry_key(s[r], row[r]) : NO_KEY;
          keys[j] = key;
          if (S > 1) keys_g[(size_t)b * OV + j] = key;
        }
      }
    }
  }
  if (dist != nullptr) return;
  if (S > 1) {  // the query's last block to arrive selects
    __threadfence();  // this block's keys before its arrival
    __syncthreads();
    if (t == 0)
      s_last = atomicInc(arrive + b, (unsigned)S - 1u) == (unsigned)S - 1u;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    const unsigned long long* kb = keys_g + (size_t)b * OV;
    for (int j = t; j < OV; j += NT)
      if (j < lo || j >= hi) keys[j] = __ldcg(kb + j);
  }
  __syncthreads();
  // the m first keys (unsorted), then sorted; NO_KEY fills a short pool
  int n = OV;
  unsigned long long* sel = keys;
  if (m < OV) {
    n = block_select_keys(keys, OV, m, cand, h, s_state, &s_cnt);
    sel = cand;
  }
  const int sz = pow2_at_least(n);
  for (int i = n + t; i < sz; i += NT) sel[i] = NO_KEY;
  __syncthreads();
  block_sort(sel, sz);
  float* od = out_d + (size_t)b * m;
  int* orow = out_r + (size_t)b * m;
  for (int j = t; j < m; j += NT) {
    const unsigned long long key = j < n ? sel[j] : NO_KEY;
    od[j] = key == NO_KEY ? INFINITY : key_dist((unsigned)(key >> 32));
    orow[j] = key == NO_KEY ? -1 : (int)((unsigned)key ^ 0x80000000u);
  }
}

// The grid's slices: whole rounds, ~RR_BLOCKS blocks a launch; *per the
// entries a block takes.
template <typename T>
inline int slices_of(int B, int OV, int* per) {
  const int rounds = (OV + Round<T>::ROWS - 1) / Round<T>::ROWS;
  const int want = (RR_BLOCKS + B - 1) / B;
  const int S0 = want < rounds ? want : rounds;
  *per = (rounds + S0 - 1) / S0 * Round<T>::ROWS;
  return (OV + *per - 1) / *per;
}

template <typename T, bool V16>
cudaError_t launch(const T* x, int N, int D, const float* q, const int* rows,
                   int B, int OV, int m, void* work, unsigned* arrive,
                   float* out_d, int* out_r, cudaStream_t stream) {
  int per = 0;
  const int S = slices_of<T>(B, OV, &per);
  const bool fused = OV <= FUSED_OV;
  const int qpad = (D + 3) & ~3;
  const int smem =
      qpad * 4 +
      (fused ? (pow2_at_least(OV) + pow2_at_least(m < OV ? m : OV)) * 8 : 0);
  static int cap[64];
  cudaError_t e = raise_smem_cap(
      reinterpret_cast<const void*>(rerank_kernel<T, V16>), smem, cap);
  if (e != cudaSuccess) return e;
  const dim3 grid(S, B);
  if (fused) {
    rerank_kernel<T, V16><<<grid, NT, smem, stream>>>(
        x, N, D, q, rows, OV, m, per,
        static_cast<unsigned long long*>(work), arrive, nullptr, out_d,
        out_r);
    return cudaGetLastError();
  }
  float* dist = static_cast<float*>(work);
  rerank_kernel<T, V16><<<grid, NT, smem, stream>>>(
      x, N, D, q, rows, OV, m, per, nullptr, nullptr, dist, out_d, out_r);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  void* sel = static_cast<unsigned char*>(work) +
              round_up16((size_t)B * OV * sizeof(float));
  return launch_select_topk(dist, rows, nullptr, OV, B, m, sel, out_d, out_r,
                            stream);
}

template <typename T>
cudaError_t rerank(const T* x, int N, int D, const float* q, const int* rows,
                   int B, int OV, int m, void* work, unsigned* arrive,
                   float* out_d, int* out_r, cudaStream_t stream) {
  if (B < 1 || B > 65535 || OV < 1 || m < 1 || D < 1 || work == nullptr ||
      (OV <= FUSED_OV && arrive == nullptr))
    return cudaErrorInvalidValue;
  const bool v16 = D % Round<T>::VEC == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  return v16 ? launch<T, true>(x, N, D, q, rows, B, OV, m, work, arrive,
                               out_d, out_r, stream)
             : launch<T, false>(x, N, D, q, rows, B, OV, m, work, arrive,
                                out_d, out_r, stream);
}

}  // namespace fvdb

// Bytes of `work` that fvdb_rerank_f32 / fvdb_rerank_f32_rows need for B
// queries' pools of OV at m: the pools' keys on the fused route (OV <=
// FUSED_OV); the distance buffer and topk_select.cuh's scratch past it.
FVDB_EXPORT long long fvdb_rerank_scratch_bytes(int B, int OV, int m) {
  if (OV <= fvdb::FUSED_OV) return (long long)B * OV * 8;
  size_t st, hist, arrive, total;
  fvdb::select_sizes(B, m, &st, &hist, &arrive, &total);
  return (long long)(fvdb::round_up16((size_t)B * OV * 4) + total);
}

// x [N, D] bf16, q [B, D] f32, rows [B, OV] int32 -> out_* [B, m]; work:
// fvdb_rerank_scratch_bytes(B, OV, m) bytes; arrive [B] uint32, all 0
// (the fused route leaves them 0 again; the radix route does not read
// them).
FVDB_EXPORT int fvdb_rerank_f32(const __nv_bfloat16* x, int N, int D,
                                const float* q, const int* rows, int B, int OV,
                                int m, void* work, unsigned* arrive,
                                float* out_d, int* out_r,
                                cudaStream_t stream) {
  return static_cast<int>(fvdb::rerank(x, N, D, q, rows, B, OV, m, work,
                                       arrive, out_d, out_r, stream));
}

// The same over f32 rows x [N, D].
FVDB_EXPORT int fvdb_rerank_f32_rows(const float* x, int N, int D,
                                     const float* q, const int* rows, int B,
                                     int OV, int m, void* work,
                                     unsigned* arrive, float* out_d,
                                     int* out_r, cudaStream_t stream) {
  return static_cast<int>(fvdb::rerank(x, N, D, q, rows, B, OV, m, work,
                                       arrive, out_d, out_r, stream));
}
