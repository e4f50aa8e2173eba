// K12: the probed-list scan of the IVF search, and its top-k, by row type
// and metric.
//
// Replaces the list scan of the JAX package's ivf_search_kernel
// (index/ivf.py:79, ivf_search_kernel(metric) at :104-120): for each query,
// the rows of its n_probe lists (ranked by K1 over the centroids, by the
// same metric) are scored max(|q|^2 - 2 q.x + |x|^2, 0), or by metric
// 1 - q.x / sqrt(max(|q|^2 |x|^2, 1e-30)) (cosine) or -q.x (dot), rows
// that are padding, past the mirror (>= N) or masked out never enter, and
// the k smallest (distance, row) come out sorted, padded with (+inf, -1).
// The rows are f32 or bf16 (a bf16 serving mirror), upcast exactly; the
// query stays f32 and x_sq are the mirror's f32 norms (on a bf16 mirror,
// the f32 host rows'), as the reference's einsum of an f32 query with
// gathered bf16 rows computes in f32. Cosine and dot distances can be
// negative; the radix select's keys (common.cuh) order them.
// A seed list (the HNSW beam's top-k in the pruned regime) may join the
// candidates, which folds the regime's two merge_topk calls into this
// selection: the beam's and the IVF's rows are disjoint.
// K15's sharded IVF search (parallel/sharded.py:206, its scan at :228-252)
// runs the same scan on each shard's lists: the probes are global list ids,
// the shard holds the lists [c_lo, c_lo + c_local) (tiles row probe - c_lo),
// and a probe outside them scans nothing, as a list another shard owns.
//
// What bounds it on the H100: the arithmetic, 2 D flops for each (query,
// probed row), and the probed rows, 4 D bytes each read once. At the 1M
// configuration (256 uneven lists, n_probe 16) a batch of 128 queries scores
// ~37.5M (query, row) pairs, 28.8 GFLOP, ~0.43 ms at 67 TFLOP/s, over the
// union of its probed lists, at most the ~900K IVF rows, 1.4 GB, ~0.41 ms.
// This design reads a list once for every query that probes it (the long
// lists, which most queries probe, ~57 times at B=128), so it moves ~57 GB
// a batch and runs far above that bound: grouping the queries that probe a
// list, so a list is read once, is the way to the bound.
//
// Design: pass 1 has a block per (list chunk of 256 entries, probe, query),
// so uneven lists cost only their own chunks (a block past its list's end
// leaves at once); each block writes its scores and rows at the list's
// offset in the query's candidate row (the prefix sum of the earlier probes'
// lengths), a warp scoring four rows at a time with all loads in flight.
// A candidate row holds at most the P longest lists and the seed, and the
// caller runs the queries in chunks, so the buffer stays bounded at any B.
// Pass 2 is topk_select.cuh's radix select over each query's candidates.
#include "common.cuh"
#include "topk_select.cuh"

namespace fvdb {

constexpr int CH = 256;  // list entries a block

// The row of tiles that holds global list pr, or -1: a probe of -1 (no
// finite centroid distance) or a list outside [c_lo, c_lo + c_local).
__device__ __forceinline__ int owned_list(int pr, int c_lo, int c_local) {
  const int l = pr - c_lo;
  return pr >= 0 && l >= 0 && l < c_local ? l : -1;
}

template <typename T, int METRIC>
__global__ void __launch_bounds__(NT) ivf_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ x_sq,
    const uint8_t* __restrict__ mask, const uint8_t* __restrict__ mask2,
    const int* __restrict__ tiles, int L_pad,
    const int* __restrict__ list_len, const int* __restrict__ probe, int P,
    int c_lo, int c_local, const float* __restrict__ q, int D, int N,
    const float* __restrict__ seed_d, const int* __restrict__ seed_r,
    int seed_stride, int k_seed, long long stride,
    float* __restrict__ cand_d, int* __restrict__ cand_r,
    int* __restrict__ n_per) {
  extern __shared__ float qs[];
  __shared__ int s_off, s_len, s_cl, s_tot;
  __shared__ float s_qsq;
  const int chunk = blockIdx.x, p = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const int* pr = probe + (size_t)b * P;
  if (t == 0) {  // a probe of no list held here is empty
    int off = 0, tot = 0;
    for (int i = 0; i < P; ++i) {
      const int li = owned_list(pr[i], c_lo, c_local);
      const int len = li >= 0 ? list_len[li] : 0;
      off += i < p ? len : 0;
      tot += len;
    }
    s_off = off;
    s_tot = tot;
    s_cl = owned_list(pr[p], c_lo, c_local);
    s_len = s_cl >= 0 ? list_len[s_cl] : 0;
  }
  __syncthreads();
  float* cd = cand_d + (size_t)b * stride;
  int* cr = cand_r + (size_t)b * stride;
  if (p == 0 && chunk == 0) {  // the seed goes after the lists
    for (int i = t; i < k_seed; i += NT) {
      cd[s_tot + i] = seed_d[(size_t)b * seed_stride + i];
      cr[s_tot + i] = seed_r[(size_t)b * seed_stride + i];
    }
    if (t == 0) n_per[b] = s_tot + k_seed;
  }
  const int lo = chunk * CH;
  const int hi = min(s_len, lo + CH);
  if (lo >= hi) return;  // the whole block
  for (int d = t; d < D; d += NT) qs[d] = q[(size_t)b * D + d];
  __syncthreads();
  if (w == 0) {
    const float s = warp_row_sq(qs, D);
    if (lane == 0) s_qsq = s;
  }
  __syncthreads();
  const float q_sq = s_qsq;
  const int* list = tiles + (size_t)s_cl * L_pad;
  const int off = s_off;
  for (int i0 = lo + w * 4; i0 < hi; i0 += (NT / 32) * 4) {
    int raw[4], rows[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int r = i0 + g < hi ? list[i0 + g] : -1;
      const bool ok = r >= 0 && r < N && mask[r] && (!mask2 || mask2[r]);
      raw[g] = r;
      rows[g] = ok ? r : -1;
    }
    float dots[4];
    warp_dots<4>(qs, x, rows, D, dots);
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      if (g == lane && i0 + g < hi) {
        cd[off + i0 + g] =
            rows[g] >= 0 ? metric_dist<METRIC>(q_sq, dots[g], x_sq[rows[g]])
                         : INFINITY;
        cr[off + i0 + g] = raw[g];
      }
    }
  }
}

template <typename T, int METRIC>
cudaError_t ivf_scan(const T* x, const float* x_sq, const uint8_t* mask,
                     const uint8_t* mask2, const int* tiles, int L_pad,
                     const int* list_len, const int* probe, int P,
                     int c_lo, int c_local, const float* q, int B, int D,
                     int N,
                     const float* seed_d, const int* seed_r, int seed_stride,
                     int k_seed, int k, long long stride, float* cand_d,
                     int* cand_r, int* n_per, void* work, float* out_d,
                     int* out_r, cudaStream_t stream) {
  const int smem = D * 4;
  static int cap[64];
  cudaError_t e = raise_smem_cap(
      reinterpret_cast<const void*>(ivf_scan_kernel<T, METRIC>), smem, cap);
  if (e != cudaSuccess) return e;
  dim3 grid((L_pad + CH - 1) / CH, P, B);
  ivf_scan_kernel<T, METRIC><<<grid, NT, smem, stream>>>(
      x, x_sq, mask, mask2, tiles, L_pad, list_len, probe, P, c_lo, c_local, q,
      D, N, seed_d, seed_r, seed_stride, k_seed, stride, cand_d, cand_r, n_per);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_select_topk(cand_d, cand_r, n_per, stride, B, k, work, out_d,
                            out_r, stream);
}

}  // namespace fvdb

// x [N, D] (x_bf16: bf16, else f32), x_sq [N], mask / mask2 [N] uint8
// (mask2 may be null), tiles [C, L_pad] int32 (each list packed at the
// front), list_len [C], probe [B, P] (from K1 over the centroids: global
// list ids; tiles row i holds list c_lo + i, for i < C, and any other probe
// scans nothing), q [B, D]; metric 0 euclidean, 1 cosine, 2 dot; seed_*
// [B, seed_stride] with its first k_seed entries joining (k_seed may be 0); cand_* [B,
// stride] scratch with stride >= the lengths of the P longest lists +
// k_seed (the most candidates any query can have), n_per [B] scratch;
// work: fvdb_select_scratch_bytes(B, k) bytes; out_* [B, k].
FVDB_EXPORT int fvdb_ivf_scan(
    const void* x, int x_bf16, int metric, const float* x_sq,
    const uint8_t* mask, const uint8_t* mask2, const int* tiles, int L_pad,
    const int* list_len, const int* probe, int P, int c_lo, int C,
    const float* q, int B, int D, int N, const float* seed_d,
    const int* seed_r, int seed_stride, int k_seed, int k, long long stride, float* cand_d, int* cand_r,
    int* n_per, void* work, float* out_d, int* out_r, cudaStream_t stream) {
  using namespace fvdb;
  if (B < 1 || D < 1 || P < 1 || L_pad < 1 || k < 1 || k_seed < 0 || C < 0 ||
      stride < (long long)k_seed + 1 || B > 65535 || P > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_metric(metric, [&](auto m) {
    constexpr int M = decltype(m)::value;
    return x_bf16
               ? ivf_scan<__nv_bfloat16, M>(
                     static_cast<const __nv_bfloat16*>(x), x_sq, mask, mask2,
                     tiles, L_pad, list_len, probe, P, c_lo, C, q, B, D, N,
                     seed_d, seed_r, seed_stride, k_seed, k, stride, cand_d,
                     cand_r, n_per, work, out_d, out_r, stream)
               : ivf_scan<float, M>(
                     static_cast<const float*>(x), x_sq, mask, mask2, tiles,
                     L_pad, list_len, probe, P, c_lo, C, q, B, D, N, seed_d,
                     seed_r, seed_stride, k_seed, k, stride, cand_d, cand_r,
                     n_per, work, out_d, out_r, stream);
  }));
}
