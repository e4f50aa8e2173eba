// K14 stage 1: the reduced-rank regime's wide candidate pool.
//
// Replaces the JAX package's stage1_select_kernel (index/fused.py:65:
// pairwise_distance with compute_dtype bf16 + masked_approx_topk). Over the
// projected bf16 mirror xp [N, r] with f32 row norms xp_sq of the bf16 rows:
//   d = max(|qp|^2 - 2 bf16(qp).xp + xp_sq, 0),
// where the product takes the projected query rounded to bf16 (round to
// nearest even) and accumulates in f32, and |qp|^2 comes from the f32 qp, as
// the reference's mixed-precision distance does. Rows where the mask is
// False never enter; the ov_k smallest (distance, row) come out sorted,
// padded with (+inf, -1). The reference selects with lax.approx_min_k, which
// is exact on the CPU backend; this kernel selects exactly.
//
// What bounds it on the H100: the mirror read, N * r * 2 bytes (403 MB at
// N = 1,048,576 and r = 192, 0.12 ms; 4.03 GB at 10,485,760, 1.2 ms),
// against 2 B N r products, which at the tensor cores' 989 TFLOP/s bf16 rate
// take 0.05 ms at B = 128 over 1M rows (0.52 ms over 10M): one read of the
// mirror bounds it.
//
// Design (r % 8 == 0): bf16_tile.cuh's tensor-core pass, which reads the
// mirror once a query tile, in its filter route (tile_filter.cuh): a bar a
// query from a sample of the mirror's tiles, the survivors under it, their
// ov_k smallest; no [B, N] buffer. K1 on f32 rows takes the same route, so
// the wrapper launches it through csrc/l2_topk.cu's fvdb_l2_topk_filter_tc
// (kind 0: bf16 rows, the query rounded).
//
// fvdb_stage1_select here, the dump route (any r; the wrapper's route where
// r % 8 != 0, and the overflow's): K1's FMA tile pass (l2_tile.cuh) for bf16
// rows and a bf16-rounded query writes the masked distances of a query
// chunk to a [B, N] buffer, and topk_select.cuh's radix select picks each
// query's ov_k.
#include "l2_tile.cuh"
#include "topk_select.cuh"

// xp [N, R] bf16, xp_sq [N], mask [N] (null: every row), qp [B, R] f32;
// dump [B, N] distance scratch; work: fvdb_select_scratch_bytes(B, k) bytes
// of selection scratch; out_* [B, k].
FVDB_EXPORT int fvdb_stage1_select(const __nv_bfloat16* xp,
                                   const float* xp_sq, const uint8_t* mask,
                                   const float* qp, int B, int N, int R, int k,
                                   int S, float* dump, void* work,
                                   float* out_d, int* out_r,
                                   cudaStream_t stream) {
  using namespace fvdb;
  if (k < 1 || B < 1 || N < 1 || R < 1 || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = launch_l2_dump<__nv_bfloat16, true>(xp, xp_sq, mask, 0, qp,
                                                       B, N, R, S, dump,
                                                       stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_select_topk(dump, nullptr, nullptr, N, B, k,
                                             work, out_d, out_r, stream));
}
