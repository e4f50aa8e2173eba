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
// at C = 128, D = 384; 201 MB for B = 1,024), 60 us at 3.35 TB/s. The Gram
// products over the triangle on and above the diagonal are C (C + 1) D =
// 6.3 MFLOP a query: 0.19 ms for B = 1,024 at f32 FMA's 67 TFLOP/s (the
// FMA route below builds both triangles: twice that), 0.04 ms as three
// TF32 products at 495 TFLOP/s. On the tensor cores the gather bounds it.
//
// Two routes, chosen by the wrapper (index/hnsw.py heuristic_route):
//
// The tensor-core route (fvdb_heuristic_kept_tc, _bf16_tc): rows that
// cp.async can copy 16 bytes at a time (f32 rows at D % 4 == 0, bf16 rows
// at D % 8 == 0, the mirror 16-byte aligned).
//  * A block holds R = 64 or 128 candidate rows: two queries at C <= 32
//    (each padded to 32), one at C <= 64 (padded to 64), one at C <= 128
//    (padded to 128). The rows' ids are read once; each 128-byte piece of
//    every row (32 f32 or 64 bf16 dims) is copied by cp.async, 16 bytes a
//    thread, into a ring of four stages, so the next pieces are in flight
//    while the tensor cores take this one (the rows are random, so TMA's
//    tiled copies do not apply). A row's 16-byte chunks are XOR-swizzled
//    by the row's low three bits (the 128-byte swizzle that wgmma reads).
//    Padded rows and dims past D are zero-filled.
//  * The Gram matrix by wgmma from shared memory, its 64 x 64 blocks on or
//    above the diagonal (one at R = 64, three at R = 128): f32 rows split
//    once a stage into TF32 big and small parts as bf16_tile.cuh's route
//    tf32x3 splits them, three products; bf16 rows one exact product. One
//    warpgroup a block takes them, three warpgroups at R = 128 on f32
//    rows. (mma.sync over the 16 x 8 tiles that reach the diagonal, this
//    route's first design below 64 candidates and on bf16 rows, took 77-82
//    us of device time at the f32 prune shape against wgmma's 68 and
//    68-70 at the bf16 link against 61, but 26 at the bf16 prune against
//    28 and 26-28 at C = 32 against 33: scripts/time_tile_routes.py --only
//    k4 --profile on an H100. One kernel takes every shape.)
//  * The sums go to a packed upper triangle a query in shared memory (it
//    takes the ring's place once the last products are done; 33 KB at CP
//    = 128): row i holds g_ij for j >= i, g_ji = g_ij is read there, and
//    sq_i is the diagonal of the same products, as the FMA route takes it.
//  * One warp a query scans: lane l holds the running minima of
//    candidates l, l + 32, ... in registers. A ballot finds the first
//    candidate past the last keep that passes (the minima of those before
//    it have not changed since that keep), then every lane lowers the
//    minima of its later candidates from one row of the triangle. The
//    scan takes a step a keep (at most m), not a step a candidate, and no
//    block barrier.
//
// The FMA route (fvdb_heuristic_kept, _bf16) takes the other rows: one
// block a query builds the whole C x C Gram matrix (both triangles) in
// D-chunks: each 32-dim chunk of the C rows is staged in shared memory and
// every thread accumulates an 8 x 8 block of g in registers. Only the
// finished C x C table of pd goes to shared memory. The sequential keep
// scan then reads one flag per step, because each keep updates a running
// dmin of every later candidate in parallel (one column of pd), so the
// block synchronises only on keeps (at most m of them).
#include "common.cuh"
#include "wgmma.cuh"

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

// ---- the tensor-core route

constexpr int HK_PIECE = 128;  // bytes of a row a stage

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  // the bytes past src_bytes (0 or 16) are zero-filled; L1 is bypassed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage kc of ROWS rows into the slot at dst by THREADS threads: 8 copies
// of 16 bytes a row (eight threads a row's 128 bytes), the chunk ch of row
// r at r * 128 + ((ch ^ (r % 8)) * 16), the 128-byte swizzle. roff[r] is
// the row's first element, -1 for a padded row (zero-filled, as are the
// dims past D).
template <typename T, int THREADS, int ROWS>
__device__ __forceinline__ void issue_stage(uint32_t dst,
                                            const T* __restrict__ x,
                                            const long long* roff, int kc,
                                            int D, int t) {
  constexpr int EP = 16 / (int)sizeof(T);        // elements a copy
  constexpr int DS = HK_PIECE / (int)sizeof(T);  // dims a stage
  constexpr int N = ROWS * 8;
#pragma unroll
  for (int i = 0; i < (N + THREADS - 1) / THREADS; ++i) {
    const int p = t + THREADS * i;
    if (N % THREADS != 0 && p >= N) break;
    const int r = p >> 3, ch = p & 7;
    const int d0 = kc * DS + ch * EP;
    const long long off = roff[r];
    const bool in = off >= 0 && d0 < D;
    cp_async16(dst + r * HK_PIECE + ((ch ^ (r & 7)) << 4),
               in ? static_cast<const void*>(x + off + d0)
                  : static_cast<const void*>(x),
               in ? 16 : 0);
  }
}

// A stage of f32 rows (BYTES of it) as TF32 parts by THREADS threads: big
// = tf32(x) in place, small = tf32(x - big) (exact in f32) at the same
// place of `sml`, 16 bytes at a time, each element once (split where each
// fragment was read, an element was split ~4.7 times over, and the splits
// held the f32 link shape at 0.32 ms against 0.20 without them:
// scripts/time_tile_routes.py --split k4 on an H100).
template <int THREADS, int BYTES>
__device__ __forceinline__ void split_stage(unsigned char* slot,
                                           unsigned char* sml, int t) {
  constexpr int N = BYTES / 16;
#pragma unroll
  for (int i = 0; i < (N + THREADS - 1) / THREADS; ++i) {
    const int p = t + THREADS * i;
    if (N % THREADS != 0 && p >= N) break;
    uint4 v = *reinterpret_cast<const uint4*>(slot + 16 * p), b, s;
    uint32_t* vv = &v.x;
    uint32_t* bb = &b.x;
    uint32_t* ss = &s.x;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      bb[e] = tf32_rna(__uint_as_float(vv[e]));
      ss[e] = tf32_rna(__uint_as_float(vv[e]) - __uint_as_float(bb[e]));
    }
    *reinterpret_cast<uint4*>(slot + 16 * p) = b;
    *reinterpret_cast<uint4*>(sml + 16 * p) = s;
  }
}

// Offset of g_ij (i <= j) in the packed upper triangle of a CP x CP
// matrix: row i holds columns i .. CP - 1.
__host__ __device__ constexpr int tri_at(int i, int j, int cp) {
  return i * cp - i * (i - 1) / 2 + (j - i);
}

// The keep scan of query b by one warp over its triangle tq.
template <int CP>
__device__ __forceinline__ void keep_scan(const float* tq,
                                          const int* __restrict__ cand_ids,
                                          const float* __restrict__ cand_d,
                                          int b, int C, int m,
                                          uint8_t* __restrict__ kept,
                                          int lane) {
  constexpr int NW = CP / 32;  // candidates a lane
  float dist[NW], dmin[NW], sq[NW];
  bool valid[NW];
  unsigned keptw[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const int c = lane + 32 * j;
    const int id = c < C ? cand_ids[(size_t)b * C + c] : -1;
    const float d = c < C ? cand_d[(size_t)b * C + c] : INFINITY;
    valid[j] = id >= 0 && isfinite(d);
    dist[j] = d;
    dmin[j] = INFINITY;
    sq[j] = tq[tri_at(c, c, CP)];
    keptw[j] = 0u;
  }
  int last = -1;
  for (int cnt = 0; cnt < m; ++cnt) {
    // the first candidate past the last keep that passes its test
    int next = CP;
#pragma unroll
    for (int j = NW - 1; j >= 0; --j) {
      const unsigned bal = __ballot_sync(
          FULL, valid[j] && dist[j] < dmin[j] && lane + 32 * j > last);
      if (bal) next = 32 * j + __ffs(bal) - 1;
    }
    if (next == CP) break;
    last = next;
    const int jn = next >> 5, ln = next & 31;
    float sqn = 0.f;
#pragma unroll
    for (int j = 0; j < NW; ++j)
      if (j == jn) {
        sqn = sq[j];
        keptw[j] |= 1u << ln;
      }
    sqn = __shfl_sync(FULL, sqn, ln);
    // row `next` of the triangle: g[next][r] at row[r] for r >= next
    const float* row = tq + tri_at(next, next, CP) - next;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const int r = lane + 32 * j;
      if (r > next) dmin[j] = fminf(dmin[j], (sq[j] - 2.f * row[r]) + sqn);
    }
  }
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const int c = lane + 32 * j;
    if (c < C) kept[(size_t)b * C + c] = (uint8_t)((keptw[j] >> lane) & 1u);
  }
}

// d[64 x 64] (+)= A[64 x 8] . B[8 x 64]^T in TF32, A and B K-major f32
// tiles in shared memory given by their descriptors (128-byte swizzle: a
// step of 8 values, 32 bytes, adds 2 to a descriptor's address field);
// scale_d 0 overwrites d. d as in wgmma.cuh's Wgmma.
__device__ __forceinline__ void wgmma_tf32_ss64(float (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

constexpr int HK_STAGES = 4;  // ring slots, then (f32 rows) the small parts

// A block's shape: R candidate rows (64 or 128) in its ring, CP of them a
// query (32, 64 or 128: C padded), R / CP queries; the 64 x 64 blocks of
// the R x R Gram matrix on or above the diagonal (one at R = 64, three at
// 128) taken by NWG warpgroups: three on f32 rows at R = 128 (one block
// each), else one (all of them).
template <typename T, int R>
__host__ __device__ constexpr int hk_warpgroups() {
  return sizeof(T) == 4 && R == 128 ? 3 : 1;
}
template <typename T, int R>
__host__ __device__ constexpr int hk_smem() {  // + 1,024 to align the ring
  return 1024 + (HK_STAGES + (sizeof(T) == 4)) * R * HK_PIECE;
}
// blocks an SM: three warpgroups take one; one warpgroup with three
// blocks' sums takes three (168 registers a thread), with one four (128)
template <typename T, int R>
__host__ __device__ constexpr int hk_blocks_per_sm() {
  return hk_warpgroups<T, R>() == 3 ? 1 : R == 128 ? 3 : 4;
}

// The ring as above (R rows, 128 bytes a row a stage, 1,024-byte aligned,
// so that a slot is a 128-byte-swizzled K-major tile as wgmma reads it),
// f32 stages split once into big (in place) and small parts, and the Gram
// matrix's 64 x 64 blocks on or above the diagonal by wgmma, A and B both
// from shared memory (at R = 64 and CP = 32 the block holds two queries'
// 32 x 32 triangles, and their cross products go unused). Each product is
// summed from zero in an accumulator of its own and then added to f32
// sums (a chain would cut it at the partial sum's size, as bf16_tile.cuh
// says): on f32 rows each k8 big . big product, with the big . small and
// small . big products chained onto it (the small products in an
// accumulator of their own, as bf16_tile.cuh keeps them, took 32 more
// registers a thread and spilled at 168); on bf16 rows a stage's four
// m64n64k16 products, each exact, chained as bf16_tile.cuh chains a step
// on bf16 rows. mma.sync's m16n8k8 TF32 products ran at ~86 TFLOP/s here
// (the f32 link shape 0.147 ms with the big product alone, 0.315 with the
// three: scripts/time_tile_routes.py --split k4 on an H100), so the 16 x
// 8 tiles' saving of work did not pay for their rate.
template <typename T, int R, int CP>
__global__ void __launch_bounds__(128 * hk_warpgroups<T, R>(),
                                  hk_blocks_per_sm<T, R>())
    heuristic_kept_tc_kernel(const T* __restrict__ x,
                             const int* __restrict__ cand_ids,
                             const float* __restrict__ cand_d, int B, int C,
                             int D, int m, uint8_t* __restrict__ kept) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int NWG = hk_warpgroups<T, R>(), NT_ = 128 * NWG;
  constexpr int QB = R / CP, SLOT = R * HK_PIECE;
  constexpr int NB = (R == 128 ? 3 : 1) / NWG;  // blocks a warpgroup
  constexpr int TRI = CP * (CP + 1) / 2;         // a query's triangle
  constexpr int DS = HK_PIECE / (int)sizeof(T);  // dims a stage
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ long long roff[R];  // a row's first element; -1: zeros
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sml = smem + HK_STAGES * SLOT;

  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const int q0 = blockIdx.x * QB;
  if (t < R) {
    const int b = q0 + t / CP, c = t % CP;
    roff[t] = b < B && c < C
                  ? (long long)max(cand_ids[(size_t)b * C + c], 0) * D
                  : -1;
  }
  __syncthreads();
  const uint32_t ring = smem_addr(smem);
  const int KS = (D + DS - 1) / DS;  // stages of the rows
#pragma unroll
  for (int s = 0; s < HK_STAGES - 1; ++s) {
    if (s < KS) issue_stage<T, NT_, R>(ring + s * SLOT, x, roff, s, D, t);
    cp_async_commit();
  }
  // block i of warpgroup u: A rows a0(i) .. + 63 against B rows b0(i) ..
  // + 63, the blocks (0, 0), (0, 64), (64, 64) in turn
  const int u = t >> 7, tw = t & 127;
  auto a0 = [&](int i) { return u + i == 2 ? 64 : 0; };
  auto b0 = [&](int i) { return u + i == 0 ? 0 : 64; };
  float acc[NB][32], pb[2][32];
#pragma unroll
  for (int i = 0; i < NB; ++i)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[i][e] = 0.f;
  for (int kc = 0; kc < KS; ++kc) {
    cp_async_wait<HK_STAGES - 2>();
    fence_proxy_async();  // this thread's copies, to wgmma's reads
    __syncthreads();  // stage kc is in; every warpgroup is past stage kc - 1
    const int kn = kc + HK_STAGES - 1;
    if (kn < KS)
      issue_stage<T, NT_, R>(ring + (kn % HK_STAGES) * SLOT, x, roff, kn, D,
                             t);
    cp_async_commit();
    unsigned char* slot = smem + (kc % HK_STAGES) * SLOT;
    if constexpr (F32) {
      split_stage<NT_, SLOT>(slot, sml, t);
      fence_proxy_async();  // the split parts, to wgmma's reads
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const uint64_t da = sw128_desc(smem_addr(slot + a0(i) * HK_PIECE));
      const uint64_t db = sw128_desc(smem_addr(slot + b0(i) * HK_PIECE));
      if constexpr (F32) {
        const uint64_t da_s = sw128_desc(smem_addr(sml + a0(i) * HK_PIECE));
        const uint64_t db_s = sw128_desc(smem_addr(sml + b0(i) * HK_PIECE));
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // k8 steps 2 h and 2 h + 1
          fence_regs(pb[0]);
          fence_regs(pb[1]);
          wgmma_fence();
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int j = 2 * h + jj;
            wgmma_tf32_ss64(pb[jj], da + 2 * j, db + 2 * j, 0);
            wgmma_tf32_ss64(pb[jj], da_s + 2 * j, db + 2 * j, 1);
            wgmma_tf32_ss64(pb[jj], da + 2 * j, db_s + 2 * j, 1);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(pb[0]);
          fence_regs(pb[1]);
#pragma unroll
          for (int e = 0; e < 32; ++e) acc[i][e] += pb[0][e] + pb[1][e];
        }
      } else {  // the stage's four k16 steps, chained
        fence_regs(pb[0]);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Wgmma<64>::mma(pb[0], da + 2 * j, db + 2 * j, j > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(pb[0]);
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[i][e] += pb[0][e];
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the triangles take its place
  float* tq = reinterpret_cast<float*>(smem);
  // thread tw holds d[e] at row 16 (tw / 32) + (tw % 32) / 4 + 8 ((e / 2)
  // % 2) and column 8 (e / 4) + 2 (tw % 4) + e % 2 of its block; an entry
  // goes to its query's triangle
#pragma unroll
  for (int i = 0; i < NB; ++i)
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int r =
          a0(i) + 16 * (tw >> 5) + ((tw & 31) >> 2) + 8 * ((e >> 1) & 1);
      const int c = b0(i) + 8 * (e >> 2) + 2 * (tw & 3) + (e & 1);
      if (r <= c && r / CP == c / CP)
        tq[(r / CP) * TRI + tri_at(r % CP, c % CP, CP)] = acc[i][e];
    }
  __syncthreads();
  if (w < QB && q0 + w < B)
    keep_scan<CP>(tq + w * TRI, cand_ids, cand_d, q0 + w, C, m, kept, lane);
}

template <typename T, int R, int CP>
cudaError_t launch_kept_tc(const T* x, const int* cand_ids,
                           const float* cand_d, int B, int C, int D, int m,
                           uint8_t* kept, cudaStream_t stream) {
  constexpr int smem = hk_smem<T, R>();
  static_assert(4 * (R / CP) * CP * (CP + 1) / 2 + 1024 <= smem,
                "the triangles fit the ring");
  static int cap[64];
  cudaError_t e = raise_smem_cap(
      reinterpret_cast<const void*>(heuristic_kept_tc_kernel<T, R, CP>), smem,
      cap);
  if (e != cudaSuccess) return e;
  constexpr int QB = R / CP;
  heuristic_kept_tc_kernel<T, R, CP>
      <<<(B + QB - 1) / QB, 128 * hk_warpgroups<T, R>(), smem, stream>>>(
          x, cand_ids, cand_d, B, C, D, m, kept);
  return cudaGetLastError();
}

template <typename T>
cudaError_t heuristic_kept_tc(const T* x, const int* cand_ids,
                              const float* cand_d, int B, int C, int D, int m,
                              uint8_t* kept, cudaStream_t stream) {
  constexpr int EP = 16 / (int)sizeof(T);
  if (B < 1 || C < 1 || C > CMAX || D < EP || D % EP != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return cudaErrorInvalidValue;
  if (C <= 32)
    return launch_kept_tc<T, 64, 32>(x, cand_ids, cand_d, B, C, D, m, kept,
                                     stream);
  if (C <= 64)
    return launch_kept_tc<T, 64, 64>(x, cand_ids, cand_d, B, C, D, m, kept,
                                     stream);
  return launch_kept_tc<T, 128, 128>(x, cand_ids, cand_d, B, C, D, m, kept,
                                     stream);
}

}  // namespace fvdb

// x [N, D]; cand_ids, cand_d [B, C] (C <= 128); kept [B, C] (0/1 bytes).
// The FMA route.
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

// The tensor-core route over f32 rows: D % 4 == 0, x 16-byte aligned.
FVDB_EXPORT int fvdb_heuristic_kept_tc(const float* x, const int* cand_ids,
                                       const float* cand_d, int B, int C,
                                       int D, int m, uint8_t* kept,
                                       cudaStream_t stream) {
  return static_cast<int>(fvdb::heuristic_kept_tc(x, cand_ids, cand_d, B, C,
                                                  D, m, kept, stream));
}

// The tensor-core route over bf16 rows: D % 8 == 0, x 16-byte aligned.
FVDB_EXPORT int fvdb_heuristic_kept_bf16_tc(const __nv_bfloat16* x,
                                            const int* cand_ids,
                                            const float* cand_d, int B, int C,
                                            int D, int m, uint8_t* kept,
                                            cudaStream_t stream) {
  return static_cast<int>(fvdb::heuristic_kept_tc(x, cand_ids, cand_d, B, C,
                                                  D, m, kept, stream));
}
