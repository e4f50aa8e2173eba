// K16, product quantization: encode, decode, ADC tables and the ADC scan.
//
// Replaces the JAX package's pq_encode (ops/quantization.py:87), pq_decode
// (:106), pq_adc_table (:114) and pq_adc_distances (:131). A codebook is
// [M, K, Ds] f32 (M subspaces of Ds dims, K <= 256 codes each); a row's
// subvector m is dims [m Ds, (m + 1) Ds).
//
//  * encode: codes[n][m] = the first k of least |x|^2 - 2 x.c_k + |c_k|^2
//    (the reference's expansion, unclamped, so near-ties fall the same
//    way), u8 [N, M].
//  * decode: out[n][m Ds + j] = c[m][codes[n][m]][j] (a code past K reads
//    code K - 1, as the reference's clamped gather).
//  * table: t[b][m][k] = |q|^2 - 2 q.c_k + |c_k|^2 over subspace m, [B, M, K].
//  * scan: out[b][n] = sum over m, in order, of t[b][m][codes[n][m]] (a code
//    past K adds 0, as the reference's one-hot product), [B, N] f32.
//
// What bounds it on the H100 (1,000,000 rows of 384 dims, K = 256): encode
// is 2 N K D operations (197 GFLOP: 1.19 ms as three TF32 products at 495
// TFLOP/s, 2.93 ms in f32 FMA at 67; its rows are 1.54 GB, 0.46 ms);
// decode writes N D f32 (0.46 ms); the scan writes B N f32 (B = 128: 512
// MB, 0.15 ms) and looks up B N M table entries in shared memory (M = 48:
// 6.1 G, 24.6 GB, ~0.74 ms at 128 bytes a clock an SM without a bank
// conflict); the tables are small (B M K f32).
//
// Encode, two routes (ops/quantization.py pq_encode_route):
//  * "tf32x3" (Ds % 4 == 0, K >= 64, x and the codebook 16-byte aligned):
//    K6's tile pass (lloyd_tile.cuh's mainloop: the TMA ring of 128 rows x
//    32 dims, three TF32 wgmma products a k8 step, two passes of 128 codes)
//    with the codebook transposed to a [K, M Ds] centroid matrix (code k's
//    row holds every subspace's codeword k), split into TF32 parts once a
//    call. A unit is 128 rows and G subspaces whose columns fill whole
//    stages (Ds = 8: four, each k8 step one; Ds = 16: two; Ds = 48: two in
//    three stages); other Ds take one subspace a unit, the k8 steps past
//    Ds skipped and, at Ds % 8 == 4, the A columns past Ds zeroed. A
//    persistent grid of one block an SM walks the units (row tile major:
//    a tile's subspaces run together, its rows from L2), so the ring runs
//    on across them; each stage also brings the pass's |c|^2 of the unit's
//    subspaces by a bulk copy on the stage's barrier. A subspace's k8
//    steps chain into one accumulator on the tensor cores. At Ds = 8 the
//    epilogue is the bound (N M K values): a lane keeps a row's least e =
//    |c|^2 - 2 x.c as a key carrying the code in its low mantissa bits (a
//    key and a min a value on the half-rate pipe), then counts the e
//    within a near-tie threshold of the least by a saturated FMA (the
//    full-rate pipe); the quad merges. A row with two codes within 1e-5
//    (|x|^2 + max |c|^2) of each other (the chained products err a few
//    1e-6 of that; the keys' 32 ulp allowed for) is taken again by the
//    warp over all K codes by f32 FMA in the FMA route's order ((|x|^2 -
//    2 x.c) + |c|^2, each sum one FMA after another; ties to the lower
//    code), so a code differs from the plain version's only at an f32
//    near-tie.
//  * "fma": a block takes 256 rows of one subspace, with the subspace's
//    codebook in shared memory transposed to [Ds][K'] (K' = K rounded up
//    to 32) and the rows' subvectors transposed to [Ds][256]; a thread
//    owns a row and walks the codes 32 at a time, 32 dot products in
//    registers. A subspace too wide for that (Ds > 113 at K = 256) takes
//    the same walk with each tile of 32 codes and the rows staged 32 dims
//    at a time (the same sums, so the same codes).
// Decode, two routes (ops/quantization.py pq_decode_route): a gather that
// writes N D f32 and reads little (the codes, N M bytes; the codebook, K D
// f32), so the stores bound it.
//  * "tile" (Ds % 4 == 0, codes, codebook and output 16-byte aligned, a
//    subspace's codebook within DEC_CB, M <= DEC_MAX_M): a persistent grid
//    of (subspace group, row range) blocks, one an SM. A block holds its
//    group's codebook in shared memory, loaded once (G subspaces, G K Ds
//    f32 <= 192 KB: Ds = 48 four, Ds = 8 24, so two blocks read a tile's
//    codes at M = 8 and 48; 5-7% faster than 96 KB and two blocks an SM.
//    Through L1 instead, the codewords took as long at M = 8 and 26%
//    longer at M = 48: scripts/pq_decode_variants.py). It walks its rows in
//    tiles whose codes (whole rows, R M bytes) it stages by 16-byte
//    cp.async, the next tile's while it writes this one's, so a code is
//    read from global memory once a tile. A thread owns one float4 of a
//    group's row segment (its subspace and offset set once, no division
//    after) and takes every RP-th row of the tile, four at a time: four
//    code bytes and four 16-byte codeword reads from shared memory, then
//    four 16-byte streaming stores (st.global.cs, so the 1.5 GB of rows does not push the codes
//    out of L2). The blocks of one row range run together, so a tile's
//    codes come from HBM once and from L2 for the other groups. Ds = 8, 16
//    and 48 are compile-time; other Ds % 4 == 0 take the same kernel with
//    Ds at run time.
//  * "any" (other Ds, or a pointer off 16 bytes): a block stages a tile's
//    codes byte by byte, each thread owns columns (their subspace and
//    offset found once a tile) and walks the tile's rows with 4-byte
//    streaming stores, the codebook read through L1.
// Table: a block a (query, subspace), one thread a code.
//
// Scan: a persistent grid of (query group, row range) blocks, about one
// a resident slot, each staging its group's tables once into shared
// memory as lut[m][c][q] (queries innermost; a code past K holds 0), then
// scanning its rows: the blocks of one row range run together, so its
// codes come from L2. QB = 16, 8, 4, 2 or 1 queries a block (the most
// whose tables fit; M = 8: 16, 128 KB; M = 48: 4, 192 KB); past four, L =
// QB / 4 lanes a row, each taking four queries' entries of a (subspace,
// code) in one 16-byte shared load, the L lanes of a row one contiguous
// chunk (random codes conflict less in shared memory than with 4-byte
// loads; at M = 48 they still bound the scan). A lane takes two rows at a
// time, so their code loads (16, 8 or 4 bytes where M allows) are in
// flight together (one row at a time, the M = 8 scan waited on them).
// Each query's sum adds the subspaces in order in f32, as the plain
// version (bit for bit); the stores of a warp are runs of consecutive rows
// of each query. Past 227 subspaces (one query's tables over a block's
// shared memory) the scan runs in launches of 96 subspaces, each adding to
// the sums the last one stored.
#include "lloyd_tile.cuh"

namespace fvdb {

constexpr int ER = NT;         // rows an encode block, one a thread
constexpr int KT = 32;         // codes a register tile
constexpr int SCAN_T = 1024;     // threads of a scan block
constexpr int SCAN_U = 2;        // rows a lane takes at once in the scan
constexpr int SCAN_MIN_ROWS = 2048;  // rows a scan block at least
constexpr int MAX_SMEM = 232448;  // a block's shared memory on Hopper
constexpr int LUT_K = 256;     // codes a table row in shared memory
constexpr int DC = 32;         // dims a slice of the wide encode
constexpr int SCAN_MC = 96;    // subspaces a launch of a chunked scan
constexpr int DEC_T = 768;     // threads of a decode block (one an SM)
constexpr int DEC_CB = 196608;  // bytes of codebook a decode block holds
constexpr int DEC_CODES = 8192;  // bytes of codes a staged tile at most
constexpr int DEC_MAX_M = 512;   // subspaces the tile route takes (16 rows)
constexpr int DEC_U = 4;       // rows a thread writes at once
constexpr int DEC_ANY_CODES = 32768;  // bytes of codes an "any" tile

__host__ __device__ inline int pad32(int k) {
  return (k + KT - 1) / KT * KT;
}

inline size_t encode_smem(int K, int Ds) {
  const int kp = pad32(K);
  return sizeof(float) * ((size_t)Ds * kp + kp + (size_t)Ds * ER);
}

__global__ void __launch_bounds__(NT) pq_encode_kernel(
    const float* __restrict__ x, const float* __restrict__ cents, int N,
    int M, int K, int Ds, uint8_t* __restrict__ codes) {
  extern __shared__ __align__(16) float smem[];
  const int kp = pad32(K);
  float* cb = smem;             // [Ds][kp]
  float* c_sq = cb + Ds * kp;   // [kp]
  float* xs = c_sq + kp;        // [Ds][ER]
  const int t = threadIdx.x, m = blockIdx.y;
  const long long n0 = (long long)blockIdx.x * ER;
  const long long D = (long long)M * Ds;
  const float* c = cents + (size_t)m * K * Ds;
  for (int i = t; i < kp * Ds; i += NT) {
    const int k = i / Ds, d = i % Ds;
    cb[d * kp + k] = k < K ? c[(size_t)k * Ds + d] : 0.f;
  }
  for (int i = t; i < ER * Ds; i += NT) {
    const int r = i / Ds, d = i % Ds;
    const long long n = n0 + r;
    xs[d * ER + r] = n < N ? x[n * D + (long long)m * Ds + d] : 0.f;
  }
  __syncthreads();
  for (int k = t; k < kp; k += NT) {
    float s = 0.f;
    for (int d = 0; d < Ds; ++d) s = fmaf(cb[d * kp + k], cb[d * kp + k], s);
    c_sq[k] = s;
  }
  float x_sq = 0.f;
  for (int d = 0; d < Ds; ++d)
    x_sq = fmaf(xs[d * ER + t], xs[d * ER + t], x_sq);
  __syncthreads();
  float best = INFINITY;
  int best_k = 0;
  for (int k0 = 0; k0 < K; k0 += KT) {
    float acc[KT];
#pragma unroll
    for (int j = 0; j < KT; ++j) acc[j] = 0.f;
    for (int d = 0; d < Ds; ++d) {
      const float xv = xs[d * ER + t];
      const float4* cp = reinterpret_cast<const float4*>(cb + d * kp + k0);
#pragma unroll
      for (int j = 0; j < KT / 4; ++j) {
        const float4 cv = cp[j];  // the same address in every lane
        acc[4 * j] = fmaf(xv, cv.x, acc[4 * j]);
        acc[4 * j + 1] = fmaf(xv, cv.y, acc[4 * j + 1]);
        acc[4 * j + 2] = fmaf(xv, cv.z, acc[4 * j + 2]);
        acc[4 * j + 3] = fmaf(xv, cv.w, acc[4 * j + 3]);
      }
    }
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const int k = k0 + j;
      const float dist = (x_sq - 2.f * acc[j]) + c_sq[k];
      if (k < K && dist < best) {  // ascending k: ties keep the first
        best = dist;
        best_k = k;
      }
    }
  }
  const long long n = n0 + t;
  if (n < N) codes[n * M + m] = static_cast<uint8_t>(best_k);
}

// The encode for a codebook over a block's shared memory: per tile of KT
// codes, the codebook's and the rows' dims DC at a time. Each sum adds the
// dims in ascending order, as pq_encode_kernel's, so the codes agree.
__global__ void __launch_bounds__(NT) pq_encode_wide_kernel(
    const float* __restrict__ x, const float* __restrict__ cents, int N,
    int M, int K, int Ds, uint8_t* __restrict__ codes) {
  __shared__ __align__(16) float cb[DC][KT];
  __shared__ float xs[DC][ER];
  __shared__ float c_sq[KT];
  const int t = threadIdx.x, m = blockIdx.y;
  const long long n0 = (long long)blockIdx.x * ER;
  const long long D = (long long)M * Ds;
  const float* c = cents + (size_t)m * K * Ds;
  float x_sq = 0.f, best = INFINITY;
  int best_k = 0;
  for (int k0 = 0; k0 < K; k0 += KT) {
    float acc[KT];
#pragma unroll
    for (int j = 0; j < KT; ++j) acc[j] = 0.f;
    float cs = 0.f;  // thread t < KT: code k0 + t's |c|^2
    for (int d0 = 0; d0 < Ds; d0 += DC) {
      const int dc = min(DC, Ds - d0);
      __syncthreads();
      for (int i = t; i < KT * dc; i += NT) {
        const int j = i / dc, d = i % dc;
        cb[d][j] = k0 + j < K ? c[(size_t)(k0 + j) * Ds + d0 + d] : 0.f;
      }
      for (int i = t; i < ER * dc; i += NT) {
        const int r = i / dc, d = i % dc;
        const long long n = n0 + r;
        xs[d][r] = n < N ? x[n * D + (long long)m * Ds + d0 + d] : 0.f;
      }
      __syncthreads();
      if (k0 == 0)
        for (int d = 0; d < dc; ++d) x_sq = fmaf(xs[d][t], xs[d][t], x_sq);
      if (t < KT)
        for (int d = 0; d < dc; ++d) cs = fmaf(cb[d][t], cb[d][t], cs);
      for (int d = 0; d < dc; ++d) {
        const float xv = xs[d][t];
        const float4* cp = reinterpret_cast<const float4*>(cb[d]);
#pragma unroll
        for (int j = 0; j < KT / 4; ++j) {
          const float4 cv = cp[j];  // the same address in every lane
          acc[4 * j] = fmaf(xv, cv.x, acc[4 * j]);
          acc[4 * j + 1] = fmaf(xv, cv.y, acc[4 * j + 1]);
          acc[4 * j + 2] = fmaf(xv, cv.z, acc[4 * j + 2]);
          acc[4 * j + 3] = fmaf(xv, cv.w, acc[4 * j + 3]);
        }
      }
    }
    if (t < KT) c_sq[t] = cs;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const int k = k0 + j;
      const float dist = (x_sq - 2.f * acc[j]) + c_sq[j];
      if (k < K && dist < best) {  // ascending k: ties keep the first
        best = dist;
        best_k = k;
      }
    }
  }
  const long long n = n0 + t;
  if (n < N) codes[n * M + m] = static_cast<uint8_t>(best_k);
}

// ---- encode, route "tf32x3": K6's tile pass ----

constexpr float PQ_TOL = 1e-5f;  // of |x|^2 + max |c|^2: a near-tie
constexpr float PQ_PAD = 3e38f;  // |c|^2 past K: finite, and never least
// |c|^2 of a pass's 128 codes for each of a unit's (up to 4) subspaces: a
// slot of the encode's second ring, filled on the stage's barrier
constexpr int PQ_CS_SLOT = 4 * LT_CENTS * 4;
constexpr int PQ_SMEM = LT_SMEM + LT_STAGES * PQ_CS_SLOT;

// TMA's one-dimensional bulk copy: bytes (a multiple of 16) from src to
// shared memory at dst, counted on barrier b.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(smem_addr(b))
      : "memory");
}

// The codebook [M, K, Ds] as the tile pass's centroid matrix: its
// transpose [K, M Ds] split into TF32 parts [2, K, M Ds] (big, small), as
// split_tf32_kernel splits K6's centroids.
__global__ void pq_split_kernel(const float* __restrict__ cents, int M,
                                int K, int Ds, float* __restrict__ parts) {
  const long long D = (long long)M * Ds, n = (long long)K * D;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long k = i / D;
    const int col = (int)(i - k * D), m = col / Ds, d = col - m * Ds;
    const float v = cents[((size_t)m * K + k) * Ds + d];
    const uint32_t big = tf32_rna(v);
    parts[i] = __uint_as_float(big);
    parts[n + i] = __uint_as_float(tf32_rna(v - __uint_as_float(big)));
  }
}

// Block m: |c_k|^2 of subspace m's codes, one FMA after another over its
// dims (as pq_encode_kernel sums them), into c_sq [2][M][128] (pass, then
// subspace: a unit's subspaces of a pass lie together; PQ_PAD past K, so
// those codes never win), and their largest into c_max [M].
__global__ void __launch_bounds__(NT) pq_code_sq_kernel(
    const float* __restrict__ cents, int M, int K, int Ds,
    float* __restrict__ c_sq, float* __restrict__ c_max) {
  __shared__ float part[NT / 32];
  const int m = blockIdx.x;
  float mx = 0.f;
  for (int k = threadIdx.x; k < 2 * LT_CENTS; k += NT) {
    float s = PQ_PAD;
    if (k < K) {
      const float* c = cents + ((size_t)m * K + k) * Ds;
      s = 0.f;
      for (int d = 0; d < Ds; ++d) s = fmaf(c[d], c[d], s);
      mx = fmaxf(mx, s);
    }
    c_sq[((size_t)(k / LT_CENTS) * M + m) * LT_CENTS + k % LT_CENTS] = s;
  }
#pragma unroll
  for (int off = 16; off; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = mx;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < NT / 32; ++w) mx = fmaxf(mx, part[w]);
    c_max[m] = mx;
  }
}

// e's key: its five low mantissa bits replaced by idx, so one min orders
// (e, idx) where e differs by more than 32 ulp (nearer, the two lie within
// the near-tie threshold's PQ_KEY term, and the row is taken again).
__device__ __forceinline__ float pq_key(float e, unsigned idx) {
  return __uint_as_float((__float_as_uint(e) & ~31u) | idx);
}
constexpr float PQ_KEY = 1.6e-5f;  // of |e|: two keys' error, with room
constexpr float PQ_BIG = 1073741824.f;  // 2^30: a saturated step's slope

// The near-tie threshold of a row whose least key is best: tb = PQ_TOL
// (|x|^2 + max |c|^2), the tensor cores' error, and the keys'.
__device__ __forceinline__ float pq_thr(float tb, float best) {
  return tb + PQ_KEY * fabsf(best);
}

// A lane's view of one row in one subspace: its least e = |c|^2 - 2 x.c
// (a key, pq_key) and that code, and how many of its codes' e lie within
// the near-tie threshold of the least (counted against the least known at
// the time, so never fewer than there are).
struct Best {
  float best, cnt;
  int code;
};

// A pass of 128 codes from c0 into the two rows' Best (row rloc + 8 h; tb
// their thresholds' base): p are the tile pass's products, p[i] of row h
// = (i / 2) % 2 and code c0 + 8 (i / 4) + 2 (lane % 4) + i % 2, overwritten
// with e; cs the pass's |c|^2 of the subspace in shared memory [128]. The
// epilogue bounds the encode at Ds = 8 (N M K values), so it spends few
// instructions of the card's half-rate pipe (compare, min, logic): a first
// sweep takes each row's least key (a key and a min a value), a second
// counts the e within the threshold of the new least by a saturated FMA
// and an add (the full-rate pipe). Earlier passes' codes are lower, so a
// tie keeps them.
__device__ __forceinline__ void pq_pass(float (&p)[64], const float* cs,
                                        int c0, int lane,
                                        const float (&tb)[2],
                                        Best (&b)[2]) {
  float lm[2][4];  // four running minima a row (q % 4): short chains
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const float2 cc =
        *reinterpret_cast<const float2*>(cs + 8 * q + 2 * (lane & 3));
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float e = fmaf(-2.f, p[4 * q + t], (t & 1) ? cc.y : cc.x);
      const float k = pq_key(e, 2 * q + (t & 1));
      p[4 * q + t] = e;
      lm[t >> 1][q & 3] = q < 4 && (t & 1) == 0 ? k
                                                : fminf(lm[t >> 1][q & 3], k);
    }
  }
  float lb[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    lb[h] = fminf(fminf(lm[h][0], lm[h][1]), fminf(lm[h][2], lm[h][3]));
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    Best& r = b[h];
    const float nb = fminf(r.best, lb[h]);
    const float thr = pq_thr(tb[h], nb);
    const float cut = (nb + thr) * PQ_BIG;
    float cs4[4] = {r.best <= nb + thr ? r.cnt : 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int q = 0; q < 16; ++q)
#pragma unroll
      for (int t = 2 * h; t < 2 * h + 2; ++t)
        cs4[q & 3] += __saturatef(fmaf(p[4 * q + t], -PQ_BIG, cut));
    const float cnt = (cs4[0] + cs4[1]) + (cs4[2] + cs4[3]);
    const unsigned idx = __float_as_uint(lb[h]) & 31u;
    r.code = lb[h] < r.best
                 ? c0 + 8 * (int)(idx >> 1) + 2 * (lane & 3) + (int)(idx & 1)
                 : r.code;
    r.best = nb;
    r.cnt = cnt;
  }
}

// The quad's Best of a row (tb its threshold's base): the least (key,
// code) over the four lanes, and the count of the lanes whose least lies
// within the threshold of it (the others' e all lie past it).
__device__ __forceinline__ void pq_quad_merge(Best& b, float tb) {
  float bq = b.best;
  int cq = b.code;
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const float ob = __shfl_xor_sync(FULL, bq, off);
    const int oc = __shfl_xor_sync(FULL, cq, off);
    if (lex_less(ob, oc, bq, cq)) {
      bq = ob;
      cq = oc;
    }
  }
  float cnt = b.best <= bq + pq_thr(tb, bq) ? b.cnt : 0.f;
  cnt += __shfl_xor_sync(FULL, cnt, 1);
  cnt += __shfl_xor_sync(FULL, cnt, 2);
  b = Best{bq, cnt, cq};
}

// A row's code in one subspace by f32 FMA over all K codes, as the FMA
// route takes it: (|x|^2 - 2 x.c) + |c|^2, each sum one FMA after another
// over the dims; ties to the lower code. xr the row's subvector, cb the
// subspace's codebook [K, Ds] (Ds % 4 == 0, both 16-byte aligned), cs its
// |c|^2 (code k at cs[(k / 128) M 128 + k % 128], c_sq's layout); the
// warp's lanes take every 32nd code each and merge. Every lane of the warp
// calls it, with the same row.
__device__ int pq_rescan(const float* __restrict__ xr,
                         const float* __restrict__ cb,
                         const float* __restrict__ cs, int M, int K, int Ds,
                         int lane) {
  float xx = 0.f;
  for (int d = 0; d < Ds; d += 4) {
    const float4 v = ld4(xr + d);
    xx = fmaf(v.x, v.x, xx);
    xx = fmaf(v.y, v.y, xx);
    xx = fmaf(v.z, v.z, xx);
    xx = fmaf(v.w, v.w, xx);
  }
  float best = INFINITY;
  int code = 0;
  for (int k = lane; k < K; k += 32) {
    const float* c = cb + (size_t)k * Ds;
    float dot = 0.f;
    for (int d = 0; d < Ds; d += 4) {
      const float4 v = ld4(xr + d), cv = ld4(c + d);
      dot = fmaf(v.x, cv.x, dot);
      dot = fmaf(v.y, cv.y, dot);
      dot = fmaf(v.z, cv.z, dot);
      dot = fmaf(v.w, cv.w, dot);
    }
    const float dist =
        (xx - 2.f * dot) +
        __ldg(cs + (size_t)(k / LT_CENTS) * M * LT_CENTS + k % LT_CENTS);
    if (dist < best) {  // ascending k: ties keep the first
      best = dist;
      code = k;
    }
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float ob = __shfl_xor_sync(FULL, best, off);
    const int oc = __shfl_xor_sync(FULL, code, off);
    if (lex_less(ob, oc, best, code)) {
      best = ob;
      code = oc;
    }
  }
  return code;
}

// The encode on the tile pass (the head comment): tmx maps x [N, D], tmb /
// tms the transposed codebook's parts [K, D]; c_sq [2][M][128] and c_max
// [M] from pq_code_sq_kernel. A unit is G subspaces whose columns fill
// whole stages: at DS = 8 (G = 4) each k8 step is a subspace, at DS = 16
// (G = 2) two, at DS = 48 (G = 2) the pair's 96 columns are three stages;
// those shapes are compile-time. DS = 0: any other Ds % 4 == 0 at G = 1,
// one subspace in ceil(Ds / 32) stages, its k8 steps past Ds skipped and,
// at Ds % 8 == 4, the A columns past Ds zeroed. Each stage brings the
// pass's |c|^2 of the unit's subspaces into a second ring beside the tile
// ring, on the stage's barrier, for the epilogues that fall in it.
template <int G, int DS>
__global__ void __launch_bounds__(LT_THREADS, 1) pq_encode_tc_kernel(
    const __grid_constant__ CUtensorMap tmx,
    const __grid_constant__ CUtensorMap tmb,
    const __grid_constant__ CUtensorMap tms, const float* __restrict__ x,
    const float* __restrict__ cents, const float* __restrict__ c_sq,
    const float* __restrict__ c_max, int N, int M, int K, int Ds_arg,
    uint8_t* __restrict__ codes) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[LT_STAGES], empty[LT_STAGES];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* cs_ring = ring + LT_STAGES * LT_STAGE;
  constexpr int SF = (G * DS + LT_K - 1) / LT_K;  // stages a pass (DS > 0)
  const int Ds = DS > 0 ? DS : Ds_arg;
  const int S = DS > 0 ? SF : (Ds + LT_K - 1) / LT_K;
  const int t = threadIdx.x;
  const int groups = (M + G - 1) / G;
  const int units = (N + LT_ROWS - 1) / LT_ROWS * groups;
  const int CT = (K + LT_CENTS - 1) / LT_CENTS;  // passes
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
      int g = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int n0 = u / groups * LT_ROWS, m0 = u % groups * G;
        const int bytes = min(G, M - m0) * LT_CENTS * 4;
        for (int ct = 0; ct < CT; ++ct)
          for (int s = 0; s < S; ++s, ++g) {
            tc_load_stage(&tmx, &tmb, &tms, ring, full, empty, g,
                          m0 * Ds + s * LT_K, n0, ct * LT_CENTS, bytes);
            bulk_load(smem_addr(cs_ring + g % LT_STAGES * PQ_CS_SLOT),
                      c_sq + ((size_t)ct * M + m0) * LT_CENTS, bytes,
                      full + g % LT_STAGES);
          }
      }
    }
    return;
  }

  const int wg = t >> 7, w = t >> 5, lane = t & 31;
  const int rloc = wg * 64 + (w & 3) * 16 + (lane >> 2);  // rows rloc, +8
  const long long D = (long long)M * Ds;
  int g = 0;  // the block's stage, as the producer counts them
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int n0 = u / groups * LT_ROWS, m0 = u % groups * G;
    const int gn = min(G, M - m0);  // the unit's subspaces
    Best b[G][2];
    float tb[G][2];  // each subspace's near-tie threshold base (pass 0)
#pragma unroll
    for (int sub = 0; sub < G; ++sub)
#pragma unroll
      for (int h = 0; h < 2; ++h) b[sub][h] = Best{INFINITY, 0.f, 0};
    for (int ct = 0; ct < CT; ++ct) {
      float acc[64];             // the open subspace's products
      float xo[2] = {0.f, 0.f};  // its |x|^2 so far (pass 0)
      // stage s of the pass: its k8 steps, each in one subspace (col / Ds;
      // a constant where DS is: the stages unrolled), the subspace's
      // epilogue after its last
      constexpr int SU = DS > 0 ? SF : 1;
#pragma unroll SU
      for (int s = 0; s < S; ++s, ++g) {
        const unsigned char* st = tc_wait_stage(ring, full, g);
        const float* cs = reinterpret_cast<const float*>(
            cs_ring + g % LT_STAGES * PQ_CS_SLOT);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = LT_K * s + 8 * j;  // in the unit's columns
          if (col >= gn * Ds) continue;       // uniform
          float v[4];  // this step's A values (read here: fewer registers)
          tc_fragments_k8(st, rloc, lane, j, v);
          const int sub = G == 1 ? 0 : col / Ds;
          if (DS == 0)  // Ds % 8 == 4: the next subspace's columns
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (col + (lane & 3) + 4 * (e >> 1) >= Ds) v[e] = 0.f;
          if (ct == 0)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              xo[e & 1] = fmaf(v[e], v[e], xo[e & 1]);
          uint32_t ab[4], as[4];
          tc_split(v, ab, as);
          // the subspace's steps chained into acc on the tensor cores (its
          // first from zero): their cut sums err ~2^-23 of |x||c| an add,
          // far inside the near-tie threshold
          tc_k8(acc, ab, as, st, j, col - sub * Ds >= 8);
          if (col + 8 >= (sub + 1) * Ds) {  // its last: the epilogue
#pragma unroll
            for (int k = 0; k < G; ++k)
              if (k == sub) {
                if (ct == 0)  // |x|^2 of the row's subvector, by the quad
#pragma unroll
                  for (int h = 0; h < 2; ++h) {
                    float xx = xo[h];
                    xx += __shfl_xor_sync(FULL, xx, 1);
                    xx += __shfl_xor_sync(FULL, xx, 2);
                    tb[k][h] = PQ_TOL * (xx + __ldg(c_max + m0 + k));
                  }
                pq_pass(acc, cs + k * LT_CENTS, ct * LT_CENTS, lane, tb[k],
                        b[k]);
              }
            xo[0] = xo[1] = 0.f;
          }
        }
        tc_release_stage(empty, g);
      }
    }
    // the quads' merges, every (subspace, row) at once; then the near-ties
    // again by f32 FMA, the warp's tied rows one at a time (a quad's lanes
    // agree: one lane a quad in the ballot)
    bool tie[G][2], any = false;
#pragma unroll
    for (int sub = 0; sub < G; ++sub)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        pq_quad_merge(b[sub][h], tb[sub][h]);
        // another code within the threshold of the least: a near-tie
        tie[sub][h] = sub < gn && n0 + rloc + 8 * h < N &&
                      b[sub][h].cnt >= 1.5f;
        any |= tie[sub][h];
      }
    if (__any_sync(FULL, any))
#pragma unroll
      for (int sub = 0; sub < G; ++sub)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          for (unsigned ties = __ballot_sync(FULL, tie[sub][h]) & 0x11111111u;
               ties; ties &= ties - 1) {
            const int src = __ffs(ties) - 1, m = m0 + sub;
            const int rn = __shfl_sync(FULL, n0 + rloc + 8 * h, src);
            const int c = pq_rescan(x + (size_t)rn * D + (size_t)m * Ds,
                                    cents + (size_t)m * K * Ds,
                                    c_sq + (size_t)m * LT_CENTS, M, K, Ds,
                                    lane);
            if ((lane >> 2) == (src >> 2)) b[sub][h].code = c;
          }
    if ((lane & 3) == 0)
#pragma unroll
      for (int sub = 0; sub < G; ++sub)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = n0 + rloc + 8 * h;
          if (sub < gn && n < N)
            codes[(size_t)n * M + m0 + sub] =
                static_cast<uint8_t>(b[sub][h].code);
        }
  }
}

template <int G, int DS>
cudaError_t launch_encode_tc(const LloydMaps& maps, const float* x,
                             const float* cents, const float* c_sq,
                             const float* c_max, int N, int M, int K, int Ds,
                             uint8_t* codes, cudaStream_t stream) {
  static int cap[64], sms[64];
  cudaError_t e = raise_smem_cap(
      reinterpret_cast<const void*>(pq_encode_tc_kernel<G, DS>), PQ_SMEM,
      cap);
  if (e != cudaSuccess) return e;
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (sms[dev] == 0) {
    e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return e;
  }
  const long long units =
      (long long)((N + LT_ROWS - 1) / LT_ROWS) * ((M + G - 1) / G);
  const int grid = (int)(units < sms[dev] ? units : sms[dev]);
  pq_encode_tc_kernel<G, DS><<<grid, LT_THREADS, PQ_SMEM, stream>>>(
      maps.x, maps.big, maps.small, x, cents, c_sq, c_max, N, M, K, Ds,
      codes);
  return cudaGetLastError();
}

// 16 bytes from global to shared memory, asynchronously; the bytes past
// src_bytes (< 16 at a tile's end) are zero-filled, none read.
__device__ __forceinline__ void dec_copy16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void dec_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void dec_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The tile route (the head comment). Block b: subspaces [m0, m0 + gn) with
// m0 = (b % groups) G, the row tiles [(b / groups) per, + per) of R rows.
// Shared memory: the group's codebook [gn][K][Ds] f32, then two tiles of
// codes [R][M] u8. DS: Ds at compile time (0: ds at run time).
template <int DS>
__global__ void __launch_bounds__(DEC_T, 1) pq_decode_tile_kernel(
    const uint8_t* __restrict__ codes, const float* __restrict__ cents,
    int N, int M, int K, int ds, int G, int groups, int R, int per,
    float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char dsm[];
  const int Ds = DS ? DS : ds;
  const int V = Ds / 4;  // float4s a codeword
  const int t = threadIdx.x;
  const int m0 = blockIdx.x % groups * G, gn = min(G, M - m0);
  const int W = G * V;       // float4s of a row segment (a full group)
  const int RP = DEC_T / W;  // rows a pass of the block
  const int col = t % W, rl = t / W;  // once a thread
  const int sub = col / V, j = col - sub * V;
  const bool on = rl < RP && sub < gn;
  float4* cb = reinterpret_cast<float4*>(dsm);
  unsigned char* cs = dsm + sizeof(float) * (size_t)G * K * Ds;
  const float4* src =
      reinterpret_cast<const float4*>(cents + (size_t)m0 * K * Ds);
  for (int i = t; i < gn * K * V; i += DEC_T) cb[i] = __ldg(src + i);
  const int tiles = (N + R - 1) / R;
  const int tile0 = blockIdx.x / groups * per;
  const int tile1 = min(tiles, tile0 + per);
  const int tb = R * M;  // bytes of a staged tile (a multiple of 16)
  const uint32_t cs_addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(cs));
  auto stage = [&](int tile, int buf) {
    const long long r0 = (long long)tile * R;
    const int bytes = (int)(min((long long)R, N - r0) * M);
    const unsigned char* s = codes + r0 * M;
    for (int c = t * 16; c < bytes; c += DEC_T * 16)
      dec_copy16(cs_addr + buf * tb + c, s + c, min(16, bytes - c));
  };
  if (tile0 < tile1) stage(tile0, 0);
  dec_commit();
  const int MV = M * V;  // float4s of an output row
  for (int tile = tile0; tile < tile1; ++tile) {
    const int buf = (tile - tile0) & 1;
    if (tile + 1 < tile1) stage(tile + 1, buf ^ 1);
    dec_commit();
    dec_wait<1>();  // this tile's codes are in
    __syncthreads();
    if (on) {
      const long long r0 = (long long)tile * R;
      const int rows = (int)min((long long)R, N - r0);
      const unsigned char* cr = cs + buf * tb + m0 + sub;
      const float4* cw = cb + (size_t)sub * K * V + j;
      float4* o = reinterpret_cast<float4*>(out) + r0 * MV + m0 * V + col;
      for (int r = rl; r < rows; r += DEC_U * RP) {
        int code[DEC_U];
        float4 v[DEC_U];
#pragma unroll
        for (int u = 0; u < DEC_U; ++u) {
          const int rr = r + u * RP;
          code[u] = rr < rows ? min((int)cr[rr * M], K - 1) : 0;
        }
#pragma unroll
        for (int u = 0; u < DEC_U; ++u) v[u] = cw[code[u] * V];
#pragma unroll
        for (int u = 0; u < DEC_U; ++u) {
          const int rr = r + u * RP;
          if (rr < rows) __stcs(o + rr * MV, v[u]);
        }
      }
    }
    __syncthreads();  // the buffer is staged again two tiles on
  }
  dec_wait<0>();
}

// The "any" route: block tiles of R rows (grid-stride), the tile's codes
// [R][M] in shared memory; CW = min(D, NT) threads across the columns, NT /
// CW rows a pass.
__global__ void __launch_bounds__(NT) pq_decode_any_kernel(
    const uint8_t* __restrict__ codes, const float* __restrict__ cents,
    int N, int M, int K, int Ds, int R, float* __restrict__ out) {
  extern __shared__ unsigned char ca[];
  const int t = threadIdx.x, D = M * Ds;
  const int CW = min(D, NT), RP = NT / CW;
  const int c0 = t % CW, rl = t / CW;
  const int tiles = (N + R - 1) / R;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long r0 = (long long)tile * R;
    const int rows = (int)min((long long)R, N - r0);
    const uint8_t* src = codes + r0 * M;
    for (int i = t; i < rows * M; i += NT) ca[i] = src[i];
    __syncthreads();
    if (rl < RP)
      for (int col = c0; col < D; col += CW) {
        const int m = col / Ds, j = col - m * Ds;
        const float* cw = cents + (size_t)m * K * Ds + j;
        float* o = out + r0 * D + col;
        for (int r = rl; r < rows; r += RP)
          __stcs(o + (size_t)r * D,
                 __ldg(cw + (size_t)min((int)ca[r * M + m], K - 1) * Ds));
      }
    __syncthreads();
  }
}

template <int DS>
cudaError_t launch_decode_tile(const uint8_t* codes, const float* cents,
                               int N, int M, int K, int Ds, float* out,
                               cudaStream_t stream) {
  static int cap[64], sms[64];
  const int V = Ds / 4;
  int G = DEC_CB / (K * Ds * 4);  // subspaces a block: its codebook fits
  if (G > M) G = M;
  if (G > DEC_T / V) G = DEC_T / V;  // and a row segment its threads
  const int groups = (M + G - 1) / G;
  const int RP = DEC_T / (G * V);
  // a tile: at least RP and 128 rows, at most DEC_CODES bytes of codes, a
  // multiple of 16 rows (so every tile's codes start 16-byte aligned)
  int R = (RP + 15) / 16 * 16;
  if (R < 128) R = 128;
  if (R > DEC_CODES / M / 16 * 16) R = DEC_CODES / M / 16 * 16;
  const int smem = (int)(sizeof(float) * (size_t)G * K * Ds) + 2 * R * M;
  const void* fn = reinterpret_cast<const void*>(pq_decode_tile_kernel<DS>);
  cudaError_t e = raise_smem_cap(fn, smem, cap);
  if (e != cudaSuccess) return e;
  int dev = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (sms[dev] == 0) {
    e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return e;
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, DEC_T,
                                                    smem);
  if (e != cudaSuccess) return e;
  const int slots = sms[dev] * (per_sm > 0 ? per_sm : 1);
  const int tiles = (N + R - 1) / R;
  int ranges = slots / groups;  // row ranges: the groups of one run together
  if (ranges > tiles) ranges = tiles;
  if (ranges < 1) ranges = 1;
  const int per = (tiles + ranges - 1) / ranges;
  ranges = (tiles + per - 1) / per;
  pq_decode_tile_kernel<DS><<<(unsigned)(groups * ranges), DEC_T, smem,
                              stream>>>(codes, cents, N, M, K, Ds, G, groups,
                                        R, per, out);
  return cudaGetLastError();
}

__global__ void __launch_bounds__(NT) pq_table_kernel(
    const float* __restrict__ q, const float* __restrict__ cents, int M,
    int K, int Ds, float* __restrict__ table) {
  extern __shared__ float qs[];  // [Ds]
  const int b = blockIdx.x, m = blockIdx.y;
  const float* qrow = q + ((size_t)b * M + m) * Ds;
  for (int d = threadIdx.x; d < Ds; d += NT) qs[d] = qrow[d];
  __syncthreads();
  float q_sq = 0.f;
  for (int d = 0; d < Ds; ++d) q_sq = fmaf(qs[d], qs[d], q_sq);
  for (int k = threadIdx.x; k < K; k += NT) {
    const float* c = cents + ((size_t)m * K + k) * Ds;
    float dot = 0.f, c_sq = 0.f;
    for (int d = 0; d < Ds; ++d) {
      const float cv = __ldg(c + d);
      dot = fmaf(qs[d], cv, dot);
      c_sq = fmaf(cv, cv, c_sq);
    }
    table[((size_t)b * M + m) * K + k] = (q_sq - 2.f * dot) + c_sq;
  }
}

// W bytes of codes at p (aligned to W) as W / 4 words.
template <int W>
__device__ __forceinline__ void load_codes(const uint8_t* p,
                                           unsigned (&w)[W / 4]) {
  if constexpr (W == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (W == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
  }
}

// QE consecutive table entries at p (one 16-, 8- or 4-byte shared load)
// added into acc.
template <int QE>
__device__ __forceinline__ void add_entries(const float* p,
                                            float (&acc)[QE]) {
  if constexpr (QE == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    acc[0] += v.x; acc[1] += v.y; acc[2] += v.z; acc[3] += v.w;
  } else if constexpr (QE == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    acc[0] += v.x; acc[1] += v.y;
  } else {
    acc[0] += *p;
  }
}

// The scan (the head comment): QE queries a lane, L lanes a row, QB = QE L
// queries a block; W the bytes of codes a load (16, 8 or 4 dividing M, MC
// and the codes' offset; 1: a byte at a time). Block b takes query group
// b % groups and rows [(b / groups) rows_per, +rows_per) over subspaces
// [m_lo, m_lo + MC) of M; lut [MC][LUT_K][QB]. A launch past the first
// (m_lo > 0) adds to the sums in out.
template <int QE, int L, int W>
__global__ void __launch_bounds__(SCAN_T) pq_scan_kernel(
    const float* __restrict__ table, const uint8_t* __restrict__ codes,
    int B, int N, int M, int m_lo, int MC, int K, int groups, int rows_per,
    float* __restrict__ out) {
  constexpr int QB = QE * L;
  extern __shared__ __align__(16) float lut[];
  const int b0 = blockIdx.x % groups * QB;
  const int qn = min(QB, B - b0);
  const int per_q = MC * LUT_K;
  for (int i = threadIdx.x; i < QB * per_q; i += SCAN_T) {
    const int q = i / per_q, r = i - q * per_q, m = r / LUT_K,
              c = r - m * LUT_K;
    lut[r * QB + q] =
        q < qn && c < K
            ? __ldg(table + ((size_t)(b0 + q) * M + m_lo + m) * K + c) : 0.f;
  }
  __syncthreads();
  const long long r0 = (long long)(blockIdx.x / groups) * rows_per;
  const long long r1 = min((long long)N, r0 + rows_per);
  const int q0 = threadIdx.x % L * QE;  // this lane's queries q0..
  const float* lq = lut + q0;
  constexpr int STEP = SCAN_T / L;  // rows apart of a lane's rows
  for (long long nb = r0 + threadIdx.x / L; nb < r1; nb += SCAN_U * STEP) {
    // SCAN_U rows a lane: their code loads go out together
    const uint8_t* row[SCAN_U];
    bool in[SCAN_U];
    float acc[SCAN_U][QE];
#pragma unroll
    for (int u = 0; u < SCAN_U; ++u) {
      const long long n = nb + u * STEP;
      in[u] = n < r1;
      row[u] = codes + (in[u] ? n : nb) * M + m_lo;
#pragma unroll
      for (int qi = 0; qi < QE; ++qi)
        acc[u][qi] = m_lo > 0 && in[u] && q0 + qi < qn
                         ? out[(size_t)(b0 + q0 + qi) * N + n] : 0.f;
    }
    if constexpr (W == 1) {
      for (int m = 0; m < MC; ++m)
#pragma unroll
        for (int u = 0; u < SCAN_U; ++u)
          add_entries<QE>(lq + (m * LUT_K + __ldg(row[u] + m)) * QB,
                          acc[u]);
    } else {
      for (int m0 = 0; m0 < MC; m0 += W) {
        unsigned w[SCAN_U][W / 4];
#pragma unroll
        for (int u = 0; u < SCAN_U; ++u) load_codes<W>(row[u] + m0, w[u]);
#pragma unroll
        for (int e = 0; e < W; ++e)
#pragma unroll
          for (int u = 0; u < SCAN_U; ++u) {
            const int c = (w[u][e >> 2] >> (8 * (e & 3))) & 0xff;
            add_entries<QE>(lq + ((m0 + e) * LUT_K + c) * QB, acc[u]);
          }
      }
    }
#pragma unroll
    for (int u = 0; u < SCAN_U; ++u)
#pragma unroll
      for (int qi = 0; qi < QE; ++qi)
        if (in[u] && q0 + qi < qn)
          out[(size_t)(b0 + q0 + qi) * N + nb + u * STEP] = acc[u][qi];
  }
}

// The most queries a scan block takes (16, 8, 4, 2 or 1) whose tables of
// MC subspaces fit a block's shared memory, and no more than B rounded up
// to a power of two (MC <= 227 always fits one query).
inline int scan_qb(int MC, int B) {
  const size_t per_q = sizeof(float) * (size_t)MC * LUT_K;
  for (int qb = 16; qb > 1; qb >>= 1)
    if (qb < 2 * B && qb * per_q <= (size_t)MAX_SMEM) return qb;
  return 1;
}

template <int QE, int L, int W>
cudaError_t launch_scan(const float* table, const uint8_t* codes, int B,
                        int N, int M, int m_lo, int MC, int K, float* out,
                        cudaStream_t stream) {
  static int cap[64], sms[64];
  auto fn = pq_scan_kernel<QE, L, W>;
  const int smem = (int)(sizeof(float) * QE * L * (size_t)MC * LUT_K);
  cudaError_t e =
      raise_smem_cap(reinterpret_cast<const void*>(fn), smem, cap);
  if (e != cudaSuccess) return e;
  int dev = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (sms[dev] == 0) {
    e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return e;
  }
  // the blocks resident at once size the grid (smem varies with M)
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, SCAN_T,
                                                    smem);
  if (e != cudaSuccess) return e;
  const long long slots = (long long)sms[dev] * (per_sm > 0 ? per_sm : 1);
  const int groups = (B + QE * L - 1) / (QE * L);
  long long ranges = slots / groups;
  const long long most = (N + SCAN_MIN_ROWS - 1) / SCAN_MIN_ROWS;
  ranges = ranges < 1 ? 1 : ranges > most ? most : ranges;
  // rows a block: a multiple of 128, so a warp's runs of rows stay aligned
  const long long per = ((N + ranges - 1) / ranges + 127) / 128 * 128;
  const long long blocks = (long long)groups * ((N + per - 1) / per);
  pq_scan_kernel<QE, L, W><<<(unsigned)blocks, SCAN_T, smem, stream>>>(
      table, codes, B, N, M, m_lo, MC, K, groups, (int)per, out);
  return cudaGetLastError();
}

template <int QE, int L>
cudaError_t scan_by_width(const float* table, const uint8_t* codes, int B,
                          int N, int M, int m_lo, int MC, int K, float* out,
                          cudaStream_t stream) {
  // SCAN_MC is a multiple of 16, so a width dividing M divides MC too
  const uintptr_t a = reinterpret_cast<uintptr_t>(codes);
  if (M % 16 == 0 && a % 16 == 0)
    return launch_scan<QE, L, 16>(table, codes, B, N, M, m_lo, MC, K, out,
                                  stream);
  if (M % 8 == 0 && a % 8 == 0)
    return launch_scan<QE, L, 8>(table, codes, B, N, M, m_lo, MC, K, out,
                                 stream);
  if (M % 4 == 0 && a % 4 == 0)
    return launch_scan<QE, L, 4>(table, codes, B, N, M, m_lo, MC, K, out,
                                 stream);
  return launch_scan<QE, L, 1>(table, codes, B, N, M, m_lo, MC, K, out,
                               stream);
}

}  // namespace fvdb

// The f32 scratch of the encode's tensor-core route: the codebook's parts
// [2, K, M Ds], c_sq [2, M, 128], c_max [M].
FVDB_EXPORT long long fvdb_pq_encode_scratch(int M, int K, int Ds) {
  return 2LL * K * M * Ds + 2LL * M * fvdb::LT_CENTS + M;
}

// x [N, M Ds] f32, cents [M, K, Ds] f32 -> codes [N, M] u8; tc 1: the
// tensor-core route (Ds % 4 == 0, x and cents 16-byte aligned; scratch as
// fvdb_pq_encode_scratch), 0: the FMA route (scratch unused).
FVDB_EXPORT int fvdb_pq_encode(const float* x, const float* cents, int N,
                               int M, int K, int Ds, int tc, float* scratch,
                               uint8_t* codes, cudaStream_t stream) {
  using namespace fvdb;
  if (N < 1 || M < 1 || K < 1 || K > 256 || Ds < 1 || M > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (tc) {
    if (Ds % 4 != 0 || scratch == nullptr ||
        reinterpret_cast<uintptr_t>(cents) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    const long long D = (long long)M * Ds, kd = (long long)K * D;
    float* parts = scratch;
    float* c_sq = parts + 2 * kd;
    float* c_max = c_sq + (size_t)2 * M * LT_CENTS;
    const long long nb = (kd + 255) / 256;
    pq_split_kernel<<<(unsigned)(nb < 1024 ? nb : 1024), 256, 0, stream>>>(
        cents, M, K, Ds, parts);
    pq_code_sq_kernel<<<M, NT, 0, stream>>>(cents, M, K, Ds, c_sq, c_max);
    LloydMaps maps;
    cudaError_t e = lloyd_maps(x, N, parts, K, (int)D, &maps);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = Ds == 8    ? launch_encode_tc<4, 8>(maps, x, cents, c_sq, c_max, N,
                                            M, K, Ds, codes, stream)
        : Ds == 16 ? launch_encode_tc<2, 16>(maps, x, cents, c_sq, c_max, N,
                                             M, K, Ds, codes, stream)
        : Ds == 48 ? launch_encode_tc<2, 48>(maps, x, cents, c_sq, c_max, N,
                                             M, K, Ds, codes, stream)
                   : launch_encode_tc<1, 0>(maps, x, cents, c_sq, c_max, N,
                                            M, K, Ds, codes, stream);
    return static_cast<int>(e);
  }
  const dim3 grid((unsigned)((N + ER - 1) / ER), (unsigned)M);
  const size_t smem = encode_smem(K, Ds);
  if (smem > (size_t)MAX_SMEM) {
    pq_encode_wide_kernel<<<grid, NT, 0, stream>>>(x, cents, N, M, K, Ds,
                                                   codes);
    return static_cast<int>(cudaGetLastError());
  }
  static int cap[64];
  cudaError_t e = raise_smem_cap(reinterpret_cast<const void*>(
                                     pq_encode_kernel), (int)smem, cap);
  if (e != cudaSuccess) return static_cast<int>(e);
  pq_encode_kernel<<<grid, NT, smem, stream>>>(x, cents, N, M, K, Ds, codes);
  return static_cast<int>(cudaGetLastError());
}

// codes [N, M] u8, cents [M, K, Ds] -> out [N, M Ds] f32. tile 1: the
// tile route (Ds % 4 == 0, Ds <= 4 DEC_T, K Ds f32 <= DEC_CB, M <=
// DEC_MAX_M, the three pointers 16-byte aligned), 0: the "any" route.
FVDB_EXPORT int fvdb_pq_decode(const uint8_t* codes, const float* cents,
                               int N, int M, int K, int Ds, int tile,
                               float* out, cudaStream_t stream) {
  using namespace fvdb;
  if (N < 1 || M < 1 || K < 1 || Ds < 1 || (long long)M * Ds > (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tile) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(codes) |
                        reinterpret_cast<uintptr_t>(cents) |
                        reinterpret_cast<uintptr_t>(out);
    if (Ds % 4 != 0 || Ds / 4 > DEC_T || 4LL * K * Ds > DEC_CB ||
        M > DEC_MAX_M || a % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t e =
        Ds == 8    ? launch_decode_tile<8>(codes, cents, N, M, K, Ds, out,
                                           stream)
        : Ds == 16 ? launch_decode_tile<16>(codes, cents, N, M, K, Ds, out,
                                            stream)
        : Ds == 48 ? launch_decode_tile<48>(codes, cents, N, M, K, Ds, out,
                                            stream)
                   : launch_decode_tile<0>(codes, cents, N, M, K, Ds, out,
                                           stream);
    return static_cast<int>(e);
  }
  int R = DEC_ANY_CODES / M;  // rows a tile: their codes in shared memory
  if (R > 64) R = 64;
  if (R < 1) R = 1;
  if ((long long)R * M > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (N + R - 1) / R;
  const int grid = tiles < 8 * sms ? tiles : 8 * sms;
  pq_decode_any_kernel<<<grid, NT, R * M, stream>>>(codes, cents, N, M, K,
                                                    Ds, R, out);
  return static_cast<int>(cudaGetLastError());
}

// q [B, M Ds] f32, cents [M, K, Ds] -> table [B, M, K] f32.
FVDB_EXPORT int fvdb_pq_adc_table(const float* q, const float* cents, int B,
                                  int M, int K, int Ds, float* table,
                                  cudaStream_t stream) {
  using namespace fvdb;
  if (B < 1 || M < 1 || K < 1 || Ds < 1 || M > 65535 ||
      sizeof(float) * (size_t)Ds > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  pq_table_kernel<<<dim3((unsigned)B, (unsigned)M), NT,
                    sizeof(float) * Ds, stream>>>(q, cents, M, K, Ds, table);
  return static_cast<int>(cudaGetLastError());
}

// table [B, M, K] f32 (K <= 256), codes [N, M] u8 -> out [B, N] f32.
FVDB_EXPORT int fvdb_pq_adc_distances(const float* table,
                                      const uint8_t* codes, int B, int N,
                                      int M, int K, float* out,
                                      cudaStream_t stream) {
  using namespace fvdb;
  if (B < 1 || N < 1 || M < 1 || K < 1 || K > LUT_K)
    return static_cast<int>(cudaErrorInvalidValue);
  // one launch where a query's tables fit a block, else SCAN_MC at a time
  const int mc = sizeof(float) * (size_t)M * LUT_K <= (size_t)MAX_SMEM
                     ? M : SCAN_MC;
  for (int m_lo = 0; m_lo < M; m_lo += mc) {
    const int c = min(mc, M - m_lo);
    cudaError_t e;
    switch (scan_qb(c, B)) {
      case 16:
        e = scan_by_width<4, 4>(table, codes, B, N, M, m_lo, c, K, out,
                                stream);
        break;
      case 8:
        e = scan_by_width<4, 2>(table, codes, B, N, M, m_lo, c, K, out,
                                stream);
        break;
      case 4:
        e = scan_by_width<4, 1>(table, codes, B, N, M, m_lo, c, K, out,
                                stream);
        break;
      case 2:
        e = scan_by_width<2, 1>(table, codes, B, N, M, m_lo, c, K, out,
                                stream);
        break;
      default:
        e = scan_by_width<1, 1>(table, codes, B, N, M, m_lo, c, K, out,
                                stream);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaSuccess);
}
