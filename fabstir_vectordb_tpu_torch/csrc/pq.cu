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
// is 2 N K D f32 operations (201 GFLOP, 3.0 ms at 67 TFLOP/s); decode
// writes N D f32 (0.46 ms); the scan writes B N f32 (B = 128: 512 MB, 0.16
// ms); the tables are small (B M K f32). Bytes bound all but encode.
//
// Design. Encode: a block takes 256 rows of one subspace, with the
// subspace's codebook in shared memory transposed to [Ds][K'] (K' = K
// rounded up to 32; 48 KiB at K = 256, Ds = 48) and the rows' subvectors
// transposed to [Ds][256]; a thread owns a row and walks the codes 32 at a
// time, 32 dot products in registers, each dim one load of its own value
// and eight 16-byte broadcast loads of the codes'. A subspace too wide for
// that (Ds > 113 at K = 256) takes the same walk with each tile of 32 codes
// and the rows staged 32 dims at a time; the dims add in the same order,
// so the distances are the same bits. Decode: one thread an output
// element. Table: a block a (query, subspace), one thread a code. Scan: a
// block copies the tables of QB queries (QB = 8, 4, 2 or 1, as many as fit
// in 96 KiB; each padded to 256 codes with zeros) into shared memory and
// streams 4,096 rows' codes, each row with 16-, 8- or 4-byte loads where M
// allows; a thread sums QB queries for its row in registers and the stores
// of a warp are 32 consecutive floats of each query. Past 227 subspaces
// (one query's tables over a block's shared memory) the scan runs in
// launches of 96 subspaces, each adding to the sums the last one stored.
#include "common.cuh"

namespace fvdb {

constexpr int ER = NT;         // rows an encode block, one a thread
constexpr int KT = 32;         // codes a register tile
constexpr int SCAN_ROWS = 4096;  // rows a scan block
constexpr int SCAN_SMEM = 96 * 1024;
constexpr int MAX_SMEM = 232448;  // a block's shared memory on Hopper
constexpr int LUT_K = 256;     // codes a table row in shared memory
constexpr int DC = 32;         // dims a slice of the wide encode
constexpr int SCAN_MC = 96;    // subspaces a launch of a chunked scan

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

__global__ void __launch_bounds__(NT) pq_decode_kernel(
    const uint8_t* __restrict__ codes, const float* __restrict__ cents,
    long long total, int M, int K, int Ds, float* __restrict__ out) {
  const long long D = (long long)M * Ds;
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < total;
       i += (long long)gridDim.x * NT) {
    const long long n = i / D;
    const int col = (int)(i - n * D), m = col / Ds, j = col - m * Ds;
    const int code = min((int)__ldg(codes + n * M + m), K - 1);
    out[i] = __ldg(cents + ((size_t)m * K + code) * Ds + j);
  }
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

// W: the bytes of codes a load (16, 8 or 4, dividing M and MC; 1: one
// byte at a time). Subspaces [m_lo, m_lo + MC) of M: lut holds QB tables
// of MC x LUT_K floats, and a launch past the first (m_lo > 0) adds to the
// sums in out.
template <int QB, int W>
__global__ void __launch_bounds__(NT) pq_scan_kernel(
    const float* __restrict__ table, const uint8_t* __restrict__ codes,
    int B, int N, int M, int m_lo, int MC, int K, float* __restrict__ out) {
  extern __shared__ float lut[];
  const int b0 = blockIdx.y * QB;
  const int qn = min(QB, B - b0);
  const int per_q = MC * LUT_K;
  for (int i = threadIdx.x; i < QB * per_q; i += NT) {
    const int qi = i / per_q, r = i - qi * per_q, m = r / LUT_K,
              k = r - m * LUT_K;
    lut[i] = qi < qn && k < K
                 ? table[((size_t)(b0 + qi) * M + m_lo + m) * K + k] : 0.f;
  }
  __syncthreads();
  const long long r0 = (long long)blockIdx.x * SCAN_ROWS;
  const long long r1 = min((long long)N, r0 + SCAN_ROWS);
  for (long long n = r0 + threadIdx.x; n < r1; n += NT) {
    const uint8_t* row = codes + n * M + m_lo;
    float acc[QB];
#pragma unroll
    for (int qi = 0; qi < QB; ++qi)
      acc[qi] = m_lo > 0 && qi < qn ? out[(size_t)(b0 + qi) * N + n] : 0.f;
    if constexpr (W == 1) {
      for (int m = 0; m < MC; ++m) {
        const int c = __ldg(row + m);
#pragma unroll
        for (int qi = 0; qi < QB; ++qi)
          acc[qi] += lut[qi * per_q + m * LUT_K + c];
      }
    } else {
      for (int m0 = 0; m0 < MC; m0 += W) {
        unsigned w[W / 4];
        load_codes<W>(row + m0, w);
#pragma unroll
        for (int e = 0; e < W; ++e) {
          const int c = (w[e >> 2] >> (8 * (e & 3))) & 0xff;
          const int off = (m0 + e) * LUT_K + c;
#pragma unroll
          for (int qi = 0; qi < QB; ++qi) acc[qi] += lut[qi * per_q + off];
        }
      }
    }
#pragma unroll
    for (int qi = 0; qi < QB; ++qi)
      if (qi < qn) out[(size_t)(b0 + qi) * N + n] = acc[qi];
  }
}

// The largest QB in {8, 4, 2, 1} whose tables of MC subspaces fit the
// scan's budget (MC <= 227 always fits one query).
inline int scan_qb(int MC, int B) {
  const size_t per_q = sizeof(float) * (size_t)MC * LUT_K;
  for (int qb = 8; qb > 1; qb >>= 1)
    if (qb <= B && qb * per_q <= (size_t)SCAN_SMEM) return qb;
  return 1;
}

template <int QB, int W>
cudaError_t launch_scan(const float* table, const uint8_t* codes, int B,
                        int N, int M, int m_lo, int MC, int K, float* out,
                        cudaStream_t stream) {
  static int cap[64];
  const int smem = (int)(sizeof(float) * QB * (size_t)MC * LUT_K);
  cudaError_t e = raise_smem_cap(
      reinterpret_cast<const void*>(pq_scan_kernel<QB, W>), smem, cap);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)((N + SCAN_ROWS - 1) / SCAN_ROWS),
                  (unsigned)((B + QB - 1) / QB));
  pq_scan_kernel<QB, W><<<grid, NT, smem, stream>>>(table, codes, B, N, M,
                                                    m_lo, MC, K, out);
  return cudaGetLastError();
}

template <int QB>
cudaError_t scan_by_width(const float* table, const uint8_t* codes, int B,
                          int N, int M, int m_lo, int MC, int K, float* out,
                          cudaStream_t stream) {
  // SCAN_MC is a multiple of 16, so a width dividing M divides MC too
  if (M % 16 == 0)
    return launch_scan<QB, 16>(table, codes, B, N, M, m_lo, MC, K, out,
                               stream);
  if (M % 8 == 0)
    return launch_scan<QB, 8>(table, codes, B, N, M, m_lo, MC, K, out,
                              stream);
  if (M % 4 == 0)
    return launch_scan<QB, 4>(table, codes, B, N, M, m_lo, MC, K, out,
                              stream);
  return launch_scan<QB, 1>(table, codes, B, N, M, m_lo, MC, K, out, stream);
}

}  // namespace fvdb

// x [N, M Ds] f32, cents [M, K, Ds] f32 -> codes [N, M] u8.
FVDB_EXPORT int fvdb_pq_encode(const float* x, const float* cents, int N,
                               int M, int K, int Ds, uint8_t* codes,
                               cudaStream_t stream) {
  using namespace fvdb;
  if (N < 1 || M < 1 || K < 1 || K > 256 || Ds < 1 || M > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
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

// codes [N, M] u8, cents [M, K, Ds] -> out [N, M Ds] f32.
FVDB_EXPORT int fvdb_pq_decode(const uint8_t* codes, const float* cents,
                               int N, int M, int K, int Ds, float* out,
                               cudaStream_t stream) {
  using namespace fvdb;
  if (N < 1 || M < 1 || K < 1 || Ds < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = (long long)N * M * Ds;
  const long long blocks = (total + NT - 1) / NT;
  const unsigned grid = (unsigned)(blocks < (1 << 20) ? blocks : (1 << 20));
  pq_decode_kernel<<<grid, NT, 0, stream>>>(codes, cents, total, M, K, Ds,
                                            out);
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
      case 8:
        e = scan_by_width<8>(table, codes, B, N, M, m_lo, c, K, out, stream);
        break;
      case 4:
        e = scan_by_width<4>(table, codes, B, N, M, m_lo, c, K, out, stream);
        break;
      case 2:
        e = scan_by_width<2>(table, codes, B, N, M, m_lo, c, K, out, stream);
        break;
      default:
        e = scan_by_width<1>(table, codes, B, N, M, m_lo, c, K, out, stream);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaSuccess);
}
