// Hopper's warpgroup matrix product (wgmma) for the port's tensor-core
// kernels: shared-memory descriptors of 64- and 128-byte-swizzled K-major
// tiles, TMA copies into such tiles completed on shared-memory barriers
// (mbarrier), the fences around an asynchronous product, m64nNk16 bf16
// x bf16 -> f32 products for N = 8, 32, 64, 96 and 128, m64nNk8 tf32 x
// tf32 -> f32 products (A from registers) for N = 8, 32, 64 and 128, the
// round of an f32 to tf32, and the host's
// encoding of a tensor map (libcuda's cuTensorMapEncodeTiled).
//
// A 64-byte-swizzled K-major tile is rows of 32 bf16 values stored in
// groups of 8 rows (512 bytes, aligned to 512): the 16-byte chunk c of row
// r sits at r * 64 + ((c ^ ((r / 2) & 3)) * 16), the layout TMA's 64-byte
// swizzle writes and the descriptor's swizzle mode 2 reads. Stepping 16
// values (32 bytes) along K inside the 64-byte row adds 2 to the
// descriptor's address field.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fvdb {

// Byte offset in a swizzled K-major tile of the 16-byte chunk c of row r.
__device__ __forceinline__ uint32_t sw64(int r, int c) {
  return (uint32_t)(r * 64 + ((c ^ ((r >> 1) & 3)) << 4));
}

// The descriptor of a swizzled K-major tile starting at shared address
// `addr`: 8-row groups 512 bytes apart (SBO), leading offset unused (1).
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffffu) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(512 >> 4) << 32) | ((uint64_t)2 << 62);
}

// The 128-byte swizzle: rows of 64 bf16 values (128 bytes) in groups of 8
// rows (1,024 bytes, aligned to 1,024), the 16-byte chunk c of row r at
// r * 128 + ((c ^ (r % 8)) * 16), as TMA's 128-byte swizzle writes them
// and the descriptor's swizzle mode 1 reads them; a step of 16 values
// along K inside the row adds 2 to the address field, as above.
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffffu) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A shared-memory barrier that `count` arrivals (and, after an
// expect_tx, that many bytes of TMA copies) complete; its phases alternate
// parity 0, 1, 0, ....
__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(b)),
               "r"(count)
               : "memory");
}
// Barrier inits made visible before any thread (or TMA) uses them.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// Arrive, and expect `bytes` more of TMA copies before the phase completes.
__device__ __forceinline__ void mbar_expect(uint64_t* b, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(b)),
               "r"(bytes)
               : "memory");
}
// Arrive (no bytes expected).
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(b))
               : "memory");
}
// Writes to shared memory by this thread made visible to the asynchronous
// proxy (wgmma reads its operands there).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Wait until the phase of parity `parity` has completed. A wait that never
// ends (a fault in the kernel's bookkeeping) traps after some seconds
// instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
  const uint32_t a = smem_addr(b);
  for (long long i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (i > (1LL << 24)) __trap();
  }
}
// TMA: the box of a 2D tensor map at (c0 innermost, c1) into shared memory
// at dst, its bytes counted on barrier b. Out-of-range elements read 0.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map,
                                            int c0, int c1, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(b))
      : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// This warpgroup's registers a thread become N (a multiple of 8, 24-256):
// dec gives registers back to the block's pool, inc waits until the pool
// holds them. Every thread of the warpgroup runs the same one.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
// x rounded to TF32 (to nearest, ties away from zero), as an f32 whose low
// 13 bits are zero: what cvt.rna.tf32.f32 gives a finite x, by two integer
// operations (half a TF32 ulp added to the magnitude's bits carries into
// the exponent where it should). The conversion instruction issues at a
// fraction of their rate: with it, K9 on f32 rows at B = 128 over 1M x 384
// took 2.96 ms against 2.70 (scripts/time_tile_routes.py --split k9f32
// on an H100). Volatile, so that it stays before the wgmma fence that
// follows it when it makes an A fragment.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm volatile(
      "{\n.reg .b32 t;\n"
      "mov.b32 t, %1;\n"
      "add.u32 t, t, 0x1000;\n"
      "and.b32 %0, t, 0xffffe000;\n}\n"
      : "=r"(r)
      : "f"(x));
  return r;
}

// Keeps the compiler from moving reads or writes of an accumulator
// register across the asynchronous product.
template <int M>
__device__ __forceinline__ void fence_regs(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x N] (+)= A[64 x 16] . B[16 x N]^T, A and B K-major bf16 tiles in
// shared memory given by their descriptors; scale_d 0 overwrites d. Thread
// t of the warpgroup holds d[i] at row 16 (t / 32) + (t % 32) / 4 +
// 8 ((i / 2) % 2) and column 8 (i / 4) + 2 (t % 4) + i % 2.
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  __device__ __forceinline__ static void mma(float (&d)[4], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3"
        "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void mma(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
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
};

template <>
struct Wgmma<96> {
  __device__ __forceinline__ static void mma(float (&d)[48], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// d[64 x N] (+)= A[64 x 8] . B[8 x N]^T in TF32 (tf32 x tf32 -> f32: the
// tensor cores read the top 19 bits of each f32), A from registers and B a
// K-major f32 tile in shared memory (128-byte swizzle: rows of 32 f32; a
// step of 8 values, 32 bytes, adds 2 to the descriptor's address field);
// scale_d 0 overwrites d. Thread t of the warpgroup holds a[e] at row 16
// (t / 32) + (t % 32) / 4 + 8 (e % 2) and column t % 4 + 4 (e / 2) of A,
// and d as in Wgmma.
template <int N>
struct WgmmaTF32;

template <>
struct WgmmaTF32<8> {
  __device__ __forceinline__ static void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3"
        "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

template <>
struct WgmmaTF32<32> {
  __device__ __forceinline__ static void mma(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

template <>
struct WgmmaTF32<64> {
  __device__ __forceinline__ static void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

template <>
struct WgmmaTF32<128> {
  __device__ __forceinline__ static void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

// libcuda's cuTensorMapEncodeTiled, found through the runtime's entry
// point query (no link against libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// A row-major [rows, cols] matrix (row stride ld elements; ld * its
// element size a multiple of 16 bytes) read in boxes of box_rows x
// box_cols: bf16 64-byte swizzled (box_cols 32) or, with sw128, 128-byte
// swizzled (box_cols 64), or f32 as it lies.
inline bool tile_map(CUtensorMap* m, const void* base, bool bf16,
                     long long rows, long long cols, long long ld,
                     int box_rows, int box_cols, bool sw128 = false) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * (bf16 ? 2 : 4)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(m,
             bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                  : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
             2, const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             sw128  ? CU_TENSOR_MAP_SWIZZLE_128B
             : bf16 ? CU_TENSOR_MAP_SWIZZLE_64B
                    : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace fvdb
