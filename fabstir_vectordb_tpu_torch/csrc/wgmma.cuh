// Hopper's warpgroup matrix product (wgmma) for the port's tensor-core
// kernels: shared-memory descriptors of 64-byte-swizzled K-major tiles,
// TMA copies into such tiles completed on shared-memory barriers
// (mbarrier), the fences around an asynchronous product, and m64nNk16 bf16
// x bf16 -> f32 products for N = 32, 64 and 96.
//
// A K-major tile here is rows of 32 bf16 values (64 bytes) stored in
// groups of 8 rows (512 bytes, aligned to 512): the 16-byte chunk c of row
// r sits at r * 64 + ((c ^ ((r / 2) & 3)) * 16), the layout TMA's 64-byte
// swizzle writes and the descriptor's swizzle mode 2 reads. Stepping 16
// values (32 bytes) along K inside the 64-byte row adds 2 to the
// descriptor's address field.
#pragma once

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


}  // namespace fvdb
