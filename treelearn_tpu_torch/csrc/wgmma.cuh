// Hopper building blocks shared by the tensor-core kernels
// (subm_conv_wgmma.cu, subm_conv_dw_wgmma.cu, subm_conv_tf32.cu,
// subm_conv_dw_tf32.cu): asynchronous copies into shared memory, mbarriers,
// the proxy fence, wgmma.mma_async for bf16 operands that both lie in shared
// memory and for TF32 with A in registers, and the 3xTF32 split.
// Everything is inline PTX behind a small function; sm_90a only.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
// one arrival on the mbarrier once this thread's earlier cp.async have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}
// `bytes` contiguous bytes global -> shared by the copy engine (async
// proxy); their arrival is counted on the mbarrier's transaction count
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// one arrival that also announces `bytes` of bulk copy to come
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}
// spin until the mbarrier's phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\nbra WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// barrier among the consumer threads only (the producers have left)
template <int THREADS>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// wgmma.mma_async m64nNk16, bf16 x bf16 -> float32, A and B from shared
// memory, D += A B.  TNSP 0: both operands K-major (the reduction dimension
// is the contiguous one); TNSP 1: both MN-major (M resp. N contiguous, the
// reduction dimension strided), which 16-bit types alone allow.  The shapes
// differ only in their register lists.  Thread t of the warpgroup holds, for
// each 8-column block j, rows 16 * (t / 32) + (t % 32) / 4 (+ 8) and columns
// 8 j + 2 (t % 4) (+ 1) in d[4 j .. 4 j + 3].
#define R16_0 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define R16_1 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define R16_2 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
#define R16_3 "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define R16_4 "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
#define R16_5 "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
#define R16_6 "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111"
#define R16_7 "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
#define REGS_32 R16_0
#define REGS_64 REGS_32 ", " R16_1
#define REGS_96 REGS_64 ", " R16_2
#define REGS_128 REGS_96 ", " R16_3
#define REGS_160 REGS_128 ", " R16_4
#define REGS_192 REGS_160 ", " R16_5
#define REGS_224 REGS_192 ", " R16_6
#define REGS_256 REGS_224 ", " R16_7
#define ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define ACC16(i) ACC4(i), ACC4(i + 4), ACC4(i + 8), ACC4(i + 12)
#define ACCS_32 ACC16(0)
#define ACCS_64 ACCS_32, ACC16(16)
#define ACCS_96 ACCS_64, ACC16(32)
#define ACCS_128 ACCS_96, ACC16(48)
#define ACCS_160 ACCS_128, ACC16(64)
#define ACCS_192 ACCS_160, ACC16(80)
#define ACCS_224 ACCS_192, ACC16(96)
#define ACCS_256 ACCS_224, ACC16(112)

template <int N, int TNSP = 0>
struct Wgmma;
// DA, DB, P, T: operand numbers of the two descriptors, the scale-d flag
// and the transpose flag, which follow the N / 2 accumulators
#define DEFINE_WGMMA(N, DA, DB, P, T)                                       \
  template <int TNSP>                                                       \
  struct Wgmma<N, TNSP> {                                                   \
    static __device__ __forceinline__ void mma(float (&d)[N / 2],           \
                                               uint64_t a, uint64_t b) {    \
      asm volatile(                                                         \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"                  \
          "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 "       \
          "{" REGS_##N "}, %" #DA ", %" #DB ", p, 1, 1, %" #T ", %" #T      \
          ";\n}\n"                                                          \
          : ACCS_##N                                                        \
          : "l"(a), "l"(b), "r"(1), "n"(TNSP));                             \
    }                                                                       \
  };
DEFINE_WGMMA(32, 16, 17, 18, 19)
DEFINE_WGMMA(64, 32, 33, 34, 35)
DEFINE_WGMMA(96, 48, 49, 50, 51)
DEFINE_WGMMA(128, 64, 65, 66, 67)
DEFINE_WGMMA(160, 80, 81, 82, 83)
DEFINE_WGMMA(192, 96, 97, 98, 99)
DEFINE_WGMMA(224, 112, 113, 114, 115)
DEFINE_WGMMA(256, 128, 129, 130, 131)

// ---- TF32 (the 3xTF32 float32 kernels subm_conv_tf32.cu,
// subm_conv_dw_tf32.cu)

// x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// x = hi + lo + O(2^-22 |x|): the split of the 3xTF32 product
// a b ~ hi(a) hi(b) + hi(a) lo(b) + lo(a) hi(b)
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}
// keeps a register the compiler would otherwise think dead (an operand of
// an asynchronous wgmma) alive and in place up to this point
__device__ __forceinline__ void reg_fence(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// Shared-memory descriptor of a K-major TF32 tile whose rows are 8 values
// (32 bytes) in the 32-byte swizzle: the 16-byte chunk c of row n lies at
// n * 32 + ((c ^ ((n >> 2) & 1)) << 4), 8-row groups 256 bytes apart, tile
// 256-byte aligned.  One such tile is the B operand of one k8 step.
__device__ __forceinline__ uint64_t tf32_desc(uint32_t addr) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;
  d |= (uint64_t)(256 >> 4) << 32;
  d |= (uint64_t)3 << 62;
  return d;
}

// wgmma.mma_async m64nNk8, tf32 x tf32 -> float32, A from registers (thread
// t of the warpgroup holds rows 16 (t / 32) + (t % 32) / 4 (+ 8) at columns
// t % 4 (+ 4): a[0] = (r, c), a[1] = (r + 8, c), a[2] = (r, c + 4),
// a[3] = (r + 8, c + 4)), B from shared memory K-major; D += A B with the
// accumulator layout of Wgmma above.  (These register lists also serve
// the bf16 widths 8..112 that are no multiple of 32.)
#define REGS_8 "%0, %1, %2, %3"
#define REGS_16 REGS_8 ", %4, %5, %6, %7"
#define REGS_24 REGS_16 ", %8, %9, %10, %11"
#define REGS_40 REGS_32 ", %16, %17, %18, %19"
#define REGS_48 REGS_40 ", %20, %21, %22, %23"
#define REGS_56 REGS_48 ", %24, %25, %26, %27"
#define REGS_80 REGS_64 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define REGS_112 REGS_96 ", %48, %49, %50, %51, %52, %53, %54, %55"
#define ACCS_8 ACC4(0)
#define ACCS_16 ACCS_8, ACC4(4)
#define ACCS_24 ACCS_16, ACC4(8)
#define ACCS_40 ACCS_32, ACC4(16)
#define ACCS_48 ACCS_40, ACC4(20)
#define ACCS_56 ACCS_48, ACC4(24)
#define ACCS_80 ACCS_64, ACC4(32), ACC4(36)
#define ACCS_112 ACCS_96, ACC4(48), ACC4(52)

// the bf16 widths below 256 that are no multiple of 32 (the conv's B
// operand is K-major, so any multiple of 8 is a valid N)
DEFINE_WGMMA(8, 4, 5, 6, 7)
DEFINE_WGMMA(16, 8, 9, 10, 11)
DEFINE_WGMMA(24, 12, 13, 14, 15)
DEFINE_WGMMA(40, 20, 21, 22, 23)
DEFINE_WGMMA(48, 24, 25, 26, 27)
DEFINE_WGMMA(56, 28, 29, 30, 31)
DEFINE_WGMMA(80, 40, 41, 42, 43)
DEFINE_WGMMA(112, 56, 57, 58, 59)

template <int N>
struct WgmmaTf32;
// A0: operand number of a[0] (N / 2); the descriptor and the scale-d flag
// follow a[3]
#define DEFINE_WGMMA_TF32(N, A0, A1, A2, A3, DB, P)                         \
  template <>                                                               \
  struct WgmmaTf32<N> {                                                     \
    static __device__ __forceinline__ void mma(float (&d)[N / 2],           \
                                               const uint32_t (&a)[4],      \
                                               uint64_t b, int scale_d) {   \
      asm volatile(                                                         \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"                  \
          "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 "        \
          "{" REGS_##N "}, {%" #A0 ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #DB \
          ", p, 1, 1;\n}\n"                                                 \
          : ACCS_##N                                                        \
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),             \
            "r"(scale_d));                                                  \
    }                                                                       \
  };
DEFINE_WGMMA_TF32(8, 4, 5, 6, 7, 8, 9)
DEFINE_WGMMA_TF32(16, 8, 9, 10, 11, 12, 13)
DEFINE_WGMMA_TF32(24, 12, 13, 14, 15, 16, 17)
DEFINE_WGMMA_TF32(32, 16, 17, 18, 19, 20, 21)
DEFINE_WGMMA_TF32(40, 20, 21, 22, 23, 24, 25)
DEFINE_WGMMA_TF32(48, 24, 25, 26, 27, 28, 29)
DEFINE_WGMMA_TF32(56, 28, 29, 30, 31, 32, 33)
DEFINE_WGMMA_TF32(64, 32, 33, 34, 35, 36, 37)
DEFINE_WGMMA_TF32(80, 40, 41, 42, 43, 44, 45)
DEFINE_WGMMA_TF32(96, 48, 49, 50, 51, 52, 53)
DEFINE_WGMMA_TF32(112, 56, 57, 58, 59, 60, 61)
DEFINE_WGMMA_TF32(128, 64, 65, 66, 67, 68, 69)

// The three products of one k8 step, small terms first: D = (first ? 0 :
// D) + lo(A) hi(B) + hi(A) lo(B) + hi(A) hi(B).  The tensor cores add into
// D rounding toward zero, which over thousands of k8 steps biases a float32
// sum by ~1e-4 of its size; the kernels therefore start D afresh each ring
// slot (`first` on its first step) and add it into a second float32 total
// with round-to-nearest FADDs (tf32_flush).
template <int N>
__device__ __forceinline__ void mma_tf32x3(float (&d)[N / 2],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint64_t bh, uint64_t bl,
                                           bool first) {
  WgmmaTf32<N>::mma(d, al, bh, first ? 0 : 1);
  WgmmaTf32<N>::mma(d, ah, bl, 1);
  WgmmaTf32<N>::mma(d, ah, bh, 1);
}
// total += d once the slot's products have retired (after wgmma_wait)
template <int N>
__device__ __forceinline__ void tf32_flush(float (&total)[N / 2],
                                           float (&d)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    reg_fence(d[i]);
    total[i] += d[i];
  }
}

}  // namespace
