// Hopper's asynchronous units for the vocoder kernels, K1's conv and K2-K4's
// ResBlock1 chain (sm_90a only):
// warpgroup products (wgmma.mma_async), bulk copies from global to shared
// memory (cp.async.bulk) and the shared-memory barriers (mbarrier) that
// report their completion, and element copies (cp.async) for K1's wide
// design's windows.
//
// wgmma here takes A (64 rows x K) and B (K x N) from shared memory
// through descriptors; one product is 32 bytes of K: 16 bf16 values
// (m64nNk16) or 8 tf32 values (m64nNk8). D (64 x N, fp32) stays in registers: element
// 4j + 2r + e of a thread's D is row 16w + gid + 8r, column 8j + 2tig + e
// (warp w of the warpgroup, gid = lane / 4, tig = lane % 4).
//
// A from shared memory is K-major without swizzle: the activations' planes
// of 16-byte chunks ([C/8][W][8] bf16 or [C/4][W][4] fp32) hold each lane's
// chunk of channels in 16 bytes, lanes one after the other, so 8
// consecutive lanes are one 128-byte core matrix (SBO = 128), the next
// chunk of channels is the next chunk plane (LBO = 16W), and a tap's shift
// of s lanes moves the start address by 16s bytes.
//
// B is K-major: the N rows of one tap's (C_out x C_in) weight tile, each
// C_in values long, in the canonical layout of a swizzle. Its atom is R
// bytes of every row, R the widest of 128, 64 and 32 that divides the row
// (128-byte swizzle at R = 128, 64 at 64, 32 at 32): 8-row groups of 8R
// bytes, one after the other (SBO = 8R), and within a group the 16-byte
// chunk q of row r stored at chunk q ^ ((r * R / 128) % (R / 16)). A row
// of more than R bytes (C_in = 64 fp32 values: 256 bytes, two atoms; C_in =
// 48: 192 bytes, three of 64) is cut into atoms along K, each all C_out
// rows (C_out * R bytes). ops/kernels/resblock.py::wgmma_tier_image writes
// this image on the host; the swizzle is a function of the shared address
// bits, so each ring slot starts on a 1024-byte boundary and each atom
// within it on a multiple of its 8R-byte repeat. A step of 32 bytes of K
// moves the descriptor's start address 32 bytes along the rows, as
// CUTLASS's descriptor iterator does for K-major swizzled tiles, and into
// the next atom after R / 32 steps.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace piper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers ---------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (the bulk
// copies) and to the other threads, with the __syncthreads that follows.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The control flow around the products stays uniform: ptxas serialises
// every wgmma of a function in which a warpgroup instruction sits on a
// divergent path. So the waits below spin inside PTX, and the one-thread
// operations are predicated instructions, not branches.

// Arrive once on `bar` where `pred` holds.
__device__ __forceinline__ void mbar_arrive_if(bool pred, uint32_t bar) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n"
      "}\n" ::"r"(bar),
      "r"((uint32_t)pred)
      : "memory");
}

// Wait until the phase of parity `parity` has completed. A phase still open
// after 2^28 tries is a fault in the protocol: the kernel traps, so the
// launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .u32 n;\n"
      "mov.u32 n, 0;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "add.u32 n, n, 1;\n"
      "setp.gt.u32 p, n, 268435456;\n"
      "@p trap;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// --- bulk copies ------------------------------------------------------

// Where `pred` holds: arrive on the mbarrier `bar` expecting `bytes` (a
// multiple of 16) of transactions, and copy them from 16-byte aligned
// global `src` to shared `dst`, completing on `bar`.
__device__ __forceinline__ void bulk_copy_if(bool pred, uint32_t dst, const void* src,
                                             uint32_t bytes, uint32_t bar) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.u32 p, %4, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%3], %2;\n"
      "@p cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n"
      "}\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "r"((uint32_t)pred)
      : "memory");
}

// --- element copies ----------------------------------------------------

// Copy 4 bytes from global `src` to shared `dst` asynchronously (cp.async),
// or, where `bytes` is 0, write 4 zero bytes there without reading `src`.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

// Close this thread's group of cp.async copies (an empty group where it
// issued none).
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// --- warpgroup products ----------------------------------------------

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

// Makes this thread's generic stores to shared memory visible to the async
// proxy (wgmma's operand reads), before the barrier that publishes them.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of the registers across
// the asynchronous products' issue and wait (CUTLASS's
// warpgroup_fence_operand).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The descriptor of a K-major swizzled B tile of rows of kRowBytes (one
// atom's width) at shared address `addr` (1024-byte aligned tile base plus
// the k-step's offset): start address and SBO in 16-byte units, LBO 1
// (unused by swizzled K-major tiles), layout type in bits 62-63 (1 =
// 128-byte, 2 = 64-byte, 3 = 32-byte swizzle).
template <int kRowBytes>
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  static_assert(kRowBytes == 32 || kRowBytes == 64 || kRowBytes == 128, "swizzle widths");
  constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  constexpr uint64_t kSbo = 8 * kRowBytes;  // bytes between 8-row groups
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((kSbo >> 4) << 32) |
         (kLayout << 62);
}

// The descriptor of a K-major A tile without swizzle at shared address
// `addr` (16-byte aligned): 8 x 16-byte core matrices, rows 16 bytes apart;
// SBO 128 bytes between the core matrices of 8 consecutive rows (M), LBO
// `lbo` bytes between the two 16-byte chunks of a step's 32 bytes of K;
// layout type 0.
__device__ __forceinline__ uint64_t a_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

// The products, D (64 x N fp32) += A x B with both read from shared memory
// through their descriptors; with `accumulate` 0, D = A x B (D's registers
// are not read). Wgmma<N>: A 64 x 16 bf16, B 16 x N bf16 (m64nNk16).
// WgmmaTf32<N>: A 64 x 8 tf32, B 8 x N tf32 (m64nNk8), fp32 sums; tf32
// takes both operands K-major (no transpose), and the hardware reads the
// top 19 bits of each operand: the values given are tf32-exact. N is a
// multiple of 16 up to 128: the stage's C_out (K2-K4's C; K1's C padded to
// a multiple of 16).
template <int N>
struct Wgmma;
template <int N>
struct WgmmaTf32;

// PIPER_Rn: D's n register operands, %0 to %(n-1); PIPER_OUTn(d): their
// bindings to d[0..n).
#define PIPER_R8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define PIPER_R16 PIPER_R8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define PIPER_R24 PIPER_R16 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define PIPER_R32 PIPER_R24 ", %24, %25, %26, %27, %28, %29, %30, %31"
#define PIPER_R40 PIPER_R32 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define PIPER_R48 PIPER_R40 ", %40, %41, %42, %43, %44, %45, %46, %47"
#define PIPER_R56 PIPER_R48 ", %48, %49, %50, %51, %52, %53, %54, %55"
#define PIPER_R64 PIPER_R56 ", %56, %57, %58, %59, %60, %61, %62, %63"
#define PIPER_OUT8(d) "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
  "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
#define PIPER_OUT16(d) PIPER_OUT8(d), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),   \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define PIPER_OUT24(d) PIPER_OUT16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),             \
  "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
#define PIPER_OUT32(d) PIPER_OUT24(d), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),             \
  "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define PIPER_OUT40(d) PIPER_OUT32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),             \
  "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
#define PIPER_OUT48(d) PIPER_OUT40(d), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),             \
  "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
#define PIPER_OUT56(d) PIPER_OUT48(d), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),             \
  "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
#define PIPER_OUT64(d) PIPER_OUT56(d), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]),             \
  "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// The specialisation of NAME for N, with R = N / 2 registers of D: a, b and
// accumulate are operands R, R + 1 and R + 2. SHAPE is the instruction's
// k and types, TAIL what follows the scales (bf16's transpose flags).
#define PIPER_WGMMA(NAME, SHAPE, TAIL, N, R, IA, IB, IP)                                 \
  template <>                                                                           \
  struct NAME<N> {                                                                      \
    static __device__ __forceinline__ void mma(float (&d)[R], uint64_t a, uint64_t b,   \
                                              uint32_t accumulate = 1) {                \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #IP ", 0;\n"                     \
                   "wgmma.mma_async.sync.aligned.m64n" #N SHAPE " {" PIPER_R##R          \
                   "}, %" #IA ", %" #IB ", p, 1, 1" TAIL ";\n}\n"                         \
                   : PIPER_OUT##R(d)                                                    \
                   : "l"(a), "l"(b), "r"(accumulate));                                  \
    }                                                                                   \
  };
#define PIPER_WGMMA_BOTH(N, R, IA, IB, IP)                                             \
  PIPER_WGMMA(Wgmma, "k16.f32.bf16.bf16", ", 0, 0", N, R, IA, IB, IP)                   \
  PIPER_WGMMA(WgmmaTf32, "k8.f32.tf32.tf32", "", N, R, IA, IB, IP)

PIPER_WGMMA_BOTH(16, 8, 8, 9, 10)
PIPER_WGMMA_BOTH(32, 16, 16, 17, 18)
PIPER_WGMMA_BOTH(48, 24, 24, 25, 26)
PIPER_WGMMA_BOTH(64, 32, 32, 33, 34)
PIPER_WGMMA_BOTH(80, 40, 40, 41, 42)
PIPER_WGMMA_BOTH(96, 48, 48, 49, 50)
PIPER_WGMMA_BOTH(112, 56, 56, 57, 58)
PIPER_WGMMA_BOTH(128, 64, 64, 65, 66)

#undef PIPER_WGMMA_BOTH
#undef PIPER_WGMMA
#undef PIPER_R8
#undef PIPER_R16
#undef PIPER_R24
#undef PIPER_R32
#undef PIPER_R40
#undef PIPER_R48
#undef PIPER_R56
#undef PIPER_R64
#undef PIPER_OUT8
#undef PIPER_OUT16
#undef PIPER_OUT24
#undef PIPER_OUT32
#undef PIPER_OUT40
#undef PIPER_OUT48
#undef PIPER_OUT56
#undef PIPER_OUT64

}  // namespace piper
