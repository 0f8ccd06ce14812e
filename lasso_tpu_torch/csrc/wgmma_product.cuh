// A 128 x 128 block tile of a product A B^T on Hopper's tensor cores
// (warpgroup MMA, wgmma), with f32 A rounded or split to bf16 on its way
// into shared memory. Used whole by csrc/omp.cu (K6a omp_select) and
// csrc/fista.cu (K2 fista_grad_prox, and K1 fista_resid reading y's
// split); K1 forming y itself takes the primitives and the register-A MMA.
//
// The tile: rows row0 .. row0+127 of A [M, Kd] against rows col0 ..
// col0+127 of B [Nb, Kd], contracting over Kd in stages of 64 (one 128-byte
// row of bf16 per tile row). Both operands are bf16, row-major and
// contiguous along Kd, which is wgmma's K-major layout; rows of A past M
// read as zero. With SPLIT, A = a_hi + a_lo and B = b_hi + b_lo are bf16x3
// splits of f32 values (hi = bf16(x), lo = bf16(x - hi)) and each 16-deep
// slice issues three MMAs into one FP32 accumulator: hi*hi, lo*hi, hi*lo.
// Without it, one MMA of a_hi and b_hi. A bf16 x bf16 product is exact in
// FP32, so this is "bf16 operands, FP32 sums" in both modes.
//
// A block has three warpgroups (384 threads): warpgroups 0 and 1 are
// consumers, each issuing m64n128k16 MMAs for 64 rows of the tile into 64
// FP32 registers a thread; warpgroup 2 is the producer. The producer fills
// a ring of STAGES stages in shared memory by cp.async, 16 bytes a copy,
// whose completion each producer thread reports to the stage's "full"
// mbarrier, so the loads of several stages are in flight at once and hold
// no registers. Every tile row is 128 bytes, stored in the 128-byte
// swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)), which the MMA
// descriptors name (layout type 1, 8-row groups 1024 bytes apart).
// Consumers release a stage through its "empty" mbarrier once the MMAs
// that read it have completed.
//
// csrc/conv.cu takes the primitives alone: mma_ss<N> for the n widths of
// its tiles (16, 64, 80, 128) and desc_plain for operands laid out
// without swizzle.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace wgp {

constexpr int BM = 128;           // rows of the block tile
constexpr int BN = 128;           // columns (rows of B) of the block tile
constexpr int BK = 64;            // depth of a stage: one 128-byte row
constexpr int CONSUMERS = 2;      // warpgroups issuing MMAs
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int TILE_BYTES = BM * BK * 2;   // one bf16 operand tile: 16 KB

template <bool SPLIT>
struct Ring {
  static constexpr int STAGES = SPLIT ? 3 : 6;
  // A_hi, [A_lo,] B_hi, [B_lo]
  static constexpr int STAGE_BYTES = (SPLIT ? 4 : 2) * TILE_BYTES;
  static constexpr int BYTES = STAGES * STAGE_BYTES;
  __device__ static uint32_t a_hi(uint32_t base, int s) {
    return base + s * STAGE_BYTES;
  }
  __device__ static uint32_t a_lo(uint32_t base, int s) {
    return a_hi(base, s) + TILE_BYTES;
  }
  __device__ static uint32_t b_hi(uint32_t base, int s) {
    return a_hi(base, s) + (SPLIT ? 2 : 1) * TILE_BYTES;
  }
  __device__ static uint32_t b_lo(uint32_t base, int s) {
    return b_hi(base, s) + TILE_BYTES;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// wait until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// as cp_async16, but reading `bytes` (16 or 0) and filling the rest of the
// 16 with zeros
__device__ __forceinline__ void cp_async16_fill(uint32_t dst, const void* src,
                                                int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// as cp_async16_fill for one 4-byte element (`bytes` 4 or 0), for rows
// that are not 16-byte aligned
__device__ __forceinline__ void cp_async4_fill(uint32_t dst, const void* src,
                                               int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// one arrival on `bar` once every cp.async this thread issued so far has
// landed (.noinc: the arrival counts against the barrier's init count)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// close this thread's group of cp.async copies issued since the last
// commit; wait until at most N of its groups are in flight
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one thread's arrival on `bar` that also expects `bytes` from bulk copies
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// a bulk copy (TMA) of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from device memory into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// order this thread's generic-proxy shared-memory accesses with the async
// proxy, through which wgmma reads its operands
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a barrier over the consumer warpgroups only (the producer does not
// take part)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * CONSUMERS) : "memory");
}

// the MMA descriptor of a K-major operand tile in the 128-byte swizzle:
// start address >> 4, leading offset 1 (unused for this layout), 8-row
// groups 1024 bytes apart, layout type 1 (128-byte swizzle)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// the MMA descriptor of a K-major operand laid out without swizzle: 8 x
// 16-byte core matrices (8 rows of 8 bf16, 128 contiguous bytes), the two
// of a 16-deep slice `lbo` bytes apart, 8-row groups `sbo` bytes apart
__device__ __forceinline__ uint64_t desc_plain(uint32_t saddr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous MMAs' fences
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The accumulator operands of an m64nNk16 MMA: N / 2 FP32 registers a
// thread, as asm operands %0 .. %(N/2 - 1) (REGS) and their constraints.
#define WGP_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WGP_F8(i) WGP_F4(i), WGP_F4(i + 4)
#define WGP_F32(i) WGP_F8(i), WGP_F8(i + 8), WGP_F8(i + 16), WGP_F8(i + 24)
#define WGP_REGS8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define WGP_REGS32                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7,"                                \
  " %8, %9, %10, %11, %12, %13, %14, %15,"                          \
  " %16, %17, %18, %19, %20, %21, %22, %23,"                        \
  " %24, %25, %26, %27, %28, %29, %30, %31}"
#define WGP_REGS40                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7,"                                \
  " %8, %9, %10, %11, %12, %13, %14, %15,"                          \
  " %16, %17, %18, %19, %20, %21, %22, %23,"                        \
  " %24, %25, %26, %27, %28, %29, %30, %31,"                        \
  " %32, %33, %34, %35, %36, %37, %38, %39}"
#define WGP_REGS64                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7,"                                \
  " %8, %9, %10, %11, %12, %13, %14, %15,"                          \
  " %16, %17, %18, %19, %20, %21, %22, %23,"                        \
  " %24, %25, %26, %27, %28, %29, %30, %31,"                        \
  " %32, %33, %34, %35, %36, %37, %38, %39,"                        \
  " %40, %41, %42, %43, %44, %45, %46, %47,"                        \
  " %48, %49, %50, %51, %52, %53, %54, %55,"                        \
  " %56, %57, %58, %59, %60, %61, %62, %63}"

// d += A B^T over one 16-deep slice, both operands in shared memory given
// by their descriptors: A 64 x 16, B N x 16, K-major. IA, IB, IS are the
// operand numbers of the two descriptors and the scale flag.
#define WGP_MMA_SS(N, REGS, IA, IB, IS, ...)                             \
  asm volatile(                                                          \
      "{\n"                                                              \
      ".reg .pred p;\n"                                                  \
      "setp.ne.b32 p, %" #IS ", 0;\n"                                    \
      "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 " REGS   \
      ", %" #IA ", %" #IB ", p, 1, 1, 0, 0;\n"                           \
      "}\n"                                                              \
      : __VA_ARGS__                                                      \
      : "l"(desc_a), "l"(desc_b), "r"(1))

template <int N>
__device__ void mma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b);

template <>
__device__ __forceinline__ void mma_ss<16>(float (&d)[8], uint64_t desc_a,
                                           uint64_t desc_b) {
  WGP_MMA_SS(16, WGP_REGS8, 8, 9, 10, WGP_F8(0));
}

template <>
__device__ __forceinline__ void mma_ss<64>(float (&d)[32], uint64_t desc_a,
                                           uint64_t desc_b) {
  WGP_MMA_SS(64, WGP_REGS32, 32, 33, 34, WGP_F32(0));
}

template <>
__device__ __forceinline__ void mma_ss<80>(float (&d)[40], uint64_t desc_a,
                                           uint64_t desc_b) {
  WGP_MMA_SS(80, WGP_REGS40, 40, 41, 42, WGP_F32(0), WGP_F8(32));
}

template <>
__device__ __forceinline__ void mma_ss<128>(float (&d)[64], uint64_t desc_a,
                                            uint64_t desc_b) {
  WGP_MMA_SS(128, WGP_REGS64, 64, 65, 66, WGP_F32(0), WGP_F32(32));
}

// d += A B^T over one 16-deep slice: A a 64 x 16 K-major bf16 tile, B a
// 128 x 16 one, both given by their descriptors
__device__ __forceinline__ void mma_64x128x16(float (&d)[64], uint64_t desc_a,
                                              uint64_t desc_b) {
  mma_ss<128>(d, desc_a, desc_b);
}

// d += A B^T over one 16-deep slice with A from registers: a is this
// thread's fragment of the 64 x 16 bf16 tile, warp w of the warpgroup
// holding rows 16 w .. 16 w + 15 as four bf16 pairs (the first element in
// the low half): a[0] row lane / 4, columns 2 (lane % 4) + {0, 1}; a[1]
// row lane / 4 + 8, the same columns; a[2], a[3] those rows at columns
// 8 + 2 (lane % 4) + {0, 1}. B is a 128 x 16 K-major tile given by its
// descriptor. The registers of a must not change until the MMA completes.
__device__ __forceinline__ void mma_64x128x16_rs(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void mma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The producer warpgroup (pt = its thread, 0..127): fills the ring with
// Kd / 64 stages, 8 16-byte copies of each operand tile a thread. full[s]
// expects one arrival of each producer thread, empty[s] one of each
// consumer thread. Kd is also both operands' row stride; B must hold the
// whole tile's rows (the callers pad it to a multiple of 128 rows).
template <bool SPLIT>
__device__ __forceinline__ void produce(const __nv_bfloat16* __restrict__ a_hi,
                                        const __nv_bfloat16* __restrict__ a_lo,
                                        const __nv_bfloat16* __restrict__ b_hi,
                                        const __nv_bfloat16* __restrict__ b_lo,
                                        int row0, int col0, int M, int Kd,
                                        uint32_t ring, uint32_t full,
                                        uint32_t empty, int pt) {
  using R = Ring<SPLIT>;
  const int stages = Kd / BK;
  for (int k = 0; k < stages; ++k) {
    const int s = k % R::STAGES;
    mbar_wait(empty + 8 * s, ((k / R::STAGES) & 1) ^ 1);
    const int d0 = k * BK;
#pragma unroll
    for (int i = 0; i < 8; ++i) {   // 128 rows of 8 chunks a tile
      const int c = pt + 128 * i, row = c >> 3, ch = c & 7;
      const uint32_t off = row * 128 + ((ch ^ (row & 7)) << 4);
      const size_t gb = (size_t)(col0 + row) * Kd + d0 + ch * 8;
      const bool in = row0 + row < M;
      const size_t ga = (size_t)(in ? row0 + row : 0) * Kd + d0 + ch * 8;
      cp_async16_fill(R::a_hi(ring, s) + off, a_hi + ga, in ? 16 : 0);
      cp_async16(R::b_hi(ring, s) + off, b_hi + gb);
      if (SPLIT) {
        cp_async16_fill(R::a_lo(ring, s) + off, a_lo + ga, in ? 16 : 0);
        cp_async16(R::b_lo(ring, s) + off, b_lo + gb);
      }
    }
    cp_async_arrive(full + 8 * s);
  }
}

// Consumer warpgroup wg (0 .. CONSUMERS-1): d (64 registers a thread, zero
// on entry) += rows 64 wg .. 64 wg + 63 of the tile. Stage k's MMAs are
// committed as one group; the stage before is released once they leave at
// most that group in flight.
template <bool SPLIT>
__device__ __forceinline__ void consume(float (&d)[64], int Kd, uint32_t ring,
                                        uint32_t full, uint32_t empty,
                                        int wg) {
  using R = Ring<SPLIT>;
  const int stages = Kd / BK;
  const uint32_t rows = wg * 64 * 128;   // this warpgroup's 64 rows of A
  fence_acc(d);
  for (int k = 0; k < stages; ++k) {
    const int s = k % R::STAGES;
    mbar_wait(full + 8 * s, (k / R::STAGES) & 1);
    fence_proxy_async();
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {   // 32 bytes a slice
      const uint64_t ah = desc_sw128(R::a_hi(ring, s) + rows + 32 * kk);
      const uint64_t bh = desc_sw128(R::b_hi(ring, s) + 32 * kk);
      mma_64x128x16(d, ah, bh);
      if (SPLIT) {
        const uint64_t al = desc_sw128(R::a_lo(ring, s) + rows + 32 * kk);
        const uint64_t bl = desc_sw128(R::b_lo(ring, s) + 32 * kk);
        mma_64x128x16(d, al, bh);
        mma_64x128x16(d, ah, bl);
      }
    }
    mma_commit();
    mma_wait<1>();
    fence_acc(d);
    if (k > 0) mbar_arrive(empty + 8 * ((k - 1) % R::STAGES));
  }
  mma_wait<0>();
  fence_acc(d);
  // the last stage needs no release: nothing is produced after it
}

}  // namespace wgp
