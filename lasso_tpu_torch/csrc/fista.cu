// One FISTA step as two hand-written kernels for Hopper (sm_90a).
//
// Replaces the TPU kernels of the JAX package's ops/fused_ista.py:
//   fused_fista_step      (_fista_kernel_f32, _fista_kernel_bf16, _epilogue)
//   fused_fista_multistep (_make_multistep_kernel)
// The TPU kernels keep the dictionary and a row tile of z in VMEM for S
// steps. On the H100 one f32 row of z is 8 KB at K=2048 against at most
// 227 KB of shared memory per block, so the step is split in two products
// that both wrappers in lasso_tpu_torch/ops/fused_ista.py issue per sub-step:
//
//   K1 fista_resid:     r = y W^T - x, contracting over K, where the
//                       momentum point y = z + c (z - zp) is formed from
//                       z and zp (c is the scalar momentum, or the per-row
//                       restart coefficient from t), or read as its bf16
//                       split where the previous K2 wrote it. It writes r
//                       in f32 and, beside it, r's bf16 split for K2.
//   K2 fista_grad_prox: g = r W, contracting over D, with an epilogue that
//                       forms y again, applies the prox and the l2
//                       contraction, writes z+, and adds block partials of
//                       sum|z+ - z| and, with restart, of the per-row
//                       <y - z+, z+ - z>. The last block of a row tile then
//                       updates that tile's t (threadfence reduction), so
//                       the t-vector needs no third kernel. Given the next
//                       step's scalars (a scalar momentum), it also writes
//                       the next momentum point z+ + c' (z+ - z)'s split.
//                       Given t but no rdot buffer, K2 reads t for the
//                       momentum and leaves it alone: the group-lasso path
//                       (lasso_tpu_torch/ops/fused_group.py) runs it so,
//                       with scale 1, to write v = soft(y - lr g, l1 lr),
//                       and csrc/group.cu then applies the group shrink and
//                       advances t.
//
// Both products run on the tensor cores (warpgroup MMA m64n128k16,
// csrc/wgmma_product.cuh) over 128 x 128 block tiles: two consumer
// warpgroups issue the MMAs, a producer warpgroup fills a ring of stages
// by cp.async. 'bf16' is one MMA of bf16 operands a 16-deep slice, with
// FP32 sums; 'f32' is the TPU kernel's bf16x3 split (fused_ista.py:100-119):
// hi*hi, lo*hi and hi*lo into one FP32 accumulator, with hi = bf16(v) and
// lo = bf16(v - hi). A bf16 x bf16 product is exact in FP32. W's split is
// made once a call by the wrapper, as the TPU wrapper splits W outside its
// kernel (fused_ista.py:210, :412): [P, D128, K64] for K1 (W, K-major) and
// [P, K128, D64] for K2 (W^T, D-major), P = 2 for f32 (hi, lo) and 1 for
// bf16, zero-padded to whole tiles (X128 is X rounded up to 128).
//
// K1's A operand is no stored tensor. Its producer copies the f32 z and
// zp tiles into shared memory (a 64-deep stage of both is 64 KB, with W's
// split 96 KB in f32; two stages), so several stages of loads are in
// flight and hold no registers. Each consumer thread then reads its
// fragment of z and zp, forms y, rounds or splits it and hands it to the
// MMA from registers (wgmma's register-A form), so y needs no shared
// memory of its own; the next slice is formed while the previous one's
// MMAs run. The f32 tiles lie 16 bytes a chunk with chunk c of row r at
// c ^ 2 (r % 4), so that a half-warp's 8-byte fragment reads meet every
// bank once. That form runs where y cannot be known a step ahead: a call's
// first sub-step, the restart momentum (t is final only after the whole
// row), the group path. Elsewhere K2's epilogue, which holds z+ and z,
// forms the next y and writes its split [P, N, K64] (zero past K), and K1
// reads it by cp.async alone, as K6a reads its operands: the same values
// bit for bit, with 4 (f32) or 2 (bf16) bytes an element read once per
// column tile in place of 8 of f32 z and zp. K1's epilogue writes r's
// split [P, N, D64] (zero past D)
// beside r, so that K2's producer issues only cp.async copies (a first
// K6a that converted f32 operands in its producer's registers starved its
// loads: PERF.md, section 6). The epilogues work on the MMA's fragment layout:
// a thread holds column pairs of rows lane/4 and lane/4 + 8, so a quad's
// writes of r and z+ are whole 32-byte sectors. The f32 tiles an epilogue
// reads (K1's x, K2's z and zp) are staged by the producer into ring slots
// as the product releases its last stages, so their loads overlap the last
// MMAs; read by the epilogue's threads from device memory, K2's z and zp
// made its epilogue about as long as its product (PERF.md, section 6).
//
// What bounds them on this card: at N=16384, D=512, K=2048 each product is
// 2NKD = 34.4 GFLOP, three times that in f32: 0.035 / 0.104 ms at 989
// TFLOP/s of bf16. K1 moves about 0.34 GB and K2 about 0.44 GB through
// device memory, 0.10 and 0.13 ms at 3.35 TB/s. At 128 x 128 tiles the L2
// carries more: K1 reads its A operand once per column tile (D/128 = 4
// times: 1.07 GB of f32 z and zp when it forms y, 0.54 / 0.27 GB of y's
// split when it reads it) and W's split once per row tile (0.5 GB in f32),
// K2 reads r's split and W's once per tile (1 GB in f32). The grids run
// the column tiles of a row strip together, so that the A operands come
// from device memory once and from L2 after.
//
// Elementwise arithmetic uses the _rn intrinsics (fista_math.cuh) so that
// the compiler does not contract it into FMAs: y, the prox and the t
// update then round op by op exactly as the plain PyTorch version does.
//
// Each C entry launches on the given stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "fista_math.cuh"
#include "wgmma_product.cuh"

namespace {

constexpr int TILE = 128;   // rows and columns of a block tile
static_assert(TILE == wgp::BM && TILE == wgp::BN, "one tile size");

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// momentum coefficient of row n: the scalar scal[2], or the restart
// coefficient of the row's t when t is given
__device__ __forceinline__ float row_coef(const float* scal, const float* t,
                                          int n, int N) {
  return t == nullptr ? scal[2] : (n < N ? restart_coef(t[n]) : 0.f);
}

// the pair p[o], p[o + 1]; `pairs` says the row width is even and the
// base 8-byte aligned, `two` that the second element is inside the row
__device__ __forceinline__ float2 load_pair(const float* p, size_t o,
                                            bool pairs, bool two) {
  if (pairs) return *reinterpret_cast<const float2*>(p + o);
  return make_float2(p[o], two ? p[o + 1] : 0.f);
}

__device__ __forceinline__ void store_pair(float* p, size_t o, float a,
                                           float b, bool pairs, bool two) {
  if (pairs) {
    *reinterpret_cast<float2*>(p + o) = make_float2(a, b);
  } else {
    p[o] = a;
    if (two) p[o + 1] = b;
  }
}

__device__ __forceinline__ uint32_t bf16_pair(__nv_bfloat16 a,
                                              __nv_bfloat16 b) {
  return (uint32_t)__bfloat16_as_ushort(a) |
         ((uint32_t)__bfloat16_as_ushort(b) << 16);
}

// hi = bf16(v), lo = bf16(v - hi) of a pair, packed (first in the low half)
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat16 ha = __float2bfloat16_rn(a),
                      hb = __float2bfloat16_rn(b);
  hi = bf16_pair(ha, hb);
  lo = bf16_pair(__float2bfloat16_rn(__fsub_rn(a, __bfloat162float(ha))),
                 __float2bfloat16_rn(__fsub_rn(b, __bfloat162float(hb))));
}

__device__ __forceinline__ float2 lds_pair(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}

// barriers of a ring of `stages`: full[s] at full + 8 s, then empty[s]
__device__ __forceinline__ void init_ring_barriers(uint32_t full,
                                                   int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      wgp::mbar_init(full + 8 * s, 128);
      wgp::mbar_init(full + 8 * (stages + s), 128 * wgp::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// byte offset of 16-byte chunk ch (0..31) of row `row` of an f32 tile of
// 128 columns staged for an epilogue: 512 bytes a row, chunk c of row r at
// c ^ 2 (r % 4), so that a half-warp's fragment-pattern 8-byte reads (rows
// lane/4, columns 8 j + 2 (lane % 4)) meet every bank once
__device__ __forceinline__ uint32_t tile_offset(int row, int ch) {
  return row * 512 + ((ch ^ ((row & 3) << 1)) << 4);
}

// The producer thread pt's share of copying rows r0 .. r0 + rows - 1 and
// columns col0 .. col0 + 127 of the f32 matrix m (row stride ld; rows past
// N and columns past C read as zero) into `dst` at tile_offset: 16-byte
// copies when vec (C % 4 == 0, m 16-byte aligned), else 4-byte ones.
__device__ __forceinline__ void stage_tile(uint32_t dst, const float* m,
                                           int ld, int r0, int rows,
                                           int col0, int N, int C, bool vec,
                                           int pt) {
  for (int i = pt; i < rows * 32; i += 128) {
    const int row = i >> 5, ch = i & 31, n = r0 + row, c = col0 + 4 * ch;
    const uint32_t off = dst + tile_offset(row, ch);
    if (vec) {
      const bool in = n < N && c < C;
      wgp::cp_async16_fill(off, m + (in ? (size_t)n * ld + c : 0),
                           in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = n < N && c + e < C;
        wgp::cp_async4_fill(off + 4 * e, m + (in ? (size_t)n * ld + c + e : 0),
                            in ? 4 : 0);
      }
    }
  }
}

// The ring of csrc/wgmma_product.cuh (K2, and K1 given y's split) with
// its barriers and alignment slack.
template <bool SPLIT>
constexpr size_t product_smem() {
  return wgp::Ring<SPLIT>::BYTES + 16 * wgp::Ring<SPLIT>::STAGES + 1024;
}

// NT f32 epilogue tiles of 128 x 128 (64 KB each; K1's x, K2's z and zp)
// staged in the slots of csrc/wgmma_product.cuh's ring after a product's
// `stages`: slot (stages + i) % STAGES holds rows i % PER * ROWS .. + ROWS
// - 1 of tile i / PER, PER = 128 / ROWS. Each slot's last product stage is
// released before the product ends (EPI <= STAGES - 1), so the copies
// overlap the last MMAs. A consumer warpgroup's 64 rows lie in one slot.
template <bool SPLIT, int NT>
struct EpilogueTiles {
  using Ring = wgp::Ring<SPLIT>;
  static constexpr int ROWS = Ring::STAGE_BYTES / 512;
  static constexpr int PER = TILE / ROWS;
  static constexpr int EPI = NT * PER;
  static_assert(EPI <= Ring::STAGES - 1, "slots to spare");
  static_assert(ROWS % 64 == 0, "a warpgroup's rows in one slot");
  // the slot holding row `row` (0..127) of tile `which`
  __device__ static uint32_t slot(uint32_t ring, int stages, int which,
                                  int row) {
    return Ring::a_hi(ring, (stages + which * PER + row / ROWS) %
                                Ring::STAGES);
  }
  // the producer's part: tile 0 from m0, tile 1 from m1 (row stride ld,
  // C columns, N rows)
  __device__ static void produce(const float* m0, const float* m1, int ld,
                                 int C, int N, int row0, int col0, bool vec,
                                 int stages, uint32_t ring, uint32_t full,
                                 uint32_t empty, int pt) {
#pragma unroll 1
    for (int i = 0; i < EPI; ++i) {
      const int v = stages + i, s = v % Ring::STAGES;
      wgp::mbar_wait(empty + 8 * s, ((v / Ring::STAGES) & 1) ^ 1);
      stage_tile(Ring::a_hi(ring, s), i / PER ? m1 : m0, ld,
                 row0 + i % PER * ROWS, ROWS, col0, N, C, vec, pt);
      wgp::cp_async_arrive(full + 8 * s);
    }
  }
  // the consumers' wait for every tile
  __device__ static void wait(int stages, uint32_t full) {
#pragma unroll 1
    for (int v = stages; v < stages + EPI; ++v)
      wgp::mbar_wait(full + 8 * (v % Ring::STAGES), (v / Ring::STAGES) & 1);
  }
};

// ---------------------------------------------------------------------
// K1: r[N, D] = y W^T - x with y = z + c (z - zp); grid (D128 / 128,
// N128 / 128), the column tiles of a row strip adjacent.

// One stage of K1's ring: the f32 z and zp tiles (128 rows of 64), then
// W's bf16 tile(s) in the 128-byte swizzle of csrc/wgmma_product.cuh.
template <bool SPLIT>
struct ResidRing {
  static constexpr int STAGES = 2;
  static constexpr int RAW_BYTES = TILE * wgp::BK * 4;   // 32 KB
  static constexpr int STAGE_BYTES =
      2 * RAW_BYTES + (SPLIT ? 2 : 1) * wgp::TILE_BYTES;
  static constexpr int BYTES = STAGES * STAGE_BYTES;
  __device__ static uint32_t z(uint32_t base, int s) {
    return base + s * STAGE_BYTES;
  }
  __device__ static uint32_t zp(uint32_t base, int s) {
    return z(base, s) + RAW_BYTES;
  }
  __device__ static uint32_t b_hi(uint32_t base, int s) {
    return z(base, s) + 2 * RAW_BYTES;
  }
  __device__ static uint32_t b_lo(uint32_t base, int s) {
    return b_hi(base, s) + wgp::TILE_BYTES;
  }
};

template <bool SPLIT>
constexpr size_t resid_smem() {
  return ResidRing<SPLIT>::BYTES + 16 * ResidRing<SPLIT>::STAGES + 1024;
}

// byte offset of 16-byte chunk ch (0..15) of row `row` of an f32 tile
__device__ __forceinline__ uint32_t raw_offset(int row, int ch) {
  return row * 256 + ((ch ^ ((row & 3) << 1)) << 4);
}

// K1's producer warpgroup (pt = its thread): per stage 16 chunks of z and
// of zp a thread (zero past N and K: 16-byte copies when K % 4 == 0 and the
// bases are aligned, else 4-byte ones) and W's split.
template <bool SPLIT>
__device__ __forceinline__ void resid_produce(
    const float* __restrict__ z, const float* __restrict__ zp,
    const __nv_bfloat16* __restrict__ w, size_t wplane, int N, int K,
    int Kw, int row0, int col0, bool vec, uint32_t ring, uint32_t full,
    uint32_t empty, int pt) {
  using R = ResidRing<SPLIT>;
  const int stages = (K + wgp::BK - 1) / wgp::BK;
  for (int k = 0; k < stages; ++k) {
    const int s = k % R::STAGES;
    wgp::mbar_wait(empty + 8 * s, ((k / R::STAGES) & 1) ^ 1);
    const int k0 = k * wgp::BK;
#pragma unroll 4
    for (int i = 0; i < 16; ++i) {   // 128 rows of 16 chunks a tile
      const int c = pt + 128 * i, row = c >> 4, ch = c & 15;
      const uint32_t off = raw_offset(row, ch);
      const int n = row0 + row, kk = k0 + 4 * ch;
      if (vec) {
        const bool in = n < N && kk < K;
        const size_t g = in ? (size_t)n * K + kk : 0;
        wgp::cp_async16_fill(R::z(ring, s) + off, z + g, in ? 16 : 0);
        wgp::cp_async16_fill(R::zp(ring, s) + off, zp + g, in ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = n < N && kk + e < K;
          const size_t g = in ? (size_t)n * K + kk + e : 0;
          wgp::cp_async4_fill(R::z(ring, s) + off + 4 * e, z + g,
                              in ? 4 : 0);
          wgp::cp_async4_fill(R::zp(ring, s) + off + 4 * e, zp + g,
                              in ? 4 : 0);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {   // 128 rows of 8 chunks of W's tile
      const int c = pt + 128 * i, row = c >> 3, ch = c & 7;
      const uint32_t off = row * 128 + ((ch ^ (row & 7)) << 4);
      const size_t g = (size_t)(col0 + row) * Kw + k0 + ch * 8;
      wgp::cp_async16(R::b_hi(ring, s) + off, w + g);
      if (SPLIT) wgp::cp_async16(R::b_lo(ring, s) + off, w + wplane + g);
    }
    wgp::cp_async_arrive(full + 8 * s);
  }
}

// After the last stage, K1's producer stages the epilogue's x tile (64 KB)
// into the slot of stage `stages`, which the consumers released during
// the last stage, so that the epilogue reads x from shared memory.
template <bool SPLIT>
__device__ __forceinline__ void resid_produce_x(const float* __restrict__ x,
                                                int N, int D, int K,
                                                int row0, int col0, bool vec,
                                                uint32_t ring, uint32_t full,
                                                uint32_t empty, int pt) {
  using R = ResidRing<SPLIT>;
  const int v = (K + wgp::BK - 1) / wgp::BK, s = v % R::STAGES;
  wgp::mbar_wait(empty + 8 * s, ((v / R::STAGES) & 1) ^ 1);
  stage_tile(R::z(ring, s), x, D, row0, TILE, col0, N, D, vec, pt);
  wgp::cp_async_arrive(full + 8 * s);
}

// K1's consumer warpgroup wg: d (zero on entry) += y W^T over rows
// 64 wg .. 64 wg + 63 of the tile; c0 and c1 are the momentum coefficients
// of this thread's rows lane/4 and lane/4 + 8 of its warp's 16. Slice i's
// A fragment lives in registers a[i % 2]; the MMAs of slice i - 1 are in
// flight while slice i is formed, and a stage is released once the MMAs of
// its last slice have completed.
template <bool SPLIT>
__device__ __forceinline__ void resid_consume(float (&d)[64], int K,
                                              float c0, float c1,
                                              uint32_t ring, uint32_t full,
                                              uint32_t empty, int wg) {
  using R = ResidRing<SPLIT>;
  const int stages = (K + wgp::BK - 1) / wgp::BK;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x & 127) >> 5;
  const int q = lane & 3, row = wg * 64 + warp * 16 + (lane >> 2);
  uint32_t a_hi[2][4], a_lo[2][4];
  wgp::fence_acc(d);
  for (int k = 0; k < stages; ++k) {
    const int s = k % R::STAGES;
    wgp::mbar_wait(full + 8 * s, (k / R::STAGES) & 1);
    wgp::fence_proxy_async();
#pragma unroll
    for (int kk = 0; kk < wgp::BK / 16; ++kk) {
      const int b = kk & 1;
#pragma unroll
      for (int f = 0; f < 4; ++f) {   // a[f]: rows +8 (f odd), cols +8 (f > 1)
        const uint32_t off =
            raw_offset(row + 8 * (f & 1), 4 * kk + 2 * (f >> 1) + (q >> 1)) +
            8 * (q & 1);
        const float2 zv = lds_pair(R::z(ring, s) + off);
        const float2 pv = lds_pair(R::zp(ring, s) + off);
        const float c = (f & 1) ? c1 : c0;
        const float y0 = momentum_point(zv.x, pv.x, c);
        const float y1 = momentum_point(zv.y, pv.y, c);
        if (SPLIT) {
          split_pair(y0, y1, a_hi[b][f], a_lo[b][f]);
        } else {
          a_hi[b][f] =
              bf16_pair(__float2bfloat16_rn(y0), __float2bfloat16_rn(y1));
        }
      }
      wgp::mma_fence();
      const uint64_t bh = wgp::desc_sw128(R::b_hi(ring, s) + 32 * kk);
      wgp::mma_64x128x16_rs(d, a_hi[b], bh);
      if (SPLIT) {
        const uint64_t bl = wgp::desc_sw128(R::b_lo(ring, s) + 32 * kk);
        wgp::mma_64x128x16_rs(d, a_lo[b], bh);
        wgp::mma_64x128x16_rs(d, a_hi[b], bl);
      }
      wgp::mma_commit();
      wgp::mma_wait<1>();
      wgp::fence_acc(d);
      if (kk == 0 && k > 0)
        wgp::mbar_arrive(empty + 8 * ((k - 1) % R::STAGES));
    }
  }
  wgp::mma_wait<0>();
  wgp::fence_acc(d);
}

// STORED: y's split was written by the previous K2 (ys [P, N, K64], zero
// past K), so the A operand is a stored tensor: the product is K6a's, on
// csrc/wgmma_product.cuh's ring, and z, zp, scal and t are not read.
template <bool SPLIT, bool STORED>
__global__ void __launch_bounds__(wgp::THREADS, 1)
    fista_resid_kernel(const float* __restrict__ x,
                       const float* __restrict__ z,
                       const float* __restrict__ zp,
                       const __nv_bfloat16* __restrict__ w,
                       const float* __restrict__ scal,
                       const float* __restrict__ t, float* __restrict__ r,
                       __nv_bfloat16* __restrict__ rb,
                       const __nv_bfloat16* __restrict__ ys, int N, int D,
                       int K, int vec, int vec_x, int pairs) {
  using R = ResidRing<SPLIT>;
  using E = EpilogueTiles<SPLIT, 1>;
  constexpr int STAGES = STORED ? wgp::Ring<SPLIT>::STAGES : R::STAGES;
  constexpr int RING_BYTES = STORED ? wgp::Ring<SPLIT>::BYTES : R::BYTES;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to it
  const uint32_t raw = wgp::smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const uint32_t full = ring + RING_BYTES, empty = full + 8 * STAGES;
  const int col0 = blockIdx.x * TILE, row0 = blockIdx.y * TILE;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int Kw = round_up(K, wgp::BK), Dp = round_up(D, 64);
  const int stages = Kw / wgp::BK;
  const size_t wplane = (size_t)round_up(D, TILE) * Kw;
  init_ring_barriers(full, STAGES);
  if (wg == wgp::CONSUMERS) {
    const int pt = tid - 128 * wgp::CONSUMERS;
    if constexpr (STORED) {
      wgp::produce<SPLIT>(ys, ys + (size_t)N * Kw, w, w + wplane, row0,
                          col0, N, Kw, ring, full, empty, pt);
      E::produce(x, nullptr, D, D, N, row0, col0, vec_x, stages, ring, full,
                 empty, pt);
    } else {
      resid_produce<SPLIT>(z, zp, w, wplane, N, K, Kw, row0, col0, vec, ring,
                           full, empty, pt);
      resid_produce_x<SPLIT>(x, N, D, K, row0, col0, vec_x, ring, full,
                             empty, pt);
    }
    return;
  }

  const int warp = (tid & 127) >> 5, lane = tid & 31, q = lane & 3;
  const int rl = wg * 64 + warp * 16 + (lane >> 2);   // and rl + 8
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  // x's tile, staged by the producer in the slot(s) after the last stage
  uint32_t xs;
  int xrows;
  if constexpr (STORED) {
    wgp::consume<SPLIT>(d, Kw, ring, full, empty, wg);
    E::wait(stages, full);
    xs = E::slot(ring, stages, 0, wg * 64);
    xrows = E::ROWS;
  } else {
    resid_consume<SPLIT>(d, K, row_coef(scal, t, row0 + rl, N),
                         row_coef(scal, t, row0 + rl + 8, N), ring, full,
                         empty, wg);
    wgp::mbar_wait(full + 8 * (stages % R::STAGES),
                   (stages / R::STAGES) & 1);
    xs = R::z(ring, stages % R::STAGES);
    xrows = TILE;
  }

  // The accumulator layout of m64nNk16: rows rl (registers 4 j, 4 j + 1)
  // and rl + 8 (4 j + 2, 4 j + 3) at columns 8 j + 2 q + {0, 1}. r's split
  // is written up to D64 (zero past D), the row stride K2 reads it with.
  const size_t plane = (size_t)N * Dp;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = row0 + rl + 8 * h;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = col0 + 8 * j + 2 * q;
      if (c >= Dp) continue;
      float v0 = 0.f, v1 = 0.f;
      if (c < D) {
        const bool two = c + 1 < D;
        const size_t o = (size_t)n * D + c;
        const float2 xv =
            lds_pair(xs + tile_offset((rl + 8 * h) % xrows, 2 * j + (q >> 1)) +
                     8 * (q & 1));
        v0 = __fsub_rn(d[4 * j + 2 * h], xv.x);
        v1 = two ? __fsub_rn(d[4 * j + 2 * h + 1], xv.y) : 0.f;
        store_pair(r, o, v0, v1, pairs, two);
      }
      uint32_t* hi = reinterpret_cast<uint32_t*>(rb + (size_t)n * Dp + c);
      if (SPLIT) {
        uint32_t h2, l2;
        split_pair(v0, v1, h2, l2);
        *hi = h2;
        *reinterpret_cast<uint32_t*>(rb + plane + (size_t)n * Dp + c) = l2;
      } else {
        *hi = bf16_pair(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
      }
    }
  }
}

// ---------------------------------------------------------------------
// K2: g[N, K] = r W, then z_out = prox(y - lr g, th) * scale; grid
// (K128 / 128, N128 / 128), the column tiles of a row strip adjacent.
// z_out may alias zp: the block's zp tile is staged in shared memory
// before the block writes any element of z_out, and no other block
// writes that tile.

template <bool SPLIT>
__global__ void __launch_bounds__(wgp::THREADS, 1)
    fista_grad_prox_kernel(const __nv_bfloat16* __restrict__ rb,
                           const float* z, const float* zp,
                           const __nv_bfloat16* __restrict__ wt,
                           const float* __restrict__ scal,
                           const float* __restrict__ trow, float* t,
                           float* rdot, unsigned int* counters,
                           float* z_out, float* delta,
                           const float* __restrict__ scal_next,
                           __nv_bfloat16* __restrict__ ys, int N, int D,
                           int K, int nonneg, int vec, int pairs) {
  using Ring = wgp::Ring<SPLIT>;
  using E = EpilogueTiles<SPLIT, 2>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ float warp_sums[wgp::CONSUMERS * 4];
  __shared__ int is_last;
  const uint32_t raw = wgp::smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const uint32_t full = ring + Ring::BYTES, empty = full + 8 * Ring::STAGES;
  const int col0 = blockIdx.x * TILE, row0 = blockIdx.y * TILE;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int Dp = round_up(D, 64);
  init_ring_barriers(full, Ring::STAGES);
  if (wg == wgp::CONSUMERS) {
    const size_t wplane = (size_t)round_up(K, TILE) * Dp;
    const int pt = tid - 128 * wgp::CONSUMERS;
    wgp::produce<SPLIT>(rb, rb + (size_t)N * Dp, wt, wt + wplane, row0, col0,
                        N, Dp, ring, full, empty, pt);
    E::produce(z, zp, K, K, N, row0, col0, vec, Dp / wgp::BK, ring, full,
               empty, pt);
    return;
  }

  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  wgp::consume<SPLIT>(d, Dp, ring, full, empty, wg);
  const int stages = Dp / wgp::BK;
  E::wait(stages, full);

  // the accumulator layout of K1's epilogue; a quad covers 8 consecutive
  // columns of a row, 32 bytes of z_out, and reads z and zp from the
  // staged tiles
  const int warp = (tid & 127) >> 5, lane = tid & 31, q = lane & 3;
  const int rl = wg * 64 + warp * 16 + (lane >> 2);
  const float lr = scal[0], th_s = scal[1], scale = scal[3];
  const float c_next = ys != nullptr ? scal_next[2] : 0.f;
  const int Kw = round_up(K, wgp::BK);
  const size_t yplane = (size_t)N * Kw;
  float dsum = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = row0 + rl + 8 * h, row = rl + 8 * h;
    const float c = row_coef(scal, t, n, N);
    const uint32_t zs = E::slot(ring, stages, 0, row),
                   ps = E::slot(ring, stages, 1, row);
    float rd = 0.f;
    if (n < N) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int k = col0 + 8 * j + 2 * q;
        if (k >= K) continue;
        const bool two = k + 1 < K;
        const size_t o = (size_t)n * K + k;
        const uint32_t off =
            tile_offset(row % E::ROWS, 2 * j + (q >> 1)) + 8 * (q & 1);
        const float2 zv = lds_pair(zs + off);
        const float2 pv = lds_pair(ps + off);
        const float2 thv = trow != nullptr ? load_pair(trow, k, pairs, two)
                                           : make_float2(th_s, th_s);
        float zn[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float zo = e ? zv.y : zv.x, th = e ? thv.y : thv.x;
          const float y = momentum_point(zo, e ? pv.y : pv.x, c);
          const float u = __fsub_rn(y, __fmul_rn(lr, d[4 * j + 2 * h + e]));
          float v;
          if (nonneg) {
            v = fmaxf(__fsub_rn(u, th), 0.f);
          } else {
            const float a = __fsub_rn(fabsf(u), th);
            v = a > 0.f ? copysignf(a, u) : 0.f;
          }
          zn[e] = __fmul_rn(v, scale);
          if (e == 0 || two) {
            const float dz = __fsub_rn(zn[e], zo);
            dsum += fabsf(dz);
            rd += __fmul_rn(__fsub_rn(y, zn[e]), dz);
          }
        }
        store_pair(z_out, o, zn[0], zn[1], pairs, two);
        if (ys != nullptr) {
          // the next step's momentum point y = z+ + c_next (z+ - z) and its
          // bf16 split (K1 forms the same from z+ and z)
          const float y0 = momentum_point(zn[0], zv.x, c_next);
          const float y1 = two ? momentum_point(zn[1], zv.y, c_next) : 0.f;
          uint32_t* yh = reinterpret_cast<uint32_t*>(ys + (size_t)n * Kw + k);
          if (SPLIT) {
            uint32_t hi2, lo2;
            split_pair(y0, y1, hi2, lo2);
            *yh = hi2;
            *reinterpret_cast<uint32_t*>(ys + yplane + (size_t)n * Kw + k) =
                lo2;
          } else {
            *yh = bf16_pair(__float2bfloat16_rn(y0), __float2bfloat16_rn(y1));
          }
        }
      }
    }
    if (rdot != nullptr) {
      // a row's 8 columns of a fragment lie on the 4 lanes of a quad
      rd += __shfl_xor_sync(0xffffffffu, rd, 1);
      rd += __shfl_xor_sync(0xffffffffu, rd, 2);
      if (q == 0 && n < N) atomicAdd(&rdot[n], rd);
    }
  }

  if (delta != nullptr) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dsum += __shfl_xor_sync(0xffffffffu, dsum, off);
    if (lane == 0) warp_sums[tid >> 5] = dsum;
    wgp::consumers_sync();
    if (tid == 0) {
      float s = 0.f;
      for (int i = 0; i < wgp::CONSUMERS * 4; ++i) s += warp_sums[i];
      atomicAdd(delta, s);
    }
  }

  if (rdot != nullptr) {
    // The last block to finish a row tile holds the whole-row rdot and
    // advances t: t = rdot > 0 ? 1 : t_next. Every other block of the tile
    // read t (in row_coef) before it counted itself in.
    __threadfence();
    wgp::consumers_sync();
    if (tid == 0)
      is_last = atomicAdd(&counters[blockIdx.y], 1u) == gridDim.x - 1;
    wgp::consumers_sync();
    if (is_last) {
      if (tid < TILE) {
        const int n = row0 + tid;
        if (n < N) {
          const float rdv = atomicExch(&rdot[n], 0.f);
          t[n] = rdv > 0.f ? 1.f : t_next_of(t[n]);
        }
      }
      if (tid == 0) counters[blockIdx.y] = 0u;
    }
  }
}

// dynamic shared memory above 48 KB needs the kernel's opt-in
template <typename Kernel>
int smem_opt_in(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <bool SPLIT, bool STORED>
int launch_resid_kernel(const float* x, const float* z, const float* zp,
                        const __nv_bfloat16* w, const float* scal,
                        const float* t, float* r, __nv_bfloat16* rb,
                        const __nv_bfloat16* ys, int N, int D, int K,
                        void* stream) {
  const size_t smem = STORED ? product_smem<SPLIT>() : resid_smem<SPLIT>();
  const int e = smem_opt_in(fista_resid_kernel<SPLIT, STORED>, smem);
  if (e != 0) return e;
  const int vec = K % 4 == 0 && aligned(z, 16) && aligned(zp, 16);
  const int vec_x = D % 4 == 0 && aligned(x, 16);
  const int pairs = D % 2 == 0 && aligned(r, 8);
  const dim3 grid(round_up(D, TILE) / TILE, round_up(N, TILE) / TILE);
  fista_resid_kernel<SPLIT, STORED><<<grid, wgp::THREADS, smem,
                                      (cudaStream_t)stream>>>(
      x, z, zp, w, scal, t, r, rb, ys, N, D, K, vec, vec_x, pairs);
  return (int)cudaGetLastError();
}

template <bool SPLIT>
int launch_resid(const float* x, const float* z, const float* zp,
                 const __nv_bfloat16* w, const float* scal, const float* t,
                 float* r, __nv_bfloat16* rb, const __nv_bfloat16* ys, int N,
                 int D, int K, void* stream) {
  if (N < 1 || D < 1 || K < 1) return (int)cudaErrorInvalidValue;
  return ys != nullptr
             ? launch_resid_kernel<SPLIT, true>(x, z, zp, w, scal, t, r, rb,
                                                ys, N, D, K, stream)
             : launch_resid_kernel<SPLIT, false>(x, z, zp, w, scal, t, r,
                                                 rb, ys, N, D, K, stream);
}

template <bool SPLIT>
int launch_grad_prox(const __nv_bfloat16* rb, const float* z,
                     const float* zp, const __nv_bfloat16* wt,
                     const float* scal, const float* trow, float* t,
                     float* rdot, unsigned int* counters, float* z_out,
                     float* delta, const float* scal_next,
                     __nv_bfloat16* ys, int N, int D, int K, int nonneg,
                     void* stream) {
  if (N < 1 || D < 1 || K < 1) return (int)cudaErrorInvalidValue;
  if ((ys == nullptr) != (scal_next == nullptr))
    return (int)cudaErrorInvalidValue;
  if (delta != nullptr) {
    const cudaError_t e =
        cudaMemsetAsync(delta, 0, sizeof(float), (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
  }
  const size_t smem = product_smem<SPLIT>();
  const int e = smem_opt_in(fista_grad_prox_kernel<SPLIT>, smem);
  if (e != 0) return e;
  const int vec = K % 4 == 0 && aligned(z, 16) && aligned(zp, 16);
  const int pairs = K % 2 == 0 && aligned(z_out, 8) &&
                    (trow == nullptr || aligned(trow, 8));
  const dim3 grid(round_up(K, TILE) / TILE, round_up(N, TILE) / TILE);
  fista_grad_prox_kernel<SPLIT><<<grid, wgp::THREADS, smem,
                                  (cudaStream_t)stream>>>(
      rb, z, zp, wt, scal, trow, t, rdot, counters, z_out, delta, scal_next,
      ys, N, D, K, nonneg, vec, pairs);
  return (int)cudaGetLastError();
}

}  // namespace

// scal points at one [4] row: lr, threshold (alpha * lr, 0 with trow),
// momentum, 1 / (1 + l2 * lr). t ([N], the restart carry) may be null.
// w is W's split [P, D128, K64] (bf16, zero-padded); r's split is written
// into rb [P, N, D64]. P = 2 (hi, lo) for f32, 1 for bf16. ys, when not
// null, is the momentum point's split [P, N, K64] as the previous
// fista_grad_prox wrote it (zero past K): y is read from it, and z, zp,
// scal and t are not read.
extern "C" int fista_resid_f32(const float* x, const float* z,
                               const float* zp, const void* w,
                               const float* scal, const float* t, float* r,
                               void* rb, const void* ys, int N, int D, int K,
                               void* stream) {
  return launch_resid<true>(x, z, zp, (const __nv_bfloat16*)w, scal, t, r,
                            (__nv_bfloat16*)rb, (const __nv_bfloat16*)ys, N,
                            D, K, stream);
}

extern "C" int fista_resid_bf16(const float* x, const float* z,
                                const float* zp, const void* w,
                                const float* scal, const float* t, float* r,
                                void* rb, const void* ys, int N, int D, int K,
                                void* stream) {
  return launch_resid<false>(x, z, zp, (const __nv_bfloat16*)w, scal, t, r,
                             (__nv_bfloat16*)rb, (const __nv_bfloat16*)ys, N,
                             D, K, stream);
}

// rb is r's split [P, N, D64] as K1 writes it, wt W^T's split [P, K128,
// D64]. trow ([K], threshold row already * lr), t, rdot ([N], zero) and
// counters ([ceil(N/128)], zero) may be null; t is advanced only when rdot
// and counters are given, and only read for the momentum otherwise. delta
// ([1]) is zeroed here and may be null when the caller does not need
// sum|z+ - z|. scal_next (the next step's [4] row) and ys ([P, N, K64],
// zero past K) go together: when given, the next step's momentum point
// z+ + scal_next[2] (z+ - z) is written into ys as its split.
extern "C" int fista_grad_prox_f32(const void* rb, const float* z,
                                   const float* zp, const void* wt,
                                   const float* scal, const float* trow,
                                   float* t, float* rdot,
                                   unsigned int* counters, float* z_out,
                                   float* delta, const float* scal_next,
                                   void* ys, int N, int D, int K, int nonneg,
                                   void* stream) {
  return launch_grad_prox<true>(
      (const __nv_bfloat16*)rb, z, zp, (const __nv_bfloat16*)wt, scal, trow,
      t, rdot, counters, z_out, delta, scal_next, (__nv_bfloat16*)ys, N, D,
      K, nonneg, stream);
}

extern "C" int fista_grad_prox_bf16(const void* rb, const float* z,
                                    const float* zp, const void* wt,
                                    const float* scal, const float* trow,
                                    float* t, float* rdot,
                                    unsigned int* counters, float* z_out,
                                    float* delta, const float* scal_next,
                                    void* ys, int N, int D, int K,
                                    int nonneg, void* stream) {
  return launch_grad_prox<false>(
      (const __nv_bfloat16*)rb, z, zp, (const __nv_bfloat16*)wt, scal, trow,
      t, rdot, counters, z_out, delta, scal_next, (__nv_bfloat16*)ys, N, D,
      K, nonneg, stream);
}

extern "C" const char* fista_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
