// Coordinate descent for the batched lasso: two hand-written kernels for
// Hopper (sm_90a).
//
// Replaces the TPU kernels of the JAX package's ops/fused_cd.py:
//   fused_cd_steps      (_make_cd_kernel)      -> K3 cd_steps
//   fused_cd_mod_sweep  (_make_cd_mod_kernel)  -> K4 cd_mod_sweep
//
// Both are row-independent: no row of b, z or R ever reads another row, so
// one warp owns one row and no block waits on another. The TPU layouts (a
// one-hot matrix-unit product as the row gather, codes transposed for
// dynamic sublane loads) existed for the TPU compiler's sake and are not
// carried over.
//
// K3 cd_steps: `steps` greedy CD steps per launch, one warp a row. A step
// computes prox(b)*scale - z, takes the first index of the largest |.|
// (ties to the smaller index, NaN counted as largest, as torch.argmax and
// jnp.argmax do), reads row k of S (S is 16 MB at K=2048 and stays in the
// 50 MB L2), and updates b, z_k and the active flag. A row that goes
// inactive is frozen, so the warp stops early; b, z and the flag are read
// and written once per launch. Two tiers:
//   - registers (K a multiple of 128 up to 2048, rows 16-byte aligned;
//     cd_steps_reg_kernel): b in registers, lane l the columns 128 m + 4 l
//     .. + 3, z and the thresholds in shared memory, row k of S by one bulk
//     copy; one sweep a step, step s's update fused with step s + 1's scan,
//     and the warp's first maximum by two warp reductions (REDUX) on the
//     bits of |diff| and the column. 148 registers at K = 2048, 12 warps an
//     SM.
//   - shared memory (every other K >= 32; cd_steps_kernel): b and z in
//     shared memory (2 K floats a row), lane l the
//     columns l, l + 32, ...; two sweeps a step (the scan, then the
//     update), the register tier's integer keys reduced by a shuffle
//     butterfly, S's row by plain loads, eight in flight a lane.
// In both, a row frozen with steps left gets what the plain version's
// later steps give it (their update is 0 * dz, NaN where the row's
// largest |diff| is not finite), and the prox keeps a NaN as torch's does.
//   What bounds it: the bytes of b and z in and out, 4 N K 4 B (0.54 GB,
//   0.16 ms at 3.35 TB/s at 16384 x 2048); the S rows come from L2, 1.07 GB
//   a launch in f32 at 8 steps, 0.139 ms at the 7.73 TB/s that
//   scripts/cd_steps_parts.py measures for such row gathers on an NVIDIA
//   H100 80GB HBM3 at 700 W. There the register tier takes 0.337 ms a
//   launch: the gathers' chain (a bulk copy and its wait a step) and b's
//   and z's I/O, which overlap only in part, are most of it (PERF.md).
//
// K4 cd_mod_sweep: one cyclic sweep over the K atoms, blocked over chunks
// of TJ = 16 atoms. Cyclic CD is sequential over the atoms only through R:
// with R0 the residual at a chunk's start and c_i = add_i - sub_i its
// updates,
//   rho_j = R0 . w_j + sum_{i < j in the chunk} c_i (w_i . w_j)
//           + add_j ||w_j||^2,
// and at the chunk's end R = R0 + C W_c^T. A block of 32 rows (four warps
// of 8) takes each chunk in three steps:
//   1. P = R0 W_c, the chunk's 16 dot products a row, as one product: each
//      warp holds its rows of R in registers (lane l the columns 4 l + 128 i)
//      against the chunk's atoms in shared memory, and a reduce-scatter sums
//      the lanes' partials across the warp;
//   2. the recurrence, one row a lane of warp 0: z_j, c_j, zmax and dzmax in
//      the JAX kernel's fused form (no add-back residual is formed), then
//      P_l += c_j G[j][l] for the chunk's later atoms, G = W_c^T W_c from a
//      prologue kernel (cd_mod_gram) once a call, which also rounds
//      d_j = ||w_j||^2 + l2 and 1 / d_j once for each atom;
//   3. R += C W_c^T, a rank-16 update of the registers.
// The next chunk's atoms land by bulk copies (TMA, one an atom, completing
// on an mbarrier; 4-byte cp.async where W^T's rows are not 16-byte aligned)
// and its codes and prologue entries by cp.async while this chunk computes,
// and each block reads W from L2 once (2 GB a sweep at 16384 x 512 -> 2048,
// against 8.6 GB when a warp owned a row and the block 8 rows, and ran one
// dot product, a shuffle reduction and a divide per atom as one dependent
// chain). With the bulk copies a sweep at that width took 2.21 ms, with
// 16-byte cp.async (16 copies a thread a chunk) 2.29. Columns with
// ||w_j||^2 = 0 and rows that have converged are left as they are. Above
// D = 512 the residual stays in R_out and the atoms are read through L1:
// 9.5 ms at 16384 x 768 -> 2048, 6.2x its bound (PERF.md).
//   What bounds it: the two products, 4 N K D FP32 operations (1.03 ms at
//   16384 x 512 -> 2048 at 67 TFLOP/s); the bytes (z and R in and out, W)
//   are 0.3 GB. The products are FFMA in registers, 8 rows x 16 columns a
//   lane, so that one float4 of an atom feeds 32 FMAs, with the next
//   atom's float4s loaded under the current one's. On an NVIDIA H100 80GB
//   HBM3 at 700 W a sweep there takes 2.2 ms (14.2 ms for the warp-a-row
//   version): about 0.75 ms for each product, the rest for the recurrence
//   (a chain of 16 steps of about nine dependent operations a chunk, on
//   one warp of the block), the atoms' copies, the codes' stores and the
//   chunk loop's barriers (PERF.md; scripts/cd_sweep_parts.py). The tensor
//   cores (3xTF32 warpgroup MMA, bound 0.42 ms) would need R's split in
//   shared memory each chunk, 128 KB at 32 rows, beside the atoms; that
//   route is not taken here.
//
// Rounding: the updates b += upd S[k, :], R += c w_j and rho = dot +
// add ||w_j||^2 are single-rounding FMAs (__fmaf_rn), which is how the JAX
// package's arithmetic compiles on the CPU and what torch.addcmul computes
// in the plain versions; every other operation is one _rn intrinsic, so
// the compiler contracts nothing else. K3 then matches its plain version
// bit for bit, K4 up to the order of the sums in its products and Gram
// entries. K4's divide is q = shr r_j corrected once by the exact
// remainder, fma(fma(-q, d_j, shr), r_j, q) with r_j = 1 / d_j rounded
// once: for operands that neither overflow nor underflow this is the
// correctly rounded quotient (Markstein), the value of __fdiv_rn and of
// torch's division, in three dependent operations in place of a call.
//
// Each C entry launches on the given stream, allocates nothing and returns
// cudaGetLastError() (or the error of its launch configuration).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "wgmma_product.cuh"  // cp.async, mbarrier and bulk-copy helpers

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int STEP_ROWS = 4;      // K3: warps (rows) per block
constexpr int SW_TJ = 16;         // K4: atoms a chunk
constexpr int SW_RW = 8;          // K4: rows a warp holds in its products
constexpr int SW_WARPS = 4;       // K4: warps a block
constexpr int SW_BM = SW_RW * SW_WARPS;           // K4: rows a block
constexpr int SW_PAIRS = SW_TJ * (SW_TJ - 1) / 2;  // Gram entries a chunk
constexpr int SW_GP = 128;        // ... padded to a multiple of 32
// a chunk's entries in the prologue's scratch: the Gram pairs, then the
// atoms' squared norms n_j, d_j = n_j + l2 and 1 / d_j (rounded once)
constexpr int SW_GS = SW_GP + 3 * SW_TJ;
constexpr int SW_PS = SW_TJ + 1;  // row stride of the dot and code tiles
constexpr int SW_CS = SW_TJ + 4;  // row stride of the coefficient tile

// where G[j][l] (j < l) of a chunk lies among its packed Gram entries
__host__ __device__ constexpr int pair_index(int j, int l) {
  return j * SW_TJ - j * (j + 1) / 2 + (l - j - 1);
}

__device__ __forceinline__ float load_s(const float* s, size_t i) {
  return s[i];
}

__device__ __forceinline__ float load_s(const __nv_bfloat16* s, size_t i) {
  return __bfloat162float(s[i]);
}

template <typename ST, bool NONNEG>
__global__ void __launch_bounds__(32 * STEP_ROWS)
    cd_steps_kernel(const float* __restrict__ b_in,
                    const float* __restrict__ z_in,
                    const float* __restrict__ act_in,
                    const ST* __restrict__ S, const float* __restrict__ trow,
                    float alpha, float tol_k, float scale,
                    float* __restrict__ b_out, float* __restrict__ z_out,
                    float* __restrict__ act_out, int N, int K, int steps,
                    int rows) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * rows + warp;
  if (n >= N) return;  // no barrier below: a warp may leave
  const size_t row = (size_t)n * K;
  float act = act_in[n];
  float* bs = smem + (size_t)warp * 2 * K;
  float* zs = bs + K;
  for (int j = lane; j < K; j += 32) {
    bs[j] = b_in[row + j];
    zs[j] = z_in[row + j];
  }

  // per step: the first index k of the largest |prox(b) * scale - z| and
  // its diff dz, then the update. A row frozen with steps to go scans once
  // more: the plain version's next step still adds 0 * dz, which is NaN
  // where the row's largest |diff| is not finite (b all NaN, z_k NaN), and
  // each step after it finds b all NaN and adds NaN to z_0; a finite dz
  // adds zeros, every step
  for (int left = steps; left > 0;) {
    // the running first maximum on the bits of |diff| (see the register
    // tier), then the warp's: the larger key, or the smaller column on a
    // tie, by a shuffle butterfly (with the register tier's REDUX pair the
    // loads of S's row below ran far slower)
    int bu = -1, bj = 0;
    float bd = 0.f;
    for (int j = lane; j < K; j += 32) {
      const float bv = bs[j];
      const float th = trow != nullptr ? trow[j] : alpha;
      float p;
      if (NONNEG) {
        const float a = __fsub_rn(bv, th);
        p = !(a <= 0.f) ? a : 0.f;   // a NaN stays NaN, as in clamp_min
      } else {
        const float a = __fsub_rn(fabsf(bv), th);
        p = !(a <= 0.f) ? copysignf(a, bv) : 0.f;
      }
      const float d = __fsub_rn(__fmul_rn(p, scale), zs[j]);
      const int u = __float_as_int(d) & 0x7fffffff;
      if (u > bu) {
        bu = u;
        bj = j;
        bd = d;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int ou = __shfl_xor_sync(FULL, bu, off);
      const int oj = __shfl_xor_sync(FULL, bj, off);
      if (ou > bu || (ou == bu && oj < bj)) {
        bu = ou;
        bj = oj;
      }
    }
    const int k = bj;  // every lane holds a column when K >= 32
    const float dz = __shfl_sync(FULL, bd, k & 31);
    const float upd = __fmul_rn(act, dz);
    if (act == 0.f) {
      if (upd != upd) {
        for (int j = lane; j < K; j += 32) bs[j] = upd;
        if ((k & 31) == lane) zs[k] = __fadd_rn(zs[k], upd);
        if (left > 1 && lane == 0) zs[0] = __fadd_rn(zs[0], upd);
      }
      break;
    }
    --left;
    // b += upd S[k, :], eight of the lane's loads of S's row in flight
    const ST* srow = S + (size_t)k * K;
    for (int j0 = lane; j0 < K; j0 += 32 * 8) {
      float sv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        sv[i] = j0 + 32 * i < K ? load_s(srow, j0 + 32 * i) : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (j0 + 32 * i < K)
          bs[j0 + 32 * i] = __fmaf_rn(upd, sv[i], bs[j0 + 32 * i]);
    }
    if ((k & 31) == lane) zs[k] = __fadd_rn(zs[k], upd);
    if (!(fabsf(dz) > tol_k)) act = 0.f;
  }

  for (int j = lane; j < K; j += 32) {
    b_out[row + j] = bs[j];
    z_out[row + j] = zs[j];
  }
  if (lane == 0) act_out[n] = act;
}

// K3's register tier, for K = 128 kq with kq <= M and 16-byte-aligned rows:
// the same steps, one warp a row, lane l the columns 128 m + 4 l .. + 3 (m
// < kq). b stays in registers, z in the warp's row of shared memory (each
// lane reads and writes only its own columns), the thresholds in one row
// of shared memory for the block, and row k of S comes into the warp's slot
// by one bulk copy (TMA) completing on the warp's mbarrier. One sweep a
// step: step s's update b += upd S[k, :] and step s + 1's scan (the prox,
// the diff and each lane's running first maximum) in the same pass over
// the row. The running maximum compares the bits of |diff| as integers:
// for |x| (sign cleared) their order is that of the values, with NaN (the
// card's arithmetic writes one NaN, 0x7fffffff) above infinity, so one
// compare keeps the rule "NaN first, then the larger". Each lane keeps
// four chains (one a float4 component, the larger index winning only if
// strictly larger) and merges them with the smaller index on a tie; the
// warp then takes the largest key by one __reduce_max_sync and the
// smallest column holding it by one __reduce_min_sync.
constexpr int REG_ROWS = 4;   // warps (rows) per register-tier block

__device__ __forceinline__ float4 load_slot(const float* slot, int i) {
  return reinterpret_cast<const float4*>(slot)[i];
}

__device__ __forceinline__ float4 load_slot(const __nv_bfloat16* slot,
                                            int i) {
  const uint2 u = reinterpret_cast<const uint2*>(slot)[i];
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(a), __high2float(a), __low2float(b),
                     __high2float(b));
}

template <typename ST, bool NONNEG, int M>
__global__ void __launch_bounds__(32 * REG_ROWS, M >= 16 ? 3 : M >= 8 ? 5 : 6)
    cd_steps_reg_kernel(const float* __restrict__ b_in,
                        const float* __restrict__ z_in,
                        const float* __restrict__ act_in,
                        const ST* __restrict__ S,
                        const float* __restrict__ trow, float alpha,
                        float tol_k, float scale, float* __restrict__ b_out,
                        float* __restrict__ z_out,
                        float* __restrict__ act_out, int N, int K,
                        int steps) {
  extern __shared__ __align__(16) float rsm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kq = K >> 7;
  const int slot_floats = K * (int)sizeof(ST) / 4;
  float* const th = rsm;                                  // [K], the block's
  float* const zs = th + K + warp * (K + slot_floats);    // [K], the warp's
  ST* const slot = reinterpret_cast<ST*>(zs + K);         // row k of S
  const uint32_t bar =
      wgp::smem_addr(rsm + K + REG_ROWS * (K + slot_floats)) + 8 * warp;
  for (int j = threadIdx.x; j < K; j += blockDim.x)
    th[j] = trow != nullptr ? trow[j] : alpha;
  __syncthreads();  // the only block-wide barrier: warps may leave below
  const int n = blockIdx.x * REG_ROWS + warp;
  if (n >= N) return;
  const size_t row = (size_t)n * K;
  const float4* b4 = reinterpret_cast<const float4*>(b_in + row);
  const float4* z4 = reinterpret_cast<const float4*>(z_in + row);
  float4* bo4 = reinterpret_cast<float4*>(b_out + row);
  float4* zo4 = reinterpret_cast<float4*>(z_out + row);
  float4* const zs4 = reinterpret_cast<float4*>(zs);
  const float4* const th4 = reinterpret_cast<const float4*>(th);
  float act = act_in[n];
  float4 bv[M];
#pragma unroll
  for (int m = 0; m < M; ++m)
    if (m < kq) {
      bv[m] = b4[lane + 32 * m];
      zs4[lane + 32 * m] = z4[lane + 32 * m];
    }
  if (lane == 0) {
    wgp::mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();

  // the scan's running first maximum: four chains a lane, the key the bits
  // of |diff|, the column's group m and the signed diff
  int bu[4] = {-1, -1, -1, -1}, bm[4] = {0, 0, 0, 0};
  float bd[4] = {0.f, 0.f, 0.f, 0.f};
  auto scan_one = [&](float bval, float thv, float zv, int m, int e) {
    float p;
    if (NONNEG) {
      const float a = __fsub_rn(bval, thv);
      p = !(a <= 0.f) ? a : 0.f;   // a NaN stays NaN, as in clamp_min
    } else {
      const float a = __fsub_rn(fabsf(bval), thv);
      p = !(a <= 0.f) ? copysignf(a, bval) : 0.f;
    }
    const float dv = __fsub_rn(__fmul_rn(p, scale), zv);
    const int u = __float_as_int(dv) & 0x7fffffff;
    if (u > bu[e]) {
      bu[e] = u;
      bm[e] = m;
      bd[e] = dv;
    }
  };
  auto scan_group = [&](int m) {
    const float4 z = zs4[lane + 32 * m], t = th4[lane + 32 * m];
    scan_one(bv[m].x, t.x, z.x, m, 0);
    scan_one(bv[m].y, t.y, z.y, m, 1);
    scan_one(bv[m].z, t.z, z.z, m, 2);
    scan_one(bv[m].w, t.w, z.w, m, 3);
  };
  // b += upd S[k, :] on the lane's float4 group m, from the slot
  auto update_group = [&](int m, float upd) {
    const float4 sv = load_slot(slot, lane + 32 * m);
    bv[m].x = __fmaf_rn(upd, sv.x, bv[m].x);
    bv[m].y = __fmaf_rn(upd, sv.y, bv[m].y);
    bv[m].z = __fmaf_rn(upd, sv.z, bv[m].z);
    bv[m].w = __fmaf_rn(upd, sv.w, bv[m].w);
  };
  auto reset = [&]() {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      bu[e] = -1;
      bm[e] = 0;
      bd[e] = 0.f;
    }
  };
  // the warp's first maximum: its column k and signed diff dz
  unsigned k = 0;
  float dz = 0.f;
  auto reduce = [&]() {
    int U = bu[0];
    unsigned J = 128u * bm[0] + 4u * lane;
    float Dv = bd[0];
#pragma unroll
    for (int e = 1; e < 4; ++e) {
      const unsigned j = 128u * bm[e] + 4u * lane + e;
      if (bu[e] > U || (bu[e] == U && j < J)) {
        U = bu[e];
        J = j;
        Dv = bd[e];
      }
    }
    const unsigned top = __reduce_max_sync(FULL, (unsigned)U);
    k = __reduce_min_sync(FULL, (unsigned)U == top ? J : 0xffffffffu);
    dz = __shfl_sync(FULL, Dv, (k >> 2) & 31);
  };

  auto scan_reduce = [&]() {
    reset();
#pragma unroll
    for (int m = 0; m < M; ++m)
      if (m < kq) scan_group(m);
    reduce();
  };

  int left = steps;   // the steps not taken yet
  if (act != 0.f && left > 0) scan_reduce();
  uint32_t phase = 0;
  while (act != 0.f && left > 0) {
    --left;
    const float upd = __fmul_rn(act, dz);
    if (((k >> 2) & 31) == (unsigned)lane) zs[k] = __fadd_rn(zs[k], upd);
    if (!(fabsf(dz) > tol_k)) act = 0.f;
    const bool more = left > 0 && act != 0.f;
    if (lane == 0) {  // every lane has read the slot (the reductions)
      wgp::fence_proxy_async();
      wgp::mbar_expect_tx(bar, (uint32_t)(K * sizeof(ST)));
      wgp::bulk_copy(wgp::smem_addr(slot), S + (size_t)k * K,
                     (uint32_t)(K * sizeof(ST)), bar);
    }
    wgp::mbar_wait(bar, phase);
    phase ^= 1u;
    if (more) {
      reset();
#pragma unroll
      for (int m = 0; m < M; ++m)
        if (m < kq) {
          update_group(m, upd);
          scan_group(m);
        }
      __syncwarp();
      reduce();
    } else {
#pragma unroll
      for (int m = 0; m < M; ++m)
        if (m < kq) update_group(m, upd);
    }
  }
  if (left > 0) {
    // frozen with steps to go: the plain version's next step still adds
    // 0 * dz, which is NaN where the row's largest |diff| is not finite
    // (b all NaN, z_k NaN), and each step after it finds b all NaN and
    // adds NaN to z_0; a finite dz adds zeros, every step
    scan_reduce();
    const float upd = __fmul_rn(act, dz);
    if (upd != upd) {
#pragma unroll
      for (int m = 0; m < M; ++m)
        bv[m] = make_float4(upd, upd, upd, upd);
      if (((k >> 2) & 31) == (unsigned)lane) zs[k] = __fadd_rn(zs[k], upd);
      if (left > 1 && lane == 0) zs[0] = __fadd_rn(zs[0], upd);
    }
  }

#pragma unroll
  for (int m = 0; m < M; ++m)
    if (m < kq) {
      bo4[lane + 32 * m] = bv[m];
      zo4[lane + 32 * m] = zs4[lane + 32 * m];
    }
  if (lane == 0) act_out[n] = act;
}

// Sums v over the warp's 32 lanes, element by element, and leaves lane l
// the totals of elements l V/32 ... l V/32 + V/32 - 1 in v[0 .. V/32 - 1]:
// at each of the five butterfly steps a lane keeps one half of its live
// elements and adds the partner's copy of it (V - V/32 shuffles a lane in
// all, against 5 V for a shuffle sum of each element apart). For the first
// NOSEL steps the caller has stored, in a lane whose bit O is set, the two
// halves swapped (the upper half's elements in the lower slots), so that
// every lane keeps its lower slots and sends its upper ones, with no
// select; lane l then holds element l V/32 ... with those index bits
// counted as the lane's own.
template <int V, int NOSEL = 0, int O = 16>
__device__ __forceinline__ void reduce_scatter(float (&v)[V], int lane) {
  constexpr int H = V * O / 32;  // half the elements still live
  constexpr bool swapped = (O == 16 ? 0 : O == 8 ? 1 : O == 4 ? 2
                            : O == 2 ? 3 : 4) < NOSEL;
  const bool up = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = swapped || !up ? v[i + H] : v[i];
    const float keep = swapped || !up ? v[i] : v[i + H];
    v[i] = __fadd_rn(keep, __shfl_xor_sync(FULL, send, O));
  }
  if constexpr (O > 1) reduce_scatter<V, NOSEL, O / 2>(v, lane);
}

using wgp::bulk_copy;
using wgp::mbar_expect_tx;

// K4's prologue: for each chunk c of SW_TJ atoms, the entries G[a][b] =
// w_a . w_b (a < b) of its Gram block, packed by pair_index into
// gram[c * SW_GS ...] (the SW_GP - SW_PAIRS tail zero), then n_j, d_j and
// r_j = 1 / d_j (zero past K). One block a chunk, one thread a pair, the
// chunk's atoms staged 128 columns at a time.
__global__ void __launch_bounds__(SW_GP)
    cd_mod_gram_kernel(const float* __restrict__ wt,
                       const float* __restrict__ nrm, float l2, int D, int K,
                       float* __restrict__ gram) {
  __shared__ float ws[SW_TJ][129];  // padded: rows fall on distinct banks
  const int t = threadIdx.x, j0 = blockIdx.x * SW_TJ;
  int a = 0, p = t;
  while (a < SW_TJ - 1 && p >= SW_TJ - 1 - a) p -= SW_TJ - 1 - a++;
  const int b = a + 1 + p;
  float acc = 0.f;
  for (int d0 = 0; d0 < D; d0 += 128) {
    __syncthreads();
    for (int i = t; i < SW_TJ * 128; i += SW_GP) {
      const int r = i >> 7, d = d0 + (i & 127);
      ws[r][i & 127] =
          j0 + r < K && d < D ? wt[(size_t)(j0 + r) * D + d] : 0.f;
    }
    __syncthreads();
    if (t < SW_PAIRS) {
#pragma unroll 8
      for (int c = 0; c < 128; ++c) acc = __fmaf_rn(ws[a][c], ws[b][c], acc);
    }
  }
  float* g = gram + (size_t)blockIdx.x * SW_GS;
  g[t] = t < SW_PAIRS ? acc : 0.f;
  if (t < SW_TJ) {
    const bool in = j0 + t < K;
    const float dj = in ? __fadd_rn(nrm[j0 + t], l2) : 0.f;
    g[SW_GP + t] = in ? nrm[j0 + t] : 0.f;
    g[SW_GP + SW_TJ + t] = dj;
    // zero for an empty atom: its quotient is then zero, with no select
    g[SW_GP + 2 * SW_TJ + t] = in && nrm[j0 + t] != 0.f ? __frcp_rn(dj) : 0.f;
  }
}

// K4: one cyclic sweep, SW_BM rows a block, blocked over chunks of SW_TJ
// atoms (see the note at the top). With Q > 0 each warp holds the residual
// of its SW_RW rows in registers, lane l the columns 128 i + 4 l .. + 3
// (i < Q, so D <= 128 Q), and the chunk's atoms lie in shared memory as
// rows of 128 Q floats (zero past D and past K). With Q = 0 (D > 512) the
// residual lives in R_out and the atoms are read through L1, lane l taking
// the columns l, l + 32, ...
template <int Q>
__global__ void __launch_bounds__(32 * SW_WARPS, 2)
    cd_mod_sweep_kernel(const float* __restrict__ z_in,
                        const float* __restrict__ R_in,
                        const float* __restrict__ act_in,
                        const float* __restrict__ wt,
                        const float* __restrict__ gram, float alpha,
                        float* __restrict__ z_out, float* __restrict__ R_out,
                        float* __restrict__ zmax_out,
                        float* __restrict__ dzmax_out, int N, int D, int K) {
  constexpr int DP = 128 * Q;  // an atom's row in shared memory
  extern __shared__ float4 smem4[];
  float* const wb = reinterpret_cast<float*>(smem4);  // [2][TJ][DP] atoms
  float* const cs = wb + 2 * SW_TJ * DP;              // [BM][CS] coefficients
  float* const gs = cs + SW_BM * SW_CS;               // [2][GS] prologue's
  float* const zs = gs + 2 * SW_GS;                   // [2][BM][PS] codes
  float* const ps = zs + 2 * SW_BM * SW_PS;           // [BM][PS] dots
  int* const lv = reinterpret_cast<int*>(ps + SW_BM * SW_PS);  // [BM] live
  uint64_t* const bars = reinterpret_cast<uint64_t*>(lv + SW_BM);
  // atoms by bulk copies where W^T's rows are 16-byte aligned, else by
  // 4-byte cp.async
  const bool bulk =
      (D & 3) == 0 && (reinterpret_cast<uintptr_t>(wt) & 15) == 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * SW_BM;
  const int wrow0 = row0 + warp * SW_RW;  // the warp's rows in the products

  // the warp's live rows; converged ones are copied through
  unsigned live = 0;
  for (int r = 0; r < SW_RW && wrow0 + r < N; ++r) {
    const size_t n = wrow0 + r;
    if (act_in[n] != 0.f) {
      live |= 1u << r;
      continue;
    }
    for (int j = lane; j < K; j += 32) z_out[n * K + j] = z_in[n * K + j];
    for (int d = lane; d < D; d += 32) R_out[n * D + d] = R_in[n * D + d];
    if (lane == 0) zmax_out[n] = dzmax_out[n] = 0.f;
  }
  if constexpr (Q > 0) {
    // zero both atom buffers once: the columns past D stay zero, and the
    // rows past K of a last chunk hold zeros or an earlier chunk's atoms
    for (int i = threadIdx.x; i < 2 * SW_TJ * DP; i += blockDim.x)
      wb[i] = 0.f;
    wgp::fence_proxy_async();  // before the bulk copies write them
    if (threadIdx.x == 0) {
      wgp::mbar_init(wgp::smem_addr(bars), 1);
      wgp::mbar_init(wgp::smem_addr(bars + 1), 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  if (!__syncthreads_or(live != 0)) return;  // the whole block is converged
  // the recurrence's row (warps 0 .. BM/32 - 1, one row a lane)
  const int rr = warp * 32 + lane, rn = row0 + rr;
  const bool rlive = warp < SW_BM / 32 && rn < N && act_in[rn] != 0.f;
  if (warp < SW_BM / 32) lv[rr] = rlive;

  float4 R[SW_RW][Q > 0 ? Q : 1];
  if constexpr (Q > 0) {
#pragma unroll
    for (int r = 0; r < SW_RW; ++r) {
      const float* src = R_in + (size_t)(wrow0 + r) * D;
      const bool in = (live >> r) & 1;
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        const int d = 128 * i + 4 * lane;
        R[r][i].x = in && d < D ? src[d] : 0.f;
        R[r][i].y = in && d + 1 < D ? src[d + 1] : 0.f;
        R[r][i].z = in && d + 2 < D ? src[d + 2] : 0.f;
        R[r][i].w = in && d + 3 < D ? src[d + 3] : 0.f;
      }
    }
  } else {
    for (int r = 0; r < SW_RW; ++r)
      if ((live >> r) & 1) {
        const size_t o = (size_t)(wrow0 + r) * D;
        for (int d = lane; d < D; d += 32) R_out[o + d] = R_in[o + d];
      }
  }

  // chunk c's atoms (bulk copies, or 4-byte cp.async zero past D and K),
  // codes (zero past N and K) and prologue entries into buffer c & 1
  auto stage = [&](int c) {
    const int b = c & 1, j0 = c * SW_TJ;
    if constexpr (Q > 0) {
      float* w = wb + b * SW_TJ * DP;
      if (bulk) {  // one bulk copy an atom, issued by one thread
        if (threadIdx.x == 0) {
          const int rows = min(SW_TJ, K - j0);
          const uint32_t bar = wgp::smem_addr(bars + b);
          wgp::fence_proxy_async();
          mbar_expect_tx(bar, (uint32_t)(rows * D * 4));
          for (int a = 0; a < rows; ++a)
            bulk_copy(wgp::smem_addr(w + a * DP), wt + (size_t)(j0 + a) * D,
                      (uint32_t)(D * 4), bar);
        }
      } else {  // rows not 16-byte aligned
        for (int i = threadIdx.x; i < SW_TJ * DP; i += blockDim.x) {
          const int a = i / DP, d = i % DP;
          const bool in = j0 + a < K && d < D;
          wgp::cp_async4_fill(wgp::smem_addr(w + i),
                              in ? wt + (size_t)(j0 + a) * D + d : wt,
                              in ? 4 : 0);
        }
      }
    }
    for (int i = threadIdx.x; i < SW_BM * SW_TJ; i += blockDim.x) {
      const int r = i / SW_TJ, j = i % SW_TJ;
      const bool in = row0 + r < N && j0 + j < K;
      wgp::cp_async4_fill(
          wgp::smem_addr(zs + (b * SW_BM + r) * SW_PS + j),
          in ? z_in + (size_t)(row0 + r) * K + j0 + j : z_in, in ? 4 : 0);
    }
    for (int i = threadIdx.x; i < SW_GS / 4; i += blockDim.x)
      wgp::cp_async16(wgp::smem_addr(gs + b * SW_GS + 4 * i),
                      gram + (size_t)c * SW_GS + 4 * i);
    wgp::cp_async_commit();
  };

  const int nch = (K + SW_TJ - 1) / SW_TJ;
  float zmax = 0.f, dzmax = 0.f;
  // chunk c's copies have landed
  auto landed = [&](int c) {
    wgp::cp_async_wait_all();
    if (Q > 0 && bulk)
      wgp::mbar_wait(wgp::smem_addr(bars + (c & 1)), (c >> 1) & 1);
  };
  stage(0);
  landed(0);
  __syncthreads();
  for (int c = 0; c < nch; ++c) {
    const int b = c & 1, j0 = c * SW_TJ;
    if (c + 1 < nch) stage(c + 1);  // lands while this chunk computes
    const float* w = wb + b * SW_TJ * DP;

    // 1. P = R W_c: the chunk's dot products of the rows as they were at
    // its start, summed over the lane's columns and then across the warp
    if constexpr (Q > 0) {
      // slot a of a batch holds atom a0 + (a ^ sw): the lane's bits 4 and
      // 3 swap the halves that the reduce-scatter's first two steps keep
      const int sw = (lane >> 3) & 3;
      // the lane's float4s of slot t (atom t ^ sw), loaded one slot ahead
      float4 vn[Q];
      auto load_slot = [&](int t) {
        const float* wa = w + (t ^ sw) * DP + 4 * lane;
#pragma unroll
        for (int i = 0; i < Q; ++i)
          vn[i] = *reinterpret_cast<const float4*>(wa + 128 * i);
      };
      load_slot(0);
#pragma unroll 1
      for (int a0 = 0; a0 < SW_TJ; a0 += 4) {
        float acc[4 * SW_RW];  // slot a, row r at 8 a + r
#pragma unroll
        for (int i = 0; i < 4 * SW_RW; ++i) acc[i] = 0.f;
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          float4 vc[Q];
#pragma unroll
          for (int i = 0; i < Q; ++i) vc[i] = vn[i];
          if (a0 + a + 1 < SW_TJ) load_slot(a0 + a + 1);
#pragma unroll
          for (int i = 0; i < Q; ++i) {
            const float4 v = vc[i];
#pragma unroll
            for (int r = 0; r < SW_RW; ++r) {
              float& s = acc[SW_RW * a + r];
              s = __fmaf_rn(R[r][i].x, v.x, s);
              s = __fmaf_rn(R[r][i].y, v.y, s);
              s = __fmaf_rn(R[r][i].z, v.z, s);
              s = __fmaf_rn(R[r][i].w, v.w, s);
            }
          }
        }
        reduce_scatter<4 * SW_RW, 2>(acc, lane);  // row l % 8, atom a0 + sw
        ps[(warp * SW_RW + (lane & 7)) * SW_PS + a0 + sw] = acc[0];
      }
    } else {
      float acc[SW_RW * SW_TJ];
#pragma unroll
      for (int i = 0; i < SW_RW * SW_TJ; ++i) acc[i] = 0.f;
      for (int d = lane; d < D; d += 32) {
        float rv[SW_RW];
#pragma unroll
        for (int r = 0; r < SW_RW; ++r)
          rv[r] = (live >> r) & 1 ? R_out[(size_t)(wrow0 + r) * D + d] : 0.f;
#pragma unroll
        for (int a = 0; a < SW_TJ; ++a) {
          const float v =
              j0 + a < K ? __ldg(wt + (size_t)(j0 + a) * D + d) : 0.f;
#pragma unroll
          for (int r = 0; r < SW_RW; ++r)
            acc[SW_TJ * r + a] = __fmaf_rn(rv[r], v, acc[SW_TJ * r + a]);
        }
      }
      reduce_scatter(acc, lane);  // lane l: row l / 4, atoms 4 (l % 4) + m
#pragma unroll
      for (int m = 0; m < SW_TJ * SW_RW / 32; ++m)
        ps[(warp * SW_RW + (lane >> 2)) * SW_PS + 4 * (lane & 3) + m] =
            acc[m];
    }
    __syncthreads();

    // 2. the recurrence, one row a lane: rho_j = P_j + add_j n_j, then
    // P_l += c_j G[j][l] for the chunk's later atoms l. Straight-line code
    // (selects, no branches), so that only the chain through c_j waits
    if (warp < SW_BM / 32) {
      // the row's dots and codes in registers, and no store until the
      // chain has run: a store to shared memory inside it would keep the
      // compiler from loading the next steps' operands ahead
      float p[SW_TJ], zv[SW_TJ], cv[SW_TJ];
      float* zr = zs + (b * SW_BM + rr) * SW_PS;
#pragma unroll
      for (int j = 0; j < SW_TJ; ++j) {
        p[j] = ps[rr * SW_PS + j];
        zv[j] = zr[j];
      }
      const float* g = gs + b * SW_GS;
#pragma unroll
      for (int j = 0; j < SW_TJ; ++j) {
        const float nj = g[SW_GP + j], zj = zv[j];
        const bool on = rlive && nj != 0.f;  // an empty atom changes nothing
        // off the chain: a row or atom that is off gets add = 0 and an
        // infinite threshold, hence shr = +-0, a zero quotient and c_j = 0
        const float add = on && zj != 0.f ? zj : 0.f;
        const float thr = on ? alpha : INFINITY;
        const float rho = __fmaf_rn(add, nj, p[j]);
        const float shr =
            copysignf(fmaxf(__fsub_rn(fabsf(rho), thr), 0.f), rho);
        // shr / d_j, correctly rounded: q0 = shr r_j, then one correction
        // by the exact remainder (Markstein), with r_j = 1 / d_j rounded
        // once by the prologue
        const float dj = g[SW_GP + SW_TJ + j], rj = g[SW_GP + 2 * SW_TJ + j];
        const float q0 = __fmul_rn(shr, rj);
        const float zq = __fmaf_rn(__fmaf_rn(-q0, dj, shr), rj, q0);
        cv[j] = __fsub_rn(add, zq);
        zv[j] = on ? zq : zj;
        dzmax = on ? fmaxf(dzmax, fabsf(__fsub_rn(zv[j], zj))) : dzmax;
        zmax = on ? fmaxf(zmax, fabsf(zv[j])) : zmax;
#pragma unroll
        for (int l = j + 1; l < SW_TJ; ++l)
          p[l] = __fmaf_rn(cv[j], g[pair_index(j, l)], p[l]);
      }
#pragma unroll
      for (int j = 0; j < SW_TJ; ++j) {
        zr[j] = zv[j];
        cs[rr * SW_CS + j] = cv[j];
      }
    }
    __syncthreads();

    // the chunk's codes of the live rows, a row's 16 as four float4 stores
    if ((K & 3) == 0) {
      const int r = threadIdx.x >> 2, j = 4 * (threadIdx.x & 3);
      const float* src = zs + (b * SW_BM + r) * SW_PS + j;
      if (lv[r] && j0 + j < K)
        *reinterpret_cast<float4*>(z_out + (size_t)(row0 + r) * K + j0 + j) =
            make_float4(src[0], src[1], src[2], src[3]);
    } else {
      for (int i = threadIdx.x; i < SW_BM * SW_TJ; i += blockDim.x) {
        const int r = i / SW_TJ, j = i % SW_TJ;
        if (lv[r] && j0 + j < K)
          z_out[(size_t)(row0 + r) * K + j0 + j] =
              zs[(b * SW_BM + r) * SW_PS + j];
      }
    }

    // 3. R += C W_c^T: the chunk's rank-SW_TJ correction
    if constexpr (Q > 0) {
      // the lane's float4s of atom t, loaded one atom ahead
      float4 vn[Q];
      auto load_atom = [&](int t) {
#pragma unroll
        for (int i = 0; i < Q; ++i)
          vn[i] = *reinterpret_cast<const float4*>(w + t * DP + 128 * i +
                                                   4 * lane);
      };
      load_atom(0);
#pragma unroll 1
      for (int a0 = 0; a0 < SW_TJ; a0 += 4) {
        float4 cv[SW_RW];
#pragma unroll
        for (int r = 0; r < SW_RW; ++r)
          cv[r] = *reinterpret_cast<const float4*>(
              cs + (warp * SW_RW + r) * SW_CS + a0);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          float4 vc[Q];
#pragma unroll
          for (int i = 0; i < Q; ++i) vc[i] = vn[i];
          if (a0 + a + 1 < SW_TJ) load_atom(a0 + a + 1);
#pragma unroll
          for (int i = 0; i < Q; ++i) {
            const float4 v = vc[i];
#pragma unroll
            for (int r = 0; r < SW_RW; ++r) {
              const float cr = a == 0   ? cv[r].x
                               : a == 1 ? cv[r].y
                               : a == 2 ? cv[r].z
                                        : cv[r].w;
              R[r][i].x = __fmaf_rn(cr, v.x, R[r][i].x);
              R[r][i].y = __fmaf_rn(cr, v.y, R[r][i].y);
              R[r][i].z = __fmaf_rn(cr, v.z, R[r][i].z);
              R[r][i].w = __fmaf_rn(cr, v.w, R[r][i].w);
            }
          }
        }
      }
    } else {
      float cv[SW_RW][SW_TJ];
#pragma unroll
      for (int r = 0; r < SW_RW; ++r)
#pragma unroll
        for (int a = 0; a < SW_TJ; ++a)
          cv[r][a] = cs[(warp * SW_RW + r) * SW_CS + a];
      for (int d = lane; d < D; d += 32) {
        float rv[SW_RW];
#pragma unroll
        for (int r = 0; r < SW_RW; ++r)
          rv[r] = (live >> r) & 1 ? R_out[(size_t)(wrow0 + r) * D + d] : 0.f;
#pragma unroll
        for (int a = 0; a < SW_TJ; ++a) {
          const float v =
              j0 + a < K ? __ldg(wt + (size_t)(j0 + a) * D + d) : 0.f;
#pragma unroll
          for (int r = 0; r < SW_RW; ++r)
            rv[r] = __fmaf_rn(cv[r][a], v, rv[r]);
        }
#pragma unroll
        for (int r = 0; r < SW_RW; ++r)
          if ((live >> r) & 1) R_out[(size_t)(wrow0 + r) * D + d] = rv[r];
      }
    }
    if (c + 1 < nch) landed(c + 1);
    __syncthreads();
  }

  if constexpr (Q > 0) {
#pragma unroll
    for (int r = 0; r < SW_RW; ++r) {
      if (!((live >> r) & 1)) continue;
      float* dst = R_out + (size_t)(wrow0 + r) * D;
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        const int d = 128 * i + 4 * lane;
        if (d < D) dst[d] = R[r][i].x;
        if (d + 1 < D) dst[d + 1] = R[r][i].y;
        if (d + 2 < D) dst[d + 2] = R[r][i].z;
        if (d + 3 < D) dst[d + 3] = R[r][i].w;
      }
    }
  }
  if (rlive) {
    zmax_out[rn] = zmax;
    dzmax_out[rn] = dzmax;
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

constexpr size_t SMEM_MAX = 227 * 1024;

template <typename ST, int M>
int launch_steps_reg(const float* b, const float* z, const float* act,
                     const ST* S, const float* trow, float alpha, float tol_k,
                     float scale, int nonneg, float* b_out, float* z_out,
                     float* act_out, int N, int K, int steps, void* stream) {
  const size_t smem = sizeof(float) * (K + REG_ROWS * (K + K * sizeof(ST) / 4))
                      + 8 * REG_ROWS;
  auto kernel = nonneg ? cd_steps_reg_kernel<ST, true, M>
                       : cd_steps_reg_kernel<ST, false, M>;
  const int e = set_smem(kernel, smem);
  if (e != 0) return e;
  kernel<<<(N + REG_ROWS - 1) / REG_ROWS, 32 * REG_ROWS, smem,
           (cudaStream_t)stream>>>(b, z, act, S, trow, alpha, tol_k, scale,
                                   b_out, z_out, act_out, N, K, steps);
  return (int)cudaGetLastError();
}

template <typename ST>
int launch_steps(const float* b, const float* z, const float* act,
                 const ST* S, const float* trow, float alpha, float tol_k,
                 float scale, int nonneg, float* b_out, float* z_out,
                 float* act_out, int N, int K, int steps, void* stream) {
  if (K < 32) return (int)cudaErrorInvalidValue;
  // the register tier: K a multiple of 128 up to 2048, rows 16-byte aligned
  const bool aligned = ((uintptr_t)b | (uintptr_t)z | (uintptr_t)S |
                        (uintptr_t)b_out | (uintptr_t)z_out) % 16 == 0;
  if (aligned && K % 128 == 0 && K <= 2048) {
#define STEPS_REG(M)                                                       \
  return launch_steps_reg<ST, M>(b, z, act, S, trow, alpha, tol_k, scale,  \
                                 nonneg, b_out, z_out, act_out, N, K, steps, \
                                 stream)
    if (K <= 512) STEPS_REG(4);
    if (K <= 1024) STEPS_REG(8);
    STEPS_REG(16);
#undef STEPS_REG
  }
  // the shared-memory tier: b and z in shared memory (2 K floats a row)
  // rows per block: as many as fit (at most STEP_ROWS)
  int rows = STEP_ROWS;
  while (rows > 1 && (size_t)rows * 2 * K * sizeof(float) > SMEM_MAX) --rows;
  const size_t smem = (size_t)rows * 2 * K * sizeof(float);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto kernel = nonneg ? cd_steps_kernel<ST, true> : cd_steps_kernel<ST, false>;
  const int e = set_smem(kernel, smem);
  if (e != 0) return e;
  kernel<<<(N + rows - 1) / rows, 32 * rows, smem, (cudaStream_t)stream>>>(
      b, z, act, S, trow, alpha, tol_k, scale, b_out, z_out, act_out, N, K,
      steps, rows);
  return (int)cudaGetLastError();
}

template <int Q>
int launch_sweep(const float* z, const float* R, const float* act,
                 const float* wt, const float* nrm, float alpha, float l2,
                 float* gram, float* z_out, float* R_out, float* zmax,
                 float* dzmax, int N, int D, int K, void* stream) {
  const size_t smem = sizeof(float) * (2 * SW_TJ * 128 * Q + SW_BM * SW_CS +
                                       2 * SW_GS + 3 * SW_BM * SW_PS) +
                      SW_BM * sizeof(int) + 2 * sizeof(uint64_t);
  const int e = set_smem(cd_mod_sweep_kernel<Q>, smem);
  if (e != 0) return e;
  const cudaStream_t s = (cudaStream_t)stream;
  cd_mod_gram_kernel<<<(K + SW_TJ - 1) / SW_TJ, SW_GP, 0, s>>>(wt, nrm, l2,
                                                                D, K, gram);
  const int eg = (int)cudaGetLastError();
  if (eg != 0) return eg;
  cd_mod_sweep_kernel<Q><<<(N + SW_BM - 1) / SW_BM, 32 * SW_WARPS, smem, s>>>(
      z, R, act, wt, gram, alpha, z_out, R_out, zmax, dzmax, N, D, K);
  return (int)cudaGetLastError();
}

}  // namespace

// b, z: [N, K]; act: [N] float 0/1; S: [K, K] (f32, or bf16 for
// cd_steps_bf16); trow: [K] threshold row or null (then alpha);
// scale = 1 / (1 + l2). Needs K >= 32 and 8 K floats of shared memory.
extern "C" int cd_steps_f32(const float* b, const float* z, const float* act,
                            const float* S, const float* trow, float alpha,
                            float tol_k, float scale, int nonneg,
                            float* b_out, float* z_out, float* act_out, int N,
                            int K, int steps, void* stream) {
  return launch_steps<float>(b, z, act, S, trow, alpha, tol_k, scale, nonneg,
                             b_out, z_out, act_out, N, K, steps, stream);
}

extern "C" int cd_steps_bf16(const float* b, const float* z, const float* act,
                             const void* S, const float* trow, float alpha,
                             float tol_k, float scale, int nonneg,
                             float* b_out, float* z_out, float* act_out,
                             int N, int K, int steps, void* stream) {
  return launch_steps<__nv_bfloat16>(
      b, z, act, static_cast<const __nv_bfloat16*>(S), trow, alpha, tol_k,
      scale, nonneg, b_out, z_out, act_out, N, K, steps, stream);
}

// Floats of the scratch `gram` that cd_mod_sweep needs for K atoms: the
// prologue's entries of each chunk.
extern "C" int cd_mod_gram_floats(int K) {
  return (K + SW_TJ - 1) / SW_TJ * SW_GS;
}

// z: [N, K]; R: [N, D]; act: [N] float (0 = converged); wt: W^T [K, D];
// nrm: [K] squared column norms; gram: scratch of cd_mod_gram_floats(K)
// floats. Writes z_out, R_out, zmax and dzmax ([N]). Two launches: the
// prologue, then the sweep.
extern "C" int cd_mod_sweep(const float* z, const float* R, const float* act,
                            const float* wt, const float* nrm, float alpha,
                            float l2, float* gram, float* z_out,
                            float* R_out, float* zmax, float* dzmax, int N,
                            int D, int K, void* stream) {
#define SWEEP(Q)                                                            \
  return launch_sweep<Q>(z, R, act, wt, nrm, alpha, l2, gram, z_out, R_out, \
                         zmax, dzmax, N, D, K, stream)
  if (D <= 128) SWEEP(1);
  if (D <= 256) SWEEP(2);
  if (D <= 384) SWEEP(3);
  if (D <= 512) SWEEP(4);
  SWEEP(0);
#undef SWEEP
}

extern "C" const char* cd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
