// One convolutional FISTA step as two hand-written kernels for Hopper
// (sm_90a), both implicit GEMMs on the tensor cores (warpgroup MMA).
//
// Replaces the TPU kernel of the JAX package's ops/fused_conv.py:
// fused_conv_fista_multistep (_make_conv_kernel). On the TPU the S steps'
// iterates stay in VMEM in a "canvas" layout (channels on sublanes, pixels
// on lanes, every tap a constant lane offset) and each conv is one
// matrix-unit product plus lane rotates. On the H100 one sample's f32 codes
// are 173 KB at 64x26x26 and 803 KB at 256x28x28, against 227 KB of shared
// memory a block, so the iterate lives in device memory in PyTorch's [N, C,
// H, W] layout, and a step is two launches that
// lasso_tpu_torch/ops/fused_conv.py issues per sub-step:
//
//   K9a conv_decode_resid: r = conv_transpose2d(y, W) - x on the crop,
//       with the momentum point y = z + c (z - zp) (c the scalar momentum,
//       or the restart coefficient of the sample's t). r is [N, Cx, H, W]:
//         r[cx,i,j] = sum_{cz,ki,kj} W[cz,cx,ki,kj] y[cz, i+p-ki, j+p-kj] - x
//   K9b conv_adjoint_prox: g = conv2d(r, W) with padding p,
//         g[cz,a,b] = sum_{cx,ki,kj} W[cz,cx,ki,kj] r[cx, a+ki-p, b+kj-p],
//       then the epilogue forms y again, applies the prox (soft or
//       nonneg; a scalar threshold or a per-channel one), writes z+, and
//       adds block partials of sum|z+ - z| and, with restart, of each
//       sample's <y - z+, z+ - z>.
//
// The canvas idea carries over: a block stages a patch of its input in
// shared memory with pixels flattened at a pitch PW (a multiple of 8), so
// that moving the tap by one filter row moves the MMA's A operand by PW
// pixels, a constant offset in its descriptor. The filter columns go into
// the product's other dimensions, so no tap is a gather:
//
//   K9b: rows m = code pixels (a, b) of the tile, columns the code channels
//       (a tile of 64 or 128), contraction over (ki; cx, kj). The staged
//       patch holds, for each pixel, the 8-deep chunks of k = cx kw + kj,
//       value r[cx, row, col + kj]: each r element is written kw times,
//       and filter row ki reads the patch ki PW pixels on. Where Cx kw <
//       16 (one image channel, the headline) a row would fill less than a
//       16-deep slice, so the contraction takes all of (cx, ki, kj), W as
//       it lies, and the product is one stage.
//   K9a: rows m = (output row i, code column b) of the tile, columns u =
//       (cx, kj) (16, 64, 80 or 128 wide), contraction over (ki; cz):
//         D[(i, b), (cx, kj)] = sum_{ki, cz} y[cz, i+p-ki, b] W[cz,cx,ki,kj]
//       with y staged as its bf16 parts. Then the fold r[cx,i,j] = sum_kj
//       D[(i, j+p-kj), (cx, kj)] - x runs from shared memory, kw reads an
//       output. For kw <= n a tile holds whole channels; wider filters
//       split a channel's columns over tiles, and the fold carries the
//       partial sum in shared memory from one tile to the next.
//
// The direct product of output pixels by image channels is no option for
// K9a: at one image channel it is one column of an MMA at least 8 wide,
// and its A operand, the im2col of y, is Cz kh kw deep (3136 at 64 atoms
// 7x7): 1.6 GB of shared-memory reads a launch in bf16, three times that
// in 'f32', 0.05-0.16 ms at the card's shared-memory rate before any
// product. In the form above K9a's contraction is kh Cz deep (448).
//
// The loop: both operands lie in shared memory without swizzle (8 x
// 16-byte core matrices, 8-deep chunks of the contraction, one pixel or
// one B row 16 bytes a chunk), so a descriptor can start at any pixel.
// Stages run over (slab of the contraction, filter row or row group).
// W's parts, in the layouts of conv_operands (ops/fused_conv.py), are
// copied by cp.async up to 3 stages ahead, and the patch of the next slab
// (or of the next
// group of filter rows, where one serving all kh rows does not fit) is
// formed while the current stage's MMAs run. The patch is formed from
// device memory: K9a reads f32 z and zp and writes y's split, K9b reads r
// and writes its split; a thread issues the loads of 2 or 4 chunks (16
// or 32 values) before it uses any. Two warpgroups and no producer: the
// 256 threads issue the copies and form the patches, and each warpgroup
// issues the MMAs of its m tiles. Each kernel is built for the blocks an
// SM its registers allow (launch bounds) and sizes its stages to their
// share of shared memory (plan_stages).
//
// Precision: 'bf16' is one bf16 MMA a 16-deep slice with FP32 sums
// (bf16(y) or bf16(r) against bf16(W)); 'f32' is the TPU kernel's bf16x3
// split (fused_conv.py:259-262, 300-303): hi*hi, lo*hi and hi*lo into one
// FP32 accumulator, hi = bf16(v), lo = bf16(v - hi). A bf16 x bf16 product
// is exact in FP32. The elementwise arithmetic is one _rn intrinsic an
// operation (fista_math.cuh), as the plain versions round.
//
// delta and the restart sums are deterministic: every block writes its
// partial, and the last block to finish (a counter per sample for the
// restart sum, one for delta) adds the partials in index order; no float
// atomics. The counters are zero again when the kernel ends.
//
// What bounds them on this card, at 256 images of 1x32x32 and 64 atoms
// 7x7 (codes 64x26x26): K9a moves z, zp (44.3 MB each), x and r (1 MB
// each), 0.027 ms at 3.35 TB/s, and K9b r, z, zp and z+, 0.040 ms; each
// conv is 1.09 GFLOP, 0.0011 ms in bf16 at 989 TFLOP/s (three products in
// 'f32'). At 64 images of 16x32x32 and 256 atoms 5x5 each conv is 10.3
// GFLOP, 0.031 ms as three bf16 products, under K9a's 0.033 ms and K9b's
// 0.047 ms of bytes: bound by bytes in every row. The tiles move more:
// K9a forms y for the halo rows of its patch again (1.7x the code pixels
// at the headline) and K9b re-reads r kw times from L1, and each block
// pays its stage loop's latencies. Their times against these bounds, and
// where the rest goes (scripts/conv_kernel_parts.py), are in PERF.md.
//
// Each C entry launches on the given stream, allocates nothing and returns
// cudaGetLastError() (or the error of its launch configuration).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "fista_math.cuh"
#include "wgmma_product.cuh"

namespace {

constexpr int THREADS = 256;   // two warpgroups
constexpr int WARPS = THREADS / 32;
constexpr int NPAD = 256;      // B rows padded to this (fused_conv.py _NPAD)
constexpr size_t SMEM_MAX = 232448;
constexpr int FORM_ITEMS = 4;   // patch chunks a thread loads before storing
constexpr int MAX_NB = 4;       // the deepest B ring

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }


// The tiling of one launch, chosen on the host (plan_*) and passed by value.
struct Geo {
  int N, Cz, Cx, Hz, Wz, H, Wd, kh, kw, pad;
  int MB;       // rows of the block's product: 128 MT
  int PW;       // patch pitch, pixels a patch row (multiple of 8)
  int TOh;      // output rows of a tile (the product's used rows TOh PW)
  int TOw;      // output columns of a tile (K9b: PW)
  int tiles_w;  // tiles along a row
  int KC;       // contraction a filter row, multiple of 16
  int SK;       // contraction of a slab, multiple of 16
  int KHC;      // filter rows a staged patch serves
  int NPX;      // pixels of a staged patch: MB + (KHC - 1) PW
  int nA;       // patch buffers: 2 where the loop stages more than one
  int nB;       // B buffers (2 .. MAX_NB, at most the stages): stage t +
                // nB - 1 is copied during stage t
  int KB;       // filter rows a B stage holds: KHC (a row group) or 1
  int rows_b;   // rows of the B layout (NPAD multiple)
  int G;        // K9a: channels an n tile (0: kw > n, kjr columns a tile)
  int kjr;      // K9a: filter columns an n tile covers at most
  int n_tiles;  // K9a: n tiles
  int kh_f;     // K9b: filter rows folded into the contraction (1: none)
};

// bytes of the patch and B buffers of a plan with P parts and n width nt
__host__ __device__ inline size_t stage_bytes(const Geo& g, int P, int nt) {
  return (size_t)g.nA * P * (g.SK / 8) * g.NPX * 16 +
         (size_t)g.nB * P * g.KB * (g.SK / 8) * nt * 16;
}

// Picks the filter rows KHC a patch serves, the slab depth SK and the B
// ring: the most filter rows (a patch serving them all is formed from
// device memory once a slab), then the deepest slab, then B stages of a
// whole row group (one barrier a patch) before stages of one row, with
// the most B buffers (up to MAX_NB and the stages), whose buffers (with
// `extra`) fit `budget`: an SM's shared memory shared by the blocks the
// kernel's registers are fit for, else the card's 227 KB for one. Every
// shape has a plan: at SK = 16, KHC = 1 and two B buffers a block needs
// at most 80 KB of them.
template <typename Extra>
bool plan_stages(Geo& g, int P, int nt, int minb, bool whole_rows,
                 Extra extra, size_t& smem) {
  for (int pass = minb > 1 ? 0 : 1; pass < 2; ++pass) {
    const size_t budget = pass == 0 ? SMEM_MAX / minb - 1024 : SMEM_MAX;
    for (int khc = g.kh; khc >= 1; --khc)
      for (int sk = g.KC < 128 ? g.KC : 128; sk >= 16; sk -= 16)
        for (int kb = whole_rows ? khc : 1; kb >= 1; kb = kb > 1 ? 1 : 0)
          for (int nb = imin(MAX_NB, imax(2, cdiv(g.KC, sk) *
                                                 (kb > 1 ? cdiv(g.kh, khc)
                                                         : g.kh)));
               nb >= 2; --nb) {
            g.SK = sk;
            g.KHC = khc;
            g.KB = kb;
            g.nB = nb;
            g.NPX = g.MB + (khc - 1) * g.PW;
            g.nA = cdiv(g.KC, sk) * cdiv(g.kh, khc) > 1 ? 2 : 1;
            const size_t need = extra(stage_bytes(g, P, nt));
            if (need <= budget) {
              smem = need;
              return true;
            }
          }
  }
  return false;
}

// Sum of v over the block in a fixed order: warp shuffles, then the warp
// sums in warp order. Every thread gets the total; red must hold WARPS
// floats, and the call ends with the block synchronised.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();  // red may still be read by a previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) s += red[i];
  return s;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Writes 8 values of one pixel's chunk: bf16(v) at hi and, with SPLIT,
// bf16(v - bf16(v)) at lo, 16 bytes each (the first of a pair in the low
// half, one conversion instruction a pair).
template <bool SPLIT>
__device__ __forceinline__ void store_chunk(const float (&v)[8],
                                            unsigned char* hi,
                                            unsigned char* lo) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const __nv_bfloat162 hp = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
    h[e] = bits(hp);
    if (SPLIT) {
      const float2 hf = __bfloat1622float2(hp);
      l[e] = bits(__floats2bfloat162_rn(__fsub_rn(v[2 * e], hf.x),
                                        __fsub_rn(v[2 * e + 1], hf.y)));
    }
  }
  *reinterpret_cast<uint4*>(hi) = make_uint4(h[0], h[1], h[2], h[3]);
  if (SPLIT) *reinterpret_cast<uint4*>(lo) = make_uint4(l[0], l[1], l[2], l[3]);
}

// wait until at most n (0 .. MAX_NB - 2) of this thread's cp.async groups
// are in flight
__device__ __forceinline__ void wait_b(int n) {
  if (n >= 2) wgp::cp_async_wait<2>();
  else if (n == 1) wgp::cp_async_wait<1>();
  else wgp::cp_async_wait<0>();
}

// The block's product over all stages: acc[i] (zero on entry) += A B^T
// for m tile wg * MT + i. Stage t is (slab of SK, row group of KHC filter
// rows, and the group's rows when a B stage holds them all (KB > 1), else
// one row). The patch of (slab, row group) is formed by form(buf, slab,
// group, part, parts), the part-th of `parts` shares of its rounds, into
// a buffer of (SK / 8) chunks x NPX pixels x 16 bytes a part; stage t's B
// rows n0 .. n0 + NT - 1 are copied from `w` (layout [P, kh, KC / 8,
// rows_b, 8]). shift(ki, group) is filter row ki's offset into the patch
// in pixels. Every m tile issues its MMAs, rows past the tile's used ones
// included: a branch on the warpgroup there made the compiler serialise
// the MMAs (ptxas C7520), which cost K9a a sixth of its time.
template <bool SPLIT, int NT, int MT, typename Form, typename Shift>
__device__ __forceinline__ void conv_product(
    float (&acc)[MT][NT / 2], const Geo& g, const __nv_bfloat16* w, int n0,
    unsigned char* smem, Form form, Shift shift) {
  constexpr int P = SPLIT ? 2 : 1;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int SKc = g.SK / 8, nslab = cdiv(g.KC, g.SK);
  const int ngrp = cdiv(g.kh, g.KHC);
  const size_t a_part = (size_t)SKc * g.NPX * 16;
  const size_t b_part = (size_t)g.KB * SKc * NT * 16;
  unsigned char* abuf = smem;
  unsigned char* bbuf = smem + g.nA * P * a_part;
  const size_t w_plane = (size_t)g.kh * (g.KC / 8) * g.rows_b * 8;
  // stage t: slab s, row group grp, filter rows r0 .. r0 + nr - 1 (the
  // group's rows when a B stage holds them all, else one)
  const int per_slab = g.KB > 1 ? ngrp : g.kh;
  const int T = nslab * per_slab;
  struct Stage { int s, grp, r0, nr; };
  auto stage = [&](int t) {
    Stage st;
    st.s = t / per_slab;
    const int j = t % per_slab;
    if (g.KB > 1) {
      st.grp = j;
      st.r0 = j * g.KHC;
      st.nr = min(g.KHC, g.kh - st.r0);
    } else {
      st.grp = j / g.KHC;
      st.r0 = j;
      st.nr = 1;
    }
    return st;
  };

  auto load_b = [&](int t) {
    if (t >= T) return;
    const Stage st = stage(t);
    const int kc_n = (st.s + 1 < nslab ? g.SK : g.KC - st.s * g.SK) / 8;
    unsigned char* dst = bbuf + (t % g.nB) * P * b_part;
    for (int it = tid; it < st.nr * kc_n * NT; it += THREADS) {
      const int j = it / (kc_n * NT), rem = it - j * kc_n * NT;
      const int kc = rem / NT, row = rem - kc * NT;
      const bool in = n0 + row < g.rows_b;
      const size_t src =
          (((size_t)(st.r0 + j) * (g.KC / 8) + st.s * SKc + kc) * g.rows_b +
           (in ? n0 + row : 0)) * 8;
      const size_t d = ((size_t)(j * SKc + kc) * NT + row) * 16;
#pragma unroll
      for (int p = 0; p < P; ++p)
        wgp::cp_async16_fill(wgp::smem_addr(dst + p * b_part + d),
                             w + p * w_plane + src, in ? 16 : 0);
    }
  };

  // B(0) .. B(nB - 2) in flight, one cp.async group each
  for (int t = 0; t < g.nB - 1; ++t) {
    load_b(t);
    wgp::cp_async_commit();
  }
  form(abuf, 0, 0, 0, 1);
#pragma unroll
  for (int i = 0; i < MT; ++i) wgp::fence_acc(acc[i]);
  for (int t = 0; t < T; ++t) {
    // B(t) is in (at most nB - 2 younger groups in flight); the barrier
    // also orders every thread's patch stores and stage t - 1's MMAs
    wait_b(min(g.nB - 2, T - 1 - t));
    wgp::fence_proxy_async();
    __syncthreads();
    load_b(t + g.nB - 1);   // into stage t - 1's buffer
    wgp::cp_async_commit();
    const Stage st = stage(t);
    const int q = st.s * ngrp + st.grp;   // the patch this stage reads
    const int slices = (st.s + 1 < nslab ? g.SK : g.KC - st.s * g.SK) / 16;
    const uint32_t a0 = wgp::smem_addr(abuf + (q % g.nA) * P * a_part);
    const uint32_t b0 = wgp::smem_addr(bbuf + (t % g.nB) * P * b_part);
    wgp::mma_fence();
    for (int j = 0; j < st.nr; ++j) {
      const int sh = shift(st.r0 + j, st.grp);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int mt = wg * MT + i;
        for (int sl = 0; sl < slices; ++sl) {
          const uint32_t ao =
              ((uint32_t)(2 * sl) * g.NPX + mt * 64 + sh) * 16;
          const uint32_t bo = (uint32_t)(j * SKc + 2 * sl) * NT * 16;
          const uint64_t ah = wgp::desc_plain(a0 + ao, g.NPX * 16, 128);
          const uint64_t bh = wgp::desc_plain(b0 + bo, NT * 16, 128);
          wgp::mma_ss<NT>(acc[i], ah, bh);
          if (SPLIT) {
            const uint64_t al =
                wgp::desc_plain(a0 + a_part + ao, g.NPX * 16, 128);
            const uint64_t bl =
                wgp::desc_plain(b0 + b_part + bo, NT * 16, 128);
            wgp::mma_ss<NT>(acc[i], al, bh);
            wgp::mma_ss<NT>(acc[i], ah, bl);
          }
        }
      }
    }
    wgp::mma_commit();
    // a share of the next patch while this stage's MMAs run, one share a
    // stage of this patch (its buffer's last reader, two patches back,
    // finished before the barrier at this patch's first stage)
    if (q + 1 < nslab * ngrp) {
      const int nst = g.KB > 1 ? 1 : min(g.KHC, g.kh - st.grp * g.KHC);
      form(abuf + ((q + 1) % g.nA) * P * a_part, (q + 1) / ngrp,
           (q + 1) % ngrp, g.KB > 1 ? 0 : st.r0 - st.grp * g.KHC, nst);
    }
    wgp::mma_wait<0>();
#pragma unroll
    for (int i = 0; i < MT; ++i) wgp::fence_acc(acc[i]);
  }
  wgp::cp_async_wait<0>();
  __syncthreads();  // every warpgroup's MMAs are done with the buffers
}

// ---------------------------------------------------------------------
// K9a: r[N, Cx, H, W] = conv_transpose2d(y, W, padding p) - x; grid (N,
// row tiles x column tiles). The product D lands in shared memory as [MB]
// rows of NT + 1 floats over the stage buffers, then the fold.

template <bool SPLIT, int NT, int MT, int MINB>
__global__ void __launch_bounds__(THREADS, MINB)
    conv_decode_resid_kernel(const float* __restrict__ x,
                             const float* __restrict__ z,
                             const float* __restrict__ zp,
                             const __nv_bfloat16* __restrict__ wa,
                             const float* __restrict__ scal,
                             const float* __restrict__ t,
                             float* __restrict__ r, Geo g) {
  constexpr int P = SPLIT ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = blockIdx.x, tid = threadIdx.x;
  const int i0 = (blockIdx.y / g.tiles_w) * g.TOh;
  const int j0 = (blockIdx.y % g.tiles_w) * g.TOw;
  const float c = t == nullptr ? scal[2] : restart_coef(t[n]);
  const int used = g.TOh * g.PW;
  const size_t ab = stage_bytes(g, P, NT), dsm = (size_t)g.MB * (NT + 1) * 4;
  float* D = reinterpret_cast<float*>(smem);
  float* racc = reinterpret_cast<float*>(smem + (ab > dsm ? ab : dsm));
  const size_t zplane = (size_t)g.Hz * g.Wz;
  const float* zn = z + (size_t)n * g.Cz * zplane;
  const float* zpn = zp + (size_t)n * g.Cz * zplane;
  const int warp = (tid & 127) >> 5, lane = tid & 31, q = lane & 3;

  for (int nt = 0; nt < g.n_tiles; ++nt) {
    // the tile's columns u0 .. u0 + NT - 1: channels cx_a .. cx_b - 1,
    // filter columns kj0 .. kj1 - 1 of each
    int cx_a, cx_b, kj0, kj1;
    if (g.G > 0) {
      cx_a = nt * g.G;
      cx_b = min(g.Cx, cx_a + g.G);
      kj0 = 0;
      kj1 = g.kw;
    } else {
      const int per = cdiv(g.kw, NT);
      cx_a = nt / per;
      cx_b = cx_a + 1;
      kj0 = (nt % per) * NT;
      kj1 = min(g.kw, kj0 + NT);
    }
    const int u0 = cx_a * g.kw + kj0;
    // code columns cb_lo + col of the patch; the first row of a group's
    // patch serves filter row min(kh, (grp + 1) KHC) - 1
    const int cb_lo = max(0, j0 + g.pad - kj1 + 1);
    auto form = [&](unsigned char* buf, int s, int grp, int part,
                    int parts) {
      const int kend = min(g.kh, (grp + 1) * g.KHC);
      const int a_org = i0 + g.pad - kend + 1;
      const int kc_n = (s + 1 < cdiv(g.KC, g.SK) ? g.SK : g.KC - s * g.SK) / 8;
      const size_t lo_part = (size_t)(g.SK / 8) * g.NPX * 16;
      const int items = kc_n * g.NPX;
      // ITEMS chunks (pixel px of chunk kc for item kc NPX + px) a thread
      // a round, two where the accumulators hold 128 registers; all their
      // loads issued before any value is used
      constexpr int ITEMS = NT * MT / 2 >= 128 ? 2 : FORM_ITEMS;
      const int rounds = cdiv(items, ITEMS * THREADS);
      for (int rd = part; rd < rounds; rd += parts) {
        float zv[ITEMS][8], zpv[ITEMS][8];
#pragma unroll
        for (int u = 0; u < ITEMS; ++u) {
          const int it = (rd * ITEMS + u) * THREADS + tid;
          const int kc = it / g.NPX, px = it - kc * g.NPX;
          const int a = a_org + px / g.PW, b = cb_lo + px % g.PW;
          const int cz0 = s * g.SK + 8 * kc;
          const bool in = it < items && a >= 0 && a < g.Hz && b < g.Wz;
          const float* zo =
              zn + (in ? (size_t)cz0 * zplane + a * g.Wz + b : 0);
          const float* zpo = zpn + (zo - zn);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const bool ok = in && cz0 + e < g.Cz;
            zv[u][e] = ok ? zo[e * zplane] : 0.f;
            zpv[u][e] = ok ? zpo[e * zplane] : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < ITEMS; ++u) {
          const int it = (rd * ITEMS + u) * THREADS + tid;
          if (it >= items) break;
          const int kc = it / g.NPX, px = it - kc * g.NPX;
          float v[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[e] = momentum_point(zv[u][e], zpv[u][e], c);
          unsigned char* dst = buf + ((size_t)kc * g.NPX + px) * 16;
          store_chunk<SPLIT>(v, dst, dst + lo_part);
        }
      }
    };
    auto shift = [&](int ki, int grp) {
      return (min(g.kh, (grp + 1) * g.KHC) - 1 - ki) * g.PW;
    };
    float acc[MT][NT / 2];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int k = 0; k < NT / 2; ++k) acc[i][k] = 0.f;
    conv_product<SPLIT, NT, MT>(acc, g, wa, u0, smem, form, shift);

    // D's rows: the accumulator layout of m64nNk16, rows wg 64 MT + 64 i +
    // 16 warp + lane / 4 (+ 8), columns 8 j + 2 q + {0, 1}
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int mt = (tid >> 7) * MT + i;
      if (mt * 64 >= used) continue;
      const int m0 = mt * 64 + warp * 16 + (lane >> 2);
#pragma unroll
      for (int j = 0; j < NT / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* row = D + (size_t)(m0 + 8 * h) * (NT + 1) + 8 * j + 2 * q;
          row[0] = acc[i][4 * j + 2 * h];
          row[1] = acc[i][4 * j + 2 * h + 1];
        }
    }
    __syncthreads();

    // the fold, along rows (lane = column); a channel whose columns go on
    // in the next tile keeps its partial sum in racc
    const bool first = kj0 == 0, last = kj1 == g.kw;
    const int per_ch = g.TOh * g.TOw;
    for (int it = tid; it < (cx_b - cx_a) * per_ch; it += THREADS) {
      const int cx = cx_a + it / per_ch, rem = it % per_ch;
      const int ir = rem / g.TOw, jc = rem - ir * g.TOw;
      const int i = i0 + ir, j = j0 + jc;
      if (i >= g.H || j >= g.Wd) continue;
      float sum = first ? 0.f : racc[rem];
      const float* drow = D + (size_t)ir * g.PW * (NT + 1) + cx * g.kw - u0;
      for (int kj = kj0; kj < kj1; ++kj) {
        const int b = j + g.pad - kj;
        if (b >= cb_lo && b < g.Wz)
          sum = __fadd_rn(sum, drow[(size_t)(b - cb_lo) * (NT + 1) + kj]);
      }
      if (last) {
        const size_t off = (((size_t)n * g.Cx + cx) * g.H + i) * g.Wd + j;
        r[off] = __fsub_rn(sum, x[off]);
      } else {
        racc[rem] = sum;
      }
    }
    __syncthreads();  // D is read before the next tile's stages overwrite it
  }
}

// ---------------------------------------------------------------------
// K9b: g = conv2d(r, W, padding p), z_out = prox(y - lr g, th); grid (N,
// code-channel tiles of NT, row tiles x column tiles). Block partials of
// delta and of each sample's restart sum go to dpart and rpart, [N, bps]
// with bps = gridDim.y * gridDim.z blocks a sample.

template <bool SPLIT, int NT, int MT, int MINB>
__global__ void __launch_bounds__(THREADS, MINB)
    conv_adjoint_prox_kernel(const float* __restrict__ r, const float* z,
                             const float* zp,
                             const __nv_bfloat16* __restrict__ wb,
                             const float* __restrict__ scal,
                             const float* __restrict__ tcol, float* t,
                             float* rpart, float* dpart,
                             unsigned int* counters, float* z_out,
                             float* delta, Geo g, int nonneg) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[WARPS];
  __shared__ int last_sample, last_all;
  const int n = blockIdx.x, nz0 = blockIdx.y * NT, tid = threadIdx.x;
  const int a0 = (blockIdx.z / g.tiles_w) * g.TOh;
  const int b0 = (blockIdx.z % g.tiles_w) * g.PW;
  const bool restart = t != nullptr;
  // every block of the sample reads its t before the last one writes it
  // (the write follows the counter below)
  const float tv = restart ? t[n] : 0.f;
  const float c = restart ? restart_coef(tv) : scal[2];
  const int khw = g.kh_f * g.kw, used = g.TOh * g.PW, ck = g.Cx * khw;
  const float* rn = r + (size_t)n * g.Cx * g.H * g.Wd;

  // patch pixel px of row group grp: r row a0 - p + grp KHC + px / PW,
  // columns b0 - p + px % PW + kj for k = cx kw + kj
  auto form = [&](unsigned char* buf, int s, int grp, int part, int parts) {
    const int kc_n = (s + 1 < cdiv(g.KC, g.SK) ? g.SK : g.KC - s * g.SK) / 8;
    const size_t lo_part = (size_t)(g.SK / 8) * g.NPX * 16;
    const int items = kc_n * g.NPX;
    // ITEMS chunks (pixel px of chunk kc for item kc NPX + px) a thread a
    // round (two where three blocks share an SM's registers), all their
    // loads issued before any store
    constexpr int ITEMS = MINB > 2 ? 2 : FORM_ITEMS;
    const int rounds = cdiv(items, ITEMS * THREADS);
    for (int rd = part; rd < rounds; rd += parts) {
      float v[ITEMS][8];
#pragma unroll
      for (int u = 0; u < ITEMS; ++u) {
        const int it = (rd * ITEMS + u) * THREADS + tid;
        const int kc = it / g.NPX, px = it - kc * g.NPX;
        const int row = a0 - g.pad + grp * g.KHC + px / g.PW;
        const int col = b0 - g.pad + px % g.PW;
        const int k = s * g.SK + 8 * kc;
        const bool in = it < items;
        if (g.kh_f == 1) {   // k = cx kw + kj, all of one r row
          int cx = k / g.kw, kj = k - cx * g.kw;
          const bool in_row = in && row >= 0 && row < g.H;
          const float* rrow = rn + (size_t)(in_row ? row : 0) * g.Wd;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int cc = col + kj;
            v[u][e] = in_row && k + e < ck && cc >= 0 && cc < g.Wd
                          ? __ldg(rrow + (size_t)cx * g.H * g.Wd + cc)
                          : 0.f;
            if (++kj == g.kw) {
              kj = 0;
              ++cx;
            }
          }
        } else {   // folded: k = (cx kh_f + ki) kw + kj
          int cx = k / khw, ki = (k - cx * khw) / g.kw;
          int kj = k - cx * khw - ki * g.kw;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int rr = row + ki, cc = col + kj;
            v[u][e] = in && k + e < ck && rr >= 0 && rr < g.H && cc >= 0 &&
                              cc < g.Wd
                          ? __ldg(rn + ((size_t)cx * g.H + rr) * g.Wd + cc)
                          : 0.f;
            if (++kj == g.kw) {
              kj = 0;
              if (++ki == g.kh_f) {
                ki = 0;
                ++cx;
              }
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < ITEMS; ++u) {
        const int it = (rd * ITEMS + u) * THREADS + tid;
        if (it >= items) break;
        const int kc = it / g.NPX, px = it - kc * g.NPX;
        unsigned char* dst = buf + ((size_t)kc * g.NPX + px) * 16;
        store_chunk<SPLIT>(v[u], dst, dst + lo_part);
      }
    }
  };
  auto shift = [&](int ki, int grp) { return (ki - grp * g.KHC) * g.PW; };
  const size_t zplane = (size_t)g.Hz * g.Wz;
  const float* zs = z + (size_t)n * g.Cz * zplane;
  const float* zps = zp + (size_t)n * g.Cz * zplane;
  const int warp = (tid & 127) >> 5, lane = tid & 31, q = lane & 3;
  // The epilogue on the accumulator layout: this thread's rows m (two an
  // m tile), columns 8 j + 2 q + {0, 1}; a quad's loads and stores of one
  // channel cover 8 consecutive code columns, a whole 32-byte sector. z
  // and zp are loaded JB column groups at a time (two where three blocks
  // share an SM's registers), all loads of a batch before any use.
  constexpr int JB = MINB > 2 ? 2 : 4, EB = 4 * JB;
  const float lr = scal[0], th_s = scal[1];
  float* zo = z_out + (size_t)n * g.Cz * zplane;
  int pxs[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m =
          ((tid >> 7) * MT + i) * 64 + warp * 16 + (lane >> 2) + 8 * h;
      const int ar = m / g.PW, a = a0 + ar, b = b0 + m % g.PW;
      pxs[i][h] = ar < g.TOh && a < g.Hz && b < g.Wz ? a * g.Wz + b : -1;
    }
  // element u of a batch: row h = u / (2 JB), column group j0 + (u % (2
  // JB)) / 2, column of the pair u % 2
  auto col_of = [&](int j0, int u) {
    return nz0 + 8 * (j0 + (u % (2 * JB)) / 2) + 2 * q + (u & 1);
  };
  auto load = [&](int i, int j0, float (&zv)[EB], float (&zpv)[EB]) {
#pragma unroll
    for (int u = 0; u < EB; ++u) {
      const int px = pxs[i][u / (2 * JB)], cz = col_of(j0, u);
      const bool in = px >= 0 && cz < g.Cz;
      const int o = in ? cz * (int)zplane + px : 0;
      zv[u] = in ? zs[o] : 0.f;
      zpv[u] = in ? zps[o] : 0.f;
    }
  };
  float acc[MT][NT / 2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int k = 0; k < NT / 2; ++k) acc[i][k] = 0.f;
  conv_product<SPLIT, NT, MT>(acc, g, wb, nz0, smem, form, shift);

  float dsum = 0.f, rd = 0.f;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int mt = (tid >> 7) * MT + i;
    if (mt * 64 >= used) continue;
#pragma unroll
    for (int j0 = 0; j0 < NT / 8; j0 += JB) {
      float zv[EB], zpv[EB];
      load(i, j0, zv, zpv);
#pragma unroll
      for (int u = 0; u < EB; ++u) {
        const int h = u / (2 * JB), px = pxs[i][h], cz = col_of(j0, u);
        if (px < 0 || cz >= g.Cz) continue;
        const float th = tcol != nullptr ? tcol[cz] : th_s;
        const float y = momentum_point(zv[u], zpv[u], c);
        const float gv =
            acc[i][4 * (j0 + (u % (2 * JB)) / 2) + 2 * h + (u & 1)];
        const float v = __fsub_rn(y, __fmul_rn(lr, gv));
        float zn;
        if (nonneg) {
          zn = fmaxf(__fsub_rn(v, th), 0.f);
        } else {
          const float mg = __fsub_rn(fabsf(v), th);
          zn = mg > 0.f ? copysignf(mg, v) : 0.f;
        }
        zo[cz * (int)zplane + px] = zn;
        const float dz = __fsub_rn(zn, zv[u]);
        dsum = __fadd_rn(dsum, fabsf(dz));
        rd = __fadd_rn(rd, __fmul_rn(__fsub_rn(y, zn), dz));
      }
    }
  }

  if (!restart && delta == nullptr) return;
  const int bps = gridDim.y * gridDim.z;
  const int slot = n * bps + blockIdx.y * gridDim.z + blockIdx.z;
  if (restart) rd = block_sum(rd, red);
  if (delta != nullptr) dsum = block_sum(dsum, red);
  // thread 0 writes the partials, makes them visible, then counts the block
  if (tid == 0) {
    if (restart) rpart[slot] = rd;
    if (delta != nullptr) dpart[slot] = dsum;
    __threadfence();
    last_sample = restart && atomicAdd(&counters[n], 1u) == bps - 1;
    last_all = delta != nullptr &&
               atomicAdd(&counters[g.N], 1u) == (unsigned)(g.N * bps) - 1;
  }
  __syncthreads();
  if (last_sample && tid == 0) {
    float s = 0.f;
    for (int k = 0; k < bps; ++k) s += __ldcg(&rpart[n * bps + k]);
    t[n] = s > 0.f ? 1.f : t_next_of(tv);
    counters[n] = 0u;
  }
  if (last_all) {
    float s = 0.f;
    for (int k = tid; k < g.N * bps; k += THREADS) s += __ldcg(&dpart[k]);
    s = block_sum(s, red);
    if (tid == 0) {
      *delta = s;
      counters[g.N] = 0u;
    }
  }
}

// ---------------------------------------------------------------------
// Host side: plans and launches.

Geo base_geo(int N, int Cz, int Cx, int Hz, int Wz, int kh, int kw,
             int pad) {
  Geo g{};
  g.N = N;
  g.Cz = Cz;
  g.Cx = Cx;
  g.Hz = Hz;
  g.Wz = Wz;
  g.H = Hz + kh - 1 - 2 * pad;
  g.Wd = Wz + kw - 1 - 2 * pad;
  g.kh = kh;
  g.kw = kw;
  g.pad = pad;
  return g;
}

// Opt the kernel in to `smem` bytes of dynamic shared memory where that,
// with its static shared memory (K9b's reduction scratch), passes the
// 48 KB a launch gets without it.
template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  if (smem + 1024 > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// K9a's tile: TOw output columns (so that a patch row of TOw + kjr - 1
// code columns fits the MB rows), PW the code columns it needs rounded to
// 8, TOh output rows of PW product rows each, balanced over the image.
template <bool SPLIT, int NT, int MT, int MINB>
int launch_decode(const float* x, const float* z, const float* zp,
                  const __nv_bfloat16* w, const float* scal, const float* t,
                  float* r, Geo g, void* stream) {
  constexpr int P = SPLIT ? 2 : 1;
  g.MB = 128 * MT;
  g.G = g.kw <= NT ? NT / g.kw : 0;
  g.kjr = g.kw < NT ? g.kw : NT;
  g.n_tiles = g.G > 0 ? cdiv(g.Cx, g.G) : g.Cx * cdiv(g.kw, NT);
  g.TOw = imin(g.Wd, g.MB - g.kjr + 1);
  g.PW = round_up(imin(g.Wz, g.TOw + g.kjr - 1), 8);
  const int rows = g.MB / g.PW;
  g.TOh = cdiv(g.H, cdiv(g.H, rows));
  g.tiles_w = cdiv(g.Wd, g.TOw);
  g.KC = round_up(g.Cz, 16);
  g.rows_b = round_up(g.Cx * g.kw, NPAD);
  const size_t dsm = (size_t)g.MB * (NT + 1) * 4;
  const size_t racc = g.G > 0 ? 0 : (size_t)g.TOh * g.TOw * 4;
  size_t smem = 0;
  if (!plan_stages(g, P, NT, MINB, true,
                   [&](size_t ab) { return (ab > dsm ? ab : dsm) + racc; },
                   smem))
    return (int)cudaErrorInvalidValue;
  auto kernel = conv_decode_resid_kernel<SPLIT, NT, MT, MINB>;
  const int e = prepare(kernel, smem);
  if (e != 0) return e;
  const dim3 grid(g.N, cdiv(g.H, g.TOh) * g.tiles_w);
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(x, z, zp, w, scal, t,
                                                        r, g);
  return (int)cudaGetLastError();
}

// n 16 for up to 16 columns (cx, kj), 64 for up to 64, 80 for up to 80
// (16 channels of 5 columns), else 128; the
// last template argument is the blocks an SM the registers are fit for
template <bool SPLIT>
int decode(const float* x, const float* z, const float* zp, const void* w,
           const float* scal, const float* t, float* r, int N, int Cz,
           int Cx, int Hz, int Wz, int kh, int kw, int pad, void* stream) {
  const Geo g = base_geo(N, Cz, Cx, Hz, Wz, kh, kw, pad);
  const auto* wb = (const __nv_bfloat16*)w;
  const int cols = Cx * kw;
  if (cols <= 16)
    return launch_decode<SPLIT, 16, 4, 2>(x, z, zp, wb, scal, t, r, g, stream);
  if (cols <= 64)
    return launch_decode<SPLIT, 64, 2, 2>(x, z, zp, wb, scal, t, r, g, stream);
  if (cols <= 80)
    return launch_decode<SPLIT, 80, 2, 1>(x, z, zp, wb, scal, t, r, g, stream);
  return launch_decode<SPLIT, 128, 2, 1>(x, z, zp, wb, scal, t, r, g, stream);
}

// K9b's tile: PW code columns (up to MB), TOh code rows of them, balanced.
template <bool SPLIT, int NT, int MT, int MINB>
int launch_adjoint(const float* r, const float* z, const float* zp,
                   const __nv_bfloat16* w, const float* scal,
                   const float* tcol, float* t, float* rpart, float* dpart,
                   unsigned int* counters, float* z_out, float* delta, Geo g,
                   int nonneg, int parts, void* stream) {
  constexpr int P = SPLIT ? 2 : 1;
  g.MB = 128 * MT;
  g.PW = imin(round_up(g.Wz, 8), g.MB);
  g.TOw = g.PW;
  const int rows = g.MB / g.PW;
  g.TOh = cdiv(g.Hz, cdiv(g.Hz, rows));
  g.tiles_w = cdiv(g.Wz, g.PW);
  // Where one filter row's Cx kw would fill less than a 16-deep slice,
  // the contraction takes all of (cx, ki, kj) (W as it lies, [Cz, Cx kh
  // kw]) and the stage loop runs one "row": no slice is mostly padding,
  // and a block's product is one stage.
  g.kh_f = g.Cx * g.kw < 16 ? g.kh : 1;
  g.kh /= g.kh_f;
  g.KC = round_up(g.Cx * g.kh_f * g.kw, 16);
  g.rows_b = round_up(g.Cz, NPAD);
  size_t smem = 0;
  if (!plan_stages(g, P, NT, MINB, false, [](size_t ab) { return ab; },
                   smem))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(g.N, cdiv(g.Cz, NT), cdiv(g.Hz, g.TOh) * g.tiles_w);
  const bool partials = t != nullptr || delta != nullptr;
  if (partials && (size_t)g.N * grid.y * grid.z > (size_t)parts)
    return (int)cudaErrorInvalidValue;
  auto kernel = conv_adjoint_prox_kernel<SPLIT, NT, MT, MINB>;
  const int e = prepare(kernel, smem);
  if (e != 0) return e;
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      r, z, zp, w, scal, tcol, t, rpart, dpart, counters, z_out, delta, g,
      nonneg);
  return (int)cudaGetLastError();
}

// n 64 for up to 64 code channels, else tiles of 128; one m tile a
// warpgroup, so that three (n 64) or two (n 128, 'bf16') blocks share an
// SM. At n 128 in 'f32' a block takes the whole SM: its patch and B
// stages of W's two parts then hold a slab of all of (cx, kj) and the
// product is kh stages, where at half the shared memory it was three
// times as many with the patch formed three times (the skeleton of
// scripts/conv_kernel_parts.py: 0.108 against 0.064 ms in 'bf16').
template <bool SPLIT>
int adjoint(const float* r, const float* z, const float* zp, const void* w,
            const float* scal, const float* tcol, float* t, float* rpart,
            float* dpart, unsigned int* counters, float* z_out, float* delta,
            int N, int Cz, int Cx, int Hz, int Wz, int kh, int kw, int pad,
            int nonneg, int parts, void* stream) {
  const Geo g = base_geo(N, Cz, Cx, Hz, Wz, kh, kw, pad);
  const auto* wb = (const __nv_bfloat16*)w;
  if (Cz <= 64)
    return launch_adjoint<SPLIT, 64, 1, 3>(r, z, zp, wb, scal, tcol, t,
                                           rpart, dpart, counters, z_out,
                                           delta, g, nonneg, parts, stream);
  constexpr int MINB = SPLIT ? 1 : 2;
  return launch_adjoint<SPLIT, 128, 1, MINB>(r, z, zp, wb, scal, tcol, t,
                                             rpart, dpart, counters, z_out,
                                             delta, g, nonneg, parts,
                                             stream);
}

}  // namespace

// x, r: [N, Cx, H, W] with H = Hz + kh - 1 - 2 pad, W = Wz + kw - 1 - 2
// pad; z, zp: [N, Cz, Hz, Wz]; w: K9a's operand of conv_operands
// (ops/fused_conv.py), [P, kh, Cz16 / 8, (Cx kw)256, 8] bf16 with P = 2
// (hi, lo) for f32 and 1 for bf16; scal points at one [4] row (lr,
// threshold, momentum, 1); t ([N], the restart carry t_{k-1}) may be null.
extern "C" int conv_decode_resid_f32(const float* x, const float* z,
                                     const float* zp, const void* w,
                                     const float* scal, const float* t,
                                     float* r, int N, int Cz, int Cx, int Hz,
                                     int Wz, int kh, int kw, int pad,
                                     void* stream) {
  return decode<true>(x, z, zp, w, scal, t, r, N, Cz, Cx, Hz, Wz, kh, kw,
                      pad, stream);
}

extern "C" int conv_decode_resid_bf16(const float* x, const float* z,
                                      const float* zp, const void* w,
                                      const float* scal, const float* t,
                                      float* r, int N, int Cz, int Cx,
                                      int Hz, int Wz, int kh, int kw,
                                      int pad, void* stream) {
  return decode<false>(x, z, zp, w, scal, t, r, N, Cz, Cx, Hz, Wz, kh, kw,
                       pad, stream);
}

// w: K9b's operand of conv_operands, [P, kh, (Cx kw)16 / 8, Cz256, 8]
// bf16, or [P, 1, (Cx kh kw)16 / 8, Cz256, 8] where Cx kw < 16. tcol
// ([Cz], thresholds already * lr) may be null (then scal[1]). t ([N]) may
// be null; when given it is advanced (t = 1 where the sample's <y - z+,
// z+ - z> > 0, else t_next) and rpart is its scratch. delta ([1]) may be
// null; when given dpart is its scratch. rpart and dpart hold `parts`
// floats, at least the blocks of the launch (N ceil(Cz / 64) Hz ceil(Wz /
// 8) bounds them), or the launch is refused; counters ([N + 1], zero) is
// zero again when the kernel ends.
extern "C" int conv_adjoint_prox_f32(const float* r, const float* z,
                                     const float* zp, const void* w,
                                     const float* scal, const float* tcol,
                                     float* t, float* rpart, float* dpart,
                                     unsigned int* counters, float* z_out,
                                     float* delta, int N, int Cz, int Cx,
                                     int Hz, int Wz, int kh, int kw, int pad,
                                     int nonneg, int parts, void* stream) {
  return adjoint<true>(r, z, zp, w, scal, tcol, t, rpart, dpart, counters,
                       z_out, delta, N, Cz, Cx, Hz, Wz, kh, kw, pad, nonneg,
                       parts, stream);
}

extern "C" int conv_adjoint_prox_bf16(const float* r, const float* z,
                                      const float* zp, const void* w,
                                      const float* scal, const float* tcol,
                                      float* t, float* rpart, float* dpart,
                                      unsigned int* counters, float* z_out,
                                      float* delta, int N, int Cz, int Cx,
                                      int Hz, int Wz, int kh, int kw,
                                      int pad, int nonneg, int parts,
                                      void* stream) {
  return adjoint<false>(r, z, zp, w, scal, tcol, t, rpart, dpart, counters,
                        z_out, delta, N, Cz, Cx, Hz, Wz, kh, kw, pad, nonneg,
                        parts, stream);
}

extern "C" const char* conv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
