// One convolutional FISTA step as two hand-written kernels for Hopper
// (sm_90a).
//
// Replaces the TPU kernel of the JAX package's ops/fused_conv.py:
// fused_conv_fista_multistep (_make_conv_kernel). On the TPU the S steps'
// iterates stay in VMEM in a "canvas" layout (channels on sublanes, pixels
// on lanes) and each conv is one matrix-unit product plus lane rotates.
// On the H100 one sample's f32 codes are 173 KB at 64x26x26 and 803 KB at
// 256x28x28, against 227 KB of shared memory a block, so the iterate lives
// in device memory in PyTorch's [N, C, H, W] layout, and a step is two
// launches that lasso_tpu_torch/ops/fused_conv.py issues per sub-step:
//
//   K9a conv_decode_resid: r = conv_transpose2d(y, W) - x on the crop,
//       with the momentum point y = z + c (z - zp) formed while the y
//       patch is staged (c is the scalar momentum, or the restart
//       coefficient of the sample's t). r is [N, Cx, H, W]:
//         r[cx,i,j] = sum_{cz,ki,kj} W[cz,cx,ki,kj] y[cz, i+p-ki, j+p-kj] - x
//   K9b conv_adjoint_prox: g = conv2d(r, W) with padding p,
//         g[cz,a,b] = sum_{cx,ki,kj} W[cz,cx,ki,kj] r[cx, a+ki-p, b+kj-p],
//       then the epilogue forms y again, applies the prox (soft or
//       nonneg; a scalar threshold or a per-channel one), writes z+, and
//       adds block partials of sum|z+ - z| and, with restart, of each
//       sample's <y - z+, z+ - z>. Out-of-range taps read zeros.
//
// Both are SIMT FP32 direct convolutions over a 32x32 output tile a block.
// A thread owns 8 consecutive columns of one row for CXT output channels
// (K9a: 4, or 1 for a single-channel image) or CZT = 8 code channels
// (K9b). The input patch of the tile plus its halo, (32 + kh - 1) x (32 +
// kw - 1), is staged in shared memory a few channels at a time with an
// odd row pitch, so the 32 lanes of a warp read 32 banks; a warp stages 8
// rows at a time with all its loads issued before the first store. The
// weights of those channels are staged beside it. For kw = 3, 5 and 7 the
// filter width is a template argument: a thread loads its row segment (8
// + kw - 1 values) into registers once per (channel, ki) and reuses each
// value for every tap that touches it; other widths run the same loops
// with a runtime width. There is no TPU tap order here: W is read as [Cz,
// Cx, kh, kw]. K9a's block is 2 or 4 groups of 128 threads that split the
// code channels and add their sums at the end, so that enough warps wait
// on the staging loads together. K9b's sums go through shared memory to an
// epilogue that runs along rows (lane = column) with 8 elements a thread
// in flight, so that its z, z_prev and z+ traffic is coalesced.
//
// Precision: 'f32' is FP32 FMA throughout (the TPU kernel splits into
// bf16 hi + lo). 'bf16' rounds y and W (K9a) and r and W (K9b) with
// __float2bfloat16_rn as they are staged and sums in FP32: a bf16 x bf16
// product is exact in FP32, so this is "bf16 operands, f32 accumulate"
// (fused_conv.py:263-264, 304-305). The epilogue's arithmetic is one _rn
// intrinsic an operation (fista_math.cuh), as the plain versions round.
//
// delta and the restart sums are deterministic: every block writes its
// partial, and the last block to finish (a counter per sample for the
// restart sum, one for delta) adds the partials in index order; no float
// atomics. The counters are zero again when the kernel ends.
//
// What bounds them on this card, at 256 images of 1x32x32 and 64 atoms
// 7x7 (codes 64x26x26): each conv is 2 N Cz Cx Hz Wz kh kw = 1.09 GFLOP,
// 0.016 ms at 67 TFLOP/s of FP32; K9a moves z, zp (44.3 MB each), x and r
// (1 MB each), 0.027 ms at 3.35 TB/s, and K9b r, z, zp and z+, 0.040 ms:
// both are bound by bytes there. At 64 images of 16x32x32 and 256 atoms
// 5x5 each conv is 10.3 GFLOP, 0.154 ms in FP32: bound by operations.
// Their times against these bounds, and where the rest goes
// (scripts/conv_kernel_parts.py), are in PERF.md.
//
// Each C entry launches on the given stream, allocates nothing and returns
// cudaGetLastError() (or the error of its launch configuration).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "fista_math.cuh"

namespace {

constexpr int TH = 32;             // rows of a block's output tile
constexpr int TW = 32;             // columns of a block's output tile
constexpr int PX = 8;              // consecutive columns a thread owns
constexpr int TPR = TW / PX;       // threads a tile row
constexpr int THREADS = TH * TPR;  // 128
constexpr int WARPS = THREADS / 32;
constexpr int CZT = 8;             // code channels of a K9b block
constexpr int RU = 8;              // patch rows a warp stages at a time
constexpr int EU = 8;              // K9b epilogue elements a thread batches
constexpr int CHUNK = 4;           // input channels staged at a time
constexpr size_t SMEM_STATIC = 48 * 1024;
constexpr size_t SMEM_MAX = 232448;

// Channel groups of a K9a block: four for a single-channel image (one
// output channel a thread leaves few threads otherwise), two for four.
__host__ __device__ constexpr int groups(int cxt) {
  return cxt == 1 ? 4 : 2;
}

// Row pitch of a staged patch: odd, so that rows r and r + 1 start in
// different banks and the 8 rows a warp covers spread over all 32.
__host__ __device__ __forceinline__ int pitch(int cols) { return cols | 1; }

// Shared bytes of a block: a patch of `chunk` channels and the weights of
// `chunk` x `ct` channel pairs.
size_t smem_bytes(int chunk, int ct, int kh, int kw) {
  return sizeof(float) *
         ((size_t)chunk * (TH + kh - 1) * pitch(TW + kw - 1) +
          (size_t)chunk * ct * kh * kw);
}

// The most channels a stage that fits: CHUNK, halved until the block fits
// in 48 KB, or 0 when even one channel does not fit the card's 227 KB.
int pick_chunk(int channels, int ct, int kh, int kw) {
  int chunk = channels < CHUNK ? channels : CHUNK;
  while (chunk > 1 && smem_bytes(chunk, ct, kh, kw) > SMEM_STATIC)
    chunk /= 2;
  return smem_bytes(chunk, ct, kh, kw) <= SMEM_MAX ? chunk : 0;
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

// Stage `rows` rows of a patch into dst (row pitch SC): row `row` is stage
// channel row / SR at source row a0 + row % SR, columns b0 .. b0 + SC - 1,
// zero outside [0, Hs) x [0, Ws); load(channel, a, b) gives an in-range
// element. A warp takes RU consecutive rows at a time and a lane one
// column of each of two 32-column slots, and every thread issues its 2 RU
// loads before it stores any, so that the stage is not one load latency a
// row.
template <int NT, typename Load>
__device__ __forceinline__ void stage_patch(float* dst, int rows, int SR,
                                            int SC, int a0, int b0, int Hs,
                                            int Ws, Load load) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int q0 = 0; q0 < SC; q0 += 64) {  // two 32-column slots a batch
    for (int row0 = warp * RU; row0 < rows; row0 += (NT / 32) * RU) {
      float v[RU][2];
#pragma unroll
      for (int u = 0; u < RU; ++u) {
        const int row = row0 + u, ch = row / SR, a = a0 + row - ch * SR;
        const bool in_a = row < rows && a >= 0 && a < Hs;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = q0 + 32 * h + lane, b = b0 + q;
          v[u][h] = (in_a && q < SC && b >= 0 && b < Ws) ? load(ch, a, b)
                                                          : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < RU; ++u)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = q0 + 32 * h + lane;
          if (row0 + u < rows && q < SC) dst[(row0 + u) * SC + q] = v[u][h];
        }
    }
  }
}

// acc[o][p] += sum_kj wr[o * taps + kj] * seg[p + off(kj)] for one input
// row segment: K9a reads seg[p + kw - 1 - kj] (a transpose conv), K9b
// seg[p + kj] (a correlation). With KW > 0 the segment is held in
// registers and every loop is unrolled.
template <int OUT, int KW, bool FLIP>
__device__ __forceinline__ void row_taps(float (&acc)[OUT][PX],
                                         const float* seg_s,
                                         const float* wr, int taps,
                                         int kw_rt) {
  if constexpr (KW > 0) {
    float seg[PX + KW - 1];
#pragma unroll
    for (int q = 0; q < PX + KW - 1; ++q) seg[q] = seg_s[q];
#pragma unroll
    for (int o = 0; o < OUT; ++o) {
#pragma unroll
      for (int kj = 0; kj < KW; ++kj) {
        const float wv = wr[o * taps + kj];
#pragma unroll
        for (int p = 0; p < PX; ++p)
          acc[o][p] = fmaf(wv, seg[FLIP ? p + KW - 1 - kj : p + kj],
                           acc[o][p]);
      }
    }
  } else {
    for (int kj = 0; kj < kw_rt; ++kj) {
#pragma unroll
      for (int o = 0; o < OUT; ++o) {
        const float wv = wr[o * taps + kj];
#pragma unroll
        for (int p = 0; p < PX; ++p)
          acc[o][p] = fmaf(wv, seg_s[FLIP ? p + kw_rt - 1 - kj : p + kj],
                           acc[o][p]);
      }
    }
  }
}

// K9a: r[N, Cx, H, W] = conv_transpose2d(y, W, padding p) - x; grid
// (N, ceil(Cx / CXT), tiles of the image), tiles_w tiles a tile row. The
// block's KS groups of 128 threads split the code channels of each stage
// (group g takes channels g, g + KS, ...), and group 0 adds the other
// groups' sums in group order at the end.
template <bool BF16, int CXT, int KW, int KS = groups(CXT)>
__global__ void __launch_bounds__(THREADS * KS)
    conv_decode_resid_kernel(const float* __restrict__ x,
                             const float* __restrict__ z,
                             const float* __restrict__ zp,
                             const float* __restrict__ w,
                             const float* __restrict__ scal,
                             const float* __restrict__ t,
                             float* __restrict__ r, int Cz, int Cx, int Hz,
                             int Wz, int kh, int kw_rt, int pad, int chunk,
                             int tiles_w) {
  const int kw = KW > 0 ? KW : kw_rt;
  extern __shared__ float smem[];
  const int H = Hz + kh - 1 - 2 * pad, Wd = Wz + kw - 1 - 2 * pad;
  const int SR = TH + kh - 1, SC = pitch(TW + kw - 1), taps = kh * kw;
  float* ys = smem;                    // [chunk][SR][SC] y patch
  float* ws = smem + chunk * SR * SC;  // [chunk][CXT][kh][kw]
  const int n = blockIdx.x, cx0 = blockIdx.y * CXT;
  const int i0 = (blockIdx.z / tiles_w) * TH, j0 = (blockIdx.z % tiles_w) * TW;
  // output (i, j) and tap (ki, kj) read y[i + p - ki][j + p - kj]; patch
  // row s holds y row a0 + s, patch column q y column b0 + q
  const int a0 = i0 + pad - kh + 1, b0 = j0 + pad - kw + 1;
  const int tid = threadIdx.x, g = tid / THREADS, lt = tid % THREADS;
  const int ty = lt / TPR, tx = lt % TPR;
  const float c = t == nullptr ? scal[2] : restart_coef(t[n]);

  float acc[CXT][PX];
#pragma unroll
  for (int o = 0; o < CXT; ++o)
#pragma unroll
    for (int p = 0; p < PX; ++p) acc[o][p] = 0.f;

  for (int cz0 = 0; cz0 < Cz; cz0 += chunk) {
    const int nc = min(chunk, Cz - cz0);
    __syncthreads();  // the previous stage is read
    stage_patch<THREADS * KS>(
        ys, nc * SR, SR, SC, a0, b0, Hz, Wz, [&](int ch, int a, int b) {
          const size_t o = (((size_t)n * Cz + cz0 + ch) * Hz + a) * Wz + b;
          const float v = momentum_point(z[o], zp[o], c);
          return BF16 ? round_bf16(v) : v;
        });
    for (int e = tid; e < nc * CXT * taps; e += THREADS * KS) {
      const int cc = e / (CXT * taps), rem = e - cc * CXT * taps;
      const int o = rem / taps, tap = rem - o * taps;
      float v = 0.f;
      if (cx0 + o < Cx) {
        v = w[((size_t)(cz0 + cc) * Cx + cx0 + o) * taps + tap];
        if (BF16) v = round_bf16(v);
      }
      ws[e] = v;
    }
    __syncthreads();
    for (int cc = g; cc < nc; cc += KS)
      for (int ki = 0; ki < kh; ++ki)
        row_taps<CXT, KW, true>(
            acc, ys + (cc * SR + ty + kh - 1 - ki) * SC + tx * PX,
            ws + cc * CXT * taps + ki * kw, taps, kw);
  }

  // the groups' sums, thread-fastest so that a warp's stores hit 32 banks
  __syncthreads();
  float* part = smem;  // [KS - 1][CXT][PX][THREADS]
  if (g > 0) {
#pragma unroll
    for (int o = 0; o < CXT; ++o)
#pragma unroll
      for (int p = 0; p < PX; ++p)
        part[(((g - 1) * CXT + o) * PX + p) * THREADS + lt] = acc[o][p];
  }
  __syncthreads();
  if (g > 0) return;
  for (int h = 1; h < KS; ++h)
#pragma unroll
    for (int o = 0; o < CXT; ++o)
#pragma unroll
      for (int p = 0; p < PX; ++p)
        acc[o][p] += part[(((h - 1) * CXT + o) * PX + p) * THREADS + lt];

  const int i = i0 + ty;
  if (i >= H) return;
#pragma unroll
  for (int o = 0; o < CXT; ++o) {
    if (cx0 + o >= Cx) continue;
#pragma unroll
    for (int p = 0; p < PX; ++p) {
      const int j = j0 + tx * PX + p;
      if (j < Wd) {
        const size_t off = (((size_t)n * Cx + cx0 + o) * H + i) * Wd + j;
        r[off] = __fsub_rn(acc[o][p], x[off]);
      }
    }
  }
}

// K9b: g = conv2d(r, W, padding p), z_out = prox(y - lr g, th); grid
// (N, ceil(Cz / CZT), tiles of the code plane). Block partials of delta
// and of each sample's restart sum go to dpart and rpart, [N, bps] with
// bps = gridDim.y * gridDim.z blocks a sample.
template <bool BF16, int KW>
__global__ void __launch_bounds__(THREADS)
    conv_adjoint_prox_kernel(const float* __restrict__ r, const float* z,
                             const float* zp, const float* __restrict__ w,
                             const float* __restrict__ scal,
                             const float* __restrict__ tcol, float* t,
                             float* rpart, float* dpart,
                             unsigned int* counters, float* z_out,
                             float* delta, int N, int Cz, int Cx, int Hz,
                             int Wz, int kh, int kw_rt, int pad, int nonneg,
                             int chunk, int tiles_w) {
  const int kw = KW > 0 ? KW : kw_rt;
  extern __shared__ float smem[];
  __shared__ float red[WARPS];
  __shared__ int last_sample, last_all;
  const int H = Hz + kh - 1 - 2 * pad, Wd = Wz + kw - 1 - 2 * pad;
  const int SR = TH + kh - 1, SC = pitch(TW + kw - 1), taps = kh * kw;
  float* rs = smem;                    // [chunk][SR][SC] r patch
  float* ws = smem + chunk * SR * SC;  // [chunk][CZT][kh][kw]
  const int n = blockIdx.x, cz0 = blockIdx.y * CZT;
  const int i0 = (blockIdx.z / tiles_w) * TH, j0 = (blockIdx.z % tiles_w) * TW;
  // output (a, b) and tap (ki, kj) read r[a + ki - p][b + kj - p]
  const int a0 = i0 - pad, b0 = j0 - pad;
  const int tid = threadIdx.x, ty = tid / TPR, tx = tid % TPR;
  const bool restart = t != nullptr;
  // every block of the sample reads its t before the last one writes it
  // (the write follows the counter below)
  const float tv = restart ? t[n] : 0.f;
  const float c = restart ? restart_coef(tv) : scal[2];

  float acc[CZT][PX];
#pragma unroll
  for (int o = 0; o < CZT; ++o)
#pragma unroll
    for (int p = 0; p < PX; ++p) acc[o][p] = 0.f;

  for (int cx0 = 0; cx0 < Cx; cx0 += chunk) {
    const int nc = min(chunk, Cx - cx0);
    __syncthreads();
    stage_patch<THREADS>(
        rs, nc * SR, SR, SC, a0, b0, H, Wd, [&](int ch, int a, int b) {
          const float v = r[(((size_t)n * Cx + cx0 + ch) * H + a) * Wd + b];
          return BF16 ? round_bf16(v) : v;
        });
    for (int e = tid; e < nc * CZT * taps; e += THREADS) {
      const int cc = e / (CZT * taps), rem = e - cc * CZT * taps;
      const int o = rem / taps, tap = rem - o * taps;
      float v = 0.f;
      if (cz0 + o < Cz) {
        v = w[((size_t)(cz0 + o) * Cx + cx0 + cc) * taps + tap];
        if (BF16) v = round_bf16(v);
      }
      ws[e] = v;
    }
    __syncthreads();
    for (int cc = 0; cc < nc; ++cc)
      for (int ki = 0; ki < kh; ++ki)
        row_taps<CZT, KW, false>(acc,
                                 rs + (cc * SR + ty + ki) * SC + tx * PX,
                                 ws + cc * CZT * taps + ki * kw, taps, kw);
  }

  // The tile's sums go through shared memory so that the epilogue reads
  // and writes along rows (lane = column): with a thread's own 8 columns
  // every warp-wide load or store would touch 32 sectors, 8 times over.
  // The row pitch TW + 1 spreads the stores of the 8 rows a warp covers.
  __syncthreads();  // the last stage is read
  float* gs = smem;  // [CZT][TH][TW + 1]
#pragma unroll
  for (int o = 0; o < CZT; ++o)
#pragma unroll
    for (int p = 0; p < PX; ++p)
      gs[(o * TH + ty) * (TW + 1) + tx * PX + p] = acc[o][p];
  __syncthreads();

  // EU elements a thread at a time, their loads issued before any is used
  const float lr = scal[0], th_s = scal[1];
  float dsum = 0.f, rd = 0.f;
  for (int e0 = tid; e0 < CZT * TH * TW; e0 += THREADS * EU) {
    float zv[EU], zpv[EU];
    size_t off[EU];
#pragma unroll
    for (int u = 0; u < EU; ++u) {
      const int e = e0 + u * THREADS;
      const int cz = cz0 + e / (TH * TW), a = i0 + (e / TW) % TH,
                b = j0 + e % TW;
      const bool in = cz < Cz && a < Hz && b < Wz;
      off[u] = in ? (((size_t)n * Cz + cz) * Hz + a) * Wz + b : ~(size_t)0;
      zv[u] = in ? z[off[u]] : 0.f;
      zpv[u] = in ? zp[off[u]] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < EU; ++u) {
      if (off[u] == ~(size_t)0) continue;
      const int e = e0 + u * THREADS, o = e / (TH * TW);
      const float th = tcol != nullptr ? tcol[cz0 + o] : th_s;
      const float y = momentum_point(zv[u], zpv[u], c);
      const float g = gs[(o * TH + (e / TW) % TH) * (TW + 1) + e % TW];
      const float v = __fsub_rn(y, __fmul_rn(lr, g));
      float zn;
      if (nonneg) {
        zn = fmaxf(__fsub_rn(v, th), 0.f);
      } else {
        const float m = __fsub_rn(fabsf(v), th);
        zn = m > 0.f ? copysignf(m, v) : 0.f;
      }
      z_out[off[u]] = zn;
      const float dz = __fsub_rn(zn, zv[u]);
      dsum = __fadd_rn(dsum, fabsf(dz));
      rd = __fadd_rn(rd, __fmul_rn(__fsub_rn(y, zn), dz));
    }
  }

  if (!restart && delta == nullptr) return;
  const int bps = gridDim.y * gridDim.z;
  const int slot = n * bps + blockIdx.y * gridDim.z + blockIdx.z;
  if (restart) {
    rd = block_sum(rd, red);
    if (tid == 0) rpart[slot] = rd;
  }
  if (delta != nullptr) {
    dsum = block_sum(dsum, red);
    if (tid == 0) dpart[slot] = dsum;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last_sample = restart && atomicAdd(&counters[n], 1u) == bps - 1;
    last_all = delta != nullptr &&
               atomicAdd(&counters[N], 1u) == (unsigned)(N * bps) - 1;
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
    for (int k = tid; k < N * bps; k += THREADS) s += __ldcg(&dpart[k]);
    s = block_sum(s, red);
    if (tid == 0) {
      *delta = s;
      counters[N] = 0u;
    }
  }
}

int tiles(int extent) { return (extent + TH - 1) / TH; }

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  if (smem > SMEM_STATIC) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

template <bool BF16, int CXT, int KW>
int launch_decode(const float* x, const float* z, const float* zp,
                  const float* w, const float* scal, const float* t,
                  float* r, int N, int Cz, int Cx, int Hz, int Wz, int kh,
                  int kw, int pad, void* stream) {
  const int chunk = pick_chunk(Cz, CXT, kh, kw);
  if (chunk == 0) return (int)cudaErrorInvalidValue;
  constexpr int KS = groups(CXT);
  const size_t sums = sizeof(float) * (KS - 1) * CXT * PX * THREADS;
  const size_t stage = smem_bytes(chunk, CXT, kh, kw);
  const size_t smem = stage > sums ? stage : sums;
  auto kernel = conv_decode_resid_kernel<BF16, CXT, KW>;
  const int e = prepare(kernel, smem);
  if (e != 0) return e;
  const int H = Hz + kh - 1 - 2 * pad, Wd = Wz + kw - 1 - 2 * pad;
  const dim3 grid(N, (Cx + CXT - 1) / CXT, tiles(H) * tiles(Wd));
  kernel<<<grid, THREADS * KS, smem, (cudaStream_t)stream>>>(
      x, z, zp, w, scal, t, r, Cz, Cx, Hz, Wz, kh, kw, pad, chunk,
      tiles(Wd));
  return (int)cudaGetLastError();
}

template <bool BF16, int CXT>
int decode_by_width(const float* x, const float* z, const float* zp,
                    const float* w, const float* scal, const float* t,
                    float* r, int N, int Cz, int Cx, int Hz, int Wz, int kh,
                    int kw, int pad, void* stream) {
  switch (kw) {
    case 3:
      return launch_decode<BF16, CXT, 3>(x, z, zp, w, scal, t, r, N, Cz, Cx,
                                         Hz, Wz, kh, kw, pad, stream);
    case 5:
      return launch_decode<BF16, CXT, 5>(x, z, zp, w, scal, t, r, N, Cz, Cx,
                                         Hz, Wz, kh, kw, pad, stream);
    case 7:
      return launch_decode<BF16, CXT, 7>(x, z, zp, w, scal, t, r, N, Cz, Cx,
                                         Hz, Wz, kh, kw, pad, stream);
    default:
      return launch_decode<BF16, CXT, 0>(x, z, zp, w, scal, t, r, N, Cz, Cx,
                                         Hz, Wz, kh, kw, pad, stream);
  }
}

// Four output channels a thread where the image has them; one otherwise,
// so that a single-channel image wastes no FMAs on absent channels.
template <bool BF16>
int decode(const float* x, const float* z, const float* zp, const float* w,
           const float* scal, const float* t, float* r, int N, int Cz,
           int Cx, int Hz, int Wz, int kh, int kw, int pad, void* stream) {
  if (Cx >= 4)
    return decode_by_width<BF16, 4>(x, z, zp, w, scal, t, r, N, Cz, Cx, Hz,
                                    Wz, kh, kw, pad, stream);
  return decode_by_width<BF16, 1>(x, z, zp, w, scal, t, r, N, Cz, Cx, Hz,
                                  Wz, kh, kw, pad, stream);
}

template <bool BF16, int KW>
int launch_adjoint(const float* r, const float* z, const float* zp,
                   const float* w, const float* scal, const float* tcol,
                   float* t, float* rpart, float* dpart,
                   unsigned int* counters, float* z_out, float* delta, int N,
                   int Cz, int Cx, int Hz, int Wz, int kh, int kw, int pad,
                   int nonneg, int parts, void* stream) {
  const int chunk = pick_chunk(Cx, CZT, kh, kw);
  const dim3 grid(N, (Cz + CZT - 1) / CZT, tiles(Hz) * tiles(Wz));
  const bool partials = t != nullptr || delta != nullptr;
  if (chunk == 0 || (partials && (size_t)N * grid.y * grid.z > (size_t)parts))
    return (int)cudaErrorInvalidValue;
  const size_t sums = sizeof(float) * CZT * TH * (TW + 1);
  const size_t stage = smem_bytes(chunk, CZT, kh, kw);
  const size_t smem = stage > sums ? stage : sums;
  auto kernel = conv_adjoint_prox_kernel<BF16, KW>;
  const int e = prepare(kernel, smem);
  if (e != 0) return e;
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      r, z, zp, w, scal, tcol, t, rpart, dpart, counters, z_out, delta, N,
      Cz, Cx, Hz, Wz, kh, kw, pad, nonneg, chunk, tiles(Wz));
  return (int)cudaGetLastError();
}

template <bool BF16>
int adjoint(const float* r, const float* z, const float* zp, const float* w,
            const float* scal, const float* tcol, float* t, float* rpart,
            float* dpart, unsigned int* counters, float* z_out, float* delta,
            int N, int Cz, int Cx, int Hz, int Wz, int kh, int kw, int pad,
            int nonneg, int parts, void* stream) {
  switch (kw) {
    case 3:
      return launch_adjoint<BF16, 3>(r, z, zp, w, scal, tcol, t, rpart,
                                     dpart, counters, z_out, delta, N, Cz,
                                     Cx, Hz, Wz, kh, kw, pad, nonneg, parts,
                                     stream);
    case 5:
      return launch_adjoint<BF16, 5>(r, z, zp, w, scal, tcol, t, rpart,
                                     dpart, counters, z_out, delta, N, Cz,
                                     Cx, Hz, Wz, kh, kw, pad, nonneg, parts,
                                     stream);
    case 7:
      return launch_adjoint<BF16, 7>(r, z, zp, w, scal, tcol, t, rpart,
                                     dpart, counters, z_out, delta, N, Cz,
                                     Cx, Hz, Wz, kh, kw, pad, nonneg, parts,
                                     stream);
    default:
      return launch_adjoint<BF16, 0>(r, z, zp, w, scal, tcol, t, rpart,
                                     dpart, counters, z_out, delta, N, Cz,
                                     Cx, Hz, Wz, kh, kw, pad, nonneg, parts,
                                     stream);
  }
}

}  // namespace

// x, r: [N, Cx, H, W] with H = Hz + kh - 1 - 2 pad, W = Wz + kw - 1 - 2
// pad; z, zp: [N, Cz, Hz, Wz]; w: [Cz, Cx, kh, kw]; scal points at one [4]
// row (lr, threshold, momentum, 1); t ([N], the restart carry t_{k-1})
// may be null.
extern "C" int conv_decode_resid_f32(const float* x, const float* z,
                                     const float* zp, const float* w,
                                     const float* scal, const float* t,
                                     float* r, int N, int Cz, int Cx, int Hz,
                                     int Wz, int kh, int kw, int pad,
                                     void* stream) {
  return decode<false>(x, z, zp, w, scal, t, r, N, Cz, Cx, Hz, Wz, kh, kw,
                       pad, stream);
}

extern "C" int conv_decode_resid_bf16(const float* x, const float* z,
                                      const float* zp, const float* w,
                                      const float* scal, const float* t,
                                      float* r, int N, int Cz, int Cx,
                                      int Hz, int Wz, int kh, int kw,
                                      int pad, void* stream) {
  return decode<true>(x, z, zp, w, scal, t, r, N, Cz, Cx, Hz, Wz, kh, kw,
                      pad, stream);
}

// tcol ([Cz], thresholds already * lr) may be null (then scal[1]). t ([N])
// may be null; when given it is advanced (t = 1 where the sample's <y - z+,
// z+ - z> > 0, else t_next) and rpart is its scratch. delta ([1]) may be
// null; when given dpart is its scratch. rpart and dpart hold `parts`
// floats, at least N * ceil(Cz / 8) * ceil(Hz / 32) * ceil(Wz / 32) (the
// blocks of the launch), or the launch is refused; counters ([N + 1],
// zero) is zero again when the kernel ends.
extern "C" int conv_adjoint_prox_f32(const float* r, const float* z,
                                     const float* zp, const float* w,
                                     const float* scal, const float* tcol,
                                     float* t, float* rpart, float* dpart,
                                     unsigned int* counters, float* z_out,
                                     float* delta, int N, int Cz, int Cx,
                                     int Hz, int Wz, int kh, int kw, int pad,
                                     int nonneg, int parts, void* stream) {
  return adjoint<false>(r, z, zp, w, scal, tcol, t, rpart, dpart, counters,
                        z_out, delta, N, Cz, Cx, Hz, Wz, kh, kw, pad, nonneg,
                        parts, stream);
}

extern "C" int conv_adjoint_prox_bf16(const float* r, const float* z,
                                      const float* zp, const float* w,
                                      const float* scal, const float* tcol,
                                      float* t, float* rpart, float* dpart,
                                      unsigned int* counters, float* z_out,
                                      float* delta, int N, int Cz, int Cx,
                                      int Hz, int Wz, int kh, int kw,
                                      int pad, int nonneg, int parts,
                                      void* stream) {
  return adjoint<true>(r, z, zp, w, scal, tcol, t, rpart, dpart, counters,
                       z_out, delta, N, Cz, Cx, Hz, Wz, kh, kw, pad, nonneg,
                       parts, stream);
}

extern "C" const char* conv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
