// The SIMT FP32 tile product shared by csrc/fista.cu (K1, K2) and
// csrc/omp.cu (K6a omp_select).
//
// A block of THREADS threads computes one BM x BN tile of a product in
// registers: thread (ty, tx) owns rows ty + TY*i and columns tx + TX*j
// (i < TM, j < TN), so the TX threads of a row are 16 consecutive lanes of
// one warp. The operands pass through shared memory BK deep at a time. In
// bf16 mode each operand is rounded with __float2bfloat16_rn on its way
// into shared memory and the sum stays FP32: a bf16 x bf16 product is exact
// in FP32, so this is exactly "bf16 operands, f32 accumulate". TF32 is
// never used.

#pragma once

#include <cstddef>

#include "fista_math.cuh"

namespace {

constexpr int BM = 128;            // rows of the block tile (batch)
constexpr int BN = 128;            // columns of the block tile
constexpr int BK = 16;             // depth of one shared-memory stage
constexpr int TM = 8;              // rows per thread
constexpr int TN = 8;              // columns per thread
constexpr int TY = BM / TM;        // 16 thread rows
constexpr int TX = BN / TN;        // 16 thread columns
constexpr int THREADS = TX * TY;   // 256
constexpr int PAD = 4;             // spreads transposed stores over banks

// acc += As^T Bs over one stage; a warp reads consecutive shared-memory
// words.
__device__ __forceinline__ void mac_stage(float (*As)[BM + PAD],
                                          float (*Bs)[BN + PAD],
                                          float (&acc)[TM][TN], int ty,
                                          int tx) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    float a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + TY * i];
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + TX * j];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc += r[row0 : row0+BM, :] w[:, col0 : col0+BN] for r [N, D] and
// w [D, K], contracting over D (K2's gradient product and K6a's
// correlation product); rows and columns past the edge read as zero.
template <bool BF16>
__device__ __forceinline__ void product_rw(const float* __restrict__ r,
                                           const float* __restrict__ w,
                                           float (*As)[BM + PAD],
                                           float (*Bs)[BN + PAD],
                                           float (&acc)[TM][TN], int row0,
                                           int col0, int N, int D, int K) {
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  for (int d0 = 0; d0 < D; d0 += BK) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int m = i / BK, kk = i % BK, n = row0 + m, d = d0 + kk;
      float v = (n < N && d < D) ? r[(size_t)n * D + d] : 0.f;
      if (BF16) v = round_bf16(v);
      As[kk][m] = v;
    }
    for (int i = tid; i < BN * BK; i += THREADS) {
      const int kk = i / BN, j = i % BN, d = d0 + kk, k = col0 + j;
      float v = (d < D && k < K) ? w[(size_t)d * K + k] : 0.f;
      if (BF16) v = round_bf16(v);
      Bs[kk][j] = v;
    }
    __syncthreads();
    mac_stage(As, Bs, acc, ty, tx);
    __syncthreads();
  }
}

}  // namespace
