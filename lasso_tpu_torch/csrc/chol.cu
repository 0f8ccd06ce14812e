// Append one row to a batch of inverse Cholesky factors and solve, as a
// hand-written kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel of the JAX package's ops/batched_cholesky.py:
//   cholesky_append_solve_lanes (_make_append_kernel, pallas_call at
//   batched_cholesky.py:290)
// which the incremental-Gram 'chol' route of OMP calls once per step. Each
// sample b carries V = L^-1 (lower triangular, identity beyond the appended
// block) in the layout [T, T, B], batch innermost. Given the new Gram row g
// and the right-hand side, with k the row being appended:
//
//   y    = V g[:k]                      (i < k)
//   u    = y^T V                        (j < k)
//   lkk  = sqrt(max(g_k - y.y, 1e-6 g_k + 1e-30))   (relative pivot floor)
//   V[k] = [-u, 1, 0 ...] / lkk
//   z    = V^T (V b)
//
// K7 chol_append_solve: lane l of every warp of a block owns sample
// blockIdx.x * 32 + l, so each load of V[i, j, :] is one coalesced 128-byte
// access for 32 samples; the 8 warps of the block split the rows (for y and
// t = V b) and the columns (for u and z) of the 32 samples between them,
// i = p, p + 8, ... for warp p. Every row or column is a register sum; y
// and then t pass between the warps through shared memory ([T][32] floats),
// and so does the new row k, which goes to V only at the end: the loads of
// V (rows below k) and its one store never touch the same element.
// Only the live block is read: V's lower triangle in rows 0..k (V is lower
// triangular and its rows past k are identity rows, which the appends from
// the identity keep so), g[0..k] and b[0..k]. Rows past k contribute
// z[j] = b[j], so a zero-padded slot solves to exactly 0. Only row k of V is
// written, in place (the JAX call aliases V in and out,
// batched_cholesky.py:318); a caller that wants a new factor copies V first.
//
// What bounds it at B=16384, T=64: the live lower triangle at step k is
// k(k+1)/2 floats a sample, 134 MB at k=63, and the whole of V 268 MB
// (0.08 ms at 3.35 TB/s); its 4 k^2 multiply-adds a sample are 0.3 GFLOP at
// k=63, 0.005 ms at 67 TFLOP/s. So it is bound by the bytes of the live
// triangle, which it reads twice per pass (once for the row sums, once for
// the column sums; the second read finds much of it in L2).
//
// Each C entry launches on the given stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int SB = 32;   // samples per block: one per lane
constexpr int PW = 8;    // warps per block, splitting rows and columns

__global__ void __launch_bounds__(SB * PW)
    chol_append_solve_kernel(float* __restrict__ v,
                             const float* __restrict__ g,
                             const float* __restrict__ b,
                             float* __restrict__ z, int k, int T, int B) {
  extern __shared__ float sh[];
  float* ys = sh;             // [T][SB]: y, then t
  float* rk = sh + T * SB;    // [T][SB]: the new row k
  float* red = rk + T * SB;   // [PW][SB]: partial y.y
  const int lane = threadIdx.x & 31, p = threadIdx.x >> 5;
  const int s = blockIdx.x * SB + lane;
  const bool live = s < B;
  const size_t rowT = (size_t)T * B;   // stride of one row of V
  const float* vs = v + s;             // rows below k: read only
  const float* gs = g + s;
  const float* bs = b + s;

  // y_i = sum_{j <= i} V[i, j] g_j for i < k
  float yy = 0.f;
  for (int i = p; i < k; i += PW) {
    float acc = 0.f;
    if (live)
      for (int j = 0; j <= i; ++j)
        acc = fmaf(vs[i * rowT + (size_t)j * B], gs[(size_t)j * B], acc);
    ys[i * SB + lane] = acc;
    yy = fmaf(acc, acc, yy);
  }
  red[p * SB + lane] = yy;
  __syncthreads();
  yy = 0.f;
  for (int w = 0; w < PW; ++w) yy += red[w * SB + lane];
  const float gkk = live ? gs[(size_t)k * B] : 1.f;
  const float pivot =
      fmaxf(__fsub_rn(gkk, yy), __fadd_rn(__fmul_rn(1e-6f, gkk), 1e-30f));
  const float inv = __frsqrt_rn(pivot);

  // row k into shared memory: -u_j / lkk with u_j = sum_{k > i >= j}
  // V[i, j] y_i, then 1 / lkk, then zeros
  for (int j = p; j < T; j += PW) {
    float val = j == k ? inv : 0.f;
    if (j < k) {
      float acc = 0.f;
      if (live)
        for (int i = j; i < k; ++i)
          acc = fmaf(vs[i * rowT + (size_t)j * B], ys[i * SB + lane], acc);
      val = __fmul_rn(-acc, inv);
    }
    rk[j * SB + lane] = val;
  }
  __syncthreads();   // row k and the reads of y are done block-wide

  // t_i = sum_{j <= i} V[i, j] b_j for i <= k (row k from shared memory)
  for (int i = p; i <= k; i += PW) {
    float acc = 0.f;
    if (live) {
      if (i < k)
        for (int j = 0; j <= i; ++j)
          acc = fmaf(vs[i * rowT + (size_t)j * B], bs[(size_t)j * B], acc);
      else
        for (int j = 0; j <= k; ++j)
          acc = fmaf(rk[j * SB + lane], bs[(size_t)j * B], acc);
    }
    ys[i * SB + lane] = acc;
  }
  __syncthreads();

  // z_j = sum_{k >= i >= j} V[i, j] t_i for j <= k; z_j = b_j past k
  for (int j = p; j < T; j += PW) {
    if (!live) continue;
    float val;
    if (j <= k) {
      val = 0.f;
      for (int i = j; i < k; ++i)
        val = fmaf(vs[i * rowT + (size_t)j * B], ys[i * SB + lane], val);
      val = fmaf(rk[j * SB + lane], ys[k * SB + lane], val);
    } else {
      val = bs[(size_t)j * B];
    }
    z[(size_t)j * B + s] = val;
  }

  // row k of V last, in place: nothing above reads it from V
  if (live)
    for (int j = p; j < T; j += PW)
      v[s + k * rowT + (size_t)j * B] = rk[j * SB + lane];
}

}  // namespace

// v [T, T, B], row k written in place; g, b, z [T, B]; 0 <= k < T.
extern "C" int chol_append_solve(float* v, const float* g, const float* b,
                                 float* z, int k, int T, int B,
                                 void* stream) {
  const size_t smem = (size_t)(2 * T + PW) * SB * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        chol_append_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  chol_append_solve_kernel<<<(B + SB - 1) / SB, SB * PW, smem,
                             (cudaStream_t)stream>>>(v, g, b, z, k, T, B);
  return (int)cudaGetLastError();
}

extern "C" const char* chol_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
