// The whole batched OMP solve as three hand-written kernels for Hopper
// (sm_90a).
//
// Replaces the TPU kernel of the JAX package's ops/fused_omp.py:
//   fused_omp_solve (_make_omp_kernel, pallas_call at fused_omp.py:308)
// which keeps one 128-sample tile's whole T-step solve in VMEM: the
// residual, the basis Q [T, D, 128] (16.8 MB at T=64, D=512), R and the
// selection mask, with no device-memory traffic per step. On the H100 a
// block has at most 227 KB of shared memory, one sample's Q is 128 KB at
// T=64, D=512, and the whole Q of N=16384 samples is 2.15 GB, so the state
// lives in device memory and the wrapper (lasso_tpu_torch/ops/fused_omp.py)
// runs T steps from the host, two launches a step on the current stream
// with no host sync, then one back-substitution:
//
//   K6a omp_select:  c = r W over a 128 x 128 tile (the tile product of K2,
//                    csrc/tile_product.cuh), then the epilogue
//                    score = sel ? -1 : |c| * invn and the first maximum of
//                    each row over the tile's 128 columns, written as one
//                    (value, index) partial per row and column tile. The
//                    grid is K2's, so every SM has blocks to run.
//   K6b omp_orth:    one warp per sample. It reduces the row's partials to
//                    the first-max atom k* (ties to the lower index, as
//                    jnp.argmax and torch.argmax), applies the rss freeze
//                    (rss = |r|^2 > tol, sklearn semantics), writes idx,
//                    valid and the selected mask, gathers w = W[:, k*] from
//                    W^T's contiguous row into shared memory, runs modified
//                    Gram-Schmidt against the k live rows of Q (a dependent
//                    chain of k length-D dot products, fused_omp.py:165-178),
//                    applies the relative pivot floor
//                    max(|w_perp|^2, 1e-12 |w|^2 + 1e-30), writes q_k,
//                    column k of R and d_k = q_k . r, and updates r. A frozen
//                    sample writes q_k = 0, R column e_k and d_k = 0
//                    (fused_omp.py:186-193).
//   K6c omp_backsub: one warp per sample, the column-oriented
//                    back-substitution R z = d once after step T.
//
// What bounds it at N=16384, D=512, K=2048, T=64 in f32: the selection
// products, 64 x 2NDK = 2.2 TFLOP, are 32.8 ms at the 67 TFLOP/s of FP32
// outside the tensor cores (0.513 ms a launch of K6a, K2's bound); the MGS
// reads of Q, sum_k k N D 4 B = 67.6 GB, are 20.2 ms at 3.35 TB/s. So
// the solve is bound by K6a's operations; K6b at step k is bound by its
// k N D 4 bytes of Q (about k x 0.010 ms). K6a is a SIMT FP32 product like
// K2, in f32 true FP32 and in bf16 with both operands rounded to bf16 and
// FP32 sums; wgmma is what would move it. K6b keeps the gathered atom in shared
// memory, lane-strided, so that Q is read once per step, coalesced, and its
// chain of dot products needs only warp shuffles.
//
// Each C entry launches on the given stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>

#include "tile_product.cuh"

namespace {

constexpr int OWARPS = 8;   // samples (one warp each) per K6b / K6c block

// Keep the better of two (score, atom) candidates: the larger score, or
// the lower atom on a tie, so that any order of combining gives the first
// maximum. A NaN score never wins.
__device__ __forceinline__ void better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// K6a: per row n and column tile b, the first maximum of
// score = sel ? -1 : |(r W)[n, k]| * invn[k] over the tile's columns;
// grid (N/BM, K/BN).
template <bool BF16>
__global__ void __launch_bounds__(THREADS)
    omp_select_kernel(const float* __restrict__ r,
                      const float* __restrict__ w,
                      const float* __restrict__ invn,
                      const unsigned char* __restrict__ sel,
                      float* __restrict__ pval, int* __restrict__ pidx,
                      int N, int D, int K) {
  __shared__ float As[BK][BM + PAD];
  __shared__ float Bs[BK][BN + PAD];
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int nK = gridDim.y;

  float acc[TM][TN] = {};
  product_rw<BF16>(r, w, As, Bs, acc, row0, col0, N, D, K);

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int n = row0 + ty + TY * i;
    float bv = -INFINITY;
    int bi = INT_MAX;
#pragma unroll
    for (int j = 0; j < TN; ++j) {   // columns ascend with j
      const int k = col0 + tx + TX * j;
      if (n < N && k < K) {
        const float s = sel[(size_t)n * K + k]
                            ? -1.f
                            : __fmul_rn(fabsf(acc[i][j]), invn[k]);
        better(bv, bi, s, k);
      }
    }
    // the TX threads of a row are 16 consecutive lanes of one warp
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      better(bv, bi, ov, oi);
    }
    if (tx == 0 && n < N) {
      pval[(size_t)n * nK + blockIdx.y] = bv;
      pidx[(size_t)n * nK + blockIdx.y] = bi;
    }
  }
}

// K6b: step k of one warp's sample. w holds the warp's [D] slice of
// shared memory; lane l owns the entries d = l + 32 m of every D-vector, so
// the MGS chain needs no synchronization beyond the warp's shuffles.
__global__ void __launch_bounds__(OWARPS * 32)
    omp_orth_kernel(const float* __restrict__ pval,
                    const int* __restrict__ pidx, int nK,
                    const float* __restrict__ wt, float* __restrict__ r,
                    float* __restrict__ q, float* __restrict__ R,
                    float* __restrict__ d, int* __restrict__ idx,
                    float* __restrict__ valid, float* __restrict__ active,
                    unsigned char* __restrict__ sel, float tol, int k, int N,
                    int D, int K, int T) {
  extern __shared__ float wsm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * OWARPS + warp;
  if (n >= N) return;   // the whole warp leaves together
  float* w = wsm + (size_t)warp * D;
  float* rn = r + (size_t)n * D;

  // the tol freeze on the squared residual
  float rss = 0.f;
  for (int e = lane; e < D; e += 32) rss = fmaf(rn[e], rn[e], rss);
  rss = warp_sum(rss);
  const bool act = active[n] > 0.f && rss > tol;

  // the first maximum over the row's column-tile partials
  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int b = lane; b < nK; b += 32)
    better(bv, bi, pval[(size_t)n * nK + b], pidx[(size_t)n * nK + b]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    better(bv, bi, ov, oi);
  }
  const int kstar = (bi >= 0 && bi < K) ? bi : 0;

  const size_t slot = (size_t)n * T + k;
  float* qk = q + slot * D;
  float* Rk = R + slot * T;   // column k of R
  if (lane == 0) {
    idx[slot] = act ? kstar : 0;
    valid[slot] = act ? 1.f : 0.f;
    active[n] = act ? 1.f : 0.f;
    if (act) sel[(size_t)n * K + kstar] = 1;
  }
  if (!act) {
    for (int e = lane; e < D; e += 32) qk[e] = 0.f;
    for (int t = lane; t <= k; t += 32) Rk[t] = t == k ? 1.f : 0.f;
    if (lane == 0) d[slot] = 0.f;
    return;
  }

  // gather the atom, then modified Gram-Schmidt against q_0 .. q_{k-1}
  const float* wrow = wt + (size_t)kstar * D;
  float w0n = 0.f;
  for (int e = lane; e < D; e += 32) {
    const float v = wrow[e];
    w[e] = v;
    w0n = fmaf(v, v, w0n);
  }
  w0n = warp_sum(w0n);
  for (int t = 0; t < k; ++t) {
    const float* qt = q + ((size_t)n * T + t) * D;
    float cf = 0.f;
    for (int e = lane; e < D; e += 32) cf = fmaf(qt[e], w[e], cf);
    cf = warp_sum(cf);
    for (int e = lane; e < D; e += 32)
      w[e] = __fsub_rn(w[e], __fmul_rn(cf, qt[e]));
    if (lane == 0) Rk[t] = cf;
  }
  float nrm2 = 0.f;
  for (int e = lane; e < D; e += 32) nrm2 = fmaf(w[e], w[e], nrm2);
  nrm2 = warp_sum(nrm2);
  const float pivot =
      fmaxf(nrm2, __fadd_rn(__fmul_rn(1e-12f, w0n), 1e-30f));
  const float inv = __frsqrt_rn(pivot);

  // q_k, d_k = q_k . r and r -= d_k q_k
  float dk = 0.f;
  for (int e = lane; e < D; e += 32) {
    const float v = __fmul_rn(w[e], inv);
    qk[e] = v;
    w[e] = v;
    dk = fmaf(v, rn[e], dk);
  }
  dk = warp_sum(dk);
  for (int e = lane; e < D; e += 32)
    rn[e] = __fsub_rn(rn[e], __fmul_rn(dk, w[e]));
  if (lane == 0) {
    Rk[k] = __fsqrt_rn(pivot);
    d[slot] = dk;
  }
}

// K6c: R z = d by columns, j = T-1 .. 0; rhs is the warp's [T] slice of
// shared memory. A frozen slot has R column e_j and d_j = 0, so it solves
// to exactly 0.
__global__ void __launch_bounds__(OWARPS * 32)
    omp_backsub_kernel(const float* __restrict__ R,
                       const float* __restrict__ d,
                       const float* __restrict__ valid,
                       float* __restrict__ z, int N, int T) {
  extern __shared__ float rsm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * OWARPS + warp;
  if (n >= N) return;
  float* rhs = rsm + (size_t)warp * T;
  for (int t = lane; t < T; t += 32) rhs[t] = d[(size_t)n * T + t];
  __syncwarp();
  for (int j = T - 1; j >= 0; --j) {
    const float* col = R + ((size_t)n * T + j) * T;
    const float zj = __fdiv_rn(rhs[j], col[j]);
    for (int i = lane; i < j; i += 32)
      rhs[i] = __fsub_rn(rhs[i], __fmul_rn(zj, col[i]));
    if (lane == 0)
      z[(size_t)n * T + j] = valid[(size_t)n * T + j] > 0.f ? zj : 0.f;
    __syncwarp();
  }
}

template <bool BF16>
int launch_select(const float* r, const float* w, const float* invn,
                  const unsigned char* sel, float* pval, int* pidx, int N,
                  int D, int K, void* stream) {
  const dim3 grid((N + BM - 1) / BM, (K + BN - 1) / BN);
  omp_select_kernel<BF16><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      r, w, invn, sel, pval, pidx, N, D, K);
  return (int)cudaGetLastError();
}

// dynamic shared memory above 48 KB needs the kernel's opt-in
template <typename Kernel>
int smem_opt_in(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// r [N, D], w [D, K], invn [K], sel [N, K] (0/1 bytes); writes the
// partials pval, pidx [N, ceil(K / 128)].
extern "C" int omp_select_f32(const float* r, const float* w,
                              const float* invn, const unsigned char* sel,
                              float* pval, int* pidx, int N, int D, int K,
                              void* stream) {
  return launch_select<false>(r, w, invn, sel, pval, pidx, N, D, K, stream);
}

extern "C" int omp_select_bf16(const float* r, const float* w,
                               const float* invn, const unsigned char* sel,
                               float* pval, int* pidx, int N, int D, int K,
                               void* stream) {
  return launch_select<true>(r, w, invn, sel, pval, pidx, N, D, K, stream);
}

// Step k: wt = W^T [K, D]; r [N, D], q [N, T, D], R [N, T, T] (column j of
// sample n at R[n, j, :]), d, valid [N, T] float, idx [N, T] int32,
// active [N] float 0/1, sel [N, K] bytes, all updated in place.
extern "C" int omp_orth(const float* pval, const int* pidx, int nK,
                        const float* wt, float* r, float* q, float* R,
                        float* d, int* idx, float* valid, float* active,
                        unsigned char* sel, float tol, int k, int N, int D,
                        int K, int T, void* stream) {
  const size_t smem = (size_t)OWARPS * D * sizeof(float);
  const int e = smem_opt_in(omp_orth_kernel, smem);
  if (e != 0) return e;
  omp_orth_kernel<<<(N + OWARPS - 1) / OWARPS, OWARPS * 32, smem,
                    (cudaStream_t)stream>>>(pval, pidx, nK, wt, r, q, R, d,
                                            idx, valid, active, sel, tol, k,
                                            N, D, K, T);
  return (int)cudaGetLastError();
}

// z [N, T] = R^-1 d per sample, zero where valid is 0.
extern "C" int omp_backsub(const float* R, const float* d, const float* valid,
                           float* z, int N, int T, void* stream) {
  const size_t smem = (size_t)OWARPS * T * sizeof(float);
  const int e = smem_opt_in(omp_backsub_kernel, smem);
  if (e != 0) return e;
  omp_backsub_kernel<<<(N + OWARPS - 1) / OWARPS, OWARPS * 32, smem,
                       (cudaStream_t)stream>>>(R, d, valid, z, N, T);
  return (int)cudaGetLastError();
}

extern "C" const char* omp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
