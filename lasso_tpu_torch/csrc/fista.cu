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
//                       momentum point y = z + c (z - zp) is formed while
//                       the A tile is loaded (c is the scalar momentum, or
//                       the per-row restart coefficient from t).
//   K2 fista_grad_prox: g = r W, contracting over D, with an epilogue that
//                       forms y again, applies the prox and the l2
//                       contraction, writes z+, and adds block partials of
//                       sum|z+ - z| and, with restart, of the per-row
//                       <y - z+, z+ - z>. The last block of a row tile then
//                       updates that tile's t (threadfence reduction), so
//                       the t-vector needs no third kernel.
//                       Given t but no rdot buffer, K2 reads t for the
//                       momentum and leaves it alone: the group-lasso path
//                       (lasso_tpu_torch/ops/fused_group.py) runs it so,
//                       with scale 1, to write v = soft(y - lr g, l1 lr),
//                       and csrc/group.cu then applies the group shrink and
//                       advances t.
//
// Both are SIMT FP32 tiled products (128x128 block tile, 8x8 outputs per
// thread, operands staged in shared memory; csrc/tile_product.cuh, which
// K2's product shares with csrc/omp.cu). In bf16 mode each operand is
// rounded with __float2bfloat16_rn on its way into shared memory and the
// sum stays FP32: a bf16 x bf16 product is exact in FP32, so this is
// exactly "bf16 operands, f32 accumulate" (fused_ista.py:93-96). The f32
// mode is FP32 FMA throughout; TF32 is never used.
//
// What bounds them on this card: at N=16384, D=512, K=2048 each product is
// 2NKD = 34.4 GFLOP. K1 moves about 0.34 GB and K2 about 0.44 GB, which is
// 0.10 and 0.13 ms at 3.35 TB/s, against 0.51 ms each at the 67 TFLOP/s of
// FP32 outside the tensor cores. So both are bound by FP32 operations;
// wgmma on the tensor cores (bf16, or a bf16x3 split for f32) is what
// would move them towards the byte bound.
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

#include "fista_math.cuh"
#include "tile_product.cuh"

namespace {

// Momentum coefficient of each row of the tile: the scalar scal[2], or the
// restart coefficient of the row's t when t is given.
__device__ __forceinline__ void load_coefs(float* coef, const float* scal,
                                           const float* t, int row0, int N) {
  const int tid = threadIdx.x;
  if (tid < BM) {
    const int n = row0 + tid;
    coef[tid] = t == nullptr ? scal[2] : (n < N ? restart_coef(t[n]) : 0.f);
  }
}

// K1: r[N, D] = y W^T - x with y = z + c (z - zp); grid (N/BM, D/BN).
template <bool BF16>
__global__ void __launch_bounds__(THREADS)
    fista_resid_kernel(const float* __restrict__ x,
                       const float* __restrict__ z,
                       const float* __restrict__ zp,
                       const float* __restrict__ w,
                       const float* __restrict__ scal,
                       const float* __restrict__ t, float* __restrict__ r,
                       int N, int D, int K) {
  __shared__ float As[BK][BM + PAD];
  __shared__ float Bs[BK][BN + PAD];
  __shared__ float coef[BM];
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  load_coefs(coef, scal, t, row0, N);
  __syncthreads();

  float acc[TM][TN] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int m = i / BK, kk = i % BK, n = row0 + m, k = k0 + kk;
      float v = 0.f;
      if (n < N && k < K) {
        const size_t o = (size_t)n * K + k;
        v = momentum_point(z[o], zp[o], coef[m]);
        if (BF16) v = round_bf16(v);
      }
      As[kk][m] = v;
    }
    for (int i = tid; i < BN * BK; i += THREADS) {
      const int j = i / BK, kk = i % BK, d = col0 + j, k = k0 + kk;
      float v = (d < D && k < K) ? w[(size_t)d * K + k] : 0.f;
      if (BF16) v = round_bf16(v);
      Bs[kk][j] = v;
    }
    __syncthreads();
    mac_stage(As, Bs, acc, ty, tx);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int n = row0 + ty + TY * i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int d = col0 + tx + TX * j;
      if (n < N && d < D) {
        const size_t o = (size_t)n * D + d;
        r[o] = __fsub_rn(acc[i][j], x[o]);
      }
    }
  }
}

// K2: g[N, K] = r W, then z_out = prox(y - lr g, th) * scale;
// grid (N/BM, K/BN). z_out may alias zp: each element of zp is read by
// the thread that then writes the same element of z_out.
template <bool BF16>
__global__ void __launch_bounds__(THREADS)
    fista_grad_prox_kernel(const float* __restrict__ r, const float* z,
                           const float* zp, const float* __restrict__ w,
                           const float* __restrict__ scal,
                           const float* __restrict__ trow, float* t,
                           float* rdot, unsigned int* counters, float* z_out,
                           float* delta, int N, int D, int K, int nonneg) {
  __shared__ float As[BK][BM + PAD];
  __shared__ float Bs[BK][BN + PAD];
  __shared__ float coef[BM];
  __shared__ float warp_sums[THREADS / 32];
  __shared__ int is_last;
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  load_coefs(coef, scal, t, row0, N);
  __syncthreads();

  float acc[TM][TN] = {};
  product_rw<BF16>(r, w, As, Bs, acc, row0, col0, N, D, K);

  const float lr = scal[0], th_s = scal[1], scale = scal[3];
  float dsum = 0.f;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = ty + TY * i, n = row0 + m;
    const float c = coef[m];
    float rd = 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int k = col0 + tx + TX * j;
      if (n < N && k < K) {
        const size_t o = (size_t)n * K + k;
        const float zv = z[o];
        const float y = momentum_point(zv, zp[o], c);
        const float u = __fsub_rn(y, __fmul_rn(lr, acc[i][j]));
        const float th = trow != nullptr ? trow[k] : th_s;
        float v;
        if (nonneg) {
          v = fmaxf(__fsub_rn(u, th), 0.f);
        } else {
          const float a = __fsub_rn(fabsf(u), th);
          v = a > 0.f ? copysignf(a, u) : 0.f;
        }
        const float zn = __fmul_rn(v, scale);
        z_out[o] = zn;
        const float dz = __fsub_rn(zn, zv);
        dsum += fabsf(dz);
        rd += __fmul_rn(__fsub_rn(y, zn), dz);
      }
    }
    if (rdot != nullptr) {
      // the TX threads of a row are 16 consecutive lanes of one warp
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        rd += __shfl_xor_sync(0xffffffffu, rd, off);
      if (tx == 0 && n < N) atomicAdd(&rdot[n], rd);
    }
  }

  if (delta != nullptr) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dsum += __shfl_xor_sync(0xffffffffu, dsum, off);
    if ((tid & 31) == 0) warp_sums[tid >> 5] = dsum;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int i = 0; i < THREADS / 32; ++i) s += warp_sums[i];
      atomicAdd(delta, s);
    }
  }

  if (rdot != nullptr) {
    // The last block to finish a row tile holds the whole-row rdot and
    // advances t: t = rdot > 0 ? 1 : t_next. Every other block of the tile
    // read t (in load_coefs) before it counted itself in.
    __threadfence();
    __syncthreads();
    if (tid == 0)
      is_last = atomicAdd(&counters[blockIdx.x], 1u) == gridDim.y - 1;
    __syncthreads();
    if (is_last) {
      if (tid < BM) {
        const int n = row0 + tid;
        if (n < N) {
          const float rdv = atomicExch(&rdot[n], 0.f);
          t[n] = rdv > 0.f ? 1.f : t_next_of(t[n]);
        }
      }
      if (tid == 0) counters[blockIdx.x] = 0u;
    }
  }
}

template <bool BF16>
int launch_resid(const float* x, const float* z, const float* zp,
                 const float* w, const float* scal, const float* t, float* r,
                 int N, int D, int K, void* stream) {
  const dim3 grid((N + BM - 1) / BM, (D + BN - 1) / BN);
  fista_resid_kernel<BF16><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      x, z, zp, w, scal, t, r, N, D, K);
  return (int)cudaGetLastError();
}

template <bool BF16>
int launch_grad_prox(const float* r, const float* z, const float* zp,
                     const float* w, const float* scal, const float* trow,
                     float* t, float* rdot, unsigned int* counters,
                     float* z_out, float* delta, int N, int D, int K,
                     int nonneg, void* stream) {
  if (delta != nullptr) {
    const cudaError_t e =
        cudaMemsetAsync(delta, 0, sizeof(float), (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((N + BM - 1) / BM, (K + BN - 1) / BN);
  fista_grad_prox_kernel<BF16><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      r, z, zp, w, scal, trow, t, rdot, counters, z_out, delta, N, D, K,
      nonneg);
  return (int)cudaGetLastError();
}

}  // namespace

// scal points at one [4] row: lr, threshold (alpha * lr, 0 with trow),
// momentum, 1 / (1 + l2 * lr). t ([N], the restart carry) may be null.
extern "C" int fista_resid_f32(const float* x, const float* z,
                               const float* zp, const float* w,
                               const float* scal, const float* t, float* r,
                               int N, int D, int K, void* stream) {
  return launch_resid<false>(x, z, zp, w, scal, t, r, N, D, K, stream);
}

extern "C" int fista_resid_bf16(const float* x, const float* z,
                                const float* zp, const float* w,
                                const float* scal, const float* t, float* r,
                                int N, int D, int K, void* stream) {
  return launch_resid<true>(x, z, zp, w, scal, t, r, N, D, K, stream);
}

// trow ([K], threshold row already * lr), t, rdot ([N], zero) and counters
// ([ceil(N/128)], zero) may be null; t is advanced only when rdot and
// counters are given, and only read for the momentum otherwise. delta ([1])
// is zeroed here and may be null when the caller does not need sum|z+ - z|.
extern "C" int fista_grad_prox_f32(const float* r, const float* z,
                                   const float* zp, const float* w,
                                   const float* scal, const float* trow,
                                   float* t, float* rdot,
                                   unsigned int* counters, float* z_out,
                                   float* delta, int N, int D, int K,
                                   int nonneg, void* stream) {
  return launch_grad_prox<false>(r, z, zp, w, scal, trow, t, rdot, counters,
                                 z_out, delta, N, D, K, nonneg, stream);
}

extern "C" int fista_grad_prox_bf16(const float* r, const float* z,
                                    const float* zp, const float* w,
                                    const float* scal, const float* trow,
                                    float* t, float* rdot,
                                    unsigned int* counters, float* z_out,
                                    float* delta, int N, int D, int K,
                                    int nonneg, void* stream) {
  return launch_grad_prox<true>(r, z, zp, w, scal, trow, t, rdot, counters,
                                z_out, delta, N, D, K, nonneg, stream);
}

extern "C" const char* fista_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
