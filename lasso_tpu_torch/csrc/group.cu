// The group-lasso prox of one FISTA step: a hand-written kernel for Hopper
// (sm_90a).
//
// Replaces the group shrink of the TPU kernel of the JAX package's
// ops/fused_group.py: fused_group_fista_multistep (_group_prox_mxu inside
// _make_group_multistep_kernel). On the TPU the per-group sums of squares
// and the scatter of the per-group scale back to coordinates are two
// one-hot [K, G_pad] matrix-unit products against a row tile resident in
// VMEM. On the H100 one f32 row of z is 8 KB at K=2048 and the [N, K]
// iterate (134 MB at N=16384) lives in device memory, so a group norm is a
// segment reduction over one row, and a step of the group path is three
// launches (lasso_tpu_torch/ops/fused_group.py):
//
//   K1 fista_resid      (csrc/fista.cu)  r = y W^T - x
//   K2 fista_grad_prox  (csrc/fista.cu)  v = soft(y - lr r W, l1 lr), with
//                                        the restart carry t read, not
//                                        advanced
//   K5 group_prox       (this file)      z+ = group shrink of v, t advanced,
//                                        delta = sum |z+ - z|
//
// K5 works on whole rows, one block per row, so no group is split across
// blocks. The groups are given as perm (the coordinates sorted stably by
// group id) and offsets ([G+1]): group g is perm[offsets[g] .. offsets[g+1]).
// The block stages the row of v in shared memory (4 K bytes), one thread
// per group sums v^2 over the group in perm order (a fixed order), forms
// the scale max(1 - th_g / ||v_g||, 0) (0 where ||v_g|| = 0) and scales the
// group's entries in place; then a coalesced pass writes z+ and, where
// asked, adds |z+ - z| and, with restart, (y - z+)(z+ - z) with y = z + c
// (z - zp) formed again from the row's t. The row's restart sum decides its
// t in the same block. delta is deterministic: block partials, then the
// last block to finish sums them in a fixed order (threadfence reduction).
//
// Precision: in bf16 mode each v^2 is rounded to bf16 before the f32 group
// sum and the group scale is rounded to bf16 before it multiplies v, as the
// TPU kernel's bf16 passes do (fused_group.py:73-78, 87-88). In f32 mode
// the sums are true FP32 (the TPU kernel splits v^2 and the scale into bf16
// hi + lo, about 2^-17 relative). Every operation is one _rn intrinsic.
//
// What bounds it at N=16384, K=2048: bytes. It reads v and z and writes z+
// (3 N K 4 B = 0.40 GB, 0.120 ms at 3.35 TB/s); with restart it also reads
// zp (0.160 ms). Its operations (about 6 per entry) are far below that.
//
// Each C entry launches on the given stream, allocates nothing and returns
// cudaGetLastError() (or the error of its launch configuration).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "fista_math.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

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

// Grid (N): block n owns row n. z_out may alias zp (each element of zp is
// read by the thread that then writes the same element of z_out), but with
// restart that made a launch 4x slower on the H100, so the wrapper passes
// another buffer. z is read only for delta or restart, zp only for
// restart.
template <bool BF16>
__global__ void __launch_bounds__(THREADS)
    group_prox_kernel(const float* __restrict__ v, const float* z,
                      const float* zp, float* t, const int* __restrict__ perm,
                      const int* __restrict__ offsets,
                      const float* __restrict__ thg, float* z_out,
                      float* partials, unsigned int* counter, float* delta,
                      int N, int K, int G) {
  extern __shared__ float sv[];  // the row of v, then z+
  __shared__ float red[WARPS];
  __shared__ int is_last;
  const int tid = threadIdx.x;
  const int n = blockIdx.x;
  const size_t row = (size_t)n * K;
  const bool restart = t != nullptr;

  for (int k = tid; k < K; k += THREADS) sv[k] = v[row + k];
  // every thread reads the row's t before thread 0 writes it (the writes
  // come after the barriers of block_sum)
  const float tv = restart ? t[n] : 0.f;
  const float c = restart ? restart_coef(tv) : 0.f;
  __syncthreads();

  for (int g = tid; g < G; g += THREADS) {
    const int lo = offsets[g], hi = offsets[g + 1];
    float s = 0.f;
    for (int j = lo; j < hi; ++j) {
      const float a = sv[perm[j]];
      float sq = __fmul_rn(a, a);
      if (BF16) sq = round_bf16(sq);
      s = __fadd_rn(s, sq);
    }
    float scale = 0.f;
    if (s > 0.f)
      scale = fmaxf(__fsub_rn(1.f, __fdiv_rn(thg[g], __fsqrt_rn(s))), 0.f);
    if (BF16) scale = round_bf16(scale);
    for (int j = lo; j < hi; ++j) {
      const int k = perm[j];
      sv[k] = __fmul_rn(sv[k], scale);
    }
  }
  __syncthreads();

  const bool need_z = restart || delta != nullptr;
  float dsum = 0.f, rd = 0.f;
  for (int k = tid; k < K; k += THREADS) {
    const float zn = sv[k];
    if (need_z) {
      const float zv = z[row + k];
      const float dz = __fsub_rn(zn, zv);
      dsum = __fadd_rn(dsum, fabsf(dz));
      if (restart) {
        const float y = momentum_point(zv, zp[row + k], c);
        rd = __fadd_rn(rd, __fmul_rn(__fsub_rn(y, zn), dz));
      }
    }
    z_out[row + k] = zn;
  }

  if (restart) {
    rd = block_sum(rd, red);
    if (tid == 0) t[n] = rd > 0.f ? 1.f : t_next_of(tv);
  }

  if (delta != nullptr) {
    dsum = block_sum(dsum, red);
    if (tid == 0) partials[n] = dsum;
    __threadfence();
    __syncthreads();
    if (tid == 0) is_last = atomicAdd(counter, 1u) == gridDim.x - 1;
    __syncthreads();
    if (is_last) {
      float s = 0.f;
      for (int i = tid; i < N; i += THREADS) s += __ldcg(&partials[i]);
      s = block_sum(s, red);
      if (tid == 0) {
        *delta = s;
        *counter = 0u;
      }
    }
  }
}

template <bool BF16>
int launch_group_prox(const float* v, const float* z, const float* zp,
                      float* t, const int* perm, const int* offsets,
                      const float* thg, float* z_out, float* partials,
                      unsigned int* counter, float* delta, int N, int K,
                      int G, void* stream) {
  const size_t smem = (size_t)K * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        group_prox_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  group_prox_kernel<BF16><<<N, THREADS, smem, (cudaStream_t)stream>>>(
      v, z, zp, t, perm, offsets, thg, z_out, partials, counter, delta, N, K,
      G);
  return (int)cudaGetLastError();
}

}  // namespace

// v, z, zp, z_out: [N, K]; t: [N] restart carry t_{k-1} (null: no restart;
// then zp is not read); perm: [K] int32, offsets: [G+1] int32 (offsets[0]
// = 0, offsets[G] = K); thg: [G] thresholds alpha * lr * w_g. delta ([1])
// may be null; when given, partials ([N]) and counter ([1], zero) are its
// scratch, and the counter is zero again when the kernel ends.
extern "C" int group_prox_f32(const float* v, const float* z, const float* zp,
                              float* t, const int* perm, const int* offsets,
                              const float* thg, float* z_out, float* partials,
                              unsigned int* counter, float* delta, int N,
                              int K, int G, void* stream) {
  return launch_group_prox<false>(v, z, zp, t, perm, offsets, thg, z_out,
                                  partials, counter, delta, N, K, G, stream);
}

extern "C" int group_prox_bf16(const float* v, const float* z,
                               const float* zp, float* t, const int* perm,
                               const int* offsets, const float* thg,
                               float* z_out, float* partials,
                               unsigned int* counter, float* delta, int N,
                               int K, int G, void* stream) {
  return launch_group_prox<true>(v, z, zp, t, perm, offsets, thg, z_out,
                                 partials, counter, delta, N, K, G, stream);
}

extern "C" const char* group_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
