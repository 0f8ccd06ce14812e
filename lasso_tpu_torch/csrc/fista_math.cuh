// Elementwise FISTA arithmetic shared by csrc/fista.cu and csrc/group.cu.
//
// Every operation is one _rn intrinsic, so that the compiler contracts
// nothing into an FMA and each value rounds op by op as the plain PyTorch
// versions in lasso_tpu_torch/ops/ compute it.

#pragma once

#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// (1 + sqrt(1 + 4 t t)) / 2, the FISTA t-sequence
__device__ __forceinline__ float t_next_of(float t) {
  const float s = __fsqrt_rn(__fadd_rn(1.f, __fmul_rn(__fmul_rn(4.f, t), t)));
  return __fmul_rn(__fadd_rn(1.f, s), 0.5f);
}

// per-row restart momentum (t - 1) / t_next; t is the carry t_{k-1}
__device__ __forceinline__ float restart_coef(float t) {
  return __fdiv_rn(__fsub_rn(t, 1.f), t_next_of(t));
}

__device__ __forceinline__ float momentum_point(float z, float zp, float c) {
  return __fadd_rn(z, __fmul_rn(c, __fsub_rn(z, zp)));
}

}  // namespace
