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
// K3 cd_steps: `steps` greedy CD steps per launch. Each warp keeps its b and
// z rows in shared memory (2 K floats; 16 KB at K=2048) for all steps; lane
// l owns the columns l, l+32, ..., so no lane ever reads another lane's
// entries and the warp needs no barrier. A step computes prox(b)*scale - z,
// takes the first index of the largest |.| by a warp shuffle reduction (ties
// to the smaller index, NaN counted as largest, as torch.argmax and
// jnp.argmax do), reads row k of S with a plain coalesced load (S is 16 MB
// at K=2048 and stays in the 50 MB L2), and updates b, z_k and the active
// flag. A row that goes inactive is frozen, so the warp stops early. b, z
// and the flag are read and written once per launch.
//   What bounds it: the bytes of b and z in and out, 4 N K 4 B (0.54 GB,
//   0.16 ms at 3.35 TB/s at 16384 x 2048); the S rows come from L2.
//
// K4 cd_mod_sweep: one cyclic sweep over the K atoms. Each warp keeps its
// residual row R in registers (D/32 per lane; in the output buffer when
// D > 1024). The block stages TJ atoms of W^T [K, D] at a time in shared
// memory, so that its 8 rows share one read of each atom from L2; the lane
// l < TJ holds z[n, j0 + l] of the chunk. Per atom j: rho = R.w_j (warp
// shuffle reduction) + add ||w_j||^2, z_j = shrink(rho, alpha) /
// (||w_j||^2 + l2), R += (add - sub) w_j, with zmax and dzmax, in the fused
// form of the JAX kernel (no add-back residual is formed). Columns with
// ||w_j||^2 = 0 and rows that have converged are left as they are.
//   What bounds it: about 6 N K D operations in FP32 (103 GFLOP at 16384 x
//   512 x 2048, 1.54 ms at 67 TFLOP/s); the bytes (z and R in and out, W)
//   are 0.3 GB.
//
// Rounding: the updates b += upd S[k, :], R += c w_j and rho = dot +
// add ||w_j||^2 are single-rounding FMAs (__fmaf_rn), which is how the JAX
// package's arithmetic compiles on the CPU and what torch.addcmul computes
// in the plain versions; every other operation is one _rn intrinsic, so
// the compiler contracts nothing else. K3 then matches its plain version
// bit for bit, K4 up to the order of its dot-product sums.
//
// Each C entry launches on the given stream, allocates nothing and returns
// cudaGetLastError() (or the error of its launch configuration).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int STEP_ROWS = 4;      // K3: warps (rows) per block
constexpr int SWEEP_ROWS = 8;     // K4: warps (rows) per block
constexpr int MAX_TJ = 32;        // K4: atoms staged per chunk

__device__ __forceinline__ float load_s(const float* s, size_t i) {
  return s[i];
}

__device__ __forceinline__ float load_s(const __nv_bfloat16* s, size_t i) {
  return __bfloat162float(s[i]);
}

// (a, ia) is a better argmax candidate than (b, ib): NaN first, then the
// larger value, then the smaller index
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  const bool na = a != a, nb = b != b;
  if (na != nb) return na;
  if (!na && a != b) return a > b;
  return ia < ib;
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
  if (act == 0.f) {  // frozen on entry: copy through
    for (int j = lane; j < K; j += 32) {
      b_out[row + j] = b_in[row + j];
      z_out[row + j] = z_in[row + j];
    }
    if (lane == 0) act_out[n] = act;
    return;
  }
  float* bs = smem + (size_t)warp * 2 * K;
  float* zs = bs + K;
  for (int j = lane; j < K; j += 32) {
    bs[j] = b_in[row + j];
    zs[j] = z_in[row + j];
  }

  for (int s = 0; s < steps && act != 0.f; ++s) {
    float best = -1.f, bd = 0.f;
    int bj = K;
    for (int j = lane; j < K; j += 32) {
      const float bv = bs[j];
      const float th = trow != nullptr ? trow[j] : alpha;
      float p;
      if (NONNEG) {
        p = fmaxf(__fsub_rn(bv, th), 0.f);
      } else {
        const float a = __fsub_rn(fabsf(bv), th);
        p = a > 0.f ? copysignf(a, bv) : 0.f;
      }
      const float d = __fsub_rn(__fmul_rn(p, scale), zs[j]);
      const float ad = fabsf(d);
      if (bj == K || better(ad, j, best, bj)) {
        best = ad;
        bj = j;
        bd = d;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(FULL, best, off);
      const int oj = __shfl_xor_sync(FULL, bj, off);
      if (oj < K && (bj == K || better(ob, oj, best, bj))) {
        best = ob;
        bj = oj;
      }
    }
    const int k = bj;  // < K: every lane holds a column when K >= 32
    const float dz = __shfl_sync(FULL, bd, k & 31);
    const float upd = __fmul_rn(act, dz);
    const ST* srow = S + (size_t)k * K;
    for (int j = lane; j < K; j += 32)
      bs[j] = __fmaf_rn(upd, load_s(srow, j), bs[j]);
    if ((k & 31) == lane) zs[k] = __fadd_rn(zs[k], upd);
    if (!(fabsf(dz) > tol_k)) act = 0.f;
  }

  for (int j = lane; j < K; j += 32) {
    b_out[row + j] = bs[j];
    z_out[row + j] = zs[j];
  }
  if (lane == 0) act_out[n] = act;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// One coordinate update of the row held by this warp against the staged
// atom w (D floats in shared memory). R is the lane's register slice (DPL
// entries, columns lane + 32 i) or, with DPL = 0, the row in device memory.
// Returns the new z_j.
template <int DPL>
__device__ __forceinline__ float sweep_atom(float (&R)[DPL > 0 ? DPL : 1],
                                            float* Rg, const float* w,
                                            float zj, float nj, float alpha,
                                            float l2, int D, int lane) {
  float dot = 0.f;
  if (DPL > 0) {
#pragma unroll
    for (int i = 0; i < (DPL > 0 ? DPL : 1); ++i) {
      const int d = lane + 32 * i;
      if (d < D) dot = fmaf(R[i], w[d], dot);
    }
  } else {
    for (int d = lane; d < D; d += 32) dot = fmaf(Rg[d], w[d], dot);
  }
  dot = warp_sum(dot);
  const float add = zj != 0.f ? zj : 0.f;
  const float rho = __fmaf_rn(add, nj, dot);
  const float a = __fsub_rn(fabsf(rho), alpha);
  const float shr = a > 0.f ? copysignf(a, rho) : 0.f;
  const float zn = __fdiv_rn(shr, __fadd_rn(nj, l2));
  const float c = __fsub_rn(add, zn != 0.f ? zn : 0.f);
  if (DPL > 0) {
#pragma unroll
    for (int i = 0; i < (DPL > 0 ? DPL : 1); ++i) {
      const int d = lane + 32 * i;
      if (d < D) R[i] = __fmaf_rn(c, w[d], R[i]);
    }
  } else {
    for (int d = lane; d < D; d += 32)
      Rg[d] = __fmaf_rn(c, w[d], Rg[d]);
  }
  return zn;
}

template <int DPL>
__global__ void __launch_bounds__(32 * SWEEP_ROWS)
    cd_mod_sweep_kernel(const float* __restrict__ z_in,
                        const float* __restrict__ R_in,
                        const float* __restrict__ act_in,
                        const float* __restrict__ wt,
                        const float* __restrict__ nrm, float alpha, float l2,
                        float* __restrict__ z_out, float* __restrict__ R_out,
                        float* __restrict__ zmax_out,
                        float* __restrict__ dzmax_out, int N, int D, int K,
                        int TJ) {
  extern __shared__ float smem[];
  float* ws = smem;                      // [TJ, D] staged atoms
  float* ns = smem + (size_t)TJ * D;     // [TJ] their squared norms
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * SWEEP_ROWS + warp;
  const bool valid = n < N;
  const bool live = valid && act_in[n] != 0.f;
  const size_t zrow = (size_t)n * K, rrow = (size_t)n * D;

  if (valid && !live) {  // converged: copy through
    for (int j = lane; j < K; j += 32) z_out[zrow + j] = z_in[zrow + j];
    for (int d = lane; d < D; d += 32) R_out[rrow + d] = R_in[rrow + d];
    if (lane == 0) zmax_out[n] = dzmax_out[n] = 0.f;
  }
  if (!__syncthreads_or(live)) return;  // the whole block is converged

  float R[DPL > 0 ? DPL : 1];
  float* Rg = R_out + rrow;
  if (live) {
    if (DPL > 0) {
#pragma unroll
      for (int i = 0; i < (DPL > 0 ? DPL : 1); ++i) {
        const int d = lane + 32 * i;
        R[i] = d < D ? R_in[rrow + d] : 0.f;
      }
    } else {
      for (int d = lane; d < D; d += 32) Rg[d] = R_in[rrow + d];
    }
  }
  float zmax = 0.f, dzmax = 0.f;

  for (int j0 = 0; j0 < K; j0 += TJ) {
    const int tj = min(TJ, K - j0);
    __syncthreads();  // the previous chunk's atoms are no longer read
    for (int i = threadIdx.x; i < tj * D; i += blockDim.x)
      ws[i] = wt[(size_t)j0 * D + i];
    for (int i = threadIdx.x; i < tj; i += blockDim.x) ns[i] = nrm[j0 + i];
    __syncthreads();
    if (!live) continue;
    float zc = lane < tj ? z_in[zrow + j0 + lane] : 0.f;
    for (int jj = 0; jj < tj; ++jj) {
      const float nj = ns[jj];
      const float zj = __shfl_sync(FULL, zc, jj);
      if (nj == 0.f) continue;  // empty atom: nothing changes
      const float zn = sweep_atom<DPL>(R, Rg, ws + (size_t)jj * D, zj, nj,
                                       alpha, l2, D, lane);
      if (lane == jj) zc = zn;
      dzmax = fmaxf(dzmax, fabsf(__fsub_rn(zn, zj)));
      zmax = fmaxf(zmax, fabsf(zn));
    }
    if (lane < tj) z_out[zrow + j0 + lane] = zc;
  }

  if (live) {
    if (DPL > 0) {
#pragma unroll
      for (int i = 0; i < (DPL > 0 ? DPL : 1); ++i) {
        const int d = lane + 32 * i;
        if (d < D) R_out[rrow + d] = R[i];
      }
    }
    if (lane == 0) {
      zmax_out[n] = zmax;
      dzmax_out[n] = dzmax;
    }
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

constexpr size_t SMEM_MAX = 227 * 1024;

template <typename ST>
int launch_steps(const float* b, const float* z, const float* act,
                 const ST* S, const float* trow, float alpha, float tol_k,
                 float scale, int nonneg, float* b_out, float* z_out,
                 float* act_out, int N, int K, int steps, void* stream) {
  if (K < 32) return (int)cudaErrorInvalidValue;
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

template <int DPL>
int launch_sweep_dpl(const float* z, const float* R, const float* act,
                     const float* wt, const float* nrm, float alpha, float l2,
                     float* z_out, float* R_out, float* zmax, float* dzmax,
                     int N, int D, int K, void* stream) {
  int TJ = MAX_TJ;
  while (TJ > 1 && (size_t)TJ * D * sizeof(float) > 64 * 1024) TJ >>= 1;
  const size_t smem = ((size_t)TJ * D + TJ) * sizeof(float);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int e = set_smem(cd_mod_sweep_kernel<DPL>, smem);
  if (e != 0) return e;
  cd_mod_sweep_kernel<DPL>
      <<<(N + SWEEP_ROWS - 1) / SWEEP_ROWS, 32 * SWEEP_ROWS, smem,
         (cudaStream_t)stream>>>(z, R, act, wt, nrm, alpha, l2, z_out, R_out,
                                 zmax, dzmax, N, D, K, TJ);
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

// z: [N, K]; R: [N, D]; act: [N] float (0 = converged); wt: W^T [K, D];
// nrm: [K] squared column norms. Writes z_out, R_out, zmax, dzmax ([N]).
extern "C" int cd_mod_sweep(const float* z, const float* R, const float* act,
                            const float* wt, const float* nrm, float alpha,
                            float l2, float* z_out, float* R_out, float* zmax,
                            float* dzmax, int N, int D, int K, void* stream) {
#define SWEEP(DPL)                                                         \
  return launch_sweep_dpl<DPL>(z, R, act, wt, nrm, alpha, l2, z_out, R_out, \
                               zmax, dzmax, N, D, K, stream)
  if (D <= 32) SWEEP(1);
  if (D <= 64) SWEEP(2);
  if (D <= 128) SWEEP(4);
  if (D <= 256) SWEEP(8);
  if (D <= 512) SWEEP(16);
  if (D <= 1024) SWEEP(32);
  SWEEP(0);
#undef SWEEP
}

extern "C" const char* cd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
