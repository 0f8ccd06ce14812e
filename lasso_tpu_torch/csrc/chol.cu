// Batched Cholesky kernels, hand-written for Hopper (sm_90a): K7 appends one
// row to a batch of inverse Cholesky factors and solves; K8 (further down)
// factors a batch of small PD systems and solves them.
//
// K7 replaces the TPU kernel of the JAX package's ops/batched_cholesky.py:
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

// K8 chol_solve: solve A_s x_s = b_s for a batch of symmetric PD systems,
// A [B, D, D] and b, x [B, D] in PyTorch's own row-major layout, D <= 256.
//
// Replaces the TPU kernel of the JAX package's ops/batched_cholesky.py:
//   batch_cholesky_solve_lanes (_make_kernel for D % 8 != 0,
//   _make_kernel_blocked for D % 8 == 0, pallas_call at
//   batched_cholesky.py:366)
// which linalg/basic.py::batch_cholesky_solve calls, once a step for OMP's
// refactorizing 'chol-full' route. The TPU kernel transposes A to
// [D, D, B] and pads B to a multiple of 128 so that the batch fills the
// vector lanes; here a group of TPS threads owns one sample, and nothing
// is transposed or padded.
//
// The arithmetic is the TPU kernel's: the column recurrence
//   for j: inv = rsqrt(a_jj); L[j:, j] = a[j:, j] * inv;
//          a[i, k] -= L[i, j] L[k, j]   (k > j, i >= k)
// then the forward substitution L y = b and the back substitution
// L^T x = y, both column by column (y_j = r_j / L_jj, then r_i -= y_j L_ij
// for i > j; x_j = y_j / L_jj, then y_k -= x_j L_jk for k < j). There is no
// pivot floor: a pivot <= 0 gives rsqrt = NaN or inf and a non-finite x,
// which is what sends the caller's whole batch to the LU solve.
//
// A is taken as symmetric; the kernel reads its upper triangle, row k
// from the diagonal on, which is column k of the lower factor: the sample's
// packed lower triangle, column-major (column k, rows k..D-1, starts at
// cs(k) = k D - k (k - 1) / 2), is loaded with contiguous reads of A, once.
// It stays in shared memory for the whole solve: D (D + 1) / 2 floats, 8.3
// KB at D = 64 and 131.6 KB at D = 256 (one block's 227 KB after opting in).
// The trailing update of column j is the contiguous tail of that packed
// array, so the TPS threads of a sample walk it with unit stride (no bank
// conflicts), each carrying its element's (row, column) to find the two
// factor entries it multiplies. TPS grows with D (32 up to D = 64, so a
// warp a sample and 8 samples a block; 256 above D = 160, one sample a
// block); all samples of a launch have the same D, so every group runs the
// same loop and __syncthreads serves the whole block.
//
// What bounds it at B = 16384, D = 64 (OMP's 'chol-full' at T = 64): A read
// once is 268 MB, 0.08 ms at 3.35 TB/s; its B (D^3 / 3 + 2 D^2) operations
// are 1.6 GFLOP, 0.024 ms at 67 TFLOP/s. So it is bound by its bytes; this
// simple version spends most of its time in the trailing update's shared
// memory loop (about 10 instructions an element, D^3 / 6 elements a
// sample).

namespace {

constexpr int CS_THREADS = 256;   // threads per block for K8

// advance the (row i, column k) position of a packed column-major lower
// triangle of width d by n elements (column k holds rows k..d-1); stops at
// k == d past the end
__device__ __forceinline__ void tri_advance(int& i, int& k, int n, int d) {
  i += n;
  while (i >= d && k < d) {
    i -= d - k - 1;   // the overflow past row d - 1 continues in column
    ++k;              // k + 1, whose first row is k + 1
  }
}

__device__ __forceinline__ int tri_col(int k, int d) {
  return k * d - k * (k - 1) / 2;
}

template <int TPS>
__global__ void __launch_bounds__(CS_THREADS)
    chol_solve_kernel(const float* __restrict__ a,
                      const float* __restrict__ b, float* __restrict__ x,
                      int B, int D) {
  constexpr int S = CS_THREADS / TPS;   // samples per block
  extern __shared__ float sh[];
  const int tri = D * (D + 1) / 2;
  const int g = threadIdx.x / TPS, t = threadIdx.x % TPS;
  const size_t s = (size_t)blockIdx.x * S + g;
  const bool live = s < (size_t)B;
  float* P = sh + (size_t)g * (tri + 2 * D);   // packed lower triangle
  float* r = P + tri;                          // b, then x
  float* y = r + D;                            // y, then the back sums
  const float* as = a + s * D * D;

  // load: P[cs(k) + i - k] = A[k, i] for i >= k; a group past the batch
  // takes the identity and a zero right-hand side, and stores nothing
  {
    int i = t, k = 0;
    tri_advance(i, k, 0, D);
    for (int p = t; p < tri; p += TPS) {
      P[p] = live ? as[(size_t)k * D + i] : (i == k ? 1.f : 0.f);
      tri_advance(i, k, TPS, D);
    }
    for (int i2 = t; i2 < D; i2 += TPS)
      r[i2] = live ? b[s * D + i2] : 0.f;
  }
  __syncthreads();

  // factor, column by column
  for (int j = 0, cj = 0; j < D; cj += D - j, ++j) {
    const float inv = __frsqrt_rn(P[cj]);
    for (int i = j + 1 + t; i < D; i += TPS)
      P[cj + i - j] = __fmul_rn(P[cj + i - j], inv);
    __syncthreads();
    // the diagonal is scaled here, where nothing reads it any more
    if (t == 0) P[cj] = __fmul_rn(P[cj], inv);
    // trailing update: the packed tail from column j + 1 on
    int i = j + 1 + t, k = j + 1;
    tri_advance(i, k, 0, D);
    for (int p = cj + (D - j) + t; p < tri; p += TPS) {
      P[p] = fmaf(-P[cj + i - j], P[cj + k - j], P[p]);
      tri_advance(i, k, TPS, D);
    }
    __syncthreads();
  }

  // forward substitution L y = r
  for (int j = 0, cj = 0; j < D; cj += D - j, ++j) {
    const float yj = __fdiv_rn(r[j], P[cj]);
    for (int i = j + 1 + t; i < D; i += TPS)
      r[i] = fmaf(-yj, P[cj + i - j], r[i]);
    if (t == 0) y[j] = yj;
    __syncthreads();
  }

  // back substitution L^T x = y; x goes to r
  for (int j = D - 1; j >= 0; --j) {
    const float xj = __fdiv_rn(y[j], P[tri_col(j, D)]);
    for (int k = t; k < j; k += TPS)
      y[k] = fmaf(-xj, P[tri_col(k, D) + j - k], y[k]);
    if (t == 0) r[j] = xj;
    __syncthreads();
  }

  if (live)
    for (int i = t; i < D; i += TPS) x[s * D + i] = r[i];
}

template <int TPS>
int launch_chol_solve(const float* a, const float* b, float* x, int B, int D,
                      cudaStream_t stream) {
  constexpr int S = CS_THREADS / TPS;
  const size_t smem = (size_t)S * (D * (D + 1) / 2 + 2 * D) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        chol_solve_kernel<TPS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  chol_solve_kernel<TPS><<<(B + S - 1) / S, CS_THREADS, smem, stream>>>(
      a, b, x, B, D);
  return (int)cudaGetLastError();
}

}  // namespace

// a [B, D, D] (symmetric, its upper triangle read), b and x [B, D];
// 1 <= D <= 256.
extern "C" int chol_solve(const float* a, const float* b, float* x, int B,
                          int D, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (D <= 64) return launch_chol_solve<32>(a, b, x, B, D, st);
  if (D <= 96) return launch_chol_solve<64>(a, b, x, B, D, st);
  if (D <= 160) return launch_chol_solve<128>(a, b, x, B, D, st);
  return launch_chol_solve<256>(a, b, x, B, D, st);
}

extern "C" const char* chol_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
