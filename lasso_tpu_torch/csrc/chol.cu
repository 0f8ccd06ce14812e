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
// blockIdx.x * 32 + l. The new row k goes to V only at the end: the loads
// of V (rows below k) and its one store never touch the same element.
// Only the live block is read: V's lower triangle in rows 0..k-1 (V is
// lower triangular and its rows past k are identity rows, which the
// appends from the identity keep so), g[0..k] and b. Rows past k
// contribute z[j] = b[j], so a zero-padded slot solves to exactly 0. Only
// row k of V is written, in place (the JAX call aliases V in and out,
// batched_cholesky.py:318); a caller that wants a new factor copies V
// first.
//
// What bounds it at B=16384, T=64: the live lower triangle at step k is
// k(k+1)/2 floats a sample, 134 MB at k=63, and the whole of V 268 MB
// (0.08 ms at 3.35 TB/s); its 4 k^2 multiply-adds a sample are 0.3 GFLOP at
// k=63, 0.005 ms at 67 TFLOP/s. So it is bound by the bytes of the live
// triangle, read once.
//
// Two tiers, both one lane a sample (32 samples a block, so that each load
// of V[i, j, :] is one coalesced 128-byte access) and any B >= 1:
//
// T <= 64, chol_append_panel_kernel<T / 8>: each element of the live
// triangle is read from device memory once. Warp w of 8 owns the columns
// j = 8 c + w and keeps in registers their g_j and b_j, the column sums
// u_j and s_j (s = t^T V, z's sum) and, for a panel of 8 rows, its entries
// of those rows (the panels unrolled, so that a warp loads and multiplies
// only the entries left of the panel's diagonal block, with no index test
// but the diagonal block's). A panel's rows go through three stages: the
// warps' partial row sums of y and t over their columns, exchanged in
// shared memory and summed (warp r sums row r over the warps, in warp
// order), then u_j += V[i, j] y_i and s_j += V[i, j] t_i from the panel's
// registers, rows ascending. So y and t need no second read of the rows
// and u and s none of the columns; two __syncthreads a panel. u_j and s_j
// are sums in ascending i, as in the sweep kernel; y_i and t_i are the sum
// over the warps of each warp's sum in ascending j. Then the pivot,
// row k = [-u / lkk, 1 / lkk, 0 ...], t_k = row k . b (the warps' partials
// exchanged once more) and z_j = s_j + row_k[j] t_k for j <= k, b_j past k.
// At 256 threads and at most 128 registers a thread two blocks share an
// SM, and each warp issues a panel's loads (up to 64 a lane) together. On
// an NVIDIA H100 80GB HBM3 at 700 W it takes 0.031 ms on average over the
// 64 appends of an OMP solve at B=16384 (0.075 for the sweep kernel) and
// 0.062 at k=63, where V's reads alone run at about 2.9 TB/s (PERF.md;
// scripts/chol_kernel_parts.py).
//
// T = 72..904, chol_append_sweep_kernel (the first kernel, kept as the
// tier for the widths whose panels would not fit in registers): the 8
// warps of the block split the rows (for y and t = V b) and the columns
// (for u and z) of the 32 samples between them, i = p, p + 8, ... for warp
// p, and sweep the live triangle four times. Every row or column is a
// register sum; y and then t pass between the warps through shared memory
// ([T][32] floats), and so does the new row k.
//
// Each C entry launches on the given stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int SB = 32;   // samples per block: one per lane
constexpr int PW = 8;    // warps per block, splitting rows and columns

__global__ void __launch_bounds__(SB * PW)
    chol_append_sweep_kernel(float* __restrict__ v,
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

constexpr int PR = 8;   // rows a panel of the panel kernel

template <int TC>
__global__ void __launch_bounds__(SB * PW, 2)
    chol_append_panel_kernel(float* __restrict__ v,
                             const float* __restrict__ g,
                             const float* __restrict__ b,
                             float* __restrict__ z, int k, int B) {
  constexpr int T = 8 * TC;
  // the warps' partial row sums of a panel, (y, t) [warp][row][lane], then
  // the rows' (y, t) [row][lane]
  __shared__ float2 part[PW][PR][SB];
  __shared__ float2 rows[PR][SB];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int s = blockIdx.x * SB + lane;
  const bool live = s < B;
  const size_t rowT = (size_t)T * B;   // stride of one row of V
  const float* vw = v + s + (size_t)w * B;   // column w of row 0

  // the warp's columns j = 8 c + w: g_j for j < k (the rows' sums reach
  // no further), b_j for every j
  float gw[TC], bw[TC], u[TC], sc[TC];
#pragma unroll
  for (int c = 0; c < TC; ++c) {
    const int j = 8 * c + w;
    gw[c] = live && j < k ? g[(size_t)j * B + s] : 0.f;
    bw[c] = live ? b[(size_t)j * B + s] : 0.f;
    u[c] = 0.f;
    sc[c] = 0.f;
  }

  // panel p: rows i = 8 p + r below k; of the warp's columns, those with
  // c < p lie below the diagonal, and c = p holds it (j <= i for w <= r).
  // The panels are unrolled, so no load or multiply-add is issued for a
  // column right of the panel's diagonal block.
  float yy = 0.f;
#pragma unroll
  for (int p = 0; p < TC; ++p) {
    if (PR * p >= k) break;
    float vr[TC][PR];
#pragma unroll
    for (int r = 0; r < PR; ++r) {
      const int i = PR * p + r;
      const float* vi = vw + i * rowT;
      const bool row = live && i < k;
#pragma unroll
      for (int c = 0; c <= p; ++c)
        vr[c][r] = row && (c < p || w <= r) ? vi[(size_t)(8 * c) * B] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < PR; ++r) {
      float yp = 0.f, tp = 0.f;
#pragma unroll
      for (int c = 0; c <= p; ++c) {
        yp = fmaf(vr[c][r], gw[c], yp);
        tp = fmaf(vr[c][r], bw[c], tp);
      }
      part[w][r][lane] = make_float2(yp, tp);
    }
    __syncthreads();
    {   // warp w sums row w over the warps (PR == PW)
      float ya = 0.f, ta = 0.f;
#pragma unroll
      for (int q = 0; q < PW; ++q) {
        const float2 pq = part[q][w][lane];
        ya += pq.x;
        ta += pq.y;
      }
      rows[w][lane] = make_float2(ya, ta);
    }
    __syncthreads();   // also: the next panel's partials overwrite part
#pragma unroll
    for (int r = 0; r < PR; ++r) {
      const float2 yt = rows[r][lane];
      yy = fmaf(yt.x, yt.x, yy);   // rows past k give 0
#pragma unroll
      for (int c = 0; c <= p; ++c) {
        u[c] = fmaf(vr[c][r], yt.x, u[c]);
        sc[c] = fmaf(vr[c][r], yt.y, sc[c]);
      }
    }
  }

  const float gkk = live ? g[(size_t)k * B + s] : 1.f;
  const float pivot =
      fmaxf(__fsub_rn(gkk, yy), __fadd_rn(__fmul_rn(1e-6f, gkk), 1e-30f));
  const float inv = __frsqrt_rn(pivot);
  // row k over the warp's columns, and t_k = row k . b over them
  float rk[TC], tkp = 0.f;
#pragma unroll
  for (int c = 0; c < TC; ++c) {
    const int j = 8 * c + w;
    rk[c] = j < k ? __fmul_rn(-u[c], inv) : (j == k ? inv : 0.f);
    if (j <= k) tkp = fmaf(rk[c], bw[c], tkp);
  }
  part[w][0][lane].x = tkp;   // the last panel's reads of part are done
  __syncthreads();
  float tk = 0.f;
#pragma unroll
  for (int q = 0; q < PW; ++q) tk += part[q][0][lane].x;
  if (live)
#pragma unroll
    for (int c = 0; c < TC; ++c) {
      const int j = 8 * c + w;
      z[(size_t)j * B + s] = j <= k ? fmaf(rk[c], tk, sc[c]) : bw[c];
      v[s + k * rowT + (size_t)j * B] = rk[c];
    }
}

template <int TC>
int launch_append_panel(float* v, const float* g, const float* b, float* z,
                        int k, int B, cudaStream_t stream) {
  chol_append_panel_kernel<TC><<<(B + SB - 1) / SB, SB * PW, 0, stream>>>(
      v, g, b, z, k, B);
  return (int)cudaGetLastError();
}

}  // namespace

// v [T, T, B], row k written in place; g, b, z [T, B]; 0 <= k < T;
// T a multiple of 8 up to 904: the panel kernel to T = 64, the sweep
// kernel above.
extern "C" int chol_append_solve(float* v, const float* g, const float* b,
                                 float* z, int k, int T, int B,
                                 void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (T % 8 != 0 || k < 0 || k >= T || B < 1)
    return (int)cudaErrorInvalidValue;
  if (T <= 64) switch (T / 8) {
      case 1: return launch_append_panel<1>(v, g, b, z, k, B, st);
      case 2: return launch_append_panel<2>(v, g, b, z, k, B, st);
      case 3: return launch_append_panel<3>(v, g, b, z, k, B, st);
      case 4: return launch_append_panel<4>(v, g, b, z, k, B, st);
      case 5: return launch_append_panel<5>(v, g, b, z, k, B, st);
      case 6: return launch_append_panel<6>(v, g, b, z, k, B, st);
      case 7: return launch_append_panel<7>(v, g, b, z, k, B, st);
      default: return launch_append_panel<8>(v, g, b, z, k, B, st);
    }
  const size_t smem = (size_t)(2 * T + PW) * SB * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        chol_append_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  chol_append_sweep_kernel<<<(B + SB - 1) / SB, SB * PW, smem, st>>>(
      v, g, b, z, k, T, B);
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
// vector lanes; here a sample belongs to one group of threads, and nothing
// is transposed or padded in device memory.
//
// The arithmetic is the TPU kernel's: the column recurrence
//   for j: inv = rsqrt(a_jj); L[j:, j] = a[j:, j] * inv;
//          a[i, k] -= L[i, j] L[k, j]   (k > j, i >= k)
// then the forward substitution L y = b and the back substitution
// L^T x = y, both column by column (y_j = r_j / L_jj, then r_i -= y_j L_ij
// for i > j; x_j = y_j / L_jj, then y_k -= x_j L_jk for k < j). Every
// element keeps its chain of fmaf(-L_ij, L_kj, a) in ascending j, the
// pivot is __frsqrt_rn and every quotient is correctly rounded, so both
// kernels below compute what the JAX recurrence computes, up to the fused
// multiply-adds. There is no pivot floor: a pivot <= 0 gives rsqrt = NaN
// or inf and a non-finite x, which is what sends the caller's whole batch
// to the LU solve. A is taken as symmetric; the kernels read its upper
// triangle (row k from the diagonal on is column k of the lower factor).
//
// D <= 64 (OMP's 'chol-full' at T <= 64): chol_solve_warp_kernel<DP>, with
// DP = 16, 32 or 64 the width D rounded up. A sample belongs to DP / 2
// lanes of one warp (a warp holds 64 / DP samples), so it synchronises
// with __syncwarp alone and waits for no other sample. Rows and columns
// past D are an identity with a zero right-hand side, and so is a sample
// past the batch. Lane g holds rows g and DP - 1 - g of the factor in
// registers (ra[DP / 2] and rb[DP], indexed by the column; entries past a
// row's diagonal are never read as values), which balances the triangle
// over the lanes; every loop over j and k is unrolled, so no index is
// computed in the inner loop. Column j goes to the other lanes through a
// per-sample row of shared memory (two rows, alternating with j, so one
// __syncwarp a column suffices); every lane reads the same float4 of it,
// and each such broadcast feeds up to eight FFMAs of the trailing update.
// The forward substitution runs inside the factorisation: y_j once column
// j is scaled, then r_i -= y_j L_ij from the lane's own registers. The
// back substitution reads row j of L from a packed copy in shared memory
// (row j at j (j + 1) / 2), written once after the factorisation. A
// quotient is q = a rc corrected once by its exact remainder, fma(fma(-q,
// d, a), rc, q) with rc = __frcp_rn(d): for operands that neither overflow
// nor underflow the correctly rounded a / d (Markstein), as __fdiv_rn.
// A is read once, coalesced: for each k the lanes read row k of A at their
// two rows' columns, 128 bytes a warp-wide load.
//
// D = 65..256: chol_solve_tile_kernel<DP>, DP = 128 or 256, a block of DP
// threads a sample. The lower triangle lives in shared memory as 32 x 32
// tiles (151.8 KB at DP = 256), column-major and XOR-swizzled by column,
// loaded by 4-byte cp.async, and is factored right-looking by panels of
// 32 columns. Warp 0 factors the panel's diagonal tile as the warp kernel
// does (a row a lane, __syncwarp alone) with the forward substitution of
// its rows; then each row below solves against that tile on its own (its
// panel row in registers, the tile's columns read as broadcast float4s),
// and the trailing update runs over whole tiles, 64 threads a tile and a
// 4 x 4 register tile a thread, with float4 loads of the two panel tiles.
// Each element's chain of FFMAs stays in ascending j, and a panel takes
// three __syncthreads. One warp does the back substitution, reading row j
// of L across the tiles.
//
// What bounds it at B = 16384, D = 64 (OMP's 'chol-full' at T = 64): one
// triangle of A, b and x are 136 MB, 0.043 ms at 3.35 TB/s; its B (D^3 / 3
// + 2 D^2) operations are 1.6 GFLOP, 0.024 ms at 67 TFLOP/s. So the bytes
// bound it; at B = 1024, D = 256 the operations do (0.0875 ms). The warp
// kernel issues about 2.5k FFMA (1.4k of them useful) and 0.6k broadcast
// loads a lane for a sample, with 16 warps an SM (128 registers a
// thread); it is bound by the latency of its chains more than by its
// issue (PERF.md; scripts/chol_kernel_parts.py).

namespace {

constexpr int CW_WARPS = 4;       // warps per block of the warp kernel
constexpr unsigned FULL = 0xffffffffu;

// a / d correctly rounded, given rc = __frcp_rn(d): q = a rc, then one
// correction by the exact remainder (Markstein)
__device__ __forceinline__ float div_rn(float a, float d, float rc) {
  const float q = __fmul_rn(a, rc);
  return __fmaf_rn(__fmaf_rn(-q, d, a), rc, q);
}

template <int DP>
struct WarpSolve {
  static constexpr int G = DP / 2;              // lanes a sample
  static constexpr int SPB = 32 / G * CW_WARPS;  // samples a block
  static constexpr int TRI = DP * (DP + 1) / 2;
  // shared floats a sample: two column rows, the packed factor, 1 / L_jj,
  // y and x
  static constexpr int FLOATS = 2 * DP + TRI + 3 * DP;
  static_assert(FLOATS % 4 == 0, "float4 column rows");
};

template <int DP>
__global__ void __launch_bounds__(CW_WARPS * 32, 4)
    chol_solve_warp_kernel(const float* __restrict__ a,
                           const float* __restrict__ b,
                           float* __restrict__ x, int B, int D) {
  using W = WarpSolve<DP>;
  constexpr int G = W::G, H = DP / 2;
  extern __shared__ __align__(16) float shw[];
  const int g = threadIdx.x % G;          // lane within the sample's group
  const int slot = threadIdx.x / G;       // sample within the block
  float* col = shw + (size_t)slot * W::FLOATS;   // [2][DP]
  float* Lp = col + 2 * DP;                      // packed rows of L
  float* rd = Lp + W::TRI;                       // 1 / L_jj
  float* yv = rd + DP;                           // y, then x
  float* xv = yv + DP;
  const int ia = g, ib = DP - 1 - g;             // the lane's two rows
  const size_t s = (size_t)blockIdx.x * W::SPB + slot;
  const bool live = s < (size_t)B;
  const float* as = a + s * D * D;

  // row i of the lower factor is column i of A's upper triangle: for
  // each k the group reads row k of A; past D, and past the batch, an
  // identity
  float ra[H], rb[DP];
#pragma unroll
  for (int k = 0; k < H; ++k)
    ra[k] = live && k <= ia && ia < D ? __ldg(as + (size_t)k * D + ia)
                                      : (k == ia ? 1.f : 0.f);
#pragma unroll
  for (int k = 0; k < DP; ++k)
    rb[k] = live && k <= ib && ib < D ? __ldg(as + (size_t)k * D + ib)
                                      : (k == ib ? 1.f : 0.f);
  float rA = live && ia < D ? b[s * D + ia] : 0.f;
  float rB = live && ib < D ? b[s * D + ib] : 0.f;

  // factor column by column, with the forward substitution L y = r
#pragma unroll
  for (int j = 0; j < DP; ++j) {
    const int ja = j < H ? j : H - 1;   // an index of ra in bounds
    const int owner = j < H ? j : DP - 1 - j;
    float* cj = col + (j & 1) * DP;
    const float ajj = __shfl_sync(FULL, j < H ? ra[ja] : rb[j], owner, G);
    const float inv = __frsqrt_rn(ajj);
    const float ljj = __fmul_rn(ajj, inv);   // L_jj, as its row scales it
    const float rc = __frcp_rn(ljj);
    if (j < H) ra[ja] = __fmul_rn(ra[ja], inv);
    rb[j] = __fmul_rn(rb[j], inv);
    // column j to the group (the entries at and above the diagonal are
    // never read)
    if (j < H) cj[ia] = ra[ja];
    cj[ib] = rb[j];
    // y_j from row j's owner, then r_i -= y_j L_ij (a finished row's r
    // is not read again)
    const float rj = __shfl_sync(FULL, j < H ? rA : rB, owner, G);
    const float yj = div_rn(rj, ljj, rc);
    if (g == 0) {
      rd[j] = rc;
      yv[j] = yj;
    }
    if (j < H) rA = __fmaf_rn(-yj, ra[ja], rA);
    rB = __fmaf_rn(-yj, rb[j], rB);
    __syncwarp();
    // trailing update: a[i][k] -= L_ij L_kj for k > j, both rows
#pragma unroll
    for (int q = (j + 1) / 4; q < DP / 4; ++q) {
      const float4 c4 = reinterpret_cast<const float4*>(cj)[q];
      const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 4 * q + e;
        if (k <= j) continue;
        if (k < H) ra[k] = __fmaf_rn(-ra[ja], cv[e], ra[k]);
        rb[k] = __fmaf_rn(-rb[j], cv[e], rb[k]);
      }
    }
  }

  // the packed rows of L (row i at i (i + 1) / 2: for the lanes' rows
  // these offsets are distinct modulo 32 banks)
#pragma unroll
  for (int k = 0; k < H; ++k)
    if (k <= ia) Lp[ia * (ia + 1) / 2 + k] = ra[k];
#pragma unroll
  for (int k = 0; k < DP; ++k)
    if (k <= ib) Lp[ib * (ib + 1) / 2 + k] = rb[k];
  __syncwarp();

  // back substitution L^T x = y (the padded rows solve to 0): x_j from row
  // j's owner, then y_k -= x_j L_jk for the lane's rows k < j (a row's y
  // past its own step is not read again, and row j's packed neighbours lie
  // within Lp)
  float yA = yv[ia], yB = yv[ib];
#pragma unroll
  for (int j = DP - 1; j >= 0; --j) {
    const float* row = Lp + j * (j + 1) / 2;
    const float yj =
        __shfl_sync(FULL, j < H ? yA : yB, j < H ? j : DP - 1 - j, G);
    const float xj = div_rn(yj, row[j], rd[j]);
    if (g == 0) xv[j] = xj;
    yA = __fmaf_rn(-xj, row[ia], yA);
    yB = __fmaf_rn(-xj, row[ib], yB);
  }
  __syncwarp();
  if (live) {
    if (ia < D) x[s * D + ia] = xv[ia];
    if (ib < D) x[s * D + ib] = xv[ib];
  }
}

template <int DP>
int launch_chol_warp(const float* a, const float* b, float* x, int B, int D,
                     cudaStream_t stream) {
  using W = WarpSolve<DP>;
  const size_t smem = (size_t)W::SPB * W::FLOATS * sizeof(float);
  chol_solve_warp_kernel<DP><<<(B + W::SPB - 1) / W::SPB, CW_WARPS * 32,
                               smem, stream>>>(a, b, x, B, D);
  return (int)cudaGetLastError();
}

// K8 above D = 64: a block of DP threads a sample, DP = 128 or 256 (D
// rounded up). The lower triangle is kept as CT x CT tiles, tile (i, k)
// for k <= i at tile_at(i, k), each column-major with its rows XOR-swizzled
// by column (swz), so that four consecutive rows of a column are one
// float4 and a row or a column of a tile is read without bank conflicts.
constexpr int CT = 32;   // tile side

__device__ __forceinline__ int swz(int r, int c) {
  return c * CT + (r ^ ((c & 7) << 2));
}

__device__ __forceinline__ int tile_at(int i, int k) {
  return (i * (i + 1) / 2 + k) * CT * CT;
}

template <int DP>
struct TileSolve {
  static constexpr int NT = DP / CT;
  static constexpr int TILES = NT * (NT + 1) / 2;
  // shared floats: the tiles; r, y, L_jj and 1 / L_jj [DP] each; two
  // column rows [2][CT]; the panel's pivots' 1 / sqrt [CT]
  static constexpr int FLOATS = TILES * CT * CT + 4 * DP + 3 * CT;
};

template <int DP>
__global__ void __launch_bounds__(DP, 1)
    chol_solve_tile_kernel(const float* __restrict__ a,
                           const float* __restrict__ b,
                           float* __restrict__ x, int D) {
  using W = TileSolve<DP>;
  constexpr int NT = W::NT, GROUPS = DP / 64;
  extern __shared__ __align__(16) float sht[];
  float* tiles = sht;
  float* rv = tiles + W::TILES * CT * CT;   // r, for the rows not yet done
  float* yv = rv + DP;
  float* ld = yv + DP;
  float* rcp = ld + DP;
  float* cb = rcp + DP;   // [2][CT]: column j of the panel's diagonal tile
  float* invs = cb + 2 * CT;
  const int t = threadIdx.x;
  const size_t s = blockIdx.x;
  const float* as = a + s * D * D;

  // L(i, k) = A[k][i] for i >= k (A's upper triangle, read along its
  // rows, by 4-byte cp.async, all of them in flight at once); past D an
  // identity; zero above the diagonal
  for (int ib = 0; ib < NT; ++ib)
    for (int kb = 0; kb <= ib; ++kb)
      for (int e = t; e < CT * CT; e += DP) {
        const int c = e / CT, r = e % CT;
        const int i = ib * CT + r, k = kb * CT + c;
        float* dst = tiles + tile_at(ib, kb) + swz(r, c);
        if (i >= k && i < D)
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                           (uint32_t)__cvta_generic_to_shared(dst)),
                       "l"(as + (size_t)k * D + i)
                       : "memory");
        else
          *dst = i == k ? 1.f : 0.f;
      }
  rv[t] = t < D ? b[s * D + t] : 0.f;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  for (int p = 0; p < NT; ++p) {
    // the panel, columns p CT .. p CT + CT - 1. Warp 0 factors its diagonal
    // tile (lane t holds row p CT + t in registers, column jj goes to the
    // warp through shared memory, one __syncwarp a column) with the
    // forward substitution of those rows; then every row below it solves
    // against that tile on its own
    const int i = p * CT + t;
    const bool row = i < DP;
    float* ptile = tiles + tile_at(p, p);
    if (t < CT) {
      float pr[CT];
#pragma unroll
      for (int c = 0; c < CT; ++c) pr[c] = ptile[swz(t, c)];
      float r = rv[i];
#pragma unroll
      for (int jj = 0; jj < CT; ++jj) {
        const int j = p * CT + jj;
        float* cj = cb + (jj & 1) * CT;
        const float ajj = __shfl_sync(FULL, pr[jj], jj);
        const float inv = __frsqrt_rn(ajj);
        const float ljj = __fmul_rn(ajj, inv);
        const float rc = __frcp_rn(ljj);
        pr[jj] = __fmul_rn(pr[jj], inv);
        cj[t] = pr[jj];   // the entries at and above the diagonal: unread
        const float yj = div_rn(__shfl_sync(FULL, r, jj), ljj, rc);
        if (t == 0) {
          yv[j] = yj;
          ld[j] = ljj;
          rcp[j] = rc;
          invs[jj] = inv;
        }
        r = __fmaf_rn(-yj, pr[jj], r);   // a finished row's r is unread
        __syncwarp();
#pragma unroll
        for (int q = (jj + 1) / 4; q < CT / 4; ++q) {
          const float4 c4 = reinterpret_cast<const float4*>(cj)[q];
          const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kk = 4 * q + e;
            if (kk <= jj) continue;
            pr[kk] = __fmaf_rn(-pr[jj], cv[e], pr[kk]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < CT; ++c) ptile[swz(t, c)] = pr[c];
    }
    __syncthreads();
    if (t >= CT && row) {
      // row i: L_ij = a_ij / L_jj's square root, then a_ik -= L_ij L_kj for
      // the panel's columns k > j, and r_i -= y_j L_ij, j ascending
      float* rt = tiles + tile_at(i / CT, p);
      float pr[CT];
#pragma unroll
      for (int c = 0; c < CT; ++c) pr[c] = rt[swz(i % CT, c)];
      float r = rv[i];
#pragma unroll
      for (int jj = 0; jj < CT; ++jj) {
        pr[jj] = __fmul_rn(pr[jj], invs[jj]);
        r = __fmaf_rn(-yv[p * CT + jj], pr[jj], r);
        const int sw = (jj & 7) << 2;
#pragma unroll
        for (int q = (jj + 1) / 4; q < CT / 4; ++q) {
          const float4 c4 = *reinterpret_cast<const float4*>(
              ptile + jj * CT + ((4 * q) ^ sw));
          const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kk = 4 * q + e;
            if (kk <= jj) continue;
            pr[kk] = __fmaf_rn(-pr[jj], cv[e], pr[kk]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < CT; ++c) rt[swz(i % CT, c)] = pr[c];
      rv[i] = r;
    }
    __syncthreads();

    // trailing update of the tiles (ib, kb), p < kb <= ib: a group of 64
    // threads a tile, a 4 x 4 register tile a thread, a[i][k] -= L_ij L_kj
    // over the panel's columns j in ascending order
    const int grp = t / 64, lt = t % 64;
    const int r0 = 4 * (lt % 8), c0 = 4 * (lt / 8);
    int u = 0;
    for (int ib = p + 1; ib < NT; ++ib)
      for (int kb = p + 1; kb <= ib; ++kb, ++u) {
        if (u % GROUPS != grp) continue;
        float* tt = tiles + tile_at(ib, kb);
        const float* pi = tiles + tile_at(ib, p);
        const float* pk = tiles + tile_at(kb, p);
        float acc[4][4];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const float4 v = *reinterpret_cast<const float4*>(
              tt + (c0 + cc) * CT + (r0 ^ (((c0 + cc) & 7) << 2)));
          acc[cc][0] = v.x;
          acc[cc][1] = v.y;
          acc[cc][2] = v.z;
          acc[cc][3] = v.w;
        }
#pragma unroll
        for (int jj = 0; jj < CT; ++jj) {
          const int sw = (jj & 7) << 2;
          const float4 a4 =
              *reinterpret_cast<const float4*>(pi + jj * CT + (r0 ^ sw));
          const float4 b4 =
              *reinterpret_cast<const float4*>(pk + jj * CT + (c0 ^ sw));
          const float av[4] = {a4.x, a4.y, a4.z, a4.w};
          const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
#pragma unroll
            for (int rr = 0; rr < 4; ++rr)
              acc[cc][rr] = __fmaf_rn(-av[rr], bv[cc], acc[cc][rr]);
        }
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
          *reinterpret_cast<float4*>(
              tt + (c0 + cc) * CT + (r0 ^ (((c0 + cc) & 7) << 2))) =
              make_float4(acc[cc][0], acc[cc][1], acc[cc][2], acc[cc][3]);
      }
    __syncthreads();
  }

  // back substitution L^T x = y on one warp (the padded rows solve to 0):
  // lane l holds y and x of the rows l + CT m; x_j from row j's owner,
  // then y_k -= x_j L_jk for the rows k < j (row j of L is row j % CT of
  // the tiles (j / CT, m))
  if (t < 32) {
    float yr[NT], xr[NT];
#pragma unroll
    for (int m = 0; m < NT; ++m) {
      yr[m] = yv[m * CT + t];
      xr[m] = 0.f;
    }
#pragma unroll
    for (int mb = NT - 1; mb >= 0; --mb)
#pragma unroll
      for (int jj = CT - 1; jj >= 0; --jj) {
        const int j = mb * CT + jj;
        const float xj =
            div_rn(__shfl_sync(FULL, yr[mb], jj), ld[j], rcp[j]);
        if (t == jj) xr[mb] = xj;
#pragma unroll
        for (int m = 0; m <= mb; ++m)
          if (m * CT + t < j)
            yr[m] = __fmaf_rn(-xj, tiles[tile_at(mb, m) + swz(jj, t)],
                              yr[m]);
      }
#pragma unroll
    for (int m = 0; m < NT; ++m)
      if (m * CT + t < D) x[s * D + m * CT + t] = xr[m];
  }
}

template <int DP>
int launch_chol_tile(const float* a, const float* b, float* x, int B, int D,
                     cudaStream_t stream) {
  const size_t smem = (size_t)TileSolve<DP>::FLOATS * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        chol_solve_tile_kernel<DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  chol_solve_tile_kernel<DP><<<B, DP, smem, stream>>>(a, b, x, D);
  return (int)cudaGetLastError();
}

}  // namespace

// a [B, D, D] (symmetric, its upper triangle read), b and x [B, D];
// 1 <= D <= 256.
extern "C" int chol_solve(const float* a, const float* b, float* x, int B,
                          int D, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (D <= 16) return launch_chol_warp<16>(a, b, x, B, D, st);
  if (D <= 32) return launch_chol_warp<32>(a, b, x, B, D, st);
  if (D <= 64) return launch_chol_warp<64>(a, b, x, B, D, st);
  if (D <= 128) return launch_chol_tile<128>(a, b, x, B, D, st);
  return launch_chol_tile<256>(a, b, x, B, D, st);
}

extern "C" const char* chol_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
