// The whole batched OMP solve as hand-written kernels for Hopper (sm_90a).
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
//   K6a omp_select:  c = r W over a 128-row x 128-atom tile on the tensor
//                    cores (csrc/wgmma_product.cuh), then the epilogue
//                    score = sel ? -1 : |c| * invn and the first maximum of
//                    each row over the tile's 128 atoms, written as one
//                    (value, index) partial per row and atom tile. It
//                    replaces the TPU kernel's selection product
//                    (fused_omp.py:113-122, W^T split at :283-288): in f32
//                    the same bf16x3 split, r_hi W_hi + r_lo W_hi + r_hi
//                    W_lo, three MMAs a 16-deep slice into one FP32
//                    accumulator; in bf16 one MMA of bf16(r) and bf16(W).
//                    W^T is split once a solve by the wrapper ([K, D] bf16,
//                    K-major for the MMA). r changes every step: K6b and
//                    K6d keep its split beside it (rb [2, N, D] bf16, hi
//                    and lo, written with r), so that K6a brings both
//                    operands into shared memory by cp.async alone.
//   K6b omp_orth:    one warp per sample. It reduces the row's partials to
//                    the first-max atom k* (ties to the lower index, as
//                    jnp.argmax and torch.argmax), applies the rss freeze
//                    (rss = |r|^2 > tol, sklearn semantics), writes idx,
//                    valid and the selected mask, gathers w = W[:, k*] from
//                    W^T's contiguous row, runs modified Gram-Schmidt
//                    against the k live rows of Q (a dependent chain of k
//                    length-D dot products, fused_omp.py:165-178), applies
//                    the relative pivot floor max(|w_perp|^2, 1e-12 |w|^2 +
//                    1e-30), writes q_k, column k of R and d_k = q_k . r,
//                    and updates r. A frozen sample writes q_k = 0, R column
//                    e_k and d_k = 0 (fused_omp.py:186-193). With r it
//                    writes rb, r's bf16x3 split, for the next step's K6a.
//                    For D a multiple of 128 up to 1024 (omp_orth_stream
//                    _kernel<V>, V = D / 128) lane l owns the float4s 4 l +
//                    128 m of every D-vector, and w and r stay in
//                    registers (r is read once); the sample's live Q rows
//                    stream into a ring of S rows of shared memory by bulk
//                    copies (one a row, completing on the slot's mbarrier),
//                    issued S rows ahead of the chain, so that Q's loads
//                    never wait for it. Each row is read once from shared
//                    memory, into registers that serve its dot product and
//                    its update. Other D (and rows that are not 16-byte
//                    aligned) take omp_orth_kernel<false>, which holds w
//                    lane-strided in shared memory and reads each row of Q
//                    from device memory, twice (K6d's template).
//   K6d omp_orth_cgs2: K6b with the orthogonalisation of gs='cgs2'
//                    (fused_omp.py:149-163): classical Gram-Schmidt in two
//                    bulk passes, c1_t = q_t . w for all t < k, w -= sum
//                    c1_t q_t, c2_t = q_t . w, w -= sum c2_t q_t, R[t, k] =
//                    c1_t + c2_t. The TPU kernel reads all T rows of a
//                    zeroed Q; K6d reads the k live rows only (the state's
//                    Q is not cleared), which is the same arithmetic, since
//                    the coefficients of the rows >= k are exactly 0. CGS2
//                    needs all of pass 1's coefficients before its update,
//                    and w1 whole before pass 2's, so the k rows are swept
//                    four times. For D a multiple of 128 up to 1024
//                    (omp_orth_cgs2_block_kernel<V>) a block of four warps
//                    takes a sample and keeps its live rows resident in
//                    shared memory (bulk copies, chunks of 8 rows on their
//                    own mbarriers), so that device memory is read once a
//                    step and the four sweeps read shared memory; up to 55
//                    rows at D = 512 (two blocks an SM), the rest read from
//                    global memory in each sweep. Other D (and rows that
//                    are not 16-byte aligned) take omp_orth_kernel<true>:
//                    a warp a sample, w lane-strided in shared memory, the
//                    k dot products of a pass four to a sweep over w, each
//                    row read from device memory in all four sweeps.
//                    Everything else is K6b's.
//   K6c omp_backsub: the column-oriented back-substitution R z = d once
//                    after step T: z_j = rhs_j / R_jj, then rhs_i -= z_j
//                    R_ij for i < j, j = T-1 .. 0, each quotient, product
//                    and difference correctly rounded as in its plain
//                    version, so that z is bit for bit the plain
//                    version's. Up to T = 128
//                    (omp_backsub_staged_kernel<RP, VEC>) a persistent
//                    warp takes one sample at a time: its live columns
//                    (column j's first j + 1 floats, rounded up to 16
//                    bytes) come into shared memory by one bulk copy a
//                    column, completing on an mbarrier (4-byte cp.async
//                    where T % 4 != 0 or R is not 16-byte aligned), and d
//                    and valid are loaded a sample ahead, so that no step
//                    of the chain waits for device memory. Lane l holds
//                    rows 32 m + l of rhs in registers; every lane repeats
//                    the last update of rhs_{j-1}, so that the chain
//                    z_j -> rhs_{j-1} -> z_{j-1} needs no shuffle (the
//                    shuffle of rhs_{j-2} runs beside the next divide). A
//                    sample's columns take 8.7 KB at T = 64, so 23 warps
//                    share an SM and one warp's copies run under the
//                    others' chains (one buffer a warp: two, with the next
//                    sample's copies under this one's chain, halve the
//                    warps and were slower). Past T = 128
//                    omp_backsub_warp_kernel, the first kernel, reads each
//                    column from device memory on the chain, rhs in
//                    shared memory.
//
// What bounds it at N=16384, D=512, K=2048, T=64. K6a: 2NDK = 34.4 GFLOP a
// launch in bf16, three times that in f32, at the 989 TFLOP/s of bf16 on
// the tensor cores: 0.035 ms and 0.104 ms, both above the 0.010 ms to read
// r. Its tile is 128 x 128 with a ring of 3 stages of 64-deep operands in
// f32 (6 in bf16) filled by cp.async from a producer warpgroup, so two
// consumer warpgroups keep MMAs in flight while the next stages load; each
// block reads its rows of rb and W^T from L2 once per atom tile: 1 GB a
// launch in f32 (0.5 GB in bf16), 96 operations a byte, which the card's
// L2 rate, not the tensor cores, bounds at these tiles (PERF.md). A first
// version converted r from f32 in the producer's registers; those held
// 32 KB of loads in flight an SM, too few for L2's latency, and bf16 took
// nearly f32's time. So r's split is kept beside r and loaded by cp.async.
// K6b at step k: its k N D 4 bytes of Q (about k x 0.010 ms; with r, its
// split and the rest 0.358 ms averaged over the 64 steps). Its chain of k
// dot products, each reduced by warp shuffles, takes a few microseconds a
// sample; with S rows of Q in flight a warp and 16-24 warps an SM, the
// copies keep far more bytes in flight than the 25 KB an SM that Little's
// law asks at 3.35 TB/s, so the streamed kernel is bound by Q's bytes.
// K6d has the same bound; its resident kernel reads the k rows from device
// memory once and sweeps them four times in shared memory: 0.506 ms a step
// on average over the 64 steps on an NVIDIA H100 80GB HBM3 at 700 W (1.153
// at step 63, where two blocks share an SM; PERF.md). K6c reads R's live
// triangle (rounded up to 16 bytes), d and valid and writes z: 156 MB,
// 0.047 ms at 3.35 TB/s; its chains are 64 dependent divides a sample.
// Its staged kernel takes 0.074 ms on an NVIDIA H100 80GB HBM3 at 700 W
// (0.162 for the warp kernel), of which the copies alone take 0.069 and
// the chains alone 0.050 (scripts/omp_kernel_parts.py; PERF.md).
//
// Each C entry launches on the given stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>

#include "wgmma_product.cuh"

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

// K6a: per row n and atom tile b, the first maximum of
// score = sel ? -1 : |(r W)[n, k]| * invn[k] over the tile's 128 atoms;
// grid (ceil(N / 128), K / 128), one block of 384 threads per tile.
constexpr int SEL_STRIDE = 144;   // bytes a staged mask row: no bank
                                  // conflicts between a quad's 8 rows

template <bool SPLIT>
constexpr size_t select_smem() {
  return wgp::Ring<SPLIT>::BYTES + wgp::BM * SEL_STRIDE + wgp::BN * 4 +
         16 * wgp::Ring<SPLIT>::STAGES + 1024;   // + alignment slack
}

template <bool SPLIT>
__global__ void __launch_bounds__(wgp::THREADS, 1)
    omp_select_kernel(const __nv_bfloat16* __restrict__ rb,
                      const __nv_bfloat16* __restrict__ wt_hi,
                      const __nv_bfloat16* __restrict__ wt_lo,
                      const float* __restrict__ invn,
                      const unsigned char* __restrict__ sel,
                      float* __restrict__ pval, int* __restrict__ pidx,
                      int N, int D, int K) {
  using Ring = wgp::Ring<SPLIT>;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to it
  const uint32_t raw = wgp::smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const unsigned char* sel_s = smem_raw + (ring - raw) + Ring::BYTES;
  const float* invn_s =
      reinterpret_cast<const float*>(sel_s + wgp::BM * SEL_STRIDE);
  const uint32_t sel_a = ring + Ring::BYTES;
  const uint32_t invn_a = sel_a + wgp::BM * SEL_STRIDE;
  const uint32_t full = invn_a + wgp::BN * 4, empty = full + 8 * Ring::STAGES;
  const int row0 = blockIdx.x * wgp::BM, col0 = blockIdx.y * wgp::BN;
  const int nK = gridDim.y;
  const int tid = threadIdx.x, wg = tid >> 7;

  if (tid == 0) {
    for (int s = 0; s < Ring::STAGES; ++s) {
      wgp::mbar_init(full + 8 * s, 128);
      wgp::mbar_init(empty + 8 * s, 128 * wgp::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (wg == wgp::CONSUMERS) {
    wgp::produce<SPLIT>(rb, rb + (size_t)N * D, wt_hi, wt_lo, row0, col0, N,
                        D, ring, full, empty, tid - 128 * wgp::CONSUMERS);
    return;
  }

  // the consumers stage the tile's mask rows (coalesced, 16 bytes a copy)
  // and invn while the products run
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = tid + 256 * i, row = q >> 3, part = q & 7;
    if (row0 + row < N)
      wgp::cp_async16(sel_a + row * SEL_STRIDE + 16 * part,
                      sel + (size_t)(row0 + row) * K + col0 + 16 * part);
  }
  if (tid < wgp::BN / 4)
    wgp::cp_async16(invn_a + 16 * tid, invn + col0 + 4 * tid);

  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  wgp::consume<SPLIT>(d, D, ring, full, empty, wg);
  wgp::cp_async_wait_all();
  wgp::consumers_sync();

  // The accumulator layout of m64nNk16: warp w of the warpgroup holds rows
  // 16 w + lane / 4 (registers 4 j, 4 j + 1) and 16 w + lane / 4 + 8
  // (4 j + 2, 4 j + 3), at columns 8 j + 2 (lane % 4) + {0, 1}. A thread
  // scans its 32 columns of a row in ascending order, then the 4 lanes of
  // its quad combine; better() keeps the first maximum in any order.
  const int warp = (tid & 127) >> 5, lane = tid & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rl = wg * 64 + warp * 16 + (lane >> 2) + 8 * h;
    float bv = -INFINITY;
    int bi = INT_MAX;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = 8 * j + 2 * (lane & 3) + e;
        const float s = sel_s[rl * SEL_STRIDE + cl]
                            ? -1.f
                            : __fmul_rn(fabsf(d[4 * j + 2 * h + e]),
                                        invn_s[cl]);
        better(bv, bi, s, col0 + cl);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      better(bv, bi, ov, oi);
    }
    const int n = row0 + rl;
    if ((lane & 3) == 0 && n < N) {
      pval[(size_t)n * nK + blockIdx.y] = bv;
      pidx[(size_t)n * nK + blockIdx.y] = bi;
    }
  }
}

// One pass of classical Gram-Schmidt for K6d: c[t] = q_t . w for all t < k
// (independent dot products, four summed in one sweep over w and reduced
// together), then w -= sum_t c[t] q_t. qn is the sample's Q, c the warp's
// [T] coefficients in shared memory.
__device__ __forceinline__ void cgs_pass(const float* __restrict__ qn,
                                         float* w, float* c, int k, int D,
                                         int lane) {
  int t = 0;
  for (; t + 4 <= k; t += 4) {
    const float* q0 = qn + (size_t)t * D;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
    for (int e = lane; e < D; e += 32) {
      const float we = w[e];
      s0 = fmaf(q0[e], we, s0);
      s1 = fmaf(q0[D + e], we, s1);
      s2 = fmaf(q0[2 * D + e], we, s2);
      s3 = fmaf(q0[3 * D + e], we, s3);
    }
    s0 = warp_sum(s0);
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    s3 = warp_sum(s3);
    if (lane == 0) {
      c[t] = s0;
      c[t + 1] = s1;
      c[t + 2] = s2;
      c[t + 3] = s3;
    }
  }
  for (; t < k; ++t) {
    const float* qt = qn + (size_t)t * D;
    float s0 = 0.f;
    for (int e = lane; e < D; e += 32) s0 = fmaf(qt[e], w[e], s0);
    s0 = warp_sum(s0);
    if (lane == 0) c[t] = s0;
  }
  __syncwarp();
  for (int e = lane; e < D; e += 32) {
    float s = 0.f;
    for (int u = 0; u < k; ++u) s = fmaf(c[u], qn[(size_t)u * D + e], s);
    w[e] = __fsub_rn(w[e], s);
  }
  __syncwarp();
}

// K6b (CGS2 false) and K6d (CGS2 true): step k of one warp's sample. w is
// the warp's [D] slice of shared memory (followed, for K6d, by [2 T]
// coefficients c1, c2); lane l owns the entries d = l + 32 m of every
// D-vector, so the Gram-Schmidt stage needs no synchronization beyond the
// warp's shuffles.
template <bool CGS2>
__global__ void __launch_bounds__(OWARPS * 32)
    omp_orth_kernel(const float* __restrict__ pval,
                    const int* __restrict__ pidx, int nK,
                    const float* __restrict__ wt, float* __restrict__ r,
                    float* __restrict__ q, float* __restrict__ R,
                    float* __restrict__ d, int* __restrict__ idx,
                    float* __restrict__ valid, float* __restrict__ active,
                    unsigned char* __restrict__ sel,
                    __nv_bfloat16* __restrict__ rb, float tol, int k, int N,
                    int D, int K, int T) {
  extern __shared__ float wsm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * OWARPS + warp;
  if (n >= N) return;   // the whole warp leaves together
  float* w = wsm + (size_t)warp * (CGS2 ? D + 2 * T : D);
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

  // gather the atom, then Gram-Schmidt against q_0 .. q_{k-1}
  const float* wrow = wt + (size_t)kstar * D;
  float w0n = 0.f;
  for (int e = lane; e < D; e += 32) {
    const float v = wrow[e];
    w[e] = v;
    w0n = fmaf(v, v, w0n);
  }
  w0n = warp_sum(w0n);
  const float* qn = q + (size_t)n * T * D;
  if (CGS2) {
    float* c1 = w + D;
    float* c2 = c1 + T;
    __syncwarp();
    cgs_pass(qn, w, c1, k, D, lane);
    cgs_pass(qn, w, c2, k, D, lane);
    for (int t = lane; t < k; t += 32) Rk[t] = __fadd_rn(c1[t], c2[t]);
  } else {
    for (int t = 0; t < k; ++t) {   // modified Gram-Schmidt: a t-chain
      const float* qt = qn + (size_t)t * D;
      float cf = 0.f;
      for (int e = lane; e < D; e += 32) cf = fmaf(qt[e], w[e], cf);
      cf = warp_sum(cf);
      for (int e = lane; e < D; e += 32)
        w[e] = __fsub_rn(w[e], __fmul_rn(cf, qt[e]));
      if (lane == 0) Rk[t] = cf;
    }
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
  __nv_bfloat16* rbn = rb + (size_t)n * D;   // r's split: hi, then lo
  __nv_bfloat16* rbl = rbn + (size_t)N * D;   // N D further on
  for (int e = lane; e < D; e += 32) {
    const float v = __fsub_rn(rn[e], __fmul_rn(dk, w[e]));
    const __nv_bfloat16 hi = __float2bfloat16_rn(v);
    rn[e] = v;
    rbn[e] = hi;
    rbl[e] = __float2bfloat16_rn(__fsub_rn(v, __bfloat162float(hi)));
  }
  if (lane == 0) {
    Rk[k] = __fsqrt_rn(pivot);
    d[slot] = dk;
  }
}

// K6b for D = 128 V, V <= 8: step k of one warp's sample, w and r in
// registers (lane l owns the float4s l + 32 m of a row), the live rows of
// Q through a ring of S rows in shared memory (the warp's S D floats,
// then its S mbarriers after all the block's rings).
constexpr int SWARPS = 4;   // samples (one warp each) per streamed block

// one row of Q into the ring: one arrival on the slot's barrier expecting
// its bytes, and the bulk copy that completes them
__device__ __forceinline__ void bulk_row(uint32_t dst, const float* src,
                                         uint32_t bytes, uint32_t bar) {
  wgp::mbar_expect_tx(bar, bytes);
  wgp::bulk_copy(dst, src, bytes, bar);
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// r -= d_k q_k for one warp's sample (lane l the float4s l + 32 m of r
// and q_k in registers), stored with r's bf16x3 split (hi, then lo N D
// further on)
template <int V>
__device__ __forceinline__ void store_residual(const float4 (&rv)[V],
                                               const float4 (&qv)[V],
                                               float dk, float* r,
                                               __nv_bfloat16* rb, int n,
                                               int N, int lane) {
  constexpr int D = 128 * V;
  float4* rn4 = reinterpret_cast<float4*>(r + (size_t)n * D);
  uint2* hi2 = reinterpret_cast<uint2*>(rb + (size_t)n * D);
  uint2* lo2 = reinterpret_cast<uint2*>(rb + (size_t)N * D + (size_t)n * D);
#pragma unroll
  for (int m = 0; m < V; ++m) {
    const float4 v = make_float4(
        __fsub_rn(rv[m].x, __fmul_rn(dk, qv[m].x)),
        __fsub_rn(rv[m].y, __fmul_rn(dk, qv[m].y)),
        __fsub_rn(rv[m].z, __fmul_rn(dk, qv[m].z)),
        __fsub_rn(rv[m].w, __fmul_rn(dk, qv[m].w)));
    const __nv_bfloat162 h01 = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 h23 = __floats2bfloat162_rn(v.z, v.w);
    const __nv_bfloat162 l01 = __floats2bfloat162_rn(
        __fsub_rn(v.x, __low2float(h01)), __fsub_rn(v.y, __high2float(h01)));
    const __nv_bfloat162 l23 = __floats2bfloat162_rn(
        __fsub_rn(v.z, __low2float(h23)), __fsub_rn(v.w, __high2float(h23)));
    rn4[lane + 32 * m] = v;
    hi2[lane + 32 * m] =
        make_uint2(*reinterpret_cast<const uint32_t*>(&h01),
                   *reinterpret_cast<const uint32_t*>(&h23));
    lo2[lane + 32 * m] =
        make_uint2(*reinterpret_cast<const uint32_t*>(&l01),
                   *reinterpret_cast<const uint32_t*>(&l23));
  }
}

template <int V>
__global__ void __launch_bounds__(SWARPS * 32)
    omp_orth_stream_kernel(const float* __restrict__ pval,
                           const int* __restrict__ pidx, int nK,
                           const float* __restrict__ wt,
                           float* __restrict__ r, float* __restrict__ q,
                           float* __restrict__ R, float* __restrict__ d,
                           int* __restrict__ idx, float* __restrict__ valid,
                           float* __restrict__ active,
                           unsigned char* __restrict__ sel,
                           __nv_bfloat16* __restrict__ rb, float tol, int k,
                           int N, int K, int T, int S) {
  constexpr int D = 128 * V;
  extern __shared__ __align__(16) unsigned char osm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * SWARPS + warp;
  if (n >= N) return;   // the whole warp leaves together
  const uint32_t ring =
      wgp::smem_addr(osm) + (uint32_t)(warp * S * D * sizeof(float));
  const uint32_t bars = wgp::smem_addr(osm) +
                        (uint32_t)(SWARPS * S * D * sizeof(float)) +
                        8u * (uint32_t)(warp * S);
  const float* ring_f =
      reinterpret_cast<const float*>(osm) + (size_t)warp * S * D;

  // r, read once; the tol freeze on its square
  float4 rv[V];
  const float4* r4 = reinterpret_cast<const float4*>(r + (size_t)n * D);
  float rss = 0.f;
#pragma unroll
  for (int m = 0; m < V; ++m) {
    rv[m] = r4[lane + 32 * m];
    rss = dot4(rv[m], rv[m], rss);
  }
  rss = warp_sum(rss);
  const bool act = active[n] > 0.f && rss > tol;

  // the first S live rows of Q on their way, before anything else waits
  const float* qn = q + (size_t)n * T * D;
  if (act && lane == 0) {
    for (int i = 0; i < S; ++i) wgp::mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int t = 0; t < S && t < k; ++t)
      bulk_row(ring + (uint32_t)(t * D * sizeof(float)), qn + (size_t)t * D,
               D * sizeof(float), bars + 8 * t);
  }

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
  float4* qk4 = reinterpret_cast<float4*>(q + slot * D);
  float* Rk = R + slot * T;   // column k of R
  if (lane == 0) {
    idx[slot] = act ? kstar : 0;
    valid[slot] = act ? 1.f : 0.f;
    active[n] = act ? 1.f : 0.f;
    if (act) sel[(size_t)n * K + kstar] = 1;
  }
  if (!act) {
#pragma unroll
    for (int m = 0; m < V; ++m)
      qk4[lane + 32 * m] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int t = lane; t <= k; t += 32) Rk[t] = t == k ? 1.f : 0.f;
    if (lane == 0) d[slot] = 0.f;
    return;
  }

  // gather the atom into registers
  const float4* w4 = reinterpret_cast<const float4*>(wt + (size_t)kstar * D);
  float4 wv[V];
  float w0n = 0.f;
#pragma unroll
  for (int m = 0; m < V; ++m) {
    wv[m] = w4[lane + 32 * m];
    w0n = dot4(wv[m], wv[m], w0n);
  }
  w0n = warp_sum(w0n);
  __syncwarp();   // the barriers' initialisation, for every lane

  // modified Gram-Schmidt: a t-chain over the ring
  int ts = 0;
  uint32_t phase = 0;
  for (int t = 0; t < k; ++t) {
    wgp::mbar_wait(bars + 8 * ts, phase);
    const float4* row = reinterpret_cast<const float4*>(ring_f + ts * D);
    float4 qv[V];
    float cf = 0.f;
#pragma unroll
    for (int m = 0; m < V; ++m) {
      qv[m] = row[lane + 32 * m];
      cf = dot4(qv[m], wv[m], cf);
    }
    __syncwarp();   // every lane has read the slot: refill it
    if (lane == 0 && t + S < k) {
      wgp::fence_proxy_async();
      bulk_row(ring + (uint32_t)(ts * D * sizeof(float)),
               qn + (size_t)(t + S) * D, D * sizeof(float), bars + 8 * ts);
    }
    cf = warp_sum(cf);
#pragma unroll
    for (int m = 0; m < V; ++m) {
      wv[m].x = __fsub_rn(wv[m].x, __fmul_rn(cf, qv[m].x));
      wv[m].y = __fsub_rn(wv[m].y, __fmul_rn(cf, qv[m].y));
      wv[m].z = __fsub_rn(wv[m].z, __fmul_rn(cf, qv[m].z));
      wv[m].w = __fsub_rn(wv[m].w, __fmul_rn(cf, qv[m].w));
    }
    if (lane == 0) Rk[t] = cf;
    if (++ts == S) {
      ts = 0;
      phase ^= 1u;
    }
  }
  float nrm2 = 0.f;
#pragma unroll
  for (int m = 0; m < V; ++m) nrm2 = dot4(wv[m], wv[m], nrm2);
  nrm2 = warp_sum(nrm2);
  const float pivot =
      fmaxf(nrm2, __fadd_rn(__fmul_rn(1e-12f, w0n), 1e-30f));
  const float inv = __frsqrt_rn(pivot);

  // q_k, d_k = q_k . r and r -= d_k q_k, with r's split
  float dk = 0.f;
#pragma unroll
  for (int m = 0; m < V; ++m) {
    wv[m] = make_float4(__fmul_rn(wv[m].x, inv), __fmul_rn(wv[m].y, inv),
                        __fmul_rn(wv[m].z, inv), __fmul_rn(wv[m].w, inv));
    qk4[lane + 32 * m] = wv[m];
    dk = dot4(wv[m], rv[m], dk);
  }
  dk = warp_sum(dk);
  store_residual<V>(rv, wv, dk, r, rb, n, N, lane);
  if (lane == 0) {
    Rk[k] = __fsqrt_rn(pivot);
    d[slot] = dk;
  }
}

// K6d for D = 128 V, V <= 8, rows 16-byte aligned: step k of one sample
// on a block of CWARPS warps. The sample's first RD live rows of Q come
// into shared memory by bulk copies (chunks of CHUNK rows, each completing
// on its own mbarrier, all issued before anything else waits) and stay
// there for the four sweeps of the two passes, so each is read from
// device memory once a step; rows t >= RD (past what two blocks an SM
// leave room for) are read from global memory in every sweep, from L2
// after the first. Every warp holds w in registers, lane l the float4s
// l + 32 m. A pass's dot products split the rows among the warps (warp w
// the rows t = w mod CWARPS, four reduced together); its update w -=
// sum_t c_t q_t splits the float4 columns (warp w the m = w mod CWARPS,
// each entry summed over t ascending as in omp_orth_kernel<true>), and the
// warps exchange the new w through shared memory. Warp 0 reads r and
// finishes the step as K6b does; warp 1 reduces the partials.
constexpr int CWARPS = 4;   // warps a sample in the resident K6d kernel
constexpr int CHUNK = 8;    // rows a bulk copy (and an mbarrier)
// shared memory a resident K6d block may take so that two fit an SM (the
// SM's 228 KB, less 1 KB the card reserves a block)
constexpr int CGS2_BLOCK_SMEM = 113 * 1024;

__device__ __forceinline__ float4 f4_sub(const float4& a, const float4& b) {
  return make_float4(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y),
                     __fsub_rn(a.z, b.z), __fsub_rn(a.w, b.w));
}

__device__ __forceinline__ void f4_fma(float c, const float4& v, float4& s) {
  s.x = fmaf(c, v.x, s.x);
  s.y = fmaf(c, v.y, s.y);
  s.z = fmaf(c, v.z, s.z);
  s.w = fmaf(c, v.w, s.w);
}

template <int V>
__global__ void __launch_bounds__(CWARPS * 32)
    omp_orth_cgs2_block_kernel(const float* __restrict__ pval,
                               const int* __restrict__ pidx, int nK,
                               const float* __restrict__ wt,
                               float* __restrict__ r, float* __restrict__ q,
                               float* __restrict__ R, float* __restrict__ d,
                               int* __restrict__ idx,
                               float* __restrict__ valid,
                               float* __restrict__ active,
                               unsigned char* __restrict__ sel,
                               __nv_bfloat16* __restrict__ rb, float tol,
                               int k, int N, int K, int T, int RD) {
  constexpr int D = 128 * V;
  extern __shared__ __align__(16) unsigned char csm[];
  float* const rows = reinterpret_cast<float*>(csm);   // [rd][D]
  const int rd = min(k, RD), nch = (rd + CHUNK - 1) / CHUNK;
  float* const wbuf = rows + (size_t)rd * D;            // [D]
  float* const c1 = wbuf + D;                           // [T]
  float* const c2 = c1 + T;                             // [T]
  int* const flags = reinterpret_cast<int*>(c2 + T);    // act, k*
  const uint32_t bars = wgp::smem_addr(flags + 2);      // [nch] mbarriers
  const uint32_t rows_a = wgp::smem_addr(rows);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x;
  const float* qn = q + (size_t)n * T * D;

  // warp 0: r and the tol freeze on its square, then the resident rows on
  // their way before anything else waits; warp 1: the first maximum over
  // the row's column-tile partials
  float4 rv[V];
  if (warp == 0) {
    const float4* r4 = reinterpret_cast<const float4*>(r + (size_t)n * D);
    float rss = 0.f;
#pragma unroll
    for (int m = 0; m < V; ++m) {
      rv[m] = r4[lane + 32 * m];
      rss = dot4(rv[m], rv[m], rss);
    }
    rss = warp_sum(rss);
    const bool act = active[n] > 0.f && rss > tol;
    if (lane == 0) {
      flags[0] = act;
      if (act) {
        for (int c = 0; c < nch; ++c) wgp::mbar_init(bars + 8 * c, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        for (int c = 0; c < nch; ++c) {
          const int t0 = c * CHUNK, nr = min(CHUNK, rd - t0);
          bulk_row(rows_a + (uint32_t)(t0 * D * sizeof(float)),
                   qn + (size_t)t0 * D, nr * D * sizeof(float),
                   bars + 8 * c);
        }
      }
    }
  } else if (warp == 1) {
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
    if (lane == 0) flags[1] = (bi >= 0 && bi < K) ? bi : 0;
  }
  __syncthreads();   // the flags and the barriers are set
  const bool act = flags[0] != 0;
  const int kstar = flags[1];

  const size_t slot = (size_t)n * T + k;
  float4* qk4 = reinterpret_cast<float4*>(q + slot * D);
  float* Rk = R + slot * T;   // column k of R
  if (threadIdx.x == 0) {
    idx[slot] = act ? kstar : 0;
    valid[slot] = act ? 1.f : 0.f;
    active[n] = act ? 1.f : 0.f;
    if (act) sel[(size_t)n * K + kstar] = 1;
  }
  if (!act) {   // the same in every warp: the block leaves together
    if (warp == 0) {
#pragma unroll
      for (int m = 0; m < V; ++m)
        qk4[lane + 32 * m] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int t = lane; t <= k; t += 32) Rk[t] = t == k ? 1.f : 0.f;
      if (lane == 0) d[slot] = 0.f;
    }
    return;
  }

  // the atom: each warp gathers its float4 columns into wbuf, then every
  // warp reads all of it into registers
  float4* const wbuf4 = reinterpret_cast<float4*>(wbuf);
  const float4* w4 = reinterpret_cast<const float4*>(wt + (size_t)kstar * D);
#pragma unroll
  for (int m = 0; m < V; ++m)
    if (m % CWARPS == warp) wbuf4[lane + 32 * m] = w4[lane + 32 * m];
  __syncthreads();
  float4 wv[V];
#pragma unroll
  for (int m = 0; m < V; ++m) wv[m] = wbuf4[lane + 32 * m];
  const float4* rows4 = reinterpret_cast<const float4*>(rows);
  const float4* qn4 = reinterpret_cast<const float4*>(qn);

  // c[t] = q_t . w for the warp's rows t = warp mod CWARPS, four reduced
  // together: first the resident rows (pass 1 waits for each chunk as it
  // lands; a wait on a landed chunk returns at once), then those read from
  // global memory. `base` is rows4 or qn4, so each call site knows its
  // space.
  auto dot_rows = [&](const float4* base, int t, int n_rows, float* c,
                      bool wait) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = t + i * CWARPS;
      if (i < n_rows) {
        if (wait) wgp::mbar_wait(bars + 8 * (u / CHUNK), 0);
        const float4* row = base + (size_t)u * (D / 4);
#pragma unroll
        for (int m = 0; m < V; ++m)
          s[i] = dot4(row[lane + 32 * m], wv[m], s[i]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[i] += __shfl_xor_sync(0xffffffffu, s[i], off);
    if (lane == 0)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (i < n_rows) c[t + i * CWARPS] = s[i];
  };
  auto dots = [&](float* c, bool wait) {
    int t = warp;
    for (; t < rd; t += 4 * CWARPS)
      dot_rows(rows4, t, min(4, (rd - t + CWARPS - 1) / CWARPS), c, wait);
    // the warp's first row past the resident ones
    t = rd + (warp - rd % CWARPS + CWARPS) % CWARPS;
    for (; t < k; t += 4 * CWARPS)
      dot_rows(qn4, t, min(4, (k - t + CWARPS - 1) / CWARPS), c, false);
  };
  // w -= sum_t c[t] q_t: warp w the float4 columns m = w mod CWARPS over
  // all k rows, each entry's sum in ascending t; then every warp reads
  // the new w back
  auto update = [&](const float* c) {
#pragma unroll
    for (int m = 0; m < V; ++m) {
      if (m % CWARPS != warp) continue;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      const int col = lane + 32 * m;
      int t = 0;
#pragma unroll 4
      for (; t < rd; ++t) f4_fma(c[t], rows4[(size_t)t * (D / 4) + col], s);
      // the rows from global memory, eight loads in flight
      for (; t + 8 <= k; t += 8) {
        float4 v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = qn4[(size_t)(t + i) * (D / 4) + col];
#pragma unroll
        for (int i = 0; i < 8; ++i) f4_fma(c[t + i], v[i], s);
      }
      for (; t < k; ++t) f4_fma(c[t], qn4[(size_t)t * (D / 4) + col], s);
      wbuf4[col] = f4_sub(wv[m], s);
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < V; ++m) wv[m] = wbuf4[lane + 32 * m];
  };

  dots(c1, true);
  // every chunk has landed (each waited for by a warp): every thread
  // observes each barrier's completion before it reads the rows
  for (int c = 0; c < nch; ++c) wgp::mbar_wait(bars + 8 * c, 0);
  __syncthreads();   // c1 complete; every warp has read w from wbuf
  update(c1);
  dots(c2, false);
  __syncthreads();   // c2 complete; every warp has read w1 from wbuf
  update(c2);
  if (warp != 0) return;

  float w0n = 0.f, nrm2 = 0.f;
#pragma unroll
  for (int m = 0; m < V; ++m) {
    const float4 a = w4[lane + 32 * m];
    w0n = dot4(a, a, w0n);
    nrm2 = dot4(wv[m], wv[m], nrm2);
  }
  w0n = warp_sum(w0n);
  nrm2 = warp_sum(nrm2);
  const float pivot =
      fmaxf(nrm2, __fadd_rn(__fmul_rn(1e-12f, w0n), 1e-30f));
  const float inv = __frsqrt_rn(pivot);
  for (int t = lane; t < k; t += 32) Rk[t] = __fadd_rn(c1[t], c2[t]);

  // q_k, d_k = q_k . r and r -= d_k q_k, with r's split
  float dk = 0.f;
#pragma unroll
  for (int m = 0; m < V; ++m) {
    wv[m] = make_float4(__fmul_rn(wv[m].x, inv), __fmul_rn(wv[m].y, inv),
                        __fmul_rn(wv[m].z, inv), __fmul_rn(wv[m].w, inv));
    qk4[lane + 32 * m] = wv[m];
    dk = dot4(wv[m], rv[m], dk);
  }
  dk = warp_sum(dk);
  store_residual<V>(rv, wv, dk, r, rb, n, N, lane);
  if (lane == 0) {
    Rk[k] = __fsqrt_rn(pivot);
    d[slot] = dk;
  }
}

// K6c past T = 128: R z = d by columns, j = T-1 .. 0; rhs is the warp's
// [T] slice of shared memory. A frozen slot has R column e_j and d_j = 0,
// so it solves to exactly 0.
__global__ void __launch_bounds__(OWARPS * 32)
    omp_backsub_warp_kernel(const float* __restrict__ R,
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

// K6c's staged layout of a sample, for TP = T rounded up to the kernel's
// rows (columns past T are an identity, e_j): column j's first j + 1
// floats rounded up to VEC floats at off(j), TP columns in a stride of
// whole 128-byte lines
template <int VEC>
__host__ __device__ constexpr int backsub_offset(int j) {
  return VEC == 1 ? j * (j + 1) / 2
                  : 8 * (j / 4) * (j / 4 + 1) + 4 * (j % 4) * (j / 4 + 1);
}

template <int TP, int VEC>
__host__ __device__ constexpr int backsub_stride() {
  return (backsub_offset<VEC>(TP) + 31) / 32 * 32;
}

// one sample's back-substitution on its staged columns cs (row 32 m + g
// of lane g in rhs[m]; z_j to zr of row j's lane), j = TP-1 .. 0: z_j =
// rhs_j / R_jj, then rhs_i -= z_j R_ij for i < j. Every lane keeps rhs_j
// (cur) and rhs_{j-1} as it stands before step j (pre), so that the chain
// z_j -> rhs_{j-1} -> z_{j-1} runs in each lane's registers: rhs_{j-1}'s
// last update is repeated by every lane (the same operations on the same
// values as its own lane's), and the shuffle of rhs_{j-2} from its lane
// overlaps the next divide. The steps are unrolled, so that every offset
// into the columns is a constant.
template <int RP, int VEC>
__device__ __forceinline__ void backsub_chain(const float* cs, int lane,
                                              float (&rhs)[RP],
                                              float (&zr)[RP]) {
  constexpr int TP = 32 * RP;
  float cur = __shfl_sync(0xffffffffu, rhs[RP - 1], 31);
  float pre = __shfl_sync(0xffffffffu, rhs[(TP - 2) / 32], (TP - 2) % 32);
#pragma unroll
  for (int mj = RP - 1; mj >= 0; --mj)
#pragma unroll
    for (int jj = 31; jj >= 0; --jj) {
      const int j = 32 * mj + jj;
      const float* col = cs + backsub_offset<VEC>(j);
      const float zj = __fdiv_rn(cur, col[j]);
      if (lane == jj) zr[mj] = zj;
      if (j >= 1) cur = __fsub_rn(pre, __fmul_rn(zj, col[j - 1]));
#pragma unroll
      for (int m = 0; m < mj; ++m)
        rhs[m] = __fsub_rn(rhs[m], __fmul_rn(zj, col[32 * m + lane]));
      if (lane < jj)
        rhs[mj] = __fsub_rn(rhs[mj], __fmul_rn(zj, col[32 * mj + lane]));
      if (j >= 2)   // row j - 2, from its lane
        pre = __shfl_sync(0xffffffffu, rhs[(j - 2) / 32], (j - 2) % 32);
    }
}

// K6c up to T = 128: a persistent warp a block, a sample at a time: each
// warp walks samples blockIdx.x, blockIdx.x + gridDim.x, ..., copying a
// sample's live columns into its shared memory by bulk copies (TMA, one a
// column, completing on an mbarrier) where VEC = 4, by 4-byte cp.async
// otherwise, once the previous sample's chain is done with it. rhs and z
// stay in registers (lane g holds rows 32 m + g, m < RP). The chain runs
// over TP = 32 RP rows: rows past T have an identity column and d = 0, so
// they solve to exactly 0 and leave the others as they are (0 * 0
// subtracted), and the unrolled chain has no test of T. The arithmetic is
// the warp kernel's.
template <int RP, int VEC>
__global__ void __launch_bounds__(32)
    omp_backsub_staged_kernel(const float* __restrict__ R,
                              const float* __restrict__ d,
                              const float* __restrict__ valid,
                              float* __restrict__ z, int N, int T) {
  constexpr int TP = 32 * RP;
  extern __shared__ __align__(16) float bsm[];
  uint64_t* bar_p = reinterpret_cast<uint64_t*>(bsm);
  float* cs = bsm + 4;   // the staged columns
  const int lane = threadIdx.x;
  const uint32_t bar = wgp::smem_addr(bar_p);
  if (VEC == 4 && lane == 0) {
    wgp::mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the identity columns past T, once
  for (int j = T; j < TP; ++j)
    for (int i = lane; i <= j; i += 32)
      cs[backsub_offset<VEC>(j) + i] = i == j ? 1.f : 0.f;
  __syncwarp();

  // sample n's columns
  auto stage = [&](int n) {
    const float* Rn = R + (size_t)n * T * T;
    if (VEC == 4) {
      if (n >= N) return;
      if (lane == 0)
        wgp::mbar_expect_tx(bar, (uint32_t)(4 * backsub_offset<4>(T)));
      __syncwarp();
      wgp::fence_proxy_async();   // the chain's reads of cs are done
      for (int j = lane; j < T; j += 32)   // column j, rounded up to 16 B
        wgp::bulk_copy(wgp::smem_addr(cs + backsub_offset<4>(j)),
                       Rn + (size_t)j * T, (uint32_t)(16 * (j / 4 + 1)),
                       bar);
    } else {
      if (n < N)
        for (int j = 0; j < T; ++j)
          for (int c = lane; c <= j; c += 32)
            wgp::cp_async4_fill(wgp::smem_addr(cs + backsub_offset<1>(j) + c),
                                Rn + (size_t)j * T + c, 4);
    }
  };

  // the lane's rows of d and valid for sample n (0 past T and N)
  auto rows_of = [&](int n, float (&dv)[RP], float (&vv)[RP]) {
#pragma unroll
    for (int m = 0; m < RP; ++m) {
      const int i = 32 * m + lane;
      const bool in = n < N && i < T;
      dv[m] = in ? d[(size_t)n * T + i] : 0.f;
      vv[m] = in ? valid[(size_t)n * T + i] : 0.f;
    }
  };

  stage(blockIdx.x);
  float dn[RP], vn[RP];   // the next sample's rows, loaded a sample ahead
  rows_of(blockIdx.x, dn, vn);
  for (int n = blockIdx.x, t = 0; n < N; n += gridDim.x, ++t) {
    float rhs[RP], vld[RP], zr[RP];
#pragma unroll
    for (int m = 0; m < RP; ++m) {
      rhs[m] = dn[m];
      vld[m] = vn[m];
      zr[m] = 0.f;
    }
    rows_of(n + gridDim.x, dn, vn);
    // this sample's columns have landed
    if (VEC == 4)
      wgp::mbar_wait(bar, t & 1);
    else
      wgp::cp_async_wait_all();
    __syncwarp();
    backsub_chain<RP, VEC>(cs, lane, rhs, zr);
#pragma unroll
    for (int m = 0; m < RP; ++m) {
      const int i = 32 * m + lane;
      if (i < T) z[(size_t)n * T + i] = vld[m] > 0.f ? zr[m] : 0.f;
    }
    __syncwarp();   // the chain's reads are done before the next copies
    stage(n + gridDim.x);
  }
  if (VEC != 4) wgp::cp_async_wait_all();
}

// dynamic shared memory above 48 KB needs the kernel's opt-in
template <typename Kernel>
int smem_opt_in(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <bool SPLIT>
int launch_select(const __nv_bfloat16* rb, const __nv_bfloat16* wt_hi,
                  const __nv_bfloat16* wt_lo, const float* invn,
                  const unsigned char* sel, float* pval, int* pidx, int N,
                  int D, int K, void* stream) {
  if (N < 1 || D % wgp::BK != 0 || K % wgp::BN != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = select_smem<SPLIT>();
  const int e = smem_opt_in(omp_select_kernel<SPLIT>, smem);
  if (e != 0) return e;
  const dim3 grid((N + wgp::BM - 1) / wgp::BM, K / wgp::BN);
  omp_select_kernel<SPLIT><<<grid, wgp::THREADS, smem,
                             (cudaStream_t)stream>>>(rb, wt_hi, wt_lo, invn,
                                                     sel, pval, pidx, N, D,
                                                     K);
  return (int)cudaGetLastError();
}

template <bool CGS2>
int launch_orth(const float* pval, const int* pidx, int nK, const float* wt,
                float* r, float* q, float* R, float* d, int* idx,
                float* valid, float* active, unsigned char* sel,
                __nv_bfloat16* rb, float tol, int k, int N, int D, int K,
                int T, void* stream) {
  const size_t smem =
      (size_t)OWARPS * (CGS2 ? D + 2 * T : D) * sizeof(float);
  const int e = smem_opt_in(omp_orth_kernel<CGS2>, smem);
  if (e != 0) return e;
  omp_orth_kernel<CGS2><<<(N + OWARPS - 1) / OWARPS, OWARPS * 32, smem,
                          (cudaStream_t)stream>>>(pval, pidx, nK, wt, r, q,
                                                  R, d, idx, valid, active,
                                                  sel, rb, tol, k, N, D, K,
                                                  T);
  return (int)cudaGetLastError();
}

// the ring's depth: S rows of D floats a warp, about 8 KB, 2 to 8 rows
inline int stream_ring_rows(int D) {
  const int s = 8192 / (D * (int)sizeof(float));
  return s < 2 ? 2 : s > 8 ? 8 : s;
}

template <int V>
int launch_orth_stream(const float* pval, const int* pidx, int nK,
                       const float* wt, float* r, float* q, float* R,
                       float* d, int* idx, float* valid, float* active,
                       unsigned char* sel, __nv_bfloat16* rb, float tol,
                       int k, int N, int K, int T, void* stream) {
  const int S = stream_ring_rows(128 * V);
  const size_t smem = (size_t)SWARPS * S * (128 * V * sizeof(float) + 8);
  const int e = smem_opt_in(omp_orth_stream_kernel<V>, smem);
  if (e != 0) return e;
  omp_orth_stream_kernel<V><<<(N + SWARPS - 1) / SWARPS, SWARPS * 32, smem,
                              (cudaStream_t)stream>>>(
      pval, pidx, nK, wt, r, q, R, d, idx, valid, active, sel, rb, tol, k, N,
      K, T, S);
  return (int)cudaGetLastError();
}

#define LAUNCH_STREAM(V)                                                   \
  launch_orth_stream<V>(pval, pidx, nK, wt, r, q, R, d, idx, valid, active, \
                        sel, rb, tol, k, N, K, T, stream)

// the resident K6d's shared memory for rd rows: the rows, w's exchange
// row, the two passes' coefficients, two flags and a barrier a chunk
inline size_t cgs2_smem(int D, int T, int rd) {
  return sizeof(float) * ((size_t)rd * D + D + 2 * T + 2) +
         8 * (size_t)((rd + CHUNK - 1) / CHUNK);
}

// its rows: as many of the k live rows as leave room for two blocks an SM
inline int cgs2_resident_rows(int D, int T, int k) {
  int rows = k;
  while (rows > 0 && cgs2_smem(D, T, rows) > CGS2_BLOCK_SMEM) --rows;
  return rows;
}

template <int V>
int launch_orth_cgs2(const float* pval, const int* pidx, int nK,
                     const float* wt, float* r, float* q, float* R, float* d,
                     int* idx, float* valid, float* active,
                     unsigned char* sel, __nv_bfloat16* rb, float tol, int k,
                     int N, int K, int T, void* stream) {
  constexpr int D = 128 * V;
  const int rd = cgs2_resident_rows(D, T, k);
  const size_t smem = cgs2_smem(D, T, rd);
  const int e = smem_opt_in(omp_orth_cgs2_block_kernel<V>, smem);
  if (e != 0) return e;
  omp_orth_cgs2_block_kernel<V><<<N, CWARPS * 32, smem,
                                  (cudaStream_t)stream>>>(
      pval, pidx, nK, wt, r, q, R, d, idx, valid, active, sel, rb, tol, k, N,
      K, T, rd);
  return (int)cudaGetLastError();
}

#define LAUNCH_CGS2(V)                                                      \
  launch_orth_cgs2<V>(pval, pidx, nK, wt, r, q, R, d, idx, valid, active,  \
                      sel, rb, tol, k, N, K, T, stream)

// rows of 16-byte-aligned pointers and D a multiple of 128 up to 1024: the
// tier of the streamed K6b and the resident K6d
inline bool vector_tier(const float* wt, const float* r, const float* q,
                        const __nv_bfloat16* rb, int D) {
  const bool aligned = ((uintptr_t)wt | (uintptr_t)r | (uintptr_t)q |
                        (uintptr_t)rb) % 16 == 0;
  return aligned && D % 128 == 0 && D <= 1024;
}

}  // namespace

// rb [2, N, D] bf16, the split of r (hi, lo); wt_hi, wt_lo [K, D] bf16,
// the split of W^T (D a multiple of 64, K of 128); invn [K], sel [N, K]
// (0/1 bytes); writes the partials pval, pidx [N, K / 128].
extern "C" int omp_select_f32(const __nv_bfloat16* rb,
                              const __nv_bfloat16* wt_hi,
                              const __nv_bfloat16* wt_lo, const float* invn,
                              const unsigned char* sel, float* pval,
                              int* pidx, int N, int D, int K, void* stream) {
  return launch_select<true>(rb, wt_hi, wt_lo, invn, sel, pval, pidx, N, D,
                             K, stream);
}

// as omp_select_f32 with one product of the hi parts; the lo parts are
// not read
extern "C" int omp_select_bf16(const __nv_bfloat16* rb,
                               const __nv_bfloat16* wt_hi,
                               const __nv_bfloat16* wt_lo, const float* invn,
                               const unsigned char* sel, float* pval,
                               int* pidx, int N, int D, int K, void* stream) {
  return launch_select<false>(rb, wt_hi, wt_lo, invn, sel, pval, pidx, N, D,
                              K, stream);
}

// Step k: wt = W^T [K, D]; r [N, D], q [N, T, D], R [N, T, T] (column j of
// sample n at R[n, j, :]), d, valid [N, T] float, idx [N, T] int32,
// active [N] float 0/1, sel [N, K] bytes, rb [2, N, D] bf16 (r's split),
// all updated in place.
extern "C" int omp_orth(const float* pval, const int* pidx, int nK,
                        const float* wt, float* r, float* q, float* R,
                        float* d, int* idx, float* valid, float* active,
                        unsigned char* sel, __nv_bfloat16* rb, float tol,
                        int k, int N, int D, int K, int T, void* stream) {
  if (!vector_tier(wt, r, q, rb, D))
    return launch_orth<false>(pval, pidx, nK, wt, r, q, R, d, idx, valid,
                              active, sel, rb, tol, k, N, D, K, T, stream);
  switch (D / 128) {
    case 1: return LAUNCH_STREAM(1);
    case 2: return LAUNCH_STREAM(2);
    case 3: return LAUNCH_STREAM(3);
    case 4: return LAUNCH_STREAM(4);
    case 5: return LAUNCH_STREAM(5);
    case 6: return LAUNCH_STREAM(6);
    case 7: return LAUNCH_STREAM(7);
    default: return LAUNCH_STREAM(8);
  }
}

// omp_orth with two-pass classical Gram-Schmidt (gs='cgs2')
extern "C" int omp_orth_cgs2(const float* pval, const int* pidx, int nK,
                             const float* wt, float* r, float* q, float* R,
                             float* d, int* idx, float* valid, float* active,
                             unsigned char* sel, __nv_bfloat16* rb,
                             float tol, int k, int N, int D, int K, int T,
                             void* stream) {
  if (!vector_tier(wt, r, q, rb, D))
    return launch_orth<true>(pval, pidx, nK, wt, r, q, R, d, idx, valid,
                             active, sel, rb, tol, k, N, D, K, T, stream);
  switch (D / 128) {
    case 1: return LAUNCH_CGS2(1);
    case 2: return LAUNCH_CGS2(2);
    case 3: return LAUNCH_CGS2(3);
    case 4: return LAUNCH_CGS2(4);
    case 5: return LAUNCH_CGS2(5);
    case 6: return LAUNCH_CGS2(6);
    case 7: return LAUNCH_CGS2(7);
    default: return LAUNCH_CGS2(8);
  }
}

namespace {

template <int RP, int VEC>
int launch_backsub_staged(const float* R, const float* d, const float* valid,
                          float* z, int N, int T, cudaStream_t stream) {
  const auto kernel = omp_backsub_staged_kernel<RP, VEC>;
  // the barrier and a sample's columns; as many warps as fit on the card
  const size_t smem =
      16 + (size_t)backsub_stride<32 * RP, VEC>() * sizeof(float);
  int e = smem_opt_in(kernel, smem);
  if (e != 0) return e;
  int dev = 0, sms = 0, per_sm = 0;
  e = (int)cudaGetDevice(&dev);
  if (e == 0)
    e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev);
  if (e == 0)
    e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                           32, smem);
  if (e != 0) return e;
  const int grid = N < sms * per_sm ? N : sms * per_sm;
  kernel<<<grid < 1 ? 1 : grid, 32, smem, stream>>>(R, d, valid, z, N, T);
  return (int)cudaGetLastError();
}

// a warp a sample: rows 32 m + lane, m < RP = ceil(T / 32)
template <int VEC>
int launch_backsub_rows(const float* R, const float* d, const float* valid,
                        float* z, int N, int T, cudaStream_t stream) {
  if (T <= 32) return launch_backsub_staged<1, VEC>(R, d, valid, z, N, T,
                                                     stream);
  if (T <= 64) return launch_backsub_staged<2, VEC>(R, d, valid, z, N, T,
                                                     stream);
  if (T <= 96) return launch_backsub_staged<3, VEC>(R, d, valid, z, N, T,
                                                     stream);
  return launch_backsub_staged<4, VEC>(R, d, valid, z, N, T, stream);
}

}  // namespace

// z [N, T] = R^-1 d per sample, zero where valid is 0: the staged kernel
// to T = 128 (16-byte copies where T % 4 == 0 and R is 16-byte aligned),
// the warp kernel above.
extern "C" int omp_backsub(const float* R, const float* d, const float* valid,
                           float* z, int N, int T, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (N < 1 || T < 1) return (int)cudaErrorInvalidValue;
  if (T <= 128) {
    if (T % 4 == 0 && (uintptr_t)R % 16 == 0)
      return launch_backsub_rows<4>(R, d, valid, z, N, T, st);
    return launch_backsub_rows<1>(R, d, valid, z, N, T, st);
  }
  const size_t smem = (size_t)OWARPS * T * sizeof(float);
  const int e = smem_opt_in(omp_backsub_warp_kernel, smem);
  if (e != 0) return e;
  omp_backsub_warp_kernel<<<(N + OWARPS - 1) / OWARPS, OWARPS * 32, smem,
                            st>>>(R, d, valid, z, N, T);
  return (int)cudaGetLastError();
}

extern "C" const char* omp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
