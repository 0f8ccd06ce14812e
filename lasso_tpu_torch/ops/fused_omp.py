"""The whole batched OMP solve: hand-written CUDA kernels and their plain
versions.

Counterpart of the JAX package's ``ops/fused_omp.py``: QR-OMP by modified
Gram-Schmidt, the same greedy recursion as the solver's Cholesky route
with other rounding. With ``r_0 = x``, step k of each sample is

    c    = r W                              (correlations)
    k*   = argmax |c| / ||w||               (masked by the selected set)
    w    = W[:, k*]
    w   -= sum_t (q_t . w) q_t              (MGS, or CGS2 with gs='cgs2';
                                             R[t, k] = the coefficient)
    q_k  = w / ||w||,  R[k, k] = ||w||      (with a relative pivot floor)
    d_k  = q_k . r,    r -= d_k q_k

and after T steps the codes on the support solve ``R z = d``. A sample
whose squared residual falls to ``tol`` or below freezes: its support stops
growing (q_k = 0, R column e_k, d_k = 0).

The TPU kernel keeps a 128-sample tile's whole solve in VMEM. On the H100
the state (Q alone is ``N T D`` floats) lives in device memory in an
:class:`OmpState`, and :func:`fused_omp_solve` runs T steps of two kernels
of ``csrc/omp.cu`` from the host, then one back-substitution:

* :func:`omp_select` (K6a): the correlation product on the tensor cores
  with the masked first-max epilogue, one ``(score, atom)`` partial per
  row and 128-atom tile;
* :func:`omp_orth` (K6b, or K6d with ``gs='cgs2'``): the partials' first
  maximum, the freeze, the atom gather, Gram-Schmidt, ``q_k``, R,
  ``d_k`` and the residual update (up to D = 1024 K6b streams the live
  rows of Q through shared memory by bulk copies, ahead of its chain, and
  K6d keeps them resident in a block's shared memory for its four
  sweeps);
* :func:`omp_backsub` (K6c): ``R z = d`` (up to T = 128 a sample's live
  columns are staged in shared memory before its chain, so that no step
  of the chain waits for device memory; :func:`backsub_tier`).

Each entry launches its kernel on a CUDA tensor (or raises) and runs its
plain version (``omp_select_plain``, ``omp_orth_plain``,
``omp_backsub_plain``) on a CPU tensor; :func:`fused_omp_solve_plain`
composes the plain versions.

``kernel_precision`` sets the selection product only, as in the TPU
kernel: ``'f32'`` is its bf16x3 split (``r_hi W_hi + r_lo W_hi + r_hi
W_lo``, FP32 sums; f32-grade), ``'bf16'`` rounds r and W to bf16 with
FP32 sums. W^T is split once a solve (:func:`select_operands`), r at
every step. The solve itself is always FP32.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from lasso_tpu_torch.config import require_fp32_matmul
from lasso_tpu_torch.ops import _cuda
from lasso_tpu_torch.ops.precision import (check_kernel_precision,
                                           round_bf16, split_bf16)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# the C entries of csrc/omp.cu
OMP_SELECT = {kp: _cuda.CudaKernel("omp", f"omp_select_{kp}",
                                   [_P] * 7 + [_I] * 3 + [_P])
              for kp in ("f32", "bf16")}
_ORTH_ARGS = [_P, _P, _I] + [_P] * 10 + [_F] + [_I] * 5 + [_P]
OMP_ORTH = {"mgs": _cuda.CudaKernel("omp", "omp_orth", _ORTH_ARGS),
            "cgs2": _cuda.CudaKernel("omp", "omp_orth_cgs2", _ORTH_ARGS)}
OMP_BACKSUB = _cuda.CudaKernel("omp", "omp_backsub", [_P] * 4 + [_I] * 2
                               + [_P])
TILE = 128        # atoms per partial: BN of csrc/wgmma_product.cuh
# past D = 1024 (or with rows not 16-byte aligned) K6b and K6d keep a [D]
# row for each of the 8 samples of a block in shared memory (K6d also its
# [2 T] coefficients); up to D = 1024 K6b keeps w and r in registers and
# K6d a sample's live rows in a block's shared memory
_WARPS = 8
_MAX_D = 227 * 1024 // (_WARPS * 4)   # floats such a warp may hold


def supports_fused_omp(N, D, K, T, dtype):
    """Shapes the fused path takes: float32 and D, K multiples of 128, as
    in the JAX package (so that its pad route and its routing are the
    same), and D within the shared memory of the warp-strided K6b that
    takes D past 1024 (a [D] row for each of 8 samples). The TPU's VMEM
    term has no counterpart: the state lives in device memory."""
    return (dtype == torch.float32 and D % 128 == 0 and K % 128 == 0
            and D <= _MAX_D)


@dataclasses.dataclass
class OmpState:
    """The fused solve's state, updated in place by the steps.

    r [N, D] residual; rb [2, N, D] bfloat16 its split ``split_bf16(r)``
    (hi, lo), kept beside it for K6a; sel [N, K] uint8 selected mask;
    active [N] float 0/1; Q [N, T, D] basis rows; R [N, T, T] with column
    j of sample n at ``R[n, j]``; d, valid [N, T] float; idx [N, T] int32;
    pval, pidx [N, ceil(K / 128)] the selection partials of the current
    step.
    """
    r: torch.Tensor
    rb: torch.Tensor
    sel: torch.Tensor
    active: torch.Tensor
    Q: torch.Tensor
    R: torch.Tensor
    d: torch.Tensor
    valid: torch.Tensor
    idx: torch.Tensor
    pval: torch.Tensor
    pidx: torch.Tensor


def omp_init_state(x, K, T):
    """The state before step 0: r = x, nothing selected, every sample
    active. Q and R need no clearing: step k writes row k of Q and column
    k of R before any later step or the back-substitution reads them."""
    N, D = x.shape
    dev = x.device
    nK = -(-K // TILE)
    f32 = dict(dtype=torch.float32, device=dev)
    return OmpState(
        r=x.clone(memory_format=torch.contiguous_format),
        rb=torch.stack(split_bf16(x)).to(torch.bfloat16),
        sel=torch.zeros((N, K), dtype=torch.uint8, device=dev),
        active=torch.ones((N,), **f32),
        Q=torch.empty((N, T, D), **f32),
        R=torch.empty((N, T, T), **f32),
        d=torch.empty((N, T), **f32),
        valid=torch.empty((N, T), **f32),
        idx=torch.empty((N, T), dtype=torch.int32, device=dev),
        pval=torch.empty((N, nK), **f32),
        pidx=torch.empty((N, nK), dtype=torch.int32, device=dev))


def inverse_norms(weight):
    """``1 / ||w_k||`` with the squared norm clipped at 1e-30, as the TPU
    kernel's ``invn``: a zero (padding) atom scores exactly 0."""
    return 1.0 / torch.sqrt(torch.clamp(torch.sum(weight * weight, dim=0),
                                        min=1e-30))


def select_operands(weight, kernel_precision="f32"):
    """K6a's B operand, made once a solve: ``W^T`` [K, D] in bf16,
    contiguous along D, as ``(hi, lo)``: the bf16x3 split of the TPU
    wrapper (fused_omp.py:283-285) for ``'f32'``, or ``(bf16(W^T), None)``
    for ``'bf16'``."""
    check_kernel_precision(kernel_precision)
    wt = weight.T.contiguous()
    if kernel_precision == "bf16":
        return wt.to(torch.bfloat16), None
    hi, lo = split_bf16(wt)
    return hi.to(torch.bfloat16), lo.to(torch.bfloat16)


def omp_select(state, wsplit, invn, kernel_precision="f32"):
    """K6a: write the selection partials of the current residual into
    ``state.pval`` / ``state.pidx``: for each row and 128-atom tile the
    largest ``sel ? -1 : |(r W)[n, k]| * invn[k]`` and its first atom.
    ``wsplit`` is :func:`select_operands` of W in the same precision. The
    kernel reads r's split ``state.rb``, which the state keeps with r."""
    check_kernel_precision(kernel_precision)
    if state.r.device.type == "cpu":
        return omp_select_plain(state, wsplit, invn, kernel_precision)
    N, D = state.r.shape
    hi, lo = wsplit
    K = hi.shape[0]
    if (lo is None) != (kernel_precision == "bf16"):
        raise ValueError(f"wsplit does not match kernel_precision="
                         f"{kernel_precision!r}")
    if D % 64 or K % TILE:
        raise ValueError(f"omp_select takes D a multiple of 64 and K of "
                         f"{TILE}, got D={D}, K={K}")
    _cuda.check_cuda(int32=("pidx",), uint8=("sel",),
                     bfloat16=("rb", "hi", "lo"), rb=state.rb, hi=hi, lo=lo,
                     invn=invn, sel=state.sel, pval=state.pval,
                     pidx=state.pidx)
    _cuda.check_shapes({"rb": (state.rb, (2, N, D)), "hi": (hi, (K, D)),
                        "lo": (lo, (K, D)),
                        "invn": (invn, (K,)), "sel": (state.sel, (N, K)),
                        "pval": (state.pval, (N, K // TILE))})
    OMP_SELECT[kernel_precision](
        state.rb.data_ptr(), hi.data_ptr(), _cuda.ptr(lo), invn.data_ptr(),
        state.sel.data_ptr(), state.pval.data_ptr(), state.pidx.data_ptr(),
        N, D, K, _cuda.stream())


def omp_select_plain(state, wsplit, invn, kernel_precision="f32"):
    """The plain version of :func:`omp_select`, on any device: the same
    product (the bf16x3 split ``r_hi W_hi + r_lo W_hi + r_hi W_lo``, or
    bf16 operands, with FP32 sums) and the same masked scores, reduced per
    128-atom tile to the first maximum."""
    check_kernel_precision(kernel_precision)
    r = state.r
    hi, lo = (None if w is None else w.float().T for w in wsplit)
    if r.is_cuda:
        require_fp32_matmul()
    if kernel_precision == "bf16":
        c = round_bf16(r) @ hi
    else:
        r_hi, r_lo = split_bf16(r)
        c = r_hi @ hi + r_lo @ hi + r_hi @ lo
    score = torch.where(state.sel.bool(), -1.0, torch.abs(c) * invn)
    N, K = score.shape
    nK = -(-K // TILE)
    tiles = torch.nn.functional.pad(score, (0, nK * TILE - K),
                                    value=-float("inf")).reshape(N, nK, TILE)
    at = torch.argmax(tiles, dim=2, keepdim=True)
    state.pval.copy_(torch.gather(tiles, 2, at)[..., 0])
    base = torch.arange(nK, device=r.device).reshape(1, nK) * TILE
    state.pidx.copy_(at[..., 0] + base)


def omp_orth(state, wt, k, tol=None, gs="mgs"):
    """K6b (``gs='mgs'``) or K6d (``gs='cgs2'``): step k after
    :func:`omp_select`. ``wt`` is ``W^T`` [K, D] (contiguous rows for the
    gather); ``tol`` (None disables the freeze) freezes a sample whose
    squared residual is at or below it. Updates ``state`` in place."""
    _check_gs(gs)
    if state.r.device.type == "cpu":
        return omp_orth_plain(state, wt, k, tol, gs)
    N, D = state.r.shape
    K = wt.shape[0]
    T = state.Q.shape[1]
    _cuda.check_cuda(int32=("pidx", "idx"), uint8=("sel",),
                     bfloat16=("rb",), wt=wt,
                     **{f.name: getattr(state, f.name)
                        for f in dataclasses.fields(OmpState)})
    _cuda.check_shapes({"wt": (wt, (K, D)), "sel": (state.sel, (N, K)),
                        "rb": (state.rb, (2, N, D)),
                        "Q": (state.Q, (N, T, D)), "R": (state.R, (N, T, T))})
    if not 0 <= k < T:
        raise ValueError(f"step {k} is outside [0, {T})")
    # K6d's warp also holds its two passes' [T] coefficients
    held = D + 2 * T if gs == "cgs2" else D
    if held > _MAX_D:
        raise ValueError(f"D={D}{f', T={T}' if gs == 'cgs2' else ''} "
                         f"exceeds omp_orth's shared memory ({held} > "
                         f"{_MAX_D} floats a sample)")
    OMP_ORTH[gs](state.pval.data_ptr(), state.pidx.data_ptr(),
                 state.pval.shape[1], wt.data_ptr(), state.r.data_ptr(),
                 state.Q.data_ptr(), state.R.data_ptr(), state.d.data_ptr(),
                 state.idx.data_ptr(), state.valid.data_ptr(),
                 state.active.data_ptr(), state.sel.data_ptr(),
                 state.rb.data_ptr(), _tol(tol), int(k), N, D, K, T,
                 _cuda.stream())


def _tol(tol):
    """The freeze threshold in float32; -1 disables it (rss >= 0 > -1), as
    the scalar the TPU kernel is given."""
    return float(torch.as_tensor(-1.0 if tol is None else tol,
                                 dtype=torch.float32))


def _cgs_pass(Qk, w):
    """One classical Gram-Schmidt pass batched over the samples: the
    coefficients ``c_t = q_t . w`` of the k rows of Qk [N, k, D] at once,
    and ``w - sum_t c_t q_t``."""
    c = torch.matmul(Qk, w[:, :, None])[..., 0]                 # [N, k]
    return c, w - torch.matmul(c[:, None, :], Qk)[:, 0]


def omp_orth_plain(state, wt, k, tol=None, gs="mgs"):
    """The plain version of :func:`omp_orth`, on any device: the same steps
    batched over the samples, MGS as a loop over the k live basis rows,
    CGS2 as two bulk passes over them."""
    _check_gs(gs)
    r = state.r
    N = r.shape[0]
    rows = torch.arange(N, device=r.device)
    rss = torch.sum(r * r, dim=1)
    act = (state.active > 0) & (rss > _tol(tol))
    tile = torch.argmax(state.pval, dim=1)    # the first tile of the max
    kstar = state.pidx[rows, tile].long()
    state.idx[:, k] = torch.where(act, kstar, 0).to(torch.int32)
    state.valid[:, k] = act.float()
    state.active.copy_(act.float())
    state.sel[rows, kstar] |= act.to(torch.uint8)
    actf = act.float()[:, None]
    w = wt[kstar]                                           # [N, D]
    w0n = torch.sum(w * w, dim=1)
    if gs == "cgs2":
        if r.is_cuda:
            require_fp32_matmul()
        Qk = state.Q[:, :k]
        c1, w = _cgs_pass(Qk, w)
        c2, w = _cgs_pass(Qk, w)
        state.R[:, k, :k] = (c1 + c2) * actf
    else:
        for t in range(k):
            qt = state.Q[:, t]
            cf = torch.sum(qt * w, dim=1)
            w = w - cf[:, None] * qt
            state.R[:, k, t] = cf * actf[:, 0]
    nrm2 = torch.sum(w * w, dim=1)
    pivot = torch.maximum(nrm2, 1e-12 * w0n + 1e-30)
    qk = w * torch.rsqrt(pivot)[:, None] * actf
    dk = torch.sum(qk * r, dim=1)
    state.R[:, k, k] = torch.where(act, torch.sqrt(pivot), 1.0)
    state.Q[:, k] = qk
    state.d[:, k] = dk
    state.r.copy_(r - dk[:, None] * qk)
    state.rb.copy_(torch.stack(split_bf16(state.r)))


def backsub_tier(state):
    """The K6c kernel that takes this state: 'staged' up to T = 128 (the
    live columns copied into shared memory ahead of the chain, by 16-byte
    copies where T % 4 == 0 and R is 16-byte aligned, else 4-byte ones),
    'warp' above (the first kernel, each column read from device memory
    on the chain)."""
    T = state.d.shape[1]
    if T > 128:
        return "warp"
    wide = T % 4 == 0 and state.R.data_ptr() % 16 == 0
    return f"staged, {16 if wide else 4}-byte copies"


def omp_backsub(state):
    """K6c: the codes on the support, ``R z = d`` per sample, zero where a
    slot is not valid. Returns z [N, T]."""
    if state.r.device.type == "cpu":
        return omp_backsub_plain(state)
    N, T = state.d.shape
    _cuda.check_cuda(R=state.R, d=state.d, valid=state.valid)
    z = torch.empty((N, T), dtype=torch.float32, device=state.d.device)
    OMP_BACKSUB(state.R.data_ptr(), state.d.data_ptr(),
                state.valid.data_ptr(), z.data_ptr(), N, T, _cuda.stream())
    return z


def omp_backsub_plain(state):
    """The plain version of :func:`omp_backsub`, on any device: the TPU
    kernel's column-oriented back-substitution."""
    T = state.d.shape[1]
    rhs = state.d.clone()
    z = torch.zeros_like(rhs)
    for j in range(T - 1, -1, -1):
        col = state.R[:, j]                                 # [N, T]
        zj = rhs[:, j] / col[:, j]
        z[:, j] = zj
        rhs[:, :j] = rhs[:, :j] - zj[:, None] * col[:, :j]
    return torch.where(state.valid > 0, z, 0.0)


def _check_gs(gs):
    if gs not in ("mgs", "cgs2"):
        raise ValueError(f"gs must be 'mgs' or 'cgs2', got {gs!r}")


def _outputs(state, z_t):
    valid = state.valid > 0
    return state.idx, valid, torch.where(valid, z_t, 0.0)


def fused_omp_solve(x, weight, T, tol=None, kernel_precision="f32",
                    gs="mgs"):
    """Whole-solve OMP: greedy T-atom selection and the least-squares fit.

    x: [N, D], weight: [D, K]. Returns ``(idx, valid, z_s)``, each [N, T]:
    the support indices (int32), slot validity (False once the ``tol``
    residual stop froze the sample) and the codes on the support (zero
    where not valid). ``gs`` is the Gram-Schmidt of each step: 'mgs'
    (modified, K6b) or 'cgs2' (classical in two bulk passes, K6d). On a
    CUDA tensor each step is K6a + K6b (or K6d) on the current stream with
    no host sync, then K6c; on a CPU tensor the plain versions run. The
    TPU arguments ``interpret`` and ``profile`` have no counterpart (the
    profiling variants belong to the JAX package's roofline bench).
    """
    check_kernel_precision(kernel_precision)
    _check_gs(gs)
    K = weight.shape[1]
    if x.device.type != "cpu":
        _cuda.check_cuda(x=x, weight=weight)
        _cuda.WRAPPER_CALLS["fused_omp_solve"] += 1
    invn = inverse_norms(weight)
    wt = weight.T.contiguous()
    wsplit = select_operands(weight, kernel_precision)
    state = omp_init_state(x, K, T)
    for k in range(T):
        omp_select(state, wsplit, invn, kernel_precision)
        omp_orth(state, wt, k, tol, gs)
    return _outputs(state, omp_backsub(state))


def fused_omp_solve_plain(x, weight, T, tol=None, kernel_precision="f32",
                          gs="mgs"):
    """The plain version of :func:`fused_omp_solve`, on any device: the
    plain versions of K6a, K6b and K6c in the same order."""
    check_kernel_precision(kernel_precision)
    _check_gs(gs)
    invn = inverse_norms(weight)
    wt = weight.T.contiguous()
    wsplit = select_operands(weight, kernel_precision)
    state = omp_init_state(x, weight.shape[1], T)
    for k in range(T):
        omp_select_plain(state, wsplit, invn, kernel_precision)
        omp_orth_plain(state, wt, k, tol, gs)
    return _outputs(state, omp_backsub_plain(state))
