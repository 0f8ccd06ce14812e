"""lasso_tpu_torch.ops.fused_ista's 'f32', now the TPU kernel's bf16x3
split: the plain versions of K1 and K2 against the interpret-mode Pallas
kernels of lasso_tpu and against a float64 sum of the split products of
JAX's own ``split_bf16_xla``, on the same seeded numpy inputs as
tests/test_torch_fused_ista.py.

The port runs on the CPU, where the wrappers take the kernels' plain
versions. Tolerances: against the Pallas kernels those of
tests/test_fused_ista.py, z atol 1e-5 per step and delta rtol 1e-5 (the
split sums hi*hi, lo*hi and hi*lo in another order than JAX's three dots);
against the float64 products rtol 1e-5 / atol 1e-6, as
tests/test_torch_omp_cgs2.py holds the OMP selection. The kernels'
operands (W's split in both layouts) against JAX's split, exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lasso_tpu.ops import fused_ista as J
from lasso_tpu.ops.precision import split_bf16_xla
from lasso_tpu_torch.ops import fused_ista as T

from _torch_port import make_problem, n, t
from _torch_port import release_jax_after_module  # noqa: F401

SHAPE = (64, 256, 384)   # rows, D, K


def _f64_split(a):
    """JAX's split of f32 ``a`` as float64 (hi, lo)."""
    return tuple(np.asarray(p).astype(np.float64)
                 for p in split_bf16_xla(jnp.asarray(a)))


def _f64_product(a, b, kp):
    """``a @ b`` from JAX's split of both, in float64: hi@hi + lo@hi +
    hi@lo for 'f32', hi@hi for 'bf16'."""
    (a_hi, a_lo), (b_hi, b_lo) = _f64_split(a), _f64_split(b)
    if kp == "bf16":
        return a_hi @ b_hi
    return a_hi @ b_hi + a_lo @ b_hi + a_hi @ b_lo


@pytest.mark.parametrize("variant", ["plain", "row_nonneg_l2"])
def test_f32_step_matches_pallas(rng, variant):
    """One fused step in 'f32': both packages run the bf16x3 split."""
    x, z, zp, W = make_problem(rng, *SHAPE)
    lr, mom = 0.3, 0.6
    alpha, kw = 0.05, {}
    if variant == "row_nonneg_l2":
        alpha = (0.02 + 0.05 * rng.random((1, W.shape[1]))).astype(
            np.float32)
        kw = {"nonneg": True, "l2": 0.4}
    zj, dj = J.fused_fista_step(jnp.asarray(x), jnp.asarray(z),
                                jnp.asarray(zp), jnp.asarray(W), lr,
                                alpha, mom, block_n=8, interpret=True,
                                kernel_precision="f32", **kw)
    zt, dt = T.fused_fista_step(t(x), t(z), t(zp), t(W), lr,
                                t(alpha) if variant != "plain" else alpha,
                                mom, kernel_precision="f32", **kw)
    np.testing.assert_allclose(n(zt), n(zj), atol=1e-5)
    np.testing.assert_allclose(float(dt), float(dj), rtol=1e-5)


@pytest.mark.parametrize("variant", ["moms", "restart_row_nonneg_l2"])
def test_f32_multistep_matches_pallas(rng, variant):
    """Four sub-steps in 'f32', with per-step momenta, or with restart, a
    threshold row, nonneg and l2."""
    x, z, zp, W = make_problem(rng, *SHAPE)
    lr, steps = 0.25, 4
    moms = np.asarray([0.0, 0.4, 0.55, 0.6], np.float32)
    th, kw_j, kw_t = np.float32(0.05 * lr), {}, {}
    if variant == "restart_row_nonneg_l2":
        th = ((0.02 + 0.05 * rng.random((1, W.shape[1]))) * lr).astype(
            np.float32)
        tv = np.where(rng.random((x.shape[0], 1)) < 0.5, 0.0,
                      1.0 + 3.0 * rng.random((x.shape[0], 1))
                      ).astype(np.float32)
        kw_j = {"t_vec": jnp.asarray(tv), "nonneg": True, "l2": 0.4}
        kw_t = {"t_vec": t(tv), "nonneg": True, "l2": 0.4}
    oj = J.fused_fista_multistep(jnp.asarray(x), jnp.asarray(z),
                                 jnp.asarray(zp), jnp.asarray(W), lr,
                                 jnp.asarray(th), jnp.asarray(moms),
                                 steps=steps, block_n=8, interpret=True,
                                 kernel_precision="f32", **kw_j)
    ot = T.fused_fista_multistep(t(x), t(z), t(zp), t(W), lr, t(th),
                                 t(moms), steps, kernel_precision="f32",
                                 **kw_t)
    assert len(ot) == len(oj)
    for a, b in zip(ot[:-1], oj[:-1]):
        np.testing.assert_allclose(n(a), n(b), atol=1e-5)
    np.testing.assert_allclose(float(ot[-1]), float(oj[-1]), rtol=1e-5)


@pytest.mark.parametrize("kp", ["f32", "bf16"])
def test_plain_resid_is_the_split_product(rng, kp):
    """K1's plain version is ``y W^T - x`` of the split operands, with y
    formed in float32 as both packages form it."""
    x, z, zp, W = make_problem(rng, *SHAPE)
    mom = np.float32(0.6)
    scal = torch.tensor([0.3, 0.0, float(mom), 1.0])
    y = z + mom * (z - zp)
    want = _f64_product(y, W.T, kp) - x
    got = T.fista_resid_plain(t(x), t(z), t(zp), t(W), scal,
                              kernel_precision=kp)
    np.testing.assert_allclose(n(got), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kp", ["f32", "bf16"])
def test_plain_gradient_is_the_split_product(rng, kp):
    """K2's plain version takes ``r W`` of the split operands: with z =
    z_prev = 0, lr = -1, no threshold and scale 1 its z_next is the
    gradient itself."""
    x, z, _, W = make_problem(rng, *SHAPE)
    r = (x + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
    zero = torch.zeros(z.shape)
    scal = torch.tensor([-1.0, 0.0, 0.0, 1.0])
    got, _, _ = T.fista_grad_prox_plain(t(r), zero, zero, t(W), scal,
                                        kernel_precision=kp)
    np.testing.assert_allclose(n(got), _f64_product(r, W, kp), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("kp", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(37, 45, 301), SHAPE],
                         ids=["ragged", "aligned"])
def test_operands_are_jax_split_padded(shape, kp):
    """The kernels' operands: W's split [P, D128, K64] and W^T's [P, K128,
    D64], equal to JAX's split of W and zero past it; the residual's split
    [P, N, D64] filled from a residual the same way, zero past D."""
    rows, d, k = shape
    rng = np.random.default_rng(rows)
    x, _, _, W = make_problem(rng, rows, d, k)
    ops = T.fista_operands(t(W), rows, kp)
    parts = 2 if kp == "f32" else 1
    up = lambda v, m: -(-v // m) * m
    assert tuple(ops.w.shape) == (parts, up(d, 128), up(k, 64))
    assert tuple(ops.wt.shape) == (parts, up(k, 128), up(d, 64))
    assert tuple(ops.rb.shape) == (parts, rows, up(d, 64))
    assert ops.w.dtype == ops.wt.dtype == ops.rb.dtype == torch.bfloat16
    for p, want in enumerate(_f64_split(W)[:parts]):
        np.testing.assert_array_equal(n(ops.w[p, :d, :k].double()), want)
        np.testing.assert_array_equal(n(ops.wt[p, :k, :d].double()), want.T)
    assert not ops.w[:, d:].any() and not ops.w[:, :, k:].any()
    assert not ops.wt[:, k:].any() and not ops.wt[:, :, d:].any()
    T._fill_resid_split(ops, t(x), kp)
    for p, want in enumerate(_f64_split(x)[:parts]):
        np.testing.assert_array_equal(n(ops.rb[p, :, :d].double()), want)
    assert not ops.rb[:, :, d:].any()
