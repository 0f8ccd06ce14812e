"""lasso_tpu_torch.ops.fused_ista: the plain versions of the CUDA kernels
against the interpret-mode Pallas kernels of lasso_tpu (the CUDA kernels
themselves are held against the plain versions in test_torch_gpu.py).

Tolerances are those of tests/test_fused_ista.py: z atol 1e-5 (f32) /
5e-3 (bf16) per step, delta rtol 1e-5 / 5e-2. In f32 both packages run the
TPU kernel's bf16x3 split (hi*hi + lo*hi + hi*lo, FP32 sums) and sum its
three products in another order, which is what the f32 tolerance absorbs;
in bf16 both round the same operands.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lasso_tpu.ops import fused_ista as J
from lasso_tpu_torch.ops import _cuda
from lasso_tpu_torch.ops import fused_ista as T

from _torch_port import make_problem, n, t
from _torch_port import release_jax_after_module  # noqa: F401


def _tol(kp):
    return (1e-5, 1e-5) if kp == "f32" else (5e-3, 5e-2)


@pytest.mark.parametrize("kp", ["f32", "bf16"])
@pytest.mark.parametrize("variant", ["plain", "row_nonneg_l2"])
def test_fused_step_matches_pallas(rng, kp, variant):
    x, z, zp, W = make_problem(rng)
    lr, mom = 0.3, 0.6
    alpha, kw = 0.05, {}
    if variant == "row_nonneg_l2":
        alpha = (0.02 + 0.05 * rng.random((1, W.shape[1]))).astype(
            np.float32)
        kw = {"nonneg": True, "l2": 0.4}
    zj, dj = J.fused_fista_step(jnp.asarray(x), jnp.asarray(z),
                                jnp.asarray(zp), jnp.asarray(W), lr,
                                alpha, mom, block_n=8, interpret=True,
                                kernel_precision=kp, **kw)
    zt, dt = T.fused_fista_step(t(x), t(z), t(zp), t(W), lr,
                                t(alpha) if variant != "plain" else alpha,
                                mom, kernel_precision=kp, **kw)
    atol, rtol = _tol(kp)
    np.testing.assert_allclose(n(zt), n(zj), atol=atol)
    np.testing.assert_allclose(float(dt), float(dj), rtol=rtol)


@pytest.mark.parametrize("kp", ["f32", "bf16"])
@pytest.mark.parametrize("variant", ["moms", "restart_row_nonneg_l2"])
def test_multistep_matches_pallas(rng, kp, variant):
    x, z, zp, W = make_problem(rng)
    lr, steps = 0.25, 4
    moms = np.asarray([0.0, 0.4, 0.55, 0.6], np.float32)
    th, kw_j, kw_t = np.float32(0.05 * lr), {}, {}
    if variant == "restart_row_nonneg_l2":
        th = ((0.02 + 0.05 * rng.random((1, W.shape[1]))) * lr).astype(
            np.float32)
        # a mix of fresh (t=0) and advanced rows
        tv = np.where(rng.random((x.shape[0], 1)) < 0.5, 0.0,
                      1.0 + 3.0 * rng.random((x.shape[0], 1))
                      ).astype(np.float32)
        kw_j = {"t_vec": jnp.asarray(tv), "nonneg": True, "l2": 0.4}
        kw_t = {"t_vec": t(tv), "nonneg": True, "l2": 0.4}
    oj = J.fused_fista_multistep(jnp.asarray(x), jnp.asarray(z),
                                 jnp.asarray(zp), jnp.asarray(W), lr,
                                 jnp.asarray(th), jnp.asarray(moms),
                                 steps=steps, block_n=8, interpret=True,
                                 kernel_precision=kp, **kw_j)
    ot = T.fused_fista_multistep(t(x), t(z), t(zp), t(W), lr, t(th),
                                 t(moms), steps, kernel_precision=kp, **kw_t)
    assert len(ot) == len(oj)
    atol, rtol = _tol(kp)
    for a, b in zip(ot[:-1], oj[:-1]):
        np.testing.assert_allclose(n(a), n(b), atol=atol)
    np.testing.assert_allclose(float(ot[-1]), float(oj[-1]), rtol=rtol)
    if "t_vec" in kw_t:   # the caller's t-vector is not written
        assert not np.shares_memory(n(ot[2]), n(kw_t["t_vec"]))


def test_multistep_equals_repeated_steps(rng):
    """S sub-steps do the arithmetic of S single steps, bit for bit."""
    x, z, zp, W = make_problem(rng)
    lr, alpha = 0.25, 0.05
    moms = [0.0, 0.4, 0.55]
    zm, zpm, dm = T.fused_fista_multistep(
        t(x), t(z), t(zp), t(W), lr, alpha * np.float32(lr),
        t(np.asarray(moms, np.float32)), 3)
    zs, zps = t(z), t(zp)
    for m in moms:
        z_next, ds = T.fused_fista_step(t(x), zs, zps, t(W), lr, alpha, m)
        zps, zs = zs, z_next
    np.testing.assert_array_equal(n(zm), n(zs))
    np.testing.assert_array_equal(n(zpm), n(zps))
    assert float(dm) == float(ds)


def test_step_reference_matches_jax(rng):
    x, z, zp, W = make_problem(rng)
    zj, dj = J.fista_step_reference(jnp.asarray(x), jnp.asarray(z),
                                    jnp.asarray(zp), jnp.asarray(W),
                                    0.3, 0.05, 0.6, l2=0.2)
    zt, dt = T.fista_step_reference(t(x), t(z), t(zp), t(W), 0.3, 0.05,
                                    0.6, l2=0.2)
    np.testing.assert_allclose(n(zt), n(zj), atol=1e-5)
    np.testing.assert_allclose(float(dt), float(dj), rtol=1e-5)


def test_supports_fused_step(rng):
    x, z, _, W = make_problem(rng)
    assert T.supports_fused_step(t(x), t(z), t(W))
    assert not T.supports_fused_step(t(x[:, :100]), t(z), t(W[:100]))
    assert not T.supports_fused_step(t(x[:5]), t(z[:5]), t(W))


def test_bad_precision_raises(rng):
    x, z, zp, W = make_problem(rng)
    with pytest.raises(ValueError):
        T.fused_fista_step(t(x), t(z), t(zp), t(W), 0.1, 0.1, 0.0,
                           kernel_precision="mixed")


def test_non_cpu_tensor_never_takes_plain_version():
    """A tensor that is not on the CPU goes to the kernel route, which
    checks it and raises; it never falls back to the plain version."""
    m = torch.empty((8, 128), device="meta")
    zk = torch.empty((8, 128), device="meta")
    w = torch.empty((128, 128), device="meta")
    counts = _cuda.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        T.fused_fista_step(m, zk, zk, w, 0.1, 0.1, 0.0)
    with pytest.raises(ValueError, match="CUDA"):
        T.fused_fista_multistep(m, zk, zk, w, 0.1, 0.01, 0.0, 2)
    assert _cuda.launch_counts() == counts
