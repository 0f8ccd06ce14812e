"""lasso_tpu_torch greedy coordinate descent against lasso_tpu's: the fused
step's plain version against the interpret-mode Pallas kernel, and
``coord_descent`` across its surface with equal ``n_iter``.

Inputs are made with numpy from a seed (unit-norm atoms, data scaled so
that ``|b|`` stays near 1). The port runs on the CPU, where
``use_pallas=True`` runs the kernel's plain version. Tolerances:

* ``'bf16'``: both gather rows of bf16-rounded S and update ``b`` by one
  fused multiply-add, so the iterates agree exactly (atol 0 on the
  steps, 1e-6 after a whole solve).
* ``'f32'``: the port gathers the true f32 S, the JAX kernel a bf16
  hi + lo split of it (about 2^-17 relative): steps atol 1e-5; whole
  fused solves at the objective, rtol 1e-4 (tests/
  test_coordinate_descent.py), since the split can flip an argmax
  near-tie; against JAX's unfused path, which gathers the true S too,
  z atol 1e-5.
"""

import importlib

import numpy as np
import pytest
import torch

from lasso_tpu.linear.solvers import coord_descent as jcd
from lasso_tpu.ops import fused_cd as jfused
from lasso_tpu_torch.linear.solvers import coord_descent as tcd
from lasso_tpu_torch.ops import fused_cd as tfused

from _torch_port import n, objective, t
from _torch_port import release_jax_after_module  # noqa: F401

cd_module = importlib.import_module(
    "lasso_tpu_torch.linear.solvers.coordinate_descent")


def cd_problem(rng, n_=16, d=24, k=128, scale=0.25):
    """x [n, d] (scaled), W [d, k] with unit columns, float32 numpy."""
    x = (scale * rng.standard_normal((n_, d))).astype(np.float32)
    W = rng.standard_normal((d, k)).astype(np.float32)
    W /= np.linalg.norm(W, axis=0, keepdims=True)
    return x, W


def step_operands(rng, k=256):
    x, W = cd_problem(rng, n_=32, k=k)
    b = (x @ W).astype(np.float32)
    z = np.zeros_like(b)
    act = np.ones((x.shape[0], 1), np.float32)
    act[::5] = 0.0                            # some rows inactive on entry
    S = (np.eye(k, dtype=np.float32) - W.T @ W).astype(np.float32)
    return b, z, act, S


def both_cd(x, W, alpha=0.1, z0=None, **kw):
    """coord_descent of both packages on the same inputs; returns
    (z_jax, n_iter_jax, z_port, n_iter_port)."""
    import jax.numpy as jnp
    a_j = jnp.asarray(alpha) if isinstance(alpha, np.ndarray) else alpha
    a_t = t(alpha) if isinstance(alpha, np.ndarray) else alpha
    zj, kj = jcd(jnp.asarray(x), jnp.asarray(W),
                 None if z0 is None else jnp.asarray(z0), a_j,
                 return_iters=True, **kw)
    zt, kt = tcd(t(x), t(W), t(z0), a_t, return_iters=True, **kw)
    return n(zj), int(kj), n(zt), kt


@pytest.mark.parametrize("kp", ["bf16", "f32"])
@pytest.mark.parametrize("variant", ["plain", "row_nonneg_l2"])
def test_cd_steps_plain_matches_jax_kernel(rng, kp, variant):
    import jax.numpy as jnp
    b, z, act, S = step_operands(rng)
    kw = {"alpha": 0.2}
    if variant == "row_nonneg_l2":
        kw = {"alpha": (0.05 + 0.2 * rng.random((1, 256))).astype(
            np.float32), "nonneg": True, "l2": 0.3}
    jkw = {**kw, "alpha": jnp.asarray(kw["alpha"])}
    tkw = {**kw, "alpha": t(kw["alpha"])}
    got_j = jfused.fused_cd_steps(
        jnp.asarray(b), jnp.asarray(z), jnp.asarray(act), jnp.asarray(S),
        tol_k=0.1, steps=6, block_n=8, interpret=True,
        kernel_precision=kp, **jkw)
    got_t = tfused.fused_cd_steps(t(b), t(z), t(act), t(S), tol_k=0.1,
                                  steps=6, kernel_precision=kp, **tkw)
    atol = 0.0 if kp == "bf16" else 1e-5
    for a, c in zip(got_t[:2], got_j[:2]):
        np.testing.assert_allclose(n(a), n(c), rtol=0, atol=atol)
    np.testing.assert_array_equal(n(got_t[2]), n(got_j[2]))
    assert n(got_t[2]).sum() < act.sum()     # some rows froze


def test_cd_steps_plain_matches_jax_reference(rng):
    import jax.numpy as jnp
    b, z, act, S = step_operands(rng)
    act[:] = 1.0
    got_j = jfused.cd_steps_reference(
        jnp.asarray(b), jnp.asarray(z), jnp.asarray(act), jnp.asarray(S),
        0.2, 1e-6 * 256, steps=6, l2=0.3)
    got_t = tfused.fused_cd_steps_plain(t(b), t(z), t(act), t(S), 0.2,
                                        1e-6 * 256, steps=6, l2=0.3)
    for a, c in zip(got_t[:2], got_j[:2]):
        np.testing.assert_allclose(n(a), n(c), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(n(got_t[2]), n(got_j[2]))


CASES = {
    "unfused": dict(use_pallas=False),
    "fused_bf16": dict(use_pallas=True, kernel_precision="bf16"),
    "fused_f32": dict(use_pallas=True),
    "mixed": dict(use_pallas=True, kernel_precision="mixed"),
    "per_sample_alpha": dict(use_pallas=True, kernel_precision="bf16"),
    "per_feature_nonneg_l2": dict(use_pallas=True, kernel_precision="bf16",
                                  nonneg=True, l2=0.2),
    "padded": dict(use_pallas=True, kernel_precision="bf16"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_coord_descent_matches_jax(rng, case):
    """tol > 0 so that the stopping rule (fused blocks of 8 while any row
    is active, then unfused steps) decides n_iter."""
    x, W = cd_problem(rng, k=200 if case == "padded" else 128,
                      n_=13 if case == "padded" else 16)
    alpha = 0.1
    if case == "per_sample_alpha":
        alpha = (0.1 + 0.1 * rng.random(x.shape[0])).astype(np.float32)
    elif case == "per_feature_nonneg_l2":
        alpha = (0.05 + 0.1 * rng.random((1, W.shape[1]))).astype(
            np.float32)
    zj, kj, zt, kt = both_cd(x, W, alpha, maxiter=2000, tol=1e-4,
                             **CASES[case])
    assert kt == kj < 2000
    assert zt.shape == (x.shape[0], W.shape[1])
    if case in ("fused_f32", "mixed"):
        np.testing.assert_allclose(objective(x, W, zt, alpha),
                                   objective(x, W, zj, alpha), rtol=1e-4)
    else:
        np.testing.assert_allclose(zt, zj, rtol=0, atol=1e-6)


def test_fused_f32_iterates_match_jax_unfused(rng):
    """The port's fused 'f32' path (12 blocks of 8, then 4 unfused steps)
    against JAX's unfused path, which gathers the same true S."""
    x, W = cd_problem(rng)
    zj, kj, _, _ = both_cd(x, W, maxiter=100, tol=0.0, use_pallas=False)
    zt, kt = tcd(t(x), t(W), alpha=0.1, maxiter=100, tol=0.0,
                 use_pallas=True, return_iters=True)
    assert kt == kj == 100
    np.testing.assert_allclose(n(zt), zj, rtol=0, atol=1e-5)


def test_warm_start_keeps_invariant(rng):
    """A warm start at the solution holds b = x W + z0 S: both packages
    stop after the same few touch-up steps (a small share of a cold
    start's), unfused and fused."""
    x, W = cd_problem(rng)
    for use_pallas in (False, True):
        kw = dict(maxiter=5000, tol=1e-6, use_pallas=use_pallas)
        z_star, k_cold = tcd(t(x), t(W), alpha=0.1, return_iters=True,
                             **kw)
        zj, kj, zt, kt = both_cd(x, W, z0=n(z_star), **kw)
        assert kt == kj < k_cold // 4, (kt, kj, k_cold)
        np.testing.assert_allclose(zt, zj, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kp", ["f32", "mixed"])
def test_block_structure(rng, monkeypatch, kp):
    """maxiter=100, fuse_steps=8 with tol=0: f32 runs 12 blocks and 4
    unfused steps; 'mixed' runs (75 // 8) = 9 bf16 blocks, rebuilds b,
    then 3 f32 blocks and 4 unfused steps. One host read per block."""
    x, W = cd_problem(rng)
    calls = []
    real = cd_module.fused_cd_steps

    def spy(*a, steps, kernel_precision, **kw):
        calls.append((steps, kernel_precision))
        return real(*a, steps=steps, kernel_precision=kernel_precision, **kw)

    monkeypatch.setattr(cd_module, "fused_cd_steps", spy)
    _, k = tcd(t(x), t(W), alpha=0.1, maxiter=100, tol=0.0, use_pallas=True,
               kernel_precision=kp, return_iters=True)
    assert k == 100
    want = ([(8, "f32")] * 12 if kp == "f32"
            else [(8, "bf16")] * 9 + [(8, "f32")] * 3)
    assert calls == want


def test_verbose_and_errors(rng, capsys):
    x, W = cd_problem(rng, n_=8)
    _, k = tcd(t(x), t(W), alpha=0.1, maxiter=7, tol=0.0, verbose=True,
               use_pallas=True, return_iters=True)
    lines = capsys.readouterr().out.splitlines()
    assert k == 7 and len(lines) == 7
    assert all(ln.startswith("iter ") and " - loss: " in ln for ln in lines)
    with pytest.raises(ValueError):
        tcd(t(x), t(W), alpha=0.1, kernel_precision="tf32")
    with pytest.raises(ValueError):
        tcd(t(x), t(W), torch.zeros((3, 256)), alpha=0.1)
    with pytest.raises(ValueError):
        tfused.fused_cd_steps_plain(t(x), t(x), t(x), t(W), 0.1, 0.0,
                                    kernel_precision="mixed")
