"""lasso_tpu_torch cyclic coordinate descent against lasso_tpu's: the sweep's
plain version against the interpret-mode Pallas sweep, ``coord_descent_mod``
with equal ``n_iter``, and ``sparse_encode``'s dispatch of 'cd' and
'cd-mod'.

Tolerances are those of tests/test_coordinate_descent.py for the fused
and unfused sweeps: z atol 1e-5, gap atol 1e-4 (sums taken in another
order).
"""

import numpy as np
import pytest
import torch

from lasso_tpu.linear import sparse_encode as jencode
from lasso_tpu.linear.solvers import coord_descent_mod as jcdm
from lasso_tpu.ops import fused_cd as jfused
from lasso_tpu_torch.linear import sparse_encode as tencode
from lasso_tpu_torch.linear.solvers import coord_descent_mod as tcdm
from lasso_tpu_torch.ops import fused_cd as tfused

from _torch_port import n, t
from _torch_port import release_jax_after_module  # noqa: F401


def cdm_problem(rng, n_=16, d=24, k=128):
    x = rng.standard_normal((n_, d)).astype(np.float32)
    W = rng.standard_normal((d, k)).astype(np.float32)
    W /= np.linalg.norm(W, axis=0, keepdims=True)
    return x, W


def both_cdm(x, W, z0=None, alpha=0.3, **kw):
    import jax.numpy as jnp
    zj, gj, kj = jcdm(jnp.asarray(x), jnp.asarray(W),
                      None if z0 is None else jnp.asarray(z0), alpha,
                      return_iters=True, **kw)
    zt, gt, kt = tcdm(t(x), t(W), t(z0), alpha, return_iters=True, **kw)
    return n(zj), n(gj), int(kj), n(zt), n(gt), kt


@pytest.mark.parametrize("tj", [1, tfused.SWEEP_TJ, 48])
@pytest.mark.parametrize("l2", [0.0, 0.3])
def test_sweep_plain_matches_jax_kernel(rng, l2, tj):
    """One sweep from a warm start, with converged rows and one zero atom,
    blocked over chunks of ``tj`` atoms: one atom at a time (the unblocked
    order), the kernel's chunk (through the wrapper's CPU path) and a chunk
    that does not divide K=128."""
    import jax.numpy as jnp
    x, W = cdm_problem(rng, n_=32)
    W[:, 7] = 0.0
    z = (rng.standard_normal((32, 128))
         * (rng.random((32, 128)) < 0.1)).astype(np.float32)
    R = (x - z @ W.T).astype(np.float32)
    conv = np.zeros(32, bool)
    conv[::4] = True
    nrm = (W * W).sum(0).astype(np.float32)
    got_j = jfused.fused_cd_mod_sweep(
        jnp.asarray(z), jnp.asarray(R), jnp.asarray(conv), jnp.asarray(W),
        jnp.asarray(nrm), 0.3, l2=l2, interpret=True)
    args = (t(z), t(R), t(conv), t(W), t(nrm), 0.3)
    if tj == tfused.SWEEP_TJ:
        got_t = tfused.fused_cd_mod_sweep(*args, l2=l2)
    else:
        got_t = tfused.fused_cd_mod_sweep_plain(*args, l2=l2, tj=tj)
    for a, c in zip(got_t, got_j):
        np.testing.assert_allclose(n(a), n(c), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(n(got_t[0])[conv], z[conv])
    np.testing.assert_array_equal(n(got_t[0])[:, 7], z[:, 7])


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("l2", [0.0, 0.3])
def test_coord_descent_mod_matches_jax(rng, use_pallas, l2):
    x, W = cdm_problem(rng)
    zj, gj, kj, zt, gt, kt = both_cdm(x, W, max_iter=60, tol=1e-6, l2=l2,
                                      use_pallas=use_pallas)
    assert kt == kj
    np.testing.assert_allclose(zt, zj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-4)


def test_converges_early_and_warm_start(rng):
    """A loose tol stops before max_iter with the same sweep count; a warm
    start from the result stops at once in both packages."""
    x, W = cdm_problem(rng)
    zj, gj, kj, zt, gt, kt = both_cdm(x, W, max_iter=500, tol=1e-3,
                                      use_pallas=True)
    assert kt == kj < 500
    np.testing.assert_allclose(zt, zj, rtol=0, atol=1e-5)
    zj2, _, kj2, zt2, _, kt2 = both_cdm(x, W, z0=zt, max_iter=500,
                                        tol=1e-3, use_pallas=True)
    assert kt2 == kj2 <= 2
    np.testing.assert_allclose(zt2, zj2, rtol=0, atol=1e-5)


@pytest.mark.parametrize("algorithm,kw", [
    ("cd", {"maxiter": 300, "tol": 1e-5}),
    ("cd-mod", {"max_iter": 40, "tol": 1e-5}),
])
def test_sparse_encode_dispatch(rng, algorithm, kw):
    import jax.numpy as jnp
    x, W = cdm_problem(rng)
    zj, kj = jencode(jnp.asarray(x), jnp.asarray(W), 0.3,
                     algorithm=algorithm, return_iters=True, **kw)
    zt, kt = tencode(t(x), t(W), 0.3, algorithm=algorithm, return_iters=True,
                     **kw)
    assert kt == int(kj)
    np.testing.assert_allclose(n(zt), n(zj), rtol=0, atol=1e-5)
    z_only = tencode(t(x), t(W), 0.3, algorithm=algorithm, **kw)
    assert isinstance(z_only, torch.Tensor)
    np.testing.assert_array_equal(n(z_only), n(zt))


@pytest.mark.parametrize("form", ["per_sample", "per_feature"])
def test_cd_mod_vector_alpha_through_sparse_encode(rng, form):
    """cd-mod has no native vector alpha: sparse_encode rescales rows
    (per-sample) or atoms (per-feature) in both packages."""
    import jax.numpy as jnp
    x, W = cdm_problem(rng)
    shape = (16,) if form == "per_sample" else (1, 128)
    alpha = (0.2 + 0.2 * rng.random(shape)).astype(np.float32)
    kw = dict(algorithm="cd-mod", max_iter=40, tol=1e-5, return_iters=True)
    zj, kj = jencode(jnp.asarray(x), jnp.asarray(W), jnp.asarray(alpha),
                     **kw)
    zt, kt = tencode(t(x), t(W), t(alpha), **kw)
    assert kt == int(kj)
    np.testing.assert_allclose(n(zt), n(zj), rtol=0, atol=1e-5)


def test_other_devices_raise_and_omp_is_not_ported():
    """A tensor neither on the CPU nor on a card raises in both wrappers;
    'gpsr', which raised here until it was ported, dispatches and matches
    JAX's objective within 1e-3 (tests/test_gpsr.py:66)."""
    b = torch.zeros((8, 128), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tfused.fused_cd_steps(b, b, torch.ones((8, 1), device="meta"),
                              torch.zeros((128, 128), device="meta"), 0.1,
                              0.0)
    with pytest.raises(ValueError, match="CUDA"):
        tfused.fused_cd_mod_sweep(
            b, torch.zeros((8, 4), device="meta"),
            torch.zeros((8,), dtype=torch.bool, device="meta"),
            torch.zeros((4, 128), device="meta"),
            torch.ones((128,), device="meta"), 0.1)
    x, W = cdm_problem(np.random.default_rng(3), n_=4, d=8, k=12)
    zt = n(tencode(t(x), t(W), 0.2, algorithm="gpsr"))
    zj = n(jencode(x, W, 0.2, algorithm="gpsr"))
    f_t, f_j = (0.5 * np.sum((z @ W.T - x) ** 2) + 0.2 * np.abs(z).sum()
                for z in (zt.astype(np.float64), zj.astype(np.float64)))
    assert abs(f_t - f_j) <= 1e-3 * max(1.0, abs(f_j))
