"""lasso_tpu_torch ista against lasso_tpu ista: per-sample and
per-feature alpha, restart, nonneg, l2, ISTA, per-sample tolerance and
backtracking.

Both get the same numpy inputs and an explicit lr; the port runs on the
CPU, where ``use_pallas=True`` runs the kernels' plain versions as JAX
runs its Pallas kernels in interpret mode. ``n_iter`` must be equal.
Tolerances come from tests/test_fused_ista.py: atol 1e-4 on the codes
(fused-vs-plain solve), objective rtol 1e-5 where bf16 rounding enters
('mixed', restart).
"""

import numpy as np
import pytest

from _torch_port import both, make_problem, objective
from _torch_port import release_jax_after_module  # noqa: F401


@pytest.fixture
def problem(rng):
    x, _, _, W = make_problem(rng, n=16)
    return x, W


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("form", ["per_sample", "per_feature"])
def test_vector_alpha_matches_jax(rng, problem, use_pallas, form):
    x, W = problem
    if form == "per_sample":
        alpha = (0.05 + 0.1 * rng.random(x.shape[0])).astype(np.float32)
    else:
        alpha = (0.05 + 0.1 * rng.random((1, W.shape[1]))).astype(
            np.float32)
    zj, kj, zt, kt = both(x, W, alpha, maxiter=100, tol=1e-5,
                          use_pallas=use_pallas, fuse_steps=4)
    assert kt == kj
    np.testing.assert_allclose(zt, zj, atol=1e-4)


@pytest.mark.parametrize("kp", ["f32", "mixed"])
def test_restart_matches_jax(problem, kp):
    x, W = problem
    zj, kj, zt, kt = both(x, W, maxiter=96, tol=0.0, use_pallas=True,
                          restart=True, fuse_steps=8, kernel_precision=kp)
    assert kt == kj == 96
    np.testing.assert_allclose(objective(x, W, zt, 0.1),
                               objective(x, W, zj, 0.1), rtol=1e-5)
    if kp == "f32":
        np.testing.assert_allclose(zt, zj, atol=1e-4)


@pytest.mark.parametrize("kw", [
    {"restart": True, "use_pallas": False, "tol": 1e-6, "maxiter": 300},
    {"nonneg": True, "l2": 0.3, "use_pallas": True, "fuse_steps": 8},
    {"nonneg": True, "use_pallas": False},
    {"fast": False, "use_pallas": True, "fuse_steps": 5},
    {"per_sample_tol": True, "tol": 1e-5, "maxiter": 300},
    {"backtrack": True, "lr": 1.0, "maxiter": 30},
], ids=["restart_plain", "nonneg_l2_fused", "nonneg_plain", "ista_fused",
        "per_sample_tol", "backtrack"])
def test_options_match_jax(problem, kw):
    x, W = problem
    kw = {"maxiter": 100, "tol": 1e-6, **kw}
    zj, kj, zt, kt = both(x, W, **kw)
    assert kt == kj
    np.testing.assert_allclose(zt, zj, atol=1e-4)
