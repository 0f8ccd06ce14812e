"""lasso_tpu_torch's lasso_path, screen_atoms, screened_encode and
chunked_encode(screen=True) against lasso_tpu's on the same numpy inputs
(the cases of tests/test_screening.py). Codes of converged solves atol
1e-4 (that file's tolerance), of equal-budget solves on the unfused route
atol 1e-5.

The port runs the sphere test in float64, the JAX package in float32.
The duality gap of a nearly converged point is a difference of sums of
order ||x||^2 (about 10 here), which float32 rounds within about 1e-6 of
the float64 value; the safe radius sqrt(2 gap) / alpha then differs by up
to about 1e-3. So the gaps agree at atol 1e-5, and the keep-masks
wherever the float64 score is more than 1e-2 from its threshold 1. Near
the optimum that rounding exceeds the gap itself, and a float32 test
drops atoms that are nonzero at the optimum (see
test_screen_atoms_safe_near_the_optimum).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lasso_tpu.linear import lasso_path as j_path
from lasso_tpu.linear import screen_atoms as j_screen
from lasso_tpu.linear import screened_encode as j_screened
from lasso_tpu.linear import sparse_encode as j_encode
from lasso_tpu.utils import chunked_encode as j_chunked
from lasso_tpu_torch.linear import (lasso_path, screen_atoms,
                                    screened_encode, sparse_encode)
from lasso_tpu_torch.utils import chunked_encode

from _torch_port import n, t
from _torch_port import release_jax_after_module  # noqa: F401


def make_problem(rng, nn=12, d=24, k=96):
    W = rng.standard_normal((d, k)).astype(np.float32)
    W /= np.linalg.norm(W, axis=0, keepdims=True)
    x = rng.standard_normal((nn, d)).astype(np.float32)
    return x, W


@pytest.mark.parametrize("mode,algorithm", [
    ("batched", "ista"), ("sequential", "ista"), ("batched", "group-ista"),
    ("sequential", "group-ista")])
def test_lasso_path_matches_jax(rng, mode, algorithm):
    """[A, N, K] codes in the alphas' order; the sequential mode goes from
    the largest alpha down, each solve warm-started from the last."""
    x, W = make_problem(rng, nn=8, d=32, k=64)
    alphas = [0.1, 0.5, 0.25]
    kw = dict(maxiter=80, tol=1e-6, lr=0.1)
    if algorithm == "group-ista":
        kw["groups"] = 8
    want = n(j_path(jnp.asarray(x), jnp.asarray(W), alphas,
                    algorithm=algorithm, mode=mode, **kw))
    got = n(lasso_path(t(x), t(W), alphas, algorithm=algorithm, mode=mode,
                       **kw))
    assert got.shape == (3, 8, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # each slice is the solve at its alpha
    direct = n(sparse_encode(t(x), t(W), 0.5, algorithm=algorithm, **kw))
    if mode == "batched":
        np.testing.assert_allclose(got[1], direct, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="mode"):
        lasso_path(t(x), t(W), alphas, mode="parallel")


def _score64(x, W, alpha, z):
    """The sphere test's score |w_k^T theta| + r ||w_k|| in float64."""
    x, W = x.astype(np.float64), W.astype(np.float64)
    z = np.zeros((x.shape[0], W.shape[1])) if z is None else z.astype(
        np.float64)
    R = x - z @ W.T
    theta = R / np.maximum(alpha, np.abs(R @ W).max(axis=1, keepdims=True))
    gap = np.maximum(0.5 * np.sum(R * R, 1) + alpha * np.abs(z).sum(1)
                     - 0.5 * np.sum(x * x, 1)
                     + 0.5 * np.sum((x - alpha * theta) ** 2, 1), 0.0)
    return (np.abs(theta @ W)
            + np.sqrt(2.0 * gap)[:, None] / alpha * np.linalg.norm(W, axis=0))


def test_screen_atoms_matches_jax(rng):
    """The keep-masks and gaps of the JAX package for a cold, a short and
    a longer warm start; every eliminated atom is zero at the optimum."""
    x, W = make_problem(rng)
    alpha = 2.0
    z_star = n(sparse_encode(t(x), t(W), alpha, maxiter=5000, tol=1e-10))
    kept = []
    for warm in (0, 3, 25):
        z_w = (None if warm == 0 else
               n(sparse_encode(t(x), t(W), alpha, maxiter=warm, tol=0.0)))
        keep_j, gap_j = j_screen(jnp.asarray(x), jnp.asarray(W), alpha,
                                 None if z_w is None else jnp.asarray(z_w))
        keep, gap = screen_atoms(t(x), t(W), alpha, t(z_w))
        assert keep.dtype == torch.bool and keep.shape == (12, 96)
        clear = np.abs(_score64(x, W, alpha, z_w) - 1.0) > 1e-2
        assert clear.mean() > 0.9
        np.testing.assert_array_equal(n(keep)[clear], n(keep_j)[clear])
        np.testing.assert_allclose(n(gap), n(gap_j), rtol=1e-4, atol=1e-5)
        assert np.all(n(gap) >= 0)
        assert np.all(np.abs(z_star)[~n(keep)] <= 1e-5)
        kept.append(int(n(keep).sum()))
    assert kept[2] <= kept[0]


def test_screen_atoms_safe_near_the_optimum(rng):
    """From a nearly converged warm point at D=512 an active atom is kept
    only by a radius of about 1e-4, from a gap below float32's rounding of
    the residual terms. The float64 test keeps every atom that is nonzero
    at the optimum (the JAX package's float32 test drops 15 of the 48
    here)."""
    x, W = make_problem(rng, nn=16, d=512, k=1024)
    alpha = 3.0
    z_star = n(sparse_encode(t(x), t(W), alpha, maxiter=4000, tol=0.0))
    z_w = sparse_encode(t(x), t(W), alpha, maxiter=300, tol=0.0)
    keep, gap = screen_atoms(t(x), t(W), alpha, z_w)
    live = np.abs(z_star) > 1e-6
    assert live.sum() > 20 and float(gap.max()) < 1e-3
    assert not (live & ~n(keep)).any()


def test_screened_encode_matches_jax(rng):
    x, W = make_problem(rng)
    alpha = 2.0
    kw = dict(warm_iters=25, bucket=16, maxiter=3000, tol=1e-9)
    zj, info_j = j_screened(jnp.asarray(x), jnp.asarray(W), alpha, **kw)
    z, info = screened_encode(t(x), t(W), alpha, **kw)
    # an atom on the boundary of the sphere test may be kept by one
    # package and not the other (module docstring); the codes agree
    assert info["screened"] and info_j["screened"]
    assert info["K"] == 96 and abs(info["kept"] - info_j["kept"]) <= 1, (
        info, info_j)
    np.testing.assert_allclose(info["gap_max"], info_j["gap_max"],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(n(z), n(zj), rtol=0, atol=1e-4)
    z_full = n(sparse_encode(t(x), t(W), alpha, maxiter=3000, tol=1e-9))
    np.testing.assert_allclose(n(z), z_full, rtol=0, atol=1e-4)


def test_screened_encode_fallback_at_low_alpha(rng):
    """Low alpha: the union keeps about every atom and the full-K solve
    runs, warm-started; near alpha 0 the minimizer is a set, so the
    objectives are compared (rtol 1e-5, as tests/test_screening.py)."""
    x, W = make_problem(rng)
    kw = dict(warm_iters=10, maxiter=8000, tol=1e-10)
    zj, info_j = j_screened(jnp.asarray(x), jnp.asarray(W), 0.01, **kw)
    z, info = screened_encode(t(x), t(W), 0.01, **kw)
    assert not info["screened"] and not info_j["screened"]
    assert info["kept"] == info_j["kept"]

    def obj(z):
        z = np.asarray(z, np.float64)
        r = z @ W.T.astype(np.float64) - x
        return 0.5 * np.sum(r * r) + 0.01 * np.sum(np.abs(z))

    np.testing.assert_allclose(obj(n(z)), obj(n(zj)), rtol=1e-5)
    z_full = j_encode(jnp.asarray(x), jnp.asarray(W), 0.01, maxiter=8000,
                      tol=1e-10)
    np.testing.assert_allclose(obj(n(z)), obj(n(z_full)), rtol=1e-5)


def test_chunked_encode_with_screening(rng):
    """chunked_encode(screen=True) routes each chunk through
    screened_encode (screen_kwargs forwarded) and matches the unscreened
    result and JAX's; it needs a scalar alpha."""
    x, W = make_problem(rng, nn=40)
    alpha = 2.0
    kw = dict(chunk_size=16, maxiter=2000, tol=1e-9)
    skw = dict(screen=True, screen_kwargs=dict(warm_iters=25, bucket=16))
    z_plain = chunked_encode(x, W, alpha=alpha, device="cpu", **kw)
    z_scr = chunked_encode(x, W, alpha=alpha, device="cpu", **kw, **skw)
    np.testing.assert_allclose(z_scr, z_plain, rtol=0, atol=1e-4)
    want = j_chunked(x, W, alpha=alpha, **kw, **skw)
    np.testing.assert_allclose(z_scr, np.asarray(want), rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="scalar alpha"):
        chunked_encode(x, W, alpha=np.full(40, 2.0, np.float32),
                       device="cpu", **kw, **skw)
