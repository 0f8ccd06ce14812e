"""lasso_tpu_torch's batched Cholesky solve against lasso_tpu's on the same
numpy inputs: the plain version of kernel K8 against the JAX package's
lane-parallel kernel in interpret mode, ``batch_cholesky_solve`` on both
routes (the kernel's and the library's) with the whole-batch LU fallback,
``cholesky_inverse`` and the ``linear.utils`` shim.

Tolerances are the JAX tests' (tests/test_linalg.py): the kernel atol 1e-5
(:150), ``batch_cholesky_solve`` atol 1e-4 with a non-PD sample (:178-181),
``cholesky_inverse`` atol 1e-3 (:66-71).
"""

import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lasso_tpu.linalg import basic as jbasic
from lasso_tpu.ops import batched_cholesky as jB
from lasso_tpu_torch import linalg as tlinalg
from lasso_tpu_torch.ops import batched_cholesky as tB

from _torch_port import n, t
from _torch_port import release_jax_after_module  # noqa: F401


def pd_systems(seed, B, D, scale=1.0):
    """A = Q Q^T + 2 I and b, as tests/test_linalg.py:140-159 draw them."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, D, D)).astype(np.float32) * scale
    A = A @ A.transpose(0, 2, 1) + 2 * np.eye(D, dtype=np.float32)
    b = rng.standard_normal((B, D)).astype(np.float32)
    return b, A


def solve64(b, A):
    return np.linalg.solve(A.astype(np.float64),
                           b.astype(np.float64)[..., None])[..., 0]


@pytest.mark.parametrize("B,D", [(16, 12), (16, 8), (9, 8), (130, 16),
                                 (5, 20)])
def test_plain_kernel_matches_jax_interpret(B, D):
    """D % 8 != 0 (the JAX package's column kernel) and D % 8 == 0 (its
    rank-8 panel kernel), B odd and past one 128-lane tile (which JAX pads
    with identity systems; the port pads nothing)."""
    b, A = pd_systems(B * 100 + D, B, D)
    xj = jB.batch_cholesky_solve_lanes(jnp.asarray(b), jnp.asarray(A),
                                       interpret=True)
    xt = tB.batch_cholesky_solve_lanes(t(b), t(A))
    assert xt.shape == (B, D) and xt.dtype == torch.float32
    np.testing.assert_allclose(n(xt), n(xj), atol=1e-5)
    np.testing.assert_allclose(n(xt), solve64(b, A), atol=1e-5)


@pytest.mark.parametrize("D", [12, 16])
def test_non_pd_gives_non_finite(D):
    """A sample that is not PD gives a non-finite x in both packages (there
    is no pivot floor); the other samples of the batch stay right."""
    b, A = pd_systems(3, 9, D)
    A[3] = -np.eye(D, dtype=np.float32)
    A[5, 2, 2] = 0.0
    A[5, 2, :2] = A[5, :2, 2] = 0.0
    A[5, 2, 3:] = A[5, 3:, 2] = 0.0
    xj = n(jB.batch_cholesky_solve_lanes(jnp.asarray(b), jnp.asarray(A),
                                         interpret=True))
    xt = n(tB.batch_cholesky_solve_lanes(t(b), t(A)))
    for x in (xj, xt):
        assert not np.isfinite(x[3]).any()
        assert not np.isfinite(x[5]).all()
    good = [0, 1, 2, 4, 6, 7, 8]
    np.testing.assert_allclose(xt[good], solve64(b[good], A[good]),
                               atol=1e-5)


@pytest.mark.parametrize("B,D", [(1, 1), (3, 100), (2, 256)])
def test_plain_kernel_at_the_gate(B, D):
    """One sample of one unknown, D = 100 (not a multiple of 8) and the
    gate's limit D = 256, against a float64 solve; both packages' gates
    take D <= 256 in float32 (the port's float64 too is refused)."""
    b, A = pd_systems(D, B, D, scale=1 / np.sqrt(D))
    xt = n(tB.batch_cholesky_solve_lanes(t(b), t(A)))
    np.testing.assert_allclose(xt, solve64(b, A), rtol=1e-4, atol=1e-5)
    for Dg in (D, 257):
        bg, Ag = np.zeros((B, Dg), np.float32), np.zeros((B, Dg, Dg),
                                                         np.float32)
        assert (tB.supports_lanes_cholesky(t(bg), t(Ag))
                == bool(jB.supports_lanes_cholesky(jnp.asarray(bg),
                                                   jnp.asarray(Ag)))
                == (Dg <= 256))
    assert not tB.supports_lanes_cholesky(t(b).double(), t(A).double())


@pytest.mark.parametrize("use_pallas", [True, False, "auto"])
def test_batch_cholesky_solve_matches_jax(use_pallas):
    """Both routes against JAX's on the same inputs (True is the kernel's
    plain version here and JAX's interpret-mode kernel; False and 'auto' on
    the CPU the library's factorization in both); one sample that is not PD
    sends the whole batch to the LU solve in both packages."""
    b, A = pd_systems(11, 16, 8)
    xj = jbasic.batch_cholesky_solve(jnp.asarray(b), jnp.asarray(A),
                                     use_pallas=use_pallas)
    xt = tlinalg.batch_cholesky_solve(t(b), t(A), use_pallas=use_pallas)
    np.testing.assert_allclose(n(xt), n(xj), atol=1e-5)
    A[0] -= 10 * np.eye(8, dtype=np.float32)          # indefinite
    xj = jbasic.batch_cholesky_solve(jnp.asarray(b), jnp.asarray(A),
                                     use_pallas=use_pallas)
    xt = tlinalg.batch_cholesky_solve(t(b), t(A), use_pallas=use_pallas)
    assert np.isfinite(n(xt)).all()
    np.testing.assert_allclose(n(xt), solve64(b, A), atol=1e-4)
    np.testing.assert_allclose(n(xt), n(xj), atol=1e-4)


def test_batch_cholesky_solve_off_the_gate():
    """D = 260 takes the library route even with use_pallas=True, as in
    JAX; a float64 batch does too, and its non-PD sample also falls back to
    LU for the whole batch."""
    b, A = pd_systems(4, 3, 260, scale=1 / np.sqrt(260))
    xj = jbasic.batch_cholesky_solve(jnp.asarray(b), jnp.asarray(A),
                                     use_pallas=True)
    xt = tlinalg.batch_cholesky_solve(t(b), t(A), use_pallas=True)
    np.testing.assert_allclose(n(xt), n(xj), atol=1e-4)
    b64, A64 = (a.astype(np.float64) for a in pd_systems(6, 3, 12))
    A64[1] = np.diag([1.0, -1.0] * 6)             # indefinite, invertible
    x64 = n(tlinalg.batch_cholesky_solve(t(b64), t(A64), use_pallas=True))
    assert x64.dtype == np.float64
    np.testing.assert_allclose(x64, solve64(b64, A64), atol=1e-10)


def test_cholesky_inverse_matches_jax():
    rng = np.random.default_rng(7)
    Q = rng.standard_normal((7, 7))
    M = (Q @ Q.T + 2 * np.eye(7)).astype(np.float32)
    inv_t = n(tlinalg.cholesky_inverse(t(M)))
    np.testing.assert_allclose(inv_t, np.linalg.inv(M), atol=1e-3)
    np.testing.assert_allclose(
        inv_t, n(jbasic.cholesky_inverse(jnp.asarray(M))), atol=1e-3)
    Mb = np.stack([M, -M])
    inv_b = n(tlinalg.cholesky_inverse(t(Mb)))
    np.testing.assert_allclose(inv_b[0], np.linalg.inv(M), atol=1e-3)
    assert np.isnan(inv_b[1]).all()
    assert np.isnan(n(jbasic.cholesky_inverse(jnp.asarray(-M)))).all()


def test_linear_utils_shim():
    """``linear.utils`` re-exports the linalg helpers as the JAX package's
    does, and they agree with JAX's on the same inputs."""
    jutils = importlib.import_module("lasso_tpu.linear.utils")
    tutils = importlib.import_module("lasso_tpu_torch.linear.utils")
    assert tutils.__all__ == jutils.__all__
    for name in tutils.__all__:
        assert getattr(tutils, name) is getattr(tlinalg, name)
    rng = np.random.default_rng(2)
    A = rng.standard_normal((12, 5)).astype(np.float32)
    rhs = rng.standard_normal((12, 2)).astype(np.float32)
    np.testing.assert_allclose(n(tutils.lstsq(t(rhs), t(A))),
                               n(jutils.lstsq(jnp.asarray(rhs),
                                              jnp.asarray(A))), atol=1e-5)
    np.testing.assert_allclose(n(tutils.ridge(t(rhs), t(A), 0.1)),
                               n(jutils.ridge(jnp.asarray(rhs),
                                              jnp.asarray(A), 0.1)),
                               atol=1e-5)
    b, S = pd_systems(5, 4, 6)
    np.testing.assert_allclose(
        n(tutils.batch_cholesky_solve(t(b), t(S))),
        n(jutils.batch_cholesky_solve(jnp.asarray(b), jnp.asarray(S))),
        atol=1e-5)
    np.testing.assert_allclose(
        n(tutils.cholesky_inverse(t(S[0]))),
        n(jutils.cholesky_inverse(jnp.asarray(S[0]))), atol=1e-3)
