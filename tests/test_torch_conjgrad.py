"""lasso_tpu_torch's conjugate gradient and line searches against
lasso_tpu's, on the same numpy inputs.

Tolerances are those of tests/test_linalg.py: CG solutions atol 1e-3
(:94-121, also between the two packages), the golden-section minimizer
within 1e-3 of the true one and its value within 1e-6 (:124-137). Status
codes, iteration counts and the line searches' trial counts are equal.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import lasso_tpu_torch.conjgrad as shim
from lasso_tpu.linalg import (backtracking_armijo as j_armijo, batch_cg as
                              j_batch_cg, cg as j_cg, conjgrad as j_conjgrad,
                              golden_section as j_golden)
from lasso_tpu.linalg.conjgrad import conjgrad_per_row as j_per_row
from lasso_tpu_torch import linalg
from lasso_tpu_torch.ops.common import INNER_ITERATIONS
from lasso_tpu_torch.linalg import (STATUS_MESSAGES, backtracking_armijo,
                                    batch_cg, cg, conjgrad, conjgrad_per_row,
                                    golden_section)

from _torch_port import n, t
from _torch_port import release_jax_after_module  # noqa: F401


def spd(seed, size=16, batch=8, ridge=0.01):
    """A shared SPD matrix [size, size] and right-hand sides [batch, size]."""
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((size, 2 * size)).astype(np.float32)
    A = (Q @ Q.T / (2 * size) + ridge * np.eye(size)).astype(np.float32)
    b = rng.standard_normal((batch, size)).astype(np.float32)
    return A, b


def row_dot_j(u, v):
    return jnp.sum(u * v, axis=1, keepdims=True)


def row_dot_t(u, v):
    return torch.sum(u * v, dim=1, keepdim=True)


# name -> (operator: 'spd' | 'zero' | 'negative', conjgrad keywords, status)
STATUS_CASES = {
    "abs_tol": ("spd", dict(rtol=1e-6, tol=1e-3), 0),
    "rel_tol": ("spd", dict(rtol=1e-1), 1),
    "curvature_converged": ("zero", dict(rtol=0.0), 2),
    "negative_curvature_fallback": ("negative", dict(rtol=0.0), 3),
    "maxiter_verbose": ("spd", dict(maxiter=3, rtol=0.0, verbose=2), 4),
}


@pytest.mark.parametrize("case", list(STATUS_CASES))
def test_conjgrad_status_matches_jax(case, capsys):
    """Each status code on the same system in both packages, with the
    same solution; a negative curvature at the first iteration takes the
    steepest-descent step; verbose=2 prints a line an iteration and the
    status message; the iterations are counted as they run."""
    op, kw, want = STATUS_CASES[case]
    A, b = spd(0)
    mat = {"spd": A, "zero": np.zeros_like(A),
           "negative": -np.eye(16, dtype=np.float32)}[op]
    Aj, At = jnp.asarray(mat), t(mat)
    xj, sj = j_conjgrad(jnp.asarray(b), lambda v: v @ Aj.T, row_dot_j,
                        return_status=True, **kw)
    capsys.readouterr()
    before = INNER_ITERATIONS["conjgrad"]
    xt, st = conjgrad(t(b), lambda v: v @ At.T, row_dot_t,
                      return_status=True, **kw)
    out = capsys.readouterr().out
    ran = INNER_ITERATIONS["conjgrad"] - before
    assert ran == kw.get("maxiter", ran) and ran >= 1
    assert st == int(sj) == want
    np.testing.assert_allclose(n(xt), n(xj), atol=1e-3)
    if op == "negative":
        # -rs / curv * b with curv = -rs: x = b
        np.testing.assert_allclose(n(xt), b, atol=1e-6)
    if kw.get("verbose"):
        lines = out.splitlines()
        assert len(lines) == kw["maxiter"] + 1
        assert lines[0].startswith("iter: 0 - rs: ")
        assert lines[-1] == "CG: " + STATUS_MESSAGES[4]
    x_only = conjgrad(t(b), lambda v: v @ At.T, row_dot_t, **kw)
    assert torch.equal(x_only, xt)


def per_row_systems(seed, singular):
    """Per-row SPD systems [B, n, n]; with ``singular`` row 0's matrix has
    a null direction that its right-hand side has a part along."""
    rng = np.random.default_rng(seed)
    B, m = 6, 10
    Q = rng.standard_normal((B, m, 2 * m)).astype(np.float32)
    A = np.einsum("bij,bkj->bik", Q, Q) / (2 * m)
    A = (A + 0.05 * np.eye(m)).astype(np.float32)
    if singular:
        Q0 = rng.standard_normal((m, m - 3)).astype(np.float32)
        A[0] = Q0 @ Q0.T / m
    b = rng.standard_normal((B, m)).astype(np.float32)
    x0 = (0.1 * rng.standard_normal((B, m))).astype(np.float32)
    return A, b, x0


@pytest.mark.parametrize("case", ["cold", "warm", "singular_row"])
def test_conjgrad_per_row_matches_jax(case):
    """Per-row stops, the warm start and a singular row: both packages
    return the same (best-residual) iterates, all finite; the regular
    rows solve their systems."""
    A, b, x0 = per_row_systems(1, case == "singular_row")
    warm = x0 if case == "warm" else None
    Aj, At = jnp.asarray(A), t(A)
    kw = dict(maxiter=40, tol=1e-6)
    xj = j_per_row(jnp.asarray(b),
                   lambda v: jnp.einsum("bij,bj->bi", Aj, v), row_dot_j,
                   x0=None if warm is None else jnp.asarray(warm), **kw)
    xt = conjgrad_per_row(t(b), lambda v: torch.einsum("bij,bj->bi", At, v),
                          row_dot_t, x0=t(warm), **kw)
    assert bool(torch.isfinite(xt).all())
    np.testing.assert_allclose(n(xt), n(xj), atol=1e-3)
    first = 1 if case == "singular_row" else 0
    want = np.linalg.solve(A[first:].astype(np.float64),
                           b[first:, :, None].astype(np.float64))[..., 0]
    np.testing.assert_allclose(n(xt)[first:], want, atol=1e-3)


def test_cg_and_batch_cg_match_jax_and_numpy():
    """Single-vector and shared-matrix batched CG against a float64 solve
    and against JAX (tests/test_linalg.py:94-111), and the exports."""
    A, b = spd(2)
    x = cg(t(A), t(b[0]), maxiter=200, tol=1e-10, rtol=1e-12)
    want = np.linalg.solve(A.astype(np.float64), b[0].astype(np.float64))
    np.testing.assert_allclose(n(x), want, atol=1e-3)
    np.testing.assert_allclose(
        n(x), n(j_cg(jnp.asarray(A), jnp.asarray(b[0]), maxiter=200,
                     tol=1e-10, rtol=1e-12)), atol=1e-3)
    xb = batch_cg(t(A), t(b), maxiter=300, tol=1e-10, rtol=1e-12)
    want_b = np.linalg.solve(A.astype(np.float64), b.T.astype(np.float64)).T
    np.testing.assert_allclose(n(xb), want_b, atol=1e-3)
    np.testing.assert_allclose(
        n(xb), n(j_batch_cg(jnp.asarray(A), jnp.asarray(b), maxiter=300,
                            tol=1e-10, rtol=1e-12)), atol=1e-3)
    assert (shim.conjgrad, shim.cg, shim.batch_cg) == (conjgrad, cg,
                                                        batch_cg)
    assert shim.STATUS_MESSAGES is STATUS_MESSAGES
    assert {"conjgrad", "conjgrad_per_row", "golden_section",
            "backtracking_armijo"} <= set(linalg.__all__)


@pytest.mark.parametrize("case", ["scalar", "per_element"])
def test_golden_section_matches_jax(case):
    """The scalar search finds a quadratic's minimum (test_linalg.py:124-
    130); the per-element search runs one search a lane; both equal
    JAX's and run in the default float dtype."""
    if case == "scalar":
        fn_t = lambda s: (s - 2.5) ** 2 + 1.0
        fn_j = fn_t
        lo = 0.0
        want_t, want_f = 2.5, 1.0
    else:
        c = np.linspace(0.3, 9.1, 7).astype(np.float32)
        fn_t = lambda s: torch.cos(s - t(c)) * -1.0 + 0.5 * (s - t(c)) ** 2
        fn_j = lambda s: -jnp.cos(s - jnp.asarray(c)) + 0.5 * (
            s - jnp.asarray(c)) ** 2
        lo = np.zeros(7, np.float64)
        want_t, want_f = c, -1.0
    scalar = case == "scalar"
    tt, ft = golden_section(fn_t, lo if scalar else t(lo), 10.0)
    tj, fj = j_golden(fn_j, lo if scalar else jnp.asarray(lo), 10.0)
    assert tt.dtype == torch.float32
    np.testing.assert_allclose(n(tt), want_t, atol=1e-3)
    np.testing.assert_allclose(n(ft), want_f, atol=1e-6)
    np.testing.assert_allclose(n(tt), n(tj), atol=1e-6)
    np.testing.assert_allclose(n(ft), n(fj), atol=1e-6)


def test_backtracking_armijo_matches_jax():
    """The sufficient-decrease search takes the same number of trials and
    the same step as JAX's, and stops at maxiter without one; its trials
    are counted as they run."""
    f = lambda s: (s - 0.3) ** 2
    slope = lambda s: s * 0.6
    for kw in ({}, {"maxiter": 4}):
        before = INNER_ITERATIONS["backtracking_armijo"]
        tt, kt = backtracking_armijo(f, f(0.0), slope, 5.0, **kw)
        assert INNER_ITERATIONS["backtracking_armijo"] - before == kt
        tj, kj = j_armijo(f, f(0.0), slope, 5.0, **kw)
        assert kt == int(kj)
        np.testing.assert_allclose(float(tt), float(tj), rtol=1e-6)
    assert kt == 4
