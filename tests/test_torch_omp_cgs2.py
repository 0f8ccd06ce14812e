"""lasso_tpu_torch.ops.fused_omp's two-pass classical Gram-Schmidt
(``gs='cgs2'``, kernel K6d on the card) and its bf16x3 selection product
(K6a) against lasso_tpu's fused OMP kernel in interpret mode, on the same
numpy inputs.

The port runs on the CPU, where the wrappers take the kernels' plain
versions. Tolerances: the fused solve by the JAX tests' equivalence rule
(tests/test_fused_omp.py:31-43): where the supports agree, codes atol
2e-4; where a near-tie flipped an atom, the per-row rss rtol 1e-3;
validity equal. With duplicated atoms the split of weight across a
dependent pair follows the pivot floor's rounding, so the codes are held
to be finite and the per-row rss to rtol 1e-3 on every row. cgs2 against
mgs by tests/test_fused_omp.py:150-167: validity equal, more than 90% of
the supports equal, per-row rss rtol 1e-4 / atol 1e-5. The selection
partials against a float64 sum of the three bf16x3 products of JAX's own
split (``split_bf16_xla``) at rtol 1e-5 / atol 1e-6, the kernels' partial
tolerance on the card.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lasso_tpu.ops import fused_omp as JF
from lasso_tpu.ops.precision import split_bf16_xla
from lasso_tpu_torch.ops import fused_omp as TF

from _torch_port import assert_equivalent, n, omp_problem, rss, t
from _torch_port import release_jax_after_module  # noqa: F401


def scatter(idx, z_s, k):
    z = np.zeros((idx.shape[0], k), np.float32)
    np.add.at(z, (np.arange(idx.shape[0])[:, None], idx), z_s)
    return z


def planted(seed, n_, d, k):
    """omp_problem with 8 rows exactly 3-sparse (they freeze at step 3
    under tol) and 4 zero rows (frozen at step 0)."""
    x, W = omp_problem(seed, n_, d, k)
    z = np.zeros((8, k), np.float32)
    z[:, 3:6] = np.random.default_rng(seed + 1).standard_normal((8, 3))
    x[:8] = z @ W.T
    x[8:12] = 0.0
    return x, W


def solve_both(x, W, T, **kw):
    """(JAX codes, JAX validity, port codes, port validity) of cgs2."""
    k = W.shape[1]
    ij, vj, zj = JF.fused_omp_solve(jnp.asarray(x), jnp.asarray(W), T,
                                    interpret=True, gs="cgs2", **kw)
    it, vt, zt = TF.fused_omp_solve(t(x), t(W), T, gs="cgs2", **kw)
    assert it.dtype == torch.int32 and tuple(zt.shape) == (x.shape[0], T)
    return (scatter(n(ij), n(zj), k), n(vj), scatter(n(it), n(zt), k),
            n(vt))


@pytest.mark.parametrize("kp", ["f32", "bf16"])
@pytest.mark.parametrize("n_,d,k,T", [
    (32, 128, 256, 8),
    (130, 128, 256, 12),    # N not a multiple of 128, T not of 8
])
def test_cgs2_plain_matches_jax(n_, d, k, T, kp):
    x, W = omp_problem(n_ + 3 * T, n_, d, k)
    za, va, zb, vb = solve_both(x, W, T, kernel_precision=kp)
    np.testing.assert_array_equal(vb, va)
    assert ((zb != 0).sum(axis=1) <= T).all()
    assert_equivalent(x, W, za, zb)
    # the CPU route is the composition of the plain versions
    ip, vp, zp = TF.fused_omp_solve_plain(t(x), t(W), T, gs="cgs2",
                                          kernel_precision=kp)
    it, vt, zt = TF.fused_omp_solve(t(x), t(W), T, gs="cgs2",
                                    kernel_precision=kp)
    assert torch.equal(ip, it) and torch.equal(vp, vt) and torch.equal(zp, zt)


@pytest.mark.parametrize("kp", ["f32", "bf16"])
def test_cgs2_tol_freeze_matches_jax(kp):
    """Zero rows freeze at step 0 and planted 3-sparse rows at step 3,
    slot for slot as in JAX's cgs2 kernel."""
    x, W = planted(5, 48, 128, 256)
    za, va, zb, vb = solve_both(x, W, 16, tol=1e-6, kernel_precision=kp)
    np.testing.assert_array_equal(vb, va)
    assert not vb[8:12].any() and (zb[8:12] == 0).all()
    np.testing.assert_array_equal(vb[:8].sum(axis=1), 3)
    assert vb[12:].all()
    assert_equivalent(x, W, za, zb)


def test_cgs2_duplicated_atoms_match_jax():
    """Every atom duplicated: the pivot floor keeps the cgs2 solve finite,
    with JAX's per-row residual."""
    rng = np.random.default_rng(3)
    W = rng.standard_normal((128, 128)).astype(np.float32)
    W[:, 64:] = W[:, :64]
    W /= np.linalg.norm(W, axis=0, keepdims=True)
    x = rng.standard_normal((16, 128)).astype(np.float32)
    za, va, zb, vb = solve_both(x, W, 12)
    np.testing.assert_array_equal(vb, va)
    assert np.isfinite(zb).all()
    assert rss(x, zb, W).mean() < np.sum(x * x, axis=1).mean()
    np.testing.assert_allclose(rss(x, zb, W), rss(x, za, W), rtol=1e-3)


@pytest.mark.parametrize("kp", ["f32", "bf16"])
def test_cgs2_matches_mgs(kp):
    """The port's cgs2 against its mgs, by the thresholds of the JAX
    package's own test of the two."""
    x, W = omp_problem(99, 64, 128, 256)
    ia, va, za = TF.fused_omp_solve(t(x), t(W), 12, kernel_precision=kp)
    ib, vb, zb = TF.fused_omp_solve(t(x), t(W), 12, gs="cgs2",
                                    kernel_precision=kp)
    np.testing.assert_array_equal(n(va), n(vb))
    assert (n(ia) == n(ib)).all(axis=1).mean() > 0.9
    np.testing.assert_allclose(rss(x, scatter(n(ib), n(zb), 256), W),
                               rss(x, scatter(n(ia), n(za), 256), W),
                               rtol=1e-4, atol=1e-5)


def test_cgs2_step_writes_both_passes_coefficients():
    """One K6d step from a state after two steps: R's column k holds
    c1 + c2, q_k is orthogonal to the earlier rows and of unit norm, and
    r is orthogonal to every q."""
    x, W = omp_problem(4, 16, 128, 256)
    state = TF.omp_init_state(t(x), 256, 4)
    wsplit = TF.select_operands(t(W))
    invn, wt = TF.inverse_norms(t(W)), t(W.T.copy())
    for k in range(3):
        TF.omp_select(state, wsplit, invn)
        TF.omp_orth(state, wt, k, gs="cgs2")
    Q = n(state.Q)[:, :3].astype(np.float64)
    gram = np.einsum("ntd,nsd->nts", Q, Q)
    np.testing.assert_allclose(gram, np.broadcast_to(np.eye(3), gram.shape),
                               atol=1e-6)
    w = W.T[n(state.idx)[:, 2]].astype(np.float64)
    c = np.einsum("ntd,nd->nt", Q[:, :2], w)
    np.testing.assert_allclose(n(state.R)[:, 2, :2], c, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(np.einsum("ntd,nd->nt", Q, n(state.r)), 0,
                               atol=1e-5)


@pytest.mark.parametrize("n_,d,k", [(40, 128, 384), (7, 256, 128)])
def test_select_plain_is_the_jax_split_product(n_, d, k):
    """K6a's plain f32 partials are the TPU kernel's bf16x3 product:
    r_hi W_hi + r_lo W_hi + r_hi W_lo, with r and W^T split by JAX's
    ``split_bf16_xla``, summed in float64 here; with two selected atoms
    masked to -1. The bf16 partials are the product of JAX's bf16 hi
    parts."""
    x, W = omp_problem(n_ + k, n_, d, k)
    state = TF.omp_init_state(t(x), k, 2)
    state.sel[:, 1] = 1
    state.sel[3, 200 % k] = 1
    invn = TF.inverse_norms(t(W))
    f64 = lambda a: np.asarray(a).astype(np.float64)
    r_hi, r_lo = (f64(a) for a in split_bf16_xla(jnp.asarray(x)))
    w_hi, w_lo = (f64(a).T for a in split_bf16_xla(jnp.asarray(W.T)))
    for kp, c in (("f32", r_hi @ w_hi + r_lo @ w_hi + r_hi @ w_lo),
                  ("bf16", r_hi @ w_hi)):
        score = np.where(n(state.sel) > 0, -1.0,
                         np.abs(c) * n(invn).astype(np.float64))
        tiles = score.reshape(n_, k // 128, 128)
        TF.omp_select(state, TF.select_operands(t(W), kp), invn, kp)
        np.testing.assert_allclose(n(state.pval), tiles.max(axis=2),
                                   rtol=1e-5, atol=1e-6)
        got = np.take_along_axis(tiles, (n(state.pidx) % 128)[..., None],
                                 axis=2)[..., 0]
        np.testing.assert_allclose(got, tiles.max(axis=2), rtol=1e-5,
                                   atol=1e-6)
        assert (n(state.pidx) // 128 == np.arange(k // 128)).all()
