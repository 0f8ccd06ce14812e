"""lasso_tpu_torch.ops.fused_omp and ops.batched_cholesky against lasso_tpu's
fused OMP kernel and append kernel (interpret mode) on the same numpy
inputs.

The port runs on the CPU, where the wrappers take the kernels' plain
versions. Tolerances: the fused solve by the JAX tests' equivalence rule
(tests/test_fused_omp.py:31-43): where the supports agree, codes atol 2e-4;
where a near-tie flipped an atom, the per-row rss rtol 1e-3. Both select
in the same bf16x3 split, summed in another order, so an f32 near-tie may
still part them. The append kernel row by row at rtol 2e-4 / atol 1e-5
(tests/test_omp.py:161-186).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lasso_tpu.ops import batched_cholesky as JB
from lasso_tpu.ops import fused_omp as JF
from lasso_tpu_torch.ops import batched_cholesky as TB
from lasso_tpu_torch.ops import fused_omp as TF

from _torch_port import assert_equivalent, n, omp_problem, t
from _torch_port import release_jax_after_module  # noqa: F401


def scatter(idx, z_s, k):
    z = np.zeros((idx.shape[0], k), np.float32)
    np.add.at(z, (np.arange(idx.shape[0])[:, None], idx), z_s)
    return z


@pytest.mark.parametrize("kp", ["f32", "bf16"])
@pytest.mark.parametrize("n_,d,k,T", [
    (32, 128, 256, 8),
    (130, 128, 256, 12),    # N not a multiple of 128, T of 8
    (16, 256, 128, 5),      # T not 8-aligned, K < D
])
def test_fused_plain_matches_jax(n_, d, k, T, kp):
    x, W = omp_problem(n_ + T, n_, d, k)
    ij, vj, zj = JF.fused_omp_solve(jnp.asarray(x), jnp.asarray(W), T,
                                    interpret=True, kernel_precision=kp)
    it, vt, zt = TF.fused_omp_solve(t(x), t(W), T, kernel_precision=kp)
    assert it.dtype == torch.int32 and vt.dtype == torch.bool
    assert tuple(zt.shape) == (n_, T)
    np.testing.assert_array_equal(n(vt), n(vj))
    za, zb = scatter(n(ij), n(zj), k), scatter(n(it), n(zt), k)
    assert ((zb != 0).sum(axis=1) <= T).all()
    assert_equivalent(x, W, za, zb)
    # the composition of the plain versions is the CPU route itself
    ip, vp, zp = TF.fused_omp_solve_plain(t(x), t(W), T, kernel_precision=kp)
    assert torch.equal(ip, it) and torch.equal(vp, vt) and torch.equal(zp, zt)


def test_tol_freeze_and_zero_rows():
    """Zero samples freeze at once (valid all False, z_s = 0); planted
    3-sparse samples freeze after 3 atoms; the freeze matches JAX's slot
    by slot."""
    x, W = omp_problem(7, 48, 128, 256)
    z_true = np.zeros((48, 256), np.float32)
    z_true[4:12, :3] = np.random.default_rng(0).standard_normal((8, 3))
    x[4:12] = z_true[4:12] @ W.T
    x[:4] = 0.0
    ij, vj, zj = JF.fused_omp_solve(jnp.asarray(x), jnp.asarray(W), 16,
                                    tol=1e-6, interpret=True)
    it, vt, zt = TF.fused_omp_solve(t(x), t(W), 16, tol=1e-6)
    np.testing.assert_array_equal(n(vt), n(vj))
    assert not n(vt)[:4].any() and (n(zt)[:4] == 0).all()
    np.testing.assert_array_equal(n(vt)[4:12].sum(axis=1), 3)
    assert n(vt)[12:].all()
    assert_equivalent(x, W, scatter(n(ij), n(zj), 256),
                      scatter(n(it), n(zt), 256))
    # without tol a zero row selects atoms but solves to exactly zero
    _, v0, z0 = TF.fused_omp_solve(t(x[:4]), t(W), 6)
    assert n(v0).all() and (n(z0) == 0).all()


def test_selection_partials_take_the_first_maximum():
    """K6a's tile partials and K6b's reduction give the first maximum of
    the masked scores, as torch.argmax and jnp.argmax: exact ties across
    tiles and inside a tile go to the lowest atom, selected atoms score -1,
    and a zero atom scores 0."""
    K = 384
    W = np.zeros((128, K), np.float32)
    W[1:, 256:] = np.eye(127, 128, dtype=np.float32)   # e_1 .. e_127
    W[0, [5, 130, 383]] = 1.0          # copies of e_0 in the three tiles
    W[0, 7] = -1.0                     # a tie inside tile 0, after atom 5
    x = np.zeros((2, 128), np.float32)
    x[:, 0] = 2.0
    x[1, 1] = 3.0                      # row 1 prefers atom 256 (e_1)
    state = TF.omp_init_state(t(x), K, 2)
    state.sel[0, 5] = 1                # atom 5 already selected in row 0
    TF.omp_select(state, TF.select_operands(t(W)), TF.inverse_norms(t(W)))
    np.testing.assert_array_equal(n(state.pidx), [[7, 130, 383],
                                                  [5, 130, 256]])
    np.testing.assert_array_equal(n(state.pval), [[2, 2, 2], [2, 2, 3]])
    TF.omp_orth(state, t(W.T.copy()), 0)
    np.testing.assert_array_equal(n(state.idx)[:, 0], [7, 256])
    np.testing.assert_array_equal(np.nonzero(n(state.sel)), [[0, 0, 1],
                                                             [5, 7, 256]])


def test_append_plain_matches_jax_row_by_row(rng):
    """Appending the rows of random PD systems one at a time: the plain
    version against JAX's interpret-mode kernel and dense solves of every
    leading block, in place through ``out=``, with untouched slots exactly
    zero."""
    T, B = 16, 8
    A = rng.standard_normal((B, T, T)).astype(np.float32)
    M = A @ np.swapaxes(A, 1, 2) + T * np.eye(T, dtype=np.float32)[None]
    rhs = rng.standard_normal((B, T)).astype(np.float32)
    Vj = jnp.broadcast_to(jnp.eye(T, dtype=jnp.float32)[:, :, None],
                          (T, T, B))
    Vt = torch.eye(T)[:, :, None].repeat(1, 1, B)
    for k in range(T):
        g = np.zeros((T, B), np.float32)
        g[:k + 1] = M[:, k, :k + 1].T
        b = np.zeros((T, B), np.float32)
        b[:k + 1] = rhs[:, :k + 1].T
        Vj, zj = JB.cholesky_append_solve_lanes(Vj, jnp.asarray(g),
                                                jnp.asarray(b), k,
                                                interpret=True)
        V_new, zt = TB.cholesky_append_solve_lanes(Vt, t(g), t(b), k, out=Vt)
        assert V_new is Vt
        np.testing.assert_allclose(n(zt), n(zj), rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(n(Vt), n(Vj), rtol=2e-4, atol=1e-5)
        for s in range(B):
            ref = np.linalg.solve(M[s, :k + 1, :k + 1], rhs[s, :k + 1])
            np.testing.assert_allclose(n(zt)[:k + 1, s], ref, rtol=2e-4,
                                       atol=1e-5)
        if k + 1 < T:
            assert np.abs(n(zt)[k + 1:]).max() == 0.0


def test_append_dependent_row_and_identity_append():
    """A linearly dependent append hits the relative pivot floor (finite,
    as JAX's kernel); an identity append leaves the factor's solution as
    it was (the frozen samples of OMP)."""
    T, B = 8, 3
    g0 = np.zeros((T, B), np.float32)
    g0[0] = 1.0
    b = np.zeros((T, B), np.float32)
    b[0] = 0.5
    V = torch.eye(T)[:, :, None].repeat(1, 1, B)
    V, z0 = TB.cholesky_append_solve_lanes(V, t(g0), t(b), 0)
    g1 = np.zeros((T, B), np.float32)
    g1[:2] = 1.0                                 # a duplicate of atom 0
    b1 = b.copy()
    b1[1] = 0.5
    Vj = jnp.asarray(n(V))
    _, zj = JB.cholesky_append_solve_lanes(Vj, jnp.asarray(g1),
                                           jnp.asarray(b1), 1, interpret=True)
    V1, z1 = TB.cholesky_append_solve_lanes(V, t(g1), t(b1), 1)
    assert np.isfinite(n(z1)).all() and np.isfinite(n(V1)).all()
    np.testing.assert_allclose(n(z1), n(zj), rtol=2e-4, atol=1e-5)
    e1 = np.zeros((T, B), np.float32)
    e1[1] = 1.0
    _, z_id = TB.cholesky_append_solve_lanes(V, t(e1), t(b), 1)
    np.testing.assert_array_equal(n(z_id), n(z0))


def test_supports_match_jax():
    for (n_, d, k, T) in ((16, 128, 256, 8), (16, 100, 256, 8),
                          (16, 128, 200, 8), (130, 512, 2048, 64)):
        assert (TF.supports_fused_omp(n_, d, k, T, torch.float32)
                == JF.supports_fused_omp(n_, d, k, T, jnp.float32))
    assert not TF.supports_fused_omp(16, 128, 256, 8, torch.float64)
    assert not TF.supports_fused_omp(16, TF._MAX_D + 128, 256, 8,
                                     torch.float32)
    for (T, B) in ((8, 16), (12, 16), (64, 16384)):
        assert (TB.supports_lanes_append(T, B, torch.float32)
                == JB.supports_lanes_append(T, B, jnp.float32))
    assert not TB.supports_lanes_append(TB._MAX_T + 8, 4, torch.float32)


def test_options_and_other_devices_raise():
    x, W = omp_problem(0, 4, 128, 128)
    with pytest.raises(ValueError, match="gs"):
        TF.fused_omp_solve(t(x), t(W), 4, gs="qr")
    with pytest.raises(ValueError, match="kernel_precision"):
        TF.fused_omp_solve(t(x), t(W), 4, kernel_precision="mixed")
    meta = torch.zeros((4, 128), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        TF.fused_omp_solve(meta, torch.zeros((128, 128), device="meta"), 4)
    V = torch.zeros((8, 8, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        TB.cholesky_append_solve_lanes(V, V[0], V[0], 0)
    with pytest.raises(ValueError, match="outside"):
        TB.cholesky_append_solve_lanes(torch.zeros((8, 8, 4)),
                                       torch.zeros((8, 4)),
                                       torch.zeros((8, 4)), 8)
