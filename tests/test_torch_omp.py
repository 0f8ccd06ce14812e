"""lasso_tpu_torch's orthogonal_matching_pursuit against lasso_tpu's on the
same numpy inputs, and its dispatch through sparse_encode, chunked_encode
and the CLI.

The port runs on the CPU, where 'fused' (with ``use_pallas=True``) and
'chol' run the kernels' plain versions and JAX runs its kernels in
interpret mode. Tolerances: 'fused' by the equivalence rule of
tests/test_fused_omp.py:31-43 (codes atol 2e-4 where the supports agree,
else the per-row rss rtol 1e-3); 'chol' by ``_assert_same_fit`` of
tests/test_omp.py:207-222 (codes rtol 1e-4 / atol 1e-5 when every support
agrees, else the per-row rss rtol 1e-3); ``n_iter`` equal.
"""

import importlib
import json
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lasso_tpu.linear.solvers import orthogonal_matching_pursuit as jomp
from lasso_tpu_torch.__main__ import main as cli
from lasso_tpu_torch.linear import sparse_encode
from lasso_tpu_torch.linear.solvers import orthogonal_matching_pursuit as tomp
from lasso_tpu_torch.utils import chunked_encode

from _torch_port import (assert_equivalent, assert_same_fit, n,
                         omp_problem, rss, t)
from _torch_port import release_jax_after_module  # noqa: F401


def both(x, W, T, **kw):
    """(z_jax, n_iter_jax, z_port, n_iter_port) on the same inputs."""
    zj, kj = jomp(jnp.asarray(x), jnp.asarray(W), T, return_iters=True, **kw)
    zt, kt = tomp(t(x), t(W), T, return_iters=True, **kw)
    return n(zj), int(kj), n(zt), kt


def planted(seed, n_, d, k, sparse_rows=8, s=3):
    """x with its first rows exactly s-sparse over W (they freeze early
    under tol)."""
    x, W = omp_problem(seed, n_, d, k)
    z = np.zeros((sparse_rows, k), np.float32)
    z[:, :s] = np.random.default_rng(seed + 1).standard_normal(
        (sparse_rows, s))
    x[:sparse_rows] = z @ W.T
    return x, W


@pytest.mark.parametrize("n_,d,k,T", [
    (32, 128, 256, 8),
    (130, 128, 256, 12),
    (16, 256, 128, 5),
])
def test_fused_matches_jax(n_, d, k, T):
    x, W = omp_problem(n_ + T, n_, d, k)
    zj, kj, zt, kt = both(x, W, T, solver="fused", use_pallas=True)
    assert kt == kj == T
    assert ((zt != 0).sum(axis=1) <= T).all()
    assert_equivalent(x, W, zj, zt)


@pytest.mark.parametrize("ws_fast", [True, False])
@pytest.mark.parametrize("tol", [None, 8.0])
def test_chol_matches_jax(ws_fast, tol):
    """Both loop bodies against JAX's 'chol' (interpret-mode append
    kernel), T not a multiple of 8, with and without per-sample freezing
    mid-run."""
    x, W = omp_problem(5, 48, 32, 64)
    zj, kj, zt, kt = both(x, W, 12, tol=tol, solver="chol", use_pallas=True,
                          ws_fast=ws_fast)
    assert kt == kj
    assert_same_fit(x, W, zj, zt)


@pytest.mark.parametrize("solver", ["fused", "chol"])
def test_tol_freezing_matches_jax(solver):
    """Planted 3-sparse rows freeze at 3 atoms on both sides; n_iter and
    the supports' sizes equal JAX's."""
    x, W = planted(7, 48, 128, 256)
    zj, kj, zt, kt = both(x, W, 16, tol=1e-6, solver=solver,
                          use_pallas=True)
    assert kt == kj
    np.testing.assert_array_equal((zt[:8] != 0).sum(axis=1),
                                  (zj[:8] != 0).sum(axis=1))
    assert ((zt[:8] != 0).sum(axis=1) <= 3).all()
    (assert_equivalent if solver == "fused" else assert_same_fit)(
        x, W, zj, zt)


def test_pad_route_and_auto():
    """D, K not multiples of 128: 'fused' pads onto the aligned grid with
    no warning and matches JAX's padded solve; 'auto' on the CPU takes
    'chol-full' and matches JAX's CPU default (also 'chol-full')."""
    x, W = omp_problem(2, 8, 64, 96)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        zj, kj, zt, kt = both(x, W, 4, solver="fused", use_pallas=True)
    assert kt == kj and zt.shape == (8, 96)
    assert_equivalent(x, W, zj, zt)
    zj, kj, zt, kt = both(x, W, 4)
    assert kt == kj
    assert_same_fit(x, W, zj, zt)


def test_gram_jitter():
    """An explicit gram_jitter bypasses the fused kernels: 'fused' warns
    and goes to 'auto', which takes 'chol' with the jitter on the diagonal
    slot, as JAX does."""
    x, W = omp_problem(3, 24, 128, 256)
    with pytest.warns(UserWarning, match="fused"):
        zt = tomp(t(x), t(W), 8, solver="fused", use_pallas=True,
                  gram_jitter=1e-2)
    zj = jomp(jnp.asarray(x), jnp.asarray(W), 8, solver="chol",
              use_pallas=True, gram_jitter=1e-2)
    assert_same_fit(x, W, n(zj), n(zt))
    z0 = n(tomp(t(x), t(W), 8, solver="chol"))
    assert not np.allclose(n(zt), z0, atol=1e-6)


def test_duplicate_atom_stays_finite():
    """Exactly duplicated atoms force dependent appends: both routes stay
    finite (the pivot floors), and 'chol' keeps the single-atom fit's
    residual, as in tests/test_omp.py."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((16, 1)).astype(np.float32)
    w /= np.linalg.norm(w)
    W = np.concatenate([w, w], axis=1)
    x = rng.standard_normal((8, 16)).astype(np.float32)
    z2 = n(tomp(t(x), t(W), 2, solver="chol"))
    z1 = n(tomp(t(x), t(W), 1, solver="chol"))
    assert np.isfinite(z2).all()
    np.testing.assert_allclose(rss(x, z2, W), rss(x, z1, W), rtol=1e-4,
                               atol=1e-5)
    Wd = rng.standard_normal((128, 128)).astype(np.float32)
    Wd[:, 64:] = Wd[:, :64]
    Wd /= np.linalg.norm(Wd, axis=0, keepdims=True)
    xd = rng.standard_normal((8, 128)).astype(np.float32)
    zj, kj, zt, kt = both(xd, Wd, 12, solver="fused", use_pallas=True)
    assert np.isfinite(zt).all() and kt == kj
    assert rss(xd, zt, Wd).mean() < np.sum(xd * xd, axis=1).mean()
    np.testing.assert_allclose(rss(xd, zt, Wd), rss(xd, zj, Wd), rtol=1e-3)


def test_dispatch_sparse_encode_chunked_and_cli(tmp_path):
    """'omp' through sparse_encode ignores alpha and z0; chunked_encode
    and the CLI give the direct codes, the zero rows padding the last
    chunk solving finitely."""
    x, W = omp_problem(4, 37, 32, 64)
    direct, k_d = tomp(t(x), t(W), 4, return_iters=True)
    z, k_s = sparse_encode(t(x), t(W), alpha=t(np.full(37, 3.0, np.float32)),
                           algorithm="omp", n_nonzero_coefs=4,
                           return_iters=True)
    assert k_s == k_d == 4 and torch.equal(z, direct)
    assert torch.equal(sparse_encode(t(x), t(W), algorithm="omp",
                                     n_nonzero_coefs=4, z0=torch.ones(2)),
                       direct)
    zc = chunked_encode(x, W, chunk_size=16, algorithm="omp",
                        n_nonzero_coefs=4, device="cpu")
    assert np.isfinite(zc).all()
    np.testing.assert_allclose(zc, n(direct), rtol=1e-5, atol=1e-6)
    np.save(tmp_path / "X.npy", x)
    np.save(tmp_path / "W.npy", W)
    cli(["encode", str(tmp_path / "X.npy"), str(tmp_path / "W.npy"), "-o",
         str(tmp_path / "Z.npy"), "--algorithm", "omp", "--chunk-size", "16",
         "--device", "cpu", "--solver-args",
         json.dumps({"n_nonzero_coefs": 4})])
    np.testing.assert_array_equal(np.load(tmp_path / "Z.npy"), zc)


def test_unported_and_invalid_requests_raise(monkeypatch):
    """'cg' (ported with conjgrad_per_row) runs and matches JAX's by
    ``_assert_same_fit``; 'auto' takes it above N T^2 = _CG_CROSSOVER
    (2^27, lowered here to this size) wherever the append route is off
    (use_pallas=False, float64), and 'chol-full' at the crossover; invalid
    requests raise."""
    x, W = omp_problem(0, 10, 32, 64)
    zj, kj, zt, kt = both(x, W, 4, solver="cg")
    assert kt == kj == 4
    assert_same_fit(x, W, zj, zt)
    omp_mod = importlib.import_module("lasso_tpu_torch.linear.solvers.omp")
    assert omp_mod._CG_CROSSOVER == 2 ** 27
    for kw in ({"use_pallas": False}, {"use_pallas": True}):
        for dtype in (torch.float32, torch.float64):
            if kw["use_pallas"] and dtype == torch.float32:
                continue                       # the append route
            xs, Ws = t(x).to(dtype), t(W).to(dtype)
            monkeypatch.setattr(omp_mod, "_CG_CROSSOVER", 10 * 4 * 4 - 1)
            z_auto = tomp(xs, Ws, 4, **kw)
            assert torch.equal(z_auto, tomp(xs, Ws, 4, solver="cg", **kw))
            assert_same_fit(x, W, zj, n(z_auto).astype(np.float32))
            monkeypatch.setattr(omp_mod, "_CG_CROSSOVER", 10 * 4 * 4)
            assert torch.equal(tomp(xs, Ws, 4, **kw),
                               tomp(xs, Ws, 4, solver="chol-full", **kw))
    with pytest.raises(ValueError, match="solver"):
        tomp(t(x), t(W), 4, solver="lars")
    for T in (0, 33):
        with pytest.raises(ValueError, match="n_nonzero_coefs"):
            tomp(t(x), t(W), T)


def test_default_budget_and_verbose(capsys):
    """T defaults to max(1, K // 10); verbose prints the mean rss of every
    iteration and takes 'chol' (as in JAX, the fused kernels print
    nothing)."""
    x, W = omp_problem(6, 10, 32, 64)
    z, k = tomp(t(x), t(W), return_iters=True, verbose=True,
                use_pallas=True)
    assert k == 6 and ((n(z) != 0).sum(axis=1) <= 6).all()
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(" - ")[0] for ln in lines] == [f"iter {i}"
                                                    for i in range(6)]
    assert all("mean rss:" in ln for ln in lines)
    zj = jomp(jnp.asarray(x), jnp.asarray(W), solver="chol", use_pallas=True)
    assert_same_fit(x, W, n(zj), n(z))


def test_no_library_factorization_on_the_omp_path(monkeypatch):
    """No PyTorch factorization or solve stands in for the kernels: with
    each of them patched to raise, 'fused', 'chol' and 'chol-full' (the
    Cholesky solve kernel's plain version) still solve."""
    def refuse(*a, **k):
        raise AssertionError("a library factorization or solve ran")

    for mod, names in ((torch.linalg, ("cholesky", "cholesky_ex", "solve",
                                       "solve_ex", "solve_triangular",
                                       "lstsq", "inv", "inv_ex", "qr",
                                       "lu_factor", "ldl_factor")),
                       (torch, ("cholesky_solve", "cholesky_inverse",
                                "triangular_solve", "lu_solve"))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)
    x, W = (t(a) for a in omp_problem(8, 12, 128, 256))
    for solver in ("fused", "chol", "chol-full"):
        z = sparse_encode(x, W, algorithm="omp", n_nonzero_coefs=6,
                          solver=solver, use_pallas=True)
        assert bool(torch.isfinite(z).all())
