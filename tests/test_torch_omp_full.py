"""lasso_tpu_torch's OMP 'chol-full' route (the refactorizing loop on the
batched Cholesky solve) against lasso_tpu's on the same numpy inputs, the
JAX package's two routing fallbacks onto it, its dispatch, and OMP
dictionary learning.

The port runs on the CPU: with ``use_pallas=True`` the Cholesky solve is the
kernel's plain version (JAX: its kernel in interpret mode), with False the
library's factorization in both. Fits are held by ``_assert_same_fit`` of
tests/test_omp.py:207-222 (codes rtol 1e-4 / atol 1e-5 when every support
agrees, else the per-row rss rtol 1e-3), ``n_iter`` equal.
"""

import importlib
import json
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lasso_tpu.linear import dict_learning as jdict_learning
from lasso_tpu.linear.solvers import orthogonal_matching_pursuit as jomp
from lasso_tpu_torch.__main__ import main as cli
from lasso_tpu_torch.linear import sparse_encode
from lasso_tpu_torch.linear.solvers import orthogonal_matching_pursuit as tomp
from lasso_tpu_torch.utils import chunked_encode

from _torch_port import assert_same_fit, n, omp_problem, t
from _torch_port import release_jax_after_module  # noqa: F401

tdl = importlib.import_module("lasso_tpu_torch.linear.dict_learning")


def both(x, W, T, **kw):
    """(z_jax, n_iter_jax, z_port, n_iter_port) on the same inputs."""
    zj, kj = jomp(jnp.asarray(x), jnp.asarray(W), T, return_iters=True, **kw)
    zt, kt = tomp(t(x), t(W), T, return_iters=True, **kw)
    return n(zj), int(kj), n(zt), kt


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("tol", [None, 8.0])
def test_chol_full_matches_jax(use_pallas, tol):
    """T not a multiple of 8, with and without per-sample freezing
    mid-run."""
    x, W = omp_problem(5, 48, 32, 64)
    zj, kj, zt, kt = both(x, W, 12, tol=tol, solver="chol-full",
                          use_pallas=use_pallas)
    assert kt == kj
    assert ((zt != 0).sum(axis=1) <= 12).all()
    assert_same_fit(x, W, zj, zt)


def test_tol_freezing_matches_jax():
    """Planted 3-sparse rows freeze at 3 atoms on both sides."""
    x, W = omp_problem(7, 48, 128, 256)
    z = np.zeros((8, 256), np.float32)
    z[:, :3] = np.random.default_rng(8).standard_normal((8, 3))
    x[:8] = z @ W.T
    zj, kj, zt, kt = both(x, W, 16, tol=1e-6, solver="chol-full",
                          use_pallas=True)
    assert kt == kj
    np.testing.assert_array_equal((zt[:8] != 0).sum(axis=1),
                                  (zj[:8] != 0).sum(axis=1))
    assert ((zt[:8] != 0).sum(axis=1) <= 3).all()
    assert_same_fit(x, W, zj, zt)


def test_padding_and_zero_rows():
    """N = 130, past one 128-lane tile (JAX pads its Cholesky batch with
    identity systems, the port pads nothing), with zero rows (what pads a
    chunk), whose codes solve to exactly zero."""
    x, W = omp_problem(9, 130, 24, 40)
    x[-6:] = 0.0
    zj, kj, zt, kt = both(x, W, 10, solver="chol-full", use_pallas=True)
    assert kt == kj
    assert (zt[-6:] == 0).all()
    assert_same_fit(x, W, zj, zt)


def test_gram_jitter_matches_jax():
    """The jitter goes on the diagonal of the whole support system in both
    packages, and moves the codes."""
    x, W = omp_problem(3, 24, 128, 256)
    zj, _, zt, _ = both(x, W, 8, solver="chol-full", use_pallas=True,
                        gram_jitter=1e-2)
    assert_same_fit(x, W, zj, zt)
    z0 = n(tomp(t(x), t(W), 8, solver="chol-full", use_pallas=True))
    assert not np.allclose(zt, z0, atol=1e-6)


@pytest.mark.parametrize("how", ["use_pallas=False", "float64", "cpu"])
def test_auto_off_the_append_route_takes_chol_full(how):
    """Where the append kernel does not launch (use_pallas=False, float64,
    and 'auto' on a CPU tensor, as in the JAX package), 'auto' takes
    'chol-full' below N T^2 = 2^27: the same codes as an explicit
    'chol-full', and JAX's 'auto' fit."""
    x, W = omp_problem(4, 40, 32, 64)
    kw = {"use_pallas": False} if how == "use_pallas=False" else {}
    xt, Wt = t(x), t(W)
    if how == "float64":
        xt, Wt = xt.double(), Wt.double()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        z, k = tomp(xt, Wt, 6, return_iters=True, **kw)
    z_full = tomp(xt, Wt, 6, solver="chol-full", **kw)
    assert k == 6 and z.dtype == xt.dtype
    assert torch.equal(z, z_full)
    zj = jomp(jnp.asarray(x), jnp.asarray(W), 6, **kw)
    assert_same_fit(x, W, n(zj), n(z).astype(np.float32))


def test_explicit_chol_off_the_append_route_warns():
    """An explicit 'chol' without the append kernel warns and takes the
    exact 'chol-full', never the inexact CG, as tests/test_omp.py:240-253
    holds the JAX package."""
    x, W = omp_problem(0, 24, 16, 32)
    with pytest.warns(UserWarning, match="chol-full"):
        z = tomp(t(x), t(W), 8, solver="chol", use_pallas=False)
    z_full = tomp(t(x), t(W), 8, solver="chol-full", use_pallas=False)
    np.testing.assert_allclose(n(z), n(z_full), atol=0)
    with pytest.warns(UserWarning, match="chol-full"):
        z64 = tomp(t(x).double(), t(W).double(), 8, solver="chol")
    assert z64.dtype == torch.float64
    with pytest.warns(UserWarning, match="chol-full"):
        zj = jomp(jnp.asarray(x), jnp.asarray(W), 8, solver="chol",
                  use_pallas=False)
    assert_same_fit(x, W, n(zj), n(z))


def test_dispatch_sparse_encode_chunked_and_cli(tmp_path):
    """'chol-full' through sparse_encode, chunked_encode (the last chunk
    padded with zero rows) and the CLI's --solver-args."""
    x, W = omp_problem(6, 37, 32, 64)
    direct, k_d = tomp(t(x), t(W), 4, solver="chol-full", use_pallas=True,
                       return_iters=True)
    z, k_s = sparse_encode(t(x), t(W), algorithm="omp", n_nonzero_coefs=4,
                           solver="chol-full", use_pallas=True,
                           return_iters=True)
    assert k_s == k_d == 4 and torch.equal(z, direct)
    zc = chunked_encode(x, W, chunk_size=16, algorithm="omp",
                        n_nonzero_coefs=4, solver="chol-full",
                        use_pallas=True, device="cpu")
    np.testing.assert_allclose(zc, n(direct), rtol=1e-5, atol=1e-6)
    np.save(tmp_path / "X.npy", x)
    np.save(tmp_path / "W.npy", W)
    cli(["encode", str(tmp_path / "X.npy"), str(tmp_path / "W.npy"), "-o",
         str(tmp_path / "Z.npy"), "--algorithm", "omp", "--chunk-size", "16",
         "--device", "cpu", "--solver-args",
         json.dumps({"n_nonzero_coefs": 4, "solver": "chol-full",
                     "use_pallas": True})])
    np.testing.assert_array_equal(np.load(tmp_path / "Z.npy"), zc)


def ksvd_problem():
    """tests/test_omp.py:138-158's K-SVD problem: 256 signals of 16
    features, 3-sparse over 32 unit atoms, with noise 0.01."""
    rng = np.random.default_rng(0)
    Dt = rng.standard_normal((16, 32))
    Dt /= np.linalg.norm(Dt, axis=0, keepdims=True)
    Z = np.zeros((256, 32))
    for i in range(256):
        Z[i, rng.choice(32, 3, replace=False)] = rng.standard_normal(3)
    return (Z @ Dt.T + 0.01 * rng.standard_normal((256, 16))).astype(
        np.float32)


def test_omp_dict_learning_matches_jax():
    """K-SVD-style learning (OMP E-steps, the constrained sequential
    M-step) on the JAX package's draws: the losses within 1e-5 of JAX's and
    never rising, the dictionary within 1e-4."""
    X = ksvd_problem()
    steps, K = 10, 32
    kw = dict(alpha=0.0, constrained=True, steps=steps, algorithm="omp",
              n_nonzero_coefs=3)
    Wj, lj = jdict_learning(jnp.asarray(X), K, key=jax.random.PRNGKey(0),
                            **kw)
    key, init_key = jax.random.split(jax.random.PRNGKey(0))
    w0 = jax.nn.initializers.orthogonal()(init_key, (16, K))
    w0 = np.array(w0 / (np.linalg.norm(w0, axis=0, keepdims=True) + 1e-30),
                  np.float32)
    atoms = np.stack([np.asarray(jax.random.normal(k, (K, 16)))
                      for k in jax.random.split(key, steps)]).astype(
                          np.float32)
    Wt, lt = tdl._dict_learning(t(X), t(w0), t(atoms), **kw)
    lt, lj = n(lt), np.asarray(lj)
    np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-5)
    assert np.all(np.diff(lt) <= 1e-5), lt
    assert lt[-1] < 0.5 * lt[0], lt
    np.testing.assert_allclose(n(Wt), np.asarray(Wj), rtol=0, atol=1e-4)
