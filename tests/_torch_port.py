"""Shared inputs for the tests that hold lasso_tpu_torch against lasso_tpu.

Inputs are made with numpy from a seed and handed to both packages; the
port runs on the CPU, where its fused functions run the kernels' plain
versions. Only :func:`both` imports JAX, inside the call, so that the
card-only tests can use this module on a machine without JAX.
"""

import sys

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def release_jax_after_module():
    """JAX keeps every executable it compiles, each holding memory mappings
    of its code, and a process may hold 65530. pytest-xdist runs the tests
    of many files in one worker, and the JAX package's interpret-mode
    tests leave tens of thousands there, so each port test file that
    imports this fixture gives every executable back when a worker leaves
    it."""
    yield
    jax = sys.modules.get("jax")
    if jax is not None:
        jax.clear_caches()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a module's port code on one intra-op thread. Its loops run
    thousands of tiny operations, and under pytest-xdist six workers of
    one thread per core each spin their OpenMP teams against each other
    (on an 8-core machine the first two files that used this fixture took
    268 s on six workers with PyTorch's default threads and 30 s with
    one). The
    worker's setting comes back after the module."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n_threads)


def make_problem(rng, n=32, d=128, k=256):
    """x [n, d], z and z_prev [n, k] (small), W [d, k] with unit-ish
    columns, as float32 numpy arrays."""
    x = rng.standard_normal((n, d)).astype(np.float32)
    W = (rng.standard_normal((d, k)) / np.sqrt(d)).astype(np.float32)
    z = (rng.standard_normal((n, k)) * 0.1).astype(np.float32)
    zp = (rng.standard_normal((n, k)) * 0.1).astype(np.float32)
    return x, z, zp, W


def t(a):
    """numpy -> CPU torch tensor (None passes through)."""
    return None if a is None else torch.from_numpy(np.asarray(a))


def n(a):
    """JAX array or torch tensor -> numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def both(x, W, alpha=0.1, z0=None, **kw):
    """Solve with lasso_tpu's and the port's ista on the same inputs;
    returns (z_jax, n_iter_jax, z_port, n_iter_port)."""
    import jax.numpy as jnp
    from lasso_tpu.linear.solvers import ista as jista
    from lasso_tpu_torch.linear.solvers import ista as tista
    if z0 is None:
        z0 = np.zeros((x.shape[0], W.shape[1]), np.float32)
    kw.setdefault("lr", 0.1)
    a_j = jnp.asarray(alpha) if isinstance(alpha, np.ndarray) else alpha
    zj, kj = jista(jnp.asarray(x), jnp.asarray(z0), jnp.asarray(W), a_j,
                   return_iters=True, **kw)
    zt, kt = tista(t(x), t(z0), t(W), t(alpha) if isinstance(
        alpha, np.ndarray) else alpha, return_iters=True, **kw)
    return n(zj), int(kj), n(zt), kt


def objective(x, W, z, alpha):
    """Lasso objective in float64."""
    z = np.asarray(z, np.float64)
    r = z @ np.asarray(W, np.float64).T - np.asarray(x, np.float64)
    return 0.5 * np.sum(r * r) + np.sum(np.asarray(alpha) * np.abs(z))


def omp_problem(seed, n, d, k):
    """Unit atoms W [d, k] and x [n, d], drawn as tests/test_fused_omp.py
    draws them."""
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((d, k)).astype(np.float32)
    W /= np.linalg.norm(W, axis=0, keepdims=True)
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x, W


def rss(x, z, W):
    """Per-row squared residual of codes z."""
    return np.sum(np.square(x - z @ W.T), axis=1)


def assert_equivalent(x, W, za, zb, atol=2e-4):
    """The fused OMP equivalence rule of tests/test_fused_omp.py:31-43:
    codes atol 2e-4 on the rows whose supports agree; on the rows where a
    near-tie flipped an atom, the per-row rss rtol 1e-3."""
    same = ((za != 0) == (zb != 0)).all(axis=1)
    np.testing.assert_allclose(zb[same], za[same], atol=atol)
    if not same.all():
        np.testing.assert_allclose(rss(x, zb, W)[~same],
                                   rss(x, za, W)[~same], rtol=1e-3,
                                   atol=1e-5)


def assert_same_fit(x, W, za, zb):
    """``_assert_same_fit`` of tests/test_omp.py:207-222: codes rtol 1e-4 /
    atol 1e-5 when every support agrees, else the per-row rss rtol
    1e-3."""
    if ((za != 0) == (zb != 0)).all():
        np.testing.assert_allclose(zb, za, rtol=1e-4, atol=1e-5)
    else:
        np.testing.assert_allclose(rss(x, zb, W), rss(x, za, W), rtol=1e-3,
                                   atol=1e-5)
