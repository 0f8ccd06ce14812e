"""Shared inputs for the tests that hold lasso_tpu_torch against lasso_tpu.

Inputs are made with numpy from a seed and handed to both packages; the
port runs on the CPU, where its fused functions run the kernels' plain
versions. Only :func:`both` imports JAX, inside the call, so that the
card-only tests can use this module on a machine without JAX.
"""

import numpy as np
import torch


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
