"""lasso_tpu_torch's implicit-differentiation encoders against lasso_tpu's:
the gradients of a downstream scalar ``sum(z * c)`` with respect to x, the
dictionary and alpha, from ``torch.autograd.backward`` through the port's
``torch.autograd.Function`` and from ``jax.grad`` through JAX's
``custom_vjp`` (jitted), on the same numpy inputs (the JAX tests' problems
and step sizes, 1000 forward iterations at tol 0, 4000 for the warm start
as in tests/test_implicit.py), the port on the CPU.

Tolerances, each relative to the largest entry of JAX's gradient: in
float64 (``jax.enable_x64``) x_bar and alpha_bar to 1e-10 (the same
masked CG in both packages), W_bar to 1e-6: its two terms, ``R^T u`` and
``W (u^T z)``, cancel, so the forward codes' last-digit differences between
the packages (7e-13 on the linear problem) show there at about 3e-8. In
float32, every gradient to 5e-3 of its norm:
the forward codes part by f32 rounding, and the support Hessian's
condition number carries that into u. The guards are exact: an empty
support or a zero cotangent gives gradients that are exactly zero.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lasso_tpu.conv2d import make_implicit_conv_encoder as j_conv_enc
from lasso_tpu.linear import make_implicit_encoder as j_enc
from lasso_tpu.linear import make_implicit_group_encoder as j_group_enc
from lasso_tpu_torch.conv2d import (implicit_conv_encode,
                                    make_implicit_conv_encoder)
from lasso_tpu_torch.linear import (implicit_sparse_encode,
                                    make_implicit_encoder,
                                    make_implicit_group_encoder)

from _torch_port import (n, one_torch_thread,  # noqa: F401
                         release_jax_after_module, t)

LINEAR = dict(maxiter=1000, tol=0.0, lr=0.2, use_pallas=False)
GROUP = dict(maxiter=1000, tol=0.0, lr=0.15, groups=4, use_pallas=False)
CONV = dict(maxiter=1000, tol=0.0, lr=0.09, use_pallas=False)
# (stride, padding, image size) of tests/test_implicit_conv.py
CONV_GEOMETRY = {1: (1, 1, 8), 2: (2, 1, 9)}


def _linear_problem(seed=3, n_=8, d=12, k=20):
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((d, k))
    W /= np.linalg.norm(W, axis=0, keepdims=True)
    return rng.standard_normal((n_, d)), W, rng.standard_normal((n_, k))


def _conv_problem(stride, seed=11, n_=4, cx=2, cz=6, k=3):
    _, _, hw = CONV_GEOMETRY[stride]
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((cz, cx, k, k))
    W /= np.sqrt((W ** 2).sum(axis=(1, 2, 3), keepdims=True))
    return rng.standard_normal((n_, cx, hw, hw)), W, rng


def _jax_grads(enc, x, W, alpha, c, dtype):
    f = lambda xx, ww, aa: jnp.sum(enc(xx, ww, aa) * jnp.asarray(c, dtype))
    return [np.asarray(g) for g in jax.jit(jax.grad(f, argnums=(0, 1, 2)))(
        jnp.asarray(x, dtype), jnp.asarray(W, dtype),
        jnp.asarray(alpha, dtype))]


def _port_grads(enc, x, W, alpha, c, dtype, **kw):
    leaves = [torch.tensor(np.asarray(v), dtype=dtype, requires_grad=True)
              for v in (x, W, alpha)]
    z = enc(*leaves, **kw)
    torch.sum(z * torch.as_tensor(c, dtype=dtype)).backward()
    return [n(v.grad) for v in leaves], z


def _assert_rel(gj, gt, tols):
    for name, a, b, tol in zip(("x", "W", "alpha"), gj, gt, tols):
        assert a.shape == b.shape, name
        err = np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)
        assert err < tol, (name, err)


@pytest.mark.parametrize("case", ["scalar", "per_sample", "per_sample_col",
                                  "per_feature", "scalar_l2"])
def test_linear_encoder_matches_jax(case):
    x, W, c = _linear_problem()
    n_, k = x.shape[0], W.shape[1]
    alpha = {"per_sample": np.linspace(0.2, 0.3, n_),
             "per_sample_col": np.linspace(0.2, 0.3, n_)[:, None],
             "per_feature": np.linspace(0.2, 0.3, k)[None]}.get(
                 case, np.asarray(0.25))
    kw = dict(LINEAR, l2=0.1) if case == "scalar_l2" else LINEAR
    with jax.enable_x64():
        gj = _jax_grads(j_enc(**kw), x, W, alpha, c, jnp.float64)
    gt, _ = _port_grads(make_implicit_encoder(**kw), x, W, alpha, c,
                        torch.float64)
    _assert_rel(gj, gt, (1e-10, 1e-6, 1e-10))


def test_linear_warm_start_and_one_shot():
    """A warm z0 (the cold codes) gives the cold gradients, as in JAX
    (tests/test_implicit.py:256-272, rtol 1e-8); z0 gets no gradient; the
    one-shot implicit_sparse_encode is the encoder."""
    x, W, c = _linear_problem()
    solve = dict(LINEAR, maxiter=4000)
    enc = make_implicit_encoder(**solve)
    gt, z_cold = _port_grads(enc, x, W, 0.25, c, torch.float64)
    z0 = z_cold.detach().clone().requires_grad_()
    gw, _ = _port_grads(enc, x, W, 0.25, c, torch.float64, z0=z0)
    for a, b in zip(gt, gw):
        np.testing.assert_allclose(b, a, rtol=1e-8, atol=1e-10)
    assert z0.grad is None
    with jax.enable_x64():
        ej = j_enc(**solve)
        z0j = jnp.asarray(n(z_cold))
        f = lambda ww: jnp.sum(ej(jnp.asarray(x), ww, jnp.asarray(0.25), z0j)
                               * jnp.asarray(c))
        gj = np.asarray(jax.jit(jax.grad(f))(jnp.asarray(W)))
    _assert_rel([gj], [gw[1]], (1e-6,))
    g1, _ = _port_grads(lambda xx, ww, aa: implicit_sparse_encode(
        xx, ww, aa, **solve), x, W, 0.25, c, torch.float64)
    for a, b in zip(gt, g1):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("l1_alpha,per_sample", [(0.0, False), (0.05, True)])
def test_group_encoder_matches_jax(l1_alpha, per_sample):
    """tests/test_implicit_group.py's problem: groups of 4, scalar or [N]
    alpha, with and without the sparse-group l1 term."""
    x, W, c = _linear_problem(seed=13, n_=6, d=12, k=24)
    alpha = (np.linspace(0.25, 0.35, x.shape[0]) if per_sample
             else np.asarray(0.3))
    with jax.enable_x64():
        gj = _jax_grads(j_group_enc(l1_alpha=l1_alpha, **GROUP), x, W, alpha,
                        c, jnp.float64)
    gt, _ = _port_grads(make_implicit_group_encoder(l1_alpha=l1_alpha,
                                                    **GROUP),
                        x, W, alpha, c, torch.float64)
    _assert_rel(gj, gt, (1e-10, 1e-6, 1e-10))


@pytest.mark.parametrize("stride,alpha_kind", [
    (1, "scalar"), (2, "scalar"), (1, "per_channel"), (2, "per_sample")])
def test_conv_encoder_matches_jax(stride, alpha_kind):
    """tests/test_implicit_conv.py's problem: both terms of W_bar at stride
    1 and 2 (odd image), scalar, per-channel (1, C_z) and per-sample [N]
    alpha."""
    s, p, _ = CONV_GEOMETRY[stride]
    x, W, rng = _conv_problem(stride)
    alpha = {"per_channel": np.linspace(0.08, 0.12, W.shape[0])[None],
             "per_sample": np.linspace(0.08, 0.12, x.shape[0])}.get(
                 alpha_kind, np.asarray(0.1))
    hz = (x.shape[2] + 2 * p - W.shape[2]) // s + 1
    c = rng.standard_normal((x.shape[0], W.shape[0], hz, hz))
    with jax.enable_x64():
        gj = _jax_grads(j_conv_enc(stride=s, padding=p, **CONV), x, W, alpha,
                        c, jnp.float64)
    gt, _ = _port_grads(make_implicit_conv_encoder(stride=s, padding=p,
                                                   **CONV),
                        x, W, alpha, c, torch.float64)
    _assert_rel(gj, gt, (1e-10, 1e-6, 1e-10))


@pytest.mark.parametrize("kind", ["linear", "group", "conv"])
def test_float32_matches_jax(kind):
    """Each encoder in float32 on both sides (JAX without x64)."""
    if kind == "conv":
        x, W, rng = _conv_problem(1)
        c = rng.standard_normal((x.shape[0], W.shape[0], 8, 8))
        alpha, kw = np.asarray(0.1), dict(CONV, padding=1)
        j_make, t_make = j_conv_enc, make_implicit_conv_encoder
    elif kind == "group":
        x, W, c = _linear_problem(seed=13, n_=6, d=12, k=24)
        alpha, kw = np.asarray(0.3), GROUP
        j_make, t_make = j_group_enc, make_implicit_group_encoder
    else:
        x, W, c = _linear_problem()
        alpha, kw = np.asarray(0.25), LINEAR
        j_make, t_make = j_enc, make_implicit_encoder
    gj = _jax_grads(j_make(**kw), x, W, alpha, c, jnp.float32)
    gt, _ = _port_grads(t_make(**kw), x, W, alpha, c, torch.float32)
    for name, a, b in zip(("x", "W", "alpha"), gj, gt):
        assert b.dtype == np.float32 and np.isfinite(b).all(), name
        rel = np.linalg.norm(b - a) / np.linalg.norm(a)
        assert rel < 5e-3, (name, rel)


@pytest.mark.parametrize("kind", ["linear", "group", "conv"])
def test_guards(kind):
    """alpha above alpha_max (empty support) gives zero gradients and no
    NaN; a zero cotangent gives zero gradients; a gradient asked of x
    alone leaves the others unset; the conv encoder refuses an alpha shape
    it cannot reduce to; the group encoder refuses a 2-D alpha, [1, 1] of
    one sample too, as JAX's does (its group_ista raises)."""
    if kind == "conv":
        x, W, _ = _conv_problem(1)
        enc = make_implicit_conv_encoder(padding=1, **CONV)
    elif kind == "group":
        x, W, _ = _linear_problem(seed=13, n_=6, d=12, k=24)
        enc = make_implicit_group_encoder(**GROUP)
    else:
        x, W, _ = _linear_problem(seed=8)
        enc = make_implicit_encoder(**LINEAR)
    xt, Wt = t(x).requires_grad_(), t(W).requires_grad_()
    a = torch.tensor(1e3, dtype=torch.float64, requires_grad=True)
    torch.sum(enc(xt, Wt, a)).backward()
    for g in (xt.grad, Wt.grad, a.grad):
        assert torch.isfinite(g).all() and not g.any()
    xt.grad = Wt.grad = None
    z = enc(xt, Wt, 0.1)
    assert z.abs().max() > 0
    torch.sum(z * 0.0).backward()
    assert not xt.grad.any() and not Wt.grad.any()
    xt.grad = None
    Wc = t(W)
    (gx,) = torch.autograd.grad(torch.sum(enc(xt, Wc, 0.1) ** 2), xt)
    assert gx.shape == xt.shape and gx.abs().max() > 0 and Wc.grad is None
    if kind == "group":
        j_enc1 = j_group_enc(**GROUP)
        for shape in ((1, 1), (x.shape[0], 1)):
            a2 = np.full(shape, 0.3)
            with pytest.raises(ValueError):
                j_enc1(jnp.asarray(x[:shape[0]]), jnp.asarray(W),
                       jnp.asarray(a2))
            with pytest.raises(ValueError):
                enc(t(x[:shape[0]]), Wc, t(a2))
    if kind == "conv":
        bad = torch.full((3,), 0.1, dtype=torch.float64, requires_grad=True)
        with pytest.raises(ValueError):
            torch.sum(implicit_conv_encode(xt, Wc, bad, padding=1,
                                           **CONV)).backward()
