"""lasso_tpu_torch's nonlinear implicit encoder against lasso_tpu's: the
gradients of a downstream scalar ``sum(z * c)`` in x, each decoder
parameter and alpha, from ``torch.autograd.backward`` through the port's
``torch.autograd.Function`` and from ``jax.grad`` through JAX's
``custom_vjp`` (jitted), on the same numpy inputs: the problems of
tests/test_implicit_nl.py (the tanh MLP 6x(16 -> 10 -> 12), seed 5; the
linear decoder 8x12->20, seed 9), the port on the CPU. The forwards take
a fixed step below 1/L (0.08 on the MLP, as the JAX test's unrolled
oracle; 0.2 on the linear decoder), so that both packages run the same
iterates without a random draw.

Tolerances, each relative to the largest entry of JAX's gradient, in
float64: x_bar and alpha_bar to 1e-10, the parameters' gradients to 1e-6,
as tests/test_torch_implicit.py holds the linear encoders; in float32 each
gradient to 5e-3 of its norm (the forward codes part by f32 rounding, and
the support Hessian's conditioning carries that into u). The linear
decoder's gradients equal the port's linear implicit encoder's at JAX's
test's rtol 1e-7 / atol 1e-9.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lasso_tpu.nonlinear import make_implicit_nl_encoder as j_nl_enc
from lasso_tpu_torch.linear import make_implicit_encoder
from lasso_tpu_torch.nonlinear import make_implicit_nl_encoder
from lasso_tpu_torch.utils import from_numpy_tree

from _torch_port import n, one_torch_thread, release_jax_after_module  # noqa: F401,E501

MLP_SOLVE = dict(maxiter=1500, tol=0.0, lr=0.08)
LINEAR_SOLVE = dict(maxiter=4000, tol=0.0, lr=0.2)


def _mlp_problem(seed=5, n_=6, k=16, h=10, d=12):
    rng = np.random.default_rng(seed)
    params = {"W1": 0.5 * rng.standard_normal((k, h)),
              "W2": rng.standard_normal((h, d)) / np.sqrt(h)}
    return rng.standard_normal((n_, d)), params, rng.standard_normal((n_, k))


def _jax_mlp(params, z):
    return jnp.matmul(jnp.tanh(jnp.matmul(z, params["W1"])), params["W2"])


def _torch_mlp(params, z):
    return torch.tanh(z @ params["W1"]) @ params["W2"]


def _jax_grads(enc, x, params, alpha, c, dtype):
    f = lambda xx, pp, aa: jnp.sum(enc(xx, pp, aa) * jnp.asarray(c, dtype))
    gx, gp, ga = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(
        jnp.asarray(x, dtype), jax.tree_util.tree_map(
            lambda v: jnp.asarray(v, dtype), params),
        jnp.asarray(alpha, dtype))
    return np.asarray(gx), jax.tree_util.tree_map(np.asarray, gp), \
        np.asarray(ga)


def _port_grads(enc, x, params, alpha, c, dtype):
    xt = torch.tensor(x, dtype=dtype, requires_grad=True)
    pt = {k: v.requires_grad_() for k, v in
          from_numpy_tree(params, "cpu", dtype).items()}
    at = torch.tensor(alpha, dtype=dtype, requires_grad=True)
    z = enc(xt, pt, at)
    torch.sum(z * torch.as_tensor(c, dtype=dtype)).backward()
    return n(xt.grad), {k: n(v.grad) for k, v in pt.items()}, n(at.grad), z


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


@pytest.mark.parametrize("case", ["scalar", "per_feature_ridge"])
def test_nl_encoder_matches_jax(case):
    """The MLP in float64: a scalar alpha, and a per-feature [1, K] alpha
    with ridge 0.1; the gradients come back in the params dict's
    structure."""
    x, params, c = _mlp_problem()
    k = params["W1"].shape[0]
    alpha, kw = ((np.asarray(0.1), {}) if case == "scalar" else
                 (np.linspace(0.08, 0.12, k)[None], {"ridge": 0.1}))
    z0 = np.zeros((x.shape[0], k))
    with jax.enable_x64():
        gj = _jax_grads(j_nl_enc(_jax_mlp, z0=jnp.asarray(z0), **kw,
                                 **MLP_SOLVE), x, params, alpha, c,
                        jnp.float64)
    gt = _port_grads(make_implicit_nl_encoder(
        _torch_mlp, z0=torch.from_numpy(z0), **kw, **MLP_SOLVE),
        x, params, alpha, c, torch.float64)
    assert _rel(gj[0], gt[0]) < 1e-10 and _rel(gj[2], gt[2]) < 1e-10
    assert gt[2].shape == alpha.shape and gt[1].keys() == params.keys()
    for leaf in params:
        assert _rel(gj[1][leaf], gt[1][leaf]) < 1e-6, leaf
    assert np.abs(gt[1]["W1"]).max() > 0 and np.abs(gt[0]).max() > 0


def test_nl_linear_decoder_matches_linear_implicit():
    """tests/test_implicit_nl.py:93-122: with decoder(P, z) = z P^T (params
    a single tensor) the nonlinear encoder gives the port's linear
    encoder's value and gradients, and JAX's nonlinear encoder's."""
    rng = np.random.default_rng(9)
    P = rng.standard_normal((12, 20))
    P /= np.linalg.norm(P, axis=0, keepdims=True)
    x = rng.standard_normal((8, 12))
    c = rng.standard_normal((8, 20))
    z0 = np.zeros((8, 20))
    enc_nl = make_implicit_nl_encoder(lambda p, z: z @ p.T,
                                      z0=torch.from_numpy(z0), **LINEAR_SOLVE)
    enc_li = make_implicit_encoder(use_pallas=False, **LINEAR_SOLVE)
    grads, values = [], []
    for enc in (enc_nl, enc_li):
        leaves = [torch.tensor(v, dtype=torch.float64, requires_grad=True)
                  for v in (x, P, 0.25)]
        f = torch.sum(enc(*leaves) * torch.from_numpy(c))
        f.backward()
        values.append(float(f.detach()))
        grads.append([n(v.grad) for v in leaves])
    np.testing.assert_allclose(values[0], values[1], rtol=1e-8)
    for a, b in zip(*grads):
        np.testing.assert_allclose(a, b, rtol=1e-7, atol=1e-9)
    with jax.enable_x64():
        enc_j = j_nl_enc(lambda p, z: jnp.matmul(z, p.T), z0=jnp.asarray(z0),
                         **LINEAR_SOLVE)
        f = lambda xx, pp, aa: jnp.sum(enc_j(xx, pp, aa) * jnp.asarray(c))
        gj = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(
            jnp.asarray(x), jnp.asarray(P), jnp.asarray(0.25))
    for a, b, tol in zip(gj, grads[0], (1e-10, 1e-6, 1e-10)):
        assert _rel(np.asarray(a), b) < tol


def test_nl_encoder_float32_and_guards():
    """float32 against JAX's float32; z0 is required; alpha above alpha_max
    (empty support) and a zero cotangent give gradients that are exactly
    zero; params=None with a closure; a list of parameters gets a list of
    gradients; no .grad of a parameter not asked for is written."""
    x, params, c = _mlp_problem()
    k = params["W1"].shape[0]
    z0 = np.zeros((x.shape[0], k))
    gj = _jax_grads(j_nl_enc(_jax_mlp, z0=jnp.asarray(z0, jnp.float32),
                             **MLP_SOLVE), x, params, 0.1, c, jnp.float32)
    gt = _port_grads(make_implicit_nl_encoder(
        _torch_mlp, z0=torch.zeros(x.shape[0], k), **MLP_SOLVE),
        x, params, 0.1, c, torch.float32)
    pairs = [(gj[0], gt[0]), (gj[2], gt[2])] + [
        (gj[1][leaf], gt[1][leaf]) for leaf in params]
    for a, b in pairs:
        assert b.dtype == np.float32 and np.isfinite(b).all()
        assert np.linalg.norm(b - a) <= 5e-3 * np.linalg.norm(a)

    with pytest.raises(ValueError):
        make_implicit_nl_encoder(_torch_mlp, maxiter=10)
    z0t = torch.from_numpy(z0)
    enc = make_implicit_nl_encoder(_torch_mlp, z0=z0t, **MLP_SOLVE)
    xt = torch.from_numpy(x).requires_grad_()
    pt = {k_: v.requires_grad_() for k_, v in
          from_numpy_tree(params, "cpu", torch.float64).items()}
    a = torch.tensor(1e3, dtype=torch.float64, requires_grad=True)
    torch.sum(enc(xt, pt, a)).backward()
    for g in (xt.grad, a.grad, *(v.grad for v in pt.values())):
        assert torch.isfinite(g).all() and not g.any()
    xt.grad = None
    torch.sum(enc(xt, pt, 0.1) * 0.0).backward()
    assert not xt.grad.any()

    pl = [v.detach().clone().requires_grad_() for v in pt.values()]
    enc_list = make_implicit_nl_encoder(
        lambda p, z: torch.tanh(z @ p[0]) @ p[1], z0=z0t, **MLP_SOLVE)
    enc_none = make_implicit_nl_encoder(
        lambda p, z: torch.tanh(z @ pl[0]) @ pl[1], z0=z0t, **MLP_SOLVE)
    x2 = torch.from_numpy(x).requires_grad_()
    z_list = enc_list(x2, pl, 0.1)
    (gx_list,) = torch.autograd.grad(torch.sum(z_list * torch.from_numpy(c)),
                                     x2)
    assert all(p.grad is None for p in pl)
    z_none = enc_none(x2, None, 0.1)
    np.testing.assert_array_equal(n(z_none), n(z_list))
    (gx_none,) = torch.autograd.grad(torch.sum(z_none * torch.from_numpy(c)),
                                     x2)
    np.testing.assert_array_equal(n(gx_none), n(gx_list))
    assert all(p.grad is None for p in pl)
    torch.sum(enc_list(x2, pl, 0.1) * torch.from_numpy(c)).backward()
    assert all(p.grad is not None and p.grad.abs().max() > 0 for p in pl)
