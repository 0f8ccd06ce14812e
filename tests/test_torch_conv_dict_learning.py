"""lasso_tpu_torch's conv dictionary learning against lasso_tpu's on the same
numpy inputs: ``batch_cg_conv2d``, ``update_kernel``,
``update_kernel_constrained`` (on JAX's draw) and the EM loop
``_conv_dict_learning`` (on JAX's draws, derived from the same PRNGKey as
``lasso_tpu/conv2d/dict_learning.py`` derives them), with the port on the
CPU (the unfused conv FISTA of ``ista_conv2d``).

Tolerances: in float64 (``jax.enable_x64``) the CG solves and the filter
refits agree to 1e-9 relative to their largest entry (the same CG
arithmetic in both packages; the stride-2 refit's normal operator is the
worst conditioned, and parts by about 1e-10), and four EM steps to 1e-7
(losses) and 1e-6 (filters). The float32 run, on draws carried over by
``from_numpy_params``, to 1e-4 (losses) and 1e-3 (filters): f32 convolutions
sum in another order in each package, and a CG refit of 30 iterations
carries that through four EM steps. The public loop's own property is that
of tests/test_conv_dict_learning.py:76-89: losses finite and
non-increasing (diff < 1e-6), unit filters within 1e-4.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lasso_tpu.conv2d import conv_dict_learning as j_cdl
from lasso_tpu.conv2d import conv_transpose2d as j_convt
from lasso_tpu.conv2d import update_kernel as j_update
from lasso_tpu.conv2d import update_kernel_constrained as j_update_c
from lasso_tpu.linalg import batch_cg_conv2d as j_bcg
import lasso_tpu_torch.conjgrad as shim
from lasso_tpu_torch.conv2d import (conv_dict_learning, conv_transpose2d,
                                    update_kernel, update_kernel_constrained)
from lasso_tpu_torch.conv2d.dict_learning import (
    _conv_dict_learning, _update_kernel_constrained)
from lasso_tpu_torch.linalg import batch_cg_conv2d
from lasso_tpu_torch.utils import from_numpy_params

from _torch_port import (n, one_torch_thread,  # noqa: F401
                         release_jax_after_module, t)

# (stride, padding, image size): stride 2 with an odd image, whose size the
# transpose convolution reproduces
GEOMETRY = {1: (1, 0, 10), 2: (2, 1, 9)}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


def _filters(rng, k, c, ks):
    W = rng.standard_normal((k, c, ks, ks))
    return W / np.sqrt((W ** 2).sum(axis=(1, 2, 3), keepdims=True))


def _images(rng, W, n_img, stride, padding, size, density=0.2):
    """Images from a sparse code over W, plus a little noise; the codes."""
    hz = (size + 2 * padding - W.shape[2]) // stride + 1
    Z = rng.standard_normal((n_img, W.shape[0], hz, hz))
    Z *= rng.random(Z.shape) < density
    X = np.asarray(j_convt(jnp.asarray(Z), jnp.asarray(W), stride=stride,
                           padding=padding))
    return X + 0.01 * rng.standard_normal(X.shape), Z


def _jax_draws(key, shape, steps, dtype):
    """The initial filters (normalized) and the per-step replacement draws
    of lasso_tpu's conv_dict_learning for ``key``, as it draws them."""
    key, init_key = jax.random.split(key)
    w0 = jax.random.normal(init_key, shape, dtype=dtype)
    w0 = w0 / (jnp.sqrt(jnp.sum(jnp.square(w0), axis=(1, 2, 3),
                                keepdims=True)) + 1e-30)
    rand = jnp.stack([jax.random.normal(k, shape, dtype=dtype)
                      for k in jax.random.split(key, steps)])
    return np.array(w0), np.array(rand)


@pytest.mark.parametrize("stride", [1, 2])
def test_batch_cg_conv2d_matches_jax(stride):
    """tik 0 and 0.5, the default stops (rtol 1) and a tight solve (rtol 0),
    which must also solve the system: 2 code channels over 3 image
    channels make the normal operator definite."""
    s, p, size = GEOMETRY[stride]
    rng = np.random.default_rng(stride)
    W = _filters(rng, 2, 3, 3)
    hz = (size + 2 * p - 3) // s + 1
    b = rng.standard_normal((3, 2, hz, hz))
    with jax.enable_x64():
        for tik in (0.0, 0.5):
            for kw in ({}, {"rtol": 0.0, "maxiter": 200, "tol": 1e-11}):
                xj = jax.jit(lambda W_, b_: j_bcg(
                    W_, b_, tik=tik, stride=s, padding=p, **kw))(
                        jnp.asarray(W), jnp.asarray(b))
                xt = batch_cg_conv2d(t(W), t(b), tik=tik, stride=s,
                                     padding=p, **kw)
                assert _rel(xj, n(xt)) < 1e-9, (tik, kw)
            # the tight solve solves (W^T W + tik) x = b (to 1e-7: its
            # condition number at tik 0 is large)
            Wt = t(W)
            Ax = torch.nn.functional.conv2d(
                conv_transpose2d(xt, Wt, stride=s, padding=p), Wt, stride=s,
                padding=p) + tik * xt
            assert _rel(b, n(Ax)) < 1e-7
    assert shim.batch_cg_conv2d is batch_cg_conv2d


@pytest.mark.parametrize("stride", [1, 2])
def test_update_kernel_matches_jax(stride):
    """The warm-started CG refit from far-off filters, lambd 0 and 1e-3;
    at 200 iterations it zeroes the filter-space gradient."""
    s, p, size = GEOMETRY[stride]
    rng = np.random.default_rng(10 + stride)
    W = _filters(rng, 4, 2, 3)
    X, Z = _images(rng, W, 3, s, p, size)
    W0 = _filters(rng, 4, 2, 3)
    with jax.enable_x64():
        for lambd in (0.0, 1e-3):
            wj = jax.jit(lambda *a: j_update(
                *a, stride=s, padding=p, lambd=lambd, cg_iters=40))(
                    jnp.asarray(X), jnp.asarray(Z), jnp.asarray(W0))
            wt = update_kernel(t(X), t(Z), t(W0), stride=s, padding=p,
                               lambd=lambd, cg_iters=40)
            assert _rel(wj, n(wt)) < 1e-9, lambd
    fit = update_kernel(t(X), t(Z), t(W0), stride=s, padding=p,
                        cg_iters=200, cg_tol=1e-12)
    R = (conv_transpose2d(t(Z), fit, stride=s, padding=p) - t(X)).requires_grad_()
    V = fit.clone().requires_grad_()
    g, = torch.autograd.grad(torch.sum(conv_transpose2d(
        t(Z), V, stride=s, padding=p) * R.detach()), V)
    assert float(g.abs().max()) < 1e-8
    with pytest.raises(TypeError, match="ProcessGroup"):
        update_kernel(t(X), t(Z), t(W0), axis_name="batch")


def test_update_kernel_constrained_on_jax_draw():
    """A dead code channel over a zero filter: its refit is exactly zero,
    so it takes JAX's normalized draw and its codes stay zero; the other
    filters are unit-norm. The public function draws from a generator."""
    rng = np.random.default_rng(20)
    W = _filters(rng, 4, 1, 3)
    X, Z = _images(rng, W, 4, 1, 0, 10)
    Z[:, 2] = 0.0
    W0 = _filters(rng, 4, 1, 3)
    W0[2] = 0.0
    key = jax.random.PRNGKey(3)
    with jax.enable_x64():
        wj, zj = jax.jit(j_update_c)(jnp.asarray(X), jnp.asarray(Z),
                                     jnp.asarray(W0), key)
        rand = np.array(jax.random.normal(key, W0.shape,
                                          dtype=jnp.float64))
    wt, zt = _update_kernel_constrained(t(X), t(Z), t(W0), t(rand))
    assert _rel(wj, n(wt)) < 1e-9
    np.testing.assert_array_equal(n(zt), np.asarray(zj))
    np.testing.assert_allclose(n(wt)[2], rand[2] / np.linalg.norm(rand[2]),
                               rtol=1e-12)
    np.testing.assert_allclose(np.linalg.norm(n(wt).reshape(4, -1), axis=1),
                               1.0, rtol=1e-12)
    g = torch.Generator().manual_seed(5)
    wg, zg = update_kernel_constrained(t(X), t(Z), t(W0), generator=g)
    assert np.all(n(zg)[:, 2] == 0.0)
    np.testing.assert_allclose(np.linalg.norm(n(wg).reshape(4, -1), axis=1),
                               1.0, rtol=1e-12)


@pytest.mark.parametrize("case", ["constrained", "unconstrained_persist",
                                  "f32_from_numpy_params"])
def test_conv_dict_learning_on_jax_draws(case):
    """Four EM steps of the port's loop on JAX's draws against JAX's
    conv_dict_learning: weights and losses."""
    rng = np.random.default_rng(30)
    W_true = _filters(rng, 4, 1, 3)
    X, _ = _images(rng, W_true, 6, 1, 0, 10)
    f64 = case != "f32_from_numpy_params"
    kw = dict(alpha=0.05, steps=4, maxiter=30,
              constrained=case != "unconstrained_persist",
              persist=case == "unconstrained_persist")
    key = jax.random.PRNGKey(1)
    with jax.enable_x64(f64):
        dtype = jnp.float64 if f64 else jnp.float32
        Xj = jnp.asarray(X, dtype)
        wj, lj = jax.jit(lambda X_, k_: j_cdl(
            X_, n_filters=4, kernel_size=3, key=k_, **kw))(Xj, key)
        w0, rand = _jax_draws(key, (4, 1, 3, 3), 4, dtype)
    if f64:
        Xt, w0t, randt = t(X), t(w0), t(rand)
    else:
        p = from_numpy_params({"weight0": w0, "step_rand": rand,
                               "x": np.asarray(Xj)}, "cpu")
        Xt, w0t, randt = p["x"], p["weight0"], p["step_rand"]
        assert torch.equal(w0t, torch.from_numpy(w0))
    wt, lt = _conv_dict_learning(Xt, w0t, randt if kw["constrained"] else None,
                                 **kw)
    tol_l, tol_w = (1e-7, 1e-6) if f64 else (1e-4, 1e-3)
    np.testing.assert_allclose(n(lt), np.asarray(lj), rtol=tol_l)
    assert _rel(wj, n(wt)) < tol_w


def test_conv_dict_learning_with_a_generator_descends():
    """The public loop (tests/test_conv_dict_learning.py:76-89's property):
    losses finite and non-increasing, with real progress, unit filters."""
    rng = np.random.default_rng(40)
    W_true = _filters(rng, 4, 1, 3)
    X, _ = _images(rng, W_true, 12, 1, 0, 10, density=0.08)
    g = torch.Generator().manual_seed(1)
    W, losses = conv_dict_learning(t(X).float(), n_filters=4, kernel_size=3,
                                   alpha=0.05, steps=10, maxiter=60,
                                   generator=g)
    losses = n(losses)
    assert losses.shape == (10,) and np.isfinite(losses).all()
    assert np.all(np.diff(losses) < 1e-6) and losses[-1] < 0.95 * losses[0]
    assert tuple(W.shape) == (4, 1, 3, 3)
    np.testing.assert_allclose(np.linalg.norm(n(W).reshape(4, -1), axis=1),
                               1.0, atol=1e-4)


def test_from_numpy_params_checks_conv_training_state():
    """'weight0' alone makes a conv dictionary; 'step_rand' and a second
    dictionary must agree with it."""
    w0 = np.ones((4, 1, 3, 3))
    p = from_numpy_params({"weight0": w0, "step_rand": np.ones((5,) + w0.shape)},
                          "cpu")
    assert p["weight0"].dtype == torch.float32
    assert tuple(p["step_rand"].shape) == (5, 4, 1, 3, 3)
    with pytest.raises(ValueError, match="step_rand"):
        from_numpy_params({"weight0": w0, "step_rand": np.ones((5, 4, 1, 3))},
                          "cpu")
    with pytest.raises(ValueError, match="weight0"):
        from_numpy_params({"weight": w0, "weight0": np.ones((4, 2, 3, 3))},
                          "cpu")
