"""lasso_tpu_torch.conv2d.ista_conv2d against lasso_tpu's on the same numpy
inputs, on both routes (the fused kernels' plain versions with
``use_pallas=True``, the unfused library convolutions with False), and the
conv paths of chunked_encode and from_numpy_params.

Tolerances (tests/test_fused_conv.py's between routes): codes atol 5e-5
in f32, 5e-4 for 'mixed' and 'bf16' (a residual that rounds to another
bf16 neighbour in one package moves the codes by more than f32 sums do);
restart atol 1e-4. ``n_iter`` is equal: the fused route tests convergence
at the same block boundaries in both packages.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lasso_tpu.conv2d import conv_lasso_loss as j_loss
from lasso_tpu.conv2d import ista_conv2d as j_ista
from lasso_tpu.utils import chunked_encode as j_chunked
from lasso_tpu_torch.conv2d import conv_lasso_loss, ista_conv2d
from lasso_tpu_torch.utils import chunked_encode, from_numpy_params

from _torch_port import n, one_torch_thread, t  # noqa: F401


@pytest.fixture(autouse=True)
def _release_jax_executables():
    """JAX keeps every executable it compiles, each holding memory
    mappings of its code, and this file's solves compile many. A process
    may hold 65530 mappings, and pytest-xdist runs many test files in one
    process, so each test here gives its executables back."""
    yield
    jax.clear_caches()


def _problem(seed, nn, cz, cx, hz, wz, kh, kw, pad=0, wscale=0.25,
             stride=1):
    rng = np.random.default_rng(seed)
    h = (hz - 1) * stride + kh - 2 * pad
    w = (wz - 1) * stride + kw - 2 * pad
    x = rng.standard_normal((nn, cx, h, w)).astype(np.float32)
    W = (rng.standard_normal((cz, cx, kh, kw)) * wscale).astype(np.float32)
    z0 = np.zeros((nn, cz, hz, wz), np.float32)
    return x, W, z0


def _both(x, z0, W, alpha, use_pallas, **kw):
    """(z, n_iter) of JAX and of the port, each on the route of
    ``use_pallas``."""
    a = jnp.asarray(alpha) if isinstance(alpha, np.ndarray) else alpha
    zj, kj = j_ista(jnp.asarray(x), jnp.asarray(z0), jnp.asarray(W), a,
                    use_pallas=use_pallas, return_iters=True, **kw)
    at = t(alpha) if isinstance(alpha, np.ndarray) else alpha
    zt, kt = ista_conv2d(t(x), t(z0), t(W), at, use_pallas=use_pallas,
                         return_iters=True, **kw)
    return n(zj), int(kj), n(zt), kt


@pytest.mark.parametrize("tol,kp,maxiter", [
    (0.0, "f32", 30), (1e-6, "f32", 50), (0.0, "mixed", 32),
    (0.0, "bf16", 24)])
def test_routes_match_jax(tol, kp, maxiter):
    """Both routes of both packages, tests/test_fused_conv.py:128-146's
    problem."""
    x, W, z0 = _problem(11, 4, 16, 1, 10, 10, 5, 5)
    kw = dict(maxiter=maxiter, tol=tol, kernel_precision=kp)
    atol = 5e-5 if kp == "f32" else 5e-4
    for use_pallas in (True, False):
        zj, kj, zt, kt = _both(x, z0, W, 0.1, use_pallas, **kw)
        assert kt == kj == maxiter
        np.testing.assert_allclose(zt, zj, atol=atol)


def test_tol_stops_on_the_same_block_boundary():
    """tol 1e-3: the unfused route stops at 44 iterations in both packages;
    the fused route (S = 15, the largest divisor of 60 <= 16) at the next
    block boundary, 45, in both; never earlier than unfused."""
    x, W, z0 = _problem(11, 4, 16, 1, 10, 10, 5, 5)
    kw = dict(maxiter=60, tol=1e-3)
    zj_f, kj_f, zt_f, kt_f = _both(x, z0, W, 0.1, True, **kw)
    zj_u, kj_u, zt_u, kt_u = _both(x, z0, W, 0.1, False, **kw)
    assert (kt_f, kt_u) == (kj_f, kj_u) == (45, 44)
    np.testing.assert_allclose(zt_f, zj_f, atol=5e-5)
    np.testing.assert_allclose(zt_u, zj_u, atol=5e-5)


@pytest.mark.parametrize("kp,maxiter", [("f32", 36), ("mixed", 37)])
def test_restart_matches_jax(kp, maxiter):
    """Per-sample restart on both routes; the t vector rides across fused
    blocks, the remainder block and the phase switch."""
    x, W, z0 = _problem(13, 4, 16, 1, 10, 10, 5, 5)
    for use_pallas in (True, False):
        zj, kj, zt, kt = _both(x, z0, W, 0.1, use_pallas, maxiter=maxiter,
                               tol=0.0, restart=True, kernel_precision=kp)
        assert kt == kj == maxiter
        np.testing.assert_allclose(zt, zj,
                                   atol=1e-4 if kp == "f32" else 5e-4)


def test_remainder_blocks_and_nonneg():
    """maxiter 37 (no divisor in 4..16: eight-step blocks and a remainder
    of 5), padding 1 with a 3x3 filter, and the nonneg prox."""
    x, W, z0 = _problem(5, 2, 8, 1, 8, 8, 3, 3, pad=1)
    for use_pallas in (True, False):
        for nonneg in (False, True):
            zj, kj, zt, kt = _both(x, z0, W, 0.1, use_pallas, maxiter=37,
                                   tol=0.0, padding=1, nonneg=nonneg)
            assert kt == kj == 37
            np.testing.assert_allclose(zt, zj, atol=5e-5)
            if nonneg:
                assert zt.min() >= 0.0


def test_per_sample_and_per_channel_alpha():
    """An [N] alpha runs the alpha=1 solve on x/a and z0/a; a (1, Cz) or
    (Cz,) alpha becomes a per-channel threshold (a [Cz] column in the
    kernels)."""
    x, W, z0 = _problem(17, 3, 8, 2, 7, 9, 4, 2, pad=1)
    rng = np.random.default_rng(3)
    a_n = rng.uniform(0.05, 0.3, (3,)).astype(np.float32)
    a_c = rng.uniform(0.05, 0.3, (1, 8)).astype(np.float32)
    kw = dict(maxiter=20, tol=0.0, lr=0.05, padding=1)
    for alpha in (a_n, a_c, a_c[0]):
        for use_pallas in (True, False):
            zj, kj, zt, kt = _both(x, z0, W, alpha, use_pallas, **kw)
            assert kt == kj == 20
            np.testing.assert_allclose(zt, zj, atol=5e-5)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("geom", [
    (16, 1, 10, 10, 5, 5, 0), (8, 2, 7, 9, 4, 2, 1), (8, 1, 7, 7, 3, 3, 0),
    (64, 1, 10, 10, 7, 7, 0), (8, 1, 6, 8, 11, 11, 0), (8, 1, 5, 5, 3, 9, 1),
    (16, 8, 6, 6, 3, 3, 0), (4, 3, 5, 6, 2, 3, 1), (12, 2, 9, 7, 5, 1, 2),
    (8, 4, 3, 11, 1, 1, 0)])
def test_geometry_matches_jax_unfused(geom, use_pallas):
    """Each of the port's routes against JAX's unfused route at each
    geometry (Cz, Cx, Hz, Wz, kh, kw, padding), 12 iterations at the
    automatic lr (the Araujo bound in both packages) where the kernel is
    odd and square, else at lr 0.05: codes atol 5e-5, the tolerance
    between routes."""
    cz, cx, hz, wz, kh, kw, pad = geom
    x, W, z0 = _problem(sum(geom), 2, cz, cx, hz, wz, kh, kw, pad=pad,
                        wscale=1.0 / np.sqrt(cz * kh * kw))
    kw_ = dict(maxiter=12, tol=0.0, padding=pad)
    if kh != kw or kh % 2 == 0:
        kw_["lr"] = 0.05
    zj, kj = j_ista(jnp.asarray(x), jnp.asarray(z0), jnp.asarray(W), 0.1,
                    use_pallas=False, return_iters=True, **kw_)
    zt, kt = ista_conv2d(t(x), t(z0), t(W), 0.1, use_pallas=use_pallas,
                         return_iters=True, **kw_)
    assert kt == int(kj) == 12
    np.testing.assert_allclose(n(zt), n(zj), atol=5e-5)


def test_stride_two_with_lip_constant():
    """Stride 2 takes the unfused route, with lr = 1/lip_constant (the
    Araujo bound needs stride 1). The port's power iteration starts from
    its own draw, so its lr differs from JAX's by the iteration's
    convergence and the objectives agree to 1e-3 relative; with a given lr
    the codes agree to 5e-5."""
    x, W, z0 = _problem(23, 2, 6, 2, 5, 5, 3, 3, pad=1, stride=2)
    kw = dict(stride=2, padding=1, maxiter=40, tol=0.0)
    zj, kj, zt, kt = _both(x, z0, W, 0.1, "auto", **kw)
    assert kt == kj == 40
    fj = float(j_loss(jnp.asarray(x), jnp.asarray(zj), jnp.asarray(W), 0.1,
                      stride=2, padding=1))
    ft = float(conv_lasso_loss(t(x), t(zt), t(W), 0.1, stride=2,
                               padding=1))
    np.testing.assert_allclose(ft, fj, rtol=1e-3)
    zl, _, zlt, _ = _both(x, z0, W, 0.1, "auto", lr=0.02, **kw)
    np.testing.assert_allclose(zlt, zl, atol=5e-5)


def test_unfused_options_match_jax(capsys):
    """fast=False (plain ISTA), an explicit mixed_tail, verbose (a loss
    line an iteration: the fused route does not take verbose)."""
    x, W, z0 = _problem(29, 2, 8, 1, 8, 8, 3, 3)
    zj, kj, zt, kt = _both(x, z0, W, 0.1, True, maxiter=12, tol=0.0,
                           fast=False)
    assert kt == kj == 12
    np.testing.assert_allclose(zt, zj, atol=5e-5)
    zj, kj, zt, kt = _both(x, z0, W, 0.1, True, maxiter=20, tol=0.0,
                           kernel_precision="mixed", mixed_tail=7)
    np.testing.assert_allclose(zt, zj, atol=5e-4)
    capsys.readouterr()
    ista_conv2d(t(x), t(z0), t(W), 0.1, maxiter=5, tol=0.0, verbose=True,
                use_pallas=True)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 5 and all(ln.startswith("loss: ") for ln in lines)


def test_validation():
    x, W, z0 = _problem(1, 2, 8, 1, 8, 8, 3, 3)
    args = (t(x), t(z0), t(W), 0.1)
    with pytest.raises(TypeError, match="ProcessGroup"):
        ista_conv2d(*args, axis_name="batch")
    for bad in ({"kernel_precision": "fp8"}, {"lr": "fast"},
                {"kernel_precision": "mixed", "mixed_tail": 0},
                {"restart": True, "fast": False}):
        with pytest.raises(ValueError):
            ista_conv2d(*args, maxiter=4, **bad)


def test_chunked_encode_conv():
    """11 images in chunks of 4 (the tail chunk padded), padding 1 and a
    per-sample alpha forwarded: against JAX's chunked_encode, and each row
    against a direct ista_conv2d call on that row's chunk."""
    x, W, _ = _problem(31, 11, 8, 1, 8, 8, 3, 3, pad=1)
    a = np.random.default_rng(4).uniform(0.05, 0.2, (11,)).astype(
        np.float32)
    kw = dict(maxiter=15, tol=0.0, padding=1)
    want = j_chunked(x, W, alpha=a, chunk_size=4, algorithm="ista_conv2d",
                     **kw)
    got = chunked_encode(x, W, alpha=a, chunk_size=4,
                         algorithm="ista_conv2d", device="cpu",
                         use_pallas=True, **kw)
    assert got.shape == (11, 8, 8, 8) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=5e-5)
    tail = np.concatenate([x[8:], np.zeros((1,) + x.shape[1:], np.float32)])
    direct = ista_conv2d(t(tail), torch.zeros((4, 8, 8, 8)), t(W),
                         t(np.concatenate([a[8:], [1.0]]).astype(
                             np.float32)), use_pallas=True, **kw)
    np.testing.assert_allclose(got[8:], n(direct)[:3], atol=1e-6)


def test_from_numpy_params_conv_and_loss():
    """A conv dictionary carries over with its images, codes and alpha;
    mismatched geometry raises; conv_lasso_loss matches JAX's."""
    x, W, z0 = _problem(37, 3, 8, 2, 7, 9, 4, 2, pad=1)
    a = np.full((1, 8), 0.1, np.float32)
    p = from_numpy_params({"weight": W, "x": x, "z0": z0, "alpha": a},
                          "cpu")
    assert from_numpy_params({"weight": W, "x": x}, "cpu",
                             padding=1)["x"].shape == x.shape
    zt = ista_conv2d(p["x"], p["z0"], p["weight"], p["alpha"], padding=1,
                     maxiter=10, tol=0.0, lr=0.05, use_pallas=True)
    zj = j_ista(jnp.asarray(x), jnp.asarray(z0), jnp.asarray(W),
                jnp.asarray(a), padding=1, maxiter=10, tol=0.0, lr=0.05,
                use_pallas=True)
    np.testing.assert_allclose(n(zt), n(zj), atol=5e-5)
    np.testing.assert_allclose(
        float(conv_lasso_loss(p["x"], zt, p["weight"], p["alpha"].reshape(
            1, 8, 1, 1), padding=1)),
        float(j_loss(jnp.asarray(x), zj, jnp.asarray(W),
                     jnp.asarray(a).reshape(1, 8, 1, 1), padding=1)),
        rtol=1e-5)
    for bad in ({"weight": W, "x": x, "z0": z0[:, :, :6]},
                {"weight": W, "x": x[:, :1]},
                {"weight": W, "z0": z0, "alpha": np.ones(5, np.float32)},
                {"weight": W, "atoms": np.zeros((1, 8, 8))}):
        with pytest.raises(ValueError):
            from_numpy_params(bad, "cpu")
    with pytest.raises(ValueError):
        from_numpy_params({"weight": W, "x": x, "z0": z0}, "cpu", padding=0)
