"""lasso_tpu_torch's group_ista against lasso_tpu's on the same numpy
inputs: both routes of the six configurations of tests/test_group_lasso.py
(unfused atol 1e-5; fused, the port's plain kernels against JAX's kernel in
interpret mode, atol 1e-4, the JAX test's own bound), equal ``n_iter``
everywhere, the stopping test, the 'mixed' tail identities, padding,
per-sample alpha, the dispatch, training and the parameter carry-over.
"""

import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lasso_tpu.linear import dict_learning as j_dict_learning
from lasso_tpu.linear import sparse_encode as j_encode
from lasso_tpu.linear.solvers import group_ista as jg
from lasso_tpu.linear.solvers import group_lasso_objective as j_obj
from lasso_tpu.linear.solvers.group_lasso import resolve_groups as j_resolve
from lasso_tpu.ops import fused_group as j_fused_group
from lasso_tpu.utils import chunked_encode as j_chunked
from lasso_tpu_torch.linear import sparse_encode
from lasso_tpu_torch.linear.solvers import (group_ista, group_lasso_objective,
                                            resolve_groups)
from lasso_tpu_torch.utils import chunked_encode, from_numpy_params

from _torch_port import n, one_torch_thread, t  # noqa: F401
from _torch_port import release_jax_after_module  # noqa: F401

tdl = importlib.import_module("lasso_tpu_torch.linear.dict_learning")


def _aligned(rng, nn=16, d=128, k=256):
    W = rng.standard_normal((d, k)).astype(np.float32)
    W /= np.linalg.norm(W, axis=0, keepdims=True)
    x = rng.standard_normal((nn, d)).astype(np.float32)
    return x, W


def _both(x, W, z0=None, **kw):
    """(z_jax, n_iter_jax, z_port, n_iter_port) of one group_ista call."""
    if z0 is None:
        z0 = np.zeros((x.shape[0], W.shape[1]), np.float32)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray)
               and v.dtype.kind == "f" else v) for k, v in kw.items()}
    tkw = {k: (t(v) if isinstance(v, np.ndarray) and v.dtype.kind == "f"
               else v) for k, v in kw.items()}
    zj, kj = jg(jnp.asarray(x), jnp.asarray(z0), jnp.asarray(W),
                return_iters=True, **jkw)
    zt, kt = group_ista(t(x), t(z0), t(W), return_iters=True, **tkw)
    return n(zj), int(kj), n(zt), kt


@pytest.fixture
def jax_group_shrink_in_f32(monkeypatch):
    """JAX's fused group kernel with its group shrink summed in f32, the
    one difference the port keeps on purpose (ROADMAP C: the TPU kernel
    splits v^2 and the group scale into bf16 hi + lo): the like-for-like
    reference of the port's fused 'f32' route, whose products are the same
    bf16x3 split. The executables traced with it are dropped after."""
    hp = jax.lax.Precision.HIGHEST

    def shrink_f32(v, thg_row, m_fwd, m_bwd, split_float, emulate):
        norms = jnp.sqrt(jnp.maximum(jnp.dot(v * v, m_fwd, precision=hp),
                                     0.0))
        nz = norms > 0.0
        scale = jnp.where(
            nz, jnp.maximum(1.0 - thg_row / jnp.where(nz, norms, 1.0), 0.0),
            0.0)
        return v * jnp.dot(scale, m_bwd, precision=hp)

    jax.clear_caches()
    monkeypatch.setattr(j_fused_group, "_group_prox_mxu", shrink_f32)
    yield
    jax.clear_caches()


def _gobj(x, W, z, alpha, groups, weights=None, l1=0.0):
    return float(j_obj(jnp.asarray(x), jnp.asarray(W),
                       jnp.asarray(np.asarray(z)), alpha, groups,
                       weights=weights, l1_alpha=l1))


@pytest.mark.parametrize("cfg", [
    dict(groups=8),                                     # contiguous blocks
    dict(groups="ids"),                                 # arbitrary ids
    dict(groups=8, group_weights="yuanlin"),            # weighted
    dict(groups=8, l1_alpha=0.05),                      # sparse-group
    dict(groups=8, restart=True),                       # per-row restart
    dict(groups=8, fast=False),                         # plain ISTA
], ids=["block", "ids", "weights", "l1", "restart", "ista"])
def test_group_ista_matches_jax(rng, cfg):
    x, W = _aligned(rng)
    cfg = dict(cfg)
    k = W.shape[1]
    if cfg["groups"] == "ids":
        cfg["groups"] = np.asarray(
            rng.permutation(np.repeat(np.arange(16), k // 16)), np.int32)
    if cfg.get("group_weights") == "yuanlin":
        cfg["group_weights"] = np.full((k // 8,), np.sqrt(8.0), np.float32)
    kw = dict(alpha=0.3, maxiter=32, tol=0.0, lr=0.15, **cfg)
    for use_pallas, atol in ((False, 1e-5), (True, 1e-4)):
        zj, kj, zt, kt = _both(x, W, use_pallas=use_pallas, **kw)
        assert kt == kj == 32
        np.testing.assert_allclose(zt, zj, rtol=0, atol=atol)


def test_tol_stops_like_jax(rng, jax_group_shrink_in_f32):
    """With tol > 0 both packages stop at the same iteration on each
    route; the fused route tests at block ends, so it never stops before
    the unfused one (test_group_lasso.py:289-302). Both fused routes run
    the bf16x3 split, which drifts from true f32 (past 32 iterations the
    JAX kernel, whose group sums are split too, by more than 1e-4), so the
    port's fused codes are held against JAX's kernel with its group shrink
    in f32, at the unfused atol 1e-5."""
    x, W = _aligned(rng)
    kw = dict(alpha=0.3, groups=8, maxiter=64, tol=1e-6, lr=0.15)
    zj_u, kj_u, zt_u, kt_u = _both(x, W, use_pallas=False, **kw)
    zj_f, kj_f, zt_f, kt_f = _both(x, W, use_pallas=True, **kw)
    assert kt_u == kj_u and kt_f == kj_f and kt_f >= kt_u
    np.testing.assert_allclose(zt_u, zj_u, rtol=0, atol=1e-5)
    np.testing.assert_allclose(zt_f, zj_f, rtol=0, atol=1e-5)
    assert _gobj(x, W, zt_f, 0.3, 8) <= _gobj(x, W, zt_u, 0.3, 8) * (1 + 1e-6)
    # a tol that stops within the first fused blocks
    for use_pallas, want in ((False, 15), (True, 32)):
        _, kj, _, kt = _both(x, W, use_pallas=use_pallas,
                             **{**kw, "tol": 1e-2})
        assert kt == kj == want


def test_mixed_tail_iters():
    """test_group_lasso.py:319-349 in the port: the full budget as the
    f32 tail equals the f32 run exactly; a 12-iteration tail runs the whole
    budget and lands between bf16-only and f32 in objective; and the mixed
    run's objective is JAX's (rtol 1e-5)."""
    rng = np.random.default_rng(4)
    nn, d, k = 16, 128, 256
    x = rng.standard_normal((nn, d)).astype(np.float32)
    W = (rng.standard_normal((d, k)) / np.sqrt(d)).astype(np.float32)
    z0 = torch.zeros((nn, k))
    kw = dict(groups=16, lr=0.08, maxiter=200, tol=0.0, use_pallas=True,
              fuse_steps=25)

    def obj(z):
        z = np.asarray(z, np.float64)
        r = z @ W.astype(np.float64).T - x
        g = z.reshape(nn, k // 16, 16)
        return (0.5 * np.sum(r * r)
                + 0.1 * np.sum(np.sqrt(np.sum(g * g, axis=2))))

    z_f = group_ista(t(x), z0, t(W), 0.1, **kw)
    z_full = group_ista(t(x), z0, t(W), 0.1, kernel_precision="mixed",
                        mixed_tail_iters=200, **kw)
    assert torch.equal(z_f, z_full)
    z_12, it = group_ista(t(x), z0, t(W), 0.1, kernel_precision="mixed",
                          mixed_tail_iters=12, return_iters=True, **kw)
    z_b = group_ista(t(x), z0, t(W), 0.1, kernel_precision="bf16", **kw)
    assert it == 200
    f_f, f_12, f_b = obj(n(z_f)), obj(n(z_12)), obj(n(z_b))
    assert f_12 <= f_b + 1e-9, (f_12, f_b)
    assert f_12 >= f_f - 1e-7 * abs(f_f)
    z_j = jg(jnp.asarray(x), jnp.zeros((nn, k)), jnp.asarray(W), 0.1,
             kernel_precision="mixed", mixed_tail_iters=12, **kw)
    np.testing.assert_allclose(f_12, obj(z_j), rtol=1e-5)
    with pytest.raises(ValueError, match="mixed_tail_iters"):
        group_ista(t(x), z0, t(W), 0.1, mixed_tail_iters=10, **kw)


def test_mixed_restart_matches_jax(rng):
    """'mixed' with restart: the per-row t carried across the switch from
    bf16 blocks to the f32 tail; objective rtol 1e-4 against JAX."""
    x, W = _aligned(rng)
    kw = dict(alpha=0.3, groups=8, maxiter=48, tol=0.0, lr=0.15,
              use_pallas=True, restart=True, kernel_precision="mixed")
    zj, kj, zt, kt = _both(x, W, **kw)
    assert kt == kj == 48
    np.testing.assert_allclose(_gobj(x, W, zt, 0.3, 8),
                               _gobj(x, W, zj, 0.3, 8), rtol=1e-4)


def test_pad_route_matches_jax(rng):
    """K = 200, gs = 8 and N = 12 pad onto the fused grid (the padded atoms
    join group 0); tol is rescaled to the original numel, so n_iter
    agrees with JAX at tol > 0 as at tol = 0."""
    x, W = _aligned(rng, nn=12, d=128, k=200)
    for tol in (0.0, 1e-4):
        kw = dict(alpha=0.2, groups=8, maxiter=32, tol=tol, lr=0.15,
                  use_pallas=True, fuse_steps=8)
        zj, kj, zt, kt = _both(x, W, **kw)
        assert zt.shape == (12, 200) and kt == kj
        np.testing.assert_allclose(zt, zj, rtol=0, atol=1e-4)


def test_per_sample_alpha_with_l1(rng):
    """Per-sample alpha with l1 rescales l1 into an [N, 1] column, which
    takes the unfused route in both packages (even with use_pallas)."""
    x, W = _aligned(rng, nn=8)
    a = np.array([0.05, 0.15, 0.4, 0.8, 0.1, 0.2, 0.3, 0.5], np.float32)
    for use_pallas in (False, True):
        kw = dict(alpha=a, groups=8, l1_alpha=0.05, maxiter=60, tol=1e-6,
                  lr=0.15, use_pallas=use_pallas)
        zj, kj, zt, kt = _both(x, W, **kw)
        assert kt == kj
        np.testing.assert_allclose(zt, zj, rtol=0, atol=1e-5)


def test_sparse_encode_and_chunked_dispatch(rng, jax_group_shrink_in_f32):
    """sparse_encode and chunked_encode reach group_ista. The port's fused
    route (the bf16x3 split) is held against JAX's fused route with its
    group shrink in f32 at atol 1e-5: with its group sums split too, the
    JAX kernel drifts past 1e-4 from true f32 at this alpha."""
    x, W = _aligned(rng, nn=20)
    kw = dict(groups=8, maxiter=32, tol=0.0, lr=0.15)
    zj, kj = j_encode(jnp.asarray(x), jnp.asarray(W), 0.2,
                      algorithm="group-ista", return_iters=True,
                      use_pallas=True, **kw)
    zt, kt = sparse_encode(t(x), t(W), 0.2, algorithm="group-ista",
                           return_iters=True, use_pallas=True, **kw)
    assert kt == int(kj) == 32
    np.testing.assert_allclose(n(zt), n(zj), rtol=0, atol=1e-5)
    # per-sample alpha goes natively to group_ista
    a = (0.1 + 0.2 * rng.random(20)).astype(np.float32)
    zj = j_encode(jnp.asarray(x), jnp.asarray(W), jnp.asarray(a),
                  algorithm="group-ista", use_pallas=True, **kw)
    zt = sparse_encode(t(x), t(W), t(a), algorithm="group-ista",
                       use_pallas=True, **kw)
    np.testing.assert_allclose(n(zt), n(zj), rtol=0, atol=1e-5)
    want = j_chunked(x, W, alpha=0.2, chunk_size=8, algorithm="group-ista",
                     use_pallas=True, **kw)
    got = chunked_encode(x, W, alpha=0.2, chunk_size=8,
                         algorithm="group-ista", device="cpu",
                         use_pallas=True, **kw)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="group_weights"):
        sparse_encode(t(x), t(W), torch.ones((1, 256)),
                      algorithm="group-ista", groups=8)
    with pytest.raises(ValueError, match="groups"):
        group_ista(t(x), torch.zeros((20, 256)), t(W), alpha=0.2)
    with pytest.raises(TypeError, match="ProcessGroup"):
        group_ista(t(x), torch.zeros((20, 256)), t(W), groups=8,
                   axis_name="batch")
    with pytest.raises(ValueError, match="restart"):
        group_ista(t(x), torch.zeros((20, 256)), t(W), groups=8,
                   restart=True, fast=False)


def test_resolve_groups_and_objective_match_jax(rng):
    x, W = _aligned(rng, nn=6, d=128, k=128)
    z = (rng.standard_normal((6, 128))
         * (rng.random((6, 128)) < 0.3)).astype(np.float32)
    ids = rng.integers(0, 5, size=128).astype(np.int32)
    ids[:5] = np.arange(5)
    w = np.array([0.5, 1.0, 2.0, 0.1, 3.0], np.float32)
    for groups, weights in ((4, None), (ids, w)):
        kj, dj, gj = j_resolve(groups, 128)
        kt, dt, gt = resolve_groups(groups, 128)
        assert (kt, gt) == (kj, gj)
        np.testing.assert_array_equal(dt, dj)
        want = _gobj(x, W, z, 0.3, groups, weights, 0.05)
        got = float(group_lasso_objective(t(x), t(W), t(z), 0.3, groups,
                                          weights=weights, l1_alpha=0.05))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    assert resolve_groups(torch.from_numpy(ids), 128)[2] == 5
    for bad in (5, None, np.array([0, 2]), 0):
        with pytest.raises(ValueError):
            resolve_groups(bad, 2 if isinstance(bad, np.ndarray) else 32)


def test_group_dict_learning_matches_jax(rng):
    """dict_learning(algorithm='group-ista', groups=4) on the JAX package's
    draws: losses rtol 1e-4, atoms atol 1e-4 (as the other EM loops)."""
    N, D, K, steps = 32, 16, 24, 3
    X = rng.standard_normal((N, D)).astype(np.float32)
    kw = dict(algorithm="group-ista", groups=4, maxiter=60, tol=0.0)
    Wj, lj = j_dict_learning(jnp.asarray(X), K, alpha=0.1, steps=steps,
                             key=jax.random.PRNGKey(1), **kw)
    key, init_key = jax.random.split(jax.random.PRNGKey(1))
    w0 = np.asarray(jax.nn.initializers.orthogonal()(init_key, (D, K)))
    w0 = w0 / (np.linalg.norm(w0, axis=0, keepdims=True) + 1e-30)
    atoms = np.stack([np.asarray(jax.random.normal(k, (K, D)))
                      for k in jax.random.split(key, steps)])
    Wt, lt = tdl._dict_learning(t(X), t(w0.astype(np.float32)),
                                t(atoms.astype(np.float32)), alpha=0.1,
                                steps=steps, **kw)
    np.testing.assert_allclose(n(lt), np.asarray(lj), rtol=1e-4)
    np.testing.assert_allclose(n(Wt), np.asarray(Wj), rtol=0, atol=1e-4)
    assert n(lt)[-1] < n(lt)[0]


def test_from_numpy_params_groups(rng):
    """The JAX package's groups and group_weights pass through
    from_numpy_params to the port's group_ista unchanged in meaning."""
    x, W = _aligned(rng, nn=8)
    ids = np.asarray(rng.permutation(np.repeat(np.arange(16), 16)),
                     np.int32)
    gw = np.sqrt(np.full(16, 16.0))
    p = from_numpy_params({"weight": W, "x": x, "groups": ids,
                           "group_weights": gw}, "cpu")
    assert p["groups"].dtype == torch.int32
    assert p["group_weights"].dtype == torch.float32
    kw = dict(alpha=0.2, maxiter=30, tol=0.0, lr=0.15, use_pallas=True)
    zj = jg(jnp.asarray(x), jnp.zeros((8, 256)), jnp.asarray(W),
            groups=ids, group_weights=jnp.asarray(gw, jnp.float32), **kw)
    zt = group_ista(p["x"], torch.zeros((8, 256)), p["weight"],
                    groups=p["groups"], group_weights=p["group_weights"],
                    **kw)
    np.testing.assert_allclose(n(zt), n(zj), rtol=0, atol=1e-4)
    assert from_numpy_params({"weight": W, "groups": np.int64(8)},
                             "cpu")["groups"] == 8
    assert from_numpy_params({"weight": W, "groups": ids.astype(np.int64)},
                             "cpu")["groups"].dtype == torch.int64
    for bad in ({"groups": 7}, {"groups": ids[:-1]},
                {"groups": ids.astype(np.float32)},
                {"groups": 8, "group_weights": np.ones(16)},
                {"group_weights": np.ones(32)},
                {"groups": np.where(ids == 3, 0, ids)}):
        with pytest.raises(ValueError):
            from_numpy_params({"weight": W, **bad}, "cpu")
