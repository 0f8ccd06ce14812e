"""lasso_tpu_torch numerics core against lasso_tpu: config, shrink,
precision, common, linalg (spectral, basic)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import lasso_tpu.config as jconfig
from lasso_tpu.linalg import basic as jbasic
from lasso_tpu.linalg import spectral as jspectral
from lasso_tpu.ops import common as jcommon
from lasso_tpu.ops import precision as jprecision
from lasso_tpu.ops import shrink as jshrink
from lasso_tpu_torch import config
from lasso_tpu_torch.linalg import basic, spectral
from lasso_tpu_torch.ops import common, precision, shrink

from _torch_port import n, t
from _torch_port import release_jax_after_module  # noqa: F401


def test_precision_names_match_jax():
    from jax import lax
    to_name = {lax.Precision.HIGHEST: "highest", lax.Precision.HIGH: "high",
               lax.Precision.DEFAULT: "default"}
    for p in (None, "default", "bfloat16", "float32", "high", "highest",
              "HIGHEST"):
        assert config.get_precision(p) == to_name[jconfig.get_precision(p)]
    with pytest.raises(ValueError):
        config.get_precision("tf32")
    with pytest.raises(TypeError):
        config.get_precision(3)
    with config.matmul_precision("bfloat16"):
        assert config.get_precision() == "default"
    assert config.get_precision() == "highest"


def test_matmul_precisions(rng):
    """'highest' is a true f32 product, as JAX's HIGHEST; 'high' (bf16x3)
    and 'default' (bf16 operands) round as the TPU's matrix unit does
    (JAX on the CPU computes every precision in f32, so those two are
    held against the exact product instead)."""
    a = rng.standard_normal((16, 64)).astype(np.float32)
    b = rng.standard_normal((64, 8)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    np.testing.assert_allclose(
        n(common.matmul(t(a), t(b), "highest")),
        n(jcommon.matmul(jnp.asarray(a), jnp.asarray(b), "highest")),
        rtol=1e-5, atol=1e-5)
    scale = np.abs(exact).max()
    errs = {p: np.abs(n(common.matmul(t(a), t(b), p)) - exact).max() / scale
            for p in ("highest", "high", "default")}
    assert errs["highest"] < 1e-6 < errs["default"] < 5e-2
    assert errs["high"] < 1e-4


@pytest.mark.parametrize("nonneg", [False, True])
def test_shrink_matches_jax(rng, nonneg):
    x = rng.standard_normal((8, 33)).astype(np.float32)
    theta = np.abs(rng.standard_normal((1, 33))).astype(np.float32) * 0.5
    jf = jshrink.soft_threshold_nonneg if nonneg else jshrink.soft_threshold
    tf = shrink.soft_threshold_nonneg if nonneg else shrink.soft_threshold
    for th in (0.3, theta):
        np.testing.assert_array_equal(n(tf(t(x), t(th) if isinstance(
            th, np.ndarray) else th)), n(jf(jnp.asarray(x), th)))


def test_round_and_split_bf16_match_jax(rng):
    a = (rng.standard_normal(4096) * 10.0 ** rng.integers(-6, 6, 4096)
         ).astype(np.float32)
    np.testing.assert_array_equal(n(precision.round_bf16(t(a))),
                                  n(jprecision.round_bf16(jnp.asarray(a))))
    hi, lo = precision.split_bf16(t(a))
    jhi, jlo = jprecision.split_bf16(jnp.asarray(a), emulate=True)
    np.testing.assert_array_equal(n(hi), n(jhi))
    np.testing.assert_array_equal(n(lo), n(jlo))


def test_largest_aligned_divisor_matches_jax():
    for nn in (8, 120, 136, 256, 1024, 8 * 15 * 7):
        for limit in (4, 8, 60, 100, 120, 512, 4096):
            assert (common.largest_aligned_divisor(nn, limit)
                    == jcommon.largest_aligned_divisor(nn, limit))
    assert common.largest_aligned_divisor(1024, 512, align=128) == 512


@pytest.mark.parametrize("alpha", ["scalar", "row"])
def test_pad_lasso_operands_matches_jax(rng, alpha):
    x = rng.standard_normal((24, 100)).astype(np.float32)
    z0 = rng.standard_normal((24, 250)).astype(np.float32)
    W = rng.standard_normal((100, 250)).astype(np.float32)
    a = 0.1 if alpha == "scalar" else np.full((1, 250), 0.2, np.float32)
    got = common.pad_lasso_operands(t(x), t(z0), t(W),
                                    a if alpha == "scalar" else t(a))
    want = jcommon.pad_lasso_operands(jnp.asarray(x), jnp.asarray(z0),
                                      jnp.asarray(W), a)
    for g, w in zip(got[:4], want[:4]):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(n(g), n(w))
    assert got[4] == want[4] == (24, 250)
    assert common.pad_lasso_operands(t(x[:8, :0]), None, t(W[:0, :128])) \
        is None


def test_alpha_resolvers_match_jax():
    N, K = 6, 5
    for a in (0.3, np.full(N, 0.5, np.float32),
              np.full((N, 1), 0.5, np.float32)):
        got = common.per_sample_alpha_column(t(a) if isinstance(
            a, np.ndarray) else a, N)
        want = jcommon.per_sample_alpha_column(a, N)
        assert (got is None) == (want is None)
        if want is not None:
            np.testing.assert_array_equal(n(got), n(want))
    for a in (0.3, np.full((1, K), 0.5, np.float32),
              np.full(K, 0.5, np.float32), np.full(N, 0.5, np.float32)):
        got = common.per_feature_alpha_row(t(a) if isinstance(
            a, np.ndarray) else a, K, N)
        want = jcommon.per_feature_alpha_row(a, K, N)
        assert (got is None) == (want is None)
        if want is not None:
            np.testing.assert_array_equal(n(got), n(want))
    with pytest.raises(ValueError):
        common.per_sample_alpha_column(t(np.zeros(N, np.float32)), N)
    with pytest.raises(ValueError):
        common.per_sample_alpha_column(t(np.ones(N + 1, np.float32)), N)
    with pytest.raises(ValueError):
        common.per_feature_alpha_row(t(-np.ones((1, K), np.float32)), K, N)


def test_resolve_pallas():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert common.resolve_pallas("auto", True, cuda)
    assert not common.resolve_pallas("auto", True, cpu)
    assert not common.resolve_pallas("auto", False, cuda)
    assert common.resolve_pallas(True, True, cpu)
    assert not common.resolve_pallas(True, False, cpu)
    assert not common.resolve_pallas(False, True, cuda)


def test_lipschitz_constant_matches_jax(rng):
    """The port takes JAX's PRNGKey(0) start vector as v0; L agrees to
    rtol 1e-5 (float32 power iteration, different summation order)."""
    W = (rng.standard_normal((128, 256)) / np.sqrt(128)).astype(np.float32)
    L_j = float(jspectral.lipschitz_constant(jnp.asarray(W)))
    v0 = np.array(jax.random.normal(jax.random.PRNGKey(0), (256,)))
    L_t = float(spectral.lipschitz_constant(t(W), v0=v0))
    np.testing.assert_allclose(L_t, L_j, rtol=1e-5)
    # the default start vector (a torch.Generator draw) converges too, and
    # the estimate is inflated by 1 + safety above the true eigenvalue
    L_g = float(spectral.lipschitz_constant(t(W)))
    top = np.linalg.eigvalsh(W.astype(np.float64).T @ W)[-1]
    np.testing.assert_allclose(L_g, top * (1 + 1e-4), rtol=1e-5)
    lam, v = spectral.power_iteration(lambda u: t(W.T @ W) @ u,
                                      torch.ones(256), maxiter=3)
    assert v.shape == (256,) and float(lam) > 0


def test_linalg_basic_matches_jax(rng):
    A = rng.standard_normal((20, 12)).astype(np.float32)
    b = rng.standard_normal((20, 3)).astype(np.float32)
    np.testing.assert_allclose(n(basic.lstsq(t(b), t(A))),
                               n(jbasic.lstsq(jnp.asarray(b),
                                              jnp.asarray(A))),
                               rtol=1e-4, atol=1e-5)
    Aw, bw = A[:8], b[:8]   # wide: least-norm
    np.testing.assert_allclose(n(basic.lstsq(t(bw), t(Aw))),
                               n(jbasic.lstsq(jnp.asarray(bw),
                                              jnp.asarray(Aw))),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(n(basic.ridge(t(b), t(A), alpha=0.3)),
                               n(jbasic.ridge(jnp.asarray(b),
                                              jnp.asarray(A), alpha=0.3)),
                               rtol=1e-4, atol=1e-5)
    M = A.T @ A + np.eye(12, dtype=np.float32)
    L = np.linalg.cholesky(M).astype(np.float32)
    np.testing.assert_allclose(n(basic.cholesky_solve(t(b[:12]), t(L))),
                               n(jbasic.cholesky_solve(jnp.asarray(b[:12]),
                                                       jnp.asarray(L))),
                               rtol=1e-4, atol=1e-5)
    q, r = basic.qr(t(A))
    np.testing.assert_allclose(n(q @ r), A, atol=1e-5)
    # a Gram matrix that is not PD gives NaNs, as in JAX
    assert np.isnan(n(basic.ridge(t(b), t(A), alpha=-1e3))).all()
