"""lasso_tpu_torch.conv2d's convolutions and Lipschitz constants against
lasso_tpu's on the same numpy inputs.

Tolerances: the convolutions atol 1e-4 (tests/test_conv_ops.py); the
adjoint identity relative 1e-5 (both sides are float32 sums of a few
hundred products); the Araujo bound rtol 1e-5 (tests/test_conv2d.py:32-37);
the power iteration rtol 1e-5 from the same start vector. The geometry
sweeps scale the kernel by 1/sqrt(fan-in), so their outputs are O(1) and
atol 1e-4 holds with room at every width.

JAX on the CPU computes every convolution in f32 whatever its precision,
so the port's 'default' (bf16 operands) is held against JAX on operands
rounded to bf16 first, and its 'high' (the bf16x3 split, about 2^-16
relative) against JAX's f32 result.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lasso_tpu.conv2d import (LipBoundConv2d as J_LipBound,
                              conv2d as j_conv2d,
                              conv_transpose2d as j_conv_t,
                              lip_bound_conv2d as j_lip_bound,
                              lip_constant as j_lip_constant)
from lasso_tpu.ops.precision import round_bf16 as j_round
from lasso_tpu_torch.config import get_precision
from lasso_tpu_torch.conv2d import (LipBoundConv2d, conv2d,
                                    conv_transpose2d, lip_bound_conv2d,
                                    lip_constant)

from _torch_port import n, t


@pytest.fixture(autouse=True)
def _release_jax_executables():
    """Each geometry below compiles JAX convolutions of its own shape, and
    each executable holds memory mappings of its code (a process may hold
    65530); each test gives its executables back."""
    yield
    jax.clear_caches()


def _jax(fn, a, k, precision, **kw):
    """JAX's convolution at the port's precision: operands rounded to bf16
    for 'default' (JAX's CPU convolutions ignore the precision)."""
    a, k = jnp.asarray(a), jnp.asarray(k)
    if precision == "default":
        a, k = j_round(a), j_round(k)
    return n(fn(a, k, **kw))


@pytest.mark.parametrize("stride,padding,method,precision", [
    (1, 2, "gemm", None), (2, 1, "auto", None),
    (1, 1, "dilated", "default"), (1, 1, "gemm", "high"),
])
def test_conv2d_matches_jax(rng, stride, padding, method, precision):
    x = rng.standard_normal((2, 3, 12, 12)).astype(np.float32)
    k = rng.standard_normal((5, 3, 3, 3)).astype(np.float32)
    want = _jax(j_conv2d, x, k, precision, stride=stride, padding=padding,
                method="gemm" if method == "gemm" else "auto")
    got = conv2d(t(x), t(k), stride=stride, padding=padding,
                 precision=precision, method=method)
    np.testing.assert_allclose(n(got), want, atol=1e-4)


@pytest.mark.parametrize("stride,padding,method,precision", [
    (1, 1, "gemm", None), (2, 1, "dilated", None),
    (1, 1, "auto", "default"), (1, 0, "gemm", "high"),
])
def test_conv_transpose2d_matches_jax(rng, stride, padding, method,
                                      precision):
    z = rng.standard_normal((2, 5, 6, 6)).astype(np.float32)
    k = rng.standard_normal((5, 3, 3, 3)).astype(np.float32)
    want = _jax(j_conv_t, z, k, precision, stride=stride, padding=padding,
                method=method)
    got = conv_transpose2d(t(z), t(k), stride=stride, padding=padding,
                           precision=precision, method=method)
    np.testing.assert_allclose(n(got), want, atol=1e-4)


@pytest.mark.parametrize("stride,padding,size,method", [
    (1, 1, 10, "gemm"), (2, 1, 9, "auto")])
def test_conv_pair_is_exact_adjoint(rng, stride, padding, size, method):
    """<conv2d(x, k), z> == <x, conv_transpose2d(z, k)>
    (tests/test_conv_ops.py:35), for each method."""
    k = t(rng.standard_normal((4, 3, 3, 3)).astype(np.float32))
    x = t(rng.standard_normal((2, 3, size, size)).astype(np.float32))
    y = conv2d(x, k, stride=stride, padding=padding, method=method)
    z = t(rng.standard_normal(tuple(y.shape)).astype(np.float32))
    xt = conv_transpose2d(z, k, stride=stride, padding=padding,
                          method=method)
    lhs, rhs = float(torch.vdot(y.ravel(), z.ravel())), \
        float(torch.vdot(x.ravel(), xt.ravel()))
    assert abs(lhs - rhs) <= 1e-5 * max(1.0, abs(lhs))


_KERNELS = [((1, 1), 3, 20), ((2, 2), 2, 5), ((3, 3), 3, 20),
            ((3, 5), 1, 4), ((5, 3), 4, 17), ((4, 2), 2, 16),
            ((7, 7), 1, 8)]


def _geometries():
    """(kernel [kh, kw], C_in, C_out, stride, padding, methods): every
    kernel at paddings 0, 1 and (2, 1), stride 1 by both methods (one case)
    and strides 2 and (2, 1) by 'auto'. C_out straddles 16, where JAX's
    'auto' transpose switches between its fold and its dilated form."""
    out = []
    for (kh, kw), ci, co in _KERNELS:
        for padding in (0, 1, (2, 1)):
            for stride, methods in ((1, ("gemm", "auto")), (2, ("auto",)),
                                    ((2, 1), ("auto",))):
                out.append(((kh, kw), ci, co, stride, padding, methods))
    return out


@pytest.mark.parametrize("ksize,ci,co,stride,padding,methods", _geometries())
def test_conv_geometry_matches_jax(ksize, ci, co, stride, padding, methods):
    """conv_transpose2d of codes, and conv2d of an image of the size that
    transpose gives, against JAX's at each geometry and by each method;
    the pair is adjoint there (relative 1e-5)."""
    for method in methods:
        rng = np.random.default_rng(sum(ksize) * 100 + ci * 10 + co)
        kh, kw = ksize
        scale = 1.0 / np.sqrt(co * kh * kw)
        k = (rng.standard_normal((co, ci, kh, kw)) * scale).astype(
            np.float32)
        z = rng.standard_normal((2, co, 6, 5)).astype(np.float32)
        kw_ = dict(stride=stride, padding=padding, method=method)
        want = _jax(j_conv_t, z, k, None, **kw_)
        xt = conv_transpose2d(t(z), t(k), **kw_)
        assert tuple(xt.shape) == want.shape
        np.testing.assert_allclose(n(xt), want, atol=1e-4)

        x = rng.standard_normal(want.shape).astype(np.float32)
        want_y = _jax(j_conv2d, x, k, None, **kw_)
        y = conv2d(t(x), t(k), **kw_)
        assert tuple(y.shape) == want_y.shape == z.shape
        np.testing.assert_allclose(n(y), want_y, atol=1e-4)
        lhs = float(np.vdot(n(y).astype(np.float64), z))
        rhs = float(np.vdot(x.astype(np.float64), n(xt)))
        assert abs(lhs - rhs) <= 1e-5 * max(1.0, abs(lhs))


@pytest.mark.parametrize("precision", [
    None, "default", "bfloat16", "high", "highest", "float32"])
@pytest.mark.parametrize("method", ["gemm", "auto"])
@pytest.mark.parametrize("op", ["conv2d", "conv_transpose2d"])
def test_precision_names_match_jax(rng, precision, method, op):
    """Every precision name, on both methods of both directions: the
    bf16 names against JAX on bf16-rounded operands, the others against
    JAX's f32 result. The kernel is [6, 4, 3, 3]: conv2d maps 4 channels
    to 6, conv_transpose2d 6 to 4."""
    ci, co = 4, 6
    k = (rng.standard_normal((co, ci, 3, 3)) / np.sqrt(co * 9)).astype(
        np.float32)
    if op == "conv2d":
        a, fn, j_fn = rng.standard_normal((2, ci, 9, 8)), conv2d, j_conv2d
    else:
        a, fn, j_fn = (rng.standard_normal((2, co, 7, 6)), conv_transpose2d,
                       j_conv_t)
    a = a.astype(np.float32)
    prec = None if precision is None else get_precision(precision)
    want = _jax(j_fn, a, k, prec, padding=1, method=method)
    got = fn(t(a), t(k), padding=1, precision=precision, method=method)
    np.testing.assert_allclose(n(got), want, atol=1e-4)


def test_conv_and_lip_bound_validation():
    x = t(np.zeros((1, 3, 8, 8), np.float32))
    k = t(np.zeros((4, 3, 3, 3), np.float32))
    with pytest.raises(ValueError, match="stride 1"):
        conv2d(x, k, stride=2, method="gemm")
    with pytest.raises(ValueError, match="stride 1"):
        conv_transpose2d(t(np.zeros((1, 4, 6, 6), np.float32)), k,
                         stride=2, method="gemm")
    with pytest.raises(ValueError, match="method"):
        conv2d(x, k, method="fft")
    with pytest.raises(ValueError):
        lip_bound_conv2d(torch.zeros((2, 2, 3, 4)), padding=1)
    with pytest.raises(ValueError):
        lip_bound_conv2d(torch.zeros((2, 2, 4, 4)), padding=1)
    with pytest.raises(NotImplementedError):
        lip_bound_conv2d(torch.zeros((2, 2, 3, 3)), padding=1, stride=2)
    with pytest.raises(NotImplementedError):
        LipBoundConv2d((2, 2, 3, 3), padding=1, stride=2)


@pytest.mark.parametrize("padding,sqrt", [(1, False), (3, True)])
def test_lip_bound_matches_jax(rng, padding, sqrt):
    k = rng.standard_normal((4, 3, 5, 5)).astype(np.float32)
    want = float(j_lip_bound(jnp.asarray(k), padding=padding, sqrt=sqrt))
    got = float(lip_bound_conv2d(t(k), padding=padding, sqrt=sqrt))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    mod = LipBoundConv2d(k.shape, padding=padding, sqrt=sqrt)
    np.testing.assert_allclose(
        float(mod(t(k))),
        float(J_LipBound(k.shape, padding=padding, sqrt=sqrt)(
            jnp.asarray(k))), rtol=1e-5)
    np.testing.assert_allclose(float(mod(t(k))), got, rtol=1e-6)


@pytest.mark.parametrize("ksize", [1, 3, 5, 7])
@pytest.mark.parametrize("paddings", [(0,), (1,), (2, 4)])
def test_lip_bound_geometry_matches_jax(ksize, paddings):
    """The Araujo bound and its module at every odd kernel size and
    padding (rtol 1e-5); paddings 2 and 4 share a case."""
    for padding in paddings:
        rng = np.random.default_rng(ksize * 10 + padding)
        k = rng.standard_normal((5, 3, ksize, ksize)).astype(np.float32)
        want = float(j_lip_bound(jnp.asarray(k), padding=padding))
        np.testing.assert_allclose(
            float(lip_bound_conv2d(t(k), padding=padding)), want, rtol=1e-5)
        np.testing.assert_allclose(
            float(LipBoundConv2d(k.shape, padding=padding)(t(k))), want,
            rtol=1e-5)


@pytest.mark.parametrize("transpose,stride,padding,imsize", [
    (True, 1, 1, (10, 10)), (False, 2, 1, (9, 9))])
def test_lip_constant_matches_jax(rng, transpose, stride, padding, imsize):
    """From JAX's own start vector (PRNGKey(0)) the power iteration gives
    JAX's eigenvalue (rtol 1e-5). From the port's seed-0 draw, 500
    iterations land within 5e-3 below the exact top eigenvalue (the
    float64 eigenvalues of the operator's dense matrix): the two top
    eigenvalues are close here, so neither start converges to 1e-9. The
    exact value lower-bounds the Araujo bound
    (tests/test_conv2d.py:22-29)."""
    k = (rng.standard_normal((4, 3, 3, 3)) * 0.3).astype(np.float32)
    kw = dict(transpose=transpose, stride=stride, padding=padding)
    want = float(j_lip_constant(jnp.asarray(k), imsize, **kw))
    channels = k.shape[0] if transpose else k.shape[1]
    v0 = n(jax.random.normal(jax.random.PRNGKey(0),
                             (1, channels) + imsize, jnp.float32))
    np.testing.assert_allclose(
        float(lip_constant(t(k), imsize, v0=t(v0), **kw)), want, rtol=1e-5)
    sq = float(lip_constant(t(k), imsize, sqrt=True, v0=t(v0), **kw))
    np.testing.assert_allclose(sq, np.sqrt(want), rtol=1e-5)

    k64 = t(k).double()
    basis = torch.eye(channels * imsize[0] * imsize[1],
                      dtype=torch.float64).reshape((-1, channels) + imsize)
    ck = dict(stride=stride, padding=padding)
    cols = (conv2d(conv_transpose2d(basis, k64, **ck), k64, **ck)
            if transpose else
            conv_transpose2d(conv2d(basis, k64, **ck), k64, **ck))
    exact = float(torch.linalg.eigvalsh(cols.reshape(len(basis), -1))[-1])
    got = float(lip_constant(t(k), imsize, **kw))
    assert exact * (1 - 5e-3) <= got <= exact * (1 + 1e-6)
    if stride == 1:
        assert exact <= float(lip_bound_conv2d(t(k), padding=padding)) * 1.01
