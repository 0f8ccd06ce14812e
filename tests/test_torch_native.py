"""lasso_tpu_torch.native against lasso_tpu.native: the patch pipeline and
the CSR packer, the port's C++ against the JAX package's C++ (both built
here by g++), bit for bit, and the numpy versions, selected when no
compiler is found, against the JAX package's numpy versions.

The numpy ``extract_patches_random`` draws from ``np.random`` and the C++
from splitmix64, so random patches are compared native to native only.
Centring with ``normalize`` is compared within 1e-6 (as
tests/test_native.py holds it to numpy); everything else is exact.
"""

import numpy as np
import pytest
import torch

import lasso_tpu.native as jnat
import lasso_tpu_torch.native as tnat

from _torch_port import release_jax_after_module  # noqa: F401


@pytest.fixture(scope="module")
def imgs():
    rng = np.random.default_rng(0)
    return rng.standard_normal((6, 20, 24)).astype(np.float32)


@pytest.fixture
def numpy_versions(monkeypatch):
    """Both packages as they run without a compiler."""
    monkeypatch.setattr(jnat, "get_lib", lambda: None)
    monkeypatch.setattr(tnat, "get_lib", lambda: None)


def test_patches_match_jax_native(imgs):
    """Dense patches on two stride grids, random patches for two seeds and
    thread counts, and centring with and without normalization."""
    assert tnat.have_native() and jnat.have_native()
    assert tnat.library_path().parent == tnat.BUILD
    for patch, stride in ((8, 4), (5, 1)):
        want = jnat.extract_patches_dense(imgs, patch, stride)
        got = tnat.extract_patches_dense(imgs, patch, stride, threads=3)
        np.testing.assert_array_equal(got, want)
    for seed, threads in ((42, None), (7, 1)):
        want = jnat.extract_patches_random(imgs, 7, 5, seed=seed)
        got = tnat.extract_patches_random(imgs, 7, 5, seed=seed,
                                          threads=threads)
        np.testing.assert_array_equal(got, want)
    for normalize in (False, True):
        p = tnat.extract_patches_dense(imgs, 6, 6)
        want = jnat.center_patches(p.copy(), normalize=normalize)
        got = tnat.center_patches(p, normalize=normalize)
        np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("eps", [0.0, 1e-3])
def test_csr_matches_jax_native(rng, eps):
    """Pack with all-zero rows and entries under eps, from an array and
    from a tensor; unpack."""
    z = rng.standard_normal((37, 53)).astype(np.float32)
    z[np.abs(z) < 1.0] = 0.0
    z[5] = 0.0
    z[-1] = 0.0
    z[3, :4] = 5e-4
    want = jnat.pack_codes_csr(z, eps=eps)
    for arg in (z, torch.from_numpy(z)):
        got = tnat.pack_codes_csr(arg, eps=eps, threads=2)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert got[2][-1] == (np.abs(z) > eps).sum()
    back = tnat.unpack_codes_csr(*got, z.shape[1])
    np.testing.assert_array_equal(back, jnat.unpack_codes_csr(*want,
                                                              z.shape[1]))
    np.testing.assert_array_equal(back, np.where(np.abs(z) > eps, z, 0))


def test_numpy_versions_match_jax_numpy(imgs, rng, numpy_versions):
    assert not tnat.have_native()
    np.testing.assert_array_equal(tnat.extract_patches_dense(imgs, 8, 4),
                                  jnat.extract_patches_dense(imgs, 8, 4))
    np.testing.assert_array_equal(
        tnat.extract_patches_random(imgs, 7, 5, seed=3),
        jnat.extract_patches_random(imgs, 7, 5, seed=3))
    p = tnat.extract_patches_dense(imgs, 6, 6)
    np.testing.assert_array_equal(
        tnat.center_patches(p.copy(), normalize=True),
        jnat.center_patches(p.copy(), normalize=True))
    z = rng.standard_normal((16, 24)).astype(np.float32)
    z[np.abs(z) < 0.8] = 0.0
    got, want = tnat.pack_codes_csr(z, 1e-3), jnat.pack_codes_csr(z, 1e-3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tnat.unpack_codes_csr(*got, 24),
                                  jnat.unpack_codes_csr(*want, 24))
