"""lasso_tpu_torch on a CUDA card: the Cholesky solve kernel K8 against its
plain version, its whole-batch LU fallback, and OMP 'chol-full' and the
nonlinear iterative-ridge BFGS on the card against the same solves on the
CPU.

Every test here is marked ``gpu`` and skips where there is no card. This
file imports neither JAX nor the JAX package; on a machine that has only
PyTorch, run the card's tests without the JAX-based conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu*.py -q
"""

import numpy as np
import pytest
import torch

from lasso_tpu_torch.linalg import batch_cholesky_solve
from lasso_tpu_torch.linear.solvers import orthogonal_matching_pursuit
from lasso_tpu_torch.nonlinear import iterative_ridge_bfgs
from lasso_tpu_torch.ops import _cuda
from lasso_tpu_torch.ops import batched_cholesky as T_B

from _torch_port import assert_same_fit, n, omp_problem, t

pytestmark = pytest.mark.gpu

if not torch.cuda.is_available():
    # without a card the whole module skips at collection, so that its
    # tests are not collected one by one only to skip
    pytest.skip("needs a CUDA card", allow_module_level=True)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def pd_systems(seed, B, D):
    """A = Q Q^T / D + 2 I and b on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    Q = torch.randn(B, D, D, generator=g, device="cuda")
    A = Q @ Q.transpose(1, 2) / D + 2 * torch.eye(D, device="cuda")
    return torch.randn(B, D, generator=g, device="cuda"), A


@pytest.mark.parametrize("B,D", [(300, 64), (130, 12), (130, 100), (9, 161),
                                 (5, 256), (1, 1), (17, 16), (5, 17),
                                 (33, 32), (301, 63), (130, 65)])
def test_chol_solve_kernel_matches_plain(B, D):
    """Every tier of K8: the warp kernel at D rounded up to 16, 32 and 64
    (16, 8 and 4 samples a block; D = 1, 16 / 17, 32 / 33, 63, 64 on both
    sides of each width, rows past D padded as an identity), then the
    thread groups of 64, 128 and 256 above D = 64; batches that leave a
    block part empty: x at rtol 1e-4 / atol 1e-5 from the plain
    version."""
    _need_card()
    b, A = pd_systems(B + D, B, D)
    before = T_B.CHOL_SOLVE.launches
    x = T_B.batch_cholesky_solve_lanes(b, A)
    torch.cuda.synchronize()
    assert T_B.CHOL_SOLVE.launches - before == 1
    want = T_B.batch_cholesky_solve_lanes_plain(b, A)
    np.testing.assert_allclose(n(x), n(want), rtol=1e-4, atol=1e-5)


def test_non_pd_sample_and_the_lu_fallback():
    """A non-PD sample gives a non-finite x from K8 and leaves the others
    right; batch_cholesky_solve then returns the LU answer for the whole
    batch and counts one fallback."""
    _need_card()
    b, A = pd_systems(3, 200, 64)
    A[17] = -torch.eye(64, device="cuda")
    x = T_B.batch_cholesky_solve_lanes(b, A)
    assert not bool(torch.isfinite(x[17]).any())
    good = torch.ones(200, dtype=torch.bool, device="cuda")
    good[17] = False
    assert bool(torch.isfinite(x[good]).all())
    before = dict(_cuda.WRAPPER_CALLS)
    got = batch_cholesky_solve(b, A)
    lu = torch.linalg.solve(A.double(), b.double()[:, :, None])[:, :, 0]
    np.testing.assert_allclose(n(got), n(lu), atol=1e-4)
    assert (_cuda.WRAPPER_CALLS["batch_cholesky_solve_lu"]
            - before.get("batch_cholesky_solve_lu", 0)) == 1


@pytest.mark.parametrize("D", [16, 32])
def test_non_pd_sample_in_a_shared_warp(D):
    """Where a warp holds several samples (4 at D = 16, 2 at D = 32), a
    non-PD sample gives a non-finite x and leaves its neighbours in the
    warp, and every other sample, as the plain version solves them."""
    _need_card()
    b, A = pd_systems(D, 37, D)
    A[5] = -torch.eye(D, device="cuda")
    x = T_B.batch_cholesky_solve_lanes(b, A)
    torch.cuda.synchronize()
    assert not bool(torch.isfinite(x[5]).any())
    good = torch.ones(37, dtype=torch.bool, device="cuda")
    good[5] = False
    want = T_B.batch_cholesky_solve_lanes_plain(b[good], A[good])
    np.testing.assert_allclose(n(x[good]), n(want), rtol=1e-4, atol=1e-5)


def test_chol_solve_refuses_what_it_does_not_take():
    _need_card()
    b, A = pd_systems(4, 3, 8)
    for args in ((b.double(), A.double()), (b[:, :4], A),
                 (torch.zeros(2, 257, device="cuda"),
                  torch.zeros(2, 257, 257, device="cuda")),
                 (b, A.transpose(1, 2))):
        with pytest.raises(ValueError):
            T_B.batch_cholesky_solve_lanes(*args)


def test_omp_chol_full_on_card_matches_cpu():
    """'chol-full' on the card (one K8 launch a step, no LU fallback)
    against the same solve on the CPU (plain versions), by
    ``_assert_same_fit`` of tests/test_omp.py."""
    _need_card()
    x, W = omp_problem(13, 300, 64, 256)
    before = _cuda.launch_counts()
    zc, kc = orthogonal_matching_pursuit(t(x).cuda(), t(W).cuda(), 12,
                                         solver="chol-full",
                                         return_iters=True)
    after = _cuda.launch_counts()
    zp, kp = orthogonal_matching_pursuit(t(x), t(W), 12, solver="chol-full",
                                         use_pallas=True, return_iters=True)
    assert kc == kp == 12
    assert after["chol_solve"] - before["chol_solve"] == 12
    assert (after.get("batch_cholesky_solve_lu", 0)
            == before.get("batch_cholesky_solve_lu", 0))
    assert_same_fit(x, W, n(zp), n(zc))


def test_iterative_ridge_bfgs_on_card_matches_cpu():
    """iterative_ridge_bfgs through a tanh MLP decoder at 256 rows, K = 256
    (K8's widest systems), 4 iterations with the line search: one K8
    launch an iteration and no LU fallback on the card, and the codes
    within 1e-2 of their largest entry of the same solve on the CPU (the
    library's Cholesky there), objectives within 1e-4 relative. The
    method is sensitive to rounding (the ridge diagonal alpha / |x| of
    small codes): the CPU's float32 run parts from its float64 run by
    9.8e-4 at these settings."""
    _need_card()
    rng = np.random.default_rng(18)
    B, K, H, D = 256, 256, 128, 64
    w1 = rng.standard_normal((K, H)) / np.sqrt(K)
    w2 = rng.standard_normal((H, D)) / np.sqrt(H)
    codes = rng.standard_normal((B, K)) * (rng.random((B, K)) < 0.05)
    x = np.tanh(codes @ w1) @ w2 + 0.01 * rng.standard_normal((B, D))
    z0 = 0.1 * rng.standard_normal((B, K))
    runs = []
    for device in ("cuda", "cpu"):
        xt, z0t, w1t, w2t = (torch.tensor(a, dtype=torch.float32,
                                          device=device)
                             for a in (x, z0, w1, w2))

        def loss(z):
            return 0.5 * torch.sum(torch.square(
                torch.tanh(z @ w1t) @ w2t - xt))

        before = _cuda.launch_counts()
        z, k = iterative_ridge_bfgs(loss, z0t, alpha=0.05, maxiter=4,
                                    return_iters=True)
        after = _cuda.launch_counts()
        runs.append((n(z), k, float(loss(z)) + 0.05 * float(z.abs().sum()),
                     {name: after.get(name, 0) - before.get(name, 0)
                      for name in ("chol_solve", "batch_cholesky_solve_lu")}))
    (zc, kc, fc, lc), (zp, kp, fp, lp) = runs
    assert kc == kp == 4
    assert lc == {"chol_solve": 4, "batch_cholesky_solve_lu": 0}
    assert lp == {"chol_solve": 0, "batch_cholesky_solve_lu": 0}
    assert np.isfinite(zc).all()
    assert np.abs(zc - zp).max() <= 1e-2 * np.abs(zp).max()
    assert abs(fc - fp) <= 1e-4 * abs(fp)
