"""lasso_tpu_torch ista against lasso_tpu ista: fused blocks, stopping,
the 'mixed' schedule, padding and arguments (test_torch_ista_options.py
holds the alpha forms, restart and the other options).

Both get the same numpy inputs and an explicit lr; the port runs on the
CPU, where ``use_pallas=True`` runs the kernels' plain versions as JAX
runs its Pallas kernels in interpret mode. ``n_iter`` must be equal.
Tolerances come from tests/test_fused_ista.py: atol 1e-4 on the codes
(fused-vs-plain solve), objective rtol 1e-5 where bf16 rounding enters
('mixed', restart).
"""

import importlib

import numpy as np
import pytest
import torch

from lasso_tpu_torch.linear.solvers import ista as tista

from _torch_port import both, make_problem, objective, t
from _torch_port import release_jax_after_module  # noqa: F401

# the module (the package's `ista` attribute is the function)
ista_module = importlib.import_module("lasso_tpu_torch.linear.solvers.ista")


@pytest.fixture
def problem(rng):
    x, _, _, W = make_problem(rng, n=16)
    return x, W


@pytest.mark.parametrize("fuse_steps", [1, 4, "auto"])
def test_fused_paths_match_jax(problem, fuse_steps):
    """tol > 0 so that the stopping rule is exercised: fuse_steps=4 and
    'auto' (S=32 at maxiter=416) stop only at block ends."""
    x, W = problem
    zj, kj, zt, kt = both(x, W, maxiter=416, tol=1e-4, use_pallas=True,
                          fuse_steps=fuse_steps)
    assert kt == kj < 416
    np.testing.assert_allclose(zt, zj, atol=1e-4)


def test_stopping_rule_at_most_S_minus_1_late(problem):
    x, W = problem
    _, _, _, k_ref = both(x, W, maxiter=416, tol=1e-4, use_pallas=False)
    for S in (4, 32):
        _, _, _, k = both(x, W, maxiter=416, tol=1e-4, use_pallas=True,
                          fuse_steps=S)
        assert k_ref <= k < k_ref + S and k % S == 0


def test_remainder_single_steps_match_jax(problem):
    """maxiter=37 (prime): 'auto' picks S=16, so two blocks and 5 single
    fused steps."""
    x, W = problem
    zj, kj, zt, kt = both(x, W, maxiter=37, tol=0.0, use_pallas=True)
    assert kt == kj == 37
    np.testing.assert_allclose(zt, zj, atol=1e-4)


def test_mixed_block_structure(problem, monkeypatch):
    """The headline schedule (200 iters, tail 37): bf16 blocks of S=25,
    a bf16 remainder of 13, an f32 block of 25 and an f32 remainder of
    12; no single steps."""
    x, W = problem
    calls = []
    real_multi = ista_module.fused_fista_multistep

    def multi(*a, steps, kernel_precision, **kw):
        calls.append((steps, kernel_precision))
        return real_multi(*a, steps=steps, kernel_precision=kernel_precision,
                          **kw)

    def step(*a, **kw):
        raise AssertionError("no single step expected")

    monkeypatch.setattr(ista_module, "fused_fista_multistep", multi)
    monkeypatch.setattr(ista_module, "fused_fista_step", step)
    z0 = torch.zeros((16, W.shape[1]))
    _, k = tista(t(x), z0, t(W), 0.1, lr=0.1, maxiter=200, tol=0.0,
                 use_pallas=True, kernel_precision="mixed",
                 mixed_tail_iters=37, return_iters=True)
    assert k == 200
    assert calls == [(25, "bf16")] * 6 + [(13, "bf16"), (25, "f32"),
                                          (12, "f32")]


@pytest.mark.parametrize("tail", [{"mixed_tail_iters": 37}, {}])
def test_mixed_matches_jax(problem, tail):
    x, W = problem
    alpha = 0.1
    zj, kj, zt, kt = both(x, W, alpha, maxiter=200, tol=0.0,
                          use_pallas=True, fuse_steps=25,
                          kernel_precision="mixed", **tail)
    assert kt == kj == 200
    np.testing.assert_allclose(objective(x, W, zt, alpha),
                               objective(x, W, zj, alpha), rtol=1e-5)


def test_ragged_shapes_pad_like_jax(rng):
    """N=24, D=100, K=250 pads onto the fused grid (the stopping threshold
    keeps the original numel), in both packages."""
    x, _, _, W = make_problem(rng, n=24, d=100, k=250)
    zj, kj, zt, kt = both(x, W, maxiter=200, tol=1e-3, use_pallas=True)
    assert zt.shape == (24, 250)
    assert kt == kj < 200
    np.testing.assert_allclose(zt, zj, atol=1e-4)


def test_lr_auto(problem):
    x, W = problem
    zj, kj, zt, kt = both(x, W, lr="auto", maxiter=50, tol=0.0,
                          use_pallas=False)
    assert kt == kj == 50
    np.testing.assert_allclose(zt, zj, atol=1e-4)


def test_verbose_prints_loss_each_iteration(problem, capsys):
    x, W = problem
    z0 = torch.zeros((16, W.shape[1]))
    _, k = tista(t(x), z0, t(W), 0.1, lr=0.1, maxiter=7, tol=0.0,
                 verbose=True, use_pallas=True, return_iters=True)
    lines = capsys.readouterr().out.splitlines()
    assert k == 7 and len(lines) == 7
    assert all(ln.startswith("loss: ") for ln in lines)


def test_argument_errors(problem):
    x, W = problem
    args = (t(x), torch.zeros((16, W.shape[1])), t(W), 0.1)
    with pytest.raises(TypeError, match="ProcessGroup"):
        tista(*args, axis_name="batch")
    with pytest.raises(ValueError):
        tista(*args, lr=0.1, kernel_precision="tf32")
    with pytest.raises(ValueError):
        tista(*args, lr=0.1, mixed_tail_iters=5)
    with pytest.raises(ValueError):
        tista(*args, lr=0.1, fast=False, restart=True)
    with pytest.raises(ValueError):
        tista(*args, lr=0.1, restart=True, backtrack=True)
    with pytest.raises(ValueError):
        tista(*args, lr="bogus")
