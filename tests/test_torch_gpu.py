"""lasso_tpu_torch on a CUDA card: the kernels against their plain
versions, and the solver's fused path against its CPU run.

Every test here is marked ``gpu`` and skips where there is no card. This
file imports neither JAX nor the JAX package, so that it runs on a
machine that has only PyTorch; there, run it without the JAX-based
conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from lasso_tpu_torch.linear.solvers import ista
from lasso_tpu_torch.ops import _cuda
from lasso_tpu_torch.ops import fused_ista as T

from _torch_port import make_problem, n, t

pytestmark = pytest.mark.gpu


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("kp", ["f32", "bf16"])
def test_cuda_kernels_match_plain(kp):
    """Both wrappers against their plain versions on the card at a ragged
    shape, with restart, a per-feature row, nonneg and l2. Tolerances of
    tests/test_fused_ista.py (z atol 1e-5 / 5e-3, delta rtol 1e-5 /
    5e-2); the kernels sum delta and the restart dot with atomics, in an
    order that changes from run to run."""
    _need_card()
    rng = np.random.default_rng(0)
    x, z, zp, W = (t(a).cuda() for a in make_problem(rng, 200, 300, 500))
    arow = t((0.02 + 0.05 * rng.random((1, 500))).astype(np.float32)).cuda()
    tv = t((3.0 * rng.random((200, 1))).astype(np.float32)).cuda()
    moms = torch.linspace(0, 0.6, 4)
    calls = [
        (T.fused_fista_step, T.fused_fista_step_plain,
         lambda f: f(x, z, zp, W, 0.2, arow, 0.5, kernel_precision=kp,
                     nonneg=True, l2=0.3)),
        (T.fused_fista_multistep, T.fused_fista_multistep_plain,
         lambda f: f(x, z, zp, W, 0.2, arow * 0.2, moms, 4,
                     kernel_precision=kp, t_vec=tv, nonneg=True, l2=0.3))]
    atol, rtol = (1e-5, 1e-5) if kp == "f32" else (5e-3, 5e-2)
    before = _cuda.launch_counts()
    for kernel, plain, call in calls:
        got, want = call(kernel), call(plain)
        for a, b in zip(got[:-1], want[:-1]):
            np.testing.assert_allclose(n(a), n(b), atol=atol)
        np.testing.assert_allclose(float(got[-1]), float(want[-1]),
                                   rtol=rtol)
    after = _cuda.launch_counts()
    assert after[f"fista_resid_{kp}"] - before[f"fista_resid_{kp}"] == 5
    assert (after[f"fista_grad_prox_{kp}"]
            - before[f"fista_grad_prox_{kp}"]) == 5


@pytest.mark.parametrize("kw", [
    {"maxiter": 416, "tol": 1e-4},
    {"maxiter": 37, "tol": 0.0},
    {"maxiter": 96, "tol": 0.0, "restart": True, "fuse_steps": 8},
], ids=["auto_tol", "remainder", "restart"])
def test_solver_on_card_matches_cpu(kw):
    """The fused path on the card against the same solve on the CPU
    (plain versions): n_iter equal, codes atol 1e-4 (tests/
    test_fused_ista.py's fused-vs-plain tolerance)."""
    _need_card()
    rng = np.random.default_rng(0)
    x, _, _, W = make_problem(rng, n=16)
    z0 = np.zeros((16, W.shape[1]), np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        out[dev] = ista(t(x).to(dev), t(z0).to(dev), t(W).to(dev), 0.1,
                        lr=0.1, use_pallas=True, return_iters=True, **kw)
    assert out["cuda"][1] == out["cpu"][1]
    np.testing.assert_allclose(n(out["cuda"][0]), n(out["cpu"][0]),
                               atol=1e-4)
