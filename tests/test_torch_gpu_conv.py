"""lasso_tpu_torch on a CUDA card: the conv-FISTA kernels K9a and K9b
(csrc/conv.cu) against their plain versions, their launch counts through
ista_conv2d, and what they refuse.

Every test here is marked ``gpu`` and skips where there is no card. This
file imports neither JAX nor the JAX package; on a machine that has only
PyTorch, run the card's tests without the JAX-based conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu*.py -q

Tolerances as in chip_smoke.py phase 14: f32 codes atol 3e-5 * max(1,
|z|max) and delta 1e-5 relative; bf16 codes 1e-3 * scale and delta 1e-4;
the restart t equal. 'f32' is the bf16x3 split in the kernels and in the
plain versions.
"""

import numpy as np
import pytest
import torch

from lasso_tpu_torch.conv2d import (conv_transpose2d, ista_conv2d,
                                    lip_constant, make_implicit_conv_encoder)
from lasso_tpu_torch.conv2d.ops import _conv2d_weight
from lasso_tpu_torch.ops import _cuda
from lasso_tpu_torch.ops import fused_conv as TC

from _torch_port import n

pytestmark = pytest.mark.gpu

if not torch.cuda.is_available():
    # without a card the whole module skips at collection, so that its
    # tests are not collected one by one only to skip
    pytest.skip("needs a CUDA card", allow_module_level=True)
TOL = {"f32": (3e-5, 1e-5), "bf16": (1e-3, 1e-4)}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _operands(seed, nn, cz, cx, hz, wz, kh, kw, pad):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(nn, cx, hz + kh - 1 - 2 * pad, wz + kw - 1 - 2 * pad,
                    generator=g, device="cuda")
    W = torch.randn(cz, cx, kh, kw, generator=g, device="cuda") / kh
    z = 0.1 * torch.randn(nn, cz, hz, wz, generator=g, device="cuda")
    zp = z + 0.05 * torch.randn(nn, cz, hz, wz, generator=g, device="cuda")
    return x, W, z, zp, g


@pytest.mark.parametrize("kp", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [
    (3, 8, 2, 7, 9, 4, 2, 1),       # ragged taps, pad 1
    (3, 8, 1, 6, 8, 11, 11, 0),     # kw = 11: tall patches
    (3, 8, 1, 5, 5, 3, 9, 1),       # kw = 9, pad 1
    (2, 13, 5, 40, 37, 5, 5, 2),    # two tiles each way, ragged channels
    (256, 64, 1, 26, 26, 7, 7, 0),  # the headline: n 16 (K9a), 64 (K9b)
    (64, 256, 16, 28, 28, 5, 5, 0),  # the rich width: n 128, two K9b tiles
])
def test_kernels_match_plain(kp, shape):
    """Three sub-steps (lr = 0.9 / L) with nonneg, a per-channel threshold
    and restart, at chip_smoke.py phase 14's shapes: codes, delta and the
    t vector against the plain versions ('f32' the bf16x3 split in both),
    with 3 launches of each kernel."""
    _need_card()
    x, W, z, zp, g = _operands(sum(shape), *shape)
    cz, pad = shape[1], shape[-1]
    lr = 0.9 / float(lip_constant(W, tuple(x.shape[2:]), padding=pad,
                                  maxiter=100))
    ths = lr * (0.05 + 0.25 * torch.rand(cz, 1, generator=g, device="cuda"))
    t0 = 3 * torch.rand(shape[0], generator=g, device="cuda")
    args = (x, z, zp, W, lr, ths, torch.tensor([0.3, 0.15, 0.0]), 3)
    kw = dict(padding=pad, kernel_precision=kp, nonneg=True, t_vec=t0)
    before = _cuda.launch_counts()
    got = TC.fused_conv_fista_multistep(*args, **kw)
    torch.cuda.synchronize()
    after = _cuda.launch_counts()
    for name in ("conv_decode_resid", "conv_adjoint_prox"):
        assert after[f"{name}_{kp}"] - before[f"{name}_{kp}"] == 3
    want = TC.fused_conv_fista_multistep_plain(*args, **kw)
    scale = max(1.0, float(want[0].abs().max()))
    for i in (0, 1):
        np.testing.assert_allclose(n(got[i]), n(want[i]),
                                   atol=TOL[kp][0] * scale)
    assert torch.equal(got[2], want[2])
    np.testing.assert_allclose(float(got[3]), float(want[3]),
                               rtol=TOL[kp][1])


@pytest.mark.parametrize("kp", ["f32", "bf16"])
def test_delta_and_restart_are_deterministic(kp):
    """Block partials summed in a fixed order: the same launch twice gives
    the same delta and t bit for bit, and W's operands made once a call
    (conv_operands) give what a launch that makes its own gives."""
    _need_card()
    x, W, z, zp, g = _operands(5, 64, 64, 1, 26, 26, 7, 7, 0)
    scal = torch.tensor([0.02, 0.002, 0.3, 1.0], device="cuda")
    t0 = 3 * torch.rand(64, generator=g, device="cuda")
    ops = TC.conv_operands(W, kp)
    r = TC.conv_decode_resid(x, z, zp, W, scal, kernel_precision=kp)
    assert torch.equal(r, TC.conv_decode_resid(x, z, zp, W, scal,
                                               kernel_precision=kp,
                                               operands=ops))
    outs = []
    for operands in (None, ops):
        t_io = t0.clone()
        zn, delta = TC.conv_adjoint_prox(r, z, zp, W, scal, t_vec=t_io,
                                         kernel_precision=kp,
                                         operands=operands)
        outs.append((zn, float(delta), t_io))
    assert torch.equal(outs[0][0], outs[1][0])
    assert outs[0][1] == outs[1][1]
    assert torch.equal(outs[0][2], outs[1][2])


def test_ista_conv2d_on_the_card_launches_the_kernels():
    """'auto' takes the kernels on a CUDA tensor: 24 iterations in blocks of
    12 are 24 launches of each kernel, and the codes match the same solve
    on the CPU's plain versions (atol 1e-4: the sums run in other orders,
    and 24 iterations let the difference grow)."""
    _need_card()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 1, 16, 16)).astype(np.float32)
    W = (rng.standard_normal((16, 1, 5, 5)) / 5).astype(np.float32)
    z0 = np.zeros((4, 16, 12, 12), np.float32)
    kw = dict(maxiter=24, tol=0.0, lr=0.05, return_iters=True)
    before = _cuda.launch_counts()
    zc, kc = ista_conv2d(torch.from_numpy(x).cuda(), torch.from_numpy(z0)
                         .cuda(), torch.from_numpy(W).cuda(), 0.1, **kw)
    torch.cuda.synchronize()
    after = _cuda.launch_counts()
    assert kc == 24
    for name in ("conv_decode_resid_f32", "conv_adjoint_prox_f32"):
        assert after[name] - before[name] == 24
    assert after["fused_conv_fista_multistep"] - before.get(
        "fused_conv_fista_multistep", 0) == 2
    zp, kp_ = ista_conv2d(torch.from_numpy(x), torch.from_numpy(z0),
                          torch.from_numpy(W), 0.1, use_pallas=True, **kw)
    assert kp_ == 24
    np.testing.assert_allclose(n(zc), n(zp), atol=1e-4)


def test_filter_adjoint_and_implicit_gradient_on_the_card():
    """update_kernel's adjoint on the card, at stride 1 and at stride 2 with
    an odd image: <conv_transpose2d(Z, V), R> = <V, adj(R)> to 1e-5
    relative (f32, TF32 off); then one gradient of a small
    make_implicit_conv_encoder, its forward fused (K9a/K9b, 60 launches
    each) against the same gradient with use_pallas=False, to 1e-3 of its
    norm (the forwards part by the bf16x3 split's rounding)."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(3)
    for stride, padding, size in ((1, 0, 12), (2, 1, 13)):
        V = torch.randn(8, 3, 3, 3, generator=g, device="cuda")
        hz = (size + 2 * padding - 3) // stride + 1
        Z = torch.randn(4, 8, hz, hz, generator=g, device="cuda")
        dec = conv_transpose2d(Z, V, stride=stride, padding=padding)
        assert tuple(dec.shape[2:]) == (size, size)
        R = torch.randn(dec.shape, generator=g, device="cuda")
        lhs = float(torch.sum(dec.double() * R.double()))
        adj = _conv2d_weight(R, Z, V.shape, stride, padding)
        rhs = float(torch.sum(V.double() * adj.double()))
        assert abs(lhs - rhs) <= 1e-5 * abs(lhs), (stride, lhs, rhs)
    x = torch.randn(4, 1, 16, 16, generator=g, device="cuda")
    W = torch.randn(16, 1, 5, 5, generator=g, device="cuda") / 5
    grads = {}
    for use_pallas in (True, False):
        enc = make_implicit_conv_encoder(maxiter=60, tol=0.0, lr=0.05,
                                         cg_iters=64, use_pallas=use_pallas)
        xg, Wg = x.clone().requires_grad_(), W.clone().requires_grad_()
        before = _cuda.launch_counts()
        z = enc(xg, Wg, 0.1)
        torch.cuda.synchronize()
        after = _cuda.launch_counts()
        launched = after.get("conv_decode_resid_f32", 0) - before.get(
            "conv_decode_resid_f32", 0)
        assert launched == (60 if use_pallas else 0)
        torch.sum(z ** 2).backward()
        grads[use_pallas] = (xg.grad, Wg.grad)
    for fused, plain in zip(grads[True], grads[False]):
        assert torch.isfinite(fused).all()
        assert float(torch.linalg.vector_norm(fused - plain)
                     / torch.linalg.vector_norm(plain)) < 1e-3


def test_kernels_refuse_what_they_do_not_take():
    """Wrong dtype, a non-contiguous tensor, mismatched shapes, a CPU
    operand, an output that is z itself, a scratch too small, or W's
    operands of the other precision or dtype: each raises before or at the
    launch, and nothing runs the plain version."""
    _need_card()
    x, W, z, zp, _ = _operands(7, 2, 8, 1, 6, 6, 3, 3, 0)
    scal = torch.tensor([0.02, 0.002, 0.3, 1.0], device="cuda")
    before = _cuda.launch_counts()
    with pytest.raises(ValueError):
        TC.conv_decode_resid(x.double(), z, zp, W, scal)
    with pytest.raises(ValueError):
        TC.conv_decode_resid(x, z.transpose(2, 3), zp, W, scal)
    with pytest.raises(ValueError):
        TC.conv_decode_resid(x[:, :, 1:], z, zp, W, scal)
    with pytest.raises(ValueError):
        TC.conv_decode_resid(x, z, zp.cpu(), W, scal)
    r = TC.conv_decode_resid(x, z, zp, W, scal)
    with pytest.raises(ValueError, match="another buffer"):
        TC.conv_adjoint_prox(r, z, zp, W, scal, out=z)
    small = (torch.empty(1, device="cuda"), torch.empty(1, device="cuda"),
             torch.zeros(3, dtype=torch.int32, device="cuda"))
    with pytest.raises(RuntimeError, match="conv_adjoint_prox"):
        TC.conv_adjoint_prox(r, z, zp, W, scal, scratch=small)
    bf16_ops = TC.conv_operands(W, "bf16")   # one part, not f32's two
    with pytest.raises(ValueError, match="operands"):
        TC.conv_decode_resid(x, z, zp, W, scal, operands=bf16_ops)
    with pytest.raises(ValueError):
        TC.conv_adjoint_prox(r, z, zp, W, scal, operands=TC.ConvOperands(
            bf16_ops.wa.float(), bf16_ops.wb.float()))
    after = _cuda.launch_counts()
    assert after["conv_decode_resid_f32"] - before[
        "conv_decode_resid_f32"] == 1
    assert after["conv_adjoint_prox_f32"] == before["conv_adjoint_prox_f32"]
