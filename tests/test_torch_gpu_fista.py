"""lasso_tpu_torch's FISTA kernels on a CUDA card: K1 ``fista_resid`` and
K2 ``fista_grad_prox`` of ``csrc/fista.cu`` (warpgroup MMA: bf16, and the
bf16x3 split for 'f32') against their plain versions, in both precisions.

Every test here is marked ``gpu`` and skips where there is no card. This
file imports neither JAX nor the JAX package; on a machine that has only
PyTorch, run the card's tests without the JAX-based conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu*.py -q

Shapes: 37x45->301 (no dimension a multiple of 4: 4-byte copies and
unpaired columns), 200x300->500 (ragged tiles) and 256x128->384 (aligned).
Tolerances: K1's residual atol 1e-4 (values of order 1, sums of K
products; chip_smoke.py's); r's split as K1 writes it equal to the split of
K1's own r, zero past D; K2, given K1's residual, at tests/test_fused_ista.py's
z atol 1e-5 (f32) / 5e-3 (bf16) and delta rtol 1e-5 / 5e-2 (delta is
summed with atomics, in an order that changes from run to run); the
restart carry atol 1e-6 (both round the same t update op by op).
"""

import numpy as np
import pytest
import torch

from lasso_tpu_torch.ops import fused_ista as T

from _torch_port import make_problem, n, t

pytestmark = pytest.mark.gpu

if not torch.cuda.is_available():
    # without a card the whole module skips at collection, so that its
    # tests are not collected one by one only to skip
    pytest.skip("needs a CUDA card", allow_module_level=True)

SHAPES = [(37, 45, 301), (200, 300, 500), (256, 128, 384)]
IDS = ["odd", "ragged", "aligned"]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _inputs(rows, d, k):
    """x, z, z_prev, W, a threshold row and a restart carry (a mix of
    fresh and advanced rows) on the card."""
    rng = np.random.default_rng(rows + d + k)
    x, z, zp, W = make_problem(rng, rows, d, k)
    arow = (0.02 + 0.05 * rng.random((1, k))).astype(np.float32)
    tv = np.where(rng.random((rows, 1)) < 0.5, 0.0,
                  1.0 + 3.0 * rng.random((rows, 1))).astype(np.float32)
    return [t(a).cuda() for a in (x, z, zp, W, arow, tv)]


def _scal(lr=0.2, th=0.002, mom=0.5, l2=0.0):
    return torch.tensor([lr, th, mom, 1.0 / (1.0 + l2 * lr)],
                        device="cuda")


@pytest.mark.parametrize("kp", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_resid_kernel_matches_plain(shape, kp):
    """K1 with the scalar momentum and with the restart carry's per-row
    momentum, one launch a call, and r's split beside r."""
    _need_card()
    rows, d, _ = shape
    x, z, zp, W, _, tv = _inputs(*shape)
    for t_vec in (None, tv):
        ops = T.fista_operands(W, rows, kp)
        before = T.FISTA_RESID[kp].launches
        r = T.fista_resid(x, z, zp, W, _scal(), t_vec, kp, operands=ops)
        assert T.FISTA_RESID[kp].launches == before + 1
        want = T.fista_resid_plain(x, z, zp, W, _scal(), t_vec, kp)
        np.testing.assert_allclose(n(r), n(want), atol=1e-4)
        assert torch.equal(ops.rb[:, :, :d], T._bf16_parts(r, kp))
        assert not ops.rb[:, :, d:].any()


@pytest.mark.parametrize("kp", ["f32", "bf16"])
@pytest.mark.parametrize("variant", ["scalar", "restart_row_nonneg_l2",
                                     "out_aliases_z_prev", "group"])
def test_grad_prox_kernel_matches_plain(variant, kp):
    """K2 given K1's residual and operands, at the ragged and the aligned
    shape: the scalar threshold; restart with a threshold row, nonneg and
    l2 (t advanced in place); ``out`` the ``z_prev`` it reads; the group
    mode (``advance_t=False``: t read for the momentum and left alone)."""
    _need_card()
    atol, rtol = (1e-5, 1e-5) if kp == "f32" else (5e-3, 5e-2)
    for shape in SHAPES[1:]:
        x, z, zp, W, arow, tv = _inputs(*shape)
        kw, t_vec, advance = {}, None, True
        scal = _scal()
        if variant == "restart_row_nonneg_l2":
            scal = _scal(l2=0.3)
            kw = {"trow": arow * 0.2, "nonneg": True}
            t_vec = tv
        elif variant == "group":
            t_vec, advance = tv, False
        ops = T.fista_operands(W, shape[0], kp)
        r = T.fista_resid(x, z, zp, W, scal, t_vec, kp, operands=ops)
        zp_in = zp.clone()
        t_k = None if t_vec is None else t_vec.clone()
        t_p = None if t_vec is None else t_vec.clone()
        out = zp_in if variant == "out_aliases_z_prev" else None
        before = T.FISTA_GRAD_PROX[kp].launches
        got, dk = T.fista_grad_prox(r, z, zp_in, W, scal, t_vec=t_k,
                                    kernel_precision=kp, out=out,
                                    advance_t=advance, operands=ops, **kw)
        assert T.FISTA_GRAD_PROX[kp].launches == before + 1
        want, dp = T._grad_prox_plain_into(r, z, zp, W, scal, t_vec=t_p,
                                           kernel_precision=kp,
                                           advance_t=advance, **kw)
        np.testing.assert_allclose(n(got), n(want), atol=atol)
        np.testing.assert_allclose(float(dk), float(dp), rtol=rtol)
        if out is not None:
            assert got.data_ptr() == zp_in.data_ptr()
        if t_vec is not None:
            np.testing.assert_allclose(n(t_k), n(t_p), atol=1e-6)
            if not advance:
                assert torch.equal(t_k, t_vec)


@pytest.mark.parametrize("kp", ["f32", "bf16"])
def test_resid_reads_the_momentum_point_k2_wrote(kp):
    """K2 given the next step's scalars writes that step's momentum point's
    split (zero past K); K1 reading it gives the r and r's split, bit for
    bit, of K1 forming y from z+ and z."""
    _need_card()
    for shape in SHAPES:
        rows, _, k = shape
        x, z, zp, W, _, _ = _inputs(*shape)
        s0, s1 = _scal(), _scal(mom=0.3)
        ops = T.fista_operands(W, rows, kp, with_y=True)
        r = T.fista_resid(x, z, zp, W, s0, None, kp, operands=ops)
        z1, _ = T.fista_grad_prox(r, z, zp, W, s0, kernel_precision=kp,
                                  operands=ops, next_scal=s1)
        assert not ops.ys[:, :, k:].any()
        stored = T.fista_resid(x, z1, z, W, s1, None, kp, operands=ops,
                               y_split=True).clone()
        rb_stored = ops.rb.clone()
        formed = T.fista_resid(x, z1, z, W, s1, None, kp, operands=ops)
        assert torch.equal(stored, formed)
        assert torch.equal(rb_stored, ops.rb)


@pytest.mark.parametrize("kp", ["f32", "bf16"])
def test_grad_prox_given_the_residual_alone(kp):
    """Without operands K2's wrapper splits W and the residual itself: the
    same codes as with K1's operands."""
    _need_card()
    x, z, zp, W, _, _ = _inputs(*SHAPES[1])
    ops = T.fista_operands(W, SHAPES[1][0], kp)
    r = T.fista_resid(x, z, zp, W, _scal(), None, kp, operands=ops)
    with_ops, _ = T.fista_grad_prox(r, z, zp, W, _scal(),
                                    kernel_precision=kp, operands=ops)
    alone, _ = T.fista_grad_prox(r, z, zp, W, _scal(), kernel_precision=kp)
    assert torch.equal(with_ops, alone)


def test_operands_of_another_precision_raise():
    """Operands made for one precision, or for another batch size, or
    without the momentum point's split that a call asks for, are refused
    before any launch."""
    _need_card()
    x, z, zp, W, _, _ = _inputs(*SHAPES[2])
    before = (T.FISTA_RESID["f32"].launches,
              T.FISTA_GRAD_PROX["f32"].launches)
    for ops in (T.fista_operands(W, SHAPES[2][0], "bf16"),
                T.fista_operands(W, SHAPES[2][0] + 1, "f32")):
        with pytest.raises(ValueError, match="operands"):
            T.fista_resid(x, z, zp, W, _scal(), None, "f32", operands=ops)
        with pytest.raises(ValueError, match="operands"):
            T.fista_grad_prox(x, z, zp, W, _scal(), kernel_precision="f32",
                              operands=ops)
    ops = T.fista_operands(W, SHAPES[2][0], "f32")   # made without ys
    with pytest.raises(ValueError, match="with_y"):
        T.fista_resid(x, z, zp, W, _scal(), None, "f32", operands=ops,
                      y_split=True)
    with pytest.raises(ValueError, match="with_y"):
        T.fista_grad_prox(x, z, zp, W, _scal(), kernel_precision="f32",
                          operands=ops, next_scal=_scal())
    assert (T.FISTA_RESID["f32"].launches,
            T.FISTA_GRAD_PROX["f32"].launches) == before
