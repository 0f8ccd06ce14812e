"""lasso_tpu_torch.ops.fused_group against lasso_tpu's group shrink and its
fused group-FISTA kernel (interpret mode) on the same numpy inputs.

The port runs on the CPU, where the wrappers take the kernels' plain
versions. Tolerances: the group shrink atol 1e-6 (tests/
test_group_lasso.py:54-77); a fused 8-step call in f32 atol 1e-4 on the
codes (both packages' products are the bf16x3 split; the JAX kernel also
splits its group sums, the port's are f32; test_group_lasso.py:282-286)
and delta rtol 1e-4; in bf16 the objective
of the codes rtol 1e-4 (the two round bf16 at the same places but sum in
other orders, and single coordinates may part).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lasso_tpu.linear.solvers import group_soft_threshold as j_gst
from lasso_tpu.ops import fused_group as JG
from lasso_tpu_torch.linear.solvers import group_soft_threshold
from lasso_tpu_torch.ops import fused_group as TG
from lasso_tpu_torch.ops import fused_ista as TF

from _torch_port import make_problem, n, t
from _torch_port import release_jax_after_module  # noqa: F401


def _ids(rng, k, g):
    return np.asarray(rng.permutation(np.repeat(np.arange(g), k // g)),
                      np.int32)


@pytest.mark.parametrize("case", ["block", "ids_weights", "zero_group"])
def test_group_prox_plain_matches_jax(rng, case):
    v = rng.standard_normal((6, 24)).astype(np.float32)
    theta, weights = 0.37, None
    if case == "block":
        groups, kind, data, G = 3, "block", 3, 8
    else:
        groups = rng.integers(0, 5, size=24).astype(np.int32)
        groups[:5] = np.arange(5)
        kind, data, G = "ids", groups, 5
        if case == "ids_weights":
            weights = np.array([0.5, 1.0, 2.0, 0.1, 3.0], np.float32)
        else:
            v[:, groups == 2] = 0.0        # an all-zero group
            v[1] = 0.0                     # and an all-zero row
    want = n(j_gst(jnp.asarray(v), theta, groups, weights=weights))
    ids = np.repeat(np.arange(G), data) if kind == "block" else data
    tables = TG.build_group_tables(ids, G, "cpu",
                                   block=data if kind == "block" else None)
    thg = theta * (torch.ones(G) if weights is None else t(weights))
    got = n(TG.group_prox_plain(t(v), thg, tables))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        n(group_soft_threshold(t(v), theta, groups, weights=weights)), want,
        rtol=0, atol=1e-6)
    assert np.all(np.isfinite(got))
    if case == "zero_group":
        assert not got[:, groups == 2].any() and not got[1].any()


def test_group_tables():
    ids = np.array([2, 0, 1, 0, 2, 2], np.int32)
    tb = TG.build_group_tables(ids, 3, "cpu")
    assert tb.perm.dtype == torch.int32 and tb.offsets.dtype == torch.int32
    np.testing.assert_array_equal(n(tb.perm), [1, 3, 2, 0, 4, 5])
    np.testing.assert_array_equal(n(tb.offsets), [0, 2, 3, 6])
    assert tb.n_groups == 3 and tb.block is None
    blk = TG.build_group_tables(np.repeat(np.arange(4), 8), 4, "cpu",
                                block=8)
    np.testing.assert_array_equal(n(blk.perm), np.arange(32))
    np.testing.assert_array_equal(n(blk.offsets), [0, 8, 16, 24, 32])


def test_supports_fused_group_step_matches_jax():
    for (nn, d, k) in ((16, 128, 256), (12, 128, 256), (16, 100, 256),
                       (16, 128, 200)):
        x = np.zeros((nn, d), np.float32)
        W = np.zeros((d, k), np.float32)
        z = np.zeros((nn, k), np.float32)
        want = JG.supports_fused_group_step(jnp.asarray(x), jnp.asarray(z),
                                            jnp.asarray(W), k // 8)
        assert TG.supports_fused_group_step(t(x), t(z), t(W), k // 8) == want


def _multistep_operands(rng, variant):
    x, z, zp, W = make_problem(rng, n=16, d=128, k=256)
    G = 32
    if variant == "block":
        ids, block, w_g = np.repeat(np.arange(G), 8), 8, np.ones(G)
    else:
        ids, block = _ids(rng, 256, G), None
        w_g = np.full(G, np.sqrt(8.0))      # Yuan-Lin weights
    lr, alpha = 0.15, 0.3
    thg = (alpha * lr * w_g).astype(np.float32)
    moms = np.linspace(0.0, 0.6, 8).astype(np.float32)
    tv = (3.0 * rng.random((16, 1))).astype(np.float32)
    return x, z, zp, W, G, ids, block, lr, thg, moms, tv


def _objective(x, W, z, thg, ids, G):
    z = np.asarray(z, np.float64)
    r = z @ np.asarray(W, np.float64).T - x
    sq = np.zeros((z.shape[0], G))
    np.add.at(sq.T, ids, (z * z).T)
    return 0.5 * np.sum(r * r) + np.sum(np.sqrt(sq) * thg)


@pytest.mark.parametrize("kp", ["f32", "bf16"])
@pytest.mark.parametrize("variant", ["block", "ids_l1_restart"])
def test_fused_multistep_matches_jax_interpret(rng, kp, variant):
    """8 fused sub-steps, the port's plain route (through the wrapper on
    CPU tensors) against the JAX kernel in interpret mode."""
    x, z, zp, W, G, ids, block, lr, thg, moms, tv = _multistep_operands(
        rng, variant)
    extra = ({} if variant == "block"
             else {"use_l1": True, "t_vec": tv})
    l1 = 0.05 * lr
    m_fwd, m_bwd = JG.build_membership(ids, G)
    thg_p = np.zeros((1, JG.pad_group_count(G)), np.float32)
    thg_p[0, :G] = thg
    out_j = JG.fused_group_fista_multistep(
        jnp.asarray(x), jnp.asarray(z), jnp.asarray(zp), jnp.asarray(W), lr,
        jnp.asarray(thg_p), l1, jnp.asarray(moms), m_fwd, m_bwd, steps=8,
        interpret=True, kernel_precision=kp,
        **{k: (jnp.asarray(v) if k == "t_vec" else v)
           for k, v in extra.items()})
    tables = TG.build_group_tables(ids, G, "cpu", block=block)
    t_extra = {k: (t(v) if k == "t_vec" else v) for k, v in extra.items()}
    out_t = TG.fused_group_fista_multistep(
        t(x), t(z), t(zp), t(W), lr, t(thg), l1, t(moms), tables, steps=8,
        kernel_precision=kp, **t_extra)
    out_p = TG.fused_group_fista_multistep_plain(
        t(x), t(z), t(zp), t(W), lr, t(thg), l1, t(moms), tables, steps=8,
        kernel_precision=kp, **t_extra)
    for a, b in zip(out_t, out_p):
        assert torch.equal(a, b)
    assert len(out_t) == len(out_j) == (4 if "t_vec" in extra else 3)
    if "t_vec" in extra:            # the input carry is not written
        np.testing.assert_array_equal(n(t_extra["t_vec"]), tv)
    if kp == "f32":
        for a, b in zip(out_t[:-1], out_j[:-1]):
            np.testing.assert_allclose(n(a), n(b), rtol=0, atol=1e-4)
        np.testing.assert_allclose(float(out_t[-1]), float(out_j[-1]),
                                   rtol=1e-4)
    else:
        np.testing.assert_allclose(
            _objective(x, W, n(out_t[0]), thg, ids, G),
            _objective(x, W, n(out_j[0]), thg, ids, G), rtol=1e-4)


def test_grad_prox_reads_t_without_advancing(rng):
    """K2 in the group path's mode: with ``advance_t=False`` the restart
    carry sets the momentum and stays as it was."""
    x, z, zp, W = make_problem(rng, n=16, d=128, k=256)
    tv = t((3.0 * rng.random((16, 1))).astype(np.float32))
    scal = torch.tensor([0.2, 0.01, 0.5, 1.0])
    r = TF.fista_resid(t(x), t(z), t(zp), t(W), scal, tv)
    t_keep = tv.clone()
    v, delta = TF.fista_grad_prox(r, t(z), t(zp), t(W), scal, t_vec=tv,
                                  with_delta=False, advance_t=False)
    assert delta is None and torch.equal(tv, t_keep)
    want, _, _ = TF.fista_grad_prox_plain(r, t(z), t(zp), t(W), scal,
                                          t_vec=t_keep)
    assert torch.equal(v, want)


def test_group_prox_update_restart_and_devices(rng):
    """K5's plain route advances the carry in place and writes ``out``;
    a tensor on a device that is neither the CPU nor CUDA raises."""
    _, z, zp, _ = make_problem(rng, n=16, d=128, k=256)
    v = t((rng.standard_normal((16, 256)) * 0.3).astype(np.float32))
    tables = TG.build_group_tables(np.repeat(np.arange(32), 8), 32, "cpu",
                                   block=8)
    thg = torch.full((32,), 0.1)
    tv = torch.zeros((16, 1))
    out = torch.empty(16, 256)
    zn, delta = TG.group_prox_update(v, t(z), t(zp), tv, thg, tables,
                                     out=out)
    want, d_want, t_want = TG.group_prox_update_plain(
        v, t(z), t(zp), torch.zeros((16, 1)), thg, tables)
    assert zn is out and torch.equal(out, want)
    assert torch.equal(tv, t_want) and float(delta) == float(d_want)
    meta = v.to("meta")
    with pytest.raises(ValueError, match="CUDA"):
        TG.group_prox_update(meta, meta, meta, None, thg.to("meta"),
                             tables._replace(perm=tables.perm.to("meta")))
