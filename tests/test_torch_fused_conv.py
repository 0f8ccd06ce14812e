"""lasso_tpu_torch.ops.fused_conv against lasso_tpu's fused conv-FISTA
kernel (interpret mode) on the same numpy inputs.

The port runs on the CPU, where the wrappers take the kernels' plain
versions; JAX's canvas-layout outputs are unpacked with
``lasso_tpu.ops.fused_conv.unpack_codes``. Tolerances (those of
tests/test_fused_conv.py): f32 codes atol 3e-5 * max(1, |z|max) (both
packages' 'f32' is a bf16x3 split, summed in other orders), delta 1e-3
relative;
bf16 atol 2e-5 against JAX's kernel and its emulated oracle (both round
y, the residual and W to bf16 and sum in f32); restart codes atol 5e-5 *
scale and the per-sample t rtol 1e-6. The Cx=32 7x7 shape crashes the
XLA-CPU compiler in interpret mode (ROADMAP §C), so it is held against
JAX's explicit conv steps instead.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lasso_tpu.conv2d.ops import conv2d as j_conv2d
from lasso_tpu.conv2d.ops import conv_transpose2d as j_conv_t
from lasso_tpu.ops import fused_conv as JC
from lasso_tpu.ops.precision import round_bf16 as j_round
from lasso_tpu.ops.precision import split_bf16_xla as j_split
from lasso_tpu.ops.shrink import soft_threshold as j_soft
from lasso_tpu.ops.shrink import soft_threshold_nonneg as j_soft_nonneg
from lasso_tpu_torch.ops import _cuda
from lasso_tpu_torch.ops import fused_conv as TC

from _torch_port import n, one_torch_thread, t  # noqa: F401

LR = 0.04


@pytest.fixture(autouse=True)
def _release_jax_executables():
    """JAX keeps every executable it compiles, each holding memory
    mappings of its code, and this file's interpret-mode kernels compile
    many. A process may hold 65530 mappings, and pytest-xdist runs many
    test files in one process, so each test here gives its executables
    back."""
    yield
    jax.clear_caches()


def _problem(seed, nn, cz, cx, hz, wz, kh, kw, pad=0, wscale=0.25,
             zp_scale=0.1):
    """x, W, z, z_prev as tests/test_fused_conv.py draws them."""
    rng = np.random.default_rng(seed)
    h, w = hz + kh - 1 - 2 * pad, wz + kw - 1 - 2 * pad
    x = rng.standard_normal((nn, cx, h, w)).astype(np.float32)
    W = (rng.standard_normal((cz, cx, kh, kw)) * wscale).astype(np.float32)
    z = rng.standard_normal((nn, cz, hz, wz)).astype(np.float32)
    zp = (z + zp_scale * rng.standard_normal(z.shape)).astype(np.float32)
    return x, W, z, zp, rng


def _jax_kernel(x, W, z, zp, ths, moms, steps, pad, kp="f32", nonneg=False,
                t0=None):
    """JAX's interpret-mode kernel on NCHW inputs; outputs unpacked to NCHW
    (and t read at one lane of each sample's segment)."""
    nn, cz, hz, wz = z.shape
    cx, kh, kw = W.shape[1:]
    _, Wp, cells = JC.canvas_dims((hz, wz), (kh, kw))
    extra = {}
    if t0 is not None:
        extra["t_vec"] = jnp.repeat(jnp.asarray(t0)[None, :], cells, axis=1)
    outs = JC.fused_conv_fista_multistep(
        JC.pack_images(jnp.asarray(x), (hz, wz), (kh, kw), pad),
        JC.pack_codes(jnp.asarray(z), (kh, kw)),
        JC.pack_codes(jnp.asarray(zp), (kh, kw)), jnp.asarray(W),
        jnp.full((steps,), LR), jnp.asarray(ths), jnp.asarray(moms),
        steps=steps, shape_info=(cx, kh, kw, Wp, cells, pad, hz, wz),
        interpret=True, kernel_precision=kp, nonneg=nonneg, **extra)
    un = lambda a: n(JC.unpack_codes(a, nn, (hz, wz), (kh, kw)))
    if t0 is not None:
        zf, zpen, t_new, delta = outs
        return un(zf), un(zpen), n(t_new)[0, ::cells], float(delta)
    zf, zpen, delta = outs
    return un(zf), un(zpen), float(delta)


def _j_split_conv(fn, a, w, **kw):
    """``fn(a, w)`` as the port's 'f32' computes it, from JAX's own split
    of both operands (``split_bf16_xla``): hi*hi + lo*hi + hi*lo."""
    parts = [[p.astype(jnp.float32) for p in j_split(jnp.asarray(v))]
             for v in (a, w)]
    (a_hi, a_lo), (w_hi, w_lo) = parts
    return (fn(a_hi, w_hi, **kw) + fn(a_lo, w_hi, **kw)
            + fn(a_hi, w_lo, **kw))


def _assert_codes(got, want, atol_rel=3e-5):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=atol_rel * scale)


@pytest.mark.parametrize("cz,cx,hz,wz,kh,kw,pad,nonneg,percol", [
    (16, 1, 10, 10, 5, 5, 0, False, False),
    (8, 2, 7, 9, 4, 2, 1, True, False),      # ragged taps, pad 1, nonneg
    (8, 1, 7, 7, 3, 3, 0, False, True),      # per-channel threshold
    (64, 1, 10, 10, 7, 7, 0, False, False),  # the headline's atoms
    (8, 1, 6, 8, 11, 11, 0, False, False),   # kw = 11
    (8, 1, 5, 5, 3, 9, 1, False, False),     # kw = 9, pad 1
    (16, 8, 6, 6, 3, 3, 0, False, False),    # channel-rich input
])
def test_plain_multistep_matches_jax_kernel(cz, cx, hz, wz, kh, kw, pad,
                                            nonneg, percol):
    """Three fused sub-steps of the plain version == JAX's interpret-mode
    kernel (tests/test_fused_conv.py:44-93)."""
    x, W, z, zp, rng = _problem(cz + kh, 3, cz, cx, hz, wz, kh, kw, pad)
    moms = np.asarray([0.3, 0.15, 0.0], np.float32)
    if percol:
        ths = (rng.uniform(0.05, 0.3, (cz, 1)) * LR).astype(np.float32)
    else:
        ths = np.full((3,), 0.1 * LR, np.float32)
    jf, jpen, jdelta = _jax_kernel(x, W, z, zp, ths, moms, 3, pad,
                                   nonneg=nonneg)
    zf, zpen, delta = TC.fused_conv_fista_multistep(
        t(x), t(z), t(zp), t(W), LR, t(ths), t(moms), 3, padding=pad,
        nonneg=nonneg)
    _assert_codes(n(zf), jf)
    _assert_codes(n(zpen), jpen)
    assert abs(float(delta) - jdelta) <= 1e-3 * max(1.0, jdelta)
    if nonneg:
        assert float(zf.min()) >= 0.0


def test_channel_rich_against_jax_steps():
    """Cx=32, 7x7 (1792 tap rows): the plain version against three of JAX's
    explicit conv FISTA steps (its interpret run crashes XLA-CPU)."""
    x, W, z, zp, _ = _problem(15, 3, 8, 32, 4, 4, 7, 7, wscale=0.05)
    moms = [0.3, 0.15, 0.0]
    zc, zpc = jnp.asarray(z), jnp.asarray(zp)
    for s in range(3):
        y = zc + moms[s] * (zc - zpc)
        g = j_conv2d(j_conv_t(y, jnp.asarray(W)) - jnp.asarray(x),
                     jnp.asarray(W))
        zpc, zc = zc, j_soft(y - LR * g, 0.1 * LR)
    zf, zpen, delta = TC.fused_conv_fista_multistep(
        t(x), t(z), t(zp), t(W), LR, 0.1 * LR,
        torch.tensor(moms), 3)
    _assert_codes(n(zf), n(zc))
    _assert_codes(n(zpen), n(zpc))
    want = float(jnp.sum(jnp.abs(zc - zpc)))
    assert abs(float(delta) - want) <= 1e-3 * max(1.0, want)


def test_bf16_matches_jax_kernel_and_emulated_oracle():
    """'bf16': y, the residual and W rounded to bf16, f32 sums
    (tests/test_fused_conv.py:96-125)."""
    x, W, z, zp, _ = _problem(3, 2, 16, 1, 9, 9, 3, 3)
    moms = np.asarray([0.3, 0.1], np.float32)
    ths = np.full((2,), 0.1 * LR, np.float32)
    jf, _, _ = _jax_kernel(x, W, z, zp, ths, moms, 2, 0, kp="bf16")
    Wq = j_round(jnp.asarray(W))
    zc, zpc = jnp.asarray(z), jnp.asarray(zp)
    for s in range(2):
        y = zc + moms[s] * (zc - zpc)
        xh = j_conv_t(j_round(y), Wq, precision="default")
        g = j_conv2d(j_round(xh - jnp.asarray(x)), Wq, precision="default")
        zpc, zc = zc, j_soft(y - LR * g, 0.1 * LR)
    zf, _, _ = TC.fused_conv_fista_multistep(
        t(x), t(z), t(zp), t(W), LR, t(ths), t(moms), 2,
        kernel_precision="bf16")
    np.testing.assert_allclose(n(zf), jf, atol=2e-5)
    np.testing.assert_allclose(n(zf), n(zc), atol=2e-5)


@pytest.mark.parametrize("nonneg", [False, True])
def test_restart_matches_jax_kernel(nonneg):
    """Per-sample restart: the t-sequence (lagged, init from t0) and the
    gradient-mapping reset track JAX's kernel, t read at one lane of each
    sample (tests/test_fused_conv.py:150-189)."""
    x, W, z, zp, rng = _problem(9, 4, 8, 1, 9, 9, 3, 3, zp_scale=0.05)
    t0 = rng.uniform(0.0, 3.0, (4,)).astype(np.float32)
    ths = np.full((4,), 0.1 * LR, np.float32)
    jf, jpen, jt, jdelta = _jax_kernel(x, W, z, zp, ths, np.zeros(4), 4, 0,
                                       nonneg=nonneg, t0=t0)
    t_in = t(t0.copy())
    zf, zpen, t_new, delta = TC.fused_conv_fista_multistep(
        t(x), t(z), t(zp), t(W), LR, t(ths), 0.0, 4, nonneg=nonneg,
        t_vec=t_in)
    _assert_codes(n(zf), jf, 5e-5)
    _assert_codes(n(zpen), jpen, 5e-5)
    np.testing.assert_allclose(n(t_new), jt, rtol=1e-6)
    np.testing.assert_array_equal(n(t_in), t0)       # the input is kept
    assert abs(float(delta) - jdelta) <= 1e-3 * max(1.0, jdelta)


def test_single_step_kernels_plain():
    """K9a's plain version is JAX's decoder residual at the momentum point,
    K9b's the prox of the adjoint step, with a per-channel threshold and
    nonneg, the convolutions split as the port's 'f32' splits them (from
    JAX's own split); delta and the restart carry follow the step."""
    x, W, z, zp, rng = _problem(21, 3, 8, 2, 7, 9, 4, 2, pad=1)
    scal = torch.tensor([LR, 0.1 * LR, 0.3, 1.0])
    y = jnp.asarray(z) + 0.3 * (jnp.asarray(z) - jnp.asarray(zp))
    want_r = n(_j_split_conv(j_conv_t, y, W, padding=1) - jnp.asarray(x))
    r = TC.conv_decode_resid(t(x), t(z), t(zp), t(W), scal, padding=1)
    np.testing.assert_allclose(n(r), want_r, atol=1e-5)
    tcol = (rng.uniform(0.05, 0.3, (8,)) * LR).astype(np.float32)
    g = _j_split_conv(j_conv2d, want_r, W, padding=1)
    want_z = n(j_soft_nonneg(y - LR * g, jnp.asarray(tcol)[None, :, None,
                                                            None]))
    zn, delta = TC.conv_adjoint_prox(r, t(z), t(zp), t(W), scal,
                                     tcol=t(tcol), nonneg=True, padding=1)
    np.testing.assert_allclose(n(zn), want_z, atol=1e-5)
    np.testing.assert_allclose(float(delta), np.abs(want_z - z).sum(),
                               rtol=1e-5)
    # restart: t = 1 where <y - z+, z+ - z> > 0, else t_next
    tv = torch.tensor([0.0, 1.5, 3.0])
    tn = (1 + torch.sqrt(1 + 4 * tv * tv)) * 0.5
    yr = t(z) + ((tv - 1) / tn).reshape(3, 1, 1, 1) * (t(z) - t(zp))
    r2 = TC.conv_decode_resid(t(x), t(z), t(zp), t(W), scal, t_vec=tv,
                              padding=1)
    t_io = tv.clone()
    z2, _ = TC.conv_adjoint_prox(r2, t(z), t(zp), t(W), scal, t_vec=t_io,
                                 padding=1)
    rdot = ((yr - z2) * (z2 - t(z))).sum(dim=(1, 2, 3))
    np.testing.assert_array_equal(n(t_io), n(torch.where(rdot > 0, 1.0, tn)))


def _gates(n_, cz, cx, hz, kh, kw, stride=1, padding=0, dtype="float32"):
    """(JAX's gate, the port's gate, JAX's S cap, the port's S cap) of one
    geometry."""
    h = hz + kh - 1 - 2 * np.max(padding)
    xj = jnp.zeros((n_, cx, h, h), dtype)
    zj = jnp.zeros((n_, cz, hz, hz), jnp.float32)
    Wj = jnp.zeros((cz, cx, kh, kw), jnp.float32)
    xt = torch.zeros((n_, cx, h, h), dtype=getattr(torch, dtype),
                     device="meta")
    zt = torch.zeros((n_, cz, hz, hz), device="meta")
    Wt = torch.zeros((cz, cx, kh, kw), device="meta")
    return (JC.supports_fused_conv(xj, zj, Wj, stride, padding),
            TC.supports_fused_conv(xt, zt, Wt, stride, padding),
            JC.max_fuse_steps_conv(Wj), TC.max_fuse_steps_conv(Wt))


@pytest.mark.parametrize("case", [
    (2, 8, 1, 8, 3, 3), (2, 8, 32, 6, 7, 7), (2, 8, 1, 8, 3, 3, 2),
    (2, 8, 1, 8, 3, 3, 1, (1, 2)), (2, 8, 1, 8, 3, 3, 1, 0, "bfloat16"),
    (1, 8, 80, 4, 7, 7), (1, 8, 1, 8, 3, 9, 1, 1)])
def test_supports_predicate_and_step_cap(case):
    """The port's gate keeps JAX's conditions (stride 1, float32, equal
    padding, at most 4096 tap rows) and its S cap."""
    j_ok, t_ok, j_cap, t_cap = _gates(*case)
    assert (t_ok, t_cap) == (j_ok, j_cap)


def test_step_cap_and_the_gate_without_vmem():
    """8192 // 1792 tap rows caps S at 4; the port drops JAX's VMEM model
    of a canvas tile, so a problem too big for one VMEM tile (512 atoms
    over 64x64 codes) runs fused in the port only (ROADMAP §C)."""
    assert _gates(2, 8, 32, 6, 7, 7)[3] == 4
    j_ok, t_ok, _, _ = _gates(1, 512, 1, 64, 3, 3)
    assert not j_ok and t_ok


# (Cz, Cx, Hz, Wz, kh, kw, padding): those of the interpret-mode cases
# above and tests/test_fused_conv.py:44-53, and ragged ones beside them
_GEOMS = [
    (16, 1, 10, 10, 5, 5, 0), (8, 2, 7, 9, 4, 2, 1), (8, 1, 7, 7, 3, 3, 0),
    (64, 1, 10, 10, 7, 7, 0), (8, 1, 6, 8, 11, 11, 0), (8, 1, 5, 5, 3, 9, 1),
    (16, 8, 6, 6, 3, 3, 0), (8, 32, 4, 4, 7, 7, 0), (4, 3, 5, 6, 2, 3, 1),
    (12, 2, 9, 7, 5, 1, 2), (8, 4, 3, 11, 1, 1, 0)]


def _jax_steps(x, W, z, zp, moms, ths, pad):
    """JAX's explicit conv FISTA steps (lagged momentum, one threshold per
    step): (z_final, z_penultimate)."""
    zc, zpc, Wj = jnp.asarray(z), jnp.asarray(zp), jnp.asarray(W)
    for m, th in zip(moms, ths):
        y = zc + m * (zc - zpc)
        g = j_conv2d(j_conv_t(y, Wj, padding=pad) - jnp.asarray(x), Wj,
                     padding=pad)
        zpc, zc = zc, j_soft(y - LR * g, th)
    return n(zc), n(zpc)


@pytest.mark.parametrize("nonneg,percol", [(False, False), (True, True)])
@pytest.mark.parametrize("geom", _GEOMS)
def test_single_step_plain_matches_jax_step(geom, nonneg, percol):
    """K9a's and K9b's plain versions against JAX's decoder residual and
    prox step at each geometry, with a scalar or a per-channel threshold
    (atol 1e-5, as test_single_step_kernels_plain), the convolutions as
    the port's 'f32' splits them, from JAX's own split. W is scaled by
    1/sqrt(Cz kh kw), the decoder's fan-in, so the residual is O(1) at
    every width."""
    cz, cx, hz, wz, kh, kw, pad = geom
    x, W, z, zp, rng = _problem(sum(geom), 2, cz, cx, hz, wz, kh, kw, pad,
                                wscale=1.0 / np.sqrt(cz * kh * kw))
    scal = torch.tensor([LR, 0.1 * LR, 0.3, 1.0])
    y = jnp.asarray(z) + 0.3 * (jnp.asarray(z) - jnp.asarray(zp))
    want_r = n(_j_split_conv(j_conv_t, y, W, padding=pad) - jnp.asarray(x))
    r = TC.conv_decode_resid(t(x), t(z), t(zp), t(W), scal, padding=pad)
    np.testing.assert_allclose(n(r), want_r, atol=1e-5)
    tcol = (rng.uniform(0.05, 0.3, (cz,)) * LR).astype(np.float32)
    th = jnp.asarray(tcol)[None, :, None, None] if percol else 0.1 * LR
    g = _j_split_conv(j_conv2d, want_r, W, padding=pad)
    prox = j_soft_nonneg if nonneg else j_soft
    want_z = n(prox(y - LR * g, th))
    zn, delta = TC.conv_adjoint_prox(r, t(z), t(zp), t(W), scal,
                                     tcol=t(tcol) if percol else None,
                                     nonneg=nonneg, padding=pad)
    np.testing.assert_allclose(n(zn), want_z, atol=1e-5)
    np.testing.assert_allclose(float(delta), np.abs(want_z - z).sum(),
                               rtol=1e-5)


@pytest.mark.parametrize("geom", [g for g in _GEOMS if g[1] != 32])
def test_plain_steps_match_jax_explicit_steps(geom):
    """Four fused sub-steps of the plain version (per-step thresholds and
    momenta) against four of JAX's explicit steps at each geometry (the
    Cx=32 one is test_channel_rich_against_jax_steps)."""
    cz, cx, hz, wz, kh, kw, pad = geom
    x, W, z, zp, _ = _problem(sum(geom) + 1, 2, cz, cx, hz, wz, kh, kw, pad,
                              wscale=1.0 / np.sqrt(cz * kh * kw))
    moms = np.asarray([0.3, 0.2, 0.1, 0.0], np.float32)
    ths = np.asarray([0.1, 0.12, 0.08, 0.1], np.float32) * LR
    jf, jpen = _jax_steps(x, W, z, zp, moms, ths, pad)
    zf, zpen, delta = TC.fused_conv_fista_multistep(
        t(x), t(z), t(zp), t(W), LR, t(ths), t(moms), 4, padding=pad)
    _assert_codes(n(zf), jf)
    _assert_codes(n(zpen), jpen)
    want = float(np.abs(jf - jpen).sum())
    assert abs(float(delta) - want) <= 1e-3 * max(1.0, want)


def test_cpu_route_and_devices(monkeypatch):
    """On CPU tensors the wrappers run the plain versions (bit for bit,
    inputs kept, no launch counted); a tensor on another device goes to
    the kernel's checks and raises, never to the plain version."""
    x, W, z, zp, _ = _problem(5, 2, 8, 1, 6, 6, 3, 3)
    before = _cuda.launch_counts()
    args = (t(x), t(z), t(zp), t(W), LR, 0.1 * LR, torch.tensor([0.0, 0.2]),
            2)
    a = TC.fused_conv_fista_multistep(*args)
    b = TC.fused_conv_fista_multistep_plain(*args)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    np.testing.assert_array_equal(n(args[1]), z)
    np.testing.assert_array_equal(n(args[2]), zp)
    assert _cuda.launch_counts() == before
    meta = [torch.empty(a_.shape, device="meta") for a_ in (x, z, zp, W)]
    scal = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        TC.conv_decode_resid(*meta, scal)
    with pytest.raises(ValueError, match="CUDA"):
        TC.conv_adjoint_prox(meta[0], *meta[1:], scal, scratch=(
            torch.empty(4, device="meta"), torch.empty(4, device="meta"),
            torch.zeros(3, dtype=torch.int32, device="meta")))
    with pytest.raises(ValueError, match="kernel_precision"):
        TC.fused_conv_fista_multistep(*args, kernel_precision="fp8")


# 'f32' is the bf16x3 split in both packages: (Cz, Cx, Hz, Wz, kh, kw, pad,
# nonneg, per-channel threshold, restart, steps)
_SPLIT_CASES = [
    (8, 2, 7, 9, 4, 2, 1, True, True, True, 3),
    (16, 8, 6, 6, 3, 3, 0, True, False, False, 3),
    (16, 1, 10, 10, 5, 5, 0, False, False, True, 1),
    (8, 1, 5, 5, 3, 9, 1, False, True, False, 1),
]


@pytest.mark.parametrize("case", _SPLIT_CASES)
def test_split_plain_matches_jax_split_kernel(case):
    """The plain 'f32' versions, whose convolutions are bf16x3 splits, over
    one step and three, against JAX's interpret-mode kernel in 'f32' (its
    split) with restart, nonneg, a per-channel threshold and padding:
    codes atol 3e-5 * max(1, |z|max) over several steps and 1e-5 over
    one, delta rtol 1e-5, the restart t rtol 1e-6."""
    cz, cx, hz, wz, kh, kw, pad, nonneg, percol, restart, steps = case
    x, W, z, zp, rng = _problem(sum(case[:7]) + 2, 3, cz, cx, hz, wz, kh, kw,
                                pad, wscale=1.0 / np.sqrt(cz * kh * kw),
                                zp_scale=0.05)
    moms = np.asarray([0.3, 0.15, 0.0][:steps], np.float32)
    ths = ((rng.uniform(0.05, 0.3, (cz, 1)) * LR).astype(np.float32)
           if percol else np.full((steps,), 0.1 * LR, np.float32))
    t0 = rng.uniform(0.0, 3.0, (3,)).astype(np.float32) if restart else None
    want = _jax_kernel(x, W, z, zp, ths, moms, steps, pad, nonneg=nonneg,
                       t0=t0)
    got = TC.fused_conv_fista_multistep(
        t(x), t(z), t(zp), t(W), LR, t(ths), t(moms), steps, padding=pad,
        nonneg=nonneg, t_vec=None if t0 is None else t(t0))
    atol = 3e-5 if steps > 1 else 1e-5
    for i in (0, 1):
        _assert_codes(n(got[i]), want[i], atol_rel=atol)
    if restart:
        np.testing.assert_allclose(n(got[2]), want[2], rtol=1e-6)
    np.testing.assert_allclose(float(got[-1]), want[-1], rtol=1e-5)


@pytest.mark.parametrize("which", ["decode", "adjoint"])
def test_split_products_against_float64(which):
    """The plain versions' split convolution (hi*hi + lo*hi + hi*lo, FP32
    sums) against the same three products of JAX's own split
    (``split_bf16_xla``) summed in float64: atol 1e-5 on values of order
    one; and the three products are what makes it f32-grade, 2e-5 from
    the float64 convolution of the unsplit operands."""
    fn = {"decode": torch.nn.functional.conv_transpose2d,
          "adjoint": torch.nn.functional.conv2d}[which]
    cz, cx, k, pad = 16, 3, 5, 1
    rng = np.random.default_rng(31)
    a = rng.standard_normal((2, cz if which == "decode" else cx, 9, 8))
    W = rng.standard_normal((cz, cx, k, k)) / np.sqrt(cz * k * k)
    a, W = a.astype(np.float32), W.astype(np.float32)
    got = TC._conv_product(fn, t(a), t(W), pad, "f32")
    (a_hi, a_lo), (w_hi, w_lo) = [
        [torch.from_numpy(np.asarray(p.astype(jnp.float32), np.float64))
         for p in j_split(jnp.asarray(v))] for v in (a, W)]
    want = (fn(a_hi, w_hi, padding=pad) + fn(a_lo, w_hi, padding=pad)
            + fn(a_hi, w_lo, padding=pad))
    np.testing.assert_allclose(n(got), n(want), atol=1e-5)
    exact = fn(torch.from_numpy(a).double(), torch.from_numpy(W).double(),
               padding=pad)
    np.testing.assert_allclose(n(got), n(exact), atol=2e-5)


@pytest.mark.parametrize("kp", ["f32", "bf16"])
def test_conv_operands_match_jax_split(kp):
    """The kernels' operands (W's parts, made once a call) hold JAX's split
    of W (``split_bf16_xla``; 'bf16': its rounding) in the kernels'
    layouts: K9a's row cx kw + kj at depth cz for each filter row; K9b's
    row cz at depth cx kw + kj for each filter row, or, where Cx kw < 16,
    at depth (cx kh + ki) kw + kj (W as it lies); 8-deep chunks of 16
    bytes a row, zero past the real rows and depths."""
    for cz, cx, kh, kw in ((13, 4, 3, 5), (13, 3, 4, 5)):
        W = np.random.default_rng(cx).standard_normal((cz, cx, kh, kw))
        W = W.astype(np.float32)
        ops = TC.conv_operands(t(W), kp)
        parts = ([np.asarray(p.astype(jnp.float32)) for p in j_split(W)]
                 if kp == "f32" else [np.asarray(j_round(jnp.asarray(W)))])
        fold = cx * kw < 16
        ck, cb = cx * kw, cx * kh * kw if fold else cx * kw
        da, db = -(-cz // 16) * 16, -(-cb // 16) * 16
        wa, wb = n(ops.wa.float()), n(ops.wb.float())
        assert wa.shape == (len(parts), kh, da // 8, 256, 8)
        assert wb.shape == (len(parts), 1 if fold else kh, db // 8, 256, 8)
        for p, part in enumerate(parts):
            # [filter rows, depth, rows] from the chunked layouts
            a = wa[p].transpose(0, 1, 3, 2).reshape(kh, da, 256)
            b = wb[p].transpose(0, 1, 3, 2).reshape(-1, db, 256)
            want_a = part.transpose(2, 0, 1, 3).reshape(kh, cz, ck)
            want_b = (part.reshape(1, cz, cb).transpose(0, 2, 1) if fold
                      else part.transpose(2, 1, 3, 0).reshape(kh, ck, cz))
            np.testing.assert_array_equal(a[:, :cz, :ck], want_a)
            np.testing.assert_array_equal(b[:, :cb, :cz], want_b)
            assert not a[:, cz:].any() and not a[:, :, ck:].any()
            assert not b[:, cb:].any() and not b[:, :, cz:].any()


@pytest.mark.parametrize("geom", [(1, 8, 1, 8, 512, 1), (1, 8, 1, 8, 1, 300)])
def test_gate_keeps_tall_and_wide_filters(geom):
    """The kernels shrink their stages to fit shared memory, so the gate is
    JAX's conditions alone: a 512 x 1 filter (4096 tap rows) and a 1 x
    300 one route fused, as they did with the SIMT kernels, and one image
    channel more than 4096 tap rows allow does not."""
    n_, cz, cx, hz, kh, kw = geom
    xt = torch.zeros((n_, cx, hz + kh - 1, hz + kw - 1), device="meta")
    zt = torch.zeros((n_, cz, hz, hz), device="meta")
    Wt = torch.zeros((cz, cx, kh, kw), device="meta")
    assert TC.supports_fused_conv(xt, zt, Wt, 1, 0)
    over = 4096 // (kh * -(-kw // 8) * 8) + 1   # image channels past 4096
    xo = torch.zeros((n_, over) + tuple(xt.shape[2:]), device="meta")
    Wo = torch.zeros((cz, over, kh, kw), device="meta")
    assert not TC.supports_fused_conv(xo, zt, Wo, 1, 0)
