"""lasso_tpu_torch.utils against lasso_tpu.utils: CSR serving output and
``encode --csr``, checkpoints and ``dict_learning_resumable``, typed
configs, exported encoders and the profiling helpers.

Tolerances, those of tests/test_utils.py: CSR codes unpacked atol 1e-5
(:159-176); the resumable EM segment from JAX's initial dictionary losses
atol 1e-5 and W 1e-4 (:26-57); config encodes 1e-6 (:60-73); exported
codes 1e-5 (:83-100). The port against itself: resumable runs and config
encodes bit for bit, exported codes atol 1e-6 with equal iteration
counts. Each JAX oracle runs under ``jax.jit``.
"""

import dataclasses
import importlib
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lasso_tpu.utils as jutils
import lasso_tpu_torch.utils as tutils
from lasso_tpu.native import unpack_codes_csr as j_unpack
from lasso_tpu_torch.__main__ import main as cli_main
from lasso_tpu_torch.linear import dict_learning, sparse_encode
from lasso_tpu_torch.native import unpack_codes_csr

from _torch_port import n, one_torch_thread, release_jax_after_module  # noqa: F401,E501
from _torch_port import t

tdl = importlib.import_module("lasso_tpu_torch.linear.dict_learning")


def _unit_atoms(rng, d, k):
    W = rng.standard_normal((d, k)).astype(np.float32)
    return W / np.linalg.norm(W, axis=0, keepdims=True)


# -- CSR serving output ---------------------------------------------------

def test_chunked_csr_matches_jax(rng):
    x = rng.standard_normal((50, 12)).astype(np.float32)
    W = _unit_atoms(rng, 12, 20)
    kw = dict(alpha=0.3, chunk_size=16, algorithm="ista", maxiter=300,
              tol=0.0, output="csr")
    jv, jc, jrp = jutils.chunked_encode(x, W, **kw)
    v, c, rp = tutils.chunked_encode(x, W, device="cpu", **kw)
    assert (v.dtype, c.dtype, rp.dtype) == (np.float32, np.int32, np.int64)
    z = unpack_codes_csr(v, c, rp, 20)
    np.testing.assert_allclose(z, j_unpack(jv, jc, jrp, 20), atol=1e-5)
    dense = tutils.chunked_encode(x, W, device="cpu",
                                  **{**kw, "output": "dense"})
    np.testing.assert_array_equal(z, dense)
    assert rp[-1] == (dense != 0).sum()
    empty = tutils.chunked_encode(x[:0], W, device="cpu", **kw)
    assert [a.tolist() for a in empty] == [[], [], [0]]
    with pytest.raises(ValueError):
        tutils.chunked_encode(x, W, device="cpu", out=np.empty((50, 20)),
                              **kw)
    with pytest.raises(ValueError):
        tutils.chunked_encode(np.zeros((4, 1, 6, 6), np.float32),
                              np.ones((2, 1, 3, 3), np.float32),
                              device="cpu",
                              **{**kw, "algorithm": "ista_conv2d"})


def test_cli_encode_csr(tmp_path, rng):
    x = rng.standard_normal((40, 12)).astype(np.float32)
    W = _unit_atoms(rng, 12, 16)
    paths = {k: str(tmp_path / f"{k}.npy") for k in ("X", "W", "Z")}
    np.save(paths["X"], x)
    np.save(paths["W"], W)
    solver = json.dumps({"maxiter": 100, "tol": 0.0})
    common = [paths["X"], paths["W"], "--alpha", "0.2", "--chunk-size",
              "16", "--device", "cpu", "--solver-args", solver]
    cli_main(["encode", *common, "-o", paths["Z"]])
    cli_main(["encode", *common, "--csr", "-o", str(tmp_path / "C.npy")])
    parts = [np.load(tmp_path / f"C.{p}.npy")
             for p in ("values", "cols", "row_ptr")]
    np.testing.assert_array_equal(unpack_codes_csr(*parts, 16),
                                  np.load(paths["Z"]))


# -- checkpoints ----------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    path = tmp_path / "ckpt"
    assert tutils.latest_step(path) is None
    assert tutils.restore_checkpoint(path) == (None, None)
    state = {"weight": torch.arange(6.0).reshape(2, 3),
             "losses": np.zeros(4, np.float32), "step_size": 0.5,
             "generator": torch.Generator().manual_seed(1).get_state()}
    tutils.save_checkpoint(path, state, step=3)
    tutils.save_checkpoint(path, {**state, "step_size": 0.25}, step=5)
    tutils.save_checkpoint(path, {**state, "step_size": 0.125}, step=5)
    # a save cut short leaves its temporary name, which is not a step
    (path / ".9-cut").mkdir()
    (path / ".9-cut" / "state.pt").write_bytes(b"partial")
    (path / "11").mkdir()
    assert tutils.latest_step(path) == 5
    restored, step = tutils.restore_checkpoint(path)
    assert step == 5 and restored["step_size"] == 0.125
    assert isinstance(restored["losses"], np.ndarray)
    assert torch.equal(restored["weight"], state["weight"])
    assert torch.equal(restored["generator"], state["generator"])
    template = {**state, "weight": torch.zeros(2, 3, dtype=torch.float64)}
    restored, step = tutils.restore_checkpoint(path, template, step=3)
    assert step == 3 and restored["weight"].dtype == torch.float64
    np.testing.assert_array_equal(n(restored["weight"]),
                                  np.arange(6.0).reshape(2, 3))
    with pytest.raises(ValueError):
        tutils.restore_checkpoint(path, {"weight": template["weight"]})


_DL = dict(n_components=12, alpha=0.1, steps=8, maxiter=50, tol=0.0,
           lr=0.1)


def _gen():
    return torch.Generator().manual_seed(3)


def test_resumable_matches_dict_learning(rng, tmp_path):
    """Sequential, block and ridge M-steps: with and without checkpoints,
    bit for bit dict_learning's result."""
    X = t(rng.standard_normal((32, 8)).astype(np.float32))
    for i, kw in enumerate((dict(), dict(dict_update="block"),
                            dict(constrained=False))):
        W, losses = dict_learning(X, generator=_gen(), **_DL, **kw)
        for ckpt in (None, tmp_path / f"dl{i}"):
            Wr, lr_ = tutils.dict_learning_resumable(
                X, generator=_gen(), ckpt_dir=ckpt, save_every=3, **_DL,
                **kw)
            assert torch.equal(Wr, W) and torch.equal(lr_, losses)
        assert sorted(os.listdir(tmp_path / f"dl{i}")) == ["3", "6", "8"]


@pytest.mark.parametrize("persist", [False, True])
def test_resume_after_deleting_checkpoints(rng, tmp_path, persist):
    """A run whose later checkpoints are gone resumes from step 6 (with
    another generator: the saved state replaces it) and ends bit for bit
    where the uninterrupted run did; a resume with a larger ``steps`` goes
    on from the saved step."""
    X = t(rng.standard_normal((32, 8)).astype(np.float32))
    kw = dict(**_DL, persist=persist, save_every=3)
    W, losses = tutils.dict_learning_resumable(X, generator=_gen(),
                                               ckpt_dir=tmp_path, **kw)
    shutil.rmtree(tmp_path / "8")
    assert tutils.latest_step(tmp_path) == 6
    Wr, lr_ = tutils.dict_learning_resumable(
        X, generator=torch.Generator().manual_seed(99), ckpt_dir=tmp_path,
        **kw)
    assert torch.equal(Wr, W) and torch.equal(lr_, losses)
    W10, l10 = tutils.dict_learning_resumable(
        X, generator=_gen(), ckpt_dir=tmp_path, **{**kw, "steps": 10})
    assert tutils.latest_step(tmp_path) == 10
    assert torch.equal(l10[:8], losses) and bool(torch.all(l10[8:] > 0))


def test_resumable_segment_matches_jax(rng, tmp_path):
    """The port's EM loop in segments of 3 steps from JAX's initial
    dictionary against JAX's dict_learning_resumable (ridge M-step)."""
    X = rng.standard_normal((32, 8)).astype(np.float32)
    kw = dict(n_components=12, alpha=0.1, constrained=False, steps=8,
              maxiter=100)
    key = jax.random.PRNGKey(7)
    Wj, lj = jutils.dict_learning_resumable(
        jnp.asarray(X), ckpt_dir=str(tmp_path / "j"), save_every=3, key=key,
        **kw)
    _, init_key = jax.random.split(key)
    w0 = jax.nn.initializers.orthogonal()(init_key, (8, 12), jnp.float32)
    p = tutils.from_numpy_params({"weight0": np.asarray(w0), "x": X}, "cpu")
    W, Z0, losses = p["weight0"], None, []
    for start in (0, 3, 6):
        W, Z0, seg = tdl._dict_learning(
            p["x"], W, None, alpha=0.1, constrained=False,
            steps=min(start + 3, 8), maxiter=100, start=start, Z0=Z0,
            return_codes=True)
        losses.append(seg)
    np.testing.assert_allclose(n(torch.cat(losses)), np.asarray(lj),
                               atol=1e-5)
    np.testing.assert_allclose(n(W), np.asarray(Wj), atol=1e-4)


# -- typed configs --------------------------------------------------------

def test_configs_match_jax():
    assert set(tutils.CONFIGS) == set(jutils.CONFIGS)
    classes = [(tutils.SolverConfig, jutils.SolverConfig)] + [
        (tutils.CONFIGS[k], jutils.CONFIGS[k]) for k in jutils.CONFIGS]
    assert len(classes) == 8
    for tc, jc in classes:
        assert tc.__name__ == jc.__name__
        assert dataclasses.is_dataclass(tc) and tc.__dataclass_params__.frozen
        assert ([(f.name, f.default) for f in dataclasses.fields(tc)]
                == [(f.name, f.default) for f in dataclasses.fields(jc)])
        assert tc().kwargs() == jc().kwargs()
    cfg = tutils.config_for("gpsr", maxiter=7)
    assert cfg.maxiter == 7 and cfg.algorithm == "gpsr"
    with pytest.raises(ValueError):
        tutils.config_for("bogus")


def test_config_encode(rng):
    """Bit for bit the port's sparse_encode; against JAX's config in
    float64 at the step size JAX's lr='auto' takes (torch cannot draw
    JAX's start vector of the power iteration). In float32 the two BLAS
    libraries' roundings part the codes of this problem by 1.9e-6 after
    its 500 iterations, over the 1e-6 at which tests/test_utils.py:60-73
    holds JAX against itself."""
    from lasso_tpu.linalg import lipschitz_constant as j_lipschitz
    x = rng.standard_normal((8, 10)).astype(np.float32)
    W = _unit_atoms(rng, 10, 16)
    cfg = tutils.config_for("ista", maxiter=500, tol=1e-8)
    z = cfg.encode(t(x), t(W), alpha=0.2)
    assert torch.equal(z, sparse_encode(t(x), t(W), 0.2, algorithm="ista",
                                        maxiter=500, tol=1e-8))
    x64, W64 = x.astype(np.float64), W.astype(np.float64)
    with jax.enable_x64():
        lr = float(1.0 / np.asarray(j_lipschitz(jnp.asarray(W64))))
        jcfg = jutils.config_for("ista", maxiter=500, tol=1e-8, lr=lr)
        zj = np.asarray(jax.jit(lambda a, b: jcfg.encode(a, b, alpha=0.2))(
            jnp.asarray(x64), jnp.asarray(W64)))
    z = tutils.config_for("ista", maxiter=500, tol=1e-8, lr=lr).encode(
        t(x64), t(W64), alpha=0.2)
    np.testing.assert_allclose(n(z), zj, atol=1e-6)
    ridge = tutils.config_for("iter-ridge", maxiter=5)
    assert torch.equal(ridge.encode(t(x), t(W), alpha=0.2),
                       sparse_encode(t(x), t(W), 0.2,
                                     algorithm="iter-ridge", init="ridge",
                                     **ridge.kwargs()))


# -- exported encoders ----------------------------------------------------

def test_export_matches_jax_load_encoder(rng):
    """On the plain path, the one JAX's CPU export takes (the fused path's
    'f32' is the bf16x3 split, held to sparse_encode below)."""
    W = _unit_atoms(rng, 10, 16)
    x = rng.standard_normal((8, 10)).astype(np.float32)
    kw = dict(alpha=0.2, algorithm="ista", batch_size=8, maxiter=200,
              tol=1e-8, lr=0.1, use_pallas=False)
    blob = tutils.export_encoder(t(W), **kw)
    assert isinstance(blob, bytes)
    z = tutils.load_encoder(blob)(t(x), t(W))
    zj = jutils.load_encoder(jutils.export_encoder(jnp.asarray(W), **kw))(
        jnp.asarray(x), jnp.asarray(W))
    np.testing.assert_allclose(n(z), np.asarray(zj), atol=1e-5)


def _correlated_problem(rng, rows):
    """Atoms sharing a common direction, on which the bf16 phase of
    'mixed' at tol 5e-3 stops after its first block and the f32 tail then
    runs far past its own length (32 iterations)."""
    W = rng.standard_normal((64, 128)) + 3.0
    W = (W / np.linalg.norm(W, axis=0)).astype(np.float32)
    return W, rng.standard_normal((rows, 64)).astype(np.float32)


@pytest.mark.parametrize("kw", [
    dict(tol=1e-2, restart=True),
    dict(kernel_precision="mixed", lr="auto", maxiter=256, tol=5e-3,
         fuse_steps=8, alpha=0.1),
    dict(kernel_precision="bf16", fuse_steps=8, maxiter=37, nonneg=True,
         l2=0.1, alpha=np.linspace(0.1, 0.3, 40, dtype=np.float32)),
    dict(use_pallas=False, maxiter=30, tol=1e-2),
], ids=["f32_stop_restart", "mixed_tail_past_its_length",
        "bf16_row_remainder", "plain"])
def test_export_matches_sparse_encode(rng, kw):
    """A symbolic batch at two sizes (one off the 8-row grid) against
    sparse_encode on the same (fused or plain) path: codes atol 1e-6 and
    the same iteration count. The 'mixed' case is one where the bf16
    phase stops early and the f32 tail needs more than its own length."""
    kw = {"maxiter": 64, "tol": 1e-4, "lr": 0.1, "alpha": 0.2, **kw}
    if kw.get("use_pallas") is None:
        kw["use_pallas"] = True
    mixed = kw.get("kernel_precision") == "mixed"
    if mixed:
        W, x24 = _correlated_problem(rng, 24)
    else:
        W = (rng.standard_normal((20, 40)) / np.sqrt(20)).astype(np.float32)
    call = tutils.load_encoder(tutils.export_encoder(
        t(W), return_iters=True, **kw))
    alpha = kw.pop("alpha")
    alpha = t(alpha) if isinstance(alpha, np.ndarray) else alpha
    for rows in (13, 24):
        x = t(x24[:rows] if mixed else
              rng.standard_normal((rows, 20)).astype(np.float32))
        z, k = call(x, t(W))
        want, k_want = sparse_encode(x, t(W), alpha, return_iters=True,
                                     **kw)
        np.testing.assert_allclose(n(z), n(want), atol=1e-6)
        assert int(k) == k_want
    if kw.get("tol") == 1e-2:
        assert k_want < kw["maxiter"]
    if mixed:
        _, k_bf16 = sparse_encode(x, t(W), alpha, return_iters=True,
                                  **{**kw, "kernel_precision": "bf16"})
        assert k_bf16 == 8 and k_want - k_bf16 > 32 and k_want < 256


def test_export_refuses(rng):
    """Another algorithm, a per-sample alpha, and an option that the
    export's check call refuses."""
    W = t(_unit_atoms(rng, 10, 16))
    with pytest.raises(NotImplementedError, match="A.15"):
        tutils.export_encoder(W, algorithm="cd")
    with pytest.raises(ValueError):
        tutils.export_encoder(W, alpha=torch.full((8,), 0.2), batch_size=8)
    with pytest.raises(ValueError, match="kernel_precision"):
        tutils.export_encoder(W, kernel_precision="fp8")


# -- profiling ------------------------------------------------------------

def test_trace_and_time_solver(rng, tmp_path):
    x = t(rng.standard_normal((8, 10)).astype(np.float32))
    with tutils.capture_trace(str(tmp_path)):
        with tutils.trace("encode_region"):
            torch.tanh(x) @ x.T
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".json")
    assert "encode_region" in (tmp_path / files[0]).read_text()
    secs, out = tutils.time_solver(lambda a: torch.tanh(a) @ a.T, x)
    assert secs > 0 and tuple(out.shape) == (8, 8)


def test_debug_nans():
    with pytest.raises(FloatingPointError, match="log"):
        with tutils.debug_nans():
            torch.log(torch.tensor(-1.0))
    with tutils.debug_nans():
        assert float(torch.log(torch.tensor(2.0))) > 0
    with tutils.debug_nans():
        with tutils.debug_nans(False):
            assert torch.isnan(torch.log(torch.tensor(-1.0)))
        with pytest.raises(FloatingPointError):
            torch.log(torch.tensor(-1.0))
    assert torch.isnan(torch.log(torch.tensor(-1.0)))
