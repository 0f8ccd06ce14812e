"""lasso_tpu_torch encode surface against lasso_tpu: initialize_code,
sparse_encode, chunked_encode, the CLI's encode, the headline bench's
solve, and from_numpy_params. Everything runs on the CPU (device='cpu').
"""

import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lasso_tpu.linear import initialize_code as j_init
from lasso_tpu.linear import sparse_encode as j_encode
from lasso_tpu.linear.solvers import ista as jista
from lasso_tpu.utils import chunked_encode as j_chunked
from lasso_tpu_torch import headline_bench
from lasso_tpu_torch.__main__ import main as cli
from lasso_tpu_torch.linear import initialize_code, sparse_encode
from lasso_tpu_torch.native import unpack_codes_csr
from lasso_tpu_torch.utils import chunked_encode, from_numpy_params

from _torch_port import make_problem, n, objective, t
from _torch_port import release_jax_after_module  # noqa: F401


@pytest.mark.parametrize("mode", ["zero", "lstsq", "ridge", "transpose"])
def test_initialize_code_matches_jax(rng, mode):
    x, _, _, W = make_problem(rng, n=16, d=128, k=64)
    for alpha in (0.3, np.full(16, 0.2, np.float32)):
        want = n(j_init(jnp.asarray(x), jnp.asarray(W), alpha, mode))
        got = n(initialize_code(t(x), t(W), alpha, mode))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_initialize_code_unif_and_errors(rng):
    x, _, _, W = make_problem(rng, n=64, d=128, k=256)
    z = initialize_code(t(x), t(W), 0.1, "unif")
    assert z.shape == (64, 256) and z.dtype == torch.float32
    assert -0.1 <= float(z.min()) and float(z.max()) < 0.1
    assert abs(float(z.mean())) < 0.01
    g = torch.Generator().manual_seed(5)
    z1 = initialize_code(t(x), t(W), 0.1, "unif", generator=g)
    z2 = initialize_code(t(x), t(W), 0.1, "unif",
                         generator=torch.Generator().manual_seed(5))
    assert torch.equal(z1, z2) and not torch.equal(z1, z)
    with pytest.raises(ValueError):
        initialize_code(t(x), t(W), 0.1, "bogus")


@pytest.mark.parametrize("alpha", ["scalar", "per_sample", "per_feature"])
def test_sparse_encode_matches_jax(rng, alpha):
    x, _, _, W = make_problem(rng, n=16)
    a = {"scalar": 0.1,
         "per_sample": (0.05 + 0.1 * rng.random(16)).astype(np.float32),
         "per_feature": (0.05 + 0.1 * rng.random((1, 256))).astype(
             np.float32)}[alpha]
    kw = dict(lr=0.1, maxiter=100, tol=1e-5, use_pallas=True)
    zj, kj = j_encode(jnp.asarray(x), jnp.asarray(W), a, return_iters=True,
                      **kw)
    zt, kt = sparse_encode(t(x), t(W), t(a) if alpha != "scalar" else a,
                           return_iters=True, **kw)
    assert kt == int(kj)
    np.testing.assert_allclose(n(zt), n(zj), atol=1e-4)
    z_only = sparse_encode(t(x), t(W), t(a) if alpha != "scalar" else a,
                           **kw)
    assert torch.equal(z_only, zt)


def test_sparse_encode_dispatch_errors(rng):
    """An unknown name, a per-feature row for group-ista and a z0 of the
    wrong shape raise. The five algorithms ported last dispatch and match
    JAX's sparse_encode by the golden-parity rules of the JAX tests
    (tests/test_torch_solvers.py lists them): the f64 objective within
    1e-3 (gpsr, iter-ridge) or 2e-3 (interior-point), at most 1 + 1e-3
    times JAX's (own), split Bregman's codes atol 2e-3; gpsr also through
    the row and the column rescaling (uniform rows: the same problem)."""
    x, _, _, W = make_problem(rng, n=8)
    args = (t(x), t(W), 0.1)
    with pytest.raises(ValueError, match="unknown algorithm"):
        sparse_encode(*args, algorithm="bogus")
    rtol = {"gpsr": 1e-3, "iter-ridge": 1e-3, "interior-point": 2e-3}
    for name in ("gpsr", "iter-ridge", "interior-point", "split-bregman",
                 "own"):
        zt = sparse_encode(*args, algorithm=name)
        zj = j_encode(jnp.asarray(x), jnp.asarray(W), 0.1, algorithm=name)
        f, f_jax = objective(x, W, n(zt), 0.1), objective(x, W, n(zj), 0.1)
        if name == "split-bregman":
            np.testing.assert_allclose(n(zt), n(zj), atol=2e-3)
        elif name == "own":
            assert f <= f_jax * (1 + 1e-3)
        else:
            np.testing.assert_allclose(f, f_jax, rtol=rtol[name])
    for a in (np.full((1, 256), 0.1, np.float32),   # the row rescaling
              np.full(8, 0.1, np.float32)):         # the column rescaling
        zt = sparse_encode(t(x), t(W), t(a), algorithm="gpsr")
        zj = j_encode(jnp.asarray(x), jnp.asarray(W), jnp.asarray(a),
                      algorithm="gpsr")
        np.testing.assert_allclose(objective(x, W, n(zt), 0.1),
                                   objective(x, W, n(zj), 0.1), rtol=1e-3)
    with pytest.raises(ValueError):
        sparse_encode(t(x), t(W), t(np.full((1, 256), 0.1, np.float32)),
                      algorithm="group-ista")
    with pytest.raises(ValueError):
        sparse_encode(*args, z0=torch.zeros((8, 255)))


@pytest.mark.parametrize("package", ["jax", "port"])
def test_wrong_shape_z0_is_refused(rng, package):
    """A z0 of the wrong shape: JAX asserts, the port raises ValueError (a
    difference kept on purpose: an assert vanishes under ``python -O``)."""
    x, _, _, W = make_problem(rng, n=8, d=16, k=24)
    if package == "jax":
        with pytest.raises(AssertionError):
            j_encode(jnp.asarray(x), jnp.asarray(W), 0.1,
                     z0=jnp.zeros((8, 23)))
    else:
        with pytest.raises(ValueError, match="z0 has shape"):
            sparse_encode(t(x), t(W), 0.1, z0=torch.zeros((8, 23)))


@pytest.mark.parametrize("alpha", ["scalar", "per_sample"])
def test_chunked_encode_matches_jax(rng, alpha):
    """37 rows in chunks of 16: the last chunk is ragged and zero-padded;
    per-sample alpha is sliced per chunk."""
    x = rng.standard_normal((37, 128)).astype(np.float32)
    W = (rng.standard_normal((128, 256)) / np.sqrt(128)).astype(np.float32)
    a = (0.1 if alpha == "scalar"
         else (0.05 + 0.1 * rng.random(37)).astype(np.float32))
    kw = dict(lr=0.1, maxiter=60, tol=0.0, use_pallas=True)
    want = j_chunked(x, W, alpha=a, chunk_size=16, **kw)
    got = chunked_encode(x, W, alpha=a, chunk_size=16, device="cpu", **kw)
    assert got.shape == (37, 256) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)
    # each row is the direct solve of that row
    direct = n(sparse_encode(t(x[32:]), t(W), a if alpha == "scalar"
                             else t(a[32:]), **kw))
    np.testing.assert_allclose(got[32:], direct, atol=1e-5)


def test_chunked_encode_options(rng):
    x = rng.standard_normal((10, 128)).astype(np.float32)
    W = (rng.standard_normal((128, 128)) / np.sqrt(128)).astype(np.float32)
    out = np.zeros((10, 128), np.float32)
    assert chunked_encode(x, t(W), 0.1, out=out, lr=0.1) is out
    assert np.abs(out).sum() > 0
    assert chunked_encode(x[:0], W, device="cpu").shape == (0, 128)
    with pytest.raises(ValueError):
        chunked_encode(x, W, output="coo", device="cpu")
    # CSR output: the dense codes, packed; no preallocated buffer
    v, c, rp = chunked_encode(x, W, 0.1, device="cpu", output="csr", lr=0.1)
    dense = chunked_encode(x, W, 0.1, device="cpu", lr=0.1)
    np.testing.assert_array_equal(unpack_codes_csr(v, c, rp, 128), dense)
    with pytest.raises(ValueError):
        chunked_encode(x, W, device="cpu", output="csr", out=out)
    # conv streams dense codes only, as in the JAX package
    xc = rng.standard_normal((4, 1, 8, 8)).astype(np.float32)
    Wc = rng.standard_normal((4, 1, 3, 3)).astype(np.float32)
    for bad in ({"output": "csr"}, {"screen": True}):
        with pytest.raises(ValueError, match="output='dense'"):
            chunked_encode(xc, Wc, algorithm="ista_conv2d", device="cpu",
                           **bad)
    with pytest.raises(ValueError):
        chunked_encode(x, W, np.ones(9, np.float32), device="cpu")
    with pytest.raises(ValueError, match="scalar alpha"):   # screen=True
        chunked_encode(x, W, np.ones(10, np.float32), device="cpu",
                       screen=True)


def test_cli_encode(rng, tmp_path, capsys, monkeypatch):
    x = rng.standard_normal((40, 128)).astype(np.float32)
    W = (rng.standard_normal((128, 256)) / np.sqrt(128)).astype(np.float32)
    np.save(tmp_path / "X.npy", x)
    np.save(tmp_path / "W.npy", W)
    out = tmp_path / "Z.npy"
    solver = json.dumps({"lr": 0.1, "maxiter": 50, "tol": 0.0,
                         "use_pallas": True})
    cli(["encode", str(tmp_path / "X.npy"), str(tmp_path / "W.npy"),
         "-o", str(out), "--alpha", "0.2", "--chunk-size", "16",
         "--solver-args", solver, "--device", "cpu"])
    assert "encoded 40 samples" in capsys.readouterr().out
    z = np.load(out)
    want = j_encode(jnp.asarray(x), jnp.asarray(W), 0.2, lr=0.1, maxiter=50,
                    tol=0.0, use_pallas=True)
    np.testing.assert_allclose(z, np.asarray(want), atol=1e-4)
    # gpsr through the CLI: the full chunks are direct solves of their rows
    # (GPSR couples a chunk's rows, so the zero-padded last one is not)
    cli(["encode", str(tmp_path / "X.npy"), str(tmp_path / "W.npy"),
         "-o", str(out), "--alpha", "0.2", "--chunk-size", "16",
         "--algorithm", "gpsr", "--device", "cpu"])
    zg = np.load(out)
    assert zg.shape == (40, 256) and np.isfinite(zg).all()
    for i in (0, 16):
        np.testing.assert_allclose(
            zg[i:i + 16], n(sparse_encode(t(x[i:i + 16]), t(W), 0.2,
                                          algorithm="gpsr")), atol=1e-6)
    # --csr writes the first encode's codes, packed
    cli(["encode", str(tmp_path / "X.npy"), str(tmp_path / "W.npy"),
         "-o", str(tmp_path / "C.npy"), "--alpha", "0.2", "--chunk-size",
         "16", "--solver-args", solver, "--csr", "--device", "cpu"])
    parts = [np.load(tmp_path / f"C.{p}.npy")
             for p in ("values", "cols", "row_ptr")]
    np.testing.assert_array_equal(unpack_codes_csr(*parts, 256), z)
    # train runs on the card unless asked for the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli(["train", str(tmp_path / "X.npy"), "--atoms", "8"])


def test_bench_solve_matches_jax_small():
    """The whole slice at a small size through the bench's own solve: the
    mixed schedule with its 37-iteration tail against JAX's (objective
    rtol 1e-5), and the f32 solve."""
    xs, W = headline_bench.make_problem(32, 128, 256)
    x = xs[1]
    lr = 0.1
    for kp in ("mixed", "f32"):
        kw = ({"mixed_tail_iters": headline_bench.MIXED_TAIL_ITERS}
              if kp == "mixed" else {})
        want = jista(jnp.asarray(x), jnp.zeros((32, 256)), jnp.asarray(W),
                     headline_bench.ALPHA, lr=lr, maxiter=200, tol=0.0,
                     use_pallas=True, kernel_precision=kp, **kw)
        got = headline_bench.solve(t(x), t(W), lr, kp)
        np.testing.assert_allclose(
            headline_bench.objective64(x, W, got),
            objective(x, W, np.asarray(want), headline_bench.ALPHA),
            rtol=1e-5)


def test_bench_run_on_cpu_small():
    res = headline_bench.run("cpu", n=16, d=128, k=128, iters=20)
    assert set(res) == {"metric", "value", "unit", "gap_vs_f32_pct",
                        "device"}
    assert res["device"] == "cpu" and res["value"] > 0
    assert np.isfinite(res["gap_vs_f32_pct"])


def test_from_numpy_params(rng):
    W = rng.standard_normal((8, 5))
    x = rng.standard_normal((3, 8))
    p = from_numpy_params({"weight": W, "x": x, "z0": np.zeros((3, 5)),
                           "alpha": np.ones((1, 5))}, "cpu")
    assert all(v.dtype == torch.float32 and v.is_contiguous()
               for v in p.values())
    np.testing.assert_array_equal(n(p["weight"]), W.astype(np.float32))
    from_numpy_params({"weight": W, "x": x, "alpha": np.ones(3)}, "cpu")
    from_numpy_params({"weight": W.T.copy(order="F").T, "alpha": 0.5},
                      "cpu")
    for bad in ({"weight": W, "x": x.T}, {"weight": W[0]},
                {"weight": W, "x": x, "z0": np.zeros((4, 5))},
                {"weight": W, "alpha": np.ones(4)}, {"x": x},
                {"weight": W, "bias": x}):
        with pytest.raises(ValueError):
            from_numpy_params(bad, "cpu")


def test_cuda_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        from_numpy_params({"weight": np.ones((2, 2))}, "cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        chunked_encode(np.ones((2, 2), np.float32), np.ones((2, 2)))
