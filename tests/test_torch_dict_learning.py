"""lasso_tpu_torch dictionary learning against lasso_tpu's: every M-step, the
EM loop with ista, cd and cd-mod E-steps, the online loop, the CLI's
``train`` and the errors.

torch cannot reproduce ``jax.random`` bits, so the JAX package's own draws
(the orthogonal initial dictionary, the replacement atoms of each step,
the minibatch indices) are made with JAX and handed, as numpy, to the
port's private loop functions, which take them in place of a generator.
Tolerances: M-steps atol 1e-5 on the atoms, codes equal; whole EM runs
losses rtol 1e-4 and atoms atol 1e-4.
"""

import importlib
import json

import numpy as np
import pytest
import torch

from lasso_tpu_torch.__main__ import main as cli_main
from lasso_tpu_torch.utils import from_numpy_params

from _torch_port import n, t
from _torch_port import release_jax_after_module  # noqa: F401

jdl = importlib.import_module("lasso_tpu.linear.dict_learning")
tdl = importlib.import_module("lasso_tpu_torch.linear.dict_learning")

# K < N: with more atoms than samples Z^T Z is singular but for the ridge
# of the block and ridge M-steps, which then amplify rounding differences
N, D, K = 32, 16, 24


@pytest.fixture
def data(rng):
    X = rng.standard_normal((N, D)).astype(np.float32)
    W = rng.standard_normal((D, K)).astype(np.float32)
    W /= np.linalg.norm(W, axis=0, keepdims=True)
    Z = (rng.standard_normal((N, K))
         * (rng.random((N, K)) < 0.3)).astype(np.float32)
    Z[:, 3] = 0.0                    # atom 3 is degenerate in the M-step
    return X, W, Z


def jx(a):
    import jax.numpy as jnp
    return jnp.asarray(a)


def jax_draws(seed, steps, constrained, dict_update):
    """The draws of the JAX package's dict_learning: the initial
    dictionary and each step's replacement atoms, as numpy."""
    import jax
    key, init_key = jax.random.split(jax.random.PRNGKey(seed))
    w0 = jax.nn.initializers.orthogonal()(init_key, (D, K))
    if constrained:
        w0 = w0 / (np.linalg.norm(w0, axis=0, keepdims=True) + 1e-30)
    shape = (K, D) if dict_update == "sequential" else (D, K)
    atoms = np.stack([np.asarray(jax.random.normal(k, shape))
                      for k in jax.random.split(key, steps)])
    return np.asarray(w0, np.float32), atoms.astype(np.float32)


def test_lasso_loss_and_dict_evaluate(data):
    X, W, Z = data
    np.testing.assert_allclose(
        float(tdl.lasso_loss(t(X), t(Z), t(W), 0.3)),
        float(jdl.lasso_loss(jx(X), jx(Z), jx(W), 0.3)), rtol=1e-6)
    kw = dict(algorithm="cd", maxiter=200, tol=1e-5)
    np.testing.assert_allclose(
        float(tdl.dict_evaluate(t(X), t(W), 0.3, **kw)),
        float(jdl.dict_evaluate(jx(X), jx(W), 0.3, **kw)), rtol=1e-5)


@pytest.mark.parametrize("positive", [False, True])
@pytest.mark.parametrize("block", [False, True])
def test_m_steps_match_jax(data, positive, block):
    import jax
    X, W, Z = data
    key = jax.random.PRNGKey(5)
    if block:
        Wj, Zj = jdl.update_dict_block(jx(W), jx(X), jx(Z), key=key,
                                       positive=positive)
        atoms = np.asarray(jax.random.normal(key, (D, K)))
        Wt, Zt = tdl._update_dict_block(t(W), t(X), t(Z), t(atoms.copy()),
                                        positive)
    else:
        Wj, Zj = jdl.update_dict(jx(W), jx(X), jx(Z), key=key,
                                 positive=positive)
        atoms = np.asarray(jax.random.normal(key, (K, D)))
        Wt, Zt = tdl._update_dict(t(W), t(X), t(Z), t(atoms.copy()),
                                  positive)
    np.testing.assert_allclose(n(Wt), n(Wj), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(n(Zt), n(Zj))
    assert not n(Zt)[:, 3].any()
    np.testing.assert_allclose(np.linalg.norm(n(Wt), axis=0), 1.0,
                               atol=1e-5)


def test_ridge_and_online_updates_match_jax(rng, data):
    X, W, Z = data
    for lambd in (1e-4, 1e-2):
        np.testing.assert_allclose(
            n(tdl.update_dict_ridge(t(X), t(Z), lambd=lambd)),
            n(jdl.update_dict_ridge(jx(X), jx(Z), lambd=lambd)),
            rtol=0, atol=1e-5)
    A = (Z.T @ Z / N).astype(np.float32)            # A[3, 3] = 0: skipped
    B = (X.T @ Z / N).astype(np.float32)
    for positive in (False, True):
        Wt = tdl.update_dict_online(t(W), t(A), t(B), sweeps=2,
                                    positive=positive)
        Wj = jdl.update_dict_online(jx(W), jx(A), jx(B), sweeps=2,
                                    positive=positive)
        np.testing.assert_allclose(n(Wt), n(Wj), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(n(Wt)[:, 3], W[:, 3])


@pytest.mark.parametrize("algorithm,dict_update,constrained,kw", [
    ("ista", "sequential", True, {"maxiter": 50, "tol": 0.0}),
    ("cd", "block", True, {"maxiter": 60, "tol": 0.0}),
    ("cd-mod", "sequential", True, {"max_iter": 20, "tol": 1e-4}),
    ("ista", "sequential", False, {"maxiter": 50, "tol": 0.0}),
], ids=["ista", "cd_block", "cd_mod", "ista_ridge"])
def test_em_loop_matches_jax(rng, algorithm, dict_update, constrained, kw):
    """The port's EM loop on the JAX package's draws, with persist (warm
    starts from the M-step's codes, zeroed degenerate coefficients
    included)."""
    import jax
    X = rng.standard_normal((N, D)).astype(np.float32)
    steps = 3
    Wj, lj = jdl.dict_learning(
        jx(X), K, alpha=0.2, steps=steps, key=jax.random.PRNGKey(1),
        algorithm=algorithm, dict_update=dict_update,
        constrained=constrained, persist=True, **kw)
    w0, atoms = jax_draws(1, steps, constrained, dict_update)
    p = from_numpy_params({"weight0": w0, "x": X, **(
        {"atoms": atoms} if dict_update == "sequential"
        else {"atoms_block": atoms})}, "cpu")
    Wt, lt = tdl._dict_learning(
        p["x"], p["weight0"], p.get("atoms", p.get("atoms_block")),
        alpha=0.2, steps=steps, algorithm=algorithm,
        dict_update=dict_update, constrained=constrained, persist=True,
        **kw)
    np.testing.assert_allclose(n(lt), np.asarray(lj), rtol=1e-4)
    np.testing.assert_allclose(n(Wt), np.asarray(Wj), rtol=0, atol=1e-4)


def test_online_loop_matches_jax(rng):
    import jax
    import jax.numpy as jnp
    X = rng.standard_normal((N, D)).astype(np.float32)
    kw = dict(alpha=0.2, batch_size=8, steps=4, forget=0.9, maxiter=50,
              tol=0.0)
    Wj, lj = jdl.dict_learning_online(jx(X), K, key=jax.random.PRNGKey(2),
                                      **kw)
    _, init_key, idx_key = jax.random.split(jax.random.PRNGKey(2), 3)
    w0 = jax.nn.initializers.orthogonal()(init_key, (D, K))
    w0 = np.asarray(w0 / (jnp.linalg.norm(w0, axis=0, keepdims=True)
                          + 1e-30))
    idx = np.asarray(jax.random.randint(idx_key, (4, 8), 0, N))
    p = from_numpy_params({"weight0": w0, "A": 1e-6 * np.eye(K),
                           "B": 1e-6 * w0}, "cpu")
    Wt, lt = tdl._dict_learning_online(
        t(X), p["weight0"], torch.from_numpy(idx.astype(np.int64)), p["A"],
        p["B"], alpha=0.2, gamma=0.9, maxiter=50, tol=0.0)
    np.testing.assert_allclose(n(lt), np.asarray(lj), rtol=1e-4)
    np.testing.assert_allclose(n(Wt), np.asarray(Wj), rtol=0, atol=1e-4)


def test_public_api_draws_from_the_generator(rng):
    """dict_learning and dict_learning_online take their draws from the
    generator: the same seed gives the same run; the loss does not rise
    and the atoms have unit norm."""
    X = t(rng.standard_normal((N, D)).astype(np.float32))

    def run(seed, fn=tdl.dict_learning, **kw):
        return fn(X, K, alpha=0.2, steps=4,
                  generator=torch.Generator().manual_seed(seed),
                  maxiter=50, tol=0.0, **kw)

    (W1, l1), (W2, l2) = run(3, algorithm="cd"), run(3, algorithm="cd")
    np.testing.assert_array_equal(n(W1), n(W2))
    np.testing.assert_array_equal(n(l1), n(l2))
    assert not np.array_equal(n(run(4, algorithm="cd")[0]), n(W1))
    assert np.all(np.diff(n(l1)) <= 1e-6)
    np.testing.assert_allclose(np.linalg.norm(n(W1), axis=0), 1.0, atol=1e-5)
    Wo, lo = run(3, tdl.dict_learning_online, batch_size=8)
    assert lo.shape == (4,) and np.isfinite(n(Wo)).all()
    assert np.all(np.linalg.norm(n(Wo), axis=0) <= 1.0 + 1e-5)


def test_cli_train_matches_api(rng, tmp_path, capsys):
    X = rng.standard_normal((N, D)).astype(np.float32)
    np.save(tmp_path / "X.npy", X)
    out = tmp_path / "W.npy"
    cli_main(["train", str(tmp_path / "X.npy"), "--atoms", str(K),
              "--alpha", "0.2", "--steps", "3", "--seed", "7",
              "--dict-update", "block", "--device", "cpu", "-o", str(out),
              "--solver-args", json.dumps({"algorithm": "cd"})])
    assert "trained 3 EM steps" in capsys.readouterr().out
    W_api, _ = tdl.dict_learning(t(X), K, alpha=0.2, steps=3,
                                 dict_update="block", algorithm="cd",
                                 generator=torch.Generator().manual_seed(7),
                                 maxiter=100, tol=0.0)
    np.testing.assert_array_equal(np.load(out), n(W_api))


def test_errors(rng, tmp_path):
    X = t(rng.standard_normal((N, D)).astype(np.float32))
    with pytest.raises(ValueError, match="dict_update"):
        tdl.dict_learning(X, K, steps=1, dict_update="parallel")
    with pytest.raises(ValueError, match="constrained"):
        tdl.dict_learning(X, K, steps=1, positive=True, constrained=False)
    with pytest.raises(ValueError, match="batch_size"):
        tdl.dict_learning_online(X, K, batch_size=0)
    with pytest.raises(ValueError, match="forget"):
        tdl.dict_learning_online(X, K, forget=1.5)
    with pytest.raises(TypeError, match="ProcessGroup"):
        tdl.update_dict(torch.eye(D, K), X, torch.zeros(N, K),
                        axis_name="batch")
    # the CLI's default maxiter reaches coord_descent_mod, which takes
    # max_iter: a TypeError, as in the JAX package's CLI
    np.save(tmp_path / "X.npy", n(X))
    with pytest.raises(TypeError, match="maxiter"):
        cli_main(["train", str(tmp_path / "X.npy"), "--atoms", str(K),
                  "--steps", "1", "--device", "cpu", "--solver-args",
                  json.dumps({"algorithm": "cd-mod"})])


def test_from_numpy_params_training_state(rng):
    w0 = rng.standard_normal((D, K))
    ok = {"weight0": w0, "atoms": np.zeros((3, K, D)),
          "atoms_block": np.zeros((3, D, K)), "A": np.eye(K),
          "B": np.zeros((D, K)), "x": np.zeros((5, D))}
    p = from_numpy_params(ok, "cpu")
    assert all(v.dtype == torch.float32 and v.is_contiguous()
               for v in p.values())
    for key, bad in (("atoms", np.zeros((3, D, K))),
                     ("atoms_block", np.zeros((D, K))),
                     ("A", np.eye(K + 1)), ("B", np.zeros((K, D))),
                     ("weight", np.zeros((D, K + 1)))):
        with pytest.raises(ValueError, match=key):
            from_numpy_params({**ok, key: bad}, "cpu")
