"""lasso_tpu_torch.nonlinear against lasso_tpu.nonlinear on the same numpy
inputs: the JAX tests' problems (tests/test_nonlinear.py:18-39 and :98-117:
the linear problem 12x10->14, the tanh MLP k=8, h=16, d=10 on 6 rows, the
single-sample linear residual of split Bregman), each JAX oracle under
``jax.jit``, the port on the CPU with torch decoders built from the same
weights by ``utils.from_numpy_tree``. ``lr='auto'`` is fed JAX's own
normalized draw through the private ``_ista_nl``.

Tolerances. In float64 (``jax.enable_x64`` and torch's default dtype
float64, so that the golden-section searches run in float64 in both, as
JAX takes ``jnp.result_type(float)``): iterates within 1e-9 of their
largest entry, and equal iteration counts. A golden-section search along a
direction that has shrunk to about 1e-7 compares objective values that
agree to their last bits, so its step there is decided by rounding and the
iterates part by up to 2e-7 (per-sample OWL-QN past 10 iterations,
per-sample iterative-ridge BFGS past 6, split Bregman 'cg' on the linear
residual once a Gauss-Newton step starts at the subproblem's optimum): the
budgets below stop such runs before that, and the linear 'cg' run, which
reaches it in its second Gauss-Newton step, is held by its cost (1e-9
relative; 7.4e-11 measured) and its iteration count. In float32: objectives within 1e-5
relative. There a golden-section search meets such ties much earlier, and
a run mid-way parts by up to 2e-3 in its objective (OWL-QN 'brent' at 50
iterations), so the searched runs are held where they have converged
(OWL-QN at the JAX test's 150 iterations: 1.2e-8; iterative-ridge BFGS at
40: 4.8e-7), and split Bregman at 4 outer iterations of 2 Gauss-Newton
steps (3.2e-6 measured).
"""

import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lasso_tpu.nonlinear import (hessian_2norm as j_hessian,
                                 ista_nl as j_ista_nl,
                                 iterative_ridge_bfgs as j_irb,
                                 owlqn as j_owlqn,
                                 split_bregman_nl as j_sb)
from lasso_tpu.nonlinear.ista import _normalize as j_normalize
from lasso_tpu_torch.nonlinear import (hessian_2norm, ista_nl,
                                       iterative_ridge_bfgs, owlqn,
                                       softshrink, split_bregman_nl)
from lasso_tpu_torch.nonlinear.ista import _ista_nl
from lasso_tpu_torch.utils import from_numpy_tree

from _torch_port import n, one_torch_thread, release_jax_after_module  # noqa: F401,E501

# the packages export the function owlqn under the module's name
j_owlqn_mod = importlib.import_module("lasso_tpu.nonlinear.owlqn")
t_owlqn_mod = importlib.import_module("lasso_tpu_torch.nonlinear.owlqn")


@pytest.fixture
def f64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        with jax.enable_x64():
            yield
    finally:
        torch.set_default_dtype(old)


def _linear(dtype=np.float64):
    """tests/test_nonlinear.py:18-27's problem (the rng fixture's seed)."""
    rng = np.random.default_rng(0)
    W = rng.standard_normal((10, 14))
    W /= np.linalg.norm(W, axis=0, keepdims=True)
    x = rng.standard_normal((12, 10))
    return x.astype(dtype), W.astype(dtype), 0.3


def _mlp(dtype=np.float64):
    """tests/test_nonlinear.py:30-39 and :120-124: params, x, z0."""
    rng = np.random.default_rng(0)
    params = {"w1": (rng.standard_normal((8, 16)) * 0.4).astype(dtype),
              "w2": (rng.standard_normal((16, 10)) * 0.4).astype(dtype)}
    x = rng.standard_normal((6, 10)).astype(dtype)
    z0 = (rng.standard_normal((6, 8)) * 0.1).astype(dtype)
    return params, x, z0


def _decoders(params, dtype):
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    pt = from_numpy_tree(params, "cpu", dtype)
    return (lambda z: jnp.tanh(z @ pj["w1"]) @ pj["w2"],
            lambda z: torch.tanh(z @ pt["w1"]) @ pt["w2"])


def _losses(dec_j, dec_t, x):
    """Batch-sum and per-row smooth losses of both packages."""
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    return (lambda z: 0.5 * jnp.sum(jnp.square(dec_j(z) - xj)),
            lambda z: 0.5 * torch.sum(torch.square(dec_t(z) - xt)),
            lambda z: 0.5 * jnp.sum(jnp.square(dec_j(z) - xj), axis=1),
            lambda z: 0.5 * torch.sum(torch.square(dec_t(z) - xt), dim=1))


def _same(zj, zt, kj=None, kt=None, rtol=1e-9, what=""):
    zj, zt = np.asarray(zj), n(zt)
    assert zt.shape == zj.shape, what
    err = np.abs(zt - zj).max() / max(np.abs(zj).max(), 1e-300)
    assert err <= rtol, (what, err)
    if kj is not None:
        np.testing.assert_array_equal(n(torch.as_tensor(kt)), np.asarray(kj),
                                      err_msg=what)


def _jax_start(z0, dtype):
    """JAX's normalized start of the power iteration (key None ->
    PRNGKey(0)) as a torch tensor."""
    return torch.from_numpy(np.array(j_normalize(jax.random.normal(
        jax.random.PRNGKey(0), z0.shape, dtype), (1,))))


def _l1obj(loss, z, alpha):
    return float(loss(z)) + alpha * float(np.abs(n(z)).sum())


def test_hessian_2norm_and_lbfgs_helpers(f64):
    """hessian_2norm given JAX's start (MLP and the linear decoder, whose
    Hessian's norm is W^T W's top eigenvalue); softshrink, project,
    pseudo_grad and the L-BFGS ring buffer (init, four updates with one
    rejected pair, the two-loop solve) against JAX's."""
    params, x, z0 = _mlp()
    dec_j, dec_t = _decoders(params, torch.float64)
    rss_j, rss_t, _, _ = _losses(dec_j, dec_t, x)
    sj, uj = jax.jit(lambda z: j_hessian(rss_j, z, niter=10,
                                         return_vector=True))(jnp.asarray(z0))
    st, ut = hessian_2norm(rss_t, torch.from_numpy(z0), niter=10,
                           u0=_jax_start(z0, jnp.float64),
                           return_vector=True)
    _same(sj, st, what="sigma")
    _same(uj, ut, what="u")
    xl, W, _ = _linear()
    Wt = torch.from_numpy(W)
    zl = np.random.default_rng(1).standard_normal((5, 14))
    sig = hessian_2norm(lambda z: 0.5 * torch.sum(torch.square(
        z @ Wt.T - torch.from_numpy(xl[:5]))), torch.from_numpy(zl),
        niter=100)
    np.testing.assert_allclose(n(sig), np.linalg.eigvalsh(W.T @ W)[-1],
                               rtol=1e-2)

    rng = np.random.default_rng(2)
    a = rng.standard_normal((6, 8))
    a[a < -0.5] = 0.0
    b = rng.standard_normal((6, 8))
    _same(j_owlqn_mod.project(a, b), t_owlqn_mod.project(
        torch.from_numpy(a), torch.from_numpy(b)), rtol=0)
    _same(j_owlqn_mod.pseudo_grad(a, b, 0.3), t_owlqn_mod.pseudo_grad(
        torch.from_numpy(a), torch.from_numpy(b), 0.3), rtol=0)
    _same(np.sign(a) * np.maximum(np.abs(a) - 0.2, 0), softshrink(
        torch.from_numpy(a), 0.2), rtol=0)
    xs = [rng.standard_normal((3, 4)) for _ in range(5)]
    gs = [2.0 * v + 0.1 * rng.standard_normal((3, 4)) for v in xs]
    gs[3] = gs[2] - (xs[3] - xs[2])          # y . s < 0: rejected
    update = jax.jit(j_owlqn_mod.lbfgs_update)
    solve = jax.jit(j_owlqn_mod.lbfgs_solve)
    lj = j_owlqn_mod.lbfgs_init(jnp.asarray(xs[0]), jnp.asarray(gs[0]), 3)
    lt = t_owlqn_mod.lbfgs_init(torch.from_numpy(xs[0]),
                                torch.from_numpy(gs[0]), 3)
    d = rng.standard_normal((3, 4))
    for xk, gk in zip(xs[1:], gs[1:]):
        lj = update(lj, jnp.asarray(xk), jnp.asarray(gk))
        lt = t_owlqn_mod.lbfgs_update(lt, torch.from_numpy(xk),
                                      torch.from_numpy(gk))
        assert (lt.head, lt.count) == (int(lj.head), int(lj.count))
        _same(solve(lj, jnp.asarray(d)),
              t_owlqn_mod.lbfgs_solve(lt, torch.from_numpy(d)), what="solve")
    assert lt.count == 3 and lt.head == 0      # 4 updates, one rejected


ISTA_CASES = {
    "fixed": dict(lr=0.07, maxiter=300, tol=1e-8),
    "ista": dict(lr=0.07, fast=False, maxiter=150, tol=1e-8),
    "auto": dict(maxiter=120, tol=1e-9),
    "auto_refresh4": dict(maxiter=120, tol=1e-9, lr_refresh=4),
    "restart": dict(lr=0.07, maxiter=300, tol=1e-8, restart=True),
    "restart_auto": dict(maxiter=60, tol=0.0, restart=True, lr_refresh=3),
}


def test_ista_nl_matches_jax(f64):
    """Every ista_nl variant on the MLP (fixed steps below 1/L, L up to 13
    on this problem): iterates and n_iter."""
    params, x, z0 = _mlp()
    dec_j, dec_t = _decoders(params, torch.float64)
    u0 = _jax_start(z0, jnp.float64)
    xt, z0t = torch.from_numpy(x), torch.from_numpy(z0)
    for name, kw in ISTA_CASES.items():
        zj, kj = jax.jit(lambda xx, zz, kw=kw: j_ista_nl(
            xx, zz, dec_j, alpha=0.05, return_iters=True, **kw))(
                jnp.asarray(x), jnp.asarray(z0))
        full = {**dict(fast=True, lr="auto", lr_refresh=1, restart=False),
                **kw}
        zt, kt = _ista_nl(xt, z0t, dec_t, 0.05, full["fast"],
                          full["maxiter"], full["lr"], 10, full["tol"],
                          u0, full["lr_refresh"], full["restart"], 0, True)
        _same(zj, zt, kj, kt, what=name)
        assert 0 < kt <= kw["maxiter"]
        if name == "fixed":
            # the public entry takes the same path
            _same(zj, ista_nl(xt, z0t, dec_t, alpha=0.05, **kw), what=name)


@pytest.mark.parametrize("mode", ["batch", "per_sample"])
def test_owlqn_matches_jax(f64, mode):
    """owlqn on the MLP with each line search, batch and per-sample."""
    params, x, z0 = _mlp()
    dec_j, dec_t = _decoders(params, torch.float64)
    rss_j, rss_t, row_j, row_t = _losses(dec_j, dec_t, x)
    per_sample = mode == "per_sample"
    fj, ft = (row_j, row_t) if per_sample else (rss_j, rss_t)
    for ls in ("brent", "backtrack", "none"):
        kw = dict(alpha=0.05, max_iter=10 if per_sample else 25, xtol=1e-8,
                  history_size=6,
                  line_search=ls, per_sample=per_sample, return_iters=True,
                  lr=0.5 if ls == "none" else 1.0)
        zj, kj = jax.jit(lambda zz, kw=kw: j_owlqn(fj, zz, **kw))(
            jnp.asarray(z0))
        zt, kt = owlqn(ft, torch.from_numpy(z0), **kw)
        _same(zj, zt, kj, kt, what=(mode, ls))


def test_iterative_ridge_bfgs_matches_jax(f64):
    """iterative_ridge_bfgs on the MLP (a nonzero z0: coordinates at zero
    stay put), batch and per-sample, with and without the line search."""
    params, x, z0 = _mlp()
    dec_j, dec_t = _decoders(params, torch.float64)
    rss_j, rss_t, row_j, row_t = _losses(dec_j, dec_t, x)
    for per_sample in (False, True):
        fj, ft = (row_j, row_t) if per_sample else (rss_j, rss_t)
        for line_search in (True, False):
            kw = dict(alpha=0.05, maxiter=6, xtol=1e-9, lr=0.5,
                      line_search=line_search, per_sample=per_sample,
                      return_iters=True)
            zj, kj = jax.jit(lambda zz, kw=kw: j_irb(fj, zz, **kw))(
                jnp.asarray(z0))
            zt, kt = iterative_ridge_bfgs(ft, torch.from_numpy(z0), **kw)
            _same(zj, zt, kj, kt, what=(per_sample, line_search))


def test_split_bregman_nl_matches_jax(f64):
    """split_bregman_nl 'exact' and 'cg' on tests/test_nonlinear.py:
    98-117's single-sample linear residual (at its settings; 'cg' by cost,
    see the module docstring), and 'cg' on the MLP's residual with the
    batch flattened into one problem."""
    rng = np.random.default_rng(0)
    W = rng.standard_normal((10, 8))
    W /= np.linalg.norm(W, axis=0, keepdims=True)
    xs = rng.standard_normal((10,))
    Wj, Wt = jnp.asarray(W), torch.from_numpy(W)
    kw = dict(alpha=0.2, lambd=1.0, max_iter=50, inner_iter=5, lstsq_iter=5,
              xtol=1e-8, return_iters=True)
    for solver in ("exact", "cg"):
        zj, kj = jax.jit(lambda zz, s=solver: j_sb(
            lambda z: Wj @ z - jnp.asarray(xs), zz, solver=s, **kw))(
                jnp.zeros(8))
        zt, kt = split_bregman_nl(lambda z: Wt @ z - torch.from_numpy(xs),
                                  torch.zeros(8, dtype=torch.float64),
                                  solver=solver, **kw)
        if solver == "exact":
            _same(zj, zt, kj, kt, what=solver)
        cost = [0.5 * np.sum((W @ np.asarray(z) - xs) ** 2)
                + 0.2 * np.abs(np.asarray(z)).sum() for z in (zj, n(zt))]
        assert kt == int(kj) and abs(cost[1] - cost[0]) <= 1e-9 * cost[0]
    params, x, z0 = _mlp()
    dec_j, dec_t = _decoders(params, torch.float64)
    kw = dict(alpha=0.05, max_iter=4, lstsq_iter=2, xtol=1e-10,
              return_iters=True, cg_kwargs={"maxiter": 30})
    zj, kj = jax.jit(lambda zz: j_sb(lambda z: dec_j(z) - jnp.asarray(x),
                                     zz, **kw))(jnp.asarray(z0))
    zt, kt = split_bregman_nl(lambda z: dec_t(z) - torch.from_numpy(x),
                              torch.from_numpy(z0), **kw)
    _same(zj, zt, kj, kt, what="mlp cg")


def test_float32_objectives_match_jax():
    """One run of each solver in float32 on both sides: objectives within
    1e-5 relative (module docstring), all codes finite."""
    params, x, z0 = _mlp(np.float32)
    dec_j, dec_t = _decoders(params, torch.float32)
    rss_j, rss_t, row_j, row_t = _losses(dec_j, dec_t, x)
    u0 = _jax_start(z0, jnp.float32)
    xj, z0j = jnp.asarray(x), jnp.asarray(z0)
    xt, z0t = torch.from_numpy(x), torch.from_numpy(z0)
    runs = {
        "ista_nl auto": (
            jax.jit(lambda: j_ista_nl(xj, z0j, dec_j, alpha=0.05,
                                      maxiter=200, tol=0.0)),
            lambda: _ista_nl(xt, z0t, dec_t, 0.05, True, 200, "auto", 10,
                             0.0, u0, 1, False, 0, False)),
        "owlqn": (jax.jit(lambda: j_owlqn(rss_j, z0j, alpha=0.05,
                                          max_iter=150, history_size=10)),
                  lambda: owlqn(rss_t, z0t, alpha=0.05, max_iter=150,
                                history_size=10)),
        "owlqn per-sample backtrack": (
            jax.jit(lambda: j_owlqn(row_j, z0j, alpha=0.05, max_iter=10,
                                    history_size=10, per_sample=True,
                                    line_search="backtrack")),
            lambda: owlqn(row_t, z0t, alpha=0.05, max_iter=10,
                          history_size=10, per_sample=True,
                          line_search="backtrack")),
        "iterative_ridge_bfgs": (
            jax.jit(lambda: j_irb(rss_j, z0j, alpha=0.05, maxiter=40)),
            lambda: iterative_ridge_bfgs(rss_t, z0t, alpha=0.05,
                                         maxiter=40)),
        "split_bregman_nl cg": (
            jax.jit(lambda: j_sb(lambda z: dec_j(z) - xj, z0j, alpha=0.05,
                                 max_iter=4, lstsq_iter=2)),
            lambda: split_bregman_nl(lambda z: dec_t(z) - xt, z0t,
                                     alpha=0.05, max_iter=4, lstsq_iter=2)),
    }
    f0 = _l1obj(rss_t, z0t, 0.05)
    for name, (run_j, run_t) in runs.items():
        zj, zt = np.array(run_j()), run_t()
        assert zt.dtype == torch.float32 and torch.isfinite(zt).all(), name
        fj = _l1obj(rss_t, torch.from_numpy(zj), 0.05)
        ft = _l1obj(rss_t, zt, 0.05)
        assert abs(ft - fj) <= 1e-5 * abs(fj) and ft < f0, (name, ft, fj)


def test_decoder_contract_and_errors(capsys):
    """An nn.Module decoder whose weights require gradients: the solvers
    run inside and outside torch.no_grad() alike, leave every .grad unset
    and return codes with no graph, the same codes as a plain function
    of the same weights; the public entries draw from a torch.Generator
    (seed 0 by default); the ValueErrors, and the TypeError of an
    axis_name that is no process group."""
    params, x, z0 = _mlp(np.float32)
    pt = from_numpy_tree(params, "cpu")
    assert pt["w1"].dtype == torch.float32 and pt["w1"].is_contiguous()

    class Dec(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.l1 = torch.nn.Linear(8, 16, bias=False)
            self.l2 = torch.nn.Linear(16, 10, bias=False)
            with torch.no_grad():
                self.l1.weight.copy_(pt["w1"].T)
                self.l2.weight.copy_(pt["w2"].T)

        def forward(self, z):
            return self.l2(torch.tanh(self.l1(z)))

    dec = Dec()
    xt, z0t = torch.from_numpy(x), torch.from_numpy(z0)
    rss = lambda z: 0.5 * torch.sum(torch.square(dec(z) - xt))  # noqa: E731
    row = lambda z: 0.5 * torch.sum(torch.square(dec(z) - xt), 1)  # noqa: E731
    plain = lambda z: torch.tanh(z @ pt["w1"]) @ pt["w2"]  # noqa: E731
    calls = {
        "ista_nl": lambda d: ista_nl(xt, z0t, d, alpha=0.05, maxiter=20,
                                     generator=torch.Generator().manual_seed(
                                         0)),
        "owlqn": lambda d: owlqn(lambda z: 0.5 * torch.sum(torch.square(
            d(z) - xt)), z0t, alpha=0.05, max_iter=5),
        "irb": lambda d: iterative_ridge_bfgs(lambda z: 0.5 * torch.sum(
            torch.square(d(z) - xt), 1), z0t, alpha=0.05, maxiter=5,
            per_sample=True),
        "split_bregman_nl": lambda d: split_bregman_nl(
            lambda z: d(z) - xt, z0t, alpha=0.05, max_iter=2),
    }
    for name, call in calls.items():
        z = call(dec)
        with torch.no_grad():
            z_ng = call(dec)
        assert z.grad_fn is None and not z.requires_grad, name
        assert all(p.grad is None for p in dec.parameters()), name
        np.testing.assert_array_equal(n(z), n(z_ng), err_msg=name)
        np.testing.assert_allclose(n(z), n(call(plain)), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(
        n(ista_nl(xt, z0t, dec, alpha=0.05, maxiter=20)),
        n(calls["ista_nl"](dec)))
    assert row(z0t).shape == (6,) and rss(z0t).ndim == 0

    # verbose prints through host reads only when asked
    ista_nl(xt, z0t, dec, alpha=0.05, maxiter=2, verbose=2)
    owlqn(rss, z0t, alpha=0.05, max_iter=2, verbose=2)
    iterative_ridge_bfgs(rss, z0t, alpha=0.05, maxiter=2, verbose=2)
    split_bregman_nl(lambda z: dec(z) - xt, z0t, alpha=0.05, max_iter=1,
                     disp=2)
    out = capsys.readouterr().out
    for line in ("initial loss", "iter 2 - loss", "final loss", "initial f",
                 "iter 2 - f", "Iterations: 2", "iter 1 - cost",
                 "final cost"):
        assert line in out, line

    with pytest.raises(ValueError):
        ista_nl(xt, z0t, dec, lr="fast")
    with pytest.raises(ValueError):
        ista_nl(xt, z0t, dec, fast=False, restart=True)
    with pytest.raises(TypeError, match="ProcessGroup"):
        ista_nl(xt, z0t, dec, axis_name="batch")
    with pytest.raises(ValueError):
        owlqn(rss, z0t, line_search="wolfe")
    with pytest.raises(ValueError):
        split_bregman_nl(lambda z: dec(z) - xt, z0t, solver="lu")
