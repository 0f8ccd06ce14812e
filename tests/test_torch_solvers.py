"""lasso_tpu_torch's iterated ridge, GPSR, split Bregman, orthant-wise
Newton, interior point, constrained inference and OMP 'cg' against
lasso_tpu's on the same numpy inputs, and their dispatch through
sparse_encode with scalar, [N] and [1, K] alpha.

Each configuration runs one JAX solve and one port solve. Tolerances are
those by which the JAX package's own tests hold it against another
implementation of each solver (the reference's, in its golden-parity
tests), on the float64 lasso objective unless stated:

* iterated ridge: |f - f_jax| <= 1e-3 max(1, |f_jax|)
  (tests/test_iterative_ridge.py:66); 1.5e-3 for ``cg=True``, whose
  K-system CG stops on batch-global tolerances near f32 rounding: over
  the draws of seeds 0-9 the port's gap to JAX was at most 1.21e-3
  (2.0e-4 on this file's draw, seed 0), and JAX's own objective moves by
  up to 6.9e-4, with another outer iteration count, when x moves by one
  ulp;
* GPSR: 1e-3 the same way (tests/test_gpsr.py:66); after the debias phase
  the same supports and the rows' squared residuals rtol 1e-2 / atol 1e-5
  (:146-149);
* split Bregman: codes atol 2e-3 (tests/test_heavy_solvers.py:97);
* orthant-wise Newton: f <= f_jax (1 + 1e-3) (:120);
* interior point: 2e-3 (:78);
* constrained inference: the penalized form 1e-3 (:143), the constrained
  form every rss at most 1.05 rss_lim and one binding at 0.8 (:131-132);
* OMP 'cg': ``_assert_same_fit`` of tests/test_omp.py:207-222.

Iteration counts are equal unless a case says otherwise.
"""

import importlib
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lasso_tpu.linear import sparse_encode as j_encode
from lasso_tpu.linear.solvers import (constrained_inference as j_constr,
                                      gpsr_basic as j_gpsr,
                                      interior_point as j_ip,
                                      iterative_ridge as j_ir,
                                      orthant_wise_newton as j_own,
                                      orthogonal_matching_pursuit as j_omp,
                                      split_bregman as j_sb)
from lasso_tpu_torch.linear import solvers, sparse_encode
from lasso_tpu_torch.ops.common import INNER_ITERATIONS

from _torch_port import (assert_same_fit, n, objective, omp_problem, rss,
                         t)
from _torch_port import release_jax_after_module  # noqa: F401

own_mod = importlib.import_module(
    "lasso_tpu_torch.linear.solvers.orthant_wise_newton")
j_own_mod = importlib.import_module(
    "lasso_tpu.linear.solvers.orthant_wise_newton")


def lasso_problem(seed, n_=16, d=32, k=64):
    """Unit atoms W [d, k] and x [n_, d] (the JAX solver tests' draws)."""
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((d, k)).astype(np.float32)
    W /= np.linalg.norm(W, axis=0, keepdims=True)
    x = rng.standard_normal((n_, d)).astype(np.float32)
    return x, W


@pytest.fixture(scope="module")
def wide():
    """Overcomplete (D < K, the Woodbury side), alpha 0.3."""
    return lasso_problem(0) + (0.3,)


@pytest.fixture(scope="module")
def tall():
    """Undercomplete (K <= D, the dense [B, K, K] side of iterated
    ridge), tests/test_iterative_ridge.py's shape, alpha 0.2."""
    return lasso_problem(1, 10, 12, 8) + (0.2,)


def ridge_z0(x, W, alpha):
    return n(j_encode(jnp.asarray(x), jnp.asarray(W), alpha,
                      algorithm="ista", maxiter=0, init="ridge"))


def assert_objective(algorithm, f, f_jax, rtol=None):
    """The golden-parity rule of each algorithm's JAX test (above)."""
    if algorithm == "own":
        assert f <= f_jax * (1 + 1e-3), (f, f_jax)
    else:
        rtol = rtol or {"iter-ridge": 1e-3, "gpsr": 1e-3,
                        "interior-point": 2e-3}[algorithm]
        assert abs(f - f_jax) <= rtol * max(1.0, abs(f_jax)), (f, f_jax)


# name -> (problem, iterative_ridge keywords, objective rtol); the
# K-system CG stops on batch-global tolerances, so rounding moves its
# outer iteration count: only that route's count is not compared
IR_CASES = {
    "woodbury_cg": ("wide", {}, 1e-3),
    "woodbury_cholesky": ("wide", dict(woodbury_solver="cholesky"), 1e-3),
    "k_system_cg": ("wide", dict(cg=True, cg_options={"maxiter": 100,
                                                      "rtol": 1e-6}), 1.5e-3),
    "dense": ("tall", dict(maxiter=30, tol=1e-8), 1e-3),
    "no_line_search": ("tall", dict(line_search=False), 1e-3),
    "per_sample_ls": ("wide", dict(per_sample_ls=True), 1e-3),
    "nan_abort_small_tikhonov": ("wide", dict(tikhonov=1e-6), 1e-3),
}


@pytest.mark.parametrize("case", list(IR_CASES))
def test_iterative_ridge_matches_jax(case, wide, tall):
    """Each subproblem route, both line searches and the NaN stop: a NaN
    in one sample's data stops both after one iteration; a small
    tikhonov warns in both."""
    prob, kw, rtol = IR_CASES[case]
    x, W, alpha = wide if prob == "wide" else tall
    x = x.copy()
    if case.startswith("nan_abort"):
        x[3, 0] = np.nan
    z0 = ridge_z0(x, W, alpha)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        zj, kj = j_ir(jnp.asarray(z0), jnp.asarray(x), jnp.asarray(W),
                      alpha, return_iters=True, **kw)
        zt, kt = solvers.iterative_ridge(t(z0), t(x), t(W), alpha,
                                         return_iters=True, **kw)
    assert kt == int(kj) or case == "k_system_cg"
    if case.startswith("nan_abort"):
        assert kt == 1
        assert sum("small regularization" in str(w.message)
                   for w in caught) == 2
        np.testing.assert_array_equal(np.isnan(n(zt)), np.isnan(n(zj)))
        x, zt, zj = x[4:], n(zt)[4:], n(zj)[4:]
    assert_objective("iter-ridge", objective(x, W, n(zt), alpha),
                     objective(x, W, n(zj), alpha), rtol)


# name -> gpsr_basic keywords (batch-global unless per_sample). The
# ladder's early rungs stop on the LCP criterion at tol 1e-3, which f32
# rounding of the Armijo test can hold off for hundreds of iterations in
# either package (about one problem in six at these sizes): with
# continuation only the objectives are compared, at maxiter 300
GPSR_CASES = {
    "criterion_0": dict(stop_criterion=0),
    "criterion_1": dict(stop_criterion=1),
    "criterion_2": dict(stop_criterion=2),
    "criterion_3": dict(stop_criterion=3),
    "criterion_4_maxiter": dict(stop_criterion=4, maxiter=150),
    "per_sample_debias": dict(per_sample=True, debias=True),
    "continuation_debias": dict(continuation=True, cont_steps=3,
                                debias=True, maxiter=300),
    "per_sample_continuation": dict(per_sample=True, continuation=True,
                                    cont_steps=2, maxiter=300),
    "init_aty_first_tau_factor": dict(init=2, continuation=True,
                                      cont_steps=2, first_tau_factor=4.0,
                                      maxiter=300),
}


@pytest.mark.parametrize("case", list(GPSR_CASES))
def test_gpsr_matches_jax(case, wide):
    """Every stopping criterion, the continuation ladder (with a
    first_tau_factor), the debias phase and the per-sample mode: the same
    iteration counts (per row with per_sample) and objectives; after a
    debias phase the same residuals."""
    x, W, alpha = wide
    kw = GPSR_CASES[case]
    Wj, Wt = jnp.asarray(W), t(W)
    zj, kj = j_gpsr(jnp.asarray(x), lambda v: v @ Wj.T, alpha,
                    AT=lambda v: v @ Wj, return_iters=True, **kw)
    zt, kt = solvers.gpsr_basic(t(x), lambda v: v @ Wt.T, alpha,
                                AT=lambda v: v @ Wt, return_iters=True,
                                **kw)
    if not kw.get("continuation"):
        np.testing.assert_array_equal(np.asarray(n(kt)), np.asarray(kj))
    assert_objective("gpsr", objective(x, W, n(zt), alpha),
                     objective(x, W, n(zj), alpha))
    if kw.get("debias"):
        np.testing.assert_array_equal(n(zt) == 0, n(zj) == 0)
        np.testing.assert_allclose(rss(x, n(zt), W), rss(x, n(zj), W),
                                   rtol=1e-2, atol=1e-5)


def test_gpsr_dense_matrix_and_trivial_solution(wide):
    """A dense A for a 1-D problem (the transposes built inside), and the
    zero solution once tau >= ||A^T y||_inf."""
    x, W, alpha = wide
    zj = j_gpsr(jnp.asarray(x[0]), jnp.asarray(W), alpha)
    zt = solvers.gpsr_basic(t(x[0]), t(W), alpha)
    assert_objective("gpsr", objective(x[:1], W, n(zt)[None], alpha),
                     objective(x[:1], W, n(zj)[None], alpha))
    big = solvers.gpsr_basic(t(x[0]), t(W), 1e6)
    assert not bool(big.any())
    with pytest.raises(ValueError, match="transpose"):
        solvers.gpsr_basic(t(x), lambda v: v, alpha)
    with pytest.raises(ValueError, match="criterion"):
        solvers.gpsr_basic(t(x[0]), t(W), alpha, stop_criterion=7)


@pytest.mark.parametrize("kp", ["f32", "bf16", "mixed"])
def test_split_bregman_matches_jax(kp, wide):
    """Each kernel precision ('mixed' with its automatic f32 tail, and an
    explicit one): codes atol 2e-3, equal outer iterations."""
    x, W, alpha = wide
    for kw in ({"kernel_precision": kp},) + (
            ({"kernel_precision": kp, "mixed_tail": 5},)
            if kp == "mixed" else ()):
        zj, kj = j_sb(jnp.asarray(W), jnp.asarray(x), None, alpha, **kw)
        zt, kt = solvers.split_bregman(t(W), t(x), None, alpha, **kw)
        assert kt == int(kj)
        np.testing.assert_allclose(n(zt), n(zj), atol=2e-3)
    with pytest.raises(ValueError, match="mixed_tail"):
        solvers.split_bregman(t(W), t(x), None, alpha, mixed_tail=3,
                              kernel_precision="f32")
    with pytest.raises(ValueError, match="kernel_precision"):
        solvers.split_bregman(t(W), t(x), None, alpha,
                              kernel_precision="fp8")


# name -> (problem, orthant_wise_newton keywords); the fixed Newton step
# needs a well-conditioned W^T W, hence the undercomplete problem
OWN_CASES = {
    "brent": ("wide", {}),
    "brent_per_sample": ("wide", dict(per_sample_ls=True)),
    "backtrack": ("wide", dict(line_search="backtrack", lr=2.0)),
    "fixed_step": ("tall", dict(line_search="none", lr=0.5)),
}


@pytest.mark.parametrize("case", list(OWN_CASES))
def test_orthant_wise_newton_matches_jax(case, wide, tall):
    """Each line search, from the zero start: the objective at most JAX's
    (1 + 1e-3) and below the start's; the projection and pseudo-gradient
    equal JAX's."""
    prob, kw = OWN_CASES[case]
    x, W, alpha = wide if prob == "wide" else tall
    z0 = np.zeros((x.shape[0], W.shape[1]), np.float32)
    zj, kj = j_own(jnp.asarray(W), jnp.asarray(x), jnp.asarray(z0), alpha,
                   return_iters=True, **kw)
    zt, kt = solvers.orthant_wise_newton(t(W), t(x), t(z0), alpha,
                                         return_iters=True, **kw)
    assert kt == int(kj)
    f_t = objective(x, W, n(zt), alpha)
    assert_objective("own", f_t, objective(x, W, n(zj), alpha))
    assert f_t < objective(x, W, z0, alpha)
    u, v = np.random.default_rng(5).standard_normal((2, 8, 64)).astype(
        np.float32)
    u[:, :8] = 0.0
    np.testing.assert_array_equal(n(own_mod.project(t(u), t(v))),
                                  n(j_own_mod.project(jnp.asarray(u),
                                                      jnp.asarray(v))))
    np.testing.assert_array_equal(
        n(own_mod.pseudo_grad(t(u), t(v), alpha)),
        n(j_own_mod.pseudo_grad(jnp.asarray(u), jnp.asarray(v), alpha)))


IP_CASES = [(kkt, sched) for kkt in ("cholesky", "cg")
            for sched in ("reference", "adaptive", "mehrotra")]


@pytest.mark.parametrize("kkt,sched", IP_CASES + [("per_sample", "reference")])
def test_interior_point_matches_jax(kkt, sched, wide):
    """Each KKT solver under each barrier schedule ('cg' with its forcing
    tolerance), and per-sample stopping: the same success flags and
    Newton iterations, objectives within 2e-3; 'auto' is 'cholesky' at this
    size, bit for bit; only 'cg' runs the inner CG loop, at least one
    iteration a Newton direction."""
    x, W, alpha = wide
    kw = (dict(per_sample=True) if kkt == "per_sample"
          else dict(kkt_solver=kkt, barrier_schedule=sched, maxiter=12))
    zj, okj, kj = j_ip(jnp.asarray(x), jnp.asarray(W), None, alpha,
                       return_iters=True, **kw)
    before = INNER_ITERATIONS["normal_cg"]
    zt, okt, kt = solvers.interior_point(t(x), t(W), None, alpha,
                                         return_iters=True, **kw)
    cg_iters = INNER_ITERATIONS["normal_cg"] - before
    assert (cg_iters >= kt) if kw.get("kkt_solver") == "cg" else not cg_iters
    assert kt == int(kj)
    np.testing.assert_array_equal(n(okt), n(okj))
    assert_objective("interior-point", objective(x, W, n(zt), alpha),
                     objective(x, W, n(zj), alpha))
    if kkt == "cholesky" and sched == "reference":
        z_auto, _ = solvers.interior_point(t(x), t(W), None, alpha,
                                           maxiter=12)
        assert torch.equal(z_auto, zt)
        for bad in (dict(kkt_solver="lu"), dict(barrier_schedule="x"),
                    dict(kkt_solver="cg", cg_rtol="bogus")):
            with pytest.raises(ValueError):
                solvers.interior_point(t(x), t(W), None, alpha, **bad)


@pytest.mark.parametrize("form", ["constrained", "penalized",
                                  "single_sample"])
def test_constrained_inference_matches_jax(form):
    """The bisection on alpha meets rss_lim (tests/test_heavy_solvers.py:
    123-132) as JAX's does; the penalized form is the lasso; one sample
    in, one code out."""
    x, W = lasso_problem(2, 8, 10, 16)
    if form == "constrained":
        rss_lim = 0.3 * float(0.5 * np.sum(np.square(x[0])))
        kw = dict(constr=True, rss_lim=rss_lim, fista_iters=300,
                  bisect_iters=30)
        zt = n(solvers.constrained_inference(t(x), t(W), **kw))
        zj = n(j_constr(jnp.asarray(x), jnp.asarray(W), **kw))
        for z in (zt, zj):
            rss = 0.5 * np.sum(np.square(z @ W.T - x), axis=1)
            assert np.all(rss <= rss_lim * 1.05)
            assert np.any(rss >= rss_lim * 0.8)
    elif form == "penalized":
        kw = dict(constr=False, alpha=0.3, fista_iters=500)
        zt = n(solvers.constrained_inference(t(x), t(W), **kw))
        zj = n(j_constr(jnp.asarray(x), jnp.asarray(W), **kw))
        np.testing.assert_allclose(objective(x, W, zt, 0.3),
                                   objective(x, W, zj, 0.3), rtol=1e-3)
        with pytest.raises(NotImplementedError):
            solvers.constrained_inference(t(x), t(W), constr=False,
                                          bound=False)
    else:
        z1 = solvers.constrained_inference(t(x[0]), t(W), rss_lim=0.5)
        zb = solvers.constrained_inference(t(x[:1]), t(W), rss_lim=0.5)
        assert tuple(z1.shape) == (16,)
        assert torch.equal(z1, zb[0])
        constrained = importlib.import_module(
            "lasso_tpu_torch.linear.solvers.constrained")
        assert constrained.scipy_inference is solvers.constrained_inference


@pytest.mark.parametrize("case", ["plain", "tol", "gram_jitter"])
def test_omp_cg_matches_jax(case):
    """OMP with solver='cg' (conjgrad_per_row warm-started at the last
    coefficients, maxiter T+8) against JAX's: the same fit and count."""
    x, W = omp_problem(40, 24, 32, 64)
    kw = {"plain": {}, "tol": dict(tol=float(np.median(
        np.sum(x * x, axis=1))) * 0.3), "gram_jitter": dict(
            gram_jitter=1e-3)}[case]
    zj, kj = j_omp(jnp.asarray(x), jnp.asarray(W), 8, solver="cg",
                   return_iters=True, **kw)
    zt, kt = solvers.orthogonal_matching_pursuit(
        t(x), t(W), 8, solver="cg", return_iters=True, **kw)
    assert kt == int(kj)
    assert_same_fit(x, W, n(zj), n(zt))


# the alpha forms of the dispatch: (kind, numpy alpha or float)
def alpha_of(kind, n_, k):
    rng = np.random.default_rng(7)
    return {"scalar": 0.3,
            "per_sample": (0.2 + 0.2 * rng.random(n_)).astype(np.float32),
            "per_feature": (0.2 + 0.2 * rng.random((1, k))).astype(
                np.float32)}[kind]


def alpha_objective(x, W, z, a):
    """The f64 lasso objective with a scalar, [N] or [1, K] alpha."""
    a = np.asarray(a, np.float64)
    if a.ndim == 1:
        a = a[:, None]
    z = np.asarray(z, np.float64)
    r = z @ W.T.astype(np.float64) - x
    return 0.5 * np.sum(r * r) + np.sum(a * np.abs(z))


DISPATCH = ("gpsr", "iter-ridge", "interior-point", "split-bregman", "own")


@pytest.mark.parametrize("alpha", ["scalar", "per_sample", "per_feature"])
@pytest.mark.parametrize("algorithm", DISPATCH)
def test_sparse_encode_dispatch_matches_jax(algorithm, alpha, wide):
    """Each new name through sparse_encode, with its default init and the
    homogeneity wrappers for vector alpha: the same iteration count as
    JAX's sparse_encode, and the objective (split Bregman: the codes) by
    the algorithm's rule."""
    x, W, _ = wide
    a = alpha_of(alpha, *x.shape[:1], W.shape[1])
    a_j = a if alpha == "scalar" else jnp.asarray(a)
    a_t = a if alpha == "scalar" else t(a)
    zj, kj = j_encode(jnp.asarray(x), jnp.asarray(W), a_j,
                      algorithm=algorithm, return_iters=True)
    zt, kt = sparse_encode(t(x), t(W), a_t, algorithm=algorithm,
                           return_iters=True)
    assert tuple(zt.shape) == (16, 64) and bool(torch.isfinite(zt).all())
    assert kt == int(kj)
    if algorithm == "split-bregman":
        np.testing.assert_allclose(n(zt), n(zj), atol=2e-3)
    else:
        assert_objective(algorithm, alpha_objective(x, W, n(zt), a),
                         alpha_objective(x, W, n(zj), a))
    z_only = sparse_encode(t(x), t(W), a_t, algorithm=algorithm)
    assert torch.equal(z_only, zt)
    if algorithm == "iter-ridge" and alpha == "scalar":
        # JAX's warning on a zero start (its coordinates freeze at once)
        with pytest.warns(UserWarning, match="zero init"):
            sparse_encode(t(x), t(W), a_t, algorithm=algorithm,
                          init="zero", maxiter=1)
