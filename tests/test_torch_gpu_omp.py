"""lasso_tpu_torch's fused OMP kernels on a CUDA card: K6a ``omp_select``
on the tensor cores, K6b ``omp_orth`` (the streamed kernel and, past D =
1024, the warp-strided one), K6d ``omp_orth_cgs2`` (the ``gs='cgs2'``
step: the resident block kernel and, past D = 1024 or for D not a multiple
of 128, the warp-strided one) and K6c ``omp_backsub`` (the staged kernel to
T = 128, the warp kernel above; bit for bit) against their plain versions,
and the launches of a cgs2 solve.

Every test here is marked ``gpu`` and skips where there is no card. This
file imports neither JAX nor the JAX package; on a machine that has only
PyTorch, run the card's tests without the JAX-based conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu*.py -q

Tolerances: K6a's partial scores at rtol 1e-5 / atol 1e-6 (the same
products summed in another order), its atoms equal except where the two
atoms' plain scores lie within 1e-5 relative; K6d's step outputs at rtol
2e-4 / atol 1e-5 (as K6b's in chip_smoke.py), whole solves by the
equivalence rule of tests/test_fused_omp.py:31-43 with validity equal.
"""

import numpy as np
import pytest
import torch

from lasso_tpu_torch.ops import _cuda
from lasso_tpu_torch.ops import fused_omp as T_O
from lasso_tpu_torch.ops.precision import split_bf16

from _torch_port import assert_equivalent, n, omp_problem, t

pytestmark = pytest.mark.gpu

if not torch.cuda.is_available():
    # without a card the whole module skips at collection, so that its
    # tests are not collected one by one only to skip
    pytest.skip("needs a CUDA card", allow_module_level=True)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _scores(state, wsplit, invn, kp):
    """The dense masked scores of the plain version's product."""
    hi, lo = (None if w is None else w.float().T for w in wsplit)
    if kp == "bf16":
        c = split_bf16(state.r)[0] @ hi
    else:
        r_hi, r_lo = split_bf16(state.r)
        c = r_hi @ hi + r_lo @ hi + r_hi @ lo
    return torch.where(state.sel.bool(), -1.0, torch.abs(c) * invn)


@pytest.mark.parametrize("kp", ["f32", "bf16"])
@pytest.mark.parametrize("N", [1, 63, 1000, 4097])
def test_select_kernel_matches_plain(N, kp):
    """K6a at ragged N (rows past N masked) for D in {128, 512} and K in
    {128, 2048}, about 5% of the atoms already selected."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    for D in (128, 512):
        for K in (128, 2048):
            g = torch.Generator(device="cuda").manual_seed(N + D + K)
            x = torch.randn(N, D, generator=g, device="cuda")
            W = torch.randn(D, K, generator=g, device="cuda")
            W = W / W.norm(dim=0)
            state = T_O.omp_init_state(x, K, 4)
            state.sel.copy_(torch.rand(N, K, generator=g, device="cuda")
                            < 0.05)
            invn = T_O.inverse_norms(W)
            wsplit = T_O.select_operands(W, kp)
            before = T_O.OMP_SELECT[kp].launches
            T_O.omp_select(state, wsplit, invn, kp)
            torch.cuda.synchronize()
            assert T_O.OMP_SELECT[kp].launches - before == 1
            gv, gi = state.pval.clone(), state.pidx.clone()
            T_O.omp_select_plain(state, wsplit, invn, kp)
            np.testing.assert_allclose(n(gv), n(state.pval), rtol=1e-5,
                                       atol=1e-6)
            score = _scores(state, wsplit, invn, kp)
            a = torch.gather(score, 1, gi.long())
            b = torch.gather(score, 1, state.pidx.long())
            part = gi != state.pidx
            assert bool(((a - b).abs() <= 1e-5 * b.abs())[part].all())
            assert bool((gi // T_O.TILE == torch.arange(
                K // T_O.TILE, device="cuda")).all())


def test_select_refuses_what_it_does_not_take():
    _need_card()
    x = torch.randn(8, 96, device="cuda")
    W = torch.randn(96, 128, device="cuda")
    state = T_O.omp_init_state(x, 128, 2)
    with pytest.raises(ValueError, match="multiple of 64"):
        T_O.omp_select(state, T_O.select_operands(W), T_O.inverse_norms(W))
    x = torch.randn(8, 128, device="cuda")
    W = torch.randn(128, 128, device="cuda")
    state = T_O.omp_init_state(x, 128, 2)
    with pytest.raises(ValueError, match="kernel_precision"):
        T_O.omp_select(state, T_O.select_operands(W, "bf16"),
                       T_O.inverse_norms(W), "f32")
    hi, lo = T_O.select_operands(W)
    with pytest.raises(ValueError, match="bfloat16"):
        T_O.omp_select(state, (hi.float(), lo), T_O.inverse_norms(W))


@pytest.mark.parametrize("N,D,T,tol", [(1001, 128, 13, 1e-6),
                                       (130, 768, 8, None),
                                       (67, 1024, 6, None),
                                       (70, 1152, 4, None)])
def test_orth_kernel_matches_plain(N, D, T, tol):
    """K6b against its plain version at every step of a solve, each step
    from one state (idx, valid and the masks equal; r, its kept split,
    q_k, R's column and d_k at rtol 2e-4 / atol 1e-5). The streamed
    kernel's ring holds 8 rows at D = 128 and 2 from D = 768 on, so the
    later steps refill it; D = 1024 is its widest row, D = 1152 takes the
    warp-strided kernel; N is ragged. Atoms 0 and 1 are both e_0, and rows
    0-7 are 3 e_0: step 0 takes atom 0 and leaves r = 0, so step 1 takes
    the duplicate, whose Gram-Schmidt remainder is exactly 0 and hits the
    pivot floor (R's diagonal 1e-6). With tol, rows 0-7 freeze at step 1
    instead, and rows 8-15, 3-sparse, by step 4."""
    _need_card()
    K = 256
    x, W = omp_problem(N + D, N, D, K)
    W[:, :2] = 0.0
    W[0, :2] = 1.0
    z = np.zeros((8, K), np.float32)
    z[:, 4:7] = np.random.default_rng(D).standard_normal((8, 3))
    x[:8] = 0.0
    x[:8, 0] = 3.0
    x[8:16] = z @ W.T
    xc, Wc = t(x).cuda(), t(W).cuda()
    wsplit, invn = T_O.select_operands(Wc), T_O.inverse_norms(Wc)
    wt = Wc.T.contiguous()
    st = T_O.omp_init_state(xc, K, T)
    before = T_O.OMP_ORTH["mgs"].launches
    for k in range(T):
        T_O.omp_select(st, wsplit, invn)
        twin = T_O.OmpState(**{f: getattr(st, f).clone()
                               for f in st.__dataclass_fields__})
        T_O.omp_orth(st, wt, k, tol)
        T_O.omp_orth_plain(twin, wt, k, tol)
        for a, c in ((st.idx[:, k], twin.idx[:, k]), (st.sel, twin.sel),
                     (st.valid[:, k], twin.valid[:, k]),
                     (st.active, twin.active)):
            assert torch.equal(a, c)
        for a, c in ((st.r, twin.r), (st.Q[:, k], twin.Q[:, k]),
                     (st.R[:, k, :k + 1], twin.R[:, k, :k + 1]),
                     (st.d[:, k], twin.d[:, k]),
                     (st.rb.float().sum(0), twin.rb.float().sum(0))):
            np.testing.assert_allclose(n(a), n(c), rtol=2e-4, atol=1e-5)
    assert T_O.OMP_ORTH["mgs"].launches - before == T
    assert bool((st.idx[:8, 0] == 0).all())
    if tol is None:
        assert bool((st.idx[:8, 1] == 1).all())
        np.testing.assert_allclose(n(st.R[:8, 1, 1]), 1e-6, rtol=1e-6)
        assert not bool(st.Q[:8, 1].any())
    else:   # r = 0 after step 0: rows 0-7 freeze at step 1
        assert not bool(st.valid[:8, 1:].any())
        assert not bool(st.valid[8:16, 4:].any())


def _omp_case(N, D, K, duplicate):
    """omp_problem with rows 8-15 3-sparse over W (they freeze under tol by
    step 4); with ``duplicate`` atoms 0 and 1 both e_0 and rows 0-7 3 e_0,
    so that step 0 takes atom 0 and leaves r = 0, and step 1 takes the
    duplicate, whose Gram-Schmidt remainder is exactly 0 and hits the
    pivot floor (R's diagonal 1e-6)."""
    x, W = omp_problem(N + D, N, D, K)
    if duplicate:
        W[:, :2] = 0.0
        W[0, :2] = 1.0
        x[:8] = 0.0
        x[:8, 0] = 3.0
    z = np.zeros((8, K), np.float32)
    z[:, 4:7] = np.random.default_rng(D).standard_normal((8, 3))
    x[8:16] = z @ W.T
    return x, W


# K6d's cases: (N, D, T, tol, duplicated atom); the resident kernel keeps
# min(k, rows) rows in shared memory, rows = 55 at D = 512, T = 64 and 27
# at D = 1024, T = 40, so the later steps read the rest from global memory;
# D = 1152 and D = 192 take the kept warp kernel
CGS2_CASES = {
    "resident_d128_tol": [(1001, 128, 13, 1e-6, False)],
    "resident_d512_t64": [(600, 512, 64, None, False)],
    "resident_d1024_past_rows_dup": [(130, 1024, 40, None, True)],
    "kept_d1152_d192": [(70, 1152, 6, None, True), (67, 192, 9, 1e-6, False)],
}


@pytest.mark.parametrize("case", list(CGS2_CASES))
def test_cgs2_kernel_matches_plain(case):
    """K6d against its plain version at every step of a solve, each step
    from one state (idx, valid and masks equal; r, its kept split, q_k, R's
    column and d_k at rtol 2e-4 / atol 1e-5), then a whole cgs2 solve on
    the card against the plain solve (validity equal, codes by the
    equivalence rule). N is ragged; under tol rows 8-15 freeze by step 4;
    the duplicated atom's step hits the pivot floor."""
    _need_card()
    K = 256
    for N, D, T, tol, dup in CGS2_CASES[case]:
        x, W = _omp_case(N, D, K, dup)
        xc, Wc = t(x).cuda(), t(W).cuda()
        wsplit, invn = T_O.select_operands(Wc), T_O.inverse_norms(Wc)
        wt = Wc.T.contiguous()
        st = T_O.omp_init_state(xc, K, T)
        before = T_O.OMP_ORTH["cgs2"].launches
        for k in range(T):
            T_O.omp_select(st, wsplit, invn)
            twin = T_O.OmpState(**{f: getattr(st, f).clone()
                                   for f in st.__dataclass_fields__})
            T_O.omp_orth(st, wt, k, tol, gs="cgs2")
            T_O.omp_orth_plain(twin, wt, k, tol, gs="cgs2")
            for a, c in ((st.idx[:, k], twin.idx[:, k]), (st.sel, twin.sel),
                         (st.valid[:, k], twin.valid[:, k]),
                         (st.active, twin.active)):
                assert torch.equal(a, c)
            for a, c in ((st.r, twin.r), (st.Q[:, k], twin.Q[:, k]),
                         (st.R[:, k, :k + 1], twin.R[:, k, :k + 1]),
                         (st.d[:, k], twin.d[:, k]),
                         (st.rb.float().sum(0), twin.rb.float().sum(0))):
                np.testing.assert_allclose(n(a), n(c), rtol=2e-4, atol=1e-5)
        assert T_O.OMP_ORTH["cgs2"].launches - before == T
        if dup:
            assert bool((st.idx[:8, :2] == torch.tensor(
                [0, 1], device="cuda", dtype=torch.int32)).all())
            np.testing.assert_allclose(n(st.R[:8, 1, 1]), 1e-6, rtol=1e-6)
            assert not bool(st.Q[:8, 1].any())
        if tol is not None:
            assert not bool(st.valid[8:16, 4:].any())
        got = T_O.fused_omp_solve(xc, Wc, T, tol=tol, gs="cgs2")
        want = T_O.fused_omp_solve_plain(xc, Wc, T, tol=tol, gs="cgs2")
        np.testing.assert_array_equal(n(got[1]), n(want[1]))

        def codes(idx, z_s):
            zz = torch.zeros((idx.shape[0], K), device="cuda")
            return n(zz.scatter_add_(1, idx.long(), z_s))

        if not dup:   # a dependent pair's split follows the floor's rounding
            assert_equivalent(x, W, codes(want[0], want[2]),
                              codes(got[0], got[2]))


def test_cgs2_solve_launches():
    """A CUDA-tensor cgs2 solve at T=64: 64 K6a and 64 K6d launches, no
    K6b, one K6c."""
    _need_card()
    x, W = omp_problem(2, 300, 128, 256)
    before = _cuda.launch_counts()
    idx, valid, z_s = T_O.fused_omp_solve(t(x).cuda(), t(W).cuda(), 64,
                                          gs="cgs2")
    torch.cuda.synchronize()
    after = _cuda.launch_counts()
    delta = {k: after[k] - before.get(k, 0) for k in after}
    assert delta["omp_select_f32"] == 64 and delta["omp_orth_cgs2"] == 64
    assert delta["omp_orth"] == 0 and delta["omp_backsub"] == 1
    assert bool(valid.all()) and bool(torch.isfinite(z_s).all())


# K6c's cases, (N, T, R 16-byte aligned) each: the staged kernel with
# 16-byte copies (T = 64, and T = 128, its widest) and 4-byte ones (T = 13,
# and T = 64 with R one float past an aligned address); the warp kernel
# past T = 128
BACKSUB_CASES = {
    "staged": [(1001, 64, True), (67, 128, True), (130, 13, True),
               (33, 64, False)],
    "warp": [(45, 129, True), (20, 200, True)],
}


@pytest.mark.parametrize("case", list(BACKSUB_CASES))
def test_backsub_kernel_matches_plain(case):
    """K6c bit for bit its plain version: R z = d on upper-triangular
    systems kept as columns (R[n, j, :j + 1], NaN past the diagonal, which
    neither reads), every fourth sample frozen from slot T // 3 on (its
    columns e_j, d_j = 0, valid 0) and a fifth of the other slots not
    valid."""
    _need_card()
    rng = np.random.default_rng(11)
    for N, T, aligned in BACKSUB_CASES[case]:
        Rn = rng.standard_normal((N, T, T)).astype(np.float32) / T
        jj = np.arange(T)
        Rn[:, jj, jj] = 1.0 + np.abs(rng.standard_normal((N, T)))
        Rn[:, jj[:, None] < jj[None, :]] = np.nan   # R[n, j, i], i > j
        d = rng.standard_normal((N, T)).astype(np.float32)
        valid = (rng.random((N, T)) > 0.2).astype(np.float32)
        frozen = np.arange(N) % 4 == 0
        for j in range(T // 3, T):
            Rn[frozen, j, :j + 1] = 0.0
            Rn[frozen, j, j] = 1.0
        d[frozen, T // 3:] = 0.0
        valid[frozen, T // 3:] = 0.0
        buf = torch.empty(N * T * T + 1, device="cuda")
        R = buf[int(not aligned):][:N * T * T].view(N, T, T)
        R.copy_(t(Rn))
        assert (R.data_ptr() % 16 == 0) == aligned
        state = T_O.OmpState(
            r=torch.zeros(N, 1, device="cuda"), rb=None, sel=None,
            active=None, Q=None, R=R, d=t(d).cuda(), valid=t(valid).cuda(),
            idx=None, pval=None, pidx=None)
        assert T_O.backsub_tier(state).split(",")[0] == case
        before = T_O.OMP_BACKSUB.launches
        z = T_O.omp_backsub(state)
        want = T_O.omp_backsub_plain(state)
        assert T_O.OMP_BACKSUB.launches - before == 1
        assert torch.equal(z, want), (N, T, aligned)
        assert bool(torch.isfinite(z).all())
        assert not bool(z[torch.from_numpy(frozen).cuda()][:, T // 3:].any())
