"""lasso_tpu_torch on a CUDA card: the kernels (FISTA, coordinate descent,
the group prox, fused OMP and the Cholesky append) against their plain
versions, and the solvers' fused paths against their CPU runs.

Every test here is marked ``gpu`` and skips where there is no card. This
file imports neither JAX nor the JAX package, so that it runs on a
machine that has only PyTorch; there, run it without the JAX-based
conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from lasso_tpu_torch.linear.solvers import (group_ista, ista,
                                            orthogonal_matching_pursuit)
from lasso_tpu_torch.ops import _cuda
from lasso_tpu_torch.ops import batched_cholesky as T_B
from lasso_tpu_torch.ops import fused_cd as T_CD
from lasso_tpu_torch.ops import fused_group as T_G
from lasso_tpu_torch.ops import fused_ista as T
from lasso_tpu_torch.ops import fused_omp as T_O

from _torch_port import (assert_equivalent, assert_same_fit, make_problem, n,
                         omp_problem, t)

pytestmark = pytest.mark.gpu

if not torch.cuda.is_available():
    # without a card the whole module skips at collection, so that its
    # tests are not collected one by one only to skip
    pytest.skip("needs a CUDA card", allow_module_level=True)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("kp", ["f32", "bf16"])
def test_cuda_kernels_match_plain(kp):
    """Both wrappers against their plain versions on the card at a ragged
    shape, with restart, a per-feature row, nonneg and l2. Tolerances of
    tests/test_fused_ista.py (z atol 1e-5 / 5e-3, delta rtol 1e-5 /
    5e-2); the kernels sum delta and the restart dot with atomics, in an
    order that changes from run to run."""
    _need_card()
    rng = np.random.default_rng(0)
    x, z, zp, W = (t(a).cuda() for a in make_problem(rng, 200, 300, 500))
    arow = t((0.02 + 0.05 * rng.random((1, 500))).astype(np.float32)).cuda()
    tv = t((3.0 * rng.random((200, 1))).astype(np.float32)).cuda()
    moms = torch.linspace(0, 0.6, 4)
    calls = [
        (T.fused_fista_step, T.fused_fista_step_plain,
         lambda f: f(x, z, zp, W, 0.2, arow, 0.5, kernel_precision=kp,
                     nonneg=True, l2=0.3)),
        (T.fused_fista_multistep, T.fused_fista_multistep_plain,
         lambda f: f(x, z, zp, W, 0.2, arow * 0.2, moms, 4,
                     kernel_precision=kp, t_vec=tv, nonneg=True, l2=0.3))]
    atol, rtol = (1e-5, 1e-5) if kp == "f32" else (5e-3, 5e-2)
    before = _cuda.launch_counts()
    for kernel, plain, call in calls:
        got, want = call(kernel), call(plain)
        for a, b in zip(got[:-1], want[:-1]):
            np.testing.assert_allclose(n(a), n(b), atol=atol)
        np.testing.assert_allclose(float(got[-1]), float(want[-1]),
                                   rtol=rtol)
    after = _cuda.launch_counts()
    assert after[f"fista_resid_{kp}"] - before[f"fista_resid_{kp}"] == 5
    assert (after[f"fista_grad_prox_{kp}"]
            - before[f"fista_grad_prox_{kp}"]) == 5


@pytest.mark.parametrize("kw", [
    {"maxiter": 416, "tol": 1e-4},
    {"maxiter": 37, "tol": 0.0},
    {"maxiter": 96, "tol": 0.0, "restart": True, "fuse_steps": 8},
], ids=["auto_tol", "remainder", "restart"])
def test_solver_on_card_matches_cpu(kw):
    """The fused path on the card against the same solve on the CPU
    (plain versions): n_iter equal, codes atol 1e-4 (tests/
    test_fused_ista.py's fused-vs-plain tolerance)."""
    _need_card()
    rng = np.random.default_rng(0)
    x, _, _, W = make_problem(rng, n=16)
    z0 = np.zeros((16, W.shape[1]), np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        out[dev] = ista(t(x).to(dev), t(z0).to(dev), t(W).to(dev), 0.1,
                        lr=0.1, use_pallas=True, return_iters=True, **kw)
    assert out["cuda"][1] == out["cpu"][1]
    np.testing.assert_allclose(n(out["cuda"][0]), n(out["cpu"][0]),
                               atol=1e-4)


# K3's cases: (rows, D, K) shapes, and whether rows get exact ties at their
# largest diff and NaNs in b and z
CD_STEPS_CASES = {
    "registers_k384": ([(200, 256, 384)], False),
    "registers_k1024": ([(203, 256, 1024)], False),
    "registers_k2048": ([(130, 512, 2048)], False),
    "shared_memory": ([(70, 64, 100), (66, 256, 2176)], False),
    "ties_nan": ([(96, 128, 256)], True),
}


@pytest.mark.parametrize("case", list(CD_STEPS_CASES))
@pytest.mark.parametrize("kp", ["f32", "bf16"])
def test_cd_steps_kernel_matches_plain(kp, case):
    """K3 against its plain version on the card, plain and with a
    per-feature row, nonneg, l2 and rows inactive on entry: b and z atol
    1e-6 (both round the same operations; only an FMA the plain version
    may take otherwise could differ), the active mask equal. The register
    tier at K = 384 (three of four float4 groups a lane), 1024 and 2048;
    the shared-memory tier at K = 100 (not a multiple of 32) and K = 2176
    (past the register tier); and rows whose largest diff is an exact tie
    between two columns (in two lanes, in one chain of one lane, in two
    chains of one lane: the smaller column wins), rows with a NaN in b (the
    prox keeps it, so it is the largest), a NaN in z or an infinite b,
    some of them inactive on entry (the plain version's 0 * dz is then NaN:
    b all NaN, z_k NaN, and z_0 NaN if a step is left)."""
    _need_card()
    shapes, ties = CD_STEPS_CASES[case]
    rng = np.random.default_rng(0)
    before = T_CD.CD_STEPS[kp].launches
    for rows, d, k in shapes:
        x, _, _, W = (t(a).cuda() for a in make_problem(rng, rows, d, k))
        W = W / W.norm(dim=0)
        S = torch.eye(k, device="cuda") - W.T @ W
        b, z = x @ W, torch.zeros(rows, k, device="cuda")
        if ties:
            for r0, (c0, c1) in enumerate(((3, 10), (5, 133), (4, 6))):
                b[r0::4, c0] = b[r0::4, c1] = 10.0
            b[3::8, 7] = float("nan")
            z[7::8, 9] = float("nan")
            b[11::16, 2] = float("inf")
        act = torch.ones(rows, 1, device="cuda")
        act[::7] = 0.0
        arow = t((0.05 + 0.1 * rng.random((1, k))).astype(np.float32)).cuda()
        for kw in ({"alpha": 0.2},
                   {"alpha": arow, "nonneg": True, "l2": 0.3}):
            got = T_CD.fused_cd_steps(b, z, act, S, tol_k=0.05, steps=8,
                                      kernel_precision=kp, **kw)
            want = T_CD.fused_cd_steps_plain(b, z, act, S, tol_k=0.05,
                                             steps=8, kernel_precision=kp,
                                             **kw)
            for a, c in zip(got[:2], want[:2]):
                np.testing.assert_allclose(n(a), n(c), rtol=0, atol=1e-6)
            np.testing.assert_array_equal(n(got[2]), n(want[2]))
        if ties:   # the first step took the smaller column of each tie
            first = T_CD.fused_cd_steps(b, z, act, S, 0.2, 0.05, steps=1,
                                        kernel_precision=kp)[1]
            for r0, (c0, c1) in enumerate(((3, 10), (5, 133), (4, 6))):
                live = act[r0::4, 0] > 0
                assert bool((first[r0::4, c0] != 0)[live].all())
                assert not bool((first[r0::4, c1] != 0)[live].any())
    assert T_CD.CD_STEPS[kp].launches - before == (
        2 * len(shapes) + (1 if ties else 0))


@pytest.mark.parametrize("rows,d,k,conv_every,offset", [
    (200, 256, 384, 6, 0), (200, 1100, 384, 6, 0), (203, 250, 390, 6, 0),
    (200, 512, 384, 1, 0), (70, 2050, 100, 3, 0), (203, 100, 390, 6, 0),
    (200, 384, 384, 6, 0), (100, 256, 160, 6, 1)],
    ids=["registers", "device_memory", "ragged_n_k_d", "all_converged",
         "large_d", "registers_d100", "registers_d384", "misaligned_atoms"])
def test_cd_mod_sweep_kernel_matches_plain(rows, d, k, conv_every, offset):
    """K4 against its plain version at the kernel's chunk on the card, with
    converged rows and a zero atom: R in registers (D=256, and each of the
    register tiles: D <= 128 unaligned, 384 aligned) and in device
    memory (D=1100); N not a multiple of the 32-row block, K not one of
    the 16-atom chunk and D not one of 4 (rows not 16-byte aligned); every
    row converged (the blocks copy through); a large D with few atoms;
    W given as the transpose of a contiguous [K, D] view ``offset`` floats
    past an aligned address, which the wrapper hands the kernel as it is:
    its rows are not 16-byte aligned although D is a multiple of 4.
    z and R atol 1e-4 (sums in another order), zmax and dzmax rtol 1e-5."""
    _need_card()
    rng = np.random.default_rng(1)
    x, z, _, W = (t(a).cuda() for a in make_problem(rng, rows, d, k))
    W[:, 5] = 0.0
    z = z * (torch.rand(rows, k, device="cuda") < 0.1)
    R = x - z @ W.T
    conv = torch.zeros(rows, dtype=torch.bool, device="cuda")
    conv[::conv_every] = True
    nrm = (W * W).sum(0)
    Wk = W
    if offset:
        store = torch.empty(k * d + offset, device="cuda")
        store[offset:].view(k, d).copy_(W.T)
        Wk = store[offset:].view(k, d).T
        assert Wk.T.contiguous().data_ptr() % 16 != 0
    got = T_CD.fused_cd_mod_sweep(z, R, conv, Wk, nrm, 0.1, l2=0.2)
    want = T_CD.fused_cd_mod_sweep_plain(z, R, conv, W, nrm, 0.1, l2=0.2)
    for a, c in zip(got[:2], want[:2]):
        np.testing.assert_allclose(n(a), n(c), rtol=0, atol=1e-4)
    for a, c in zip(got[2:], want[2:]):
        np.testing.assert_allclose(n(a), n(c), rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(n(got[0])[n(conv)], n(z)[n(conv)])
    np.testing.assert_array_equal(n(got[1])[n(conv)], n(R)[n(conv)])


@pytest.mark.parametrize("kp", ["f32", "bf16"])
def test_group_prox_kernel_matches_plain(kp):
    """K5 against its plain version on the card, alone and inside an
    8-sub-step group-FISTA call: permuted ragged groups with weights, and
    contiguous blocks with l1 and restart. z atol 1e-5 (f32) / 5e-3 (bf16),
    delta rtol 1e-5 / 5e-2, the restart carry equal."""
    _need_card()
    rng = np.random.default_rng(2)
    x, z, zp, W = (t(a).cuda() for a in make_problem(rng, 200, 128, 256))
    ids = np.concatenate([np.zeros(3), np.ones(45), np.full(80, 2),
                          np.repeat(np.arange(3, 19), 8)]).astype(np.int32)
    ids = ids[rng.permutation(256)]
    w_g = np.sqrt(np.bincount(ids)).astype(np.float32)     # Yuan-Lin
    ragged = T_G.build_group_tables(ids, 19, "cuda")
    blocks = T_G.build_group_tables(np.repeat(np.arange(32), 8), 32, "cuda",
                                    block=8)
    tv = t((3.0 * rng.random((200, 1))).astype(np.float32)).cuda()
    atol, rtol = (1e-5, 1e-5) if kp == "f32" else (5e-3, 5e-2)
    before = T_G.GROUP_PROX[kp].launches
    v = z + 0.3 * (zp - z)
    for tables, thg, t_vec in ((ragged, 0.02 * t(w_g).cuda(), None),
                               (blocks, torch.full((32,), 0.02).cuda(), tv)):
        t_k = None if t_vec is None else t_vec.clone()
        t_p = None if t_vec is None else t_vec.clone()
        got = T_G.group_prox_update(v, z, zp, t_k, thg, tables,
                                    kernel_precision=kp)
        want = T_G._group_prox_update_plain_into(v, z, zp, t_p, thg, tables,
                                                 kernel_precision=kp)
        np.testing.assert_allclose(n(got[0]), n(want[0]), rtol=0, atol=atol)
        np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=rtol)
        if t_vec is not None:
            np.testing.assert_array_equal(n(t_k), n(t_p))
        kw = dict(kernel_precision=kp, t_vec=t_vec,
                  use_l1=t_vec is not None)
        args = (x, z, zp, W, 0.1, thg, 0.01, torch.linspace(0, 0.6, 8),
                tables, 8)
        got = T_G.fused_group_fista_multistep(*args, **kw)
        want = T_G.fused_group_fista_multistep_plain(*args, **kw)
        for a, b in zip(got[:-1], want[:-1]):
            np.testing.assert_allclose(n(a), n(b), rtol=0, atol=atol)
        np.testing.assert_allclose(float(got[-1]), float(want[-1]),
                                   rtol=rtol)
    assert T_G.GROUP_PROX[kp].launches - before == 18


@pytest.mark.parametrize("kw", [
    {"maxiter": 37, "tol": 0.0},
    {"maxiter": 64, "tol": 0.0, "restart": True, "groups": "ids",
     "l1_alpha": 0.05},
], ids=["blocks_remainder", "ids_restart_l1"])
def test_group_ista_on_card_matches_cpu(kw):
    """group_ista's fused path on the card against the same solve on the
    CPU (plain versions): n_iter equal, codes atol 1e-4."""
    _need_card()
    rng = np.random.default_rng(0)
    x, _, _, W = make_problem(rng, n=16)
    kw = dict(kw)
    kw["groups"] = (np.asarray(rng.permutation(np.repeat(np.arange(16), 16)),
                               np.int32)
                    if kw.get("groups") == "ids" else 8)
    z0 = np.zeros((16, W.shape[1]), np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        out[dev] = group_ista(t(x).to(dev), t(z0).to(dev), t(W).to(dev),
                              0.1, lr=0.1, use_pallas=True,
                              return_iters=True, **kw)
    assert out["cuda"][1] == out["cpu"][1]
    np.testing.assert_allclose(n(out["cuda"][0]), n(out["cpu"][0]),
                               atol=1e-4)


def _scatter(idx, z_s, k):
    z = torch.zeros((idx.shape[0], k), device=z_s.device)
    return n(z.scatter_add_(1, idx.long(), z_s))


@pytest.mark.parametrize("kp", ["f32", "bf16"])
def test_fused_omp_kernels_match_plain(kp):
    """K6a, K6b and K6c (one fused_omp_solve) against the plain versions
    on the card: N not a multiple of the 128-row tile, T not of 8, rows
    that freeze under tol mid-run, and a duplicated atom. Validity equal;
    the codes by the equivalence rule of tests/test_fused_omp.py (the
    product sums in another order, so a near-tie may flip an atom)."""
    _need_card()
    x, W = omp_problem(9, 200, 128, 384)
    W[:, 383] = W[:, 0]
    z = np.zeros((8, 384), np.float32)
    z[:, 1:4] = np.random.default_rng(1).standard_normal((8, 3))
    x[:8] = z @ W.T
    xc, Wc = t(x).cuda(), t(W).cuda()
    before = _cuda.launch_counts()
    got = T_O.fused_omp_solve(xc, Wc, 13, tol=1e-6, kernel_precision=kp)
    want = T_O.fused_omp_solve_plain(xc, Wc, 13, tol=1e-6,
                                     kernel_precision=kp)
    after = _cuda.launch_counts()
    np.testing.assert_array_equal(n(got[1]), n(want[1]))
    assert n(got[1])[:8].sum(axis=1).max() <= 4
    assert np.isfinite(n(got[2])).all()
    assert_equivalent(x, W, _scatter(want[0], want[2], 384),
                      _scatter(got[0], got[2], 384))
    assert after[f"omp_select_{kp}"] - before[f"omp_select_{kp}"] == 13
    assert after["omp_orth"] - before["omp_orth"] == 13
    assert after["omp_backsub"] - before["omp_backsub"] == 1


# K7's cases, (T, B) each: the panel kernel (T <= 64) at a B that is not
# a multiple of 32 or of 4 and at T = 16; the sweep kernel past T = 64
APPEND_CASES = {"panel": [(64, 1003), (16, 200)], "sweep": [(72, 37)]}


@pytest.mark.parametrize("case", list(APPEND_CASES))
def test_chol_append_kernel_matches_plain(case):
    """K7 against its plain version on the card, appending the rows of
    random PD systems one at a time from the identity (k = 0 to T - 1),
    in place, into a new factor and into another buffer, with every third
    sample appending identity rows (a frozen OMP sample): V and z rtol
    2e-4 / atol 1e-5. g and b hold NaN past k (the kernel reads g only to
    k, and b past k only as z's value there)."""
    _need_card()
    rng = np.random.default_rng(3)
    for T, B in APPEND_CASES[case]:
        assert T_B.append_tier(T, B) == case
        A = rng.standard_normal((B, T, T)).astype(np.float32)
        M = A @ np.swapaxes(A, 1, 2) + T * np.eye(T, dtype=np.float32)[None]
        M[::3] = np.eye(T, dtype=np.float32)
        rhs = rng.standard_normal((T, B)).astype(np.float32)
        V = torch.eye(T, device="cuda")[:, :, None].repeat(1, 1, B)
        Vp = V.clone()
        before = T_B.CHOL_APPEND_SOLVE.launches
        for k in range(T):
            g = np.full((T, B), np.nan, np.float32)
            g[:k + 1] = M[:, k, :k + 1].T
            b = np.zeros((T, B), np.float32)
            b[:k + 1] = rhs[:k + 1]
            gc, bc = t(g).cuda(), t(b).cuda()
            fresh, z_f = T_B.cholesky_append_solve_lanes(V, gc, bc, k)
            other = torch.full_like(V, float("nan"))
            _, z_o = T_B.cholesky_append_solve_lanes(V, gc, bc, k, out=other)
            _, z = T_B.cholesky_append_solve_lanes(V, gc, bc, k, out=V)
            Vp, z_p = T_B.cholesky_append_solve_lanes_plain(Vp, gc, bc, k)
            for a, c in ((V, Vp), (fresh, Vp), (other, Vp), (z, z_p),
                         (z_f, z_p), (z_o, z_p)):
                np.testing.assert_allclose(n(a), n(c), rtol=2e-4, atol=1e-5)
            assert not bool(z[k + 1:].any())
        assert T_B.CHOL_APPEND_SOLVE.launches - before == 3 * T


def test_omp_on_card_matches_cpu():
    """'fused' and 'chol' on the card against the same solve on the CPU
    (plain versions), with a tol freeze: n_iter equal, codes by the JAX
    tests' rules."""
    _need_card()
    x, W = omp_problem(11, 64, 128, 256)
    x[:4] = 0.0
    for solver, rule in (("fused", assert_equivalent),
                         ("chol", assert_same_fit)):
        out = {dev: orthogonal_matching_pursuit(
            t(x).to(dev), t(W).to(dev), 12, tol=1e-3, solver=solver,
            use_pallas=True, return_iters=True) for dev in ("cpu", "cuda")}
        assert out["cuda"][1] == out["cpu"][1]
        rule(x, W, n(out["cpu"][0]), n(out["cuda"][0]))


def test_data_parallel_encode_one_nccl_rank_is_sparse_encode():
    """lasso_tpu_torch.parallel on one NCCL rank (an in-memory store, no
    network): data_parallel_encode at 512x256->1024 with the all-reduced
    stop (tol 1e-5 over 64 iterations, 'mixed') equals sparse_encode bit
    for bit, with the same count and the same K1/K2 launches."""
    _need_card()
    import torch.distributed as dist

    from lasso_tpu_torch.linear import sparse_encode
    from lasso_tpu_torch.parallel import data_parallel_encode, make_mesh
    rng = np.random.default_rng(19)
    x, _, _, W = (t(a).cuda() for a in make_problem(rng, 512, 256, 1024))
    kw = dict(alpha=0.1, algorithm="ista", lr=0.1, maxiter=64, tol=1e-5,
              kernel_precision="mixed", return_iters=True)
    _cuda.reset_launch_counts()
    z_s, k_s = sparse_encode(x, W, **kw)
    single = _cuda.launch_counts()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(devices="cuda")
        _cuda.reset_launch_counts()
        z_p, k_p = data_parallel_encode(mesh, x, W, **kw)
        counts = _cuda.launch_counts()
    finally:
        dist.destroy_process_group()
    assert k_p == k_s and torch.equal(z_p, z_s)
    names = [f"{k}_{kp}" for k in ("fista_resid", "fista_grad_prox")
             for kp in ("bf16", "f32")]
    assert all(counts[n] == single[n] > 0 for n in names)


@pytest.mark.parametrize("kw", [
    dict(kernel_precision="mixed", tol=1e-5, lr="auto"),
    dict(kernel_precision="mixed", tol=1e-2, lr="auto"),
    dict(kernel_precision="f32", tol=1e-2, lr=0.1, restart=True),
], ids=["mixed_auto", "mixed_auto_stop", "f32_stop_restart"])
def test_exported_encoder_on_card_is_sparse_encode(kw):
    """The loaded encoder on CUDA inputs: the codes, iteration count and
    K1/K2 launches of sparse_encode bit for bit at two batch sizes of one
    export (the second off the 8-row grid)."""
    _need_card()
    from lasso_tpu_torch.linear import sparse_encode
    from lasso_tpu_torch.utils import export_encoder, load_encoder
    rng = np.random.default_rng(0)
    W = t((rng.standard_normal((100, 300)) / 10).astype(np.float32)).cuda()
    kw = dict(maxiter=64, fuse_steps=16, **kw)
    call = load_encoder(export_encoder(W, alpha=0.1, return_iters=True,
                                       **kw))
    for rows in (256, 203):
        x = t(rng.standard_normal((rows, 100)).astype(np.float32)).cuda()
        runs = []
        for fn in (lambda: call(x, W),
                   lambda: sparse_encode(x, W, 0.1, return_iters=True,
                                         **kw)):
            torch.cuda.synchronize()
            _cuda.reset_launch_counts()
            z, k = fn()
            torch.cuda.synchronize()
            counts = {name: v for name, v in _cuda.launch_counts().items()
                      if name.startswith("fista_") and v}
            runs.append((z, int(k), counts))
        (z, k, counts), (want, k_want, counts_want) = runs
        assert torch.equal(z, want) and k == k_want
        assert counts == counts_want and counts_want


def test_csr_round_trip_of_card_codes():
    """pack_codes_csr of CUDA codes copies them to the host; unpacked they
    are the codes."""
    _need_card()
    from lasso_tpu_torch.native import pack_codes_csr, unpack_codes_csr
    rng = np.random.default_rng(1)
    x, _, _, W = (t(a).cuda() for a in make_problem(rng, 64, 128, 256))
    z = ista(x, torch.zeros(64, 256, device="cuda"), W, 0.5, lr=0.5,
             maxiter=40, tol=0.0)
    values, cols, row_ptr = pack_codes_csr(z, eps=0.0)
    assert row_ptr[-1] == int(torch.count_nonzero(z)) > 0
    np.testing.assert_array_equal(unpack_codes_csr(values, cols, row_ptr,
                                                   256), n(z))
