#!/usr/bin/env python3
"""Time the batched Cholesky solve K8 (``batch_cholesky_solve_lanes``), the
append K7 (``cholesky_append_solve_lanes``), the fused OMP steps K6b
(``omp_orth``) and K6d (``omp_orth_cgs2``), the back-substitution K6c
(``omp_backsub``) and the greedy-CD kernel K3 (``cd_steps``) on one CUDA
card, for this checkout and, with ``--other DIR``, for another checkout of
the repository (for example the parent commit unpacked with ``git
archive``).

    python3 scripts/chol_omp_timing.py [--other DIR] [--ptxas]

Each tree runs in a process of its own (both packages are named
``lasso_tpu_torch``), in the order other, this, this, other, so that the
two are compared on one card in turns. A process builds its tree's
``omp``, ``chol`` and ``cd`` libraries (``--ptxas``: and prints what ptxas
says of each kernel), then:

* K8 at B=16384, D=64 (OMP 'chol-full' at T=64) and B=1024, D=256 (the
  gate's limit), on A = Q Q^T + 2 I: x held to the plain version at rtol
  1e-4 / atol 1e-5, and the mean of 20 launches after 3 by CUDA events,
  behind about 20 ms of queued work;
* K7 at B=16384, T=64: the 64 appends of random PD systems (every fifth
  the identity) from the identity, in place, with events around every
  launch: the mean over the 64 steps and the times at steps 0, 32 and
  63; V and z of every step held to the plain version at rtol 2e-4 /
  atol 1e-5 (and the kernel's tier, where the tree names it);
* one fused OMP solve at benchmarks/omp_fused_bench.py's problem
  (16384x512->2048, T=64, f32), with events around every launch: K6b's
  mean over the 64 steps and its time at steps 0, 32 and 63, K6a's mean;
  the same with ``gs='cgs2'`` for K6d; K6b and K6d at step 32 held to
  their plain versions from one state (idx, valid and the masks equal; r,
  q_k, R's column, d_k and r's split at rtol 2e-4 / atol 1e-5); K6c on
  the f32 solve's final state, bit for bit its plain version, timed as
  K8 (and its tier);
* solves/s of ``sparse_encode(algorithm='omp', n_nonzero_coefs=64)`` (the
  fused route, K6c once a solve), of the same with ``solver='chol'`` (K7
  once a step), with ``solver='chol-full'`` (K8 once a step) and of
  ``fused_omp_solve(gs='cgs2')`` (K6d once a step), the best of two solves
  after one warm-up;
* K3 ``cd_steps`` in f32 and bf16 at 16384x512->2048 (the headline) and
  16384x256->1024 (the training width): 8 steps a launch from b = x W,
  z = 0, every row active, alpha 0.2, tol 0 (phase 5's operands in
  ``chip_smoke.py``), held to its plain version (b and z atol 1e-6) and
  timed as K8.

It prints one JSON line a process; the parent prints the card's name and
power limit and a summary line last.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, D, K, T = 16384, 512, 2048, 64        # benchmarks/omp_fused_bench.py
CHOL_SHAPES = ((16384, 64), (1024, 256))
CD_WIDTHS = ((512, 2048), (256, 1024))   # K3: (D, K), 16384 rows


def measure(root, label, ptxas):
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from lasso_tpu_torch.linear import sparse_encode
    from lasso_tpu_torch.ops import _cuda
    from lasso_tpu_torch.ops import batched_cholesky as B
    from lasso_tpu_torch.ops import fused_cd as C
    from lasso_tpu_torch.ops import fused_omp as O

    logs = _cuda.build(["omp", "chol", "cd"], ptxas_verbose=ptxas)
    for line in "".join(logs.values()).splitlines():
        if ptxas and ("registers" in line or "spill" in line
                      or "Compiling" in line):
            print(f"[{label}] ptxas: {line.strip()}")
    dev = torch.device("cuda")
    out = {"tree": label}

    def hold_the_card():
        a = torch.full((8192, 8192), 1e-3, device=dev)
        torch.matmul(a, a)

    def cuda_ms(fn, reps=20, warm=3):
        for _ in range(warm):
            fn()
        hold_the_card()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    def worst(a, c, rtol):
        return float(((a - c).abs() - rtol * c.abs()).max())

    ok = True
    for b_, d_ in CHOL_SHAPES:
        g = torch.Generator(device=dev).manual_seed(b_ + d_)
        Q = torch.randn(b_, d_, d_, generator=g, device=dev)
        A = Q @ Q.transpose(1, 2) + 2 * torch.eye(d_, device=dev)
        b = torch.randn(b_, d_, generator=g, device=dev)
        del Q
        x = B.batch_cholesky_solve_lanes(b, A)
        torch.cuda.synchronize()
        e = worst(x, B.batch_cholesky_solve_lanes_plain(b, A), 1e-4)
        ok &= e <= 1e-5 and bool(torch.isfinite(x).all())
        out[f"chol_solve_{b_}x{d_}_ms"] = cuda_ms(
            lambda: B.batch_cholesky_solve_lanes(b, A))
        out[f"chol_solve_{b_}x{d_}_excess"] = e
        del A, b, x

    # K7: 64 appends from the identity, each between two events
    g = torch.Generator(device=dev).manual_seed(7)
    A = torch.randn(N, T, T, generator=g, device=dev)
    M = A @ A.transpose(1, 2) / T + torch.eye(T, device=dev)
    M[::5] = torch.eye(T, device=dev)
    M = M.permute(1, 2, 0).contiguous()
    rhs = torch.randn(T, N, generator=g, device=dev)
    del A
    gb = []
    for k in range(T):
        gk, bk = M[k].clone(), rhs.clone()
        gk[k + 1:] = 0.0
        bk[k + 1:] = 0.0
        gb.append((gk, bk))
    del M, rhs
    V = torch.eye(T, device=dev)[:, :, None].repeat(1, 1, N)
    B.cholesky_append_solve_lanes(V.clone(), *gb[0], 0)   # load the kernel
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(T + 1)]
    zs = []
    hold_the_card()
    ev[0].record()
    for k, (gk, bk) in enumerate(gb):
        zs.append(B.cholesky_append_solve_lanes(V, gk, bk, k, out=V)[1])
        ev[k + 1].record()
    torch.cuda.synchronize()
    append = [ev[k].elapsed_time(ev[k + 1]) for k in range(T)]
    Vp = torch.eye(T, device=dev)[:, :, None].repeat(1, 1, N)
    e = 0.0
    for k, (gk, bk) in enumerate(gb):
        Vp, zp = B.cholesky_append_solve_lanes_plain(Vp, gk, bk, k)
        e = max(e, worst(zs[k], zp, 2e-4))
    e = max(e, worst(V, Vp, 2e-4))
    ok &= e <= 1e-5
    out["chol_append_solve_mean_ms"] = sum(append) / T
    out["chol_append_solve_steps_ms"] = {s: append[s] for s in (0, 32, T - 1)}
    out["chol_append_solve_excess"] = e
    tier = getattr(B, "append_tier", None)
    if tier is not None:
        out["chol_append_solve_tier"] = tier(T, N)
    del V, Vp, zs, gb

    rng = np.random.default_rng(0)
    W_np = rng.standard_normal((D, K)).astype(np.float32)
    W_np /= np.linalg.norm(W_np, axis=0, keepdims=True)
    x_np = rng.standard_normal((N, D)).astype(np.float32)
    x, W = torch.from_numpy(x_np).to(dev), torch.from_numpy(W_np).to(dev)
    invn, wt = O.inverse_norms(W), W.T.contiguous()
    wsplit = O.select_operands(W)
    for gs in ("mgs", "cgs2"):
        O.fused_omp_solve(x[:256], W, 4, gs=gs)   # load the kernels first
        state = O.omp_init_state(x, K, T)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2 * T + 1)]
        hold_the_card()
        for k in range(T):
            ev[2 * k].record()
            O.omp_select(state, wsplit, invn)
            ev[2 * k + 1].record()
            O.omp_orth(state, wt, k, gs=gs)
        ev[2 * T].record()
        torch.cuda.synchronize()
        orth = [ev[2 * k + 1].elapsed_time(ev[2 * k + 2]) for k in range(T)]
        name = "omp_orth" if gs == "mgs" else "omp_orth_cgs2"
        out[f"{name}_mean_ms"] = sum(orth) / T
        out[f"{name}_steps_ms"] = {s: orth[s] for s in (0, 32, T - 1)}
        if gs == "mgs":
            out["omp_select_f32_mean_ms"] = sum(
                ev[2 * k].elapsed_time(ev[2 * k + 1]) for k in range(T)) / T
            # K6c on the final state, bit for bit its plain version
            z = O.omp_backsub(state)
            torch.cuda.synchronize()
            exact = bool(torch.equal(z, O.omp_backsub_plain(state)))
            ok &= exact
            out["omp_backsub_ms"] = cuda_ms(lambda: O.omp_backsub(state))
            out["omp_backsub_exact"] = exact
            tier = getattr(O, "backsub_tier", None)
            if tier is not None:
                out["omp_backsub_tier"] = tier(state)
            del z
        del state
    # K6b and K6d at step 32 from one state against their plain versions
    for gs, name in (("mgs", "omp_orth"), ("cgs2", "omp_orth_cgs2")):
        st = O.omp_init_state(x, K, T)
        for k in range(32):
            O.omp_select(st, wsplit, invn)
            O.omp_orth(st, wt, k, gs=gs)
        O.omp_select(st, wsplit, invn)
        twin = O.OmpState(**{f: getattr(st, f).clone()
                             for f in st.__dataclass_fields__})
        O.omp_orth(st, wt, 32, gs=gs)
        O.omp_orth_plain(twin, wt, 32, gs=gs)
        exact = all(torch.equal(a, c) for a, c in (
            (st.idx[:, 32], twin.idx[:, 32]),
            (st.valid[:, 32], twin.valid[:, 32]),
            (st.active, twin.active), (st.sel, twin.sel)))
        e = max(worst(a, c, 2e-4) for a, c in (
            (st.r, twin.r), (st.Q[:, 32], twin.Q[:, 32]),
            (st.R[:, 32, :33], twin.R[:, 32, :33]),
            (st.d[:, 32], twin.d[:, 32]),
            (st.rb.float().sum(0), twin.rb.float().sum(0))))
        ok &= exact and e <= 1e-5
        out[f"{name}_step32_excess"], out[f"{name}_step32_exact"] = e, exact
        del st, twin

    solves = {"fused": lambda: sparse_encode(x, W, algorithm="omp",
                                             n_nonzero_coefs=T),
              "chol": lambda: sparse_encode(x, W, algorithm="omp",
                                            n_nonzero_coefs=T,
                                            solver="chol"),
              "chol_full": lambda: sparse_encode(x, W, algorithm="omp",
                                                 n_nonzero_coefs=T,
                                                 solver="chol-full"),
              "cgs2": lambda: O.fused_omp_solve(x, W, T, gs="cgs2")}
    for key, solve in solves.items():
        secs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solve()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        out[f"omp_{key}_solves_per_s"] = 1 / min(secs[1:])
    del x, W, wt, wsplit, invn

    for d_, k_ in CD_WIDTHS:
        g = torch.Generator(device=dev).manual_seed(1)
        xc = torch.randn(N, d_, generator=g, device=dev)
        Wc = torch.randn(d_, k_, generator=g, device=dev)
        Wc = Wc / Wc.norm(dim=0)
        S = torch.eye(k_, device=dev) - Wc.T @ Wc
        args = (xc @ Wc, torch.zeros(N, k_, device=dev),
                torch.ones(N, 1, device=dev), S, 0.2, 0.0)
        for kp in ("f32", "bf16"):
            got = C.fused_cd_steps(*args, steps=8, kernel_precision=kp)
            torch.cuda.synchronize()
            want = C.fused_cd_steps_plain(*args, steps=8, kernel_precision=kp)
            e = max(float((a - c).abs().max())
                    for a, c in zip(got[:2], want[:2]))
            ok &= e <= 1e-6 and bool(torch.equal(got[2], want[2]))
            out[f"cd_steps_{kp}_{N}x{k_}_ms"] = cuda_ms(
                lambda: C.fused_cd_steps(*args, steps=8, kernel_precision=kp))
            out[f"cd_steps_{kp}_{N}x{k_}_err"] = e
        del xc, Wc, S, args, got, want
    out["ok"] = ok
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="another checkout of the repository")
    ap.add_argument("--ptxas", action="store_true",
                    help="print ptxas's register and spill lines")
    ap.add_argument("--one", nargs=2, metavar=("ROOT", "LABEL"),
                    help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.one:
        measure(os.path.abspath(a.one[0]), a.one[1], a.ptxas)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chol_omp_timing: no CUDA device", file=sys.stderr)
        return 1
    order = [(HERE, "this")]
    if a.other:
        other = os.path.abspath(a.other)
        order = [(other, "other"), (HERE, "this"), (HERE, "this"),
                 (other, "other")]
    rows = []
    for i, (root, label) in enumerate(order):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", root, label]
            + (["--ptxas"] if a.ptxas and i < 2 else []),
            capture_output=True, text=True, timeout=900)
        sys.stdout.write(out.stdout)
        if out.returncode != 0:
            sys.stderr.write(out.stderr)
            return out.returncode
        rows += [json.loads(line) for line in out.stdout.splitlines()
                 if line.startswith("{")]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    summary = {}
    for r in rows:
        for key, v in r.items():
            # the per-step dicts as one key a step
            items = ({f"{key[:-len('_steps_ms')]}_step{s}_ms": t
                      for s, t in v.items()} if isinstance(v, dict)
                     else {key: v})
            for k, t in items.items():
                if k.endswith(("_ms", "_per_s")):
                    summary.setdefault(k, {}).setdefault(
                        r["tree"], []).append(round(t, 4))
    print(json.dumps({"summary": summary,
                      "ok": all(r["ok"] for r in rows)}))
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
