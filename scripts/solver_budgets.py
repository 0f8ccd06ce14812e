#!/usr/bin/env python3
"""Seconds a solve and objective gap of gpsr, interior-point and
split-bregman at several iteration budgets, on one CUDA card.

    python3 scripts/solver_budgets.py

At the headline problem of ``chip_smoke.py`` phase 16 (16384x512->2048,
alpha 0.1) each solver runs once through ``sparse_encode`` at each budget
below, its defaults first: gpsr at ``maxiter`` 1000 (its default), 100,
200 and 500; interior-point at 20 Newton steps with at most 512 CG
iterations each (the default ``cg_maxiter`` at D=512), 32, 64 and 128;
split-bregman 'f32' at 20 outer iterations (its default), 50, 100 and
200, and 'mixed' at 20, 100 and 200. Each line gives the solve's wall
time (``chip_smoke.timed_solve``: a first run counts its synchronizing
calls, a second is timed between two synchronizes), its iterations, its
inner loops' iterations and the f64 objective's gap to a 3200-iteration
FISTA solve of the port, beside the bound of the solver's JAX test
(``chip_smoke.SOLVER_GAP_BOUND``): the budgets that phase 16 takes are the
smallest here that meet the bound. Then each of phase 16's headline runs
(``chip_smoke.SOLVER_RUNS``) once more, its first run inside torch.profiler:
its kernel time split into cuBLAS's products, elementwise kernels and the
largest kernels by name, against the timed run's wall time. The last line
is the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

BUDGETS = (
    ("gpsr", {}), ("gpsr", {"maxiter": 100}), ("gpsr", {"maxiter": 200}),
    ("gpsr", {"maxiter": 500}),
    ("interior-point", {"maxiter": 20}),
    ("interior-point", {"maxiter": 20, "cg_maxiter": 32}),
    ("interior-point", {"maxiter": 20, "cg_maxiter": 64}),
    ("interior-point", {"maxiter": 20, "cg_maxiter": 128}),
    ("split-bregman", {}), ("split-bregman", {"maxiter": 50}),
    ("split-bregman", {"maxiter": 100}), ("split-bregman", {"maxiter": 200}),
    ("split-bregman", {"kernel_precision": "mixed"}),
    ("split-bregman", {"maxiter": 100, "kernel_precision": "mixed"}),
    ("split-bregman", {"maxiter": 200, "kernel_precision": "mixed"}),
)


def main():
    if not torch.cuda.is_available():
        print("solver_budgets: no CUDA device", file=sys.stderr)
        return 1
    x_np, W_np = cs.headline_problem()
    x = torch.from_numpy(x_np).to(cs.DEV)
    W = torch.from_numpy(W_np).to(cs.DEV)
    f_star, drift = cs.fista_anchor(x, W, cs.ALPHA)
    print(f"FISTA anchor {f_star:.10g} (half its iterations {drift:.3e} "
          f"above it)")
    for name, kw in BUDGETS:
        solve = cs.timed_solve(
            lambda name=name, kw=kw: cs.sparse_encode(
                x, W, cs.ALPHA, algorithm=name, return_iters=True, **kw))
        gap = (cs.objective64_dev(x, W, solve.z, cs.ALPHA) - f_star) / max(
            1.0, abs(f_star))
        print(json.dumps({"algorithm": name, "kwargs": kw,
                          "seconds": round(solve.seconds, 4),
                          "n_iter": solve.n_iter, "inner": solve.inner,
                          "synchronizing_calls": solve.syncs, "gap": gap,
                          "bound": cs.SOLVER_GAP_BOUND[name]}))
    for label, name, kw in cs.SOLVER_RUNS:
        solve = cs.timed_solve(
            lambda name=name, kw=kw: cs.sparse_encode(
                x, W, cs.ALPHA, algorithm=name, return_iters=True, **kw),
            profile=True)
        print(f"{label}: {solve.seconds:.4f} s, "
              f"{cs.kernel_split(solve.kernels, solve.seconds)}")
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
