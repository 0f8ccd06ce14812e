"""Headline benchmark: batched FISTA iterations/s on one card.

Counterpart of the JAX package's ``headline_bench.py``, with the same
problem and seeds: N=16384 samples, D=512 features, K=2048 atoms,
alpha=0.1, a fixed 200 iterations (tol=0), ``kernel_precision='mixed'``
with a 37-iteration f32 tail, lr = 1/L computed outside the timed
region, and 7 distinct inputs (one warm-up, six timed; the minimum
counts). Each timed repeat synchronizes the device before and after the
solve and reads one value back to the host.

``gap_vs_f32_pct`` is measured in the same run: the mixed solve's f64
objective against an all-f32 solve of the same budget and an 8x-budget
f32 anchor, as ``100 * (f_mixed - f_f32) / (f_f32 - f_anchor)``.

Run it as ``python -m lasso_tpu_torch bench [--device cuda]``. It prints
one JSON line: ``metric``, ``value``, ``unit``, ``gap_vs_f32_pct`` and
``device`` (the card's name).
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

N, D, K = 16384, 512, 2048
ALPHA = 0.1
ITERS = 200
MIXED_TAIL_ITERS = 37


def make_problem(n=N, d=D, k=K, seed=0):
    """The bench's inputs as numpy: 7 distinct x [n, d] and W [d, k]."""
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((n, d)).astype(np.float32) for _ in range(7)]
    W = (rng.standard_normal((d, k)) / np.sqrt(d)).astype(np.float32)
    return xs, W


def solve(x, W, lr, kernel_precision="mixed", iters=ITERS):
    """The timed solve: ``iters`` FISTA iterations at ``kernel_precision``
    through the fused path (the CUDA kernels on a card, their plain
    versions on the CPU)."""
    from lasso_tpu_torch.linear.solvers import ista
    z0 = torch.zeros((x.shape[0], W.shape[1]), dtype=torch.float32,
                     device=x.device)
    kw = ({"mixed_tail_iters": MIXED_TAIL_ITERS}
          if kernel_precision == "mixed" else {})
    return ista(x, z0, W, ALPHA, lr=lr, maxiter=iters, tol=0.0,
                use_pallas=True, kernel_precision=kernel_precision, **kw)


def objective64(x, W, z):
    """The lasso objective of codes ``z`` in float64 on the host."""
    z = z.cpu().double().numpy()
    r = z @ W.astype(np.float64).T - x.astype(np.float64)
    return 0.5 * np.sum(r * r) + ALPHA * np.sum(np.abs(z))


def run(device, n=N, d=D, k=K, iters=ITERS):
    """Measure the headline on ``device``; returns the result dict."""
    from lasso_tpu_torch.linalg import lipschitz_constant
    from lasso_tpu_torch.utils.convert import from_numpy_params, resolve_device
    device = resolve_device(device)
    xs_np, W_np = make_problem(n, d, k)
    W = from_numpy_params({"weight": W_np}, device)["weight"]
    xs = [torch.from_numpy(x).to(device) for x in xs_np]
    lr = float(1.0 / lipschitz_constant(W))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    solve(xs[0], W, lr, iters=iters)   # warm-up (and kernel build)
    times = []
    for x in xs[1:]:
        sync()
        t0 = time.perf_counter()
        z = solve(x, W, lr, iters=iters)
        sync()
        float(z[0, 0])   # a real device->host readback
        times.append(time.perf_counter() - t0)
    iters_per_s = iters / min(times)

    f_m = objective64(xs_np[1], W_np, solve(xs[1], W, lr, iters=iters))
    f_f = objective64(xs_np[1], W_np,
                      solve(xs[1], W, lr, "f32", iters=iters))
    f_star = objective64(xs_np[1], W_np,
                         solve(xs[1], W, lr, "f32", iters=8 * iters))
    gap_pct = 100.0 * (f_m - f_f) / max(f_f - f_star, 1e-30)
    return {
        "metric": (f"batched FISTA iterations/s per card (N={n}, "
                   f"{d}->{k}, mixed-precision continuation, "
                   f"gap-to-optimum measured in-run, see gap_vs_f32_pct)"),
        "value": round(iters_per_s, 2),
        "unit": "iterations/s",
        "gap_vs_f32_pct": round(gap_pct, 2),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
    }


def main(device="cuda"):
    print(json.dumps(run(device)))
