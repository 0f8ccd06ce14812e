#!/usr/bin/env python3
"""One FISTA step of lasso_tpu_torch on the card: K1 + K2 of
lasso_tpu_torch/csrc/fista.cu at the headline shape (N=16384, D=512,
K=2048), in the two ways the wrappers run them.

* "chained": as the sub-steps of a multistep call with a scalar momentum
  run them after the first. K1 reads the momentum point's bf16 split that
  the previous K2 wrote, and K2 writes the next one.
* "forming": as a call's first sub-step, the restart momentum and the
  group path run them. K1 forms y from z and z_prev, and K2 writes no
  split.

Run from the root of the repository on a machine with an NVIDIA card and
the CUDA toolkit:

    python3 scripts/fista_step_parts.py

Each way is timed by CUDA events over 20 steps behind about 20 ms of
queued work, in the order chained, forming, forming, chained, and K1 and
K2 alone beside. The script prints one JSON line a precision with the
card's name and power limit.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from lasso_tpu_torch.ops import fused_ista as F  # noqa: E402

N, D, K = 16384, 512, 2048
REPS = 20


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def events_ms(fn):
    """Mean ms of ``fn`` on the card over REPS calls after one, queued
    behind an 8192^3 product so that the events time the card and not the
    host."""
    fn()
    a = torch.full((8192, 8192), 1e-3, device="cuda")
    torch.matmul(a, a)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(REPS):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / REPS


def main():
    if not torch.cuda.is_available():
        print("fista_step_parts: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(N, D, generator=g, device="cuda")
    W = torch.randn(D, K, generator=g, device="cuda") / D ** 0.5
    z = torch.randn(N, K, generator=g, device="cuda") * 0.1
    zp = torch.randn(N, K, generator=g, device="cuda") * 0.1
    scal = torch.tensor([0.1, 0.001, 0.5, 1.0], device="cuda")
    r = torch.empty(N, D, device="cuda")
    out = torch.empty(N, K, device="cuda")
    card = card_line()
    for kp in ("bf16", "f32"):
        ops = F.fista_operands(W, N, kp, with_y=True)
        resid = dict(kernel_precision=kp, out=r, operands=ops)
        grad = dict(kernel_precision=kp, out=out, operands=ops)
        ways = {
            "chained": (
                lambda: F.fista_resid(x, z, zp, W, scal, y_split=True,
                                      **resid),
                lambda: F.fista_grad_prox(r, z, zp, W, scal,
                                          next_scal=scal, **grad)),
            "forming": (
                lambda: F.fista_resid(x, z, zp, W, scal, **resid),
                lambda: F.fista_grad_prox(r, z, zp, W, scal, **grad))}
        ways["forming"][0]()
        ways["chained"][1]()   # the momentum point's split K1 will read
        steps = {"chained": [], "forming": []}
        for way in ("chained", "forming", "forming", "chained"):
            k1, k2 = ways[way]
            steps[way].append(events_ms(lambda: (k1(), k2())))
        alone = {f"{way}_{name}_ms": events_ms(fn)
                 for way, fns in ways.items()
                 for name, fn in zip(("K1", "K2"), fns)}
        print(json.dumps({"precision": kp, "N": N, "D": D, "K": K,
                          "step_ms": steps, **alone, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
