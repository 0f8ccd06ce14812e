#!/usr/bin/env python3
"""Time the cyclic-CD sweep kernel K4 (``fused_cd_mod_sweep``) on one CUDA
card, at the headline width (16384x512->2048) and the training width
(16384x256->1024), or at the widths given as ``--width NxDxK``, every row
live, for this checkout and, with ``--other DIR``, for another checkout of
the repository (for example the parent commit unpacked with ``git
archive``).

    python3 scripts/cd_mod_sweep_timing.py [--other DIR] [--width NxDxK ...]
        [--ptxas]

Each tree runs in a process of its own (both packages are named
``lasso_tpu_torch``), in the order other, this, this, other, so that the two
are compared on one card in turns. A process builds its tree's ``cd``
library (``--ptxas``: and prints what ptxas says of each kernel), holds its
kernel to its own plain version on the same inputs (z and R atol 1e-4,
zmax and dzmax rtol 1e-5), then times one sweep by CUDA events: the mean
of 10 launches after 3, behind about 20 ms of queued work, and reads the
SM clock and the power draw (nvidia-smi every 20 ms) over 60 more
launches. It prints one JSON line a width; the parent prints the card's
name and power limit and a summary line last.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTHS = {"headline": (16384, 512, 2048), "training": (16384, 256, 1024)}
PEAK_FP32 = 67e12                      # H100 SXM data sheet, FP32 FFMA


def measure(root, label, ptxas, widths):
    sys.path.insert(0, root)
    import torch
    from lasso_tpu_torch.ops import _cuda
    from lasso_tpu_torch.ops import fused_cd as C

    logs = _cuda.build(["cd"], ptxas_verbose=ptxas)
    for line in "".join(logs.values()).splitlines():
        if ptxas and ("registers" in line or "spill" in line
                      or "Compiling" in line):
            print(f"[{label}] ptxas: {line.strip()}")
    dev = torch.device("cuda")

    def hold_the_card():
        a = torch.full((8192, 8192), 1e-3, device=dev)
        torch.matmul(a, a)

    for n, d, k in widths:
        g = torch.Generator(device=dev).manual_seed(1)
        x = torch.randn(n, d, generator=g, device=dev)
        W = torch.randn(d, k, generator=g, device=dev)
        W = W / W.norm(dim=0)
        z = torch.randn(n, k, generator=g, device=dev) * (
            torch.rand(n, k, generator=g, device=dev) < 0.05)
        R = x - z @ W.T
        conv = torch.zeros(n, dtype=torch.bool, device=dev)
        nrm = (W * W).sum(0)
        args = (z, R, conv, W, nrm, 0.1)
        got = C.fused_cd_mod_sweep(*args)
        torch.cuda.synchronize()
        want = C.fused_cd_mod_sweep_plain(*args)
        err = max(float((a - b).abs().max())
                  for a, b in zip(got[:2], want[:2]))
        rel = max(float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
                  for a, b in zip(got[2:], want[2:]))
        for _ in range(3):
            C.fused_cd_mod_sweep(*args)
        hold_the_card()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(10):
            C.fused_cd_mod_sweep(*args)
        e1.record()
        torch.cuda.synchronize()
        ms = e0.elapsed_time(e1) / 10
        smi = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "20"],
            stdout=subprocess.PIPE, text=True)
        for _ in range(60):
            C.fused_cd_mod_sweep(*args)
        torch.cuda.synchronize()
        smi.terminate()
        samples = [[float(v) for v in line.split(",")]
                   for line in smi.communicate()[0].splitlines()
                   if line.count(",") == 1]
        busy = samples[len(samples) // 4:] or samples
        span = [[min(v[i] for v in busy), max(v[i] for v in busy)]
                if busy else None for i in (0, 1)]
        print(json.dumps({
            "tree": label, "width": f"{n}x{d}->{k}", "ms": ms,
            "sm_mhz": span[0], "power_w": span[1],
            "bound_ms": 4 * n * k * d / PEAK_FP32 * 1e3,
            "max_abs_err": err, "max_rel_err_zmax_dzmax": rel,
            "ok": err <= 1e-4 and rel <= 1e-5}), flush=True)
        del x, W, z, R, got, want


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="another checkout of the repository")
    ap.add_argument("--width", action="append", metavar="NxDxK",
                    help="a width to time (repeatable; default the headline "
                    "and the training width)")
    ap.add_argument("--ptxas", action="store_true",
                    help="print ptxas's register and spill lines")
    ap.add_argument("--one", nargs=2, metavar=("ROOT", "LABEL"),
                    help=argparse.SUPPRESS)
    a = ap.parse_args()
    widths = ([tuple(int(v) for v in w.split("x")) for w in a.width]
              if a.width else list(WIDTHS.values()))
    if a.one:
        measure(os.path.abspath(a.one[0]), a.one[1], a.ptxas, widths)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("cd_mod_sweep_timing: no CUDA device", file=sys.stderr)
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
            + [f"--width={n}x{d}x{k}" for n, d, k in widths]
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
        summary.setdefault(f"{r['tree']} {r['width']}", []).append(r["ms"])
    print(json.dumps({"ms": summary,
                      "ok": all(r["ok"] for r in rows)}))
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
