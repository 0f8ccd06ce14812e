#!/usr/bin/env python3
"""Time ``chunked_encode``'s dense and CSR outputs on one CUDA card at the
serving width of ``chip_smoke.py`` phase 20 (b): 40000x512 -> 2048, W/sqrt(D),
alpha 0.1, chunks of 16384 (the last ragged), 100 'f32' iterations, tol 0.

    python3 scripts/csr_overlap_timing.py [--threads 0 1 2 4 7] [--repeats 5]

It prints the host's cores (``os.cpu_count()``, the affinity mask, the
cgroup's CPU quota), then one JSON line a configuration: the dense encode,
and the CSR encode with the packer given each ``--threads`` (0: its
default), and once more with the default packer landing each chunk inline,
right after its solve, in place of on ``chunked_encode``'s worker thread
(``csr-inline``; ``dense-inline`` likewise). Each configuration runs ``--repeats`` times in turns with
the others; a line holds the median seconds of the whole call, and, from the
median run, each chunk's solve (``sparse_encode``) and packing intervals on
the host's clock and the seconds of packing that ran while a solve did.
Then one line a thread count for the packer alone on one chunk's codes,
with nothing else running. The card's name and power limit come last.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import importlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import lasso_tpu_torch.native as native  # noqa: E402
from lasso_tpu_torch.utils import chunked_encode  # noqa: E402

# the modules, which the packages' names of their functions shadow
SE = importlib.import_module("lasso_tpu_torch.linear.sparse_encode")
CH = importlib.import_module("lasso_tpu_torch.utils.chunked")

ROWS, D, K, CHUNK, ALPHA = 40000, 512, 2048, 16384, 0.1
KW = dict(alpha=ALPHA, chunk_size=CHUNK, maxiter=100, tol=0.0,
          kernel_precision="f32")


def cores():
    quota = "none"
    if os.path.exists("/sys/fs/cgroup/cpu.max"):
        with open("/sys/fs/cgroup/cpu.max") as f:
            quota = f.read().strip()
    return {"cpu_count": os.cpu_count(),
            "affinity": len(os.sched_getaffinity(0)),
            "cgroup_cpu_max": quota}


class Inline:
    """An executor that runs each task as it is submitted."""

    def __init__(self, max_workers=None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def submit(self, fn, *a, **k):
        done = concurrent.futures.Future()
        done.set_result(fn(*a, **k))
        return done


def run(x, W, pack_threads, inline=False):
    """One chunked encode (dense when ``pack_threads`` is None, the
    packer's default threads when it is 0; landing inline with
    ``inline``); returns its seconds and the solve and packing
    intervals."""
    solves, packs = [], []
    encode, pack = SE.sparse_encode, native.pack_codes_csr
    executor = CH.ThreadPoolExecutor

    def timed_encode(*a, **k):
        t0 = time.perf_counter()
        out = encode(*a, **k)
        solves.append((t0, time.perf_counter()))
        return out

    def timed_pack(z, eps=0.0, threads=None):
        t0 = time.perf_counter()
        out = pack(z, eps=eps, threads=pack_threads or threads)
        packs.append((t0, time.perf_counter()))
        return out

    SE.sparse_encode, native.pack_codes_csr = timed_encode, timed_pack
    if inline:
        CH.ThreadPoolExecutor = Inline
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        output = "dense" if pack_threads is None else "csr"
        chunked_encode(x, W, output=output, **KW)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        SE.sparse_encode, native.pack_codes_csr = encode, pack
        CH.ThreadPoolExecutor = executor
    overlap = sum(max(0.0, min(p1, s1) - max(p0, s0))
                  for p0, p1 in packs for s0, s1 in solves)
    return {"seconds": secs,
            "solve_s": [round(b - a, 4) for a, b in solves],
            "pack_s": [round(b - a, 4) for a, b in packs],
            "pack_during_solve_s": round(overlap, 4)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--threads", type=int, nargs="+", default=[0, 1, 2, 4])
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(json.dumps({"cores": cores()}))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((ROWS, D)).astype(np.float32)
    W = torch.from_numpy((rng.standard_normal((D, K)) / np.sqrt(D))
                         .astype(np.float32)).cuda()
    configs = [("dense", None, False), ("dense-inline", None, True),
               ("csr-inline", 0, True),
               *(("csr", c, False) for c in args.threads)]
    run(x, W, None)   # build the kernels, warm the host's copies
    runs = {c: [] for c in configs}
    for _ in range(args.repeats):
        for c in configs:
            runs[c].append(run(x, W, *c[1:]))
    for c in configs:
        rs = sorted(runs[c], key=lambda r: r["seconds"])
        med = rs[len(rs) // 2]
        print(json.dumps({"output": c[0], "pack_threads": c[1],
                          "median_s": med["seconds"],
                          "all_s": [r["seconds"] for r in runs[c]],
                          **{k: v for k, v in med.items()
                             if k != "seconds"}}))
    z = chunked_encode(x[:CHUNK], W, **KW)
    for c in args.threads:
        secs = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            native.pack_codes_csr(z, threads=c or None)  # 0: its default
            secs.append(time.perf_counter() - t0)
        print(json.dumps({"pack_alone_threads": c, "rows": CHUNK,
                          "median_s": float(np.median(secs)),
                          "all_s": secs}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
