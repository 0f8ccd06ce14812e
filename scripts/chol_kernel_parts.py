#!/usr/bin/env python3
"""Where the batched Cholesky solve K8 (lasso_tpu_torch/csrc/chol.cu,
``chol_solve``) spends its time: it is timed whole and with one part cut
out, at B=16384, D=64 (OMP 'chol-full' at T=64: the warp kernel) and at
B=1024, D=256 (the gate's limit: the tiled kernel).

Run from the root of the repository on a machine with an NVIDIA card and
the CUDA toolkit:

    python3 scripts/chol_kernel_parts.py

It builds copies of csrc/chol.cu into build/chol_parts/: the source as it
is ("whole"), without the loads of A (each kernel then factors a matrix it
makes itself: "no_a_loads"), without the warp kernel's trailing update
("no_update"), without the back substitution of either kernel
("no_back"), and, in the tiled kernel, without the trailing update over
whole tiles ("no_tile_update") and without the solves of the rows below a
panel's diagonal tile ("no_panel_rows"). It prints what ptxas says of the
two kernels' registers and spills for each copy, and one JSON line with
the card's name and power limit and each copy's time at both shapes (the
mean of 20 launches after 3 by CUDA events, behind about 20 ms of queued
work, twice). The cut copies compute wrong results; only their times
mean anything.
"""

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from lasso_tpu_torch.ops import _cuda  # noqa: E402

SHAPES = ((16384, 64), (1024, 256))
CUTS = {
    "no_a_loads": [
        ("? __ldg(as + (size_t)k * D + ia)", "? (k == ia ? 64.f : 0.01f)"),
        ("? __ldg(as + (size_t)k * D + ib)", "? (k == ib ? 64.f : 0.01f)"),
        ("        if (i >= k && i < D)\n          asm volatile",
         "        if (false)\n          asm volatile")],
    "no_update": [("        if (k <= j) continue;\n", "        continue;\n")],
    "no_back": [
        ("  for (int j = DP - 1; j >= 0; --j) {\n    const float* row = Lp",
         "  for (int j = DP - 1; j >= DP; --j) {\n    const float* row = Lp"),
        ("  if (t < 32) {\n    float yr[NT]",
         "  if (t < 0) {\n    float yr[NT]")],
    "no_tile_update": [("        if (u % GROUPS != grp) continue;",
                        "        continue;")],
    "no_panel_rows": [("    if (t >= CT && row) {", "    if (t < 0) {")],
}


def build():
    """{copy: ctypes library}, the copies compiled together."""
    src = open(os.path.join(_cuda.CSRC, "chol.cu")).read()
    out = os.path.join(ROOT, "build", "chol_parts")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name, cuts in {"whole": [], **CUTS}.items():
        text = src
        for old, new in cuts:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in csrc/chol.cu "
                                   f"once")
            text = text.replace(old, new)
        path = os.path.join(out, f"chol_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(out, f"libchol_{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-o", lib,
             path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines[:-2]):
            if "Compiling entry" in line and ("warp_kernelILi64" in line
                                              or "tile_kernelILi256" in line):
                kernel = "warp<64>" if "warp" in line else "tile<256>"
                print(f"{name} {kernel}: {lines[i + 1].strip()}; "
                      f"{lines[i + 2].strip()}")
        libs[name] = ctypes.CDLL(lib)
        libs[name].chol_solve.argtypes = ([ctypes.c_void_p] * 3
                                          + [ctypes.c_int] * 2
                                          + [ctypes.c_void_p])
        libs[name].chol_solve.restype = ctypes.c_int
    return libs


def ms(fn, reps=20):
    for _ in range(3):
        fn()
    a = torch.full((8192, 8192), 1e-3, device="cuda")
    torch.matmul(a, a)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def main():
    if not torch.cuda.is_available():
        print("chol_kernel_parts: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    libs = build()
    stream = torch.cuda.current_stream().cuda_stream
    times = {}
    for b_, d_ in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(1)
        Q = torch.randn(b_, d_, d_, generator=g, device="cuda")
        A = Q @ Q.transpose(1, 2) + 2 * torch.eye(d_, device="cuda")
        b = torch.randn(b_, d_, generator=g, device="cuda")
        x = torch.empty_like(b)
        del Q
        for _ in range(2):
            for name, lib in libs.items():
                def call(lib=lib):
                    return lib.chol_solve(A.data_ptr(), b.data_ptr(),
                                          x.data_ptr(), b_, d_, stream)
                if call():
                    raise RuntimeError(f"{name}: chol_solve failed")
                times.setdefault(f"{b_}x{d_}", {}).setdefault(
                    name, []).append(round(ms(call), 4))
    print(json.dumps({"card": card, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
