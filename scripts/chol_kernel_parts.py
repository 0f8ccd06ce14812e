#!/usr/bin/env python3
"""Where the batched Cholesky solve K8 (lasso_tpu_torch/csrc/chol.cu,
``chol_solve``) and the append K7 (``chol_append_solve``) spend their
time: each is timed whole and with one part cut out. K8 at B=16384, D=64
(OMP 'chol-full' at T=64: the warp kernel) and at B=1024, D=256 (the
gate's limit: the tiled kernel); K7 at B=16384, T=64 (OMP 'chol' at T=64)
at steps k = 0, 32 and 63.

Run from the root of the repository on a machine with an NVIDIA card and
the CUDA toolkit:

    python3 scripts/chol_kernel_parts.py [--kernels k8|k7|all]

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

K7's copies: its panel kernel (T <= 64, the live triangle read once)
whole ("k7_panel_whole"), with every read of V replaced by a value made
from the indices ("k7_panel_no_v_reads"), without the exchange of the
row sums between the warps (its partial sums, two __syncthreads a panel
and the warps' sums: "k7_panel_no_exchange"), with neither
("k7_panel_skeleton") and with no panel at all ("k7_panel_io_only": g, b
read, the pivot, t_k's exchange, z and row k written). The "k7_sweep_"
copies send T = 64 to its kept sweep kernel (the first kernel, taken past
T = 64: the live triangle swept four times, for y, u, t and z): whole,
without any read of V ("no_v_reads": the sweeps' loops, g's and b's
loads and the shared-memory exchanges alone), with only the first sweep
(y) reading V ("one_read") and with no sweep ("io_only"). A factor of 63
appends from the identity is built first by the package's own kernel
(random PD systems, every fifth the identity); each copy appends row k
to it in place, which writes the same row k each time, 20 launches after
3, behind about 20 ms of queued work, twice.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from lasso_tpu_torch.ops import _cuda  # noqa: E402
from lasso_tpu_torch.ops import batched_cholesky as B  # noqa: E402

SHAPES = ((16384, 64), (1024, 256))
K7_B, K7_T, K7_STEPS = 16384, 64, (0, 32, 63)
# the four reads of V in the sweep kernel: y's, u's, t's and z's sweeps
K7_READS = (
    "acc = fmaf(vs[i * rowT + (size_t)j * B], gs[(size_t)j * B], acc);",
    "acc = fmaf(vs[i * rowT + (size_t)j * B], ys[i * SB + lane], acc);",
    "acc = fmaf(vs[i * rowT + (size_t)j * B], bs[(size_t)j * B], acc);",
    "val = fmaf(vs[i * rowT + (size_t)j * B], ys[i * SB + lane], val);")


def _no_read(line):
    return (line, line.replace("vs[i * rowT + (size_t)j * B]",
                               "(1e-3f * (float)(i + j))"))


# the panel kernel's load of V, and its exchange between the warps
K7_PANEL_LOAD = ("? vi[(size_t)(8 * c) * B] : 0.f;",
                 "? 1e-3f * (float)(i + c) : 0.f;")
K7_PANEL_EXCHANGE = [
    ("    __syncthreads();\n    {   // warp w sums row w", "    {   // warp"
                                                         " w sums row w"),
    ("        ya += pq.x;\n        ta += pq.y;\n", ""),
    ("    __syncthreads();   // also: the next panel's partials",
     "    // also: the next panel's partials")]
# T = 64 to the sweep kernel
TO_SWEEP = [("  if (T <= 64) switch (T / 8) {",
             "  if (false) switch (T / 8) {")]
K7_CUTS = {
    "k7_panel_whole": [],
    "k7_panel_no_v_reads": [K7_PANEL_LOAD],
    "k7_panel_no_exchange": K7_PANEL_EXCHANGE,
    "k7_panel_skeleton": [K7_PANEL_LOAD] + K7_PANEL_EXCHANGE,
    "k7_panel_io_only": [("    if (PR * p >= k) break;",
                          "    if (PR * p >= 0) break;")],
    "k7_sweep_whole": TO_SWEEP,
    "k7_sweep_no_v_reads": TO_SWEEP + [_no_read(line) for line in K7_READS],
    "k7_sweep_one_read": TO_SWEEP + [_no_read(line)
                                     for line in K7_READS[1:]],
    "k7_sweep_io_only": TO_SWEEP + [
        ("  for (int i = p; i < k; i += PW) {\n    float acc = 0.f;",
         "  for (int i = p; i < 0; i += PW) {\n    float acc = 0.f;"),
        ("        for (int i = j; i < k; ++i)\n          acc = fmaf(",
         "        for (int i = j; i < 0; ++i)\n          acc = fmaf("),
        ("  for (int i = p; i <= k; i += PW) {",
         "  for (int i = p; i < 0; i += PW) {"),
        ("      for (int i = j; i < k; ++i)\n        val = fmaf(",
         "      for (int i = j; i < 0; ++i)\n        val = fmaf(")],
}
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


def build(kernels):
    """{copy: ctypes library}, the copies of ``kernels`` ('k8', 'k7' or
    'all') compiled together."""
    src = open(os.path.join(_cuda.CSRC, "chol.cu")).read()
    out = os.path.join(ROOT, "build", "chol_parts")
    os.makedirs(out, exist_ok=True)
    procs = {}
    copies = {}
    if kernels in ("k8", "all"):
        copies.update({"whole": [], **CUTS})
    if kernels in ("k7", "all"):
        copies.update(K7_CUTS)
    for name, cuts in copies.items():
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
                                              or "tile_kernelILi256" in line
                                              or "append" in line):
                kernel = ("warp<64>" if "warp_kernel" in line else
                          "tile<256>" if "tile_kernel" in line else
                          line.split("'")[1] if "'" in line else "append")
                print(f"{name} {kernel}: {lines[i + 1].strip()}; "
                      f"{lines[i + 2].strip()}")
        libs[name] = ctypes.CDLL(lib)
        libs[name].chol_solve.argtypes = ([ctypes.c_void_p] * 3
                                          + [ctypes.c_int] * 2
                                          + [ctypes.c_void_p])
        libs[name].chol_solve.restype = ctypes.c_int
        libs[name].chol_append_solve.argtypes = B.CHOL_APPEND_SOLVE.argtypes
        libs[name].chol_append_solve.restype = ctypes.c_int
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


def k7_times(libs, stream):
    """{step: {copy: [ms, ms]}} of K7's copies on a factor of 63 appends."""
    T, B_ = K7_T, K7_B
    g = torch.Generator(device="cuda").manual_seed(7)
    A = torch.randn(B_, T, T, generator=g, device="cuda")
    M = A @ A.transpose(1, 2) / T + torch.eye(T, device="cuda")
    M[::5] = torch.eye(T, device="cuda")
    M = M.permute(1, 2, 0).contiguous()
    rhs = torch.randn(T, B_, generator=g, device="cuda")
    del A

    def rows(k):
        gk, bk = M[k].clone(), rhs.clone()
        gk[k + 1:] = 0.0
        bk[k + 1:] = 0.0
        return gk, bk

    V = torch.eye(T, device="cuda")[:, :, None].repeat(1, 1, B_)
    for k in range(T - 1):
        B.cholesky_append_solve_lanes(V, *rows(k), k, out=V)
    z = torch.empty_like(rhs)
    times = {}
    for _ in range(2):
        for k in K7_STEPS:
            gk, bk = rows(k)
            for name in K7_CUTS:
                def call(lib=libs[name]):
                    return lib.chol_append_solve(
                        V.data_ptr(), gk.data_ptr(), bk.data_ptr(),
                        z.data_ptr(), k, T, B_, stream)
                if call():
                    raise RuntimeError(f"{name}: chol_append_solve failed")
                times.setdefault(f"k={k}", {}).setdefault(name, []).append(
                    round(ms(call), 4))
    return times


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", choices=("k8", "k7", "all"),
                    default="all", help="the kernels whose copies to time")
    kernels = ap.parse_args().kernels
    if not torch.cuda.is_available():
        print("chol_kernel_parts: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    libs = build(kernels)
    stream = torch.cuda.current_stream().cuda_stream
    if kernels in ("k7", "all"):
        print(json.dumps({"card": card, "kernel": "chol_append_solve",
                          "width": f"B={K7_B}, T={K7_T}",
                          "ms": k7_times(libs, stream)}), flush=True)
    if kernels == "k7":
        return 0
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
                if name in K7_CUTS:
                    continue

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
