#!/usr/bin/env python3
"""Where the conv-FISTA kernels K9a and K9b (lasso_tpu_torch/csrc/conv.cu)
spend their time: each is timed whole and with one part cut out.

Run from the root of the repository on a machine with an NVIDIA card and
the CUDA toolkit:

    python3 scripts/conv_kernel_parts.py

It builds copies of csrc/conv.cu into build/conv_parts/: the source as it
is ("whole"), without the device-memory loads that form the staged patches
(K9a's z and z_prev, K9b's r: "no_patch_loads"), without the cp.async
copies of W's parts ("no_b_copies"), without the warpgroup MMAs
("no_mma"), without the z / z_prev loads of K9b's epilogue
("no_epilogue_loads"), without its z+ stores ("no_epilogue_stores"),
without its delta and restart partials ("no_partials") and without K9a's
fold ("no_fold"), and with all of these cut at once ("skeleton": the stage
loop's copies and barriers). Each copy's K9a
and K9b are timed in 'f32' and 'bf16' at benchmarks/conv_fused_bench.py's
two widths (256 images 1x32x32 with 64 atoms 7x7, and 64 images 16x32x32
with 256 atoms 5x5) by CUDA events over 20 launches behind about 20 ms of
queued work, and the script prints one JSON line a width with the card's
name and power limit. The cut copies compute wrong results; only their
times mean anything.
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
from lasso_tpu_torch.ops import fused_conv as FC  # noqa: E402

CUTS = {
    "no_patch_loads": [
        ("zv[u][e] = ok ? zo[e * zplane] : 0.f;", "zv[u][e] = 1.f;"),
        ("zpv[u][e] = ok ? zpo[e * zplane] : 0.f;", "zpv[u][e] = 1.f;"),
        ("? __ldg(rrow + (size_t)cx * g.H * g.Wd + cc)", "? 1.f"),
        ("? __ldg(rn + ((size_t)cx * g.H + rr) * g.Wd + cc)", "? 1.f")],
    "no_b_copies": [
        ("        wgp::cp_async16_fill(wgp::smem_addr(dst",
         "        if (0) wgp::cp_async16_fill(wgp::smem_addr(dst")],
    "no_mma": [
        ("          wgp::mma_ss<NT>(acc[i], ah, bh);",
         "          if (0) wgp::mma_ss<NT>(acc[i], ah, bh);"),
        ("            wgp::mma_ss<NT>(acc[i], al, bh);\n"
         "            wgp::mma_ss<NT>(acc[i], ah, bl);",
         "            if (0) wgp::mma_ss<NT>(acc[i], al, bh);\n"
         "            if (0) wgp::mma_ss<NT>(acc[i], ah, bl);")],
    "no_epilogue_loads": [
        ("zv[u] = in ? zs[o] : 0.f;", "zv[u] = 0.f;"),
        ("zpv[u] = in ? zps[o] : 0.f;", "zpv[u] = 0.f;")],
    "no_epilogue_stores": [("        zo[cz * (int)zplane + px] = zn;",
                            "        if (zn == 1.2345f) zo[0] = zn;")],
    "no_partials": [("  if (!restart && delta == nullptr) return;\n",
                     "  return;\n")],
    "no_fold": [("      for (int kj = kj0; kj < kj1; ++kj) {",
                 "      for (int kj = kj0; kj < kj0; ++kj) {")],
}
# what is left when nothing but the stage loop's copies and barriers runs
CUTS["skeleton"] = [c for name in ("no_patch_loads", "no_mma",
                                   "no_epilogue_loads", "no_epilogue_stores",
                                   "no_partials", "no_fold")
                    for c in CUTS[name]]
SHAPES = ((256, 64, 1, 26, 7), (64, 256, 16, 28, 5))   # N, Cz, Cx, Hz, k


def build():
    """{copy: ctypes library}, the copies compiled together."""
    src = open(os.path.join(_cuda.CSRC, "conv.cu")).read()
    out = os.path.join(ROOT, "build", "conv_parts")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name, cuts in {"whole": [], **CUTS}.items():
        text = src
        for old, new in cuts:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} not in csrc/conv.cu")
            text = text.replace(old, new)
        path = os.path.join(out, f"conv_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(out, f"libconv_{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC), "-o",
             lib, path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        libs[name] = ctypes.CDLL(lib)
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
        print("conv_kernel_parts: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    libs = build()
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    for n, cz, cx, hz, k in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(1)
        x = torch.randn(n, cx, hz + k - 1, hz + k - 1, generator=g,
                        device="cuda")
        w = torch.randn(cz, cx, k, k, generator=g, device="cuda") / k
        z = 0.1 * torch.randn(n, cz, hz, hz, generator=g, device="cuda")
        zp = z.clone()
        scal = torch.tensor([0.01, 0.001, 0.3, 1.0], device="cuda")
        r, out = torch.empty_like(x), torch.empty_like(z)
        rpart, dpart, counters = FC.adjoint_scratch(n, cz, hz, hz, "cuda")
        delta = torch.empty(1, device="cuda")
        times = {}
        for name, lib in libs.items():
            for kp in ("f32", "bf16"):
                ops = FC.conv_operands(w, kp)
                fa = getattr(lib, f"conv_decode_resid_{kp}")
                fb = getattr(lib, f"conv_adjoint_prox_{kp}")
                fa.argtypes, fb.argtypes = FC._DECODE_ARGS, FC._ADJOINT_ARGS
                fa.restype = fb.restype = ctypes.c_int

                def k9a():
                    return fa(x.data_ptr(), z.data_ptr(), zp.data_ptr(),
                              ops.wa.data_ptr(), scal.data_ptr(), None,
                              r.data_ptr(), n, cz, cx, hz, hz, k, k, 0,
                              stream())

                def k9b():
                    return fb(r.data_ptr(), z.data_ptr(), zp.data_ptr(),
                              ops.wb.data_ptr(), scal.data_ptr(), None, None,
                              rpart.data_ptr(), dpart.data_ptr(),
                              counters.data_ptr(), out.data_ptr(),
                              delta.data_ptr(), n, cz, cx, hz, hz, k, k, 0,
                              0, rpart.numel(), stream())

                errs = (k9a(), k9b())
                if any(errs):
                    lib.conv_error_string.restype = ctypes.c_char_p
                    raise RuntimeError(
                        f"{name} {kp}: launch failed: " + ", ".join(
                            lib.conv_error_string(e).decode() for e in errs))
                times[f"{name} {kp}"] = {"k9a_ms": round(ms(k9a), 4),
                                         "k9b_ms": round(ms(k9b), 4)}
        print(json.dumps({"card": card, "shape": {"N": n, "Cz": cz,
                                                  "Cx": cx, "Hz": hz,
                                                  "k": k},
                          "times": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
