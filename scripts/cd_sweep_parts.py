#!/usr/bin/env python3
"""Where the cyclic-CD sweep kernel K4 (cd_mod_sweep in
lasso_tpu_torch/csrc/cd.cu) spends its time: it is timed whole and with one
part cut out.

Run from the root of the repository on a machine with an NVIDIA card and
the CUDA toolkit:

    python3 scripts/cd_sweep_parts.py

It builds copies of csrc/cd.cu into build/cd_parts/: the source as it is
("whole"), without the chunk's dot products P = R W_c ("no_product1"),
without the per-row recurrence ("no_recurrence"), without the rank-16
correction R += C W_c^T ("no_product2"), without the bulk copies of the
next chunk's atoms ("no_w_copies"), without the wait for them
("no_w_wait"), without the stores of the chunk's codes ("no_code_stores"),
and with all of these but the wait cut at once ("skeleton": the chunk
loop's barriers and the small copies). Each copy's sweep (the
prologue included) is timed at the headline width (16384x512->2048) and at the
training width (16384x256->1024), every row live, by CUDA events over 10
launches behind about 20 ms of queued work. The script prints ptxas's
register and spill lines of the whole copy and one JSON line a copy with
the card's name and power limit. The cut copies compute wrong results;
only their times mean anything.
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
from lasso_tpu_torch.ops import fused_cd as C  # noqa: E402

CUTS = {
    "no_product1": [
        ("      for (int a0 = 0; a0 < SW_TJ; a0 += 4) {\n"
         "        float acc[4 * SW_RW];",
         "      for (int a0 = 0; a0 < 0; a0 += 4) {\n"
         "        float acc[4 * SW_RW];")],
    "no_recurrence": [("    if (warp < SW_BM / 32) {\n      // the row's dots",
                       "    if (warp < 0) {\n      // the row's dots")],
    "no_product2": [
        ("      for (int a0 = 0; a0 < SW_TJ; a0 += 4) {\n"
         "        float4 cv[SW_RW];",
         "      for (int a0 = 0; a0 < 0; a0 += 4) {\n"
         "        float4 cv[SW_RW];")],
    "no_w_copies": [   # the barrier then expects no bytes
        ("          mbar_expect_tx(bar, (uint32_t)(rows * D * 4));\n"
         "          for (int a = 0; a < rows; ++a)",
         "          mbar_expect_tx(bar, 0u);\n"
         "          for (int a = 0; a < 0; ++a)")],
    "no_w_wait": [("    if (Q > 0 && bulk)\n      wgp::mbar_wait(",
                   "    if (0)\n      wgp::mbar_wait(")],
    "no_code_stores": [("      if (lv[r] && j0 + j < K)\n",
                        "      if (0)\n")],
}
CUTS["skeleton"] = [c for name, cuts in CUTS.items() for c in cuts
                    if name != "no_w_wait"]
WIDTHS = {"headline": (16384, 512, 2048), "training": (16384, 256, 1024)}
ARGTYPES = C.CD_MOD_SWEEP.argtypes


def build():
    """{copy: ctypes library}, the copies compiled together."""
    src = open(os.path.join(_cuda.CSRC, "cd.cu")).read()
    out = os.path.join(ROOT, "build", "cd_parts")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name, cuts in {"whole": [], **CUTS}.items():
        s = src
        for old, new in cuts:
            if old not in s:
                raise RuntimeError(f"{name}: cut not found: {old!r}")
            s = s.replace(old, new)
        cu = os.path.join(out, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(s)
        so = os.path.join(out, f"lib{name}.so")
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC),
               *(["-Xptxas", "-v"] if name == "whole" else []), "-o", so, cu]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    libs = {}
    for name, (p, so) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        if name == "whole":
            for line in log.splitlines():
                if ("registers" in line or "spill" in line
                        or "Compiling" in line):
                    print(f"ptxas: {line.strip()}")
        lib = ctypes.CDLL(so)
        lib.cd_mod_sweep.argtypes = ARGTYPES
        lib.cd_mod_sweep.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main():
    if not torch.cuda.is_available():
        print("cd_sweep_parts: no CUDA device", file=sys.stderr)
        return 1
    libs = build()
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    times = {name: {} for name in libs}
    for width, (n, d, k) in WIDTHS.items():
        g = torch.Generator(device=dev).manual_seed(1)
        x = torch.randn(n, d, generator=g, device=dev)
        W = torch.randn(d, k, generator=g, device=dev)
        W = W / W.norm(dim=0)
        z = torch.randn(n, k, generator=g, device=dev) * (
            torch.rand(n, k, generator=g, device=dev) < 0.05)
        R = x - z @ W.T
        wt, nrm = W.T.contiguous(), (W * W).sum(0)
        act = torch.ones(n, device=dev)
        gram = torch.empty(libs["whole"].cd_mod_gram_floats(k), device=dev)
        z_out, R_out = torch.empty_like(z), torch.empty_like(R)
        zmax, dzmax = torch.empty(n, device=dev), torch.empty(n, device=dev)
        for name, lib in libs.items():
            def launch():
                err = lib.cd_mod_sweep(
                    z.data_ptr(), R.data_ptr(), act.data_ptr(),
                    wt.data_ptr(), nrm.data_ptr(), 0.1, 0.0,
                    gram.data_ptr(), z_out.data_ptr(), R_out.data_ptr(),
                    zmax.data_ptr(), dzmax.data_ptr(), n, d, k,
                    _cuda.stream())
                if err != 0:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            for _ in range(3):
                launch()
            a = torch.full((8192, 8192), 1e-3, device=dev)
            torch.matmul(a, a)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(10):
                launch()
            e1.record()
            torch.cuda.synchronize()
            times[name][width] = e0.elapsed_time(e1) / 10
    for name, t in times.items():
        print(json.dumps({"copy": name, **{f"{w}_ms": v
                                          for w, v in t.items()},
                          "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
