#!/usr/bin/env python3
"""Where the fused OMP step K6b (lasso_tpu_torch/csrc/omp.cu, the streamed
``omp_orth`` kernel) spends its time: it is timed whole and with one part
cut out, at steps 0, 32 and 63 of one f32 solve.

Run from the root of the repository on a machine with an NVIDIA card and
the CUDA toolkit:

    python3 scripts/omp_kernel_parts.py

It builds copies of csrc/omp.cu into build/omp_parts/: the source as it is
("whole"); the two timing bodies of the JAX package's fused OMP kernel
(lasso_tpu/ops/fused_omp.py, ``profile=``), as cuts of K6b:
"select_only" (:136, the selection product and the first maximum only:
K6b stops once it has written idx, valid and the mask, and the script adds
K6a's time) and "no_gs" (:147, the whole step with the projection
coefficients zero: no Gram-Schmidt chain and no copies of Q); then
"no_q_copies" (the chain runs on whatever its ring holds: no bulk copies
of Q, no waits), "no_reduce" (each dot product left unreduced across the
warp) and "no_outputs" (no stores of q_k, r and r's split), and
"skeleton" (no_gs and no_outputs at once: r's read, the partials, the
atom's gather and the small stores). The states come from the whole
kernel: step k's state is built by the package's own kernels, then each
copy's K6b is launched on it 10 times by CUDA events around each launch,
behind about 20 ms of queued work, with r and the active flags put back
between launches. It prints one JSON line a step with the card's name and
power limit, at benchmarks/omp_fused_bench.py's problem (16384x512->2048,
T=64). The cut copies compute wrong results; only their times mean
anything.
"""

import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from lasso_tpu_torch.ops import _cuda  # noqa: E402
from lasso_tpu_torch.ops import fused_omp as O  # noqa: E402

N, D, K, T = 16384, 512, 2048, 64
STEPS = (0, 32, 63)
COPIES = ("      bulk_row(ring + (uint32_t)(t * D * sizeof(float)), "
          "qn + (size_t)t * D,")
REFILL = "    if (lane == 0 && t + S < k) {"
CHAIN = "  for (int t = 0; t < k; ++t) {\n    wgp::mbar_wait"
CUTS = {
    "select_only": [
        (COPIES, "      if (0) bulk_row(ring + (uint32_t)(t * D * "
                 "sizeof(float)), qn + (size_t)t * D,"),
        ("  if (!act) {\n#pragma unroll", "  return;\n  if (!act) {\n"
                                          "#pragma unroll")],
    "no_gs": [
        (COPIES, "      if (0) bulk_row(ring + (uint32_t)(t * D * "
                 "sizeof(float)), qn + (size_t)t * D,"),
        (CHAIN, "  for (int t = 0; t < 0; ++t) {\n    wgp::mbar_wait")],
    "no_q_copies": [
        (COPIES, "      if (0) bulk_row(ring + (uint32_t)(t * D * "
                 "sizeof(float)), qn + (size_t)t * D,"),
        ("    wgp::mbar_wait(bars + 8 * ts, phase);\n", ""),
        (REFILL, "    if (0) {")],
    "no_reduce": [("    cf = warp_sum(cf);\n#pragma unroll",
                   "#pragma unroll")],
    "no_outputs": [
        ("    qk4[lane + 32 * m] = wv[m];\n", ""),
        ("    rn4[lane + 32 * m] = v;\n",
         "    if (v.x == 1.2345f) rn4[0] = v;\n"),
        ("    hi2[lane + 32 * m] =", "    if (v.x == 1.2345f) hi2[0] ="),
        ("    lo2[lane + 32 * m] =", "    if (v.y == 1.2345f) lo2[0] =")],
}
# what is left with neither the chain nor the big stores
CUTS["skeleton"] = CUTS["no_gs"] + CUTS["no_outputs"]


def build():
    """{copy: ctypes library}, the copies compiled together."""
    src = open(os.path.join(_cuda.CSRC, "omp.cu")).read()
    out = os.path.join(ROOT, "build", "omp_parts")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name, cuts in {"whole": [], **CUTS}.items():
        text = src
        for old, new in cuts:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in csrc/omp.cu "
                                   f"once")
            text = text.replace(old, new)
        path = os.path.join(out, f"omp_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(out, f"libomp_{name}.so")
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
        libs[name].omp_orth.argtypes = O._ORTH_ARGS
        libs[name].omp_orth.restype = ctypes.c_int
    return libs


def launch_ms(fn, restore, reps=10):
    """Mean card time of ``fn`` over ``reps`` launches, each between two
    events, with ``restore`` run between launches (outside the events)."""
    fn()
    restore()
    a = torch.full((8192, 8192), 1e-3, device="cuda")
    torch.matmul(a, a)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2 * reps)]
    for i in range(reps):
        ev[2 * i].record()
        err = fn()
        ev[2 * i + 1].record()
        if err:
            raise RuntimeError(f"omp_orth: CUDA error {err}")
        restore()
    torch.cuda.synchronize()
    return sum(ev[2 * i].elapsed_time(ev[2 * i + 1])
               for i in range(reps)) / reps


def main():
    if not torch.cuda.is_available():
        print("omp_kernel_parts: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    libs = build()
    rng = np.random.default_rng(0)   # benchmarks/omp_fused_bench.py's draw
    W = rng.standard_normal((D, K)).astype(np.float32)
    W /= np.linalg.norm(W, axis=0, keepdims=True)
    x = rng.standard_normal((N, D)).astype(np.float32)
    x, W = torch.from_numpy(x).cuda(), torch.from_numpy(W).cuda()
    invn, wt = O.inverse_norms(W), W.T.contiguous()
    wsplit = O.select_operands(W)
    st = O.omp_init_state(x, K, T)
    stream = torch.cuda.current_stream().cuda_stream
    tol = O._tol(None)
    for k in range(T):
        O.omp_select(st, wsplit, invn)
        if k in STEPS:
            r0, active0 = st.r.clone(), st.active.clone()

            def restore():
                st.r.copy_(r0)
                st.active.copy_(active0)

            k6a = launch_ms(lambda: O.omp_select(st, wsplit, invn), restore)
            times = {}
            for name, lib in libs.items():
                def k6b(lib=lib):
                    return lib.omp_orth(
                        st.pval.data_ptr(), st.pidx.data_ptr(),
                        st.pval.shape[1], wt.data_ptr(), st.r.data_ptr(),
                        st.Q.data_ptr(), st.R.data_ptr(), st.d.data_ptr(),
                        st.idx.data_ptr(), st.valid.data_ptr(),
                        st.active.data_ptr(), st.sel.data_ptr(),
                        st.rb.data_ptr(), tol, k, N, D, K, T, stream)
                times[name] = round(launch_ms(k6b, restore), 4)
            times["select_only"] = round(times["select_only"] + k6a, 4)
            print(json.dumps({"card": card, "width": f"{N}x{D}->{K}",
                              "step": k, "k6a_ms": round(k6a, 4),
                              "k6b_ms": times,
                              "note": "select_only is K6a plus K6b cut "
                                      "after the selection"}), flush=True)
            restore()
        O.omp_orth(st, wt, k)
    return 0


if __name__ == "__main__":
    sys.exit(main())
