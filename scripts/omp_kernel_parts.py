#!/usr/bin/env python3
"""Where the fused OMP steps K6b (``omp_orth``) and K6d (``omp_orth_cgs2``)
of lasso_tpu_torch/csrc/omp.cu spend their time: each is timed whole and
with one part cut out, at steps 0, 32 and 63 of one f32 solve.

Run from the root of the repository on a machine with an NVIDIA card and
the CUDA toolkit:

    python3 scripts/omp_kernel_parts.py [--kernels k6b|k6d|all]

It builds copies of csrc/omp.cu into build/omp_parts/: the source as it is
("whole") and copies with one part cut out. K6b (the streamed kernel): the
two timing bodies of the JAX package's fused OMP kernel
(lasso_tpu/ops/fused_omp.py, ``profile=``), as cuts of K6b: "select_only"
(:136, the selection product and the first maximum only: K6b stops once it
has written idx, valid and the mask, and the script adds K6a's time) and
"no_gs" (:147, the whole step with the projection coefficients zero: no
Gram-Schmidt chain and no copies of Q); then "no_q_copies" (the chain runs
on whatever its ring holds: no bulk copies of Q, no waits), "no_reduce"
(each dot product left unreduced across the warp) and "no_outputs" (no
stores of q_k, r and r's split), and "skeleton" (no_gs and no_outputs at
once: r's read, the partials, the atom's gather and the small stores).

K6d at this width takes its resident kernel (``omp_orth_cgs2_block_kernel``):
one copy without each of its four sweeps over the live rows ("cgs2_no_
dots1", "cgs2_no_update1", "cgs2_no_dots2", "cgs2_no_update2": the
coefficients or the new w are then whatever memory holds), "cgs2_no_row_
copies" (no bulk copies of the resident rows: the sweeps read whatever
shared memory holds), "cgs2_q_from_cache" (every sample reads sample 0's
rows: Q comes from L2, not from device memory) and "cgs2_all_resident"
(room for every live row, so one block an SM at the late steps in place of
two, the rows past 55 no longer read from global memory). The "kept_"
copies send K6d to its warp kernel (``omp_orth_kernel<true>``, the kernel
before the resident one, which reads the live rows from global memory in
each of the four sweeps) and cut its second pass ("kept_no_pass2"), both
passes' dot sweeps ("kept_no_dots"), both update sweeps ("kept_no_
updates"), or read sample 0's rows ("kept_q_from_cache").

The states come from the package's own kernels: step k's state is built by
the MGS solve, then each copy's kernel is launched on it 10 times by CUDA
events around each launch, behind about 20 ms of queued work, with r and
the active flags put back between launches. It prints one JSON line a step
with the card's name and power limit, at benchmarks/omp_fused_bench.py's
problem (16384x512->2048, T=64), and for K6d one line a sweep and step:
the time without that sweep and what the whole kernel spends beyond it.
The cut copies compute wrong results; only their times mean anything.
"""

import argparse
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
        # in K6b and in K6d's resident kernel; this copy times K6b only
        ("    qk4[lane + 32 * m] = wv[m];\n", "", 2),
        ("    rn4[lane + 32 * m] = v;\n",
         "    if (v.x == 1.2345f) rn4[0] = v;\n"),
        ("    hi2[lane + 32 * m] =", "    if (v.x == 1.2345f) hi2[0] ="),
        ("    lo2[lane + 32 * m] =", "    if (v.y == 1.2345f) lo2[0] =")],
}
# what is left with neither the chain nor the big stores
CUTS["skeleton"] = CUTS["no_gs"] + CUTS["no_outputs"]
# K6d's copies, each timed through omp_orth_cgs2: the resident kernel's
# four sweeps over the sample's live rows of Q (pass 1's dot products and
# update, pass 2's), its row copies and where Q comes from
CGS2_CUTS = {
    "cgs2_no_dots1": [("  dots(c1, true);\n", "")],
    "cgs2_no_update1": [("  update(c1);\n", "")],
    "cgs2_no_dots2": [("  dots(c2, false);\n", "")],
    "cgs2_no_update2": [("  update(c2);\n  if (warp != 0) return;",
                         "  if (warp != 0) return;")],
    "cgs2_no_row_copies": [
        ("          bulk_row(rows_a + (uint32_t)(t0 * D * sizeof(float)),\n"
         "                   qn + (size_t)t0 * D, nr * D * sizeof(float),\n"
         "                   bars + 8 * c);",
         "          wgp::mbar_arrive(bars + 8 * c);")],
    "cgs2_q_from_cache": [
        ("  const float* qn = q + (size_t)n * T * D;\n\n  // warp 0:",
         "  const float* qn = q;\n\n  // warp 0:")],
    "cgs2_all_resident": [("constexpr int CGS2_BLOCK_SMEM = 113 * 1024;",
                           "constexpr int CGS2_BLOCK_SMEM = 226 * 1024;")],
}
# K6d's warp kernel, the one it keeps for other D
TO_KEPT = [("  if (!vector_tier(wt, r, q, rb, D))\n"
            "    return launch_orth<true>(", "  if (true)\n"
            "    return launch_orth<true>(")]
KEPT_CUTS = {
    "kept_no_pass2": [("    cgs_pass(qn, w, c2, k, D, lane);\n", "")],
    "kept_no_dots": [
        ("  for (; t + 4 <= k; t += 4) {", "  for (; t + 4 <= 0; t += 4) {"),
        ("  for (; t < k; ++t) {\n    const float* qt",
         "  for (; t < 0; ++t) {\n    const float* qt")],
    "kept_no_updates": [
        ("    for (int u = 0; u < k; ++u) s = fmaf(c[u]",
         "    for (int u = 0; u < 0; ++u) s = fmaf(c[u]")],
    # every sample reads sample 0's rows: Q from the caches, not from
    # device memory
    "kept_q_from_cache": [
        ("  const float* qn = q + (size_t)n * T * D;\n  if (CGS2) {",
         "  const float* qn = q;\n  if (CGS2) {")],
}
CGS2_CUTS.update({"kept_whole": TO_KEPT,
                  **{name: TO_KEPT + cuts
                     for name, cuts in KEPT_CUTS.items()}})
SWEEPS = ("cgs2_no_dots1", "cgs2_no_update1", "cgs2_no_dots2",
          "cgs2_no_update2")


def build(kernels):
    """{copy: ctypes library}, the copies of ``kernels`` ('k6b', 'k6d' or
    'all') compiled together."""
    src = open(os.path.join(_cuda.CSRC, "omp.cu")).read()
    out = os.path.join(ROOT, "build", "omp_parts")
    os.makedirs(out, exist_ok=True)
    procs = {}
    copies = {"whole": [], **(CUTS if kernels != "k6d" else {}),
              **(CGS2_CUTS if kernels != "k6b" else {})}
    for name, cuts in copies.items():
        text = src
        for old, new, *times in cuts:   # (old, new[, occurrences])
            if text.count(old) != (times[0] if times else 1):
                raise RuntimeError(f"{name}: {old!r} is not in csrc/omp.cu "
                                   f"{times[0] if times else 1} time(s)")
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
        for entry in ("omp_orth", "omp_orth_cgs2"):
            getattr(libs[name], entry).argtypes = O._ORTH_ARGS
            getattr(libs[name], entry).restype = ctypes.c_int
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
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", choices=("k6b", "k6d", "all"),
                    default="all", help="the kernels whose copies to time")
    kernels = ap.parse_args().kernels
    if not torch.cuda.is_available():
        print("omp_kernel_parts: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    libs = build(kernels)
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
            times, cgs2 = {}, {}
            for name, lib in libs.items():
                def orth(fn):
                    return fn(
                        st.pval.data_ptr(), st.pidx.data_ptr(),
                        st.pval.shape[1], wt.data_ptr(), st.r.data_ptr(),
                        st.Q.data_ptr(), st.R.data_ptr(), st.d.data_ptr(),
                        st.idx.data_ptr(), st.valid.data_ptr(),
                        st.active.data_ptr(), st.sel.data_ptr(),
                        st.rb.data_ptr(), tol, k, N, D, K, T, stream)
                if kernels != "k6b" and (name == "whole"
                                         or name in CGS2_CUTS):
                    cgs2[name] = round(launch_ms(
                        lambda: orth(lib.omp_orth_cgs2), restore), 4)
                if kernels != "k6d" and name not in CGS2_CUTS:
                    times[name] = round(launch_ms(
                        lambda: orth(lib.omp_orth), restore), 4)
            if "select_only" in times:
                times["select_only"] = round(times["select_only"] + k6a, 4)
            print(json.dumps({"card": card, "width": f"{N}x{D}->{K}",
                              "step": k, "k6a_ms": round(k6a, 4),
                              "k6b_ms": times, "k6d_ms": cgs2,
                              "note": "select_only is K6a plus K6b cut "
                                      "after the selection"}), flush=True)
            for name in SWEEPS if cgs2 else ():
                print(json.dumps({
                    "card": card, "step": k, "kernel": "omp_orth_cgs2",
                    "sweep": name[len("cgs2_no_"):],
                    "ms_without": cgs2[name],
                    "whole_less_without_ms": round(
                        cgs2["whole"] - cgs2[name], 4)}), flush=True)
            restore()
        O.omp_orth(st, wt, k)
    return 0


if __name__ == "__main__":
    sys.exit(main())
