#!/usr/bin/env python3
"""Where the fused OMP steps K6b (``omp_orth``) and K6d (``omp_orth_cgs2``)
of lasso_tpu_torch/csrc/omp.cu spend their time: each is timed whole and
with one part cut out, at steps 0, 32 and 63 of one f32 solve.

Run from the root of the repository on a machine with an NVIDIA card and
the CUDA toolkit:

    python3 scripts/omp_kernel_parts.py [--kernels k6b|k6d|k6c|all]

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
K6c (``omp_backsub``) is timed on the solve's final state (after step
63), whole and with a part cut out, 10 launches each. Its staged kernel
(T <= 128): whole; with each warp copying its first sample's columns
again and again ("k6c_staged_cols_from_cache": the copies hit L2);
without the chains ("no_chain": the copies, d's loads and z's stores);
with the columns copied for the first sample only and every later chain
run on them ("copy_once": the chains alone), and that without the
shuffle of rhs_{j-2} ("copy_once_no_shfl"), with a product for the divide
("copy_once_no_div") or without the lanes' updates of their rows
("copy_once_no_updates"); with neither copies nor chains ("io_only", the
skeleton).
The "k6c_warp_" copies send T = 64 to its kept warp kernel (the first
kernel, taken past T = 128: a warp a sample, each column read from device
memory on the chain): whole, with the chain's divides and updates on
constant operands ("no_col_reads": the chain's arithmetic, shared memory
and barriers alone), with every sample reading sample 0's columns
("cols_from_cache": the chain's loads hit the caches) and with no chain
("io_only": d read, z written).

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
# K6c's copies, each timed through omp_backsub on the final state
K6C_WARP_CHAIN = ("  for (int t = lane; t < T; t += 32) "
                  "rhs[t] = d[(size_t)n * T + t];\n"
                  "  __syncwarp();\n"
                  "  for (int j = T - 1; j >= 0; --j) {\n"
                  "    const float* col = R + ((size_t)n * T + j) * T;\n")
K6C_NO_CHAIN = ("  for (int mj = RP - 1; mj >= 0; --mj)\n#pragma unroll",
                "  for (int mj = RP - 1; mj >= RP; --mj)\n#pragma unroll")
# the chain's parts: the shuffle of rhs_{j-2} (each lane takes its own
# register), the divide (a product) and the lanes' updates of their rows
K6C_NO_SHFL = ("        pre = __shfl_sync(0xffffffffu, rhs[(j - 2) / 32], "
               "(j - 2) % 32);", "        pre = rhs[(j - 2) / 32];")
K6C_NO_DIV = ("      const float zj = __fdiv_rn(cur, col[j]);",
              "      const float zj = __fmul_rn(cur, col[j]);")
K6C_NO_UPDATES = [
    ("        rhs[m] = __fsub_rn(rhs[m], __fmul_rn(zj, col[32 * m + "
     "lane]));", "        rhs[m] = rhs[m];"),
    ("        rhs[mj] = __fsub_rn(rhs[mj], __fmul_rn(zj, col[32 * mj + "
     "lane]));", "        rhs[mj] = rhs[mj];")]
# each warp copies its first sample only and runs every later chain on it:
# the chains without the copies
K6C_COPY_ONCE = [
    ("    stage(n + gridDim.x);", "    if (t < 0) stage(n + gridDim.x);"),
    ("      wgp::mbar_wait(bar, t & 1);",
     "      if (t < 1) wgp::mbar_wait(bar, t & 1);")]
# each warp copies its first sample's columns again and again (2 MB in
# all, so the copies hit L2)
K6C_FROM_CACHE = ("    const float* Rn = R + (size_t)n * T * T;\n"
                  "    if (VEC == 4) {",
                  "    const float* Rn = R + (size_t)blockIdx.x * T * T;\n"
                  "    if (VEC == 4) {")
K6C_NO_COPIES = [
    ("      for (int j = lane; j < T; j += 32)   // column j,",
     "      for (int j = lane; j < 0; j += 32)   // column j,"),
    ("      if (lane == 0)\n        wgp::mbar_expect_tx(",
     "      if (lane == 0) wgp::mbar_arrive(bar);\n      if (false)\n"
     "        wgp::mbar_expect_tx(")]
# T = 64 to the warp kernel
TO_WARP = [("  if (T <= 128) {\n    if (T % 4 == 0",
            "  if (false) {\n    if (T % 4 == 0")]
BACKSUB_CUTS = {
    "k6c_staged_whole": [],
    "k6c_staged_cols_from_cache": [K6C_FROM_CACHE],
    "k6c_staged_no_chain": [K6C_NO_CHAIN],
    "k6c_staged_copy_once": K6C_COPY_ONCE,
    "k6c_staged_copy_once_no_shfl": K6C_COPY_ONCE + [K6C_NO_SHFL],
    "k6c_staged_copy_once_no_div": K6C_COPY_ONCE + [K6C_NO_DIV],
    "k6c_staged_copy_once_no_updates": K6C_COPY_ONCE + K6C_NO_UPDATES,
    "k6c_staged_io_only": K6C_NO_COPIES + [K6C_NO_CHAIN],
    "k6c_warp_whole": [],
    "k6c_warp_no_col_reads": [
        ("    const float zj = __fdiv_rn(rhs[j], col[j]);",
         "    const float zj = __fdiv_rn(rhs[j], 1.5f + (float)j);"),
        ("      rhs[i] = __fsub_rn(rhs[i], __fmul_rn(zj, col[i]));",
         "      rhs[i] = __fsub_rn(rhs[i], __fmul_rn(zj, 0.5f));")],
    "k6c_warp_cols_from_cache": [
        ("    const float* col = R + ((size_t)n * T + j) * T;",
         "    const float* col = R + (size_t)j * T;")],
    "k6c_warp_io_only": [
        (K6C_WARP_CHAIN, K6C_WARP_CHAIN.replace(
            "  __syncwarp();\n",
            "  __syncwarp();\n"
            "  for (int t = lane; t < T; t += 32) z[(size_t)n * T + t] = "
            "rhs[t];\n  return;\n"))],
}
BACKSUB_CUTS = {name: (TO_WARP if name.startswith("k6c_warp_") else [])
                + cuts for name, cuts in BACKSUB_CUTS.items()}
SWEEPS = ("cgs2_no_dots1", "cgs2_no_update1", "cgs2_no_dots2",
          "cgs2_no_update2")


def build(kernels):
    """{copy: ctypes library}, the copies of ``kernels`` ('k6b', 'k6d',
    'k6c' or 'all') compiled together."""
    src = open(os.path.join(_cuda.CSRC, "omp.cu")).read()
    out = os.path.join(ROOT, "build", "omp_parts")
    os.makedirs(out, exist_ok=True)
    procs = {}
    copies = {}
    if kernels in ("k6b", "all"):
        copies.update({"whole": [], **CUTS})
    if kernels in ("k6d", "all"):
        copies.update({"whole": [], **CGS2_CUTS})
    if kernels in ("k6c", "all"):
        copies.update(BACKSUB_CUTS)
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
        libs[name].omp_backsub.argtypes = O.OMP_BACKSUB.argtypes
        libs[name].omp_backsub.restype = ctypes.c_int
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
            raise RuntimeError(f"CUDA error {err}")
        restore()
    torch.cuda.synchronize()
    return sum(ev[2 * i].elapsed_time(ev[2 * i + 1])
               for i in range(reps)) / reps


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", choices=("k6b", "k6d", "k6c", "all"),
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
        if k in STEPS and kernels != "k6c":
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
                if kernels in ("k6d", "all") and (name == "whole"
                                                  or name in CGS2_CUTS):
                    cgs2[name] = round(launch_ms(
                        lambda: orth(lib.omp_orth_cgs2), restore), 4)
                if kernels in ("k6b", "all") and (name == "whole"
                                                  or name in CUTS):
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
    if kernels in ("k6c", "all"):
        z = torch.empty_like(st.d)
        times = {}
        for name in BACKSUB_CUTS:
            def back(lib=libs[name]):
                return lib.omp_backsub(st.R.data_ptr(), st.d.data_ptr(),
                                       st.valid.data_ptr(), z.data_ptr(), N,
                                       T, stream)
            times[name] = round(launch_ms(back, lambda: None), 4)
        print(json.dumps({"card": card, "width": f"{N}x{D}->{K}",
                          "T": T, "kernel": "omp_backsub",
                          "k6c_ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
