#!/usr/bin/env python3
"""Where the greedy-CD kernel K3 (cd_steps in lasso_tpu_torch/csrc/cd.cu)
spends its time: it is timed whole and with one part cut out.

Run from the root of the repository on a machine with an NVIDIA card and
the CUDA toolkit:

    python3 scripts/cd_steps_parts.py

It builds copies of csrc/cd.cu into build/cd_steps_parts/: the source as
it is ("whole"), and copies with one part of a tier's kernel cut out. At
the widths timed here (K = 2048 and 1024) K3 takes its register tier
(``cd_steps_reg_kernel``, one sweep a step); the "smem_" copies send it
to the shared-memory tier (``cd_steps_kernel``, two sweeps a step, the
kernel before the register tier) instead. In both tiers:

* "no_scan": the scan of a step (prox, diff and each lane's running first
  maximum) is cut (register tier: the row's next column comes from a
  counter; shared-memory tier: the scan reads only the lane's first
  column);
* "no_reduce": no reduction across the warp (register tier: the next
  column is folded from the lane's chains and lane 0's is taken;
  shared-memory tier: lane 0's candidate);
* "no_gather": no row of S is read (register tier: no bulk copy, the
  update reads the slot as it is; shared-memory tier: a constant);
* "no_update": no update of b;
* "no_io": b and z are neither loaded nor stored (the row starts from
  constants);
* "skeleton": all of these at once (register tier: all but no_gather).

In the register tier's cut copies a row never freezes, so that each runs
its 8 steps.

Each copy's ``cd_steps_f32`` and ``cd_steps_bf16`` is timed at the headline
width (16384 rows, K = 2048) and at the training width (16384 rows, K =
1024), every row active, 8 steps a launch, tol 0 (no row freezes), by CUDA
events over 10 launches after 3, behind about 20 ms of queued work. The
script also measures the card's rate for the S rows' traffic: a kernel of
its own gathers 8 rows of S a row of b (the rows K3 reads, as 16-byte loads
from L2, at the same widths) and sums them, and the rate is those bytes
over its time. It prints ptxas's register and spill lines of the whole
copy and one JSON line a copy with the card's name and power limit. The
cut copies compute wrong results; only their times mean anything.
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

STEPS = 8
WIDTHS = {"headline": (16384, 2048), "training": (16384, 1024)}
# the shared-memory tier's cuts (its kernel, cd_steps_kernel)
SMEM_CUTS = {
    "no_scan": [("    for (int j = lane; j < K; j += 32) {\n"
                 "      const float bv = bs[j];",
                 "    for (int j = lane; j < 32; j += 32) {\n"
                 "      const float bv = bs[j];")],
    "no_reduce": [("    for (int off = 16; off > 0; off >>= 1) {\n"
                   "      const int ou = __shfl_xor_sync(FULL, bu, off);",
                   "    for (int off = 16; off > 16; off >>= 1) {\n"
                   "      const int ou = __shfl_xor_sync(FULL, bu, off);"),
                  ("    const int k = bj;  // every lane",
                   "    const int k = __shfl_sync(FULL, bj, 0);  // every lane")],
    "no_gather": [("        sv[i] = j0 + 32 * i < K ? load_s(srow, j0 + 32 * i) : 0.f;",
                   "        sv[i] = 0.5f;")],
    "no_update": [("    for (int j0 = lane; j0 < K; j0 += 32 * 8) {",
                   "    for (int j0 = lane; j0 < 0; j0 += 32 * 8) {")],
    "no_io": [("    bs[j] = b_in[row + j];\n    zs[j] = z_in[row + j];",
               "    bs[j] = 1e-3f * j;\n    zs[j] = 0.f;"),
              ("    b_out[row + j] = bs[j];\n    z_out[row + j] = zs[j];",
               "    if (bs[j] == 1.2345f) b_out[row + j] = zs[j];")],
}
SMEM_CUTS["skeleton"] = [c for name in ("no_scan", "no_reduce", "no_update",
                                        "no_io") for c in SMEM_CUTS[name]]
TO_SMEM = [("  if (aligned && K % 128 == 0 && K <= 2048) {",
            "  if (false) {")]

# the register tier's cuts (cd_steps_reg_kernel); every copy keeps its
# rows live
NO_FREEZE = [("    if (!(fabsf(dz) > tol_k)) act = 0.f;\n    const bool more",
              "    const bool more")]
REG_SCAN = ("          update_group(m, upd);\n"
            "          scan_group(m);\n        }\n      __syncwarp();\n"
            "      reduce();")
REG_CUTS = {
    "no_scan": [(REG_SCAN,
                 "          update_group(m, upd);\n"
                 "        }\n      __syncwarp();\n"
                 "      k = (k * 1103u + 12345u) % (unsigned)K;")],
    "no_reduce": [(REG_SCAN,
                   "          update_group(m, upd);\n"
                   "          scan_group(m);\n        }\n      __syncwarp();\n"
                   "      k = __shfl_sync(FULL, (unsigned)(bu[0] + bu[1] + "
                   "bu[2] + bu[3] + bm[0] + bm[3]) % (unsigned)K, 0);\n"
                   "      dz = bd[0] + bd[1] + bd[2] + bd[3];")],
    "no_gather": [("      wgp::mbar_expect_tx(bar, (uint32_t)(K * sizeof(ST)));\n"
                   "      wgp::bulk_copy(wgp::smem_addr(slot), S + (size_t)k * K,\n"
                   "                     (uint32_t)(K * sizeof(ST)), bar);",
                   "      wgp::mbar_arrive(bar);")],
    "no_update": [("          update_group(m, upd);\n          scan_group(m);",
                   "          scan_group(m);")],
    "no_io": [("      bv[m] = b4[lane + 32 * m];\n"
               "      zs4[lane + 32 * m] = z4[lane + 32 * m];",
               "      bv[m] = make_float4(1e-3f * m, 2e-3f, 3e-3f, 1e-3f * lane);\n"
               "      zs4[lane + 32 * m] = make_float4(0.f, 0.f, 0.f, 0.f);"),
              ("      bo4[lane + 32 * m] = bv[m];\n"
               "      zo4[lane + 32 * m] = zs4[lane + 32 * m];",
               "      if (bv[m].x == 1.2345f) bo4[0] = zs4[lane + 32 * m];")],
}
REG_CUTS["skeleton"] = (REG_CUTS["no_update"] + [
    ("          scan_group(m);\n        }\n      __syncwarp();\n"
     "      reduce();",
     "        }\n      __syncwarp();\n"
     "      k = (k * 1103u + 12345u) % (unsigned)K;")] + REG_CUTS["no_io"])
CUTS = {**{name: NO_FREEZE + cuts for name, cuts in REG_CUTS.items()},
        "smem_whole": TO_SMEM,
        **{f"smem_{name}": TO_SMEM + cuts
           for name, cuts in SMEM_CUTS.items()}}

# the rows of S that K3 gathers, alone: a warp a row of b, 8 rows of S a
# row, each read by 16-byte loads and summed
GATHER_SRC = r"""
#include <cuda_runtime.h>
__global__ void gather_rows(const float4* __restrict__ S,
                            const int* __restrict__ ks, int K4, int steps,
                            int N, float* __restrict__ out) {
  const int n = blockIdx.x * 4 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (n >= N) return;
  float acc = 0.f;
  for (int s = 0; s < steps; ++s) {
    const float4* row = S + (size_t)ks[n * steps + s] * K4;
    for (int j = lane; j < K4; j += 32) {
      const float4 v = row[j];
      acc += v.x + v.y + v.z + v.w;
    }
  }
  out[n * 32 + lane] = acc;
}
extern "C" int gather(const void* S, const int* ks, int K, int steps, int N,
                      float* out, void* stream) {
  gather_rows<<<(N + 3) / 4, 128, 0, (cudaStream_t)stream>>>(
      (const float4*)S, ks, K / 4, steps, N, out);
  return (int)cudaGetLastError();
}
"""


def build():
    """{copy: ctypes library}, the copies compiled together, and the
    gather kernel's library."""
    src = open(os.path.join(_cuda.CSRC, "cd.cu")).read()
    out = os.path.join(ROOT, "build", "cd_steps_parts")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name, cuts in {"whole": [], **CUTS}.items():
        s = src
        for old, new in cuts:
            if s.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in csrc/cd.cu "
                                   f"once")
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
    cu = os.path.join(out, "gather.cu")
    with open(cu, "w") as f:
        f.write(GATHER_SRC)
    so = os.path.join(out, "libgather.so")
    procs["gather"] = (subprocess.Popen(
        [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", so, cu],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
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
        if name == "gather":
            lib.gather.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 \
                + [ctypes.c_void_p] * 2
            lib.gather.restype = ctypes.c_int
        else:
            for kp in ("f32", "bf16"):
                fn = getattr(lib, f"cd_steps_{kp}")
                fn.argtypes = C.CD_STEPS[kp].argtypes
                fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def timed(launch, reps=10):
    """Mean card time of ``launch`` over ``reps`` launches after 3, behind
    about 20 ms of queued work."""
    for _ in range(3):
        launch()
    a = torch.full((8192, 8192), 1e-3, device="cuda")
    torch.matmul(a, a)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        launch()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def main():
    if not torch.cuda.is_available():
        print("cd_steps_parts: no CUDA device", file=sys.stderr)
        return 1
    libs = build()
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    times = {name: {} for name in libs}
    stream = _cuda.stream()
    for width, (n, k) in WIDTHS.items():
        g = torch.Generator(device=dev).manual_seed(1)
        W = torch.randn(k // 4, k, generator=g, device=dev)
        W = W / W.norm(dim=0)
        S32 = torch.eye(k, device=dev) - W.T @ W
        S = {"f32": S32, "bf16": S32.to(torch.bfloat16)}
        b = torch.randn(n, k, generator=g, device=dev)
        z = torch.zeros(n, k, device=dev)
        act = torch.ones(n, 1, device=dev)
        b_out, z_out = torch.empty_like(b), torch.empty_like(z)
        act_out = torch.empty_like(act)
        for name, lib in libs.items():
            if name == "gather":
                continue
            for kp in ("f32", "bf16"):
                fn = getattr(lib, f"cd_steps_{kp}")

                def launch():
                    err = fn(b.data_ptr(), z.data_ptr(), act.data_ptr(),
                             S[kp].data_ptr(), None, 0.1, 0.0, 1.0, 0,
                             b_out.data_ptr(), z_out.data_ptr(),
                             act_out.data_ptr(), n, k, STEPS, stream)
                    if err != 0:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                times[name][f"{width}_{kp}_ms"] = round(timed(launch), 4)
        # the S rows alone: the rows the whole kernel picks are not known
        # here, so each row of b gathers 8 rows drawn at random
        ks = torch.randint(0, k, (n * STEPS,), generator=g, device=dev,
                           dtype=torch.int32)
        out = torch.empty(n * 32, device=dev)
        for kp in ("f32", "bf16"):
            # bf16 rows are K / 2 floats: the same bytes as K / 2 f32
            kk = k if kp == "f32" else k // 2

            def launch():
                err = libs["gather"].gather(S[kp].data_ptr(), ks.data_ptr(),
                                            kk, STEPS, n, out.data_ptr(),
                                            stream)
                if err != 0:
                    raise RuntimeError(f"gather: CUDA error {err}")
            ms = timed(launch)
            nbytes = n * STEPS * kk * 4
            times["gather"][f"{width}_{kp}_ms"] = round(ms, 4)
            times["gather"][f"{width}_{kp}_tb_per_s"] = round(
                nbytes / ms / 1e9, 3)
    for name, t in times.items():
        print(json.dumps({"copy": name, **t, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
