"""Build, load and count the port's hand-written CUDA kernels.

Each library ``<name>`` is one source ``lasso_tpu_torch/csrc/<name>.cu``
with a plain C interface. At its first use ``nvcc`` compiles it for
``sm_90a`` into ``build/`` at the repository root, under a name that
carries a hash of the sources and flags (so a changed source builds anew
and an unchanged one is reused across processes), and ``ctypes`` loads
it. Nothing is built or loaded when a module is imported.

A :class:`CudaKernel` is one C entry of such a library. It counts its
launches in the plain integer attribute ``launches``: one per launch, and
nowhere else. ``WRAPPER_CALLS`` counts the calls of the Python functions
that issue them (such as one ``fused_fista_multistep`` call, which
launches two kernels per sub-step, or one ``fused_group_fista_multistep``
call, which launches three) when they take the CUDA route, and, as
``batch_cholesky_solve_lu``, the batches that ``batch_cholesky_solve``
sent to its LU fallback on the card.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libraries = {}
KERNELS = []
WRAPPER_CALLS = collections.Counter()


def _nvcc():
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return nvcc


def library_path(name):
    """Where library ``name`` is built: named by a hash of its source, the
    shared headers and the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names, ptxas_verbose=False):
    """Compile the libraries ``names`` that are not built yet, one ``nvcc``
    per source, all started together. Returns ``{name: compiler output}``
    for the sources compiled now; raises if any compile fails."""
    BUILD.mkdir(exist_ok=True)
    procs = {}
    for name in names:
        path = library_path(name)
        if path.exists():
            continue
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_verbose
                                       else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    logs, failed = {}, []
    for name, (proc, tmp, path) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n"
                          f"{logs[name]}")
        else:
            os.replace(tmp, path)   # atomic: a concurrent build is harmless
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return logs


def load(name):
    """The ctypes handle of library ``name``, built at first use."""
    lib = _libraries.get(name)
    if lib is None:
        build([name])
        lib = _libraries[name] = ctypes.CDLL(str(library_path(name)))
    return lib


class CudaKernel:
    """One C entry ``symbol`` of library ``library``.

    ``argtypes`` are the ctypes of its arguments: ``c_void_p`` for every
    pointer and for the stream, ``c_int`` for every int. The entry returns
    ``cudaGetLastError()``; a nonzero code raises. Calling it launches the
    kernel on the current stream and adds one to ``launches``.
    """

    def __init__(self, library, symbol, argtypes):
        self.library = library
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        KERNELS.append(self)

    def __call__(self, *args):
        if self._fn is None:
            lib = load(self.library)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            lib = load(self.library)
            what = getattr(lib, f"{self.library}_error_string")
            what.argtypes, what.restype = [ctypes.c_int], ctypes.c_char_p
            raise RuntimeError(f"{self.symbol}: CUDA error {err} "
                               f"({what(err).decode()})")
        self.launches += 1


def launch_counts():
    """``{symbol: launches}`` of every kernel entry, and ``{wrapper:
    calls}`` of every wrapper that took the CUDA route."""
    return {**{k.symbol: k.launches for k in KERNELS}, **WRAPPER_CALLS}


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0
    WRAPPER_CALLS.clear()


def ptr(t):
    """Device pointer of a tensor, or None for a missing optional one."""
    return None if t is None else t.data_ptr()


def stream():
    """The current CUDA stream, as the integer the C entries take."""
    import torch
    return torch.cuda.current_stream().cuda_stream


def check_shapes(want):
    """``want`` maps names to ``(tensor, shape)``; a tensor of another
    shape raises (None stands for a missing optional one)."""
    for name, (t, shape) in want.items():
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")


def check_cuda(int32=(), uint8=(), bfloat16=(), **tensors):
    """The kernels take contiguous float32 tensors (int32 for the names in
    ``int32``, uint8 for those in ``uint8``, bfloat16 for those in
    ``bfloat16``) on one CUDA device (None stands for a missing optional
    one); anything else raises."""
    import torch
    device = None
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        dtype = (torch.int32 if name in int32 else
                 torch.uint8 if name in uint8 else
                 torch.bfloat16 if name in bfloat16 else torch.float32)
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
