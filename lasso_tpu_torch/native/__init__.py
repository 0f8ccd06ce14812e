"""Native (C++) host runtime, built on demand.

Counterpart of the JAX package's ``native/__init__.py``, with the same
seven public names, arguments and numpy results. The port's compute path
is its CUDA kernels; the host-side runtime around it (the patch-extraction
pipeline that feeds dictionary learning, and the CSR packer of serving
output) is multithreaded C++, ``patch_ops.cpp`` and ``sparse_pack.cpp``
beside this file. At first use ``g++`` compiles both into one shared
library in ``build/`` at the repository root, under a name tagged by a hash
of the sources, the flags and the host CPU's feature flags (``-march=native``
code from one machine may not run on another), through a temporary file and
``os.replace`` (so that processes building at once cannot load a
half-written library), and ``ctypes`` binds it. Nothing is built when the
module is imported.

Every entry point has a numpy version, selected when no compiler is
found. The two are equal bit for bit except in
:func:`extract_patches_random`, whose numpy version draws from
``np.random`` and whose C++ draws from splitmix64: the same seed picks
other windows.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

_HERE = Path(__file__).resolve().parent
_SOURCES = (_HERE / "patch_ops.cpp", _HERE / "sparse_pack.cpp")
BUILD = _HERE.parent.parent / "build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             "-pthread")
_LOCK = threading.Lock()
_LIB = None
_BUILD_ERROR = None


def _cpu_flags():
    """The host CPU's feature flags as ``/proc/cpuinfo`` lists them (the
    machine's name where there is no such file)."""
    cpuinfo = Path("/proc/cpuinfo")
    lines = cpuinfo.read_text().splitlines() if cpuinfo.exists() else []
    return next((line for line in lines
                 if line.startswith(("flags", "Features"))),
                platform.machine())


def library_path():
    """Where the library is built: named by a hash of both sources, the
    compiler flags and the host CPU's feature flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_cpu_flags().encode())
    for src in _SOURCES:
        h.update(src.read_bytes())
    return BUILD / f"liblasso_native-{h.hexdigest()[:16]}.so"


def _build_lib():
    """Compile the two sources into the cached shared library and bind
    its entry points."""
    so_path = library_path()
    if not so_path.exists():
        BUILD.mkdir(exist_ok=True)
        tmp = so_path.with_name(f"{so_path.name}.{os.getpid()}.tmp")
        subprocess.run(["g++", *CXX_FLAGS, *map(str, _SOURCES), "-o",
                        str(tmp)], check=True, capture_output=True)
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(str(so_path))

    i64, f32p, i32, u64 = (ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
                           ctypes.c_int, ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.extract_patches_dense.restype = i64
    lib.extract_patches_dense.argtypes = [f32p, i64, i64, i64, i64, i64,
                                          f32p, i32]
    lib.extract_patches_random.restype = i64
    lib.extract_patches_random.argtypes = [f32p, i64, i64, i64, i64, i64,
                                           u64, f32p, i32]
    lib.center_patches.restype = None
    lib.center_patches.argtypes = [f32p, i64, i64, i32, i32]
    lib.csr_count_nnz.restype = i64
    lib.csr_count_nnz.argtypes = [f32p, i64, i64, ctypes.c_float, i64p, i32]
    lib.csr_pack.restype = None
    lib.csr_pack.argtypes = [f32p, i64, i64, ctypes.c_float, i64p, f32p,
                             i32p, i32]
    lib.csr_unpack.restype = None
    lib.csr_unpack.argtypes = [f32p, i32p, i64p, i64, i64, f32p, i32]
    return lib


def get_lib():
    """Return the ctypes library, or None when it cannot be built."""
    global _LIB, _BUILD_ERROR
    with _LOCK:
        if _LIB is None and _BUILD_ERROR is None:
            try:
                _LIB = _build_lib()
            except Exception as e:  # no compiler / failed build -> numpy
                _BUILD_ERROR = e
    return _LIB


def have_native():
    return get_lib() is not None


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i64ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _i32ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _threads(threads):
    if threads is None:
        threads = os.cpu_count() or 1
    return int(threads)


def extract_patches_dense(imgs, patch, stride=1, threads=None):
    """All patches on a stride grid. imgs: [n, h, w] f32 ->
    [n * n_y * n_x, patch*patch]."""
    imgs = np.ascontiguousarray(imgs, np.float32)
    n, h, w = imgs.shape
    n_y = (h - patch) // stride + 1
    n_x = (w - patch) // stride + 1
    out = np.empty((n * n_y * n_x, patch * patch), np.float32)
    lib = get_lib()
    if lib is not None:
        count = lib.extract_patches_dense(
            _fptr(imgs), n, h, w, patch, stride, _fptr(out),
            _threads(threads))
        assert count == out.shape[0]
        return out
    k = 0
    for i in range(n):
        for yy in range(0, h - patch + 1, stride):
            for xx in range(0, w - patch + 1, stride):
                out[k] = imgs[i, yy:yy + patch, xx:xx + patch].ravel()
                k += 1
    return out


def extract_patches_random(imgs, patch, per_image, seed=0, threads=None):
    """per_image random patches per image (deterministic in seed, and the
    same for any ``threads``)."""
    imgs = np.ascontiguousarray(imgs, np.float32)
    n, h, w = imgs.shape
    out = np.empty((n * per_image, patch * patch), np.float32)
    lib = get_lib()
    if lib is not None:
        count = lib.extract_patches_random(
            _fptr(imgs), n, h, w, patch, per_image, seed, _fptr(out),
            _threads(threads))
        assert count == out.shape[0]
        return out
    rng = np.random.default_rng(seed)
    k = 0
    for i in range(n):
        for _ in range(per_image):
            y0 = rng.integers(0, h - patch + 1)
            x0 = rng.integers(0, w - patch + 1)
            out[k] = imgs[i, y0:y0 + patch, x0:x0 + patch].ravel()
            k += 1
    return out


def center_patches(patches, normalize=False, threads=None):
    """In-place per-patch mean subtraction (and optional l2 normalize).
    Returns the same array."""
    assert patches.dtype == np.float32 and patches.flags.c_contiguous
    lib = get_lib()
    if lib is not None:
        lib.center_patches(_fptr(patches), patches.shape[0],
                           patches.shape[1], int(normalize),
                           _threads(threads))
        return patches
    patches -= patches.mean(axis=1, keepdims=True)
    if normalize:
        nrm = np.linalg.norm(patches, axis=1, keepdims=True)
        patches *= np.where(nrm > 1e-6, 1.0 / np.maximum(nrm, 1e-30), 0.0)
    return patches


def pack_codes_csr(z, eps=0.0, threads=None):
    """Pack a dense code matrix z [N, K] into CSR ``(values float32, cols
    int32, row_ptr int64)``, dropping entries with ``|z| <= eps``.

    ``z`` is a numpy array or a tensor; a tensor on the card is copied to
    the host first. A two-pass multithreaded C++ packer (row counts, a
    scan, then the fill), or numpy without a compiler.
    """
    if torch.is_tensor(z):
        z = z.detach().cpu().numpy()
    z = np.ascontiguousarray(np.asarray(z), dtype=np.float32)
    N, K = z.shape
    lib = get_lib()
    if lib is None:
        mask = np.abs(z) > eps
        row_nnz = mask.sum(axis=1).astype(np.int64)
        row_ptr = np.zeros(N + 1, np.int64)
        np.cumsum(row_nnz, out=row_ptr[1:])
        cols = np.nonzero(mask)[1].astype(np.int32)
        values = z[mask]
        return values, cols, row_ptr

    row_nnz = np.empty(N, np.int64)
    total = lib.csr_count_nnz(_fptr(z), N, K, np.float32(eps),
                              _i64ptr(row_nnz), _threads(threads))
    row_ptr = np.zeros(N + 1, np.int64)
    np.cumsum(row_nnz, out=row_ptr[1:])
    values = np.empty(total, np.float32)
    cols = np.empty(total, np.int32)
    lib.csr_pack(_fptr(z), N, K, np.float32(eps), _i64ptr(row_ptr),
                 _fptr(values), _i32ptr(cols), _threads(threads))
    return values, cols, row_ptr


def unpack_codes_csr(values, cols, row_ptr, n_components, threads=None):
    """CSR -> dense [N, n_components] (decode side of pack_codes_csr)."""
    values = np.ascontiguousarray(values, np.float32)
    cols = np.ascontiguousarray(cols, np.int32)
    row_ptr = np.ascontiguousarray(row_ptr, np.int64)
    N = row_ptr.shape[0] - 1
    out = np.empty((N, n_components), np.float32)
    lib = get_lib()
    if lib is None:
        out[:] = 0.0
        for r in range(N):
            sl = slice(row_ptr[r], row_ptr[r + 1])
            out[r, cols[sl]] = values[sl]
        return out
    lib.csr_unpack(_fptr(values), _i32ptr(cols), _i64ptr(row_ptr),
                   N, n_components, _fptr(out), _threads(threads))
    return out
