"""Profiling and observability helpers.

Counterpart of the JAX package's ``utils/profiling.py``: annotations around
solver regions, a trace of a region written for TensorBoard or
``chrome://tracing``, a timing harness for the iterations/s metric, and a
NaN check for debugging.
"""

from __future__ import annotations

import contextlib
import contextvars
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


@contextlib.contextmanager
def trace(name: str):
    """Annotate a region for the profiler: it shows as ``name`` in a
    :func:`capture_trace` trace."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def capture_trace(log_dir: str):
    """Capture a trace of the region into ``log_dir`` as a Chrome trace
    (``torch.profiler.tensorboard_trace_handler``): host operations, and
    the card's kernels when the process has a card."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                str(log_dir))):
        yield


def _synchronize(result):
    """Wait for every CUDA device that holds a tensor of ``result``."""
    devices = {t.device for t in tree_leaves(result)
               if torch.is_tensor(t) and t.is_cuda}
    for d in devices:
        torch.cuda.synchronize(d)
    return result


def time_solver(fn, *args, warmup=1, repeats=3, **kwargs):
    """Best-of-``repeats`` wall time of ``fn(*args, **kwargs)`` after
    ``warmup`` calls, each timed to the end of the device work of every
    tensor it returns. Returns ``(seconds, result)``; with a fixed
    iteration count (``tol=0``) it gives iterations/s."""
    result = None
    for _ in range(warmup):
        result = _synchronize(fn(*args, **kwargs))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        result = _synchronize(fn(*args, **kwargs))
        best = min(best, time.perf_counter() - t0)
    return best, result


# allocations: their contents are undefined until written
_UNWRITTEN = {"empty", "empty_like", "new_empty", "empty_strided",
              "new_empty_strided", "empty_permuted"}


# whether the innermost debug_nans region checks (JAX's jax_debug_nans flag)
_CHECKING = contextvars.ContextVar("debug_nans", default=False)


class _NanCheck(TorchDispatchMode):
    """Raise ``FloatingPointError`` at the first operator whose
    floating-point output holds a NaN (allocations aside), while the
    innermost ``debug_nans`` region checks."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (not _CHECKING.get()
                or func.overloadpacket.__name__ in _UNWRITTEN):
            return out
        for t in tree_leaves(out):
            if (torch.is_tensor(t) and t.is_floating_point()
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(
                    f"invalid value (nan) encountered in {func}")
        return out


@contextlib.contextmanager
def debug_nans(enable=True):
    """Within the region, raise ``FloatingPointError`` naming the first
    PyTorch operator whose output holds a NaN (the counterpart of the JAX
    package's ``jax_debug_nans``; for debugging, not recovery: the solvers
    already stop on NaNs themselves). Each check reads a flag back to the
    host, so the region runs much slower.

    The check sees what goes through PyTorch's dispatcher. A CUDA kernel
    of this package is launched through ``ctypes`` into a tensor made
    beforehand, which the dispatcher does not see: a kernel's NaN output
    is caught at the first operator that reads it. ``enable=False`` turns
    the check off within the region, also inside an enclosing
    ``debug_nans()``; the state from before the region comes back on exit.
    """
    token = _CHECKING.set(bool(enable))
    try:
        if enable:
            with _NanCheck():
                yield
        else:
            yield
    finally:
        _CHECKING.reset(token)
