"""Carry parameters and training state over from the JAX package, and pick
the device.

The JAX package keeps its arrays as numpy on the host between calls:
the dictionary ``weight`` is ``[D, K]`` and codes reconstruct as
``X_hat = Z @ W.T``. The port keeps that layout, so the arrays carry
over unchanged as contiguous float32 tensors.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device):
    """``torch.device(device)``; a CUDA device with no card raises (the
    entry points never carry on on the CPU unless asked to)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    return device


def from_numpy_params(params, device):
    """Turn the JAX package's numpy parameters into float32 tensors.

    ``params`` maps names to arrays: the dictionary ``'weight'`` (``[D,
    K]``) or the initial dictionary of a training run ``'weight0'`` (``[D,
    K]``), at least one of them; and optionally ``'x'`` (``[N, D]``),
    ``'z0'`` (``[N, K]``), ``'alpha'`` (a scalar, an ``[N]`` or ``[N, 1]``
    per-sample column, or a ``[1, K]`` / ``[K]`` per-feature row), and the
    training state: the replacement atoms of each step as the JAX package
    draws them, ``'atoms'`` (``[steps, K, D]``, the sequential M-step) or
    ``'atoms_block'`` (``[steps, D, K]``, the block M-step), and the online
    statistics ``'A'`` (``[K, K]``) and ``'B'`` (``[D, K]``). Returns a
    dict with the same keys of contiguous float32 tensors on ``device``,
    after checking that the shapes agree.
    """
    device = resolve_device(device)
    unknown = set(params) - {"weight", "weight0", "x", "z0", "alpha",
                             "atoms", "atoms_block", "A", "B"}
    if unknown:
        raise ValueError(f"unknown parameters {sorted(unknown)}")
    arrays = {k: np.asarray(v, dtype=np.float32) for k, v in params.items()}
    dicts = [arrays[k] for k in ("weight", "weight0") if k in arrays]
    if not dicts or any(w.ndim != 2 for w in dicts):
        raise ValueError("params needs a 2-D 'weight' or 'weight0' [D, K]")
    D, K = dicts[0].shape
    want = {"weight": (D, K), "weight0": (D, K), "A": (K, K), "B": (D, K)}
    for name, shape in want.items():
        if name in arrays and arrays[name].shape != shape:
            raise ValueError(f"{name} has shape {arrays[name].shape}, "
                             f"expected {list(shape)}")
    for name, shape in (("atoms", (K, D)), ("atoms_block", (D, K))):
        a = arrays.get(name)
        if a is not None and (a.ndim != 3 or a.shape[1:] != shape):
            raise ValueError(f"{name} has shape {a.shape}, expected "
                             f"[steps, {shape[0]}, {shape[1]}]")
    N = None
    if "x" in arrays:
        if arrays["x"].ndim != 2 or arrays["x"].shape[1] != D:
            raise ValueError(f"x has shape {arrays['x'].shape}, expected "
                             f"[N, {D}]")
        N = arrays["x"].shape[0]
    if "z0" in arrays:
        z0 = arrays["z0"]
        if z0.ndim != 2 or z0.shape[1] != K or (N is not None
                                                and z0.shape[0] != N):
            raise ValueError(f"z0 has shape {z0.shape}, expected "
                             f"[{'N' if N is None else N}, {K}]")
    if "alpha" in arrays:
        a = arrays["alpha"]
        ok = (a.ndim == 0 or a.shape in ((1, K), (K,))
              or (N is not None and a.shape in ((N,), (N, 1))))
        if not ok:
            raise ValueError(f"alpha has shape {a.shape}: expected a "
                             f"scalar, [N], [N, 1], [1, {K}] or [{K}]")
    # a read-only array (one of JAX's, say) is copied, never shared
    return {k: torch.from_numpy(np.require(v, requirements=["C", "W"]))
            .to(device) for k, v in arrays.items()}
