"""Carry parameters and training state over from the JAX package, and pick
the device.

The JAX package keeps its arrays as numpy on the host between calls:
the dictionary ``weight`` is ``[D, K]`` and codes reconstruct as
``X_hat = Z @ W.T``; a conv dictionary is ``[C_z, C_x, kh, kw]`` with
images ``[N, C_x, H, W]`` and codes ``[N, C_z, H_z, W_z]``. The port keeps
those layouts, so the arrays carry over unchanged as contiguous float32
tensors.
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


def from_numpy_params(params, device, padding=None):
    """Turn the JAX package's numpy parameters into float32 tensors.

    ``params`` maps names to arrays: the dictionary ``'weight'`` (``[D,
    K]``) or the initial dictionary of a training run ``'weight0'`` (``[D,
    K]``), at least one of them; and optionally ``'x'`` (``[N, D]``),
    ``'z0'`` (``[N, K]``), ``'alpha'`` (a scalar, an ``[N]`` or ``[N, 1]``
    per-sample column, or a ``[1, K]`` / ``[K]`` per-feature row), and the
    training state: the replacement atoms of each step as the JAX package
    draws them, ``'atoms'`` (``[steps, K, D]``, the sequential M-step) or
    ``'atoms_block'`` (``[steps, D, K]``, the block M-step), and the online
    statistics ``'A'`` (``[K, K]``) and ``'B'`` (``[D, K]``); and the
    group structure of ``group_ista``: ``'groups'``, an int block size
    (dividing K) or a ``[K]`` integer array of group ids, and
    ``'group_weights'`` (``[G]``). Returns a dict with the same keys of
    contiguous float32 tensors on ``device``, after checking that the
    shapes agree; a block size stays a Python int, and an id array becomes
    an integer tensor of its own int32 or int64 type.

    A 4-D ``'weight'`` or ``'weight0'`` is a conv dictionary ``[C_z, C_x,
    kh, kw]`` (``'weight0'`` the initial filters of a training run); then
    only ``'x'`` (``[N, C_x, H, W]``), ``'z0'`` (``[N, C_z, H_z, W_z]``),
    ``'alpha'`` (a scalar, per-sample ``[N]`` / ``[N, 1]``, or
    per-channel ``[1, C_z]`` / ``[C_z]``) and the replacement filters of
    each training step as the JAX package draws them, ``'step_rand'``
    (``[steps, C_z, C_x, kh, kw]``), may come with it. At stride 1
    ``H_z = H + 2 p - kh + 1`` (and likewise for the width): with
    ``padding`` given, x and z0 are checked against it; without it, a
    given pair x, z0 must agree with one padding p >= 0 of both axes.
    """
    device = resolve_device(device)
    w = params.get("weight", params.get("weight0"))
    if w is not None and np.ndim(w) == 4:
        return _conv_params(params, device, padding)
    if padding is not None:
        raise ValueError("padding applies only to a conv dictionary "
                         "(a 4-D 'weight')")
    unknown = set(params) - {"weight", "weight0", "x", "z0", "alpha",
                             "atoms", "atoms_block", "A", "B", "groups",
                             "group_weights"}
    if unknown:
        raise ValueError(f"unknown parameters {sorted(unknown)}")
    groups = params.get("groups")
    arrays = {k: np.asarray(v, dtype=np.float32) for k, v in params.items()
              if k != "groups"}
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
    n_groups = None
    if groups is not None:
        g = np.asarray(groups)
        if g.ndim == 0 and g.dtype.kind in "iu":
            if int(g) < 1 or K % int(g) != 0:
                raise ValueError(f"groups: block size {int(g)} does not "
                                 f"divide K={K}")
            groups, n_groups = int(g), K // int(g)
        elif g.shape == (K,) and g.dtype.kind in "iu":
            if g.min() < 0 or len(np.unique(g)) != int(g.max()) + 1:
                raise ValueError("groups: ids must be 0..G-1 with every id "
                                 "used")
            n_groups = int(g.max()) + 1
            g = g.astype(np.int64 if g.dtype.itemsize > 4 else np.int32)
            groups = torch.from_numpy(np.require(g, requirements=["C", "W"])
                                      ).to(device)
        else:
            raise ValueError(f"groups must be an int block size or an int "
                             f"array of shape ({K},), got shape {g.shape} "
                             f"dtype {g.dtype}")
    if "group_weights" in arrays:
        gw = arrays["group_weights"]
        if n_groups is None or gw.shape != (n_groups,):
            raise ValueError(f"group_weights has shape {gw.shape}, expected "
                             f"[G] with G={n_groups} from 'groups'")
    # a read-only array (one of JAX's, say) is copied, never shared
    out = {k: torch.from_numpy(np.require(v, requirements=["C", "W"]))
           .to(device) for k, v in arrays.items()}
    if groups is not None:
        out["groups"] = groups
    return out


def from_numpy_tree(tree, device, dtype=torch.float32):
    """Turn the JAX package's parameter tree of a nonlinear decoder (dicts,
    lists and tuples of numpy arrays, nested, as ``decoder(params, z)``
    takes them) into the same structure of contiguous tensors of ``dtype``
    (float32 by default) on ``device``. A read-only array (one of JAX's,
    say) is copied, never shared."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_numpy_tree(v, device, dtype) for v in tree)
    a = np.require(np.asarray(tree), requirements=["C", "W"])
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def _conv_params(params, device, padding):
    """:func:`from_numpy_params` for a conv dictionary."""
    unknown = set(params) - {"weight", "weight0", "x", "z0", "alpha",
                             "step_rand"}
    if unknown:
        raise ValueError(f"unknown parameters {sorted(unknown)} for a conv "
                         f"dictionary")
    arrays = {k: np.asarray(v, dtype=np.float32) for k, v in params.items()}
    shape = arrays.get("weight", arrays.get("weight0")).shape
    for name in ("weight", "weight0"):
        if name in arrays and arrays[name].shape != shape:
            raise ValueError(f"{name} has shape {arrays[name].shape}, "
                             f"expected {list(shape)}")
    Cz, Cx, kh, kw = shape
    rand = arrays.get("step_rand")
    if rand is not None and (rand.ndim != 5 or rand.shape[1:] != shape):
        raise ValueError(f"step_rand has shape {rand.shape}, expected "
                         f"[steps, {Cz}, {Cx}, {kh}, {kw}]")
    x, z0 = arrays.get("x"), arrays.get("z0")
    if x is not None and (x.ndim != 4 or x.shape[1] != Cx):
        raise ValueError(f"x has shape {x.shape}, expected [N, {Cx}, H, W]")
    if z0 is not None and (z0.ndim != 4 or z0.shape[1] != Cz):
        raise ValueError(f"z0 has shape {z0.shape}, expected "
                         f"[N, {Cz}, H_z, W_z]")
    N = next((a.shape[0] for a in (x, z0) if a is not None), None)
    if x is not None and z0 is not None:
        if x.shape[0] != z0.shape[0]:
            raise ValueError(f"x has {x.shape[0]} samples, z0 "
                             f"{z0.shape[0]}")
        # 2p = H_z - H + kh - 1 on both axes
        two_p = {z0.shape[2] - x.shape[2] + kh - 1,
                 z0.shape[3] - x.shape[3] + kw - 1}
        if padding is not None:
            ph, pw = np.broadcast_to(np.asarray(padding, int), (2,))
            ok = two_p == {2 * ph, 2 * pw} and ph == pw
        else:
            ok = len(two_p) == 1 and min(two_p) >= 0 and min(two_p) % 2 == 0
        if not ok:
            raise ValueError(
                f"x {x.shape} and z0 {z0.shape} do not agree with a "
                f"{kh}x{kw} dictionary at stride 1 and padding "
                f"{'one p >= 0' if padding is None else padding}: expected "
                f"H_z = H + 2p - {kh} + 1 and W_z = W + 2p - {kw} + 1")
    if "alpha" in arrays:
        a = arrays["alpha"]
        ok = (a.ndim == 0 or a.shape in ((1, Cz), (Cz,))
              or (N is not None and a.shape in ((N,), (N, 1))))
        if not ok:
            raise ValueError(f"alpha has shape {a.shape}: expected a "
                             f"scalar, [N], [N, 1], [1, {Cz}] or [{Cz}]")
    return {k: torch.from_numpy(np.require(v, requirements=["C", "W"]))
            .to(device) for k, v in arrays.items()}
