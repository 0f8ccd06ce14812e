"""Scalar line searches.

Counterpart of the JAX package's ``linalg/line_search.py``: a bounded
minimization by a fixed number of golden-section reductions (branch-free,
no host synchronization, accurate to ``(hi-lo) * 0.618**maxiter``), and a
backtracking search with a sufficient-decrease test.
"""

from __future__ import annotations

import math

import torch

from lasso_tpu_torch.ops.common import INNER_ITERATIONS

_INVPHI = (math.sqrt(5.0) - 1.0) / 2.0  # 1/phi ~ 0.618
_INVPHI2 = (3.0 - math.sqrt(5.0)) / 2.0  # 1/phi^2 ~ 0.382


def golden_section(fn, lo=0.0, hi=1.0, maxiter=30):
    """Minimize ``fn`` over ``[lo, hi]``; returns ``(t_min, f_min)``.

    When ``lo``/``hi`` are tensors and ``fn`` maps elementwise (e.g. a
    per-sample objective ``[B] -> [B]``), the search runs independently
    per element. ``lo`` is taken in the default float dtype (float32
    unless changed with ``torch.set_default_dtype``), as the JAX package
    takes ``jnp.result_type(float)``. The search moves to the device of
    ``fn``'s values; a ``lo`` tensor already there saves that copy.
    """
    dtype = torch.get_default_dtype()
    a = (lo.to(dtype) if isinstance(lo, torch.Tensor)
         else torch.tensor(lo, dtype=dtype))
    b = (hi.to(dtype=dtype, device=a.device) if isinstance(hi, torch.Tensor)
         else torch.full_like(a, hi))
    b = torch.broadcast_to(b, a.shape)
    h = b - a
    c = a + _INVPHI2 * h
    d = a + _INVPHI * h
    fc = fn(c)
    fd = fn(d)
    if a.device != fc.device:
        a, b, c, d = (v.to(fc.device) for v in (a, b, c, d))

    for _ in range(maxiter):
        go_left = fc < fd
        a_new = torch.where(go_left, a, c)
        b_new = torch.where(go_left, d, b)
        h = b_new - a_new
        c_new = torch.where(go_left, a_new + _INVPHI2 * h, d)
        d_new = torch.where(go_left, c, a_new + _INVPHI * h)
        # one new evaluation an iteration: c_new on the left branch,
        # d_new on the right
        f_eval = fn(torch.where(go_left, c_new, d_new))
        fc, fd = (torch.where(go_left, f_eval, fd),
                  torch.where(go_left, fc, f_eval))
        a, b, c, d = a_new, b_new, c_new, d_new

    t = torch.where(fc < fd, c, d)
    f = torch.minimum(fc, fd)
    return t, f


def backtracking_armijo(fn, f0, slope, t0, decay=0.95, sufficient=0.1,
                        maxiter=500):
    """Backtracking line search with a sufficient-decrease test.

    Shrinks ``t`` by ``decay`` until ``fn(t) <= f0 - sufficient *
    slope(t)``, where ``slope(t)`` is the caller's directional-decrease
    term; after ``maxiter`` trials it returns the last ``t``. Each trial
    reads its test to the host (one synchronization on a CUDA tensor).

    ``fn``: scalar t -> objective value; ``slope``: scalar t -> decrease
    term. Returns ``(t, n_iters)`` (``t`` a 0-dim tensor in the default
    float dtype, ``n_iters`` an int).
    """
    t = torch.as_tensor(t0, dtype=torch.get_default_dtype())
    k = 0
    done = False
    while not done and k < maxiter:
        INNER_ITERATIONS["backtracking_armijo"] += 1
        ok = fn(t) <= f0 - sufficient * slope(t)
        done = bool(ok)                                     # host sync
        if not done:
            t = t * decay
        k += 1
    return t, k
