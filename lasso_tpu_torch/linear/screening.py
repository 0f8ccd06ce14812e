"""Gap-safe atom screening (Fercoq, Gramfort & Salmon 2015).

Counterpart of the JAX package's ``linear/screening.py``. For the
per-sample lasso ``min_z 0.5||x - W z||^2 + alpha ||z||_1`` any primal
iterate gives a dual-feasible point and a duality gap, and every atom the
resulting safe-sphere test eliminates is certified to be zero at the
optimum, however the iterate was made. Dropping the atoms inactive for
the whole batch shrinks K.

The elimination happens at the host boundary: a short warm start runs at
full K, the union of the certified keep-masks crosses to the host once,
the kept columns are gathered into a dictionary padded to a multiple of
``bucket`` atoms, and the reduced solve's codes are scattered back into
``[N, K]``. Eliminated coordinates are exact zeros of the full problem,
so the result is the full-K solve's. It pays when the union of the
per-sample supports is well under K: high alphas and small batches.
"""

from __future__ import annotations

import numpy as np
import torch

from lasso_tpu_torch.config import get_precision
from lasso_tpu_torch.ops.common import matmul


def screen_atoms(x, weight, alpha, z=None, precision=None):
    """Per-sample gap-safe sphere test. Returns ``(keep, gap)``.

    x: [N, D], weight: [D, K], z: [N, K] warm primal (zeros if None).
    ``keep``: [N, K] bool; False entries are certified zero at each
    sample's optimum. ``gap``: [N] duality gaps of the warm points, in x's
    dtype.

    Construction (Fercoq et al. 2015, eq. 2.2-2.4): with residual
    ``R = x - z W^T``, the scaled dual point ``theta = R / max(alpha,
    ||W^T R||_inf)`` is feasible; the safe radius is ``r = sqrt(2 gap) /
    alpha`` and atom k is eliminated when ``|w_k^T theta| + r ||w_k|| <
    1``.

    The test runs in float64 (the JAX package runs it in float32). Near the
    optimum an active atom has ``|w_k^T theta|`` just under 1 and only the
    radius keeps it, while the gap is smaller than float32's rounding of
    the residual terms (about 1e-7 against 5e-5 at D=512): a float32 test
    then drops atoms that are nonzero at the optimum.
    """
    prec = get_precision(precision)
    x64, w64 = x.double(), weight.double()
    z64 = (x64.new_zeros((x.shape[0], weight.shape[1])) if z is None
           else z.double())
    R = x64 - matmul(z64, w64.T, prec)                             # [N, D]
    WtR = matmul(R, w64, prec)                                     # [N, K]
    dual_inf = torch.amax(torch.abs(WtR), dim=1, keepdim=True)     # [N, 1]
    theta = R / torch.clamp_min(dual_inf, alpha)                   # [N, D]

    primal = (0.5 * torch.sum(torch.square(R), dim=1)
              + alpha * torch.sum(torch.abs(z64), dim=1))          # [N]
    # D(theta) = 0.5||x||^2 - 0.5||x - alpha*theta||^2
    dual = (0.5 * torch.sum(torch.square(x64), dim=1)
            - 0.5 * torch.sum(torch.square(x64 - alpha * theta), dim=1))
    gap = torch.clamp_min(primal - dual, 0.0)                      # [N]

    w_norms = torch.sqrt(torch.sum(torch.square(w64), dim=0))      # [K]
    corr = torch.abs(matmul(theta, w64, prec))                     # [N, K]
    radius = torch.sqrt(2.0 * gap)[:, None] / alpha                # [N, 1]
    keep = corr + radius * w_norms[None, :] >= 1.0
    return keep, gap.to(x.dtype)


def screened_encode(x, weight, alpha, warm_iters=10, bucket=128,
                    algorithm="ista", min_shrink=0.75, **kwargs):
    """Encode with certified gap-safe dictionary shrinking.

    Runs ``warm_iters`` FISTA iterations at full K, screens, gathers the
    union of kept atoms into a bucket-padded dictionary, solves the
    reduced problem (warm-started from the warm iterate) and scatters
    back. Returns ``(z, info)`` with ``info = {'kept': K', 'K': K,
    'gap_max': float, 'screened': bool}``. Falls back to a full-K solve,
    warm-started too, when screening keeps more than ``min_shrink`` of the
    atoms. ``kwargs`` go to the solves of
    :func:`lasso_tpu_torch.linear.sparse_encode`.

    The keep-mask crosses to the host (one small sync): call it from
    serving or chunked pipelines.
    """
    from lasso_tpu_torch.linear.sparse_encode import sparse_encode

    N = x.shape[0]
    K = weight.shape[1]
    alpha = float(alpha)
    z_warm = sparse_encode(x, weight, alpha, algorithm="ista",
                           maxiter=int(warm_iters), tol=0.0)
    keep_ps, gap = screen_atoms(x, weight, alpha, z_warm)
    keep = torch.any(keep_ps, dim=0).cpu().numpy()                # [K] union
    kept = int(keep.sum())
    info = {"kept": kept, "K": K, "gap_max": float(torch.max(gap))}

    if kept > min_shrink * K:
        z = sparse_encode(x, weight, alpha, algorithm=algorithm, z0=z_warm,
                          **kwargs)
        info["screened"] = False
        return z, info

    # bucket-pad the kept set so that the reduced solves come in a few
    # sizes
    k_pad = min(K, max(bucket, -(-kept // bucket) * bucket))
    idx = np.flatnonzero(keep)
    # pad with distinct unkept columns: they enter with their warm values
    # and converge to their certified-zero optima like any other
    # coordinate of the reduced problem
    if len(idx) < k_pad:
        unkept = np.flatnonzero(~keep)[: k_pad - len(idx)]
        idx = np.concatenate([idx, unkept])
    idx_t = torch.from_numpy(idx).to(x.device)
    z_s = sparse_encode(x, weight.index_select(1, idx_t), alpha,
                        algorithm=algorithm,
                        z0=z_warm.index_select(1, idx_t), **kwargs)
    z = x.new_zeros((N, K))
    z[:, idx_t] = z_s
    info["screened"] = True
    return z, info
