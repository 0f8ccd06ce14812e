"""Ahead-of-time export of encoders for serving.

Counterpart of the JAX package's ``utils/export.py``. A serving process
wants a fixed artifact rather than a call it assembles itself. The JAX
package serializes a jitted encode function to StableHLO bytes; the port
exports ``encode(x, weight) -> z`` with ``torch.export`` and saves the
program into bytes.

The program is one operator, ``lasso_tpu_torch::ista_encode``, with the
solver's options fixed at export. Its body is
:func:`lasso_tpu_torch.linear.sparse_encode` with ``algorithm='ista'``, so
an exported encoder gives ``sparse_encode``'s codes and iteration count
bit for bit, launches the same K1/K2 on CUDA inputs (their plain versions
on CPU ones) and stops where it stops. ``torch.export`` traces only the
operator's fake version (the output shapes, the batch symbolic), so the
solve's loops, host reads and early stop stay out of the graph. The
operator is registered when this module is imported, which
:func:`load_encoder` does.
"""

from __future__ import annotations

import io
import json
from typing import Optional

import torch

from lasso_tpu_torch.ops.common import per_feature_alpha_row


@torch.library.custom_op("lasso_tpu_torch::ista_encode", mutates_args=())
def ista_encode(x: torch.Tensor, weight: torch.Tensor, alpha: float,
                alpha_row: Optional[torch.Tensor], options: str
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``sparse_encode(x, weight, alpha, algorithm='ista',
    return_iters=True, **json.loads(options))`` as one operator, with the
    per-feature ``alpha_row`` in place of ``alpha`` when it is given.
    Returns ``(z, n_iter)``, ``n_iter`` a 0-d int64 tensor on x's
    device."""
    from lasso_tpu_torch.linear.sparse_encode import sparse_encode
    a = alpha if alpha_row is None else alpha_row.to(x.device)
    z, k = sparse_encode(x, weight, a, algorithm="ista", return_iters=True,
                         **json.loads(options))
    return z, torch.tensor(k, dtype=torch.int64, device=x.device)


@ista_encode.register_fake
def _(x, weight, alpha, alpha_row, options):
    return (x.new_empty((x.shape[0], weight.shape[1])),
            x.new_empty((), dtype=torch.int64))


class _Encoder(torch.nn.Module):
    """``encode(x, weight)`` through :func:`ista_encode` with fixed
    options, for ``torch.export``."""

    def __init__(self, alpha, alpha_row, options, return_iters):
        super().__init__()
        self.alpha, self.options = alpha, options
        self.return_iters = return_iters
        self.register_buffer("alpha_row", alpha_row)

    def forward(self, x, weight):
        z, k = ista_encode(x, weight, self.alpha, self.alpha_row,
                           self.options)
        return (z, k) if self.return_iters else z


def export_encoder(weight, alpha=1.0, algorithm="ista", batch_size=None,
                   return_iters=False, **solver_kwargs):
    """Export ``encode(x, weight) -> z`` for a fixed dictionary shape
    ``[D, K]`` and return it as bytes.

    ``batch_size=None`` exports with a symbolic batch dimension; an int
    fixes it. ``solver_kwargs`` are ``ista``'s (``fast``, ``lr`` fixed or
    ``'auto'``, ``maxiter``, ``tol``, ``kernel_precision``, ``fuse_steps``,
    ``restart``, ...) and ``sparse_encode``'s ``init``, JSON values all;
    ``return_iters=True`` makes the program return ``(z, n_iter)``.
    ``alpha`` is a scalar or a per-feature ``[1, K]`` row, fixed in the
    program as the options are. The options are checked at export by one
    call on a zero batch, so that a bad one fails here rather than in the
    serving process.

    Only ``algorithm='ista'`` exports; another raises NotImplementedError
    (ROADMAP A.15).
    """
    if algorithm != "ista":
        raise NotImplementedError(
            f"export of algorithm={algorithm!r} is not ported yet: only "
            f"'ista' exports (ROADMAP A.15: export of the other solvers)")
    weight = weight.detach()
    if weight.dtype != torch.float32:
        raise ValueError(f"weight must be float32, got {weight.dtype}")
    a_row = per_feature_alpha_row(alpha, weight.shape[1])
    if a_row is None and torch.as_tensor(alpha).ndim > 0:
        raise ValueError("a per-sample alpha belongs to one batch and "
                         "cannot be exported; pass a scalar or a "
                         "per-feature [1, K] row")
    program = _Encoder(
        float(alpha) if a_row is None else 1.0,
        None if a_row is None else a_row.detach().to(weight.device,
                                                     torch.float32),
        json.dumps(solver_kwargs), return_iters)
    x = weight.new_zeros((8 if batch_size is None else int(batch_size),
                          weight.shape[0]))
    program(x, weight)
    dims = {"x": None if batch_size is not None
            else {0: torch.export.Dim.DYNAMIC}, "weight": None}
    exported = torch.export.export(program, (x, weight),
                                   dynamic_shapes=dims)
    exported.example_inputs = None  # the blob need not carry W
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    return buf.getvalue()


def load_encoder(blob):
    """Load an exported encoder; returns ``call(x, weight) -> z`` (a
    ``torch.nn.Module``)."""
    return torch.export.load(io.BytesIO(bytes(blob))).module()
