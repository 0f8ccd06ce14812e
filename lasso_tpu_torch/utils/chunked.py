"""Chunked encoding: stream batches larger than device memory.

Counterpart of the JAX package's ``utils/chunked.py``, dense output. Per-sample
solves are independent, so a big batch streams through the device in
fixed-size chunks and the codes are gathered into host memory. Chunk
i+1 is dispatched before chunk i is copied back to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from lasso_tpu_torch.utils.convert import resolve_device


def chunked_encode(x, weight, alpha=1.0, chunk_size=65536, algorithm="ista",
                   out=None, output="dense", csr_eps=0.0, screen=False,
                   screen_kwargs=None, device=None, **kwargs):
    """Encode an arbitrarily large batch in fixed-size chunks.

    x: [N, D] on the host (numpy or array-like, e.g. a memmap), weight:
    [D, K] (numpy or tensor). The chunks are solved on ``device``:
    weight's device when weight is a tensor and ``device`` is None, else
    ``device`` (default ``'cuda'``, which raises when there is no card).
    Returns a host numpy array [N, K] in x's dtype, or fills ``out``
    (any preallocated array-like).

    The last chunk is zero-padded to ``chunk_size`` so every chunk has the
    same shape; padding rows solve the zero problem and are discarded. A
    per-sample alpha is sliced per chunk (padding rows get alpha 1); a
    per-feature ``[1, K]`` row passes to every chunk unchanged.

    ``screen=True`` routes each chunk through
    :func:`lasso_tpu_torch.linear.screened_encode` (gap-safe certified
    dictionary shrinking with a full-K fallback; it pays at strongly sparse
    alphas, where a chunk's union support sits well under K), with
    ``screen_kwargs`` (warm_iters, bucket, min_shrink) forwarded; it needs
    a scalar alpha, and its keep-mask crosses to the host inside each
    dispatch, so the chunks then run one after another.

    ``algorithm='ista_conv2d'`` streams a conv sparse-coding batch: x
    ``[N, C_x, H, W]``, weight ``[C_z, C_x, kh, kw]``, codes ``[N, C_z,
    H_z, W_z]`` from the conv geometry; ``stride``/``padding`` and the other
    keywords go to :func:`lasso_tpu_torch.conv2d.ista_conv2d`. Dense output
    only: with ``output='csr'`` or ``screen=True`` it raises ValueError.

    ``output='csr'`` (``csr_eps``) is not ported yet and raises.
    """
    from lasso_tpu_torch.linear.screening import screened_encode
    from lasso_tpu_torch.linear.sparse_encode import sparse_encode

    if output not in ("dense", "csr"):
        raise ValueError(f"output must be 'dense' or 'csr', got {output!r}")
    conv = algorithm == "ista_conv2d"
    if conv and (output != "dense" or screen):
        raise ValueError("ista_conv2d supports only output='dense' without "
                         "screening (the CSR packer and gap-safe screening "
                         "are 2-D code paths)")
    if output == "csr":
        raise NotImplementedError(
            "output='csr' needs the native CSR packer, which is not ported "
            "yet (ROADMAP A item 13b)")
    if device is None:
        device = weight.device if torch.is_tensor(weight) else "cuda"
    device = resolve_device(device)
    weight = torch.as_tensor(weight, dtype=torch.float32).to(device)
    N = x.shape[0]
    # codes follow x's dtype (sparse_encode initializes z0 as x.dtype)
    out_dtype = np.asarray(x[:0]).dtype
    if conv:
        from lasso_tpu_torch.conv2d.ista import ista_conv2d
        from lasso_tpu_torch.conv2d.ops import _pair
        conv_kw = {k: kwargs.pop(k) for k in ("stride", "padding")
                   if k in kwargs}
        (sh, sw), (ph, pw) = (_pair(conv_kw.get("stride", 1)),
                              _pair(conv_kw.get("padding", 0)))
        kh, kw = weight.shape[2], weight.shape[3]
        code_shape = (weight.shape[0], (x.shape[2] + 2 * ph - kh) // sh + 1,
                      (x.shape[3] + 2 * pw - kw) // sw + 1)
    else:
        code_shape = (weight.shape[1],)
    if out is None:
        out = np.empty((N,) + code_shape, dtype=out_dtype)
    if N == 0:
        return out
    chunk_size = min(chunk_size, N)
    if conv:
        z0_chunk = torch.zeros(
            (chunk_size,) + code_shape,
            dtype=torch.from_numpy(np.empty(0, out_dtype)).dtype,
            device=device)

    a_arr = np.asarray(alpha)
    per_feature = (a_arr.ndim == 2 and a_arr.shape[0] == 1
                   and a_arr.shape[1] != 1)
    vec_alpha = a_arr.ndim >= 1 and not per_feature
    if a_arr.ndim >= 1 and screen:
        raise ValueError("screen=True requires a scalar alpha (the gap-safe "
                         "certificate is a scalar-penalty construction)")
    if vec_alpha:
        if a_arr.shape[0] != N:
            raise ValueError(f"per-sample alpha must have shape ({N},), "
                             f"got {a_arr.shape}")
        if a_arr.ndim == 2:
            a_arr = a_arr[:, 0]

    def dispatch(start):
        stop = min(start + chunk_size, N)
        xb = np.asarray(x[start:stop])
        if stop - start < chunk_size:   # pad the tail chunk
            pad = np.zeros((chunk_size - (stop - start),) + x.shape[1:],
                           dtype=xb.dtype)
            xb = np.concatenate([xb, pad], axis=0)
        ab = alpha
        if vec_alpha:
            ab = a_arr[start:stop].astype(np.float32)
            if stop - start < chunk_size:
                # padding rows solve a zero problem; any positive penalty
                # keeps their codes exactly zero
                ab = np.concatenate(
                    [ab, np.ones(chunk_size - (stop - start), np.float32)])
            ab = torch.from_numpy(ab).to(device)
        xb = torch.from_numpy(np.ascontiguousarray(xb)).to(device)
        if screen:
            zb = screened_encode(xb, weight, alpha, algorithm=algorithm,
                                 **(screen_kwargs or {}), **kwargs)
        elif conv:
            zb = ista_conv2d(xb, z0_chunk, weight, alpha=ab, **conv_kw,
                             **kwargs)
        else:
            zb = sparse_encode(xb, weight, alpha=ab, algorithm=algorithm,
                               **kwargs)
        return (zb[0] if isinstance(zb, tuple) else zb), start, stop

    def land(zb, start, stop):
        out[start:stop] = zb[: stop - start].cpu().numpy()

    # one-deep pipeline: dispatch chunk i+1 before copying chunk i back
    pending = None
    for start in range(0, N, chunk_size):
        nxt = dispatch(start)
        if pending is not None:
            land(*pending)
        pending = nxt
    land(*pending)
    return out
