"""Chunked encoding: stream batches larger than device memory.

Counterpart of the JAX package's ``utils/chunked.py``. Per-sample solves are
independent, so a big batch streams through the device in fixed-size
chunks and the codes are gathered into host memory, dense or packed as
CSR by the native packer. Each chunk lands (its copy to the host, then
its packing or its store) on one worker thread while the next chunk is
dispatched, so that landing one chunk overlaps solving the next, also
where the solver reads to the host as it runs. At most two chunks are in
flight.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

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

    ``output='csr'`` instead returns ``(values float32, cols int32,
    row_ptr int64)``, each chunk's codes packed on the host by
    :func:`lasso_tpu_torch.native.pack_codes_csr` (entries with ``|z| <=
    csr_eps`` dropped) as they land, so the dense ``[N, K]`` matrix never
    materializes on the host; an empty batch gives ``([], [], [0])``.
    ``out`` applies to dense output only (ValueError with ``'csr'``).

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
    """
    from lasso_tpu_torch.linear.screening import screened_encode
    from lasso_tpu_torch.linear.sparse_encode import sparse_encode
    from lasso_tpu_torch.native import pack_codes_csr

    if output not in ("dense", "csr"):
        raise ValueError(f"output must be 'dense' or 'csr', got {output!r}")
    csr = output == "csr"
    if out is not None and csr:
        raise ValueError(
            "a preallocated `out` buffer applies only to output='dense'; "
            "the CSR path returns freshly packed (values, cols, row_ptr) "
            "arrays whose sizes are data-dependent")
    conv = algorithm == "ista_conv2d"
    if conv and (output != "dense" or screen):
        raise ValueError("ista_conv2d supports only output='dense' without "
                         "screening (the CSR packer and gap-safe screening "
                         "are 2-D code paths)")
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
    if csr:
        vals_parts, cols_parts, nnz_rows = [], [], []
    elif out is None:
        out = np.empty((N,) + code_shape, dtype=out_dtype)
    if N == 0:
        if csr:
            return (np.empty(0, np.float32), np.empty(0, np.int32),
                    np.zeros(1, np.int64))
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
        zb = zb[: stop - start].cpu().numpy()
        if csr:
            v, c, rp = pack_codes_csr(zb, eps=csr_eps)
            vals_parts.append(v)
            cols_parts.append(c)
            nnz_rows.append(np.diff(rp))
        else:
            out[start:stop] = zb

    # one-deep pipeline: chunk i lands on the worker while chunk i+1 is
    # dispatched; chunk i+2 waits for chunk i to have landed
    with ThreadPoolExecutor(max_workers=1) as worker:
        landing = None
        for start in range(0, N, chunk_size):
            nxt = dispatch(start)
            if landing is not None:
                landing.result()
            landing = worker.submit(land, *nxt)
        landing.result()
    if csr:
        row_ptr = np.zeros(N + 1, np.int64)
        np.cumsum(np.concatenate(nnz_rows), out=row_ptr[1:])
        return (np.concatenate(vals_parts), np.concatenate(cols_parts),
                row_ptr)
    return out
