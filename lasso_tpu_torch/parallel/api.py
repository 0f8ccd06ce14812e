"""Sharded entry points: data-parallel encoding and dictionary learning.

Counterpart of the JAX package's ``parallel/api.py`` on
``torch.distributed``, one process per device of the mesh
(:func:`lasso_tpu_torch.parallel.make_mesh`). Every rank calls an entry
point with the same global tensors, as a JAX caller passes global arrays,
and gets back the whole result: the codes of all N rows (gathered over
'data' and sliced back to N), or the replicated dictionary and loss.
Tensors go to the mesh's device ('cuda' by default).

Two routes, as in the JAX package:

* **shard-map route** (the solvers of ``_SHARD_MAP_ALGOS`` without atom
  sharding): each rank runs the port's own single-process solver on its
  rows, so that its kernels see the local shapes. The solvers with a
  batch-global stop take the 'data' group as ``axis_name`` and all-reduce
  their stopping sums; the M-steps all-reduce their Gram statistics.
  Ragged batches are zero-padded to equal local shapes, so that every
  rank makes the same routing choices and the same collectives.
* **replicated route** (``shard_atoms=True`` and the other algorithms):
  where the JAX package lets XLA partition a plain solve (GSPMD), every
  rank runs the single-process solve of the whole batch, kernels and
  all, as one process does. Truly atom-sharded solves are not ported.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from lasso_tpu_torch.config import get_precision
from lasso_tpu_torch.linear.dict_learning import (lasso_loss, update_dict,
                                                  update_dict_block,
                                                  update_dict_online,
                                                  update_dict_ridge)
from lasso_tpu_torch.linear.sparse_encode import sparse_encode
from lasso_tpu_torch.ops.common import matmul, psum
from lasso_tpu_torch.parallel.mesh import (data_sharding, replicated,
                                           weight_sharding)

# Solver families on the shard-map route (local shapes, so their kernels
# run on each rank's rows). 'ista', 'interior-point' and 'group-ista' stop
# on batch-global statistics and take the 'data' group as axis_name; cd,
# cd-mod and omp stop per sample, so ranks leave their loops on their own.
_SHARD_MAP_ALGOS = ("ista", "cd", "cd-mod", "interior-point", "omp",
                    "group-ista")
_AXIS_NAME_ALGOS = ("ista", "interior-point", "group-ista")


def _device(mesh):
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _on(mesh, a):
    return torch.as_tensor(a).to(_device(mesh))


def _data_size(mesh):
    return mesh.size(mesh.mesh_dim_names.index("data"))


def _data_group(mesh):
    return mesh.get_group("data")


def _data_pad(mesh, n_rows):
    """Zero rows of padding that make n_rows divisible by the 'data' axis
    size (0 when already divisible)."""
    return (-n_rows) % _data_size(mesh)


def _pad_rows(arr, n_pad, fill=0.0):
    """Append ``n_pad`` constant rows to a batched tensor."""
    if n_pad == 0:
        return arr
    pad = torch.full((n_pad,) + tuple(arr.shape[1:]), fill, dtype=arr.dtype,
                     device=arr.device)
    return torch.cat([arr, pad])


def _local_rows(mesh, arr):
    """This rank's rows of a batch whose size the 'data' axis divides."""
    n = _data_size(mesh)
    if arr.shape[0] % n != 0:
        raise ValueError(f"a batch of {arr.shape[0]} rows does not split "
                         f"over a 'data' axis of {n}")
    per = arr.shape[0] // n
    r = mesh.get_local_rank("data")
    return arr[r * per:(r + 1) * per]


def _gather_rows(mesh, local):
    """The rows of every rank of 'data', in rank order."""
    n = _data_size(mesh)
    if n == 1:
        return local
    local = local.contiguous()
    parts = [torch.empty_like(local) for _ in range(n)]
    dist.all_gather(parts, local, group=_data_group(mesh))
    return torch.cat(parts)


def _shard_solve(mesh, solve, x, z0=None, alpha=None, kwargs=None,
                 rescale_tol=True):
    """Run a row-wise solve on this rank's rows of the batch and gather.

    x, ``z0`` and a per-sample ``alpha`` (padded with ones: any positive
    penalty keeps a zero row's codes zero) are zero-padded to a multiple
    of the 'data' size; with ``rescale_tol``, ``kwargs['tol']`` is scaled
    by ``N / N_padded``, since the padded rows add 0 to the global
    ``sum|dz|`` but would inflate its ``numel``. ``solve(x, z0, alpha,
    kwargs) -> (codes, extra)`` gets this rank's rows (None stays None);
    returns the codes of all N rows, gathered in rank order, and
    ``extra``."""
    kwargs = {} if kwargs is None else kwargs
    n_rows = x.shape[0]
    n_pad = _data_pad(mesh, n_rows)
    if n_pad:
        x = _pad_rows(x, n_pad)
        if z0 is not None:
            z0 = _pad_rows(z0, n_pad)
        if alpha is not None:
            alpha = _pad_rows(alpha, n_pad, fill=1.0)
        if rescale_tol:
            kwargs["tol"] = (kwargs.get("tol", 1e-5)
                             * n_rows / (n_rows + n_pad))

    def local(a):
        return None if a is None else _local_rows(mesh, a)

    z, extra = solve(local(x), local(z0), local(alpha), kwargs)
    return _gather_rows(mesh, z)[:n_rows], extra


def _global_mean(value, n_local, group, like):
    """A per-sample mean over this rank's ``n_local`` rows, made the mean
    over the whole batch: sum of ``value * n_local`` over N."""
    n_global = psum(torch.tensor(n_local, dtype=like.dtype,
                                 device=like.device), group)
    return psum(value * n_local, group) / n_global


def _check_return_iters(algorithm, kwargs):
    if bool(kwargs.get("return_iters")) and (
            algorithm in ("cd", "cd-mod", "omp")
            or kwargs.get("per_sample_tol") or kwargs.get("per_sample")):
        raise ValueError(
            "return_iters is not supported under data_parallel_encode "
            "for solvers with per-sample stopping (cd, cd-mod, omp, or "
            "per_sample/per_sample_tol modes): each rank exits its loop "
            "at a different count, so there is no single global iteration "
            "count to return. Call the solver on your rows directly if "
            "you need per-rank counts.")


def data_parallel_encode(mesh, x, weight, alpha=1.0, shard_atoms=False,
                         algorithm="ista", **kwargs):
    """Shard the batch over the mesh's 'data' axis and encode.

    Per-sample solves are independent; the only collectives are the
    solver's stopping sums (for the solvers that have them), one a block,
    and the final gather of the codes.

    Ragged batches (N not divisible by the 'data' size) are zero-padded to
    the next multiple and the codes sliced back: a zero row solves a zero
    problem, so its codes are exactly zero and it adds 0 to the global
    ``sum|dz|``. For ista and group-ista ``tol`` is rescaled by ``N /
    N_padded`` so that the global threshold ``numel * tol`` is that of the
    unpadded batch, and the solve stops where the single-process one
    does. For 'interior-point' the padding rows dilute the batch-mean
    stopping statistics (the padded run can stop a little later, never
    with worse iterates); pass ``per_sample=True`` there for exact ragged
    stopping. A per-sample ``alpha`` ([N] or [N, 1]) and ``z0`` are split
    with the rows (alpha padded with ones).

    Returns the codes [N, K] on every rank; with ``return_iters=True``
    also the iteration count, the same on every rank.
    """
    _check_return_iters(algorithm, kwargs)
    return_iters = bool(kwargs.get("return_iters"))
    x, weight = _on(mesh, x), _on(mesh, weight)
    if algorithm not in _SHARD_MAP_ALGOS or shard_atoms:
        return sparse_encode(x, weight, alpha=alpha, algorithm=algorithm,
                             **kwargs)

    z0 = kwargs.pop("z0", None)
    a_arr = torch.as_tensor(alpha)
    # only the per-sample forms ((N,) / (N, 1)) split over 'data'; a
    # per-feature [1, K] row is batch-invariant, like a scalar
    vec_alpha = (a_arr.ndim >= 1 and a_arr.shape[0] == x.shape[0]
                 and (a_arr.ndim == 1 or tuple(a_arr.shape[1:]) == (1,)))
    if algorithm in _AXIS_NAME_ALGOS:
        kwargs["axis_name"] = _data_group(mesh)

    def solve(x_l, z0_l, a_l, kw):
        if z0_l is not None:
            kw["z0"] = z0_l
        out = sparse_encode(x_l, weight, alpha=alpha if a_l is None else a_l,
                            algorithm=algorithm, **kw)
        return out if return_iters else (out, None)

    z, k = _shard_solve(
        mesh, solve, x, None if z0 is None else _on(mesh, z0),
        _on(mesh, a_arr) if vec_alpha else None, kwargs,
        rescale_tol=(algorithm in ("ista", "group-ista")
                     and not kwargs.get("per_sample_tol")))
    return (z, k) if return_iters else z


def data_parallel_encode_conv2d(mesh, x, weight, alpha=1.0, z0=None,
                                stride=1, padding=0, **kwargs):
    """Shard a conv sparse-coding batch over the mesh's 'data' axis.

    x: [N, C_x, H, W], weight: [C_z, C_x, kh, kw] replicated. The solver's
    batch-global stopping sum is all-reduced over 'data'
    (``ista_conv2d(axis_name=...)``). Ragged batches are zero-padded, with
    ``tol`` rescaled, and the codes sliced back. ``z0`` defaults to zeros
    of the conv geometry's code shape. Returns the codes on every rank.
    """
    from lasso_tpu_torch.conv2d.ista import ista_conv2d
    from lasso_tpu_torch.conv2d.ops import _code_shape

    if kwargs.get("return_iters"):
        raise ValueError("return_iters is not supported under "
                         "data_parallel_encode_conv2d")
    x, weight = _on(mesh, x), _on(mesh, weight)
    z0 = (x.new_zeros(_code_shape(x.shape, weight.shape, stride, padding))
          if z0 is None else _on(mesh, z0))

    def solve(x_l, z0_l, _, kw):
        return ista_conv2d(x_l, z0_l, weight, alpha, stride=stride,
                           padding=padding, axis_name=_data_group(mesh),
                           **kw), None

    return _shard_solve(mesh, solve, x, z0, kwargs=kwargs)[0]


def data_parallel_encode_nl(mesh, x, z0, decoder, alpha=1.0, **kwargs):
    """Shard a nonlinear sparse-coding batch over the mesh's 'data' axis.

    ``decoder`` must act row by row, since each rank applies it to its own
    rows. The batch-global stopping sum is all-reduced over 'data'
    (``ista_nl(axis_name=...)``); the per-sample Hessian power iteration
    is row-local. Ragged batches are zero-padded with ``tol`` rescaled:
    the padded rows' deltas are 0 when ``decoder(0) == 0`` (exact
    stopping parity) and otherwise only add to the global ``sum|dz|``, so
    the padded run may stop later, never earlier. Returns the codes on
    every rank.
    """
    from lasso_tpu_torch.nonlinear.ista import ista_nl

    if kwargs.get("return_iters"):
        raise ValueError("return_iters is not supported under "
                         "data_parallel_encode_nl")

    def solve(x_l, z0_l, _, kw):
        return ista_nl(x_l, z0_l, decoder, alpha=alpha,
                       axis_name=_data_group(mesh), **kw), None

    return _shard_solve(mesh, solve, _on(mesh, x), _on(mesh, z0),
                        kwargs=kwargs)[0]


def make_train_step(mesh, alpha=1.0, lambd=1e-2, shard_atoms=False,
                    algorithm="ista", constrained=False,
                    dict_update="sequential", block_lambd=1e-6,
                    **solver_kwargs):
    """One EM step of dictionary learning over a mesh.

    x splits over 'data' (N must divide by its size); W is replicated.
    The ridge update's ``Z^T Z`` / ``Z^T X`` are all-reduced over 'data',
    and so is the loss (the mean over the whole batch).

    ``constrained=False`` (default) takes the unconstrained ridge M-step
    and returns ``step(x, W) -> (W_new, loss)``. ``constrained=True``
    mirrors :func:`lasso_tpu_torch.linear.dict_learning` (unit-norm atoms,
    degenerate atoms redrawn; ``dict_update`` 'sequential', an all-reduce
    of each atom's ``Z[:, k]^T R``, or 'block', one all-reduced joint ridge
    fit) and returns ``step(x, W, generator) -> (W_new, loss)``: the
    ``torch.Generator`` (on the mesh's device) draws the replacement atoms
    and must be seeded alike on every rank. Returns the step and the
    placements ``(x_sharding, w_sharding)``.
    """
    if dict_update not in ("sequential", "block"):
        raise ValueError(f"dict_update must be 'sequential' or 'block', "
                         f"got {dict_update!r}")
    x_sh = data_sharding(mesh)
    w_sh = weight_sharding(mesh, shard_atoms)

    def m_step(x, weight, Z, generator, axis_name=None):
        if not constrained:
            return update_dict_ridge(x, Z, lambd=lambd, axis_name=axis_name)
        if dict_update == "sequential":
            W_new, _ = update_dict(weight, x, Z, generator=generator,
                                   axis_name=axis_name)
        else:
            W_new, _ = update_dict_block(weight, x, Z, generator=generator,
                                         lambd=block_lambd,
                                         axis_name=axis_name)
        return W_new

    if algorithm in _SHARD_MAP_ALGOS and not shard_atoms:
        group = _data_group(mesh)
        extra = {"axis_name": group} if algorithm in _AXIS_NAME_ALGOS else {}

        def step(x, weight, generator=None):
            x = _local_rows(mesh, _on(mesh, x))
            weight = _on(mesh, weight)
            Z = sparse_encode(x, weight, alpha, algorithm=algorithm,
                              **extra, **solver_kwargs)
            loss = _global_mean(lasso_loss(x, Z, weight, alpha), x.shape[0],
                                group, x)
            return m_step(x, weight, Z, generator, axis_name=group), loss
    else:
        def step(x, weight, generator=None):
            x, weight = _on(mesh, x), _on(mesh, weight)
            Z = sparse_encode(x, weight, alpha, algorithm=algorithm,
                              **solver_kwargs)
            return (m_step(x, weight, Z, generator),
                    lasso_loss(x, Z, weight, alpha))

    if constrained:
        return step, (x_sh, w_sh)
    return (lambda x, weight: step(x, weight)), (x_sh, w_sh)


def make_task_driven_step(mesh, downstream_loss, alpha=0.1, opt_lr=0.05,
                          algorithm="ista", normalize_atoms=True,
                          persist=False, **enc_kwargs):
    """One task-driven dictionary-training step over a mesh.

    Each rank encodes its rows of x with the implicit encoder
    (:func:`lasso_tpu_torch.linear.make_implicit_encoder`; for ista,
    interior-point and group-ista its forward stops on the batch-global
    sum, all-reduced over 'data'), the codes are gathered, and
    ``downstream_loss(x, z, weight) -> scalar`` (the user's objective
    over the whole batch) is evaluated on every rank alike. Its gradient
    in z sends each rank's rows back through that rank's implicit
    backward (a per-row masked CG); those partial dictionary gradients
    are all-reduced over 'data' and added to the loss's direct gradient
    in W, once. ``normalize_atoms`` clips atom norms to <= 1 after the
    gradient step. ``enc_kwargs`` go to the encoder and its solver.

    Returns ``(step, (x_sharding, w_sharding))`` with ``step(x, W) ->
    (W_new, loss)``; with ``persist=True`` ``step(x, W, Z0) -> (W_new,
    loss, Z)``: the encoder warm-starts from ``Z0`` (the previous step's
    codes) and returns the new codes. The warm start has zero cotangent,
    so the gradients are unchanged. N must divide by the 'data' size.
    """
    from lasso_tpu_torch.linear.implicit import make_implicit_encoder

    group = _data_group(mesh)
    if algorithm in _AXIS_NAME_ALGOS:
        enc_kwargs["axis_name"] = group
    enc = make_implicit_encoder(algorithm=algorithm, **enc_kwargs)
    x_sh, w_sh = data_sharding(mesh), replicated(mesh)

    def run(x, weight, z0):
        x, weight = _on(mesh, x), _on(mesh, weight)
        x_l = _local_rows(mesh, x)
        z0_l = None if z0 is None else _local_rows(mesh, _on(mesh, z0))
        w = weight.detach().requires_grad_(True)
        with torch.enable_grad():
            z_l = enc(x_l, w, torch.as_tensor(alpha, dtype=x.dtype,
                                              device=x.device), z0_l)
            z = _gather_rows(mesh, z_l.detach()).requires_grad_(True)
            loss = downstream_loss(x, z, w)
            g_direct, g_z = torch.autograd.grad(loss, (w, z),
                                                allow_unused=True)
            if g_z is None:
                g_z = torch.zeros_like(z)
            g, = torch.autograd.grad(z_l, w,
                                     grad_outputs=_local_rows(mesh, g_z))
        g = psum(g, group)
        if g_direct is not None:
            g = g + g_direct
        w_new = weight - opt_lr * g
        if normalize_atoms:
            w_new = w_new / torch.clamp_min(torch.linalg.vector_norm(
                w_new, dim=0, keepdim=True), 1.0)
        return w_new, loss.detach(), z.detach()

    if persist:
        return run, (x_sh, w_sh)

    def step(x, weight):
        return run(x, weight, None)[:2]
    return step, (x_sh, w_sh)


def make_conv_train_step(mesh, alpha=1.0, kernel_size=7, stride=1,
                         padding=0, constrained=True, lambd=None,
                         cg_iters=30, eps=1e-10, **solver_kwargs):
    """One EM step of convolutional dictionary learning over the mesh (see
    :func:`lasso_tpu_torch.conv2d.conv_dict_learning`).

    ``step(x, weight, generator=None) -> (weight_new, loss)``: the image
    batch x [N, C, H, W] splits over 'data' (N must divide by its size);
    the filters are replicated. The encode's stopping sum is all-reduced
    over 'data' (``ista_conv2d(axis_name=...)``) and so are the M-step
    CG's adjoint outputs (``update_kernel(axis_name=...)``): one
    filter-sized all-reduce a CG iteration, the CG state the same on every
    rank. The ``torch.Generator`` draws the replacement filters and must
    be seeded alike on every rank.
    """
    from lasso_tpu_torch.conv2d.dict_learning import (
        conv_lasso_loss, update_kernel, update_kernel_constrained)
    from lasso_tpu_torch.conv2d.ista import ista_conv2d
    from lasso_tpu_torch.conv2d.ops import _code_shape

    if lambd is None:
        lambd = 1e-6 if constrained else 1e-4
    group = _data_group(mesh)

    def step(x, weight, generator=None):
        x = _local_rows(mesh, _on(mesh, x))
        weight = _on(mesh, weight)
        z0 = x.new_zeros(_code_shape(x.shape, weight.shape, stride, padding))
        Z = ista_conv2d(x, z0, weight, alpha, stride=stride,
                        padding=padding, axis_name=group, **solver_kwargs)
        loss = _global_mean(conv_lasso_loss(x, Z, weight, alpha,
                                            stride=stride, padding=padding),
                            x.shape[0], group, x)
        if constrained:
            W_new, _ = update_kernel_constrained(
                x, Z, weight, generator, stride=stride, padding=padding,
                lambd=lambd, cg_iters=cg_iters, eps=eps, axis_name=group)
        else:
            W_new = update_kernel(x, Z, weight, stride=stride,
                                  padding=padding, lambd=lambd,
                                  cg_iters=cg_iters, axis_name=group)
        return W_new, loss

    return step, (data_sharding(mesh), replicated(mesh))


def make_online_train_step(mesh, alpha=1.0, algorithm="ista", forget=None,
                           positive=False, eps=1e-10, dict_sweeps=1,
                           **solver_kwargs):
    """One online dictionary-learning step over the mesh (the minibatch
    update of Mairal et al.; see
    :func:`lasso_tpu_torch.linear.dict_learning_online`).

    ``step(x_t, W, A, B) -> (W_new, A_new, B_new, loss)``: the minibatch
    splits over 'data'; the dictionary and the statistics A [K, K] and B
    [D, K] are replicated. The per-rank partials ``Z^T Z`` and ``x^T Z``
    are all-reduced over 'data' (the atom sweep then runs on replicated
    tensors), so a step moves O(K^2 + DK) values whatever the minibatch
    size. Returns the step and the placements ``(x_sharding,
    replicated)``.
    """
    gamma = 1.0 if forget is None else float(forget)
    if algorithm not in _SHARD_MAP_ALGOS:
        raise ValueError(
            f"make_online_train_step supports the shard-map solver "
            f"routes {_SHARD_MAP_ALGOS}, got {algorithm!r}")
    group = _data_group(mesh)
    extra = {"axis_name": group} if algorithm in _AXIS_NAME_ALGOS else {}
    prec = get_precision(None)

    def step(x, weight, A, B):
        x = _local_rows(mesh, _on(mesh, x))
        weight, A, B = _on(mesh, weight), _on(mesh, A), _on(mesh, B)
        Z = sparse_encode(x, weight, alpha, algorithm=algorithm, **extra,
                          **solver_kwargs)
        n_g = psum(torch.tensor(x.shape[0], dtype=x.dtype, device=x.device),
                   group)
        loss = psum(lasso_loss(x, Z, weight, alpha) * x.shape[0],
                    group) / n_g
        A_new = gamma * A + psum(matmul(Z.T, Z, prec), group) / n_g
        B_new = gamma * B + psum(matmul(x.T, Z, prec), group) / n_g
        W_new = update_dict_online(weight, A_new, B_new, sweeps=dict_sweeps,
                                   positive=positive, eps=eps)
        return W_new, A_new, B_new, loss

    return step, (data_sharding(mesh), replicated(mesh))
