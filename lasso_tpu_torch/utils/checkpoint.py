"""Checkpoint / resume for dictionary learning.

Counterpart of the JAX package's ``utils/checkpoint.py``. The JAX package
keeps Orbax directories; the port keeps one ``torch.save`` file a step,
``<path>/<step>/state.pt``, read back with ``torch.load(weights_only=True)``
(tensors, Python scalars and strings only: loading runs no pickled code).
A step is written under a temporary name in ``<path>`` and renamed into
place by ``os.replace``, so a save cut short by a preemption never becomes
the latest step.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from pathlib import Path

import numpy as np
import torch

from lasso_tpu_torch.linear.dict_learning import (_dict_learning, _em_draws,
                                                  _generator)

_STATE = "state.pt"


def _saveable(value):
    """A numpy array becomes a tensor and a numpy scalar a Python one;
    anything else is kept."""
    if isinstance(value, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(value))
    if isinstance(value, np.generic):
        return value.item()
    if torch.is_tensor(value):
        return value.detach()
    return value


def save_checkpoint(path, state, step):
    """Save ``state``, a dict of tensors, numpy arrays and Python scalars,
    as step ``step`` under ``path`` (created if needed), replacing an
    earlier save of that step. Tensors keep their device; arrays come back
    as arrays."""
    path = Path(path).resolve()
    path.mkdir(parents=True, exist_ok=True)
    payload = {"state": {k: _saveable(v) for k, v in state.items()},
               "numpy": [k for k, v in state.items()
                         if isinstance(v, np.ndarray)]}
    tmp = Path(tempfile.mkdtemp(prefix=f".{int(step)}-", dir=path))
    torch.save(payload, tmp / _STATE)
    final = path / str(int(step))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)


def latest_step(path):
    """The largest saved step under ``path``, or None when nothing is
    saved. Temporary names of saves in progress are not steps."""
    path = Path(path)
    if not path.is_dir():
        return None
    steps = [int(p.name) for p in path.iterdir()
             if p.name.isdigit() and (p / _STATE).is_file()]
    return max(steps, default=None)


def _like(value, template):
    """``value`` in the type, dtype and device of ``template``."""
    if torch.is_tensor(template):
        return torch.as_tensor(value).to(dtype=template.dtype,
                                         device=template.device)
    if isinstance(template, np.ndarray):
        return np.asarray(value, dtype=template.dtype)
    return type(template)(value) if template is not None else value


def restore_checkpoint(path, template=None, step=None):
    """Restore the state saved by :func:`save_checkpoint`. Returns
    ``(state, step)``, the latest step when ``step`` is None, or ``(None,
    None)`` when nothing is saved.

    Tensors come back on the CPU. A ``template`` (a dict like the saved
    one) fixes the keys, which must match, and each value's type, dtype
    and device.
    """
    if step is None:
        step = latest_step(path)
    if step is None:
        return None, None
    payload = torch.load(Path(path) / str(int(step)) / _STATE,
                         map_location="cpu", weights_only=True)
    state = payload["state"]
    for k in payload["numpy"]:
        state[k] = state[k].numpy()
    if template is not None:
        if set(template) != set(state):
            raise ValueError(f"checkpoint keys {sorted(state)} differ from "
                             f"the template's {sorted(template)}")
        state = {k: _like(state[k], template[k]) for k in template}
    return state, int(step)


def dict_learning_resumable(X, n_components, alpha=1.0, constrained=True,
                            persist=False, lambd=1e-2, steps=60,
                            ckpt_dir=None, save_every=10, generator=None,
                            algorithm="ista", dict_update="sequential",
                            block_lambd=1e-6, progbar=False,
                            **solver_kwargs):
    """:func:`lasso_tpu_torch.linear.dict_learning` with periodic
    checkpoints and exact resume.

    Runs the EM loop in segments of ``save_every`` steps and, with a
    ``ckpt_dir``, saves ``(weight, Z0, losses, generator)`` after each;
    on restart it picks up from the latest saved step. Returns ``(weight,
    losses)`` as ``dict_learning`` does, and takes the same M-step options
    (``dict_update``/``block_lambd``/``progbar``).

    ``dict_learning`` draws the initial dictionary and every step's
    replacement atoms up front from ``generator`` (default: seed 0 on X's
    device). The checkpoint keeps the generator's state from before those
    draws, as the JAX package keeps its original ``key``; a resumed run
    sets ``generator`` to it, draws the same dictionary and atoms again,
    and goes on from the saved step with the saved weight, codes (for
    ``persist``) and losses. With the same arguments the result is
    therefore bit for bit that of an uninterrupted run, and with
    ``ckpt_dir=None`` that of ``dict_learning``. A resume with a larger
    ``steps`` goes on from the saved step as well, but its steps' atoms
    are drawn as one longer ``[steps, ...]`` tensor, whose first entries
    need not be those of the shorter draw: only the saved steps are shared
    with the shorter run.
    """
    if dict_update not in ("sequential", "block"):
        raise ValueError(f"dict_update must be 'sequential' or 'block', "
                         f"got {dict_update!r}")
    generator = _generator(generator, X.device)
    restored, saved_step = (restore_checkpoint(ckpt_dir)
                            if ckpt_dir is not None else (None, None))
    if restored is not None:
        generator.set_state(restored["generator"])
    gen_state = generator.get_state()
    weight, step_atoms = _em_draws(X, n_components, steps, generator,
                                   constrained, dict_update)
    Z0, start = None, 0
    losses = X.new_zeros((steps,))
    if restored is not None:
        old = restored["losses"].to(losses)
        n_keep = min(old.shape[0], steps)
        losses[:n_keep] = old[:n_keep]
        weight = restored["weight"].to(weight)
        Z0 = restored["Z0"].to(X)
        start = min(saved_step, steps)

    i = start
    while i < steps:
        n = min(save_every, steps - i)
        weight, Z0, seg_losses = _dict_learning(
            X, weight, step_atoms, alpha, constrained, persist, lambd,
            i + n, algorithm, dict_update, block_lambd, False, progbar,
            start=i, Z0=Z0, return_codes=True, **solver_kwargs)
        losses[i:i + n] = seg_losses
        i += n
        if ckpt_dir is not None:
            save_checkpoint(ckpt_dir, {"weight": weight, "Z0": Z0,
                                       "losses": losses,
                                       "generator": gen_state}, i)
    return weight, losses
