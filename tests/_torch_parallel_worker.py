"""The ranks of tests/test_torch_parallel.py: two gloo processes on the CPU.

Run by :func:`run_ranks` as ``python tests/_torch_parallel_worker.py
SCENARIO RANK WORLD DIR``. Each rank joins the group through
``lasso_tpu_torch.parallel.initialize`` on a ``FileStore`` in DIR (no TCP
port: several test workers run at once), reads the numpy inputs that the
test wrote to ``DIR/inputs.npz``, runs the port's parallel entry points on
a CPU mesh and saves what they return to ``DIR/SCENARIO-RANK.pt``. The test
holds those results against the JAX package. This module imports no JAX,
so that the ranks start without it.
"""

import os
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


def run_ranks(scenario, directory, inputs, world=2, timeout=150):
    """Run ``scenario`` on ``world`` ranks; returns each rank's results.

    The ranks start before the caller computes its oracles; the returned
    function waits for them. A rank that fails, or a run past ``timeout``
    seconds (a deadlock: ranks that part in their collectives wait for
    each other for ever), kills them all and fails with their output."""
    directory = Path(directory)
    np.savez(directory / "inputs.npz", **inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    procs = [subprocess.Popen(
        [sys.executable, __file__, scenario, str(r), str(world),
         str(directory)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    start = time.monotonic()

    def wait():
        outputs = []
        try:
            for p in procs:
                left = max(1.0, timeout - (time.monotonic() - start))
                outputs.append(p.communicate(timeout=left)[0])
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            logs = [p.communicate()[0] for p in procs]
            raise AssertionError(f"{scenario}: the ranks ran past {timeout}"
                                 f" s (a deadlock?)\n" + "\n".join(logs))
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        if failed:
            raise AssertionError(f"{scenario}: ranks {failed} failed\n"
                                 + "\n".join(outputs))
        return [torch.load(directory / f"{scenario}-{r}.pt",
                           weights_only=False) for r in range(world)]
    return wait


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if isinstance(v, (tuple, list)):
        return type(v)(_np(u) for u in v)
    return v


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _raises(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def scenario_encode(inp, rank, world):
    """The encodes on a ('data', 'model') = (2, 1) mesh, atom sharding on
    (1, 2), and the mesh and batch helpers."""
    from lasso_tpu_torch.conv2d import ista_conv2d
    from lasso_tpu_torch.linear import sparse_encode
    from lasso_tpu_torch.nonlinear import ista_nl
    from lasso_tpu_torch.parallel import (data_parallel_encode,
                                          data_parallel_encode_conv2d,
                                          data_parallel_encode_nl,
                                          make_global_mesh, make_mesh,
                                          process_local_batch)
    from lasso_tpu_torch.parallel.distributed import initialize

    out = {"initialize_again": initialize(num_processes=world,
                                          process_id=rank, backend="gloo"),
           "local_batch": process_local_batch(11)}
    mesh = make_global_mesh(devices="cpu")
    out["mesh"] = (tuple(mesh.shape), tuple(mesh.mesh_dim_names))
    x, W = _t(inp["x"]), _t(inp["W"])
    x128, W128 = _t(inp["x128"]), _t(inp["W128"])
    ista = dict(algorithm="ista", lr=0.2)

    def case(name, xx, ww, alpha=0.2, **kw):
        """One encode through data_parallel_encode and through the
        port's single-process sparse_encode, on the same inputs."""
        out[name] = _np(data_parallel_encode(mesh, xx, ww, alpha=alpha,
                                             **kw))
        kw.pop("shard_atoms", None)
        out[f"{name}_single"] = _np(sparse_encode(xx, ww, alpha, **kw))

    # ragged: 61 rows with the count, on the plain step and on the fused
    # route (the kernels' plain versions)
    case("ragged_plain", x[:61], W, maxiter=500, tol=1e-5,
         return_iters=True, **ista)
    case("ragged_fused", x[:61], W, maxiter=500, tol=1e-5,
         return_iters=True, use_pallas=True, **ista)
    case("restart", x, W, maxiter=400, tol=1e-8, restart=True,
         return_iters=True, **ista)
    case("warm_vec_alpha", x[:43], W, alpha=_t(inp["a43"]),
         z0=_t(inp["z0_43"]), maxiter=400, tol=1e-7, **ista)
    case("group", x, W, algorithm="group-ista", groups=4, lr=0.2,
         maxiter=500, tol=1e-5, return_iters=True)
    case("interior_point", x, W, algorithm="interior-point", maxiter=30)
    # per-sample stops: the ranks run on until every rank's rows stopped
    case("interior_point_rows", x[:61], W, algorithm="interior-point",
         per_sample=True, maxiter=30)
    case("cd", x128[:45], W128, algorithm="cd", maxiter=300, tol=1e-8,
         use_pallas=True)
    # the replicated route (the JAX package's GSPMD route)
    case("gspmd_gpsr", x, W, algorithm="gpsr", maxiter=200,
         return_iters=True)
    out["errors"] = [
        _raises(lambda: data_parallel_encode(mesh, x, W, algorithm="cd",
                                             return_iters=True)),
        _raises(lambda: data_parallel_encode(mesh, x, W, per_sample_tol=True,
                                             return_iters=True)),
        _raises(lambda: data_parallel_encode_conv2d(
            mesh, _t(inp["xc"]), _t(inp["kc"]), return_iters=True)),
        _raises(lambda: data_parallel_encode_nl(
            mesh, _t(inp["xn"]), _t(inp["zn"]), torch.tanh,
            return_iters=True))]
    xc, kc = _t(inp["xc"]), _t(inp["kc"])
    conv = dict(alpha=0.05, lr=0.05, padding=1, maxiter=300, tol=1e-7)
    out["conv"] = _np(data_parallel_encode_conv2d(mesh, xc, kc, **conv))
    out["conv_single"] = _np(ista_conv2d(
        xc, xc.new_zeros((13, 4, 8, 8)), kc, **conv))
    Wd = _t(inp["Wd"])
    xn, zn = _t(inp["xn"]), _t(inp["zn"])
    nl = dict(alpha=0.05, lr=0.05, maxiter=300, tol=1e-7)
    out["nl"] = _np(data_parallel_encode_nl(
        mesh, xn, zn, lambda z: torch.tanh(z) @ Wd, **nl))
    out["nl_single"] = _np(ista_nl(xn, zn, lambda z: torch.tanh(z) @ Wd,
                                   **nl))

    tp = make_mesh(model_parallel=world, devices="cpu")
    out["tp_mesh"] = tuple(tp.shape)
    mesh = tp
    case("atoms_ista", x, W, shard_atoms=True, maxiter=500, tol=1e-8,
         **ista)
    case("atoms_cd", x128, W128, shard_atoms=True, algorithm="cd",
         maxiter=300, tol=1e-8)
    return out


def scenario_train(inp, rank, world):
    """The M-steps with axis_name and the train steps on a (2, 1) mesh,
    and the atom-sharded train step on (1, 2)."""
    from lasso_tpu_torch.linear import (lasso_loss, sparse_encode,
                                        update_dict, update_dict_block,
                                        update_dict_ridge)
    from lasso_tpu_torch.parallel import (make_conv_train_step, make_mesh,
                                          make_online_train_step,
                                          make_task_driven_step,
                                          make_train_step)

    mesh = make_mesh(devices="cpu")
    group = mesh.get_group("data")
    rows = slice(rank * 32, (rank + 1) * 32)
    out = {}
    Xg, Zg, Wg = _t(inp["Xg"]), _t(inp["Zg"]), _t(inp["Wg"])
    out["ridge"] = _np(update_dict_ridge(Xg[rows], Zg[rows], lambd=1e-3,
                                         axis_name=group))
    out["update_dict"] = _np(update_dict(Wg, Xg[rows], Zg[rows],
                                         axis_name=group))
    out["update_dict_block"] = _np(update_dict_block(
        Wg, Xg[rows], Zg[rows], axis_name=group))

    x, W = _t(inp["x"]), _t(inp["W"])
    sol = dict(maxiter=300, tol=1e-8, lr=0.2)
    step, _ = make_train_step(mesh, alpha=0.2, lambd=1e-2, **sol)
    out["train"] = _np(step(x, W))
    cd = dict(algorithm="cd", maxiter=300, tol=1e-8)
    step, _ = make_train_step(mesh, alpha=0.2, lambd=1e-2, **cd)
    out["train_cd"] = _np(step(x, W))
    Z = sparse_encode(x, W, 0.2, **cd)
    out["train_cd_single"] = _np((update_dict_ridge(x, Z, lambd=1e-2),
                                  lasso_loss(x, Z, W, 0.2)))
    for upd in ("sequential", "block"):
        step, _ = make_train_step(mesh, alpha=0.2, constrained=True,
                                  dict_update=upd, **sol)
        g = torch.Generator().manual_seed(42)
        out[f"train_{upd}"] = _np(step(x, W, g))

    K = W.shape[1]
    A0 = 1e-6 * torch.eye(K)
    B0 = 1e-6 * W
    step, _ = make_online_train_step(mesh, alpha=0.2, **sol)
    out["online"] = _np(step(x, W, A0, B0))

    xc, kc = _t(inp["xc16"]), _t(inp["kc"])
    conv = dict(alpha=0.05, padding=1, lr=0.05, maxiter=100, tol=1e-8)
    for constrained in (True, False):
        step, _ = make_conv_train_step(mesh, constrained=constrained,
                                       **conv)
        out[f"conv_train_{constrained}"] = _np(step(xc, kc))

    def downstream(xx, z, w):
        return 0.5 * torch.sum(torch.square(z @ w.T - xx))

    td = dict(alpha=0.2, opt_lr=0.01, maxiter=400, tol=0.0, lr=0.15)
    step, _ = make_task_driven_step(mesh, downstream, **td)
    step_p, _ = make_task_driven_step(mesh, downstream, persist=True, **td)
    W_t, loss = step(x, W)
    W_p, loss_p, z = step_p(x, W, torch.zeros(x.shape[0], K))
    losses, W_c = [float(loss_p)], W_p
    for _ in range(3):
        W_c, loss_c, z = step_p(x, W_c, z)
        losses.append(float(loss_c))
    out["task"] = _np((W_t, loss))
    out["task_persist"] = _np((W_p, loss_p))
    out["task_losses"] = losses

    tp = make_mesh(model_parallel=world, devices="cpu")
    step, _ = make_train_step(tp, alpha=0.2, shard_atoms=True, maxiter=100,
                              lr=0.2)
    out["train_tp"] = _np(step(x, W))
    return out


SCENARIOS = {"encode": scenario_encode, "train": scenario_train}


def main(argv):
    scenario, rank, world, directory = (argv[1], int(argv[2]), int(argv[3]),
                                        Path(argv[4]))
    sys.path.insert(0, str(ROOT))
    torch.set_num_threads(1)
    import torch.distributed as dist

    from lasso_tpu_torch.parallel import initialize

    store = dist.FileStore(str(directory / f"{scenario}.store"), world)
    assert initialize(num_processes=world, process_id=rank, backend="gloo",
                      store=store, timeout=timedelta(seconds=120))
    inputs = dict(np.load(directory / "inputs.npz"))
    out = SCENARIOS[scenario](inputs, rank, world)
    torch.save(out, directory / f"{scenario}-{rank}.pt")
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
