"""Command-line interface: encode / train / bench on .npy arrays.

Counterpart of the JAX package's ``__main__.py``. Runs on ``--device`` (default
``cuda``; with no card it raises rather than carry on on the CPU).
Examples:

    python -m lasso_tpu_torch encode X.npy W.npy --alpha 0.2 -o Z.npy
    python -m lasso_tpu_torch encode X.npy W.npy --csr -o Z    # Z.{values,cols,row_ptr}.npy
    python -m lasso_tpu_torch train X.npy --atoms 256 --steps 30 -o W.npy
    python -m lasso_tpu_torch train X.npy --atoms 1024 --alpha 0.1 \
        --solver-args '{"algorithm": "cd"}'
    python -m lasso_tpu_torch bench

``train`` passes ``maxiter=100, tol=0.0`` to the E-step solver unless
``--solver-args`` sets them, as the JAX package's CLI does; so
``{"algorithm": "cd-mod"}`` raises ``TypeError`` there as here (its
solver takes ``max_iter``).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def _cmd_encode(args):
    from lasso_tpu_torch.utils import chunked_encode, from_numpy_params

    x = np.load(args.x)
    W = from_numpy_params({"weight": np.load(args.weight)},
                          args.device)["weight"]
    solver_kw = json.loads(args.solver_args) if args.solver_args else {}
    t0 = time.time()
    if args.csr:
        values, cols, row_ptr = chunked_encode(
            x, W, alpha=args.alpha, chunk_size=args.chunk_size,
            algorithm=args.algorithm, output="csr", **solver_kw)
        stem = args.out.removesuffix(".npy")
        np.save(stem + ".values.npy", values)
        np.save(stem + ".cols.npy", cols)
        np.save(stem + ".row_ptr.npy", row_ptr)
        nnz = int(row_ptr[-1])
        print(f"encoded {x.shape[0]} samples in {time.time()-t0:.2f}s -> "
              f"{stem}.{{values,cols,row_ptr}}.npy "
              f"({1 - nnz / (x.shape[0] * W.shape[1]):.1%} sparse)")
        return
    z = chunked_encode(x, W, alpha=args.alpha, chunk_size=args.chunk_size,
                       algorithm=args.algorithm, **solver_kw)
    np.save(args.out, z)
    sparsity = float((np.abs(z) < 1e-6).mean())
    print(f"encoded {x.shape[0]} samples in {time.time()-t0:.2f}s -> "
          f"{args.out} (sparsity {sparsity:.3f})")


def _cmd_train(args):
    import torch
    from lasso_tpu_torch.linear import dict_learning
    from lasso_tpu_torch.utils import resolve_device

    device = resolve_device(args.device)
    X = torch.from_numpy(np.ascontiguousarray(
        np.load(args.x), dtype=np.float32)).to(device)
    solver_kw = json.loads(args.solver_args) if args.solver_args else {}
    solver_kw.setdefault("maxiter", 100)
    solver_kw.setdefault("tol", 0.0)
    t0 = time.time()
    W, losses = dict_learning(
        X, n_components=args.atoms, alpha=args.alpha,
        constrained=not args.unconstrained, dict_update=args.dict_update,
        steps=args.steps,
        generator=torch.Generator(device=device).manual_seed(args.seed),
        **solver_kw)
    W, losses = W.cpu().numpy(), losses.cpu().numpy()
    np.save(args.out, W)
    print(f"trained {args.steps} EM steps in {time.time()-t0:.2f}s -> "
          f"{args.out}; loss {losses[0]:.4f} -> {losses[-1]:.4f}")


def _cmd_bench(args):
    from lasso_tpu_torch.headline_bench import main as bench_main
    bench_main(args.device)


def main(argv=None):
    p = argparse.ArgumentParser(prog="lasso_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    pe = sub.add_parser("encode", help="sparse-encode X under dictionary W")
    pe.add_argument("x", help="X.npy [N, D]")
    pe.add_argument("weight", help="W.npy [D, K]")
    pe.add_argument("-o", "--out", default="Z.npy")
    pe.add_argument("--alpha", type=float, default=1.0)
    pe.add_argument("--algorithm", default="ista")
    pe.add_argument("--chunk-size", type=int, default=65536)
    pe.add_argument("--csr", action="store_true",
                    help="write packed CSR: <out stem>.values.npy, "
                         ".cols.npy and .row_ptr.npy")
    pe.add_argument("--solver-args", default=None,
                    help='extra solver kwargs as JSON, e.g. '
                         '\'{"maxiter": 500, "tol": 1e-8}\'')
    pe.set_defaults(fn=_cmd_encode)

    pt = sub.add_parser("train", help="dictionary learning on X")
    pt.add_argument("x", help="X.npy [N, D]")
    pt.add_argument("-o", "--out", default="W.npy")
    pt.add_argument("--atoms", type=int, required=True)
    pt.add_argument("--alpha", type=float, default=1.0)
    pt.add_argument("--steps", type=int, default=30)
    pt.add_argument("--unconstrained", action="store_true")
    pt.add_argument("--dict-update", default="sequential",
                    choices=["sequential", "block"])
    pt.add_argument("--seed", type=int, default=0)
    pt.add_argument("--solver-args", default=None,
                    help='extra dict_learning / solver kwargs as JSON, e.g. '
                         '\'{"algorithm": "cd"}\'')
    pt.set_defaults(fn=_cmd_train)

    pb = sub.add_parser("bench", help="run the headline benchmark")
    pb.set_defaults(fn=_cmd_bench)

    for sp in (pe, pt, pb):
        sp.add_argument("--device", default="cuda",
                        help="torch device (default cuda)")

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
