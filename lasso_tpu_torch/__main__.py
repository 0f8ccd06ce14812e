"""Command-line interface: encode / bench on .npy arrays.

Counterpart of the JAX package's ``__main__.py``. Runs on ``--device`` (default
``cuda``; with no card it raises rather than carry on on the CPU).
Examples:

    python -m lasso_tpu_torch encode X.npy W.npy --alpha 0.2 -o Z.npy
    python -m lasso_tpu_torch bench

``encode --csr`` and ``train`` are not ported yet and raise.
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
    z = chunked_encode(x, W, alpha=args.alpha, chunk_size=args.chunk_size,
                       algorithm=args.algorithm,
                       output="csr" if args.csr else "dense", **solver_kw)
    np.save(args.out, z)
    sparsity = float((np.abs(z) < 1e-6).mean())
    print(f"encoded {x.shape[0]} samples in {time.time()-t0:.2f}s -> "
          f"{args.out} (sparsity {sparsity:.3f})")


def _cmd_train(args):
    raise NotImplementedError("train needs dictionary learning, which is "
                              "not ported yet (ROADMAP A item 5)")


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
                    help="write packed CSR (not ported yet)")
    pe.add_argument("--solver-args", default=None,
                    help='extra solver kwargs as JSON, e.g. '
                         '\'{"maxiter": 500, "tol": 1e-8}\'')
    pe.set_defaults(fn=_cmd_encode)

    pt = sub.add_parser("train", help="dictionary learning (not ported yet)")
    pt.add_argument("x", help="X.npy [N, D]")
    pt.set_defaults(fn=_cmd_train)

    pb = sub.add_parser("bench", help="run the headline benchmark")
    pb.set_defaults(fn=_cmd_bench)

    for sp in (pe, pb):
        sp.add_argument("--device", default="cuda",
                        help="torch device (default cuda)")

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
