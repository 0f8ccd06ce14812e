"""lasso_tpu_torch stands alone: it imports neither JAX nor the JAX
package, its kernel wrappers never fall back to the plain versions, and
chip_smoke.py imports neither either."""

import ast
import importlib
import inspect
import json
import pathlib
import re
import subprocess
import sys
import textwrap

import pytest
import torch

from lasso_tpu_torch.ops import _cuda

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "lasso_tpu_torch"
FORBIDDEN = re.compile(r"import jax|\blasso_tpu\b(?!_torch)")


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in PORT.rglob("*.py"))


def test_import_leaves_jax_out():
    code = ("import importlib, sys\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'lasso_tpu')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_sources_name_neither_jax_nor_the_jax_package():
    files = [p for p in PORT.rglob("*")
             if p.suffix in (".py", ".cu", ".cuh", ".cpp")]
    assert {".cu", ".cpp"} <= {p.suffix for p in files}
    hits = [f"{p.relative_to(ROOT)}:{i}: {line.strip()}"
            for p in files
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if FORBIDDEN.search(line)]
    assert not hits, hits


def test_failed_library_load_raises(monkeypatch):
    """With the loader patched to fail, every CUDA launch entry raises;
    none returns the plain version, and the kernel modules hold no
    try/except that could turn a failure into one. The exported encoder's
    operator calls sparse_encode, and an exported program reaches no
    plain version but through it."""
    def fail(name):
        raise RuntimeError(f"cannot build {name}")

    monkeypatch.setattr(_cuda, "load", fail)
    fused = importlib.import_module("lasso_tpu_torch.ops.fused_ista")
    cd = importlib.import_module("lasso_tpu_torch.ops.fused_cd")
    group = importlib.import_module("lasso_tpu_torch.ops.fused_group")
    omp = importlib.import_module("lasso_tpu_torch.ops.fused_omp")
    chol = importlib.import_module("lasso_tpu_torch.ops.batched_cholesky")
    basic = importlib.import_module("lasso_tpu_torch.linalg.basic")
    conv = importlib.import_module("lasso_tpu_torch.ops.fused_conv")
    conv_ista = importlib.import_module("lasso_tpu_torch.conv2d.ista")
    kernels = [*fused.FISTA_RESID.values(), *fused.FISTA_GRAD_PROX.values(),
               *cd.CD_STEPS.values(), cd.CD_MOD_SWEEP,
               *group.GROUP_PROX.values(), *omp.OMP_SELECT.values(),
               *omp.OMP_ORTH.values(), omp.OMP_BACKSUB,
               chol.CHOL_APPEND_SOLVE, chol.CHOL_SOLVE,
               *conv.CONV_DECODE_RESID.values(),
               *conv.CONV_ADJOINT_PROX.values()]
    for k in kernels:
        monkeypatch.setattr(k, "_fn", None)
        before = k.launches
        with pytest.raises(RuntimeError, match="cannot build"):
            k(*([0] * len(k.argtypes)))
        assert k.launches == before
    # the exported encoder's operator is sparse_encode, whose ista reaches
    # the kernels through the wrappers above (launching K1/K2 or raising
    # on a CUDA tensor); neither it nor its program calls a plain version
    export = importlib.import_module("lasso_tpu_torch.utils.export")
    called = {node.func.id for node in ast.walk(ast.parse(
        textwrap.dedent(inspect.getsource(export.ista_encode._init_fn))))
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name)}
    assert "sparse_encode" in called
    assert not any(name.endswith("_plain") for name in called)
    program = export._Encoder(0.1, None, json.dumps({"lr": 0.1}), False)
    graph = torch.export.export(program, (torch.zeros(8, 16),
                                          torch.zeros(16, 8))).graph
    targets = [str(node.target) for node in graph.nodes
               if node.op == "call_function"]
    assert targets.count("lasso_tpu_torch.ista_encode.default") == 1
    assert not any("plain" in name for name in targets)
    for mod in (fused, cd, group, omp, chol, basic, conv, conv_ista, _cuda,
                export):
        tree = ast.parse(pathlib.Path(mod.__file__).read_text())
        assert not any(isinstance(node, ast.Try) for node in ast.walk(tree))


def test_chip_smoke_imports_neither():
    src = (ROOT / "chip_smoke.py").read_text()
    tree = ast.parse(src)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert "lasso_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "lasso_tpu"}, names
