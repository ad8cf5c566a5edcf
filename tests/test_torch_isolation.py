"""The port stands alone: no module of qtpu_torch, and not chip_smoke.py,
imports jax, flax, optax or the qtpu package (qtpu_torch itself aside).
The card's machine has no JAX, so a stray import would break the port
there while every CPU test still passed."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "qtpu")
FILES = sorted((ROOT / "qtpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module


def test_port_files_exist():
    assert (ROOT / "chip_smoke.py").exists()
    assert len(FILES) > 20


def test_parallel_package_walked():
    """The walk covers the parallel runtime, every module of it."""
    walked = {p.relative_to(ROOT).as_posix() for p in FILES}
    for name in ("__init__", "collectives", "distributed", "launch", "mesh",
                 "pipeline", "spatial"):
        assert f"qtpu_torch/parallel/{name}.py" in walked, name


def test_bench_package_walked():
    """The walk covers the bench tooling, every module of it."""
    walked = {p.relative_to(ROOT).as_posix() for p in FILES}
    for name in ("__init__", "timing", "receipts", "profile", "tracing",
                 "scaling", "scaling_projection"):
        assert f"qtpu_torch/bench/{name}.py" in walked, name


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_qtpu_imports(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
