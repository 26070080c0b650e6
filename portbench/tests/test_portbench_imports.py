"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), the
plain reference imports nothing of the port, and a run refuses to print a
result without a card or with JAX loaded."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from portbench import run
from portbench.run import BENCH_DIR, FORBIDDEN, ROOT

SOURCES = sorted(BENCH_DIR.rglob("*.py"))


def top_level_imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_jax_import(path):
    assert not top_level_imports(path) & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "lanczos_tpu_torch" not in top_level_imports(path)


def test_only_drivers_import_the_port():
    importers = {p.relative_to(BENCH_DIR).parts[0] for p in SOURCES
                 if "lanczos_tpu_torch" in top_level_imports(p)}
    assert importers <= {"drivers", "tests"}


def test_forbidden_modules_compares_whole_names():
    """In a fresh process: a test worker's sys.modules holds what other
    tests loaded (the repository's JAX tests load jax)."""
    code = ("import sys; from portbench import run; "
            "sys.modules['lanczos_tpu_torch_fake'] = object(); "
            "print(run.forbidden_modules()); "
            "sys.modules['lanczos_tpu.fake'] = object(); "
            "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.split("\n")[:2] == ["[]", "['lanczos_tpu']"]


def test_no_card_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "maxwell160-fdtd", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""
