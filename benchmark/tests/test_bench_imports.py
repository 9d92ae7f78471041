"""The import rule, by an AST walk over every Python file of the
benchmark: no ``jax``, ``jaxlib``, ``flax`` or ``pothoscomms_tpu``, each
compared by whole top-level name (``pothoscomms_tpu_torch`` is the port);
the references, counts, metric readers and the generator import nothing
of the port; nothing imports the repo's older bench code."""

import ast
import sys
from pathlib import Path

import pytest

from benchmark import harness

BENCH = Path(__file__).resolve().parents[1]
FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)
PLAIN = [p for p in FILES if p.parent.name in ("reference", "counts",
                                               "metrics")
         or p.name == "generate.py"]
OLD = {"bench", "benches", "benches_torch", "chip_smoke", "bench_suite"}


def top_names(path: Path):
    """The whole top-level names of every module ``path`` imports."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_files_found():
    assert any(p.name == "run.py" for p in FILES) and len(PLAIN) >= 8


def rel(p: Path) -> str:
    return str(p.relative_to(BENCH))


@pytest.mark.parametrize("path", FILES, ids=rel)
def test_no_jax_and_no_jax_package(path):
    names = set(top_names(path))
    assert not names & set(harness.FORBIDDEN), names
    assert not names & OLD, names


@pytest.mark.parametrize("path", PLAIN, ids=rel)
def test_plain_files_import_nothing_of_the_port(path):
    names = set(top_names(path))
    assert not {n for n in names if n.startswith("pothoscomms")}, names


def test_whole_name_comparison():
    """``pothoscomms_tpu_torch`` begins with ``pothoscomms_tpu`` but is
    not it; ``jaxtyping`` is not ``jax``."""
    probe = "pothoscomms_tpu_torch.core"
    assert probe.split(".")[0] not in harness.FORBIDDEN
    assert "jaxtyping" not in harness.FORBIDDEN


def test_runtime_guard_sees_a_loaded_module(monkeypatch):
    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake_probe", object())
    monkeypatch.setitem(sys.modules, "pothoscomms_tpu_torch_probe", object())
    got = harness.forbidden_modules()
    assert "jaxlib.fake_probe" in got
    assert "pothoscomms_tpu_torch_probe" not in got
    assert set(got) - set(before) == {"jaxlib.fake_probe"}
