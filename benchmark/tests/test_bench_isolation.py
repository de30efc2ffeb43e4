"""Nothing under benchmark/ imports JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), the
reference imports nothing of the program, and a measurement refuses to run
without a card."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "piper_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


def _top(name: str) -> str:
    return name.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = [p for p in HERE.rglob("*.py") if "tests" not in p.parts]
    assert files
    for p in files:
        bad = {_top(m) for m in _imports(p)} & FORBIDDEN
        assert not bad, (p, bad)


def test_the_reference_imports_nothing_of_the_program():
    seen, todo = set(), [HERE / "reference" / "judge.py"]
    while todo:
        p = todo.pop()
        if p in seen:
            continue
        seen.add(p)
        for m in _imports(p):
            assert _top(m) not in FORBIDDEN | {"piper_tpu_torch"}, (p, m)
            if _top(m) == "benchmark":
                q = HERE.parent / (m.replace(".", "/") + ".py")
                if q.exists():
                    todo.append(q)
    assert HERE / "reference" / "vits.py" in seen and HERE / "reference" / "noise.py" in seen


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "piper_tpu_torch_fake_probe", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "piper_tpu.engine", object())
    assert run.forbidden_modules() == ["piper_tpu"]


def test_a_measurement_refuses_to_run_without_a_card(capsys):
    import torch

    from benchmark import run

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal is for machines without one")
    assert run.main(["--workload", "piper_high.offline", "--seed", "1", "--seconds", "1"]) == 2
    out, err = capsys.readouterr()
    assert out == "" and "needs 1 CUDA card" in err
