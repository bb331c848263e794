"""What the benchmark may import, and that it never measures on the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "chipbench"
SOURCES = sorted(HERE.rglob("*.py"))
# the reference side: what the plain reference and the inputs it reads are made of,
# each family's layout and plain model among them
REFERENCE_SIDE = ("reference.py", "data.py", "weights.py", "work.py", "compare.py", "registry.py",
                  *sorted(str(p.relative_to(HERE)) for p in (HERE / "models").glob("*.py")))


def _imports(path: Path) -> set[str]:
    """Top-level names of every module a file imports (the part before the
    first dot, compared whole)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("name", REFERENCE_SIDE)
def test_the_reference_imports_nothing_of_the_program(name):
    seen, todo = set(), [HERE / name]
    while todo:         # the file and the benchmark's modules it imports
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        tree = ast.parse(path.read_text())
        assert "repro_torch" not in _imports(path), path
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and (node.module or "").split(".")[0] in ("chipbench", ""):
                todo.extend(HERE / f"{a.name}.py" for a in node.names if (HERE / f"{a.name}.py").exists())


def test_the_check_names_its_forbidden_modules_whole():
    sys.path.insert(0, str(ROOT))
    from chipbench import run

    assert set(run.FORBIDDEN) == {"jax", "jaxlib", "flax", "repro"}
    assert "repro_torch".split(".")[0] not in run.FORBIDDEN


def test_without_a_card_it_exits_and_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", HOME=str(tmp_path))
    p = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", "granite-8b.prefill",
                        "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode == 2
    assert p.stdout == ""
    assert "no run on the CPU" in p.stderr


def test_the_control_script_refuses_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", HOME=str(tmp_path))
    p = subprocess.run([sys.executable, str(HERE / "control.py"), "--workload", "granite-8b.prefill",
                        "--seeds", "1"], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode == 2 and p.stdout == ""
