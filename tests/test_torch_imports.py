"""The port stands alone: it imports neither jax nor the reference package,
and it does not carry on on the CPU when asked for the GPU."""

import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_importing_every_module_leaves_jax_and_repro_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'triton')]\n"
        "assert not bad, bad\n"
        "assert len(names) >= 15, names\n"
        "print(len(names))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
    )
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax_no_repro(path):
    src = path.read_text()
    bad = re.findall(r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)(?:[.\s]|$).*", src, flags=re.M)
    assert not bad, bad
    # nor a library's attention, nor a compiled stand-in for a kernel
    if path.name != "chip_smoke.py":        # which times the library call as a yardstick
        assert "scaled_dot_product_attention" not in src
    assert "torch.compile" not in src


def test_cuda_asked_for_without_a_card_raises():
    """on a machine without a GPU (this test's place) the default device
    raises; nothing falls back to the CPU"""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is there")
    from repro_torch.launch import serve
    from repro_torch.models.param import ParamSpec, tree_init

    with pytest.raises(RuntimeError, match="cuda"):
        serve.run(serve.build_parser().parse_args([]))
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--gen", "2"])
    with pytest.raises((RuntimeError, AssertionError)):
        tree_init({"w": ParamSpec((2,), (None,))}, torch.Generator())      # device defaults to cuda


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""          # no result line of any kind
