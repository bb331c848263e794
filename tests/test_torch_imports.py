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


def test_planner_layers_run_without_jax_or_repro(tmp_path):
    """The planner layers import much inside their functions: run each
    (the netsim-backed planner, the simulator, co-design, the campaign and
    its trace, the decode-serving planner, ``--auto-parallel``) and hold
    the loaded modules to the same rule."""
    code = (
        "import sys\n"
        "from repro_torch.core import codesign, cost_model as cm, perf_model, planner, simulator, topology, traffic\n"
        "from repro_torch.launch import serve, train\n"
        "from repro_torch.runtime import campaign\n"
        "w = traffic.backend_comparison_workloads()[1]\n"
        "comm = cm.build_comm_model(multi_pod=False, routing=cm.Routing.DETOUR)\n"
        "perf = perf_model.NetsimPerfModel(comm, topo=topology.ub_mesh_pod(), size_bytes=4e6, cache_dir=None)\n"
        "r = planner.plan(w, 256, perf, top_k=1)\n"
        "simulator.linearity_curve(w, 512, [1, 2])\n"
        "codesign.prefilter_geometries(w, codesign.enumerate_geometries(uplinks=(64,)), 1024)\n"
        "h = campaign.head_to_head(chips=1024, seeds=(0,), netsim_reprice=False)\n"
        "campaign.campaign_trace(h['ub'].runs[0])\n"
        "sw = traffic.WorkloadSpec('s', 4, 1024, 8, 128, 8, seq_len=512, global_batch=8, params_total=1e9)\n"
        "serve.plan_decode(sw, 16, serve.rack_perf_model(cache_dir=None), qps=10.0, slo_s=0.01, duration_s=1.0)\n"
        "train.plan_parallelism(train.load('granite-8b', smoke=True), "
        "train.build_parser().parse_args(['--auto-parallel']))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'triton')]\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "CALIB_CACHE_DIR": str(tmp_path)},
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
