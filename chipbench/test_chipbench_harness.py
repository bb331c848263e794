"""The harness finds each piece of a cell by name, and the metric readers
read what they should from a trace."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chipbench import compare, readers, registry, run, trace, work  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_pieces(name):
    cell = run.load_cell(name)
    assert cell.cfg["name"] == next(w["config"] for w in BENCH["workloads"] if w["name"] == name)
    kind = registry.kind(cell.mix)
    assert all(callable(getattr(kind, f)) for f in ("window", "trace_context", "check", "control"))
    family = registry.family(cell.cfg)
    assert family.leaf_specs(cell.cfg) and callable(family.Reference)
    assert callable(registry.module("programs", cell.cfg["family"]).harness)
    assert cell.limits["limits"]
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.end_to_end:
        assert callable(run.reader("end_to_end", m["name"]))
    for m in cell.per_layer:
        assert m["moves"] in names
        assert callable(run.reader("metrics", m["name"]))


# a cell of a new kind of traffic, on a configuration of a new family, added
# as files alone: the harness's own files are copied unchanged
NEW_FILES = {
    "configs/toy.json": json.dumps({"family": "toy", "width": 64}),
    "mixes/echo_mix.json": json.dumps({"kind": "echo", "rows": 8}),
    "checks/toy.echo.json": json.dumps({"limits": {"echo_gap": 1e-6}}),
    "models/toy.py": """
import torch


def leaf_specs(cfg):
    return [(("w",), (cfg["width"], cfg["width"]), "scaled", cfg["width"] ** -0.5)]


class Reference:
    def __init__(self, cfg, precision="fp32"):
        self.cfg = cfg

    def forward(self, w, x):
        return x.double() @ w.double()
""",
    "programs/toy.py": """
def harness(cfg):
    import torch

    return lambda w, x: (x.float() @ w.float()).to(torch.bfloat16)
""",
    "kinds/echo.py": """
import time

import torch

from chipbench import reference, registry, weights

FAULTS = ()


class Result:
    attempted = failed = 0


def window(cell, seed, seconds, device, trace=None):
    fn = registry.module("programs", cell.cfg["family"]).harness(cell.cfg)
    w = weights.draw(cell.cfg, seed, device)["w"]
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(cell.mix["rows"], cell.cfg["width"], generator=gen, device=device)
    res = Result()
    res.t_start = time.perf_counter()
    while time.perf_counter() - res.t_start < seconds or not res.attempted:
        res.y = fn(w, x)
        res.attempted += 1
    res.window_s = time.perf_counter() - res.t_start
    res.x = x
    return res


def trace_context(cell, res):
    return {}


def check(cell, res, seed, device):
    w = weights.draw(cell.cfg, seed, device)["w"]
    want = reference.model(cell.cfg).forward(w, res.x)
    gap = float((res.y.double() - want).norm() / want.norm())
    return {"echo_gap": gap}, {}


def control(cell, seed, device, fault=None):
    return {}
""",
    "end_to_end/echo_per_s.py": "def read(run):\n    return run.res.attempted / run.res.window_s\n",
}


def test_a_new_cell_runs_from_files_and_an_entry(tmp_path):
    """A configuration of a new family, a mix of a new kind, its check and
    an end-to-end metric added as files and entries; one run of the cell
    goes through ``run.run_cell`` (on the CPU, the look for a card left
    out) and is judged by its file's limit: bf16 rounding reads over 1e-6."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "chipbench", root / "chipbench", ignore=shutil.ignore_patterns("__pycache__"))
    for name, text in NEW_FILES.items():
        (root / "chipbench" / name).write_text(text)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy", "source": "https://example.org", "reduced": [],
                             "file": "chipbench/configs/toy.json", "why": "a test"})
    bench["workloads"].append({"name": "toy.echo", "config": "toy", "traffic": "echo_mix", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "echo_per_s", "unit": "1/s", "better": "higher", "bound": 0.05,
                                "source": "host_clock", "workloads": ["toy.echo"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys; from chipbench import run; cell = run.load_cell('toy.echo'); "
            "print(json.dumps(run.run_cell(cell, 3000000011, 0.2, False, 'cpu')))")
    p = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=str(root)))
    assert p.returncode == 0, p.stderr
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert sorted(out["metrics"]) == ["echo_per_s", "setup_s"] and out["attempted"] >= 1
    assert out["correct"] is False and out["checks"]["echo_gap"]["value"] > 1e-6


def _train_ctx(cfg, kernels, spans=None, steps=2, window_s=1.0, numels=(10, 20)):
    ctx = {"kernels": sorted(kernels, key=lambda k: k[1]), "device_spans": spans or {}, "host_spans": {},
           "host_ops": [], "cfg": cfg, "mix": {"batch": 2, "seq": 64}, "kind": "train", "steps": steps,
           "window_s": window_s, "leaf_numels": list(numels)}
    ctx["busy_s"] = trace.union_ns(ctx["kernels"]) / 1e9
    return ctx


CFG = dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, head_dim=32,
           intermediate_size=256, vocab_size=512, sliding_window=None)


def test_readers_on_a_made_up_trace():
    k = [("void tc::flash_fwd_tc_kernel<128>(Params)", 0, 1000), ("ccu_kernel", 1000, 1500),
         ("ccu_kernel", 2000, 2600), ("sm90_gemm", 3000, 7000), ("elementwise", 6000, 8000)]
    ctx = _train_ctx(CFG, k, spans={"train.compress": [(900, 2700)]})
    flash = run.reader("metrics", "flash_attention_roofline.train")(ctx)
    assert flash == pytest.approx(100 * readers.flash_least_seconds(CFG, 2, 64) / 1e-6)
    ccu = run.reader("metrics", "ccu_reduce_roofline.train")(ctx)
    least = sum(work.least_seconds(*work.ccu_reduce_work(n)) for n in (10, 20))
    assert ccu == pytest.approx(100 * least / 1.1e-6)
    assert run.reader("metrics", "optimizer_ms.train")(ctx) == pytest.approx(1.1e-6 * 1e3 / 2)
    assert run.reader("metrics", "grad_ms.train")(ctx) == pytest.approx(7e-6 * 1e3 / 2)
    # busy: [0, 1500] + [2000, 2600] + [3000, 8000] ns of a 1 s window
    assert run.reader("metrics", "device_idle.train")(ctx) == pytest.approx(100 * (1 - 7.1e-6))
    mfu = run.reader("metrics", "mfu.train")(ctx)
    assert mfu == pytest.approx(100 * 2 * work.train_step_flops(CFG, 2, 64) / work.PEAK_BF16_FLOPS)
    # nothing to read: no MoE layer, not a prefill
    assert run.reader("metrics", "moe_dispatch_roofline.train")(ctx) is None
    assert run.reader("metrics", "mfu.prefill")(ctx) is None
    assert run.reader("metrics", "flash_attention_roofline.prefill")(ctx) is None


def test_prefill_readers_take_each_launch_at_its_batch():
    ctx = {"kernels": [("flash_fwd_tc_kernel", 10, 20), ("flash_fwd_tc_kernel", 110, 130)],
           "host_spans": {"bench.batch.0": [(0, 100)], "bench.batch.1": [(100, 200)]},
           "batches": [("bench.batch.0", 4, 64), ("bench.batch.1", 4, 128)], "cfg": CFG,
           "kind": "prefill", "window_s": 1e-6, "busy_s": 3e-8, "device_spans": {}, "host_ops": []}
    least = readers.flash_least_seconds(CFG, 4, 64) + readers.flash_least_seconds(CFG, 4, 128)
    got = run.reader("metrics", "flash_attention_roofline.prefill")(ctx)
    assert got == pytest.approx(100 * least / 30e-9)
    assert run.reader("metrics", "device_idle.prefill")(ctx) == pytest.approx(97.0)
    assert run.reader("metrics", "mfu.prefill")(ctx) == pytest.approx(
        100 * (work.prefill_flops(CFG, 4, 64) + work.prefill_flops(CFG, 4, 128)) / (1e-6 * work.PEAK_BF16_FLOPS))


def test_breakdown_lists_ops_and_gaps():
    ctx = {"kernels": [("a", 0, 10), ("b", 30, 40), ("a", 100, 150)],
           "host_ops": [("aten::mm", 5, 200), ("aten::add", 95, 99)]}
    b = trace.breakdown(ctx)
    assert b["device_ops"][0] == ["a", pytest.approx(60e-9)]
    assert dict(b["idle_gaps"]) == {"aten::mm": pytest.approx(80e-9)}


def test_judge_and_the_leaf_rule():
    ok, checks = compare.judge({"a": 0.1, "b": float("nan")}, {"limits": {"a": 0.2}})
    assert ok and list(checks) == ["a"]
    assert not compare.judge({"a": float("nan")}, {"limits": {"a": 0.2}})[0]
    # a leaf whose reference gradient is under a thousandth of the median's is left out of the change
    one = [1.0, 0.0]
    prog = type("P", (), {"losses": [1.0], "payload_norms": [1.0, 1.0, 1.0], "change_norms": [1.0, 1.0, 5.0],
                          "grad_samples": [[1.0, 0.0], [1.0, 0.0], [0.0, 9.0]],
                          "change_samples": [[-1.0, 0.0], [0.0, 1.0], [0.0, 9.0]]})
    ref = {"losses": [1.0], "payload_norms": [1.0, 1.0, 1.0], "change_norms": [1.0, 1.0, 1.0],
           "grad_norms": [1.0, 1.0, 1e-5], "grad_samples": [one, [0.0, 1.0], [1e-5, 0.0]],
           "change_samples": [one, [0.0, 1.0], [1e-5, 0.0]]}
    got = compare.train_numbers(prog, ref)
    assert got["update_norm_gap"] == 0.0
    # leaf 1's gradient distance, sqrt(2), over its sample's norm 1; leaf 2 left out
    keep = compare.moving(ref)
    assert keep == [True, True, False]
    assert compare.leaf_dists(prog.grad_samples, ref["grad_samples"], keep) == [0.0, pytest.approx(2 ** 0.5), None]
    assert got["grad_dist_median"] == pytest.approx(2 ** 0.5 / 2)
    assert got["grad_dist_worst"] == pytest.approx(2 ** 0.5)
    # leaf 0's change moved the other way: the same norm, a distance of 2
    assert got["update_dist_worst"] == pytest.approx(2.0) and got["update_dist_median"] == pytest.approx(1.0)
    ref["grad_norms"][2] = 1.0
    got = compare.train_numbers(prog, ref)
    assert got["update_norm_gap"] == pytest.approx(4.0)
    # leaf 2: 9 over the median leaf's norm, 1; the median of 0, sqrt(2), 9
    assert got["grad_dist_median"] == pytest.approx(2 ** 0.5) and got["grad_dist_worst"] == pytest.approx(9.0)


def test_batches_sampled_from_the_seed_hold_every_length():
    lengths = [8, 16, 32, 16, 8, 32, 8, 16, 32]
    counts = {"8": 2, "16": 1, "32": 5}
    a = compare.sample_batches(5, lengths, counts)
    assert a == compare.sample_batches(5, lengths, counts) == sorted(set(a))
    assert [sum(lengths[i] == n for i in a) for n in (8, 16, 32)] == [2, 1, 3]
