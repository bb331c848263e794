"""``--auto-parallel`` in the port's ``launch/train.py`` against the
reference's (``repro/launch/train.py`` ``main``): the same three
``[planner] ...`` lines for granite-8b smoke and a MoE arch, from ``run``'s
log and from ``main``'s output, and the report ``run`` returns equal to the
reference planner's on the same workload.  The reference's ``main`` is cut
right after it plans (its ``Runtime`` replaced by a stop), before it
trains."""

import sys

import pytest

import repro.core.traffic as ref_traffic
import repro.launch.train as ref_train
from repro.core.cost_model import Routing as RefRouting, build_comm_model as ref_comm
from repro.core.planner import plan as ref_plan
from repro_torch.launch import train

from _torch_netsim_parity import plain
from _torch_parity import one_thread  # noqa: F401  (the fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

CASES = [("granite-8b", []), ("mixtral-8x22b", []), ("granite-8b", ["--seq", "64", "--batch", "512"])]


class _Planned(Exception):
    pass


def reference_lines(monkeypatch, capsys, argv) -> list[str]:
    """The reference ``main``'s ``[planner]`` lines for ``argv``."""
    def stop(*a, **k):
        raise _Planned
    monkeypatch.setattr(ref_train, "Runtime", stop)
    monkeypatch.setattr(sys, "argv", ["train", *argv])
    capsys.readouterr()
    with pytest.raises(_Planned):
        ref_train.main()
    return [line for line in capsys.readouterr().out.splitlines() if line.startswith("[planner]")]


@pytest.mark.parametrize("arch,extra", CASES)
def test_run_logs_the_reference_lines(arch, extra, monkeypatch, capsys):
    want = reference_lines(monkeypatch, capsys, ["--arch", arch, "--auto-parallel", *extra])
    args = train.build_parser().parse_args(["--arch", arch, "--auto-parallel", "--device", "cpu", *extra])
    lines = []
    res = train.run(args, log=lines.append, stop_at=0)
    assert len(want) == 3
    assert [line for line in lines if line.startswith("[planner]")] == want
    assert res["losses"] == []

    # the report is the reference planner's on the reference's workload
    harness = ref_train.load(arch, smoke=True)
    cfg = harness.cfg
    w = ref_traffic.WorkloadSpec(
        name=arch, n_layers=cfg.n_layers, hidden=cfg.d_model,
        n_heads=getattr(cfg, "n_heads", cfg.d_model // 64), head_dim=getattr(cfg, "head_dim", 64),
        seq_len=args.seq, global_batch=max(args.batch, 256),
        params_total=float(train.param_count(train.load(arch, smoke=True).param_specs())))
    ref = ref_plan(w, 512, ref_comm(multi_pod=True, routing=RefRouting.BORROW), top_k=3)
    assert plain(res["plans"].results) == plain(ref.results)


def test_main_prints_the_reference_lines(monkeypatch, capsys):
    flags = ["--auto-parallel", "--steps", "1", "--seq", "16", "--batch", "2"]
    want = reference_lines(monkeypatch, capsys, flags)
    train.main([*flags, "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert [line for line in out if line.startswith("[planner]")] == want
    assert out[1:4] == want and any(line.startswith("[train] done.") for line in out)


def test_without_the_flag_nothing_is_planned():
    args = train.build_parser().parse_args(["--device", "cpu"])
    lines = []
    res = train.run(args, log=lines.append, stop_at=0)
    assert res["plans"] is None and not any("[planner]" in line for line in lines)
