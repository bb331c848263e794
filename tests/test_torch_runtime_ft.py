"""The reference's ``tests/test_runtime_ft.py`` restated against the port's
``repro_torch.runtime`` (its checkpoint cases against the port's
``CheckpointManager``, whose leaves are tensors), followed by the port's
``RackFailover`` / ``plan_recovery`` held against the reference's on the
same failures.

Runtime fault-tolerance unit coverage: RackFailover spare-pool
lifecycle (64+1, Fig. 9), the structured ``SparesExhausted`` outcome,
`TrainingSupervisor` with an injected deterministic clock, elastic
shrink planning, and CheckpointManager partial-save integrity."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from _torch_netsim_parity import both, outcome

from repro_torch.core.topology import ub_mesh_rack
from repro_torch.runtime.elastic import ElasticPlan, shrink_plan
from repro_torch.runtime.fault_tolerance import (
    RackFailover,
    SparesExhausted,
    TrainingSupervisor,
)


class TestRackFailover:
    def test_backup_swap_record(self):
        fo = RackFailover(rack=ub_mesh_rack(), n_backups=1)
        rec = fo.fail(5)
        assert rec["kind"] == "backup"
        assert rec["failed_physical"] == 5
        assert rec["backup_physical"] == fo.rack.num_nodes
        assert fo.translate(5) == fo.rack.num_nodes
        assert rec["extra_hops"] == 1           # Fig. 9: via-LRS redirect
        assert not fo.degraded

    def test_spares_exhausted_is_structured_not_raised(self):
        fo = RackFailover(rack=ub_mesh_rack(), n_backups=1)
        fo.fail(0)
        rec = fo.fail(1)                        # pool empty now
        assert isinstance(rec, SparesExhausted)
        assert isinstance(rec, dict)            # still a recovery record
        assert rec["kind"] == "spares_exhausted"
        assert rec["logical"] == 1
        assert rec["failed_physical"] == 1
        assert rec["failed_count"] == 2
        assert fo.degraded                      # 2 failures > 1 spare

    def test_zero_backups_always_exhausted(self):
        fo = RackFailover(rack=ub_mesh_rack(), n_backups=0)
        assert isinstance(fo.fail(3), SparesExhausted)

    def test_restock_returns_npu_to_pool(self):
        fo = RackFailover(rack=ub_mesh_rack(), n_backups=1)
        rec = fo.fail(5)                        # spare takes slot 5
        assert not fo.spares
        fo.restock(rec["failed_physical"])      # field service swaps board
        assert fo.spares == [5]
        assert 5 not in fo.failed
        rec2 = fo.fail(7)                       # pool usable again
        assert rec2["kind"] == "backup"
        assert rec2["backup_physical"] == 5

    def test_restock_ignores_active_and_duplicate_ids(self):
        fo = RackFailover(rack=ub_mesh_rack(), n_backups=1)
        fo.restock(3)                           # 3 is still mapped: no-op
        assert fo.spares == [fo.rack.num_nodes]
        fo.restock(fo.rack.num_nodes)           # already a spare: no dup
        assert fo.spares == [fo.rack.num_nodes]


class TestTrainingSupervisorClock:
    def test_injected_clock_detects_timeout_deterministically(self):
        t = [0.0]
        sup = TrainingSupervisor(
            n_workers=3, heartbeat_timeout_s=10.0, clock=lambda: t[0]
        )
        sup.heartbeat(0, step=1)
        sup.heartbeat(1, step=1)
        t[0] = 11.0
        sup.heartbeat(2, step=2)                # 2 stays alive
        assert sup.dead_workers() == [0, 1]

    def test_dead_workers_accepts_explicit_now_zero(self):
        # now=0.0 is falsy — the check must be `is None`, not truthiness
        t = [5.0]
        sup = TrainingSupervisor(
            n_workers=1, heartbeat_timeout_s=1.0, clock=lambda: t[0]
        )
        sup.workers[0].last_heartbeat = -10.0
        assert sup.dead_workers(now=0.0) == [0]
        sup.workers[0].last_heartbeat = -0.5
        assert sup.dead_workers(now=0.0) == []

    def test_plan_recovery_backup_then_elastic_fallback(self):
        sup = TrainingSupervisor(n_workers=4, clock=lambda: 0.0)
        fo = RackFailover(rack=ub_mesh_rack(), n_backups=1)
        plan = sup.plan_recovery(fo, dead=[2, 3])
        kinds = [a["kind"] for a in plan["actions"]]
        assert kinds == ["backup", "elastic_shrink"]
        # the exhausted record keeps its structured fields
        assert plan["actions"][1]["failed_count"] == 2
        assert plan["actions"][1]["worker"] == 3
        assert plan["restart_from_checkpoint"]


class TestElasticShrink:
    def test_capacity_fraction(self):
        p = ElasticPlan(old_dp=8, new_dp=6, old_global_batch=512)
        assert p.capacity_fraction == pytest.approx(0.75)

    def test_shrink_plan_rounds_up_lost_replicas(self):
        # 8 DP replicas over 512 chips -> 64 chips each; losing one
        # 64-chip rack costs exactly one replica
        p = shrink_plan(8, 512, lost_chips=64, total_chips=512)
        assert p.new_dp == 7
        # losing 65 chips straddles two replicas -> ceil to 2
        p = shrink_plan(8, 512, lost_chips=65, total_chips=512)
        assert p.new_dp == 6

    def test_shrink_plan_never_below_one_replica(self):
        p = shrink_plan(2, 512, lost_chips=10_000, total_chips=512)
        assert p.new_dp == 1


class TestCheckpointPartialSave:
    @pytest.fixture()
    def mgr(self, tmp_path):
        from repro_torch.checkpoint.manager import CheckpointManager

        return CheckpointManager(str(tmp_path), keep=10)

    def test_partial_save_invisible_until_meta_commit(self, mgr, tmp_path):
        tree = {"w": torch.ones(4, dtype=torch.float32)}
        mgr.save(100, tree, blocking=True)
        # fake a crashed save: arrays on disk, no committed meta.json
        part = tmp_path / "step_00000200"
        part.mkdir()
        (part / "w.npy").write_bytes(b"not a checkpoint")
        (part / "meta.json.tmp").write_text("{\"step\": 200")  # truncated
        assert mgr.steps() == [100]
        assert mgr.latest_step() == 100

    def test_restore_after_partial_save_uses_committed_step(self, mgr, tmp_path):
        tree = {"w": torch.arange(4, dtype=torch.float32)}
        mgr.save(7, tree, blocking=True)
        (tmp_path / "step_00000008").mkdir()    # dir exists, never committed
        out = mgr.restore(mgr.latest_step(), {"w": torch.zeros(4, dtype=torch.float32)})
        assert out["w"].tolist() == [0.0, 1.0, 2.0, 3.0]

    def test_meta_json_is_valid_after_blocking_save(self, mgr, tmp_path):
        mgr.save(3, {"w": torch.zeros((2, 2), dtype=torch.float32)}, blocking=True)
        meta = json.loads((tmp_path / "step_00000003" / "meta.json").read_text())
        assert meta["step"] == 3
        assert meta["keys"] == ["w"]
        assert not (tmp_path / "step_00000003" / "meta.json.tmp").exists()


# ---------------------------------------------------------------------------
# cross-package: the port's copies against the reference's on the same
# failures, by ==
# ---------------------------------------------------------------------------

class TestCrossPackageRecovery:
    @pytest.mark.parametrize("n_backups", [0, 1, 2])
    def test_rack_failover_sequence(self, n_backups):
        rng = np.random.default_rng(5 + n_backups)
        ops = [("fail", int(v)) if rng.random() < 0.7 else ("restock", int(v))
               for v in rng.integers(0, 64, 12)]

        def run(top, ft):
            fo = ft.RackFailover(rack=top.ub_mesh_rack(), n_backups=n_backups)
            out = []
            for op, v in ops:
                if op == "fail":
                    rec = fo.fail(v)
                    out.append((type(rec).__name__, dict(rec)))
                else:
                    phys = sorted(fo.failed)[0] if fo.failed else v
                    fo.restock(phys)
                    out.append(("restock", phys))
                out.append((list(fo.logical_to_physical), sorted(fo.failed),
                             list(fo.spares), fo.degraded,
                             [fo.translate(k) for k in range(0, 64, 9)]))
            return out
        both("core.topology runtime.fault_tolerance", run)

    @pytest.mark.parametrize("dead", [[2, 3], [0, 64, 65], [7], []])
    def test_plan_recovery(self, dead):
        def run(top, ft):
            sup = ft.TrainingSupervisor(n_workers=130, clock=lambda: 0.0)
            fo = ft.RackFailover(rack=top.ub_mesh_rack(), n_backups=1)
            plan = sup.plan_recovery(fo, dead=dead)
            return plan, sup.events, list(fo.logical_to_physical), sorted(fo.failed)
        both("core.topology runtime.fault_tolerance", run)

    def test_recover_link_failure(self):
        pairs = [tuple(int(v) for v in p)
                 for p in np.random.default_rng(9).integers(0, 1024, (48, 2))]

        def run(top, apr, ft):
            pod = top.ub_mesh_pod()
            plan = apr.RoutePlan(pod)
            for s, d in pairs:
                if s != d:
                    plan.install(s, d, apr.shortest_paths(pod, s, d)[0])
            out = []
            for link in sorted(plan._by_link)[:4]:
                stats = ft.recover_link_failure(plan, link)
                assert stats.pop("recovery_wall_s") >= 0     # a wall-clock time
                out.append((link, stats))
            return out, plan
        both("core.topology core.apr runtime.fault_tolerance", run)

    def test_elastic_plans(self):
        def run(el):
            out = []
            for old, batch, lost, total in ((8, 512, 64, 512), (8, 512, 65, 512),
                                            (2, 512, 10_000, 512), (16, 1024, 1, 4096),
                                            (6, 100, 3, 96)):
                p = el.shrink_plan(old, batch, lost_chips=lost, total_chips=total)
                out.append((p, p.new_global_batch, p.effective_lr_scale, p.capacity_fraction))
            for keep in (True, False):
                p = el.ElasticPlan(old_dp=8, new_dp=6, old_global_batch=100,
                                   keep_global_batch=keep, lr_scale=0.5)
                out.append((p, outcome(lambda: p.new_global_batch), p.effective_lr_scale,
                            p.capacity_fraction))
            return out
        both("runtime.elastic", run)

    def test_rescale_forwards_to_the_manager(self):
        """``rescale`` is the reference's: it hands the step, the tree and
        ``shardings=`` to the manager's ``restore`` and returns the plan."""
        class Manager:
            def __init__(self):
                self.calls = []

            def restore(self, step, tree_like, shardings=None):
                self.calls.append((step, tree_like, shardings))
                return {"w": [step]}

        def run(el):
            m = Manager()
            plan = el.ElasticPlan(old_dp=4, new_dp=2, old_global_batch=64)
            state, back = el.rescale(m, 12, {"w": [0]}, {"w": "new"}, plan)
            assert back is plan
            return state, m.calls
        both("runtime.elastic", run)
