"""The port's own copy of ``repro/runtime/fault_tolerance.py``, held to the original by
``tests/test_torch_runtime_ft.py``; only its imports of the package differ.
With ``runtime/elastic.py`` beside it, the port's ``runtime/`` lacks only the
copy of ``runtime/campaign.py``, which needs ``core/codesign.py`` (ROADMAP
A12c, A12d).

Self-healing runtime (paper P3): 64+1 backup NPUs, link recovery,
heartbeats and straggler mitigation.

Two layers:

* **Topology layer** — exact reproduction of the paper's mechanisms on the
  UB-Mesh graph: `RackFailover` implements the 64+1 design of Fig. 9 (the
  backup NPU takes the failed logical slot; its direct links are redirected
  through the LRS, +1 hop); link failures trigger APR direct notification +
  reroute (§4.2).
* **Job layer** — `TrainingSupervisor` drives checkpoint/restart: heartbeat
  timeout -> activate backup (or shrink DP via `runtime.elastic`) -> restore
  latest checkpoint -> resume.  The CPU container simulates worker failures;
  the control flow is the production one.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

from repro_torch.core.apr import RoutePlan, all_paths
from repro_torch.core.topology import NDFullMesh, ub_mesh_rack


# ---------------------------------------------------------------------------
# 64+1 backup NPU (paper §3.3.2, Fig. 9)
# ---------------------------------------------------------------------------


class SparesExhausted(dict):
    """Structured spare-pool-empty outcome of :meth:`RackFailover.fail`.

    A dict subclass so callers can both ``isinstance``-check the outcome
    (the policy-engine path: degrade to checkpoint-restore / elastic
    shrink) and read fields like any other recovery record.  Carries
    ``kind="spares_exhausted"``, the logical/physical ids of the
    unrecovered failure and the rack's failure count."""

    def __init__(self, logical: int, failed_physical: int, failed_count: int):
        super().__init__(
            kind="spares_exhausted",
            logical=logical,
            failed_physical=failed_physical,
            failed_count=failed_count,
        )


@dataclass
class RackFailover:
    """Logical->physical NPU mapping for one rack with hot spares."""

    rack: NDFullMesh = field(default_factory=ub_mesh_rack)
    n_backups: int = 1

    def __post_init__(self):
        n = self.rack.num_nodes
        # physical ids: [0, n) regular, [n, n+backups) spares behind the LRS
        self.logical_to_physical = list(range(n))
        self.failed: set[int] = set()
        self.spares = list(range(n, n + self.n_backups))

    @property
    def degraded(self) -> bool:
        """True once failures exceed what the spares could absorb."""
        return len(self.failed) > self.n_backups

    def fail(self, logical: int) -> dict:
        """NPU failure: activate a spare for this logical slot.

        Returns the recovery record: which physical npu replaced it and
        which direct links became 1-hop LRS routes (Fig. 9's 5-3 ->
        5-LRS-B redirection).  When the spare pool is empty the failure
        is still recorded but the outcome is a :class:`SparesExhausted`
        record (``kind="spares_exhausted"``) instead of an exception —
        the caller's policy engine decides whether to wait for a
        restock, restore from checkpoint, or shrink the job elastically.
        """
        phys = self.logical_to_physical[logical]
        self.failed.add(phys)
        if not self.spares:
            return SparesExhausted(
                logical=logical,
                failed_physical=phys,
                failed_count=len(self.failed),
            )
        spare = self.spares.pop(0)
        self.logical_to_physical[logical] = spare
        redirected = [
            (peer, "via-LRS", 1)  # (logical peer, path type, extra hops)
            for peer, _dim in self.rack.all_neighbors(phys if phys < self.rack.num_nodes else 0)
        ]
        return {
            "kind": "backup",
            "logical": logical,
            "failed_physical": phys,
            "backup_physical": spare,
            "redirected_links": len(redirected),
            "extra_hops": 1,
        }

    def restock(self, physical: int) -> None:
        """Return a repaired NPU to the spare pool (field service swapped
        the failed board).  The physical id re-enters as a spare — the
        logical slot it used to hold stays on whatever replaced it."""
        self.failed.discard(physical)
        if physical not in self.spares and physical not in self.logical_to_physical:
            self.spares.append(physical)

    def translate(self, logical: int) -> int:
        return self.logical_to_physical[logical]


# ---------------------------------------------------------------------------
# link failure -> APR direct notification + reroute (paper §4.2)
# ---------------------------------------------------------------------------


def recover_link_failure(
    plan: RoutePlan, link: tuple[int, int]
) -> dict:
    """Direct-notification recovery; returns convergence statistics."""
    t0 = time.perf_counter()
    notified = plan.direct_notify(link)
    rerouted = plan.reroute(link)
    dt = time.perf_counter() - t0
    baseline = plan.hop_by_hop_notify(link)
    return {
        "affected_flows": len(rerouted),
        "notified_sources": len(notified),
        "max_notify_hops": max(notified.values(), default=0),
        "max_hop_by_hop_hops": max(baseline.values(), default=0),
        "control_messages_direct": len(notified),
        "control_messages_flood": plan.topo.num_nodes,
        "recovery_wall_s": dt,
    }


# ---------------------------------------------------------------------------
# job-level supervisor: heartbeats, checkpoint/restart, stragglers
# ---------------------------------------------------------------------------


@dataclass
class WorkerState:
    last_heartbeat: float
    step: int = 0
    slow_strikes: int = 0


class TrainingSupervisor:
    """Heartbeat-driven failure detection + restart orchestration.

    ``clock`` injects the time source (a zero-arg callable returning
    seconds).  The default stays ``time.monotonic`` for live use; tests
    and the Monte-Carlo campaign pass a simulated clock so detection is
    deterministic and replayable per seed."""

    def __init__(
        self,
        n_workers: int,
        heartbeat_timeout_s: float = 10.0,
        straggler_factor: float = 3.0,
        clock: Callable[[], float] | None = None,
    ):
        self._clock = clock if clock is not None else time.monotonic
        now = self._clock()
        self.workers = {i: WorkerState(now) for i in range(n_workers)}
        self.timeout = heartbeat_timeout_s
        self.straggler_factor = straggler_factor
        self.step_times: list[float] = []
        self.events: list[dict] = []

    def heartbeat(self, worker: int, step: int, step_time_s: float | None = None):
        w = self.workers[worker]
        w.last_heartbeat = self._clock()
        w.step = step
        if step_time_s is not None:
            self.step_times.append(step_time_s)
            self.step_times = self.step_times[-256:]
            med = sorted(self.step_times)[len(self.step_times) // 2]
            if step_time_s > self.straggler_factor * med:
                w.slow_strikes += 1
                if w.slow_strikes >= 3:
                    self.events.append(
                        {"kind": "straggler", "worker": worker, "step": step}
                    )
                    w.slow_strikes = 0
            else:
                w.slow_strikes = 0

    def dead_workers(self, now: float | None = None) -> list[int]:
        # `now is None` check, not truthiness: a simulated clock
        # legitimately reads 0.0 at t=0
        now = self._clock() if now is None else now
        return [
            i for i, w in self.workers.items()
            if now - w.last_heartbeat > self.timeout
        ]

    def plan_recovery(self, failover: RackFailover, dead: list[int]) -> dict:
        """Decide the recovery action for a set of dead workers."""
        actions = []
        for w in dead:
            rec = failover.fail(w % failover.rack.num_nodes)
            if isinstance(rec, SparesExhausted):
                actions.append({**rec, "kind": "elastic_shrink", "worker": w})
            else:
                actions.append(rec | {"worker": w})
        self.events.extend(actions)
        return {
            "actions": actions,
            "restart_from_checkpoint": True,
        }
