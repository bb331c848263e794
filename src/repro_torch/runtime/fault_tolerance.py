"""Job-level supervision of training — the port's own copy of the part of
``repro/runtime/fault_tolerance.py`` that the train loop uses:
``WorkerState`` and ``TrainingSupervisor`` (heartbeats, dead-worker
detection, straggler strikes), plain Python, so that the port imports nothing
of the reference; ``tests/test_torch_train.py`` holds it to the original.

Left out: ``TrainingSupervisor.plan_recovery`` and the topology layer it
drives (``RackFailover``, the 64+1 backup NPU, link recovery), which need the
port's copies of ``core/`` (ROADMAP A12).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable


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
