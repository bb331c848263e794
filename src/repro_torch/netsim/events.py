"""The port's own copy of ``repro/netsim/events.py``, held to the original by
``tests/test_torch_netsim_solver.py``; only its imports of the package differ.

Deterministic discrete-event engine (netsim layer 1).

A minimal heapq-based event queue over *virtual* time — no wall clock
anywhere, so two runs of the same scenario produce bit-identical event
orders and timestamps.  Ties in firing time are broken by a monotonically
increasing sequence number (schedule order), which is what makes the whole
simulator reproducible: the fluid flow model recomputes rates on every
event, and a nondeterministic tie-break would propagate into different
rate histories.

Events are plain callbacks.  Cancellation is lazy (a cancelled event stays
in the heap but is skipped when popped), the standard trick that keeps
``schedule``/``cancel`` O(log n) without heap surgery.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Any, Callable


@dataclass(order=True, slots=True)
class Event:
    """One scheduled callback.  Ordering: (time, seq)."""

    time: float
    seq: int
    fn: Callable[[], Any] = field(compare=False)
    cancelled: bool = field(default=False, compare=False)

    def cancel(self) -> None:
        self.cancelled = True


class EventEngine:
    """Virtual-time event loop."""

    def __init__(self) -> None:
        self.now: float = 0.0
        self._heap: list[Event] = []
        self._seq: int = 0
        self.events_fired: int = 0
        # optional per-event observer (telemetry); None = zero-cost
        self.observer: Callable[[float], Any] | None = None

    # -- scheduling --------------------------------------------------------
    def schedule(self, delay: float, fn: Callable[[], Any]) -> Event:
        """Schedule ``fn`` to fire ``delay`` seconds from now."""
        if delay < 0:
            raise ValueError(f"negative delay {delay}")
        return self.schedule_at(self.now + delay, fn)

    def schedule_at(self, time: float, fn: Callable[[], Any]) -> Event:
        if time < self.now:
            raise ValueError(f"cannot schedule in the past ({time} < {self.now})")
        ev = Event(time=time, seq=self._seq, fn=fn)
        self._seq += 1
        heapq.heappush(self._heap, ev)
        return ev

    # -- running -----------------------------------------------------------
    def step(self) -> bool:
        """Fire the next non-cancelled event.  Returns False when empty."""
        while self._heap:
            ev = heapq.heappop(self._heap)
            if ev.cancelled:
                continue
            self.now = ev.time
            self.events_fired += 1
            if self.observer is not None:
                self.observer(ev.time)
            ev.fn()
            return True
        return False

    def run(self, until: float | None = None, max_events: int = 10_000_000) -> float:
        """Drain the queue (or up to virtual time ``until``).  Returns the
        final virtual time.

        ``max_events`` is a hard budget: at most that many events fire, and
        the error raises *before* the budget-busting event runs.  When
        ``until`` is given, ``now`` always lands exactly on ``until`` —
        including when the queue drains early — so back-to-back
        ``run(until=...)`` windows tile virtual time without gaps."""
        fired = 0
        while self._heap:
            nxt = self._peek_time()
            if nxt is None:
                break
            if until is not None and nxt > until:
                self.now = until
                return self.now
            if fired >= max_events:
                raise RuntimeError(f"event budget exceeded ({max_events})")
            if not self.step():
                break
            fired += 1
        if until is not None and self.now < until:
            self.now = until
        return self.now

    def _peek_time(self) -> float | None:
        while self._heap and self._heap[0].cancelled:
            heapq.heappop(self._heap)
        return self._heap[0].time if self._heap else None

    @property
    def pending(self) -> int:
        return sum(1 for e in self._heap if not e.cancelled)
