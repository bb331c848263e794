"""The port's own copy of ``repro/netsim/messages.py``, held to the original by
``tests/test_torch_netsim_latency.py``; only its imports of the package differ.

Message-level store-and-forward latency model (netsim layer 2b).

The fluid model (``netsim/flows.py``) prices *bandwidth*: rates are
max-min fair shares and a DAG task's only latency is one flat
``latency_s`` launch delay.  That is the right abstraction for the
256 MB training collectives the planner calibrates on — and exactly the
wrong one for production decode serving, where per-token messages are
kilobytes and completion time is dominated by per-hop latency,
serialization and queueing behind busy links ("I've Got 99 Problems But
FLOPS Ain't One": the network-latency-dominant regime).

``MessageNetwork`` executes the SAME collective ``FlowDAG``s at message
granularity:

* **serialization** — a message occupies a directed link for
  ``size / capacity`` seconds (capacities come from the same per-topology
  wire inventory the fluid model uses, ``flows._wire_structure``);
* **propagation** — each hop adds the per-hop latency (flat by default,
  per-dimension overridable);
* **queueing** — each directed link is a FIFO: a message entering a busy
  link waits for every earlier message to finish serializing.  Entry
  order (event order, deterministic) is service order;
* **receiver ejection (incast)** — the destination port is a FIFO server
  at ``rx_gbs``.  It is *cut-through*: an uncontended message ejects
  while it serializes off the wire (no extra term — uncongested runs
  match the closed-form alpha-beta cost exactly), but N messages
  converging on one node serialize behind the port, which is what gives
  A2A dispatch its p99 tail.

Routing is the dimension-ordered shortest path (``core/apr``): at decode
message sizes multipath splitting buys nothing (serialization is already
negligible — splitting only adds per-path latency), so the latency mode
deliberately models the single-path fast path.  Failure injection stays a
fluid-mode feature.

Determinism: everything runs on the shared ``EventEngine`` ((time, seq)
order), and all queueing state is plain floats updated in event order —
two runs of the same scenario produce bit-identical latencies.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from ..core.apr import shortest_paths
from ..core.topology import NDFullMesh
from .collectives import FlowDAG
from .events import EventEngine
from .flows import DirectedLink, _build_wire_structure, _wire_structure


@dataclass(slots=True)
class Message:
    """One store-and-forward message on a pinned path."""

    mid: int
    path: tuple[int, ...]
    size: float                                  # bytes
    t_launch: float                              # entered the first hop
    t_end: float | None = None                   # delivered
    on_complete: Callable[["Message"], None] | None = None

    @property
    def latency_s(self) -> float:
        """Launch-to-delivery latency (queueing-inclusive)."""
        return (self.t_end or self.t_launch) - self.t_launch


class MessageNetwork:
    """Store-and-forward message transport over the nD-FullMesh links.

    Shares the fluid model's directed-link inventory (capacities in
    bytes/s from ``flows._wire_structure``) but replaces rate sharing
    with per-link FIFO occupancy: deterministic, queueing-aware, O(hops)
    events per message.
    """

    def __init__(
        self,
        topo: NDFullMesh,
        engine: EventEngine | None = None,
        *,
        latency_s: float = 1e-6,
        dim_latency_s: dict[int, float] | None = None,
        rx_gbs: float | dict[int, float] | None = None,
        reuse_wire_template: bool = True,
    ) -> None:
        self.topo = topo
        self.engine = engine or EventEngine()
        if reuse_wire_template:
            capacity, link_dim = _wire_structure(topo)
        else:
            capacity, link_dim = _build_wire_structure(topo)
        # read-only here (no fail_link in message mode), so the template
        # dicts are shared, not copied
        self.capacity: dict[DirectedLink, float] = capacity
        self._link_dim: dict[DirectedLink, int] = link_dim
        self.latency_s = latency_s
        self.dim_latency_s = dict(dim_latency_s or {})
        if rx_gbs is None:
            self.rx_cap: dict[int, float] = {}
        elif isinstance(rx_gbs, dict):
            self.rx_cap = {n: g * 1e9 for n, g in rx_gbs.items()}
        else:
            self.rx_cap = {n: rx_gbs * 1e9 for n in range(topo.num_nodes)}
        # FIFO state: when each directed link / ejection port frees up
        self._link_busy: dict[DirectedLink, float] = {}
        self._rx_busy: dict[int, float] = {}
        self._link_bytes: dict[DirectedLink, float] = {}
        self._next_mid = 0
        self.delivered = 0
        self.bytes_delivered = 0.0

    # -- hop pricing -------------------------------------------------------
    def hop_latency(self, link: DirectedLink) -> float:
        d = self._link_dim.get(link)
        if d is None:
            return self.latency_s
        return self.dim_latency_s.get(d, self.latency_s)

    # -- sending -----------------------------------------------------------
    def send(
        self,
        path: "tuple[int, ...] | list[int]",
        size: float,
        on_complete: Callable[[Message], None] | None = None,
    ) -> Message:
        """Launch one message along ``path`` (adjacent node ids) now."""
        if len(path) < 2:
            raise ValueError(f"path needs >= 2 nodes, got {path!r}")
        msg = Message(
            mid=self._next_mid,
            path=tuple(path),
            size=float(size),
            t_launch=self.engine.now,
            on_complete=on_complete,
        )
        self._next_mid += 1
        self._enter_hop(msg, 0)
        return msg

    def _enter_hop(self, msg: Message, i: int) -> None:
        now = self.engine.now
        link = (msg.path[i], msg.path[i + 1])
        cap = self.capacity.get(link)
        if cap is None:
            raise KeyError(f"no directed link {link} in topology")
        start = max(now, self._link_busy.get(link, 0.0))
        ser = msg.size / cap
        self._link_busy[link] = start + ser
        self._link_bytes[link] = self._link_bytes.get(link, 0.0) + msg.size
        arrive = start + ser + self.hop_latency(link)
        if i + 2 < len(msg.path):
            self.engine.schedule_at(
                arrive, lambda: self._enter_hop(msg, i + 1)
            )
            return
        # last hop: queue through the destination's ejection port.  The
        # port is cut-through — its "virtual start" is backdated by its own
        # serialization time, so an idle port adds nothing while a
        # contended one serializes messages back to back
        dst = msg.path[-1]
        rx = self.rx_cap.get(dst)
        if rx:
            rser = msg.size / rx
            rstart = max(arrive - rser, self._rx_busy.get(dst, 0.0))
            arrive = rstart + rser
            self._rx_busy[dst] = arrive
        self.engine.schedule_at(arrive, lambda: self._deliver(msg))

    def _deliver(self, msg: Message) -> None:
        msg.t_end = self.engine.now
        self.delivered += 1
        self.bytes_delivered += msg.size
        if msg.on_complete is not None:
            msg.on_complete(msg)

    # -- inspection --------------------------------------------------------
    def utilization(self, elapsed_s: float | None = None) -> dict[DirectedLink, float]:
        elapsed = elapsed_s if elapsed_s else (self.engine.now or None)
        if not elapsed:
            return {l: 0.0 for l in self._link_bytes}
        return {
            l: b / (self.capacity[l] * elapsed)
            for l, b in self._link_bytes.items()
        }


class MessageDagRun:
    """Executes one collective ``FlowDAG`` at message granularity.

    Same dependency semantics as the fluid ``_DagRun`` — a task launches
    when its deps complete — but every task (or every pair of an
    aggregate ring step) becomes one store-and-forward message on its
    dimension-ordered shortest path, with NO flat launch delay: latency
    is carried per hop by the transport instead.  Per-task
    launch/completion times are recorded so the caller can extract the
    within-collective message-latency distribution (p50/p99 calibration).
    """

    def __init__(self, msgnet: MessageNetwork, dag: FlowDAG) -> None:
        self.msgnet = msgnet
        self.dag = dag
        self.start_s: dict[int, float] = {}
        self.end_s: dict[int, float] = {}
        self.children: dict[int, list[int]] = {}
        self.indeg: dict[int, int] = {}
        self.fanout: dict[int, int] = {}
        self._path_cache: dict[tuple[int, int], tuple[int, ...]] = {}
        for t in dag.tasks:
            self.indeg[t.tid] = len(t.deps)
            for d in t.deps:
                self.children.setdefault(d, []).append(t.tid)

    def start(self) -> None:
        for t in self.dag.tasks:
            if self.indeg[t.tid] == 0:
                self._launch(t.tid)

    def _path(self, src: int, dst: int) -> tuple[int, ...]:
        p = self._path_cache.get((src, dst))
        if p is None:
            p = self._path_cache[(src, dst)] = shortest_paths(
                self.msgnet.topo, src, dst
            )[0]
        return p

    def _launch(self, tid: int) -> None:
        task = self.dag.tasks[tid]
        self.start_s[tid] = self.msgnet.engine.now
        pairs = task.pairs if task.pairs else ((task.src, task.dst),)
        self.fanout[tid] = len(pairs)
        for src, dst in pairs:
            self.msgnet.send(
                self._path(src, dst),
                task.size,
                on_complete=lambda m, tid=tid: self._msg_done(tid),
            )

    def _msg_done(self, tid: int) -> None:
        self.fanout[tid] -= 1
        if self.fanout[tid] == 0:
            self._done(tid)

    def _done(self, tid: int) -> None:
        self.end_s[tid] = self.msgnet.engine.now
        for c in self.children.get(tid, ()):
            self.indeg[c] -= 1
            if self.indeg[c] == 0:
                self._launch(c)

    @property
    def task_latency_s(self) -> dict[int, float]:
        """Per-task ready-to-complete latency (queueing-inclusive)."""
        return {
            tid: end - self.start_s[tid] for tid, end in self.end_s.items()
        }
