"""The port's own copy of ``repro/netsim/routing.py``, held to the original by
``tests/test_torch_netsim.py``; only its imports of the package differ.

APR adapter: core/apr path sets -> per-flow multi-path splits (layer 3).

Converts the planner-side APR machinery (``core/apr.py``) into executable
routing for the fluid network:

* **Shortest** — the single dimension-ordered shortest path (baseline
  Fig. 10-(a)); on failure, falls back to any surviving APR path.
* **Detour** — a link-disjoint subset of the TFC-admissible all-path set
  (shortest permutations + single-relay detours, §4.1); a transfer's bytes
  are split across the paths with congestion-aware weights.
* **Borrow** — Detour plus one switch-assisted path through a virtual
  LRS/HRS node attached to every NPU at ``borrow_gbs`` per uplink (§6.3).

Congestion awareness: the split weight of a path is its estimated residual
bottleneck bandwidth (capacity divided by one more than the flows already
on each link).  When one subflow finishes while its siblings lag, the
transfer *re-splits* the remaining bytes over all its paths — the fluid
analogue of APR's congestion-aware path (re)selection.

Failure handling is the paper's direct-notification fast recovery (§4.2):
``fail_link`` stalls the crossing flows immediately, and after a
notification delay proportional to the endpoint->source hop distance the
affected transfers re-split their remaining bytes over surviving paths.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from ..core.apr import Path, all_paths, shortest_paths, tfc_admissible
from ..core.cost_model import Routing
from ..core.topology import NDFullMesh
from .flows import Flow, FluidNetwork

_EPS = 1e-6


@dataclass
class Transfer:
    """One logical src->dst message, possibly split over several paths."""

    tid: int
    src: int
    dst: int
    size: float
    on_complete: Callable[["Transfer"], None] | None = None
    meta: object = None
    single_path: bool = False       # collective ring steps pin one path
    subflows: dict[int, Flow] = field(default_factory=dict)
    delivered: float = 0.0
    resplits: int = 0
    done: bool = False
    start_s: float = 0.0
    end_s: float | None = None

    @property
    def remaining(self) -> float:
        return max(0.0, self.size - self.delivered)


class Router:
    """Maps transfers onto APR paths over a FluidNetwork."""

    MAX_PATHS = 4           # split fan-out cap (Fig. 14 uses 2; APR allows more)
    MAX_RESPLITS = 8        # per transfer, guards event inflation

    def __init__(
        self,
        net: FluidNetwork,
        policy: Routing = Routing.DETOUR,
        *,
        borrow_gbs: float = 50.0,
        notify_latency_s: float = 1e-6,
        adaptive: bool = True,
    ) -> None:
        self.net = net
        self.topo: NDFullMesh = net.topo
        self.policy = policy
        self.notify_latency_s = notify_latency_s
        self.adaptive = adaptive
        self.transfers: dict[int, Transfer] = {}
        self._next_tid = 0
        # APR path sets are pure functions of (src, dst, policy) while the
        # failed-link set is unchanged; memoizing them removes the dominant
        # per-send cost of large collective DAG runs (invalidated by
        # ``fail_link``)
        self._path_cache: dict[tuple[int, int, bool], list[Path]] = {}
        self.switch_node: int | None = None
        if policy == Routing.BORROW:
            # virtual switch plane: one hop up, one hop down, per-NPU uplink
            self.switch_node = self.topo.num_nodes
            for u in range(self.topo.num_nodes):
                net.add_link(u, self.switch_node, borrow_gbs)

    # -- path sets ---------------------------------------------------------
    # An NDFullMesh gets core/apr's coordinate-based enumeration plus TFC
    # admission.  A topology carrying its own ``apr_shortest_paths`` /
    # ``apr_all_paths`` (the mixed-granularity coarse meshes, which are
    # NOT Hamming graphs) supplies graph-generic BFS path sets instead;
    # those are simple loop-free paths by construction, and TFC's VL
    # rules need dimension-ordered hops, so they are used as-is.
    def _shortest_set(self, src: int, dst: int) -> list[Path]:
        fn = getattr(self.topo, "apr_shortest_paths", None)
        if fn is not None:
            return fn(src, dst)
        return shortest_paths(self.topo, src, dst)

    def _all_path_set(self, src: int, dst: int) -> list[Path]:
        fn = getattr(self.topo, "apr_all_paths", None)
        if fn is not None:
            return fn(src, dst)
        return all_paths(self.topo, src, dst)

    def _admissible_set(self, src: int, dst: int) -> list[Path]:
        fn = getattr(self.topo, "apr_all_paths", None)
        if fn is not None:
            return fn(src, dst)
        return [
            p
            for p, _ in tfc_admissible(
                self.topo, all_paths(self.topo, src, dst)
            )
        ]

    def _alive(self, p: Path) -> bool:
        return all(self.net.link_ok(u, v) for u, v in zip(p, p[1:]))

    def candidate_paths(self, src: int, dst: int, *, single: bool = False) -> list[Path]:
        """APR path set for (src, dst) under the active policy, skipping
        failed links.  ``single`` pins one path (ring-schedule steps).
        Memoized per (src, dst, single) until a link fails."""
        key = (src, dst, single)
        cached = self._path_cache.get(key)
        if cached is not None:
            return cached
        paths = self._candidate_paths(src, dst, single)
        self._path_cache[key] = paths
        return paths

    def _candidate_paths(self, src: int, dst: int, single: bool) -> list[Path]:
        if src == dst:
            return [(src,)]
        sp = [p for p in self._shortest_set(src, dst) if self._alive(p)]
        if single or self.policy == Routing.SHORTEST:
            if sp:
                return [sp[0]]      # first permutation == dimension-ordered
            # fast recovery: any surviving APR path
            for p in self._all_path_set(src, dst):
                if self._alive(p):
                    return [p]
            raise RuntimeError(f"no surviving path {src}->{dst}")
        adm = [p for p in self._admissible_set(src, dst) if self._alive(p)]
        # greedy link-disjoint subset, shortest first (path_diversity's rule)
        chosen: list[Path] = []
        used: set[tuple[int, int]] = set()
        for p in sorted(adm, key=len):
            edges = {tuple(sorted(e)) for e in zip(p, p[1:])}
            if edges & used:
                continue
            chosen.append(p)
            used |= edges
            if len(chosen) >= self.MAX_PATHS:
                break
        if not chosen and adm:
            chosen = [adm[0]]
        if self.policy == Routing.BORROW and self.switch_node is not None:
            chosen = chosen[: self.MAX_PATHS - 1] + [
                (src, self.switch_node, dst)
            ]
        if not chosen:
            raise RuntimeError(f"no surviving path {src}->{dst}")
        return chosen

    def _weights(self, paths: list[Path]) -> list[float]:
        """Congestion-aware split: residual bottleneck bandwidth per path."""
        counts: dict[tuple[int, int], int] = {}
        for f in self.net.flows.values():
            for l in f.links:
                counts[l] = counts.get(l, 0) + 1
        ws = []
        for p in paths:
            bn = min(
                self.net.effective_capacity(l) / (counts.get(l, 0) + 1)
                for l in zip(p, p[1:])
            )
            ws.append(max(bn, 0.0))
        if sum(ws) <= 0:
            ws = [1.0] * len(paths)
        return ws

    # -- transfers ---------------------------------------------------------
    def send(
        self,
        src: int,
        dst: int,
        size: float,
        on_complete: Callable[[Transfer], None] | None = None,
        *,
        single_path: bool = False,
        meta: object = None,
    ) -> Transfer:
        t = Transfer(
            tid=self._next_tid,
            src=src,
            dst=dst,
            size=float(size),
            on_complete=on_complete,
            meta=meta,
            single_path=single_path,
            start_s=self.net.engine.now,
        )
        self._next_tid += 1
        self.transfers[t.tid] = t
        if self.net.telemetry is not None:
            self.net.telemetry.router_counters["transfers"] += 1
        if src == dst or size <= _EPS:
            self._finish(t)
            return t
        self._launch(t, t.size)
        return t

    def _launch(self, t: Transfer, nbytes: float) -> None:
        paths = self.candidate_paths(t.src, t.dst, single=t.single_path)
        if self.net.telemetry is not None:
            self.net.telemetry.record_launch(paths, self.switch_node)
        # a single path needs no congestion weighting (it normalizes out),
        # and collective ring steps are all single-path — skipping the
        # all-active-flows link census there makes large multi-ring DAG
        # runs ~2.5x faster
        ws = [1.0] if len(paths) == 1 else self._weights(paths)
        tot = sum(ws)
        for p, w in zip(paths, ws):
            share = nbytes * w / tot
            if share <= _EPS:
                continue
            f = self.net.add_flow(p, share, self._on_subflow_done, meta=t)
            if not f.done:
                t.subflows[f.fid] = f
            else:
                t.delivered += f.size
        if not t.subflows:
            if t.remaining <= _EPS:
                self._finish(t)
            elif nbytes > 0:
                # every per-path share fell below _EPS (a tiny re-split
                # remainder over many paths): push it all down one path so
                # the transfer cannot strand sub-_EPS residuals forever
                f = self.net.add_flow(
                    paths[0], nbytes, self._on_subflow_done, meta=t
                )
                if not f.done:
                    t.subflows[f.fid] = f

    def _withdraw(self, t: Transfer) -> float:
        """Pull all of a transfer's live subflows off the network.

        Returns the un-sent byte count and credits the partial progress to
        ``delivered``, clamped so delivered + left == size exactly (the
        per-flow tallies carry float error that must not double-count)."""
        left = 0.0
        for f in list(t.subflows.values()):
            left += self.net.remove_flow(f)
            t.delivered += f.size - max(0.0, f.remaining)
            del t.subflows[f.fid]
        t.delivered = min(t.delivered, t.size - left)
        return left

    def _on_subflow_done(self, flow: Flow) -> None:
        t: Transfer = flow.meta
        t.subflows.pop(flow.fid, None)
        t.delivered += flow.size
        if not t.subflows:
            if t.remaining <= _EPS:
                self._finish(t)
            else:
                # a partial launch skipped sub-_EPS shares and the launched
                # subflows are all done: resend the stranded residual so
                # the transfer (and its DAG dependents) cannot stall
                self._launch(t, t.remaining)
            return
        if (
            self.adaptive
            and not t.single_path
            and t.resplits < self.MAX_RESPLITS
        ):
            # a path freed up: re-split the laggards' remaining bytes over
            # the full path set (congestion-aware), the APR re-balance
            t.resplits += 1
            if self.net.telemetry is not None:
                self.net.telemetry.router_counters["resplits"] += 1
            left = self._withdraw(t)
            if left <= _EPS:
                self._finish(t)
                return
            self._launch(t, left)

    def _finish(self, t: Transfer) -> None:
        if t.done:
            return
        t.done = True
        t.delivered = t.size
        t.end_s = self.net.engine.now
        if self.net.telemetry is not None:
            self.net.telemetry.record_transfer_done(t)
        if t.on_complete:
            t.on_complete(t)

    # -- failure handling (paper §4.2, direct notification) ----------------
    def fail_link(self, u: int, v: int) -> dict:
        """Fail u-v now; schedule per-source direct-notification reroutes.

        Returns {affected_transfers, notified_sources, max_notify_hops}.
        """
        self._path_cache.clear()
        hit_flows = self.net.fail_link(u, v)
        hit: dict[int, Transfer] = {}
        for f in hit_flows:
            if isinstance(f.meta, Transfer):
                hit[f.meta.tid] = f.meta
        notify_hops: dict[int, int] = {}
        for t in hit.values():
            hops = min(
                self.topo.hop_distance(u, t.src),
                self.topo.hop_distance(v, t.src),
            )
            notify_hops[t.src] = max(notify_hops.get(t.src, 0), hops)
            delay = max(1, hops) * self.notify_latency_s
            self.net.engine.schedule(delay, lambda tr=t: self._reroute(tr))
        stats = {
            "affected_transfers": len(hit),
            "notified_sources": len(notify_hops),
            "max_notify_hops": max(notify_hops.values(), default=0),
        }
        if self.net.telemetry is not None:
            self.net.telemetry.record_instant(
                "link_failures", {"link": [u, v], **stats}
            )
        return stats

    def _reroute(self, t: Transfer) -> None:
        if t.done:
            return
        if self.net.telemetry is not None:
            self.net.telemetry.record_instant(
                "reroutes",
                {"tid": t.tid, "src": t.src, "dst": t.dst,
                 "remaining": t.remaining},
            )
        left = self._withdraw(t)
        if left <= _EPS:
            self._finish(t)
            return
        self._launch(t, left)
