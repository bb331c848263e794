"""The port's own copy of ``repro/netsim/api.py``, held to the original by
``tests/test_torch_netsim.py``; only its imports of the package differ.

NetSim facade (netsim layer 5).

``NetSim`` glues the layers together: it builds a fresh ``FluidNetwork`` +
``Router`` per run, executes a collective ``FlowDAG`` (tasks start when
their deps complete, plus one per-step hop latency), and returns a
``NetSimResult`` with per-link utilization, per-transfer completion times
and collective completion times.

Cross-validation contract (enforced by tests and the ``netsim_*``
benchmarks): on an uncongested single-dimension clique the simulated
multi-ring AllReduce time matches the analytic
``MultiRingPlan.allreduce_time_s`` / ``CommModel.allreduce`` within 15%,
and under cross-rack contention the §6.3 strategies rank
Shortest < Detour < Borrow in throughput (Fig. 19 ordering).

``calibrated_axis_gbs`` closes the loop back to the analytic stack: it
measures the *effective* per-chip collective bandwidth of each logical
mesh axis from a netsim run, in the exact units ``CommModel`` carries —
``core.perf_model.NetsimPerfModel`` memoizes these measurements per
(axis, group-width, routing) key and serves them to the planner.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..core.cost_model import (
    A2A_CALIBRATION_MAX_NODES,
    COLLECTIVE_SHAPES,
    LATENCY_SHAPES,
    CalibrationProfile,
    CommModel,
    LatencyProfile,
    LatencyStats,
    Routing,
)
from ..core.topology import DimSpec, NDFullMesh, PASSIVE_ELECTRICAL, ub_mesh_pod
from ..core.traffic import ParallelSpec, WorkloadSpec
from .collectives import (
    FlowDAG,
    model_group,
    clique_nodes,
    compile_workload,
    grid_all_gather,
    grid_allreduce,
    grid_plane_nodes,
    hierarchical_all_gather,
    hierarchical_allreduce,
    multipath_all_to_all,
    remap_dag,
    ring_all_gather,
    ring_allreduce,
)
from .events import EventEngine
from .flows import FluidNetwork, default_rx_gbs
from .routing import Router, Transfer
from .telemetry import Telemetry


@dataclass
class NetSimResult:
    """Outcome of one netsim run."""

    name: str
    makespan_s: float
    task_end_s: dict[int, float]                   # task tid -> completion
    link_utilization: dict[tuple[int, int], float]
    bytes_delivered: float
    events: int
    collective_s: dict[str, float] = field(default_factory=dict)
    transfer_counts: dict[str, float] = field(default_factory=dict)
    incomplete: int = 0                            # tasks never finished
    failure_stats: dict = field(default_factory=dict)   # from Router.fail_link
    # message-level runs only: per-task ready-to-complete latency
    # (queueing-inclusive) — the raw samples behind a LatencyProfile
    task_latency_s: dict[int, float] = field(default_factory=dict)
    # the run's Telemetry recorder when the NetSim was built with
    # ``telemetry=True`` (None otherwise; see netsim/telemetry.py)
    telemetry: "Telemetry | None" = None

    @property
    def max_link_utilization(self) -> float:
        return max(self.link_utilization.values(), default=0.0)

    @property
    def iteration_comm_s(self) -> float:
        """Sum of per-technique times scaled by their transfer counts."""
        return sum(
            t * self.transfer_counts.get(k, 1.0)
            for k, t in self.collective_s.items()
        )


class _DagRun:
    """Executes one FlowDAG on a Router with per-step latency.

    Aggregate tasks (``task.pairs``) normally run as one weighted flow
    (``FluidNetwork.add_aggregate_flow``); with ``aggregate=False`` — the
    failure-injection path, where per-flow APR rerouting must stay live —
    they are expanded into one routed send per pair and the task completes
    when the last pair does.
    """

    def __init__(
        self,
        router: Router,
        dag: FlowDAG,
        latency_s: float,
        *,
        aggregate: bool = True,
    ):
        self.router = router
        self.dag = dag
        self.latency_s = latency_s
        self.aggregate = aggregate
        self.end_s: dict[int, float] = {}
        self.children: dict[int, list[int]] = {}
        self.indeg: dict[int, int] = {}
        self.fanout: dict[int, int] = {}    # expanded aggregates: sends left
        for t in dag.tasks:
            self.indeg[t.tid] = len(t.deps)
            for d in t.deps:
                self.children.setdefault(d, []).append(t.tid)

    def start(self) -> None:
        for t in self.dag.tasks:
            if self.indeg[t.tid] == 0:
                self._launch(t.tid)

    def _launch(self, tid: int) -> None:
        self.router.net.engine.schedule(
            self.latency_s, lambda: self._send(tid)
        )

    def _send(self, tid: int) -> None:
        task = self.dag.tasks[tid]
        tel = self.router.net.telemetry
        if tel is not None:
            tel.task_labels[tid] = task.tag or f"task{tid}"
        if task.pairs and self.aggregate:
            self.router.net.add_aggregate_flow(
                task.pairs,
                task.size,
                on_complete=lambda f, tid=tid: self._done(tid),
                meta=("task", tid),
            )
            return
        if task.pairs:
            # expanded aggregate: per-pair routed sends, countdown to done
            self.fanout[tid] = len(task.pairs)
            for src, dst in task.pairs:
                self.router.send(
                    src,
                    dst,
                    task.size,
                    on_complete=lambda tr, tid=tid: self._pair_done(tid),
                    single_path=task.single_path,
                    meta=("task", tid),
                )
            return
        self.router.send(
            task.src,
            task.dst,
            task.size,
            on_complete=lambda tr, tid=tid: self._done(tid),
            single_path=task.single_path,
            meta=("task", tid),
        )

    def _pair_done(self, tid: int) -> None:
        self.fanout[tid] -= 1
        if self.fanout[tid] == 0:
            self._done(tid)

    def _done(self, tid: int) -> None:
        self.end_s[tid] = self.router.net.engine.now
        for c in self.children.get(tid, ()):
            self.indeg[c] -= 1
            if self.indeg[c] == 0:
                self._launch(c)


# bump whenever calibration *semantics* change — DAG builders, wire-byte
# normalization, rx/IO-cap conventions — anything that can shift a measured
# bandwidth without the topology or solver changing.  Part of the
# persistent calibration cache key (core/calib_cache.py).
CALIBRATION_SCHEMA_VERSION = 1


class NetSim:
    """Flow-level discrete-event simulator of an nD-FullMesh network."""

    def __init__(
        self,
        topo: NDFullMesh | None = None,
        *,
        routing: Routing = Routing.DETOUR,
        borrow_gbs: float = 50.0,
        latency_s: float = 1e-6,
        adaptive: bool = True,
        record_rates: bool = False,
        rx_gbs: float | str | None = "auto",
        dim_io_gbs: dict[int, float] | None = None,
        solver: str = "vectorized",
        aggregate: bool = True,
        axis_dims: dict[str, tuple[int, ...]] | None = None,
        telemetry: bool = False,
        reuse_wire_template: bool = True,
        failed_links: "tuple[tuple[int, int], ...]" = (),
        message_level: bool = False,
        dim_latency_s: dict[int, float] | None = None,
    ) -> None:
        self.topo = topo or ub_mesh_pod()
        self.routing = routing
        self.borrow_gbs = borrow_gbs
        self.latency_s = latency_s
        self.adaptive = adaptive
        self.record_rates = record_rates
        # receiver-egress (incast) cap: "auto" sizes it at the node's
        # largest per-dimension clique allocation; None disables it.  A
        # topology carrying per-node ejection bandwidths (``node_rx_gbs``
        # — mixed-granularity meshes, where a chip and a rack super-node
        # differ by ~30x) hands "auto" a per-node dict instead.
        if rx_gbs == "auto":
            node_rx = getattr(self.topo, "node_rx_gbs", None)
            self.rx_gbs: float | dict[int, float] | None = (
                dict(node_rx) if node_rx is not None
                else default_rx_gbs(self.topo)
            )
        else:
            self.rx_gbs = rx_gbs
        # per-dim per-node IO caps (switched tiers, see flows.dim_io_gbs)
        self.dim_io_gbs = dim_io_gbs
        # "vectorized" numpy water-filling (default) or the pure-Python
        # "reference" oracle (netsim/solver.py)
        self.solver = solver
        # run multi-ring steps as aggregate flows; automatically expanded
        # per pair on failure-injection runs (APR reroute needs per-flow
        # paths)
        self.aggregate = aggregate
        # logical-axis -> topology-dims override (rack-coarsened meshes lay
        # their axes out differently from the pod convention)
        self.axis_dims = axis_dims
        # record a Telemetry per run (utilization timelines, bottleneck
        # attribution, router counters; exported via
        # NetSimResult.telemetry.summary()/to_perfetto())
        self.telemetry = telemetry
        # False rebuilds the wire-capacity dicts per run instead of using
        # the per-topology template cache (flows._WIRE_TEMPLATES) — only
        # the throughput benchmark's pre-cache baseline wants this
        self.reuse_wire_template = reuse_wire_template
        # links dead from t=0 in EVERY run of this sim — the degraded-mesh
        # repricing hook: calibration DAGs route around them through the
        # live APR machinery (candidate paths skip dead links), so a
        # ``calibrated_profile`` on a failed-link NetSim measures the
        # post-reroute bandwidth of the degraded fabric.  Aggregate ring
        # steps are force-expanded per pair (reroute needs per-flow paths)
        # and batched calibration is disabled (a failure breaks the
        # translation symmetry relocation relies on).
        self.failed_links = tuple(tuple(l) for l in failed_links)
        # message-level latency mode (netsim/messages.py): DAG tasks become
        # store-and-forward messages — per-hop serialization + propagation +
        # FIFO queueing replace both the fluid rate sharing AND the flat
        # per-task launch delay.  Off (the default) leaves the fluid code
        # path completely untouched: bit-identical to a sim built without
        # the flag.  ``dim_latency_s`` optionally overrides the per-hop
        # latency per topology dimension (default: ``latency_s`` flat).
        self.message_level = message_level
        self.dim_latency_s = dict(dim_latency_s or {})
        if message_level and self.failed_links:
            raise ValueError(
                "message_level does not support failed_links: failure "
                "injection and APR reroute are fluid-mode features"
            )
        self.last_network: FluidNetwork | None = None   # post-run inspection
        self.last_telemetry: Telemetry | None = None

    # -- plumbing ----------------------------------------------------------
    def _fresh(self) -> Router:
        tel = Telemetry() if self.telemetry else None
        self.last_telemetry = tel
        net = FluidNetwork(
            self.topo,
            EventEngine(),
            record_rates=self.record_rates,
            rx_gbs=self.rx_gbs,
            dim_io_gbs=self.dim_io_gbs,
            solver=self.solver,
            telemetry=tel,
            reuse_wire_template=self.reuse_wire_template,
        )
        for u, v in self.failed_links:
            net.fail_link(u, v)         # dead from t=0; no flows exist yet
        return Router(
            net,
            self.routing,
            borrow_gbs=self.borrow_gbs,
            notify_latency_s=self.latency_s,
            adaptive=self.adaptive,
        )

    # -- primitive runs ----------------------------------------------------
    def run_dag(
        self,
        dag: FlowDAG,
        *,
        fail_link: tuple[int, int] | None = None,
        fail_at_s: float = 0.0,
        name: str | None = None,
    ) -> NetSimResult:
        """Execute a flow DAG; optionally fail one physical link mid-run.

        Aggregate ring-step tasks run as single weighted flows unless a
        failure is injected (or the NetSim was built with
        ``aggregate=False``), in which case they expand into per-pair
        routed sends so APR rerouting stays per-flow."""
        if self.message_level:
            if fail_link is not None:
                raise ValueError(
                    "message_level does not support fail_link injection"
                )
            return self._run_dags_messages([dag], names=[name])[0]
        router = self._fresh()
        net = router.net
        use_agg = self.aggregate and fail_link is None and not self.failed_links
        run = _DagRun(router, dag, self.latency_s, aggregate=use_agg)
        fail_stats: dict = {}
        if fail_link is not None:
            u, v = fail_link
            net.engine.schedule_at(
                fail_at_s, lambda: fail_stats.update(router.fail_link(u, v))
            )
        run.start()
        net.run()
        self.last_network = net
        res = self._dag_result(dag, run, net, name)
        res.failure_stats = fail_stats
        res.telemetry = net.telemetry
        return res

    @staticmethod
    def _dag_result(dag, run: _DagRun, net, name: str | None = None) -> NetSimResult:
        makespan = max(run.end_s.values(), default=0.0)
        return NetSimResult(
            name=name or dag.name,
            makespan_s=makespan,
            task_end_s=dict(run.end_s),
            link_utilization=net.utilization(makespan or None),
            # transfer-level: a re-split withdraws flows mid-stream, so the
            # flow ledger undercounts; completed tasks are the ground truth
            bytes_delivered=sum(dag.tasks[tid].total_bytes for tid in run.end_s),
            events=net.engine.events_fired,
            incomplete=len(dag.tasks) - len(run.end_s),
        )

    def run_dags(self, dags: "list[FlowDAG]") -> list[NetSimResult]:
        """Execute several flow DAGs CONCURRENTLY on one shared network.

        All DAGs start at t=0 and contend for the same links — which is
        the point: e.g. a model-axis calibration inside an embedded
        chip-level rack while cross-pod DP background traffic crosses the
        rack's trunk uplinks (``netsim/coarsen.mixed_calibrated_profile``).
        Returns one result per DAG in order; each result's utilization is
        the shared network's, averaged over that DAG's own makespan."""
        if self.message_level:
            return self._run_dags_messages(dags)
        router = self._fresh()
        net = router.net
        use_agg = self.aggregate and not self.failed_links
        runs = [
            _DagRun(router, dag, self.latency_s, aggregate=use_agg)
            for dag in dags
        ]
        for run in runs:
            run.start()
        net.run()
        self.last_network = net
        results = []
        for dag, run in zip(dags, runs):
            r = self._dag_result(dag, run, net)
            r.telemetry = net.telemetry      # shared network, shared recorder
            results.append(r)
        return results

    # -- message-level (latency) runs --------------------------------------
    def _run_dags_messages(
        self, dags: "list[FlowDAG]", names: "list[str | None] | None" = None
    ) -> list[NetSimResult]:
        """Execute DAGs concurrently at message granularity
        (``netsim/messages.py``): store-and-forward serialization +
        per-hop propagation + FIFO queueing on the same wire inventory,
        no fluid solver, no flat launch delay."""
        from .messages import MessageDagRun, MessageNetwork

        msgnet = MessageNetwork(
            self.topo,
            EventEngine(),
            latency_s=self.latency_s,
            dim_latency_s=self.dim_latency_s,
            rx_gbs=self.rx_gbs,
            reuse_wire_template=self.reuse_wire_template,
        )
        runs = [MessageDagRun(msgnet, dag) for dag in dags]
        for run in runs:
            run.start()
        msgnet.engine.run()
        results = []
        for i, (dag, run) in enumerate(zip(dags, runs)):
            makespan = max(run.end_s.values(), default=0.0)
            name = names[i] if names else None
            results.append(NetSimResult(
                name=name or dag.name,
                makespan_s=makespan,
                task_end_s=dict(run.end_s),
                link_utilization=msgnet.utilization(makespan or None),
                bytes_delivered=sum(
                    dag.tasks[tid].total_bytes for tid in run.end_s
                ),
                events=msgnet.engine.events_fired,
                incomplete=len(dag.tasks) - len(run.end_s),
                task_latency_s=run.task_latency_s,
            ))
        return results

    def measure_latency_profile(
        self,
        size_bytes: float = 64e3,
        *,
        widths: "dict | None" = None,
        axes: tuple[str, ...] | None = None,
        shapes: tuple[str, ...] = LATENCY_SHAPES,
    ) -> LatencyProfile:
        """Per-``(axis, shape)`` message-level latency statistics at a
        decode-sized payload — the latency-side sibling of
        :meth:`calibrated_profile`.

        Each shape's OWN collective DAG (the same builders the bandwidth
        calibration uses) is executed at message granularity regardless of
        this sim's ``message_level`` flag: per-hop serialization +
        propagation + FIFO link/ejection queueing.  Per entry:
        ``total_s`` is the collective's completion time and p50/p99 the
        distribution of per-task ready-to-delivery latencies within the
        run — incast queueing gives the A2A dispatch a heavy p99 tail
        while the fluid model would price every task at one flat
        ``latency_s``.  ``widths`` narrows measurement groups exactly as
        in :meth:`calibrated_profile` (the planner's TP*SP / EP
        footprints); memoization lives in
        ``core.perf_model.NetsimPerfModel.latency_profile``."""
        axis_dims = self._axis_dims_map(axes)
        lat: dict[tuple[str, str], LatencyStats] = {}
        for axis, dims in axis_dims.items():
            for shape in shapes:
                if shape not in LATENCY_SHAPES:
                    raise ValueError(
                        f"latency profiles cover {LATENCY_SHAPES}, "
                        f"got {shape!r}"
                    )
                dag = self._axis_shape_dag(
                    dims, shape, size_bytes,
                    self._width_of(widths, axis, shape),
                    tag=f"lat-{axis}-{shape}",
                )
                if dag is None or not dag.tasks:
                    continue
                res = self._run_dags_messages([dag])[0]
                if res.makespan_s <= 0:
                    continue
                lat[(axis, shape)] = LatencyStats.from_samples(
                    sorted(res.task_latency_s.values()), res.makespan_s
                )
        return LatencyProfile(lat=lat, size_bytes=float(size_bytes))

    def allreduce_time(
        self, dim: int, size_bytes: float, *, fixed: dict[int, int] | None = None
    ) -> float:
        """Multi-ring AllReduce completion time on one clique of ``dim``."""
        nodes = clique_nodes(self.topo, dim, fixed)
        dag = ring_allreduce(self.topo, nodes, size_bytes, tag=f"ar-dim{dim}")
        return self.run_dag(dag).makespan_s

    # -- workload-level run ------------------------------------------------
    def run(
        self,
        workload: WorkloadSpec,
        parallel_spec: ParallelSpec,
        *,
        techniques: tuple[str, ...] | None = None,
    ) -> NetSimResult:
        """Simulate one transfer of each parallelism technique's collective
        on the concrete topology; per-technique completion times land in
        ``collective_s`` with the per-iteration transfer counts alongside
        (``iteration_comm_s`` composes them, pre-overlap)."""
        compiled = compile_workload(self.topo, workload, parallel_spec)
        result = NetSimResult(
            name=workload.name,
            makespan_s=0.0,
            task_end_s={},
            link_utilization={},
            bytes_delivered=0.0,
            events=0,
        )
        for tech, (dag, n_eff) in sorted(compiled.items()):
            if techniques and tech not in techniques:
                continue
            r = self.run_dag(dag, name=f"{workload.name}/{tech}")
            result.collective_s[tech] = r.makespan_s
            result.transfer_counts[tech] = n_eff
            result.makespan_s = max(result.makespan_s, r.makespan_s)
            result.bytes_delivered += r.bytes_delivered
            result.events += r.events
            result.incomplete += r.incomplete
            for l, u in r.link_utilization.items():
                result.link_utilization[l] = max(
                    result.link_utilization.get(l, 0.0), u
                )
        return result

    # -- calibration back into the analytic stack --------------------------
    # collective "shape" -> (grid, hierarchical, single-ring) DAG compilers
    _RING_SHAPES = {
        "allreduce": (grid_allreduce, hierarchical_allreduce, ring_allreduce),
        "all_gather": (grid_all_gather, hierarchical_all_gather, ring_all_gather),
    }
    # A2A calibration group cap — see A2A_CALIBRATION_MAX_NODES in
    # core/cost_model.py (shared with the perf_model width canonicalization)
    A2A_MAX_NODES = A2A_CALIBRATION_MAX_NODES

    def _axis_ring_dag(
        self,
        dims: tuple[int, ...],
        size_bytes: float,
        width: int | None,
        tag: str,
        shape: str = "allreduce",
    ) -> FlowDAG | None:
        """Ring-schedule DAG (AllReduce / AllGather) of one logical axis,
        optionally restricted to a ``width``-chip group (full first-dim
        cliques widened across the second dim, the ``model_group``
        convention).  Full square planes run the cross-dim 2D multi-ring;
        narrower groups the hierarchical per-dim schedule; ``width < 2``
        means no collective at all."""
        grid_fn, hier_fn, ring_fn = self._RING_SHAPES[shape]
        if width is not None and width < 2:
            return None
        x = self.topo.shape[dims[0]]
        plane = math.prod(self.topo.shape[d] for d in dims)
        if width is None or width >= plane:
            if len(dims) == 2:
                dag = grid_fn(self.topo, dims, size_bytes, tag=tag)
                if dag is not None:
                    return dag
            return hier_fn(self.topo, dims, size_bytes, tag=tag)
        if width <= x or len(dims) == 1:
            nodes = clique_nodes(self.topo, dims[0])[: max(2, width)]
            return ring_fn(self.topo, nodes, size_bytes, tag=tag)
        boards = -(-width // x)
        coords = {dims[0]: tuple(range(x)), dims[1]: tuple(range(boards))}
        return hier_fn(
            self.topo, dims[:2], size_bytes, dim_coords=coords, tag=tag
        )

    def a2a_group_cap(self, dims: tuple[int, ...]) -> int:
        """Largest A2A calibration group for an axis over ``dims``: the EP
        footprint convention (``compile_traffic_entry``) never exceeds two
        first-dim cliques, and ``A2A_MAX_NODES`` bounds the explicit-relay
        DAG size.  ``core.perf_model.NetsimPerfModel`` canonicalizes its
        width keys against this same cap."""
        plane = math.prod(self.topo.shape[d] for d in dims)
        cap = min(self.A2A_MAX_NODES, plane)
        if dims[0] == 0:
            cap = min(cap, 2 * self.topo.shape[0])
        return cap

    def _axis_a2a_group(
        self, dims: tuple[int, ...], width: int | None
    ) -> list[int] | None:
        """Node group an axis-level A2A calibration runs on: the EP
        footprint convention (first-dim cliques widened across the second
        dim), capped at ``a2a_group_cap``."""
        cap = self.a2a_group_cap(dims)
        w = min(width or cap, cap)
        if w < 2:
            return None
        if dims[0] == 0:
            return model_group(self.topo, w)
        if len(dims) == 2:
            return grid_plane_nodes(self.topo, dims)[:w]
        return clique_nodes(self.topo, dims[0])[:w]

    def _axis_shape_dag(
        self,
        dims: tuple[int, ...],
        shape: str,
        size_bytes: float,
        width: int | None,
        tag: str,
    ) -> FlowDAG | None:
        """Calibration DAG for one ``(axis-dims, shape)`` pair.
        ``size_bytes`` is the per-chip payload in the matching CommModel
        formula's convention (input for RS/A2A, gathered output for AG)."""
        if shape in self._RING_SHAPES:
            return self._axis_ring_dag(dims, size_bytes, width, tag, shape)
        if shape == "all_to_all":
            group = self._axis_a2a_group(dims, width)
            if group is None:
                return None
            return multipath_all_to_all(
                self.topo, group, size_bytes / len(group), tag=tag
            )
        if shape == "p2p":
            nodes = clique_nodes(self.topo, dims[0])[:2]
            if len(nodes) < 2:
                return None
            dag = FlowDAG(name=tag)
            dag._add(src=nodes[0], dst=nodes[1], size=size_bytes, tag=tag)
            return dag
        raise ValueError(f"unknown collective shape {shape!r}")

    def _axis_dims_map(
        self, axes: tuple[str, ...] | None
    ) -> dict[str, tuple[int, ...]]:
        """Axis -> topology dims.  Default structural convention: dims
        (0, 1) are the intra-rack "model" domain, the rest the inter-rack
        "data" domain; a rack-coarsened mesh overrides the layout via the
        constructor's ``axis_dims``."""
        if self.axis_dims is not None:
            axis_dims = dict(self.axis_dims)
        else:
            axis_dims = {"model": (0, 1)}
            if self.topo.ndim > 2:
                axis_dims["data"] = tuple(range(2, self.topo.ndim))
        if axes is not None:
            axis_dims = {k: v for k, v in axis_dims.items() if k in axes}
        return axis_dims

    @staticmethod
    def _measured_shapes(shapes: tuple[str, ...]) -> tuple[str, ...]:
        """reduce_scatter aliases the all_gather measurement (same wire
        schedule), so measure all_gather whenever either is requested —
        shared by the chip, coarse and mixed calibration paths."""
        return tuple(dict.fromkeys(
            "all_gather" if s == "reduce_scatter" else s for s in shapes
        ))

    @staticmethod
    def _alias_reduce_scatter(
        gbs: dict, axis: str, shapes: tuple[str, ...]
    ) -> None:
        """Post-measurement bookkeeping for the reduce_scatter alias."""
        if "reduce_scatter" in shapes and (axis, "all_gather") in gbs:
            gbs[(axis, "reduce_scatter")] = gbs[(axis, "all_gather")]
        if "all_gather" not in shapes:
            gbs.pop((axis, "all_gather"), None)

    @staticmethod
    def _width_of(widths: "dict | None", axis: str, shape: str) -> int | None:
        """Calibration group width: ``(axis, shape)`` key wins over the
        bare axis key."""
        if not widths:
            return None
        return widths.get((axis, shape), widths.get(axis))

    @staticmethod
    def _wire_fraction(shape: str, n: int) -> float:
        """Per-chip wire bytes of ``shape`` as a fraction of the payload —
        the inverse of the matching ``CommModel`` formula, so the measured
        bandwidth plugs straight back in."""
        if n <= 1:
            return 0.0
        if shape == "allreduce":
            return 2.0 * (n - 1) / n
        if shape in ("all_gather", "reduce_scatter", "all_to_all"):
            return (n - 1) / n
        return 1.0                      # p2p

    def calibrated_axis_gbs(
        self,
        size_bytes: float = 64e6,
        *,
        comm: "CommModel | None" = None,
        axis_sizes: dict[str, int] | None = None,
        widths: dict[str, int] | None = None,
        axes: tuple[str, ...] | None = None,
    ) -> dict[str, float]:
        """Effective per-chip AllReduce bandwidth per logical mesh axis,
        measured from netsim runs — in the units ``CommModel``'s
        ``gbs_per_chip`` uses, so a ``core.perf_model`` backend can feed
        it back into ``core/simulator.simulate``.  (The single-shape
        predecessor of :meth:`calibrated_profile`; kept as the scalar
        entry point.)

        The axis-size normalization must match the CommModel the override
        will be applied to: pass ``comm`` (its ``axes[..].size`` wins) or
        explicit ``axis_sizes``; the fallback is the production mapping's
        16-wide model/data axes.  ``widths`` optionally narrows an axis'
        node group to the chips a parallelism group actually spans (e.g.
        the TP*SP footprint), which is what makes the calibration
        spec-dependent for the planner backend.

        Full square planes are measured on the cross-dim 2D multi-ring
        (Fig. 13), which keeps both dimensions' links busy every step —
        the hierarchical per-dim schedule only reaches about half of the
        plane's analytic bandwidth."""
        prof = self.calibrated_profile(
            size_bytes,
            comm=comm,
            axis_sizes=axis_sizes,
            widths=widths,
            axes=axes,
            shapes=("allreduce",),
        )
        return {a: g for (a, _s), g in prof.gbs.items()}

    def calibrated_profile(
        self,
        size_bytes: float = 64e6,
        *,
        comm: "CommModel | None" = None,
        axis_sizes: dict[str, int] | None = None,
        widths: "dict | None" = None,
        axes: tuple[str, ...] | None = None,
        shapes: tuple[str, ...] = COLLECTIVE_SHAPES,
    ) -> CalibrationProfile:
        """Effective per-chip bandwidth per ``(axis, collective shape)``,
        measured by executing each shape's own flow DAG on this topology.

        AllReduce/AllGather ride the multi-ring schedules (edge-disjoint,
        one inbound flow per ring per node); All-to-All rides the
        Fig. 14-(a) X-then-Y / Y-then-X split with explicit relay hops,
        where relay contention and receiver-egress (incast) serialization
        — modeled when this NetSim has ``rx_gbs`` enabled, the default —
        price it strictly below the AllReduce number on any
        multi-dimension axis.  ``reduce_scatter`` shares AllGather's wire
        schedule and aliases its measurement instead of re-running it.

        ``widths`` narrows the measurement group per axis; keys are either
        an axis name or an ``(axis, shape)`` pair (the pair wins), so a
        planner backend can calibrate the TP*SP footprint for ring shapes
        and the EP footprint for A2A independently.  Callers wanting
        memoization get it from ``core.perf_model.NetsimPerfModel``, which
        caches per (topology, axis, shape, group-width, routing, payload)
        — this method always measures."""
        axis_dims = self._axis_dims_map(axes)
        if axis_sizes is None and comm is not None:
            axis_sizes = {k: a.size for k, a in comm.axes.items()}
        sizes = axis_sizes or {"model": 16, "data": 16}

        gbs: dict[tuple[str, str], float] = {}
        for axis, dims in axis_dims.items():
            n = sizes.get(axis, 16)
            for shape in self._measured_shapes(shapes):
                dag = self._axis_shape_dag(
                    dims, shape, size_bytes, self._width_of(widths, axis, shape),
                    tag=f"cal-{axis}-{shape}",
                )
                if dag is None or not dag.tasks:
                    continue
                t = self.run_dag(dag).makespan_s
                if t <= 0:
                    continue
                wire = self._wire_fraction(shape, n) * size_bytes
                gbs[(axis, shape)] = wire / t / 1e9
            self._alias_reduce_scatter(gbs, axis, shapes)
        return CalibrationProfile(gbs=gbs)

    # -- batched calibration ------------------------------------------------
    def can_batch_calibration(self) -> bool:
        """Whether independent calibration DAGs may share one solver
        session by relocation to disjoint coordinate boxes.

        Requires translation symmetry (homogeneous per-dim link capacities
        and node caps) and box-confined routing.  Under SHORTEST/DETOUR,
        every APR candidate path stays inside the src/dst coordinate box
        (shortest paths permute the differing dims; detours relay through
        a third member of the *same* clique), so DAGs whose boxes are
        disjoint can never share a link, an rx port, or an IO port —
        BORROW breaks this with its global switch plane."""
        if self.routing == Routing.BORROW:
            return False
        if self.failed_links:
            return False                # a failure breaks translation symmetry
        if getattr(self.topo, "link_gbs", None) is not None:
            return False                # heterogeneous link capacities
        if isinstance(self.rx_gbs, dict):
            return False                # per-node rx caps
        if self.dim_io_gbs:
            return False                # switched-tier IO caps
        return True

    def _dag_box(self, dag: FlowDAG) -> list[set[int]]:
        """Per-dimension coordinate sets any flow of ``dag`` can touch.

        Single-path tasks pin their direct links, so only the endpoints'
        coordinates count; router-policy tasks may relay through any third
        member of a differing dimension's clique (APR detour), so each
        differing dim expands to its full range."""
        shape = self.topo.shape
        ndim = len(shape)
        dims = range(ndim)
        full = [set(range(s)) for s in shape]
        box: list[set[int]] = [set() for _ in shape]
        coords = self.topo.coords
        cache: dict[int, tuple[int, ...]] = {}
        for t in dag.tasks:
            pairs = t.pairs if t.pairs else ((t.src, t.dst),)
            single = t.single_path
            for u, v in pairs:
                cu = cache.get(u)
                if cu is None:
                    cu = cache[u] = coords(u)
                cv = cache.get(v)
                if cv is None:
                    cv = cache[v] = coords(v)
                for d in dims:
                    box[d].add(cu[d])
                    box[d].add(cv[d])
                    if cu[d] != cv[d] and not single:
                        box[d] |= full[d]
        return box

    def _place_dag(
        self,
        dag: FlowDAG,
        box: list[set[int]],
        placed: list[list[set[int]]],
    ) -> "tuple[FlowDAG, list[set[int]]] | None":
        """Translate ``dag`` so its box is disjoint from every ``placed``
        box, or ``None`` when no translation fits.  Only dimensions the
        DAG does not use (box == {0}, the builders' base-corner
        convention) are offset; the identity placement is tried first, so
        a batch of one reproduces the sequential run exactly."""
        import itertools

        shape = self.topo.shape
        free = [d for d in range(len(shape)) if box[d] == {0}]
        for offs in itertools.product(*(range(shape[d]) for d in free)):
            tbox = [
                {offs[free.index(d)]} if d in free else set(box[d])
                for d in range(len(shape))
            ]
            ok = all(
                any(not tbox[d] & pb[d] for d in range(len(shape)))
                for pb in placed
            )
            if not ok:
                continue
            if not any(offs):
                return dag, tbox
            delta = {free[i]: offs[i] for i in range(len(free))}
            coords, node_id = self.topo.coords, self.topo.node_id
            cache: dict[int, int] = {}

            def translate(n: int) -> int:
                m = cache.get(n)
                if m is None:
                    c = list(coords(n))
                    for d, o in delta.items():
                        c[d] = o
                    m = cache[n] = node_id(tuple(c))
                return m

            return remap_dag(dag, translate), tbox
        return None

    def measure_profile_batch(
        self,
        size_bytes: float,
        requests: "list[tuple[str, str, int | None]]",
        *,
        comm: "CommModel | None" = None,
        axis_sizes: dict[str, int] | None = None,
        batch_size: int = 8,
        stats: dict | None = None,
    ) -> "dict[tuple[str, str, int | None], float | None]":
        """Measure many ``(axis, shape, width)`` calibration keys in few
        solver sessions.

        Each key's flow DAG is built exactly as :meth:`calibrated_profile`
        would, then translated (``remap_dag``) into a disjoint coordinate
        box of the same mesh — translation symmetry plus APR's
        box-confinement (see :meth:`can_batch_calibration`) make the
        concurrent DAGs provably non-interacting, so each measured
        makespan equals its sequential value (to fp accumulation order).
        Keys that cannot batch (no placement left, ``batch_size``
        reached, or the NetSim configuration forbids it) run sequentially.
        Returns measured GB/s per request (``None`` where the shape
        yields no DAG on this topology — the caller's analytic-fallback
        convention).  ``stats``, when given, accumulates ``sessions``
        (solver sessions run) and ``session_keys`` (keys measured across
        them) so sweep drivers can report batching efficiency."""
        if axis_sizes is None and comm is not None:
            axis_sizes = {k: a.size for k, a in comm.axes.items()}
        sizes = axis_sizes or {"model": 16, "data": 16}
        axis_dims = self._axis_dims_map(None)

        out: "dict[tuple[str, str, int | None], float | None]" = {}
        build: list[tuple[tuple[str, str, int | None], FlowDAG]] = []
        for axis, shape, w in requests:
            dims = axis_dims.get(axis)
            dag = (
                self._axis_shape_dag(
                    dims, shape, size_bytes, w, tag=f"cal-{axis}-{shape}"
                )
                if dims is not None
                else None
            )
            if dag is None or not dag.tasks:
                out[(axis, shape, w)] = None
                continue
            build.append(((axis, shape, w), dag))

        def finish(key, makespan: float) -> None:
            axis, shape, _w = key
            n = sizes.get(axis, 16)
            wire = self._wire_fraction(shape, n) * size_bytes
            out[key] = wire / makespan / 1e9 if makespan > 0 else None

        def count(keys: int) -> None:
            if stats is not None:
                stats["sessions"] = stats.get("sessions", 0) + 1
                stats["session_keys"] = stats.get("session_keys", 0) + keys

        if not self.can_batch_calibration():
            for key, dag in build:
                count(1)
                finish(key, self.run_dag(dag).makespan_s)
            return out

        # greedy first-fit packing into batches of relocated DAGs
        batch: list[tuple[tuple[str, str, int | None], FlowDAG]] = []
        boxes: list[list[set[int]]] = []

        def flush() -> None:
            if not batch:
                return
            count(len(batch))
            for res, (key, _dag) in zip(
                self.run_dags([dag for _k, dag in batch]), batch
            ):
                finish(key, res.makespan_s)
            batch.clear()
            boxes.clear()

        for key, dag in build:
            if len(batch) >= batch_size:
                flush()
            placed = self._place_dag(dag, self._dag_box(dag), boxes)
            if placed is None:
                flush()
                placed = self._place_dag(dag, self._dag_box(dag), [])
            if placed is None:          # does not fit even alone (cannot
                count(1)                # happen today)
                finish(key, self.run_dag(dag).makespan_s)
                continue
            tdag, tbox = placed
            batch.append((key, tdag))
            boxes.append(tbox)
        flush()
        return out


# ---------------------------------------------------------------------------
# Cross-topology batched calibration (topology co-design sweeps)
# ---------------------------------------------------------------------------

# host meshes are cached so ``flows``' per-topology wire templates survive
# across sweep groups with the same dimension specs
_HOST_MESH_CACHE: "dict[tuple, NDFullMesh]" = {}


def _host_mesh(dim_specs: "tuple[DimSpec, ...]", n_slots: int) -> NDFullMesh:
    """A common host mesh for ``n_slots`` concurrent calibration DAGs that
    all live on dimensions ``dim_specs``: the candidate dims plus one
    passive batch dimension "B" of size ``n_slots``.  DAGs in distinct
    B-slots have disjoint coordinate boxes, so by the same box-confinement
    argument as :meth:`NetSim.can_batch_calibration` they never share a
    link or an rx port."""
    key = (dim_specs, n_slots)
    topo = _HOST_MESH_CACHE.get(key)
    if topo is None:
        dims = dim_specs + (DimSpec("B", n_slots, PASSIVE_ELECTRICAL, 1),)
        topo = _HOST_MESH_CACHE[key] = NDFullMesh(dims=dims)
    return topo


def measure_cross_topology(
    jobs: "list[tuple[NetSim, float, list[tuple[str, str, int | None]], dict[str, int]]]",
    *,
    batch_size: int = 8,
    stats: dict | None = None,
) -> "list[dict[tuple[str, str, int | None], float | None]]":
    """Measure calibration keys from *different candidate topologies* in
    shared solver sessions (the cross-topology extension of
    :meth:`NetSim.measure_profile_batch`).

    ``jobs`` is one ``(sim, size_bytes, requests, axis_sizes)`` tuple per
    candidate; the return value is one ``{key: GB/s | None}`` dict per job,
    exactly what each job's own ``measure_profile_batch`` would return.

    Two levels of sharing:

    * **Dedup** — a measured makespan is a function of the DAG's structure
      and the link capacities it touches, not of the candidate it came
      from.  Requests whose *measurement signature* matches (the DimSpecs
      of the dimensions their DAG actually uses, the axis-dims shapes, the
      collective shape/width, payload, routing, latency, rx cap, solver)
      are measured once and fanned back out to every requesting candidate
      — each with its own axis-size wire normalization.
    * **Session sharing** — distinct signatures over the same used-dim
      specs are relocated into disjoint B-slots of one host mesh
      (:func:`_host_mesh`) and solved concurrently, the way
      ``measure_profile_batch`` packs one topology's keys into boxes.

    Candidates whose configuration forbids batching
    (``can_batch_calibration`` False — BORROW routing, per-node rx dicts,
    switched-tier IO caps) fall back to their own sequential
    ``measure_profile_batch`` path, parity-preserved."""
    results: "list[dict[tuple[str, str, int | None], float | None]]" = [
        {} for _ in jobs
    ]
    # group key -> dedup key -> measurement entry
    groups: dict = {}
    for j, (sim, size_bytes, requests, axis_sizes) in enumerate(jobs):
        sizes = axis_sizes or {"model": 16, "data": 16}
        if not sim.can_batch_calibration():
            results[j] = sim.measure_profile_batch(
                size_bytes,
                requests,
                axis_sizes=sizes,
                batch_size=batch_size,
                stats=stats,
            )
            continue
        axis_dims = sim._axis_dims_map(None)
        for axis, shape, w in requests:
            dims = axis_dims.get(axis)
            if dims is None:
                results[j][(axis, shape, w)] = None
                continue
            # calibration DAG builders work at the base corner of ``dims``
            # (every other coordinate is 0), so the dims of size > 1 are a
            # superset of any coordinate the DAG can touch — cheap to
            # compute (no DAG build, no box scan) and sufficient for both
            # the host-mesh embedding and the dedup signature (the DAG is
            # a pure function of the mkey shapes and the sig capacities)
            used = tuple(d for d in dims if sim.topo.shape[d] > 1)
            if not used:
                # degenerate: every dim the axis maps to has size 1, so
                # any DAG is confined to one node — run it alone
                dag = sim._axis_shape_dag(
                    dims, shape, size_bytes, w, tag=f"cal-{axis}-{shape}"
                )
                if dag is None or not dag.tasks:
                    results[j][(axis, shape, w)] = None
                    continue
                if stats is not None:
                    stats["sessions"] = stats.get("sessions", 0) + 1
                    stats["session_keys"] = stats.get("session_keys", 0) + 1
                ms = sim.run_dag(dag).makespan_s
                n = sizes.get(axis, 16)
                wire = NetSim._wire_fraction(shape, n) * size_bytes
                results[j][(axis, shape, w)] = (
                    wire / ms / 1e9 if ms > 0 else None
                )
                continue
            specs = tuple(sim.topo.dims[d] for d in used)
            # the rx (incast) cap only binds when a node's total inflow
            # through the used dims can exceed it — below that bound it is
            # inert, so canonicalize it away: candidates differing only in
            # the lanes of *unused* dims (which drive their "auto" rx) then
            # share one measurement
            rx = sim.rx_gbs
            if rx is not None and rx >= sum(s.gbs_total for s in specs):
                rx = None
            sig = (
                specs,
                sim.routing.value,
                round(sim.latency_s, 12),
                rx,
                sim.solver,
                sim.aggregate,
                sim.adaptive,
                float(size_bytes),
            )
            # everything the DAG *structure* depends on beyond the
            # signature: the axis-dims shapes (clique/plane sizes the
            # builders see), whether dims[0]==0 (the a2a group-cap and
            # model_group special case), the collective shape and width
            mkey = (
                tuple(sim.topo.shape[d] for d in dims),
                dims[0] == 0,
                shape,
                w,
            )
            entry = groups.setdefault(sig, {}).setdefault(
                mkey,
                {"sim": sim, "dims": dims, "used": used, "axis": axis,
                 "shape": shape, "w": w, "refs": []},
            )
            entry["refs"].append((j, (axis, shape, w), sizes.get(axis, 16)))

    for sig, by_key in groups.items():
        specs = sig[0]
        size_bytes = sig[-1]
        # one representative DAG per deduped (sig, mkey) — built lazily
        # here so the candidates' duplicate requests never pay for a build
        entries = []
        for e in by_key.values():
            dag = e["sim"]._axis_shape_dag(
                e["dims"],
                e["shape"],
                size_bytes,
                e["w"],
                tag=f"cal-{e['axis']}-{e['shape']}",
            )
            if dag is None or not dag.tasks:
                for j, key, n in e["refs"]:
                    results[j][key] = None
                continue
            e["dag"] = dag
            entries.append(e)
        for lo in range(0, len(entries), batch_size):
            chunk = entries[lo : lo + batch_size]
            host = _host_mesh(specs, len(chunk))
            hsim = NetSim(
                host,
                routing=Routing(sig[1]),
                latency_s=sig[2],
                rx_gbs=sig[3],
                solver=sig[4],
                aggregate=sig[5],
                adaptive=sig[6],
            )
            n_slots = len(chunk)
            dags = []
            for slot, e in enumerate(chunk):
                cand, used = e["sim"].topo, e["used"]
                # vectorized node relocation: both meshes are row-major,
                # so project the candidate coords onto the used dims and
                # ravel into the host (the trailing B dim is the slot)
                coords = np.unravel_index(
                    np.arange(cand.num_nodes), cand.shape
                )
                host_ids = np.ravel_multi_index(
                    tuple(coords[d] for d in used)
                    + (np.full(cand.num_nodes, slot),),
                    host.shape,
                ).tolist()
                dags.append(remap_dag(e["dag"], host_ids.__getitem__))
            if stats is not None:
                stats["sessions"] = stats.get("sessions", 0) + 1
                stats["session_keys"] = (
                    stats.get("session_keys", 0) + len(chunk)
                )
            for e, res in zip(chunk, hsim.run_dags(dags)):
                ms = res.makespan_s
                for j, key, n in e["refs"]:
                    wire = NetSim._wire_fraction(key[1], n) * size_bytes
                    results[j][key] = wire / ms / 1e9 if ms > 0 else None
    return results
