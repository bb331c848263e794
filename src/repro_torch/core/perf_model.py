"""The port's own copy of ``repro/core/perf_model.py``, held to the original by
``tests/test_torch_netsim_parity.py`` and against it by
``tests/test_torch_perf_model_parity.py``; only its
imports of the package, and the package's name where its docstring
gives it, differ.

Pluggable performance-model backends for planning and simulation.

The §5.2 planner, the iteration simulator and the benchmark harness all
price communication through one interface, the ``PerfModel`` protocol:

    comm_model(p)  ->  CommModel      # concrete axis costs for spec ``p``

Two backends implement it:

* **analytic** — ``CommModel`` itself (closed-form alpha-beta costs with
  idealized multi-ring bandwidths; spec-invariant).  ``AnalyticPerfModel``
  is the same backend with explicit per-axis bandwidth overrides — the
  typed replacement for the old ``simulate(axis_gbs_override=...)``
  plumbing — and can additionally carry a ``CalibrationProfile`` of
  measured per-(axis, collective-shape) bandwidths.
* **netsim-calibrated** — ``NetsimPerfModel`` measures each axis'
  effective bandwidth **per collective shape** by *executing* the matching
  flow DAG on the flow-level simulator (``repro_torch.netsim``): AllReduce /
  AllGather ride the multi-ring schedules, All-to-All rides the Fig. 14
  X-then-Y / Y-then-X split with explicit relay hops and receiver-egress
  (incast) caps, P2P a routed transfer.  Contention, chain-endpoint
  idling, relay serialization and incast are priced instead of assumed.
  Ranking hundreds of candidate specs stays tractable because calibration
  is memoized per unique ``(topology, axis, shape, group-width, routing,
  payload)`` key — NOT per spec: a 1024-chip search hits only a handful
  of distinct TP*SP / EP footprints.

Two spec-dependences matter for planning:

* the **model-axis group width**: a TP*SP group spanning the whole (X, Y)
  rack plane rides the cross-dim 2D multi-ring (~85% of the analytic
  bandwidth), while a partial plane is stuck with the per-dimension
  hierarchical schedule (~50%);
* the **collective shape**: the MoE dispatch A2A prices ~3x below the
  AllReduce number on the same axis (relay hops + incast), so an
  AllReduce-proxy backend systematically flatters expert parallelism —
  restrict ``shapes=("allreduce",)`` to reproduce that proxy behavior.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Protocol, runtime_checkable

from .cost_model import (
    A2A_CALIBRATION_MAX_NODES,
    COLLECTIVE_SHAPES,
    LATENCY_SHAPES,
    AxisCost,
    CalibrationProfile,
    CommModel,
    LatencyProfile,
    LatencyStats,
)
from .topology import NDFullMesh, SuperPod, ub_mesh_pod
from .traffic import ParallelSpec

# collective shapes that cross the HRS pod tier (DP gradient traffic and
# pipeline boundaries); EP's all-to-all never leaves the model axis
_POD_SHAPES = ("allreduce", "all_gather", "reduce_scatter", "p2p")


@runtime_checkable
class PerfModel(Protocol):
    """Anything that can resolve a candidate spec to concrete axis costs."""

    @property
    def backend(self) -> str: ...

    def comm_model(self, p: ParallelSpec | None = None) -> CommModel: ...

    def override_axis(self, name: str, cost: AxisCost) -> "PerfModel": ...


@dataclass(frozen=True)
class AnalyticPerfModel:
    """Closed-form backend with explicit per-axis bandwidth overrides.

    ``axis_gbs`` replaces the per-chip bandwidth of named axes — e.g. a
    one-off calibration from ``NetSim.calibrated_axis_gbs`` — without the
    untyped dict plumbing ``simulate`` used to carry.  ``profile``
    optionally stamps measured per-(axis, collective-shape) bandwidths
    (a ``NetSim.calibrated_profile`` result) on top, so a one-off
    measurement can drive shape-aware pricing without the netsim backend's
    per-spec recalibration.
    """

    base: CommModel
    axis_gbs: dict[str, float] = field(default_factory=dict)
    profile: CalibrationProfile | None = None

    @property
    def backend(self) -> str:
        return "analytic"

    def comm_model(self, p: ParallelSpec | None = None) -> CommModel:
        comm = self.base
        if self.axis_gbs:
            axes = {
                k: replace(a, gbs_per_chip=self.axis_gbs.get(k, a.gbs_per_chip))
                for k, a in comm.axes.items()
            }
            comm = CommModel(axes=axes, routing=comm.routing)
        if self.profile is not None:
            comm = self.profile.apply(comm)
        return comm

    def override_axis(self, name: str, cost: AxisCost) -> "AnalyticPerfModel":
        gbs = {k: v for k, v in self.axis_gbs.items() if k != name}
        return AnalyticPerfModel(
            self.base.override_axis(name, cost), gbs, self.profile
        )


def _topo_key(topo: NDFullMesh) -> tuple:
    return tuple(
        (d.name, d.size, d.lanes_per_peer, d.link.name) for d in topo.dims
    )


# calibration memo shared across backend instances: one netsim execution per
# unique (topology, axis, shape, group-width, routing, payload, latency, rx)
# — the same key appears once whether the planner scores 10 specs or 1000
_CALIBRATION_CACHE: dict[tuple, float] = {}

# latency-mode sibling of the bandwidth memo: one message-level netsim
# execution per unique (topology, routing, ..., "latency-mode", payload,
# axis, shape, width) key, holding the full LatencyStats (p50/p99/mean/
# total) rather than a scalar GB/s
_LATENCY_CACHE: dict[tuple, LatencyStats] = {}

# LatencyStats fields persisted per key in the disk store; each becomes a
# ``(axis, f"{shape}@{field}", width)`` entry so the store's 3-part
# ``axis|shape|width`` key format carries stats without a schema change
_LATENCY_STAT_FIELDS = ("p50_s", "p99_s", "mean_s", "total_s", "n")

# persistent-store handles per resolved cache directory (shares the
# corrupt-file warn-once bookkeeping across NetsimPerfModel instances)
_DISK_CACHES: dict[str, object] = {}

# running memo-effectiveness counters, cumulative since import (or the last
# ``reset_calibration_stats``).  ``per_key_s`` keeps the netsim wall cost of
# each (axis, shape, width) actually measured — the observability hook that
# shows WHERE planner time goes when the memo misses
_CALIBRATION_STATS: dict = {
    "hits": 0,
    "misses": 0,
    "disk_hits": 0,
    "measure_s": 0.0,
    "per_key_s": {},
    "sessions": 0,
    "session_keys": 0,
}


def calibration_stats() -> dict:
    """Snapshot of the shared calibration-memo counters: ``hits`` /
    ``misses`` (in-memory memo lookups by ``_calibrate``), ``disk_hits``
    (misses served by the persistent ``core.calib_cache`` store instead
    of a netsim run), ``measure_s`` (total netsim wall seconds spent
    measuring), ``per_key_s`` mapping each measured ``(axis, shape,
    width)`` to its wall cost (batched measurements split their batch
    wall time evenly across the batch's keys), and ``sessions`` /
    ``session_keys`` (solver sessions run and keys measured across them
    — ``session_keys / sessions`` is the batching efficiency)."""
    return {
        "hits": _CALIBRATION_STATS["hits"],
        "misses": _CALIBRATION_STATS["misses"],
        "disk_hits": _CALIBRATION_STATS["disk_hits"],
        "measure_s": _CALIBRATION_STATS["measure_s"],
        "per_key_s": dict(_CALIBRATION_STATS["per_key_s"]),
        "sessions": _CALIBRATION_STATS["sessions"],
        "session_keys": _CALIBRATION_STATS["session_keys"],
    }


def reset_calibration_stats() -> None:
    """Zero the memo counters (the cache itself is untouched)."""
    _CALIBRATION_STATS.update(
        hits=0, misses=0, disk_hits=0, measure_s=0.0,
        sessions=0, session_keys=0,
    )
    _CALIBRATION_STATS["per_key_s"] = {}


def _record_measurement(axis: str, shape: str, w: int | None, dt: float) -> None:
    _CALIBRATION_STATS["measure_s"] += dt
    per_key = _CALIBRATION_STATS["per_key_s"]
    k = (axis, shape, w)
    per_key[k] = per_key.get(k, 0.0) + dt


@dataclass(frozen=True)
class NetsimPerfModel:
    """Netsim-calibrated backend: effective axis bandwidths measured by
    executing each (axis, collective shape)'s flow DAG on the concrete
    topology, assembled into a ``CalibrationProfile`` per spec.

    ``comm_model(p)`` narrows the model-axis ring-collective calibration
    to the TP*SP footprint of ``p`` (capped at the topology's own (X, Y)
    rack plane, so the cap always matches the fabric being simulated) and
    the model-axis A2A calibration to the EP footprint (the
    ``compile_traffic_entry`` convention: up to two first-dim cliques) —
    so wide groups that can ride the cross-dim 2D multi-ring price
    differently from narrow ones, and EP volume is priced on the measured
    A2A number while TP/DP keep theirs.  The data axis is calibrated once
    over the full inter-rack plane.  Axes the netsim topology cannot
    measure (e.g. the HRS "pod" tier) keep their analytic cost.

    ``shapes`` selects what gets measured: the default is the full
    ``COLLECTIVE_SHAPES`` profile; ``("allreduce",)`` reproduces the
    earlier AllReduce-proxy backend, where every collective is priced on
    the ring-calibrated scalar (useful as the baseline that shows why
    shape-aware pricing changes planner decisions).  ``rx_gbs`` is the
    receiver-egress (incast) cap handed to netsim ("auto" = the node's
    largest per-dim clique allocation).

    ``superpod`` unlocks multi-pod pricing: the "pod" axis — previously
    pinned to its analytic DCN cost because the chip-level pod topology
    cannot see the HRS tier — is calibrated on the **rack-coarsened**
    SuperPod mesh (``netsim/coarsen.py``: racks become super-nodes, the
    Clos tier an IO-capped extra dimension), so cross-pod DP/PP traffic
    is priced on measured multi-pod bandwidths.  The memo key gains the
    coarsening level (``coarsen_level``), so rack- and pod-granularity
    calibrations never alias.

    ``detail_racks`` (with ``superpod``) switches the MODEL-axis
    calibration from the isolated chip-level pod onto a
    **mixed-granularity** mesh: the named racks stay at chip granularity
    inside the rack-coarsened SuperPod, and the model-axis collectives
    are measured inside the embedded rack WHILE a cross-pod DP
    background AllReduce (``background_bytes`` per chip, default
    ``size_bytes``) crosses the same rack's trunk uplinks — so the
    planner finally sees model-axis interference from DCN traffic
    (ejection-port and uplink sharing), which both the pure-chip and
    pure-coarse calibrations miss by construction.  The memo key gains
    the ``detail_racks`` tuple and the background payload, so mixed and
    isolated model calibrations never alias.
    """

    base: CommModel
    topo: NDFullMesh = field(default_factory=ub_mesh_pod)
    size_bytes: float = 256e6
    latency_s: float = 1e-6
    pinned: dict[str, AxisCost] = field(default_factory=dict)
    shapes: tuple[str, ...] = COLLECTIVE_SHAPES
    rx_gbs: float | str | None = "auto"
    superpod: SuperPod | None = None
    coarsen_level: str = "rack"
    detail_racks: tuple[int, ...] = ()
    background_bytes: float | None = None
    # persistent calibration cache directory: "auto" resolves
    # $CALIB_CACHE_DIR / ~/.cache (core/calib_cache.py), an explicit path
    # pins it, None disables disk persistence entirely
    cache_dir: "str | None" = "auto"
    # how many independent chip-level calibration DAGs share one netsim
    # solver session (NetSim.measure_profile_batch); 1 = sequential
    batch_size: int = 4
    # False rebuilds the FluidNetwork wire structure from scratch on every
    # measurement session (the pre-template-cache behavior) — the per-spec
    # baseline leg of benchmarks/netsim_scale.netsim_planner_throughput
    reuse_wire_template: bool = True
    # degraded-mesh repricing (runtime/campaign.py): chip-level links dead
    # from t=0 in every measurement — calibration DAGs route around them
    # through APR reroute, so the profile prices the POST-FAILURE fabric.
    # Only the axes whose dims contain a failed link get degraded cache
    # keys; unaffected axes keep their healthy keys (box-confined routing
    # never crosses the failure), which is what makes repricing
    # incremental: the first degraded query measures only the hit axes and
    # every healthy axis is a memo/disk hit.
    failed_links: "tuple[tuple[int, int], ...]" = ()

    def __post_init__(self) -> None:
        if self.failed_links and self.detail_racks:
            raise ValueError(
                "failed_links and detail_racks cannot combine: degraded "
                "repricing runs on the isolated chip-level pod"
            )
        if self.detail_racks and self.superpod is None:
            # without a SuperPod there is no coarse mesh to embed the
            # detail racks in — silently falling back to the isolated
            # chip-level calibration would defeat the caller's intent
            raise ValueError(
                "detail_racks requires superpod= (the mixed-granularity "
                "mesh embeds the racks in the coarsened SuperPod)"
            )

    @property
    def backend(self) -> str:
        return "netsim"

    # -- calibration (memoized) -------------------------------------------
    def _tags(self) -> tuple[tuple, tuple, tuple, float]:
        """(key_base, coarse_tag, detail_tag, bg_bytes) — everything that
        pins a measurement besides the (axis, shape, width) request."""
        key_base = (
            _topo_key(self.topo),
            self.base.routing.value,
            self.size_bytes,
            self.latency_s,
            self.rx_gbs,
        )
        coarse_tag = ()
        if self.superpod is not None:
            # the coarse capacities derive from the SuperPod's OWN pod
            # (trunk widths, racks per pod), which need not equal
            # self.topo — key on its geometry too so distinct SuperPods
            # never alias in the shared cache
            coarse_tag = (
                "coarse",
                self.coarsen_level,
                self.superpod.n_pods,
                self.superpod.uplink_lanes_per_rack,
                _topo_key(self.superpod.pod),
            )
        detail_tag = ()
        bg_bytes = (
            self.size_bytes if self.background_bytes is None
            else self.background_bytes
        )
        if self.superpod is not None and self.detail_racks:
            # mixed-granularity model-axis calibration: keyed on the
            # embedded racks AND the background payload so isolated and
            # interference-priced measurements never alias
            detail_tag = ("detail", tuple(self.detail_racks), bg_bytes)
        return key_base, coarse_tag, detail_tag, bg_bytes

    def _degraded_axes(self) -> frozenset:
        """Chip-level axes whose calibration DAGs can see a failed link.

        An axis is affected iff some failed link's dimension belongs to
        the axis' dim set (model = dims 0-1, data = the rest): calibration
        DAGs are built at the base corner and routing is box-confined
        under SHORTEST/DETOUR, so a flow only ever traverses links of its
        own axis' dimensions.  The coarse "pod" axis is never affected by
        chip-level failures."""
        if not self.failed_links:
            return frozenset()
        ndim = len(self.topo.shape)
        axis_dims = {"model": (0, 1)}
        if ndim > 2:
            axis_dims["data"] = tuple(range(2, ndim))
        hit = set()
        for u, v in self.failed_links:
            d = self.topo.are_adjacent(u, v)
            if d is None:
                raise ValueError(
                    f"failed link ({u}, {v}) is not a physical link of the "
                    "topology"
                )
            for a, dims in axis_dims.items():
                if d in dims:
                    hit.add(a)
        return frozenset(hit)

    def _store_kind(self, axis: str, detail_tag: tuple) -> str:
        """Which persistent-cache file an axis' measurements live in —
        mirrors the in-memory key composition exactly."""
        if axis == "pod":
            return "pod"
        if axis == "model" and detail_tag:
            return "mixed"
        if axis in self._degraded_axes():
            return "degraded"
        return "chip"

    def _disk_cache(self) -> "object | None":
        if self.cache_dir is None:
            return None
        from .calib_cache import CalibCache, default_cache_dir

        d = (
            default_cache_dir() if self.cache_dir == "auto"
            else self.cache_dir
        )
        cache = _DISK_CACHES.get(str(d))
        if cache is None:
            cache = _DISK_CACHES[str(d)] = CalibCache(d)
        return cache

    def _calibrate(
        self, widths: dict[tuple[str, str], int | None]
    ) -> dict[tuple[str, str], float]:
        """(axis, shape) -> measured GB/s for the requested group widths,
        via the shared cross-instance memo (and the persistent disk store
        when enabled); ``reduce_scatter`` aliases the ``all_gather``
        measurement (same wire schedule)."""
        triples = [(a, s, w) for (a, s), w in widths.items()]
        vals = self._calibrate_keys(triples)
        return {(a, s): vals[(a, s, w)] for (a, s), w in widths.items()}

    def _key_context(self):
        """The memo-key closure plus persistent-store configs — shared by
        the per-model ``_calibrate_keys`` path and the cross-topology
        ``precalibrate_models`` sweep path so keys always compose the same
        way.  Returns ``(key, store_configs, detail_tag, bg_bytes)``."""
        key_base, coarse_tag, detail_tag, bg_bytes = self._tags()
        degraded_axes = self._degraded_axes()
        degraded_tag = ()
        if degraded_axes:
            degraded_tag = (
                "degraded",
                tuple(sorted(tuple(sorted(l)) for l in self.failed_links)),
            )

        def key(axis: str, shape: str, w: int | None) -> tuple:
            if shape == "reduce_scatter":
                shape = "all_gather"
            if axis == "pod":
                return key_base + coarse_tag + (axis, shape, w)
            if axis == "model" and detail_tag:
                return key_base + coarse_tag + detail_tag + (axis, shape, w)
            if axis in degraded_axes:
                return key_base + degraded_tag + (axis, shape, w)
            return key_base + (axis, shape, w)

        store_configs = {
            "chip": list(key_base),
            "pod": list(key_base + coarse_tag),
            "mixed": list(key_base + coarse_tag + detail_tag),
            "degraded": list(key_base + degraded_tag),
        }
        return key, store_configs, detail_tag, bg_bytes

    def _resolve_disk(self, missing: set, key, store_configs, detail_tag):
        """Serve memo ``missing`` entries from the persistent store
        (mutating ``missing``, the memo and the stats counters); returns
        the disk handle for later write-back (None when disabled)."""
        disk = self._disk_cache() if missing else None
        if disk is not None:
            stored: dict[str, dict] = {}
            for axis, shape, w in list(missing):
                kind = self._store_kind(axis, detail_tag)
                if kind not in stored:
                    stored[kind] = disk.get_profile(store_configs[kind])
                mshape = "all_gather" if shape == "reduce_scatter" else shape
                v = stored[kind].get((axis, mshape, w))
                if v is not None:
                    _CALIBRATION_CACHE[key(axis, shape, w)] = v
                    _CALIBRATION_STATS["disk_hits"] += 1
                    missing.discard((axis, shape, w))
        return disk

    def _to_measure(
        self, missing: set, detail_tag
    ) -> "dict[tuple[str, str, int | None], str]":
        """De-alias and de-duplicate what still needs a netsim run: the
        reduce_scatter/all_gather pair must measure ONCE, not twice.
        Maps each measured triple to its store kind."""
        to_measure: dict[tuple[str, str, int | None], str] = {}
        for axis, shape, w in sorted(missing, key=str):
            mshape = "all_gather" if shape == "reduce_scatter" else shape
            kind = self._store_kind(axis, detail_tag)
            to_measure.setdefault((axis, mshape, w), kind)
        return to_measure

    def _calibrate_keys(
        self, triples: "list[tuple[str, str, int | None]]"
    ) -> "dict[tuple[str, str, int | None], float]":
        """Measured GB/s per ``(axis, shape, width)`` triple.

        Resolution order per key: in-memory memo -> persistent disk store
        (``core/calib_cache.py``) -> netsim measurement.  Chip-level
        misses are measured in batched solver sessions
        (``NetSim.measure_profile_batch``); "pod"-axis entries on the
        rack-coarsened SuperPod mesh and mixed-granularity model entries
        on the embedded-rack mesh, one run each (their cache keys carry
        the coarsening / detail tags so granularities never alias).
        Newly measured values are written back to the disk store."""
        from ..netsim import NetSim  # deferred: core must not hard-require netsim

        key, store_configs, detail_tag, bg_bytes = self._key_context()

        missing = {
            (axis, shape, w)
            for axis, shape, w in triples
            if key(axis, shape, w) not in _CALIBRATION_CACHE
        }
        _CALIBRATION_STATS["hits"] += len(triples) - len(missing)
        _CALIBRATION_STATS["misses"] += len(missing)

        # persistent read-through: serve misses from the on-disk profile
        disk = self._resolve_disk(missing, key, store_configs, detail_tag)
        to_measure = self._to_measure(missing, detail_tag)

        new_by_kind: dict[str, dict] = {}

        def store(axis: str, mshape: str, w: int | None, kind: str,
                  gbs: "float | None") -> None:
            # shapes netsim could not measure fall back to the analytic bw
            val = (
                gbs if gbs is not None
                else self.base.axes[axis].gbs_per_chip
            )
            _CALIBRATION_CACHE[key(axis, mshape, w)] = val
            new_by_kind.setdefault(kind, {})[(axis, mshape, w)] = val

        chip_keys = [k for k, kind in to_measure.items() if kind == "chip"]
        if chip_keys:
            sim = NetSim(
                self.topo,
                routing=self.base.routing,
                latency_s=self.latency_s,
                rx_gbs=self.rx_gbs,
                reuse_wire_template=self.reuse_wire_template,
            )
            t0 = time.perf_counter()
            measured = sim.measure_profile_batch(
                self.size_bytes,
                chip_keys,
                comm=self.base,
                batch_size=max(1, self.batch_size),
                stats=_CALIBRATION_STATS,
            )
            dt = (time.perf_counter() - t0) / len(chip_keys)
            for axis, mshape, w in chip_keys:
                _record_measurement(axis, mshape, w, dt)
                store(axis, mshape, w, "chip", measured[(axis, mshape, w)])
        degraded_keys = [
            k for k, kind in to_measure.items() if kind == "degraded"
        ]
        if degraded_keys:
            # affected axes re-measure on the failed-link mesh; APR reroute
            # happens inside netsim (can_batch_calibration is False there,
            # so measure_profile_batch falls back to sequential runs)
            dsim = NetSim(
                self.topo,
                routing=self.base.routing,
                latency_s=self.latency_s,
                rx_gbs=self.rx_gbs,
                reuse_wire_template=self.reuse_wire_template,
                failed_links=self.failed_links,
            )
            t0 = time.perf_counter()
            dmeasured = dsim.measure_profile_batch(
                self.size_bytes,
                degraded_keys,
                comm=self.base,
                batch_size=max(1, self.batch_size),
                stats=_CALIBRATION_STATS,
            )
            dt = (time.perf_counter() - t0) / len(degraded_keys)
            for axis, mshape, w in degraded_keys:
                _record_measurement(axis, mshape, w, dt)
                store(
                    axis, mshape, w, "degraded", dmeasured[(axis, mshape, w)]
                )
        pod_keys = [k for k, kind in to_measure.items() if kind == "pod"]
        if pod_keys:
            from ..netsim.coarsen import (
                coarse_calibrated_profile,
                coarse_netsim,
                coarsen_superpod,
            )

            cm = coarsen_superpod(self.superpod, level=self.coarsen_level)
            csim = coarse_netsim(
                cm,
                routing=self.base.routing,
                latency_s=self.latency_s,
                rx_gbs=self.rx_gbs,
            )
            for axis, mshape, w in pod_keys:
                _CALIBRATION_STATS["sessions"] += 1
                _CALIBRATION_STATS["session_keys"] += 1
                t0 = time.perf_counter()
                cal = coarse_calibrated_profile(
                    cm,
                    self.size_bytes,
                    comm=self.base,
                    widths={} if w is None else {axis: w},
                    axes=(axis,),
                    shapes=(mshape,),
                    sim=csim,
                )
                _record_measurement(axis, mshape, w, time.perf_counter() - t0)
                store(axis, mshape, w, "pod", cal.gbs.get((axis, mshape)))
        mixed_keys = [k for k, kind in to_measure.items() if kind == "mixed"]
        if mixed_keys:
            from ..netsim.coarsen import (
                coarsen_superpod,
                mixed_calibrated_profile,
                mixed_netsim,
            )

            cm = coarsen_superpod(
                self.superpod,
                level=self.coarsen_level,
                detail_racks=self.detail_racks,
            )
            msim = mixed_netsim(
                cm,
                routing=self.base.routing,
                latency_s=self.latency_s,
                rx_gbs=self.rx_gbs,
            )
            for axis, mshape, w in mixed_keys:
                _CALIBRATION_STATS["sessions"] += 1
                _CALIBRATION_STATS["session_keys"] += 1
                t0 = time.perf_counter()
                cal = mixed_calibrated_profile(
                    cm,
                    self.size_bytes,
                    comm=self.base,
                    widths={} if w is None else {axis: w},
                    axes=(axis,),
                    shapes=(mshape,),
                    background_per_chip_bytes=bg_bytes,
                    sim=msim,
                )
                _record_measurement(axis, mshape, w, time.perf_counter() - t0)
                store(axis, mshape, w, "mixed", cal.gbs.get((axis, mshape)))

        # persistent write-back (best-effort; never raises into planning)
        if new_by_kind and disk is not None:
            for kind, entries in new_by_kind.items():
                disk.update(store_configs[kind], entries)

        return {
            (axis, shape, w): _CALIBRATION_CACHE[key(axis, shape, w)]
            for axis, shape, w in triples
        }

    def _measure_coarse_key(
        self, cm, kind: str, axis: str, mshape: str, w: "int | None"
    ) -> "float | None":
        """One coarse ("pod") or mixed-granularity key measured on mesh
        ``cm`` — a single solver session.  Used by ``precalibrate_models``
        to measure each distinct coarse signature once and fan the value
        out to every candidate that shares it."""
        _CALIBRATION_STATS["sessions"] += 1
        _CALIBRATION_STATS["session_keys"] += 1
        t0 = time.perf_counter()
        if kind == "pod":
            from ..netsim.coarsen import (
                coarse_calibrated_profile,
                coarse_netsim,
            )

            sim = coarse_netsim(
                cm,
                routing=self.base.routing,
                latency_s=self.latency_s,
                rx_gbs=self.rx_gbs,
            )
            cal = coarse_calibrated_profile(
                cm,
                self.size_bytes,
                comm=self.base,
                widths={} if w is None else {axis: w},
                axes=(axis,),
                shapes=(mshape,),
                sim=sim,
            )
        else:
            from ..netsim.coarsen import (
                mixed_calibrated_profile,
                mixed_netsim,
            )

            bg = (
                self.size_bytes if self.background_bytes is None
                else self.background_bytes
            )
            sim = mixed_netsim(
                cm,
                routing=self.base.routing,
                latency_s=self.latency_s,
                rx_gbs=self.rx_gbs,
            )
            cal = mixed_calibrated_profile(
                cm,
                self.size_bytes,
                comm=self.base,
                widths={} if w is None else {axis: w},
                axes=(axis,),
                shapes=(mshape,),
                background_per_chip_bytes=bg,
                sim=sim,
            )
        _record_measurement(axis, mshape, w, time.perf_counter() - t0)
        return cal.gbs.get((axis, mshape))

    def precalibrate(
        self, specs: "list[ParallelSpec] | tuple[ParallelSpec, ...]"
    ) -> dict:
        """Front-load every calibration key a spec set will need.

        Collects the union of ``_widths(p)`` over ``specs`` (one dry pass,
        no netsim work) and resolves all unique ``(axis, shape, width)``
        keys at once — so the chip-level misses land in few batched
        ``NetSim.run_dags`` sessions instead of one session per key, and a
        sweep pays measurement exactly once up front.  ``plan()`` calls
        this automatically for backends that expose it; standalone sweeps
        can call it with ``enumerate_specs(...)`` output directly.

        Returns ``{"keys": unique keys, "measured": netsim-measured,
        "disk_hits": served from the persistent store, "wall_s": ...}``.
        """
        keys: set[tuple[str, str, int | None]] = set()
        for p in specs:
            keys.update(
                (a, s, w) for (a, s), w in self._widths(p).items()
            )
        before = calibration_stats()
        t0 = time.perf_counter()
        if keys:
            self._calibrate_keys(sorted(keys, key=str))
        after = calibration_stats()
        return {
            "keys": len(keys),
            "measured": after["misses"] - before["misses"]
            - (after["disk_hits"] - before["disk_hits"]),
            "disk_hits": after["disk_hits"] - before["disk_hits"],
            "wall_s": time.perf_counter() - t0,
        }

    def _widths(
        self, p: ParallelSpec | None
    ) -> dict[tuple[str, str], int | None]:
        """Calibration group width per measurable (axis, shape) for spec
        ``p``.  ``None`` means the shape's default group (full plane for
        ring collectives, the capped A2A footprint for all_to_all); widths
        that cover it are canonicalized to ``None`` so they share one
        cache entry."""
        widths: dict[tuple[str, str], int | None] = {}
        x = self.topo.shape[0]
        plane = x * (self.topo.shape[1] if self.topo.ndim > 1 else 1)
        if "model" in self.base.axes:
            for shape in self.shapes:
                if shape in ("allreduce", "all_gather", "reduce_scatter"):
                    w = None if p is None else p.tp * p.sp
                    widths[("model", shape)] = (
                        None if w is None or w >= plane else w
                    )
                elif shape == "all_to_all":
                    # EP footprint (compile_traffic_entry convention),
                    # canonicalized against the SAME cap the measurement
                    # group uses; an ep=1 spec has no A2A traffic to price
                    if p is not None and p.ep <= 1:
                        continue
                    cap = min(A2A_CALIBRATION_MAX_NODES, 2 * x, plane)
                    w = None if p is None else min(2 * p.ep, cap)
                    widths[("model", shape)] = (
                        None if w is None or w >= cap else w
                    )
                else:                           # p2p: width-independent
                    widths[("model", shape)] = None
        if "data" in self.base.axes and self.topo.ndim > 2:
            for shape in self.shapes:
                widths[("data", shape)] = None  # full inter-rack plane
        if self.superpod is not None and "pod" in self.base.axes:
            # HRS pod tier, measured on the rack-coarsened mesh; the
            # calibration ring spans the pod-axis group (spec-invariant:
            # the DP-across-pods footprint is the axis itself), capped at
            # the SuperPod's pod count
            w = min(self.base.axes["pod"].size, self.superpod.n_pods)
            for shape in self.shapes:
                if shape in _POD_SHAPES:
                    widths[("pod", shape)] = (
                        None if w >= self.superpod.n_pods else w
                    )
        return widths

    def _latency_widths(
        self, p: ParallelSpec | None
    ) -> dict[tuple[str, str], int | None]:
        """The latency-measurable subset of ``_widths(p)``: decode-regime
        shapes only (``LATENCY_SHAPES``) on the chip-level axes — the HRS
        "pod" tier lives on the coarse mesh, which the message-level
        transport does not model."""
        return {
            (a, s): w
            for (a, s), w in self._widths(p).items()
            if s in LATENCY_SHAPES and a != "pod"
        }

    def _analytic_latency(
        self, axis: str, shape: str, size_bytes: float
    ) -> float:
        """Closed-form alpha-beta time for shapes the topology cannot
        host (fallback; flagged by ``n=0`` in the stats)."""
        return getattr(self.base, shape)(axis, size_bytes)

    def latency_profile(
        self, p: ParallelSpec | None = None, *, size_bytes: float = 64e3
    ) -> LatencyProfile:
        """Measured message-level latency stats per (axis, shape) at a
        decode-sized payload — the latency-mode sibling of
        :meth:`calibration_profile`.

        Each (axis, shape, width) key executes its collective DAG ONCE on
        the message-level transport (``NetSim(message_level=True)``) and
        is memoized in the shared ``_LATENCY_CACHE`` under the bandwidth
        memo's ``key_base`` extended with a ``("latency-mode",
        size_bytes)`` tag — so latency and bandwidth calibrations never
        alias, while specs sharing a TP*SP / EP footprint share
        measurements exactly as they do for GB/s.  Values persist through
        the same ``core.calib_cache`` store (config = key_base + the
        latency tag) with each ``LatencyStats`` field flattened to an
        ``axis|shape@field|width`` entry.

        Widths resolve from ``_widths(p)`` restricted to
        ``LATENCY_SHAPES``, so the measured group is the spec's REAL
        footprint: a tp*sp=64 plane group pays the full 2(w-1)-step ring
        latency while a tp*sp=8 clique group pays ~1/8 of it — the
        spec-dependence the analytic model's pinned axis size hides, and
        the reason SLO-driven decode planning can disagree with
        bandwidth-optimal planning."""
        from ..netsim import NetSim  # deferred: core must not hard-require netsim

        if self.failed_links:
            raise ValueError(
                "latency profiles run on the healthy mesh: message mode "
                "does not model failure injection"
            )
        widths = self._latency_widths(p)
        key_base, _coarse, _detail, _bg = self._tags()
        tag = ("latency-mode", float(size_bytes))

        def lkey(axis: str, shape: str, w: "int | None") -> tuple:
            return key_base + tag + (axis, shape, w)

        triples = [(a, s, w) for (a, s), w in widths.items()]
        missing = {t for t in triples if lkey(*t) not in _LATENCY_CACHE}
        _CALIBRATION_STATS["hits"] += len(triples) - len(missing)
        _CALIBRATION_STATS["misses"] += len(missing)

        # persistent read-through: a key hits only when every stat field
        # is present (partial rows re-measure rather than mixing sources)
        store_config = list(key_base + tag)
        disk = self._disk_cache() if missing else None
        if disk is not None:
            stored = disk.get_profile(store_config)
            for axis, shape, w in list(missing):
                vals = {
                    f: stored.get((axis, f"{shape}@{f}", w))
                    for f in _LATENCY_STAT_FIELDS
                }
                if all(v is not None for v in vals.values()):
                    _LATENCY_CACHE[lkey(axis, shape, w)] = LatencyStats(
                        p50_s=vals["p50_s"],
                        p99_s=vals["p99_s"],
                        mean_s=vals["mean_s"],
                        total_s=vals["total_s"],
                        n=int(vals["n"]),
                    )
                    _CALIBRATION_STATS["disk_hits"] += 1
                    missing.discard((axis, shape, w))

        if missing:
            sim = NetSim(
                self.topo,
                routing=self.base.routing,
                latency_s=self.latency_s,
                rx_gbs=self.rx_gbs,
                reuse_wire_template=self.reuse_wire_template,
                message_level=True,
            )
            new_entries: dict = {}
            for axis, shape, w in sorted(missing, key=str):
                _CALIBRATION_STATS["sessions"] += 1
                _CALIBRATION_STATS["session_keys"] += 1
                t0 = time.perf_counter()
                prof = sim.measure_latency_profile(
                    size_bytes,
                    widths={(axis, shape): w},
                    axes=(axis,),
                    shapes=(shape,),
                )
                _record_measurement(
                    axis, f"{shape}@lat", w, time.perf_counter() - t0
                )
                st = prof.get(axis, shape)
                if st is None:
                    t_an = self._analytic_latency(axis, shape, size_bytes)
                    st = LatencyStats(
                        p50_s=t_an, p99_s=t_an, mean_s=t_an,
                        total_s=t_an, n=0,
                    )
                _LATENCY_CACHE[lkey(axis, shape, w)] = st
                for f in _LATENCY_STAT_FIELDS:
                    new_entries[(axis, f"{shape}@{f}", w)] = float(
                        getattr(st, f)
                    )
            # persistent write-back (best-effort; never raises into
            # planning)
            if disk is not None and new_entries:
                disk.update(store_config, new_entries)

        return LatencyProfile(
            lat={
                (a, s): _LATENCY_CACHE[lkey(a, s, w)]
                for (a, s), w in widths.items()
            },
            size_bytes=float(size_bytes),
        )

    def calibration_profile(
        self, p: ParallelSpec | None = None
    ) -> CalibrationProfile:
        """The measured (axis, shape) profile resolved for spec ``p``
        (memoized; unclamped — ``comm_model`` clamps at the analytic
        bound when pricing)."""
        return CalibrationProfile(gbs=dict(self._calibrate(self._widths(p))))

    def comm_model(self, p: ParallelSpec | None = None) -> CommModel:
        comm = self.calibration_profile(p).apply(self.base, clamp=True)
        axes = dict(comm.axes)
        for name, a in self.pinned.items():
            axes[name] = a
        return CommModel(axes=axes, routing=self.base.routing)

    def override_axis(self, name: str, cost: AxisCost) -> "NetsimPerfModel":
        return replace(self, pinned={**self.pinned, name: cost})


# ---------------------------------------------------------------------------
# Cross-topology batched precalibration (geometry sweeps)
# ---------------------------------------------------------------------------


def _coarse_measure_sig(
    m: NetsimPerfModel, kind: str, cm, store_configs: dict
) -> tuple:
    """Everything that determines a coarse-mesh measurement's outcome
    besides the (axis, shape, width) triple — the cross-candidate dedup
    key of ``precalibrate_models``.

    The "pod" signature is *structural*: the coarse mesh derives from the
    pod's inter-rack dims and the uplink only, so candidates that differ
    in intra-rack lanes (different chip topologies, different memo keys)
    still share one coarse measurement.  Mixed-granularity entries stay
    conservative: their exact store config (which pins the embedded chip
    topology too) is the signature."""
    if kind == "mixed":
        return ("mixed",) + tuple(store_configs["mixed"])
    sizes = tuple(sorted((k, a.size) for k, a in m.base.axes.items()))
    return (
        "pod",
        cm.topo.dims,
        tuple(sorted((cm.dim_io_gbs or {}).items())),
        cm.chips_per_node,
        tuple(sorted((k, tuple(v)) for k, v in cm.axis_dims.items())),
        m.base.routing.value,
        float(m.size_bytes),
        m.latency_s,
        m.rx_gbs,
        sizes,
    )


def precalibrate_models(
    models: "list[NetsimPerfModel] | tuple[NetsimPerfModel, ...]",
    specs_by_model: "list | None" = None,
    *,
    batch_size: int = 8,
) -> dict:
    """Front-load calibration for MANY candidate topologies at once — the
    cross-topology extension of :meth:`NetsimPerfModel.precalibrate` that
    makes a geometry sweep pay roughly one candidate's measurement bill.

    ``specs_by_model`` optionally aligns one spec list per model (the
    widths each candidate's planner run will request); ``None`` entries
    calibrate the spec-independent default widths.

    Three sharings stack on top of the per-model memo/disk resolution:

    * chip-level misses from all candidates go through ONE
      ``netsim.api.measure_cross_topology`` call — identical measurements
      (same used-dim specs, same DAG structure) dedup across candidates,
      and distinct ones share host-mesh solver sessions;
    * coarse "pod"-axis misses dedup by structural signature
      (:func:`_coarse_measure_sig`) — candidates differing only in
      intra-rack provisioning share one coarse-mesh run;
    * every resolved value lands in each candidate's own memo key and
      persistent store, so subsequent ``plan()`` calls are measurement-free.

    Returns ``{"models", "keys", "measured", "unique_measured",
    "deduped", "disk_hits", "sessions", "session_keys", "wall_s"}``.
    """
    from ..netsim import NetSim  # deferred: core must not hard-require netsim
    from ..netsim.api import measure_cross_topology

    t0 = time.perf_counter()
    before = calibration_stats()
    models = list(models)
    specs_list = (
        list(specs_by_model) if specs_by_model is not None
        else [None] * len(models)
    )
    if len(specs_list) != len(models):
        raise ValueError("specs_by_model must align with models")

    ctx: list[dict] = []
    chip_jobs: list = []
    chip_job_model: list[int] = []
    coarse_groups: dict = {}
    coarse_meshes: dict = {}
    total_keys = 0

    for i, m in enumerate(models):
        specs = specs_list[i]
        keys: set = set()
        for p in (specs if specs else [None]):
            keys.update((a, s, w) for (a, s), w in m._widths(p).items())
        total_keys += len(keys)
        if m.failed_links:
            # degraded models cannot share relocated solver sessions (the
            # failure breaks translation symmetry) — resolve them through
            # the per-model sequential path and keep ctx aligned
            if keys:
                m._calibrate_keys(sorted(keys, key=str))
            ctx.append({
                "key": None,
                "store_configs": None,
                "disk": None,
                "new_by_kind": {},
            })
            continue
        key, store_configs, detail_tag, _bg = m._key_context()
        missing = {k for k in keys if key(*k) not in _CALIBRATION_CACHE}
        _CALIBRATION_STATS["hits"] += len(keys) - len(missing)
        _CALIBRATION_STATS["misses"] += len(missing)
        disk = m._resolve_disk(missing, key, store_configs, detail_tag)
        to_measure = m._to_measure(missing, detail_tag)
        ctx.append({
            "key": key,
            "store_configs": store_configs,
            "disk": disk,
            "new_by_kind": {},
        })
        chip_keys = sorted(
            (k for k, kind in to_measure.items() if kind == "chip"), key=str
        )
        if chip_keys:
            sim = NetSim(
                m.topo,
                routing=m.base.routing,
                latency_s=m.latency_s,
                rx_gbs=m.rx_gbs,
                reuse_wire_template=m.reuse_wire_template,
            )
            sizes = {k: a.size for k, a in m.base.axes.items()}
            chip_jobs.append((sim, m.size_bytes, chip_keys, sizes))
            chip_job_model.append(i)
        for triple, kind in to_measure.items():
            if kind == "chip":
                continue
            cm = coarse_meshes.get((i, kind))
            if cm is None:
                from ..netsim.coarsen import coarsen_superpod

                cm = coarsen_superpod(
                    m.superpod,
                    level=m.coarsen_level,
                    detail_racks=(
                        m.detail_racks if kind == "mixed" else ()
                    ),
                )
                coarse_meshes[(i, kind)] = cm
            sig = _coarse_measure_sig(m, kind, cm, store_configs) + triple
            coarse_groups.setdefault(sig, []).append((i, kind, triple))

    # chip-level: one cross-topology batched measurement over all models
    if chip_jobs:
        t0c = time.perf_counter()
        measured = measure_cross_topology(
            chip_jobs, batch_size=batch_size, stats=_CALIBRATION_STATS
        )
        dtc = time.perf_counter() - t0c
        n_chip = sum(len(j[2]) for j in chip_jobs) or 1
        for i, job, out in zip(chip_job_model, chip_jobs, measured):
            m, c = models[i], ctx[i]
            for triple in job[2]:
                axis, mshape, w = triple
                _record_measurement(axis, mshape, w, dtc / n_chip)
                gbs = out[triple]
                val = (
                    gbs if gbs is not None
                    else m.base.axes[axis].gbs_per_chip
                )
                _CALIBRATION_CACHE[c["key"](axis, mshape, w)] = val
                c["new_by_kind"].setdefault("chip", {})[triple] = val

    # coarse/mixed: measured once per distinct signature, fanned out
    for sig, refs in coarse_groups.items():
        i0, kind0, (axis, mshape, w) = refs[0]
        gbs = models[i0]._measure_coarse_key(
            coarse_meshes[(i0, kind0)], kind0, axis, mshape, w
        )
        for i, kind, triple in refs:
            m, c = models[i], ctx[i]
            val = gbs if gbs is not None else m.base.axes[axis].gbs_per_chip
            _CALIBRATION_CACHE[c["key"](*triple)] = val
            c["new_by_kind"].setdefault(kind, {})[triple] = val

    # persistent write-back, per candidate per store kind (best-effort)
    for c in ctx:
        if c["new_by_kind"] and c["disk"] is not None:
            for kind, entries in c["new_by_kind"].items():
                c["disk"].update(c["store_configs"][kind], entries)

    after = calibration_stats()
    measured_reqs = (after["misses"] - before["misses"]) - (
        after["disk_hits"] - before["disk_hits"]
    )
    unique = after["session_keys"] - before["session_keys"]
    return {
        "models": len(models),
        "keys": total_keys,
        "measured": measured_reqs,
        "unique_measured": unique,
        "deduped": max(0, measured_reqs - unique),
        "disk_hits": after["disk_hits"] - before["disk_hits"],
        "sessions": after["sessions"] - before["sessions"],
        "session_keys": unique,
        "wall_s": time.perf_counter() - t0,
    }
