"""The port's own copy of ``repro/runtime/campaign.py``, held to the original by
``tests/test_torch_netsim_parity.py`` and against it by
``tests/test_torch_campaign_parity.py``; only its
imports of the package, and the package's name where its docstring
gives it, differ.

Seeded Monte-Carlo availability campaign over a SuperPod (paper
§3.3.2, §6.6, Table 6).

The closed-form layer (`core/availability.py`) turns AFR sums into
``MTBF/(MTBF+MTTR)``; this module *replays* the failures.  Per seed it

1. samples failure events per class (link / trunk / LRS / HRS / NPU)
   from the exponential inter-arrival times implied by the AFR
   breakdown, over a simulated multi-week horizon;
2. reprices the training step on the degraded mesh for every network
   event class through netsim APR reroute
   (``NetsimPerfModel(failed_links=...)`` — the measured DAGs route
   around the dead links), *incrementally*: only the axes a failure
   can touch get degraded cache keys, one measurement per class per
   process, everything else is a memo/`calib_cache` hit;
3. drives a recovery policy engine per event: 64+1 backup-swap
   (`RackFailover`, 13-min fast MTTR, state recovered from DP peers),
   checkpoint-restore with lost-work accounting (75-min full MTTR plus
   work since the last checkpoint at the `checkpoint/manager.py` step
   cadence), or elastic DP shrink (`ElasticPlan`) when the rack's
   spare pool is exhausted (`SparesExhausted`);
4. integrates the goodput timeline (stalls at rate 0, degraded windows
   at the repriced step-time ratio, shrunken windows at the elastic
   capacity fraction, minus recomputed work) and the Table-6-style
   *network availability* (union of network-class repair windows).

Everything on the replay path is deterministic per seed: one
``numpy.random.default_rng(seed)`` drives sampling, no wall clock is
read anywhere.

The UB-Mesh vs Clos head-to-head (`head_to_head`) reproduces the
paper's ordering (≈7.2 pp network availability gap at the 75-min MTTR)
and the ≥95% linearity-under-failures claim
(`linearity_under_failures`).  `availability_score` is the cheap
sampling-only variant (no netsim, no goodput) that gives every
`GeometryCandidate` the third Pareto dominance axis carried by
`core/codesign.DesignPoint.unavailability`.

Modeling notes (deliberate, conservative toward UB-Mesh):

* Clos network failures are charged the same repair windows in the
  availability metric but produce no goodput degradation (a
  non-blocking fabric reroutes at full bisection) — Clos only pays
  goodput for NPU failures, where its lack of an in-rack 64+1 spare
  forces a full checkpoint-restore per failure.
* Backup-swap does not roll back: §6.6's fast path migrates state
  from DP-replica peers onto the pre-heated spare, so it costs the
  13-min stall only.
* The per-NPU AFR default (0.12/yr) is the fleet-level board+HBM rate;
  `core.availability.BackupAnalysis` keeps its conservative 0.25 for
  the rack-capacity-loss analysis.
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field, replace

import numpy as np

from repro_torch.core.availability import (
    AFR_PER_UNIT,
    AFRBreakdown,
    FAST_MTTR_HOURS,
    HOURS_PER_YEAR,
    PAPER_CLOS,
    PAPER_MTTR_HOURS,
    PAPER_UB_MESH,
    superpod_afr,
)
from repro_torch.core.codesign import GeometryCandidate
from repro_torch.core.topology import NDFullMesh
from repro_torch.core.traffic import WorkloadSpec
from repro_torch.runtime.elastic import shrink_plan
from repro_torch.runtime.fault_tolerance import RackFailover, SparesExhausted

HOURS_PER_WEEK = 7 * 24

# network event classes of the UB-Mesh profile, in AFRBreakdown terms:
# x/y = passive intra-rack cables, z = active-electrical trunks,
# a = optical trunks, lrs/hrs = switches.  "npu" rides separately.
MESH_CLASSES = ("x_link", "y_link", "z_trunk", "a_trunk", "lrs", "hrs")
CLOS_CLASSES = ("clos_electrical", "clos_optical", "clos_lrs", "clos_hrs")


# ---------------------------------------------------------------------------
# canonical degraded-link sets per event class
# ---------------------------------------------------------------------------


def canonical_failed_links(
    topo: NDFullMesh, cls: str
) -> tuple[tuple[int, int], ...]:
    """The representative failed-link set one event of ``cls`` induces.

    By symmetry every single failure of a class is equivalent up to
    relabeling, so the campaign prices ONE canonical instance per class
    and reuses the measurement for all events of that class — this is
    what makes repricing memoizable.  Classes a geometry cannot survive
    (a trunk failure in a 2-deep dimension leaves no detour clique
    member) return ``()`` and are charged availability but no measured
    degradation.

    * ``x_link`` / ``y_link`` — one intra-rack cable at the base corner;
    * ``z_trunk`` / ``a_trunk`` — the full pair-link bundle between the
      first two racks of that dimension (the chips detour through the
      remaining clique members — APR's same-clique relay);
    * ``lrs`` — 1/18 of rack 0's backplane: a staggered subset of its
      trunk pair-links, at most one inter-rack link per chip per dim so
      every flow retains a detour.
    """
    shape = topo.shape
    ndim = len(shape)
    base = [0] * ndim

    def link(dim: int, cu: list[int], hi: int) -> tuple[int, int]:
        cv = list(cu)
        cv[dim] = hi
        return topo.node_id(tuple(cu)), topo.node_id(tuple(cv))

    if cls == "x_link":
        return (link(0, base, 1),) if shape[0] > 1 else ()
    if cls == "y_link":
        return (link(1, base, 1),) if ndim > 1 and shape[1] > 1 else ()
    if cls in ("z_trunk", "a_trunk"):
        dim = 2 if cls == "z_trunk" else 3
        if ndim <= dim or shape[dim] < 3:
            return ()                   # no detour clique member survives
        out = []
        for x in range(shape[0]):
            for y in range(shape[1] if ndim > 1 else 1):
                cu = list(base)
                cu[0], cu[1] = x, y
                out.append(link(dim, cu, 1))
        return tuple(out)
    if cls == "lrs":
        # one of the rack's 18 LRS: ~1/18 of its trunk pair-links, spread
        # so no chip loses more than one link per clique
        out = []
        peers = [
            (dim, hi)
            for dim in range(2, ndim)
            if shape[dim] >= 3
            for hi in range(1, shape[dim])
        ]
        n_rack = shape[0] * (shape[1] if ndim > 1 else 1)
        per_peer = max(1, round(n_rack * len(peers) / 18 / max(1, len(peers))))
        for k, (dim, hi) in enumerate(peers):
            y = k % (shape[1] if ndim > 1 else 1)
            for x in range(min(per_peer, shape[0])):
                cu = list(base)
                cu[0], cu[1] = x, y
                out.append(link(dim, cu, hi))
        return tuple(out)
    return ()                           # hrs (analytic) and npu (no links)


# ---------------------------------------------------------------------------
# failure-class rates from an AFR breakdown
# ---------------------------------------------------------------------------


def failure_class_rates(
    afr: AFRBreakdown, cand: GeometryCandidate, chips: int
) -> dict[str, float]:
    """Whole-system failures/year per mesh event class.

    The breakdown's ``electrical_cable`` pools passive intra-rack (x, y)
    and active trunk (z) cables; it is apportioned by the geometry's
    unit-weighted cable counts (the same per-unit AFRs `derived_afr`
    calibrates against Table 6)."""
    cb = cand.superpod(chips).cables_by_link_type()
    w_passive = (
        cb.get("passive_electrical", 0) * AFR_PER_UNIT["passive_electrical"]
    )
    w_active = (
        cb.get("active_electrical", 0) * AFR_PER_UNIT["active_electrical"]
    )
    tot = w_passive + w_active
    f_passive = w_passive / tot if tot > 0 else 1.0
    return {
        "x_link": afr.electrical_cable * f_passive / 2,
        "y_link": afr.electrical_cable * f_passive / 2,
        "z_trunk": afr.electrical_cable * (1.0 - f_passive),
        "a_trunk": afr.optical_cable,
        "lrs": afr.lrs,
        "hrs": afr.hrs,
    }


def clos_class_rates(afr: AFRBreakdown) -> dict[str, float]:
    return {
        "clos_electrical": afr.electrical_cable,
        "clos_optical": afr.optical_cable,
        "clos_lrs": afr.lrs,
        "clos_hrs": afr.hrs,
    }


def scale_afr(afr: AFRBreakdown, factor: float) -> AFRBreakdown:
    """Component-proportional rescaling (e.g. Table 6's 8K profile down
    to a smaller fleet)."""
    return AFRBreakdown(
        afr.name,
        electrical_cable=afr.electrical_cable * factor,
        optical_cable=afr.optical_cable * factor,
        lrs=afr.lrs * factor,
        hrs=afr.hrs * factor,
    )


# ---------------------------------------------------------------------------
# campaign configuration / event model
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FailureEvent:
    t_hours: float
    cls: str
    rack: int = -1                      # NPU events only


@dataclass(frozen=True)
class CampaignConfig:
    """One architecture's campaign setup.  ``profile=None`` scales the
    paper's Table 6 breakdown to ``chips``; pass `superpod_afr(...)`
    output for component-count-derived rates instead."""

    candidate: GeometryCandidate = field(default_factory=GeometryCandidate)
    chips: int = 8192
    workload: WorkloadSpec | None = None
    horizon_weeks: float = 4.0
    seeds: tuple[int, ...] = tuple(range(8))
    profile: AFRBreakdown | None = None
    arch: str = "ub-mesh"               # "ub-mesh" | "clos"
    npu_afr_per_year: float = 0.12      # per NPU (board+HBM fleet rate)
    n_backups: int = 1                  # per rack; Clos forces 0
    repair_hours: float = 24.0          # field service restocks the spare
    checkpoint_interval_hours: float = 0.5
    mttr_full_hours: float = PAPER_MTTR_HOURS
    mttr_fast_hours: float = FAST_MTTR_HOURS
    netsim_reprice: bool = True         # False: availability-only math
    size_bytes: float = 16e6            # calibration payload

    @property
    def horizon_hours(self) -> float:
        return self.horizon_weeks * HOURS_PER_WEEK

    @property
    def n_racks(self) -> int:
        return max(1, self.chips // self.candidate.rack_size)

    def afr(self) -> AFRBreakdown:
        if self.profile is not None:
            return self.profile
        paper = PAPER_CLOS if self.arch == "clos" else PAPER_UB_MESH
        return scale_afr(paper, self.chips / 8192)

    def class_rates(self) -> dict[str, float]:
        if self.arch == "clos":
            return clos_class_rates(self.afr())
        return failure_class_rates(self.afr(), self.candidate, self.chips)


def sample_events(
    rates: dict[str, float],
    horizon_hours: float,
    rng: np.random.Generator,
    *,
    npu_rate_per_year: float = 0.0,
    n_racks: int = 1,
) -> list[FailureEvent]:
    """Poisson arrivals per class (exponential inter-arrival times), in
    deterministic class order so one seeded generator reproduces the
    exact event list."""
    events: list[FailureEvent] = []
    all_rates = dict(sorted(rates.items()))
    if npu_rate_per_year > 0:
        all_rates["npu"] = npu_rate_per_year
    for cls, per_year in all_rates.items():
        per_hour = per_year / HOURS_PER_YEAR
        if per_hour <= 0:
            continue
        t = 0.0
        while True:
            t += float(rng.exponential(1.0 / per_hour))
            if t >= horizon_hours:
                break
            rack = int(rng.integers(n_racks)) if cls == "npu" else -1
            events.append(FailureEvent(t, cls, rack))
    events.sort(key=lambda e: (e.t_hours, e.cls, e.rack))
    return events


# ---------------------------------------------------------------------------
# degraded-step repricing (netsim APR reroute, memoized per class)
# ---------------------------------------------------------------------------


class DegradedRepricer:
    """Step-time delta per failure class on the degraded mesh.

    The first query of a class builds the canonical failed-link set,
    reprices the step through a ``NetsimPerfModel(failed_links=...)``
    (only the affected axes re-measure — see
    ``NetsimPerfModel._degraded_axes``) and memoizes the delta; every
    later event of the class is a dict lookup.  ``hrs`` degrades the
    coarse pod axis analytically by (h-1)/h — chip-level netsim cannot
    see the Clos tier, and the paper's HRS count makes one switch a
    small capacity fraction."""

    def __init__(
        self,
        perf,
        w: WorkloadSpec,
        spec,
        *,
        rack_size: int,
        hrs_count: int = 0,
        reprice: bool = True,
    ):
        from repro_torch.core.simulator import simulate

        self._simulate = simulate
        self.perf = perf
        self.w = w
        self.spec = spec
        self.rack_size = rack_size
        self.hrs_count = hrs_count
        self.reprice = reprice
        self.healthy_s = simulate(
            w, spec, perf, rack_size=rack_size
        ).iteration_s
        self._memo: dict[str, float] = {}

    def delta_s(self, cls: str) -> float:
        """Extra seconds per training step while one ``cls`` failure is
        unrepaired (>= 0; 0 for classes with no measurable path)."""
        if cls in self._memo:
            return self._memo[cls]
        d = 0.0
        if self.reprice:
            if cls == "hrs":
                axes = self.perf.comm_model(self.spec).axes
                if "pod" in axes and self.hrs_count > 1:
                    a = axes["pod"]
                    scaled = replace(
                        a,
                        gbs_per_chip=a.gbs_per_chip
                        * (self.hrs_count - 1)
                        / self.hrs_count,
                    )
                    degraded = self.perf.override_axis("pod", scaled)
                    d = (
                        self._simulate(
                            self.w, self.spec, degraded,
                            rack_size=self.rack_size,
                        ).iteration_s
                        - self.healthy_s
                    )
            elif cls in MESH_CLASSES:
                links = canonical_failed_links(self.perf.topo, cls)
                if links:
                    degraded = replace(self.perf, failed_links=links)
                    d = (
                        self._simulate(
                            self.w, self.spec, degraded,
                            rack_size=self.rack_size,
                        ).iteration_s
                        - self.healthy_s
                    )
        d = max(0.0, d)
        self._memo[cls] = d
        return d


# ---------------------------------------------------------------------------
# per-seed replay: policy engine + goodput integration
# ---------------------------------------------------------------------------


@dataclass
class SeedResult:
    seed: int
    availability: float                 # network: 1 - union(repair)/H
    job_availability: float             # 1 - union(stalls)/H
    goodput: float                      # productive fraction of the horizon
    n_events: int
    events_by_class: dict[str, int]
    policies: dict[str, int]            # backup/restore/shrink/wait counts
    stall_hours: float
    degraded_hours: float
    lost_work_hours: float
    timeline: list[dict] = field(default_factory=list)


def _union_hours(windows: list[tuple[float, float]], horizon: float) -> float:
    """Total covered hours of the interval union, clipped to [0, H]."""
    clipped = sorted(
        (max(0.0, a), min(horizon, b)) for a, b in windows if b > 0
    )
    total, cur_a, cur_b = 0.0, None, None
    for a, b in clipped:
        if b <= a:
            continue
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def replay_seed(
    cfg: CampaignConfig,
    seed: int,
    repricer: DegradedRepricer | None,
) -> SeedResult:
    """Replay one seeded event trace through the recovery policy engine."""
    H = cfg.horizon_hours
    rng = np.random.default_rng(seed)
    events = sample_events(
        cfg.class_rates(),
        H,
        rng,
        npu_rate_per_year=cfg.npu_afr_per_year * cfg.chips,
        n_racks=cfg.n_racks,
    )

    healthy_s = repricer.healthy_s if repricer is not None else 1.0
    rack_mesh = None
    failovers: dict[int, RackFailover] = {}
    rack_fail_count: dict[int, int] = {}
    restocks: list[tuple[float, int, int]] = []   # (t, rack, physical)

    net_windows: list[tuple[float, float]] = []    # availability metric
    degrade: list[tuple[float, float, float]] = []  # (t0, t1, delta_s)
    stalls: list[tuple[float, float]] = []
    cap_windows: list[tuple[float, float, float]] = []  # (t0, t1, fraction)
    lost_work_h = 0.0
    policies = {"backup": 0, "restore": 0, "shrink": 0, "wait": 0}
    by_class: dict[str, int] = {}
    timeline: list[dict] = []
    n_backups = 0 if cfg.arch == "clos" else cfg.n_backups

    def rack_failover(r: int) -> RackFailover:
        nonlocal rack_mesh
        fo = failovers.get(r)
        if fo is None:
            if rack_mesh is None:
                pod = cfg.candidate.pod()
                rack_mesh = NDFullMesh(dims=pod.dims[:2])
            fo = failovers[r] = RackFailover(
                rack=rack_mesh, n_backups=n_backups
            )
        return fo

    def lost_work(t: float) -> float:
        return t - math.floor(t / cfg.checkpoint_interval_hours) * (
            cfg.checkpoint_interval_hours
        )

    for e in events:
        t = e.t_hours
        by_class[e.cls] = by_class.get(e.cls, 0) + 1
        if e.cls != "npu":
            # network failure: repair window counts against availability;
            # training continues on the rerouted mesh at the repriced rate
            net_windows.append((t, t + cfg.mttr_full_hours))
            delta = repricer.delta_s(e.cls) if repricer is not None else 0.0
            if delta > 0:
                degrade.append((t, t + cfg.mttr_full_hours, delta))
            timeline.append(
                {"t": t, "kind": e.cls, "action": "reroute",
                 "mttr_h": cfg.mttr_full_hours,
                 "step_delta_s": delta}
            )
            continue

        # NPU failure: pop due restocks, then ask the rack's policy
        while restocks and restocks[0][0] <= t:
            _, r, phys = heapq.heappop(restocks)
            rack_failover(r).restock(phys)
        fo = rack_failover(e.rack)
        k = rack_fail_count.get(e.rack, 0)
        rack_fail_count[e.rack] = k + 1
        rec = fo.fail(k % cfg.candidate.rack_size)
        if not isinstance(rec, SparesExhausted):
            # 64+1 fast swap: 13-min stall, no rollback (§6.6 migrates
            # state from DP-replica peers onto the pre-heated spare)
            stalls.append((t, t + cfg.mttr_fast_hours))
            heapq.heappush(
                restocks, (t + cfg.repair_hours, e.rack, rec["failed_physical"])
            )
            policies["backup"] += 1
            timeline.append(
                {"t": t, "kind": "npu", "rack": e.rack, "action": "backup_swap",
                 "stall_h": cfg.mttr_fast_hours}
            )
            continue
        heapq.heappush(
            restocks, (t + cfg.repair_hours, e.rack, rec["failed_physical"])
        )
        if cfg.arch == "clos":
            # any-to-any fabric: restart on a hall spare from checkpoint
            lw = lost_work(t)
            lost_work_h += lw
            stalls.append((t, t + cfg.mttr_full_hours))
            policies["restore"] += 1
            timeline.append(
                {"t": t, "kind": "npu", "rack": e.rack,
                 "action": "checkpoint_restore",
                 "stall_h": cfg.mttr_full_hours, "lost_work_h": lw}
            )
            continue
        # UB-Mesh spare pool empty: wait for the earliest restock of this
        # rack, or shrink DP around the dead rack slice — pick the policy
        # with the lower expected goodput loss
        next_restock = min(
            (rt for rt, r, _p in restocks if r == e.rack), default=t
        )
        plan = shrink_plan(
            old_dp=max(2, getattr(repricer.spec, "dp", 2))
            if repricer is not None else 2,
            old_global_batch=cfg.workload.global_batch
            if cfg.workload is not None else 512,
            lost_chips=cfg.candidate.rack_size,
            total_chips=cfg.chips,
        )
        lw = lost_work(t)
        loss_wait = (next_restock - t) + cfg.mttr_fast_hours
        loss_shrink = (
            2 * cfg.mttr_full_hours      # shrink restore + later re-expand
            + lw
            + (1.0 - plan.capacity_fraction) * (next_restock - t)
        )
        if loss_wait <= loss_shrink:
            stalls.append((t, next_restock + cfg.mttr_fast_hours))
            policies["wait"] += 1
            timeline.append(
                {"t": t, "kind": "npu", "rack": e.rack,
                 "action": "wait_for_spare",
                 "stall_h": (next_restock - t) + cfg.mttr_fast_hours}
            )
        else:
            lost_work_h += lw
            stalls.append((t, t + cfg.mttr_full_hours))
            cap_windows.append(
                (t + cfg.mttr_full_hours, next_restock, plan.capacity_fraction)
            )
            stalls.append((next_restock, next_restock + cfg.mttr_full_hours))
            policies["shrink"] += 1
            timeline.append(
                {"t": t, "kind": "npu", "rack": e.rack,
                 "action": "elastic_shrink",
                 "new_dp": plan.new_dp, "old_dp": plan.old_dp,
                 "capacity_fraction": plan.capacity_fraction,
                 "lost_work_h": lw}
            )

    # ---- integrate the goodput timeline ---------------------------------
    edges = {0.0, H}
    for a, b in stalls:
        edges |= {a, b}
    for a, b, _d in degrade:
        edges |= {a, b}
    for a, b, _f in cap_windows:
        edges |= {a, b}
    cut = sorted(x for x in edges if 0.0 <= x <= H)
    progress_h = 0.0
    for a, b in zip(cut, cut[1:]):
        if b <= a:
            continue
        mid = (a + b) / 2
        if any(sa <= mid < sb for sa, sb in stalls):
            continue
        delta = sum(d for (da, db, d) in degrade if da <= mid < db)
        rate = healthy_s / (healthy_s + delta) if healthy_s > 0 else 1.0
        for ca, cb_, f in cap_windows:
            if ca <= mid < cb_:
                rate *= f
        progress_h += (b - a) * rate
    progress_h = max(0.0, progress_h - lost_work_h)

    stall_h = _union_hours(stalls, H)
    return SeedResult(
        seed=seed,
        availability=1.0 - _union_hours(net_windows, H) / H,
        job_availability=1.0 - stall_h / H,
        goodput=progress_h / H,
        n_events=len(events),
        events_by_class=by_class,
        policies=policies,
        stall_hours=stall_h,
        degraded_hours=_union_hours([(a, b) for a, b, _ in degrade], H),
        lost_work_hours=lost_work_h,
        timeline=timeline,
    )


# ---------------------------------------------------------------------------
# campaign driver + aggregation
# ---------------------------------------------------------------------------


@dataclass
class CampaignResult:
    config: CampaignConfig
    runs: list[SeedResult]
    healthy_step_s: float
    deltas_by_class: dict[str, float]

    @property
    def availability(self) -> float:
        return float(np.mean([r.availability for r in self.runs]))

    @property
    def job_availability(self) -> float:
        return float(np.mean([r.job_availability for r in self.runs]))

    @property
    def goodput(self) -> float:
        return float(np.mean([r.goodput for r in self.runs]))

    def summary(self) -> dict:
        pol: dict[str, int] = {}
        for r in self.runs:
            for k, v in r.policies.items():
                pol[k] = pol.get(k, 0) + v
        return {
            "arch": self.config.arch,
            "chips": self.config.chips,
            "seeds": len(self.runs),
            "horizon_weeks": self.config.horizon_weeks,
            "availability": round(self.availability, 6),
            "job_availability": round(self.job_availability, 6),
            "goodput": round(self.goodput, 6),
            "events": sum(r.n_events for r in self.runs),
            "policies": pol,
            "healthy_step_s": round(self.healthy_step_s, 6),
            "step_delta_s_by_class": {
                k: round(v, 6) for k, v in sorted(self.deltas_by_class.items())
            },
            "lost_work_hours": round(
                sum(r.lost_work_hours for r in self.runs), 3
            ),
        }


def _default_workload() -> WorkloadSpec:
    from repro_torch.core.traffic import backend_comparison_workloads

    return backend_comparison_workloads()[0]      # dense-70B


def run_campaign(cfg: CampaignConfig) -> CampaignResult:
    """All seeds of one architecture's campaign."""
    from repro_torch.core.planner import best_parallel_spec

    w = cfg.workload or _default_workload()
    cfg = replace(cfg, workload=w)
    repricer = None
    healthy_s = 1.0
    if cfg.netsim_reprice and cfg.arch != "clos":
        perf = cfg.candidate.perf_model(cfg.chips, size_bytes=cfg.size_bytes)
        spec = best_parallel_spec(
            w, cfg.chips, perf, rack_size=cfg.candidate.rack_size
        )
        repricer = DegradedRepricer(
            perf,
            w,
            spec,
            rack_size=cfg.candidate.rack_size,
            hrs_count=cfg.candidate.superpod(cfg.chips).hrs_count(),
        )
        healthy_s = repricer.healthy_s
    elif cfg.arch == "clos":
        # Clos prices its healthy step analytically for the stall math;
        # degradation windows are zero by the non-blocking assumption
        pass
    runs = [replay_seed(cfg, s, repricer) for s in cfg.seeds]
    deltas = dict(repricer._memo) if repricer is not None else {}
    return CampaignResult(
        config=cfg,
        runs=runs,
        healthy_step_s=healthy_s if repricer is not None else float("nan"),
        deltas_by_class=deltas,
    )


def head_to_head(
    chips: int = 8192,
    *,
    candidate: GeometryCandidate | None = None,
    seeds: tuple[int, ...] = tuple(range(8)),
    horizon_weeks: float = 4.0,
    workload: WorkloadSpec | None = None,
    netsim_reprice: bool = True,
    size_bytes: float = 16e6,
) -> dict:
    """UB-Mesh vs Clos under the same seeds: the Table 6 reproduction.

    Both architectures are charged the identical 75-min repair MTTR; the
    ordering comes from the AFR gap (Table 6: 88.9 vs 632.8 failures/yr
    at 8K NPUs — optical modules dominate Clos).  Expected availability
    gap ≈ 7.2 pp, paper §6.6."""
    cand = candidate or GeometryCandidate()
    ub_cfg = CampaignConfig(
        candidate=cand, chips=chips, workload=workload, seeds=seeds,
        horizon_weeks=horizon_weeks, arch="ub-mesh",
        netsim_reprice=netsim_reprice, size_bytes=size_bytes,
    )
    clos_cfg = replace(ub_cfg, arch="clos", netsim_reprice=False)
    ub = run_campaign(ub_cfg)
    clos = run_campaign(clos_cfg)
    return {
        "ub": ub,
        "clos": clos,
        "availability_gap": ub.availability - clos.availability,
        "goodput_gap": ub.goodput - clos.goodput,
        "analytic_gap": (
            ub_cfg.afr().availability(PAPER_MTTR_HOURS)
            - clos_cfg.afr().availability(PAPER_MTTR_HOURS)
        ),
    }


def linearity_under_failures(
    base_chips: int = 1024,
    chips: int = 8192,
    *,
    candidate: GeometryCandidate | None = None,
    seeds: tuple[int, ...] = tuple(range(8)),
    horizon_weeks: float = 4.0,
    workload: WorkloadSpec | None = None,
    arch: str = "ub-mesh",
    netsim_reprice: bool = True,
    perf_backend: str = "netsim",
    size_bytes: float = 16e6,
) -> dict:
    """Per-NPU *goodput* at scale relative to base, under failures.

    Weak scaling à la Fig. 22 (`core.simulator.linearity_curve`): global
    batch grows with the fleet, the planner re-picks the spec per scale,
    and each scale runs its own campaign (failure rates scale with
    component counts).  Linearity is the ratio of failure-discounted
    per-NPU throughput — the paper claims UB-Mesh holds ≥95% at 8K while
    a backup-less Clos pays a full checkpoint-restore per NPU failure."""
    from repro_torch.core.planner import best_parallel_spec
    from repro_torch.core.simulator import simulate

    cand = candidate or GeometryCandidate()
    w = workload or _default_workload()
    base_w = replace(w, global_batch=max(w.global_batch, base_chips // 8))

    def leg(n: int) -> dict:
        wn = replace(
            base_w, global_batch=base_w.global_batch * n // base_chips
        )
        cfg = CampaignConfig(
            candidate=cand, chips=n, workload=wn, seeds=seeds,
            horizon_weeks=horizon_weeks, arch=arch,
            netsim_reprice=netsim_reprice and arch != "clos",
            size_bytes=size_bytes,
        )
        if arch == "clos" or perf_backend == "analytic":
            # Clos (no chip-level netsim backend) and the fast golden-pin
            # path price the healthy step analytically; the failure
            # discount still comes from the seeded campaign
            perf = cand.comm_model(n)
        else:
            perf = cand.perf_model(n, size_bytes=size_bytes)
        spec = best_parallel_spec(wn, n, perf, rack_size=cand.rack_size)
        r = simulate(wn, spec, perf, rack_size=cand.rack_size)
        camp = run_campaign(cfg)
        per_npu = r.tokens_per_s / n
        return {
            "chips": n,
            "per_npu_tokens_s": per_npu,
            "goodput": camp.goodput,
            "effective_per_npu": per_npu * camp.goodput,
            "campaign": camp,
        }

    base = leg(base_chips)
    top = leg(chips)
    return {
        "base": base,
        "scaled": top,
        "linearity": top["effective_per_npu"] / base["effective_per_npu"],
        "healthy_linearity": (
            top["per_npu_tokens_s"] / base["per_npu_tokens_s"]
        ),
    }


# ---------------------------------------------------------------------------
# per-candidate availability score (codesign third Pareto axis)
# ---------------------------------------------------------------------------


def availability_score(
    candidate: GeometryCandidate,
    chips: int,
    *,
    afr: AFRBreakdown | None = None,
    seeds: tuple[int, ...] = tuple(range(8)),
    horizon_weeks: float = 4.0,
    mttr_hours: float = PAPER_MTTR_HOURS,
) -> float:
    """UNavailability (1 - availability, minimized) of one geometry.

    The sampling-only campaign: component-count AFRs from the
    candidate's own cable/switch counts (`superpod_afr`), seeded event
    sampling, union of repair windows — no netsim, no goodput, so the
    codesign sweep can score its whole candidate grid in milliseconds.
    Deterministic for fixed seeds, which keeps the extended Pareto cull
    winner-safe (the cull and the frontier see the same number)."""
    a = afr or superpod_afr(candidate.superpod(chips))
    return unavailability_for_afr(
        a, seeds=seeds, horizon_weeks=horizon_weeks, mttr_hours=mttr_hours
    )


def unavailability_for_afr(
    afr: AFRBreakdown,
    *,
    seeds: tuple[int, ...] = tuple(range(8)),
    horizon_weeks: float = 4.0,
    mttr_hours: float = PAPER_MTTR_HOURS,
) -> float:
    """Sampling-only unavailability for an arbitrary AFR breakdown (the
    Clos/hybrid baseline points use their own fabric profiles)."""
    H = horizon_weeks * HOURS_PER_WEEK
    rate_h = afr.total / HOURS_PER_YEAR
    if rate_h <= 0:
        return 0.0
    vals = []
    for seed in seeds:
        rng = np.random.default_rng(seed)
        windows = []
        t = 0.0
        while True:
            t += float(rng.exponential(1.0 / rate_h))
            if t >= H:
                break
            windows.append((t, t + mttr_hours))
        vals.append(_union_hours(windows, H) / H)
    return float(np.mean(vals))


# ---------------------------------------------------------------------------
# timeline export (netsim/telemetry.py Perfetto doc)
# ---------------------------------------------------------------------------


def campaign_trace(run: SeedResult, path: str | None = None) -> dict:
    """One seed's failure/recovery timeline as a Chrome/Perfetto trace.

    Hours map to trace seconds (a 4-week horizon stays navigable in the
    Perfetto UI); the goodput counter tracks the instantaneous
    productive rate, spans show repair/stall windows per event class,
    instants mark each policy decision."""
    from repro_torch.netsim.telemetry import perfetto_doc

    spans = []
    instants = []
    goodput_edges: list[tuple[float, float]] = [(0.0, 1.0)]
    for ev in run.timeline:
        t = ev["t"]
        dur = ev.get("stall_h", ev.get("mttr_h", 0.0))
        spans.append(
            {
                "name": ev["action"],
                "lane": ev["kind"],
                "start": t,
                "end": t + dur,
                "args": {
                    k: v for k, v in ev.items() if k not in ("t", "kind")
                },
            }
        )
        instants.append((t, f"{ev['kind']}:{ev['action']}", dict(ev)))
        if "stall_h" in ev:
            goodput_edges.append((t, 0.0))
            goodput_edges.append((t + ev["stall_h"], 1.0))
    goodput_edges.sort(key=lambda p: p[0])
    return perfetto_doc(
        counters={"productive_rate": goodput_edges},
        spans=spans,
        instants=instants,
        time_scale=1e6,                 # 1 simulated hour -> 1 trace second
        path=path,
    )
