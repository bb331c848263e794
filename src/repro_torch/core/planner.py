"""The port's own copy of ``repro/core/planner.py``, held to the original by
``tests/test_torch_netsim_parity.py`` and against it by
``tests/test_torch_planner_parity.py``; only its
imports of the package, and the package's name where its docstring
gives it, differ.

Topology-aware parallelization planner (paper §5.2, Fig. 15).

Step 1 — generate feasible parallelism configurations mapped onto UB-Mesh;
Step 2 — price each through a ``core.perf_model.PerfModel`` backend (the
closed-form analytic ``CommModel``, or the netsim-calibrated backend whose
``CalibrationProfile`` prices each collective SHAPE on its own measured
bandwidth — so EP's all-to-all is no longer flattered by an
AllReduce-calibrated scalar);
Step 3 — pick the minimum-cost configuration.

Search-space pruning follows the paper's priority heuristic: TP and SP
(high volume) are pinned to the high-bandwidth intra-rack domain first;
PP and DP get what remains; for MoE, SP*DP must be an integer multiple of EP.
"""

from __future__ import annotations

import itertools
import logging
import math
import time
from dataclasses import dataclass, field, replace
from typing import TYPE_CHECKING, Iterator

from .cost_model import CommModel
from .traffic import ParallelSpec, WorkloadSpec

if TYPE_CHECKING:  # pragma: no cover
    from .perf_model import PerfModel

log = logging.getLogger(__name__)


def _divisors_pow2(n: int, cap: int) -> list[int]:
    out = []
    d = 1
    while d <= min(n, cap):
        if n % d == 0:
            out.append(d)
        d *= 2
    return out


HBM_BYTES = 48e9        # datacenter-class NPU HBM (the paper's NPUs; the
                        # production-mesh fit for OUR framework is checked by
                        # the dry-run's memory_analysis, not this constant)


def memory_feasible(w: WorkloadSpec, p: ParallelSpec, hbm: float = HBM_BYTES) -> bool:
    """First-order per-chip memory: bf16 params + ZeRO-1 optimizer shards +
    remat'd activation boundaries must fit HBM.  This is what forces PP at
    small scale (and creates the paper's Fig. 22 super-linearity when larger
    scale unlocks bubble-free configs).
    """
    if w.n_experts > 0:
        dense = w.params_total * (1 - w.moe_param_frac)
        moe = w.params_total * w.moe_param_frac
        p_local = dense / (p.tp * p.pp) + moe / (p.tp * p.pp * p.ep)
    else:
        p_local = w.params_total / (p.tp * p.pp)
    param_bytes = p_local * 2.0
    grad_bytes = p_local * 2.0
    optim_bytes = p_local * 12.0 / p.dp          # ZeRO-1: fp32 master + m + v
    seqs_per_dp = max(1, w.global_batch // p.dp)
    s_loc = max(1, w.seq_len // p.sp)
    tokens_mb = max(1, seqs_per_dp * s_loc // max(1, p.microbatches))
    layers_local = max(1, w.n_layers // p.pp)
    # remat: keep ~2 boundary tensors per layer + pipeline in-flight copies
    act_bytes = tokens_mb * w.hidden * 2.0 * 2.0 * layers_local
    act_bytes *= min(p.pp, p.microbatches)      # 1F1B in-flight microbatches
    return param_bytes + grad_bytes + optim_bytes + act_bytes <= hbm


@dataclass(frozen=True)
class PlanResult:
    spec: ParallelSpec
    iteration_s: float
    compute_s: float
    comm_s: float
    bubble_s: float


@dataclass(frozen=True)
class Prefilter:
    """Tuning of the vectorized analytic pre-filter (see ``plan``).

    ``keep_k`` specs with the best analytic iteration time always survive
    (never fewer than the requested ``top_k``).  ``margin`` is the safety
    factor on the analytic comm estimate that extends the survivor set:
    every spec whose analytic time beats the best achievable time under a
    ``margin``-fold bandwidth degradation also survives.  Because a
    measured backend only ever prices comm at or *below* the analytic
    bandwidth (``CalibrationProfile.apply(clamp=True)``), a spec whose
    analytic time exceeds that cutoff cannot win unless measurement
    degrades some bandwidth by more than ``margin`` — 5x covers the worst
    observed analytic/netsim ratio (the relay-and-incast-priced A2A at
    ~4.2x) with slack.
    """

    keep_k: int = 64
    margin: float = 5.0


def analytic_iteration_arrays(
    w: WorkloadSpec,
    specs: list[ParallelSpec],
    comm: CommModel,
    *,
    rack_size: int = 64,
):
    """Per-spec ``(compute_s, comm_s, bubble_s)`` numpy arrays from the
    vectorized analytic cost model — the batch replica of
    ``analyze_traffic`` + ``simulate``.

    Every closed-form collective cost is linear in the payload for a
    fixed ``CommModel`` (``c1 * bytes + c0``), so each (axis, shape)
    needs one two-point probe and the per-spec composition is pure
    arithmetic on the (tp, sp, pp, dp, ep, m) arrays.  Raises on models
    the analytic composition cannot price (missing axes).

    Shared by the planner's spec pre-filter (:func:`_prefilter_mask`) and
    the topology co-design geometry cull (``core/codesign.py``) — when a
    measured backend clamps at the analytic bound, ``compute + bubble +
    comm`` is a LOWER bound and ``compute + bubble + margin * comm`` an
    upper-bound proxy on the measured iteration, which is what both
    winner-safety arguments rest on."""
    import numpy as np

    from .simulator import OVERLAP, _compute_seconds

    def lin(f) -> tuple[float, float]:
        # closed forms return c1 * size + c0 for size > 0 (and 0 at 0)
        s1, s2 = 1e6, 2e6
        t1, t2 = f(s1), f(s2)
        c1 = (t2 - t1) / (s2 - s1)
        return c1, t1 - c1 * s1

    cost = {
        ("model", "allreduce"): lin(lambda s: comm.allreduce("model", s)),
        ("model", "all_gather"): lin(lambda s: comm.all_gather("model", s)),
        ("model", "all_to_all"): lin(lambda s: comm.all_to_all("model", s)),
        ("data", "allreduce"): lin(lambda s: comm.allreduce("data", s)),
        ("data", "all_gather"): lin(lambda s: comm.all_gather("data", s)),
        ("data", "all_to_all"): lin(lambda s: comm.all_to_all("data", s)),
        ("data", "p2p"): lin(lambda s: comm.p2p("data", s)),
    }
    dp_axes = ["data"] + (["pod"] if "pod" in comm.axes else [])
    hier = lin(lambda s: comm.hierarchical_allreduce(dp_axes, s))

    tp = np.array([p.tp for p in specs], dtype=np.int64)
    sp = np.array([p.sp for p in specs], dtype=np.int64)
    pp = np.array([p.pp for p in specs], dtype=np.int64)
    dp = np.array([p.dp for p in specs], dtype=np.int64)
    ep = np.array([p.ep for p in specs], dtype=np.int64)
    m = np.array([p.microbatches for p in specs], dtype=np.int64)
    buckets = np.array([p.grad_buckets for p in specs], dtype=np.int64)

    def price(axis_local: str, shape: str, v, n):
        c1l, c0l = cost[(axis_local, shape)]
        t_local = np.where(n > 0, (c1l * v + c0l) * n, 0.0)
        if axis_local == "model":       # TP/SP/EP spill to the data axis
            c1s, c0s = cost[("data", shape)]
            t_spill = np.where(n > 0, (c1s * v + c0s) * n, 0.0)
            return (1.0 - spill) * t_local + spill * t_spill
        return t_local

    # ---- analyze_traffic, vectorized -------------------------------------
    bpe = w.bytes_per_elem
    L = w.n_layers
    seqs = np.maximum(1, w.global_batch // dp)
    s_loc = np.maximum(1, w.seq_len // sp)
    tokens_mb = np.maximum(1, seqs * s_loc // m)
    v_act = tokens_mb.astype(np.float64) * w.hidden * bpe

    footprint = tp * sp
    spill = np.where(
        footprint > rack_size, 1.0 - rack_size / footprint, 0.0
    )

    comm_total = np.zeros(len(specs))
    n_base = 4 * L * m
    n_eff = np.maximum(1, n_base // pp)          # simulate's L/pp hosting
    # TP: AllReduce on the model axis
    comm_total += (
        price("model", "allreduce", v_act, np.where(tp > 1, n_eff, 0))
        * (1 - OVERLAP["TP"])
    )
    # SP: half-width re-gathers + full-width gathers
    sp_mask = sp > 1
    comm_total += (
        price("model", "all_gather", v_act / 2, np.where(sp_mask, n_eff, 0))
        + price(
            "model", "all_gather", v_act,
            np.where(sp_mask, np.maximum(1, (n_base // 3) // pp), 0),
        )
    ) * (1 - OVERLAP["SP"])
    # EP: dispatch/combine A2A (ledger stores the per-peer chunk; the
    # device-level payload per op is chunk * ep)
    if w.n_experts > 0:
        ep_mask = ep > 1
        off = np.where(ep_mask, (ep - 1) / np.maximum(ep, 1), 0.0)
        v_a2a = tokens_mb * w.topk * (w.hidden / tp) * bpe * off / np.maximum(ep, 1)
        comm_total += (
            price(
                "model", "all_to_all", v_a2a * ep,
                np.where(ep_mask, n_eff, 0),
            )
            * (1 - OVERLAP["EP"])
        )
    # PP: boundary activations on the data axis
    comm_total += (
        price("data", "p2p", v_act, np.where(pp > 1, 2 * m, 0))
        * (1 - OVERLAP["PP"])
    )
    # DP: bucketed gradient AllReduce up the data(+pod) hierarchy
    if w.n_experts > 0:
        dense = w.params_total * (1 - w.moe_param_frac)
        moe = w.params_total * w.moe_param_frac
        p_local = dense / (tp * pp) + moe / (tp * pp * ep)
    else:
        p_local = w.params_total / (tp * pp)
    v_grad = p_local * 4.0 / buckets
    c1h, c0h = hier
    comm_total += np.where(
        dp > 1, (c1h * v_grad + c0h) * buckets, 0.0
    ) * (1 - OVERLAP["DP"])

    compute_s = _compute_seconds(w, specs[0])    # chips-invariant scalar
    bubble_s = np.where(pp > 1, compute_s * (pp - 1) / np.maximum(m, 1), 0.0)
    return np.full(len(specs), compute_s), comm_total, bubble_s


def _prefilter_mask(
    w: WorkloadSpec,
    specs: list[ParallelSpec],
    comm: CommModel,
    *,
    rack_size: int,
    keep_k: int,
    margin: float,
):
    """Boolean survivor mask over ``specs`` from
    :func:`analytic_iteration_arrays`."""
    import numpy as np

    compute_s, comm_total, bubble_s = analytic_iteration_arrays(
        w, specs, comm, rack_size=rack_size
    )
    iteration = compute_s + comm_total + bubble_s

    # survivors: the analytic top keep_k, plus everything that could still
    # win under a margin-fold bandwidth degradation of the best candidate
    cutoff = np.min(compute_s + bubble_s + margin * comm_total)
    keep = iteration <= cutoff
    if len(specs) > keep_k:
        keep |= iteration <= np.partition(iteration, keep_k - 1)[keep_k - 1]
    else:
        keep[:] = True
    return keep


@dataclass(frozen=True)
class PlanReport:
    """Ranked plan results plus the search's bookkeeping.

    Sequence-like over ``results`` so ``plan(...)[0]`` / iteration keep
    working; ``skipped`` counts specs whose simulation RAISED (by exception
    type) — previously swallowed silently, which hid cost-model bugs.

    ``wall_s`` is the search's wall-clock cost and ``calibration`` the
    netsim calibration-memo delta over the search (``hits`` / ``misses`` /
    ``measure_s`` / ``per_key_s`` from
    ``core.perf_model.calibration_stats``) — together they attribute
    planner latency: a search that re-measures is slow in ``measure_s``,
    a memo-warm one is pure enumeration.
    """

    results: tuple[PlanResult, ...]
    n_enumerated: int = 0
    n_infeasible: int = 0                      # failed memory_feasible
    skipped: dict[str, int] = field(default_factory=dict)
    wall_s: float = 0.0
    calibration: dict = field(default_factory=dict)
    n_prefiltered: int = 0                     # culled by the analytic pre-filter

    @property
    def n_skipped(self) -> int:
        return sum(self.skipped.values())

    def __iter__(self) -> Iterator[PlanResult]:
        return iter(self.results)

    def __len__(self) -> int:
        return len(self.results)

    def __getitem__(self, i):
        return self.results[i]


def enumerate_specs(
    w: WorkloadSpec,
    chips: int,
    *,
    rack_size: int = 64,
    max_tp: int = 64,
    microbatch_options: tuple[int, ...] = (1, 2, 4, 8, 13, 16, 32),
) -> list[ParallelSpec]:
    """Feasible (tp, sp, pp, dp, ep, m) factorizations of ``chips``."""
    specs: list[ParallelSpec] = []
    for tp in _divisors_pow2(chips, max_tp):
        rem = chips // tp
        for pp in _divisors_pow2(rem, min(rem, w.n_layers)):
            dp = rem // pp
            if dp < 1:
                continue
            seqs_per_dp = w.global_batch / dp
            if seqs_per_dp < 1:
                continue
            sp_options = [
                s for s in (1, 2, 4, 8, 16, 32, 64) if w.seq_len % s == 0
            ]
            for sp in sp_options:
                # paper heuristic: prioritize TP*SP into the rack domain;
                # long-context jobs may spill across racks (Fig. 20), but
                # never beyond a quarter pod.
                if tp * sp > 16 * rack_size:
                    continue
                ep_options = [1]
                if w.n_experts > 0:
                    ep_options = [
                        e
                        for e in (1, 2, 4, 8, 16, 32)
                        if e <= w.n_experts
                        and w.n_experts % e == 0
                        and (sp * dp) % e == 0  # paper: SP*DP multiple of EP
                    ]
                for ep in ep_options:
                    s_loc = max(1, w.seq_len // sp)
                    # sequence-split microbatching: long-context jobs may
                    # chop the local sequence into >=2048-token microbatches
                    max_m = max(1, int(seqs_per_dp)) * max(1, s_loc // 2048)
                    for m in microbatch_options:
                        if m > max_m:
                            continue
                        if pp > 1 and m < pp:  # bubble-dominated; prune
                            continue
                        specs.append(
                            ParallelSpec(
                                tp=tp, sp=sp, pp=pp, dp=dp, ep=ep, microbatches=m
                            )
                        )
    return specs


def enumerate_decode_specs(
    w: WorkloadSpec,
    chips: int,
    *,
    max_tp: int = 64,
    hbm: float = HBM_BYTES,
) -> list[ParallelSpec]:
    """Feasible (tp, dp) shardings of ``chips`` for decode serving.

    Decode inference has no gradients, optimizer shards or pipeline
    microbatching to trade off: the factorization is TP (weight sharding
    inside the rack plane) x DP (independent serving replicas), and the
    only hard constraint is that the bf16 weight shard fits HBM.  The
    interesting tension — maximum TP streams the smallest shard per step
    but pays the widest collective latency per token — is priced by
    ``launch.serve.decode_step_s``, not filtered here.
    """
    specs: list[ParallelSpec] = []
    for tp in _divisors_pow2(chips, max_tp):
        dp = chips // tp
        if tp * dp != chips:
            continue
        if w.params_total * w.bytes_per_elem / tp > hbm:
            continue
        specs.append(
            ParallelSpec(
                tp=tp, sp=1, pp=1, dp=dp, ep=1,
                microbatches=1, grad_buckets=1,
            )
        )
    return specs


def _prefilter_comm(perf: "PerfModel | CommModel") -> CommModel:
    """The spec-invariant analytic model the pre-filter prices against.

    For the netsim backend this is its analytic *base* (plus any pinned
    axis overrides) — deliberately NOT ``comm_model(None)``, which would
    trigger netsim measurement of the default widths before the filter
    has trimmed the spec set.  Measured backends clamp at the analytic
    bound, so the base is a true lower bound on what pricing will return
    — exactly what the ``Prefilter.margin`` soundness argument needs.
    Spec-invariant backends resolve ``comm_model(None)`` directly (cheap,
    and identical to what final pricing uses)."""
    base = getattr(perf, "base", None)
    if getattr(perf, "backend", "") == "netsim" and isinstance(base, CommModel):
        pinned = getattr(perf, "pinned", None) or {}
        if pinned:
            axes = dict(base.axes)
            axes.update(pinned)
            return CommModel(axes=axes, routing=base.routing)
        return base
    return perf.comm_model(None)


def plan(
    w: WorkloadSpec,
    chips: int,
    perf: "PerfModel | CommModel",
    *,
    rack_size: int = 64,
    top_k: int = 5,
    max_tp: int = 64,
    microbatch_options: tuple[int, ...] = (1, 2, 4, 8, 13, 16, 32),
    prefilter: "Prefilter | None" = Prefilter(),
    precalibrate: bool = True,
) -> PlanReport:
    """Rank feasible specs by simulated iteration time (Step 2+3).

    ``perf`` is any ``core.perf_model.PerfModel`` backend (a plain
    ``CommModel`` is the analytic one); a ``NetsimPerfModel`` ranks specs
    on flow-level *measured* axis bandwidths instead of idealized ones.

    ``max_tp`` / ``microbatch_options`` thread straight through to
    ``enumerate_specs`` so callers can narrow the search space without
    reimplementing the loop.

    ``prefilter`` (default on) evaluates the analytic cost model as numpy
    array ops over the whole spec batch and sends only the plausible
    Pareto tail (``Prefilter.keep_k`` best plus a ``margin``-fold safety
    band) to per-spec pricing — for a netsim backend that means far fewer
    calibration keys to measure.  Pass ``prefilter=None`` to price every
    feasible spec (the escape hatch; winner preservation of the default
    against this path is pinned by tests on every bench config).  Models
    the analytic composition cannot price (e.g. a missing axis) fall back
    to the unfiltered path automatically, so skip accounting is unchanged.

    ``precalibrate`` (default on) front-loads every calibration key the
    surviving specs need through ``NetsimPerfModel.precalibrate`` — few
    batched solver sessions instead of one per key — for backends that
    expose it.

    Specs whose simulation raises (missing axis, degenerate bandwidth) are
    counted per exception type on ``PlanReport.skipped`` and summarized in
    one log line — not silently dropped, so model bugs stay visible.
    """
    from .perf_model import calibration_stats  # local import to avoid cycle
    from .simulator import simulate  # local import to avoid cycle

    t_start = time.perf_counter()
    cal_before = calibration_stats()
    specs = enumerate_specs(
        w, chips, rack_size=rack_size, max_tp=max_tp,
        microbatch_options=microbatch_options,
    )
    n_enumerated = len(specs)
    feasible = [s for s in specs if memory_feasible(w, s)]
    n_infeasible = n_enumerated - len(feasible)

    survivors = feasible
    n_prefiltered = 0
    if prefilter is not None and len(feasible) > max(prefilter.keep_k, top_k):
        try:
            mask = _prefilter_mask(
                w, feasible, _prefilter_comm(perf),
                rack_size=rack_size,
                keep_k=max(prefilter.keep_k, top_k),
                margin=prefilter.margin,
            )
            survivors = [s for s, keep in zip(feasible, mask) if keep]
            n_prefiltered = len(feasible) - len(survivors)
        except Exception as e:  # unpriceable model: fall back to full search
            log.debug(
                "plan(%s): analytic prefilter disabled (%s: %s)",
                w.name, type(e).__name__, e,
            )
            survivors = feasible

    if precalibrate and survivors:
        pre = getattr(perf, "precalibrate", None)
        if pre is not None:
            pre(survivors)

    results: list[PlanResult] = []
    skipped: dict[str, int] = {}
    for spec in survivors:
        try:
            r = simulate(w, spec, perf, rack_size=rack_size)
        except (KeyError, ZeroDivisionError) as e:
            skipped[type(e).__name__] = skipped.get(type(e).__name__, 0) + 1
            continue
        results.append(
            PlanResult(
                spec=spec,
                iteration_s=r.iteration_s,
                compute_s=r.compute_s,
                comm_s=r.comm_total_s,
                bubble_s=r.bubble_s,
            )
        )
    if skipped:
        log.warning(
            "plan(%s, %d chips): %d/%d specs skipped by simulate errors %s",
            w.name, chips, sum(skipped.values()), n_enumerated, skipped,
        )
    results.sort(key=lambda x: x.iteration_s)
    cal_after = calibration_stats()
    calibration = {
        "hits": cal_after["hits"] - cal_before["hits"],
        "misses": cal_after["misses"] - cal_before["misses"],
        "disk_hits": cal_after["disk_hits"] - cal_before["disk_hits"],
        "measure_s": cal_after["measure_s"] - cal_before["measure_s"],
        "sessions": cal_after["sessions"] - cal_before["sessions"],
        "session_keys": cal_after["session_keys"] - cal_before["session_keys"],
        "per_key_s": {
            "{}/{}/{}".format(*k): dt - cal_before["per_key_s"].get(k, 0.0)
            for k, dt in cal_after["per_key_s"].items()
            if dt - cal_before["per_key_s"].get(k, 0.0) > 0.0
        },
    }
    return PlanReport(
        results=tuple(results[:top_k]),
        n_enumerated=n_enumerated,
        n_infeasible=n_infeasible,
        skipped=skipped,
        wall_s=time.perf_counter() - t_start,
        calibration=calibration,
        n_prefiltered=n_prefiltered,
    )


def best_parallel_spec(
    w: WorkloadSpec,
    chips: int,
    perf: "PerfModel | CommModel",
    *,
    rack_size: int = 64,
    max_tp: int = 64,
    microbatch_options: tuple[int, ...] = (1, 2, 4, 8, 13, 16, 32),
    prefilter: "Prefilter | None" = Prefilter(),
) -> ParallelSpec:
    ranked = plan(
        w, chips, perf, rack_size=rack_size, top_k=1, max_tp=max_tp,
        microbatch_options=microbatch_options, prefilter=prefilter,
    )
    if not ranked:
        raise ValueError(f"no feasible parallelization for {w.name} on {chips} chips")
    return ranked[0].spec
