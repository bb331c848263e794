"""The port's own copy of ``repro/core/simulator.py``, held to the original by
``tests/test_torch_netsim_parity.py`` and against it by
``tests/test_torch_simulator_parity.py``; only its
imports of the package, and the package's name where its docstring
gives it, differ.

Cluster-scale LLM training simulator (paper §6's evaluation engine).

Computes per-iteration time = compute + exposed communication for a workload
under a parallelization spec on a given communication model (topology
variant).  This is the engine behind the Fig. 17 / 19 / 20 / 22 benchmarks
and the §5.2 planner's objective function.

Calibration targets (paper):
* 2D-FM intra-rack reaches 93.2%..95.9% of Clos training performance,
* inter-rack Detour/Borrow close the 2D-FM vs Clos gap to <1%,
* inter-rack x16 optimal for 8K-32K seq, x32 for 64K-10M,
* linearity >= 95% up to 64x base scale.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import TYPE_CHECKING

from .cost_model import AxisCost, CommModel, Routing, build_comm_model, clos_comm_model
from .traffic import ParallelSpec, TrafficTable, WorkloadSpec, analyze_traffic

if TYPE_CHECKING:  # pragma: no cover
    from .perf_model import PerfModel

# The simulator models the PAPER's NPU class (its accelerator/bandwidth
# ratio sets the comm-exposure that Figs 17-22 measure).  The roofline for
# OUR framework uses the v5e constants in launch/hlo_stats.py instead.
PEAK_FLOPS = 1000e12         # bf16 / chip (paper-class NPU)
MFU_CEILING = 0.60           # achievable fraction of peak on matmul steps


@dataclass(frozen=True)
class SimResult:
    name: str
    compute_s: float
    comm_s: dict[str, float]       # technique -> exposed seconds
    bubble_s: float
    iteration_s: float
    tokens: int

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / self.iteration_s

    @property
    def comm_total_s(self) -> float:
        return sum(self.comm_s.values())


def _compute_seconds(w: WorkloadSpec, p: ParallelSpec) -> float:
    """Per-chip matmul seconds for one iteration (fwd+bwd)."""
    tokens = w.global_batch * w.seq_len
    if w.n_experts > 0:
        active = w.params_total * (
            (1 - w.moe_param_frac) + w.moe_param_frac * w.topk / w.n_experts
        )
    else:
        active = w.params_total
    dense_flops = 6.0 * active * tokens
    # attention score/value matmuls: 12 * L * b * s^2 * (heads*head_dim)
    attn_flops = 12.0 * w.n_layers * w.global_batch * (w.seq_len ** 2) * (
        w.n_heads * w.head_dim
    )
    total = dense_flops + attn_flops
    return total / (p.chips * PEAK_FLOPS * MFU_CEILING)


# overlap fractions: how much of each technique's traffic hides under compute
OVERLAP = {"TP": 0.10, "SP": 0.30, "EP": 0.20, "PP": 0.90, "DP": 0.80}


def _collective_time(
    comm: CommModel, axis: str, shape: str, size_bytes: float
) -> float:
    """Price one transfer of ``shape`` on ``axis`` — the dispatch point
    where a traffic entry's collective shape (``TrafficEntry.shape``)
    selects the matching shape-resolved ``CommModel`` cost, so an A2A
    entry rides the A2A-calibrated bandwidth, not the AllReduce proxy."""
    if shape == "allreduce":
        return comm.allreduce(axis, size_bytes)
    if shape == "all_gather":
        return comm.all_gather(axis, size_bytes)
    if shape == "reduce_scatter":
        return comm.reduce_scatter(axis, size_bytes)
    if shape == "all_to_all":
        return comm.all_to_all(axis, size_bytes)
    if shape == "p2p":
        return comm.p2p(axis, size_bytes)
    raise KeyError(f"unknown collective shape {shape!r}")


def simulate(
    w: WorkloadSpec,
    p: ParallelSpec,
    perf: "PerfModel | CommModel",
    *,
    name: str = "",
    rack_size: int = 64,
) -> SimResult:
    """Analytic iteration-time simulation.

    ``perf`` is any ``core.perf_model.PerfModel`` backend: a plain
    ``CommModel`` (the closed-form analytic backend), an
    ``AnalyticPerfModel`` with explicit bandwidth overrides (and
    optionally a measured ``CalibrationProfile``), or a
    ``NetsimPerfModel`` whose ``comm_model(p)`` resolves to flow-level
    *measured* per-(axis, collective-shape) bandwidths for this spec —
    pricing in the contention, relay and incast effects the closed-form
    model idealizes away.  Each traffic entry is priced on its own
    collective shape (``TrafficEntry.shape``): EP's A2A rides the
    A2A-calibrated number while TP/DP keep theirs.
    """
    comm = perf.comm_model(p)
    traffic = analyze_traffic(w, p)
    compute_s = _compute_seconds(w, p)

    # map techniques onto axes; when the TP*SP footprint exceeds the rack
    # high-bandwidth domain, the overflow fraction of TP/SP traffic crosses
    # the inter-rack ("data") axis — the Fig. 20 effect.
    tp_sp_footprint = p.tp * p.sp
    spill = 0.0
    if tp_sp_footprint > rack_size:
        spill = 1.0 - rack_size / tp_sp_footprint

    comm_s: dict[str, float] = {}
    for e in traffic.entries:
        per_transfer = e.volume_per_transfer
        n = e.n_transfers
        if e.technique in ("TP", "SP", "EP"):
            n = max(1, n // p.pp)   # each device hosts L/pp of the layers
        if e.technique == "EP":
            # Table-1 ledger stores the per-peer chunk; the device-level A2A
            # payload per op is chunk * ep
            per_transfer = per_transfer * p.ep
        if e.technique == "PP":
            t_local = _collective_time(comm, "data", e.shape, per_transfer) * n
            t_spill = t_local
        elif e.technique == "DP":
            axes = ["data"] + (["pod"] if "pod" in comm.axes else [])
            t_local = comm.hierarchical_allreduce(axes, per_transfer) * n
            t_spill = t_local
        else:   # TP / SP / EP live on the model axis, spilling to "data"
            t_local = _collective_time(comm, "model", e.shape, per_transfer) * n
            t_spill = _collective_time(comm, "data", e.shape, per_transfer) * n
        t = (1 - spill) * t_local + spill * t_spill
        exposed = t * (1 - OVERLAP[e.technique])
        comm_s[e.technique] = comm_s.get(e.technique, 0.0) + exposed

    bubble_s = compute_s * (p.pp - 1) / max(p.microbatches, 1) if p.pp > 1 else 0.0
    iteration_s = compute_s + sum(comm_s.values()) + bubble_s
    return SimResult(
        name=name or w.name,
        compute_s=compute_s,
        comm_s=comm_s,
        bubble_s=bubble_s,
        iteration_s=iteration_s,
        tokens=w.global_batch * w.seq_len,
    )


# ---------------------------------------------------------------------------
# Intra-rack architecture variants (paper Fig. 16/17)
# ---------------------------------------------------------------------------

# effective per-chip "model"-axis bandwidth (GB/s) of each intra-rack variant:
#   2D-FM    — 56 direct lanes, multi-ring recovers them all        ~350
#   1D-FM-A  — 28 X lanes direct + x16 LRS-switched cross-board     ~380*
#   1D-FM-B  — 28 X lanes direct + x32 HRS-switched                  ~430
#   Clos     — all 72 lanes switched, fully symmetric                450
# 2D-FM multiring recovers the 56 direct lanes at ~80% efficiency (even-n
# cliques decompose into CHAINS, whose endpoints idle half-duplex; boundary
# turns between X/Y rings cost the rest) — see core/multiring.py
INTRA_RACK_GBS = {
    "2D-FM": 280.0,
    "1D-FM-A": 350.0,
    "1D-FM-B": 420.0,
    "Clos": 450.0,
}


def intra_rack_comm_model(variant: str, *, multi_pod: bool = True) -> CommModel:
    # the paper fixes the inter-rack fabric at 2D-FM for this comparison
    # (§6.2); only the intra-rack ("model") bandwidth varies
    base = build_comm_model(multi_pod=multi_pod, routing=Routing.DETOUR)
    axes = dict(base.axes)
    axes["model"] = replace(axes["model"], gbs_per_chip=INTRA_RACK_GBS[variant])
    return CommModel(axes=axes, routing=base.routing)


def inter_rack_comm_model(strategy: str, *, multi_pod: bool = True) -> CommModel:
    """Fig. 18/19: 2D-FM inter-rack with Shortest/Detour/Borrow, or Clos."""
    if strategy == "Clos":
        m = build_comm_model(multi_pod=multi_pod, routing=Routing.DETOUR)
        axes = dict(m.axes)
        axes["data"] = replace(axes["data"], gbs_per_chip=450.0)
        return CommModel(axes=axes, routing=m.routing)
    routing = {
        "Shortest": Routing.SHORTEST,
        "Detour": Routing.DETOUR,
        "Borrow": Routing.BORROW,
    }[strategy]
    m = build_comm_model(multi_pod=multi_pod, routing=routing)
    if routing == Routing.SHORTEST:
        # single-path also halves the *model* axis? No — Fig 19 varies only
        # the inter-rack strategy; intra-rack keeps multi-ring.
        base = build_comm_model(multi_pod=multi_pod, routing=Routing.DETOUR)
        axes = dict(base.axes)
        shortest = build_comm_model(multi_pod=multi_pod, routing=Routing.SHORTEST)
        axes["data"] = shortest.axes["data"]
        return CommModel(axes=axes, routing=Routing.SHORTEST)
    return m


def linearity_curve(
    w: WorkloadSpec,
    base_chips: int,
    scales: list[int],
    *,
    perf: "PerfModel | CommModel | None" = None,
) -> dict[int, float]:
    """Paper Fig. 22: per-NPU throughput at scale k relative to base.

    Global batch grows with scale (weak scaling); the planner (priority
    heuristic inlined here) re-picks DP/PP split at each scale.  ``perf``
    may be any ``PerfModel`` backend; the DCN penalty above one SuperPod is
    applied by pinning the "pod" axis through ``override_axis``.
    """
    from .planner import best_parallel_spec  # local import to avoid cycle

    perf = perf or build_comm_model(multi_pod=True, routing=Routing.BORROW)
    base_axes = perf.comm_model(None).axes
    out: dict[int, float] = {}
    base_w = replace(w, global_batch=max(w.global_batch, base_chips // 8))
    base_p = best_parallel_spec(base_w, base_chips, perf)
    base_r = simulate(base_w, base_p, perf)
    base_per_npu = base_r.tokens_per_s / base_chips
    for k in scales:
        chips = base_chips * k
        wk = replace(base_w, global_batch=base_w.global_batch * k)
        # beyond one SuperPod (8K), DP crosses the DCN: cheaper per-chip BW
        perf_k = perf
        if chips > 8192 and "pod" in base_axes:
            dcn_gbs = base_axes["pod"].gbs_per_chip / 2.5
            perf_k = perf.override_axis(
                "pod",
                AxisCost(
                    size=max(2, chips // 8192),
                    gbs_per_chip=dcn_gbs,
                    latency_s=10e-6,
                ),
            )
        pk = best_parallel_spec(wk, chips, perf_k)
        rk = simulate(wk, pk, perf_k)
        per_npu = rk.tokens_per_s / chips
        if chips > 8192:
            # cross-SuperPod DCN jitter/straggler amortization (§6.5): the
            # 64x points in Fig. 22 sit at 95-97%
            per_npu /= 1.0 + 0.012 * math.log2(chips / 8192)
        out[k] = per_npu / base_per_npu
    return out
