"""The port's own copy of ``repro/core/traffic.py``, held to the original by
``tests/test_torch_topology.py``; only its imports of the package differ.

LLM-training traffic analysis (paper §2.2, Table 1).

Analytic, Megatron-style accounting of the bytes each parallelism technique
moves per training iteration.  The output drives three things:

* the Table-1 reproduction benchmark (locality: TP+SP ~ 97% of traffic),
* the parallelization planner's objective (which axis carries which volume),
* the training-iteration simulator (per-axis communication time).

All volumes are per-DP-replica per-iteration unless noted; bf16 payloads.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass(frozen=True)
class WorkloadSpec:
    """Just enough of a model + schedule to price its traffic."""

    name: str
    n_layers: int
    hidden: int
    n_heads: int
    head_dim: int
    n_kv_heads: int | None = None
    seq_len: int = 8192
    global_batch: int = 512            # sequences
    params_total: float = 7e10
    n_experts: int = 0                 # 0 => dense
    topk: int = 2
    moe_param_frac: float = 0.8        # fraction of params in expert MLPs
    bytes_per_elem: int = 2            # bf16

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads


@dataclass(frozen=True)
class ParallelSpec:
    tp: int = 8
    sp: int = 8          # sequence/context parallel degree
    pp: int = 8
    dp: int = 8
    ep: int = 1
    microbatches: int = 13
    grad_buckets: int = 64

    @property
    def chips(self) -> int:
        # TP and SP share the high-bandwidth group in UB-Mesh (§5.2): the
        # model axis is tp*sp wide only when they shard different resources;
        # Megatron-SP reuses the TP group, so the footprint is tp * pp * dp.
        return self.tp * self.pp * self.dp


# ledger pattern label -> the canonical collective shape a
# ``core.cost_model.CalibrationProfile`` prices (COLLECTIVE_SHAPES)
_PATTERN_SHAPE = {
    "AllReduce": "allreduce",
    "AllGather": "all_gather",
    "AllGather(full)": "all_gather",
    "ReduceScatter": "reduce_scatter",
    "AlltoAll": "all_to_all",
    "P2P": "p2p",
}


@dataclass(frozen=True)
class TrafficEntry:
    technique: str
    pattern: str
    volume_per_transfer: float   # bytes
    n_transfers: int
    total_bytes: float
    locality: str                # which mesh axis carries it

    @property
    def shape(self) -> str:
        """Collective shape of this entry, in ``CalibrationProfile`` terms
        — the single source of truth the simulator dispatches on, so EP
        volume is priced on the A2A bandwidth while TP/DP keep theirs."""
        return _PATTERN_SHAPE[self.pattern]

    @property
    def volume_mb(self) -> float:
        return self.volume_per_transfer / 1e6

    @property
    def total_gb(self) -> float:
        return self.total_bytes / 1e9


@dataclass(frozen=True)
class TrafficTable:
    entries: tuple[TrafficEntry, ...]

    @property
    def total_bytes(self) -> float:
        return sum(e.total_bytes for e in self.entries)

    def share(self, technique: str) -> float:
        tot = self.total_bytes
        return (
            sum(e.total_bytes for e in self.entries if e.technique == technique)
            / tot
            if tot
            else 0.0
        )

    def local_share(self) -> float:
        """Fraction of traffic on the high-bandwidth (intra-rack) domain."""
        tot = self.total_bytes
        return (
            sum(e.total_bytes for e in self.entries if e.locality == "model")
            / tot
            if tot
            else 0.0
        )


def analyze_traffic(w: WorkloadSpec, p: ParallelSpec) -> TrafficTable:
    """Per-iteration traffic per technique (per DP replica)."""
    bpe = w.bytes_per_elem
    # local activation tile: tokens per microbatch (sequence-split
    # microbatching allowed for long-context jobs) x hidden
    seqs_per_replica = max(1, w.global_batch // p.dp)
    s_loc = max(1, w.seq_len // p.sp)
    tokens_mb = max(1, seqs_per_replica * s_loc // p.microbatches)
    b_mb = max(1, seqs_per_replica // p.microbatches)
    v_act = tokens_mb * w.hidden * bpe

    entries: list[TrafficEntry] = []

    # --- TP: 2 AllReduce fwd + 2 bwd per layer per microbatch (Megatron) ---
    if p.tp > 1:
        n = 4 * w.n_layers * p.microbatches
        entries.append(
            TrafficEntry("TP", "AllReduce", v_act, n, v_act * n, "model")
        )

    # --- SP: AllGathers around attention/MLP (two size classes, like the
    # paper's 180/360 MB mix: half-width re-gathers of the TP-sliced tiles
    # plus full-width gathers for the attention inputs) -------------------
    if p.sp > 1:
        n_half = 4 * w.n_layers * p.microbatches
        n_full = n_half // 3
        entries.append(
            TrafficEntry("SP", "AllGather", v_act / 2, n_half, v_act / 2 * n_half, "model")
        )
        entries.append(
            TrafficEntry("SP", "AllGather(full)", v_act, n_full, v_act * n_full, "model")
        )

    # --- EP: dispatch+combine All2All, fwd+bwd, per MoE layer --------------
    # Ledger follows the paper's Table 1: "volume per transfer" is the
    # per-peer A2A chunk of the TP-sliced token tile.
    if w.n_experts > 0 and p.ep > 1:
        off = (p.ep - 1) / p.ep
        v_a2a = tokens_mb * w.topk * (w.hidden / p.tp) * bpe * off / p.ep
        n = 4 * w.n_layers * p.microbatches
        entries.append(
            TrafficEntry("EP", "AlltoAll", v_a2a, n, v_a2a * n, "model")
        )

    # --- PP: boundary activations, fwd + bwd per microbatch ----------------
    if p.pp > 1:
        n = 2 * p.microbatches
        entries.append(
            TrafficEntry("PP", "P2P", v_act, n, v_act * n, "data")
        )

    # --- DP: gradient AllReduce (bucketed, fp32 reduction payloads) --------
    if p.dp > 1:
        if w.n_experts > 0:
            dense = w.params_total * (1 - w.moe_param_frac)
            moe = w.params_total * w.moe_param_frac
            p_local = dense / (p.tp * p.pp) + moe / (p.tp * p.pp * p.ep)
        else:
            p_local = w.params_total / (p.tp * p.pp)
        grad_bytes = p_local * 4
        v = grad_bytes / p.grad_buckets
        entries.append(
            TrafficEntry("DP", "AllReduce", v, p.grad_buckets, grad_bytes, "data")
        )

    return TrafficTable(entries=tuple(entries))


# Paper Table 1 reference values (in-house MoE-2T measurement) for the
# side-by-side benchmark.
PAPER_TABLE1 = {
    "TP": dict(pattern="AllReduce", volume_mb=360.0, transfers=4992, total_gb=1775.0, share=0.529),
    "SP": dict(pattern="AllGather", volume_mb=360.0, transfers=4992, total_gb=1462.5, share=0.4408),
    "EP": dict(pattern="AlltoAll", volume_mb=10.5, transfers=4992, total_gb=51.19, share=0.0154),
    "PP": dict(pattern="P2P", volume_mb=192.0, transfers=26, total_gb=4.875, share=0.0014),
    "DP": dict(pattern="AllReduce", volume_mb=711.75, transfers=64, total_gb=44.48, share=0.0134),
}


def backend_comparison_workloads() -> tuple[WorkloadSpec, WorkloadSpec]:
    """The canonical (uncongested, contended) workload pair for comparing
    PerfModel backends — shared by ``benchmarks/planner_bench.py`` and the
    backend-contract tests so the two cannot drift apart.

    * uncongested dense-70B: TP*SP = 64 fills the rack plane exactly, every
      strong candidate rides the full-bandwidth cross-dim 2D multi-ring, so
      measured and idealized rankings coincide.
    * contended MoE-600B @ seq 2500: the sequence length caps SP at 4, so
      the search is between NARROW model-axis groups (tp*sp = 16..32 chips
      -> per-dim hierarchical schedule, measured ~85 GB/s) and the full
      64-chip plane (2D multi-ring, ~140-165 GB/s).  The analytic backend
      prices them all at a flat 200 GB/s; the netsim backend knows narrow
      groups are ~2x slower and flips the winner (the Rail-only / RailX
      observation: placement decisions flip when contention is priced
      realistically).
    """
    clean = WorkloadSpec(
        "dense-70B", 80, 8192, 64, 128, 8,
        seq_len=5000, global_batch=512, params_total=7e10,
    )
    contended = WorkloadSpec(
        "moe-600B-s2500", 64, 8192, 64, 128, 8,
        seq_len=2500, global_batch=512, params_total=6e11,
        n_experts=16, topk=2, moe_param_frac=0.85,
    )
    return clean, contended


def a2a_divergence_workload() -> WorkloadSpec:
    """The canonical MoE config whose winning spec flips between
    AllReduce-proxy pricing and the A2A-aware ``CalibrationProfile`` —
    shared by ``benchmarks/planner_bench.py`` and the backend-contract
    tests.

    seq 2500 caps SP at 4, so TP*SP cannot soak up chips and EP carries a
    large dispatch volume (topk=8 of 16 experts, wide hidden, small dense
    params keep compute from masking it).  Priced on the AllReduce proxy
    the A2A is nearly free and the planner maxes out expert parallelism
    (ep=16, dp=128); priced on the measured A2A bandwidth (~3x lower:
    relay hops + incast) the same search retreats to ep=4 and buys
    pipeline stages instead — the Rail-only / "99 Problems" observation
    that topology-cost conclusions flip when A2A-shaped traffic is priced
    with its real contention pattern.
    """
    return WorkloadSpec(
        "moe-a2a-div", 32, 12288, 96, 128, 8,
        seq_len=2500, global_batch=512, params_total=8e10,
        n_experts=16, topk=8, moe_param_frac=0.9,
    )


def moe_2t_workload() -> tuple[WorkloadSpec, ParallelSpec]:
    """An MoE-2T-like setup calibrated to reproduce Table 1's locality."""
    w = WorkloadSpec(
        name="MoE-2T",
        n_layers=96,
        hidden=12288,
        n_heads=96,
        head_dim=128,
        n_kv_heads=8,
        seq_len=131072,
        global_batch=104,          # 13 sequences per replica => 13 microbatches
        params_total=2e12,
        n_experts=16,
        topk=2,
        moe_param_frac=0.8,
    )
    p = ParallelSpec(tp=8, sp=8, pp=8, dp=8, ep=8, microbatches=13, grad_buckets=64)
    return w, p
