"""Sharding rules — port of ``repro/parallel/sharding.py`` (``make_rules``,
``rules_for_cell``, ``zero1_pspec``, ``tree_zero1_pspecs``): UB-Mesh's
topology-aware logical-axis -> mesh-axis maps, index arithmetic ported as it
is.

The production mesh is ("data", "model") = (16, 16) per pod, plus a leading
"pod" axis (2) for multi-pod.  "model" = the intra-rack high-bandwidth
2D-FullMesh domain carries the TP/SP-class traffic; "data" (+ "pod") = the
inter-rack mesh / HRS Clos tier carries the DP-class traffic: batch dim,
ZeRO-1 optimizer shards, FSDP dims of the 100B+ experts (paper §5.2).
``ShardingRules.pspec`` drops an axis already used by an earlier tensor dim,
so one rule set adapts between train and decode.

``rules_for_cell`` and ``zero1_pspec`` keep the reference's production DP
sizes (16, 32 with pods): a smaller mesh passes its rules explicitly and
the specs stay those of production.  New here: ``shard_slices``, the rank's
local block of a tensor under a spec, cut with the mesh's actual sizes (the
ZeRO-1 shard of a leaf), and ``Placement``, a mesh and a pspec: the port's
form of the reference's ``NamedSharding`` (``CheckpointManager.restore``'s
``shardings``).
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

from ..models.param import ParamSpec, ShardingRules, tree_map

MODEL_AXIS = "model"
DATA_AXIS = "data"
POD_AXIS = "pod"


def make_rules(
    *,
    multi_pod: bool = False,
    sp: bool = True,                 # sequence-parallel activations (train)
    batch_shardable: bool = True,    # False for global_batch=1 cells
    moe_strategy: str | None = None,
    extra: dict | None = None,
) -> ShardingRules:
    dp = (POD_AXIS, DATA_AXIS) if multi_pod else (DATA_AXIS,)
    rules: dict = {
        # activations
        "batch": dp if batch_shardable else None,
        "sp": MODEL_AXIS if sp else None,
        "ff_act": MODEL_AXIS,
        "cache_seq": MODEL_AXIS,
        "ssm_heads": MODEL_AXIS,
        # weights (all these dims divide 16 for every zoo arch)
        "qkv": MODEL_AXIS,
        "kv": MODEL_AXIS,
        "ff": MODEL_AXIS,
        "rkv": MODEL_AXIS,
        "ssm_proj": MODEL_AXIS,
        "ssm_inner": MODEL_AXIS,
        "table_embed": MODEL_AXIS,
        "vocab": MODEL_AXIS,
        "embed_in": None,
        "layers": None,
    }
    if moe_strategy == "expert_parallel":
        rules.update(
            experts=MODEL_AXIS,
            experts_act=MODEL_AXIS,
            moe_fsdp=DATA_AXIS,
            moe_ff_act=None,
            moe_d_act=MODEL_AXIS,
        )
    elif moe_strategy == "expert_tp":
        rules.update(
            experts=None,
            experts_act=None,
            moe_fsdp=DATA_AXIS,
            moe_ff_act=MODEL_AXIS,
            moe_d_act=MODEL_AXIS,
        )
    if extra:
        rules.update(extra)
    return ShardingRules(rules=rules)


def rules_for_cell(harness, cell, *, multi_pod: bool) -> ShardingRules:
    """Pick the per-(arch x shape) rule set the dry-run/train/serve use."""
    dp_size = 32 if multi_pod else 16
    batch_ok = cell.global_batch % dp_size == 0 and cell.global_batch >= dp_size
    return make_rules(
        multi_pod=multi_pod,
        sp=cell.kind != "decode",
        batch_shardable=batch_ok,
        moe_strategy=harness.moe_strategy,
    )


# ---------------------------------------------------------------------------
# ZeRO-1: optimizer-state sharding over the DP axes
# ---------------------------------------------------------------------------


def zero1_pspec(spec: ParamSpec, rules: ShardingRules, dp_size: int) -> tuple:
    """Param pspec + the DP axes added on the first free, divisible dim.

    This is the ZeRO-1 partitioning of fp32 master/moment tensors: model-
    sharded dims stay, and one replicated dim additionally shards over
    ("pod","data").  Falls back to the plain param spec when nothing divides.
    """
    base = rules.pspec(spec.logical)
    entries = list(base) + [None] * (len(spec.shape) - len(base))
    used = {a for e in entries if e for a in ((e,) if isinstance(e, str) else e)}
    dp_axes = tuple(
        a for a in ((POD_AXIS, DATA_AXIS) if dp_size > 16 else (DATA_AXIS,))
        if a not in used
    )
    if not dp_axes:
        return base
    dp_total = math.prod([dp_size // 16 if a == POD_AXIS else 16 for a in dp_axes])
    # skip the scanned-layers dim (dim 0 when logical starts with "layers")
    start = 1 if spec.logical and spec.logical[0] == "layers" else 0
    for i in range(start, len(spec.shape)):
        if entries[i] is None and spec.shape[i] % dp_total == 0 and spec.shape[i] > 0:
            entries[i] = dp_axes if len(dp_axes) > 1 else dp_axes[0]
            break
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def tree_zero1_pspecs(spec_tree, rules: ShardingRules, dp_size: int):
    return tree_map(lambda s: zero1_pspec(s, rules, dp_size), spec_tree)


def local_slices(pspec: tuple, shape: tuple[int, ...], sizes: dict[str, int],
                 coord: dict[str, int]) -> tuple[slice, ...]:
    """The block of a ``shape`` tensor that the device at ``coord`` (mesh
    axis -> index) holds under ``pspec`` on a mesh of ``sizes`` (axis ->
    size): each sharded dim cut into equal parts, the first axis of a tuple
    the major one, as ``NamedSharding.devices_indices_map`` cuts it."""
    out = []
    for dim, n in enumerate(shape):
        entry = pspec[dim] if dim < len(pspec) else None
        if entry is None:
            out.append(slice(0, n))
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        parts, index = 1, 0
        for a in names:
            parts, index = parts * sizes[a], index * sizes[a] + coord[a]
        if n % parts:
            raise ValueError(f"dim {dim} of {shape} does not divide into {parts} parts under {pspec}")
        step = n // parts
        out.append(slice(index * step, (index + 1) * step))
    return tuple(out)


def shard_slices(pspec: tuple, shape: tuple[int, ...], mesh) -> tuple[slice, ...]:
    """``local_slices`` for this rank of ``mesh`` (a ``DeviceMesh``)."""
    names = tuple(mesh.mesh_dim_names)
    sizes = {a: mesh.size(i) for i, a in enumerate(names)}
    coord = dict(zip(names, mesh.get_coordinate()))
    return local_slices(pspec, shape, sizes, coord)


class Placement(NamedTuple):
    """A ``DeviceMesh`` and a pspec tuple: the port's form of the reference's
    ``NamedSharding(mesh, PartitionSpec(*pspec))``."""
    mesh: Any
    pspec: tuple
