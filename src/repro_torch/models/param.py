"""Parameter trees — port of ``repro/models/param.py``.

A model describes its parameters as a nested dict of :class:`ParamSpec`
(shape + init + logical axis names).  From one spec tree the port derives
materialized tensors (``tree_init``) and parameter counts; weights made by
the reference cross over by value through ``from_reference``.

Ported: ``ParamSpec``, ``is_spec``, ``tree_init`` / ``_init_leaf``,
``tree_abstract`` (tensors on the ``meta`` device), ``ShardingRules`` /
``pspec``, ``tree_pspecs``, ``tree_shardings``, ``param_count``,
``param_bytes``, ``stack_specs``, ``round_up``, ``cast_floats``,
``virtual_kv_heads``.  New here: ``tree_map`` / ``tree_leaves`` (the small
part of ``jax.tree`` the port needs), ``value_and_grad`` (the part of
``jax.value_and_grad`` it needs) and ``from_reference``.

A partition spec is a tuple with one entry a tensor dim: None, a mesh-axis
name, or a tuple of names (the first the major one), the trailing Nones
popped, as the reference's ``PartitionSpec`` holds them (``tuple(P(...))``
is the port's spec).  ``tree_shardings`` turns a spec into the placements of
a ``DeviceMesh`` (``Shard(dim)`` / ``Replicate()``, one a mesh dim).

Trees are nested dicts; leaves are flattened in sorted-key order, as
``jax.tree`` flattens dicts, so a reference tree and its port line up.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

PyTree = Any


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    logical: tuple[str | None, ...]
    init: str = "normal"          # normal | zeros | ones | scaled
    scale: float = 0.02
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """Apply ``fn`` to every leaf (anything that is not a dict)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree: PyTree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def value_and_grad(fn: Callable) -> Callable:
    """``fn(params, *args) -> scalar`` becomes ``(params, *args) -> (value,
    grads)``, ``grads`` a tree like ``params`` of the gradients by
    ``torch.autograd`` (each in its leaf's type; zeros for a leaf the value
    does not use, as ``jax.value_and_grad`` gives, e.g. the hybrid's shared
    block at a depth that never calls it).  The leaves are made to require
    grad on a detached alias; the caller's tensors are not touched."""

    def run(params, *args):
        params = tree_map(lambda t: t.detach().requires_grad_(), params)
        leaves = tree_leaves(params)
        with torch.enable_grad():
            value = fn(params, *args)
        grads = iter(torch.autograd.grad(value, leaves, allow_unused=True, materialize_grads=True))
        by_id = {id(t): next(grads) for t in leaves}
        return value.detach(), tree_map(lambda t: by_id[id(t)], params)

    return run


def _init_leaf(
    spec: ParamSpec, generator: torch.Generator, dtype, device
) -> torch.Tensor:
    dtype = dtype if dtype is not None and spec.dtype.is_floating_point else spec.dtype
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init == "scaled":
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = 1.0 / math.sqrt(fan_in)
    else:
        std = spec.scale

    def draw(shape):
        x = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return (x * std).to(dtype)

    if spec.logical and spec.logical[0] == "layers":
        # a stacked leaf is drawn layer by layer: the float32 draw of a whole
        # stack can be several times the size of the low-precision result
        out = torch.empty(spec.shape, dtype=dtype, device=device)
        for i in range(spec.shape[0]):
            out[i] = draw(spec.shape[1:])
        return out
    return draw(spec.shape)


def tree_abstract(spec_tree: PyTree, dtype: torch.dtype | None = None) -> PyTree:
    """Tensors on the ``meta`` device with each spec's shape and type (or
    ``dtype``): the reference's ``ShapeDtypeStruct`` tree, no allocation."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=dtype or s.dtype, device="meta"), spec_tree)


@dataclass(frozen=True)
class ShardingRules:
    """Logical-axis -> mesh-axis mapping.

    ``rules`` maps a logical name to a mesh axis name (or tuple of axes, or
    None).  Unlisted logical names are unsharded.
    """

    rules: dict[str, Any]

    def pspec(self, logical: tuple[str | None, ...]) -> tuple:
        axes: list = []
        used: set[str] = set()
        for name in logical:
            ax = self.rules.get(name) if name else None
            if ax is None:
                axes.append(None)
                continue
            # one mesh axis may shard only one tensor dim
            flat = (ax,) if isinstance(ax, str) else tuple(ax)
            flat = tuple(a for a in flat if a not in used)
            if not flat:
                axes.append(None)
                continue
            used.update(flat)
            axes.append(flat[0] if len(flat) == 1 else flat)
        while axes and axes[-1] is None:
            axes.pop()
        return tuple(axes)


def tree_pspecs(spec_tree: PyTree, rules: ShardingRules) -> PyTree:
    return tree_map(lambda s: rules.pspec(s.logical), spec_tree)


def placements(pspec: tuple, mesh_dim_names: tuple[str, ...]) -> list:
    """The DTensor placements of a partition spec on a mesh with these axis
    names: ``Shard(i)`` on each mesh dim that shards tensor dim i, else
    ``Replicate()``.  DTensor cuts a dim sharded by several mesh dims in the
    mesh's order, so a spec's tuple of axes must list them in that order."""
    from torch.distributed.tensor import Replicate, Shard

    out: list = [Replicate() for _ in mesh_dim_names]
    for dim, entry in enumerate(pspec):
        if entry is None:
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        for a in names:
            if a not in mesh_dim_names:
                raise ValueError(f"spec {pspec} names axis {a!r}, not in the mesh's {mesh_dim_names}")
        idx = [mesh_dim_names.index(a) for a in names]
        if idx != sorted(idx):
            raise ValueError(f"spec {pspec}: axes {names} are not in the mesh's order {mesh_dim_names}")
        for i in idx:
            out[i] = Shard(dim)
    return out


def tree_shardings(spec_tree: PyTree, rules: ShardingRules, mesh) -> PyTree:
    """For each leaf, its placements on ``mesh`` (a ``DeviceMesh``), one a
    mesh dim: the reference's ``NamedSharding`` tree."""
    names = tuple(mesh.mesh_dim_names)
    return tree_map(lambda s: placements(rules.pspec(s.logical), names), spec_tree)


def tree_init(
    spec_tree: PyTree,
    generator: torch.Generator,
    dtype: torch.dtype | None = None,
    device: str | torch.device = "cuda",
) -> PyTree:
    """Materialize a spec tree.  ``generator`` must live on ``device``; float
    leaves are cast to ``dtype`` when given, integer leaves keep theirs."""
    return tree_map(lambda s: _init_leaf(s, generator, dtype, device), spec_tree)


def from_reference(
    numpy_tree: PyTree,
    dtype: torch.dtype | None = None,
    device: str | torch.device = "cuda",
) -> PyTree:
    """Carry a tree of numpy arrays (the reference's weights, exported as
    ``np.asarray(x, np.float32)``) into tensors with the same keys and shapes.

    Float leaves are cast to ``dtype`` when given (float32 -> bfloat16 is the
    rounding the reference applies itself); integer leaves keep their type.
    """

    def conv(x):
        t = torch.from_numpy(np.array(x))      # a copy: the tensor owns its memory
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    return tree_map(conv, numpy_tree)


def param_count(spec_tree: PyTree) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(spec_tree))


def param_bytes(spec_tree: PyTree, bytes_per_elem: int = 2) -> int:
    return param_count(spec_tree) * bytes_per_elem


def stack_specs(spec_tree: PyTree, n_layers: int) -> PyTree:
    """Add a leading layer-stack dim to every ParamSpec in a tree."""
    return tree_map(
        lambda s: ParamSpec(
            (n_layers,) + s.shape,
            ("layers",) + s.logical,
            init=s.init,
            scale=s.scale,
            dtype=s.dtype,
        ),
        spec_tree,
    )


def round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def cast_floats(tree: PyTree, dtype: torch.dtype) -> PyTree:
    """Cast float leaves to the compute dtype; a leaf already of that type is
    returned as it is (no copy)."""

    def cast(x):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.to(dtype)
        return x

    return tree_map(cast, tree)


def virtual_kv_heads(n_kv: int, tp: int = 16) -> int:
    """Replicate KV heads so the kv-head dim divides the model axis."""
    if n_kv % tp == 0:
        return n_kv
    if tp % n_kv == 0:
        return tp
    return round_up(n_kv, tp)
