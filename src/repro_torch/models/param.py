"""Parameter trees — port of ``repro/models/param.py``.

A model describes its parameters as a nested dict of :class:`ParamSpec`
(shape + init + logical axis names).  From one spec tree the port derives
materialized tensors (``tree_init``) and parameter counts; weights made by
the reference cross over by value through ``from_reference``.

Ported: ``ParamSpec``, ``is_spec``, ``tree_init`` / ``_init_leaf``,
``param_count``, ``param_bytes``, ``stack_specs``, ``round_up``,
``cast_floats``.  New here: ``tree_map`` / ``tree_leaves`` (the small part of
``jax.tree`` the port needs), ``value_and_grad`` (the part of
``jax.value_and_grad`` it needs) and ``from_reference``.  ``ShardingRules``,
``tree_pspecs`` and ``tree_abstract`` belong to the distribution slice.

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
    ``torch.autograd`` (each in its leaf's type).  The leaves are made to
    require grad on a detached alias; the caller's tensors are not touched."""

    def run(params, *args):
        params = tree_map(lambda t: t.detach().requires_grad_(), params)
        leaves = tree_leaves(params)
        with torch.enable_grad():
            value = fn(params, *args)
        grads = iter(torch.autograd.grad(value, leaves))
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
