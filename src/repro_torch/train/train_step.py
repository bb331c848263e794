"""Train and serve step builders — port of ``repro/train/train_step.py``
(``StepBundle``, ``build_train_step``, ``build_serve_step``,
``build_bundle``).

A bundle carries the step's ``fn``, the placements of its inputs and outputs
on the ``DeviceMesh`` (``in_shardings`` / ``out_shardings``: for each leaf a
list of ``Shard(dim)`` / ``Replicate()``, one a mesh dim, from the
harness's logical axes and the topology-aware rules of
``parallel/sharding.py``; the optimizer state under the ZeRO-1 specs) and
``abstract_args``, the arguments' global shapes and types as tensors on the
``meta`` device.  The reference's ``lower_bundle`` (the dry-run's entry
point) comes with the dry-run (ROADMAP A11).

The reference hands ``fn`` to ``jit`` and XLA inserts the collectives.  The
port runs eagerly on each rank, so ``fn`` takes the rank's own tensors and
does the data-parallel step itself, in the reference's order
(``train_step``, ``:81-86``):

1. the loss and the gradients on the rank's share of the batch;
2. the gradients summed over the data-parallel ranks by
   ``hierarchical_allreduce`` (fast axis "data", slow axis "pod" where the
   mesh has one; every sum in ``ccu_reduce``), divided by the DP size (the
   loss is a mean over the local batch; the sizes here are powers of two, so
   the division is exact) and rounded once to the gradient's type;
3. ``compress_grads`` on the full synchronised gradient, leaf by leaf, its
   payload cast to ``grad_dtype`` as AdamW casts it;
4. AdamW on the rank's ZeRO-1 shard of master/m/v only (``update_leaf`` on
   the block that ``tree_zero1_pspecs`` gives it), with the global norm of
   the whole synchronised gradient (``step_scalars``), which is the same on
   every rank, so each shard ends bit for bit as ``adamw.apply`` would leave
   that block;
5. the updated params (the masters' blocks rounded to the params' type)
   all-gathered over the DP group into every rank's full params.

The step is data-parallel: every mesh axis but "pod" and "data" must have
size 1 (tensor parallelism is not ported).  The int8 error-feedback residual
is carried (ROADMAP C2: the reference's step drops it): ``fn`` takes it and
returns the new one.  ``metrics["loss"]`` is the rank's own loss, the mean
over its share of the batch.  ``fn.wire_bytes`` counts the operand bytes of
its collectives by mesh axis (``parallel/collectives.py``).  The parts of a
step are marked for ``torch.profiler`` as ``train.grad``, ``train.sync``,
``train.compress``, ``train.adamw`` and ``train.gather``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch.profiler import record_function

from ..models.api import Harness, ShapeCell
from ..models.layers import Runtime
from ..models.param import (
    ShardingRules,
    placements,
    tree_abstract,
    tree_leaves,
    tree_map,
    tree_pspecs,
    value_and_grad,
)
from ..optim import adamw
from ..optim.compression import CompressionConfig, compress_grads
from ..parallel.collectives import Transport, hierarchical_allreduce
from ..parallel.sharding import DATA_AXIS, POD_AXIS, rules_for_cell, shard_slices, tree_zero1_pspecs


@dataclass
class StepBundle:
    """Everything needed to run (and, with A11, lower) one (arch x shape x
    mesh) cell.  ``init_opt_state`` (train bundles) makes this rank's ZeRO-1
    optimizer state from its full params."""

    fn: Callable
    in_shardings: Any
    out_shardings: Any
    abstract_args: tuple
    donate_argnums: tuple = ()
    init_opt_state: Callable | None = None


def _shardings(mesh, pspec_tree):
    names = tuple(mesh.mesh_dim_names)
    return tree_map(lambda p: placements(p, names), pspec_tree)


def build_train_step(
    harness: Harness,
    cell: ShapeCell,
    mesh,
    *,
    multi_pod: bool = False,
    opt_cfg: adamw.OptConfig | None = None,
    compression: CompressionConfig | None = None,
    rules: ShardingRules | None = None,
) -> StepBundle:
    opt_cfg = opt_cfg or adamw.OptConfig()
    compression = compression or CompressionConfig()
    rules = rules or rules_for_cell(harness, cell, multi_pod=multi_pod)
    # each rank's activations are its own local tensors: no sharding
    # constraint to hand a compiler, so the layers run without rules
    rt = Runtime()
    loss_and_grad = value_and_grad(harness.loss(rt))
    dp_size = 32 if multi_pod else 16

    param_specs = harness.param_specs()
    opt_specs = adamw.opt_state_specs(param_specs)
    input_specs = harness.train_input_specs(cell)

    param_ps = tree_pspecs(param_specs, rules)
    zero_ps = tree_zero1_pspecs(param_specs, rules, dp_size)
    opt_ps = {"master": zero_ps, "m": zero_ps, "v": zero_ps, "step": ()}
    input_ps = tree_pspecs(input_specs, rules)

    names = tuple(mesh.mesh_dim_names)
    dp_axes = tuple(a for a in names if a in (POD_AXIS, DATA_AXIS))
    others = {a: mesh.size(i) for i, a in enumerate(names) if a not in dp_axes}
    if DATA_AXIS not in dp_axes or any(n != 1 for n in others.values()):
        raise ValueError(f"the train step is data-parallel: it needs a {DATA_AXIS!r} axis and every other "
                         f"axis but {POD_AXIS!r} of size 1; mesh axes {names}, sizes {others}")
    dp = math.prod(mesh.size(names.index(a)) for a in dp_axes)
    sync = hierarchical_allreduce(mesh, DATA_AXIS, tuple(a for a in dp_axes if a != DATA_AXIS))
    # this rank's block of each leaf under its ZeRO-1 spec, and where it was
    # cut: (tensor dim, the DP axes cutting it), or None where no DP axis
    # cuts the leaf and every rank updates all of it
    blocks = tree_map(lambda ps, s: shard_slices(ps, s.shape, mesh), zero_ps, param_specs)

    def dp_cut(ps):
        for d, e in enumerate(ps):
            axes = tuple(a for a in ((e,) if isinstance(e, str) else e or ()) if a in dp_axes)
            if axes:
                return d, axes
        return None

    cuts = tree_map(dp_cut, zero_ps)
    # one group a set of cutting axes, made by every rank in the same order
    gathers = {axes: Transport(mesh, axes, sync.wire_bytes)
               for axes in sorted({c[1] for c in tree_leaves(cuts) if c is not None})}

    def init_opt_state(params) -> dict:
        with torch.no_grad():
            master = tree_map(lambda p, sl: p[sl].to(torch.float32, copy=True), params, blocks)
            return {"master": master,
                    "m": tree_map(torch.zeros_like, master),
                    "v": tree_map(torch.zeros_like, master),
                    "step": torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)}

    @torch.no_grad()
    def train_step(params, opt_state, batch, residual=None, observe=None):
        """One data-parallel ZeRO-1 step on this rank's share of the batch.
        Returns (params, opt_state, metrics, residual), the first two updated
        in place.  ``observe(grads, payload)``, if given, sees the
        synchronised gradients and the payload AdamW gets, before the update."""
        with torch.enable_grad(), record_function("train.grad"):
            loss, grads = loss_and_grad(params, batch)
        # 2. sum over the DP ranks, every sum in ccu_reduce; mean; one rounding
        with record_function("train.sync"):
            grads = tree_map(lambda g: (sync(g) / dp).to(g.dtype), grads)
        # 3. compression of the whole synchronised gradient, leaf by leaf
        if compression.mode == "int8" and residual is None:
            residual = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)

        def compress(g, r=None):
            return compress_grads(compression, g, r, use_kernels=rt.use_kernels)[0].to(opt_cfg.grad_dtype)

        with record_function("train.compress"):
            payload = tree_map(compress, grads) if residual is None else tree_map(compress, grads, residual)
        if observe is not None:
            observe(grads, payload)
        del grads
        # 4. AdamW on this rank's shard
        k = adamw.step_scalars(opt_cfg, payload, opt_state)
        flat = zip(tree_leaves(payload), tree_leaves(opt_state["m"]), tree_leaves(opt_state["v"]),
                   tree_leaves(opt_state["master"]), tree_leaves(params), tree_leaves(blocks),
                   tree_leaves(cuts))
        for g, m, v, master, p, sl, cut in flat:
            with record_function("train.adamw"):
                adamw.update_leaf(opt_cfg, k, g[sl], m, v, master)
            if cut is None:
                p.copy_(master)
                continue
            # 5. the updated blocks gathered over the DP ranks that cut them
            with record_function("train.gather"):
                dim, axes = cut
                p.copy_(torch.cat(gathers[axes].all_gather(master.to(p.dtype)).unbind(0), dim=dim))
        opt_state["step"] = k["step"]
        return params, opt_state, {"loss": loss, "grad_norm": k["gnorm"], "lr": k["lr"]}, residual

    train_step.wire_bytes = sync.wire_bytes     # the sync's and the params' gathers, by axis

    abstract = (
        tree_abstract(param_specs, dtype=torch.bfloat16),
        tree_abstract(opt_specs),
        tree_abstract(input_specs),
    )
    in_sh = (_shardings(mesh, param_ps), _shardings(mesh, opt_ps), _shardings(mesh, input_ps))
    out_sh = (_shardings(mesh, param_ps), _shardings(mesh, opt_ps), None)
    return StepBundle(
        fn=train_step,
        in_shardings=in_sh,
        out_shardings=out_sh,
        abstract_args=abstract,
        donate_argnums=(0, 1),
        init_opt_state=init_opt_state,
    )


def build_serve_step(
    harness: Harness,
    cell: ShapeCell,
    mesh,
    *,
    multi_pod: bool = False,
    rules: ShardingRules | None = None,
) -> StepBundle:
    """Prefill (cell.kind == 'prefill') or decode step bundle.  ``fn`` runs
    the harness's serving call on the rank's own params, state and inputs."""
    rules = rules or rules_for_cell(harness, cell, multi_pod=multi_pod)
    rt = Runtime()

    param_specs = harness.param_specs()
    state_specs = harness.serve_state_specs(cell)
    input_specs = harness.serve_input_specs(cell)

    param_ps = tree_pspecs(param_specs, rules)
    state_ps = tree_pspecs(state_specs, rules)
    input_ps = tree_pspecs(input_specs, rules)

    inner = harness.prefill(rt) if cell.kind == "prefill" else harness.decode(rt)

    def serve_step(params, state, inputs):
        logits, new_state = inner(params, state, **inputs)
        return logits, new_state

    abstract = (
        tree_abstract(param_specs, dtype=torch.bfloat16),
        tree_abstract(state_specs),
        tree_abstract(input_specs),
    )
    in_sh = (_shardings(mesh, param_ps), _shardings(mesh, state_ps), _shardings(mesh, input_ps))
    out_sh = (None, _shardings(mesh, state_ps))
    return StepBundle(
        fn=serve_step,
        in_shardings=in_sh,
        out_shardings=out_sh,
        abstract_args=abstract,
        donate_argnums=(1,),
    )


def build_bundle(harness, cell: ShapeCell, mesh, *, multi_pod: bool, **kw) -> StepBundle:
    if cell.kind == "train":
        return build_train_step(harness, cell, mesh, multi_pod=multi_pod, **kw)
    return build_serve_step(harness, cell, mesh, multi_pod=multi_pod)
