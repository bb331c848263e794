"""Train and serve step builders — port of ``repro/train/train_step.py``
(``StepBundle``, ``build_train_step``, ``build_serve_step``,
``build_bundle``, ``lower_bundle``).

A bundle carries the step's ``fn``, the partition specs of its inputs and
outputs (``in_pspecs`` / ``out_pspecs``, from the harness's logical axes and
the topology-aware rules of ``parallel/sharding.py``; the optimizer state
under the ZeRO-1 specs), their placements on the ``DeviceMesh``
(``in_shardings`` / ``out_shardings``: for each leaf a list of
``Shard(dim)`` / ``Replicate()``, one a mesh dim) and ``abstract_args``, the
arguments' global shapes and types as tensors on the ``meta`` device.

The reference hands ``fn`` to ``jit`` and XLA inserts the collectives.  The
port runs eagerly on each rank, so ``fn`` takes the rank's own tensors (its
block of each argument under ``in_pspecs``) and does the collectives
itself, every sum of them through ``ccu_reduce`` (its plain version on the
plain path, ``use_kernels=False``), in the reference's order
(``train_step``, ``:81-86``):

1. the loss and the gradients on the rank's share of the batch.  Where the
   mesh's "model" axis has more than one rank the rank holds the model
   shard of each weight the rules shard on "model" (``sp``, ``qkv``,
   ``kv``, ``ff``, ``table_embed``, ``vocab``, ``experts``, ``rkv``,
   ``ssm_proj``, ``ssm_inner``) and, where the rules cut the sequence
   (``sp``: every family but the SSM one), the positions ``[r·S/m,
   (r+1)·S/m)`` of its sequences: the layers gather each weight but the
   MoE experts and the keys and values over "model" before use
   (``parallel.collectives.ModelAxis``, ``models/transformer.py``,
   ``encdec.py``, ``hybrid.py``; the MoE layer keeps its experts cut,
   ``models/moe.py``; a Mamba2 layer gathers x along the sequence and runs
   its scan on the rank's heads, ``models/mamba2.py``); the SSM family,
   whose sequence the rules never cut, runs the axis tensor-parallel over
   its heads (``models/rwkv6.py``), its loss the rank's disjoint share of
   the positions.  Each gather's backward is a reduce-scatter, so a sharded
   leaf's gradient comes out summed over the model ranks.  The gradients
   of the leaves replicated on "model" (the norms, ``bo``, ``b_out``, the
   router, RWKV-6's ``mu``/``w0``/``bonus_u``, Mamba2's per-head leaves)
   and the ranks' losses are summed over "model" here, in one
   ``ccu_reduce``: each rank's are its part (a rank uses only its slice of
   a replicated leaf sliced to its heads).  A leaf the rules cut over "data" (the MoE
   experts' ``moe_fsdp``) is gathered over it before use
   (``Runtime.fsdp``), so its gradient comes out reduce-scattered over
   "data" already; an MoE model's auxiliary loss takes its means over every
   rank's tokens (``Runtime.tokens``);
2. the gradients summed over the data-parallel ranks by
   ``hierarchical_allreduce`` (fast axis "data", slow axis "pod" where the
   mesh has one; every sum in ``ccu_reduce``), each leaf over the DP axes
   that do not cut it, divided by the DP size (the loss is a mean over the
   local batch; the sizes here are powers of two, so the division is exact)
   and rounded once to the gradient's type;
3. ``compress_grads`` on the synchronised gradient, leaf by leaf, its
   payload cast to ``grad_dtype`` as AdamW casts it.  Where a leaf is cut
   over "model" or "data" its scale is the whole leaf's: the max of
   ``|g + r|`` over the ranks that hold its blocks;
4. AdamW on the rank's ZeRO-1 shard of master/m/v only (``update_leaf`` on
   the block that ``tree_zero1_pspecs`` gives it, within the rank's block of
   the param), with the global norm of the whole synchronised gradient
   (``step_scalars``; where a leaf is cut, from each leaf's sum of squares,
   summed in ``ccu_reduce`` over the ranks that hold its blocks, and counted
   once where it is not), which is the same on every rank, so each shard
   ends as ``adamw.apply`` with that norm would leave that block, bit for
   bit;
5. the updated params (the masters' blocks rounded to the params' type)
   all-gathered over the DP axes that the ZeRO-1 spec adds to the param's
   (a leaf already cut over "data" keeps its block).

Axes other than "pod", "data" and "model" must have size 1.  The int8
error-feedback residual is carried (ROADMAP C2: the reference's step drops
it): ``fn`` takes it and returns the new one.  ``metrics["loss"]`` is the
mean over the rank's data-parallel share of the batch (on the model axis
the sum of the model ranks' parts).  ``fn.wire_bytes`` counts the operand
bytes of its collectives by mesh axis (``parallel/collectives.py``;
``collectives.recording`` lists them one by one where a caller asks).
The parts of a step are marked for ``torch.profiler`` as ``train.grad``
(with ``model.gather`` and ``model.reduce_scatter`` inside it),
``train.model_sum``, ``train.sync``, ``train.compress``, ``train.adamw``
and ``train.gather``.

``build_serve_step`` runs prefill on the model axis the same way (each rank
writes the gathered keys and values of the positions its block of the cache
holds, the rules' ``cache_seq``: a prompt shorter than the cache fills the
first blocks; a recurrent layer keeps the state block of its heads, its
replicated tails the same bits on every rank; whisper's encoder output is
gathered whole into every rank's cache) and decode tensor-parallel
(``models/layers.py``: every rank attends over its block of the cache, the
blocks' outputs combined by their log-sum-exps; whisper's cross-attention
over the rank's columns of every frame, split heads' partial scores summed
over their run of ranks; a Mamba2 layer's ``in_proj`` product gathered;
no weight gathered over "model").

``lower_bundle`` is the dry-run's entry point (the reference's
``jit(...).lower``): it runs ``fn`` once, as this rank, on its blocks of
``abstract_args`` on the ``meta`` device, over the fake process group that
``launch/mesh.fake_mesh`` makes, and returns what the reference reads from
the compiled program: the collectives, the FLOPs, the bytes and the memory
(its docstring).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch
from torch.profiler import record_function

from ..kernels import ops
from ..kernels.ccu_reduce import ccu_reduce_plain
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
from ..parallel.collectives import (
    AxisGroup,
    ModelAxis,
    Transport,
    hierarchical_allreduce,
    operand_bytes_by_axis,
    recording,
)
from ..parallel.sharding import (
    DATA_AXIS,
    MODEL_AXIS,
    POD_AXIS,
    local_slices,
    rules_for_cell,
    shard_slices,
    tree_zero1_pspecs,
)


@dataclass
class StepBundle:
    """Everything needed to run and lower one (arch x shape x mesh) cell.
    ``init_opt_state`` (train bundles) makes this rank's ZeRO-1 optimizer
    state from its params.  ``in_shardings`` / ``out_shardings`` are the
    partition specs' placements on the mesh, made when read (DTensor's
    module is not imported by a step)."""

    fn: Callable
    in_pspecs: tuple
    out_pspecs: tuple
    mesh_dim_names: tuple
    abstract_args: tuple
    donate_argnums: tuple = ()
    init_opt_state: Callable | None = None

    def _placements(self, trees: tuple) -> tuple:
        return tuple(None if t is None else tree_map(lambda p: placements(p, self.mesh_dim_names), t)
                     for t in trees)

    @property
    def in_shardings(self) -> tuple:
        return self._placements(self.in_pspecs)

    @property
    def out_shardings(self) -> tuple:
        return self._placements(self.out_pspecs)


def _like(tree, leaves: list):
    """``leaves`` (in the order ``tree_leaves`` gives) in ``tree``'s shape."""
    by_id = {id(t): x for t, x in zip(tree_leaves(tree), leaves)}
    return tree_map(lambda t: by_id[id(t)], tree)


def _axes(entry) -> tuple:
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def _size(mesh, axis: str) -> int:
    names = tuple(mesh.mesh_dim_names)
    return mesh.size(names.index(axis)) if axis in names else 1


def _model_axis(mesh, rules: ShardingRules, **kw) -> ModelAxis | None:
    """The mesh's "model" axis where it has more than one rank, else None."""
    return ModelAxis(mesh, rules, **kw) if _size(mesh, MODEL_AXIS) > 1 else None


def _fsdp_axis(mesh, rules: ShardingRules, param_ps, **kw) -> AxisGroup | None:
    """The data-parallel axes that the rules cut some parameter over (the
    MoE experts' ``moe_fsdp``: "data"), where they have more than one rank,
    else None."""
    cut = {tuple(_axes(e)) for ps in tree_leaves(param_ps) for e in ps
           if any(a in (POD_AXIS, DATA_AXIS) for a in _axes(e))}
    if not cut:
        return None
    if len(cut) > 1:
        raise ValueError(f"parameters cut over several sets of data-parallel axes: {sorted(cut)}")
    axes = cut.pop()
    return AxisGroup(mesh, rules, axes, **kw) if math.prod(_size(mesh, a) for a in axes) > 1 else None


def build_train_step(
    harness: Harness,
    cell: ShapeCell,
    mesh,
    *,
    multi_pod: bool = False,
    opt_cfg: adamw.OptConfig | None = None,
    compression: CompressionConfig | None = None,
    rules: ShardingRules | None = None,
    use_kernels: bool = True,
) -> StepBundle:
    opt_cfg = opt_cfg or adamw.OptConfig()
    compression = compression or CompressionConfig()
    rules = rules or rules_for_cell(harness, cell, multi_pod=multi_pod)
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
    others = {a: mesh.size(i) for i, a in enumerate(names) if a not in dp_axes + (MODEL_AXIS,)}
    if DATA_AXIS not in dp_axes or any(n != 1 for n in others.values()):
        raise ValueError(f"the train step needs a {DATA_AXIS!r} axis, and every axis but {POD_AXIS!r}, "
                         f"{DATA_AXIS!r} and {MODEL_AXIS!r} of size 1; mesh axes {names}, sizes {others}")
    dp = math.prod(mesh.size(names.index(a)) for a in dp_axes)
    reduce = ops.ccu_reduce if use_kernels else ccu_reduce_plain
    wire: dict[str, int] = {}
    model = _model_axis(mesh, rules, reduce=reduce, wire=wire)
    fsdp = _fsdp_axis(mesh, rules, param_ps, reduce=reduce, wire=wire)
    # the MoE auxiliary loss's means span every rank that holds other tokens
    spread = tuple(a for a in names if a in dp_axes + (MODEL_AXIS,) and _size(mesh, a) > 1)
    tokens = (AxisGroup(mesh, rules, spread, reduce=reduce, wire=wire)
              if getattr(harness.cfg, "moe", None) is not None and spread else None)
    rt = Runtime(use_kernels=use_kernels, model=model, fsdp=fsdp, tokens=tokens)
    loss_and_grad = value_and_grad(harness.loss(rt))
    # each leaf's gradient is summed over the DP axes that do not cut it (a
    # leaf cut over "data", the MoE experts' FSDP, comes out of its gather's
    # reduce-scatter summed over "data" already): one function a set of axes,
    # made by every rank in the same order
    rest = tree_map(lambda ps: tuple(a for a in dp_axes if not any(a in _axes(e) for e in ps)), param_ps)
    def sync_over(axes):                 # fast axis "data", slow axis "pod" where the mesh has one
        fast = DATA_AXIS if DATA_AXIS in axes else axes[0]
        return hierarchical_allreduce(mesh, fast, tuple(a for a in axes if a != fast), reduce=reduce, wire=wire)

    syncs = {axes: sync_over(axes) for axes in sorted(set(tree_leaves(rest)), key=lambda t: (t != dp_axes, t))
             if axes}
    syncs[()] = lambda g: g.float()
    # this rank's block of each param (its model and FSDP shard), and its
    # ZeRO-1 block within that: the ZeRO-1 spec keeps the param spec's axes
    # and adds the DP axes that do not cut the param on another dim, so the
    # one lies inside the other
    local = tree_map(lambda ps, s: shard_slices(ps, s.shape, mesh), param_ps, param_specs)

    def within(block, outer):
        return tuple(slice(b.start - o.start, b.stop - o.start) for b, o in zip(block, outer))

    blocks = tree_map(lambda ps, s, lo: within(shard_slices(ps, s.shape, mesh), lo), zero_ps, param_specs, local)
    # where the ZeRO-1 spec cuts a leaf's block of params further: (tensor
    # dim, the DP axes), or None where it does not and every rank of those
    # axes updates all of its block
    def dp_cut(zs, ps):
        for d, e in enumerate(zs):
            axes = tuple(a for a in _axes(e) if a in dp_axes and not any(a in _axes(f) for f in ps))
            if axes:
                return d, axes
        return None

    cuts = tree_map(dp_cut, zero_ps, param_ps)
    # which leaves the model axis shards (the others' gradients are summed over it)
    on_model = tree_map(lambda ps: model is not None and any(MODEL_AXIS in _axes(e) for e in ps), param_ps)
    # the groups whose ranks hold different blocks of some leaf, and which
    # leaves: a leaf's sum of squares and int8 scale span them
    cutters = [(g, torch.tensor(tree_leaves(tree_map(lambda ps: any(a in _axes(e) for e in ps for a in g.axes),
                                                     param_ps))))
               for g in (model, fsdp) if g is not None]
    # one group a set of cutting axes, made by every rank in the same order
    gathers = {axes: Transport(mesh, axes, wire)
               for axes in sorted({c[1] for c in tree_leaves(cuts) if c is not None})}

    def init_opt_state(params) -> dict:
        with torch.no_grad():
            master = tree_map(lambda p, sl: p[sl].to(torch.float32, copy=True), params, blocks)
            return {"master": master,
                    "m": tree_map(torch.zeros_like, master),
                    "v": tree_map(torch.zeros_like, master),
                    "step": torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)}

    def model_sums(loss, grads):
        """The ranks' losses and the gradients of the leaves replicated on
        the model axis, summed over it in one ``ccu_reduce`` (fp32)."""
        kept = []
        tree_map(lambda g, m: None if m else kept.append(g), grads, on_model)
        flat = torch.cat([loss.reshape(1).float()] + [g.reshape(-1).float() for g in kept])
        summed = model.sum(flat)
        parts = iter(summed[1:].split([g.numel() for g in kept]))
        grads = tree_map(lambda g, m: g if m else next(parts).view(g.shape).to(g.dtype), grads, on_model)
        return summed[0], grads

    def across(values: torch.Tensor, op: str) -> torch.Tensor:
        """Each leaf's value (one a leaf, in leaf order) combined by ``op``
        ("sum" or "max") over every group that cuts the leaf, model first."""
        for g, cut in cutters:
            values = torch.where(cut.to(values.device), getattr(g, op)(values), values)
        return values

    def global_norm(payload) -> torch.Tensor:
        """The norm of the whole tree from the rank's shards: each leaf's sum
        of squares, summed over the ranks that hold other blocks of it, the
        leaves added in order as ``adamw.global_norm`` adds them."""
        sq = torch.stack([torch.sum(torch.square(g.to(torch.float32))) for g in tree_leaves(payload)])
        return torch.sqrt(sum(across(sq, "sum").unbind(0)))

    @torch.no_grad()
    def train_step(params, opt_state, batch, residual=None, observe=None):
        """One ZeRO-1 step on this rank's blocks.  Returns (params, opt_state,
        metrics, residual), the first two updated in place.  ``observe(grads,
        payload)``, if given, sees the rank's blocks of the synchronised
        gradients and of the payload AdamW gets, before the update."""
        with torch.enable_grad(), record_function("train.grad"):
            loss, grads = loss_and_grad(params, batch)
        if model is not None:
            with record_function("train.model_sum"):
                loss, grads = model_sums(loss, grads)
        # 2. sum over the DP ranks, every sum in ccu_reduce; mean; one rounding
        with record_function("train.sync"):
            grads = tree_map(lambda g, axes: (syncs[axes](g) / dp).to(g.dtype), grads, rest)
        # 3. compression of the synchronised gradient, leaf by leaf
        if compression.mode == "int8" and residual is None:
            residual = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)
        with record_function("train.compress"):
            amax = None
            if cutters and compression.mode == "int8":
                # each leaf's scale is the whole leaf's: max |g + r| over the ranks that hold its blocks
                local_max = tree_map(lambda g, r: (g.to(torch.float32) + r if compression.ef
                                                   else g.to(torch.float32)).abs().amax(), grads, residual)
                amax = _like(local_max, across(torch.stack(tree_leaves(local_max)), "max").unbind(0))

            def compress(g, r=None, a=None):
                return compress_grads(compression, g, r, use_kernels=use_kernels,
                                      amax=None if a is None else [a])[0].to(opt_cfg.grad_dtype)

            extra = () if residual is None else (residual,) if amax is None else (residual, amax)
            payload = tree_map(compress, grads, *extra)
        if observe is not None:
            observe(grads, payload)
        del grads
        # 4. AdamW on this rank's shard
        k = adamw.step_scalars(opt_cfg, payload, opt_state, global_norm(payload) if cutters else None)
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

    train_step.wire_bytes = wire        # operand bytes of every collective of the step, by axis

    abstract = (
        tree_abstract(param_specs, dtype=torch.bfloat16),
        tree_abstract(opt_specs),
        tree_abstract(input_specs),
    )
    return StepBundle(
        fn=train_step,
        in_pspecs=(param_ps, opt_ps, input_ps),
        out_pspecs=(param_ps, opt_ps, None),
        mesh_dim_names=tuple(mesh.mesh_dim_names),
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
    use_kernels: bool = True,
) -> StepBundle:
    """Prefill (cell.kind == 'prefill') or decode step bundle.  ``fn`` runs
    the harness's serving call on the rank's own params, state and inputs;
    on a "model" axis of more than one rank every rank returns the same
    logits: prefill the last model rank's (the SSM family's, tensor-parallel,
    gathered over the axis), decode the logits gathered over the axis.  A decode step's
    ``inputs["pos"]`` is read from its tensor; on ``meta`` (the dry-run,
    ``lower_bundle``), where no tensor can be read, the step writes the
    cell's last position that the cache holds (``decode_position``)."""
    rules = rules or rules_for_cell(harness, cell, multi_pod=multi_pod)
    wire: dict[str, int] = {}
    reduce = ops.ccu_reduce if use_kernels else ccu_reduce_plain
    model = _model_axis(mesh, rules, wire=wire, reduce=reduce)

    param_specs = harness.param_specs()
    state_specs = harness.serve_state_specs(cell)
    input_specs = harness.serve_input_specs(cell)

    param_ps = tree_pspecs(param_specs, rules)
    state_ps = tree_pspecs(state_specs, rules)
    input_ps = tree_pspecs(input_specs, rules)

    fsdp = _fsdp_axis(mesh, rules, param_ps, reduce=reduce, wire=wire)
    rt = Runtime(use_kernels=use_kernels, model=model, fsdp=fsdp)
    inner = harness.prefill(rt) if cell.kind == "prefill" else harness.decode(rt)
    meta_pos = decode_position(harness, cell) if cell.kind == "decode" else None

    def serve_step(params, state, inputs):
        if "pos" in inputs and isinstance(inputs["pos"], torch.Tensor):
            pos = inputs["pos"]
            inputs = {**inputs, "pos": meta_pos if pos.device.type == "meta" else int(pos)}
        logits, new_state = inner(params, state, **inputs)
        return logits, new_state

    serve_step.wire_bytes = wire

    abstract = (
        tree_abstract(param_specs, dtype=torch.bfloat16),
        tree_abstract(state_specs),
        tree_abstract(input_specs),
    )
    return StepBundle(
        fn=serve_step,
        in_pspecs=(param_ps, state_ps, input_ps),
        out_pspecs=(None, state_ps),
        mesh_dim_names=tuple(mesh.mesh_dim_names),
        abstract_args=abstract,
        donate_argnums=(1,),
    )


def decode_position(harness, cell: ShapeCell) -> int:
    """The position a decode cell's step writes where it is traced on
    ``meta``: the cell's last, or the cache's last where the cache is
    shorter (mixtral's ``long_500k``, whose cache the window bounds)."""
    state = harness.serve_state_specs(cell)
    cache = state.get("k") if isinstance(state, dict) else None         # a transformer's (L, B, S, K, Dh)
    held = cache.shape[2] if cache is not None and len(cache.shape) == 5 else cell.seq_len
    return min(cell.seq_len, held) - 1


def build_bundle(harness, cell: ShapeCell, mesh, *, multi_pod: bool, use_kernels: bool = True,
                 **kw) -> StepBundle:
    if cell.kind == "train":
        return build_train_step(harness, cell, mesh, multi_pod=multi_pod, use_kernels=use_kernels, **kw)
    return build_serve_step(harness, cell, mesh, multi_pod=multi_pod, use_kernels=use_kernels)


# ---------------------------------------------------------------------------
# lower_bundle: the dry-run's entry point
# ---------------------------------------------------------------------------

# aten ops that read or write no tensor data: views are skipped by their schema
_NO_DATA = {"empty", "empty_strided", "new_empty", "new_empty_strided", "detach", "alias", "lift_fresh",
            "_local_scalar_dense", "set_", "resize_"}


def _operand_bytes_mode():
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class OperandBytes(TorchDispatchMode):
        """Bytes of each aten op's tensor operands and results, summed over
        the ops: every op counted alone (no fusion), so an upper bound on
        what the step reads and writes; views and ops that move no data are
        skipped."""

        total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.namespace == "aten" and not func.is_view and func._opname not in _NO_DATA:
                flat = tree_flatten((args, kwargs or {}))[0] + tree_flatten(out)[0]
                self.total += sum(t.numel() * t.element_size() for t in flat if isinstance(t, torch.Tensor))
            return out

    return OperandBytes()


def lower_bundle(bundle: StepBundle, mesh) -> dict:
    """Run ``bundle.fn`` once as this rank of ``mesh`` on its blocks of
    ``bundle.abstract_args`` (``local_slices`` of ``in_pspecs``), as tensors
    on the ``meta`` device, over a fake process group (``launch/mesh.
    fake_mesh``): nothing is allocated, computed or sent.  The bundle must be
    built with ``use_kernels=False``: no kernel launches on ``meta``, so the
    plain path is traced (attention materialises its scores).  Returns

    * ``records``: the collectives ``(kind, result bytes, group size, axes)``
      as the step's transports issued them (``collectives.recording``), and
      ``operand_bytes_by_axis`` reckoned from them alone;
      ``c10d_ops``, the collectives ``CommDebugMode`` saw reach the process
      group (equal to the records' count unless one bypassed the transport);
    * ``flops``: ``FlopCounterMode``'s count (products, forward and backward);
    * ``hbm_bytes``: each aten op's operand and result bytes summed
      (unfused: an upper bound, standing in for XLA's "bytes accessed");
    * ``memory``: ``argument_bytes`` (this rank's blocks of the arguments),
      ``output_bytes`` (of everything returned), ``alias_bytes`` (of the
      outputs that are arguments, updated in place), ``temp_bytes`` and
      ``peak_bytes`` = arguments + the peak of the tensors the step
      allocates, as ``MemTracker`` follows them (``temp_bytes`` is that peak
      less the outputs it holds, so that peak = arguments + outputs + temp -
      alias, the reference's reckoning).  The arguments live throughout; the
      plain attention's scores make the peak an upper bound there.
    """
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils.flop_counter import FlopCounterMode

    names = tuple(mesh.mesh_dim_names)
    sizes = {a: mesh.size(i) for i, a in enumerate(names)}
    coord = dict(zip(names, mesh.get_coordinate()))

    def block(t, ps):
        shape = tuple(sl.stop - sl.start for sl in local_slices(ps, tuple(t.shape), sizes, coord))
        return torch.empty(shape, dtype=t.dtype, device="meta")

    args = tuple(tree_map(block, a, ps) for a, ps in zip(bundle.abstract_args, bundle.in_pspecs))

    def tensors(tree) -> list:
        if isinstance(tree, (tuple, list)):
            return [t for x in tree for t in tensors(x)]
        return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]

    hbm, mem = _operand_bytes_mode(), MemTracker()
    with recording() as records, CommDebugMode() as comm, FlopCounterMode(display=False) as flops, hbm, mem:
        out = bundle.fn(*args)
    arg_ids = {id(t) for t in tensors(args)}
    outs = tensors(out)
    argument = sum(t.numel() * t.element_size() for t in tensors(args))
    output = sum(t.numel() * t.element_size() for t in outs)
    alias = sum(t.numel() * t.element_size() for t in outs if id(t) in arg_ids)
    peak_new = sum(v["Total"] for v in mem.get_tracker_snapshot("peak").values())
    return {
        "records": records,
        "operand_bytes_by_axis": operand_bytes_by_axis(records),
        "c10d_ops": comm.get_total_counts(),
        "flops": flops.get_total_flops(),
        "hbm_bytes": hbm.total,
        "memory": {"argument_bytes": argument, "output_bytes": output, "alias_bytes": alias,
                   "temp_bytes": peak_new - (output - alias), "peak_bytes": argument + peak_new},
    }
