"""Multi-process helpers of the port's distribution tests: ``spawn`` runs a
target on ``world`` gloo ranks on the CPU and returns each rank's result.

Each rank joins a process group through a ``FileStore`` under the test's
temporary directory (no TCP port, so parallel test workers cannot collide),
with a timeout, so that a rank that hangs fails the test in five minutes.
A rank that raises fails the test: ``torch.multiprocessing.spawn`` re-raises
its exception in the parent and stops the others.  This module imports
torch and the port only: the ranks never load JAX.
"""

from __future__ import annotations

import datetime
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank: int, target, world: int, tmp: str, args: tuple) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        out = target(rank, world, *args)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(target, world: int, tmp, *args) -> list:
    """Run ``target(rank, world, *args)`` on ``world`` ranks; their results,
    by rank."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    mp.spawn(_entry, args=(target, world, tmp, args), nprocs=world, join=True)
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _np(tree):
    from repro_torch.models.param import tree_map

    def conv(t):       # bf16 widens to fp32 exactly: numpy has no bf16
        if not isinstance(t, torch.Tensor):
            return t
        return (t.detach().float() if t.is_floating_point() else t.detach()).numpy().copy()

    return tree_map(conv, tree)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def collectives(rank: int, world: int, shape: tuple, axes: tuple, inputs: dict) -> dict:
    """Every collective on this rank's inputs (``inputs[case][rank]``), with
    the wire bytes of one call each; on the three-axis mesh also the local
    shard of each leaf of ``inputs["specs"]`` under ``tree_shardings``
    (DTensor) and under ``local_slices``."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import collectives as C

    mesh = make_mesh(shape, axes, device_type="cpu")
    out: dict = {}
    if len(axes) == 3:
        hier = C.hierarchical_allreduce(mesh, "model", ("data", "pod"))
        flat = C.flat_allreduce(mesh, ("model", "data", "pod"))
        mp_ = C.multipath_split(mesh, "data", "model")
        h2a = C.hierarchical_all_to_all(mesh, "model", "data")
    else:
        hier = C.hierarchical_allreduce(mesh, axes[0], ())
        flat = C.flat_allreduce(mesh, axes)
        mp_ = h2a = None
    for case in ("equal", "differ", "odd"):
        if case not in inputs:
            continue
        x = torch.from_numpy(inputs[case][rank])
        out[f"hier_{case}"] = hier(x).numpy()
        out[f"flat_{case}"] = flat(x).numpy()
        if mp_ is not None:
            a, b = mp_(x)
            out[f"multipath_{case}"] = (a.numpy(), b.numpy())
            out[f"a2a_{case}"] = h2a(torch.from_numpy(inputs["a2a_" + case][rank])).numpy()
    calls = 3 if "odd" in inputs else 2
    out["wire"] = {name: {a: n // calls for a, n in fn.wire_bytes.items()}
                   for name, fn in (("hier", hier), ("flat", flat))}
    out["dtype"] = str(hier(torch.from_numpy(inputs["equal"][rank]).to(torch.bfloat16)).dtype)
    if "specs" in inputs:
        out["shards"] = _local_shards(mesh, inputs["specs"])
    return out


def _local_shards(mesh, specs: dict) -> dict:
    """For each named (pspec, shape): the block this rank holds as DTensor
    cuts it (from the local tensor of an ``arange``) and as ``local_slices``
    cuts it, each as ((start, stop), ...) a dim."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import load
    from repro_torch.models.param import placements, tree_leaves, tree_shardings
    from repro_torch.parallel.sharding import make_rules, shard_slices

    # the params' placements as tree_shardings gives them (leaf i is "param{i}")
    params = tree_leaves(tree_shardings(load("granite-8b", smoke=True).param_specs(),
                                        make_rules(multi_pod=True), mesh))
    out = {}
    for name, (pspec, shape) in specs.items():
        full = torch.arange(int(np.prod(shape)), dtype=torch.float64).reshape(shape)
        place = placements(pspec, tuple(mesh.mesh_dim_names))
        if name.startswith("param") and params[int(name[5:])] != place:
            raise AssertionError(f"{name}: tree_shardings gives {params[int(name[5:])]}, the spec {place}")
        local = distribute_tensor(full, mesh, place).to_local()
        start = np.unravel_index(int(local.reshape(-1)[0]), shape)
        dtensor = tuple((int(s), int(s) + n) for s, n in zip(start, local.shape))
        if not torch.equal(local, full[tuple(slice(a, b) for a, b in dtensor)]):
            raise AssertionError(f"{name}: DTensor's local block is not a box")
        mine = tuple((sl.start, sl.stop) for sl in shard_slices(pspec, shape, mesh))
        out[name] = {"dtensor": dtensor, "local_slices": mine}
    return out


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------


def pipeline(rank: int, world: int, ws: np.ndarray, x: np.ndarray) -> np.ndarray:
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.pipeline import pipelined_forward, stage_split

    mesh = make_mesh((world,), ("stage",), device_type="cpu")

    def stage_fn(p, h):                 # p: (L / n_stages, D, D) for this stage
        for w in p:
            h = torch.tanh(h @ w)
        return h

    fn = pipelined_forward(mesh, "stage", stage_fn, x.shape[0])
    return fn(stage_split(torch.from_numpy(ws), world)[rank], torch.from_numpy(x)).numpy()


# ---------------------------------------------------------------------------
# the ZeRO-1 train step
# ---------------------------------------------------------------------------


def train_step(rank: int, world: int, shape: tuple, axes: tuple, batch: dict, steps: int,
               seed: int) -> dict:
    """granite-8b smoke in fp32, ``steps`` ZeRO-1 steps for each compression
    mode on this rank's share of ``batch``; what the parent holds against a
    single process: the first step's synchronised gradient and AdamW
    payload, the shards after it and their blocks, the params after the
    first and the last step, the losses.  The 2-rank mesh also checks
    ``build_serve_step``'s ``fn`` against the harness and returns its
    ``abstract_args`` as (shape, type)."""
    from repro_torch.configs import load
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import ShapeCell
    from repro_torch.models.param import tree_init, tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.optim.compression import CompressionConfig
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.train.train_step import build_train_step

    mesh = make_mesh(shape, axes, device_type="cpu")
    multi_pod = "pod" in axes
    rules = make_rules(multi_pod=multi_pod)
    harness = load("granite-8b", smoke=True).clone(dtype=torch.float32)
    B, S = batch["tokens"].shape
    cell = ShapeCell("smoke", "train", S, B)
    share = B // world
    local = {k: torch.from_numpy(v[rank * share:(rank + 1) * share]) for k, v in batch.items()}
    opt_cfg = adamw.OptConfig(lr=1e-3, warmup_steps=2, decay_steps=steps)
    out: dict = {}
    for mode in ("none", "int8"):
        bundle = build_train_step(harness, cell, mesh, multi_pod=multi_pod, opt_cfg=opt_cfg,
                                  compression=CompressionConfig(mode=mode), rules=rules)
        params = tree_init(harness.param_specs(), torch.Generator().manual_seed(seed), torch.float32, "cpu")
        opt = bundle.init_opt_state(params)
        kept: dict = {}
        residual, losses = None, []
        for step in range(steps):
            observe = (lambda g, p: kept.update(grads=_np(g), payload=_np(p))) if step == 0 else None
            params, opt, metrics, residual = bundle.fn(params, opt, local, residual, observe)
            losses.append(float(metrics["loss"]))
            if step == 0:
                kept["shards"] = _np({k: opt[k] for k in ("master", "m", "v")})
                kept["params_1"] = _np(params)
        blocks = _blocks(harness, mesh, rules, multi_pod)
        kept.update(losses=losses, params_end=_np(params),
                    blocks=[tuple((s.start, s.stop) for s in b) for b in blocks])
        out[mode] = kept
    if not multi_pod:
        out["serve"] = _serve_check(harness, mesh, rules)
        out["abstract"] = [[(tuple(t.shape), str(t.dtype), t.device.type) for t in tree_leaves(tree)]
                           for tree in bundle.abstract_args]
        out["in_shardings"] = [str(p) for p in tree_leaves(bundle.in_shardings[1]["master"])]
    return out


def _blocks(harness, mesh, rules, multi_pod):
    from repro_torch.models.param import tree_leaves, tree_map
    from repro_torch.parallel.sharding import shard_slices, tree_zero1_pspecs

    specs = harness.param_specs()
    zero = tree_zero1_pspecs(specs, rules, 32 if multi_pod else 16)
    return tree_leaves(tree_map(lambda ps, s: shard_slices(ps, s.shape, mesh), zero, specs))


def _serve_check(harness, mesh, rules) -> dict:
    """``build_serve_step``'s fn against the harness's prefill and decode on
    the same params, cache and tokens: the largest difference of each."""
    from repro_torch.models.api import ShapeCell
    from repro_torch.models.layers import Runtime
    from repro_torch.models.param import tree_init, tree_map
    from repro_torch.train.train_step import build_serve_step

    gen = torch.Generator().manual_seed(3)
    params = tree_init(harness.param_specs(), gen, torch.float32, "cpu")
    pre, dec = ShapeCell("p", "prefill", 16, 2), ShapeCell("d", "decode", 16, 2)
    tokens = torch.randint(0, harness.cfg.vocab_size, (2, 8), generator=gen, dtype=torch.int32)
    out = {}
    cache = tree_init(harness.serve_state_specs(pre), gen, None, "cpu")
    fresh = tree_map(torch.clone, cache)
    a, ca = build_serve_step(harness, pre, mesh, rules=rules).fn(params, cache, {"tokens": tokens})
    b, cb = harness.prefill(Runtime())(params, fresh, tokens)
    out["prefill"] = float((a - b).abs().max())
    nxt = tokens[:, -1:]
    pos = torch.tensor(8, dtype=torch.int32)
    a2, _ = build_serve_step(harness, dec, mesh, rules=rules).fn(params, ca, {"tokens": nxt, "pos": pos})
    b2, _ = harness.decode(Runtime())(params, cb, nxt, pos)
    out["decode"] = float((a2 - b2).abs().max())
    out["shapes"] = (tuple(a.shape), tuple(a2.shape))
    return out


# ---------------------------------------------------------------------------
# checkpoint re-sharding
# ---------------------------------------------------------------------------


def reshard_restore(rank: int, world: int, shape: tuple, directory: str, step: int,
                    specs: dict, pspecs: dict) -> dict:
    """This rank's blocks of the save at ``step`` restored onto a
    ("data", "model") mesh of ``shape``, through ``restore(...,
    shardings=)`` and through ``elastic.rescale`` with the same manager:
    ``{"restore": {key: (dtype, device type, block)}, "rescale": ...,
    "new_dp": ...}``, ``specs`` a flat ``{key: (shape, dtype name)}`` and
    ``pspecs`` a flat ``{key: pspec}``."""
    from repro_torch.checkpoint.manager import CheckpointManager, flatten
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import elastic
    from repro_torch.parallel.sharding import Placement

    mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
    like = {k: torch.empty(s, dtype=getattr(torch, t), device="meta") for k, (s, t) in specs.items()}
    shardings = {k: Placement(mesh, ps) for k, ps in pspecs.items()}
    manager = CheckpointManager(directory)

    def blocks(tree):
        return {k: (str(t.dtype), t.device.type, _np(t)) for k, t in flatten(tree).items()}

    plan = elastic.ElasticPlan(old_dp=2, new_dp=shape[0], old_global_batch=8)
    state, back = elastic.rescale(manager, step, like, shardings, plan)
    return {"restore": blocks(manager.restore(step, like, shardings=shardings)),
            "rescale": blocks(state), "new_dp": back.new_dp}
