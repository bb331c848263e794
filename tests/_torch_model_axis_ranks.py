"""Rank targets of ``tests/test_torch_model_axis*.py`` and
``tests/test_torch_dryrun.py`` (spawned by ``_torch_dist.spawn``): the train
step, prefill and decode of every family on a mesh with a "model" axis, one attention layer on the rank's rows, and the MoE routing of
the rank's shard of a sequence.  Each arch's rules name its MoE strategy, as
``rules_for_cell`` does.  Imports torch and the port only."""

from __future__ import annotations

import pickle

import torch

from _torch_dist import _np

LR, STEPS = 1e-3, 2


def inputs(path) -> tuple:
    """The inputs a test wrote with ``pickle`` for its ranks.  They travel
    by file: ``torch.multiprocessing.spawn`` pickles its arguments into each
    child's start-up pipe, so that large ones start the ranks one by one."""
    with open(path, "rb") as f:
        return pickle.load(f)


def _local(tree, pspecs, mesh):
    from repro_torch.models.param import tree_map
    from repro_torch.parallel.sharding import shard_slices

    return tree_map(lambda t, ps: t[shard_slices(ps, tuple(t.shape), mesh)].clone(), tree, pspecs)


def _slices(pspecs, specs, mesh) -> list:
    from repro_torch.models.param import tree_leaves, tree_map
    from repro_torch.parallel.sharding import shard_slices

    return [tuple((s.start, s.stop) for s in sl)
            for sl in tree_leaves(tree_map(lambda ps, s: shard_slices(ps, s.shape, mesh), pspecs, specs))]


def opt_cfg():
    from repro_torch.optim import adamw

    return adamw.OptConfig(lr=LR, warmup_steps=2, decay_steps=STEPS)


def train(rank: int, world: int, shape: tuple, axes: tuple, path: str, steps: int = STEPS) -> dict:
    """For each arch of the cases at ``path`` ({arch: (weights, batch)},
    numpy, fp32):
    ``steps`` int8 ZeRO-1 steps on this rank's blocks: the first step's
    synchronised gradient and payload blocks, the ZeRO-1 shards after it and
    their blocks, the params' blocks after each step, the losses, the norm."""
    from repro_torch.configs import load
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import ShapeCell
    from repro_torch.models.param import from_reference, tree_pspecs
    from repro_torch.optim.compression import CompressionConfig
    from repro_torch.parallel.sharding import make_rules, tree_zero1_pspecs
    from repro_torch.train.train_step import build_train_step

    mesh = make_mesh(shape, axes, device_type="cpu")
    multi_pod = "pod" in axes
    out: dict = {}
    for arch, (weights, batch) in inputs(path).items():
        harness = load(arch, smoke=True).clone(dtype=torch.float32)
        rules = make_rules(multi_pod=multi_pod, moe_strategy=harness.moe_strategy)
        specs = harness.param_specs()
        param_ps = tree_pspecs(specs, rules)
        B, S = batch["tokens"].shape
        cell = ShapeCell("smoke", "train", S, B)
        bundle = build_train_step(harness, cell, mesh, multi_pod=multi_pod, opt_cfg=opt_cfg(),
                                  compression=CompressionConfig(mode="int8"), rules=rules)
        input_ps = tree_pspecs(harness.train_input_specs(cell), rules)
        local = _local({k: torch.from_numpy(v) for k, v in batch.items()}, input_ps, mesh)
        params = _local(from_reference(weights, torch.float32, "cpu"), param_ps, mesh)
        opt = bundle.init_opt_state(params)
        kept: dict = {"losses": [], "params": []}
        residual = None
        for i in range(steps):
            observe = (lambda g, p: kept.update(grads=_np(g), payload=_np(p))) if i == 0 else None
            params, opt, metrics, residual = bundle.fn(params, opt, local, residual, observe)
            kept["losses"].append(float(metrics["loss"]))
            kept["params"].append(_np(params))
            if i == 0:
                kept["gnorm"] = float(metrics["grad_norm"])
                kept["shards"] = _np({k: opt[k] for k in ("master", "m", "v")})
        kept["param_blocks"] = _slices(param_ps, specs, mesh)
        kept["zero_blocks"] = _slices(tree_zero1_pspecs(specs, rules, 32 if multi_pod else 16), specs, mesh)
        kept["coord"] = dict(zip(axes, mesh.get_coordinate()))
        out[arch] = kept
    return out


def prefill(rank: int, world: int, shape: tuple, axes: tuple, path: str) -> dict:
    """For each arch of the inputs at ``path`` ({arch: ((weights, prompt),
    (layer weights, x))}, numpy, fp32): prefill of ``prompt`` on this rank's
    share of the batch and of the positions (the logits and this rank's
    cache block), and one attention layer on this rank's rows of ``x``
    against the keys and values gathered over "model", through the kernel's
    wrapper and through the plain path."""
    from repro_torch.configs import load
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import ShapeCell
    from repro_torch.models.param import from_reference, tree_init, tree_pspecs
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.train.train_step import build_serve_step

    mesh = make_mesh(shape, axes, device_type="cpu")
    multi_pod = "pod" in axes
    out: dict = {}
    for arch, ((weights, prompt), attn) in inputs(path).items():
        harness = load(arch, smoke=True).clone(dtype=torch.float32)
        rules = make_rules(multi_pod=multi_pod, moe_strategy=harness.moe_strategy)
        cell = ShapeCell("p", "prefill", prompt.shape[1], prompt.shape[0])
        serve = build_serve_step(harness, cell, mesh, multi_pod=multi_pod, rules=rules)
        params = _local(from_reference(weights, torch.float32, "cpu"), tree_pspecs(harness.param_specs(), rules),
                        mesh)
        state = harness.serve_state_specs(cell)
        state_ps = tree_pspecs(state, rules)
        cache = _local(tree_init(state, None, None, "cpu"), state_ps, mesh)
        tokens = _local({"tokens": torch.from_numpy(prompt)}, tree_pspecs(harness.serve_input_specs(cell), rules),
                        mesh)
        logits, cache = serve.fn(params, cache, tokens)
        out[arch] = {"logits": logits.numpy(), "cache": _np(cache), "cache_blocks": _slices(state_ps, state, mesh),
                     "coord": dict(zip(axes, mesh.get_coordinate())),
                     "attention": _attention_rows(mesh, rules, arch, *attn)}
    return out


def _attention_rows(mesh, rules, arch, weights, x) -> dict:
    from repro_torch.configs import load
    from repro_torch.models.layers import Runtime, attention
    from repro_torch.models.param import from_reference
    from repro_torch.parallel.collectives import ModelAxis
    from repro_torch.parallel.sharding import shard_slices

    cfg = load(arch, smoke=True).clone(dtype=torch.float32).cfg.attn()
    rows = shard_slices(("data", "model"), x.shape, mesh)
    xl = torch.from_numpy(x)[rows]
    p = from_reference(weights, torch.float32, "cpu")
    model = ModelAxis(mesh, rules)
    out = {"rows": [(s.start, s.stop) for s in rows]}
    for use_kernels in (True, False):
        rt = Runtime(use_kernels=use_kernels, model=model)
        S = xl.shape[1]
        y, _ = attention(rt, p, xl, cfg, rt.seq_offset(S) + torch.arange(S))
        out["kernel" if use_kernels else "plain"] = y.numpy()
    return out


def records(rank: int, world: int, shape: tuple, axes: tuple, arch: str, B: int, S: int, steps: int) -> dict:
    """``steps`` int8 steps of ``arch``'s smoke config in bf16 (its own
    type) from drawn weights and tokens on this rank's blocks; the
    collectives of the last step as the transports recorded them."""
    from repro_torch.configs import load
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import ShapeCell
    from repro_torch.models.param import tree_init, tree_pspecs
    from repro_torch.optim.compression import CompressionConfig
    from repro_torch.parallel.collectives import recording
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.train.train_step import build_train_step

    mesh = make_mesh(shape, axes, device_type="cpu")
    multi_pod = "pod" in axes
    harness = load(arch, smoke=True)
    rules = make_rules(multi_pod=multi_pod, moe_strategy=harness.moe_strategy)
    cell = ShapeCell("smoke", "train", S, B)
    bundle = build_train_step(harness, cell, mesh, multi_pod=multi_pod, opt_cfg=opt_cfg(),
                              compression=CompressionConfig(mode="int8"), rules=rules)
    gen = torch.Generator().manual_seed(0)
    params = _local(tree_init(harness.param_specs(), gen, torch.bfloat16, "cpu"),
                    tree_pspecs(harness.param_specs(), rules), mesh)
    tokens = torch.randint(0, harness.cfg.vocab_size, (B, S + 1), generator=gen, dtype=torch.int32)
    batch = _local({"tokens": tokens[:, :-1].contiguous(), "labels": tokens[:, 1:].contiguous()},
                   tree_pspecs(harness.train_input_specs(cell), rules), mesh)
    opt = bundle.init_opt_state(params)
    residual = None
    for _ in range(steps):
        wire0 = dict(bundle.fn.wire_bytes)
        with recording() as seen:
            params, opt, _, residual = bundle.fn(params, opt, batch, residual)
    return {"records": seen, "wire": {a: n - wire0.get(a, 0) for a, n in bundle.fn.wire_bytes.items()}}


def serve(rank: int, world: int, shape: tuple, axes: tuple, path: str) -> dict:
    """For each case of the inputs at ``path`` ({name: dict(arch, weights,
    prompt, prefix (or None), cache, steps, window (or None), and an
    encoder-decoder's frames)}, numpy, fp32): a served request on this rank's share of the batch, as
    ``build_serve_step`` runs it on the model axis: prefill of the prompt
    (after the prefix) into a cache of ``cache`` positions, each rank's
    block of the cache under the rules' ``cache_seq``, then ``steps`` greedy
    decode steps (the decode cell's rules, ``sp`` off), each fed the ids
    this rank chose.  Returns the logits of every step, the ids, the cache
    blocks after the last step and their slices."""
    from repro_torch.configs import load
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import ShapeCell
    from repro_torch.models.param import from_reference, tree_init, tree_pspecs
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.train.train_step import build_serve_step

    mesh = make_mesh(shape, axes, device_type="cpu")
    out: dict = {}
    for name, case in inputs(path).items():
        harness = load(case["arch"], smoke=True).clone(dtype=torch.float32)
        if case["window"] is not None:
            harness = harness.clone(window=case["window"])
        B, S = case["prompt"].shape
        P = 0 if case["prefix"] is None else case["prefix"].shape[1]
        pre, dec = ShapeCell("p", "prefill", S, B), ShapeCell("d", "decode", case["cache"] - P, B)
        rules = make_rules(moe_strategy=harness.moe_strategy)
        drules = make_rules(sp=False, moe_strategy=harness.moe_strategy)
        params = _local(from_reference(case["weights"], torch.float32, "cpu"),
                        tree_pspecs(harness.param_specs(), rules), mesh)
        state = harness.serve_state_specs(dec)
        state_ps = tree_pspecs(state, rules)
        cache = _local(tree_init(state, None, None, "cpu"), state_ps, mesh)
        inp = {"tokens": torch.from_numpy(case["prompt"])}
        if P:
            inp["prefix_embeds"] = torch.from_numpy(case["prefix"])
        if case.get("frames") is not None:
            inp["frames"] = torch.from_numpy(case["frames"])
        inp = _local(inp, tree_pspecs(harness.serve_input_specs(pre), rules), mesh)
        logits, cache = build_serve_step(harness, pre, mesh, rules=rules).fn(params, cache, inp)
        step = build_serve_step(harness, dec, mesh, rules=drules)
        kept = {"logits": [logits.numpy()], "ids": []}
        for i in range(case["steps"]):
            ids = logits.argmax(-1).to(torch.int32)
            kept["ids"].append(ids.numpy())
            logits, cache = step.fn(params, cache, {"tokens": ids, "pos": torch.tensor(P + S + i, dtype=torch.int32)})
            kept["logits"].append(logits.numpy())
        kept.update(cache=_np(cache), cache_blocks=_slices(state_ps, state, mesh),
                    coord=dict(zip(axes, mesh.get_coordinate())), wire=dict(step.fn.wire_bytes))
        out[name] = kept
    return out


def slots(rank: int, world: int, shape: tuple, axes: tuple, path: str) -> dict:
    """For each case of the inputs at ``path`` ({name: (x (B, S, D),
    router (D, E), MoE config fields)}, numpy, fp32): ``moe.route`` of this
    rank's positions of each sequence with the whole sequence's capacity,
    the slots counted over the model axis (``seq=``): the choices, the
    slots and which are kept, and the rank's positions."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.moe import MoEConfig, route
    from repro_torch.parallel.collectives import ModelAxis
    from repro_torch.parallel.sharding import make_rules, shard_slices

    mesh = make_mesh(shape, axes, device_type="cpu")
    model = ModelAxis(mesh, make_rules())
    out: dict = {}
    for name, (x, router, fields) in inputs(path).items():
        cfg = MoEConfig(**fields)
        rows = shard_slices(("data", "model"), x.shape, mesh)
        r = route(torch.from_numpy(x)[rows], torch.from_numpy(router), cfg, capacity=cfg.capacity(x.shape[1]),
                  seq=model)
        out[name] = {"rows": [(s.start, s.stop) for s in rows], "gate_idx": r.gate_idx.numpy(),
                     "pos": r.pos.numpy(), "keep": r.keep.numpy()}
    return out


def train_and_serve(rank: int, world: int, shape: tuple, axes: tuple, train_path: str, serve_path: str) -> dict:
    """``train`` on the cases at ``train_path``, then ``serve`` on those at
    ``serve_path``, on the same ranks."""
    return {"train": train(rank, world, shape, axes, train_path), "serve": serve(rank, world, shape, axes, serve_path)}


def family_layers(rank: int, world: int, shape: tuple, axes: tuple, path: str) -> dict:
    """For each case of the inputs at ``path`` ({name: (arch, weights, x)},
    numpy, fp32), one piece of a family on the model axis, on this rank's
    blocks of its weights (the rules' specs): ``"timemix"`` an RWKV-6 time
    mix on the whole ``x`` (B, S, D), every rank's output whole;
    ``"mamba"`` a Mamba2 layer on the rank's positions of ``x``, its output
    on them; ``"encode"`` whisper's encoder on the rank's frames ``x``, its
    output gathered whole.  Each with the rank's positions."""
    import dataclasses

    from repro_torch.configs import load
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import encdec, mamba2, rwkv6
    from repro_torch.models.layers import Runtime
    from repro_torch.models.param import from_reference, tree_pspecs
    from repro_torch.parallel.collectives import ModelAxis
    from repro_torch.parallel.sharding import make_rules, shard_slices

    mesh = make_mesh(shape, axes, device_type="cpu")
    rules = make_rules()
    model = ModelAxis(mesh, rules)
    out: dict = {}
    for name, (arch, weights, x) in inputs(path).items():
        cfg = load(arch, smoke=True).clone(dtype=torch.float32).cfg
        p = from_reference(weights, torch.float32, "cpu")
        rt = Runtime(use_kernels=False, model=model)
        rows = shard_slices(("data", "model"), x.shape, mesh)
        if name == "timemix":
            p = _local(p, tree_pspecs(rwkv6.timemix_specs(cfg.inner), rules), mesh)
            rows = (rows[0], slice(None), slice(None))
            y, _ = rwkv6.timemix_apply(dataclasses.replace(rt, tp=True), p, torch.from_numpy(x)[rows], cfg.inner)
        elif name == "mamba":
            p = _local(p, tree_pspecs(mamba2.mamba2_specs(cfg.mamba), rules), mesh)
            y, _ = mamba2.mamba2_apply(rt, p, torch.from_numpy(x)[rows], cfg.mamba)
        else:
            p = _local(p, tree_pspecs(encdec.model_specs(cfg), rules), mesh)
            y = encdec.encode(rt, cfg, p, torch.from_numpy(x)[rows])
            rows = (rows[0], slice(None), slice(None))
        out[name] = {"rows": [(s.start, s.stop) for s in rows], "y": y.detach().numpy()}
    return out
