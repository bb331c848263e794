"""End-to-end training — port of ``repro/launch/train.py``::

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \\
        --steps 40 --lr 1e-3 --compression int8 --device cpu   # smoke config
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \\
        --no-smoke --n-layers 8 --steps 4 --compression int8   # on the card

The reference's flags, plus ``--smoke/--no-smoke`` (the reference's
``--smoke`` is ``store_true`` with default True, so it cannot be turned off),
``--device`` (default ``cuda``; it raises without a card and never carries on
on the CPU), ``--n-layers`` (the config at that depth, widths unchanged: at 8
of its 36 layers granite-8b's training state of 20 bytes a parameter, 42.95
GB, fits one 80 GB card) and ``--seed`` (the weights' draw; the data's seed
is 0, as the reference's).  ``--auto-parallel`` raises: the planner comes
with its slice.  The transformers (dense, MoE, and paligemma text-only as the
reference's train script trains it), rwkv6 and zamba2 train.  whisper-base
raises: the reference's train script feeds tokens and labels only, and its
encoder-decoder loss reads frames (ROADMAP C5).

One step: the loss and its gradients (``value_and_grad`` of the harness's
loss, with the family's kernels and their recompute under remat), the
gradients compressed (``--compression``; in int8 every leaf's payload goes
through the ``ccu_reduce`` kernel), then AdamW.  The int8 error-feedback
residual is carried from step to step; the reference's step passes none and
drops the one it gets back, so there the residual never acts.  ``run(args)``
is the whole loop and returns what it measured; ``main`` prints it.

Checkpoints (``--ckpt-dir``, ``checkpoint/manager.py``, the reference's
layout): ``{"params", "opt"}`` and, once there is one, the int8 residual
under ``"residual"``, every ``--ckpt-every`` updates and at the end.  Each
save is labelled with the number of updates it holds, which is
``opt["step"]``, and a run resumes from the latest save at
``int(opt["step"])``: its data and its step range start there.  The
reference labels its periodic saves one short (its save after step ``s``
holds ``s + 1`` updates and is labelled ``s``) and resumes at the label, so
it runs batch ``s`` twice; reading ``opt["step"]`` resumes its saves at the
batch after their last update too.  A save without a residual (the
reference's) resumes with a zero one, and says so.
"""

from __future__ import annotations

import argparse
import time

import torch
from torch.profiler import record_function

from ..checkpoint.manager import CheckpointManager
from ..configs import load
from ..data.pipeline import DataConfig, Pipeline, SyntheticSource
from ..kernels import launch_counts
from ..models.layers import Runtime
from ..models.param import param_count, tree_init, tree_map, value_and_grad
from ..optim import adamw
from ..optim.compression import CompressionConfig, compress_grads
from ..runtime.fault_tolerance import TrainingSupervisor


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument(
        "--smoke", action=argparse.BooleanOptionalAction, default=True,
        help="shrunken config (default; --no-smoke for the full arch)",
    )
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compression", default="none", choices=["none", "bf16", "int8"])
    ap.add_argument("--auto-parallel", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--n-layers", type=int, default=None,
                    help="train at this depth, widths unchanged (default: the config's)")
    ap.add_argument("--seed", type=int, default=0, help="seed of the weights' draw")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args: argparse.Namespace, *, harness=None, params=None, rt=None, observe=None,
        log=None, stop_at: int | None = None) -> dict:
    """Train up to ``args.steps`` updates, from fresh weights and optimizer
    state or from the latest save in ``args.ckpt_dir``.

    ``harness`` and ``params`` replace the loaded config and the drawn
    weights (the parity tests carry the reference's weights across that way;
    ``params`` is updated in place, by a restore too); ``rt`` replaces the
    default runtime (``Runtime(use_kernels=False)`` is the plain path, for
    the model and the compression's reduce alike).  ``observe(step, loss,
    grads, payload, wire)``, if given, is called every step after the
    compression and before the update, with the gradients, the payload AdamW
    gets and, in int8 mode, each leaf's int8 values and scale ``(q, scale)``
    (else an empty list); its time is left out of the step's.  ``log`` takes
    each line the loop would print.  ``stop_at`` ends the loop after that
    many updates, as a run cut there would end, but with its save written
    (with ``--ckpt-dir``): a later call resumes from it.  A run that resumes
    with nothing left to do writes no save, so that no label ever names
    fewer updates than its save holds.

    Returns per step run the loss, the gradient norm, the learning rate and
    the wall time (host clock ended by a device synchronise), the peak device
    memory, tokens per second over the steps' wall times with the first step
    left out where there are more (it builds the kernels; None if no step
    ran), the kernels' launch counts over the loop, the update count the run
    started from (``start_step``), the label of the save it resumed from
    (``resumed_from``, else None) and whether that save held the residual
    (``residual_restored``).  The three parts of a step are marked for
    ``torch.profiler`` as ``train.grad``, ``train.compress`` and
    ``train.adamw`` (``launch/profile_train.py`` reads them).
    """
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda asked for, but torch.cuda.is_available() is False; "
            "pass --device cpu to run the plain versions on the CPU"
        )
    if args.auto_parallel:
        raise NotImplementedError("--auto-parallel: the planner (core/planner.py, core/perf_model.py) "
                                  "is not ported yet (ROADMAP A12c)")
    say = log if log is not None else (lambda line: None)
    harness = harness if harness is not None else load(args.arch, smoke=args.smoke)
    if harness.family == "audio":
        raise ValueError(
            f"--arch {args.arch}: the training loop feeds tokens and labels only, and the "
            "encoder-decoder's loss reads frames; the reference's train script fails the same "
            "way with a KeyError (ROADMAP C5)")
    if args.n_layers is not None:
        harness = harness.clone(n_layers=args.n_layers)
    cfg = harness.cfg
    rt = rt if rt is not None else Runtime(rules=None)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    loss_and_grad = value_and_grad(harness.loss(rt))
    opt_cfg = adamw.OptConfig(lr=args.lr, warmup_steps=10, decay_steps=args.steps)
    comp = CompressionConfig(mode=args.compression)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = tree_init(harness.param_specs(), gen, torch.bfloat16, device)
    residual = None
    manager = CheckpointManager(args.ckpt_dir) if args.ckpt_dir is not None else None
    label = None if manager is None else manager.latest_step()
    residual_restored = None
    if label is None:
        opt_state = adamw.init_opt_state(params)
    else:
        # the optimizer state is read into new tensors, the weights into the
        # caller's; the label is only where to look: the run resumes at the
        # number of updates the save holds
        opt_specs = adamw.opt_state_specs(harness.param_specs())
        state = manager.restore(label, {"params": params, "opt": opt_specs}, device=device)
        with torch.no_grad():
            tree_map(lambda p, r: p.copy_(r), params, state["params"])
        opt_state = state["opt"]
        del state
        if comp.mode == "int8":
            try:
                residual = manager.restore(label, {"residual": opt_specs["m"]}, device=device)["residual"]
                residual_restored = True
            except KeyError:
                residual_restored = False
                say(f"[train] save {label} holds no int8 residual: resuming with a zero residual")
    start = int(opt_state["step"])
    stop = args.steps if stop_at is None else min(stop_at, args.steps)
    if label is not None:
        say(f"[train] resuming from save {label}: {start} updates done, running steps {start}..{stop - 1}")

    def saved_state() -> dict:
        tree = {"params": params, "opt": opt_state}
        return tree if residual is None else {**tree, "residual": residual}

    data_cfg = DataConfig(global_batch=args.batch, seq_len=args.seq, vocab_size=cfg.vocab_size, seed=0)
    pipeline = Pipeline(SyntheticSource(data_cfg), data_cfg, start_step=start)
    supervisor = TrainingSupervisor(n_workers=1)
    out = {"losses": [], "grad_norms": [], "lrs": [], "step_ms": []}
    launches0 = launch_counts()
    try:
        for step in range(start, stop):
            batch = next(pipeline)
            batch = {k: torch.from_numpy(batch[k]).to(device) for k in ("tokens", "labels")}
            t0 = time.perf_counter()
            with record_function("train.grad"):
                loss, grads = loss_and_grad(params, batch)
            wire = [] if observe is not None else None
            with record_function("train.compress"):
                payload, residual = compress_grads(comp, grads, residual, use_kernels=rt.use_kernels, wire=wire)
            if observe is not None:
                _sync(device)
                t1 = time.perf_counter()
                observe(step, loss, grads, payload, wire)
                t0 += time.perf_counter() - t1
                del wire
            del grads
            with record_function("train.adamw"):
                params, opt_state, metrics = adamw.apply(opt_cfg, params, payload, opt_state)
            del payload
            _sync(device)
            dt = time.perf_counter() - t0
            supervisor.heartbeat(0, step, dt)
            out["losses"].append(float(loss))
            out["grad_norms"].append(float(metrics["grad_norm"]))
            out["lrs"].append(float(metrics["lr"]))
            out["step_ms"].append(dt * 1e3)
            if log is not None and (step % args.log_every == 0 or step == args.steps - 1):
                log(f"[train] step={step} loss={out['losses'][-1]:.4f} "
                    f"gnorm={out['grad_norms'][-1]:.3f} lr={out['lrs'][-1]:.2e} dt={dt * 1e3:.0f}ms")
            if manager is not None and (step + 1) % args.ckpt_every == 0 and step + 1 < stop:
                manager.save(step + 1, saved_state())
        if manager is not None and start < stop:      # the periodic saves stop short of stop
            manager.save(stop, saved_state(), blocking=True)
    finally:
        pipeline.close()
        if manager is not None:
            manager.wait()
    warm = out["step_ms"][1:] or out["step_ms"]
    out["tokens_per_s"] = len(warm) * args.batch * args.seq * 1e3 / sum(warm) if warm else None
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9 if device.type == "cuda" else None
    out["params"] = param_count(harness.param_specs())
    out["launches"] = {k: n - launches0[k] for k, n in launch_counts().items()}
    out["device"] = str(device)
    out["start_step"] = start
    out["resumed_from"] = label
    out["residual_restored"] = residual_restored
    return out


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    print(f"[train] arch={args.arch} smoke={args.smoke} device={args.device} "
          f"compression={args.compression}")
    res = run(args, log=print)
    losses = res["losses"]
    if not losses:
        print(f"[train] nothing to run: the save holds {res['start_step']} of {args.steps} updates")
        return
    print(f"[train] params={res['params']:.4g} peak={res['peak_memory_gb']} GB "
          f"kernel launches={res['launches']}")
    print(f"[train] done. first loss={losses[0]:.4f} last loss={losses[-1]:.4f} "
          f"({res['tokens_per_s']:.0f} tok/s after the first step)")
    assert losses[-1] < losses[0], "loss did not improve"


if __name__ == "__main__":
    main()
