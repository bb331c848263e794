"""AdamW with fp32 masters and moments — port of ``repro/optim/adamw.py``.

Storage as in the reference: the params in their own type (bf16 on the main
path), an fp32 master copy of each, fp32 moments ``m`` and ``v`` and an int32
``step``.  ``apply`` updates whole trees; the ZeRO-1 step
(``train/train_step.py``) updates each rank's shard of the masters and
moments with the same ``step_scalars`` and ``update_leaf``.

``apply`` follows the reference's order exactly: the gradients cast to
``grad_dtype``, their global norm in fp32, the clip factor, the bias
corrections in fp32, then per leaf ``m``, ``v``, the bias-corrected step and
the decoupled weight decay on the fp32 master, and the params cast back from
the masters.  It goes leaf by leaf and updates the state and the params in
place, so that the fp32 temporaries of one leaf (1.9 GB for granite-8b's
largest stacked leaf at 8 layers) are the peak, not the whole tree's; it
returns the same containers, as the reference returns new ones.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from ..models.param import ParamSpec, tree_leaves, tree_map


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    clip_norm: float = 1.0
    grad_dtype: Any = torch.bfloat16     # payload dtype of the DP reduction


def opt_state_specs(param_specs) -> dict:
    """ParamSpec tree for the optimizer state (fp32 masters + moments)."""

    def f32(s: ParamSpec, init: str) -> ParamSpec:
        return ParamSpec(s.shape, s.logical, init=init, scale=s.scale, dtype=torch.float32)

    return {
        "master": tree_map(lambda s: f32(s, s.init), param_specs),
        "m": tree_map(lambda s: f32(s, "zeros"), param_specs),
        "v": tree_map(lambda s: f32(s, "zeros"), param_specs),
        "step": ParamSpec((), (), init="zeros", dtype=torch.int32),
    }


def init_opt_state(params) -> dict:
    with torch.no_grad():
        return {
            "master": tree_map(lambda p: p.detach().to(torch.float32, copy=True), params),
            "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params),
            "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params),
            "step": torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device),
        }


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_ratio``; fp32."""
    step = step.to(torch.float32)
    warm = torch.clamp((step + 1.0) / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0
    )
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    sq = sum(torch.sum(torch.square(x.to(torch.float32))) for x in tree_leaves(tree))
    return torch.sqrt(sq)


def step_scalars(cfg: OptConfig, grads, state: dict, gnorm: torch.Tensor | None = None) -> dict:
    """What one update needs beside each leaf: the next step, the learning
    rate, the global norm of ``grads`` (already in ``grad_dtype``; or
    ``gnorm``, where a caller holding shards of the tree reduced it), the
    clip factor and the bias corrections, in the reference's order."""
    step = state["step"] + 1
    gnorm = global_norm(grads) if gnorm is None else gnorm
    return {"step": step, "lr": schedule(cfg, state["step"]), "gnorm": gnorm,
            "scale": torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0),
            "bc1": 1.0 - torch.pow(cfg.b1, step.to(torch.float32)),
            "bc2": 1.0 - torch.pow(cfg.b2, step.to(torch.float32))}


def update_leaf(cfg: OptConfig, k: dict, g, m, v, master) -> None:
    """One leaf's update, in place on ``m``, ``v`` and ``master``.  Every
    operation is elementwise with the same scalars, so a block of the leaf
    (a ZeRO-1 shard) updates to the same bits as the whole leaf."""
    b1, b2 = cfg.b1, cfg.b2
    g = g.to(torch.float32) * k["scale"]
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * g * g)
    del g
    upd = (m / k["bc1"]).div_((v / k["bc2"]).sqrt_().add_(cfg.eps))
    upd.add_(cfg.weight_decay * master)
    master.sub_(k["lr"] * upd)


@torch.no_grad()
def apply(cfg: OptConfig, params, grads, state: dict) -> tuple[Any, dict, dict]:
    """One AdamW update.  Returns (params, state, metrics), the first two
    updated in place."""
    grads = tree_map(lambda g: g.to(cfg.grad_dtype), grads)
    k = step_scalars(cfg, grads, state)
    flat = zip(tree_leaves(grads), tree_leaves(state["m"]), tree_leaves(state["v"]),
               tree_leaves(state["master"]), tree_leaves(params))
    for g, m, v, master, p in flat:
        update_leaf(cfg, k, g, m, v, master)
        p.copy_(master)                     # rounds to the params' type
    state["step"] = k["step"]
    return params, state, {"grad_norm": k["gnorm"], "lr": k["lr"]}
