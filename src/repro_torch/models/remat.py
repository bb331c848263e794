"""Rematerialisation and per-layer views, shared by the model families.

``remat`` maps the reference's ``remat_policy`` onto ``torch.utils.checkpoint``
(non-reentrant) around a block: ``"nothing"`` saves nothing and recomputes the
block in the backward, ``"dots"`` saves the outputs of the matrix products
without batch dimensions (the projections; the reference's
``dots_with_no_batch_dims_saveable``) and recomputes the rest, ``"none"``
recomputes nothing.  The transformer and the encoder-decoder apply their
config's policy; the RWKV-6
and hybrid models apply ``"nothing"`` whatever the config says, as their
references' ``jax.checkpoint(..., nothing_saveable)`` does.  Without grad
mode a block runs as it is.

``unbind_layers`` gives every layer's parameters as views of the stacked
leaves, where the reference scans over the stacked layer dim.
"""

from __future__ import annotations

import functools

import torch
from torch.utils import checkpoint as ckpt

from .param import tree_map

_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``"dots"``: keep the outputs of the
    products without batch dimensions, recompute everything else."""
    if op in _MATMULS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def remat(policy: str, fn):
    """``fn`` under ``policy`` (nothing | dots | none)."""
    if policy == "none":
        return fn
    if policy == "dots":
        context_fn = functools.partial(ckpt.create_selective_checkpoint_contexts, _save_matmuls)
    elif policy == "nothing":
        context_fn = ckpt.noop_context_fn
    else:
        raise ValueError(f"remat_policy {policy!r} (nothing | dots | none)")

    def wrapped(*args):
        if not torch.is_grad_enabled():     # nothing to save for a backward
            return fn(*args)
        return ckpt.checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn)

    return wrapped


def unbind_layers(blocks: dict, n_layers: int) -> list[dict]:
    """Every layer's parameters as views of the stacked leaves, cut in one
    ``unbind`` a leaf, so that the backward stacks each leaf's gradient once
    rather than adding a full-size tensor a layer."""
    parts = tree_map(lambda t: t.unbind(0), blocks)
    return [tree_map(lambda u: u[i], parts) for i in range(n_layers)]
