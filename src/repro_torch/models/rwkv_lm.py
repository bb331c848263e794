"""RWKV-6 language model (attention-free; pool arch ``rwkv6-1.6b``) — port of
``repro/models/rwkv_lm.py``.

Ported: ``RWKVLMConfig``, ``block_specs``, ``lm_specs``, ``_block``,
``forward``, ``loss_fn``, ``state_specs`` and ``decode_step``.  Where the
reference scans over the stacked layer dim, the port loops in Python over
views of the stacked leaves: no per-layer copy.  Under grad mode every block
of ``forward`` is recomputed in the backward (``remat.remat`` under
``"nothing"``), as the reference's ``jax.checkpoint(..., nothing_saveable)``
does whatever ``remat_policy`` says; so a training step runs each layer's
scan twice.  Serving runs without grad mode and recomputes nothing.

New here: ``prefill``, one pass over the prompt from the zero state that
returns the last token's logits and the state the prompt leaves: each
layer's final scan state ``tm_s`` and the last inputs of its two token
shifts, ``tm_shift`` and ``cm_shift``.  The reference's
``RWKVHarness.prefill`` runs ``forward`` and returns the state it was given,
so its decode starts from a zero state and ignores the prompt; the tests hold
this ``prefill`` against the reference's own ``decode_step`` fed the prompt
one token at a time.

The state is updated in place: ``tm_s`` (float32) where it lies.  The shift
buffers are promoted with the activations as the reference's decode promotes
them (its scan stacks the layers' float32 shifts, so a bfloat16 buffer of a
float32 model comes back float32), so the state returned may hold new
``tm_shift`` and ``cm_shift`` tensors; a float32 shift is never rounded into
a bfloat16 buffer.

On the model axis every entry point runs tensor-parallel (``rt.tp``; the
rules never cut this family's sequence): the embedding looks up the rank's
columns and gathers them, the blocks run on the rank's heads
(``models/rwkv6.py``), the logits are the rank's vocabulary shard, gathered,
so every rank holds the whole logits; ``loss_fn`` takes the cross-entropy
of the rank's ``1/m`` of the positions, weighed by their share, so that the
ranks' losses (and the replicated leaves' gradients) sum to one process's
rather than m times it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from . import layers as L
from .param import cast_floats, round_up, stack_specs
from .remat import remat, unbind_layers
from .rwkv6 import (
    RWKV6Config,
    channelmix_apply,
    channelmix_specs,
    rwkv6_state_specs,
    timemix_apply,
    timemix_specs,
)


@dataclass(frozen=True)
class RWKVLMConfig:
    name: str
    n_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    head_dim: int = 64
    chunk: int = 128
    remat_policy: str = "nothing"  # kept for field parity: blocks are always recomputed
    unroll: bool = False           # kept for field parity; the port always loops
    dtype: torch.dtype = torch.bfloat16

    @property
    def vocab_padded(self) -> int:
        return round_up(self.vocab_size, 256)

    @property
    def inner(self) -> RWKV6Config:
        return RWKV6Config(
            d_model=self.d_model, head_dim=self.head_dim, d_ff=self.d_ff,
            chunk=self.chunk, unroll=self.unroll,
        )


def block_specs(cfg: RWKVLMConfig) -> dict:
    return {
        "ln1": L.layernorm_specs(cfg.d_model),
        "tm": timemix_specs(cfg.inner),
        "ln2": L.layernorm_specs(cfg.d_model),
        "cm": channelmix_specs(cfg.inner),
    }


def lm_specs(cfg: RWKVLMConfig) -> dict:
    return {
        "embed": L.embed_specs(cfg.vocab_padded, cfg.d_model),
        "ln_in": L.layernorm_specs(cfg.d_model),
        "blocks": stack_specs(block_specs(cfg), cfg.n_layers),
        "final_norm": L.layernorm_specs(cfg.d_model),
    }


def _block(rt, cfg, p, x, state=None):
    """One layer; returns (x, the state it leaves)."""
    tm_state = None if state is None else {"s": state["tm_s"], "shift": state["tm_shift"]}
    h, tm_new = timemix_apply(rt, p["tm"], L.layernorm(p["ln1"], x), cfg.inner, tm_state)
    x = x + h
    cm_state = None if state is None else {"shift": state["cm_shift"]}
    h, cm_new = channelmix_apply(rt, p["cm"], L.layernorm(p["ln2"], x), cm_state)
    x = x + h
    new_state = {"tm_s": tm_new["s"], "tm_shift": tm_new["shift"], "cm_shift": cm_new["shift"]}
    return rt.shard(x, "batch", None, None), new_state


def _run(rt, cfg: RWKVLMConfig, params, tokens, state, step: bool):
    """Tokens (B, S) through the stack.  ``state`` None: scoring, nothing
    kept.  Else each layer writes the state it leaves into ``state`` — from
    the chunked scan over the tokens (``step`` False, prefill) or from the
    recurrence starting at the state there (``step`` True, decode).  Returns
    the final-norm hidden states, the parameters in the compute type and the
    new state."""
    params = cast_floats(params, cfg.dtype)
    x = L.embed(rt, params["embed"], tokens)
    x = L.layernorm(params["ln_in"], x).to(cfg.dtype)
    layers = unbind_layers(params["blocks"], cfg.n_layers)
    if state is None:
        block = remat("nothing", lambda h, lp: _block(rt, cfg, lp, h)[0])
        for lp in layers:
            x = block(x, lp)
    else:
        state = {name: t.to(torch.promote_types(t.dtype, cfg.dtype)) for name, t in state.items()}
        for i, lp in enumerate(layers):
            prev = {name: t[i] for name, t in state.items()} if step else None
            x, new = _block(rt, cfg, lp, x, prev)
            for name, t in new.items():
                state[name][i].copy_(t)
    x = L.layernorm(params["final_norm"], x)
    return x, params, state


def _tensor_parallel(rt):
    """On the model axis the family runs tensor-parallel everywhere (the
    rules never cut its sequence): ``rt.tp``."""
    return rt if rt.model is None else dataclasses.replace(rt, tp=True)


def forward(rt, cfg: RWKVLMConfig, params, tokens):
    """Scoring forward over a whole sequence.  Returns the logits."""
    rt = _tensor_parallel(rt)
    x, params, _ = _run(rt, cfg, params, tokens, None, step=False)
    return L.unembed(rt, params["embed"], x)


def loss_fn(rt, cfg: RWKVLMConfig, params, batch) -> torch.Tensor:
    """The mean NLL.  On the model axis every rank holds the whole
    sequences and the whole logits, so a rank's loss is its disjoint share:
    the mean over its positions ``[r·S/m, (r+1)·S/m)`` weighed by their
    share of the sequence, and the ranks' losses sum to the mean."""
    logits = forward(rt, cfg, params, batch["tokens"])
    labels = batch["labels"]
    if rt.model is None:
        return L.cross_entropy(logits, labels, cfg.vocab_size)
    S, m, r = labels.shape[1], rt.model.size, rt.model.rank
    lo, hi = r * S // m, (r + 1) * S // m
    if hi == lo:
        return logits.sum() * 0.0
    return L.cross_entropy(logits[:, lo:hi], labels[:, lo:hi], cfg.vocab_size) * ((hi - lo) / S)


def state_specs(cfg: RWKVLMConfig, batch: int) -> dict:
    return rwkv6_state_specs(cfg.inner, batch, cfg.n_layers)


def prefill(rt, cfg: RWKVLMConfig, params, tokens, state):
    """The prompt (B, S) in one pass from the zero state; returns the last
    token's logits (B, 1, V) and the state the prompt leaves."""
    rt = _tensor_parallel(rt)
    x, params, state = _run(rt, cfg, params, tokens, state, step=False)
    return L.unembed(rt, params["embed"], x[:, -1:]), state


def decode_step(rt, cfg: RWKVLMConfig, params, tokens, state, pos=None):
    """One token through the recurrent form.  tokens: (B, 1)."""
    rt = _tensor_parallel(rt)
    x, params, state = _run(rt, cfg, params, tokens, state, step=True)
    return L.unembed(rt, params["embed"], x), state
