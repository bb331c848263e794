"""Zamba2-style hybrid — port of ``repro/models/hybrid.py``: a Mamba2
backbone and ONE shared (weight-tied) attention + MLP block that runs after
every ``share_every``-th Mamba2 block, except after the last.

Ported: ``HybridConfig``, ``lm_specs``, ``_shared_block``, ``forward``,
``loss_fn``, ``state_specs`` and ``decode_step``.  Where the reference scans
over the stacked layer dim, the port loops in Python over views of the
stacked leaves: no per-layer copy.  Under grad mode every Mamba2 body of
``forward`` is recomputed in the backward (``remat.remat`` under
``"nothing"``), as the reference's ``jax.checkpoint(..., nothing_saveable)``
does whatever ``remat_policy`` says, and the shared attention block is not;
so a training step runs each Mamba2 layer's scan twice and each shared
call's attention once.  Serving runs without grad mode and recomputes
nothing.

New here: ``prefill``, one pass over the prompt that returns the last
token's logits and the state the prompt leaves: each Mamba2 layer's final
scan state and conv tail, and each shared call's keys and values at cache
positions [0, S).  The reference's ``HybridHarness.prefill`` runs
``forward`` and returns the state it was given, so its decode starts from a
zero state; the tests hold this ``prefill`` against the reference's own
``decode_step`` fed the prompt one token at a time.

The state is updated in place: the SSM state ``h`` (float32) and the KV
cache are written where they lie.  The conv tail is promoted with the
activations as the reference's concatenation promotes it (a bfloat16 state
of a float32 model becomes float32), so the state returned may hold a new
``conv`` tensor.

On the model axis the rank holds its positions of each sequence between
blocks (the rules' ``sp``) in training and prefill: the token table and
the unembedding are gathered whole, as the shared block's cut weights are
(``layers.whole``), the shared block's attention gathers its keys and
values, the Mamba2 layers gather x along the sequence and run on the
rank's heads (``models/mamba2.py``); ``loss_fn`` is the rank's share of
the mean and ``prefill`` returns the last model rank's logits on every
rank.  ``decode_step`` runs the axis tensor-parallel (``rt.tp``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from . import layers as L
from .mamba2 import Mamba2Config, mamba2_apply, mamba2_specs, mamba2_state_specs
from .param import cast_floats, round_up, stack_specs
from .remat import remat, unbind_layers


@dataclass(frozen=True)
class HybridConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    ssm_state: int = 64
    share_every: int = 6
    rope_theta: float = 10000.0
    remat_policy: str = "nothing"  # kept for field parity: Mamba2 bodies are always recomputed
    unroll: bool = False           # kept for field parity; the port always loops
    dtype: torch.dtype = torch.bfloat16

    @property
    def vocab_padded(self) -> int:
        return round_up(self.vocab_size, 256)

    @property
    def mamba(self) -> Mamba2Config:
        return Mamba2Config(
            d_model=self.d_model,
            d_inner=2 * self.d_model,
            d_state=self.ssm_state,
            unroll=self.unroll,
        )

    @property
    def attn(self) -> L.AttnConfig:
        return L.AttnConfig(
            d_model=self.d_model,
            n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads,
            head_dim=self.head_dim,
            causal=True,
            rope_theta=self.rope_theta,
        )

    @property
    def n_shared_calls(self) -> int:
        # shared block runs after every share_every-th mamba block EXCEPT
        # when that block is the last one (forward loop: done < n_layers)
        return (self.n_layers - 1) // self.share_every


def lm_specs(cfg: HybridConfig) -> dict:
    return {
        "embed": L.embed_specs(cfg.vocab_padded, cfg.d_model),
        "mamba_blocks": stack_specs(
            {"norm": L.rmsnorm_spec(cfg.d_model), "mamba": mamba2_specs(cfg.mamba)},
            cfg.n_layers,
        ),
        "shared": _shared_specs(cfg),
        "final_norm": L.rmsnorm_spec(cfg.d_model),
    }


def _shared_specs(cfg: HybridConfig) -> dict:
    return {
        "ln1": L.rmsnorm_spec(cfg.d_model),
        "attn": L.attn_specs(cfg.attn),
        "ln2": L.rmsnorm_spec(cfg.d_model),
        "mlp": L.swiglu_specs(cfg.d_model, cfg.d_ff),
    }


def _shared_block(rt, cfg, p, x, positions, cache=None, cache_pos=None):
    p = L.whole(rt, p, _shared_specs(cfg))
    h = L.rmsnorm(p["ln1"], x)
    a, new_cache = L.attention(rt, p["attn"], h, cfg.attn, positions, cache, cache_pos)
    x = x + a
    h = L.rmsnorm(p["ln2"], x)
    x = x + L.swiglu(rt, p["mlp"], h)
    return rt.shard(x, "batch", "sp", None), new_cache


def _run(rt, cfg: HybridConfig, params, tokens, state, pos: int, step: bool):
    """Tokens (B, S) at positions pos .. pos+S-1 through the stack, in the
    reference's group loop.  ``state`` None: scoring, nothing kept.  Else
    each Mamba2 layer writes the state it leaves into ``state["ssm"]`` —
    from the chunked scan over the tokens (``step`` False, prefill) or from
    the recurrence starting at the state there (``step`` True, decode) —
    and shared call c writes its keys and values into ``state["kv"]``'s
    cache c at ``pos``.  Returns the final-norm hidden states, the
    parameters in the compute type and the new state."""
    params = cast_floats(params, cfg.dtype)
    x = L.embed(rt, _embedding(rt, cfg, params, "tok"), tokens).to(cfg.dtype)
    positions = pos + rt.seq_offset(x.shape[1]) + torch.arange(x.shape[1], device=x.device)
    ssm = None
    if state is not None:
        conv = state["ssm"]["conv"]
        promoted = torch.promote_types(conv.dtype, cfg.dtype)
        ssm = {"h": state["ssm"]["h"], "conv": conv.to(promoted)}
        kv = state["kv"]

    layers = unbind_layers(params["mamba_blocks"], cfg.n_layers)

    def mamba_body(h, lp, i):
        prev = {"h": ssm["h"][i], "conv": ssm["conv"][i]} if step else None
        y, new = mamba2_apply(rt, lp["mamba"], L.rmsnorm(lp["norm"], h), cfg.mamba, state=prev,
                              keep=ssm is not None)
        if ssm is not None:
            ssm["h"][i].copy_(new["h"])
            ssm["conv"][i].copy_(new["conv"])
        return (h + y).to(cfg.dtype)

    if state is None:
        mamba_body = remat("nothing", mamba_body)
    done, call = 0, 0
    group = cfg.share_every
    while done < cfg.n_layers:
        size = min(group, cfg.n_layers - done)
        for i in range(done, done + size):
            x = mamba_body(x, layers[i], i)
        done += size
        if done % group == 0 and done < cfg.n_layers:
            cache = None if state is None else (kv["k"][call], kv["v"][call])
            x, _ = _shared_block(
                rt, cfg, params["shared"], x, positions,
                cache=cache, cache_pos=None if state is None else pos,
            )
            call += 1
    x = L.rmsnorm(params["final_norm"], x)
    return x, params, (None if state is None else {"ssm": ssm, "kv": kv})


def _embedding(rt, cfg: HybridConfig, params, key: str) -> dict:
    """``params["embed"][key]`` as the lookup (``tok``) or the logits
    (``unembed``) use it: gathered whole where the rank holds its positions
    (``layers.whole``)."""
    return L.whole(rt, {key: params["embed"][key]}, L.embed_specs(cfg.vocab_padded, cfg.d_model))


def forward(rt, cfg: HybridConfig, params, tokens):
    """Scoring forward over a whole sequence.  Returns the logits."""
    x, params, _ = _run(rt, cfg, params, tokens, None, 0, step=False)
    return L.unembed(rt, _embedding(rt, cfg, params, "unembed"), x)


def loss_fn(rt, cfg: HybridConfig, params, batch) -> torch.Tensor:
    """The mean NLL; on the model axis this rank's share of it: the mean
    over its positions weighed by their share of the sequence."""
    logits = forward(rt, cfg, params, batch["tokens"])
    ce = L.cross_entropy(logits, batch["labels"], cfg.vocab_size)
    return ce if rt.model is None else ce / rt.model.size


def state_specs(cfg: HybridConfig, batch: int, max_attn_len: int) -> dict:
    """Decode state: per-layer SSM states + ONE shared-attn KV cache per
    shared call site."""
    ssm = mamba2_state_specs(cfg.mamba, batch, cfg.n_layers)
    n_calls = cfg.n_shared_calls
    kv = L.init_kv_cache(cfg.attn, batch, max_attn_len, n_calls, cfg.dtype)
    return {"ssm": ssm, "kv": kv}


def prefill(rt, cfg: HybridConfig, params, tokens, state):
    """The prompt (B, S) in one pass from the zero state; returns the last
    token's logits (B, 1, V) and the state the prompt leaves."""
    x, params, state = _run(rt, cfg, params, tokens, state, 0, step=False)
    logits = L.unembed(rt, _embedding(rt, cfg, params, "unembed"), x[:, -1:])
    return (logits if rt.model is None else rt.model.last(logits)), state


def decode_step(rt, cfg: HybridConfig, params, tokens, state, pos):
    """One autoregressive step (tokens (B, 1) at ``pos``) from ``state``;
    on the model axis tensor-parallel (``rt.tp``), every rank returning the
    same logits."""
    if rt.model is not None:
        rt = dataclasses.replace(rt, tp=True)
    x, params, state = _run(rt, cfg, params, tokens, state, int(pos), step=True)
    return L.unembed(rt, params["embed"], x), state
