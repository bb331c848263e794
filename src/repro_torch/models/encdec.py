"""Whisper-style encoder-decoder backbone — port of ``repro/models/encdec.py``
(pool arch ``whisper-base``).

The conv/mel frontend is a stub, as in the reference: the caller gives
precomputed frame embeddings ``(B, T_frames, d_model)``.  Sinusoidal positions
are added here; the encoder is bidirectional, the decoder has causal
self-attention and cross-attention over the encoder's output.

Ported: ``EncDecConfig``, ``sinusoid`` (and ``sinusoid_row``), ``enc_block_specs``,
``dec_block_specs``, ``model_specs``, ``encode``, ``_dec_block``,
``forward``, ``loss_fn``, ``cache_specs``, ``prefill`` and ``decode_step``.
As in the rest of the port, the layers are a Python loop over views of the
stacked leaves and the self-attention cache is written in place; ``prefill``
writes the encoder's output into ``cache["enc_out"]`` (in place where its type
and shape are the cache's, else the leaf is replaced, as the reference's
returned cache holds the output as computed).  The encoder and decoder bodies
run under ``remat.remat(cfg.remat_policy, ...)``, as the transformer's
blocks do: the default ``"nothing"`` is what the reference applies whatever
its ``remat_policy`` says, and no policy changes a loss or a gradient
(``remat``).  The decode step adds the
sinusoid's row at its position, computed with the same float32 operations as
the reference's 65536-row table.  Cross-attention recomputes its keys and
values from ``enc_out`` at every decode step, as the reference's
``_dec_block`` does.  On the kernel path every attention goes through the
flash-attention kernel: the encoder's and the cross-attention's with no mask.

On the model axis, in training and prefill, the rank holds its frames and
its positions of the decoder's sequence (the rules' ``sp``): each block
gathers its cut weights whole (``layers.whole``), the encoder's attention
gathers its keys and values over the axis, and its output is gathered
along the frames, so every decoder row's cross-attention sees every frame
and prefill stores ``enc_out`` whole in every rank's cache (its spec is
replicated on "model"); ``loss_fn`` is the rank's share of the mean.
``decode_step`` runs the axis tensor-parallel (``rt.tp``): the
self-attention as the dense family's, the cross-attention over the rank's
columns of every frame (``layers._cross_attention_tp``).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

from . import layers as L
from .param import ParamSpec, cast_floats, round_up, stack_specs
from .remat import remat, unbind_layers


@dataclass(frozen=True)
class EncDecConfig:
    name: str
    n_layers: int               # per stack (encoder AND decoder)
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    n_frames: int = 1500        # stub frontend output length (30 s audio)
    remat_policy: str = "nothing"   # nothing | dots | none: recompute in the backward (remat.remat)
    unroll: bool = False            # kept for field parity; the port always loops
    dtype: torch.dtype = torch.bfloat16

    @property
    def vocab_padded(self) -> int:
        return round_up(self.vocab_size, 256)

    def attn(self, causal: bool) -> L.AttnConfig:
        return L.AttnConfig(
            d_model=self.d_model,
            n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads,
            head_dim=self.head_dim,
            causal=causal,
            rope_theta=None,          # whisper: absolute sinusoidal positions
            qkv_bias=True,
        )


def _sinusoid_at(pos: torch.Tensor, dim: int) -> torch.Tensor:
    """(len(pos), dim) float32 rows of the table at float32 positions ``pos``."""
    div = torch.exp(
        torch.arange(0, dim, 2, dtype=torch.float32, device=pos.device) * (-math.log(10000.0) / dim)
    )
    pe = torch.zeros((pos.shape[0], dim), dtype=torch.float32, device=pos.device)
    pe[:, 0::2] = torch.sin(pos[:, None] * div)
    pe[:, 1::2] = torch.cos(pos[:, None] * div)
    return pe


def sinusoid(max_len: int, dim: int, device=None) -> torch.Tensor:
    """(max_len, dim) float32: sin at the even columns, cos at the odd ones,
    computed in float32 as the reference computes it."""
    return _sinusoid_at(torch.arange(max_len, dtype=torch.float32, device=device), dim)


def sinusoid_row(pos: int, dim: int, device=None) -> torch.Tensor:
    """(1, dim): row ``pos`` of ``sinusoid``, by the same operations."""
    return _sinusoid_at(torch.full((1,), float(pos), dtype=torch.float32, device=device), dim)


def enc_block_specs(cfg: EncDecConfig) -> dict:
    return {
        "ln1": L.layernorm_specs(cfg.d_model),
        "attn": L.attn_specs(cfg.attn(False)),
        "ln2": L.layernorm_specs(cfg.d_model),
        "mlp": L.gelu_mlp_specs(cfg.d_model, cfg.d_ff),
    }


def dec_block_specs(cfg: EncDecConfig) -> dict:
    return {
        "ln1": L.layernorm_specs(cfg.d_model),
        "self_attn": L.attn_specs(cfg.attn(True)),
        "ln_x": L.layernorm_specs(cfg.d_model),
        "cross_attn": L.attn_specs(cfg.attn(False)),
        "ln2": L.layernorm_specs(cfg.d_model),
        "mlp": L.gelu_mlp_specs(cfg.d_model, cfg.d_ff),
    }


def model_specs(cfg: EncDecConfig) -> dict:
    return {
        "embed": L.embed_specs(cfg.vocab_padded, cfg.d_model),
        "enc_blocks": stack_specs(enc_block_specs(cfg), cfg.n_layers),
        "enc_norm": L.layernorm_specs(cfg.d_model),
        "dec_blocks": stack_specs(dec_block_specs(cfg), cfg.n_layers),
        "dec_norm": L.layernorm_specs(cfg.d_model),
    }


def _rows(rt: L.Runtime, n: int, dim: int, device) -> torch.Tensor:
    """The sinusoid's rows of this rank's ``n`` positions: ``[0, n)``, or on
    the model axis in training and prefill ``[r·n, (r+1)·n)`` (by the same
    float32 operations as the whole table's, so the same bits)."""
    first = rt.seq_offset(n)
    return _sinusoid_at(torch.arange(first, first + n, dtype=torch.float32, device=device), dim)


def encode(rt: L.Runtime, cfg: EncDecConfig, params: dict, frames: torch.Tensor) -> torch.Tensor:
    """The bidirectional encoder over frames (B, T, D); params in the compute
    type.  On the model axis (training and prefill) the rank holds its
    frames ``[r·T/m, (r+1)·T/m)`` (the rules' ``sp``), its block's weights
    are gathered whole and its attention's keys and values over the axis,
    and the output is gathered along the frames: every rank returns all
    ``T`` rows, which every decoder row attends to."""
    x = frames.to(cfg.dtype) + _rows(rt, frames.shape[1], cfg.d_model, frames.device).to(cfg.dtype)
    x = rt.shard(x, "batch", "sp", None)
    positions = rt.seq_offset(x.shape[1]) + torch.arange(x.shape[1], device=x.device)
    specs = enc_block_specs(cfg)

    def body(h, lp):
        lp = L.whole(rt, lp, specs)
        a, _ = L.attention(rt, lp["attn"], L.layernorm(lp["ln1"], h), cfg.attn(False), positions)
        h = h + a
        h = h + L.gelu_mlp(rt, lp["mlp"], L.layernorm(lp["ln2"], h))
        return rt.shard(h, "batch", "sp", None)

    block = remat(cfg.remat_policy, body)
    for lp in unbind_layers(params["enc_blocks"], cfg.n_layers):
        x = block(x, lp)
    x = L.layernorm(params["enc_norm"], x)
    return x if rt.model is None else rt.model.gather(x, 1)


def _dec_block(rt, cfg: EncDecConfig, lp, h, enc_out, positions, cache=None, cache_pos=None):
    lp = L.whole(rt, lp, dec_block_specs(cfg))
    a, new_cache = L.attention(
        rt, lp["self_attn"], L.layernorm(lp["ln1"], h), cfg.attn(True),
        positions, cache, cache_pos,
    )
    h = h + a
    c, _ = L.attention(
        rt, lp["cross_attn"], L.layernorm(lp["ln_x"], h), cfg.attn(False),
        positions, kv_override=enc_out,
    )
    h = h + c
    h = h + L.gelu_mlp(rt, lp["mlp"], L.layernorm(lp["ln2"], h))
    return rt.shard(h, "batch", "sp", None), new_cache


def _table(rt, cfg: EncDecConfig, params, key: str) -> dict:
    """``params["embed"][key]``, gathered whole where the rank holds its
    positions (``layers.whole``)."""
    return L.whole(rt, {key: params["embed"][key]}, L.embed_specs(cfg.vocab_padded, cfg.d_model))


def _embed(rt, cfg: EncDecConfig, params, tokens) -> torch.Tensor:
    y = L.embed(rt, _table(rt, cfg, params, "tok"), tokens).to(cfg.dtype)
    return y + _rows(rt, y.shape[1], cfg.d_model, y.device).to(cfg.dtype)


def forward(rt: L.Runtime, cfg: EncDecConfig, params: dict, frames: torch.Tensor,
            tokens: torch.Tensor) -> torch.Tensor:
    """Teacher-forced training forward.  Returns logits (B, S, vocab_padded)."""
    params = cast_floats(params, cfg.dtype)
    enc_out = encode(rt, cfg, params, frames)
    y = _embed(rt, cfg, params, tokens)
    positions = rt.seq_offset(y.shape[1]) + torch.arange(y.shape[1], device=y.device)

    def body(h, lp):
        return _dec_block(rt, cfg, lp, h, enc_out, positions)[0]

    block = remat(cfg.remat_policy, body)
    for lp in unbind_layers(params["dec_blocks"], cfg.n_layers):
        y = block(y, lp)
    y = L.layernorm(params["dec_norm"], y)
    return L.unembed(rt, _table(rt, cfg, params, "unembed"), y)


def loss_fn(rt: L.Runtime, cfg: EncDecConfig, params: dict, batch: dict) -> torch.Tensor:
    """The mean NLL; on the model axis this rank's share of it (its
    positions are ``1/m`` of each sequence)."""
    logits = forward(rt, cfg, params, batch["frames"], batch["tokens"])
    ce = L.cross_entropy(logits, batch["labels"], cfg.vocab_size)
    return ce if rt.model is None else ce / rt.model.size


def cache_specs(cfg: EncDecConfig, batch: int, max_len: int) -> dict:
    kv = L.init_kv_cache(cfg.attn(True), batch, max_len, cfg.n_layers, cfg.dtype)
    kv["enc_out"] = ParamSpec(
        (batch, cfg.n_frames, cfg.d_model),
        ("batch", None, None),
        init="zeros",
        dtype=torch.bfloat16,
    )
    return kv


def prefill(rt: L.Runtime, cfg: EncDecConfig, params: dict, frames: torch.Tensor,
            tokens: torch.Tensor, cache: dict) -> tuple[torch.Tensor, dict]:
    """Encode, and write the decoder's self-attention cache for positions
    [0, S) and the encoder's output; returns the last token's logits."""
    params = cast_floats(params, cfg.dtype)
    enc_out = encode(rt, cfg, params, frames)
    y = _embed(rt, cfg, params, tokens)
    positions = rt.seq_offset(y.shape[1]) + torch.arange(y.shape[1], device=y.device)
    for i, lp in enumerate(unbind_layers(params["dec_blocks"], cfg.n_layers)):
        y, _ = _dec_block(rt, cfg, lp, y, enc_out, positions,
                          cache=(cache["k"][i], cache["v"][i]), cache_pos=0)
    y = L.layernorm(params["dec_norm"], y)
    if cache["enc_out"].dtype == enc_out.dtype and cache["enc_out"].shape == enc_out.shape:
        cache["enc_out"].copy_(enc_out)
    else:
        cache["enc_out"] = enc_out
    logits = L.unembed(rt, _table(rt, cfg, params, "unembed"), y[:, -1:])
    return (logits if rt.model is None else rt.model.last(logits)), cache


def decode_step(rt: L.Runtime, cfg: EncDecConfig, params: dict, tokens: torch.Tensor,
                cache: dict, pos: int) -> tuple[torch.Tensor, dict]:
    """One step of the decoder at position ``pos``: its self-attention over
    the cache, its cross-attention over ``cache["enc_out"]``."""
    if rt.model is not None:
        rt = dataclasses.replace(rt, tp=True)
    params = cast_floats(params, cfg.dtype)
    pos = int(pos)
    enc_out = cache["enc_out"].to(cfg.dtype)
    y = L.embed(rt, params["embed"], tokens).to(cfg.dtype)
    y = y + sinusoid_row(pos, cfg.d_model, y.device).to(cfg.dtype)[None]
    positions = torch.tensor([pos], device=y.device)
    for i, lp in enumerate(unbind_layers(params["dec_blocks"], cfg.n_layers)):
        y, _ = _dec_block(rt, cfg, lp, y, enc_out, positions,
                          cache=(cache["k"][i], cache["v"][i]), cache_pos=pos)
    y = L.layernorm(params["dec_norm"], y)
    return L.unembed(rt, params["embed"], y), cache
