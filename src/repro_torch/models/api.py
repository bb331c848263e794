"""Unified model harness — port of ``repro/models/api.py`` (``ShapeCell``,
``SHAPES``, ``Harness``, ``TransformerHarness``, ``RWKVHarness``,
``HybridHarness``, ``EncDecHarness``): one interface over all ten
architectures.  New in the port: ``GraniteHybridHarness``
(granite-4.0-h-small, ``models/granitemoehybrid.py``), training only.

Each architecture config (``repro_torch/configs/<id>.py``) builds a Harness
that exposes ``param_specs()``, ``prefill(rt)`` / ``decode(rt)`` (serving
callables), ``serve_state_specs(cell)`` (KV-cache or recurrent-state spec
tree), ``serve_input_specs(cell)`` and ``skip_reason(shape)``, and the training
half, ``loss(rt)`` (a callable ``(params, batch) -> loss``) and
``train_input_specs(cell)``.

``RWKVHarness.prefill`` and ``HybridHarness.prefill`` differ from the
reference's on purpose: they return the state the prompt leaves
(``rwkv_lm.prefill``, ``hybrid.prefill``), where the reference's return the
state they were given, so that their decode would start from a zero state and
ignore the prompt.
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass
from typing import Any, Callable

import torch

from . import encdec, granitemoehybrid, hybrid, rwkv_lm, transformer
from .layers import Runtime
from .param import ParamSpec


@dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524_288, 1),
}

TOKENS = torch.int32
POS = torch.int32


def _tok(shape, logical):
    return ParamSpec(shape, logical, init="zeros", dtype=TOKENS)


class Harness:
    """Base interface; family subclasses below."""

    arch_id: str = ""
    family: str = ""
    long_context_ok: bool = False
    moe_strategy: str | None = None

    def skip_reason(self, shape: str) -> str | None:
        if shape == "long_500k" and not self.long_context_ok:
            return "full quadratic attention — sub-quadratic required (DESIGN.md §4)"
        return None

    def clone(self, **cfg_updates) -> "Harness":
        """Same harness with a modified config."""
        new = copy.copy(self)
        new.cfg = dataclasses.replace(self.cfg, **cfg_updates)
        return new

    # subclasses implement:
    def param_specs(self) -> Any: ...
    def loss(self, rt: Runtime) -> Callable: ...
    def train_input_specs(self, cell: ShapeCell) -> dict: ...
    def prefill(self, rt: Runtime) -> Callable: ...
    def decode(self, rt: Runtime) -> Callable: ...
    def serve_state_specs(self, cell: ShapeCell) -> Any: ...
    def serve_input_specs(self, cell: ShapeCell) -> dict: ...


def _embeds(B: int, P: int, D: int) -> ParamSpec:
    """A stub frontend's output (paligemma's patches, whisper's frames)."""
    return ParamSpec((B, P, D), ("batch", "sp", None), init="normal", dtype=torch.bfloat16)


class TransformerHarness(Harness):
    """Dense, MoE and VLM-backbone decoder-only transformers.  A VLM
    (``prefix_tokens`` > 0) takes ``prefix_embeds (B, prefix_tokens,
    d_model)`` in training and prefill, before the tokens."""

    def __init__(
        self,
        arch_id: str,
        cfg: transformer.LMConfig,
        *,
        family: str = "dense",
        prefix_tokens: int = 0,          # VLM stub patches (prepended)
        long_context_ok: bool = False,
    ):
        self.arch_id = arch_id
        self.cfg = cfg
        self.family = family
        self.prefix_tokens = prefix_tokens
        self.long_context_ok = long_context_ok
        self.moe_strategy = cfg.moe.strategy if cfg.moe else None

    def param_specs(self):
        return transformer.lm_specs(self.cfg)

    # -- training -----------------------------------------------------------
    def loss(self, rt: Runtime):
        def fn(params, batch):
            return transformer.loss_fn(rt, self.cfg, params, batch)

        return fn

    def train_input_specs(self, cell: ShapeCell) -> dict:
        B, S = cell.global_batch, cell.seq_len
        specs = {
            "tokens": _tok((B, S), ("batch", "sp")),
            "labels": _tok((B, S), ("batch", "sp")),
        }
        if self.prefix_tokens:
            specs["prefix_embeds"] = _embeds(B, self.prefix_tokens, self.cfg.d_model)
        return specs

    # -- serving ------------------------------------------------------------
    def serve_state_specs(self, cell: ShapeCell):
        max_len = cell.seq_len + self.prefix_tokens
        if self.cfg.window is not None and cell.name == "long_500k":
            # SWA: the live window bounds the cache; window+slack keeps the
            # mask exact
            max_len = min(max_len, self.cfg.window * 2)
        return transformer.cache_specs(self.cfg, cell.global_batch, max_len)

    def serve_input_specs(self, cell: ShapeCell) -> dict:
        B = cell.global_batch
        if cell.kind == "prefill":
            specs = {"tokens": _tok((B, cell.seq_len), ("batch", "sp"))}
            if self.prefix_tokens:
                specs["prefix_embeds"] = _embeds(B, self.prefix_tokens, self.cfg.d_model)
            return specs
        return {
            "tokens": _tok((B, 1), ("batch", None)),
            "pos": ParamSpec((), (), init="zeros", dtype=POS),
        }

    def prefill(self, rt: Runtime):
        def fn(params, cache, tokens, prefix_embeds=None):
            return transformer.prefill(rt, self.cfg, params, tokens, cache, prefix_embeds)

        return fn

    def decode(self, rt: Runtime):
        def fn(params, cache, tokens, pos):
            return transformer.decode_step(rt, self.cfg, params, tokens, cache, pos)

        return fn


class RWKVHarness(Harness):
    """RWKV-6: attention-free, a recurrent state of fixed size per layer.

    ``prefill`` differs from the reference's (``RWKVHarness.prefill``, which
    scores the prompt with ``forward`` and returns the state it was given):
    it returns the state the prompt leaves, so that decode continues from
    the prompt (``rwkv_lm.prefill``)."""

    family = "ssm"
    long_context_ok = True

    def __init__(self, arch_id: str, cfg: rwkv_lm.RWKVLMConfig):
        self.arch_id = arch_id
        self.cfg = cfg

    def param_specs(self):
        return rwkv_lm.lm_specs(self.cfg)

    # -- training -----------------------------------------------------------
    def loss(self, rt: Runtime):
        def fn(params, batch):
            return rwkv_lm.loss_fn(rt, self.cfg, params, batch)

        return fn

    def train_input_specs(self, cell: ShapeCell) -> dict:
        B, S = cell.global_batch, cell.seq_len
        return {
            "tokens": _tok((B, S), ("batch", None)),
            "labels": _tok((B, S), ("batch", None)),
        }

    # -- serving ------------------------------------------------------------
    def serve_state_specs(self, cell: ShapeCell):
        return rwkv_lm.state_specs(self.cfg, cell.global_batch)

    def serve_input_specs(self, cell: ShapeCell) -> dict:
        B = cell.global_batch
        if cell.kind == "prefill":
            return {"tokens": _tok((B, cell.seq_len), ("batch", None))}
        return {
            "tokens": _tok((B, 1), ("batch", None)),
            "pos": ParamSpec((), (), init="zeros", dtype=POS),
        }

    def prefill(self, rt: Runtime):
        def fn(params, state, tokens):
            return rwkv_lm.prefill(rt, self.cfg, params, tokens, state)

        return fn

    def decode(self, rt: Runtime):
        def fn(params, state, tokens, pos):
            return rwkv_lm.decode_step(rt, self.cfg, params, tokens, state, pos)

        return fn


class HybridHarness(Harness):
    """Zamba2: a Mamba2 backbone with a shared attention block."""

    family = "hybrid"
    long_context_ok = True

    def __init__(self, arch_id: str, cfg: hybrid.HybridConfig):
        self.arch_id = arch_id
        self.cfg = cfg

    def param_specs(self):
        return hybrid.lm_specs(self.cfg)

    # -- training -----------------------------------------------------------
    def loss(self, rt: Runtime):
        def fn(params, batch):
            return hybrid.loss_fn(rt, self.cfg, params, batch)

        return fn

    def train_input_specs(self, cell: ShapeCell) -> dict:
        B, S = cell.global_batch, cell.seq_len
        return {
            "tokens": _tok((B, S), ("batch", "sp")),
            "labels": _tok((B, S), ("batch", "sp")),
        }

    # -- serving ------------------------------------------------------------
    def serve_state_specs(self, cell: ShapeCell):
        # the shared attention block's KV grows with context; capped per shape
        return hybrid.state_specs(self.cfg, cell.global_batch, cell.seq_len)

    def serve_input_specs(self, cell: ShapeCell) -> dict:
        B = cell.global_batch
        if cell.kind == "prefill":
            return {"tokens": _tok((B, cell.seq_len), ("batch", "sp"))}
        return {
            "tokens": _tok((B, 1), ("batch", None)),
            "pos": ParamSpec((), (), init="zeros", dtype=POS),
        }

    def prefill(self, rt: Runtime):
        def fn(params, state, tokens):
            return hybrid.prefill(rt, self.cfg, params, tokens, state)

        return fn

    def decode(self, rt: Runtime):
        def fn(params, state, tokens, pos):
            return hybrid.decode_step(rt, self.cfg, params, tokens, state, pos)

        return fn


class EncDecHarness(Harness):
    """Whisper: an encoder over stub frame embeddings and a decoder with
    self-attention and cross-attention over its output."""

    family = "audio"
    long_context_ok = False

    def __init__(self, arch_id: str, cfg: encdec.EncDecConfig):
        self.arch_id = arch_id
        self.cfg = cfg

    def param_specs(self):
        return encdec.model_specs(self.cfg)

    # -- training -----------------------------------------------------------
    def loss(self, rt: Runtime):
        def fn(params, batch):
            return encdec.loss_fn(rt, self.cfg, params, batch)

        return fn

    def train_input_specs(self, cell: ShapeCell) -> dict:
        B, S = cell.global_batch, cell.seq_len
        return {
            "frames": _embeds(B, self.cfg.n_frames, self.cfg.d_model),
            "tokens": _tok((B, S), ("batch", "sp")),
            "labels": _tok((B, S), ("batch", "sp")),
        }

    # -- serving ------------------------------------------------------------
    def serve_state_specs(self, cell: ShapeCell):
        return encdec.cache_specs(self.cfg, cell.global_batch, cell.seq_len)

    def serve_input_specs(self, cell: ShapeCell) -> dict:
        B = cell.global_batch
        if cell.kind == "prefill":
            return {
                "frames": _embeds(B, self.cfg.n_frames, self.cfg.d_model),
                "tokens": _tok((B, cell.seq_len), ("batch", "sp")),
            }
        return {
            "tokens": _tok((B, 1), ("batch", None)),
            "pos": ParamSpec((), (), init="zeros", dtype=POS),
        }

    def prefill(self, rt: Runtime):
        def fn(params, cache, frames, tokens):
            return encdec.prefill(rt, self.cfg, params, frames, tokens, cache)

        return fn

    def decode(self, rt: Runtime):
        def fn(params, cache, tokens, pos):
            return encdec.decode_step(rt, self.cfg, params, tokens, cache, pos)

        return fn


class GraniteHybridHarness(Harness):
    """Granite 4.0-H: Mamba2 and NoPE attention mixers, each followed by
    sparse experts and a shared expert (``models/granitemoehybrid.py``).
    Training only: serving it is not ported, and every serving method
    raises.  ``clone(n_layers=n)`` keeps the first n of ``layer_types``."""

    family = "moe_hybrid"

    def __init__(self, arch_id: str, cfg: granitemoehybrid.GraniteHybridConfig):
        self.arch_id = arch_id
        self.cfg = cfg
        self.moe_strategy = cfg.moe.strategy

    def clone(self, **cfg_updates) -> "GraniteHybridHarness":
        if "n_layers" in cfg_updates:
            cfg_updates["layer_types"] = self.cfg.layer_types[:cfg_updates.pop("n_layers")]
        return super().clone(**cfg_updates)

    def param_specs(self):
        return granitemoehybrid.lm_specs(self.cfg)

    # -- training -----------------------------------------------------------
    def loss(self, rt: Runtime):
        def fn(params, batch):
            return granitemoehybrid.loss_fn(rt, self.cfg, params, batch)

        return fn

    def train_input_specs(self, cell: ShapeCell) -> dict:
        B, S = cell.global_batch, cell.seq_len
        return {
            "tokens": _tok((B, S), ("batch", None)),
            "labels": _tok((B, S), ("batch", None)),
        }

    # -- serving: not ported --------------------------------------------------
    def _no_serving(self, *_):
        raise NotImplementedError(
            f"{self.arch_id}: serving (prefill and decode through launch/serve.run) is not ported for "
            "the granitemoehybrid family; it trains through launch/train.run")

    serve_state_specs = serve_input_specs = prefill = decode = _no_serving
