"""The yardstick's arithmetic: the card's peaks and the operations and bytes
that a function needs at a call's shapes.

Frozen copies, so that a change to the program cannot move the yardstick:

- ``flash_work`` is ``_flash_bound_ms`` of ``chip_smoke.py`` (q read and o
  written once, each key and value that some row sees read once; two
  products of 2 flops a multiply-add over the visible (query, key) pairs),
  with the visible pairs counted row by row in numpy instead of from
  ``repro_torch.kernels.flash_attention.visible``;
- ``moe_dispatch_work`` is the ``moe_dispatch`` rows' bound of
  ``chip_smoke.py`` (disp, x and the output each moved once);
- ``ccu_reduce_work`` is the ``ccu_reduce`` rows' bound of ``chip_smoke.py``
  at P peers of int8 with one fp32 scale each, written out in fp32.

Each counts what the function needs, not what a kernel does, so a later
kernel for the same function is read against the same work.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM, NVIDIA's data sheet, dense rates, at its 700 W limit
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def visible_pairs(sq: int, sk: int, *, causal: bool = True, window: int | None = None,
                  q_start: int = 0) -> tuple[int, int]:
    """(query, key) pairs a mask lets through, and the keys some row sees,
    for query rows at positions ``q_start .. q_start + sq - 1`` against
    keys ``0 .. sk - 1``: row q sees ``max(0, q - window + 1) .. q`` when
    causal (``0 .. sk - 1`` when not), the window only where one is given."""
    q = np.arange(q_start, q_start + sq, dtype=np.int64)
    hi = np.minimum(q, sk - 1) if causal else np.full_like(q, sk - 1)
    lo = np.zeros_like(q) if window is None else np.maximum(0, q - window + 1)
    n = np.maximum(0, hi - lo + 1)
    seen = n > 0
    keys = int(hi[seen].max() - lo[seen].min() + 1) if seen.any() else 0
    return int(n.sum()), keys


def flash_work(batch: int, sq: int, sk: int, n_heads: int, n_kv_heads: int, head_dim: int, *,
               causal: bool = True, window: int | None = None, q_start: int = 0,
               elem_bytes: int = 2) -> tuple[float, float]:
    """(flops, bytes) of one flash-attention forward call."""
    pairs, keys = visible_pairs(sq, sk, causal=causal, window=window, q_start=q_start)
    flops = 4 * head_dim * pairs * batch * n_heads
    q_bytes = batch * sq * n_heads * head_dim * elem_bytes
    kv_bytes = 2 * batch * keys * n_kv_heads * head_dim * elem_bytes
    return float(flops), float(2 * q_bytes + kv_bytes)


def moe_dispatch_work(batch: int, seq: int, n_experts: int, capacity: int, d_model: int, topk: int,
                      elem_bytes: int = 2) -> tuple[float, float]:
    """(flops, bytes) of one dispatch ``out[e, b, c, :] = sum_s disp[b, s, e, c] x[b, s, :]``:
    disp, x and out moved once; a multiply-add for each kept (token, choice)
    pair and model column, counted at every pair kept (at most B S K)."""
    disp = batch * seq * n_experts * capacity
    x = batch * seq * d_model
    out = n_experts * batch * capacity * d_model
    return float(2 * batch * seq * topk * d_model), float((disp + x + out) * elem_bytes)


def ccu_reduce_work(n: int, peers: int = 1) -> tuple[float, float]:
    """(flops, bytes) of a fixed-order sum of ``peers`` int8 rows of ``n``
    with one fp32 scale each, written out as fp32."""
    return float(2 * peers * n), float(peers * n + 4 * peers + 4 * n)


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time for a call: the larger of its operations at the bf16
    peak and its bytes at the memory rate."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


# ---------------------------------------------------------------------------
# model FLOPs (no recompute)
# ---------------------------------------------------------------------------


def layer_matmul_params(cfg: dict) -> int:
    """Parameters a token multiplies in one layer: q, k, v, o, and the MLP or
    the router plus ``num_experts_per_tok`` experts."""
    d, h, kv, dh = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    attn = d * h * dh * 2 + d * kv * dh * 2
    f = cfg["intermediate_size"]
    if cfg.get("num_local_experts"):
        return attn + d * cfg["num_local_experts"] + cfg["num_experts_per_tok"] * 3 * d * f
    return attn + 3 * d * f


def attention_forward_flops(cfg: dict, batch: int, seq: int) -> float:
    """Both products of every layer's attention over the visible pairs."""
    pairs, _ = visible_pairs(seq, seq, causal=True, window=cfg.get("sliding_window"))
    return float(4 * cfg["head_dim"] * pairs * batch * cfg["num_attention_heads"] * cfg["num_hidden_layers"])


def train_step_flops(cfg: dict, batch: int, seq: int) -> float:
    """6 N T for the layers and the unembedding, plus attention's forward and
    backward (three times the forward) at the mask."""
    tokens = batch * seq
    n = cfg["num_hidden_layers"] * layer_matmul_params(cfg) + cfg["hidden_size"] * cfg["vocab_size"]
    return 6.0 * n * tokens + 3.0 * attention_forward_flops(cfg, batch, seq)


def prefill_flops(cfg: dict, batch: int, seq: int) -> float:
    """2 N T for the layers, the unembedding of each prompt's last token, and
    attention's forward at the causal mask."""
    layers = 2.0 * cfg["num_hidden_layers"] * layer_matmul_params(cfg) * batch * seq
    return layers + 2.0 * cfg["hidden_size"] * cfg["vocab_size"] * batch + attention_forward_flops(cfg, batch, seq)


def moe_capacity(cfg: dict, seq: int) -> int:
    """Slots per expert and sequence: max(1, int(S K cf / E))."""
    return max(1, int(seq * cfg["num_experts_per_tok"] * cfg["capacity_factor"] / cfg["num_local_experts"]))
