"""paligemma-3b [vlm]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=257216 — SigLIP frontend STUB (256 precomputed patch embeddings,
bidirectional prefix) + gemma backbone [arXiv:2407.07726; hf].

Port of ``repro/configs/paligemma_3b.py``: the same numbers."""

from repro_torch.models.api import TransformerHarness
from repro_torch.models.transformer import LMConfig


def get_harness(smoke: bool = False) -> TransformerHarness:
    if smoke:
        cfg = LMConfig(
            name="paligemma-smoke", n_layers=2, d_model=128, n_heads=4,
            n_kv_heads=1, head_dim=32, d_ff=256, vocab_size=512,
            embed_scale=True, act="gelu",
        )
        return TransformerHarness(
            "paligemma-3b", cfg, family="vlm", prefix_tokens=8
        )
    cfg = LMConfig(
        name="paligemma-3b", n_layers=18, d_model=2048, n_heads=8,
        n_kv_heads=1, head_dim=256, d_ff=16384, vocab_size=257216,
        embed_scale=True, act="gelu",
    )
    return TransformerHarness(
        "paligemma-3b", cfg, family="vlm", prefix_tokens=256
    )
