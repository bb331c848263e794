"""phi4-mini-3.8b [dense]: 32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064 — RoPE SwiGLU GQA [arXiv:2412.08905; hf].

Port of ``repro/configs/phi4_mini_3_8b.py``: the same numbers."""

from repro_torch.models.api import TransformerHarness
from repro_torch.models.transformer import LMConfig


def get_harness(smoke: bool = False) -> TransformerHarness:
    if smoke:
        cfg = LMConfig(
            name="phi4-mini-smoke", n_layers=2, d_model=96, n_heads=3,
            n_kv_heads=1, head_dim=32, d_ff=192, vocab_size=512,
        )
    else:
        cfg = LMConfig(
            name="phi4-mini-3.8b", n_layers=32, d_model=3072, n_heads=24,
            n_kv_heads=8, head_dim=128, d_ff=8192, vocab_size=200064,
        )
    return TransformerHarness("phi4-mini-3.8b", cfg, family="dense")
