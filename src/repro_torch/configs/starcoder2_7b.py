"""starcoder2-7b [dense]: 32L d_model=4608 36H (GQA kv=4) d_ff=18432
vocab=49152 — GQA, RoPE, sliding window 4096, LayerNorm+GELU, qkv bias
[arXiv:2402.19173; hf].

Port of ``repro/configs/starcoder2_7b.py``: the same numbers."""

from repro_torch.models.api import TransformerHarness
from repro_torch.models.transformer import LMConfig


def get_harness(smoke: bool = False) -> TransformerHarness:
    if smoke:
        cfg = LMConfig(
            name="starcoder2-smoke", n_layers=2, d_model=96, n_heads=3,
            n_kv_heads=1, head_dim=32, d_ff=192, vocab_size=512,
            norm="ln", act="gelu", window=64, qkv_bias=True,
        )
    else:
        cfg = LMConfig(
            name="starcoder2-7b", n_layers=32, d_model=4608, n_heads=36,
            n_kv_heads=4, head_dim=128, d_ff=18432, vocab_size=49152,
            norm="ln", act="gelu", window=4096, qkv_bias=True,
        )
    return TransformerHarness("starcoder2-7b", cfg, family="dense")
