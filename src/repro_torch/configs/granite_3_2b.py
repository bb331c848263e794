"""granite-3-2b [dense]: 40L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=49155 [hf:ibm-granite/granite-3.0-2b-base; hf].

Port of ``repro/configs/granite_3_2b.py``: the same numbers."""

from repro_torch.models.api import TransformerHarness
from repro_torch.models.transformer import LMConfig


def get_harness(smoke: bool = False) -> TransformerHarness:
    if smoke:
        cfg = LMConfig(
            name="granite-3-2b-smoke", n_layers=2, d_model=128, n_heads=4,
            n_kv_heads=2, head_dim=32, d_ff=256, vocab_size=515,
        )
    else:
        cfg = LMConfig(
            name="granite-3-2b", n_layers=40, d_model=2048, n_heads=32,
            n_kv_heads=8, head_dim=64, d_ff=8192, vocab_size=49155,
        )
    return TransformerHarness("granite-3-2b", cfg, family="dense")
