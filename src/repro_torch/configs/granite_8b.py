"""granite-8b [dense]: 36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152
— llama-arch, code model [arXiv:2405.04324; hf].

Port of ``repro/configs/granite_8b.py``: the same numbers."""

from repro_torch.models.api import TransformerHarness
from repro_torch.models.transformer import LMConfig


def get_harness(smoke: bool = False) -> TransformerHarness:
    if smoke:
        cfg = LMConfig(
            name="granite-8b-smoke", n_layers=2, d_model=128, n_heads=4,
            n_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
        )
    else:
        cfg = LMConfig(
            name="granite-8b", n_layers=36, d_model=4096, n_heads=32,
            n_kv_heads=8, head_dim=128, d_ff=14336, vocab_size=49152,
        )
    return TransformerHarness("granite-8b", cfg, family="dense")
