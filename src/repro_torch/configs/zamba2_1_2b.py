"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=32000, ssm_state=64 — Mamba2 + shared attn blocks
[arXiv:2411.15242; hf].

Port of ``repro/configs/zamba2_1_2b.py``: the same numbers.  The Mamba2
widths follow from them (``HybridConfig.mamba``): d_inner 4096, 64 heads of
head_dim 64, state size 64, chunk 128; the shared block runs 6 times."""

from repro_torch.models.api import HybridHarness
from repro_torch.models.hybrid import HybridConfig


def get_harness(smoke: bool = False) -> HybridHarness:
    if smoke:
        cfg = HybridConfig(
            name="zamba2-smoke", n_layers=4, d_model=128, n_heads=4,
            n_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512,
            ssm_state=16, share_every=2,
        )
    else:
        cfg = HybridConfig(
            name="zamba2-1.2b", n_layers=38, d_model=2048, n_heads=32,
            n_kv_heads=32, head_dim=64, d_ff=8192, vocab_size=32000,
            ssm_state=64, share_every=6,
        )
    return HybridHarness("zamba2-1.2b", cfg)
