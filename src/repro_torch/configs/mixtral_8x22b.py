"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, SWA [arXiv:2401.04088; hf].

Port of ``repro/configs/mixtral_8x22b.py``: the same numbers.  Expert-TP
sharding (``strategy="expert_tp"``) names the reference's layout; on one
device it changes nothing but the logical axis names of the expert weights."""

from repro_torch.models.api import TransformerHarness
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig


def get_harness(smoke: bool = False) -> TransformerHarness:
    if smoke:
        cfg = LMConfig(
            name="mixtral-smoke", n_layers=2, d_model=128, n_heads=4,
            n_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512, window=64,
            moe=MoEConfig(n_experts=4, topk=2, d_ff=256, strategy="expert_tp"),
        )
    else:
        cfg = LMConfig(
            name="mixtral-8x22b", n_layers=56, d_model=6144, n_heads=48,
            n_kv_heads=8, head_dim=128, d_ff=16384, vocab_size=32768,
            window=4096,
            moe=MoEConfig(n_experts=8, topk=2, d_ff=16384, strategy="expert_tp"),
        )
    return TransformerHarness(
        "mixtral-8x22b", cfg, family="moe", long_context_ok=True
    )
