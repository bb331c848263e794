"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352,
MoE 16 experts top-4, fine-grained [hf:databricks/dbrx-base; unverified].

Port of ``repro/configs/dbrx_132b.py``: the same numbers.  True
expert-parallel sharding (``strategy="expert_parallel"``) names the
reference's layout; on one device it changes nothing but the logical axis
names of the expert weights."""

from repro_torch.models.api import TransformerHarness
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig


def get_harness(smoke: bool = False) -> TransformerHarness:
    if smoke:
        cfg = LMConfig(
            name="dbrx-smoke", n_layers=2, d_model=128, n_heads=4,
            n_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
            moe=MoEConfig(n_experts=4, topk=2, d_ff=256, strategy="expert_parallel"),
        )
    else:
        cfg = LMConfig(
            name="dbrx-132b", n_layers=40, d_model=6144, n_heads=48,
            n_kv_heads=8, head_dim=128, d_ff=10752, vocab_size=100352,
            moe=MoEConfig(
                n_experts=16, topk=4, d_ff=10752, strategy="expert_parallel"
            ),
        )
    return TransformerHarness("dbrx-132b", cfg, family="moe")
