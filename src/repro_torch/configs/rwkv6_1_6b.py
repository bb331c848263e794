"""rwkv6-1.6b [ssm]: 24L d_model=2048 (attn-free) d_ff=7168 vocab=65536
— Finch, data-dependent decay [arXiv:2404.05892; unverified].

Port of ``repro/configs/rwkv6_1_6b.py``: the same numbers.  The time-mix
widths follow from them (``RWKVLMConfig.inner``): 32 heads of head_dim 64,
decay LoRA rank 64, chunk 128; 1,584,046,080 parameters."""

from repro_torch.models.api import RWKVHarness
from repro_torch.models.rwkv_lm import RWKVLMConfig


def get_harness(smoke: bool = False) -> RWKVHarness:
    if smoke:
        cfg = RWKVLMConfig(
            name="rwkv6-smoke", n_layers=2, d_model=128, d_ff=256,
            vocab_size=512, head_dim=32, chunk=16,
        )
    else:
        cfg = RWKVLMConfig(
            name="rwkv6-1.6b", n_layers=24, d_model=2048, d_ff=7168,
            vocab_size=65536, head_dim=64,
        )
    return RWKVHarness("rwkv6-1.6b", cfg)
