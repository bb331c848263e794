"""granite-4.0-h-small [moe_hybrid]: 40L d_model=4096, 36 Mamba2 layers
(128 heads of 64, state 128, conv 4, chunk 256) and 4 NoPE attention layers
(32 heads, GQA kv=8, head_dim 128), every layer followed by 72 experts
top-10 of width 768 and a shared expert of 1536; vocab=100352, tied
embeddings; embedding x12, residual x0.22, softmax scale 1/128, logits /16
[https://huggingface.co/ibm-granite/granite-4.0-h-small, config.json].

New in the port (the reference has no such config).  The full config
holds every published number; its chunk is 128, the most rows the
``ssd_scan`` kernel holds (the chunked scan computes the same function at
any chunk).  ``--n-layers 10`` trains one whole period of the layer
pattern (five Mamba2 layers, one attention layer, four Mamba2 layers)."""

from repro_torch.models.api import GraniteHybridHarness
from repro_torch.models.granitemoehybrid import GraniteHybridConfig
from repro_torch.models.mamba2 import Mamba2Config
from repro_torch.models.moe import MoEConfig

# the published layer_types: five Mamba2 layers, then (attention, nine Mamba2) repeated
LAYER_TYPES = ("mamba",) * 5 + (("attention",) + ("mamba",) * 9) * 3 + ("attention",) + ("mamba",) * 4


def get_harness(smoke: bool = False) -> GraniteHybridHarness:
    if smoke:
        cfg = GraniteHybridConfig(
            name="granite-4.0-h-smoke", layer_types=("mamba", "attention", "mamba"), d_model=128,
            n_heads=4, n_kv_heads=2, head_dim=32, vocab_size=512,
            mamba=Mamba2Config(d_model=128, d_inner=256, d_state=32, head_dim=32, chunk=64,
                               norm_before_gate=False, norm_eps=1e-5),
            moe=MoEConfig(n_experts=8, topk=2, d_ff=64, shared_d_ff=128, router_aux_coef=0.001),
            embedding_multiplier=12.0, residual_multiplier=0.22, attention_multiplier=1 / 32,
            logits_scaling=16.0,
        )
    else:
        cfg = GraniteHybridConfig(
            name="granite-4.0-h-small", layer_types=LAYER_TYPES, d_model=4096, n_heads=32, n_kv_heads=8,
            head_dim=128, vocab_size=100352,
            mamba=Mamba2Config(d_model=4096, d_inner=8192, d_state=128, head_dim=64, d_conv=4, chunk=128,
                               norm_before_gate=False, norm_eps=1e-5),
            moe=MoEConfig(n_experts=72, topk=10, d_ff=768, shared_d_ff=1536, router_aux_coef=0.001),
            embedding_multiplier=12.0, residual_multiplier=0.22, attention_multiplier=0.0078125,
            logits_scaling=16.0,
        )
    return GraniteHybridHarness("granite-4.0-h-small", cfg)
