"""The program's granite-4.0-h model, built from a configuration file of
the ``granitemoehybrid`` family: every number the program's
``GraniteHybridConfig``, ``Mamba2Config`` and ``MoEConfig`` take is the
file's.  The experts held are ``num_local_experts`` of the router's
``router_experts`` from ``first_local_expert``."""

from __future__ import annotations


def harness(cfg: dict):
    from repro_torch.models.api import GraniteHybridHarness
    from repro_torch.models.granitemoehybrid import GraniteHybridConfig
    from repro_torch.models.mamba2 import Mamba2Config
    from repro_torch.models.moe import MoEConfig

    fixed = {"mamba_n_groups": 1, "mamba_conv_bias": True, "mamba_proj_bias": False, "attention_bias": False,
             "position_embedding_type": "nope", "tie_word_embeddings": True, "hidden_act": "silu"}
    for key, value in fixed.items():
        if cfg[key] != value:
            raise ValueError(f"the program's granitemoehybrid model has {key}={value!r}, the file {cfg[key]!r}")
    D = cfg["hidden_size"]
    if cfg["mamba_n_heads"] * cfg["mamba_d_head"] != cfg["mamba_expand"] * D:
        raise ValueError("mamba_n_heads * mamba_d_head must be mamba_expand * hidden_size")
    mamba = Mamba2Config(d_model=D, d_inner=cfg["mamba_expand"] * D, d_state=cfg["mamba_d_state"],
                         head_dim=cfg["mamba_d_head"], d_conv=cfg["mamba_d_conv"], chunk=cfg["mamba_chunk_size"],
                         norm_before_gate=False, norm_eps=cfg["rms_norm_eps"])
    moe = MoEConfig(n_experts=cfg["router_experts"], topk=cfg["num_experts_per_tok"], d_ff=cfg["intermediate_size"],
                    capacity_factor=cfg["capacity_factor"], router_aux_coef=cfg["router_aux_loss_coef"],
                    held=(cfg["first_local_expert"], cfg["num_local_experts"]),
                    shared_d_ff=cfg["shared_intermediate_size"])
    lm = GraniteHybridConfig(
        name=cfg["name"], layer_types=tuple(cfg["layer_types"]), d_model=D, n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"], vocab_size=cfg["vocab_size"], mamba=mamba,
        moe=moe, embedding_multiplier=cfg["embedding_multiplier"], residual_multiplier=cfg["residual_multiplier"],
        attention_multiplier=cfg["attention_multiplier"], logits_scaling=cfg["logits_scaling"],
        rms_norm_eps=cfg["rms_norm_eps"], remat_policy=cfg["remat_policy"])
    return GraniteHybridHarness(cfg["name"], lm)
