"""The program's decoder-only transformer (dense or with sparse experts),
built from a configuration file of the ``decoder`` family: every number the
program's ``LMConfig`` and ``MoEConfig`` take is the file's."""

from __future__ import annotations


def harness(cfg: dict):
    from repro_torch.models.api import TransformerHarness
    from repro_torch.models.moe import MoEConfig
    from repro_torch.models.transformer import LMConfig

    moe = None
    if cfg.get("num_local_experts"):
        moe = MoEConfig(n_experts=cfg["num_local_experts"], topk=cfg["num_experts_per_tok"],
                        d_ff=cfg["intermediate_size"], strategy="expert_tp",
                        capacity_factor=cfg["capacity_factor"], router_aux_coef=cfg["router_aux_loss_coef"])
    lm = LMConfig(name=cfg["name"], n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
                  n_heads=cfg["num_attention_heads"], n_kv_heads=cfg["num_key_value_heads"],
                  head_dim=cfg["head_dim"], d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
                  window=cfg.get("sliding_window"), rope_theta=cfg["rope_theta"],
                  qkv_bias=bool(cfg.get("attention_bias")), moe=moe, remat_policy=cfg["remat_policy"])
    return TransformerHarness(cfg["name"], lm, family="moe" if moe else "dense")
