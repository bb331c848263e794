"""The decoder-only transformer family (``"family": "decoder"``): its weight
layout and its plain reference.  Reference side: imports nothing of the
program.

``leaf_specs`` is the layout, written from the configuration file: the
program's key names, the layers stacked on a leading dim, the table's rows
the vocabulary rounded up to 256.  ``attention_bias`` adds the biases of
q, k, v and the output projection.

``Reference`` computes, in float32 (``reference.Plain``):

- pre-norm blocks of RMSNorm, grouped-query attention with rotary
  embeddings (and the attention's biases where the file has them), and a
  SwiGLU MLP or sparse experts;
- the experts: a top-k router (softmax, the k best, their weights
  renormalised) over experts that each take at most ``capacity`` tokens of
  a sequence, the first choices of every token before the second, overflow
  dropped, and the Switch load-balancing loss weighed by
  ``router_aux_loss_coef``;
- untied token table and unembedding, the mean cross-entropy over the
  vocabulary.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils import checkpoint

from chipbench import reference, weights


def leaf_specs(cfg: dict) -> list[tuple[tuple[str, ...], tuple[int, ...], str, float]]:
    """``(path, shape, init, std)`` of every leaf, in sorted path order."""
    L, D = cfg["num_hidden_layers"], cfg["hidden_size"]
    N, K, Dh, F_ = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"], cfg["intermediate_size"]
    V = weights.vocab_padded(cfg)
    specs = {
        ("embed", "tok"): ((V, D), "normal", 0.02),
        ("embed", "unembed"): ((D, V), "scaled", D ** -0.5),
        ("final_norm",): ((D,), "ones", 0.0),
        ("blocks", "ln1"): ((L, D), "ones", 0.0),
        ("blocks", "ln2"): ((L, D), "ones", 0.0),
        ("blocks", "attn", "wq"): ((L, D, N * Dh), "scaled", D ** -0.5),
        ("blocks", "attn", "wk"): ((L, D, K * Dh), "scaled", D ** -0.5),
        ("blocks", "attn", "wv"): ((L, D, K * Dh), "scaled", D ** -0.5),
        ("blocks", "attn", "wo"): ((L, N * Dh, D), "scaled", (N * Dh) ** -0.5),
    }
    if cfg.get("attention_bias"):
        specs[("blocks", "attn", "bq")] = ((L, N * Dh), "normal", 0.02)
        specs[("blocks", "attn", "bk")] = ((L, K * Dh), "normal", 0.02)
        specs[("blocks", "attn", "bv")] = ((L, K * Dh), "normal", 0.02)
        specs[("blocks", "attn", "bo")] = ((L, D), "normal", 0.02)
    E = cfg.get("num_local_experts")
    if E:
        specs[("blocks", "moe", "router")] = ((L, D, E), "scaled", D ** -0.5)
        specs[("blocks", "moe", "w_gate")] = ((L, E, D, F_), "scaled", D ** -0.5)
        specs[("blocks", "moe", "w_up")] = ((L, E, D, F_), "scaled", D ** -0.5)
        specs[("blocks", "moe", "w_down")] = ((L, E, F_, D), "scaled", F_ ** -0.5)
    else:
        specs[("blocks", "mlp", "w_gate")] = ((L, D, F_), "scaled", D ** -0.5)
        specs[("blocks", "mlp", "w_up")] = ((L, D, F_), "scaled", D ** -0.5)
        specs[("blocks", "mlp", "w_down")] = ((L, F_, D), "scaled", F_ ** -0.5)
    return [(path, *specs[path]) for path in sorted(specs)]


class Reference(reference.Plain):
    def moe(self, h: torch.Tensor, p: dict) -> tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        B, S, D = h.shape
        E, K = cfg["num_local_experts"], cfg["num_experts_per_tok"]
        C = max(1, int(S * K * cfg["capacity_factor"] / E))
        probs = torch.softmax(self.mm(h, p["router"]), dim=-1)                  # (B, S, E)
        idx = torch.sort(probs.detach(), dim=-1, descending=True, stable=True)[1][..., :K]
        gate = torch.gather(probs, -1, idx)
        gate = gate / torch.clamp(gate.sum(dim=-1, keepdim=True), min=1e-9)
        onehot = F.one_hot(idx, E).float()                                      # (B, S, K, E)
        flat = onehot.transpose(1, 2).reshape(B, K * S, E)                      # first choices first
        pos = (torch.cumsum(flat, dim=1) - flat).reshape(B, K, S, E).transpose(1, 2)
        keep = (pos * onehot).sum(-1) < C                                       # (B, S, K)
        gate = gate * keep
        hf = h.reshape(B * S, D)
        y = torch.zeros_like(hf)
        for e in range(E):
            sel = (idx == e) & keep
            rows = sel.any(-1).reshape(-1).nonzero()[:, 0]
            if rows.numel() == 0:
                continue
            w = (gate * sel).sum(-1).reshape(-1)[rows]
            xe = hf[rows]
            he = F.silu(self.mm(xe, p["w_gate"][e])) * self.mm(xe, p["w_up"][e])
            y = y.index_add(0, rows, self.mm(he, p["w_down"][e]) * w[:, None])
        me = onehot.sum(2).mean(dim=(0, 1)) / K
        ce = probs.mean(dim=(0, 1))
        return y.reshape(B, S, D), cfg["router_aux_loss_coef"] * E * torch.sum(me * ce)

    def layer(self, x: torch.Tensor, p: dict) -> tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        B, S, D = x.shape
        N, K, Dh = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
        zero = torch.zeros((), device=x.device)
        pos = torch.arange(S, device=x.device)
        h = self.rmsnorm(x, p["ln1"])
        q = self.mm(h, p["wq"]) + p.get("bq", zero)
        k = self.mm(h, p["wk"]) + p.get("bk", zero)
        v = self.mm(h, p["wv"]) + p.get("bv", zero)
        q = self.rope(q.reshape(B, S, N, Dh), pos)
        k = self.rope(k.reshape(B, S, K, Dh), pos)
        x = x + self.mm(self.attention(q, k, v.reshape(B, S, K, Dh)), p["wo"]) + p.get("bo", zero)
        h = self.rmsnorm(x, p["ln2"])
        if cfg.get("num_local_experts"):
            m, aux = self.moe(h, p)
        else:
            m = self.mm(F.silu(self.mm(h, p["w_gate"])) * self.mm(h, p["w_up"]), p["w_down"])
            aux = zero
        return x + m, aux

    @staticmethod
    def _layer_weights(tree: dict, i: int, cast=lambda t: t) -> dict:
        b = tree["blocks"]
        p = {"ln1": b["ln1"][i], "ln2": b["ln2"][i], **{k: t[i] for k, t in b["attn"].items()}}
        mlp = b["moe"] if "moe" in b else b["mlp"]
        p.update({k: mlp[k][i] for k in mlp})
        return {k: cast(t) for k, t in p.items()}

    def logits_of(self, tree: dict, x: torch.Tensor) -> torch.Tensor:
        lg = self.mm(self.rmsnorm(x, tree["final_norm"].float()), tree["embed"]["unembed"].float())
        return lg[..., :self.cfg["vocab_size"]]

    @torch.no_grad()
    def last_logits(self, tree: dict, tokens: torch.Tensor) -> torch.Tensor:
        """Logits (fp32, the real vocabulary) at each prompt's last position,
        (B, V), from a tree of bf16 weights cast to fp32 a layer at a time."""
        x = tree["embed"]["tok"][tokens.long()].float()
        for i in range(self.cfg["num_hidden_layers"]):
            x, _ = self.layer(x, self._layer_weights(tree, i, lambda t: t.float()))
        return self.logits_of(tree, x[:, -1])

    def loss(self, tree: dict, tokens: torch.Tensor, labels: torch.Tensor, positions: int | None = None
             ) -> torch.Tensor:
        """The mean loss over the batch (over its first ``positions``
        positions where given: a fault the check has to catch)."""
        x = tree["embed"]["tok"][tokens.long()]
        aux = torch.zeros((), device=x.device)
        for i in range(self.cfg["num_hidden_layers"]):
            x, a = checkpoint.checkpoint(self.layer, x, self._layer_weights(tree, i), use_reentrant=False)
            aux = aux + a
        lg = self.logits_of(tree, x)
        nll = torch.logsumexp(lg, dim=-1) - torch.gather(lg, -1, labels.long()[..., None])[..., 0]
        return (nll if positions is None else nll[:, :positions]).mean() + aux
