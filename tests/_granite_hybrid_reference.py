"""A plain float32 reference of granite-4.0-h (``granitemoehybrid``) for the
port's CPU tests: the forward, the loss and, through autograd, the
gradients, in plain PyTorch with TF32 off.  It imports neither JAX nor
anything of the port, and takes the port's parameter tree
(``models/granitemoehybrid.lm_specs``: ``mamba_blocks``, ``attn_blocks``,
``ffn_blocks``, the tied ``embed.tok``, ``final_norm``) and a configuration
dict with the published ``config.json`` names.
``chipbench/models/granitemoehybrid.py`` holds a frozen copy of it for the
benchmark's check.

The equations are those of ``transformers``' ``GraniteMoeHybrid``: the
embedding times ``embedding_multiplier``; each layer ``h = x + r *
mixer(rmsnorm(x))``, ``x = h + r * (moe(u) + shared(u))``, ``u =
rmsnorm(h)``; the Mamba2 mixer with a causal ``conv1d`` and its bias, the
minimal SSD's chunked scan (``_segsum``), the gate before the norm
(``rmsnorm(y * silu(z))``); NoPE attention at the scale
``attention_multiplier``; the router over ``router_experts``, a softmax over
its ``num_experts_per_tok`` largest logits, GShard capacity over every
expert and only the held experts' part (``first_local_expert``,
``num_local_experts``), the shared expert on every token, the Switch
auxiliary loss; the tied logits over ``logits_scaling``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils import checkpoint

QUERY_BLOCK = 1024


class _Plain:
    """float32 products with TF32 off; RMSNorm at the file's eps."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def _q(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return a @ b

    def rmsnorm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + self.cfg["rms_norm_eps"]) * w


def _dims(cfg: dict) -> dict:
    D = cfg["hidden_size"]
    DI = cfg["mamba_expand"] * D
    N, H = cfg["mamba_d_state"], cfg["mamba_n_heads"]
    return dict(D=D, DI=DI, N=N, H=H, P=DI // H, conv=DI + 2 * N, proj=2 * DI + 2 * N + H,
                Lm=cfg["layer_types"].count("mamba"), La=cfg["layer_types"].count("attention"),
                L=len(cfg["layer_types"]))


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """``out[..., i, j] = x[..., j+1] + ... + x[..., i]`` for ``i >= j``, else
    -inf (the minimal SSD's stable segment sum)."""
    T = x.shape[-1]
    x = x[..., None].expand(*x.shape, T)
    below = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device), -1)
    sums = torch.cumsum(x.masked_fill(~below, 0.0), dim=-2)
    on = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device), 0)
    return sums.masked_fill(~on, -torch.inf)


class Reference(_Plain):
    def ein(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """A product of two operands, each as the control rounds it."""
        return torch.einsum(eq, self._q(a), self._q(b))

    def ssd(self, x: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
        """y (b, s, h, p) of ``h_t = exp(a_t) h_{t-1} + x_t B_t^T``, ``y_t =
        h_t C_t``, from a zero state: x (b, s, h, p), a (b, s, h), B and C
        (b, s, n), in chunks of ``mamba_chunk_size``."""
        b, s, h, p = x.shape
        n = Bm.shape[-1]
        q = min(self.cfg["mamba_chunk_size"], s)
        if s % q:
            raise ValueError(f"sequence {s} not a multiple of the chunk {q}")
        c = s // q
        X, Bc, Cc = x.reshape(b, c, q, h, p), Bm.reshape(b, c, q, n), Cm.reshape(b, c, q, n)
        A = a.reshape(b, c, q, h).permute(0, 3, 1, 2)                         # (b, h, c, q)
        cum = torch.cumsum(A, dim=-1)
        att = self.ein("bcin,bcjn->bcij", Cc, Bc)[:, None] * torch.exp(_segsum(A))   # (b, h, c, i, j)
        y_diag = self.ein("bhcij,bcjhp->bcihp", att, X)
        # each chunk's own state, then the states carried from chunk to chunk
        decay_in = torch.exp(cum[..., -1:] - cum)                              # (b, h, c, q)
        states = self.ein("bcjn,bcjhp->bchpn", Bc, X * decay_in.permute(0, 2, 3, 1)[..., None])
        states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
        decay_chunk = torch.exp(_segsum(F.pad(cum[..., -1], (1, 0))))          # (b, h, c + 1, c + 1)
        carried = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)[:, :-1]
        y_off = self.ein("bcin,bchpn->bcihp", Cc, carried) * torch.exp(cum).permute(0, 2, 3, 1)[..., None]
        return (y_diag + y_off).reshape(b, s, h, p)

    def mamba(self, u: torch.Tensor, p: dict) -> torch.Tensor:
        d = _dims(self.cfg)
        B, S, _ = u.shape
        DI, N, H, P = d["DI"], d["N"], d["H"], d["P"]
        z, xbc, dt = torch.split(self.mm(u, p["in_proj"]), [DI, DI + 2 * N, H], dim=-1)
        K = p["conv_w"].shape[0]
        xbc = F.conv1d(xbc.transpose(1, 2), p["conv_w"].t()[:, None, :], p["conv_b"], padding=K - 1,
                       groups=d["conv"])[..., :S].transpose(1, 2)
        x, Bm, Cm = torch.split(F.silu(xbc), [DI, N, N], dim=-1)
        dt = F.softplus(dt + p["dt_bias"])
        xh = x.reshape(B, S, H, P)
        y = self.ssd(xh * dt[..., None], dt * -torch.exp(p["A_log"]), Bm, Cm) + xh * p["D"][:, None]
        y = self.rmsnorm(y.reshape(B, S, DI) * F.silu(z), p["out_norm"])
        return self.mm(y, p["out_proj"])

    def attention(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """q (B, S, N, Dh), k/v (B, S, K, Dh): causal GQA, no positional
        encoding, the scores times ``attention_multiplier``, in blocks of
        query rows."""
        B, S, N, Dh = q.shape
        K = k.shape[2]
        qg = q.reshape(B, S, K, N // K, Dh)
        kq, vq = self._q(k), self._q(v)
        out = []
        for lo in range(0, S, QUERY_BLOCK):
            hi = min(S, lo + QUERY_BLOCK)
            s = torch.einsum("bqkgd,bskd->bkgqs", self._q(qg[:, lo:hi]), kq[:, :hi]) * self.cfg["attention_multiplier"]
            ok = torch.arange(hi, device=q.device)[None, :] <= torch.arange(lo, hi, device=q.device)[:, None]
            pr = torch.softmax(s.masked_fill(~ok, float("-inf")), dim=-1)
            out.append(torch.einsum("bkgqs,bskd->bqkgd", self._q(pr), vq[:, :hi]))
        return torch.cat(out, dim=1).reshape(B, S, N * Dh)

    def attn(self, u: torch.Tensor, p: dict) -> torch.Tensor:
        cfg = self.cfg
        B, S, _ = u.shape
        N, K, Dh = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
        q, k, v = (self.mm(u, p[w]).reshape(B, S, n, Dh) for w, n in (("wq", N), ("wk", K), ("wv", K)))
        return self.mm(self.attention(q, k, v), p["wo"])

    def moe(self, u: torch.Tensor, p: dict) -> tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        B, S, D = u.shape
        E, K, lo = cfg["router_experts"], cfg["num_experts_per_tok"], cfg["first_local_expert"]
        C = max(1, int(S * K * cfg["capacity_factor"] / E))
        logits = self.mm(u, p["router"])                                       # (B, S, E)
        top, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
        gate, idx = torch.softmax(top[..., :K], dim=-1), idx[..., :K]
        onehot = F.one_hot(idx, E).float()                                     # (B, S, K, E)
        flat = onehot.transpose(1, 2).reshape(B, K * S, E)                     # first choices first
        pos = (torch.cumsum(flat, dim=1) - flat).reshape(B, K, S, E).transpose(1, 2)
        keep = (pos * onehot).sum(-1) < C                                      # (B, S, K)
        gate = gate * keep
        uf = u.reshape(B * S, D)
        y = torch.zeros_like(uf)
        for e in range(lo, lo + cfg["num_local_experts"]):
            sel = (idx == e) & keep
            rows = sel.any(-1).reshape(-1).nonzero()[:, 0]
            if rows.numel() == 0:
                continue
            w = (gate * sel).sum(-1).reshape(-1)[rows]
            xe = uf[rows]
            he = F.silu(self.mm(xe, p["w_gate"][e - lo])) * self.mm(xe, p["w_up"][e - lo])
            y = y.index_add(0, rows, self.mm(he, p["w_down"][e - lo]) * w[:, None])
        sh = p["shared"]
        shared = self.mm(F.silu(self.mm(u, sh["w_gate"])) * self.mm(u, sh["w_up"]), sh["w_down"])
        me = onehot.sum(2).mean(dim=(0, 1)) / K
        ce = torch.softmax(logits, dim=-1).mean(dim=(0, 1))
        return y.reshape(B, S, D) + shared, cfg["router_aux_loss_coef"] * E * torch.sum(me * ce)

    def layer(self, x: torch.Tensor, mixer: str, mp: dict, fp: dict) -> tuple[torch.Tensor, torch.Tensor]:
        r = self.cfg["residual_multiplier"]
        u = self.rmsnorm(x, mp["norm"])
        h = x + r * (self.mamba(u, mp["mamba"]) if mixer == "mamba" else self.attn(u, mp["attn"]))
        m, aux = self.moe(self.rmsnorm(h, fp["norm"]), fp["moe"])
        return h + r * m, aux

    def logits(self, tree: dict, tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The logits over the real vocabulary, (B, S, vocab_size), and the
        sum of the layers' auxiliary losses; each layer recomputed in the
        backward."""
        cfg = self.cfg
        tok = tree["embed"]["tok"]
        x = tok[tokens.long()] * cfg["embedding_multiplier"]
        seen = {"mamba": 0, "attention": 0}
        aux = torch.zeros((), device=x.device)
        for i, mixer in enumerate(cfg["layer_types"]):
            stack = tree["mamba_blocks" if mixer == "mamba" else "attn_blocks"]
            mp = _layer_of(stack, seen[mixer])
            seen[mixer] += 1
            x, a = checkpoint.checkpoint(self.layer, x, mixer, mp, _layer_of(tree["ffn_blocks"], i),
                                         use_reentrant=False)
            aux = aux + a
        lg = self.mm(self.rmsnorm(x, tree["final_norm"]), tok.t())[..., :cfg["vocab_size"]]
        return lg / cfg["logits_scaling"], aux

    def loss(self, tree: dict, tokens: torch.Tensor, labels: torch.Tensor, positions: int | None = None
             ) -> torch.Tensor:
        """The mean loss over the batch (over its first ``positions``
        positions where given: a fault the check has to catch)."""
        lg, aux = self.logits(tree, tokens)
        nll = torch.logsumexp(lg, dim=-1) - torch.gather(lg, -1, labels.long()[..., None])[..., 0]
        return (nll if positions is None else nll[:, :positions]).mean() + aux


def _layer_of(stack: dict, i: int) -> dict:
    """Layer ``i`` of a stacked tree."""
    return {k: _layer_of(v, i) if isinstance(v, dict) else v[i] for k, v in stack.items()}
