"""The granite-4.0-h family (``"family": "granitemoehybrid"``): its weight
layout, its plain reference and its model FLOPs.  Reference side: imports
nothing of the program.

``leaf_specs`` is the layout, written from the configuration file: the
program's key names (``mamba_blocks``, ``attn_blocks`` and ``ffn_blocks``,
each a stack of its layers on a leading dim, ``embed.tok`` the tied table
with the vocabulary rounded up to 256, ``final_norm``).  The Mamba2 decay
``A_log`` and the time-step bias ``dt_bias`` are drawn normal at 0.5 and 1.0,
the conv's bias at 0.02.

``Reference`` computes, in float32 (``reference.Plain``), the equations of
``transformers``' ``GraniteMoeHybrid``:

- ``x0 = embed[ids] * embedding_multiplier``; each layer ``h = x + r *
  mixer(rmsnorm(x))`` and ``x = h + r * (moe(u) + shared(u))`` with ``u =
  rmsnorm(h)``, ``r`` the ``residual_multiplier``; the logits
  ``rmsnorm(x_L) embed^T / logits_scaling`` (tied), the mean cross-entropy;
- a Mamba2 mixer: ``[z | x | B | C | dt] = u W_in``; a depthwise causal
  conv (``conv1d``) with its bias and SiLU on ``[x | B | C]``; ``dt =
  softplus(dt + dt_bias)``; the scan in the chunked form of the Mamba2
  paper's minimal SSD (``segsum``: the chunks' states carried by a second
  segment sum over the chunks, not a loop) on ``x dt`` with the log decay
  ``dt * -exp(A_log)``, plus ``D x``; the gate before the norm,
  ``rmsnorm(y * silu(z))``, then ``W_out``;
- attention: grouped-query, causal, no positional encoding, the scores
  times ``attention_multiplier``, in blocks of query rows;
- the experts: the router over all ``router_experts`` at its full width,
  the ``num_experts_per_tok`` largest logits and a softmax over them, each
  expert taking at most ``capacity`` tokens of a sequence (``capacity =
  int(S k cf / E)`` over all E experts, the first choices of every token
  before the second, overflow dropped); only the held experts'
  (``first_local_expert`` and the ``num_local_experts`` after it) part is
  computed, as the program's share; the shared expert's SwiGLU on every
  token; the Switch load-balancing loss over all E weighed by
  ``router_aux_loss_coef``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils import checkpoint

from chipbench import reference, weights, work
from chipbench.scan_work import ssd_scan_work


def _dims(cfg: dict) -> dict:
    D = cfg["hidden_size"]
    DI = cfg["mamba_expand"] * D
    N, H = cfg["mamba_d_state"], cfg["mamba_n_heads"]
    return dict(D=D, DI=DI, N=N, H=H, P=DI // H, conv=DI + 2 * N, proj=2 * DI + 2 * N + H,
                Lm=cfg["layer_types"].count("mamba"), La=cfg["layer_types"].count("attention"),
                L=len(cfg["layer_types"]))


def leaf_specs(cfg: dict) -> list[tuple[tuple[str, ...], tuple[int, ...], str, float]]:
    """``(path, shape, init, std)`` of every leaf, in sorted path order."""
    d = _dims(cfg)
    D, DI, H, L, Lm, La = d["D"], d["DI"], d["H"], d["L"], d["Lm"], d["La"]
    N, K, Dh = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    E, F_, Fs = cfg["num_local_experts"], cfg["intermediate_size"], cfg["shared_intermediate_size"]
    specs = {
        ("embed", "tok"): ((weights.vocab_padded(cfg), D), "normal", 0.02),
        ("final_norm",): ((D,), "ones", 0.0),
        ("ffn_blocks", "norm"): ((L, D), "ones", 0.0),
        ("ffn_blocks", "moe", "router"): ((L, D, cfg["router_experts"]), "scaled", D ** -0.5),
        ("ffn_blocks", "moe", "w_gate"): ((L, E, D, F_), "scaled", D ** -0.5),
        ("ffn_blocks", "moe", "w_up"): ((L, E, D, F_), "scaled", D ** -0.5),
        ("ffn_blocks", "moe", "w_down"): ((L, E, F_, D), "scaled", F_ ** -0.5),
        ("ffn_blocks", "moe", "shared", "w_gate"): ((L, D, Fs), "scaled", D ** -0.5),
        ("ffn_blocks", "moe", "shared", "w_up"): ((L, D, Fs), "scaled", D ** -0.5),
        ("ffn_blocks", "moe", "shared", "w_down"): ((L, Fs, D), "scaled", Fs ** -0.5),
    }
    if Lm:
        specs.update({
            ("mamba_blocks", "norm"): ((Lm, D), "ones", 0.0),
            ("mamba_blocks", "mamba", "in_proj"): ((Lm, D, d["proj"]), "scaled", D ** -0.5),
            ("mamba_blocks", "mamba", "conv_w"): ((Lm, cfg["mamba_d_conv"], d["conv"]), "scaled",
                                                  cfg["mamba_d_conv"] ** -0.5),
            ("mamba_blocks", "mamba", "conv_b"): ((Lm, d["conv"]), "normal", 0.02),
            ("mamba_blocks", "mamba", "dt_bias"): ((Lm, H), "normal", 1.0),
            ("mamba_blocks", "mamba", "A_log"): ((Lm, H), "normal", 0.5),
            ("mamba_blocks", "mamba", "D"): ((Lm, H), "ones", 0.0),
            ("mamba_blocks", "mamba", "out_norm"): ((Lm, DI), "ones", 0.0),
            ("mamba_blocks", "mamba", "out_proj"): ((Lm, DI, D), "scaled", DI ** -0.5),
        })
    if La:
        specs.update({
            ("attn_blocks", "norm"): ((La, D), "ones", 0.0),
            ("attn_blocks", "attn", "wq"): ((La, D, N * Dh), "scaled", D ** -0.5),
            ("attn_blocks", "attn", "wk"): ((La, D, K * Dh), "scaled", D ** -0.5),
            ("attn_blocks", "attn", "wv"): ((La, D, K * Dh), "scaled", D ** -0.5),
            ("attn_blocks", "attn", "wo"): ((La, N * Dh, D), "scaled", (N * Dh) ** -0.5),
        })
    return [(path, *specs[path]) for path in sorted(specs)]


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """``out[..., i, j] = x[..., j+1] + ... + x[..., i]`` for ``i >= j``, else
    -inf (the minimal SSD's stable segment sum)."""
    T = x.shape[-1]
    x = x[..., None].expand(*x.shape, T)
    below = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device), -1)
    sums = torch.cumsum(x.masked_fill(~below, 0.0), dim=-2)
    on = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device), 0)
    return sums.masked_fill(~on, -torch.inf)


class Reference(reference.Plain):
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
        for lo in range(0, S, reference.QUERY_BLOCK):
            hi = min(S, lo + reference.QUERY_BLOCK)
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


def train_step_flops(cfg: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step, no recompute: 6 T times the matrix
    parameters a token multiplies (each Mamba2 layer's in and out
    projections, each attention layer's q, k, v and o, every layer's router,
    shared expert and ``num_experts_per_tok`` held / ``router_experts``
    experts' worth of the routed ones, the tied unembedding), plus three
    times the forward of every scan (``ssd_scan_work``) and of every
    attention layer at the causal mask."""
    d = _dims(cfg)
    D, Lm, La, L = d["D"], d["Lm"], d["La"], d["L"]
    N, K, Dh = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    E, k = cfg["router_experts"], cfg["num_experts_per_tok"]
    routed = k * cfg["num_local_experts"] / E * 3 * D * cfg["intermediate_size"]
    params = (Lm * (D * d["proj"] + d["DI"] * D) + La * (2 * D * N * Dh + 2 * D * K * Dh)
              + L * (D * E + routed + 3 * D * cfg["shared_intermediate_size"]) + D * cfg["vocab_size"])
    scan = Lm * ssd_scan_work(batch, seq, d["H"], d["P"], d["N"], cfg["mamba_chunk_size"])[0]
    attn = La * work.flash_work(batch, seq, seq, N, K, Dh)[0]
    return 6.0 * params * batch * seq + 3.0 * (scan + attn)
