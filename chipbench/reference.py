"""The plain reference's shared parts, written in plain PyTorch float32 with
TF32 off.  It imports nothing of the program and takes nothing the program
made: the weights are drawn again from ``--seed`` (``weights.py``), the
tokens made again from the frozen draws of ``data.py``.  Each family's model
is ``models/<family>.py``'s ``Reference``, built on ``Plain``.

``Plain`` holds the arithmetic the families share, as the configuration
files state it (each departure from the published models is listed in the
file under ``departures``):

- RMSNorm, ``x / sqrt(mean(x^2) + eps) * w``;
- rotary embeddings on the two halves of each head (theta from the file);
- grouped-query attention, causal, with a sliding window where the file has
  one, in blocks of query rows so that it fits beside nothing else on the
  card.

``train_readings`` runs a family's loss through training: the gradients by
autograd (each layer recomputed in the backward), the int8 error-feedback
compression where the file asks for it, and AdamW with fp32 masters and
moments, the gradients rounded to ``grad_dtype`` first, global-norm
clipping, linear warm-up and cosine decay.

``precision="fp8"`` is the control: every operand of every matrix product
(weights and activations, the attention's scores and probabilities too)
rounded to float8 e4m3 with one scale a tensor, the products still summed
in float32.
"""

from __future__ import annotations

import math

import torch

from . import data, registry, weights

QUERY_BLOCK = 1024
FP8_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Plain:
    def __init__(self, cfg: dict, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(precision)
        self.cfg = cfg
        self.fp8 = precision == "fp8"
        no_tf32()

    def _q(self, x: torch.Tensor) -> torch.Tensor:
        """An operand as the control rounds it (the identity at fp32); its
        gradient passes straight through."""
        if not self.fp8:
            return x
        s = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        r = (x.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s
        return x + (r - x.detach())

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._q(a) @ self._q(b)

    def rmsnorm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + self.cfg["rms_norm_eps"]) * w

    def rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        half = x.shape[-1] // 2
        freqs = torch.exp(-math.log(self.cfg["rope_theta"])
                          * torch.arange(half, dtype=torch.float32, device=x.device) / half)
        ang = pos[:, None].float() * freqs
        cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def attention(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """q (B, S, N, Dh), k/v (B, S, K, Dh): causal GQA in blocks of query rows."""
        B, S, N, Dh = q.shape
        K = k.shape[2]
        qg = q.reshape(B, S, K, N // K, Dh)
        window = self.cfg.get("sliding_window")
        kq, vq = self._q(k), self._q(v)
        out = []
        for lo in range(0, S, QUERY_BLOCK):
            hi = min(S, lo + QUERY_BLOCK)
            s = torch.einsum("bqkgd,bskd->bkgqs", self._q(qg[:, lo:hi]), kq[:, :hi]) / math.sqrt(Dh)
            qp = torch.arange(lo, hi, device=q.device)[:, None]
            kp = torch.arange(hi, device=q.device)[None, :]
            ok = kp <= qp
            if window is not None:
                ok = ok & (qp - kp < window)
            p = torch.softmax(s.masked_fill(~ok, float("-inf")), dim=-1)
            out.append(torch.einsum("bkgqs,bskd->bqkgd", self._q(p), vq[:, :hi]))
        return torch.cat(out, dim=1).reshape(B, S, N * Dh)


def model(cfg: dict, precision: str = "fp32"):
    """The configuration family's plain model."""
    return registry.family(cfg).Reference(cfg, precision)


# ---------------------------------------------------------------------------
# training: the checked steps of loss, gradients, compression and AdamW
# ---------------------------------------------------------------------------


def _lr(opt: dict, step: int, total_steps: int) -> float:
    warm = min((step + 1.0) / max(opt["warmup_steps"], 1), 1.0)
    prog = min(max((step - opt["warmup_steps"]) / max(total_steps - opt["warmup_steps"], 1), 0.0), 1.0)
    cos = 0.5 * (1.0 + math.cos(math.pi * prog))
    return opt["lr"] * warm * (opt["min_lr_ratio"] + (1 - opt["min_lr_ratio"]) * cos)


def _int8(acc: torch.Tensor) -> torch.Tensor:
    scale = torch.clamp(acc.abs().amax(), min=1e-12) / 127.0
    return torch.clamp(torch.round(acc / scale), -127, 127) * scale


def train_readings(cfg: dict, mix: dict, seed: int, device, steps: int = 3, precision: str = "fp32",
                   total_steps: int = 10**6, half_batch: bool = False) -> dict:
    """The reference's readings of the first ``steps`` training steps from
    the benchmark's weights and data: the loss of each step, each leaf's
    norm of the first gradient as the optimizer gets it (after the
    compression) and of the raw first gradient, the raw first gradient's
    sampled elements (``weights.samples``), and each leaf's norm and
    sampled elements of the parameters' change after ``steps`` updates, the
    params rounded to bf16 as the program holds them.  ``half_batch`` is a
    fault: half of the batch left out (half of the positions where the
    batch holds one sequence), the mean taken over the rest."""
    ref = model(cfg, precision)
    opt = cfg["training"]["optimizer"]
    specs = weights.leaf_specs(cfg)
    paths = [s[0] for s in specs]
    leaves = [weights.draw_leaf(cfg, seed, i, device).float().requires_grad_() for i in range(len(specs))]
    tree = weights.nest(paths, leaves)
    m = [torch.zeros_like(t) for t in leaves]
    v = [torch.zeros_like(t) for t in leaves]
    res = [torch.zeros_like(t) for t in leaves] if cfg["training"]["compression"] == "int8" else None
    grad_dtype = getattr(torch, opt["grad_dtype"])
    out = {"losses": [], "payload_norms": None, "grad_norms": None}
    B, S = mix["batch"], mix["seq"]
    for step in range(steps):
        b = data.train_batch(step, B, S, cfg["vocab_size"])
        tokens = torch.from_numpy(b["tokens"]).to(device)
        labels = torch.from_numpy(b["labels"]).to(device)
        positions = None
        if half_batch and B > 1:
            tokens, labels = tokens[: B // 2], labels[: B // 2]
        elif half_batch:
            positions = S // 2
        loss = ref.loss(tree, tokens, labels, positions)
        grads = list(torch.autograd.grad(loss, leaves))
        out["losses"].append(float(loss.detach()))
        with torch.no_grad():
            if step == 0:
                out["grad_norms"] = [float(torch.linalg.vector_norm(g)) for g in grads]
                out["grad_samples"] = weights.samples(cfg, seed, weights.nest(paths, grads))
            for i, r in enumerate(res or ()):       # the payload in place of each gradient
                acc = grads[i].add_(r)
                d = _int8(acc)
                r.copy_(acc - d)
                grads[i] = d
            if step == 0:
                out["payload_norms"] = [float(torch.linalg.vector_norm(g)) for g in grads]
            payload = grads
            gs = [g.to(grad_dtype).float() for g in payload]
            del payload, grads
            gnorm = math.sqrt(sum(float(torch.sum(g * g)) for g in gs))
            clip = min(opt["clip_norm"] / (gnorm + 1e-9), 1.0)
            lr = _lr(opt, step, total_steps)
            bc1, bc2 = 1 - opt["b1"] ** (step + 1), 1 - opt["b2"] ** (step + 1)
            for g, mm_, vv, p in zip(gs, m, v, leaves):
                g = g * clip
                mm_.mul_(opt["b1"]).add_((1 - opt["b1"]) * g)
                vv.mul_(opt["b2"]).add_((1 - opt["b2"]) * g * g)
                upd = (mm_ / bc1) / (torch.sqrt(vv / bc2) + opt["eps"]) + opt["weight_decay"] * p
                p.sub_(lr * upd)
            del gs
    with torch.no_grad():
        out["change_norms"], out["change_samples"] = [], []
        for i, p in enumerate(leaves):
            c = p.to(torch.bfloat16).float() - weights.draw_leaf(cfg, seed, i, device).float()
            out["change_norms"].append(float(torch.linalg.vector_norm(c)))
            out["change_samples"].append(weights.sample(cfg, seed, i, c))
            del c
    out["paths"] = [".".join(p) for p in paths]
    return out
