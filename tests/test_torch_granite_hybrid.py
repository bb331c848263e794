"""granite-4.0-h (``models/granitemoehybrid.py``) against the plain float32
reference of ``tests/_granite_hybrid_reference.py``, at a small size on the
CPU: the logits, the loss and every leaf's gradient; the pieces that make
the model (the gated norm's order, each multiplier) each shown to matter;
the MoE layer's expert share against the uncut layer; the ``ssd_scan``
wrapper's limits at state size 128; the harness through ``launch/train.run``
and its refusal to serve."""

import dataclasses

import pytest
import torch

from _granite_hybrid_reference import Reference
from repro_torch.configs import load
from repro_torch.models import granitemoehybrid as G
from repro_torch.models import layers as L
from repro_torch.models.api import GraniteHybridHarness
from repro_torch.models.mamba2 import Mamba2Config
from repro_torch.models.moe import MoEConfig, moe_apply
from repro_torch.models.param import tree_init, tree_map

# a small model in the published names: 3 layers, both mixers, 8 experts of
# which 3 are held (2, 3, 4), top-2, a capacity that drops some choices
REF_CFG = dict(
    hidden_size=64, layer_types=["mamba", "attention", "mamba"], num_attention_heads=4, num_key_value_heads=2,
    head_dim=16, vocab_size=250, mamba_expand=2, mamba_d_state=16, mamba_n_heads=8, mamba_d_head=16,
    mamba_d_conv=4, mamba_chunk_size=16, intermediate_size=32, shared_intermediate_size=48, router_experts=8,
    num_local_experts=3, first_local_expert=2, num_experts_per_tok=2, capacity_factor=1.0,
    router_aux_loss_coef=0.01, embedding_multiplier=12.0, residual_multiplier=0.22,
    attention_multiplier=1 / 16, logits_scaling=16.0, rms_norm_eps=1e-5)
B, S = 2, 48


def _port_cfg(**changes) -> G.GraniteHybridConfig:
    c = REF_CFG
    D = c["hidden_size"]
    cfg = G.GraniteHybridConfig(
        name="tiny-granite-hybrid", layer_types=tuple(c["layer_types"]), d_model=D,
        n_heads=c["num_attention_heads"], n_kv_heads=c["num_key_value_heads"], head_dim=c["head_dim"],
        vocab_size=c["vocab_size"],
        mamba=Mamba2Config(d_model=D, d_inner=2 * D, d_state=c["mamba_d_state"], head_dim=c["mamba_d_head"],
                           d_conv=4, chunk=c["mamba_chunk_size"], norm_before_gate=False, norm_eps=1e-5),
        moe=MoEConfig(n_experts=8, topk=2, d_ff=32, capacity_factor=1.0, router_aux_coef=0.01, held=(2, 3),
                      shared_d_ff=48),
        embedding_multiplier=12.0, residual_multiplier=0.22, attention_multiplier=1 / 16, logits_scaling=16.0,
        rms_norm_eps=1e-5, dtype=torch.float32)
    return dataclasses.replace(cfg, **changes)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


pytestmark = pytest.mark.usefixtures("one_thread")


def _params(cfg, seed=0):
    """The port's tree, with the Mamba2 decays, time-step biases and conv
    biases drawn away from their zero inits so that each takes part."""
    p = tree_init(G.lm_specs(cfg), torch.Generator().manual_seed(seed), torch.float32, "cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    m = p["mamba_blocks"]["mamba"]
    for key, std in (("A_log", 0.5), ("dt_bias", 1.0), ("conv_b", 0.1)):
        m[key] = torch.randn(m[key].shape, generator=gen) * std
    return p


def _batch(seed=0):
    gen = torch.Generator().manual_seed(seed + 7)
    tokens = torch.randint(0, REF_CFG["vocab_size"], (B, S), generator=gen)
    return {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}


def _port(cfg, params, batch):
    rt = L.Runtime(use_kernels=False)
    logits, aux = G.forward(rt, cfg, params, batch["tokens"])
    return logits[..., :cfg.vocab_size], G.loss_fn(rt, cfg, params, batch)


def _leaves(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], prefix + (k,))
        else:
            yield ".".join(prefix + (k,)), tree[k]


def test_the_port_matches_the_plain_reference():
    """float32, seeded: logits within 1e-5 of the largest, the loss within
    1e-6, and every leaf's gradient within 1e-4 of its largest element."""
    cfg = _port_cfg()
    params, batch = _params(cfg), _batch()
    leaves = [t.requires_grad_() for _, t in _leaves(params)]
    lg, loss = _port(cfg, params, batch)
    grads = torch.autograd.grad(loss, leaves)
    ref = Reference(REF_CFG)
    rparams = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    rleaves = [t for _, t in _leaves(rparams)]
    rlg, _ = ref.logits(rparams, batch["tokens"])
    rloss = ref.loss(rparams, batch["tokens"], batch["labels"])
    rgrads = torch.autograd.grad(rloss, rleaves)
    assert (lg - rlg).abs().max() <= 1e-5 * rlg.abs().max()
    assert abs(float(loss.detach()) - float(rloss.detach())) <= 1e-6 * abs(float(rloss.detach()))
    for (name, _), g, r in zip(_leaves(params), grads, rgrads):
        assert r.abs().max() > 0, name
        assert (g - r).abs().max() <= 1e-4 * r.abs().max(), name


@pytest.mark.parametrize("change", [
    dict(mamba=dataclasses.replace(_port_cfg().mamba, norm_before_gate=True)),   # Zamba2's order
    dict(embedding_multiplier=1.0),
    dict(residual_multiplier=1.0),
    dict(attention_multiplier=None),        # 1/sqrt(head_dim) in place of the file's scale
    dict(logits_scaling=1.0),
], ids=["norm-after-gate", "embedding-multiplier", "residual-multiplier", "attention-multiplier",
        "logits-scaling"])
def test_each_piece_matters(change):
    """The port with one piece of the model changed or dropped lies far
    outside the limit the matching port keeps from the reference."""
    params, batch = _params(_port_cfg()), _batch()
    with torch.no_grad():
        rlg, _ = Reference(REF_CFG).logits(params, batch["tokens"])
        lg, _ = _port(_port_cfg(**change), params, batch)
    assert (lg - rlg).abs().max() > 100 * 1e-5 * rlg.abs().max()


@pytest.mark.parametrize("shares", [1, 2, 4, 8])
def test_the_expert_shares_add_up_to_the_uncut_layer(shares):
    """An MoE layer of 8 experts cut into ``shares`` shares: each share's
    output (routing over all 8 and the whole layer's capacity, its own
    experts only), summed over the shares, plus the shared expert counted
    once, is the plain reference's layer holding every expert; the
    auxiliary loss is the same on every share and the reference's."""
    E, n, D = 8, 8 // shares, 64
    gen = torch.Generator().manual_seed(shares)
    full = MoEConfig(n_experts=E, topk=2, d_ff=32, capacity_factor=1.0, router_aux_coef=0.01)
    p = {"router": torch.randn(D, E, generator=gen) / D ** 0.5,
         **{k: torch.randn(E, *s, generator=gen) / s[0] ** 0.5
            for k, s in (("w_gate", (D, 32)), ("w_up", (D, 32)), ("w_down", (32, D)))}}
    shared = {k: torch.randn(*s, generator=gen) / s[0] ** 0.5
              for k, s in (("w_gate", (D, 48)), ("w_up", (D, 48)), ("w_down", (48, D)))}
    x = torch.randn(B, S, D, generator=gen)
    rt = L.Runtime(use_kernels=False)
    total, auxes = torch.zeros_like(x), []
    for s in range(shares):
        mine = {"router": p["router"], **{k: p[k][s * n:(s + 1) * n] for k in ("w_gate", "w_up", "w_down")}}
        y, aux = moe_apply(rt, mine, x, dataclasses.replace(full, held=(s * n, n)))
        total, auxes = total + y, auxes + [aux]
    total = total + L.swiglu(rt, shared, x)
    ref_cfg = dict(REF_CFG, router_experts=E, num_local_experts=E, first_local_expert=0)
    want, want_aux = Reference(ref_cfg).moe(x, {**p, "shared": shared})
    assert (total - want).abs().max() <= 1e-5 * want.abs().max()
    assert all(torch.equal(a, auxes[0]) for a in auxes)
    assert abs(float(auxes[0]) - float(want_aux)) <= 1e-6


def test_holding_every_expert_is_the_layer_without_a_share():
    """``held=(0, E)`` gives the bits of the layer without a share: mixtral's
    and dbrx's path (``held`` None) is the same function."""
    E, D = 4, 32
    gen = torch.Generator().manual_seed(3)
    p = {"router": torch.randn(D, E, generator=gen), "w_gate": torch.randn(E, D, 16, generator=gen),
         "w_up": torch.randn(E, D, 16, generator=gen), "w_down": torch.randn(E, 16, D, generator=gen)}
    x = torch.randn(2, 40, D, generator=gen).bfloat16()
    p = tree_map(lambda t: t.bfloat16(), p)
    cfg = MoEConfig(n_experts=E, topk=2, d_ff=16)
    rt = L.Runtime(use_kernels=False)
    y0, a0 = moe_apply(rt, p, x, cfg)
    y1, a1 = moe_apply(rt, p, x, dataclasses.replace(cfg, held=(0, E)))
    assert torch.equal(y0, y1) and torch.equal(a0, a1)


@pytest.mark.parametrize("dtype,P,N,chunk,ok", [
    (torch.bfloat16, 64, 128, 128, True),      # granite-4.0-h: the tensor-core design at N 128
    (torch.bfloat16, 64, 100, 64, True),
    (torch.bfloat16, 64, 64, 128, True),
    (torch.float32, 64, 64, 128, True),
    (torch.float32, 64, 128, 128, False),      # the FMA design keeps N <= 64
    (torch.bfloat16, 64, 132, 128, False),
    (torch.bfloat16, 128, 64, 128, False),     # P stays <= 64
    (torch.bfloat16, 64, 126, 128, False),     # N a multiple of 4
    (torch.bfloat16, 64, 128, 129, False),     # chunk <= 128
])
def test_ssd_scan_checks_its_widths(dtype, P, N, chunk, ok):
    from repro_torch.kernels.ssd_scan import _check

    xh = torch.zeros(1, 8, 2, P, dtype=dtype)
    bm = torch.zeros(1, 8, N, dtype=dtype)
    args = (xh, torch.zeros(1, 8, 2), bm, bm, chunk, None)
    if ok:
        _check(*args)
    else:
        with pytest.raises(ValueError):
            _check(*args)


def test_the_smoke_config_trains_through_launch_train_run():
    """``launch/train.run`` builds the registry's smoke config and trains it
    on the CPU: five AdamW steps at a raised learning rate lower the loss."""
    from repro_torch.launch import train

    args = train.build_parser().parse_args(["--arch", "granite-4.0-h-small", "--device", "cpu", "--steps", "5",
                                            "--batch", "2", "--seq", "64", "--lr", "3e-3"])
    out = train.run(args, rt=L.Runtime(use_kernels=False))
    assert len(out["losses"]) == 5 and out["losses"][-1] < out["losses"][0]


def test_the_harness_refuses_to_serve_and_cuts_depth():
    h = load("granite-4.0-h-small")
    assert isinstance(h, GraniteHybridHarness) and h.cfg.n_layers == 40
    assert h.cfg.layer_types.count("attention") == 4
    cut = h.clone(n_layers=10)
    assert cut.cfg.layer_types == ("mamba",) * 5 + ("attention",) + ("mamba",) * 4
    for method in ("prefill", "decode", "serve_state_specs", "serve_input_specs"):
        with pytest.raises(NotImplementedError, match="not ported"):
            getattr(h, method)(L.Runtime())
