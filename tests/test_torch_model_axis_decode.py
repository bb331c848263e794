"""A served request on the dense family's "model" axis
(``train/train_step.build_serve_step``, ``models/layers.py``'s decode on
the axis) on gloo ranks on the CPU, against the reference on one device:
fp32 smoke configs of granite-8b (a prompt of 60 into a cache of 128, 8
greedy steps that cross from the first block of the cache into the second)
and starcoder2-7b (its window of 64, qkv biases, LayerNorm: a prompt of 200
into a cache of 256, 4 steps, during which the first block lies wholly
before the window and contributes nothing), on (data, model) = (1, 2) and
(2, 2), with the weights of ``tests/test_torch_model_axis.py``.

The prefill writes the gathered keys and values of each position into the
block of the cache that owns it (the rules' ``cache_seq``), so a prompt
shorter than the cache fills the first blocks; each decode step runs the
axis tensor-parallel: the rank's columns of q, k and v, the new key and
value written by the block that owns the position, every query head over
the rank's block with its log-sum-exp, the ranks' outputs combined in rank
order, the row-parallel sums and the vocabulary shards gathered.  Held: the
greedy ids equal the reference's (``prefill`` then ``decode_step``), every
step's logits at 2e-4 (the port's fp32 logit tolerance), each rank's cache
block after the last step at 2e-5 of the largest |value| of the matching
slice of the reference's cache.  Without processes: the flash plain
version's log-sum-exp against a float64 one, and the blocks' partial
attentions combined by their log-sum-exps against the reference's attention
over the whole cache, a block with no visible key launching nothing."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist
import _torch_model_axis_ranks as ranks
import repro.models.param as ref_param
from repro.models import layers as RL
from repro.models.api import ShapeCell as RefCell
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain, visible
from repro_torch.models import layers as PL
from repro_torch.models.param import tree_leaves
from test_torch_model_axis import RRT, _dp_index, _ref, weights

from _torch_parity import one_thread  # noqa: F401  (the fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

MESHES = {"1x2": ((1, 2), ("data", "model")), "2x2": ((2, 2), ("data", "model"))}
B = 4
# prompt, cache, steps, window (None: the config's)
REQUESTS = {"granite-8b": (60, 128, 8, None), "starcoder2-7b": (200, 256, 4, None)}
CELLS = [(mesh, arch) for mesh in MESHES for arch in REQUESTS]


@pytest.fixture(scope="module")
def cases():
    out = {}
    for i, (arch, (S, L, steps, window)) in enumerate(REQUESTS.items()):
        prompt = np.random.default_rng(300 + i).integers(0, _ref(arch).cfg.vocab_size, (B, S)).astype(np.int32)
        out[arch] = dict(arch=arch, weights=weights(i, arch), prompt=prompt, prefix=None, cache=L, steps=steps,
                         window=window)
    return out


def reference_request(case) -> dict:
    """The reference's prefill into a cache of ``case["cache"]`` positions,
    then its greedy decode steps: logits, ids and the final cache."""
    rh = _ref(case["arch"])
    if case["window"] is not None:
        rh = rh.clone(window=case["window"])
    B_, S = case["prompt"].shape
    P = 0 if case["prefix"] is None else case["prefix"].shape[1]
    w = jax.tree.map(jnp.asarray, case["weights"])
    cache = ref_param.tree_init(rh.serve_state_specs(RefCell("d", "decode", case["cache"] - P, B_)),
                                jax.random.PRNGKey(0), dtype=jnp.float32)
    extra = () if case["prefix"] is None else (jnp.asarray(case["prefix"]),)
    logits, cache = rh.prefill(RRT)(w, cache, jnp.asarray(case["prompt"]), *extra)
    out = {"logits": [np.asarray(logits)], "ids": []}
    for i in range(case["steps"]):
        ids = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out["ids"].append(np.asarray(ids))
        logits, cache = rh.decode(RRT)(w, cache, ids, jnp.asarray(P + S + i, jnp.int32))
        out["logits"].append(np.asarray(logits))
    out["cache"] = [np.asarray(c) for c in jax.tree.leaves(cache)]
    return out


@pytest.fixture(scope="module")
def reference(cases):
    return {name: reference_request(case) for name, case in cases.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, cases):
    out = {}
    for name, (shape, axes) in MESHES.items():
        tmp = tmp_path_factory.mktemp(f"serve{name}")
        with open(tmp / "cases.pkl", "wb") as f:
            pickle.dump(cases, f)
        out[name] = _torch_dist.spawn(ranks.serve, int(np.prod(shape)), tmp, shape, axes, str(tmp / "cases.pkl"))
    return out


def check_request(res: list, ref: dict, name: str, mesh_shape: tuple) -> None:
    """Every rank's ids and logits against the reference's rows of its data
    share, and its cache block against the matching slice."""
    for r in res:
        run = r[name]
        dp, n = _dp_index(run["coord"], mesh_shape)
        rows = slice(dp * B // n, (dp + 1) * B // n)
        for got, want in zip(run["ids"], ref["ids"]):
            assert np.array_equal(got, want[rows])
        for got, want in zip(run["logits"], ref["logits"]):
            assert np.abs(got - want[rows]).max() <= 2e-4
        for blk, got, want in zip(run["cache_blocks"], tree_leaves(run["cache"]), ref["cache"]):
            want = want[tuple(slice(a, b) for a, b in blk)]
            assert got.shape == want.shape
            assert np.abs(got - want).max() <= 2e-5 * max(np.abs(want).max(), 1.0)


@pytest.mark.parametrize("mesh, arch", CELLS)
def test_request_matches_reference(runs, reference, mesh, arch):
    """prefill into a longer cache, then greedy decode on the model axis:
    the reference's ids, logits and cache"""
    check_request(runs[mesh], reference[arch], arch, MESHES[mesh][0])


def decode_model_bytes(cfg, B_local: int, m: int, itemsize: int = 4) -> int:
    """The operand bytes a rank hands the "model" axis in one decode step
    of the dense family, from the shapes alone: a layer gathers its columns
    of q, k and v and the (B, N) fp32 log-sum-exps, reduce-scatters the
    (B, N·Dh) partial outputs (in their type: scaled in fp32 where they are
    summed), and sums two (B, D) partials (the
    output projection's and the MLP's); the step gathers the embedding's
    columns and the logits.  Activations only, in their type: no term is a
    weight."""
    N, K, Dh, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    layer = B_local * ((N + 2 * K) * Dh // m * itemsize + N * 4 + N * Dh * itemsize + 2 * D * itemsize)
    return cfg.n_layers * layer + B_local * (D + cfg.vocab_padded) // m * itemsize


@pytest.mark.parametrize("mesh", MESHES)
def test_decode_moves_activations_only(runs, cases, mesh):
    """a decode step's operand bytes on "model" equal the closed form of
    its activations, and the same on every rank"""
    (data, m), _ = MESHES[mesh]
    for arch, case in cases.items():
        want = decode_model_bytes(_ref(arch).cfg, B // data, m)
        assert {r[arch]["wire"]["model"] for r in runs[mesh]} == {case["steps"] * want}


def _attention_case(seed, S_k=48, N=4, K=2, D=32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, 1, N, D)).astype(np.float32)
    k = rng.standard_normal((2, S_k, K, D)).astype(np.float32)
    v = rng.standard_normal((2, S_k, K, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("window, prefix", [(None, 0), (16, 0), (None, 6)], ids=["causal", "window", "prefix"])
def test_flash_plain_log_sum_exp(window, prefix):
    """the plain version's log-sum-exp (what the kernel's combine writes)
    equals a float64 log-sum-exp of the scaled, masked scores; the wrapper
    hands the CPU call to it, and refuses it outside a decode call"""
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((2, 2, 3, 2, 32)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 2, 40, 32)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 2, 40, 32)).astype(np.float32))
    kw = dict(causal=True, window=window, prefix_len=prefix, q_start=30)
    o, lse = flash_attention_plain(q, k, v, return_lse=True, **kw)
    s = torch.einsum("bkgqd,bksd->bkgqs", q.double(), k.double()) / np.sqrt(32)
    ok = visible(2, 40, q_start=30, causal=True, window=window, prefix_len=prefix)
    want = torch.logsumexp(s.masked_fill(~ok, -np.inf), dim=-1)
    assert lse.dtype == torch.float32 and lse.shape == (2, 2, 3, 2)
    assert (lse.double() - want).abs().max() <= 1e-5
    o2, lse2 = flash_attention(q, k, v, return_lse=True, **kw)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    with pytest.raises(ValueError, match="decode"):
        flash_attention(q.repeat(1, 1, 1, 9, 1), k, v, return_lse=True, causal=True)


class _RankOf:
    """Rank ``rank`` of a model axis of ``len(outs)`` ranks, in one process:
    what ``layers._combine`` asks of the axis, answered from every rank's
    partial output and log-sum-exp."""

    def __init__(self, rank, outs, lses):
        self.rank, self.size, self.outs, self.lses = rank, len(outs), outs, lses
        self.transport = self
        self.reduce = PL.ops.ccu_reduce

    def rows(self, x):
        return torch.stack(self.lses)

    def all_to_all(self, chunks, kind):
        return torch.stack([o.flatten(-2).unflatten(-1, (self.size, -1))[..., self.rank, :] for o in self.outs])


def test_combine_sums_in_fp32():
    """``layers._combine`` on four ranks' bf16 partial outputs (one rank
    with no visible key: log-sum-exp -inf, output 0) gives each rank the
    bits of the fp32 combine: every output scaled in fp32 by ``exp(lse_r -
    lse)``, its chunk of heads summed in rank order by ``ccu_reduce``,
    rounded once to bf16; within one bf16 ulp of the float64 combine"""
    gen = torch.Generator().manual_seed(11)
    P, B, N, Dh = 4, 3, 6, 16           # 6 heads on 4 ranks: the chunks cut a head
    outs = [torch.randn((B, 1, N, Dh), generator=gen).to(torch.bfloat16) for _ in range(P)]
    lses = [3 * torch.randn((B, 1, N), generator=gen) for _ in range(P)]
    outs[1], lses[1] = torch.zeros_like(outs[1]), torch.full_like(lses[1], -float("inf"))
    total = torch.logsumexp(torch.stack(lses), dim=0)
    scaled = [(o.float() * torch.exp(l - total)[..., None]).flatten(-2) for o, l in zip(outs, lses)]
    exact = sum(o.double() * torch.exp(l.double() - total.double())[..., None] for o, l in zip(outs, lses))
    exact = exact.flatten(-2)
    w = N * Dh // P
    for r in range(P):
        got = PL._combine(_RankOf(r, outs, lses), outs[r], lses[r])
        rows = torch.stack([x[..., r * w:(r + 1) * w].reshape(-1) for x in scaled])
        assert got.dtype == torch.bfloat16 and got.shape == (B, 1, w)
        assert torch.equal(got, PL.ops.ccu_reduce(rows).view(B, 1, w).to(torch.bfloat16))
        want = exact[..., r * w:(r + 1) * w]
        assert ((got.double() - want).abs() <= 2.0 ** -8 * want.abs() + 1e-30).all()


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernel", "plain"])
@pytest.mark.parametrize("window", [None, 10])
def test_blocks_combine_to_whole_attention(use_kernels, window, monkeypatch):
    """the cache cut into 4 blocks of 12: each block's partial attention
    and log-sum-exp (``layers._attend_block``, the kernel's wrapper or the
    plain path), scaled by ``exp(lse_r - logsumexp lse)`` and summed in
    rank order, equals the reference's attention over the whole cache at
    2e-5 of the largest |output|; under the window of 10 the blocks before
    it contribute exactly nothing and launch nothing"""
    q, k, v = _attention_case(5)
    pos, Lb = 40, 12
    cfg = PL.AttnConfig(d_model=0, n_heads=4, n_kv_heads=2, head_dim=32, window=window)
    bias = RL._mask_bias(jnp.asarray([pos]), jnp.arange(48), True, window)
    want = np.asarray(RL.sdpa(jnp.asarray(q).reshape(2, 1, 2, 2, 32), jnp.asarray(k), jnp.asarray(v), bias))
    want = want.reshape(2, 1, 4, 32)
    calls = []
    real = PL.ops.flash_attention_bsnd
    monkeypatch.setattr(PL.ops, "flash_attention_bsnd", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    rt = PL.Runtime(use_kernels=use_kernels)
    parts = [PL._attend_block(rt, torch.from_numpy(q), torch.from_numpy(k[:, r * Lb:(r + 1) * Lb]),
                              torch.from_numpy(v[:, r * Lb:(r + 1) * Lb]), cfg, pos, r * Lb) for r in range(4)]
    lse = torch.stack([p[1] for p in parts])
    total = torch.logsumexp(lse, dim=0)
    got = sum(o.float() * torch.exp(l - total)[..., None] for o, l in parts)
    assert np.abs(got.numpy() - want).max() <= 2e-5 * np.abs(want).max()
    hidden = [r for r in range(4) if window is not None and (r + 1) * Lb - 1 <= pos - window]
    for r in hidden:
        assert torch.isneginf(parts[r][1]).all() and not parts[r][0].any()
    assert len(calls) == (4 - len(hidden) if use_kernels else 0)
    assert window is None or hidden == [0, 1]
