"""Prefill and one attention layer on the dense family's "model" axis
(``train/train_step.build_serve_step``, ``models/layers.attention``,
``parallel/collectives.ModelAxis``) on gloo ranks on the CPU, against the
reference on one device: fp32 smoke configs of granite-8b, starcoder2-7b
(sliding window below the prompt, qkv biases, LayerNorm) and phi4-mini-3.8b
(one KV head), on (data, model) = (1, 2) and (2, 2), with the weights of
``tests/test_torch_model_axis.py``.

Each rank prefills its data-parallel share of the prompts at its positions
``[r·S/m, (r+1)·S/m)``, writing them into its block of the KV cache (the
rules' ``cache_seq``), and returns the last model rank's last-token logits.
Held: the logits at 2e-4 (the port's fp32 logit tolerance) and each rank's
cache block against the matching slice of the reference's cache at 2e-5 of
its largest value; one attention layer on a rank's rows, against the keys
and values gathered over "model", on both paths, against the matching rows
of the reference's attention over the whole sequence at 2e-5 of the largest
|output|.  And the SSM, hybrid and audio families' train, prefill and
decode steps build on (1, 2) and trace on a fake process group (their
parity: ``tests/test_torch_model_axis_{rwkv,hybrid,audio}.py``)."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_dist
import _torch_model_axis_ranks as ranks
import repro.models.param as ref_param
from repro.models import layers as RL
from repro.models.api import ShapeCell as RefCell
from repro_torch.configs import load
from repro_torch.launch.mesh import fake_mesh
from repro_torch.models.api import ShapeCell
from repro_torch.models.param import tree_leaves
from repro_torch.parallel.sharding import make_rules
from repro_torch.train.train_step import build_serve_step, build_train_step
from test_torch_model_axis import ARCHS, RRT, B, S, _dp_index, _ref, weights

from _torch_parity import one_thread  # noqa: F401  (the fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

MESHES = {"1x2": ((1, 2), ("data", "model")), "2x2": ((2, 2), ("data", "model"))}
CELLS = [(mesh, arch) for mesh in MESHES for arch in ARCHS]


@pytest.fixture(scope="module")
def inputs():
    """{arch: ((weights, prompt), (a layer's attention weights, x))}"""
    out = {}
    for i, arch in enumerate(ARCHS):
        w = weights(i, arch)
        rng = np.random.default_rng(200 + i)
        prompt = rng.integers(0, _ref(arch).cfg.vocab_size, (B, S)).astype(np.int32)
        x = rng.standard_normal((B, S, _ref(arch).cfg.d_model)).astype(np.float32)
        out[arch] = ((w, prompt), (jax.tree.map(lambda a: a[0], w["blocks"]["attn"]), x))
    return out


@pytest.fixture(scope="module")
def reference(inputs):
    out = {}
    for arch, ((w, prompt), (pw, x)) in inputs.items():
        rh = _ref(arch)
        cache = ref_param.tree_init(rh.serve_state_specs(RefCell("p", "prefill", S, B)), jax.random.PRNGKey(0),
                                    dtype=jnp.float32)
        logits, cache = rh.prefill(RRT)(jax.tree.map(jnp.asarray, w), cache, jnp.asarray(prompt))
        y, _ = RL.attention(RRT, jax.tree.map(jnp.asarray, pw), jnp.asarray(x), rh.cfg.attn(), jnp.arange(S))
        out[arch] = {"logits": np.asarray(logits), "cache": [np.asarray(c) for c in jax.tree.leaves(cache)],
                     "attention": np.asarray(y)}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory, inputs):
    """Each mesh's ranks, spawned once for the module."""
    out = {}
    for name, (shape, axes) in MESHES.items():
        tmp = tmp_path_factory.mktemp(f"ranks{name}")
        with open(tmp / "inputs.pkl", "wb") as f:
            pickle.dump(inputs, f)
        out[name] = _torch_dist.spawn(ranks.prefill, int(np.prod(shape)), tmp, shape, axes, str(tmp / "inputs.pkl"))
    return out


@pytest.mark.parametrize("mesh, arch", CELLS)
def test_prefill_matches_reference(runs, reference, mesh, arch):
    """every rank returns the last-token logits of its DP share's rows (the
    last model rank's), and its cache block holds its positions' keys and
    values"""
    ref = reference[arch]
    for r in runs[mesh]:
        run = r[arch]
        dp, n = _dp_index(run["coord"], MESHES[mesh][0])
        rows = slice(dp * B // n, (dp + 1) * B // n)
        assert np.abs(run["logits"] - ref["logits"][rows]).max() <= 2e-4
        for blk, got, want in zip(run["cache_blocks"], tree_leaves(run["cache"]), ref["cache"]):
            want = want[tuple(slice(a, b) for a, b in blk)]
            assert got.shape == want.shape
            assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()


@pytest.mark.parametrize("mesh, arch", CELLS)
def test_attention_rows_match_full_attention(runs, reference, mesh, arch):
    """a rank's rows against the keys and values gathered over "model", on
    both paths (the kernel's wrapper takes its plain version on the CPU,
    with ``q_start`` at the rank's offset), equal the matching rows of the
    reference's attention over the whole sequence"""
    for r in runs[mesh]:
        got = r[arch]["attention"]
        want = reference[arch]["attention"][tuple(slice(a, b) for a, b in got["rows"])]
        for path in ("kernel", "plain"):
            assert np.abs(got[path] - want).max() <= 2e-5 * np.abs(want).max(), path


def test_model_axis_waits_for_a13_elsewhere():
    """the SSM, hybrid and audio families' steps build on a (1, 2) mesh, as
    the dense, MoE and VLM families' do, and each traces on ``meta`` over a
    fake process group with collectives on "model" (no family is refused a
    model axis any more)"""
    from repro_torch.train.train_step import lower_bundle

    with fake_mesh((1, 2), ("data", "model")) as mesh:
        for arch in ("rwkv6-1.6b", "zamba2-1.2b", "whisper-base"):
            harness = load(arch, smoke=True)
            for cell in (ShapeCell("t", "train", 16, 2), ShapeCell("p", "prefill", 16, 2),
                         ShapeCell("d", "decode", 16, 2)):
                if cell.kind == "train":
                    bundle = build_train_step(harness, cell, mesh, rules=make_rules(), use_kernels=False)
                else:
                    bundle = build_serve_step(harness, cell, mesh, rules=make_rules(sp=cell.kind != "decode"),
                                              use_kernels=False)
                low = lower_bundle(bundle, mesh)
                assert low["operand_bytes_by_axis"]["model"] > 0, (arch, cell.kind)
