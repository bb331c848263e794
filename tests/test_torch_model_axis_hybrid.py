"""The hybrid family (zamba2-1.2b's smoke config in fp32: 4 Mamba2 layers
of 4 heads, d_inner 256, state 16, ``in_proj`` of 548 columns; the shared
attention block once, after layer 2) on a "model" axis (``models/mamba2.py``,
``models/hybrid.py``) on gloo ranks at (data, model) = (1, 2) and (2, 2),
against the reference on one device.

Between blocks the rank holds its positions of each sequence (the rules'
``sp``).  A Mamba2 layer in training and prefill gathers x along the
sequence and ``in_proj`` whole (its column blocks do not line up with the
heads), computes its heads' ``z``/``x``/``dt`` columns and ``B``/``C``
whole, runs the conv on its channels and the scan on its heads, sums
``out_norm``'s mean of squares over the axis and reduce-scatters
``out_proj``'s partial output back to its positions; the shared block is the
dense family's path.  In decode every rank holds the token, the product of
the token with the rank's block of ``in_proj`` is gathered (no weight is),
the conv tail is whole and the same bits on every rank, and the partial
output is summed.

Held (``tests/_torch_model_axis_families.py``): two int8 ZeRO-1 steps
against ``jax.value_and_grad`` and ``adamw.apply``; a request (a prompt of
32 into a cache of 64 whose second block the decode steps reach, 4 steps)
against the reference's recurrence, each rank's ``h`` (its heads), conv
tail and cache block; the conv tails bit-equal on the model ranks.  And
one Mamba2 layer on the axis against the reference's: its heads'
columns of ``in_proj`` and ``out_norm`` over all of d_inner.  And the
gradients of leaves a depth never uses (ROADMAP C9)."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_dist
import _torch_model_axis_families as F
import _torch_model_axis_ranks as ranks
import repro.models.mamba2 as RM
from test_torch_model_axis import RRT, _ref

from _torch_parity import one_thread  # noqa: F401  (the fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

ARCH = "zamba2-1.2b"
S = 32


@pytest.fixture(scope="module")
def cases():
    return F.make_cases(ARCH, 21, S, prompt_len=32, cache=64, steps=4)


@pytest.fixture(scope="module")
def reference(cases):
    return F.reference(ARCH, *cases)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, cases):
    train, serve = cases
    return F.spawn(tmp_path_factory, "hybrid", F.MESHES, {ARCH: train}, {ARCH: serve})


@pytest.mark.parametrize("mesh", F.MESHES)
def test_loss_and_gradients_match_reference(runs, reference, mesh):
    F.check_loss_and_gradients(runs[mesh], reference, ARCH, F.MESHES[mesh][0])


@pytest.mark.parametrize("mesh", F.MESHES)
def test_shards_and_norm_match_adamw_apply(runs, cases, mesh):
    F.check_shards(runs[mesh], cases[0][0], ARCH)


@pytest.mark.parametrize("mesh", F.MESHES)
def test_params_identical_across_data_ranks(runs, mesh):
    F.check_params_identical(runs[mesh], ARCH)


@pytest.mark.parametrize("mesh", F.MESHES)
def test_request_matches_reference(runs, reference, mesh):
    """prefill then greedy decode: the reference recurrence's ids and
    logits, each rank's block of ``h`` (its heads), the whole conv tail and
    the rank's block of the shared block's cache"""
    F.check_request(runs[mesh], reference["request"], ARCH, F.MESHES[mesh][0])


@pytest.mark.parametrize("mesh", F.MESHES)
def test_conv_tail_bit_equal_on_the_model_ranks(runs, mesh):
    """the conv tail (leaf 2 of the state: kv.k, kv.v, ssm.conv, ssm.h) is
    replicated on "model": every rank holds the same bits, though each
    computed only its own channels' scan"""
    F.replicated_state_bit_equal(runs[mesh], ARCH, (2,))


@pytest.fixture(scope="module")
def mamba(tmp_path_factory, cases):
    w = cases[0][0]
    p = jax.tree.map(lambda t: t[0], w["mamba_blocks"]["mamba"])
    x = np.random.default_rng(4).standard_normal((2, S, _ref(ARCH).cfg.d_model)).astype(np.float32)
    tmp = tmp_path_factory.mktemp("hybrid_layers")
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump({"mamba": (ARCH, p, x)}, f)
    got = _torch_dist.spawn(ranks.family_layers, 2, tmp, (1, 2), ("data", "model"), str(tmp / "cases.pkl"))
    want = np.asarray(RM.mamba2_apply(RRT, jax.tree.map(jnp.asarray, p), jnp.asarray(x), _ref(ARCH).cfg.mamba)[0])
    return got, want


def test_mamba_layer_heads_and_norm(mamba):
    """one Mamba2 layer on two model ranks against the reference's, each
    rank's positions: the rank's heads take their own columns of the fused
    ``in_proj`` (274 a rank's block, misaligned with the 256 + 256 + 16 +
    16 + 4 of z, x, B, C, dt) and ``out_norm``'s mean of squares spans all
    of d_inner"""
    got, want = mamba
    for r in got:
        y = r["mamba"]["y"]
        rows = tuple(slice(a, b) for a, b in r["mamba"]["rows"])
        assert y.shape == want[rows].shape
        assert np.abs(y - want[rows]).max() <= 2e-5 * np.abs(want).max()


def test_unused_leaves_get_zero_gradients():
    """ROADMAP C9: at a depth that never calls the shared block (2 layers,
    one shared call every 2: ``(2 - 1) // 2 = 0`` calls) the shared block's
    leaves are unused; ``jax.value_and_grad`` gives them zeros, and so does
    the port's ``param.value_and_grad`` (``torch.autograd.grad`` raised
    there before, which the dry-run's hybrid probes at 6 layers hit)"""
    import torch

    from repro_torch.configs import load
    from repro_torch.models.layers import Runtime
    from repro_torch.models.param import from_reference, tree_leaves, value_and_grad

    rh = _ref(ARCH).clone(n_layers=2, share_every=2)
    ph = load(ARCH, smoke=True).clone(dtype=torch.float32, n_layers=2, share_every=2)
    w = F.drawn_weights(23, ARCH)
    w = {**w, "mamba_blocks": jax.tree.map(lambda t: t[:2], w["mamba_blocks"])}
    tok = np.random.default_rng(7).integers(0, rh.cfg.vocab_size, (2, 17)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    _, want = jax.value_and_grad(rh.loss(RRT))(jax.tree.map(jnp.asarray, w), jax.tree.map(jnp.asarray, batch))
    _, got = value_and_grad(ph.loss(Runtime(use_kernels=False)))(from_reference(w, torch.float32, "cpu"),
                                                                 {k: torch.from_numpy(v) for k, v in batch.items()})
    for g, r in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert np.abs(g.numpy() - np.asarray(r)).max() <= 2e-5 * max(np.abs(np.asarray(r)).max(), 1e-30)
    assert all(not np.asarray(r).any() for r in jax.tree.leaves(want["shared"]))
    assert all(not g.any() for g in tree_leaves(got["shared"]))
