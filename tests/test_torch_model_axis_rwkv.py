"""The SSM family (rwkv6-1.6b's smoke config in fp32: 2 layers, 4 heads of
32) on a "model" axis (``models/rwkv6.py``, ``models/rwkv_lm.py``,
``train/train_step.py``) on gloo ranks at (data, model) = (1, 2) and
(2, 2), against the reference on one device.

The rules never cut this family's sequence, so the axis is
tensor-parallel in training, prefill and decode alike: a rank holds heads
``[r·H/m, (r+1)·H/m)``; the time mix's ``wr``/``wk``/``wv``/``wg`` and
``w_lora_b`` give its columns, ``w0``, ``bonus_u`` and ``ln_out`` are
sliced to its channels, the scan runs on its heads, ``ln_out``'s mean of
squares is summed over the axis and ``wo``'s partial output summed; the
channel mix reduce-scatters its ``vv`` over D, multiplies the rank's
``rr`` and gathers the product; the embedding looks up the rank's columns
and the logits are the rank's vocabulary shard, gathered.  Every rank
holds the whole sequences, so its loss is the cross-entropy of its
``1/m`` of the positions weighed by their share.

Held (``tests/_torch_model_axis_families.py``): two int8 ZeRO-1 steps'
loss and gradients against ``jax.value_and_grad`` (2e-5), not m times
them; the shards against ``adamw.apply`` (1e-6); a request (a prompt of
32, two chunks, then 4 greedy steps) against the reference's recurrence;
each rank's ``tm_s`` block; the token-shift tails bit-equal on the model
ranks.  And one time mix on the axis against the reference's: its
``ln_out`` over all D channels, where a rank's own mean would be wrong."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_dist
import _torch_model_axis_families as F
import _torch_model_axis_ranks as ranks
import repro.models.rwkv6 as RW
from test_torch_model_axis import RRT, _ref

from _torch_parity import one_thread  # noqa: F401  (the fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

ARCH = "rwkv6-1.6b"
S = 32


@pytest.fixture(scope="module")
def cases():
    return F.make_cases(ARCH, 20, S, prompt_len=32, cache=64, steps=4)


@pytest.fixture(scope="module")
def reference(cases):
    return F.reference(ARCH, *cases)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, cases):
    train, serve = cases
    return F.spawn(tmp_path_factory, "rwkv", F.MESHES, {ARCH: train}, {ARCH: serve})


@pytest.mark.parametrize("mesh", F.MESHES)
def test_loss_and_gradients_match_reference(runs, reference, mesh):
    """the loss is the reference's, not m times it: each rank's share is
    its own positions' cross-entropy weighed by their share"""
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
    logits, each rank's block of ``tm_s`` (its heads) and the whole shift
    tails"""
    F.check_request(runs[mesh], reference["request"], ARCH, F.MESHES[mesh][0])


@pytest.mark.parametrize("mesh", F.MESHES)
def test_shift_tails_bit_equal_on_the_model_ranks(runs, mesh):
    """``tm_shift`` and ``cm_shift`` (leaves 0 and 2 of the state: cm_shift,
    tm_s, tm_shift) are replicated on "model": every rank writes the same
    bits"""
    F.replicated_state_bit_equal(runs[mesh], ARCH, (0, 2))


@pytest.fixture(scope="module")
def timemix(tmp_path_factory, cases):
    w = cases[0][0]
    tm = jax.tree.map(lambda t: t[0], w["blocks"]["tm"])
    x = np.random.default_rng(3).standard_normal((2, S, _ref(ARCH).cfg.d_model)).astype(np.float32)
    tmp = tmp_path_factory.mktemp("rwkv_layers")
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump({"timemix": (ARCH, tm, x)}, f)
    got = _torch_dist.spawn(ranks.family_layers, 2, tmp, (1, 2), ("data", "model"), str(tmp / "cases.pkl"))
    cfg = _ref(ARCH).cfg.inner
    want = np.asarray(RW.timemix_apply(RRT, jax.tree.map(jnp.asarray, tm), jnp.asarray(x), cfg)[0])
    return got, want


def test_time_mix_norm_over_the_whole_dim(timemix):
    """one time mix on two model ranks against the reference's: each rank
    holds half the channels, and ``ln_out``'s mean of squares is summed
    over the axis; a rank's own mean would give other values"""
    got, want = timemix
    for r in got:
        y = r["timemix"]["y"]
        assert y.shape == want.shape
        assert np.abs(y - want).max() <= 2e-5 * np.abs(want).max()
