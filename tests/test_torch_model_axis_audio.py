"""The audio family (whisper-base's smoke config in fp32: 2 + 2 layers,
d_model 64, 2 heads of 32, 24 frames) on a "model" axis
(``models/encdec.py``, ``models/layers.py``) on gloo ranks at (data,
model) = (1, 2), (2, 2) and (1, 4), against the reference on one device.

In training and prefill the encoder is the dense family's
sequence-parallel path over the frames (a rank's frames, its blocks'
weights gathered, keys and values gathered, no mask); its output is
gathered along the frames, so every decoder row's cross-attention sees
every frame, and prefill stores it whole in every rank's cache.  In decode
the self-attention is the dense family's tensor-parallel one, and the
cross-attention projects the rank's columns over every frame: whole heads
on (1, 2) and (2, 2), attended as one process does; on (1, 4) a head's 32
columns lie on two ranks, whose partial scores are summed over the pair
(``AxisGroup.within``) before the softmax.

Held (``tests/_torch_model_axis_families.py``): two int8 ZeRO-1 steps
through the harness's loss with drawn frames against
``jax.value_and_grad`` and ``adamw.apply``; a request (24 drawn frames, a
prompt of 16 into a cache of 32, 4 greedy steps) against the reference's
``prefill`` and ``decode_step``, each rank's cache block and ``enc_out``
whole and bit-equal on the model ranks.  And the encoder on the axis
against the reference's over all frames."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_dist
import _torch_model_axis_families as F
import _torch_model_axis_ranks as ranks
import repro.models.encdec as RE
from repro.models import param as ref_param
from test_torch_model_axis import RRT, _ref

from _torch_parity import one_thread  # noqa: F401  (the fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

ARCH = "whisper-base"
S = 16
MESHES = {**F.MESHES, "1x4": ((1, 4), ("data", "model"))}


@pytest.fixture(scope="module")
def cases():
    return F.make_cases(ARCH, 22, S, prompt_len=16, cache=32, steps=4)


@pytest.fixture(scope="module")
def reference(cases):
    return F.reference(ARCH, *cases)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, cases):
    train, serve = cases
    return F.spawn(tmp_path_factory, "audio", MESHES, {ARCH: train}, {ARCH: serve})


@pytest.mark.parametrize("mesh", MESHES)
def test_loss_and_gradients_match_reference(runs, reference, mesh):
    """the decoder's rows attend to every frame: a rank whose rows saw only
    its own frames would give another loss"""
    F.check_loss_and_gradients(runs[mesh], reference, ARCH, MESHES[mesh][0])


@pytest.mark.parametrize("mesh", MESHES)
def test_shards_and_norm_match_adamw_apply(runs, cases, mesh):
    F.check_shards(runs[mesh], cases[0][0], ARCH)


@pytest.mark.parametrize("mesh", MESHES)
def test_params_identical_across_data_ranks(runs, mesh):
    F.check_params_identical(runs[mesh], ARCH)


@pytest.mark.parametrize("mesh", MESHES)
def test_request_matches_reference(runs, reference, mesh):
    """prefill then greedy decode: the reference's ids, logits and cache;
    on (1, 4) the cross-attention's heads split over pairs of ranks"""
    F.check_request(runs[mesh], reference["request"], ARCH, MESHES[mesh][0])


@pytest.mark.parametrize("mesh", MESHES)
def test_enc_out_whole_and_bit_equal_on_the_model_ranks(runs, cases, mesh):
    """``enc_out`` (leaf 0 of the cache: enc_out, k, v) is replicated on
    "model": every rank holds all 24 frames, the same bits"""
    F.replicated_state_bit_equal(runs[mesh], ARCH, (0,))
    for r in runs[mesh]:
        assert r["serve"][ARCH]["cache"]["enc_out"].shape[1] == _ref(ARCH).cfg.n_frames


@pytest.fixture(scope="module")
def encoded(tmp_path_factory, cases):
    w = cases[0][0]
    frames = cases[0][1]["frames"][:2]
    tmp = tmp_path_factory.mktemp("audio_layers")
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump({"encode": (ARCH, w, frames)}, f)
    got = _torch_dist.spawn(ranks.family_layers, 2, tmp, (1, 2), ("data", "model"), str(tmp / "cases.pkl"))
    rh = _ref(ARCH)
    params = ref_param.cast_floats(jax.tree.map(jnp.asarray, w), rh.cfg.dtype)
    return got, np.asarray(RE.encode(RRT, rh.cfg, params, jnp.asarray(frames)))


def test_encoder_output_covers_every_frame(encoded):
    """the encoder on two model ranks, each given its 12 frames: every rank
    returns all 24 rows, the reference's encoder over all frames"""
    got, want = encoded
    for r in got:
        y = r["encode"]["y"]
        assert y.shape == want.shape
        assert np.abs(y - want).max() <= 2e-5 * np.abs(want).max()
