"""The port's copy of tests/test_models.py::TestSmoke: for each of the ten
architectures' smoke configs, one training step's loss and gradients (finite,
not all zero) and one decode step's logits and state (shapes, finite, the
state's structure kept), on the CPU through both paths (on the CPU the kernel
path runs the kernels' plain versions), and the long-context skip matrix."""

import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro_torch.configs import ARCH_IDS, load
from repro_torch.models.api import ShapeCell
from repro_torch.models.layers import Runtime
from repro_torch.models.param import tree_init, tree_leaves, tree_map, value_and_grad

from _torch_parity import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

CELL = ShapeCell("smoke", "train", 32, 2)
DECODE_CELL = ShapeCell("smoke_decode", "decode", 64, 2)


def make_batch(harness, cell):
    """as the reference's: integer leaves drawn in [0, 64), float leaves 0.01"""
    batch = {}
    for k, s in harness.train_input_specs(cell).items():
        if s.dtype == torch.int32:
            batch[k] = torch.from_numpy(np.random.default_rng(0).integers(0, 64, s.shape).astype(np.int32))
        else:
            batch[k] = torch.full(s.shape, 0.01, dtype=s.dtype)
    return batch


def params_of(harness):
    return tree_init(harness.param_specs(), torch.Generator().manual_seed(0), device="cpu")


def test_the_ten_archs():
    assert ARCH_IDS == ref_configs.ARCH_IDS and len(ARCH_IDS) == 10


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("arch", ARCH_IDS)
class TestSmoke:
    def test_train_step_loss_finite(self, arch, use_kernels):
        h = load(arch, smoke=True)
        loss, grads = value_and_grad(h.loss(Runtime(use_kernels=use_kernels)))(params_of(h), make_batch(h, CELL))
        assert np.isfinite(float(loss))
        gnorm = sum(float(g.float().abs().sum()) for g in tree_leaves(grads))
        assert np.isfinite(gnorm) and gnorm > 0

    def test_decode_step_shapes(self, arch, use_kernels):
        h = load(arch, smoke=True)
        state = tree_init(h.serve_state_specs(DECODE_CELL), torch.Generator().manual_seed(0), device="cpu")
        structure = tree_map(lambda t: (tuple(t.shape), t.dtype), state)
        tokens = torch.zeros((2, 1), dtype=torch.int32) + 3
        with torch.no_grad():
            logits, new_state = h.decode(Runtime(use_kernels=use_kernels))(params_of(h), state, tokens, 5)
        assert logits.shape[0] == 2 and logits.shape[1] == 1
        assert logits.shape[2] >= h.cfg.vocab_size
        assert torch.isfinite(logits.float()).all()
        # state structure preserved
        assert tree_map(lambda t: (tuple(t.shape), t.dtype), new_state) == structure

    def test_skip_matrix_matches_design(self, arch, use_kernels):
        h = load(arch, smoke=True)
        skip = h.skip_reason("long_500k")
        if arch in ("zamba2_1_2b", "rwkv6_1_6b", "mixtral_8x22b"):
            assert skip is None
        else:
            assert skip is not None
        assert h.skip_reason("train_4k") is None
