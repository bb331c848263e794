"""Checkpoint/restart of the port against the reference: the port's
``checkpoint/manager.py`` writes the reference's layout (flat keys as
``jax.tree_util.tree_flatten_with_path`` gives them, bf16 widened to fp32,
``meta.json`` committed last), so a save of either package restores in the
other; ``launch/train.run`` with ``--ckpt-dir`` resumes at ``opt["step"]``
and a run of 10 + 10 steps equals 20 straight (granite-3-2b smoke, as
``tests/test_e2e.py::TestCheckpointRestart`` holds the reference, within its
1e-2, and here bit for bit), with the int8 residual carried across the
restart.  The reference's
train script labels its periodic saves one short of the updates they hold (ROADMAP
Queue C, C4): pinned here, and resumed by the port at the batch after the
last update."""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models.param as ref_param
from repro.checkpoint import manager as ref_manager
from repro.optim import adamw as RA
import repro_torch.configs as port_configs
from repro_torch.checkpoint import manager as port_manager
from repro_torch.launch import train
from repro_torch.models.param import tree_init, tree_leaves, tree_map
from repro_torch.optim import adamw as PA

from _torch_parity import carry, one_thread, to_np  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def reference_state():
    """granite-8b smoke's reference weights (bf16) and AdamW state after
    one update, so that the moments are not zeros and the step is 1."""
    h = ref_configs.load("granite-8b", smoke=True)
    params = ref_param.tree_init(h.param_specs(), jax.random.PRNGKey(3), dtype=jnp.bfloat16)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), params)
    params, opt, _ = RA.apply(RA.OptConfig(), params, grads, RA.init_opt_state(params))
    return {"params": params, "opt": opt}


def port_like(tree):
    """The port's tree of the same keys, shapes and types (values carried)."""
    params = carry(tree["params"], torch.bfloat16)
    return {"params": params, "opt": {**carry({k: v for k, v in tree["opt"].items() if k != "step"}),
                                      "step": torch.tensor(int(tree["opt"]["step"]), dtype=torch.int32)}}


def assert_same_tree(port, ref):
    flat_p, flat_r = port_manager.flatten(port), ref_manager._flatten(ref)
    assert sorted(flat_p) == sorted(flat_r)
    for k, p in flat_p.items():
        r = flat_r[k]
        assert tuple(p.shape) == tuple(r.shape), k
        np.testing.assert_array_equal(to_np(p), to_np(r), err_msg=k)


def test_flat_keys_are_the_references():
    """The port's flat keys are the ones the reference's ``_flatten``
    (``jax.tree_util.tree_flatten_with_path``, keys joined by "/") gives the
    same nested dict, in the same order."""
    ref = reference_state()
    keys = list(port_manager.flatten(port_like(ref)))
    assert keys == list(ref_manager._flatten(ref))
    assert "params/blocks/attn/wq" in keys and "opt/step" in keys and "opt/master/embed/tok" in keys


def test_reference_save_restores_in_the_port(tmp_path):
    ref = reference_state()
    ref_manager.CheckpointManager(str(tmp_path)).save(1, ref, blocking=True)
    like = tree_map(torch.zeros_like, port_like(ref))
    got = port_manager.CheckpointManager(str(tmp_path)).restore(1, like)
    assert_same_tree(got, ref)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(got["params"]))      # narrowed back
    assert all(t.dtype == torch.float32 for t in tree_leaves(got["opt"]["master"]))
    assert got["opt"]["step"].dtype == torch.int32 and got["opt"]["step"].shape == () and int(got["opt"]["step"]) == 1


def test_port_save_restores_in_the_reference(tmp_path):
    """The port's save, with its residual under its own key, restores the
    reference's ``{"params", "opt"}`` (the reference reads only its keys)."""
    ref = reference_state()
    port = port_like(ref)
    residual = tree_map(lambda p: torch.randn(p.shape), port["params"])
    port_manager.CheckpointManager(str(tmp_path)).save(1, {**port, "residual": residual}, blocking=True)
    meta = json.loads((tmp_path / "step_00000001" / "meta.json").read_text())
    assert meta["dtypes"]["params/embed/tok"] == "float32" and meta["dtypes"]["opt/step"] == "int32"
    assert any(k.startswith("residual/") for k in meta["keys"])
    like = jax.tree.map(jnp.zeros_like, ref)
    got = ref_manager.CheckpointManager(str(tmp_path)).restore(1, like)
    assert_same_tree(port, got)
    assert all(a.dtype == jnp.bfloat16 for a in jax.tree.leaves(got["params"]))
    assert got["opt"]["step"].dtype == jnp.int32 and int(got["opt"]["step"]) == 1


def test_save_takes_its_copy_before_returning(tmp_path):
    """The train loop updates its tensors in place right after ``save``
    returns; the save holds the values of the call."""
    mgr = port_manager.CheckpointManager(str(tmp_path))
    w = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    b = torch.ones(4, dtype=torch.bfloat16)
    mgr.save(5, {"w": w, "b": b})
    w.add_(100.0)
    b.zero_()
    mgr.wait()
    got = mgr.restore(5, {"w": w, "b": b})
    assert torch.equal(got["w"], torch.arange(6, dtype=torch.float32).reshape(2, 3))
    assert got["b"].dtype == torch.bfloat16 and torch.equal(got["b"], torch.ones(4, dtype=torch.bfloat16))


def test_half_written_save_is_ignored(tmp_path):
    mgr = port_manager.CheckpointManager(str(tmp_path))
    mgr.save(3, {"w": torch.ones(2)}, blocking=True)
    partial = tmp_path / "step_00000007"
    partial.mkdir()
    np.save(partial / "w.npy", np.zeros(2, np.float32))
    (partial / "meta.json.tmp").write_text("{")
    assert mgr.steps() == [3] and mgr.latest_step() == 3
    assert ref_manager.CheckpointManager(str(tmp_path)).latest_step() == 3


def test_keep_removes_the_oldest(tmp_path):
    mgr = port_manager.CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"w": torch.full((2,), float(s))})
    mgr.wait()
    assert mgr.steps() == [3, 4]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000003", "step_00000004"]
    assert float(mgr.restore(4, {"w": torch.zeros(2)})["w"][0]) == 4.0


def test_restore_checks_keys_and_shapes(tmp_path):
    mgr = port_manager.CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": torch.ones(2, 3)}, blocking=True)
    with pytest.raises(KeyError, match="missing"):
        mgr.restore(1, {"a": torch.ones(2, 3), "b": torch.ones(1)})
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(1, {"a": torch.ones(3, 2)})


def test_a_failed_write_is_raised_by_wait(tmp_path):
    mgr = port_manager.CheckpointManager(str(tmp_path))
    (tmp_path / "step_00000002").write_text("not a directory")
    mgr.save(2, {"w": torch.ones(2)})
    with pytest.raises(RuntimeError, match="checkpoint save failed"):
        mgr.wait()
    mgr.wait()                                     # raised once, then clear


# ---------------------------------------------------------------------------
# train.run with --ckpt-dir
# ---------------------------------------------------------------------------


def run_args(ckpt_dir, steps, compression, **over):
    argv = ["--arch", "granite-3-2b", "--device", "cpu", "--steps", str(steps), "--batch", "8",
            "--seq", "64", "--lr", "1e-3", "--compression", compression, "--ckpt-dir", str(ckpt_dir)]
    for k, v in over.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    return train.build_parser().parse_args(argv)


def drawn_weights(seed=0):
    h = port_configs.load("granite-3-2b", smoke=True)
    return tree_init(h.param_specs(), torch.Generator().manual_seed(seed), torch.bfloat16, "cpu")


def saved(directory, step) -> dict:
    """Every leaf of the save at ``step``, by flat key, as it lies on disk."""
    src = directory / f"step_{step:08d}"
    meta = json.loads((src / "meta.json").read_text())
    return {k: np.load(src / (k.replace("/", "__") + ".npy")) for k in meta["keys"]}


def assert_same_saves(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_restart_is_equivalent(tmp_path, compression):
    """train 10 -> save -> (a new run, fresh trees) restore -> train 10 more
    == train 20 straight: every weight within 1e-2 (the reference test's
    limit) and, on the CPU, where a step is deterministic, bit for bit: the
    losses, the weights and every leaf of the two runs' saves at 10 and at
    20 (AdamW's ``m``, ``v``, ``master`` and ``step`` and, in int8, the
    residual), so a restore that lost any part of the state would show."""
    straight = drawn_weights()
    a = train.run(run_args(tmp_path / "a", 20, compression, ckpt_every=10), params=straight)

    first = drawn_weights()
    b = train.run(run_args(tmp_path / "b", 20, compression, ckpt_every=10), params=first, stop_at=10)
    assert len(b["losses"]) == 10 and b["start_step"] == 0
    assert_same_saves(saved(tmp_path / "a", 10), saved(tmp_path / "b", 10))
    resumed = drawn_weights(seed=1)                          # overwritten by the restore
    lines = []
    c = train.run(run_args(tmp_path / "b", 20, compression, ckpt_every=10), params=resumed, log=lines.append)
    assert c["resumed_from"] == 10 and c["start_step"] == 10 and len(c["losses"]) == 10
    assert c["residual_restored"] is (True if compression == "int8" else None)
    assert not any("zero residual" in line for line in lines)
    end = saved(tmp_path / "b", 20)
    assert int(end["opt/step"]) == 20
    assert any(k.startswith("residual/") for k in end) is (compression == "int8")
    assert_same_saves(saved(tmp_path / "a", 20), end)
    assert a["losses"][:10] == b["losses"] and a["losses"][10:] == c["losses"]
    for x, y in zip(tree_leaves(straight), tree_leaves(resumed)):
        np.testing.assert_allclose(to_np(x), to_np(y), atol=1e-2)
        assert torch.equal(x, y)


def test_resume_starts_at_the_updates_held(tmp_path):
    """Saves every 2 updates are labelled 2, 4, ... and hold that many; a run
    cut after 3 updates writes its save at 3; the next run starts at step 3
    and feeds the batches of steps 3, 4, 5, none twice."""
    args = run_args(tmp_path, 6, "int8", ckpt_every=2, batch=2, seq=16)
    first = train.run(args, stop_at=3)
    mgr = port_manager.CheckpointManager(str(tmp_path))
    assert mgr.steps() == [2, 3]
    held = [int(mgr.restore(s, {"opt": {"step": PA.opt_state_specs({})["step"]}}, device="cpu")["opt"]["step"])
            for s in (2, 3)]
    assert held == [2, 3]
    seen = []
    second = train.run(args, observe=lambda step, *_: seen.append(step))
    assert seen == [3, 4, 5] and second["start_step"] == 3 and len(first["losses"]) == 3
    assert mgr.steps() == [3, 4, 6]                    # 4 periodic, 6 the end; 2 gone (keep=3)


def test_resume_past_the_end_writes_no_save(tmp_path):
    """A run asked for fewer updates than its latest save holds runs no step
    and writes no save: a save under the smaller label would hold more
    updates than its label says."""
    train.run(run_args(tmp_path, 4, "int8", ckpt_every=10, batch=2, seq=16))
    mgr = port_manager.CheckpointManager(str(tmp_path))
    assert mgr.steps() == [4]
    res = train.run(run_args(tmp_path, 2, "int8", ckpt_every=10, batch=2, seq=16))
    assert res["start_step"] == 4 and res["losses"] == [] and mgr.steps() == [4]


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference's own train script, 4 steps with a save after every step."""
    import repro.launch.train as ref_train

    d = tmp_path_factory.mktemp("ref_ckpt")
    argv = sys.argv
    sys.argv = ["train", "--steps", "4", "--batch", "4", "--seq", "32", "--lr", "1e-2",
                "--ckpt-dir", str(d), "--ckpt-every", "1", "--log-every", "100"]
    try:
        ref_train.main()
    finally:
        sys.argv = argv
    return d


def test_reference_labels_its_saves_one_short(reference_run):
    """ROADMAP C4: the reference's train script saves after step s's update under
    the label s (``repro/launch/train.py:130``), so the save holds s + 1
    updates, and it resumes at the label (``:92-94``), running batch s
    again.  Its final save (``:132``) is labelled right.  If this fails the
    reference changed: revisit ``train.run``'s resume and Queue C."""
    mgr = ref_manager.CheckpointManager(str(reference_run))
    assert mgr.steps() == [2, 3, 4]
    held = {s: int(mgr.restore(s, {"opt": {"step": jnp.zeros((), jnp.int32)}})["opt"]["step"]) for s in (2, 3, 4)}
    assert held == {2: 3, 3: 4, 4: 4}


def test_port_resumes_a_reference_save_after_its_last_update(reference_run, tmp_path):
    """The reference's save labelled 2 holds 3 updates: the port resumes it
    at step 3 (the batch after the last update, not batch 2 again), with
    the reference's weights and a zero int8 residual, and says so."""
    import shutil

    shutil.copytree(reference_run / "step_00000002", tmp_path / "step_00000002")
    lines, seen = [], []
    args = train.build_parser().parse_args(["--device", "cpu", "--steps", "5", "--batch", "4", "--seq", "32",
                                            "--lr", "1e-2", "--compression", "int8", "--ckpt-dir", str(tmp_path)])
    res = train.run(args, log=lines.append, observe=lambda step, *_: seen.append(step))
    assert res["resumed_from"] == 2 and res["start_step"] == 3 and seen == [3, 4]
    assert res["residual_restored"] is False and any("zero residual" in line for line in lines)
    assert all(np.isfinite(res["losses"]))
