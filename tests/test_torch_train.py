"""The training slice against the reference: ``layers.cross_entropy``, the
granite-8b smoke loss and its gradients (``value_and_grad`` of the port's
``loss_fn`` vs ``jax.value_and_grad`` of the reference's) on both paths and
under every remat policy, whole train steps (gradients -> int8 compression
with the residual carried -> AdamW) through ``launch/train.run`` vs the
reference's functions, ``train.run`` lowering the loss as ``tests/test_e2e.py``
asks of the reference, the port's copies of the data pipeline and the
training supervisor, and the reference's dropped error-feedback residual.

Tolerances.  float32: loss and gradients 2e-5 absolute (the same arithmetic,
sums in another order).  bfloat16: loss within 2e-2 of its value, each
gradient leaf within 2e-2 of that leaf's largest |g| (a bf16 gradient is
rounded where the two frameworks sum in different orders; the kernel path
also keeps the attention probabilities in fp32 where the reference rounds
them to bf16)."""

import argparse
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.data.pipeline as ref_pipeline
import repro.models.param as ref_param
import repro.runtime.fault_tolerance as ref_ft
from repro.models import layers as RL
from repro.models.api import ShapeCell as RefCell
from repro.models.layers import Runtime as RefRuntime
from repro.optim import adamw as RA, compression as RC
import repro_torch.configs as port_configs
import repro_torch.data.pipeline as port_pipeline
import repro_torch.runtime.fault_tolerance as port_ft
from repro_torch.launch import train
from repro_torch.models import layers as PL
from repro_torch.models.api import ShapeCell
from repro_torch.models.layers import Runtime
from repro_torch.models.param import tree_leaves, value_and_grad

from _torch_parity import JDT, TDT, carry, max_err, one_thread, to_np  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

RRT = RefRuntime(rules=None)
B, S = 4, 32


def harnesses(dtype, **cfg):
    return (ref_configs.load("granite-8b", smoke=True).clone(dtype=JDT[dtype], **cfg),
            port_configs.load("granite-8b", smoke=True).clone(dtype=TDT[dtype], **cfg))


def ref_weights(dtype):
    rh, _ = harnesses(dtype)
    return ref_param.tree_init(rh.param_specs(), jax.random.PRNGKey(7), dtype=JDT[dtype])


def batch(step=0):
    cfg = ref_pipeline.DataConfig(global_batch=B, seq_len=S, vocab_size=512, seed=0)
    raw = ref_pipeline.SyntheticSource(cfg).batch_at(step)
    return {"tokens": raw[:, :-1], "labels": raw[:, 1:]}


def reference_loss_and_grads(dtype, params=None, b=None):
    rh, _ = harnesses(dtype)
    params = ref_weights(dtype) if params is None else params
    b = batch() if b is None else b
    loss, grads = jax.value_and_grad(rh.loss(RRT))(params, jax.tree.map(jnp.asarray, b))
    return float(loss), grads


def port_loss_and_grads(dtype, use_kernels, params=None, b=None, **cfg):
    _, ph = harnesses(dtype, **cfg)
    params = carry(ref_weights(dtype) if params is None else params, TDT[dtype])
    b = batch() if b is None else b
    loss, grads = value_and_grad(ph.loss(Runtime(use_kernels=use_kernels)))(
        params, {k: torch.from_numpy(v) for k, v in b.items()})
    return float(loss), grads


def reference_bf16_noise():
    """Per gradient leaf, how far the reference's own bf16 gradients lie from
    its float32 gradients of the same (bf16-valued) weights."""
    _, r16 = reference_loss_and_grads("bfloat16")
    w32 = jax.tree.map(lambda a: a.astype(jnp.float32), ref_weights("bfloat16"))
    _, r32 = reference_loss_and_grads("float32", params=w32)
    return [max_err(a, b) for a, b in zip(jax.tree.leaves(r16), jax.tree.leaves(r32))]


def assert_grads_close(p, r, dtype):
    """float32: 2e-5.  bfloat16: 2e-2 of the leaf's largest |g|, or, where the
    reference's own bf16 gradient lies farther than that from its float32 one
    (the norm scales' gradients, sums over every token of bf16 products that
    cancel: ``test_reference_bf16_gradient_noise``), twice that distance: two
    bf16 computations may each lie that far from the float32 result, on
    either side of it."""
    noise = reference_bf16_noise() if dtype == "bfloat16" else None
    for i, (a, g) in enumerate(zip(jax.tree.leaves(r), tree_leaves(p))):
        assert g.dtype == TDT[dtype]
        limit = 2e-5 if dtype == "float32" else max(2e-2 * float(np.abs(to_np(a)).max()), 2 * noise[i])
        assert max_err(g, a) <= limit, (i, max_err(g, a), limit)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("vocab_real", [300, 256])
def test_cross_entropy_matches_reference(vocab_real, dtype):
    """The padded vocab tail (300 of 512 real) masked with -1e9; the gathered
    gold logit equals the reference's one-hot sum."""
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 512)) * 4).astype(np.float32)
    labels = rng.integers(0, vocab_real, (3, 7), dtype=np.int32)
    r = float(RL.cross_entropy(jnp.asarray(logits, JDT[dtype]), jnp.asarray(labels), vocab_real))
    p = float(PL.cross_entropy(torch.from_numpy(logits).to(TDT[dtype]), torch.from_numpy(labels), vocab_real))
    assert abs(p - r) <= 1e-5


def test_cross_entropy_gradient_matches_reference():
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((2, 5, 512)) * 3).astype(np.float32)
    labels = rng.integers(0, 400, (2, 5), dtype=np.int32)
    r = jax.grad(lambda lg: RL.cross_entropy(lg, jnp.asarray(labels), 400))(jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_()
    PL.cross_entropy(lg, torch.from_numpy(labels), 400).backward()
    assert max_err(lg.grad, r) <= 1e-8
    assert not lg.grad[..., 400:].any()            # the padded tail gets no gradient


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_reference(dtype, use_kernels):
    r_loss, r_grads = reference_loss_and_grads(dtype)
    p_loss, p_grads = port_loss_and_grads(dtype, use_kernels)
    assert abs(p_loss - r_loss) <= (2e-5 if dtype == "float32" else 2e-2 * abs(r_loss))
    assert_grads_close(p_grads, r_grads, dtype)


def test_reference_bf16_gradient_noise():
    """The control of the bf16 limit above: the reference's bf16 gradients lie
    within 2e-2 of each leaf's largest |g| from its float32 ones on every
    leaf but the norm scales (ln1, ln2, final_norm), where they lie farther;
    only there does the limit widen."""
    rh, _ = harnesses("bfloat16")
    names = [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_flatten_with_path(
        rh.param_specs(), is_leaf=lambda x: hasattr(x, "logical"))[0]]
    _, r16 = reference_loss_and_grads("bfloat16")
    over = [n for n, a, e in zip(names, jax.tree.leaves(r16), reference_bf16_noise())
            if e > 2e-2 * float(np.abs(to_np(a)).max())]
    assert over and all("ln" in n or "norm" in n for n in over), over


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("policy", ["dots", "none"])
def test_remat_changes_nothing(policy, dtype):
    """Recomputing a block in the backward (``"nothing"``, the config's
    default), keeping only its matrix products (``"dots"``) or keeping
    everything (``"none"``) give the same loss and gradients, bit for bit."""
    base_loss, base = port_loss_and_grads(dtype, True)
    loss, grads = port_loss_and_grads(dtype, True, remat_policy=policy)
    assert loss == base_loss
    for a, b in zip(tree_leaves(base), tree_leaves(grads)):
        assert torch.equal(a, b)


def test_remat_policy_unknown_raises():
    with pytest.raises(ValueError, match="remat_policy"):
        port_loss_and_grads("float32", True, remat_policy="everything")


def test_train_input_specs_match_reference():
    rh, ph = harnesses("bfloat16")
    r = rh.train_input_specs(RefCell("t", "train", 64, 8))
    p = ph.train_input_specs(ShapeCell("t", "train", 64, 8))
    assert sorted(p) == sorted(r)
    for k in r:
        assert (p[k].shape, p[k].logical, p[k].init) == (r[k].shape, r[k].logical, r[k].init)
        assert p[k].dtype == torch.int32


# ---------------------------------------------------------------------------
# whole steps through train.run
# ---------------------------------------------------------------------------


def train_args(**over):
    argv = ["--device", "cpu", "--steps", "3", "--batch", str(B), "--seq", str(S),
            "--lr", "1e-3", "--compression", "int8"]
    for k, v in over.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    return train.build_parser().parse_args(argv)


def reference_steps(params, steps, comp_mode, lr=1e-3):
    """The reference's functions in the reference train script's order, with
    the residual carried (which that script does not do): per step the loss, the
    gradients, the payload and the state after the update."""
    rh, _ = harnesses("float32")
    comp = RC.CompressionConfig(mode=comp_mode)
    opt_cfg = RA.OptConfig(lr=lr, warmup_steps=10, decay_steps=steps)
    state, residual, out = RA.init_opt_state(params), None, []
    src = ref_pipeline.SyntheticSource(ref_pipeline.DataConfig(global_batch=B, seq_len=S, vocab_size=512, seed=0))
    for step in range(steps):
        raw = src.batch_at(step)
        loss, grads = jax.value_and_grad(rh.loss(RRT))(
            params, {"tokens": jnp.asarray(raw[:, :-1]), "labels": jnp.asarray(raw[:, 1:])})
        payload, residual = RC.compress_grads(comp, grads, residual)
        params, state, metrics = RA.apply(opt_cfg, params, payload, state)
        out.append({"loss": float(loss), "grads": grads, "payload": payload,
                    "master": state["master"], "grad_norm": float(metrics["grad_norm"])})
    return out


def assert_masters_close(ref_master, p_params, lrs):
    """fp32 masters after the steps: within 1e-6, but for at most 1e-4 of a
    leaf's elements (8 in a small leaf), and every element within twice the
    learning rates summed.  AdamW's first steps move an element by about lr
    whatever the size of its gradient, so an element whose gradient is
    near zero (or whose int8 value straddled a rounding boundary) may move
    differently on the two sides."""
    for a, b in zip(jax.tree.leaves(ref_master), tree_leaves(p_params)):
        d = np.abs(to_np(b) - to_np(a))
        assert (d > 1e-6).sum() <= max(8, 1e-4 * d.size)
        assert d.max() <= 2 * sum(lrs)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_train_steps_match_reference(use_kernels):
    """Three steps of float32 granite-8b smoke from the same weights through
    ``train.run`` (int8, residual carried) and the reference's functions.
    Step 0: loss and gradients within 2e-5; the int8 values of the payload
    equal but where the two gradients straddle a rounding boundary (at most
    1e-4 of a leaf's elements, 2 in a small leaf), the payload within 1e-7
    elsewhere and one quantisation step there.  Every step: the loss within
    1e-4; the masters after the last as ``assert_masters_close``."""
    params = ref_weights("float32")
    ref = reference_steps(params, 3, "int8")
    _, ph = harnesses("float32")
    seen = []

    def observe(step, loss, grads, payload, wire):
        seen.append({"loss": float(loss), "grads": grads, "payload": payload})

    p_params = carry(params, torch.float32)
    res = train.run(train_args(), harness=ph, params=p_params,
                    rt=Runtime(use_kernels=use_kernels), observe=observe)
    assert res["losses"] == [s["loss"] for s in seen]
    assert abs(seen[0]["loss"] - ref[0]["loss"]) <= 2e-5
    assert_grads_close(seen[0]["grads"], ref[0]["grads"], "float32")
    for a, b in zip(jax.tree.leaves(ref[0]["payload"]), tree_leaves(seen[0]["payload"])):
        a = to_np(a)
        step = np.abs(a).max() / 127
        diff = np.abs(to_np(b) - a)
        assert (diff > 1e-7).sum() <= max(2, 1e-4 * diff.size)
        assert (diff <= step * 1.0001 + 1e-7).all()
    for s in range(3):
        assert abs(res["losses"][s] - ref[s]["loss"]) <= 1e-4
    assert_masters_close(ref[-1]["master"], p_params, res["lrs"])     # p_params were updated in place


def test_train_step_without_compression_matches_reference():
    """``--compression none``: the payload is the gradients themselves; three
    steps' losses within 1e-4, grad norms within 1e-5 (relative) and the
    masters as ``assert_masters_close``."""
    params = ref_weights("float32")
    ref = reference_steps(params, 3, "none")
    _, ph = harnesses("float32")
    p_params = carry(params, torch.float32)
    res = train.run(train_args(compression="none"), harness=ph, params=p_params)
    for s in range(3):
        assert abs(res["losses"][s] - ref[s]["loss"]) <= 1e-4
        assert abs(res["grad_norms"][s] - ref[s]["grad_norm"]) <= 1e-5 * ref[s]["grad_norm"]
    assert_masters_close(ref[-1]["master"], p_params, res["lrs"])


def test_residual_is_carried_across_steps():
    """The port's train loop hands each step's residual to the next: the payload
    of step 1 is Q(g1 + r0), which differs from Q(g1) alone."""
    from repro_torch.optim import compression as PC

    seen = []
    train.run(train_args(steps=2), observe=lambda s, l, g, p, w: seen.append((g, p)))
    (g0, p0), (g1, p1) = seen
    comp = PC.CompressionConfig(mode="int8")
    _, r0 = PC.compress_grads(comp, g0)
    carried, _ = PC.compress_grads(comp, g1, r0)
    alone, _ = PC.compress_grads(comp, g1)
    for a, b, c in zip(tree_leaves(p1), tree_leaves(carried), tree_leaves(alone)):
        assert torch.equal(a, b)
    assert any(not torch.equal(a, c) for a, c in zip(tree_leaves(p1), tree_leaves(alone)))


def test_train_lowers_the_loss():
    """As ``tests/test_e2e.py::test_loss_decreases_granite`` asks of the
    reference: 40 steps of granite-8b smoke at lr 1e-3 (bf16 weights, the
    train loop's int8 compression) lower the loss by more than 0.5."""
    args = train_args(steps=40, seq=64, batch=8)
    res = train.run(args)
    losses = res["losses"]
    assert len(losses) == 40 and all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.5
    assert res["launches"] == {"flash_attention": 0, "moe_dispatch": 0, "ssd_scan": 0, "rwkv6_scan": 0,
                               "ccu_reduce": 0}          # CPU: the plain versions
    assert len(res["step_ms"]) == 40 and res["tokens_per_s"] > 0 and res["peak_memory_gb"] is None


@pytest.mark.parametrize("steps", [1, 3])
def test_tokens_per_s_leaves_out_the_first_step(steps):
    """The rate is over the steps' own wall times, the first (which builds
    the kernels on the card) left out where there are more."""
    args = train_args(steps=steps, seq=16, batch=2)
    res = train.run(args)
    warm = res["step_ms"][1:] or res["step_ms"]
    assert res["tokens_per_s"] == pytest.approx(len(warm) * 2 * 16 * 1e3 / sum(warm))


def test_train_main_prints(capsys):
    train.main(["--device", "cpu", "--steps", "12", "--lr", "1e-2", "--seq", "32", "--log-every", "5"])
    out = capsys.readouterr().out
    assert out.count("[train] step=") == 4 and "done. first loss=" in out


@pytest.mark.parametrize("flag,item", [pytest.param(["--auto-parallel"], "[planner]", id="flag0-A12")])
def test_train_flags_not_ported_raise(flag, item):
    """The flag that raised while the planner was not ported (ROADMAP A12)
    now runs: ``run`` logs the planner's three lines and its report, then
    trains (``tests/test_torch_auto_parallel.py`` holds the lines to the
    reference's)."""
    args = train.build_parser().parse_args(["--device", "cpu", "--steps", "1", "--seq", "16", "--batch", "2",
                                            *flag])
    lines = []
    res = train.run(args, log=lines.append)
    assert [line.startswith(item) for line in lines[:3]] == [True] * 3
    assert len(res["plans"]) == 3 and len(res["losses"]) == 1


def test_train_smoke_flag_and_depth():
    args = train.build_parser().parse_args(["--no-smoke", "--n-layers", "8"])
    assert args.smoke is False and args.n_layers == 8 and args.device == "cuda"
    assert args.batch == 8 and args.seq == 256 and args.compression == "none"      # the reference's defaults


def test_train_wants_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is there")
    with pytest.raises(RuntimeError, match="cuda"):
        train.run(train.build_parser().parse_args(["--steps", "1"]))


# ---------------------------------------------------------------------------
# the port's copies of the data pipeline and the supervisor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pattern", ["arith", "uniform"])
@pytest.mark.parametrize("host_index,host_count", [(0, 1), (1, 2)])
def test_synthetic_source_copy(pattern, host_index, host_count):
    kw = dict(global_batch=8, seq_len=33, vocab_size=1000, seed=5, pattern=pattern)
    r = ref_pipeline.SyntheticSource(ref_pipeline.DataConfig(**kw), host_index, host_count)
    p = port_pipeline.SyntheticSource(port_pipeline.DataConfig(**kw), host_index, host_count)
    for step in (0, 1, 17):
        np.testing.assert_array_equal(p.batch_at(step), r.batch_at(step))


def test_memmap_source_copy(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 60000, 5000, dtype=np.uint16).tofile(path)
    kw = dict(global_batch=4, seq_len=31, vocab_size=60000)
    for host in (0, 1):
        r = ref_pipeline.MemmapSource(str(path), ref_pipeline.DataConfig(**kw), host, 2)
        p = port_pipeline.MemmapSource(str(path), port_pipeline.DataConfig(**kw), host, 2)
        for step in (0, 3, 40):
            np.testing.assert_array_equal(p.batch_at(step), r.batch_at(step))


def test_pipeline_copy_same_batches():
    kw = dict(global_batch=2, seq_len=16, vocab_size=512, seed=0)
    r_cfg, p_cfg = ref_pipeline.DataConfig(**kw), port_pipeline.DataConfig(**kw)
    r = ref_pipeline.Pipeline(ref_pipeline.SyntheticSource(r_cfg), r_cfg, start_step=3)
    p = port_pipeline.Pipeline(port_pipeline.SyntheticSource(p_cfg), p_cfg, start_step=3)
    try:
        for _ in range(4):
            a, b = next(r), next(p)
            assert a["step"] == b["step"]
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(b[k], a[k])
        assert p.state() == r.state() == {"step": 7}
    finally:
        r.close()
        p.close()


def test_supervisor_copy_same_state():
    """Both supervisors on one simulated clock, fed the same heartbeats
    (a straggler among them, then a silent worker): the same workers' state,
    the same events, the same dead workers."""
    def run(mod):
        now = [0.0]
        sup = mod.TrainingSupervisor(3, heartbeat_timeout_s=5.0, clock=lambda: now[0])
        dead = []
        for step, dt in enumerate([1.0, 1.1, 0.9, 5.0, 5.5, 6.0, 1.0, 1.0]):
            now[0] += dt
            sup.heartbeat(0, step, dt)
            sup.heartbeat(1, step, dt if step < 3 else None)
            if step < 2:
                sup.heartbeat(2, step)
            dead.append(sup.dead_workers())
        state = {i: (w.last_heartbeat, w.step, w.slow_strikes) for i, w in sup.workers.items()}
        return state, sup.events, sup.step_times, dead, sup.dead_workers(now=0.0)

    assert run(port_ft) == run(ref_ft)


# ---------------------------------------------------------------------------
# the reference's fault that the port works around
# ---------------------------------------------------------------------------


def test_reference_train_step_drops_the_residual(monkeypatch):
    """The reference's train script calls ``compress_grads(comp, grads)`` and drops
    the residual it gets back (``repro/launch/train.py:101``), so its int8
    error feedback never acts across steps.  Its step is traced once: the
    call it makes is given no residual.  If this fails the reference changed:
    revisit the port's train loop, which carries the residual, and ROADMAP's
    Queue C."""
    import repro.launch.train as ref_train
    import repro.optim.compression as ref_comp

    calls, compress = [], ref_comp.compress_grads

    def recording(cfg, grads, residual=None):
        out = compress(cfg, grads, residual)
        calls.append((cfg.mode, residual, out[1]))
        return out

    monkeypatch.setattr(ref_comp, "compress_grads", recording)
    monkeypatch.setattr(sys, "argv", ["train", "--steps", "8", "--batch", "4", "--seq", "32",
                                      "--lr", "1e-2", "--compression", "int8", "--log-every", "100"])
    ref_train.main()
    assert calls and all(mode == "int8" for mode, _, _ in calls)
    assert all(residual is None for _, residual, _ in calls)
    assert all(new is not None for _, _, new in calls)       # one is made, and dropped
