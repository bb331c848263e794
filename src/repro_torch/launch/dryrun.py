"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on the meta
device — port of ``repro/launch/dryrun.py`` (``analytic_model_flops``,
``_probe_metrics``, ``extrapolated_metrics``, ``run_cell``, ``main``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k --both-meshes
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --force

The reference lowers and compiles each cell's jitted step on 256 or 512 host
devices and reads XLA's analyses.  The port's step is eager, with explicit
collectives, so the dry-run runs it: ``train_step.lower_bundle`` executes
the cell's step once, as rank 0 of the production mesh (``(16, 16)`` =
("data", "model"), or ``(2, 16, 16)`` with "pod") over a fake process group
(``launch/mesh.fake_mesh``), on rank 0's blocks of the arguments as tensors
on the ``meta`` device.  Nothing is allocated, computed or sent; every
collective, product, operand and allocation is counted.  No kernel launches
on ``meta``, so the **plain path** is traced (``"path": "plain"`` in each
record): its attention materialises the ``(B, K, G, Sq, Sk)`` scores, so
the bytes and the peak are upper bounds at attention.

Each cell writes ``results/dryrun_torch/<arch>__<shape>__<mesh>.json`` with
the reference's keys (``memory``, ``cost``, ``collectives`` with
``by_kind``, ``roofline``, ``params``, ``status``) and, new here,
``collectives.by_axis`` (ring wire bytes by mesh axis),
``collectives.operand_bytes_by_axis`` (what the transports handed the
process group) and ``path``.  The roofline's peaks are arguments
(``--peak-flops``, ``--hbm-bw``, ``--link-bw``), an H100 SXM5's by default.
Every family's cells are built; the only cells written as ``"status":
"skipped"`` are those of the reference's own ``skip_reason``
(``long_500k`` on full attention).  A decode cell's step writes the cell's
last position that its cache holds (``train_step.decode_position``): no
tensor is read on ``meta``.

The reference's counters come from probes (XLA's cost analysis counts a
scanned loop's body once), extrapolated by family
(``extrapolated_metrics``): linearly from 1 and 2 layers for the dense,
MoE, VLM and audio families; for the SSM family also linearly in the
sequence, from S0 and 2·S0; for the hybrid family from 6, 7 and 8 layers
(the shared block's share) at S = 256, 512 and 1024, its Mamba2 layers'
and the rest's costs fitted linearly in S and the shared block's
quadratically.  The eager trace counts every layer, so ``run_cell`` also
traces the full depth and records whether the two agree
(``extrapolation_exact``) and, per counter, the fit's relative distance
from the trace (``extrapolation_rel_err``; 0 where exact).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time
import traceback

from ..configs import ARCH_IDS, load
from ..models.api import SHAPES
from ..models.param import param_count
from ..train.train_step import build_bundle, lower_bundle
from .hlo_stats import Roofline, collective_stats
from .mesh import fake_mesh, production_shape

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
# an H100 SXM5 (NVIDIA's data sheet): dense bf16, HBM3, NVLink 4 (900 GB/s
# both ways, 450 GB/s each way)
PEAK_FLOPS, HBM_BW, LINK_BW = 989e12, 3.35e12, 450e9


def analytic_model_flops(harness, cell) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE), over the whole mesh."""
    n_params = param_count(harness.param_specs())
    cfg = harness.cfg
    moe = getattr(cfg, "moe", None)
    if moe is not None:
        # embedding + attention stay dense; experts scale by topk/E
        from ..models.moe import moe_specs

        expert_params = param_count(moe_specs(cfg.d_model, moe)) * cfg.n_layers
        active = n_params - expert_params + expert_params * moe.topk / moe.n_experts
    else:
        active = n_params
    tokens = cell.global_batch * cell.seq_len
    if cell.kind == "train":
        return 6.0 * active * tokens
    if cell.kind == "prefill":
        return 2.0 * active * tokens
    return 2.0 * active * cell.global_batch       # decode: one token per sequence


def _probe_metrics(harness, cell, mesh, multi_pod) -> dict:
    """One trace of the cell's step (``lower_bundle``) and its per-device
    counters."""
    bundle = build_bundle(harness, cell, mesh, multi_pod=multi_pod, use_kernels=False)
    low = lower_bundle(bundle, mesh)
    coll = collective_stats(low["records"])
    return {
        "flops": float(low["flops"]),
        "hbm": float(low["hbm_bytes"]),
        "wire": float(coll.wire_bytes),
        "ops": coll.count,
        "by_kind": dict(coll.by_kind),
        "by_axis": dict(coll.by_axis),
        "operand_bytes_by_axis": low["operand_bytes_by_axis"],
        "c10d_ops": low["c10d_ops"],
        "memory": low["memory"],
    }


_PARTS = ("by_kind", "by_axis", "operand_bytes_by_axis")
KEYS = ("flops", "hbm", "wire")


def _combine(points: list[tuple[float, dict]]) -> dict:
    """``sum(c * metrics)`` over the points (coefficient, probe metrics), for
    the counters and each entry of the by-kind and by-axis tables."""
    out = {k: sum(c * f[k] for c, f in points) for k in KEYS}
    for part in _PARTS:
        names = set().union(*(f[part] for _, f in points))
        out[part] = {n: sum(c * f[part].get(n, 0.0) for c, f in points) for n in names}
    return out


def _probe_cell(cell, seq_len: int):
    return dataclasses.replace(cell, seq_len=seq_len)


def extrapolated_metrics(harness, cell, mesh, multi_pod) -> dict:
    """Per-device counters at the FULL (L, S) from probes at reduced depth
    (and, for the recurrent families, length), by family as the reference's
    ``extrapolated_metrics`` (``repro/launch/dryrun.py:123-188``):

    * dense, MoE, VLM, audio, and the SSM family's decode: ``f1 + (L -
      1)(f2 - f1)`` from 1 and 2 layers;
    * SSM (train, prefill): probes at L in {1, 2} and S in {S0, 2·S0} (S0 =
      min(256, S)); the per-layer cost and the rest each linear in S;
    * hybrid: ``F(L) = E + n_mamba(L)·M + n_shared(L)·A`` from L in {6, 7,
      8}; in decode at the cell's S, else solved at S in {256, 512, 1024}
      (those not above S) with E and M fitted linearly in S and A
      quadratically (``numpy.polyfit``), evaluated at S."""
    fam = harness.family

    def probe(L, S=None):
        return _probe_metrics(harness.clone(n_layers=L), cell if S is None else _probe_cell(cell, S), mesh,
                              multi_pod)

    L = harness.cfg.n_layers
    if fam in ("dense", "moe", "vlm", "audio") or (fam == "ssm" and cell.kind == "decode"):
        return _combine([(2 - L, probe(1)), (L - 1, probe(2))])      # f1 + (L - 1)(f2 - f1)

    if fam == "ssm":
        S = cell.seq_len
        S0 = min(256, S)
        at_s0 = _combine([(2 - L, probe(1, S0)), (L - 1, probe(2, S0))])
        at_2s0 = _combine([(2 - L, probe(1, 2 * S0)), (L - 1, probe(2, 2 * S0))])
        t = (S - S0) / S0                  # linear in S through S0 and 2·S0
        return _combine([(1 - t, at_s0), (t, at_2s0)])

    if fam == "hybrid":
        import numpy as np

        S = cell.seq_len
        n_shared = sum(1 for d in range(1, L) if d % harness.cfg.share_every == 0)

        def solve(S_=None) -> tuple[list, list, list]:
            """E = F6 - 6M, M = F8 - F7, A = F7 - F6 - M, each as a list of
            (coefficient, probe) of the probes at 6, 7 and 8 layers."""
            f6, f7, f8 = probe(6, S_), probe(7, S_), probe(8, S_)
            return [(1, f6), (6, f7), (-6, f8)], [(-1, f7), (1, f8)], [(-1, f6), (2, f7), (-1, f8)]

        weights = (1, L, n_shared)          # F = E + L·M + n_shared·A
        if cell.kind == "decode":
            return _combine([(w * c, f) for w, part in zip(weights, solve()) for c, f in part])
        Ss = [s for s in (256, 512, 1024) if s <= S] or [S]
        parts = {s: solve(s) for s in Ss}
        points: list[tuple[float, dict]] = []
        for j, (deg, w) in enumerate(zip((1, 1, 2), weights)):
            deg = min(deg, len(Ss) - 1)
            # the fit's value at S is linear in the samples: its weights are the
            # polyfit of the unit vectors, evaluated at S
            basis = [float(np.polyval(np.polyfit(np.array(Ss, dtype=float), np.eye(len(Ss))[i], deg), S))
                     for i in range(len(Ss))]
            for i, s in enumerate(Ss):
                points += [(w * basis[i] * c, f) for c, f in parts[s][j]]
        return _combine(points)

    raise ValueError(f"unknown family {fam}")


def run_cell(arch: str, shape: str, multi_pod: bool, probes: bool = True, *, peak_flops: float = PEAK_FLOPS,
             hbm_bw: float = HBM_BW, link_bw: float = LINK_BW) -> dict:
    harness = load(arch)
    cell = SHAPES[shape]
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "kind": cell.kind, "status": "ok", "path": "plain"}
    skip = harness.skip_reason(shape)
    if skip:
        rec.update(status="skipped", reason=skip)
        return rec

    dims, axes = production_shape(multi_pod)
    chips = 512 if multi_pod else 256
    with fake_mesh(dims, axes) as mesh:
        # ---- the full-depth step, traced once ----------------------------
        t0 = time.time()
        full = _probe_metrics(harness, cell, mesh, multi_pod)
        rec["lower_s"] = round(time.time() - t0, 1)
        mem = full["memory"]
        rec["memory"] = {
            "argument_bytes": mem["argument_bytes"],
            "output_bytes": mem["output_bytes"],
            "temp_bytes": mem["temp_bytes"],
            "alias_bytes": mem["alias_bytes"],
            "peak_per_device_gb": round(mem["peak_bytes"] / 1e9, 3),
        }
        # ---- cost counters: probe-extrapolated, as the reference's --------
        t1 = time.time()
        if probes:
            metrics = extrapolated_metrics(harness, cell, mesh, multi_pod)
            rec["extrapolation_exact"] = all(metrics[k] == full[k] for k in KEYS)
            rec["extrapolation_rel_err"] = {k: abs(metrics[k] - full[k]) / max(abs(full[k]), 1.0) for k in KEYS}
        else:
            metrics = full
            rec["counters"] = "full-depth eager trace (every layer counted)"
        rec["probe_s"] = round(time.time() - t1, 1)

    roof = Roofline(flops=metrics["flops"], hbm_bytes=metrics["hbm"], wire_bytes=metrics["wire"],
                    model_flops=analytic_model_flops(harness, cell) / chips,
                    peak_flops=peak_flops, hbm_bw=hbm_bw, link_bw=link_bw)
    rec["cost"] = {"flops_per_device": metrics["flops"], "hbm_bytes_per_device": metrics["hbm"]}
    rec["collectives"] = {
        "wire_bytes_per_device": metrics["wire"],
        "by_kind": metrics.get("by_kind", {}),
        "by_axis": metrics.get("by_axis", {}),
        "operand_bytes_by_axis": metrics.get("operand_bytes_by_axis", {}),
        "count": full["ops"],
        "c10d_ops": full["c10d_ops"],
    }
    rec["roofline"] = roof.to_dict()
    rec["params"] = param_count(harness.param_specs())
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--peak-flops", type=float, default=PEAK_FLOPS, help="FLOP/s of one device (H100 SXM5 bf16)")
    ap.add_argument("--hbm-bw", type=float, default=HBM_BW, help="memory B/s of one device (H100 SXM5 HBM3)")
    ap.add_argument("--link-bw", type=float, default=LINK_BW,
                    help="B/s one device sends on its links (H100 SXM5 NVLink 4, each way)")
    args = ap.parse_args()

    RESULTS.mkdir(parents=True, exist_ok=True)
    cells: list[tuple[str, str, bool]] = []
    if args.all:
        cells = [(a, s, m) for a in ARCH_IDS for s in SHAPES for m in (False, True)]
    else:
        arches = [args.arch] if args.arch else ARCH_IDS
        shapes = [args.shape] if args.shape else list(SHAPES)
        meshes = [args.multi_pod] if not args.both_meshes else [False, True]
        cells = [(a, s, m) for a in arches for s in shapes for m in meshes]

    failures = 0
    for arch, shape, mp in cells:
        mesh_name = "pod2x16x16" if mp else "pod16x16"
        out = RESULTS / f"{arch.replace('-', '_')}__{shape}__{mesh_name}.json"
        if out.exists() and not args.force:
            rec = json.loads(out.read_text())
            if rec.get("status") in ("ok", "skipped"):
                print(f"[dryrun] {arch:16s} {shape:12s} {mesh_name:10s} cached", flush=True)
                continue
        try:
            rec = run_cell(arch, shape, mp, probes=not args.no_probes, peak_flops=args.peak_flops,
                           hbm_bw=args.hbm_bw, link_bw=args.link_bw)
        except Exception as e:  # noqa: BLE001
            traceback.print_exc()
            rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "status": "error",
                   "error": f"{type(e).__name__}: {e}"}
            failures += 1
        out.write_text(json.dumps(rec, indent=2))
        status = rec["status"]
        extra = ""
        if status == "ok":
            extra = (f" mem={rec['memory']['peak_per_device_gb']}GB"
                     f" flops/dev={rec['cost']['flops_per_device']:.3e}"
                     f" wire/dev={rec['collectives']['wire_bytes_per_device']:.3e}B"
                     f" bottleneck={rec['roofline']['bottleneck']}"
                     f" lower={rec['lower_s']}s")
        elif status == "skipped":
            extra = f" ({rec['reason'][:60]})"
        print(f"[dryrun] {arch:16s} {shape:12s} {mesh_name:10s} {status}{extra}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
