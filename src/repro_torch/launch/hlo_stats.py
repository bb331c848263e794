"""Collective traffic and roofline terms — port of
``repro/launch/hlo_stats.py`` (``CollectiveStats``, ``collective_stats``,
``Roofline``).

The reference parses the compiled HLO text for every all-gather /
all-reduce / reduce-scatter / all-to-all / collective-permute.  The port
compiles nothing: its collectives are the ones its transports issue
(``parallel/collectives.Transport``), each recorded as ``(kind, result
bytes, group size, axes)``, and ``collective_stats`` reads those records.
What carries over is the accounting, per-device WIRE bytes under the
reference's ring conventions:

    all-reduce      2 (n-1)/n * bytes(result)
    all-gather        (n-1)/n * bytes(result)
    reduce-scatter    (n-1)/n * bytes(operand) = (n-1) * bytes(result)
    all-to-all        (n-1)/n * bytes(result)
    collective-permute            bytes(result)

``by_axis`` adds each collective's wire bytes under every mesh axis its
group spans (the reference's HLO names groups, not axes).

``Roofline`` takes the device's peaks as fields, where the reference bakes
in a TPU's: the dry-run (``launch/dryrun.py``) passes an H100 SXM5's by
default (``--peak-flops``, ``--hbm-bw``, ``--link-bw``).
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class CollectiveStats:
    wire_bytes: float = 0.0                       # per-device, ring conv.
    by_kind: dict = field(default_factory=lambda: defaultdict(float))
    by_axis: dict = field(default_factory=lambda: defaultdict(float))
    count: int = 0
    ops: list = field(default_factory=list)

    def add(self, kind: str, bytes_: float, n: int, axes: tuple = ()):
        if kind == "all-reduce":
            wire = 2.0 * (n - 1) / max(n, 1) * bytes_
        elif kind in ("all-gather", "all-to-all"):
            wire = (n - 1) / max(n, 1) * bytes_
        elif kind == "reduce-scatter":
            wire = (n - 1) * bytes_          # bytes_ is the (scattered) result
        else:  # collective-permute
            wire = bytes_
        self.wire_bytes += wire
        self.by_kind[kind] += wire
        for a in axes:
            self.by_axis[a] += wire
        self.count += 1


def collective_stats(records) -> CollectiveStats:
    """Wire bytes of ``records`` (``(kind, result bytes, group size, axes)``
    each, as ``Transport`` records them)."""
    stats = CollectiveStats()
    for kind, bytes_, n, axes in records:
        stats.add(kind, float(bytes_), n, tuple(axes))
        stats.ops.append((kind, bytes_, n))
    return stats


@dataclass
class Roofline:
    flops: float                 # per-device flops
    hbm_bytes: float             # per-device bytes accessed
    wire_bytes: float            # per-device collective wire bytes
    model_flops: float = 0.0     # analytic 6*N*D (or 6*N_active*D)
    peak_flops: float = 989e12   # FLOP/s of the device
    hbm_bw: float = 3.35e12      # B/s of its memory
    link_bw: float = 450e9       # B/s a device puts on its links

    @property
    def compute_s(self) -> float:
        return self.flops / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / self.hbm_bw

    @property
    def collective_s(self) -> float:
        return self.wire_bytes / self.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    def to_dict(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "wire_bytes": self.wire_bytes,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "peaks": {"flops": self.peak_flops, "hbm_bw": self.hbm_bw, "link_bw": self.link_bw},
        }
