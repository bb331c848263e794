"""UB-Mesh core: the paper's contributions as composable modules — the port's
own copy of ``repro/core/__init__.py`` for the modules ported so far.

* topology    — nD-FullMesh graph + baselines (C1, C2)
* ub          — Unified Bus lane budgeting (C2)
* apr         — All-Path Routing: SR header, linear tables, TFC, direct
                notification (C3, C4)
* multiring   — Multi-Ring AllReduce planner (C5)
* alltoall    — Multi-Path / hierarchical All2All analysis (C5)
* cost_model  — topology-aware communication cost model (C6)
* traffic     — per-technique traffic accounting (Table 1)
* capex       — CapEx/OpEx/cost-efficiency (Fig. 21)
* availability— MTBF/availability + 64+1 backup analysis (Table 6)

The reference's package also imports ``perf_model``, ``planner`` and
``simulator``; their copies are still to come (ROADMAP A12c).
"""

from . import (  # noqa: F401
    alltoall,
    apr,
    availability,
    capex,
    cost_model,
    multiring,
    topology,
    traffic,
    ub,
)
