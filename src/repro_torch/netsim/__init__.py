"""The port's own copy of ``repro/netsim/__init__.py``, held to the original by
``tests/test_torch_netsim.py``; only its imports of the package, and the
package's name where its docstring gives it, differ.

repro_torch.netsim — flow-level discrete-event simulator of the UB-Mesh fabric.

Where the analytic engine (``core/simulator.py``) prices collectives with
closed-form alpha-beta costs per axis, netsim *executes* them: flows are
mapped onto the concrete ``NDFullMesh`` links, share bandwidth max-min
fairly, contend, detour, borrow switch capacity, and survive link failures
— the phenomena §4 (All-Path Routing) and §5 (Multi-Ring) exist to handle.

Module map (paper section -> module):

* ``events``      — deterministic heapq event engine, virtual time
                    (simulation substrate; no paper section)
* ``flows``       — max-min fair-share fluid flows on the §3.1 nD-FullMesh
                    links, per-dim ``gbs_per_peer`` capacities (Table 3),
                    plus receiver-egress (incast) caps that serialize
                    many-to-one bursts instead of resolving them instantly,
                    per-dim IO caps for switched tiers, and aggregate flows
                    carrying N symmetric ring-step members at once
* ``messages``    — message-level store-and-forward latency mode
                    (``NetSim(message_level=True)``): per-hop
                    serialization, propagation and FIFO queueing under the
                    same collective DAG compiler — the decode-serving
                    regime where small-message latency, not bandwidth,
                    dominates; feeds ``NetSim.measure_latency_profile``
* ``solver``      — the max-min rate allocators: vectorized numpy
                    water-filling over an incremental group CSR (default)
                    and the pure-Python reference oracle
* ``coarsen``     — rack/pod-coarsened SuperPod meshes (§3.3.4): racks
                    become super-nodes with trunk-aggregated capacities and
                    an IO-capped HRS dimension, so 4096-8192-chip multi-pod
                    scenarios stay tractable; ``detail_racks`` embeds
                    chip-level racks inside the coarse mesh (MixedMesh) so
                    model-axis collectives can be calibrated against
                    cross-pod background traffic
* ``routing``     — APR adapter (§4.1): shortest / detour / borrow path
                    sets from ``core/apr.py`` as per-flow multi-path
                    splits; direct-notification fast recovery (§4.2)
* ``collectives`` — Multi-Ring AllReduce (§5.1, Fig. 13) and Multi-Path
                    All2All (Fig. 14) schedules compiled into flow DAGs;
                    Table-1 traffic entries mapped onto node groups
* ``api``         — ``NetSim.run(workload, parallel_spec)`` facade,
                    ``NetSimResult``, and the per-(axis, collective-shape)
                    ``calibrated_profile`` behind
                    ``core.perf_model.NetsimPerfModel`` (§6 evaluation loop)
* ``scenarios``   — canonical traffic patterns (cross-rack hotspot,
                    inter-rack mesh, trunk congestion) shared by
                    benchmarks, examples and tests
* ``telemetry``   — opt-in recorder threaded through engine, solvers
                    and router: per-link utilization timelines,
                    solver-level bottleneck attribution, flow lifecycle
                    traces, router counters; exports a structured
                    summary dict and Perfetto trace JSON
                    (observability layer; no paper section)

Quick start::

    from repro_torch.core.cost_model import Routing
    from repro_torch.core.topology import ub_mesh_rack
    from repro_torch.netsim import NetSim

    sim = NetSim(ub_mesh_rack(), routing=Routing.DETOUR)
    t = sim.allreduce_time(dim=0, size_bytes=64e6)   # one X clique
"""

from .api import NetSim, NetSimResult                      # noqa: F401
from .coarsen import (                                     # noqa: F401
    CoarseMesh,
    MixedMesh,
    coarse_calibrated_profile,
    coarse_netsim,
    coarsen_superpod,
    cross_pod_background_dag,
    mixed_calibrated_profile,
    mixed_netsim,
)
from .collectives import (                                 # noqa: F401
    FlowDAG,
    FlowTask,
    all_to_all,
    clique_nodes,
    compile_workload,
    grid_all_gather,
    grid_allreduce,
    grid_plane_nodes,
    hierarchical_all_gather,
    hierarchical_allreduce,
    model_group,
    moe_dispatch,
    multipath_all_to_all,
    remap_dag,
    ring_all_gather,
    ring_allreduce,
    ring_reduce_scatter,
    splice_dag,
)
from .events import EventEngine                            # noqa: F401
from .flows import FluidNetwork, default_rx_gbs            # noqa: F401
from .messages import (                                    # noqa: F401
    Message,
    MessageDagRun,
    MessageNetwork,
)
from .routing import Router, Transfer                      # noqa: F401
from .scenarios import (                                   # noqa: F401
    TrunkCongestion,
    hotspot_dag,
    inter_rack_mesh,
    trunk_congestion,
)
from .telemetry import FlowTrace, Telemetry                # noqa: F401
