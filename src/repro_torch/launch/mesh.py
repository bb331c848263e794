"""Meshes — port of ``repro/launch/mesh.py`` (``make_production_mesh``,
``make_smoke_mesh``) and of the ``jax.make_mesh`` they call (``make_mesh``).

Each builds a ``DeviceMesh`` through ``init_device_mesh``, with the
reference's axis names and shapes.  They are functions, so that importing
this module touches no device and no process group.  The caller first
initialises the default process group of ``prod(shape)`` ranks
(``torch.distributed.init_process_group`` with its address, world size and
rank: nothing on the machine announces a cluster); global rank r sits at the
row-major coordinate of r in ``shape``.  The device type is ``"cuda"``
unless the caller asks for ``"cpu"``.  Axes map onto the UB-Mesh hierarchy:
"model" = intra-rack 2D-FullMesh (high-bandwidth TP/SP domain), "data" =
inter-rack 2D-FullMesh, "pod" = HRS Clos tier.
"""

from __future__ import annotations


def make_mesh(shape: tuple[int, ...], axis_names: tuple[str, ...], *, device_type: str = "cuda"):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_smoke_mesh(data: int = 1, model: int = 1, *, device_type: str = "cuda"):
    """Tiny mesh for tests (needs ``data * model`` ranks)."""
    return make_mesh((data, model), ("data", "model"), device_type=device_type)
