"""Production mesh construction (port of ``repro/launch/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the default
process group, which the caller initialises first with as many ranks as
the mesh has: a ``fake`` group for the dry run (:mod:`repro_torch.launch.
dryrun`, one process standing in for every rank), ``gloo`` in the CPU
tests, NCCL on the card.  Nothing here initialises a process group; the
meshes are built by functions, never at import.
"""
from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The reference's logical production mesh: 16 x 16 = 256 GPUs over
    ("data", "model"); multi-pod, 2 x 16 x 16 = 512 over ("pod", "data",
    "model").  Under the dry run's ``fake`` group a "cuda" mesh needs no
    card, and DTensor plans its collectives as for NCCL."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh("cuda", shape, mesh_dim_names=axes)


def make_host_mesh(*, model: int = 1, data: int = 1,
                   device_type: str = "cuda") -> DeviceMesh:
    """A small ("data", "model") mesh: 1 x 1 on the card; the CPU tests
    pass ``device_type="cpu"`` (gloo) for 2 x 4."""
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))


def batch_axes(mesh) -> tuple:
    """Axes over which the global batch is sharded."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def axis_size(mesh, name: str) -> int:
    return dict(zip(mesh.mesh_dim_names, mesh.shape)).get(name, 1)
