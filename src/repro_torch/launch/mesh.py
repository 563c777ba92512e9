"""Production mesh definition, as DeviceMeshes.

Defined as FUNCTIONS (not module-level constants) so importing this
module never touches process-group state.  A mesh needs a default
process group of its size: a real one on the card (``nccl``), or
``torch.distributed``'s ``"fake"`` backend for the dry run and tests
(``launch/dryrun.py`` opens one of 256 or 512 ranks).
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["make_production_mesh", "make_mesh_for", "make_mesh", "mesh_device_type"]


def mesh_device_type() -> str:
    """The device type a mesh is built on: ``cuda`` under NCCL, else
    ``cpu`` (gloo and the fake backend)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """(16, 16) single-pod mesh over ('data', 'model'); with
    ``multi_pod=True`` the 2-pod (2, 16, 16) mesh over
    ('pod', 'data', 'model')."""
    return make_mesh((2, 16, 16) if multi_pod else (16, 16))


def make_mesh_for(num_devices: int, model_parallel: int = 1) -> DeviceMesh:
    """Small helper for tests/examples on however many ranks exist."""
    return make_mesh((num_devices // model_parallel, model_parallel))


def make_mesh(shape) -> DeviceMesh:
    """A mesh of ``shape`` over the last ``len(shape)`` of ('pod', 'data',
    'model')."""
    names = ("pod", "data", "model")[-len(shape):]
    return init_device_mesh(mesh_device_type(), tuple(shape), mesh_dim_names=names)
