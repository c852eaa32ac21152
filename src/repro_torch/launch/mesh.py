"""Production mesh builders — port of ``repro.launch.mesh`` on
``torch.distributed``.

FUNCTIONS, not module constants, so importing this module touches no
process group.  Each builds a ``DeviceMesh`` over every rank of the
initialised default group, on the device type of its backend (``cuda``
for NCCL, ranks on cards; ``cpu`` for gloo), with the reference's shapes
and axis names:

  single-pod: (16, 16)    axes (data, model)
  multi-pod:  (2, 16, 16) axes (pod, data, model)   # 512 ranks

The ``pod`` axis doubles as the DR-FL *client* axis in the federated
multi-pod mapping (``launch/steps.py::build_fl_train_step``).  A world
size other than the mesh's raises ``ValueError``, as the reference cannot
build these meshes on fewer devices either.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _mesh(name: str, shape, axes) -> DeviceMesh:
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    need = math.prod(shape)
    if world != need:
        raise ValueError(f"the {name} mesh {shape} {axes} needs {need} "
                         f"ranks; the default group has {world}")
    dev_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(dev_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh("multi-pod production" if multi_pod else
                 "single-pod production", shape, axes)


def make_debug_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """Tiny mesh for tests (8 or 4 ranks)."""
    shape = (2, 2, 2) if multi_pod else (2, 2)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh("multi-pod debug" if multi_pod else "debug", shape, axes)
