"""Elastic re-meshing: resume the same global state on a different device
count (the port of the JAX package's ``repro.runtime.elastic``).

Checkpoints are topology-independent (host arrays in the reference's
layout, :mod:`repro_torch.checkpoint`) and every placement is derived from
the mesh by :func:`~repro_torch.sharding.make_plan`, so scaling down (node
loss) or up is: build the new mesh, rebuild the plan, restore the
checkpoint onto the new placements, go on.  Only the ``data`` extent, and
so the per-device batch, moves.

The reference's mesh is a ``jax.sharding.Mesh`` over the devices of one
process; the port's is a :class:`~torch.distributed.device_mesh.DeviceMesh`
over the ranks of the process group, one process a device (DTensor's
model).  :func:`join_group` joins ``torchrun``'s group or starts a
one-rank one; :func:`world_size` says how many ranks there are before.

``choose_mesh_shape`` picks the largest usable (data, model) grid for a
surviving device count, keeping the model axis intact first (TP size is a
property of the model's memory footprint, DP is the elastic axis).
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["choose_mesh_shape", "build_mesh", "join_group", "world_size"]


def choose_mesh_shape(num_devices: int, model_axis: int,
                      pod_axis: Optional[int] = None) -> Tuple[int, ...]:
    """Largest (pod?, data, model) grid with <= num_devices devices.

    Keeps ``model_axis`` fixed (shrinking TP changes per-device memory);
    drops to the largest data extent that fits, then the pod axis.
    """
    if model_axis > num_devices:
        raise ValueError(
            f"cannot keep model axis {model_axis} with only "
            f"{num_devices} devices")
    if pod_axis:
        for pods in range(pod_axis, 0, -1):
            data = num_devices // (pods * model_axis)
            if data >= 1:
                return (pods, data, model_axis)
    data = num_devices // model_axis
    return (data, model_axis)


def build_mesh(shape: Sequence[int], devices: Optional[Sequence[int]] = None,
               *, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over the first ``prod(shape)`` of
    ``devices`` (ranks of the process group; default: all of them), its
    dims named ``("data", "model")`` or ``("pod", "data", "model")``.
    Every rank of the group calls it.  ``device_type`` is ``"cuda"`` (one
    card a rank) unless the caller asks for ``"cpu"``.  Raises when the
    group is not started or has fewer ranks than the shape needs."""
    from torch.distributed.device_mesh import DeviceMesh
    names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    if len(shape) not in (2, 3):
        raise ValueError(f"a mesh is (data, model) or (pod, data, model), "
                         f"got {tuple(shape)}")
    if not dist.is_initialized():
        raise RuntimeError("no process group: start one first (join_group, "
                           "or torch.distributed.init_process_group)")
    # the "fake" group (the dry run) places nothing, so it needs no card
    if device_type == "cuda" and not torch.cuda.is_available() \
            and dist.get_backend() != "fake":
        raise RuntimeError("no CUDA device is available; pass "
                           "device_type='cpu' for a CPU mesh")
    ranks = np.asarray(list(range(dist.get_world_size()))
                       if devices is None else list(devices))
    need = int(np.prod(shape))
    if ranks.size < need:
        raise ValueError(f"need {need} devices, have {ranks.size}")
    return DeviceMesh(device_type,
                      torch.as_tensor(ranks[:need].reshape(tuple(shape))),
                      mesh_dim_names=names)


def world_size() -> int:
    """The ranks this process runs among: the started group's size, else
    ``torchrun``'s ``WORLD_SIZE``, else 1."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


@contextlib.contextmanager
def join_group(device_type: str = "cuda"):
    """Run the block in a process group: the one already started, else
    ``torchrun``'s (from its ``RANK``/``WORLD_SIZE``/``MASTER_*``
    environment; on the card each rank takes card ``LOCAL_RANK``), else a
    one-rank group of this process.  NCCL on the card, gloo on the CPU.
    A group this call started is destroyed after the block.  Yields
    (rank, world size)."""
    if dist.is_initialized():
        yield dist.get_rank(), dist.get_world_size()
        return
    backend = "nccl" if device_type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if device_type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, init_method="env://")
    else:
        if device_type == "cuda":
            torch.cuda.set_device(torch.cuda.current_device())
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    try:
        yield dist.get_rank(), dist.get_world_size()
    finally:
        dist.destroy_process_group()
