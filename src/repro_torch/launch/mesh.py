"""Production mesh construction (the port of the JAX package's
``repro.launch.mesh``).

A function, not a module-level constant, so importing never touches a
device or a process group.  Shapes per the brief: single pod = (16, 16)
(data, model) = 256 devices; multi-pod = (2, 16, 16) (pod, data, model)
= 512 devices, one rank of the process group a device
(:func:`repro_torch.runtime.build_mesh`).
"""

from __future__ import annotations

__all__ = ["make_production_mesh"]


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    from ..runtime import build_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    return build_mesh(shape, device_type=device_type)
