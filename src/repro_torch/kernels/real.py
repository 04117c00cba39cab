"""The guard of every ctypes launch: a kernel reads and writes device
memory through the pointers it is handed, and a fake tensor
(``FakeTensorMode``, the dry run) or a meta tensor has none.  Each
wrapper calls :func:`require_real` on its tensors before it launches;
a fake or meta tensor is refused with a clear error, never run through
the plain version instead."""

from __future__ import annotations

import torch

__all__ = ["require_real", "is_fake"]


def is_fake(t) -> bool:
    """Whether ``t`` is a tensor without device memory: a fake tensor or
    a meta tensor."""
    from torch._subclasses.fake_tensor import is_fake as _is_fake
    return isinstance(t, torch.Tensor) and (t.is_meta or _is_fake(t))


def require_real(kernel: str, *tensors) -> None:
    """Raise if any of ``tensors`` (``None`` entries skipped) is fake or
    meta: ``kernel`` would be launched on pointers to no memory."""
    for i, t in enumerate(tensors):
        if t is not None and is_fake(t):
            kind = "meta" if t.is_meta else "fake"
            raise RuntimeError(
                f"{kernel}: argument {i} is a {kind} tensor "
                f"({tuple(t.shape)}, {t.dtype}, {t.device}); a kernel "
                f"launch needs tensors with device memory")
