"""Device resolution and counted host reads.

Every entry point of the port takes ``device=None``, which means the card
(``"cuda"``).  There is no silent fallback: asking for the card on a
machine without one raises, and the CPU runs only when a caller names it.

The BFS and the hash-table probe loops run from the host, so they read a
few device scalars per level.  Each such read goes through
:func:`host_read`, which counts it in :data:`host_reads` so a run can
report its host reads per wave.
"""

from __future__ import annotations

import threading
from typing import List, Union

import torch

__all__ = ["resolve_device", "same_device", "host_read", "host_read_all",
           "host_reads"]

DeviceLike = Union[str, torch.device, None]

#: Host reads of device values made by the port since import (a plain
#: integer; callers reset it to 0 before the run they measure).
host_reads = 0
_reads_lock = threading.Lock()


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raise when the card is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain versions on the CPU")
    return dev


def same_device(a: DeviceLike, b: DeviceLike) -> bool:
    """Whether two devices name the same one after :func:`resolve_device`
    (``"cuda"`` is the current card, ``cuda:<i>`` with its index)."""
    def norm(d):
        d = resolve_device(d)
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d
    return norm(a) == norm(b)


def host_read(x: torch.Tensor) -> int:
    """One counted device-to-host read of a scalar (bool or int).  The
    count is bumped under a lock: the trace service reads from its drain
    thread."""
    global host_reads
    with _reads_lock:
        host_reads += 1
    return int(x.item())


def host_read_all(x: torch.Tensor) -> List[int]:
    """One counted device-to-host read of a 1-D tensor of ints (a count
    per rank, read together in one transfer)."""
    global host_reads
    with _reads_lock:
        host_reads += 1
    return [int(v) for v in x.tolist()]
