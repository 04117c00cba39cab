"""Device resolution, counted host reads and the sync check.

Every entry point of the port takes ``device=None``, which means the card
(``"cuda"``).  There is no silent fallback: asking for the card on a
machine without one raises, and the CPU runs only when a caller names it.

Host reads.  :data:`host_reads` counts the device-to-host transfers the
port makes to read device values: each call of :func:`host_read` (one
scalar), :func:`host_read_all` (a 1-D tensor read together) or
:func:`host_copy` (a tensor copied out, as a result's archive) is one,
whatever the device (on the CPU the count still says how often the port
would read the card).  On the card the BFS levels read nothing: a run
reads its counts and flags once at the end and copies its archive out
(two reads), plus one read of the loop scalars a checkpoint chunk.  A
checkpoint's snapshot of the state is the checkpoint's own I/O and is not
counted; no other transfer is made.

The sync check.  :func:`sync_check` runs a block under
``torch.cuda.set_sync_debug_mode("error")``: any operation that waits on
the card raises, except the counted reads above, which step outside the
check for their one transfer.  So a block that passes it reads the card
only where it counts a read.
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, Union

import torch

__all__ = ["resolve_device", "same_device", "host_read", "host_read_all",
           "host_copy", "host_reads", "sync_check"]

DeviceLike = Union[str, torch.device, None]

#: Device-to-host transfers made by the port to read device values since
#: import (module docstring; a plain integer, which callers reset to 0
#: before the run they measure).
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


@contextlib.contextmanager
def sync_check():
    """Run the block under ``torch.cuda.set_sync_debug_mode("error")``
    (module docstring); the mode in force before is restored after."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


@contextlib.contextmanager
def _counted(x: torch.Tensor):
    """Count one read, and let its transfer wait on the card under
    :func:`sync_check`."""
    global host_reads
    with _reads_lock:
        host_reads += 1
    if x.device.type != "cuda" or torch.cuda.get_sync_debug_mode() == 0:
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def host_read(x: torch.Tensor) -> int:
    """One counted device-to-host read of a scalar (bool or int).  The
    count is bumped under a lock: the trace service reads from its drain
    thread."""
    with _counted(x):
        return int(x.item())


def host_read_all(x: torch.Tensor) -> List[int]:
    """One counted device-to-host read of a 1-D tensor of ints (counts and
    flags read together in one transfer)."""
    with _counted(x):
        return [int(v) for v in x.tolist()]


def host_copy(x: torch.Tensor) -> torch.Tensor:
    """One counted copy of ``x`` to the host (a result's archive)."""
    with _counted(x):
        return x.cpu()
