"""Placement helpers of the meshed model and steps: DTensor's
counterparts of what GSPMD does unasked where an operation needs a
tensor whole, or mixes in a value that is not on the mesh.  Each leaves a
plain tensor as it is, so the unmeshed path runs the same code."""

from __future__ import annotations

import contextlib

import torch

__all__ = ["meshed", "replicated", "unsharded", "on_mesh"]


@contextlib.contextmanager
def meshed(x: torch.Tensor):
    """Run the block with the plain tensors it makes (RoPE's frequencies,
    masks, zero statistics, cache lengths) taken as replicated values
    where they meet DTensors, when ``x`` (a parameter) is one:
    DTensor's ``implicit_replication``, restored to its earlier setting
    after (so blocks nest; the setting is the dispatcher's, so autograd's
    device threads see it too).  Without DTensors it does nothing."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        yield
        return
    dispatcher = DTensor._op_dispatcher
    prev = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = prev


def replicated(x: torch.Tensor) -> torch.Tensor:
    """``x`` whole and equal on every rank: a DTensor (a partial sum, say
    a loss) redistributed to ``Replicate()`` on every mesh dim, so that
    reading it reads the global value; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return x
    want = [Replicate()] * x.device_mesh.ndim
    return x if list(x.placements) == want else \
        x.redistribute(x.device_mesh, want)


def unsharded(x: torch.Tensor, *dims: int) -> torch.Tensor:
    """``x`` with tensor dims ``dims`` whole on every rank: a DTensor
    sharded on one of them is redistributed (an all-gather, as GSPMD
    inserts one where an op needs the whole dim), its other placements
    kept; a plain tensor comes back as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    dims = {d % x.ndim for d in dims}
    want = [Replicate() if isinstance(p, Shard) and p.dim in dims else p
            for p in x.placements]
    if want == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def on_mesh(x: torch.Tensor, mesh, placements):
    """``x`` on ``mesh`` with ``placements``: a DTensor redistributed, a
    plain tensor (a value every rank holds whole) taken as replicated
    first."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return x.redistribute(mesh, placements)
