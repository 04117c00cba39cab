"""Placement helpers of the meshed model and steps: DTensor's
counterparts of what GSPMD does unasked where an operation needs a
tensor whole, or mixes in a value that is not on the mesh.  Each leaves a
plain tensor as it is, so the unmeshed path runs the same code."""

from __future__ import annotations

import contextlib
import math

import torch

__all__ = ["meshed", "replicated", "unsharded", "on_mesh", "reshape",
           "matmul", "shard_offset"]


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


def _uneven(x, shape) -> list:
    """The mesh dims of DTensor ``x`` whose shard DTensor cannot carry
    through ``x.reshape(shape)``: a sharded dim split into several whose
    first is not a multiple of the ranks sharding it (15 heads over 16
    ranks; 16 sequences of tokens sharded over 2 x 16), merged into the
    dim before it, or merged with the dims after it while its ranks do
    not divide it (5 LoRA blocks over 2)."""
    from torch.distributed.tensor import Shard
    src, dst = tuple(x.shape), tuple(shape)
    bad_dims = set()

    def parts(d):                   # the ranks that shard dim d, together
        n = 1
        for m, p in enumerate(x.placements):
            if isinstance(p, Shard) and p.dim == d:
                n *= x.device_mesh.size(m)
        return n

    i = j = 0
    while i < len(src) and j < len(dst):
        if src[i] == dst[j]:
            i, j = i + 1, j + 1
        elif src[i] == 1:
            i += 1
        elif dst[j] == 1:
            j += 1
        elif src[i] > dst[j]:             # src[i] splits into dst[j:k]
            first, prod = dst[j], 1
            while j < len(dst) and prod < src[i]:
                prod, j = prod * dst[j], j + 1
            if prod != src[i] or first % parts(i):
                bad_dims.add(i)
            i += 1
        else:                             # src[i:k] merge into dst[j]
            prod, start = 1, i
            while i < len(src) and prod < dst[j]:
                prod, i = prod * src[i], i + 1
            bad_dims.update(range(start + 1, i))
            if src[start] % parts(start):
                bad_dims.add(start)
            j += 1
    return [m for m, p in enumerate(x.placements)
            if isinstance(p, Shard) and p.dim in bad_dims]


def _even(x, shape):
    from torch.distributed.tensor import Replicate
    bad = _uneven(x, shape)
    if not bad:
        return x
    want = [Replicate() if m in bad else p
            for m, p in enumerate(x.placements)]
    return x.redistribute(x.device_mesh, want)


class _Reshape(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shape):
        ctx.shape = tuple(x.shape)
        return _even(x, shape).reshape(shape)

    @staticmethod
    def backward(ctx, g):
        return _even(g, ctx.shape).reshape(ctx.shape), None


def reshape(x: torch.Tensor, shape) -> torch.Tensor:
    """``x.reshape(shape)``; on a DTensor, a dim whose shard the reshape
    cannot carry (:func:`_uneven`) is gathered whole first, in the
    forward and in the gradient's reshape back (GSPMD re-shards such a
    reshape itself; DTensor raises).  A plain tensor is reshaped as it
    is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x.reshape(shape)
    shape = list(shape)
    if -1 in shape:                 # the inferred dim, as reshape infers it
        known = math.prod(d for d in shape if d != -1)
        shape[shape.index(-1)] = x.numel() // max(known, 1)
    return _Reshape.apply(x, tuple(shape))


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for activations ``x`` (..., d) and a 2-D weight.  On a
    DTensor whose rows are sharded on a dim after the first, the rows are
    flattened by :func:`reshape` first (and the result's rows split back
    by it): torch 2.11's DTensor refuses to flatten such rows (its 2.13
    makes a strided shard), so that dim is gathered.  The same ``mm`` on
    the same rows either way."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(x, DTensor) or not any(
            isinstance(p, Shard) and 0 < p.dim < x.dim() - 1
            for p in x.placements):
        return x @ w
    lead = tuple(x.shape[:-1])
    y = reshape(x, (-1, x.shape[-1])) @ w
    return reshape(y, lead + (y.shape[-1],))


def shard_offset(shape, mesh, placements, dim: int) -> int:
    """Where this rank's shard of tensor dim ``dim`` starts in the global
    tensor of ``shape`` placed by ``placements`` on ``mesh``: each mesh
    dim that shards ``dim`` cuts what the ones before it left in chunks
    of ``ceil(size / n)`` (DTensor's uneven ``Shard``), in mesh-dim
    order.  Plain integers (DTensor's own helper builds the offsets as a
    tensor, which has no value on the dry run's fake tensors)."""
    from torch.distributed.tensor import Shard
    size, off = shape[dim], 0
    for i, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim:
            chunk = -(-size // mesh.size(i))
            start = min(mesh.get_local_rank(i) * chunk, size)
            off += start
            size = min(chunk, size - start)
    return off
