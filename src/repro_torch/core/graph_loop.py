"""The BFS level loop with no host read: one CUDA graph on the card.

The reference runs a whole BFS as one ``lax.while_loop`` whose predicate
``step < bound && total_new > 0`` lives on the device
(``repro.core.engine._explore_loop``, ``repro.core.distributed.
_dense_loop`` and the sharded loop).  :class:`FusedLoop` is the port's
counterpart.  A level is a function that updates a state's tensors in
place (``step`` and ``total_new`` are device int32 scalars), and

* on the card, the first :meth:`FusedLoop.run` that has a level to run
  runs that level eagerly on a side stream, as the capture's warm-up (the
  kernels' libraries load, the cached constants are made), then captures
  the next level there with ``torch.cuda.CUDAGraph(keep_graph=True)``
  into the memory pool the first level allocated from, and builds around
  it a graph with a conditional WHILE node (``csrc/graph_loop.cu``): a
  one-thread kernel sets the condition from the predicate before the loop
  and after every level.  No level runs twice and no copy of the state is
  made.  A run is one graph launch with ``bound`` written on the device;
  the host reads nothing until it asks for the result, and a drained tree
  stops on the device where the reference's stops;
* on the CPU, the same level function runs in a Python loop that tests
  the predicate between levels (a CPU tensor: no transfer, no counted
  read);
* over a mesh of several cards (not one graph) the same level runs from
  the host, with one counted read of the predicate a level
  (:func:`~.device.host_read`), until the ``torch.distributed`` transport
  carries the loop.

There is no fallback: a level that cannot be captured or a graph that
cannot be built raises :class:`GraphLoopError`, which is not a backend
failure (:func:`~.failover.is_backend_failure`), so no entry point
degrades from it or replaces the graph by the host loop.

The kernels count their own launches on the card
(:mod:`repro_torch.kernels.launch_counts`), so a replayed level counts
like an eager one and this module keeps no count.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Callable, List

import torch

from ..kernels.real import require_real
from .device import host_read

__all__ = ["FusedLoop", "GraphLoopError", "SOURCE", "load_library",
           "tree_tensors"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "graph_loop.cu"

_STAGES = {1: "cudaGraphCreate", 2: "cudaGraphConditionalHandleCreate",
           3: "cudaGraphAddKernelNode (the first condition)",
           4: "cudaGraphAddNode (the conditional WHILE node)",
           5: "cudaGraphAddChildGraphNode (the captured level)",
           6: "cudaGraphAddKernelNode (the body's condition)",
           7: "cudaGraphInstantiate"}


class GraphLoopError(Exception):
    """The level could not be captured, or its loop graph built or
    launched.  Not a ``RuntimeError``: no entry point degrades from it."""


def load_library():
    """Build (at first use) and load the loop helper's shared library."""
    from ..kernels.snp_step._build import load_library as load
    lib = load(SOURCE)
    vp = ctypes.c_void_p
    lib.graph_loop_build.argtypes = [vp] * 4 + [ctypes.POINTER(vp)] * 2
    lib.graph_loop_build.restype = ctypes.c_int
    lib.graph_loop_launch.argtypes = [vp, vp]
    lib.graph_loop_launch.restype = ctypes.c_int
    lib.graph_loop_destroy.argtypes = [vp, vp]
    lib.graph_loop_destroy.restype = ctypes.c_int
    return lib


def tree_tensors(tree) -> List[torch.Tensor]:
    """The tensors of a state (nested tuples and NamedTuples), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [t for x in tree for t in tree_tensors(x)]
    return []


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------


class FusedLoop:
    """Run ``level(state)`` (in place) while ``state.step < bound`` and
    ``state.total_new > 0`` (module docstring).  ``devices`` are the
    devices the level touches: all the CPU, one card (the graph), or
    several cards (the host loop with one counted read a level)."""

    def __init__(self, level: Callable[[object], None], state,
                 devices) -> None:
        self.level = level
        self.state = state
        kinds = {torch.device(d).type for d in devices}
        cards = {(torch.device(d).type, torch.device(d).index
                  if torch.device(d).index is not None
                  else torch.cuda.current_device())
                 for d in devices if torch.device(d).type == "cuda"}
        if kinds == {"cpu"}:
            self.mode = "cpu"
        elif kinds == {"cuda"} and len(cards) == 1:
            self.mode = "graph"
        else:
            self.mode = "mesh"
        self.dev = state.step.device
        self._exec = self._graph = None
        self._captured = self._pool = None

    # -- the three routes -------------------------------------------------

    def run(self, bound: int, step: int, go: bool) -> None:
        """Levels until the absolute step ``bound`` or the drain.  ``step``
        and ``go`` are the state's step and ``total_new > 0`` as the host
        knows them without a read (0 and True at the start of a run, a
        resumed snapshot's, the last chunk's readout): they say whether
        the first call on the card has a level to run, which it runs
        eagerly before the capture."""
        s = self.state
        if self.mode == "cpu":
            while bool((s.step < bound) & (s.total_new > 0)):
                self.level(s)
        elif self.mode == "mesh":
            while host_read((s.step < bound) & (s.total_new > 0)):
                self.level(s)
        else:
            # the graph's WHILE node reads and writes these on the card
            require_real("graph_loop_launch", s.step, s.total_new)
            if self._exec is None:
                if not (step < bound and go):
                    return
                self._build()
            self._bound.fill_(bound)
            rc = self._lib.graph_loop_launch(
                self._exec, torch.cuda.current_stream(self.dev).cuda_stream)
            if rc != 0:
                raise GraphLoopError(f"cudaGraphLaunch failed: CUDA error "
                                     f"{rc}")

    def close(self) -> None:
        """Free the executable, its graph and the capture's pool."""
        if self._exec is not None or self._graph is not None:
            self._lib.graph_loop_destroy(self._exec, self._graph)
        self._exec = self._graph = None
        if self._captured is not None:
            self._captured.reset()
            self._captured = self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- capture ----------------------------------------------------------

    def _build(self) -> None:
        """Run one level eagerly, capture the next, build the loop."""
        self._lib = load_library()
        dev = self.dev
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        # the eager level and the capture share one pool: the capture
        # reuses the blocks the eager level freed (a capture cannot release
        # cached memory, so a pool of its own would need the level's peak
        # again)
        pool = torch.cuda.MemPool()
        with torch.cuda.stream(side):
            with torch.cuda.use_mem_pool(pool, dev):
                self.level(self.state)
            g = torch.cuda.CUDAGraph(keep_graph=True)
            g.capture_begin(pool=pool.id)
            try:
                self.level(self.state)
            except Exception as e:
                try:
                    g.capture_end()
                except Exception:       # the capture is already invalid
                    pass
                raise GraphLoopError(
                    f"the BFS level could not be captured into a CUDA "
                    f"graph: {e}") from e
            g.capture_end()
        cur.wait_stream(side)
        self._captured, self._pool = g, pool
        self._bound = torch.zeros((), dtype=torch.int32, device=dev)
        exe, graph = ctypes.c_void_p(), ctypes.c_void_p()
        rc = self._lib.graph_loop_build(
            g.raw_cuda_graph(), self.state.step.data_ptr(),
            self._bound.data_ptr(), self.state.total_new.data_ptr(),
            ctypes.byref(exe), ctypes.byref(graph))
        if rc != 0:
            stage, err = divmod(rc, 1000)
            raise GraphLoopError(
                f"building the level loop's graph failed at "
                f"{_STAGES.get(stage, stage)}: CUDA error {err}")
        self._exec, self._graph = exe, graph
