"""Fault-tolerant training supervisor: checkpoint/restart and failure
injection (the port of the JAX package's
``repro.runtime.fault_tolerance``).

The recovery contract is the reference's:

1. the train loop runs under a supervisor that snapshots the state every
   ``ckpt_every`` steps through :class:`~repro_torch.checkpoint.
   AsyncCheckpointer` (the copy to the host is made at once, the write on
   a background thread, so the loop does not wait on the disk),
2. on a failure (a ``RuntimeError``, which a CUDA error is too, or one
   injected by :class:`FailureInjector`) it waits for the writer,
   restores the latest complete checkpoint (an atomic rename makes every
   listed checkpoint complete), rebuilds the step function and replays
   the data stream from the checkpointed step (the pipeline is a pure
   function of the step: no data lost or consumed twice),
3. past ``max_restarts`` failures it gives up.

The port's train state holds its parameters in an ``nn.Module``, so the
supervisor saves ``snapshot(state)`` (default: the state itself): the
train launcher passes :func:`repro_torch.train.train_state_tree`, the
reference's layout.  On a mesh every rank runs a supervisor: each takes
the snapshot (gathering a sharded state is a collective), only the
writer (``write=True``, rank 0) saves it, and ``barrier`` (called once
the writer's saves are on disk, before any rank reads the directory)
keeps the ranks' restores on the same checkpoint.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

from ..checkpoint import AsyncCheckpointer, latest_step

__all__ = ["FailureInjector", "Supervisor", "SupervisorConfig"]


class FailureInjector:
    """Deterministic failure schedule for tests: raises ``RuntimeError`` the
    first time each listed step is reached."""

    def __init__(self, fail_at_steps=()):
        self.remaining = set(fail_at_steps)

    def check(self, step: int):
        if step in self.remaining:
            self.remaining.discard(step)
            raise RuntimeError(f"injected node failure at step {step}")


@dataclasses.dataclass
class SupervisorConfig:
    ckpt_dir: str
    ckpt_every: int = 10
    max_restarts: int = 3
    keep: int = 3


class Supervisor:
    """Runs ``num_steps`` of training with checkpoint/restart semantics.

    ``make_step``: restore step or None -> (state, step_fn, start_step),
    called at the start and after every failure.  ``data_for``: step ->
    batch (pure).  ``snapshot``: state -> the tree a checkpoint holds.
    ``write``: whether this process saves checkpoints; ``barrier``: the
    ranks' meeting point after the saves are on disk (module docstring).
    """

    def __init__(self, cfg: SupervisorConfig,
                 make_step: Callable[[Optional[int]],
                                     Tuple[Any, Callable, int]],
                 data_for: Callable[[int], Any],
                 injector: Optional[FailureInjector] = None,
                 snapshot: Callable[[Any], Any] = lambda state: state,
                 write: bool = True,
                 barrier: Callable[[], None] = lambda: None):
        self.cfg = cfg
        self.make_step = make_step
        self.data_for = data_for
        self.injector = injector
        self.snapshot = snapshot
        self.write = write
        self.barrier = barrier
        self.ckpt = AsyncCheckpointer(cfg.ckpt_dir, keep=cfg.keep)
        self.restarts = 0
        self.step_times: list[float] = []

    def run(self, num_steps: int) -> Tuple[Any, Dict]:
        state, step_fn, start = self.make_step(None)
        step = start
        metrics: Dict = {}
        while step < num_steps:
            try:
                while step < num_steps:
                    if self.injector is not None:
                        self.injector.check(step)
                    t0 = time.monotonic()
                    batch = self.data_for(step)
                    state, metrics = step_fn(state, batch)
                    self.step_times.append(time.monotonic() - t0)
                    step += 1
                    if step % self.cfg.ckpt_every == 0:
                        tree = self.snapshot(state)
                        if self.write:
                            self.ckpt.save(step, tree)
            except RuntimeError as e:
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise RuntimeError(
                        f"exceeded max_restarts={self.cfg.max_restarts}"
                    ) from e
                self.ckpt.wait()
                self.barrier()
                restored = latest_step(self.cfg.ckpt_dir)
                state, step_fn, _ = self.make_step(restored)
                step = restored if restored is not None else start
        self.ckpt.wait()
        self.barrier()
        return state, {"final_step": step, "restarts": self.restarts,
                       **{k: float(v) for k, v in metrics.items()}}
