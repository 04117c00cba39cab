"""Helpers of the port's mesh tests (``test_torch_elastic_restore.py``,
``test_torch_mesh_launchers.py``): run a script on N ranks, one
subprocess a rank, over a gloo group whose rendezvous is a ``FileStore``
under the test's ``tmp_path`` (no TCP port, so concurrent test workers
cannot collide).

A rank script reads its rank, the world size and the store's path from
``MESH_RANK``, ``MESH_WORLD`` and ``MESH_STORE`` and joins the group
first; :data:`PRELUDE`, put before every script, does both."""

import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRELUDE = """
import os, sys, json, logging
import torch, torch.distributed as dist
torch.set_num_threads(1)
logging.disable(logging.WARNING)   # DTensor's notes on gloo's collectives
RANK, WORLD = int(os.environ["MESH_RANK"]), int(os.environ["MESH_WORLD"])
dist.init_process_group("gloo", store=dist.FileStore(
    os.environ["MESH_STORE"], WORLD), rank=RANK, world_size=WORLD)
"""


def start_ranks(world, script, tmp_path, name, args=()):
    """Start ``script`` (``PRELUDE`` prepended) on ``world`` ranks, their
    store and output under ``tmp_path`` (``name`` tells runs apart);
    returns the run (see :func:`wait_ranks`)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1", MESH_WORLD=str(world),
               MESH_STORE=str(tmp_path / f"{name}.store"))
    env.pop("RANK", None)
    env.pop("WORLD_SIZE", None)
    procs = []
    for r in range(world):
        out = open(tmp_path / f"{name}.{r}.out", "w+")
        err = open(tmp_path / f"{name}.{r}.err", "w+")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", PRELUDE + script, *map(str, args)],
            env=dict(env, MESH_RANK=str(r)), stdout=out, stderr=err,
            text=True), out, err))
    return procs


def wait_ranks(procs, timeout):
    """Wait for every rank, ``timeout`` seconds in all; once a rank fails
    (or the time is out) the others are killed and the first failing
    rank's error output raised.  Returns rank 0's standard output."""
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p, _, _ in procs):
            failed = any(p.poll() not in (None, 0) for p, _, _ in procs)
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p, _, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for p, out, err in procs:
        out.seek(0)
        err.seek(0)
        texts.append((p.returncode, out.read(), err.read()))
        out.close()
        err.close()
    for r, (rc, _, err) in enumerate(texts):
        if rc not in (0, -9):
            raise AssertionError(f"rank {r} exited {rc}:\n{err[-4000:]}")
    for r, (rc, _, err) in enumerate(texts):
        assert rc == 0, f"rank {r} killed after {timeout} s:\n{err[-4000:]}"
    return texts[0][1]


def run_ranks(world, script, tmp_path, name, args=(), timeout=300):
    return wait_ranks(start_ranks(world, script, tmp_path, name, args),
                      timeout)
