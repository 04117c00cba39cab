"""Atomic, content-verified checkpoints of nested tensors and arrays (the
port of the JAX package's ``repro.checkpoint.checkpoint``, same layout).

Layout: ``<dir>/step_<n>/`` (``n`` zero-padded to 8 digits) holds one
``arrays.npz`` of the flattened tree, keyed by path, and ``manifest.json``
(shapes, dtypes and a SHA-256 per array; a restore takes the structure
from its template).  A save writes ``step_<n>.tmp``, fsyncs the manifest
and renames the directory, so a crashed writer never corrupts the latest
complete checkpoint.

A tree is nested dicts, lists, tuples and NamedTuples whose leaves are
torch tensors, numpy arrays or Python scalars; ``None`` holds no leaf.
Paths join the reference's keys with ``/``: a dict key as itself (dicts
in sorted key order), a sequence index as its number, a NamedTuple field
as ``.name`` — so either package reads the other's checkpoints.  Tensors
are copied to the host at save; a restore builds each leaf as its
template leaf is (a tensor of its dtype on ``device``, else on the
template's device; an array of its dtype; a Python scalar).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "read_manifest", "AsyncCheckpointer"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _leaves(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in the reference's order and keys."""
    join = (lambda k: f"{prefix}/{k}") if prefix else str
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _leaves(tree[k], join(k))]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in _leaves(getattr(tree, f), join(f".{f}"))]
    if isinstance(tree, (tuple, list)):
        return [kv for i, x in enumerate(tree) for kv in _leaves(x, join(i))]
    return [(prefix, tree)]


def _rebuild(template, it):
    """``template``'s structure with its leaves taken from ``it`` in
    :func:`_leaves` order."""
    if template is None:
        return None
    if isinstance(template, dict):
        vals = {k: _rebuild(template[k], it) for k in sorted(template)}
        return type(template)((k, vals[k]) for k in template)
    if _is_namedtuple(template):
        return type(template)(*(_rebuild(x, it) for x in template))
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(x, it) for x in template)
    return next(it)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {k: _host(v) for k, v in _leaves(tree)}


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: Optional[Dict] = None) -> str:
    """Atomic synchronous save.  Returns the final checkpoint path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    arrays = _flatten(tree)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "extra": extra or {},
        "arrays": {
            k: {"shape": list(v.shape), "dtype": str(v.dtype),
                "sha256": hashlib.sha256(v.tobytes()).hexdigest()}
            for k, v in arrays.items()
        },
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _steps(directory: str) -> List[int]:
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return steps[-1] if steps else None


def read_manifest(directory: str, step: Optional[int] = None
                  ) -> Tuple[int, Dict]:
    """``(step, manifest)`` of a checkpoint (the latest if ``step`` is
    None): shapes and dtypes by path, for a caller that sizes its restore
    template from them."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    with open(os.path.join(directory, f"step_{step:08d}",
                           "manifest.json")) as f:
        return step, json.load(f)


def _like(arr: np.ndarray, leaf, device):
    if isinstance(leaf, torch.Tensor):
        dev = leaf.device if device is None else torch.device(device)
        return torch.as_tensor(arr).to(dtype=leaf.dtype, device=dev)
    if isinstance(leaf, (bool, int, float)):
        return type(leaf)(arr.item())
    return arr.astype(np.asarray(leaf).dtype)


def restore_checkpoint(directory: str, template: Any, *,
                       step: Optional[int] = None, device=None,
                       verify: bool = True) -> Tuple[Any, int, Dict]:
    """Restore into the structure of ``template``.  Returns
    ``(tree, step, extra)``.  ``verify`` checks every array of the
    checkpoint against its SHA-256 (``IOError`` on a mismatch); a leaf
    whose shape differs from the template's raises ``ValueError``."""
    step, manifest = read_manifest(directory, step)
    path = os.path.join(directory, f"step_{step:08d}")
    with np.load(os.path.join(path, "arrays.npz")) as npz:
        data = {k: npz[k] for k in npz.files}
    if verify:
        for k, meta in manifest["arrays"].items():
            h = hashlib.sha256(data[k].tobytes()).hexdigest()
            if h != meta["sha256"]:
                raise IOError(f"checkpoint corruption in {k} at step {step}")
    leaves = []
    for key, leaf in _leaves(template):
        arr = data[key]
        want = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) \
            else np.shape(leaf)
        if tuple(arr.shape) != want:
            raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} "
                             f"vs template {want}")
        leaves.append(_like(arr, leaf, device))
    return _rebuild(template, iter(leaves)), step, manifest["extra"]


class AsyncCheckpointer:
    """Background-thread checkpointing: the caller hands off host copies
    and carries on; ``wait()`` joins before exit.  Keeps the last
    ``keep`` checkpoints."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None):
        self.wait()
        host = _rebuild(tree, iter([_host(x) for _, x in _leaves(tree)]))

        def work():
            try:
                save_checkpoint(self.directory, step, host, extra)
                self._gc()
            except BaseException as e:   # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        for s in _steps(self.directory)[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
