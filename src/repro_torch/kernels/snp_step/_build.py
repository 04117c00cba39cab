"""Build the kernels' CUDA sources at first use (the step kernels here and
B8 in ``kernels/flash_attn``).

Each ``csrc/*.cu`` has a plain C entry point and is compiled by ``nvcc``
into its own shared library under ``kernels/_build/`` (listed in
``.gitignore``), named by a hash of the source, the headers beside it
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds
and an unchanged one is reused.  The wrappers load the
libraries with ``ctypes`` (no PyTorch headers: a build takes seconds, not
minutes).  :func:`build_all` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "library_path", "build", "build_all",
           "load_library"]

BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

# sm_90a (not sm_90): the later wgmma/setmaxnreg work needs the "a" target.
# -Xptxas -v reports registers, shared memory and spills in the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: compiler log of each source built by this process (source path -> log)
build_logs: Dict[Path, str] = {}

_loaded: Dict[Path, ctypes.CDLL] = {}
_load_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built at first "
                       "use and need the CUDA toolkit (set CUDA_HOME)")


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"


def build_all(sources: Sequence[Path]) -> List[Tuple[Path, str]]:
    """Compile every source whose library does not exist yet, one ``nvcc``
    each, all started together.  Returns ``(library path, compiler log)``
    per source; the log is empty for a library already built."""
    todo = [s for s in sources if not library_path(s).exists()]
    nvcc = _nvcc() if todo else None
    jobs = []
    for source in sources:
        lib = library_path(source)
        if source not in todo:
            jobs.append((source, lib, None))
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((source, lib, (proc, tmp)))
    out, failed = [], []
    for source, lib, job in jobs:
        if job is None:
            out.append((lib, ""))
            continue
        proc, tmp = job
        log, _ = proc.communicate()
        build_logs[source] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {source}:\n{log}")
            continue
        os.replace(tmp, lib)   # a reader never sees a partial library
        out.append((lib, log))
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def build(source: Path) -> Tuple[Path, str]:
    """:func:`build_all` of one source."""
    return build_all([source])[0]


def load_library(source: Path) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed (once per
    process, also when threads ask at once: the trace service launches
    from its drain thread)."""
    with _load_lock:
        lib = _loaded.get(source)
        if lib is None:
            path, _ = build(source)
            lib = _loaded[source] = ctypes.CDLL(str(path))
        return lib
