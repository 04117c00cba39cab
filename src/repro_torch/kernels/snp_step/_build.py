"""Build the dense step kernel's CUDA source at first use.

``csrc/snp_step_dense.cu`` has a plain C entry point and is compiled by
``nvcc`` into a shared library under ``kernels/_build/`` (listed in
``.gitignore``), named by a hash of the source and the flags, so an edited
source rebuilds and an unchanged one is reused.  The wrapper loads the
library with ``ctypes`` (no PyTorch headers: a build takes seconds, not
minutes).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "library_path", "build"]

BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

# sm_90a (not sm_90): the later wgmma/setmaxnreg work needs the "a" target.
# -Xptxas -v reports registers, shared memory and spills in the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{source.stem}-{digest[:16]}.so"


def build(source: Path) -> Tuple[Path, str]:
    """Compile ``source`` unless its library exists.  Returns ``(library
    path, compiler log)``; the log is empty for a library already built."""
    lib = library_path(source)
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(".tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{log}")
    os.replace(tmp, lib)   # a reader never sees a partial library
    return lib, log
