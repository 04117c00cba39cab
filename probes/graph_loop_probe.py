"""Feasibility probe of the fused level loop on the card (no JAX).

Builds ``src/repro_torch/core/csrc/graph_loop.cu``, captures a toy "level"
of the PyTorch operations the BFS level uses (a stable sort, a cumsum, an
``amin`` scatter, copies into static buffers) plus a cooperative launch
of a small grid-synchronising kernel (built here from an inline source),
and runs it under the conditional WHILE node, inside
``torch.cuda.set_sync_debug_mode("error")``.  Prints what it found and
exits non-zero on any failure.

    python3 probes/graph_loop_probe.py
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
import traceback
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

COOP = r"""
#include <cuda_runtime.h>
#include <cooperative_groups.h>
namespace cg = cooperative_groups;
__global__ void coop_rounds(int* acc, int rounds) {
  cg::grid_group g = cg::this_grid();
  for (int r = 0; r < rounds; ++r) {
    if (g.thread_rank() == 0) acc[0] += 1;
    g.sync();
  }
}
extern "C" int coop_launch(void* acc, int rounds, int ex, void* stream) {
  int dev; cudaGetDevice(&dev);
  int sms; cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int per; cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, coop_rounds, 256, 0);
  void* args[] = {&acc, &rounds};
  if (!ex)
    return (int)cudaLaunchCooperativeKernel((void*)coop_rounds, sms * per, 256,
                                            args, 0, (cudaStream_t)stream);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(sms * per); cfg.blockDim = dim3(256);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeCooperative; at[0].val.cooperative = 1;
  cfg.attrs = at; cfg.numAttrs = 1;
  int* a = (int*)acc;
  return (int)cudaLaunchKernelEx(&cfg, coop_rounds, a, rounds);
}
"""


def sh(cmd):
    p = subprocess.run(cmd, shell=True, capture_output=True, text=True)
    return (p.stdout + p.stderr).strip()


def main() -> int:
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    print(sh("nvidia-smi --query-gpu=name,power.limit "
             "--format=csv,noheader"))
    print("raw_cuda_graph:", hasattr(torch.cuda.CUDAGraph, "raw_cuda_graph"))
    print(sh("grep -rn 'cudaGraphSetConditional' /usr/local/cuda/include "
             "| head -5"))
    from repro_torch.kernels.snp_step import _build
    src = ROOT / "src/repro_torch/core/csrc/graph_loop.cu"
    try:
        path, log = _build.build(src)
        print("graph_loop build ok", path.name)
    except Exception as e:          # noqa: BLE001 — a probe reports all
        print("graph_loop build FAILED:\n", str(e)[-3000:])
        return 1
    lib = ctypes.CDLL(str(path))
    lib.graph_loop_build.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.POINTER(ctypes.c_void_p)] * 2
    lib.graph_loop_launch.argtypes = [ctypes.c_void_p] * 2
    lib.graph_loop_destroy.argtypes = [ctypes.c_void_p] * 2

    tmp = Path(tempfile.mkdtemp())
    (tmp / "coop.cu").write_text(COOP)
    out = sh(f"/usr/local/cuda/bin/nvcc -gencode arch=compute_90a,code=sm_90a"
             f" -std=c++17 -O3 -shared -Xcompiler -fPIC -o {tmp}/coop.so "
             f"{tmp}/coop.cu")
    print("coop build:", out or "ok")
    coop = ctypes.CDLL(str(tmp / "coop.so"))
    coop.coop_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p]
    dev = torch.device("cuda")
    ok = True
    for ex in (0, 1):
        for use_coop in (False, True):
            try:
                ok &= run_case(lib, coop, dev, ex, use_coop)
            except Exception:       # noqa: BLE001
                traceback.print_exc()
                ok = False
    print("PROBE", "OK" if ok else "FAILED")
    return 0 if ok else 1


def run_case(lib, coop, dev, ex, use_coop) -> bool:
    N, limit, rounds = 1 << 16, 7, 3
    step = torch.zeros((), dtype=torch.int32, device=dev)
    total = torch.ones((), dtype=torch.int32, device=dev)
    bound = torch.zeros((), dtype=torch.int32, device=dev)
    x = torch.arange(N, dtype=torch.int64, device=dev)
    acc = torch.zeros(1, dtype=torch.int32, device=dev)
    mins = torch.zeros(16, dtype=torch.int64, device=dev)

    def level(st, xx, a, mn, tt):
        y = torch.sort((xx * 7 + st) % 1000, stable=True).values
        c = torch.cumsum(y, 0)
        m = torch.full((16,), N, dtype=torch.int64, device=dev)
        m.scatter_reduce_(0, y % 16, torch.arange(N, device=dev), "amin")
        mn.copy_(m)
        xx.copy_(torch.where(c > 0, y, 0))
        if use_coop:
            rc = coop.coop_launch(a.data_ptr(), rounds, ex,
                                  torch.cuda.current_stream(dev).cuda_stream)
            if rc:
                raise RuntimeError(f"coop launch rc {rc}")
        else:
            a.add_(rounds)
        st.add_(1)
        tt.copy_(limit - st)

    torch.cuda.set_sync_debug_mode("error")
    try:
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            level(step.clone(), x.clone(), acc.clone(), mins.clone(),
                  total.clone())
            g = torch.cuda.CUDAGraph(keep_graph=True)
            g.capture_begin()
            level(step, x, acc, mins, total)
            g.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)
        exe, gr = ctypes.c_void_p(), ctypes.c_void_p()
        rc = lib.graph_loop_build(g.raw_cuda_graph(), step.data_ptr(),
                                  bound.data_ptr(), total.data_ptr(),
                                  ctypes.byref(exe), ctypes.byref(gr))
        print(f"case ex={ex} coop={use_coop}: build rc {rc}")
        if rc:
            return False
        bound.fill_(5)
        rc = lib.graph_loop_launch(exe, torch.cuda.current_stream(dev)
                                   .cuda_stream)
        bound.fill_(100)
        rc2 = lib.graph_loop_launch(exe, torch.cuda.current_stream(dev)
                                    .cuda_stream)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    got = (int(step), int(total), int(acc[0]))
    want = (limit, 0, rounds * limit)
    print(f"  launch rc {rc} {rc2}; step/total/acc {got} want {want}")
    lib.graph_loop_destroy(exe, gr)
    return got == want and rc == 0 and rc2 == 0


if __name__ == "__main__":
    sys.exit(main())
