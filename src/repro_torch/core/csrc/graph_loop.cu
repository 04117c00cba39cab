// The BFS level loop as one CUDA graph with a conditional WHILE node
// (CUDA >= 12.4), bound with ctypes by core/graph_loop.py.
//
// Replaces no TPU kernel: it is the port's counterpart of the reference's
// lax.while_loop over BFS levels (src/repro/core/engine.py::_explore_loop,
// src/repro/core/distributed.py::_dense_loop and the sharded loop), whose
// predicate runs on the device.  PyTorch captures one level into a graph
// (torch.cuda.CUDAGraph(keep_graph=True)); this helper builds
//
//   set_condition  ->  WHILE(handle) { level (child graph) -> set_condition }
//
// where set_condition is a one-thread kernel that sets the node's condition
// to  step < bound && total_new > 0  from three device int32 scalars.  The
// first one decides whether the loop runs at all (the reference tests its
// predicate before the first level), the one in the body after every level.
// So a drained tree stops on the device where the reference's stops, and
// the host launches the whole run once and reads nothing until it ends.
//
// What bounds it: nothing measurable; two one-thread launches a level
// beside the level's own work.
//
// Errors: every entry returns 0 or stage * 1000 + the CUDA error of the
// call that failed (stage 1 create, 2 handle, 3 first kernel node, 4 the
// conditional node, 5 the child graph node, 6 the body's kernel node, 7
// instantiate), so the caller can name the refused call.

#include <cuda_runtime.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const int* step, const int* bound,
                              const int* total_new) {
  cudaGraphSetConditional(handle,
                          (*step < *bound && *total_new > 0) ? 1u : 0u);
}

cudaError_t add_condition_node(cudaGraphNode_t* node, cudaGraph_t graph,
                               const cudaGraphNode_t* deps, size_t ndeps,
                               cudaGraphConditionalHandle handle,
                               const int* step, const int* bound,
                               const int* total_new) {
  void* args[] = {&handle, &step, &bound, &total_new};
  cudaKernelNodeParams p = {};
  p.func = (void*)set_condition;
  p.gridDim = dim3(1, 1, 1);
  p.blockDim = dim3(1, 1, 1);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  p.extra = nullptr;
  return cudaGraphAddKernelNode(node, graph, deps, ndeps, &p);
}

}  // namespace

#define STAGE(n, call)                                   \
  do {                                                   \
    cudaError_t e_ = (call);                             \
    if (e_ != cudaSuccess) {                             \
      if (graph) cudaGraphDestroy(graph);                \
      return (n) * 1000 + (int)e_;                       \
    }                                                    \
  } while (0)

// Build and instantiate the loop around `level` (a cudaGraph_t, not
// consumed: it is cloned into the body).  `step`, `bound` and `total_new`
// are device int32 scalars that outlive the executable.  On success
// *exec_out and *graph_out hold the executable and its graph, which
// graph_loop_destroy frees.
extern "C" int graph_loop_build(void* level, const void* step,
                                const void* bound, const void* total_new,
                                void** exec_out, void** graph_out) {
  const int* s = (const int*)step;
  const int* b = (const int*)bound;
  const int* t = (const int*)total_new;
  cudaGraph_t graph = nullptr;
  STAGE(1, cudaGraphCreate(&graph, 0));
  cudaGraphConditionalHandle handle;
  STAGE(2, cudaGraphConditionalHandleCreate(&handle, graph, 0, 0));
  cudaGraphNode_t first;
  STAGE(3, add_condition_node(&first, graph, nullptr, 0, handle, s, b, t));
  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = handle;
  cp.conditional.type = cudaGraphCondTypeWhile;
  cp.conditional.size = 1;
  cudaGraphNode_t loop;
  STAGE(4, cudaGraphAddNode(&loop, graph, &first, 1, &cp));
  cudaGraph_t body = cp.conditional.phGraph_out[0];
  cudaGraphNode_t child;
  STAGE(5, cudaGraphAddChildGraphNode(&child, body, nullptr, 0,
                                      (cudaGraph_t)level));
  cudaGraphNode_t again;
  STAGE(6, add_condition_node(&again, body, &child, 1, handle, s, b, t));
  cudaGraphExec_t exec;
  STAGE(7, cudaGraphInstantiate(&exec, graph, 0));
  *exec_out = (void*)exec;
  *graph_out = (void*)graph;
  return 0;
}

// Launch the loop on `stream` (PyTorch's current stream); asynchronous.
extern "C" int graph_loop_launch(void* exec, void* stream) {
  return (int)cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
}

extern "C" int graph_loop_destroy(void* exec, void* graph) {
  cudaError_t e = cudaSuccess;
  if (exec) e = cudaGraphExecDestroy((cudaGraphExec_t)exec);
  if (graph) {
    cudaError_t g = cudaGraphDestroy((cudaGraph_t)graph);
    if (e == cudaSuccess) e = g;
  }
  return (int)e;
}
