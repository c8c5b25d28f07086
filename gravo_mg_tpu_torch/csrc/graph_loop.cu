// The fused solve's loop as one CUDA graph: the device-side counterpart of
// jax.lax.while_loop (gravo_mg_tpu/solver/multigrid.py fused_solve and the
// halo solver's _make_fused, gravo_mg_tpu/parallel/halo.py).
//
//   outer graph:  set(handle, *more) -> WHILE(handle) { step ; set(handle, *more) }
//
// `step` is a graph captured by PyTorch (one multigrid cycle, its residual
// and the stop test, which writes the loop's `more` flag, a one-byte bool
// in device memory).  loop_control_kernel is a one-thread kernel that
// reads the flag and sets the conditional handle from it: once in front of
// the WHILE node (so a launch whose first cycle is not needed runs no body,
// as JAX's cond is tested before the first body) and once at the end of
// every body.  The host launches the instantiated graph once per solve and
// waits once, for the result.
//
// This is no port of a TPU kernel and bounds nothing: it is one launch per
// cycle of one thread, which reads one byte.
//
// The two CUDA runtimes: this library links cudart statically and PyTorch
// has its own.  Graphs, executable graphs, streams and conditional handles
// are driver objects, so a cudaGraph_t captured by PyTorch and PyTorch's
// stream are passed in as they are.  The kernel nodes added here take this
// library's own __global__, which this library's runtime resolves.
//
// A conditional body may hold kernel, empty, child-graph, memset, memcpy
// (device memory) and conditional nodes only: no host, event or
// memory-allocation nodes.  gravomg_graph_node_types counts a graph's
// nodes by type so that a refusal can say what the body held.

#include <cuda_runtime.h>

#include <cstdint>

namespace gravomg {

__global__ void loop_control_kernel(cudaGraphConditionalHandle handle,
                                    const bool* more) {
  cudaGraphSetConditional(handle, *more ? 1u : 0u);
}

cudaError_t add_loop_control(cudaGraphNode_t* node, cudaGraph_t graph,
                             const cudaGraphNode_t* deps, size_t ndeps,
                             cudaGraphConditionalHandle handle,
                             const bool* more) {
  void* args[] = {&handle, &more};
  cudaKernelNodeParams p = {};
  p.func = reinterpret_cast<void*>(loop_control_kernel);
  p.gridDim = dim3(1);
  p.blockDim = dim3(1);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  p.extra = nullptr;
  return cudaGraphAddKernelNode(node, graph, deps, ndeps, &p);
}

cudaError_t count_node_types(cudaGraph_t graph, int64_t* counts) {
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(graph, nullptr, &n);
  if (err != cudaSuccess || n == 0) return err;
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n];
  err = cudaGraphGetNodes(graph, nodes, &n);
  for (size_t i = 0; err == cudaSuccess && i < n; ++i) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[i], &type);
    if (err != cudaSuccess) break;
    counts[static_cast<int>(type) & 15] += 1;
    if (type == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      err = cudaGraphChildGraphNodeGetGraph(nodes[i], &child);
      if (err == cudaSuccess) err = count_node_types(child, counts);
    }
  }
  delete[] nodes;
  return err;
}

}  // namespace gravomg

extern "C" {

// counts[t] += the nodes of type t (cudaGraphNodeType) in `graph`, those
// inside child graphs included; counts has 16 entries.
int gravomg_graph_node_types(void* graph, int64_t* counts) {
  for (int t = 0; t < 16; ++t) counts[t] = 0;
  return gravomg::count_node_types(static_cast<cudaGraph_t>(graph), counts);
}

// Builds and instantiates the outer graph around `body` (which is cloned
// into it; the caller keeps what `body`'s kernels address alive) with the
// loop's flag `more`.  On success *exec_out and *graph_out hold the
// executable and the graph, both for gravomg_graph_loop_destroy.  On
// failure both are null, everything built is freed, and stage[0] says
// which call failed (1 handle, 2 first control node, 3 WHILE node, 4 the
// body's child graph, 5 the body's control node, 6 instantiation),
// stage[1] the instantiation's cudaGraphInstantiateResult and stage[2] the
// type of the node it blamed (-1 if none).
int gravomg_graph_loop_create(void* body, const void* more, void** exec_out,
                              void** graph_out, int64_t* stage) {
  using namespace gravomg;
  *exec_out = nullptr;
  *graph_out = nullptr;
  stage[0] = 0;
  stage[1] = 0;
  stage[2] = -1;
  const bool* flag = static_cast<const bool*>(more);
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaGraphCreate(&graph, 0);
  if (err != cudaSuccess) return err;

  cudaGraphConditionalHandle handle;
  cudaGraphNode_t first = nullptr, loop = nullptr, step = nullptr, last = nullptr;
  cudaGraph_t loop_body = nullptr;
  cudaGraphExec_t exec = nullptr;
  cudaGraphNodeParams cond = {};
  cudaGraphInstantiateParams inst = {};

  stage[0] = 1;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) goto fail;
  stage[0] = 2;
  err = add_loop_control(&first, graph, nullptr, 0, handle, flag);
  if (err != cudaSuccess) goto fail;
  stage[0] = 3;
  cond.type = cudaGraphNodeTypeConditional;
  cond.conditional.handle = handle;
  cond.conditional.type = cudaGraphCondTypeWhile;
  cond.conditional.size = 1;
  err = cudaGraphAddNode(&loop, graph, &first, 1, &cond);
  if (err != cudaSuccess) goto fail;
  loop_body = cond.conditional.phGraph_out[0];
  stage[0] = 4;
  err = cudaGraphAddChildGraphNode(&step, loop_body, nullptr, 0,
                                   static_cast<cudaGraph_t>(body));
  if (err != cudaSuccess) goto fail;
  stage[0] = 5;
  err = add_loop_control(&last, loop_body, &step, 1, handle, flag);
  if (err != cudaSuccess) goto fail;
  stage[0] = 6;
  inst.flags = 0;
  err = cudaGraphInstantiateWithParams(&exec, graph, &inst);
  if (err != cudaSuccess) {
    stage[1] = static_cast<int64_t>(inst.result_out);
    cudaGraphNodeType type;
    if (inst.errNode_out != nullptr &&
        cudaGraphNodeGetType(inst.errNode_out, &type) == cudaSuccess) {
      stage[2] = static_cast<int64_t>(type);
    }
    goto fail;
  }
  stage[0] = 0;
  *exec_out = exec;
  *graph_out = graph;
  return cudaSuccess;

fail:
  cudaGetLastError();
  cudaGraphDestroy(graph);
  return err;
}

// Launches the instantiated loop on `stream` (PyTorch's current stream).
int gravomg_graph_loop_launch(void* exec, void* stream) {
  cudaError_t err = cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                                    static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? err : cudaGetLastError();
}

int gravomg_graph_loop_destroy(void* exec, void* graph) {
  cudaError_t err = cudaSuccess;
  if (exec != nullptr) err = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  if (graph != nullptr) {
    cudaError_t e2 = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
    if (err == cudaSuccess) err = e2;
  }
  return err;
}

}  // extern "C"
