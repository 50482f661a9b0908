// JAX's lax.cond on the card: a CUDA graph whose data-dependent choices are
// conditional nodes, assembled from graphs that PyTorch captured.
//
// Replaces no TPU kernel. On the TPU a layer that chooses its branch from
// the scene (sast_tpu/models/sast.py:376 and :441) is one lax.cond inside
// the jitted step, and XLA takes the branch on the device. The port
// captures a step as CUDA graphs, one per segment between two choices and
// one per branch (sast_tpu_torch/graphs.py). The entries below put those
// graphs into one parent graph, in capture order:
// - each segment as a child-graph node;
// - at each choice, a one-thread kernel node that reads the choice's 0-d
//   bool predicate on the card, sets the conditional handle from it and
//   adds one to that choice's count of the branch taken; then an IF node
//   whose body holds the first branch's graph as a child-graph node, and
//   whose else body holds the second's (CUDA 12.8). A CUDA driver that
//   refuses the else body makes the entry fail, naming that node.
// Every node depends on the one before it: the graphs share one memory
// pool and must run in the order they were captured. A replay is one
// launch of the instantiated parent; no predicate crosses to the host.
//
// Bound on the H100: each choice costs one kernel node of one thread (a
// 1-byte read and an 8-byte read-modify-write) and the conditional node's
// launch of its body, a few microseconds of latency; the bytes are nothing.
//
// Graphs and streams cross from PyTorch's CUDA runtime to this library's
// own as the CUDA driver's handles (CUgraph, CUstream), which both runtimes
// share on the device's primary context. Each entry returns its CUDA error
// code (0 on success).
#include <cuda_runtime.h>

#include <cstdint>
#include <vector>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle, const unsigned char* pred,
                              long long* counts) {
  const bool p = *pred != 0;
  cudaGraphSetConditional(handle, p ? 1u : 0u);
  counts[p ? 0 : 1] += 1;
}

// Adds `params` after `*tail` (none when *tail is null) and makes it the tail.
cudaError_t add_after(cudaGraph_t graph, cudaGraphNode_t* tail, cudaGraphNodeParams* params) {
  cudaGraphNode_t node;
  const cudaError_t err = cudaGraphAddNode(&node, graph, *tail ? tail : nullptr, *tail ? 1 : 0,
                                           params);
  if (err == cudaSuccess) *tail = node;
  return err;
}

cudaError_t add_child(cudaGraph_t graph, cudaGraphNode_t* tail, cudaGraph_t child) {
  cudaGraphNode_t node;
  const cudaError_t err = cudaGraphAddChildGraphNode(&node, graph, *tail ? tail : nullptr,
                                                     *tail ? 1 : 0, child);
  if (err == cudaSuccess) *tail = node;
  return err;
}

// One IF node on `handle` after *tail, with `then_graph` as its body and
// `else_graph` as its else body. *stage is 3 when the conditional node is
// refused, 4 when a body's child-graph node is.
cudaError_t add_if(cudaGraph_t graph, cudaGraphNode_t* tail, cudaGraphConditionalHandle handle,
                   cudaGraph_t then_graph, cudaGraph_t else_graph, int* stage) {
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 2;
  *stage = 3;
  cudaError_t err = add_after(graph, tail, &params);
  if (err != cudaSuccess) return err;
  *stage = 4;
  cudaGraphNode_t inner = nullptr;
  err = add_child(params.conditional.phGraph_out[0], &inner, then_graph);
  if (err != cudaSuccess) return err;
  inner = nullptr;
  return add_child(params.conditional.phGraph_out[1], &inner, else_graph);
}

void count_types(cudaGraph_t graph, long long* counts, int n) {
  size_t num = 0;
  if (cudaGraphGetNodes(graph, nullptr, &num) != cudaSuccess || num == 0) return;
  std::vector<cudaGraphNode_t> nodes(num);
  if (cudaGraphGetNodes(graph, nodes.data(), &num) != cudaSuccess) return;
  for (cudaGraphNode_t node : nodes) {
    cudaGraphNodeType type;
    if (cudaGraphNodeGetType(node, &type) != cudaSuccess) continue;
    if (static_cast<int>(type) >= 0 && static_cast<int>(type) < n) ++counts[type];
    cudaGraph_t child;
    if (type == cudaGraphNodeTypeGraph &&
        cudaGraphChildGraphNodeGetGraph(node, &child) == cudaSuccess)
      count_types(child, counts, n);
  }
}

}  // namespace

extern "C" int sast_cond_graph_create(void** graph) {
  return cudaGraphCreate(reinterpret_cast<cudaGraph_t*>(graph), 0);
}

// The nodes of `graph`, child graphs included, by cudaGraphNodeType into
// counts[0, n).
extern "C" int sast_cond_node_types(void* graph, long long* counts, int n) {
  for (int i = 0; i < n; ++i) counts[i] = 0;
  count_types(static_cast<cudaGraph_t>(graph), counts, n);
  return cudaGetLastError();
}

// `child` as a child-graph node after *tail.
extern "C" int sast_cond_add_segment(void* graph, void** tail, void* child) {
  return add_child(static_cast<cudaGraph_t>(graph), reinterpret_cast<cudaGraphNode_t*>(tail),
                   static_cast<cudaGraph_t>(child));
}

// One choice after *tail: the set kernel on `pred` (a bool on the card),
// counting the branch taken into counts[0] (first) or counts[1] (second),
// then an IF node whose body holds `first` and whose else body holds
// `second`. On an error *stage names the node that failed: 1 the
// conditional handle, 2 the set kernel, 3 the conditional node, 4 a body's
// child-graph node.
extern "C" int sast_cond_add_choice(void* graph_, void** tail_, const void* pred, void* counts,
                                    void* first, void* second, int* stage) {
  cudaGraph_t graph = static_cast<cudaGraph_t>(graph_);
  cudaGraphNode_t* tail = reinterpret_cast<cudaGraphNode_t*>(tail_);
  cudaGraphConditionalHandle handle = 0;
  *stage = 1;
  cudaError_t err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  *stage = 2;
  const unsigned char* pred_arg = static_cast<const unsigned char*>(pred);
  long long* counts_arg = static_cast<long long*>(counts);
  void* args[] = {&handle, &pred_arg, &counts_arg};
  cudaKernelNodeParams kernel = {};
  kernel.func = reinterpret_cast<void*>(set_condition);
  kernel.gridDim = dim3(1);
  kernel.blockDim = dim3(1);
  kernel.kernelParams = args;
  cudaGraphNode_t cursor;
  err = cudaGraphAddKernelNode(&cursor, graph, *tail ? tail : nullptr, *tail ? 1 : 0, &kernel);
  if (err != cudaSuccess) return err;
  err = add_if(graph, &cursor, handle, static_cast<cudaGraph_t>(first),
               static_cast<cudaGraph_t>(second), stage);
  if (err == cudaSuccess) *tail = cursor;
  return err;
}

// Instantiate `graph`; on an error, *node_type is the cudaGraphNodeType of
// the node the CUDA driver names (-1 where it names none).
extern "C" int sast_cond_instantiate(void* graph, void** exec, int* node_type) {
  cudaGraphInstantiateParams params = {};
  *node_type = -1;
  const cudaError_t err = cudaGraphInstantiateWithParams(
      reinterpret_cast<cudaGraphExec_t*>(exec), static_cast<cudaGraph_t>(graph), &params);
  if (err != cudaSuccess && params.errNode_out) {
    cudaGraphNodeType type;
    if (cudaGraphNodeGetType(params.errNode_out, &type) == cudaSuccess) *node_type = type;
  }
  return err;
}

extern "C" int sast_cond_launch(void* exec, void* stream) {
  return cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec), static_cast<cudaStream_t>(stream));
}

extern "C" int sast_cond_destroy(void* graph, void* exec) {
  cudaError_t err = cudaSuccess;
  if (exec) err = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  if (graph) {
    const cudaError_t e = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
    if (err == cudaSuccess) err = e;
  }
  return err;
}
