// The solver loop's stop test on the card: a CUDA graph whose while node
// runs a captured trip until the trip's own flag says no lane is active.
//
// Counterpart of the JAX package's lax.while_loop around its solver trip
// (etol_tpu/solve/al_sqp.py, _solve_single): XLA runs the loop's cond on
// the device, so a solve is one program with no host decision between
// trips. It replaces no Pallas kernel; it is the device half of the
// loop's cond. Its plain version is the host-driven loop (the eager loop
// and the replayed trip in etol_tpu_torch/solve/trip_graph.py).
//
// What it holds:
//   * loop_cond_kernel: one thread. It reads the 0-dim bool flag that the
//     trip writes at its end (any lane active), adds one to the loop's
//     launch counter and, in the while node's body, one to its trip
//     counter, and sets the while node's condition handle from the flag.
//   * etol_graph_loop_insert: adds a loop to the graph a stream is
//     capturing, after the work captured so far:
//         head: loop_cond_kernel (body = 0)   -- test before the first trip
//           -> while node (cudaGraphCondTypeWhile) whose body is
//                child graph of the captured trip -> loop_cond_kernel (1)
//     and makes the while node what the capture's next work waits on. A
//     loop whose flag is false when it is reached runs no trip, as
//     lax.while_loop tests its cond before the first body. So a loop is
//     one more step of a torch capture: alone in one (a solve's loop), or
//     between the captured work before and after it (the staged solve).
//   * etol_graph_loop_load / _versions.
//
// What bounds it: nothing of its own. The condition kernel moves 33 bytes
// (the flag, the two counters read and written) and does no arithmetic;
// its cost is one dependent launch inside the graph a trip, which is what
// the host's replay and its wait on a flag a trip late cost before.
//
// The stream and graph handles passed in are torch's (a CUstream and a
// CUgraph of the CUDA driver, valid across the two runtimes in the
// process: torch's shared libcudart and this library's static one). Every
// entry point returns a cudaError_t; the wrapper
// (etol_tpu_torch/ops/graph_loop.py) raises on anything but cudaSuccess.
#include <cuda_runtime.h>

#if CUDART_VERSION < 12040
#error "graph_loop.cu needs CUDA 12.4 or later: conditional nodes whose body holds memsets and memcopies"
#endif

namespace {

__global__ void loop_cond_kernel(cudaGraphConditionalHandle handle,
                                 const unsigned char* flag,
                                 unsigned long long* counts, int body) {
  counts[0] += 1;     // launches of this kernel
  counts[1] += body;  // trips run under the loop
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

cudaError_t add_cond_kernel(cudaGraphNode_t* node, cudaGraph_t graph,
                            const cudaGraphNode_t* deps, size_t n_deps,
                            cudaGraphConditionalHandle handle,
                            const unsigned char* flag,
                            unsigned long long* counts, int body) {
  void* args[] = {&handle, &flag, &counts, &body};
  cudaKernelNodeParams p = {};
  p.func = reinterpret_cast<void*>(loop_cond_kernel);
  p.gridDim = dim3(1);
  p.blockDim = dim3(1);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  p.extra = nullptr;
  return cudaGraphAddKernelNode(node, graph, deps, n_deps, &p);
}

cudaError_t add_node(cudaGraphNode_t* node, cudaGraph_t graph,
                     const cudaGraphNode_t* deps, size_t n_deps,
                     cudaGraphNodeParams* params) {
#if CUDART_VERSION >= 13000
  return cudaGraphAddNode(node, graph, deps, nullptr, n_deps, params);
#else
  return cudaGraphAddNode(node, graph, deps, n_deps, params);
#endif
}

// The edge-data forms of the capture queries (CUDA 12.3), named so from
// CUDA 13.0. No edge data is asked for: a capture whose edges carry any
// fails the query rather than lose it.
cudaError_t capture_info(cudaStream_t stream, cudaStreamCaptureStatus* status,
                         cudaGraph_t* graph, const cudaGraphNode_t** deps,
                         size_t* n_deps) {
#if CUDART_VERSION >= 13000
  return cudaStreamGetCaptureInfo(stream, status, nullptr, graph, deps,
                                  nullptr, n_deps);
#else
  return cudaStreamGetCaptureInfo_v3(stream, status, nullptr, graph, deps,
                                     nullptr, n_deps);
#endif
}

cudaError_t wait_on(cudaStream_t stream, cudaGraphNode_t* node) {
#if CUDART_VERSION >= 13000
  return cudaStreamUpdateCaptureDependencies(
      stream, node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
  return cudaStreamUpdateCaptureDependencies_v2(
      stream, node, nullptr, 1, cudaStreamSetCaptureDependencies);
#endif
}

}  // namespace

// Add to the graph `stream` is capturing, after what it captured so far, a
// loop around the captured graph `trip` (a cudaGraph_t, cloned in) with
// its flag `flag` (a 1-byte bool on the card) and its counters `counts`
// (two unsigned 64-bit integers on the card: launches of the condition
// kernel, trips); what the stream captures next runs after the loop. The
// flag and the counters must outlive every graph made from the capture.
extern "C" int etol_graph_loop_insert(void* stream, void* trip, void* flag,
                                      void* counts) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t e = capture_info(s, &status, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return (int)e;
  if (status != cudaStreamCaptureStatusActive)
    return (int)cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (e != cudaSuccess) return (int)e;
  const unsigned char* f = static_cast<const unsigned char*>(flag);
  unsigned long long* c = static_cast<unsigned long long*>(counts);
  cudaGraphNode_t head;
  e = add_cond_kernel(&head, graph, deps, n_deps, handle, f, c, 0);
  if (e != cudaSuccess) return (int)e;
  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = handle;
  cp.conditional.type = cudaGraphCondTypeWhile;
  cp.conditional.size = 1;
  cudaGraphNode_t loop;
  e = add_node(&loop, graph, &head, 1, &cp);
  if (e != cudaSuccess) return (int)e;
  cudaGraph_t body = cp.conditional.phGraph_out[0];
  cudaGraphNode_t step, tail;
  e = cudaGraphAddChildGraphNode(&step, body, nullptr, 0,
                                 static_cast<cudaGraph_t>(trip));
  if (e != cudaSuccess) return (int)e;
  e = add_cond_kernel(&tail, body, &step, 1, handle, f, c, 1);
  if (e != cudaSuccess) return (int)e;
  return (int)wait_on(s, &loop);
}

// Load the condition kernel into the current context, so that no capture
// pays for (or is refused) a lazy module load.
extern "C" int etol_graph_loop_load() {
  cudaFuncAttributes attr;
  return (int)cudaFuncGetAttributes(
      &attr, reinterpret_cast<const void*>(loop_cond_kernel));
}

// The runtime this library was built against and the CUDA driver's
// version, as 1000 * major + 10 * minor.
extern "C" int etol_graph_loop_versions(int* runtime, int* cuda_driver) {
  *runtime = CUDART_VERSION;
  return (int)cudaDriverGetVersion(cuda_driver);
}
