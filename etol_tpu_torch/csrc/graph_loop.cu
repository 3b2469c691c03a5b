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
//     Where the loop has a stamp slot (five unsigned 64-bit integers on
//     the card, one slot an insertion: two loops of one program may run
//     one trip graph), the head kernel writes %globaltimer into slot[0]
//     and adds one to slot[3] (the loop's runs), the body's adds one to
//     slot[2] (its trips), and the kernel that ends the loop adds the
//     time since slot[0] to slot[1]: the loop's card time in ns. Where
//     the trip has a line-search buffer too (two unsigned 64-bit
//     integers of the trip's, which two phase stamps in the trip fill:
//     the line search's start, and its ns summed since the buffer was
//     last emptied), the body's kernel moves buf[1] into slot[4] (the
//     loop's line-search ns) and empties it; the head's empties it.
//   * phase_stamp_kernel: one thread, launched on a stream (captured into
//     a traced trip between its phases, and into every trip of a device
//     loop at its line search's start and end). It adds the %globaltimer
//     time since buf[0] to buf[1 + phase] and writes the time to buf[0];
//     phase -1 only writes it.
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
//   * etol_graph_loop_load / _versions, etol_phase_stamp.
//
// What bounds it: nothing of its own. The condition kernel moves 33 bytes
// (the flag, the two counters read and written; with a stamp slot 16 to
// 24 more, with a line-search buffer 24 more) and does no arithmetic; its
// cost is one dependent launch inside the graph a trip, which is what the
// host's replay and its wait on a flag a trip late cost before. A trip
// with a line-search buffer adds two phase stamps (16 bytes each) a line
// search; a traced trip one at each of its phase boundaries.
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

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void loop_cond_kernel(cudaGraphConditionalHandle handle,
                                 const unsigned char* flag,
                                 unsigned long long* counts,
                                 unsigned long long* stamp,
                                 unsigned long long* ls, int body) {
  counts[0] += 1;     // launches of this kernel
  counts[1] += body;  // trips run under the loop
  const bool more = *flag;
  if (stamp != nullptr) {
    const unsigned long long now = globaltimer();
    if (body) {
      stamp[2] += 1;
      if (ls != nullptr) stamp[4] += ls[1];
    } else {
      stamp[0] = now;
      stamp[3] += 1;
    }
    if (ls != nullptr) ls[1] = 0;
    if (!more) stamp[1] += now - stamp[0];
  }
  cudaGraphSetConditional(handle, more ? 1u : 0u);
}

__global__ void phase_stamp_kernel(unsigned long long* buf, int phase) {
  const unsigned long long now = globaltimer();
  if (phase >= 0) buf[1 + phase] += now - buf[0];
  buf[0] = now;
}

cudaError_t add_cond_kernel(cudaGraphNode_t* node, cudaGraph_t graph,
                            const cudaGraphNode_t* deps, size_t n_deps,
                            cudaGraphConditionalHandle handle,
                            const unsigned char* flag,
                            unsigned long long* counts,
                            unsigned long long* stamp,
                            unsigned long long* ls, int body) {
  void* args[] = {&handle, &flag, &counts, &stamp, &ls, &body};
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
// kernel, trips), its stamp slot `stamp` (five unsigned 64-bit integers
// on the card, or null) and the trip's line-search buffer `ls` (two
// unsigned 64-bit integers on the card, or null; read only with a slot:
// see loop_cond_kernel); what the stream captures next runs after the
// loop. The flag, the counters, the slot and the buffer must outlive
// every graph made from the capture.
extern "C" int etol_graph_loop_insert(void* stream, void* trip, void* flag,
                                      void* counts, void* stamp, void* ls) {
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
  unsigned long long* st = static_cast<unsigned long long*>(stamp);
  unsigned long long* lb = static_cast<unsigned long long*>(ls);
  cudaGraphNode_t head;
  e = add_cond_kernel(&head, graph, deps, n_deps, handle, f, c, st, lb, 0);
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
  e = add_cond_kernel(&tail, body, &step, 1, handle, f, c, st, lb, 1);
  if (e != cudaSuccess) return (int)e;
  return (int)wait_on(s, &loop);
}

// Launch the phase stamp on `stream` (captured where the stream captures):
// buf (six unsigned 64-bit integers on the card) gains the time since its
// last stamp in buf[1 + phase]; phase -1 only stamps.
extern "C" int etol_phase_stamp(void* stream, void* buf, int phase) {
  phase_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(buf), phase);
  return (int)cudaGetLastError();
}

// Load the kernels into the current context, so that no capture pays for
// (or is refused) a lazy module load.
extern "C" int etol_graph_loop_load() {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(
      &attr, reinterpret_cast<const void*>(loop_cond_kernel));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaFuncGetAttributes(
      &attr, reinterpret_cast<const void*>(phase_stamp_kernel));
}

// The runtime this library was built against and the CUDA driver's
// version, as 1000 * major + 10 * minor.
extern "C" int etol_graph_loop_versions(int* runtime, int* cuda_driver) {
  *runtime = CUDART_VERSION;
  return (int)cudaDriverGetVersion(cuda_driver);
}
