// Conditional nodes of CUDA graphs, opened inside a capture that PyTorch
// has under way: the counterpart of XLA's on-device `cond` and `while`
// (the JAX package's `lax.cond` and `lax.while_loop`), used by
// sos_slam_tpu_torch/ops/control.py.
//
// Replaces no Pallas kernel. The fused path's graphs (the frame step and
// the keyframe chains) need it to skip a branch or leave a loop on the
// device, as the JAX programs do, instead of running every branch and
// every loop to its bound.
//
// Bound on the card: launch latency, not bytes or operations. Each setter
// kernel is one thread that reads one flag, writes one or two counters and
// adds one to the count of setter launches (at most 25 bytes); what a node
// costs is the scheduling of the node and of its setter, a few
// microseconds (the probe scripts/torch_graph_probe.py measures a skipped
// IF node and one WHILE trip). The design keeps a node
// to one setter launch: the IF setter counts the branch it takes, the
// WHILE setter counts the trip and tests the trip cap in the same thread.
// Beside them, a one-thread stamp kernel writes %globaltimer into one slot:
// the fused frame's device stamps (models/fused_graph.py), inside its
// graph and its bodies.
//
// The host half uses the driver API (linked -lcuda), so that it meets the
// capture that PyTorch began in the one driver context, whatever runtime
// library PyTorch carries: cuStreamGetCaptureInfo gives the graph being
// captured and its dependencies, cuGraphConditionalHandleCreate a handle
// in it, cuGraphAddNode the node, cuStreamUpdateCaptureDependencies makes
// the node the capture's new frontier, and cuStreamBeginCaptureToGraph
// captures a body from a side stream into the node's body graph. Every
// entry point returns 0 or the CUDA error code; the wrapper raises on any
// other value.
#include <cuda.h>
#include <cuda_runtime.h>
#include <string.h>

#if CUDA_VERSION < 12030
#error "conditional graph nodes need CUDA 12.3 or later"
#endif

#if CUDA_VERSION >= 13000
#define GC_CAPTURE_INFO(s, st, id, g, d, n) \
  cuStreamGetCaptureInfo(s, st, id, g, d, nullptr, n)
#define GC_ADD_NODE(node, g, d, n, p) cuGraphAddNode(node, g, d, nullptr, n, p)
#define GC_UPDATE_DEPS(s, d, n, f) \
  cuStreamUpdateCaptureDependencies(s, d, nullptr, n, f)
#define GC_GET_EDGES(g, f, t, e, n) cuGraphGetEdges(g, f, t, e, n)
#else
#define GC_CAPTURE_INFO(s, st, id, g, d, n) \
  cuStreamGetCaptureInfo_v3(s, st, id, g, d, nullptr, n)
#define GC_ADD_NODE(node, g, d, n, p) \
  cuGraphAddNode_v2(node, g, d, nullptr, n, p)
#define GC_UPDATE_DEPS(s, d, n, f) \
  cuStreamUpdateCaptureDependencies_v2(s, d, nullptr, n, f)
#define GC_GET_EDGES(g, f, t, e, n) cuGraphGetEdges_v2(g, f, t, e, n)
#endif

// The setter launches that ran on the device, all nodes together (read by
// gc_launches).
__device__ unsigned long long gc_launch_count = 0;

// IF: take the body (or, with `negate`, the else) where *pred holds, and
// count the branch taken in runs_true / runs_false (either may be null).
__global__ void set_if_kernel(cudaGraphConditionalHandle h, const bool* pred,
                              int negate, long long* runs_true,
                              long long* runs_false) {
  atomicAdd(&gc_launch_count, 1ull);
  const bool p = (*pred) != (negate != 0);
  long long* runs = p ? runs_true : runs_false;
  if (runs) *runs += 1;
  cudaGraphSetConditional(h, p ? 1u : 0u);
}

// WHILE: before the node (step 0) the trip count starts at 0, and `runs`
// (the node's entry count) goes up by one where the body will run; at the
// end of each trip (step 1) the trip count and `runs` (the node's trip
// count) go up by one. The body runs again while *go holds and fewer than
// `cap` trips were made.
__global__ void set_while_kernel(cudaGraphConditionalHandle h, const bool* go,
                                 int* trips, int cap, int step,
                                 long long* runs) {
  atomicAdd(&gc_launch_count, 1ull);
  const int t = step ? *trips + 1 : 0;
  *trips = t;
  const bool more = *go && t < cap;
  if (runs && (step || more)) *runs += 1;
  cudaGraphSetConditional(h, more ? 1u : 0u);
}

// The device's clock (%globaltimer, ns) into *slot: one thread, 8 bytes.
// A kernel node, so a conditional body may hold it; it counts in no
// launch counter (not gc_launch_count either).
__global__ void stamp_kernel(long long* slot) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  *slot = (long long)t;
}

static cudaGraphConditionalHandle handle_of(const void* h) {
  return *(const unsigned long long*)h;
}

// A new conditional handle in the graph that `stream` is capturing, into
// the host word at `handle_out`.
extern "C" int gc_handle(void* stream, void* handle_out) {
  CUstreamCaptureStatus status;
  cuuint64_t id;
  CUgraph graph;
  const CUgraphNode* deps;
  size_t n;
  CUresult r = GC_CAPTURE_INFO((CUstream)stream, &status, &id, &graph, &deps,
                               &n);
  if (r != CUDA_SUCCESS) return (int)r;
  if (status != CU_STREAM_CAPTURE_STATUS_ACTIVE)
    return (int)CUDA_ERROR_STREAM_CAPTURE_UNMATCHED;
  CUcontext ctx;
  r = cuCtxGetCurrent(&ctx);
  if (r != CUDA_SUCCESS) return (int)r;
  CUgraphConditionalHandle h;
  r = cuGraphConditionalHandleCreate(&h, graph, ctx, 0, 0);
  if (r != CUDA_SUCCESS) return (int)r;
  *(unsigned long long*)handle_out = (unsigned long long)h;
  return 0;
}

extern "C" int gc_set_if(void* handle, const void* pred, int negate,
                         void* runs_true, void* runs_false, void* stream) {
  set_if_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      handle_of(handle), (const bool*)pred, negate, (long long*)runs_true,
      (long long*)runs_false);
  return (int)cudaGetLastError();
}

extern "C" int gc_set_while(void* handle, const void* go, void* trips,
                            int cap, int step, void* runs, void* stream) {
  set_while_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      handle_of(handle), (const bool*)go, (int*)trips, cap, step,
      (long long*)runs);
  return (int)cudaGetLastError();
}

extern "C" int gc_stamp(void* slot, void* stream) {
  stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((long long*)slot);
  return (int)cudaGetLastError();
}

// A conditional node (`kind` 0: IF with `size` 1 or 2 bodies, 1: WHILE)
// after the capture's current dependencies on `stream`, which then
// depend on it. Its body graphs go to the host array `bodies_out`.
extern "C" int gc_add_node(void* stream, void* handle, int kind, int size,
                           void* bodies_out) {
  CUstreamCaptureStatus status;
  cuuint64_t id;
  CUgraph graph;
  const CUgraphNode* deps;
  size_t n;
  CUresult r = GC_CAPTURE_INFO((CUstream)stream, &status, &id, &graph, &deps,
                               &n);
  if (r != CUDA_SUCCESS) return (int)r;
  if (status != CU_STREAM_CAPTURE_STATUS_ACTIVE)
    return (int)CUDA_ERROR_STREAM_CAPTURE_UNMATCHED;
  CUcontext ctx;
  r = cuCtxGetCurrent(&ctx);
  if (r != CUDA_SUCCESS) return (int)r;
  CUgraphNodeParams params;
  memset(&params, 0, sizeof(params));
  params.type = CU_GRAPH_NODE_TYPE_CONDITIONAL;
  params.conditional.handle = (CUgraphConditionalHandle)handle_of(handle);
  params.conditional.type =
      kind == 1 ? CU_GRAPH_COND_TYPE_WHILE : CU_GRAPH_COND_TYPE_IF;
  params.conditional.size = (unsigned int)size;
  params.conditional.ctx = ctx;
  CUgraphNode node;
  r = GC_ADD_NODE(&node, graph, deps, n, &params);
  if (r != CUDA_SUCCESS) return (int)r;
  for (int i = 0; i < size; ++i)
    ((CUgraph*)bodies_out)[i] = params.conditional.phGraph_out[i];
  r = GC_UPDATE_DEPS((CUstream)stream, &node, 1,
                     CU_STREAM_SET_CAPTURE_DEPENDENCIES);
  return (int)r;
}

// Capture `stream` into the body graph `body` ("thread_local" mode, as
// PyTorch's capture of the fused path), until gc_end_body.
extern "C" int gc_begin_body(void* stream, void* body) {
  return (int)cuStreamBeginCaptureToGraph(
      (CUstream)stream, (CUgraph)body, nullptr, nullptr, 0,
      CU_STREAM_CAPTURE_MODE_THREAD_LOCAL);
}

extern "C" int gc_end_body(void* stream) {
  CUgraph graph;
  return (int)cuStreamEndCapture((CUstream)stream, &graph);
}

// A stream of its own for capturing bodies, into the host word at
// `stream_out` (never one of PyTorch's pooled streams, which a capture
// may already be using).
extern "C" int gc_stream_create(void* stream_out) {
  CUstream s;
  CUresult r = cuStreamCreate(&s, CU_STREAM_NON_BLOCKING);
  if (r != CUDA_SUCCESS) return (int)r;
  *(CUstream*)stream_out = s;
  return 0;
}

// The nodes of `graph` by type into the host ints counts_out[0..15]
// (CUgraphNodeType), into counts_out[16] the memcpy nodes that touch host
// memory or an array and into counts_out[17] the edges of another than
// the default type: what a conditional node's body may not hold.
extern "C" int gc_node_types(void* graph, void* counts_out) {
  int* counts = (int*)counts_out;
  for (int i = 0; i < 18; ++i) counts[i] = 0;
  size_t n = 0;
  CUresult r = GC_GET_EDGES((CUgraph)graph, nullptr, nullptr, nullptr, &n);
  if (r != CUDA_SUCCESS) return (int)r;
  if (n > 0) {
    CUgraphNode* from = new CUgraphNode[n];
    CUgraphNode* to = new CUgraphNode[n];
    CUgraphEdgeData* data = new CUgraphEdgeData[n];
    r = GC_GET_EDGES((CUgraph)graph, from, to, data, &n);
    for (size_t i = 0; r == CUDA_SUCCESS && i < n; ++i)
      if (data[i].type != CU_GRAPH_DEPENDENCY_TYPE_DEFAULT ||
          data[i].from_port != 0 || data[i].to_port != 0)
        counts[17] += 1;
    delete[] from;
    delete[] to;
    delete[] data;
    if (r != CUDA_SUCCESS) return (int)r;
  }
  n = 0;
  r = cuGraphGetNodes((CUgraph)graph, nullptr, &n);
  if (r != CUDA_SUCCESS || n == 0) return (int)r;
  CUgraphNode* nodes = new CUgraphNode[n];
  r = cuGraphGetNodes((CUgraph)graph, nodes, &n);
  for (size_t i = 0; r == CUDA_SUCCESS && i < n; ++i) {
    CUgraphNodeType t;
    r = cuGraphNodeGetType(nodes[i], &t);
    if (r != CUDA_SUCCESS) break;
    if ((int)t >= 0 && (int)t < 16) counts[(int)t] += 1;
    if (t == CU_GRAPH_NODE_TYPE_MEMCPY) {
      CUDA_MEMCPY3D p;
      r = cuGraphMemcpyNodeGetParams(nodes[i], &p);
      if (r != CUDA_SUCCESS) break;
      if (p.srcMemoryType == CU_MEMORYTYPE_HOST ||
          p.dstMemoryType == CU_MEMORYTYPE_HOST ||
          p.srcMemoryType == CU_MEMORYTYPE_ARRAY ||
          p.dstMemoryType == CU_MEMORYTYPE_ARRAY)
        counts[16] += 1;
    }
  }
  delete[] nodes;
  return (int)r;
}

// The setter launches run so far (gc_launch_count), into the host word at
// `out`; waits for the work queued before it on the legacy stream only,
// so the caller synchronizes the device first.
extern "C" int gc_launches(void* out) {
  return (int)cudaMemcpyFromSymbol(out, gc_launch_count,
                                   sizeof(unsigned long long));
}

// The driver's CUDA version (e.g. 12080), into the host int at `out`.
extern "C" int gc_driver_version(void* out) {
  return (int)cuDriverGetVersion((int*)out);
}
