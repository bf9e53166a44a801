// backup: the f32 per-edge backup adds of recorded rollout paths.
//
// Replaces the TPU kernel alphatpu/mcts/pallas_kernels.py:backup_pallas
// (_backup_kernel -> _backup_edges).  For every game and every recorded
// path edge (node >= 0) at depth d: wsum += contrib, visits += 1, where
// contrib is 1 - value on the leaf edge and every second edge above it and
// value on the others.  The search runs it once per move, as the flush of
// the last rollout's pending update.
//
// What bounds it on Hopper: a handful of scattered read-modify-writes per
// game (path length x 2 planes); the launch itself dominates.  The TPU
// kernel copied whole [A, V, Gb] blocks through VMEM and masked 8-row chunks;
// here one thread per game touches only its own path edges.  A path's edges
// are distinct tree edges, so no two threads - and no two steps of one
// thread - write the same word: no atomics.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) backup_kernel(
    float* __restrict__ wsum, float* __restrict__ visits,
    const int32_t* __restrict__ nodes, const int32_t* __restrict__ actions,
    const int32_t* __restrict__ length, const float* __restrict__ value,
    int V, int G, int D) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const size_t gs = static_cast<size_t>(G);
  const size_t vg = static_cast<size_t>(V) * gs;
  const int len = length[g];
  const float v = value[g];
  for (int d = 0; d < D; ++d) {
    const int node = nodes[d * gs + g];
    if (node < 0) continue;
    const int k = len - 1 - d;
    const float contrib = (k % 2 == 0) ? 1.0f - v : v;
    const size_t i = static_cast<size_t>(actions[d * gs + g]) * vg +
                     static_cast<size_t>(node) * gs + g;
    wsum[i] = wsum[i] + contrib;
    visits[i] = visits[i] + 1.0f;
  }
}

}  // namespace

extern "C" int launch_backup(void* wsum, void* visits, const void* nodes,
                             const void* actions, const void* length,
                             const void* value, int A, int V, int G, int D,
                             void* stream) {
  if (A < 1 || V < 1 || G < 1 || D < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (G + kThreads - 1) / kThreads;
  backup_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(wsum), static_cast<float*>(visits),
      static_cast<const int32_t*>(nodes), static_cast<const int32_t*>(actions),
      static_cast<const int32_t*>(length), static_cast<const float*>(value), V,
      G, D);
  return static_cast<int>(cudaGetLastError());
}
