// backup: the f32 per-edge backup adds of recorded rollout paths.
//
// Replaces the TPU kernel alphatpu/mcts/pallas_kernels.py:backup_pallas
// (_backup_kernel -> _backup_edges).  For every game and every recorded
// path edge (node >= 0) at depth d: wsum += contrib, visits += 1, where
// contrib is 1 - value on the leaf edge and every second edge above it and
// value on the others (walk.cuh, add_path_f32).  The search runs it once
// per move, as the flush of the last rollout's pending update, and the
// per-phase search (search.backup) once per rollout.
//
// What bounds it on Hopper: a handful of scattered read-modify-writes per
// game (path length x 2 planes); the launch itself dominates.  The TPU
// kernel copied whole [A, V, Gb] blocks through VMEM and masked 8-row chunks;
// here one thread per game touches only its own path edges.
#include "walk.cuh"

namespace {

__global__ void __launch_bounds__(walk::kThreads) backup_kernel(
    float* __restrict__ wsum, float* __restrict__ visits,
    const int32_t* __restrict__ nodes, const int32_t* __restrict__ actions,
    const int32_t* __restrict__ length, const float* __restrict__ value,
    int V, int G, int D) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  walk::add_path_f32(wsum, visits, nodes, actions, length[g], value[g], V, G,
                     D, g);
}

}  // namespace

extern "C" int launch_backup(void* wsum, void* visits, const void* nodes,
                             const void* actions, const void* length,
                             const void* value, int A, int V, int G, int D,
                             void* stream) {
  if (A < 1 || V < 1 || G < 1 || D < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  backup_kernel<<<walk::blocks_for(G), walk::kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(wsum), static_cast<float*>(visits),
      static_cast<const int32_t*>(nodes), static_cast<const int32_t*>(actions),
      static_cast<const int32_t*>(length), static_cast<const float*>(value), V,
      G, D);
  return static_cast<int>(cudaGetLastError());
}
