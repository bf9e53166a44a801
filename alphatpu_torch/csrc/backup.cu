// backup: the f32 per-edge backup adds of recorded rollout paths.
//
// Replaces the TPU kernel alphatpu/mcts/pallas_kernels.py:backup_pallas
// (_backup_kernel -> _backup_edges).  For every game and every recorded
// path edge (node >= 0) at depth d: wsum += contrib, visits += 1, where
// contrib is 1 - value on the leaf edge and every second edge above it and
// value on the others.  The search runs it once per move, as the flush of
// the last rollout's pending update, and the per-phase search
// (search.backup) once per rollout.
//
// What bounds it on Hopper: bytes, and few of them - the [D, G] path
// (D x G x 4 B, read whole to find the edges) and two f32
// read-modify-writes per recorded edge: under 2 MB at connect4's shape,
// about half a microsecond at 3.35 TB/s, so the launch itself dominates.
// The design: one thread per (depth, game), the depth on the grid's y
// axis (no division), the game on x, so a warp reads 32 neighbouring words
// of the path.  A thread whose depth holds no edge exits after that one
// load; the others do their edge's two adds.  A path's edges are distinct
// tree edges, so no two threads write the same word: no atomics and no
// loop over D.  The TPU kernel copied whole [A, V, Gb] blocks through VMEM
// and masked 8-row chunks.
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBackupThreads = 256;  // most threads a block of backup

__global__ void __launch_bounds__(kBackupThreads) backup_kernel(
    float* __restrict__ wsum, float* __restrict__ visits,
    const int32_t* __restrict__ nodes, const int32_t* __restrict__ actions,
    const int32_t* __restrict__ length, const float* __restrict__ value,
    int V, int G) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const int d = blockIdx.y;
  const size_t gs = static_cast<size_t>(G);
  const size_t e = static_cast<size_t>(d) * gs + g;
  const int node = nodes[e];
  if (node < 0) return;
  const int k = length[g] - 1 - d;
  const float v = value[g];
  const float contrib = (k % 2 == 0) ? 1.0f - v : v;
  const size_t i = static_cast<size_t>(actions[e]) * V * gs +
                   static_cast<size_t>(node) * gs + g;
  wsum[i] = wsum[i] + contrib;
  visits[i] = visits[i] + 1.0f;
}

}  // namespace

// threads, blocks: the launch geometry along the games
// (alphatpu_torch.mcts.kernels.backup_geometry); the grid's y axis is D.
extern "C" int launch_backup(void* wsum, void* visits, const void* nodes,
                             const void* actions, const void* length,
                             const void* value, int A, int V, int G, int D,
                             int threads, int blocks, void* stream) {
  if (A < 1 || V < 1 || G < 1 || D < 1 || D > 65535 || threads < 32 ||
      threads > kBackupThreads || threads % 32 != 0 ||
      static_cast<long long>(blocks) * threads < G)
    return static_cast<int>(cudaErrorInvalidValue);
  backup_kernel<<<dim3(blocks, D), threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(wsum), static_cast<float*>(visits),
      static_cast<const int32_t*>(nodes), static_cast<const int32_t*>(actions),
      static_cast<const int32_t*>(length), static_cast<const float*>(value), V,
      G);
  return static_cast<int>(cudaGetLastError());
}
