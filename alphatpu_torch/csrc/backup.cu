// backup: the per-edge backup adds of recorded rollout paths, on f32 stat
// planes or, under ALPHATPU_BF16_STATS, on bf16 ones.
//
// Replaces the TPU kernel alphatpu/mcts/pallas_kernels.py:backup_pallas
// (_backup_kernel -> _backup_edges), in both of its storage dtypes.  For
// every game and every recorded path edge (node >= 0) at depth d: wsum +=
// contrib, visits += 1, where contrib is 1 - value on the leaf edge and
// every second edge above it and value on the others; each add runs in f32
// and is rounded once to the storage type (an element is stored whole, 2 B
// in bf16: neighbouring games' halves of a word stay apart).  The search
// runs it once per move, as the flush of the last rollout's pending
// update, and the per-phase search (search.backup) once per rollout.
//
// What bounds it on Hopper: bytes, and few of them - the [D, G] path
// (D x G x 4 B, read whole to find the edges) and two read-modify-writes
// per recorded edge (4 B each in f32, 2 B in bf16): under 2 MB at
// connect4's shape, about half a microsecond at 3.35 TB/s, so the launch
// itself dominates.
// The design: one thread per (depth, game), the depth on the grid's y
// axis (no division), the game on x, so a warp reads 32 neighbouring words
// of the path.  A thread whose depth holds no edge exits after that one
// load; the others do their edge's two adds.  A path's edges are distinct
// tree edges, so no two threads write the same element: no atomics and no
// loop over D.  The TPU kernel copied whole [A, V, Gb] blocks through VMEM
// and masked 8-row chunks.
#include "walk.cuh"

namespace {

constexpr int kBackupThreads = 256;  // most threads a block of backup

template <class T>
__global__ void __launch_bounds__(kBackupThreads) backup_kernel(
    T* __restrict__ wsum, T* __restrict__ visits,
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
  wsum[i] = walk::stat_from_f32<T>(walk::stat_to_f32(wsum[i]) + contrib);
  visits[i] = walk::stat_from_f32<T>(walk::stat_to_f32(visits[i]) + 1.0f);
}

template <class T>
int launch(void* wsum, void* visits, const void* nodes, const void* actions,
           const void* length, const void* value, int A, int V, int G, int D,
           int threads, int blocks, void* stream) {
  if (A < 1 || V < 1 || G < 1 || D < 1 || D > 65535 || threads < 32 ||
      threads > kBackupThreads || threads % 32 != 0 ||
      static_cast<long long>(blocks) * threads < G)
    return static_cast<int>(cudaErrorInvalidValue);
  backup_kernel<T><<<dim3(blocks, D), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(wsum), static_cast<T*>(visits),
      static_cast<const int32_t*>(nodes), static_cast<const int32_t*>(actions),
      static_cast<const int32_t*>(length), static_cast<const float*>(value), V,
      G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// threads, blocks: the launch geometry along the games
// (alphatpu_torch.mcts.kernels.backup_geometry); the grid's y axis is D.
// One entry per storage type: f32 planes, and bf16 planes
// (launch_backup_bf16).
extern "C" int launch_backup(void* wsum, void* visits, const void* nodes,
                             const void* actions, const void* length,
                             const void* value, int A, int V, int G, int D,
                             int threads, int blocks, void* stream) {
  return launch<float>(wsum, visits, nodes, actions, length, value, A, V, G,
                       D, threads, blocks, stream);
}

extern "C" int launch_backup_bf16(void* wsum, void* visits,
                                  const void* nodes, const void* actions,
                                  const void* length, const void* value,
                                  int A, int V, int G, int D, int threads,
                                  int blocks, void* stream) {
  return launch<__nv_bfloat16>(wsum, visits, nodes, actions, length, value,
                               A, V, G, D, threads, blocks, stream);
}
