// select: the read-only root-to-leaf walk of every game over three f32 stat
// planes (prior, wsum, visits) - the kernel behind the per-phase search
// API (alphatpu_torch.mcts.search.select).
//
// Replaces the TPU kernel alphatpu/mcts/pallas_kernels.py:select_pallas
// (_select_kernel -> _walk).  It is select_apply.cu without the apply
// phase: the same walk (walk.cuh) on the same row loader, so on planes that
// an empty pending update leaves as they are, the two return the same
// outputs bit for bit.
//
// What bounds it on Hopper: scattered loads of the rows each walk visits
// (three planes x A words per depth, plus V words each of parent and
// action_from); one thread per game, games minor, no synchronisation.
#include "walk.cuh"

namespace {

__global__ void __launch_bounds__(walk::kThreads) select_kernel(
    const float* __restrict__ prior, const float* __restrict__ wsum,
    const float* __restrict__ visits, const int32_t* __restrict__ parent,
    const int32_t* __restrict__ action_from, const bool* __restrict__ expanded,
    const float* __restrict__ probs, int32_t* __restrict__ nodes_out,
    int32_t* __restrict__ actions_out, int32_t* __restrict__ leaf_out,
    int32_t* __restrict__ laction_out, bool* __restrict__ alloc_out,
    float* __restrict__ rootpi_out, int A, int V, int G, int D, float cpuct) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const walk::F32Rows rows{prior, wsum, visits};
  walk::walk_game(rows, parent, action_from, expanded, probs, nodes_out,
                  actions_out, leaf_out, laction_out, alloc_out, rootpi_out, A,
                  V, G, D, cpuct, g);
}

}  // namespace

extern "C" int launch_select(const void* prior, const void* wsum,
                             const void* visits, const void* parent,
                             const void* action_from, const void* expanded,
                             const void* probs, void* nodes_out,
                             void* actions_out, void* leaf_out,
                             void* laction_out, void* alloc_out,
                             void* rootpi_out, int A, int V, int G, int D,
                             float cpuct, void* stream) {
  if (A < 1 || A > walk::kMaxActions || V < 1 || G < 1 || D < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  select_kernel<<<walk::blocks_for(G), walk::kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(prior), static_cast<const float*>(wsum),
      static_cast<const float*>(visits), static_cast<const int32_t*>(parent),
      static_cast<const int32_t*>(action_from),
      static_cast<const bool*>(expanded), static_cast<const float*>(probs),
      static_cast<int32_t*>(nodes_out), static_cast<int32_t*>(actions_out),
      static_cast<int32_t*>(leaf_out), static_cast<int32_t*>(laction_out),
      static_cast<bool*>(alloc_out), static_cast<float*>(rootpi_out), A, V, G,
      D, cpuct);
  return static_cast<int>(cudaGetLastError());
}
