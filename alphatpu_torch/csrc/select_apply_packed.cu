// select_apply_packed: one MCTS rollout's tree work for every game, on the
// packed (wsum | visits) plane - the level-1 engine.
//
// Replaces the TPU kernel alphatpu/mcts/pallas_kernels.py:select_apply_packed
// (_select_apply_packed_kernel = _backup_edges_packed + _walk_packed).  Per
// game it
//   1. writes the previous rollout's pending prior row at its leaf (unless
//      the leaf is V, i.e. the tree was full),
//   2. applies the previous rollout's backup to the packed plane: one
//      integer add of ((contrib * S) << 16) | 1 per recorded path edge,
//   3. walks from the root to a leaf (walk.cuh).
//
// What bounds it on Hopper: scattered loads.  A walk visits about 5 nodes;
// at each it reads 2 planes x A words of [A, V, G] stats plus V words each
// of parent and action_from, and the Newton solve works on those rows.  The
// TPU kernel streamed whole [A, V, Gb] blocks through VMEM and selected rows
// with one-hot reduces over V because it has no fast gather.  Here each game
// is one thread with its own early exit: it loads only the rows of the nodes
// it visits, and because the layout keeps games minor, the 32 threads of a
// warp read 32 neighbouring words of each row.  Games share nothing, so
// there is no synchronisation.
#include "walk.cuh"

namespace {

__global__ void __launch_bounds__(walk::kThreads) select_apply_packed_kernel(
    float* __restrict__ prior, uint32_t* __restrict__ packed,
    const int32_t* __restrict__ parent, const int32_t* __restrict__ action_from,
    const bool* __restrict__ expanded, const float* __restrict__ probs,
    const int32_t* __restrict__ pu_nodes, const int32_t* __restrict__ pu_actions,
    const int32_t* __restrict__ pu_length, const float* __restrict__ pu_value,
    const int32_t* __restrict__ pu_leaf, const float* __restrict__ pu_newp,
    const bool* __restrict__ pu_write, int32_t* __restrict__ nodes_out,
    int32_t* __restrict__ actions_out, int32_t* __restrict__ leaf_out,
    int32_t* __restrict__ laction_out, bool* __restrict__ alloc_out,
    float* __restrict__ rootpi_out, int A, int V, int G, int D, float cpuct,
    int scale) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const size_t gs = static_cast<size_t>(G);
  const size_t vg = static_cast<size_t>(V) * gs;

  // 1. pending prior-row write
  const int pleaf = walk::pending_row_node(pu_write, pu_leaf, V, g);
  if (pleaf >= 0) {
    const size_t row = static_cast<size_t>(pleaf) * gs + g;
    for (int a = 0; a < A; ++a) prior[a * vg + row] = pu_newp[a * gs + g];
  }

  // 2. pending backup adds at the wsum half's offset 16
  const float fscale = static_cast<float>(scale);
  walk::add_path_packed(packed, pu_nodes, pu_actions, pu_length[g],
                        pu_value[g], fscale, 16, V, G, D, g);

  // 3. the walk
  const walk::PackedRows rows{prior, packed, 1.0f / fscale};
  walk::walk_game(rows, parent, action_from, expanded, probs, nodes_out,
                  actions_out, leaf_out, laction_out, alloc_out, rootpi_out, A,
                  V, G, D, cpuct, g);
}

}  // namespace

extern "C" int launch_select_apply_packed(
    void* prior, void* packed, const void* parent, const void* action_from,
    const void* expanded, const void* probs, const void* pu_nodes,
    const void* pu_actions, const void* pu_length, const void* pu_value,
    const void* pu_leaf, const void* pu_newp, const void* pu_write,
    void* nodes_out, void* actions_out, void* leaf_out, void* laction_out,
    void* alloc_out, void* rootpi_out, int A, int V, int G, int D, float cpuct,
    int scale, void* stream) {
  if (A < 1 || A > walk::kMaxActions || V < 1 || G < 1 || D < 1 || scale < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  select_apply_packed_kernel<<<walk::blocks_for(G), walk::kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(prior), static_cast<uint32_t*>(packed),
      static_cast<const int32_t*>(parent),
      static_cast<const int32_t*>(action_from),
      static_cast<const bool*>(expanded), static_cast<const float*>(probs),
      static_cast<const int32_t*>(pu_nodes),
      static_cast<const int32_t*>(pu_actions),
      static_cast<const int32_t*>(pu_length),
      static_cast<const float*>(pu_value), static_cast<const int32_t*>(pu_leaf),
      static_cast<const float*>(pu_newp), static_cast<const bool*>(pu_write),
      static_cast<int32_t*>(nodes_out), static_cast<int32_t*>(actions_out),
      static_cast<int32_t*>(leaf_out), static_cast<int32_t*>(laction_out),
      static_cast<bool*>(alloc_out), static_cast<float*>(rootpi_out), A, V, G,
      D, cpuct, scale);
  return static_cast<int>(cudaGetLastError());
}
