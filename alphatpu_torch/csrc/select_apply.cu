// select_apply: one MCTS rollout's tree work for every game, on three f32
// stat planes (prior, wsum, visits) - the level-0 engine, which also
// searches pre-grown trees.
//
// Replaces the TPU kernel alphatpu/mcts/pallas_kernels.py:select_apply_pallas
// (_select_apply_kernel = the pending prior-row write + _backup_edges +
// _walk).  Per game it
//   1. writes the previous rollout's pending prior row at its leaf (unless
//      the leaf is V, i.e. the tree was full),
//   2. applies the previous rollout's backup to the f32 planes: wsum +=
//      contrib, visits += 1 per recorded path edge.  The value is not
//      quantized here, so wsum lies on no grid: each edge gets one f32 add
//      per rollout, as in the plain version, and nothing is reordered or
//      contracted (-fmad=false),
//   3. walks from the root to a leaf (walk.cuh).
//
// What bounds it on Hopper: scattered loads, as for select_apply_packed,
// with three planes per row instead of two.  One thread per game loads only
// the rows of the nodes it visits; the games-minor layout keeps a warp's 32
// loads of a row contiguous.  The walk keeps two rows (prior, Q) of up to
// 169 floats per thread in local memory.
#include "walk.cuh"

namespace {

__global__ void __launch_bounds__(walk::kThreads) select_apply_kernel(
    float* __restrict__ prior, float* __restrict__ wsum,
    float* __restrict__ visits, const int32_t* __restrict__ parent,
    const int32_t* __restrict__ action_from, const bool* __restrict__ expanded,
    const float* __restrict__ probs, const int32_t* __restrict__ pu_nodes,
    const int32_t* __restrict__ pu_actions,
    const int32_t* __restrict__ pu_length, const float* __restrict__ pu_value,
    const int32_t* __restrict__ pu_leaf, const float* __restrict__ pu_newp,
    const bool* __restrict__ pu_write, int32_t* __restrict__ nodes_out,
    int32_t* __restrict__ actions_out, int32_t* __restrict__ leaf_out,
    int32_t* __restrict__ laction_out, bool* __restrict__ alloc_out,
    float* __restrict__ rootpi_out, int A, int V, int G, int D, float cpuct) {
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

  // 2. pending backup adds
  walk::add_path_f32(wsum, visits, pu_nodes, pu_actions, pu_length[g],
                     pu_value[g], V, G, D, g);

  // 3. the walk
  const walk::F32Rows rows{prior, wsum, visits};
  walk::walk_game(rows, parent, action_from, expanded, probs, nodes_out,
                  actions_out, leaf_out, laction_out, alloc_out, rootpi_out, A,
                  V, G, D, cpuct, g);
}

}  // namespace

extern "C" int launch_select_apply(
    void* prior, void* wsum, void* visits, const void* parent,
    const void* action_from, const void* expanded, const void* probs,
    const void* pu_nodes, const void* pu_actions, const void* pu_length,
    const void* pu_value, const void* pu_leaf, const void* pu_newp,
    const void* pu_write, void* nodes_out, void* actions_out, void* leaf_out,
    void* laction_out, void* alloc_out, void* rootpi_out, int A, int V, int G,
    int D, float cpuct, void* stream) {
  if (A < 1 || A > walk::kMaxActions || V < 1 || G < 1 || D < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  select_apply_kernel<<<walk::blocks_for(G), walk::kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(prior), static_cast<float*>(wsum),
      static_cast<float*>(visits), static_cast<const int32_t*>(parent),
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
      D, cpuct);
  return static_cast<int>(cudaGetLastError());
}
