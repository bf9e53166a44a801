// select_apply_packed1: one MCTS rollout's tree work for every game, on the
// 1-plane word [prior u11 | wsum * S1 u(bits_w) | visits u(bits_v)] - the
// level-2 engine, where the whole stat state of an edge is one 32-bit word.
//
// Replaces the TPU kernel
// alphatpu/mcts/pallas_kernels.py:select_apply_packed1
// (_select_apply_packed1_kernel = the packed prior-row write +
// _backup_edges_packed at offset bits_v + _walk_packed1).  Per game it
//   1. overwrites the words of the previous rollout's pending leaf row with
//      a fresh row: the prior quantized to the 1/2048 grid (clamped to
//      2047/2048) in the top 11 bits, wsum and visits zero - unless the leaf
//      is V (the tree was full),
//   2. applies the previous rollout's backup: one unsigned add of
//      ((contrib * S1) << bits_v) + 1 per recorded path edge.  A fresh
//      search's sums fit the wsum field (R * S1 < 2**bits_w), so no add
//      carries into the prior field,
//   3. walks from the root to a leaf (walk.cuh), unpacking each word into
//      prior, wsum and visits.  The reference peels depth 0 (all lanes at
//      the root); this walk does not, and gives the same results.
//
// What bounds it on Hopper: scattered loads, one word per action per depth
// (half the stat bytes of the level-1 walk), plus V words each of parent and
// action_from.  One thread per game, games minor, no synchronisation.
#include "walk.cuh"

namespace {

__global__ void __launch_bounds__(walk::kThreads) select_apply_packed1_kernel(
    uint32_t* __restrict__ packed, const int32_t* __restrict__ parent,
    const int32_t* __restrict__ action_from, const bool* __restrict__ expanded,
    const float* __restrict__ probs, const int32_t* __restrict__ pu_nodes,
    const int32_t* __restrict__ pu_actions,
    const int32_t* __restrict__ pu_length, const float* __restrict__ pu_value,
    const int32_t* __restrict__ pu_leaf, const float* __restrict__ pu_newp,
    const bool* __restrict__ pu_write, int32_t* __restrict__ nodes_out,
    int32_t* __restrict__ actions_out, int32_t* __restrict__ leaf_out,
    int32_t* __restrict__ laction_out, bool* __restrict__ alloc_out,
    float* __restrict__ rootpi_out, int A, int V, int G, int D, float cpuct,
    int bits_v, int bits_w, int scale) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const size_t gs = static_cast<size_t>(G);
  const size_t vg = static_cast<size_t>(V) * gs;

  // 1. pending prior-row write: the whole word, stats zero
  const int pleaf = walk::pending_row_node(pu_write, pu_leaf, V, g);
  if (pleaf >= 0) {
    const size_t row = static_cast<size_t>(pleaf) * gs + g;
    for (int a = 0; a < A; ++a) {
      const float q = fminf(rintf(pu_newp[a * gs + g] * 2048.0f), 2047.0f);
      packed[a * vg + row] = static_cast<uint32_t>(static_cast<int32_t>(q))
                             << (bits_v + bits_w);
    }
  }

  // 2. pending backup adds at the wsum field's offset bits_v
  const float fscale = static_cast<float>(scale);
  walk::add_path_packed(packed, pu_nodes, pu_actions, pu_length[g],
                        pu_value[g], fscale, bits_v, V, G, D, g);

  // 3. the walk
  const walk::Packed1Rows rows{packed, bits_v, bits_w, 1.0f / fscale};
  walk::walk_game(rows, parent, action_from, expanded, probs, nodes_out,
                  actions_out, leaf_out, laction_out, alloc_out, rootpi_out, A,
                  V, G, D, cpuct, g);
}

}  // namespace

extern "C" int launch_select_apply_packed1(
    void* packed, const void* parent, const void* action_from,
    const void* expanded, const void* probs, const void* pu_nodes,
    const void* pu_actions, const void* pu_length, const void* pu_value,
    const void* pu_leaf, const void* pu_newp, const void* pu_write,
    void* nodes_out, void* actions_out, void* leaf_out, void* laction_out,
    void* alloc_out, void* rootpi_out, int A, int V, int G, int D, float cpuct,
    int bits_v, int bits_w, int scale, void* stream) {
  if (A < 1 || A > walk::kMaxActions || V < 1 || G < 1 || D < 1 ||
      scale < 1 || bits_v < 1 || bits_w < 1 || bits_v + bits_w != 21)
    return static_cast<int>(cudaErrorInvalidValue);
  select_apply_packed1_kernel<<<walk::blocks_for(G), walk::kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(packed), static_cast<const int32_t*>(parent),
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
      D, cpuct, bits_v, bits_w, scale);
  return static_cast<int>(cudaGetLastError());
}
