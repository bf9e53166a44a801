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
//   3. walks from the root to a leaf (walk.cuh, walk_group), unpacking each
//      word into prior, wsum and visits.  The reference peels depth 0 (all
//      lanes at the root); this walk does not, and gives the same results.
//
// What bounds it on Hopper: bytes, as for select_apply_packed, with one
// word per row entry (4 B per action) instead of two; what the card waits
// on is each walk's chain of dependent steps.  The design is that of
// select_apply_packed.cu: K lanes of a warp per game, each holding
// ceil(A / K) actions of the row in registers, the order-sensitive sums
// folded in action order across the lanes (bit for bit equal to the plain
// version), the apply phase split across the lanes (whole words of the
// prior row, path depths) while the game's parent and action_from columns
// are copied into shared memory - or, where one warp's games' columns do
// not fit a block, read from device memory by a second instantiation of
// each <K, S> (the device placement).
#include "walk.cuh"

namespace {

struct Args {
  uint32_t* packed;
  const int32_t* parent;
  const int32_t* action_from;
  const bool* expanded;
  const float* probs;
  const int32_t* pu_nodes;
  const int32_t* pu_actions;
  const int32_t* pu_length;
  const float* pu_value;
  const int32_t* pu_leaf;
  const float* pu_newp;
  const bool* pu_write;
  int32_t* nodes_out;
  int32_t* actions_out;
  int32_t* leaf_out;
  int32_t* laction_out;
  bool* alloc_out;
  float* rootpi_out;
  int A, V, G, D;
  float cpuct;
  int bits_v, bits_w, scale;
};

template <int K, int S, class Cols>
__global__ void __launch_bounds__(walk::kGroupThreads)
    select_apply_packed1_kernel(const Args x) {
  extern __shared__ int32_t columns[];
  const walk::Group<K> grp;
  const int g = grp.game();
  if (g >= x.G) return;  // the whole group: its lanes share g
  const int j = grp.j;
  const size_t gs = static_cast<size_t>(x.G);
  const size_t vg = static_cast<size_t>(x.V) * gs;
  const Cols cols = walk::placed_columns<Cols>(grp, columns, x.parent,
                                               x.action_from, x.V, x.G, g);

  // 1. pending prior-row write, the whole word with zero stats: lane j
  // takes actions j, j + K, ...
  const int pleaf = walk::pending_row_node(x.pu_write, x.pu_leaf, x.V, g);
  if (pleaf >= 0) {
    const size_t row = static_cast<size_t>(pleaf) * gs + g;
    const int pshift = x.bits_v + x.bits_w;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int a = s * K + j;
      if (a < x.A) {
        const float q =
            fminf(rintf(x.pu_newp[a * gs + g] * 2048.0f), 2047.0f);
        x.packed[a * vg + row] =
            static_cast<uint32_t>(static_cast<int32_t>(q)) << pshift;
      }
    }
  }
  // 2. pending backup adds at the wsum field's offset bits_v
  const float fscale = static_cast<float>(x.scale);
  walk::add_packed_path<K>(x.packed, x.pu_nodes, x.pu_actions,
                           x.pu_length[g], x.pu_value[g], fscale, x.bits_v,
                           x.V, x.G, x.D, g, j);
  // every word a game touches is its own: the group's barrier orders the
  // writes above before the walk's reads
  __syncwarp(grp.mask);

  // 3. the walk
  const walk::Packed1Rows rows{x.packed, x.bits_v, x.bits_w, 1.0f / fscale};
  walk::walk_group<K, S>(grp, rows, cols, x.expanded, x.probs, x.nodes_out,
                         x.actions_out, x.leaf_out, x.laction_out,
                         x.alloc_out, x.rootpi_out, x.A, x.V, x.G, x.D,
                         x.cpuct, g);
}

struct SelectApplyPacked1 {
  template <int K, int S>
  static auto fn(int placement) {
    return placement == walk::kDeviceColumns
               ? select_apply_packed1_kernel<K, S, walk::DeviceColumns>
               : select_apply_packed1_kernel<K, S, walk::SharedColumns>;
  }
};

}  // namespace

// bits_v, bits_w, scale: the 1-plane layout (kernels.packed1_layout);
// lanes, slots, threads, blocks, smem, placement: the launch geometry
// (alphatpu_torch.mcts.kernels.walk_geometry); walk::launch_group refuses
// a geometry it has no instantiation for.
extern "C" int launch_select_apply_packed1(
    void* packed, const void* parent, const void* action_from,
    const void* expanded, const void* probs, const void* pu_nodes,
    const void* pu_actions, const void* pu_length, const void* pu_value,
    const void* pu_leaf, const void* pu_newp, const void* pu_write,
    void* nodes_out, void* actions_out, void* leaf_out, void* laction_out,
    void* alloc_out, void* rootpi_out, int A, int V, int G, int D, float cpuct,
    int bits_v, int bits_w, int scale, int lanes, int slots, int threads,
    int blocks, int smem, int placement, void* stream) {
  if (scale < 1 || bits_v < 1 || bits_w < 1 || bits_v + bits_w != 21)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args x{
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
      D, cpuct, bits_v, bits_w, scale};
  return walk::launch_group<SelectApplyPacked1>(
      {lanes, slots, threads, blocks, smem, placement}, x, stream);
}
