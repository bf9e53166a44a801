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
//   3. walks from the root to a leaf (walk.cuh, walk_group).
//
// What bounds it on Hopper: bytes.  Per game the walk must read the
// parent and action_from columns (V x 8 B) to find each child, A x 8 B of
// prior and packed stats per node it visits (about 3 at connect4's
// shape), and write the path (D x 8 B) and the root policy (A x 4 B); the
// apply phase reads the pending path (D x 4 B) and adds to a few words.
// At A=7, V=64, G=8192, D=42 that is about 11 MB, 3.3 us at 3.35 TB/s
// (alphatpu_torch/mcts/bounds.py counts it per call); the Newton arithmetic
// is far below the f32 peak.  What the card actually waits on is latency:
// each step of a walk depends on the last (a node's row, its policy, the
// sampled child), and the kernel ends with its slowest game.
//
// The design, for that: K lanes of a warp per game (K the next power of
// two of A, at most 32; the wrapper's walk_geometry picks it and the block
// size so that every SM gets blocks): 8 lanes at connect4, 32 at A >= 17,
// 65,536 threads at both 8192 x A=7 and 2048 x A=169.  Each lane keeps its
// ceil(A / K) actions of the row in registers (S is a template parameter:
// no row array lives in local memory) and does their divisions; the order-
// sensitive sums fold in action order across the lanes, so the kernel
// stays bit for bit equal to its plain version.  The game's parent and
// action_from columns are copied into shared memory (cp.async) at the
// start, behind the apply phase, which the lanes split: prior-row entries
// and path depths.  Where one warp's games' columns do not fit a block
// (from V = 7,249 at connect4's A=7), a second instantiation of each
// <K, S> reads them from device memory (the device placement); the shared
// one keeps its own lookup.  Tensor cores and TMA have no role: there is
// no matrix product, and each game's rows are scattered words chosen by
// the walk.
#include "walk.cuh"

namespace {

struct Args {
  float* prior;
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
  int scale;
};

template <int K, int S, class Cols>
__global__ void __launch_bounds__(walk::kGroupThreads)
    select_apply_packed_kernel(const Args x) {
  extern __shared__ int32_t columns[];
  const walk::Group<K> grp;
  const int g = grp.game();
  if (g >= x.G) return;  // the whole group: its lanes share g
  const int j = grp.j;
  const size_t gs = static_cast<size_t>(x.G);
  const size_t vg = static_cast<size_t>(x.V) * gs;
  const Cols cols = walk::placed_columns<Cols>(grp, columns, x.parent,
                                               x.action_from, x.V, x.G, g);

  // 1. pending prior-row write: lane j takes actions j, j + K, ...
  const int pleaf = walk::pending_row_node(x.pu_write, x.pu_leaf, x.V, g);
  if (pleaf >= 0) {
    const size_t row = static_cast<size_t>(pleaf) * gs + g;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int a = s * K + j;
      if (a < x.A) x.prior[a * vg + row] = x.pu_newp[a * gs + g];
    }
  }
  // 2. pending backup adds at the wsum half's offset 16
  walk::add_packed_path<K>(x.packed, x.pu_nodes, x.pu_actions,
                           x.pu_length[g], x.pu_value[g],
                           static_cast<float>(x.scale), 16, x.V, x.G, x.D, g,
                           j);
  // every word a game touches is its own: the group's barrier orders the
  // writes above before the walk's reads
  __syncwarp(grp.mask);

  // 3. the walk
  const walk::PackedRows rows{x.prior, x.packed,
                              1.0f / static_cast<float>(x.scale)};
  walk::walk_group<K, S>(grp, rows, cols, x.expanded, x.probs, x.nodes_out,
                         x.actions_out, x.leaf_out, x.laction_out,
                         x.alloc_out, x.rootpi_out, x.A, x.V, x.G, x.D,
                         x.cpuct, g);
}

struct SelectApplyPacked {
  template <int K, int S>
  static auto fn(int placement) {
    return placement == walk::kDeviceColumns
               ? select_apply_packed_kernel<K, S, walk::DeviceColumns>
               : select_apply_packed_kernel<K, S, walk::SharedColumns>;
  }
};

}  // namespace

// lanes, slots, threads, blocks, smem, placement: the launch geometry
// (alphatpu_torch.mcts.kernels.walk_geometry); walk::launch_group refuses
// a geometry it has no instantiation for.
extern "C" int launch_select_apply_packed(
    void* prior, void* packed, const void* parent, const void* action_from,
    const void* expanded, const void* probs, const void* pu_nodes,
    const void* pu_actions, const void* pu_length, const void* pu_value,
    const void* pu_leaf, const void* pu_newp, const void* pu_write,
    void* nodes_out, void* actions_out, void* leaf_out, void* laction_out,
    void* alloc_out, void* rootpi_out, int A, int V, int G, int D, float cpuct,
    int scale, int lanes, int slots, int threads, int blocks, int smem,
    int placement, void* stream) {
  if (scale < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Args x{
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
      D, cpuct, scale};
  return walk::launch_group<SelectApplyPacked>(
      {lanes, slots, threads, blocks, smem, placement}, x, stream);
}
