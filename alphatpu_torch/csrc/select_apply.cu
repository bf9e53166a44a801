// select_apply: one MCTS rollout's tree work for every game, on three stat
// planes (prior, wsum, visits) of f32, or of bf16 under ALPHATPU_BF16_STATS
// - the level-0 engine, which also searches pre-grown trees and every bf16
// tree.
//
// Replaces the TPU kernel alphatpu/mcts/pallas_kernels.py:select_apply_pallas
// (_select_apply_kernel = the pending prior-row write + _backup_edges +
// _walk), in both of its storage dtypes.  Per game it
//   1. writes the previous rollout's pending prior row at its leaf (unless
//      the leaf is V, i.e. the tree was full), each entry rounded once to
//      the storage type,
//   2. applies the previous rollout's backup to the planes: wsum +=
//      contrib, visits += 1 per recorded path edge, each add in f32 and
//      rounded once to the storage type.  The value is not quantized here,
//      so wsum lies on no grid: each edge gets one add per rollout, as in
//      the plain version, and nothing is reordered or contracted
//      (-fmad=false),
//   3. walks from the root to a leaf (walk.cuh, walk_group), every load
//      widened to f32 (walk::StatRows), so the walk is the same
//      instruction stream for either storage.
//
// What bounds it on Hopper: bytes, as for select_apply_packed, with three
// planes per row (12 B per action in f32, 6 B in bf16) instead of two;
// what the card waits on is each walk's chain of dependent steps.  The
// design is that of select_apply_packed.cu: K lanes of a warp per game,
// each holding ceil(A / K) actions of the row in registers, the
// order-sensitive sums folded in action order across the lanes (bit for
// bit equal to the plain version), the apply phase split across the lanes
// (prior-row entries and path depths) while the game's parent and
// action_from columns are copied into shared memory.  This engine searches
// trees of any size, so where the columns do not fit a block the lookup
// reads them from device memory (the device placement;
// walk::group_columns).
#include "walk.cuh"

namespace {

template <class T>
struct Args {
  T* prior;
  T* wsum;
  T* visits;
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
  int placement;
};

// The pending backup adds on the planes, lane j taking depths j, j + K,
// ...: per edge wsum += contrib, visits += 1, in f32 and rounded once to
// T (unrolled, so that the path loads issue together).
template <class T, int K>
__device__ __forceinline__ void add_path_lanes(
    T* __restrict__ wsum, T* __restrict__ visits,
    const int32_t* __restrict__ nodes, const int32_t* __restrict__ actions,
    int len, float value, int V, int G, int D, int g, int j) {
  const size_t gs = static_cast<size_t>(G);
  const size_t vg = static_cast<size_t>(V) * gs;
#pragma unroll 4
  for (int d = j; d < D; d += K) {
    const int node = nodes[d * gs + g];
    if (node < 0) continue;
    const int k = len - 1 - d;
    const float contrib = (k % 2 == 0) ? 1.0f - value : value;
    const size_t i = static_cast<size_t>(actions[d * gs + g]) * vg +
                     static_cast<size_t>(node) * gs + g;
    wsum[i] = walk::stat_from_f32<T>(walk::stat_to_f32(wsum[i]) + contrib);
    visits[i] = walk::stat_from_f32<T>(walk::stat_to_f32(visits[i]) + 1.0f);
  }
}

template <int K, int S, class T>
__global__ void __launch_bounds__(walk::kGroupThreads)
    select_apply_kernel(const Args<T> x) {
  extern __shared__ int32_t columns[];
  const walk::Group<K> grp;
  const int g = grp.game();
  if (g >= x.G) return;  // the whole group: its lanes share g
  const int j = grp.j;
  const size_t gs = static_cast<size_t>(x.G);
  const size_t vg = static_cast<size_t>(x.V) * gs;
  const walk::Columns cols =
      walk::group_columns(grp, columns, x.placement, x.parent, x.action_from,
                          x.V, x.G, g);

  // 1. pending prior-row write: lane j takes actions j, j + K, ...
  const int pleaf = walk::pending_row_node(x.pu_write, x.pu_leaf, x.V, g);
  if (pleaf >= 0) {
    const size_t row = static_cast<size_t>(pleaf) * gs + g;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int a = s * K + j;
      if (a < x.A)
        x.prior[a * vg + row] = walk::stat_from_f32<T>(x.pu_newp[a * gs + g]);
    }
  }
  // 2. pending backup adds
  add_path_lanes<T, K>(x.wsum, x.visits, x.pu_nodes, x.pu_actions,
                       x.pu_length[g], x.pu_value[g], x.V, x.G, x.D, g, j);
  // every element a game touches is its own, and is stored whole - 4 B in
  // f32, 2 B in bf16, never as part of a wider read-modify-write: in a
  // bf16 plane games g and g + 1 share a 32-bit word and are walked by
  // different groups, and byte-granular stores keep their halves apart.
  // The group's barrier orders the writes above (to the prior plane and
  // to the two stat planes) before the walk's reads.
  __syncwarp(grp.mask);

  // 3. the walk
  const walk::StatRows<T> rows{x.prior, x.wsum, x.visits};
  walk::walk_group<K, S>(grp, rows, cols, x.expanded, x.probs, x.nodes_out,
                         x.actions_out, x.leaf_out, x.laction_out,
                         x.alloc_out, x.rootpi_out, x.A, x.V, x.G, x.D,
                         x.cpuct, g);
}

template <class T>
struct SelectApply {
  template <int K, int S>
  static auto fn(int) {  // either placement: Args.placement picks
    return select_apply_kernel<K, S, T>;
  }
};

template <class T>
int launch(void* prior, void* wsum, void* visits, const void* parent,
           const void* action_from, const void* expanded, const void* probs,
           const void* pu_nodes, const void* pu_actions,
           const void* pu_length, const void* pu_value, const void* pu_leaf,
           const void* pu_newp, const void* pu_write, void* nodes_out,
           void* actions_out, void* leaf_out, void* laction_out,
           void* alloc_out, void* rootpi_out, int A, int V, int G, int D,
           float cpuct, const walk::Geometry& geo, void* stream) {
  const Args<T> x{
      static_cast<T*>(prior), static_cast<T*>(wsum), static_cast<T*>(visits),
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
      D, cpuct, geo.placement};
  return walk::launch_group<SelectApply<T>>(geo, x, stream);
}

}  // namespace

// lanes, slots, threads, blocks, smem, placement: the launch geometry
// (alphatpu_torch.mcts.kernels.walk_geometry); walk::launch_group refuses
// a geometry it has no instantiation for.  One entry per storage type:
// f32 planes, and bf16 planes (launch_select_apply_bf16).
extern "C" int launch_select_apply(
    void* prior, void* wsum, void* visits, const void* parent,
    const void* action_from, const void* expanded, const void* probs,
    const void* pu_nodes, const void* pu_actions, const void* pu_length,
    const void* pu_value, const void* pu_leaf, const void* pu_newp,
    const void* pu_write, void* nodes_out, void* actions_out, void* leaf_out,
    void* laction_out, void* alloc_out, void* rootpi_out, int A, int V, int G,
    int D, float cpuct, int lanes, int slots, int threads, int blocks,
    int smem, int placement, void* stream) {
  return launch<float>(
      prior, wsum, visits, parent, action_from, expanded, probs, pu_nodes,
      pu_actions, pu_length, pu_value, pu_leaf, pu_newp, pu_write, nodes_out,
      actions_out, leaf_out, laction_out, alloc_out, rootpi_out, A, V, G, D,
      cpuct, {lanes, slots, threads, blocks, smem, placement}, stream);
}

extern "C" int launch_select_apply_bf16(
    void* prior, void* wsum, void* visits, const void* parent,
    const void* action_from, const void* expanded, const void* probs,
    const void* pu_nodes, const void* pu_actions, const void* pu_length,
    const void* pu_value, const void* pu_leaf, const void* pu_newp,
    const void* pu_write, void* nodes_out, void* actions_out, void* leaf_out,
    void* laction_out, void* alloc_out, void* rootpi_out, int A, int V, int G,
    int D, float cpuct, int lanes, int slots, int threads, int blocks,
    int smem, int placement, void* stream) {
  return launch<__nv_bfloat16>(
      prior, wsum, visits, parent, action_from, expanded, probs, pu_nodes,
      pu_actions, pu_length, pu_value, pu_leaf, pu_newp, pu_write, nodes_out,
      actions_out, leaf_out, laction_out, alloc_out, rootpi_out, A, V, G, D,
      cpuct, {lanes, slots, threads, blocks, smem, placement}, stream);
}
