// select: the read-only root-to-leaf walk of every game over three stat
// planes (prior, wsum, visits) of f32, or of bf16 under ALPHATPU_BF16_STATS
// - the kernel behind the per-phase search API
// (alphatpu_torch.mcts.search.select).
//
// Replaces the TPU kernel alphatpu/mcts/pallas_kernels.py:select_pallas
// (_select_kernel -> _walk), in both of its storage dtypes.  It is
// select_apply.cu without the apply phase: the same walk (walk.cuh,
// walk_group) on the same row loader (walk::StatRows, each load widened to
// f32) and the same launch geometry, so on planes that an empty pending
// update leaves as they are, the two return the same outputs bit for bit.
//
// What bounds it on Hopper: bytes - the rows each walk visits (three
// planes x A elements per depth), plus V words each of parent and
// action_from - and in practice the latency of each walk's chain.  K lanes
// of a warp per game: the game's columns are copied into shared memory
// (cp.async) while the root's row loads and its policy is solved, or, for
// a tree whose columns do not fit a block, read from device memory.
#include "walk.cuh"

namespace {

template <class T>
struct Args {
  const T* prior;
  const T* wsum;
  const T* visits;
  const int32_t* parent;
  const int32_t* action_from;
  const bool* expanded;
  const float* probs;
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

template <int K, int S, class T>
__global__ void __launch_bounds__(walk::kGroupThreads)
    select_kernel(const Args<T> x) {
  extern __shared__ int32_t columns[];
  const walk::Group<K> grp;
  const int g = grp.game();
  if (g >= x.G) return;  // the whole group: its lanes share g
  const walk::Columns cols =
      walk::group_columns(grp, columns, x.placement, x.parent, x.action_from,
                          x.V, x.G, g);
  const walk::StatRows<T> rows{x.prior, x.wsum, x.visits};
  walk::walk_group<K, S>(grp, rows, cols, x.expanded, x.probs, x.nodes_out,
                         x.actions_out, x.leaf_out, x.laction_out,
                         x.alloc_out, x.rootpi_out, x.A, x.V, x.G, x.D,
                         x.cpuct, g);
}

template <class T>
struct Select {
  template <int K, int S>
  static auto fn(int) {  // either placement: Args.placement picks
    return select_kernel<K, S, T>;
  }
};

template <class T>
int launch(const void* prior, const void* wsum, const void* visits,
           const void* parent, const void* action_from, const void* expanded,
           const void* probs, void* nodes_out, void* actions_out,
           void* leaf_out, void* laction_out, void* alloc_out,
           void* rootpi_out, int A, int V, int G, int D, float cpuct,
           const walk::Geometry& geo, void* stream) {
  const Args<T> x{
      static_cast<const T*>(prior), static_cast<const T*>(wsum),
      static_cast<const T*>(visits), static_cast<const int32_t*>(parent),
      static_cast<const int32_t*>(action_from),
      static_cast<const bool*>(expanded), static_cast<const float*>(probs),
      static_cast<int32_t*>(nodes_out), static_cast<int32_t*>(actions_out),
      static_cast<int32_t*>(leaf_out), static_cast<int32_t*>(laction_out),
      static_cast<bool*>(alloc_out), static_cast<float*>(rootpi_out), A, V, G,
      D, cpuct, geo.placement};
  return walk::launch_group<Select<T>>(geo, x, stream);
}

}  // namespace

// lanes, slots, threads, blocks, smem, placement: the launch geometry
// (alphatpu_torch.mcts.kernels.walk_geometry); walk::launch_group refuses
// a geometry it has no instantiation for.  One entry per storage type:
// f32 planes, and bf16 planes (launch_select_bf16).
extern "C" int launch_select(const void* prior, const void* wsum,
                             const void* visits, const void* parent,
                             const void* action_from, const void* expanded,
                             const void* probs, void* nodes_out,
                             void* actions_out, void* leaf_out,
                             void* laction_out, void* alloc_out,
                             void* rootpi_out, int A, int V, int G, int D,
                             float cpuct, int lanes, int slots, int threads,
                             int blocks, int smem, int placement,
                             void* stream) {
  return launch<float>(prior, wsum, visits, parent, action_from, expanded,
                       probs, nodes_out, actions_out, leaf_out, laction_out,
                       alloc_out, rootpi_out, A, V, G, D, cpuct,
                       {lanes, slots, threads, blocks, smem, placement},
                       stream);
}

extern "C" int launch_select_bf16(const void* prior, const void* wsum,
                                  const void* visits, const void* parent,
                                  const void* action_from,
                                  const void* expanded, const void* probs,
                                  void* nodes_out, void* actions_out,
                                  void* leaf_out, void* laction_out,
                                  void* alloc_out, void* rootpi_out, int A,
                                  int V, int G, int D, float cpuct, int lanes,
                                  int slots, int threads, int blocks,
                                  int smem, int placement, void* stream) {
  return launch<__nv_bfloat16>(
      prior, wsum, visits, parent, action_from, expanded, probs, nodes_out,
      actions_out, leaf_out, laction_out, alloc_out, rootpi_out, A, V, G, D,
      cpuct, {lanes, slots, threads, blocks, smem, placement}, stream);
}
