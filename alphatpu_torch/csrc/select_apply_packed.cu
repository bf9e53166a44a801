// select_apply_packed: one MCTS rollout's tree work for every game.
//
// Replaces the TPU kernel alphatpu/mcts/pallas_kernels.py:select_apply_packed
// (_select_apply_packed_kernel = _backup_edges_packed + _walk_packed, with
// _node_policy_2d and _cdf_sample_2d).  Per game it
//   1. writes the previous rollout's pending prior row at its leaf (unless
//      the leaf is V, i.e. the tree was full),
//   2. applies the previous rollout's backup to the packed plane: one
//      integer add of ((contrib * S) << 16) | 1 per recorded path edge,
//   3. walks from the root to a leaf: at each depth the regularized policy
//      of the node (latched Newton solve, or the raw prior on a node with no
//      visits), a CDF sample against probs[d], and the child lookup through
//      parent/action_from.  It stops at an unexpanded node or a missing
//      child, records the path, leaf, leaf action and needs_alloc, and the
//      depth-0 policy of every game as root_pi.
//
// What bounds it on Hopper: scattered loads.  A walk visits about 5 nodes;
// at each it reads 2 planes x A words of [A, V, G] stats plus V words each
// of parent and action_from, and the Newton solve works on those rows.  The
// TPU kernel streamed whole [A, V, Gb] blocks through VMEM and selected rows
// with one-hot reduces over V because it has no fast gather.  Here each game
// is one thread with its own early exit: it loads only the rows of the nodes
// it visits, and because the layout keeps games minor, the 32 threads of a
// warp read 32 neighbouring words of each row.  Games share nothing, so
// there is no synchronisation.  The rows of the current node live in
// per-thread arrays (local memory, cached in L1) so that A is a runtime
// argument up to kMaxActions.
//
// Arithmetic is that of the plain torch version in
// alphatpu_torch/mcts/kernels.py, operation for operation, and sums over
// actions run in action order.  Built with -fmad=false and IEEE division and
// square root, the two agree bit for bit.
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxActions = 169;
constexpr int kThreads = 128;
constexpr int kNewtonSteps = 96;  // 12 chunks x 8 in the reference
constexpr float kNewtonTol = 1e-3f;
constexpr float kAlphaFloor = 1e-4f;

__global__ void __launch_bounds__(kThreads) select_apply_packed_kernel(
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
  const int pleaf = pu_leaf[g];
  if (pu_write[g] && pleaf >= 0 && pleaf < V) {
    const size_t row = static_cast<size_t>(pleaf) * gs + g;
    for (int a = 0; a < A; ++a) prior[a * vg + row] = pu_newp[a * gs + g];
  }

  // 2. pending backup adds; the wrap into bit 31 is unsigned arithmetic
  const int len = pu_length[g];
  const float value = pu_value[g];
  const float fscale = static_cast<float>(scale);
  for (int d = 0; d < D; ++d) {
    const int node = pu_nodes[d * gs + g];
    if (node < 0) continue;
    const int k = len - 1 - d;
    const float contrib = (k % 2 == 0) ? 1.0f - value : value;
    const uint32_t cfix =
        static_cast<uint32_t>(static_cast<int32_t>(contrib * fscale));
    const size_t a = static_cast<size_t>(pu_actions[d * gs + g]);
    packed[a * vg + static_cast<size_t>(node) * gs + g] += (cfix << 16) + 1u;
  }

  // 3. the walk
  for (int d = 0; d < D; ++d) {
    nodes_out[d * gs + g] = -1;
    actions_out[d * gs + g] = 0;
  }
  const float inv_scale = 1.0f / fscale;
  float P[kMaxActions];
  float Q[kMaxActions];
  int node = 0;
  int leaf_action = 0;
  bool needs_alloc = false;
  for (int d = 0; d < D; ++d) {
    const size_t row = static_cast<size_t>(node) * gs + g;
    const bool exp = expanded[row];
    float nvis = 0.0f;
    float acts = 0.0f;
    for (int a = 0; a < A; ++a) {
      const float p = prior[a * vg + row];
      const uint32_t pk = packed[a * vg + row];
      const float w = static_cast<float>(pk >> 16) * inv_scale;
      const float nv = static_cast<float>(pk & 0xFFFFu);
      P[a] = p;
      Q[a] = nv > 0.0f ? w / fmaxf(nv, 1.0f) : 0.0f;
      nvis += nv;
      acts += p > 0.0f ? 1.0f : 0.0f;
    }
    const float n = 1.0f + nvis;
    const float lam = cpuct * sqrtf(n) / (acts + n);
    const bool fresh = nvis == 0.0f;
    float alpha = -INFINITY;
    for (int a = 0; a < A; ++a)
      alpha = fmaxf(alpha, Q[a] + fmaxf(lam * P[a], kAlphaFloor));
    if (!fresh) {
      float prev_err = INFINITY;
      for (int it = 0; it < kNewtonSteps; ++it) {
        float s = 0.0f;
        float gsum = 0.0f;
        for (int a = 0; a < A; ++a) {
          const float r = 1.0f / (alpha - Q[a]);
          const float frac = (lam * P[a]) * r;
          s += frac;
          gsum += frac * r;
        }
        const float grad = -gsum;
        const float err = s - 1.0f;
        if (err < kNewtonTol || err == prev_err) break;  // latched
        alpha = alpha - err / (grad == 0.0f ? 1.0f : grad);
        prev_err = err;
      }
    }
    // policy row (recomputed where read: the same operations each time)
    auto pi = [&](int a) {
      return fresh ? P[a] : (lam * P[a]) / (alpha - Q[a]);
    };
    if (d == 0)
      for (int a = 0; a < A; ++a) rootpi_out[a * gs + g] = pi(a);

    // CDF sample: first action whose inclusive prefix sum reaches the
    // uniform and has mass, else the last action with mass, else 0
    const float prob = probs[d * gs + g];
    float c = 0.0f;
    int first = A;
    int last = -1;
    for (int a = 0; a < A; ++a) {
      const float p = pi(a);
      c += p;
      if (p > 0.0f) {
        if (first == A && c >= prob) first = a;
        last = a;
      }
    }
    const int action = first < A ? first : (last > 0 ? last : 0);

    if (exp) {
      nodes_out[d * gs + g] = node;
      actions_out[d * gs + g] = action;
    }
    int cid = 0;  // the child under (node, action); 0 = none
    for (int v = 0; v < V; ++v) {
      const size_t i = static_cast<size_t>(v) * gs + g;
      if (parent[i] == node && action_from[i] == action) cid += v;
    }
    const bool hit_missing = exp && cid == 0;
    if (hit_missing) {
      leaf_action = action;
      needs_alloc = true;
    }
    if (!exp || hit_missing) break;
    node = cid;
  }
  leaf_out[g] = node;
  laction_out[g] = leaf_action;
  alloc_out[g] = needs_alloc;
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
  if (A < 1 || A > kMaxActions || V < 1 || G < 1 || D < 1 || scale < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (G + kThreads - 1) / kThreads;
  select_apply_packed_kernel<<<blocks, kThreads, 0,
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
