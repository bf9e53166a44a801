// The root-to-leaf selection walk of one game, shared by the port's four
// walk kernels (select_apply_packed.cu, select_apply_packed1.cu,
// select_apply.cu, select.cu), and the per-game pieces of their apply
// phase.  Counterpart of the reference's _walk,
// _walk_packed and _walk_packed1 (alphatpu/mcts/pallas_kernels.py), with
// _node_policy_2d and _cdf_sample_2d, and of _backup_edges and
// _backup_edges_packed.
//
// The kernels differ only in how a node's row is stored, so the walk is a
// template on a row loader: ``rows.load(i, &p, &w, &n)`` returns the prior,
// value sum and visit count of the edge at flat index ``i`` of the
// [A, V, G] planes as floats.  Each loader is exact (integer fields times a
// power of two, or a bf16 widened to f32), so the walk's arithmetic is the
// same operation for operation whatever the storage.  At each depth: the
// regularized policy of the node (the latched Newton solve, or the raw
// prior on a node with no visits), a CDF sample against probs[d], and the
// child lookup through parent/action_from.  It stops at an unexpanded node
// or a missing child, and records the path, the leaf, the leaf action,
// needs_alloc and the depth-0 policy.
//
// One walk, walk_group: K lanes of a warp per game, for all four kernels,
// launched through one <K, S> dispatch, launch_group.
//
// Arithmetic is that of the plain torch version in
// alphatpu_torch/mcts/kernels.py (_walk_plain), and sums over actions run
// in action order.  Built with -fmad=false and IEEE division and square
// root, the two agree bit for bit.
#pragma once

#include <cmath>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace walk {

constexpr int kMaxActions = 169;
constexpr int kNewtonSteps = 96;  // 12 chunks x 8 in the reference
constexpr float kNewtonTol = 1e-3f;
constexpr float kAlphaFloor = 1e-4f;

// Row loaders, one per storage of the edge stats.

// The storage types of the three-plane kernels (select_apply.cu, select.cu,
// backup.cu): f32, or bf16 under ALPHATPU_BF16_STATS.  A load widens to
// f32 exactly; a store rounds an f32 once, to nearest even, as torch's
// .to(torch.bfloat16) and the reference's .astype(bfloat16) round.  For
// f32 both are the identity, so the f32 instantiations keep their
// instruction stream.
__device__ __forceinline__ float stat_to_f32(float x) { return x; }
__device__ __forceinline__ float stat_to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <class T>
__device__ __forceinline__ T stat_from_f32(float x);
template <>
__device__ __forceinline__ float stat_from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 stat_from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

// Three planes of one storage type T.  Visit counts are whole numbers
// below 2^24, as walk_group's integer reduction needs: bf16 holds them
// exactly up to 256, where stat_dtype_for stops.
template <class T>
struct StatRows {
  const T* prior;
  const T* wsum;
  const T* visits;
  __device__ __forceinline__ void load(size_t i, float* p, float* w,
                                       float* n) const {
    *p = stat_to_f32(prior[i]);
    *w = stat_to_f32(wsum[i]);
    *n = stat_to_f32(visits[i]);
  }
};
using F32Rows = StatRows<float>;
using Bf16Rows = StatRows<__nv_bfloat16>;

// f32 prior plane + the packed [wsum * S u16 | visits u16] word
// (select_apply_packed.cu).
struct PackedRows {
  const float* prior;
  const uint32_t* packed;
  float inv_scale;
  __device__ __forceinline__ void load(size_t i, float* p, float* w,
                                       float* n) const {
    const uint32_t pk = packed[i];
    *p = prior[i];
    *w = static_cast<float>(pk >> 16) * inv_scale;
    *n = static_cast<float>(pk & 0xFFFFu);
  }
};

// The 1-plane word [prior u11 | wsum * S1 u(bits_w) | visits u(bits_v)]
// (select_apply_packed1.cu).
struct Packed1Rows {
  const uint32_t* packed;
  int bits_v;
  int bits_w;
  float inv_scale;
  __device__ __forceinline__ void load(size_t i, float* p, float* w,
                                       float* n) const {
    const uint32_t pk = packed[i];
    *p = static_cast<float>(pk >> (bits_v + bits_w)) * (1.0f / 2048.0f);
    *w = static_cast<float>((pk >> bits_v) & ((1u << bits_w) - 1u)) *
         inv_scale;
    *n = static_cast<float>(pk & ((1u << bits_v) - 1u));
  }
};

// The apply phase of the select_apply kernels: the previous rollout's
// deferred writes, applied before the walk.

// The node whose prior row a pending update writes, or -1: the lane does
// not write, or its leaf is V (the tree was full, no slot was allocated).
__device__ __forceinline__ int pending_row_node(const bool* __restrict__ write,
                                                const int32_t* __restrict__ leaf,
                                                int V, int g) {
  const int node = leaf[g];
  return write[g] && node >= 0 && node < V ? node : -1;
}

// The backup of one game's recorded path (node -1 = nothing recorded at
// that depth) on a packed word with an integer wsum field at bit
// ``wshift`` and visits below it (select_apply_packed.cu at 16,
// select_apply_packed1.cu at bits_v): per edge at depth d the leaf value's
// contribution is 1 - v on the leaf edge and every second edge above it, v
// on the others, added as ((contrib * scale) << wshift) + 1.  The value
// lies on the 1/scale grid, so contrib * scale is an exact integer; the
// add is unsigned, where the carry into bit 31 is defined.  Lane j of the
// game's K takes depths j, j + K, ... (unrolled, so that the path loads
// issue together).  A path's edges are distinct tree edges, so no two
// lanes write the same word: no atomics.
template <int K>
__device__ __forceinline__ void add_packed_path(
    uint32_t* __restrict__ packed, const int32_t* __restrict__ nodes,
    const int32_t* __restrict__ actions, int len, float value, float fscale,
    int wshift, int V, int G, int D, int g, int j) {
  const size_t gs = static_cast<size_t>(G);
  const size_t vg = static_cast<size_t>(V) * gs;
#pragma unroll 4
  for (int d = j; d < D; d += K) {
    const int node = nodes[d * gs + g];
    if (node < 0) continue;
    const int k = len - 1 - d;
    const float contrib = (k % 2 == 0) ? 1.0f - value : value;
    const uint32_t cfix =
        static_cast<uint32_t>(static_cast<int32_t>(contrib * fscale));
    const size_t a = static_cast<size_t>(actions[d * gs + g]);
    packed[a * vg + static_cast<size_t>(node) * gs + g] +=
        (cfix << wshift) + 1u;
  }
}

// ---------------------------------------------------------------------------
// The cooperative walk: K lanes of one warp per game (K a power of two up
// to 32), each holding S actions of the current node's row in registers.
//
// A warp serves 32 / K games.  Warp lane l works for game l % (32 / K) of
// the warp as group lane j = l / (32 / K): the K lanes of a game are
// strided across the warp, so lanes of equal j are neighbouring games and
// their loads of one [*, G] word (parent, action_from, the pending path,
// the path out) fall on neighbouring addresses.  Group lane j holds
// actions j, j + K, ..., j + (S - 1) K; slots past A hold zeros.
//
// A walk is a chain of dependent steps (a node's row, its policy, the
// sampled child), so what the design cuts is the latency of each step:
// the node's flag, uniform and row are loaded together; the game's parent
// and action_from columns are copied into shared memory once, while the
// apply phase runs (stage_columns), so the child lookup reads no device
// memory - unless they do not fit a block's shared memory, and then the
// lookup reads them where they lie (the device placement: group_columns,
// placed_columns);
// the divisions (1 / (alpha - Q), pi) run across lanes; exact
// reductions (visit and action counts, the child id, the max that seeds
// alpha) use warp reductions in any order.  The order-sensitive f32 sums
// (the Newton sums, the CDF prefix) broadcast each action's term from the
// lane that holds it and fold in action order on every lane - unrolled,
// so the broadcasts issue together - and every lane holds the same bits,
// the same as _walk_plain.  A zero from a padding slot
// leaves a running sum as it is: the sum starts at +0 and is never -0.
// ---------------------------------------------------------------------------

constexpr int kGroupThreads = 128;  // most threads a block of walk_group

__host__ __device__ constexpr unsigned group_bits(int k) {
  unsigned bits = 0;
  for (int m = 0; m < k; ++m) bits |= 1u << (m * (32 / k));
  return bits;
}

// Words of shared memory per game for its parent and action_from columns:
// 2V rounded up to whole banks, plus K, so that the K x (32 / K) lanes of a
// warp reading slot m of their games hit 32 distinct banks.
__host__ __device__ constexpr int column_words(int V, int K) {
  return (2 * V + 31) / 32 * 32 + K;
}

template <int K>
struct Group {
  static_assert(K >= 1 && K <= 32 && (K & (K - 1)) == 0, "K: 1, 2, ..., 32");
  static constexpr int kGames = 32 / K;  // games per warp
  unsigned mask;  // the group's lanes in the warp
  int first;      // warp lane of group lane 0
  int j;          // this thread's group lane

  __device__ __forceinline__ Group() {
    const int lane = static_cast<int>(threadIdx.x & 31u);
    first = lane % kGames;
    j = lane / kGames;
    mask = group_bits(K) << first;
  }
  // warp lane of group lane m
  __device__ __forceinline__ int lane(int m) const {
    return first + m * kGames;
  }
  // this thread's game in its block, and in the launch
  __device__ __forceinline__ int slot() const {
    return static_cast<int>(threadIdx.x >> 5) * kGames + first;
  }
  __device__ __forceinline__ int game() const {
    return static_cast<int>(blockIdx.x * (blockDim.x / K)) + slot();
  }
};

// Start copying game g's parent and action_from columns into ``cols``
// (column_words(V, K) words: parent at [0, V), action_from at [V, 2V));
// lane j copies slots j, j + K, ...  walk_group waits for them.
template <int K>
__device__ __forceinline__ void stage_columns(
    const Group<K>& grp, int32_t* cols, const int32_t* __restrict__ parent,
    const int32_t* __restrict__ action_from, int V, int G, int g) {
  const size_t gs = static_cast<size_t>(G);
  for (int v = grp.j; v < V; v += K) {
    const size_t i = static_cast<size_t>(v) * gs + g;
    __pipeline_memcpy_async(cols + v, parent + i, sizeof(int32_t));
    __pipeline_memcpy_async(cols + V + v, action_from + i, sizeof(int32_t));
  }
  __pipeline_commit();
}

// Where the game's columns go: copied into shared memory, or read where
// they lie when they do not fit a block (kernels.walk_geometry decides).
constexpr int kSharedColumns = 0;
constexpr int kDeviceColumns = 1;

// What the child lookup reads, three views of a game's parent and
// action_from columns; ``match(v, node, action)`` tells whether slot v is
// the child under (node, action).

// The copy staged in shared memory, parent at [0, V) and action_from at
// [V, 2V) (the shared instantiations of select_apply_packed.cu and
// select_apply_packed1.cu).
struct SharedColumns {
  const int32_t* cols;
  int V;
  __device__ __forceinline__ bool match(int v, int node, int action) const {
    return cols[v] == node && cols[V + v] == action;
  }
};

// Either placement, chosen at run time (select_apply.cu, select.cu): slot v
// at parent[v * stride] and action_from[v * stride].  The pointers are
// generic, so one instantiation serves both.
struct Columns {
  const int32_t* parent;
  const int32_t* action_from;
  size_t stride;
  __device__ __forceinline__ bool match(int v, int node, int action) const {
    const size_t i = static_cast<size_t>(v) * stride;
    const int32_t p = parent[i];  // both loads issue unconditionally
    const int32_t a = action_from[i];
    return (p == node) & (a == action);
  }
};

// The [V, G] planes in device memory (the device instantiations of
// select_apply_packed.cu and select_apply_packed1.cu): slot v at
// parent[v * stride], read through the read-only data cache (__ldg; no
// walk kernel writes the columns).  With plain global loads, ptxas kept
// four of the lookup's loads in flight (two slots; kernel 1 <8, 1>), and
// kernels 1 and 3 took 0.93-1.08 ms at A=7, V=8000, G=512 against 0.57-0.64
// ms this way (H100 SXM, chip_smoke.py phase 3).
struct DeviceColumns {
  const int32_t* parent;
  const int32_t* action_from;
  size_t stride;
  __device__ __forceinline__ bool match(int v, int node, int action) const {
    const size_t i = static_cast<size_t>(v) * stride;
    const int32_t p = __ldg(parent + i);
    const int32_t a = __ldg(action_from + i);
    return (p == node) & (a == action);
  }
};

// Game g's columns in ``placement``: the shared placement starts copying
// them into the game's part of ``smem`` (stride 1); the device placement
// points into the [V, G] planes (stride G), where lanes of one slot read
// neighbouring games' words.
template <int K>
__device__ __forceinline__ Columns group_columns(
    const Group<K>& grp, int32_t* smem, int placement,
    const int32_t* __restrict__ parent,
    const int32_t* __restrict__ action_from, int V, int G, int g) {
  if (placement == kDeviceColumns)
    return {parent + g, action_from + g, static_cast<size_t>(G)};
  int32_t* cols = smem + grp.slot() * column_words(V, K);
  stage_columns(grp, cols, parent, action_from, V, G, g);
  return {cols, cols + V, 1};
}

// Game g's columns in the view ``Cols``, fixed at compile time (the packed
// kernels, instantiated once per placement, so that the shared
// instantiation keeps its own lookup and registers): SharedColumns starts
// copying them into the game's part of ``smem``; DeviceColumns points into
// the [V, G] planes (stride G).
template <class Cols, int K>
__device__ __forceinline__ Cols placed_columns(
    const Group<K>& grp, int32_t* smem, const int32_t* __restrict__ parent,
    const int32_t* __restrict__ action_from, int V, int G, int g) {
  static_assert(std::is_same<Cols, SharedColumns>::value ||
                    std::is_same<Cols, DeviceColumns>::value,
                "Cols: SharedColumns or DeviceColumns");
  if constexpr (std::is_same<Cols, SharedColumns>::value) {
    int32_t* staged = smem + grp.slot() * column_words(V, K);
    stage_columns(grp, staged, parent, action_from, V, G, g);
    return {staged, V};
  } else {
    return {parent + g, action_from + g, static_cast<size_t>(G)};
  }
}

template <int K, int S, class Rows, class Cols>
__device__ __forceinline__ void walk_group(
    const Group<K>& grp, const Rows& rows, const Cols cols,
    const bool* __restrict__ expanded, const float* __restrict__ probs,
    int32_t* __restrict__ nodes_out, int32_t* __restrict__ actions_out,
    int32_t* __restrict__ leaf_out, int32_t* __restrict__ laction_out,
    bool* __restrict__ alloc_out, float* __restrict__ rootpi_out, int A,
    int V, int G, int D, float cpuct, int g) {
  const size_t gs = static_cast<size_t>(G);
  const size_t vg = static_cast<size_t>(V) * gs;
  const int j = grp.j;
  float P[S], Q[S], T1[S], T2[S];
  int node = 0;
  int leaf_action = 0;
  bool needs_alloc = false;
  int recorded = 0;  // depths 0 .. recorded - 1 hold the path
  for (int d = 0; d < D; ++d) {
    const size_t row = static_cast<size_t>(node) * gs + g;
    const bool exp = expanded[row];
    const float prob = probs[d * gs + g];
    int nv_part = 0;
    int acts_part = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int a = s * K + j;
      float p = 0.0f, w = 0.0f, nv = 0.0f;
      if (a < A) rows.load(a * vg + row, &p, &w, &nv);
      P[s] = p;
      Q[s] = nv > 0.0f ? w / fmaxf(nv, 1.0f) : 0.0f;
      nv_part += static_cast<int>(nv);
      acts_part += p > 0.0f ? 1 : 0;
    }
    // integer-valued sums below 2^24: exact in any order
    const float nvis =
        static_cast<float>(__reduce_add_sync(grp.mask, nv_part));
    const float acts =
        static_cast<float>(__reduce_add_sync(grp.mask, acts_part));
    if (!exp && d > 0) break;  // a leaf below the root: its row is unused
    const float n = 1.0f + nvis;
    const float lam = cpuct * sqrtf(n) / (acts + n);
    const bool fresh = nvis == 0.0f;
    float alpha = -INFINITY;
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (s * K + j < A)
        alpha = fmaxf(alpha, Q[s] + fmaxf(lam * P[s], kAlphaFloor));
#pragma unroll
    for (int off = 1; off < K; off <<= 1)
      alpha = fmaxf(alpha, __shfl_xor_sync(grp.mask, alpha,
                                           off * Group<K>::kGames));
    if (!fresh) {
      float prev_err = INFINITY;
      for (int it = 0; it < kNewtonSteps; ++it) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float r = 1.0f / (alpha - Q[s]);
          const float frac = (lam * P[s]) * r;
          const bool real = s * K + j < A;
          T1[s] = real ? frac : 0.0f;
          T2[s] = real ? frac * r : 0.0f;
        }
        float sum = 0.0f;
        float gsum = 0.0f;
#pragma unroll
        for (int s = 0; s < S; ++s) {
#pragma unroll
          for (int m = 0; m < K; ++m) {
            sum += __shfl_sync(grp.mask, T1[s], grp.lane(m));
            gsum += __shfl_sync(grp.mask, T2[s], grp.lane(m));
          }
        }
        const float grad = -gsum;
        const float err = sum - 1.0f;
        if (err < kNewtonTol || err == prev_err) break;  // latched
        alpha = alpha - err / (grad == 0.0f ? 1.0f : grad);
        prev_err = err;
      }
    }
    // this lane's entries of the policy row
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float pi = fresh ? P[s] : (lam * P[s]) / (alpha - Q[s]);
      T1[s] = s * K + j < A ? pi : 0.0f;
    }
    if (d == 0) {
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (s * K + j < A) rootpi_out[(s * K + j) * gs + g] = T1[s];
    }
    if (!exp) break;

    // CDF sample: first action whose inclusive prefix sum reaches the
    // uniform and has mass, else the last action with mass, else 0
    float c = 0.0f;
    int first = A;
    int last = -1;
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
      for (int m = 0; m < K; ++m) {
        const float p = __shfl_sync(grp.mask, T1[s], grp.lane(m));
        c += p;
        if (p > 0.0f) {
          if (first == A && c >= prob) first = s * K + m;
          last = s * K + m;
        }
      }
    }
    const int action = first < A ? first : (last > 0 ? last : 0);

    if (j == d % K) {
      nodes_out[d * gs + g] = node;
      actions_out[d * gs + g] = action;
    }
    recorded = d + 1;
    if (d == 0) {  // the columns staged at kernel start (none in flight
      __pipeline_wait_prior(0);  // in the device placement)
      __syncwarp(grp.mask);
    }
    int cid_part = 0;  // the child under (node, action); 0 = none
#pragma unroll 8
    for (int v = j; v < V; v += K)
      if (cols.match(v, node, action)) cid_part += v;
    const int cid = __reduce_add_sync(grp.mask, cid_part);
    if (cid == 0) {
      leaf_action = action;
      needs_alloc = true;
      break;
    }
    node = cid;
  }
  __pipeline_wait_prior(0);  // no copy left in flight at exit
  // the depths the walk did not record: lane j takes d = j (mod K)
  for (int d = recorded + ((j - recorded) & (K - 1)); d < D; d += K) {
    nodes_out[d * gs + g] = -1;
    actions_out[d * gs + g] = 0;
  }
  if (j == 0) {
    leaf_out[g] = node;
    laction_out[g] = leaf_action;
    alloc_out[g] = needs_alloc;
  }
}

// ---------------------------------------------------------------------------
// The one dispatch of the four walk kernels.  Each names its kernel
// template through a trait: ``Kernel::fn<K, S>(placement)`` returns the
// __global__ function, taking the kernel's Args by value (with fields A, V,
// G, D), that serves that column placement - one instantiation per
// placement for the packed kernels (select_apply_packed.cu,
// select_apply_packed1.cu), one for both for the f32 kernels, which read
// the placement from their Args (select_apply.cu, select.cu).
// ---------------------------------------------------------------------------

constexpr int kDefaultSmem = 48 * 1024;  // dynamic shared memory without
                                         // the opt-in attribute
constexpr int kMaxSmem = 232448;         // what a block can use on sm_90

// The launch geometry (alphatpu_torch.mcts.kernels.WalkGeometry).
struct Geometry {
  int lanes, slots, threads, blocks, smem, placement;
};

// Launch the <K, S> instantiation if it is the one asked for; sets *err.
template <class Kernel, int K, int S, class Args>
bool try_launch(const Geometry& geo, const Args& x, cudaStream_t stream,
                cudaError_t* err) {
  if (geo.lanes != K || geo.slots != S) return false;
  const bool shared = geo.placement == kSharedColumns;
  const int need = shared ? geo.threads / K * column_words(x.V, K) * 4 : 0;
  if (geo.smem < need || geo.smem > (shared ? kMaxSmem : 0)) {
    *err = cudaErrorInvalidValue;
    return true;
  }
  const auto fn = Kernel::template fn<K, S>(geo.placement);
  if (geo.smem > kDefaultSmem) {
    *err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, geo.smem);
    if (*err != cudaSuccess) return true;
  }
  void* args[] = {const_cast<Args*>(&x)};
  const cudaError_t launched =
      cudaLaunchKernel(reinterpret_cast<const void*>(fn), dim3(geo.blocks),
                       dim3(geo.threads), args, geo.smem, stream);
  const cudaError_t last = cudaGetLastError();  // clears a launch error
  *err = launched != cudaSuccess ? launched : last;
  return true;
}

// Instantiated for lanes 1, 2, ..., 32 with one slot, and 32 lanes with 2
// to 6 slots (A up to 192 >= kMaxActions), in both placements.  Any other
// geometry is refused.
template <class Kernel, class Args>
int launch_group(const Geometry& geo, const Args& x, void* stream) {
  const bool placed = geo.placement == kSharedColumns ||
                      geo.placement == kDeviceColumns;
  if (x.A < 1 || x.A > kMaxActions || x.V < 1 || x.G < 1 || x.D < 1 ||
      !placed || geo.lanes < 1 || geo.slots < 1 ||
      geo.lanes * geo.slots < x.A || geo.threads < 32 ||
      geo.threads > kGroupThreads || geo.threads % 32 != 0 ||
      static_cast<long long>(geo.blocks) * (geo.threads / geo.lanes) < x.G)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  const bool instantiated =
      try_launch<Kernel, 1, 1>(geo, x, st, &err) ||
      try_launch<Kernel, 2, 1>(geo, x, st, &err) ||
      try_launch<Kernel, 4, 1>(geo, x, st, &err) ||
      try_launch<Kernel, 8, 1>(geo, x, st, &err) ||
      try_launch<Kernel, 16, 1>(geo, x, st, &err) ||
      try_launch<Kernel, 32, 1>(geo, x, st, &err) ||
      try_launch<Kernel, 32, 2>(geo, x, st, &err) ||
      try_launch<Kernel, 32, 3>(geo, x, st, &err) ||
      try_launch<Kernel, 32, 4>(geo, x, st, &err) ||
      try_launch<Kernel, 32, 5>(geo, x, st, &err) ||
      try_launch<Kernel, 32, 6>(geo, x, st, &err);
  return static_cast<int>(instantiated ? err : cudaErrorInvalidValue);
}

}  // namespace walk
