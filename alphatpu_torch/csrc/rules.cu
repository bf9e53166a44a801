// rules: the game rules the search runs once per rollout - reversi's move
// (reversi_play) and end test (reversi_is_over), the line games' end test
// (line_is_over: tictactoe, gobang, connect4) and hex's (hex_is_over).
//
// Replaces no Pallas kernel.  The reference writes each rule as a static
// Python loop of jnp bit operations - reversi's _legal_play_dir,
// legal_board, _flip_dir, flip_board, play and is_over
// (alphatpu/games/reversi.py:71-153), gobang's is_over
// (alphatpu/games/gobang.py:65-86), connect4's
// (alphatpu/games/connect4.py:86-106) and hex's connectivity flood
// (alphatpu/games/hex.py:95-110) - traced into its one jitted search
// program, where XLA fuses each chain of bit operations into a few loop
// fusions.  Run op by op, the port's torch versions of the same rules
// (alphatpu_torch/games/kernels.py, *_plain) cost hundreds of launches a
// call: these kernels are the port's counterpart of XLA's fusion.  Each
// computes every word of the plain version's operations with the plain
// version's expressions, so its outputs equal the plain version's bit for
// bit for any input; the reversi kernels fold each direction's step - two
// shifts, each then masked - into one shift and one mask, an identity
// (Reversi::shifted; tests/test_torch_rules.py holds it).  Hex's flood is
// 2N-2 dependent steps of three shifts each (up, right, down): the plain
// version runs each shift word by word, some 5,700 launches a call on
// hex13.
//
// What bounds them on Hopper: the launch, then a chain of dependent word
// operations.  At 8192 games a call reads and writes under 1 MB (about
// 0.3 us at 3.35 TB/s) and does a few thousand word operations a game
// (well under a microsecond across the card), so what is left above the
// launch is the loads' latency and each game's longest chain.  So the
// kernels split a game's independent chains - its directions - over
// threads, where each thread keeps whole 64-bit boards or whole words:
// - reversi_play, reversi_is_over and line_is_over run four warps a block
//   of 32 games, lane l game l of the block in every warp, warp k
//   direction k of the line games' four, or reversi's directions 2k and
//   2k+1, so the direction's shifts are constants and its branch uniform
//   across the warp.  The warps meet in shared memory: line_is_over ORs
//   four ballots of "a stone left" after one barrier; reversi_play ORs the
//   four warps' flips (one barrier), forms the new boards in every warp,
//   ORs their legal boards (a second barrier), and warp 0 stores;
//   reversi_is_over ORs the opponent's legal board (one barrier), and a
//   warp none of whose games is stuck skips that chain by a vote.  (A lane
//   a direction for reversi_play - eight lanes a game, ORed by shuffles -
//   waited on each lane's loads and lost at reversi6x6; PERF.md has the
//   trials.)
// - hex_is_over, the longest chain, runs L lanes of a warp a game (the
//   next power of two at or above its W words), lane w word w, every mask
//   arithmetic on the lane's index.  A lane computes b = up(a) for words
//   w-2..w, c = right(b) for w-1..w and the and-or for w-1..w, so each of
//   the 2N-2 steps, unrolled, needs one round of three independent
//   shuffles (words w-2, w-1 and w+1 of a) instead of three rounds.
// The masks of the reversi and line kernels are kernel parameters.
// Boards are the port's layout: 32-bit words held in int64 elements, cell
// (r, c) at bit r + rows * c.  Reversi's two words are joined into one
// 64-bit value (36 or 64 cells); a shift of that value equals the plain
// version's two-word shift, and the valid mask clears what the 6x6 board
// does not hold.  The line and hex kernels keep W 32-bit words (gobang13:
// six, hex13: seven) and shift across them as bitboard._shift does.
// Geometry and masks come from Python (games/kernels.py: reversi_geometry,
// line_geometry, hex_geometry; the launches direction_geometry for the
// reversi kernels and line_is_over, spread_geometry for hex_is_over); each
// entry point checks them against the masks and the launch it derives from
// rows, cols and G, and refuses any geometry it has no instantiation for.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

typedef unsigned long long u64;
typedef uint32_t u32;

constexpr int kMaxThreads = 128;
// reversi_play, reversi_is_over and line_is_over: four warps a block, a
// warp a direction (or a pair), a lane a game: kDirGames games a block
constexpr int kDirWarps = 4;
constexpr int kDirGames = 32;
constexpr int kDirThreads = kDirWarps * kDirGames;
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kMaxWords = 7;      // hex13: 196 cells
constexpr int kLineMaxWords = 6;  // gobang13: 169 cells
constexpr int kHexMaxSize = 13;   // hex<N>, N + 1 rows with the border

// The spec's masks, word by word: valid cells, not the first row, not the
// last row (BoardSpec.valid_mask, not_first_row_mask, not_last_row_mask).
struct Masks {
  u32 valid[kMaxWords], not_first_row[kMaxWords], not_last_row[kMaxWords];
};

// Derive the masks of a rows x cols board of `words` words and compare
// them with the ones Python passed; false on any difference.
bool masks_match(const u32* given, int rows, int cols, int words,
                 Masks* out) {
  Masks m = {};
  for (int i = 0; i < rows * cols; ++i) {
    const u32 bit = 1u << (i % 32);
    m.valid[i / 32] |= bit;
    if (i % rows != 0) m.not_first_row[i / 32] |= bit;
    if (i % rows != rows - 1) m.not_last_row[i / 32] |= bit;
  }
  for (int w = 0; w < words; ++w) {
    if (given[w] != m.valid[w] || given[words + w] != m.not_first_row[w] ||
        given[2 * words + w] != m.not_last_row[w])
      return false;
  }
  *out = m;
  return true;
}

int blocks_for(int G, int threads) { return (G + threads - 1) / threads; }

bool threads_ok(int threads) {
  return threads >= 32 && threads <= kMaxThreads && threads % 32 == 0;
}

// A launch of `lanes` lanes of a warp a game (games/kernels.py
// spread_geometry): whole warps, and exactly the blocks that cover G games.
bool lanes_ok(int G, int lanes, int threads, int blocks) {
  return G >= 1 && threads_ok(threads) && threads % lanes == 0 &&
         blocks == blocks_for(G, threads / lanes);
}

// A launch of a warp a direction (games/kernels.py direction_geometry):
// four warps a block and exactly the blocks that cover G games, a lane a
// game.
bool directions_ok(int G, int threads, int blocks) {
  return G >= 1 && threads == kDirThreads &&
         blocks == blocks_for(G, kDirGames);
}

// ---------------------------------------------------------------------------
// reversi: one 64-bit board
// ---------------------------------------------------------------------------

struct Masks64 {
  u64 valid, not_first_row, not_last_row;
};

__device__ __forceinline__ u64 load64(const int64_t* b, int g) {
  return static_cast<u64>(static_cast<u32>(b[2 * g])) |
         (static_cast<u64>(static_cast<u32>(b[2 * g + 1])) << 32);
}

__device__ __forceinline__ void store64(int64_t* b, int g, u64 x) {
  b[2 * g] = static_cast<int64_t>(x & 0xffffffffull);
  b[2 * g + 1] = static_cast<int64_t>(x >> 32);
}

// bitboard.py's up, down, left and right on a board of SIZE rows: each
// shift masked to the valid cells, up and down then to the row masks.
template <int SIZE>
struct Reversi {
  Masks64 m;

  __device__ __forceinline__ u64 up(u64 x) const {
    return ((x >> 1) & m.valid) & m.not_last_row;
  }
  __device__ __forceinline__ u64 down(u64 x) const {
    return ((x << 1) & m.valid) & m.not_first_row;
  }
  __device__ __forceinline__ u64 left(u64 x) const {
    return (x >> SIZE) & m.valid;
  }
  __device__ __forceinline__ u64 right(u64 x) const {
    return (x << SIZE) & m.valid;
  }
  // direction d of kernels.reversi_dirs: up, down, left, right, up-left,
  // down-left, up-right, down-right (d is a constant after unrolling)
  __device__ __forceinline__ u64 step(int d, u64 x) const {
    switch (d) {
      case 0: return up(x);
      case 1: return down(x);
      case 2: return left(x);
      case 3: return right(x);
      case 4: return up(left(x));
      case 5: return down(left(x));
      case 6: return up(right(x));
      default: return down(right(x));
    }
  }

  // step(D, x) as one shift and one mask.  Each of up, down, left and
  // right is a shift then an AND, and a shift distributes over an AND, so
  // step(D, x) == shifted<D>(x) & step(D, ~0): shifted<D> the net shift of
  // D's composition (up >> 1, down << 1, left >> SIZE, right << SIZE).
  template <int D>
  static __device__ __forceinline__ u64 shifted(u64 x) {
    constexpr int s = D == 0 ? -1 : D == 1 ? 1 : D == 2 ? -SIZE
                    : D == 3 ? SIZE : D == 4 ? -(SIZE + 1)
                    : D == 5 ? -(SIZE - 1) : D == 6 ? SIZE - 1 : SIZE + 1;
    if constexpr (s > 0) return x << s;
    else return x >> -s;
  }

  // kernels.flip_board_plain's body for direction D, its step folded as
  // above (adv and me masked once): the discs of `adv` a disc on `played`
  // flips along D
  template <int D>
  __device__ __forceinline__ u64 flips_dir(u64 me, u64 adv,
                                           u64 played) const {
    const u64 mask = step(D, ~0ull);
    const u64 a = adv & mask;
    u64 cand = a & shifted<D>(played);
    u64 toflip = cand;
#pragma unroll
    for (int i = 0; i < SIZE - 2; ++i) {
      cand = a & shifted<D>(cand);
      toflip |= cand;
    }
    return (shifted<D>(toflip) & mask & me) != 0 ? toflip : 0ull;
  }

  // kernels.legal_board_plain's body for direction D, its step folded (adv
  // and the empty cells masked once): the empty cells a run of `adv` from
  // `me` ends on along D
  template <int D>
  __device__ __forceinline__ u64 legal_dir(u64 me, u64 adv,
                                           u64 emptyc) const {
    const u64 mask = step(D, ~0ull);
    const u64 a = adv & mask;
    const u64 e = emptyc & mask;
    u64 out = 0;
    u64 cand = a & shifted<D>(me);
#pragma unroll
    for (int i = 0; i < SIZE - 2; ++i) {
      const u64 dc = shifted<D>(cand);
      out |= e & dc;
      cand = a & dc;
    }
    return out | (e & shifted<D>(cand));
  }

  // directions 2k and 2k+1 (k the warp's index, uniform across it)
  __device__ __forceinline__ u64 flips_pair(int k, u64 me, u64 adv,
                                            u64 played) const {
    switch (k) {
      case 0: return flips_dir<0>(me, adv, played) |
                     flips_dir<1>(me, adv, played);
      case 1: return flips_dir<2>(me, adv, played) |
                     flips_dir<3>(me, adv, played);
      case 2: return flips_dir<4>(me, adv, played) |
                     flips_dir<5>(me, adv, played);
      default: return flips_dir<6>(me, adv, played) |
                      flips_dir<7>(me, adv, played);
    }
  }
  __device__ __forceinline__ u64 legal_pair(int k, u64 me, u64 adv) const {
    const u64 emptyc = ~(me | adv) & m.valid;
    switch (k) {
      case 0: return legal_dir<0>(me, adv, emptyc) |
                     legal_dir<1>(me, adv, emptyc);
      case 1: return legal_dir<2>(me, adv, emptyc) |
                     legal_dir<3>(me, adv, emptyc);
      case 2: return legal_dir<4>(me, adv, emptyc) |
                     legal_dir<5>(me, adv, emptyc);
      default: return legal_dir<6>(me, adv, emptyc) |
                      legal_dir<7>(me, adv, emptyc);
    }
  }
};

// Reversi.play, a warp a pair of directions: a block of kDirThreads threads
// (four warps) plays kDirGames games, lane l game blockIdx.x * kDirGames +
// l in every warp, warp k directions 2k and 2k+1.  Each warp ORs its two
// directions' flips into shared memory; after a barrier every warp forms
// the new boards from the four, ORs its two directions of the new mover's
// legal board into shared memory, and after a second barrier warp 0 stores
// the boards, the legal board and -player.  Lanes past G hold empty boards
// and store nothing, and every lane reaches both barriers.
template <int SIZE, class Action>
__global__ void __launch_bounds__(kDirThreads) reversi_play_kernel(
    const int64_t* __restrict__ bplayer, const int64_t* __restrict__ bopponent,
    const Action* __restrict__ action, const int8_t* __restrict__ player,
    int64_t* __restrict__ out_bplayer, int64_t* __restrict__ out_bopponent,
    int64_t* __restrict__ out_legal, int8_t* __restrict__ out_player,
    Masks64 masks, int G) {
  __shared__ u64 flipped[kDirWarps][kDirGames], legal[kDirWarps][kDirGames];
  const int k = threadIdx.x / 32;
  const int l = threadIdx.x % 32;
  const int g = blockIdx.x * kDirGames + l;
  const bool live = g < G;
  const Reversi<SIZE> R{masks};
  const u64 bp = live ? load64(bplayer, g) : 0ull;
  const u64 bo = live ? load64(bopponent, g) : 0ull;
  const long long a = live ? static_cast<long long>(action[g]) : -1ll;
  const int8_t p = live && k == 0 ? player[g] : int8_t{0};
  // the pass action (size*size and above) places and flips nothing; a
  // negative index sets no bit (bitboard.set_bit)
  const bool is_pass = a >= SIZE * SIZE;
  const u64 placed = (!is_pass && a >= 0) ? (1ull << a) : 0ull;
  flipped[k][l] = is_pass ? 0ull : R.flips_pair(k, bp, bo, placed);
  __syncthreads();
  const u64 h = flipped[0][l] | flipped[1][l] | flipped[2][l] | flipped[3][l];
  const u64 me = (bp ^ h) | placed;
  const u64 adv = bo ^ h;
  if (live && k == 0) {
    store64(out_bplayer, g, adv);
    store64(out_bopponent, g, me);
    out_player[g] = static_cast<int8_t>(-p);
  }
  legal[k][l] = R.legal_pair(k, adv, me);
  __syncthreads();
  if (live && k == 0)
    store64(out_legal, g,
            legal[0][l] | legal[1][l] | legal[2][l] | legal[3][l]);
}

// Reversi.is_over, a warp a pair of directions of the opponent's legal
// board: a block of kDirThreads threads (four warps) tests kDirGames games,
// lane l game blockIdx.x * kDirGames + l in every warp, warp k directions
// 2k and 2k+1, each step folded into one shift and one mask.  Every load is
// issued before any arithmetic (player by warp 0, which stores).  A game
// can be over only where its mover has no move (legal == 0), and the four
// warps load the same legal boards, so their votes agree: a warp none of
// whose games is stuck skips the chain, and warp 0 stores done = false,
// result = 0.  Otherwise each warp ORs its two directions into shared
// memory and, after a barrier, warp 0 ORs the four.  Lanes past G hold a
// nonzero legal board (they never ask for the chain) and store nothing,
// and every lane reaches the barrier.
template <int SIZE>
__global__ void __launch_bounds__(kDirThreads) reversi_is_over_kernel(
    const int64_t* __restrict__ bplayer, const int64_t* __restrict__ bopponent,
    const int64_t* __restrict__ legal, const int8_t* __restrict__ player,
    bool* __restrict__ done, int8_t* __restrict__ result, Masks64 masks,
    int G) {
  __shared__ u64 opp[kDirWarps][kDirGames];
  const int k = threadIdx.x / 32;
  const int l = threadIdx.x % 32;
  const int g = blockIdx.x * kDirGames + l;
  const bool live = g < G;
  const Reversi<SIZE> R{masks};
  const u64 bp = live ? load64(bplayer, g) : 0ull;
  const u64 bo = live ? load64(bopponent, g) : 0ull;
  const u64 lg = live ? load64(legal, g) : ~0ull;
  const int8_t p = live && k == 0 ? player[g] : int8_t{0};
  const bool stuck = lg == 0;  // the mover has no move
  if (__any_sync(kFullWarp, stuck)) opp[k][l] = R.legal_pair(k, bo, bp);
  __syncthreads();
  if (live && k == 0) {
    // stuck only where this warp (and so every warp) ran the chain
    const bool over =
        stuck && (opp[0][l] | opp[1][l] | opp[2][l] | opp[3][l]) == 0;
    const int diff = __popcll(bp) - __popcll(bo);
    const int sign = (diff > 0) - (diff < 0);
    done[g] = over;
    result[g] = over ? static_cast<int8_t>(sign * p) : int8_t{0};
  }
}

Masks64 join(const Masks& m) {
  return {static_cast<u64>(m.valid[0]) | static_cast<u64>(m.valid[1]) << 32,
          static_cast<u64>(m.not_first_row[0]) |
              static_cast<u64>(m.not_first_row[1]) << 32,
          static_cast<u64>(m.not_last_row[0]) |
              static_cast<u64>(m.not_last_row[1]) << 32};
}

// A reversi board: square, 6x6 or 8x8, in two words, with its own masks.
bool reversi_geometry(const void* masks, int G, int rows, int cols,
                      int words, Masks64* out) {
  Masks m;
  if (G < 1 || rows != cols || (rows != 6 && rows != 8) || words != 2 ||
      !masks_match(static_cast<const u32*>(masks), rows, cols, words, &m))
    return false;
  *out = join(m);
  return true;
}

template <int SIZE, class Action>
void play(const void* bplayer, const void* bopponent, const void* action,
          const void* player, void* out_bplayer, void* out_bopponent,
          void* out_legal, void* out_player, Masks64 m, int G, int blocks,
          cudaStream_t stream) {
  reversi_play_kernel<SIZE, Action><<<blocks, kDirThreads, 0, stream>>>(
          static_cast<const int64_t*>(bplayer),
          static_cast<const int64_t*>(bopponent),
          static_cast<const Action*>(action),
          static_cast<const int8_t*>(player),
          static_cast<int64_t*>(out_bplayer),
          static_cast<int64_t*>(out_bopponent),
          static_cast<int64_t*>(out_legal), static_cast<int8_t*>(out_player),
          m, G);
}

// ---------------------------------------------------------------------------
// line games: W 32-bit words
// ---------------------------------------------------------------------------

template <int W>
struct Board {
  u32 w[W];
};

// bitboard._shift by 1 <= n <= 31 bits (a shift stays inside a word and
// its neighbour), then masked to the valid cells
template <int W>
__device__ __forceinline__ Board<W> shift_up(const Board<W>& b, int n,
                                             const Masks& m) {
  Board<W> out;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    u32 acc = b.w[w] << n;
    if (w > 0) acc |= b.w[w - 1] >> (32 - n);
    out.w[w] = acc & m.valid[w];
  }
  return out;
}

template <int W>
__device__ __forceinline__ Board<W> shift_down(const Board<W>& b, int n,
                                               const Masks& m) {
  Board<W> out;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    u32 acc = b.w[w] >> n;
    if (w + 1 < W) acc |= b.w[w + 1] << (32 - n);
    out.w[w] = acc & m.valid[w];
  }
  return out;
}

// kernels.line_win_plain's four steps: right, down, down-right, down-left
template <int W>
__device__ __forceinline__ Board<W> line_step(int d, const Board<W>& b,
                                              int rows, const Masks& m) {
  Board<W> x = b;
  if (d == 1 || d == 2 || d == 3) {
    if (d == 2) x = shift_up(x, rows, m);  // right first
    x = shift_up(x, 1, m);                 // down
#pragma unroll
    for (int w = 0; w < W; ++w) x.w[w] &= m.not_first_row[w];
    if (d == 3) x = shift_down(x, rows, m);  // then left
    return x;
  }
  return shift_up(x, rows, m);  // right
}

template <int W>
__device__ __forceinline__ int popcount(const Board<W>& b) {
  int n = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) n += __popc(b.w[w]);
  return n;
}

template <int W>
__device__ __forceinline__ Board<W> load(const int64_t* p, int g) {
  Board<W> b;
#pragma unroll
  for (int w = 0; w < W; ++w)
    b.w[w] = static_cast<u32>(p[static_cast<size_t>(g) * W + w]);
  return b;
}

// kernels.line_win_plain's direction D: nvict - 1 shift-ANDs of the board,
// then whether a stone is left
template <int W, int D>
__device__ __forceinline__ bool line_dir(Board<W> b, int rows, int nvict,
                                         const Masks& m) {
  for (int i = 0; i < nvict - 1; ++i) {
    const Board<W> s = line_step(D, b, rows, m);
#pragma unroll
    for (int w = 0; w < W; ++w) b.w[w] &= s.w[w];
  }
  u32 any = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) any |= b.w[w];
  return any != 0;
}

// Gobang.is_over / Connect4.is_over, a warp a direction: a block of
// kDirThreads threads (four warps) tests kDirGames games, lane l game
// blockIdx.x * kDirGames + l in every warp, warp d direction d of
// line_win_plain (uniform across the warp).  Each warp's ballot of "a
// stone left" goes to shared memory; after a barrier warp 0 ORs the four
// and adds the full-board test on both boards, which it loaded before the
// barrier.  Lanes past G hold an empty board and store nothing, and every
// lane reaches the barrier.
template <int W>
__global__ void __launch_bounds__(kDirThreads) line_is_over_kernel(
    const int64_t* __restrict__ bplayer, const int64_t* __restrict__ bopponent,
    const int8_t* __restrict__ player, bool* __restrict__ done,
    int8_t* __restrict__ result, Masks masks, int G, int rows, int cells,
    int nvict) {
  __shared__ u32 won[kDirWarps];
  const int d = threadIdx.x / 32;
  const int l = threadIdx.x % 32;
  const int g = blockIdx.x * kDirGames + l;
  const bool live = g < G;
  Board<W> board = {};  // the previous mover's
  if (live) board = load<W>(bopponent, g);
  Board<W> bp = {};
  int8_t p = 0;
  if (live && d == 0) {
    bp = load<W>(bplayer, g);
    p = player[g];
  }
  bool win;
  switch (d) {
    case 0: win = line_dir<W, 0>(board, rows, nvict, masks); break;
    case 1: win = line_dir<W, 1>(board, rows, nvict, masks); break;
    case 2: win = line_dir<W, 2>(board, rows, nvict, masks); break;
    default: win = line_dir<W, 3>(board, rows, nvict, masks); break;
  }
  const u32 ballot = __ballot_sync(kFullWarp, win);
  if (l == 0) won[d] = ballot;
  __syncthreads();
  if (live && d == 0) {
    const bool w = ((won[0] | won[1] | won[2] | won[3]) >> l) & 1u;
    const bool full = popcount(bp) + popcount(board) == cells;
    done[g] = w || full;
    result[g] = w ? static_cast<int8_t>(-p) : int8_t{0};
  }
}

template <int W>
void line(const void* bplayer, const void* bopponent, const void* player,
          void* done, void* result, const Masks& m, int G, int rows,
          int cols, int nvict, int blocks, cudaStream_t stream) {
  line_is_over_kernel<W><<<blocks, kDirThreads, 0, stream>>>(
      static_cast<const int64_t*>(bplayer),
      static_cast<const int64_t*>(bopponent),
      static_cast<const int8_t*>(player), static_cast<bool*>(done),
      static_cast<int8_t*>(result), m, G, rows, rows * cols, nvict);
}

// ---------------------------------------------------------------------------
// hex: the connectivity flood on W 32-bit words
// ---------------------------------------------------------------------------

// hex_is_over's lanes a game: the next power of two at or above W
__host__ __device__ constexpr int hex_lanes(int words) {
  return words <= 1 ? 1 : words <= 2 ? 2 : words <= 4 ? 4 : 8;
}

// bits 0, rows, 2 rows, ... of a 32-bit word
__host__ __device__ constexpr u32 row_bits(int rows) {
  u32 m = 0;
  for (int b = 0; b < 32; b += rows) m |= 1u << b;
  return m;
}

// The spec's masks of a rows x rows board (masks_match's) at word w (0 off
// the board: w < 0 or past the last word), by arithmetic on w
template <int rows>
struct WordMasks {
  u32 valid, not_first_row, not_last_row;

  __device__ __forceinline__ explicit WordMasks(int w) {
    constexpr int cells = rows * rows;
    constexpr u32 every_row = row_bits(rows);
    const int above = cells - 32 * w;  // cells from word w's bit 0 up
    valid = w < 0 || above <= 0 ? 0u : above >= 32 ? ~0u : (1u << above) - 1;
    // row 0 at the bits b of word w with 32 w + b a multiple of rows, the
    // last row one bit below them
    const int first = (rows - (32 * w) % rows) % rows;
    const int last = (first + rows - 1) % rows;
    not_first_row = valid & ~(every_row << first);
    not_last_row = valid & ~(every_row << last);
  }
};

// kernels.hex_is_over_plain on hex<N>, a board of rows = N + 1 rows and
// columns: from the previous mover's stones a, 2N-2 steps of
//   b = up(a), c = right(b), a = down((a & (b | c)) | (b & c)),
// then, where that side owns the row-0 border (player == 1), a |= the
// seed of step j: row 0 from column 2 + j to N.  Won where the corner
// (row N, column N) is reached.
//
// L lanes a game (hex_lanes(W) of its W words), lane w word w; lanes
// w >= W hold 0 and their masks are 0.  Word w of a step reads words
// w-2..w+1 of a: up(a)[k] = (a[k] >> 1 | a[k+1] << 31) & valid &
// not_last_row for k = w-2..w, right(b)[k] = (b[k] << rows | b[k-1] >>
// (32 - rows)) & valid for k = w-1..w (rows <= 14), then the and-or for
// w-1..w and down's (x[w] << 1 | x[w-1] >> 31) & valid & not_first_row -
// bitboard._shift's expressions, the words off the board 0 as there.  A
// shuffle at a segment's edge returns the lane's own value, so each
// neighbour is zeroed by its index, not by the shuffle.  N is a template
// argument, so the steps unroll (a loop of shuffles costs each step a
// branch and a reconvergence).  Every lane of the warp runs every step
// (lanes past G hold 0 and store nothing).
template <int N>
__global__ void __launch_bounds__(kMaxThreads) hex_is_over_kernel(
    const int64_t* __restrict__ bopponent, const int8_t* __restrict__ player,
    bool* __restrict__ done, int8_t* __restrict__ result, int G) {
  constexpr int rows = N + 1;
  constexpr int W = (rows * rows + 31) / 32;
  constexpr int L = hex_lanes(W);
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int g = t / L;
  const int w = t % L;
  const bool live = g < G;
  // this lane's masks: up's (valid & not_last_row) at words w-2..w,
  // right's (valid) at w-1..w, down's (valid & not_first_row) and the
  // re-seed's row 0 (valid & ~not_first_row) at w; 0 off the board
  const WordMasks<rows> m2(w - 2), m1(w - 1), m0(w);
  const u32 up2 = m2.valid & m2.not_last_row;
  const u32 up1 = m1.valid & m1.not_last_row, right1 = m1.valid;
  const u32 up0 = m0.valid & m0.not_last_row, right0 = m0.valid;
  const u32 down0 = m0.valid & m0.not_first_row;
  const u32 row0 = m0.valid & ~m0.not_first_row;
  const int8_t p = live ? player[g] : int8_t{0};
  const bool reseed = p == 1;
  u32 a = live && w < W
              ? static_cast<u32>(bopponent[static_cast<size_t>(g) * W + w])
              : 0u;
#pragma unroll
  for (int j = 1; j <= 2 * N - 2; ++j) {
    u32 am2 = 0, am1 = 0, ap1 = 0;  // words w-2, w-1, w+1 of a
    if constexpr (L > 1) {
      const u32 lo1 = __shfl_up_sync(kFullWarp, a, 1, L);
      const u32 hi1 = __shfl_down_sync(kFullWarp, a, 1, L);
      am1 = w >= 1 ? lo1 : 0u;
      ap1 = w + 1 < W ? hi1 : 0u;
      if constexpr (W > 2) {
        const u32 lo2 = __shfl_up_sync(kFullWarp, a, 2, L);
        am2 = w >= 2 ? lo2 : 0u;
      }
    }
    // up
    const u32 bm2 = ((am2 >> 1) | (am1 << 31)) & up2;
    const u32 bm1 = ((am1 >> 1) | (a << 31)) & up1;
    const u32 b0 = ((a >> 1) | (ap1 << 31)) & up0;
    // right
    const u32 cm1 = ((bm1 << rows) | (bm2 >> (32 - rows))) & right1;
    const u32 c0 = ((b0 << rows) | (bm1 >> (32 - rows))) & right0;
    const u32 xm1 = (am1 & (bm1 | cm1)) | (bm1 & cm1);
    const u32 x0 = (a & (b0 | c0)) | (b0 & c0);
    // down
    a = ((x0 << 1) | (xm1 >> 31)) & down0;
    // row 0's cells (r = 0: bits rows * c) from bit rows * (2 + j) up
    const int lo = rows * (2 + j) - 32 * w;
    const u32 upper = lo <= 0 ? ~0u : lo >= 32 ? 0u : ~0u << lo;
    if (reseed) a |= upper & row0;
  }
  constexpr int corner = rows * rows - 1;
  if (live && w == corner / 32) {
    const bool win = (a >> (corner % 32)) & 1u;
    done[g] = win;
    result[g] = win ? static_cast<int8_t>(-p) : int8_t{0};
  }
}

// the launch of hex<n>'s instantiation, for n from N up to kHexMaxSize
template <int N>
void hex(int n, const void* bopponent, const void* player, void* done,
         void* result, int G, int threads, int blocks, cudaStream_t stream) {
  if (n != N) {
    if constexpr (N < kHexMaxSize)
      hex<N + 1>(n, bopponent, player, done, result, G, threads, blocks,
                 stream);
    return;
  }
  hex_is_over_kernel<N><<<blocks, threads, 0, stream>>>(
      static_cast<const int64_t*>(bopponent),
      static_cast<const int8_t*>(player), static_cast<bool*>(done),
      static_cast<int8_t*>(result), G);
}

}  // namespace

// Reversi.play on boards i64[G, 2]: action i32 (action_bits 32) or i64
// (64), player i8[G]; writes the swapped boards, the new legal board and
// -player.  masks: host u32[3 * words]; threads and blocks:
// kernels.direction_geometry.
extern "C" int launch_reversi_play(const void* bplayer, const void* bopponent,
                                   const void* action, const void* player,
                                   void* out_bplayer, void* out_bopponent,
                                   void* out_legal, void* out_player,
                                   const void* masks, int G, int action_bits,
                                   int rows, int cols, int words, int threads,
                                   int blocks, void* stream) {
  Masks64 m;
  if (!reversi_geometry(masks, G, rows, cols, words, &m) ||
      !directions_ok(G, threads, blocks) ||
      (action_bits != 32 && action_bits != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool a64 = action_bits == 64;
  if (rows == 6 && a64)
    play<6, int64_t>(bplayer, bopponent, action, player, out_bplayer,
                     out_bopponent, out_legal, out_player, m, G, blocks, st);
  else if (rows == 6)
    play<6, int32_t>(bplayer, bopponent, action, player, out_bplayer,
                     out_bopponent, out_legal, out_player, m, G, blocks, st);
  else if (a64)
    play<8, int64_t>(bplayer, bopponent, action, player, out_bplayer,
                     out_bopponent, out_legal, out_player, m, G, blocks, st);
  else
    play<8, int32_t>(bplayer, bopponent, action, player, out_bplayer,
                     out_bopponent, out_legal, out_player, m, G, blocks, st);
  return static_cast<int>(cudaGetLastError());
}

// Reversi.is_over on boards i64[G, 2] and player i8[G]: done bool[G],
// result i8[G].  threads and blocks: kernels.direction_geometry.
extern "C" int launch_reversi_is_over(const void* bplayer,
                                      const void* bopponent,
                                      const void* legal, const void* player,
                                      void* done, void* result,
                                      const void* masks, int G, int rows,
                                      int cols, int words, int threads,
                                      int blocks, void* stream) {
  Masks64 m;
  if (!reversi_geometry(masks, G, rows, cols, words, &m) ||
      !directions_ok(G, threads, blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t* bp = static_cast<const int64_t*>(bplayer);
  const int64_t* bo = static_cast<const int64_t*>(bopponent);
  const int64_t* lg = static_cast<const int64_t*>(legal);
  const int8_t* p = static_cast<const int8_t*>(player);
  if (rows == 6)
    reversi_is_over_kernel<6><<<blocks, kDirThreads, 0, st>>>(
        bp, bo, lg, p, static_cast<bool*>(done), static_cast<int8_t*>(result),
        m, G);
  else
    reversi_is_over_kernel<8><<<blocks, kDirThreads, 0, st>>>(
        bp, bo, lg, p, static_cast<bool*>(done), static_cast<int8_t*>(result),
        m, G);
  return static_cast<int>(cudaGetLastError());
}

// Gobang.is_over / Connect4.is_over on boards i64[G, words] (1 to 6) and
// player i8[G]: done bool[G], result i8[G].  threads and blocks:
// kernels.direction_geometry.
extern "C" int launch_line_is_over(const void* bplayer, const void* bopponent,
                                   const void* player, void* done,
                                   void* result, const void* masks, int G,
                                   int rows, int cols, int words, int nvict,
                                   int threads, int blocks, void* stream) {
  Masks m;
  if (G < 1 || rows < 1 || rows > 31 || cols < 1 || cols > 31 ||
      words < 1 || words > kLineMaxWords ||
      words != (rows * cols + 31) / 32 ||
      nvict < 1 || nvict > 32 || !directions_ok(G, threads, blocks) ||
      !masks_match(static_cast<const u32*>(masks), rows, cols, words, &m))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (words) {
    case 1: line<1>(bplayer, bopponent, player, done, result, m, G, rows,
                    cols, nvict, blocks, st); break;
    case 2: line<2>(bplayer, bopponent, player, done, result, m, G, rows,
                    cols, nvict, blocks, st); break;
    case 3: line<3>(bplayer, bopponent, player, done, result, m, G, rows,
                    cols, nvict, blocks, st); break;
    case 4: line<4>(bplayer, bopponent, player, done, result, m, G, rows,
                    cols, nvict, blocks, st); break;
    case 5: line<5>(bplayer, bopponent, player, done, result, m, G, rows,
                    cols, nvict, blocks, st); break;
    default: line<6>(bplayer, bopponent, player, done, result, m, G, rows,
                     cols, nvict, blocks, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// Hex.is_over on the previous mover's board i64[G, words] (1 to 7) and
// player i8[G], hex<N> for N from 2 to 13 (rows = cols = N + 1): done
// bool[G], result i8[G].  lanes (the next power of two at or above
// words), threads and blocks: kernels.spread_geometry.
extern "C" int launch_hex_is_over(const void* bopponent, const void* player,
                                  void* done, void* result,
                                  const void* masks, int G, int rows,
                                  int cols, int words, int lanes,
                                  int threads, int blocks, void* stream) {
  Masks m;
  if (G < 1 || rows != cols || rows < 3 || rows > kHexMaxSize + 1 ||
      words != (rows * cols + 31) / 32 || words > kMaxWords ||
      lanes != hex_lanes(words) || !lanes_ok(G, lanes, threads, blocks) ||
      !masks_match(static_cast<const u32*>(masks), rows, cols, words, &m))
    return static_cast<int>(cudaErrorInvalidValue);
  hex<2>(rows - 1, bopponent, player, done, result, G, threads, blocks,
         static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
