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
// does the plain version's operations in the plain version's order, so
// its outputs equal the plain version's bit for bit for any input.  Hex's
// flood is 2N-2 dependent steps of three shifts each (up, right, down):
// the plain version runs each shift word by word, some 5,700 launches a
// call on hex13.
//
// What bounds them on Hopper: the launch.  At 8192 games a call reads and
// writes under 1 MB (about 0.3 us at 3.35 TB/s) and does a few thousand
// word operations a game (well under a microsecond across the card).
// The design: one thread per game, its boards in registers, the directions,
// the flip lines and the words unrolled at compile time (the size or the
// word count is a template argument), nothing in shared memory.  Boards
// are the port's layout: 32-bit words held in int64 elements, cell (r, c)
// at bit r + rows * c.  Reversi's two words are joined into one 64-bit
// value (36 or 64 cells); a shift of that value equals the plain
// version's two-word shift, and the valid mask clears what the 6x6 board
// does not hold.  The line and hex kernels keep W 32-bit words (gobang13:
// six, hex13: seven) and shift across them as bitboard._shift does; the
// flood's steps run as a loop inside the thread.  Geometry and masks come
// from Python (games/kernels.py: reversi_geometry, line_geometry,
// hex_geometry, rules_threads); each entry point checks them against the
// masks it derives from rows and cols and refuses any geometry it has no
// instantiation for.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

typedef unsigned long long u64;
typedef uint32_t u32;

constexpr int kMaxThreads = 128;
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

  // kernels.legal_board_plain: the placing moves of `me`
  __device__ __forceinline__ u64 legal(u64 me, u64 adv) const {
    const u64 emptyc = ~(me | adv) & m.valid;
    u64 out = 0;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      u64 cand = step(d, me) & adv;
#pragma unroll
      for (int i = 0; i < SIZE - 2; ++i) {
        const u64 dc = step(d, cand);
        out |= emptyc & dc;
        cand = adv & dc;
      }
      out |= emptyc & step(d, cand);
    }
    return out;
  }

  // kernels.flip_board_plain: the discs of `adv` a disc on `played` flips
  __device__ __forceinline__ u64 flips(u64 me, u64 adv, u64 played) const {
    u64 out = 0;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      u64 cand = step(d, played) & adv;
      u64 toflip = cand;
#pragma unroll
      for (int i = 0; i < SIZE - 2; ++i) {
        cand = adv & step(d, cand);
        toflip |= cand;
      }
      if ((step(d, toflip) & me) != 0) out |= toflip;
    }
    return out;
  }
};

template <int SIZE, class Action>
__global__ void __launch_bounds__(kMaxThreads) reversi_play_kernel(
    const int64_t* __restrict__ bplayer, const int64_t* __restrict__ bopponent,
    const Action* __restrict__ action, const int8_t* __restrict__ player,
    int64_t* __restrict__ out_bplayer, int64_t* __restrict__ out_bopponent,
    int64_t* __restrict__ out_legal, int8_t* __restrict__ out_player,
    Masks64 masks, int G) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const Reversi<SIZE> R{masks};
  const u64 bp = load64(bplayer, g);
  const u64 bo = load64(bopponent, g);
  const long long a = static_cast<long long>(action[g]);
  // the pass action (size*size and above) places and flips nothing; a
  // negative index sets no bit (bitboard.set_bit)
  const bool is_pass = a >= SIZE * SIZE;
  const u64 placed = (!is_pass && a >= 0) ? (1ull << a) : 0ull;
  const u64 h = is_pass ? 0ull : R.flips(bp, bo, placed);
  const u64 me = (bp ^ h) | placed;
  const u64 adv = bo ^ h;
  store64(out_bplayer, g, adv);
  store64(out_bopponent, g, me);
  store64(out_legal, g, R.legal(adv, me));
  out_player[g] = static_cast<int8_t>(-player[g]);
}

template <int SIZE>
__global__ void __launch_bounds__(kMaxThreads) reversi_is_over_kernel(
    const int64_t* __restrict__ bplayer, const int64_t* __restrict__ bopponent,
    const int64_t* __restrict__ legal, const int8_t* __restrict__ player,
    bool* __restrict__ done, int8_t* __restrict__ result, Masks64 masks,
    int G) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const Reversi<SIZE> R{masks};
  const u64 bp = load64(bplayer, g);
  const u64 bo = load64(bopponent, g);
  const bool over = load64(legal, g) == 0 && R.legal(bo, bp) == 0;
  const int diff = __popcll(bp) - __popcll(bo);
  const int sign = (diff > 0) - (diff < 0);
  done[g] = over;
  result[g] = over ? static_cast<int8_t>(sign * player[g]) : int8_t{0};
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
                      int words, int threads, Masks64* out) {
  Masks m;
  if (G < 1 || rows != cols || (rows != 6 && rows != 8) || words != 2 ||
      !threads_ok(threads) ||
      !masks_match(static_cast<const u32*>(masks), rows, cols, words, &m))
    return false;
  *out = join(m);
  return true;
}

template <int SIZE, class Action>
void play(const void* bplayer, const void* bopponent, const void* action,
          const void* player, void* out_bplayer, void* out_bopponent,
          void* out_legal, void* out_player, Masks64 m, int G, int threads,
          cudaStream_t stream) {
  reversi_play_kernel<SIZE, Action>
      <<<blocks_for(G, threads), threads, 0, stream>>>(
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

template <int W>
__global__ void __launch_bounds__(kMaxThreads) line_is_over_kernel(
    const int64_t* __restrict__ bplayer, const int64_t* __restrict__ bopponent,
    const int8_t* __restrict__ player, bool* __restrict__ done,
    int8_t* __restrict__ result, Masks masks, int G, int rows, int cells,
    int nvict) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const Board<W> bp = load<W>(bplayer, g);
  const Board<W> board = load<W>(bopponent, g);  // the previous mover's
  bool win = false;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    Board<W> b = board;
    for (int i = 0; i < nvict - 1; ++i) {
      const Board<W> s = line_step(d, b, rows, masks);
#pragma unroll
      for (int w = 0; w < W; ++w) b.w[w] &= s.w[w];
    }
    win |= popcount(b) != 0;
  }
  const bool full = popcount(bp) + popcount(board) == cells;
  done[g] = win || full;
  result[g] = win ? static_cast<int8_t>(-player[g]) : int8_t{0};
}

template <int W>
void line(const void* bplayer, const void* bopponent, const void* player,
          void* done, void* result, const Masks& m, int G, int rows,
          int cols, int nvict, int threads, cudaStream_t stream) {
  line_is_over_kernel<W><<<blocks_for(G, threads), threads, 0, stream>>>(
      static_cast<const int64_t*>(bplayer),
      static_cast<const int64_t*>(bopponent),
      static_cast<const int8_t*>(player), static_cast<bool*>(done),
      static_cast<int8_t*>(result), m, G, rows, rows * cols, nvict);
}

// ---------------------------------------------------------------------------
// hex: the connectivity flood on W 32-bit words
// ---------------------------------------------------------------------------

// kernels.hex_is_over_plain on a board of `rows` = N + 1 rows and columns:
// from the previous mover's stones a, 2N-2 steps of
//   b = up(a), c = right(b), a = down((a & (b | c)) | (b & c)),
// then, where that side owns the row-0 border (player == 1), a |= the
// seed of step j: row 0 from column 2 + j to N.  Won where the corner
// (row N, column N) is reached.
template <int W>
__global__ void __launch_bounds__(kMaxThreads) hex_is_over_kernel(
    const int64_t* __restrict__ bopponent, const int8_t* __restrict__ player,
    bool* __restrict__ done, int8_t* __restrict__ result, Masks masks, int G,
    int rows) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const int n = rows - 1;
  const int8_t p = player[g];
  const bool reseed = p == 1;
  Board<W> a = load<W>(bopponent, g);
  for (int j = 1; j <= 2 * n - 2; ++j) {
    Board<W> b = shift_down(a, 1, masks);  // up
#pragma unroll
    for (int w = 0; w < W; ++w) b.w[w] &= masks.not_last_row[w];
    const Board<W> c = shift_up(b, rows, masks);  // right
    Board<W> x;
#pragma unroll
    for (int w = 0; w < W; ++w)
      x.w[w] = (a.w[w] & (b.w[w] | c.w[w])) | (b.w[w] & c.w[w]);
    a = shift_up(x, 1, masks);  // down
#pragma unroll
    for (int w = 0; w < W; ++w) a.w[w] &= masks.not_first_row[w];
    if (reseed) {
      // row 0's cells (r = 0: bits rows * c) from bit rows * (2 + j) up
      const int from = rows * (2 + j);
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const int lo = from - 32 * w;
        const u32 upper = lo <= 0 ? ~0u : lo >= 32 ? 0u : ~0u << lo;
        a.w[w] |= upper & masks.valid[w] & ~masks.not_first_row[w];
      }
    }
  }
  const int corner = rows * rows - 1;
  const bool win = (a.w[corner / 32] >> (corner % 32)) & 1u;
  done[g] = win;
  result[g] = win ? static_cast<int8_t>(-p) : int8_t{0};
}

template <int W>
void hex(const void* bopponent, const void* player, void* done, void* result,
         const Masks& m, int G, int rows, int threads, cudaStream_t stream) {
  hex_is_over_kernel<W><<<blocks_for(G, threads), threads, 0, stream>>>(
      static_cast<const int64_t*>(bopponent),
      static_cast<const int8_t*>(player), static_cast<bool*>(done),
      static_cast<int8_t*>(result), m, G, rows);
}

}  // namespace

// Reversi.play on boards i64[G, 2]: action i32 (action_bits 32) or i64
// (64), player i8[G]; writes the swapped boards, the new legal board and
// -player.  masks: host u32[3 * words].
extern "C" int launch_reversi_play(const void* bplayer, const void* bopponent,
                                   const void* action, const void* player,
                                   void* out_bplayer, void* out_bopponent,
                                   void* out_legal, void* out_player,
                                   const void* masks, int G, int action_bits,
                                   int rows, int cols, int words, int threads,
                                   void* stream) {
  Masks64 m;
  if (!reversi_geometry(masks, G, rows, cols, words, threads, &m) ||
      (action_bits != 32 && action_bits != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool a64 = action_bits == 64;
  if (rows == 6 && a64)
    play<6, int64_t>(bplayer, bopponent, action, player, out_bplayer,
                     out_bopponent, out_legal, out_player, m, G, threads, st);
  else if (rows == 6)
    play<6, int32_t>(bplayer, bopponent, action, player, out_bplayer,
                     out_bopponent, out_legal, out_player, m, G, threads, st);
  else if (a64)
    play<8, int64_t>(bplayer, bopponent, action, player, out_bplayer,
                     out_bopponent, out_legal, out_player, m, G, threads, st);
  else
    play<8, int32_t>(bplayer, bopponent, action, player, out_bplayer,
                     out_bopponent, out_legal, out_player, m, G, threads, st);
  return static_cast<int>(cudaGetLastError());
}

// Reversi.is_over on boards i64[G, 2] and player i8[G]: done bool[G],
// result i8[G].
extern "C" int launch_reversi_is_over(const void* bplayer,
                                      const void* bopponent,
                                      const void* legal, const void* player,
                                      void* done, void* result,
                                      const void* masks, int G, int rows,
                                      int cols, int words, int threads,
                                      void* stream) {
  Masks64 m;
  if (!reversi_geometry(masks, G, rows, cols, words, threads, &m))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = blocks_for(G, threads);
  const int64_t* bp = static_cast<const int64_t*>(bplayer);
  const int64_t* bo = static_cast<const int64_t*>(bopponent);
  const int64_t* lg = static_cast<const int64_t*>(legal);
  const int8_t* p = static_cast<const int8_t*>(player);
  if (rows == 6)
    reversi_is_over_kernel<6><<<blocks, threads, 0, st>>>(
        bp, bo, lg, p, static_cast<bool*>(done), static_cast<int8_t*>(result),
        m, G);
  else
    reversi_is_over_kernel<8><<<blocks, threads, 0, st>>>(
        bp, bo, lg, p, static_cast<bool*>(done), static_cast<int8_t*>(result),
        m, G);
  return static_cast<int>(cudaGetLastError());
}

// Gobang.is_over / Connect4.is_over on boards i64[G, words] (1 to 6) and
// player i8[G]: done bool[G], result i8[G].
extern "C" int launch_line_is_over(const void* bplayer, const void* bopponent,
                                   const void* player, void* done,
                                   void* result, const void* masks, int G,
                                   int rows, int cols, int words, int nvict,
                                   int threads, void* stream) {
  Masks m;
  if (G < 1 || rows < 1 || rows > 31 || cols < 1 || cols > 31 ||
      words < 1 || words > kLineMaxWords ||
      words != (rows * cols + 31) / 32 ||
      nvict < 1 || nvict > 32 || !threads_ok(threads) ||
      !masks_match(static_cast<const u32*>(masks), rows, cols, words, &m))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (words) {
    case 1: line<1>(bplayer, bopponent, player, done, result, m, G, rows,
                    cols, nvict, threads, st); break;
    case 2: line<2>(bplayer, bopponent, player, done, result, m, G, rows,
                    cols, nvict, threads, st); break;
    case 3: line<3>(bplayer, bopponent, player, done, result, m, G, rows,
                    cols, nvict, threads, st); break;
    case 4: line<4>(bplayer, bopponent, player, done, result, m, G, rows,
                    cols, nvict, threads, st); break;
    case 5: line<5>(bplayer, bopponent, player, done, result, m, G, rows,
                    cols, nvict, threads, st); break;
    default: line<6>(bplayer, bopponent, player, done, result, m, G, rows,
                     cols, nvict, threads, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// Hex.is_over on the previous mover's board i64[G, words] (1 to 7) and
// player i8[G], hex<N> for N from 2 to 13 (rows = cols = N + 1): done
// bool[G], result i8[G].
extern "C" int launch_hex_is_over(const void* bopponent, const void* player,
                                  void* done, void* result,
                                  const void* masks, int G, int rows,
                                  int cols, int words, int threads,
                                  void* stream) {
  Masks m;
  if (G < 1 || rows != cols || rows < 3 || rows > kHexMaxSize + 1 ||
      words != (rows * cols + 31) / 32 || words > kMaxWords ||
      !threads_ok(threads) ||
      !masks_match(static_cast<const u32*>(masks), rows, cols, words, &m))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (words) {
    case 1: hex<1>(bopponent, player, done, result, m, G, rows, threads, st);
      break;
    case 2: hex<2>(bopponent, player, done, result, m, G, rows, threads, st);
      break;
    case 3: hex<3>(bopponent, player, done, result, m, G, rows, threads, st);
      break;
    case 4: hex<4>(bopponent, player, done, result, m, G, rows, threads, st);
      break;
    case 5: hex<5>(bopponent, player, done, result, m, G, rows, threads, st);
      break;
    case 6: hex<6>(bopponent, player, done, result, m, G, rows, threads, st);
      break;
    default: hex<7>(bopponent, player, done, result, m, G, rows, threads,
                    st); break;
  }
  return static_cast<int>(cudaGetLastError());
}
