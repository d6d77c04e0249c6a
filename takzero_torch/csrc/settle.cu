// The search's settle: one warp a tree, from the end of the descent to the
// evaluation.
//
// Replaces no TPU kernel.  It is the tail of JAX's forward
// (takzero_tpu/search/core.py:101) with tak/engine.py's step and
// terminal_kind, which XLA fuses; the port ran it as batched torch operators
// (search/core.py settle, still the CPU's path and that of any engine other
// than Tak's), about 590 kernels a simulation, most of them the n * n rounds
// of the road flood's max-pools and the gathers and scatters of the step.
// Each lane of the batch is an independent tree with one leaf, so a lane
// gets one warp here:
//
//   * the depth clip: a lane still active after the descent becomes a known
//     stop with its current node's flag and its parent edge's ply and value;
//   * one visit on each edge of the lane's path (the edges of a path are
//     distinct and one warp owns the lane, so no atomics);
//   * the leaf's environment: the parent node's state with the leaf edge's
//     action applied (the placement or the spread, exactly as
//     TakEngine.step does it, for any action, legal or not), or the root's
//     state where the lane expands its root;
//   * terminal discovery: roads by a bitboard flood (S <= 64 squares in one
//     uint64, 4-neighbour shifts masked at the board's edges) run to its
//     fixed point, which is the torch path's n * n rounds of dilation, then
//     the full board or an empty reserve with the flat counts and half komi,
//     and the reversible limit;
//   * the terminal stores into the leaf's slot (or the scratch row's) and the
//     root's, and every output of settle.
//
// Thread q of the warp holds squares q and q + 32: it loads and writes them,
// and __ballot_sync turns their predicates into the bitboards.  Thread 0
// applies the action on the board in shared memory, in TakEngine.step's
// order (a spread drops square by square), and makes the lane's stores.
//
// Bound on an H100: at [128 lanes, 6x6] a lane reads its leaf's state
// (36 squares of int32 height and tops and int64 colour bits, 604 bytes),
// its path (384 bytes at depth 48) and a few scalars, and writes the
// evaluated state and its outputs: about 0.2 MB for the batch, 0.06 us at
// 3.35 TB/s.  Neither bound binds; the time is the chain of a few dependent
// loads, the spread's drops and the flood's rounds (at most S) in registers.
//
// Exact: the work is integer, or copies of stored floats, and the int64
// shifts follow torch's semantics for counts outside [0, 64) (a left shift
// gives 0, a right shift the sign), so the results are the torch path's bit
// for bit on any input.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSquares = 64;

// The tensors of one settle, in the order of ops/tree.py's _SETTLE_POINTERS.
struct Settle {
  // The tree.
  const int* child_action;    // [B, M, C]
  int* child_flag;            // [B, M, C]
  int* child_ply;             // [B, M, C]
  const float* child_value;   // [B, M, C]
  float* child_std;           // [B, M, C]
  int* child_visit;           // [B, M, C]
  const int* node_parent;     // [B, M]
  const int* node_slot;       // [B, M]
  int* root_flag;             // [B]
  int* root_ply;              // [B]
  float* root_std;            // [B]
  int* overflow;              // [B]
  // The node pool's states.
  const int* env_height;      // [B, M, S]
  const long long* env_owner; // [B, M, S]
  const int* env_tops;        // [B, M, S]
  const int* env_reserves;    // [B, M, 2, 2]
  const int* env_to_move;     // [B, M]
  const int* env_ply;         // [B, M]
  const int* env_reversible;  // [B, M]
  // The descent's outputs (search/core.py _descent_buffers).
  const bool* lane_root_expand;  // [B]
  const long long* cur;
  const int* cur_flag;
  const bool* active;
  const int* path_node;       // [B, depth]
  const int* path_slot;
  const int* length;
  const bool* stop_known;
  const int* known_f;
  const int* known_p;
  const float* known_v;
  const bool* stop_leaf;
  const long long* leaf_parent;
  const long long* leaf_slot;
  // The outputs.
  int* out_length;            // [B]
  bool* out_stop_known;
  int* out_known_f;
  int* out_known_p;
  float* out_known_v;
  bool* out_eval_leaf;
  bool* out_eval_root;
  int* out_height;            // [B, S]
  long long* out_owner;       // [B, S]
  int* out_tops;              // [B, S]
  int* out_reserves;          // [B, 2, 2]
  int* out_to_move;           // [B]
  int* out_ply;
  int* out_reversible;
};
constexpr int kPointers = 47;
static_assert(sizeof(Settle) == kPointers * sizeof(void*), "Settle holds only pointers");

struct Shape {
  int m, c, n, depth, half_komi, reversible_limit;
};

// torch's int64 shifts: a count outside [0, 64) gives 0 to the left and the
// sign to the right (the count clamped to 63).
__device__ __forceinline__ long long shl64(long long a, long long k) {
  return (k < 0 || k >= 64) ? 0 : static_cast<long long>(static_cast<unsigned long long>(a) << k);
}

__device__ __forceinline__ long long shr64(long long a, long long k) {
  return (k < 0 || k >= 63) ? (a >> 63) : (a >> k);
}

// The bits of `cells` reachable from `seed` through 4-neighbours within
// `cells`: the torch path's max-pool dilation, to its fixed point.
__device__ __forceinline__ unsigned long long flood(unsigned long long cells, unsigned long long seed, int n,
                                                    unsigned long long not_first_col,
                                                    unsigned long long not_last_col) {
  unsigned long long reach = cells & seed;
  while (true) {
    const unsigned long long grown = cells & (reach | ((reach << 1) & not_first_col) |
                                              ((reach >> 1) & not_last_col) | (reach << n) | (reach >> n));
    if (grown == reach) return reach;
    reach = grown;
  }
}

__global__ void __launch_bounds__(32) tree_settle_kernel(Settle p, Shape sh) {
  __shared__ int s_height[kMaxSquares], s_tops[kMaxSquares];
  __shared__ long long s_owner[kMaxSquares];
  const int b = blockIdx.x, q = threadIdx.x;
  const int n = sh.n, s = n * n, m = sh.m, c = sh.c;
  const size_t lane_nodes = static_cast<size_t>(b) * m;

  // One visit on each edge of the path; padded entries (-1) add nothing.
  for (int d = q; d < sh.depth; d += 32) {
    const size_t at = static_cast<size_t>(b) * sh.depth + d;
    const int pn = p.path_node[at];
    if (pn >= 0) p.child_visit[(lane_nodes + pn) * c + max(p.path_slot[at], 0)] += 1;
  }

  // The state the lane evaluates starts from: the root's where the lane
  // expands its root, else the leaf's parent's.
  const bool root_expand = p.lane_root_expand[b];
  const long long leaf_parent = p.leaf_parent[b], leaf_slot = p.leaf_slot[b];
  const size_t src = lane_nodes + (root_expand ? 0 : leaf_parent);
  for (int sq = q; sq < s; sq += 32) {
    s_height[sq] = p.env_height[src * s + sq];
    s_owner[sq] = p.env_owner[src * s + sq];
    s_tops[sq] = p.env_tops[src * s + sq];
  }
  int reserves[2][2];
  for (int i = 0; i < 4; ++i) reserves[i >> 1][i & 1] = p.env_reserves[src * 4 + i];
  int to_move = p.env_to_move[src], ply = p.env_ply[src], reversible = p.env_reversible[src];
  __syncwarp();

  if (!root_expand) {
    // TakEngine.step on the board in shared memory; every thread keeps the
    // scalars, thread 0 the board.
    const long long action = max(p.child_action[(lane_nodes + leaf_parent) * c + leaf_slot], 0);
    const int ch = static_cast<int>(action / s), sq = static_cast<int>(action % s);
    if (ch < 3) {  // _place: the colour swaps in the first two plies
      const int color = ply < 2 ? 1 - to_move : to_move;
      const int piece = min(ch + 1, 3);
      if (q == 0) {
        s_height[sq] = 1;
        s_owner[sq] |= color;
        s_tops[sq] = piece;
      }
      reserves[color][piece == 3] -= 1;
      reversible = 0;
    } else {  // _spread: pick up `carry`, drop along the direction
      const int patterns = (1 << n) - 2;
      const int si = min(max(ch - 3, 0), 4 * patterns - 1);
      const int dir = si / patterns, mask = si % patterns + 1;  // moves.py decode_pattern
      const int delta = dir == 0 ? n : (dir == 1 ? 1 : (dir == 2 ? -n : -1));
      const int k = __popc(mask), first = __ffs(mask) - 1, carry = n - first;
      bool crushed = false;
      if (q == 0) {
        const long long h = s_height[sq], own = s_owner[sq];
        const long long start = min(max(h - carry, 0LL), 63LL);
        const long long carried = shr64(own, start) & (shl64(1, carry) - 1);
        const int moving_top = s_tops[sq];
        s_height[sq] = static_cast<int>(start);
        s_owner[sq] = own & (shl64(1, start) - 1);
        s_tops[sq] = start > 0;
        int bits = mask;
        for (int i = 1; i <= k; ++i) {
          const int pos = __ffs(bits) - 1;  // the i-th set bit: drop i's suffix
          bits &= bits - 1;
          const int next = bits ? __ffs(bits) - 1 : n;
          const int drops = next - pos, pre = pos - first;
          const int tsq = min(max(sq + i * delta, 0), s - 1);
          const long long chunk = shr64(carried, pre) & (shl64(1, drops) - 1);
          const int ht = s_height[tsq];
          crushed |= i == k && s_tops[tsq] == 2;
          s_owner[tsq] |= shl64(chunk, ht);
          s_height[tsq] = ht + drops;
          s_tops[tsq] = i == k ? moving_top : 1;
        }
      }
      crushed = __shfl_sync(0xffffffffu, crushed, 0);
      reversible = crushed ? 0 : reversible + 1;
    }
    to_move = 1 - to_move;
    ply += 1;
  }
  __syncwarp();

  // The evaluated state out, and its bitboards.
  unsigned long long white_road = 0, black_road = 0, white_flat = 0, black_flat = 0, occupied = 0;
  for (int half = 0; half < 2; ++half) {
    const int sq = q + 32 * half;
    const bool on = sq < s;
    int top = 0, color = 0;
    if (on) {
      const int h = s_height[sq];
      const long long own = s_owner[sq];
      top = s_tops[sq];
      color = static_cast<int>(shr64(own, max(h - 1, 0)) & 1);  // engine.py top_color
      p.out_height[static_cast<size_t>(b) * s + sq] = h;
      p.out_owner[static_cast<size_t>(b) * s + sq] = own;
      p.out_tops[static_cast<size_t>(b) * s + sq] = top;
    }
    const bool road = top == 1 || top == 3;
    const int shift = 32 * half;
    white_road |= static_cast<unsigned long long>(__ballot_sync(0xffffffffu, on && road && color == 0)) << shift;
    black_road |= static_cast<unsigned long long>(__ballot_sync(0xffffffffu, on && road && color == 1)) << shift;
    white_flat |= static_cast<unsigned long long>(__ballot_sync(0xffffffffu, on && top == 1 && color == 0)) << shift;
    black_flat |= static_cast<unsigned long long>(__ballot_sync(0xffffffffu, on && top == 1 && color == 1)) << shift;
    occupied |= static_cast<unsigned long long>(__ballot_sync(0xffffffffu, on && top != 0)) << shift;
  }
  if (q != 0) return;

  const unsigned long long board = s == 64 ? ~0ULL : (1ULL << s) - 1;
  unsigned long long first_col = 0, last_col = 0;
  for (int r = 0; r < n; ++r) {
    first_col |= 1ULL << (r * n);
    last_col |= 1ULL << (r * n + n - 1);
  }
  const unsigned long long first_row = (1ULL << n) - 1, last_row = first_row << (s - n);
  const unsigned long long nf = ~first_col, nl = ~last_col;
  // engine.py _roads: west to east from the first column, south to north
  // from the first row.
  const bool white = (flood(white_road, first_col, n, nf, nl) & last_col) ||
                     (flood(white_road, first_row, n, nf, nl) & last_row);
  const bool black = (flood(black_road, first_col, n, nf, nl) & last_col) ||
                     (flood(black_road, first_row, n, nf, nl) & last_row);

  // engine.py game_result, then terminal_kind (0 ongoing, 1 win, 2 loss, 3 draw).
  int result;
  if (white || black) {
    result = white && black ? 1 - to_move : (white ? 0 : 1);  // both: the last mover's
  } else if (occupied == board || reserves[0][0] + reserves[0][1] == 0 || reserves[1][0] + reserves[1][1] == 0) {
    const int w2 = 2 * __popcll(white_flat), b2 = 2 * __popcll(black_flat) + sh.half_komi;
    result = w2 > b2 ? 0 : (b2 > w2 ? 1 : 2);
  } else {
    result = reversible >= sh.reversible_limit ? 2 : -1;
  }
  const int tk = result == -1 ? 0 : (result == 2 ? 3 : (result == to_move ? 1 : 2));

  for (int i = 0; i < 4; ++i) p.out_reserves[static_cast<size_t>(b) * 4 + i] = reserves[i >> 1][i & 1];
  p.out_to_move[b] = to_move;
  p.out_ply[b] = ply;
  p.out_reversible[b] = reversible;

  // The depth clip: the current node's eval from its parent edge (read
  // before the terminal stores, as the torch path reads it).
  const bool clipped = p.active[b];
  int known_f = p.known_f[b], known_p = p.known_p[b];
  float known_v = p.known_v[b];
  if (clipped) {
    const long long cur = p.cur[b];
    const int parent = max(p.node_parent[lane_nodes + cur], 0), slot = max(p.node_slot[lane_nodes + cur], 0);
    const size_t edge = (lane_nodes + parent) * c + slot;
    known_f = p.cur_flag[b];
    known_p = p.child_ply[edge];
    known_v = p.child_value[edge];
    p.overflow[b] += 1;
  }

  // Terminal leaves become known (tk, ply 0, std 0); other lanes store into
  // the scratch row, as the torch path's unconditional stores do.
  const bool stop_leaf = p.stop_leaf[b];
  const bool leaf_term = stop_leaf && tk != 0, root_term = root_expand && tk != 0;
  const size_t t_edge = (lane_nodes + (leaf_term ? leaf_parent : m - 1)) * c + leaf_slot;
  p.child_flag[t_edge] = tk;
  p.child_ply[t_edge] = 0;
  p.child_std[t_edge] = 0.0f;
  if (root_term) {
    p.root_flag[b] = tk;
    p.root_ply[b] = 0;
    p.root_std[b] = 0.0f;
  }
  p.out_length[b] = clipped ? sh.depth : p.length[b];
  p.out_stop_known[b] = p.stop_known[b] || clipped || leaf_term;
  p.out_known_f[b] = leaf_term ? tk : known_f;
  p.out_known_p[b] = leaf_term ? 0 : known_p;
  p.out_known_v[b] = leaf_term ? 0.0f : known_v;
  p.out_eval_leaf[b] = stop_leaf && !leaf_term;
  p.out_eval_root[b] = root_expand && !root_term;
}

}  // namespace

// The settle of every lane of a batch of trees (child arrays [b, m, c], the
// node pool's states over n * n squares, 3 <= n <= 8), its outputs written
// into the given tensors and the tree in place.  `pointers` holds the
// tensors' addresses in Settle's order.  Returns the CUDA error code of the
// launch (0 on success).
extern "C" int tree_settle_launch(const void* const* pointers, int b, int m, int c, int n, int depth, int half_komi,
                                  int reversible_limit, void* stream) {
  if (n < 3 || n * n > kMaxSquares || m < 1 || c < 1 || depth < 1) return static_cast<int>(cudaErrorInvalidValue);
  Settle p;
  std::memcpy(&p, pointers, sizeof(p));
  const Shape sh{m, c, n, depth, half_komi, reversible_limit};
  tree_settle_kernel<<<b, 32, 0, static_cast<cudaStream_t>(stream)>>>(p, sh);
  return static_cast<int>(cudaGetLastError());
}
