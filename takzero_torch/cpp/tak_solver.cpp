// Exact depth-limited tinue (forced-win) solver on the oracle rules.
//
// The reference's puzzle benchmark consumes a database whose tinue /
// tinue-avoidance depth labels come from an external exact solver
// (puzzle/src/main.rs:132-166 filters on tinue_length /
// tinue_avoidance_length).  tools/make_puzzles.py finds CANDIDATES with
// the batched device prover (fast, but its proof distance is only an
// upper bound — the first proof found wins, not the shortest), then
// verifies and labels them here: full-width negamax over the independent
// C++ rules core, minimal-depth by iterative deepening over odd depths.
//
// All searches carry a node budget so a pathologically open position
// returns "unknown" (-1) instead of hanging the generator.
//
// C ABI, used from Python via ctypes (tak/oracle.py).

#include "tak_core.hpp"

#include <unordered_map>

namespace {

using namespace tak;

// Depth-bounded proof/disproof facts about one position (side to move
// implicit in the hashed state): mover wins within `win_le` plies /
// provably does not win within `nowin_ge`; and the defender-to-move
// forms, mover is lost within `lose_le` / not lost within `notlose_ge`.
struct Entry {
  int8_t win_le = 127;
  int8_t nowin_ge = -1;
  int8_t lose_le = 127;
  int8_t notlose_ge = -1;
};

struct Ctx {
  int64_t nodes = 0;
  int64_t budget = 0;
  bool aborted = false;
  std::unordered_map<uint64_t, Entry> tt;
  bool tick() {
    if (++nodes > budget) aborted = true;
    return !aborted;
  }
};

uint64_t hash_board(const Board& b) {
  // FNV-1a over the canonical interchange buffer.  Ply is clamped to 2:
  // beyond the swap rule nothing depends on it, so later transpositions
  // of the same stones/reserves/reversible-count merge.
  int64_t buf[3 * kMaxN * kMaxN + 7];
  store(b, buf);
  int size = state_size(b.n);
  buf[3 * b.n * b.n + 5] = b.ply < 2 ? b.ply : 2;
  uint64_t h = 1469598103934665603ULL;
  const unsigned char* p = reinterpret_cast<const unsigned char*>(buf);
  for (int i = 0; i < size * 8; ++i) {
    h ^= p[i];
    h *= 1099511628211ULL;
  }
  return h;
}

std::vector<int> legal_actions(const Board& b) {
  std::vector<uint8_t> mask(num_actions(b.n));
  legal_mask(b, mask.data());
  std::vector<int> out;
  out.reserve(64);
  for (int a = 0; a < static_cast<int>(mask.size()); ++a)
    if (mask[a]) out.push_back(a);
  return out;
}

bool mover_wins(const Board& b, int d, Ctx& c);

// Defender to move: true iff EVERY defender move still loses to the
// attacker within d plies total (the defender's move is one of them).
bool defender_lost(const Board& b, int d, Ctx& c) {
  if (c.aborted || !c.tick()) return false;
  uint64_t h = hash_board(b);
  {
    const Entry& e = c.tt[h];
    if (e.lose_le <= d) return true;
    if (e.notlose_ge >= d) return false;
  }
  int att = 1 - b.to_move;
  bool lost = true;
  for (int a : legal_actions(b)) {
    Board b2 = b;
    step(b2, a);
    int r = result(b2);
    if (r == att) continue;  // the defender move itself completes
                             // the attacker's road: still lost
    if (r != -1 || d < 2 || !mover_wins(b2, d - 1, c)) {
      lost = false;  // defender win/draw, or an unrefuted escape
      break;
    }
    if (c.aborted) return false;
  }
  if (c.aborted) return false;
  Entry& e = c.tt[h];  // re-lookup: recursion may have rehashed
  if (lost) {
    if (d < e.lose_le) e.lose_le = static_cast<int8_t>(d);
  } else if (d > e.notlose_ge) {
    e.notlose_ge = static_cast<int8_t>(d);
  }
  return lost;  // Tak always has a legal move while the game is ongoing
}

// Side to move forces result == its color within d plies.
bool mover_wins(const Board& b, int d, Ctx& c) {
  if (c.aborted || d <= 0 || !c.tick()) return false;
  uint64_t h = hash_board(b);
  {
    const Entry& e = c.tt[h];
    if (e.win_le <= d) return true;
    if (e.nowin_ge >= d) return false;
  }
  bool won = false;
  for (int a : legal_actions(b)) {
    Board b2 = b;
    step(b2, a);
    int r = result(b2);
    if (r == b.to_move) {
      won = true;
      break;
    }
    if (r != -1) continue;  // draw / own-move loss: not a winning line
    if (d >= 3 && defender_lost(b2, d - 1, c)) {
      won = true;
      break;
    }
    if (c.aborted) return false;
  }
  if (c.aborted) return false;
  Entry& e = c.tt[h];
  if (won) {
    if (d < e.win_le) e.win_le = static_cast<int8_t>(d);
  } else if (d > e.nowin_ge) {
    e.nowin_ge = static_cast<int8_t>(d);
  }
  return won;
}

int tinue_depth_board(const Board& b, int max_depth, int64_t node_budget,
                      Ctx& c) {
  if (result(b) != -1) return 0;
  for (int d = 1; d <= max_depth; d += 2) {
    // Budget is per deepening iteration; the table carries proofs across
    // iterations (and across the moves of one avoidance call).
    c.nodes = 0;
    c.aborted = false;
    c.budget = node_budget;
    if (mover_wins(b, d, c)) return d;
    if (c.aborted) return -1;
  }
  return 0;
}

}  // namespace

extern "C" {

// Minimal odd d <= max_depth such that the side to move forces a win,
// 0 if none, -1 if the node budget was exhausted (unknown).
int tak_tinue_depth(int n, int half_komi, int reversible_limit,
                    const int64_t* state, int max_depth,
                    int64_t node_budget) {
  Board b;
  load(b, n, half_komi, reversible_limit, state);
  Ctx c;
  return tinue_depth_board(b, max_depth, node_budget, c);
}

// Side to move is LOST: the opponent forces a win within `depth` plies
// whatever the mover does.  1 yes / 0 no / -1 budget exhausted.
int tak_loses_within(int n, int half_komi, int reversible_limit,
                     const int64_t* state, int depth, int64_t node_budget) {
  Board b;
  load(b, n, half_komi, reversible_limit, state);
  int r = result(b);
  if (r != -1) return r == 1 - b.to_move ? 1 : 0;
  Ctx c;
  c.budget = node_budget;
  bool lost = defender_lost(b, depth, c);
  if (c.aborted) return -1;
  return lost ? 1 : 0;
  // (one-shot: no deepening loop, the caller picks the depth)
}

// Per-action avoidance labeling: out[a] =
//   -1 illegal move;
//   -2 playing a survives (no forced opponent win within max_depth);
//   -3 unknown (node budget exhausted);
//   k >= 0: after playing a the opponent forces a win in minimally k
//           plies (k = 0: the move itself hands the opponent the game).
void tak_avoidance_status(int n, int half_komi, int reversible_limit,
                          const int64_t* state, int max_depth,
                          int64_t node_budget, int32_t* out) {
  Board b;
  load(b, n, half_komi, reversible_limit, state);
  int total = num_actions(n);
  for (int i = 0; i < total; ++i) out[i] = -1;
  if (result(b) != -1) return;
  Ctx c;  // proof table shared across all the root moves
  for (int a : legal_actions(b)) {
    Board b2 = b;
    step(b2, a);
    int r = result(b2);
    if (r != -1) {
      // b2.to_move is the opponent of the original mover.
      out[a] = (r == b2.to_move) ? 0 : -2;  // self-loss : win/draw
      continue;
    }
    int d = tinue_depth_board(b2, max_depth, node_budget, c);
    out[a] = d > 0 ? d : (d == 0 ? -2 : -3);
  }
}

// Laddered avoidance labeling (same out[] codes) with early exit.  An
// avoidance puzzle needs EXACTLY ONE surviving move, and proving a
// survivor (a full no-win search) is the expensive case — so moves are
// first solved at `small_budget`, unknowns retried at `node_budget`, and
// the whole search bails as soon as TWO survivors are proven (remaining
// moves keep whatever label they have; callers must test the survivor
// count before consulting -3).  The proof table is shared across both
// passes and all moves, so the retry pass resumes rather than restarts.
void tak_avoidance_status_laddered(int n, int half_komi,
                                   int reversible_limit,
                                   const int64_t* state, int max_depth,
                                   int64_t small_budget, int64_t node_budget,
                                   int32_t* out) {
  Board b;
  load(b, n, half_komi, reversible_limit, state);
  int total = num_actions(n);
  for (int i = 0; i < total; ++i) out[i] = -1;
  if (result(b) != -1) return;
  Ctx c;
  auto solve_move = [&](int a, int64_t budget) -> int32_t {
    Board b2 = b;
    step(b2, a);
    int r = result(b2);
    if (r != -1) return (r == b2.to_move) ? 0 : -2;
    int d = tinue_depth_board(b2, max_depth, budget, c);
    return d > 0 ? d : (d == 0 ? -2 : -3);
  };
  std::vector<int> acts = legal_actions(b);
  int survivors = 0;
  for (int a : acts) {
    out[a] = solve_move(a, small_budget);
    if (out[a] == -2 && ++survivors >= 2) return;
  }
  for (int a : acts) {
    if (out[a] != -3) continue;
    out[a] = solve_move(a, node_budget);
    if (out[a] == -2 && ++survivors >= 2) return;
  }
}

}  // extern "C"
