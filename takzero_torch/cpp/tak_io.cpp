// Native data loader for the shared-filesystem protocol.
//
// The reference's runtime parses its target/replay text files in Rust
// (takzero/src/target.rs:56-143, 215-268); this is the TPU framework's
// native equivalent: TPS and PTN parsing, target-line and replay-line
// decoding, and replay explosion into per-ply positions (the reanalyze
// hot path, reanalyze/src/main.rs:269-290) — all in C++, exposed over a
// C ABI for ctypes.
//
// Wire formats (takzero_tpu/data/target.py):
//   target line:  {tps};{value};{ube};{move}:{p},{move}:{p},...
//   replay line:  [TPS "{tps}"] {move} {move} ... {result}
//
// States are written in the oracle's int64 interchange layout
// (tak_oracle.cpp header comment). Action indices use the policy-tensor
// layout channel*S + row*N + col (takzero_tpu/tak/moves.py).

#include <cstdlib>

#include "tak_core.hpp"

namespace {

using tak::Board;
using tak::kMaxN;

// Default reserves (flats, caps) by board size (tak/moves.py).
const int kReserves[kMaxN + 1][2] = {{0, 0}, {0, 0}, {0, 0}, {10, 0},
                                     {15, 0}, {21, 1}, {30, 1}, {40, 2},
                                     {50, 2}};

// ---------------------------------------------------------------------------
// TPS -> packed state (mirrors tak/tps.py:tps_to_state)
// ---------------------------------------------------------------------------

// Parses the TPS in [begin, end) into `buf` (state_size(n) int64s).
// Returns true on success.
bool parse_tps(int n, const char* begin, const char* end, int64_t* buf) {
  int s = n * n;
  int ss = tak::state_size(n);
  for (int i = 0; i < ss; ++i) buf[i] = 0;
  int64_t* height = buf;
  int64_t* owners = buf + s;
  int64_t* tops = buf + 2 * s;
  int64_t reserves[2][2] = {{kReserves[n][0], kReserves[n][1]},
                            {kReserves[n][0], kReserves[n][1]}};

  // Split off the trailing " {to_move} {move_number}".
  const char* p = end;
  while (p > begin && p[-1] == ' ') --p;
  const char* num2 = p;
  while (num2 > begin && num2[-1] != ' ') --num2;
  if (num2 == begin) return false;
  const char* sp1 = num2 - 1;
  const char* num1 = sp1;
  while (num1 > begin && num1[-1] != ' ') --num1;
  if (num1 == begin) return false;
  long move_number = strtol(num2, nullptr, 10);
  long to_move = strtol(num1, nullptr, 10) - 1;
  if (to_move != 0 && to_move != 1) return false;
  const char* board_end = num1 - 1;

  int row = n - 1, col = 0;
  const char* c = begin;
  while (c < board_end) {
    if (*c == '/') {
      if (col != n) return false;
      --row;
      col = 0;
      ++c;
      continue;
    }
    if (*c == ',') {
      ++c;
      continue;
    }
    if (row < 0 || col >= n) return false;
    if (*c == 'x') {
      ++c;
      int k = 1;
      if (c < board_end && *c >= '1' && *c <= '8') {
        k = *c - '0';
        ++c;
      }
      col += k;
      continue;
    }
    // Stack of 1/2 digits with optional trailing S/C.
    int sq = row * n + col;
    int h = 0;
    int64_t own = 0;
    int last_color = -1;
    while (c < board_end && (*c == '1' || *c == '2')) {
      last_color = *c - '1';
      own |= static_cast<int64_t>(last_color) << h;
      reserves[last_color][0] -= 1;
      ++h;
      ++c;
    }
    if (h == 0 || h > 64) return false;
    int top = 1;
    if (c < board_end && (*c == 'S' || *c == 'C')) {
      if (*c == 'C') {
        top = 3;
        reserves[last_color][0] += 1;
        reserves[last_color][1] -= 1;
      } else {
        top = 2;
      }
      ++c;
    }
    height[sq] = h;
    owners[sq] = own;
    tops[sq] = top;
    ++col;
  }
  if (row != 0 || col != n) return false;

  buf[3 * s + 0] = reserves[0][0];
  buf[3 * s + 1] = reserves[0][1];
  buf[3 * s + 2] = reserves[1][0];
  buf[3 * s + 3] = reserves[1][1];
  buf[3 * s + 4] = to_move;
  buf[3 * s + 5] = (move_number - 1) * 2 + to_move;
  buf[3 * s + 6] = 0;
  return true;
}

// ---------------------------------------------------------------------------
// PTN move -> action index (mirrors tak/moves.py:ptn_to_action)
// ---------------------------------------------------------------------------

int dir_index(char c) {
  switch (c) {
    case '+': return 0;
    case '>': return 1;
    case '-': return 2;
    case '<': return 3;
  }
  return -1;
}

// Suffix-sum pattern mask (tak/moves.py:encode_pattern).
int encode_pattern(const int* drops, int k, int n) {
  int mask = 0, s = 0;
  for (int j = k - 1; j >= 0; --j) {
    s += drops[j];
    if (s > n) return -1;
    mask |= 1 << (n - s);
  }
  return mask;
}

// Parses the PTN move in [begin, end). Returns the action index or -1.
int parse_ptn(int n, const char* begin, const char* end) {
  // Strip trailing annotations.
  while (end > begin &&
         (end[-1] == '*' || end[-1] == '!' || end[-1] == '?' ||
          end[-1] == '\'' || end[-1] == '"'))
    --end;
  int len = static_cast<int>(end - begin);
  if (len < 2) return -1;
  int s = n * n;
  int p = tak::num_patterns(n);

  auto square_index = [&](const char* sq) -> int {
    int col = sq[0] - 'a';
    int row = sq[1] - '1';
    if (col < 0 || col >= n || row < 0 || row >= n) return -1;
    return row * n + col;
  };

  if (begin[0] == 'S' || begin[0] == 'C') {
    if (len != 3) return -1;
    int sq = square_index(begin + 1);
    if (sq < 0) return -1;
    int ch = begin[0] == 'S' ? 1 : 2;
    return ch * s + sq;
  }
  // Spread if any direction char present.
  int dpos = -1;
  for (int i = 0; i < len; ++i)
    if (dir_index(begin[i]) >= 0) {
      dpos = i;
      break;
    }
  if (dpos < 0) {
    if (len != 2) return -1;
    int sq = square_index(begin);
    return sq < 0 ? -1 : sq;  // channel 0
  }
  int i = 0, carry = 1;
  if (begin[0] >= '1' && begin[0] <= '8') {
    carry = begin[0] - '0';
    i = 1;
  }
  if (dpos != i + 2) return -1;
  int sq = square_index(begin + i);
  if (sq < 0) return -1;
  int dir = dir_index(begin[dpos]);
  int drops[kMaxN];
  int k = 0;
  for (const char* c = begin + dpos + 1; c < end; ++c) {
    if (*c < '1' || *c > '8' || k >= n) return -1;
    drops[k++] = *c - '0';
  }
  if (k == 0) {
    drops[0] = carry;
    k = 1;
  }
  int total = 0;
  for (int j = 0; j < k; ++j) total += drops[j];
  if (total != carry) return -1;
  int mask = encode_pattern(drops, k, n);
  if (mask < 1 || mask > p) return -1;
  int ch = 3 + dir * p + (mask - 1);
  return ch * s + sq;
}

const char* find_char(const char* c, const char* end, char ch) {
  while (c < end && *c != ch) ++c;
  return c;
}

bool is_result_token(const char* b, const char* e) {
  static const char* kResults[] = {"R-0", "0-R", "F-0", "0-F",
                                   "1/2-1/2", "1-0", "0-1"};
  int len = static_cast<int>(e - b);
  for (const char* r : kResults) {
    int rl = static_cast<int>(strlen(r));
    if (rl == len && memcmp(b, r, len) == 0) return true;
  }
  return false;
}

}  // namespace

extern "C" {

int tak_state_size(int n) { return tak::state_size(n); }

// Parse one TPS string; returns 0 on success, -1 on parse error.
int tak_parse_tps(int n, const char* tps, long len, int64_t* out_state) {
  return parse_tps(n, tps, tps + len, out_state) ? 0 : -1;
}

// Parse one PTN move; returns the action index or -1.
int tak_parse_ptn(int n, const char* ptn, long len) {
  return parse_ptn(n, ptn, ptn + len);
}

// Parse target lines from buf[0..len).
//   out_states:  int64[max_targets * state_size(n)]
//   out_value:   float[max_targets]
//   out_ube:     float[max_targets]
//   out_actions: int32[cap_policy], out_probs: float[cap_policy]
//   out_offsets: int64[max_targets + 1] (policy ranges per target)
//   out_lines:   int32[max_targets] (source line number of each target;
//                may be null)
// Returns the number of targets parsed; malformed lines are skipped
// (the reference's learner does the same, learn/src/main.rs:313-318).
int tak_parse_targets(int n, const char* buf, long len, int max_targets,
                      long cap_policy, int64_t* out_states, float* out_value,
                      float* out_ube, int* out_actions, float* out_probs,
                      int64_t* out_offsets, int* out_lines) {
  int ss = tak::state_size(n);
  const char* c = buf;
  const char* end = buf + len;
  int t = 0;
  int line_no = -1;
  long pol = 0;
  out_offsets[0] = 0;
  while (c < end && t < max_targets) {
    ++line_no;
    const char* eol = find_char(c, end, '\n');
    const char* line_end = eol;
    while (line_end > c && (line_end[-1] == '\r' || line_end[-1] == ' '))
      --line_end;
    if (line_end == c) {
      c = eol + 1;
      continue;
    }
    // tps ; value ; ube ; policy
    const char* s1 = find_char(c, line_end, ';');
    const char* s2 = s1 < line_end ? find_char(s1 + 1, line_end, ';') : line_end;
    const char* s3 = s2 < line_end ? find_char(s2 + 1, line_end, ';') : line_end;
    bool ok = s3 < line_end && parse_tps(n, c, s1, out_states + t * ss);
    long pol_start = pol;
    if (ok) {
      out_value[t] = strtof(s1 + 1, nullptr);
      out_ube[t] = strtof(s2 + 1, nullptr);
      // policy items: move:prob separated by ','
      const char* q = s3 + 1;
      while (ok && q < line_end) {
        const char* item_end = find_char(q, line_end, ',');
        // Split on the LAST ':' (move strings contain no ':').
        const char* colon = item_end;
        while (colon > q && colon[-1] != ':') --colon;
        if (colon == q || pol >= cap_policy) {
          ok = false;
          break;
        }
        int a = parse_ptn(n, q, colon - 1);
        if (a < 0) {
          ok = false;
          break;
        }
        out_actions[pol] = a;
        out_probs[pol] = strtof(colon, nullptr);
        ++pol;
        q = item_end + 1;
      }
    }
    if (ok && pol > pol_start) {
      out_offsets[t + 1] = pol;
      if (out_lines) out_lines[t] = line_no;
      ++t;
    } else {
      pol = pol_start;  // drop partial policy of a malformed line
    }
    c = eol + 1;
  }
  return t;
}

// Parse replay lines and explode every replay into the position before
// each action (plus the starting position), stepping with the rules core.
//   out_states:  int64[cap_positions * state_size(n)]
//   out_plies:   int32[cap_positions] (ply of each position)
// Returns the number of positions written; stops early when capacity is
// reached; malformed lines are skipped.
int tak_parse_replays(int n, int half_komi, int reversible_limit,
                      const char* buf, long len, long cap_positions,
                      int64_t* out_states, int* out_plies) {
  int ss = tak::state_size(n);
  const char* c = buf;
  const char* end = buf + len;
  long pos = 0;
  std::vector<int64_t> state(ss);
  while (c < end && pos < cap_positions) {
    const char* eol = find_char(c, end, '\n');
    const char* line_end = eol;
    while (line_end > c && (line_end[-1] == '\r' || line_end[-1] == ' '))
      --line_end;
    // [TPS "<tps>"] moves... result?
    if (line_end - c > 8 && memcmp(c, "[TPS \"", 6) == 0) {
      const char* tps_begin = c + 6;
      const char* tps_end = tps_begin;
      while (tps_end + 1 < line_end && !(tps_end[0] == '"' && tps_end[1] == ']'))
        ++tps_end;
      if (tps_end + 1 < line_end && parse_tps(n, tps_begin, tps_end, state.data())) {
        Board b;
        tak::load(b, n, half_komi, reversible_limit, state.data());
        const char* q = tps_end + 2;
        bool ok = true;
        long pos_start = pos;  // roll back on a malformed move token,
                               // so "skipped" means the WHOLE line
                               // (matches tak_parse_targets)
        while (ok && q < line_end && pos < cap_positions) {
          while (q < line_end && *q == ' ') ++q;
          if (q >= line_end) break;
          const char* tok_end = q;
          while (tok_end < line_end && *tok_end != ' ') ++tok_end;
          if (is_result_token(q, tok_end)) break;
          int a = parse_ptn(n, q, tok_end);
          if (a < 0) {
            ok = false;
            break;
          }
          tak::store(b, out_states + pos * ss);
          out_plies[pos] = static_cast<int>(b.ply);
          ++pos;
          tak::step(b, a);
          q = tok_end;
        }
        if (!ok) pos = pos_start;
      }
    }
    c = eol + 1;
  }
  return static_cast<int>(pos);
}
}
