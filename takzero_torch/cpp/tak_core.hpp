// Shared Tak rules core (split from tak_oracle.cpp) — used by the
// bit-exactness oracle (tak_oracle.cpp) and the native data loader
// (tak_io.cpp).  See tak_oracle.cpp for the state interchange layout.
#pragma once

#include <cstdint>
#include <cstring>
#include <vector>

namespace tak {
namespace {  // internal linkage: header shared by multiple TUs

constexpr int kMaxN = 8;

struct Square {
  std::vector<uint8_t> colors;  // bottom to top, 0 white / 1 black
  uint8_t top = 0;              // 0 empty / 1 flat / 2 wall / 3 cap
};

struct Board {
  int n;
  int half_komi;
  int reversible_limit;
  Square sq[kMaxN * kMaxN];
  int64_t reserves[2][2];
  int to_move = 0;
  int64_t ply = 0;
  int64_t reversible = 0;
};

const int kDirs[4][2] = {{1, 0}, {0, 1}, {-1, 0}, {0, -1}};  // up,right,down,left

int num_patterns(int n) { return (1 << n) - 2; }
int num_channels(int n) { return 3 + 4 * num_patterns(n); }

// Decode the N-bit suffix-sum pattern mask into drops. Returns count.
int decode_pattern(int mask, int n, int drops[kMaxN]) {
  int positions[kMaxN];
  int k = 0;
  for (int p = 0; p < n; ++p)
    if (mask >> p & 1) positions[k++] = p;
  for (int j = 0; j < k; ++j) {
    int s = n - positions[j];
    int next = (j + 1 < k) ? n - positions[j + 1] : 0;
    drops[j] = s - next;
  }
  return k;
}

void load(Board& b, int n, int half_komi, int reversible_limit,
          const int64_t* buf) {
  b.n = n;
  b.half_komi = half_komi;
  b.reversible_limit = reversible_limit;
  int s = n * n;
  const int64_t* height = buf;
  const int64_t* owners = buf + s;
  const int64_t* tops = buf + 2 * s;
  for (int i = 0; i < s; ++i) {
    b.sq[i].colors.clear();
    for (int h = 0; h < height[i]; ++h)
      b.sq[i].colors.push_back((owners[i] >> h) & 1);
    b.sq[i].top = static_cast<uint8_t>(tops[i]);
  }
  const int64_t* res = buf + 3 * s;
  b.reserves[0][0] = res[0];
  b.reserves[0][1] = res[1];
  b.reserves[1][0] = res[2];
  b.reserves[1][1] = res[3];
  b.to_move = static_cast<int>(buf[3 * s + 4]);
  b.ply = buf[3 * s + 5];
  b.reversible = buf[3 * s + 6];
}

void store(const Board& b, int64_t* buf) {
  int s = b.n * b.n;
  for (int i = 0; i < s; ++i) {
    buf[i] = static_cast<int64_t>(b.sq[i].colors.size());
    int64_t owners = 0;
    for (size_t h = 0; h < b.sq[i].colors.size(); ++h)
      owners |= static_cast<int64_t>(b.sq[i].colors[h]) << h;
    buf[s + i] = owners;
    buf[2 * s + i] = b.sq[i].top;
  }
  buf[3 * s + 0] = b.reserves[0][0];
  buf[3 * s + 1] = b.reserves[0][1];
  buf[3 * s + 2] = b.reserves[1][0];
  buf[3 * s + 3] = b.reserves[1][1];
  buf[3 * s + 4] = b.to_move;
  buf[3 * s + 5] = b.ply;
  buf[3 * s + 6] = b.reversible;
}

bool legal_spread(const Board& b, int row, int col, int dir, int k,
                  const int drops[kMaxN]) {
  int n = b.n;
  int from = row * n + col;
  const Square& src = b.sq[from];
  if (src.top == 0) return false;
  if (src.colors.back() != b.to_move) return false;
  int carry = 0;
  for (int j = 0; j < k; ++j) carry += drops[j];
  if (carry > n || carry > static_cast<int>(src.colors.size())) return false;
  for (int i = 1; i <= k; ++i) {
    int r = row + i * kDirs[dir][0], c = col + i * kDirs[dir][1];
    if (r < 0 || r >= n || c < 0 || c >= n) return false;
    uint8_t t = b.sq[r * n + c].top;
    if (t <= 1) continue;  // empty or flat: fine
    if (t == 3) return false;  // capstone always blocks
    // Wall: only the final square, only a lone capstone crush.
    if (i != k || drops[k - 1] != 1 || src.top != 3) return false;
  }
  return true;
}

void legal_mask(const Board& b, uint8_t* out) {
  int n = b.n, s = n * n;
  std::memset(out, 0, num_channels(n) * s);
  bool swap = b.ply < 2;
  bool stones = b.reserves[b.to_move][0] > 0;
  bool caps = b.reserves[b.to_move][1] > 0;
  for (int i = 0; i < s; ++i) {
    if (b.sq[i].top != 0) continue;
    if (swap || stones) out[0 * s + i] = 1;
    if (!swap && stones) out[1 * s + i] = 1;
    if (!swap && caps) out[2 * s + i] = 1;
  }
  if (swap) return;
  int p = num_patterns(n);
  for (int dir = 0; dir < 4; ++dir) {
    for (int mask = 1; mask <= p; ++mask) {
      int drops[kMaxN];
      int k = decode_pattern(mask, n, drops);
      int ch = 3 + dir * p + (mask - 1);
      for (int row = 0; row < n; ++row)
        for (int col = 0; col < n; ++col)
          if (legal_spread(b, row, col, dir, k, drops))
            out[ch * s + row * n + col] = 1;
    }
  }
}

void step(Board& b, int action) {
  int n = b.n, s = n * n;
  int ch = action / s, sq = action % s;
  if (ch < 3) {
    int color = (b.ply < 2) ? 1 - b.to_move : b.to_move;
    b.sq[sq].colors.assign(1, static_cast<uint8_t>(color));
    b.sq[sq].top = static_cast<uint8_t>(ch + 1);
    b.reserves[color][ch == 2 ? 1 : 0] -= 1;
    b.reversible = 0;
  } else {
    int si = ch - 3;
    int p = num_patterns(n);
    int dir = si / p;
    int mask = si % p + 1;
    int drops[kMaxN];
    int k = decode_pattern(mask, n, drops);
    Square& src = b.sq[sq];
    int carry = 0;
    for (int j = 0; j < k; ++j) carry += drops[j];
    std::vector<uint8_t> hand(src.colors.end() - carry, src.colors.end());
    src.colors.resize(src.colors.size() - carry);
    uint8_t moving_top = src.top;
    src.top = src.colors.empty() ? 0 : 1;
    bool crushed = false;
    int row = sq / n, col = sq % n, idx = 0;
    for (int i = 1; i <= k; ++i) {
      Square& dst = b.sq[(row + i * kDirs[dir][0]) * n + col + i * kDirs[dir][1]];
      if (i == k && dst.top == 2) crushed = true;
      for (int j = 0; j < drops[i - 1]; ++j) dst.colors.push_back(hand[idx++]);
      dst.top = (i == k) ? moving_top : 1;
    }
    b.reversible = crushed ? 0 : b.reversible + 1;
  }
  b.to_move = 1 - b.to_move;
  b.ply += 1;
}

bool has_road(const Board& b, int color) {
  int n = b.n, s = n * n;
  bool cell[kMaxN * kMaxN], seen[kMaxN * kMaxN];
  for (int i = 0; i < s; ++i)
    cell[i] = b.sq[i].top != 0 && b.sq[i].top != 2 &&
              b.sq[i].colors.back() == color;
  for (int axis = 0; axis < 2; ++axis) {  // 0: west-east, 1: south-north
    std::memset(seen, 0, sizeof(seen));
    std::vector<int> stack;
    for (int i = 0; i < n; ++i) {
      int start = axis == 0 ? i * n : i;
      if (cell[start] && !seen[start]) {
        seen[start] = true;
        stack.push_back(start);
      }
    }
    while (!stack.empty()) {
      int cur = stack.back();
      stack.pop_back();
      int r = cur / n, c = cur % n;
      if ((axis == 0 && c == n - 1) || (axis == 1 && r == n - 1)) return true;
      for (auto& d : kDirs) {
        int rr = r + d[0], cc = c + d[1];
        if (rr < 0 || rr >= n || cc < 0 || cc >= n) continue;
        int nxt = rr * n + cc;
        if (cell[nxt] && !seen[nxt]) {
          seen[nxt] = true;
          stack.push_back(nxt);
        }
      }
    }
  }
  return false;
}

// -1 ongoing, 0 white, 1 black, 2 draw
int result(const Board& b) {
  bool rw = has_road(b, 0), rb = has_road(b, 1);
  if (rw && rb) return 1 - b.to_move;  // player who just moved
  if (rw) return 0;
  if (rb) return 1;
  int s = b.n * b.n;
  bool full = true;
  for (int i = 0; i < s; ++i) full = full && b.sq[i].top != 0;
  bool out = (b.reserves[0][0] + b.reserves[0][1] == 0) ||
             (b.reserves[1][0] + b.reserves[1][1] == 0);
  if (full || out) {
    int wf = 0, bf = 0;
    for (int i = 0; i < s; ++i)
      if (b.sq[i].top == 1) (b.sq[i].colors.back() == 0 ? wf : bf)++;
    int w2 = 2 * wf, b2 = 2 * bf + b.half_komi;
    return w2 > b2 ? 0 : (b2 > w2 ? 1 : 2);
  }
  if (b.reversible >= b.reversible_limit) return 2;
  return -1;
}


int num_actions(int n) { return num_channels(n) * n * n; }
int state_size(int n) { return 3 * n * n + 7; }

}  // anonymous
}  // namespace tak
