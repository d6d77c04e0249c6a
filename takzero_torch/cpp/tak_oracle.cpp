// Independent Tak rules oracle for bit-exactness testing of the JAX engine.
//
// Deliberately written with a different representation (explicit per-square
// piece stacks, recursive road search) than takzero_tpu/tak/engine.py so the
// two implementations only agree if the *rules* agree.  Mirrors the behavior
// of the reference's external rules crate (fast-tak; SURVEY.md §2.4).
//
// C ABI, used from Python via ctypes.  Build: make -C takzero_tpu/cpp
//
// State interchange layout (all int64, little-endian):
//   height[S], owners[S] (bit h = color of piece at height h),
//   tops[S] (0 empty/1 flat/2 wall/3 cap),
//   reserves[4] (w_stones, w_caps, b_stones, b_caps),
//   to_move, ply, reversible
// Action indices use the policy-tensor layout (channel*S + row*N + col).
//
// The rules engine itself lives in tak_core.hpp (shared with tak_io.cpp).

#include "tak_core.hpp"

using namespace tak;

extern "C" {

int tak_num_actions(int n) { return num_channels(n) * n * n; }

void tak_legal_mask(int n, int half_komi, int reversible_limit,
                    const int64_t* state, uint8_t* out) {
  Board b;
  load(b, n, half_komi, reversible_limit, state);
  legal_mask(b, out);
}

void tak_step(int n, int half_komi, int reversible_limit, int64_t* state,
              int action) {
  Board b;
  load(b, n, half_komi, reversible_limit, state);
  step(b, action);
  store(b, state);
}

int tak_result(int n, int half_komi, int reversible_limit,
               const int64_t* state) {
  Board b;
  load(b, n, half_komi, reversible_limit, state);
  return result(b);
}

// Play a full random game from the given state with an xorshift PRNG,
// writing the visited action at each ply into `actions` (up to max_plies).
// Returns the number of plies played; final result in *out_result.
int tak_random_playout(int n, int half_komi, int reversible_limit,
                       int64_t* state, uint64_t seed, int max_plies,
                       int* actions, int* out_result) {
  Board b;
  load(b, n, half_komi, reversible_limit, state);
  std::vector<uint8_t> mask(tak_num_actions(n));
  uint64_t rng = seed ? seed : 0x9e3779b97f4a7c15ULL;
  int plies = 0;
  while (plies < max_plies && result(b) == -1) {
    legal_mask(b, mask.data());
    std::vector<int> legal;
    for (int a = 0; a < static_cast<int>(mask.size()); ++a)
      if (mask[a]) legal.push_back(a);
    if (legal.empty()) break;
    rng ^= rng << 13;
    rng ^= rng >> 7;
    rng ^= rng << 17;
    int a = legal[rng % legal.size()];
    step(b, a);
    actions[plies++] = a;
  }
  store(b, state);
  *out_result = result(b);
  return plies;
}
}
